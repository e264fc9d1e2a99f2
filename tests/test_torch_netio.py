"""Port twin of ``tests/test_netio.py``: ``SocketWaiter`` (timeout,
readiness, a socket closed under the wait by a cancellation hook) and
the DNS cache (per-host TTL, negative cache, TTL 0, cached connects).

Every body runs over both packages' ``utils.netio`` (``[port]`` and
``[ref]`` cases) and holds each to the reference test's acceptance, so
the port keeps the JAX package's behaviour case by case.
"""

import socket
import threading
import time

import pytest

from downloader_tpu.utils import netio as ref_netio
from downloader_tpu_torch.utils import netio as port_netio


@pytest.fixture(params=[port_netio, ref_netio], ids=["port", "ref"])
def netio(request):
    return request.param


def test_wait_times_out(netio):
    a, b = socket.socketpair()
    try:
        with netio.SocketWaiter(a, write=False, what="read") as waiter:
            start = time.monotonic()
            with pytest.raises(TimeoutError):
                waiter.wait(0.3)
            assert time.monotonic() - start < 2
    finally:
        a.close()
        b.close()


def test_wait_returns_when_ready(netio):
    a, b = socket.socketpair()
    try:
        with netio.SocketWaiter(a, write=False, what="read") as waiter:
            b.send(b"x")
            waiter.wait(2)  # must not raise
    finally:
        a.close()
        b.close()


def test_close_mid_wait_detected_within_slice(netio):
    a, b = socket.socketpair()
    try:
        with netio.SocketWaiter(a, write=False, what="read") as waiter:
            threading.Timer(0.2, a.close).start()
            start = time.monotonic()
            with pytest.raises(OSError) as excinfo:
                waiter.wait(10)
            assert not isinstance(excinfo.value, TimeoutError)
            assert time.monotonic() - start < 2, "close not detected promptly"
    finally:
        b.close()
        try:
            a.close()
        except OSError:
            pass


def test_register_closed_socket_raises_oserror(netio):
    a, b = socket.socketpair()
    a.close()
    b.close()
    with pytest.raises(OSError) as excinfo:
        netio.SocketWaiter(a, write=False, what="read")
    assert not isinstance(excinfo.value, TimeoutError)


# -- DNS resolution cache (per-host TTL + negative cache) -----------------------


class _CountingResolver:
    """Monkeypatch target standing in for socket.getaddrinfo."""

    def __init__(self, result=None, error=None):
        self.calls = 0
        self.result = result or [
            (socket.AF_INET, socket.SOCK_STREAM, 6, "", ("127.0.0.1", 80))
        ]
        self.error = error

    def __call__(self, host, port, family=0, type=0, *args):
        self.calls += 1
        if self.error is not None:
            raise self.error
        return list(self.result)


def test_dns_cache_hits_within_ttl(netio, monkeypatch):
    resolver = _CountingResolver()
    monkeypatch.setattr(socket, "getaddrinfo", resolver)
    now = [0.0]
    cache = netio.DNSCache(ttl=60.0, clock=lambda: now[0])
    first = cache.resolve("example.test", 80)
    second = cache.resolve("example.test", 80)
    assert first == second and resolver.calls == 1
    assert cache.hits == 1 and cache.misses == 1
    # a different port is a different cache key
    cache.resolve("example.test", 443)
    assert resolver.calls == 2


def test_dns_cache_expires_after_ttl(netio, monkeypatch):
    resolver = _CountingResolver()
    monkeypatch.setattr(socket, "getaddrinfo", resolver)
    now = [0.0]
    cache = netio.DNSCache(ttl=60.0, clock=lambda: now[0])
    cache.resolve("example.test", 80)
    now[0] = 61.0
    cache.resolve("example.test", 80)
    assert resolver.calls == 2


def test_dns_negative_cache(netio, monkeypatch):
    resolver = _CountingResolver(error=socket.gaierror("no such host"))
    monkeypatch.setattr(socket, "getaddrinfo", resolver)
    now = [0.0]
    cache = netio.DNSCache(ttl=60.0, negative_ttl=5.0, clock=lambda: now[0])
    with pytest.raises(socket.gaierror):
        cache.resolve("dead.test", 80)
    with pytest.raises(socket.gaierror):
        cache.resolve("dead.test", 80)
    assert resolver.calls == 1, "negative result not cached"
    # the failure ages out much faster than a positive entry
    now[0] = 6.0
    resolver.error = None
    assert cache.resolve("dead.test", 80)
    assert resolver.calls == 2


def test_dns_ttl_zero_disables_cache(netio, monkeypatch):
    resolver = _CountingResolver()
    monkeypatch.setattr(socket, "getaddrinfo", resolver)
    cache = netio.DNSCache(ttl=0.0)
    cache.resolve("example.test", 80)
    cache.resolve("example.test", 80)
    assert resolver.calls == 2


def test_create_connection_uses_cached_addresses(netio):
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    try:
        cache = netio.DNSCache(ttl=60.0)
        conn = netio.create_connection(("127.0.0.1", port), timeout=2, resolver=cache)
        conn.close()
        assert cache.misses == 1
        conn = netio.create_connection(("127.0.0.1", port), timeout=2, resolver=cache)
        conn.close()
        assert cache.hits == 1, "second connect resolved again"
    finally:
        listener.close()
