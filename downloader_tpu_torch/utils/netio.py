"""Socket readiness waits for the zero-copy data paths, plus the
per-host DNS resolution cache the pooled HTTP paths resolve through.

Bare ``select.select`` is the wrong tool here twice over: it raises
ValueError both for fds >= FD_SETSIZE (inevitable in a long-lived daemon)
and for fds closed mid-wait by a cancellation hook (fileno() == -1).
``selectors.DefaultSelector`` picks the platform's FD_SETSIZE-free
backend (epoll/kqueue/poll); errors from a dead fd are converted to
OSError so callers' existing error handling (resume / cancel / per-file
failure) applies instead of an unhandled ValueError crossing the worker
boundary.

The DNS cache exists for the segmented HTTP fetcher: N concurrent
segment connections to one host must not issue N identical resolver
round trips, and a pooled reconnect should skip the resolver entirely.
Failures are negative-cached briefly so a dead hostname doesn't hammer
the resolver once per retry attempt either.
"""

from __future__ import annotations

import os
import selectors
import socket
import threading
import time

DEFAULT_DNS_TTL = 60.0
# failed lookups are cached much shorter: a transient resolver blip
# must not blind the host for a whole positive-TTL window
DEFAULT_DNS_NEGATIVE_TTL = 5.0


def dns_ttl_from_env(environ=None) -> float:
    """HTTP_DNS_TTL env knob: seconds resolved addresses stay cached
    (0 disables caching entirely)."""
    env = os.environ if environ is None else environ
    raw = (env.get("HTTP_DNS_TTL") or "").strip()
    if not raw:
        return DEFAULT_DNS_TTL
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_DNS_TTL


class DNSCache:
    """TTL'd ``getaddrinfo`` results keyed by (host, port, family).

    Thread-safe. Positive entries live ``ttl`` seconds, failures
    ``negative_ttl`` seconds (re-raised as the cached ``gaierror``).
    The clock is injectable so tests can expire entries without
    sleeping."""

    def __init__(
        self,
        ttl: float = DEFAULT_DNS_TTL,
        negative_ttl: float = DEFAULT_DNS_NEGATIVE_TTL,
        max_entries: int = 512,
        clock=time.monotonic,
    ) -> None:
        self._ttl = ttl
        self._negative_ttl = negative_ttl
        self._max_entries = max_entries
        self._clock = clock
        self._lock = threading.Lock()
        # key -> (expires_at, addrinfo list | gaierror)
        self._entries: dict[tuple, tuple[float, object]] = {}
        self.hits = 0
        self.misses = 0

    def resolve(self, host: str, port: int, family: int = 0) -> list[tuple]:
        if self._ttl <= 0:
            return socket.getaddrinfo(
                host, port, family, socket.SOCK_STREAM
            )
        key = (host, port, family)
        now = self._clock()
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None and cached[0] > now:
                self.hits += 1
                if isinstance(cached[1], socket.gaierror):
                    raise cached[1]
                return list(cached[1])  # copy: callers may reorder
            self.misses += 1
        try:
            infos = socket.getaddrinfo(
                host, port, family, socket.SOCK_STREAM
            )
        except socket.gaierror as exc:
            with self._lock:
                self._evict_locked(now)
                self._entries[key] = (now + self._negative_ttl, exc)
            raise
        with self._lock:
            self._evict_locked(now)
            self._entries[key] = (now + self._ttl, infos)
        return list(infos)

    def _evict_locked(self, now: float) -> None:
        if len(self._entries) < self._max_entries:
            return
        expired = [k for k, (at, _) in self._entries.items() if at <= now]
        for key in expired:
            del self._entries[key]
        while len(self._entries) >= self._max_entries:
            # all live: drop the soonest-to-expire entry
            self._entries.pop(min(self._entries, key=lambda k: self._entries[k][0]))

    def purge(self) -> None:
        with self._lock:
            self._entries.clear()


RESOLVER = DNSCache(ttl=dns_ttl_from_env())


def create_connection(
    address: tuple[str, int],
    timeout=socket._GLOBAL_DEFAULT_TIMEOUT,
    source_address=None,
    *,
    resolver: DNSCache | None = None,
) -> socket.socket:
    """``socket.create_connection`` resolving through the DNS cache —
    signature-compatible so it drops into ``http.client``'s
    ``_create_connection`` hook. Tries each cached address in resolver
    order, raising the last error when none connects."""
    host, port = address
    from .failpoints import FAILPOINTS

    if FAILPOINTS.fire("net.connect"):
        raise ConnectionRefusedError(
            f"failpoint: net.connect refused for {host!r}"
        )
    infos = (resolver or RESOLVER).resolve(host, port)
    if not infos:
        raise OSError(f"getaddrinfo returned nothing for {host!r}")
    last: Exception | None = None
    for family, socktype, proto, _, sockaddr in infos:
        sock = None
        try:
            sock = socket.socket(family, socktype, proto)
            if timeout is not socket._GLOBAL_DEFAULT_TIMEOUT:
                sock.settimeout(timeout)
            if source_address:
                sock.bind(source_address)
            sock.connect(sockaddr)
            return sock
        except OSError as exc:
            last = exc
            if sock is not None:
                sock.close()
    assert last is not None
    raise last


class SocketWaiter:
    """Re-armable readiness wait for one socket.

    Register once per transfer: the EAGAIN path of the splice/sendfile
    loops fires on most windows whenever the disk outpaces the network,
    and re-polling one registered selector costs a single syscall per
    wait instead of epoll_create + epoll_ctl + epoll_wait + close.
    """

    def __init__(self, sock, write: bool, what: str) -> None:
        self._sock = sock
        self._what = what
        self._sel = selectors.DefaultSelector()
        try:
            self._sel.register(
                sock, selectors.EVENT_WRITE if write else selectors.EVENT_READ
            )
        except (ValueError, KeyError, OSError) as exc:
            self._sel.close()
            raise OSError(f"socket closed while waiting to {what}") from exc

    # epoll silently drops a registered fd when it is closed (the cancel
    # hook does exactly that), so a close landing mid-select would stall
    # the wait to its full timeout; waiting in slices and re-checking the
    # fd bounds cancellation-detection latency to one slice
    _SLICE = 0.5

    def wait(self, timeout: float | None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._sock.fileno() == -1:
                raise OSError(f"socket closed while waiting to {self._what}")
            step = self._SLICE
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise TimeoutError(f"timed out waiting to {self._what}")
                step = min(step, remain)
            if self._sel.select(step):
                return

    def close(self) -> None:
        self._sel.close()

    def __enter__(self) -> "SocketWaiter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
