"""The port's dispatch client and HTTP backend against the JAX package's.

Routing is compared over a table of URLs. Downloads are compared against
one loopback origin per test: striped and single-stream fetches, an
origin without Range support, an origin that cuts the connection once
mid-body (resume), the small-object lane, and a 404. Both packages must
give the same file names and bytes, or the same error.
"""

import http.server
import threading

import numpy as np
import pytest

from downloader_tpu.fetch import DispatchClient as RefDispatchClient
from downloader_tpu.fetch import HTTPBackend as RefHTTPBackend
from downloader_tpu.fetch import TransferError as RefTransferError
from downloader_tpu.fetch import UnsupportedJobError as RefUnsupportedJobError
from downloader_tpu.fetch.dispatch import BackendRegistration as RefRegistration
from downloader_tpu.utils import watchdog as ref_watchdog
from downloader_tpu.utils.cancel import CancelToken as RefCancelToken
from downloader_tpu_torch.fetch import (
    BackendRegistration,
    DispatchClient,
    HTTPBackend,
    TransferError,
    UnsupportedJobError,
)
from downloader_tpu_torch.utils import watchdog
from downloader_tpu_torch.utils.cancel import CancelToken

# seconds: every origin socket and every backend request gives up after
# this, so no test waits on a socket default
TIMEOUT = 10.0

PORT = {
    "name": "port", "backend": HTTPBackend, "dispatch": DispatchClient,
    "token": CancelToken, "registration": BackendRegistration,
    "transfer_error": TransferError, "unsupported": UnsupportedJobError,
}
REF = {
    "name": "ref", "backend": RefHTTPBackend, "dispatch": RefDispatchClient,
    "token": RefCancelToken, "registration": RefRegistration,
    "transfer_error": RefTransferError, "unsupported": RefUnsupportedJobError,
}
PACKAGES = (PORT, REF)


def _payload(size):
    return np.random.default_rng(size).integers(0, 256, size, np.uint8).tobytes()


class Origin:
    """A loopback HTTP/1.1 origin for one test. ``ranges`` answers HEAD
    and honours ``Range`` with 206; ``cut_after`` closes the connection
    once per path after that many body bytes; ``/missing*`` is a 404."""

    def __init__(self, payload, ranges=True, cut_after=None):
        self.payload = payload
        self.requests = []
        self._cut = set()
        origin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = TIMEOUT

            def log_message(self, *args):
                pass

            def handle_error(self, *args):
                pass

            def _headers(self, status, length, extra=()):
                self.send_response(status)
                self.send_header("Content-Length", str(length))
                if origin.ranges:
                    self.send_header("Accept-Ranges", "bytes")
                for name, value in extra:
                    self.send_header(name, value)
                self.end_headers()

            def do_HEAD(self):
                origin.requests.append(("HEAD", self.path, None))
                if self.path.startswith("/missing"):
                    self._headers(404, 0)
                    return
                self._headers(200, len(origin.payload))

            def do_GET(self):
                rng = self.headers.get("Range")
                origin.requests.append(("GET", self.path, rng))
                if self.path.startswith("/missing"):
                    self._headers(404, 0)
                    return
                data, start = origin.payload, 0
                if origin.ranges and rng and rng.startswith("bytes="):
                    lo, _, hi = rng[len("bytes="):].partition("-")
                    start = int(lo)
                    end = int(hi) + 1 if hi else len(data)
                    self._headers(206, end - start, [(
                        "Content-Range",
                        f"bytes {start}-{end - 1}/{len(data)}",
                    )])
                    data = data[start:end]
                else:
                    self._headers(200, len(data))
                if (
                    origin.cut_after is not None
                    and self.path not in origin._cut
                    and len(data) > origin.cut_after
                ):
                    origin._cut.add(self.path)
                    self.wfile.write(data[: origin.cut_after])
                    self.wfile.flush()
                    self.close_connection = True
                    return
                self.wfile.write(data)

        self.ranges = ranges
        self.cut_after = cut_after
        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=TIMEOUT)


@pytest.fixture
def origin_factory():
    origins = []

    def make(*args, **kwargs):
        origins.append(Origin(*args, **kwargs))
        return origins[-1]

    yield make
    for origin in origins:
        origin.close()


def _download(pkg, tmp_path, url, small=None):
    backend = pkg["backend"](timeout=TIMEOUT)
    token = pkg["token"]()
    job_dir = tmp_path / pkg["name"]
    job_dir.mkdir()
    try:
        if small is None:
            backend.download(token, str(job_dir), lambda url, pct: None, url)
        else:
            assert backend.fetch_small(
                token, str(job_dir), lambda url, pct: None, url, small
            )
    finally:
        backend.close()
        token.cancel()
    return {path.name: path.read_bytes() for path in job_dir.iterdir()}


def _download_both(tmp_path, url_of, small=None):
    results = [
        _download(pkg, tmp_path, url_of(pkg), small=small) for pkg in PACKAGES
    ]
    assert results[0] == results[1]
    return results[0]


CASES = {
    # name: (payload bytes, HTTP_SEGMENTS, origin keywords)
    "single-stream": (3 * 1024 * 1024 + 5, "1", {}),
    "four-segments": (4 * 1024 * 1024 + 321, "4", {}),
    "no-range-support": (2 * 1024 * 1024 + 7, None, {"ranges": False}),
    "cut-once-resume": (2 * 1024 * 1024 + 9, "1", {"cut_after": 700_001}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_download_matches_reference(monkeypatch, origin_factory, tmp_path, case):
    size, segments, origin_kwargs = CASES[case]
    if segments is None:
        monkeypatch.delenv("HTTP_SEGMENTS", raising=False)
    else:
        monkeypatch.setenv("HTTP_SEGMENTS", segments)
    monkeypatch.setenv("HTTP_SEGMENT_MIN_MB", "1")
    origin = origin_factory(_payload(size), **origin_kwargs)
    # one path per package, so a cut-once origin cuts each package once
    files = _download_both(
        tmp_path, lambda pkg: f"{origin.url}/{pkg['name']}/Show.S01E01.mkv"
    )
    assert files == {"Show.S01E01.mkv": origin.payload}
    gets = [r for r in origin.requests if r[0] == "GET"]
    ranged = [r for r in gets if r[2]]
    if case == "four-segments":
        assert len(ranged) >= 2 * 4  # four ranged GETs a package
    elif case == "cut-once-resume":
        resumes = [r for r in ranged if r[2] == "bytes=700001-"]
        assert len(resumes) == 2  # one resume a package
    elif case == "no-range-support":
        assert len(gets) == 2 and ranged == []


def test_fetch_small_matches_reference(origin_factory, tmp_path):
    origin = origin_factory(_payload(123_457))
    files = _download_both(
        tmp_path, lambda pkg: f"{origin.url}/{pkg['name']}/clip.mp4",
        small=1 << 20,
    )
    assert files == {"clip.mp4": origin.payload}


@pytest.mark.parametrize("segments", ["1", "4"])
def test_fetch_heartbeat_matches_reference(monkeypatch, origin_factory, tmp_path, segments):
    # an installed job watch sees the fetch stage's bytes in both
    # packages; the reference's watch is built directly so the test does
    # not depend on how its process-wide monitor is configured
    monkeypatch.setenv("HTTP_SEGMENTS", segments)
    monkeypatch.setenv("HTTP_SEGMENT_MIN_MB", "1")
    origin = origin_factory(_payload(4 * 1024 * 1024 + 11))
    port_watch = watchdog.MONITOR.job("episode")
    ref_watch = ref_watchdog.TaskWatch(None, "episode")
    counts = []
    try:
        for pkg, module, watch in ((PORT, watchdog, port_watch), (REF, ref_watchdog, ref_watch)):
            with module.install(watch):
                _download(pkg, tmp_path, f"{origin.url}/{pkg['name']}/Show.S01E01.mkv")
            assert module.current() is module.NOOP_WATCH
            counts.append(watch.counts())
        tasks = watchdog.MONITOR.snapshot()["tasks"]
        assert [t["counts"] for t in tasks if t["name"] == "episode"] == [counts[0]]
    finally:
        watchdog.MONITOR.unregister(port_watch)
    if segments == "1":
        assert counts[0] == counts[1] == {"fetch": len(origin.payload)}
    else:
        # striped workers may fetch a range twice (a stolen or re-split
        # segment), and every byte received is progress
        for count in counts:
            assert list(count) == ["fetch"] and count["fetch"] >= len(origin.payload)
    assert all(t["name"] != "episode" for t in watchdog.MONITOR.snapshot()["tasks"])


def test_not_found_raises_the_same_transfer_error(origin_factory, tmp_path):
    origin = origin_factory(_payload(1000))
    messages = []
    for pkg in PACKAGES:
        with pytest.raises(pkg["transfer_error"]) as raised:
            _download(pkg, tmp_path, f"{origin.url}/missing-{pkg['name']}.mkv")
        messages.append(str(raised.value))
    assert messages[0] == messages[1]
    assert "404" in messages[0]


ROUTES = [
    "http://host/a.torrent",        # extension before scheme
    "https://host/dir/x.torrent?sig=1",
    "https://host/movie.mkv",       # scheme only
    "http://host/noext",
    "magnet:?xt=urn:btih:" + "ab" * 20,
    "ftp://host/x.torrent",         # extensions count for http(s) only
    "gopher://host/x",              # unsupported
    "file:///etc/passwd",
]


def _route(pkg, tmp_path, url):
    chosen = []

    class Fake:
        def __init__(self, name, protocols=(), exts=()):
            self.reg = pkg["registration"](name, protocols, exts)

        def register(self):
            return self.reg

        def download(self, token, base_dir, progress, url):
            chosen.append(self.reg.name)

    token = pkg["token"]()
    client = pkg["dispatch"](
        token, str(tmp_path / pkg["name"]),
        [Fake("torrent", ("magnet",), (".torrent",)), Fake("http", ("http", "https"))],
    )
    try:
        client.download("media-1", url)
    except pkg["unsupported"] as exc:
        return f"unsupported: {exc}"
    finally:
        token.cancel()
    return chosen[0]


@pytest.mark.parametrize("url", ROUTES)
def test_dispatch_routing_matches_reference(tmp_path, url):
    port, ref = (_route(pkg, tmp_path, url) for pkg in PACKAGES)
    assert port == ref
