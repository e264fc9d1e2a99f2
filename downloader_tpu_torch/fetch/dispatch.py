"""Download dispatch: pluggable per-protocol backends behind one client.

Rebuild of the Go reference's ``internal/downloader`` package. Semantics
kept (citations into tritonmedia/downloader):

- Backends self-describe via a registration of name + URL schemes + file
  extensions (downloader.go:26-38); the client indexes both maps
  (downloader.go:87-94).
- Routing: for http/https URLs a file-extension match wins first, then a
  scheme match; anything else is an unsupported-job error
  (downloader.go:149-168).
- Each job downloads into ``base_dir/<media_id>/`` which the client
  creates (downloader.go:170-171) and returns even on failure, as the
  reference returns the dir alongside the backend error.
- Progress: backends report (url, percent) updates; the client aggregates
  them and a display thread logs each in-flight download every
  ``progress_interval`` seconds, dropping entries that reach 100%
  (downloader.go:96-130).

Deliberate fixes over the reference:

- Backend download errors always propagate (the reference's HTTP backend
  returned nil unconditionally, http.go:70 — silent failure).
- Registration happens under a lock and the maps are immutable after
  construction, so dispatch is thread-safe for the N-way job concurrency
  the daemon adds (the reference planned but never added it, cmd:100-101).
"""

from __future__ import annotations

import math
import os
import threading
import urllib.parse
from dataclasses import dataclass, field
from typing import Callable, Protocol

from ..utils import get_logger, tracing
from ..utils.cancel import CancelToken

log = get_logger("fetch")

ProgressFn = Callable[[str, float], None]


@dataclass
class BackendRegistration:
    """What a backend supports (reference ClientRegister, downloader.go:26-38)."""

    name: str
    protocols: tuple[str, ...] = ()
    file_extensions: tuple[str, ...] = ()


class Backend(Protocol):
    """A downloader implementation (reference ClientImpl, downloader.go:16-23)."""

    def register(self) -> BackendRegistration: ...

    def download(
        self, token: CancelToken, base_dir: str, progress: ProgressFn, url: str
    ) -> None: ...


class UnsupportedJobError(Exception):
    """No backend matches the job URL's extension or scheme
    (reference downloader.go:166-168)."""


@dataclass
class _Progress:
    entries: dict[str, float] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def update(self, url: str, percent: float) -> None:
        with self.lock:
            if percent >= 100:
                self.entries.pop(url, None)
            else:
                self.entries[url] = percent

    def snapshot(self) -> dict[str, float]:
        with self.lock:
            return dict(self.entries)


class DispatchClient:
    """Routes a job URL to a backend and owns the per-job directory layout."""

    def __init__(
        self,
        token: CancelToken,
        base_dir: str,
        backends: list[Backend],
        progress_interval: float = 5.0,
        data_plane=None,
    ):
        if not base_dir or not os.path.isabs(base_dir):
            # reference rejects relative baseDir (downloader.go:76-78)
            raise ValueError("invalid base_dir: must be absolute")
        self._base_dir = base_dir
        self._token = token
        # fleet data plane (fetch/singleflight.py): when configured,
        # both lanes front their fetches with the shared content cache
        # + single-flight election; None = every fetch goes to origin
        self._data_plane = data_plane
        self._by_protocol: dict[str, list[Backend]] = {}
        self._by_extension: dict[str, list[Backend]] = {}
        self._progress = _Progress()

        for backend in backends:
            reg = backend.register()
            log.with_fields(
                name=reg.name, exts=list(reg.file_extensions), protocol=list(reg.protocols)
            ).info("registered client implementation")
            for ext in reg.file_extensions:
                self._by_extension.setdefault(ext, []).append(backend)
            for protocol in reg.protocols:
                self._by_protocol.setdefault(protocol, []).append(backend)

        log.info(
            f"have {len(self._by_protocol)} protocol(s), and "
            f"{len(self._by_extension)} file extension(s) registered"
        )

        self._display_thread = threading.Thread(
            target=self._display_loop, args=(progress_interval,), daemon=True
        )
        self._display_thread.start()

    # -- progress --------------------------------------------------------

    def _display_loop(self, interval: float) -> None:
        # logs in-flight downloads every `interval` s (downloader.go:115-130)
        while not self._token.wait(interval):
            try:
                for url, percent in sorted(self._progress.snapshot().items()):
                    log.with_fields(
                        progress=math.ceil(percent * 100) / 100, url=url
                    ).info("download status")
            except Exception as exc:
                # purely cosmetic thread: a formatting bug must not
                # kill the status ticker for the rest of the process
                log.debug(f"progress display tick failed: {exc}")

    # -- dispatch --------------------------------------------------------

    def _select_backend(self, url: str) -> Backend:
        parsed = urllib.parse.urlparse(url)
        ext = os.path.splitext(parsed.path)[1]
        log.with_fields(protocol=parsed.scheme, ext=ext).info("downloading file")

        # extension match only applies to http/s URLs (downloader.go:149-153)
        if parsed.scheme in ("http", "https"):
            candidates = self._by_extension.get(ext, [])
            if candidates:
                return candidates[0]

        candidates = self._by_protocol.get(parsed.scheme, [])
        if candidates:
            log.info("found supported protocol downloader")
            return candidates[0]

        raise UnsupportedJobError(
            f"unsupported fileext '{ext}' or protocol '{parsed.scheme}'"
        )

    def probe_size(
        self, url: str, token: CancelToken | None = None
    ) -> int | None:
        """Object size when the routed backend can answer cheaply (a
        cached HEAD), else None. Never raises for unroutable URLs —
        None just keeps the job on the normal path, where routing
        errors surface with their proper handling."""
        try:
            backend = self._select_backend(url)
        except UnsupportedJobError:
            return None
        probe_size = getattr(backend, "probe_size", None)
        if probe_size is None:
            return None
        return probe_size(url, token)

    def fast_fetch(
        self,
        media_id: str,
        url: str,
        max_bytes: int,
        token: CancelToken | None = None,
    ) -> str | None:
        """Small-object fast path: fetch ``url`` into the job dir over
        the backend's pooled connection, skipping striping/multipart.
        Returns the job dir on success, None when the fast path cannot
        own this job (caller falls back to ``download``). Transfer
        errors propagate exactly like ``download``'s."""
        try:
            backend = self._select_backend(url)
        except UnsupportedJobError:
            return None
        fetch_small = getattr(backend, "fetch_small", None)
        if fetch_small is None:
            return None

        job_dir = os.path.join(self._base_dir, media_id)
        os.makedirs(job_dir, exist_ok=True)
        try:
            with tracing.span(
                "backend", backend=backend.register().name, fast_path=True
            ):
                plane = self._data_plane
                if plane is not None and plane.covers(backend, url):
                    done = plane.fetch_small(
                        backend, token or self._token, job_dir,
                        self._progress.update, url, max_bytes,
                    )
                else:
                    done = fetch_small(
                        token or self._token, job_dir, self._progress.update,
                        url, max_bytes,
                    )
        finally:
            self._progress.update(url, 100.0)
        return job_dir if done else None

    def download(
        self,
        media_id: str,
        url: str,
        token: CancelToken | None = None,
        mirrors: "tuple[str, ...]" = (),
    ) -> str:
        """Download a job into ``base_dir/<media_id>/`` and return that dir.

        ``token`` scopes cancellation to this job (the daemon passes a
        per-job child so the stall watchdog can release one wedged
        download); None falls back to the client-wide token.

        ``mirrors`` are alternate URLs for the same object (job header
        ``X-Mirrors`` + config fallback); they reach only backends that
        declare ``supports_mirrors`` — the HTTP backend races byte
        spans across them, the torrent backend rides them as extra
        webseeds — and are silently dropped for any other backend.

        Raises UnsupportedJobError for unroutable URLs and propagates
        backend errors (unlike the reference's HTTP backend, which
        swallowed them — http.go:70).
        """
        backend = self._select_backend(url)

        job_dir = os.path.join(self._base_dir, media_id)
        os.makedirs(job_dir, exist_ok=True)

        try:
            with tracing.span(
                "backend", backend=backend.register().name
            ):
                plane = self._data_plane
                if plane is not None and plane.covers(backend, url):
                    # served from cache or a coalesced fetch; a False
                    # return (wait timeout, index failure) falls back
                    # to the plain direct fetch below
                    if plane.download(
                        backend, token or self._token, job_dir,
                        self._progress.update, url, mirrors=tuple(mirrors),
                    ):
                        return job_dir
                if mirrors and getattr(backend, "supports_mirrors", False):
                    backend.download(
                        token or self._token, job_dir,
                        self._progress.update, url, mirrors=tuple(mirrors),
                    )
                else:
                    backend.download(
                        token or self._token, job_dir,
                        self._progress.update, url,
                    )
        finally:
            # whatever happened, stop displaying this URL
            self._progress.update(url, 100.0)
        return job_dir
