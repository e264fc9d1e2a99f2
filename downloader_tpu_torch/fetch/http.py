"""HTTP/HTTPS download backend.

Rebuild of the reference's ``internal/downloader/http`` package, which
delegates to cavaliercoder/grab (http.go:36-71). This implementation
streams with stdlib ``urllib.request`` and keeps the same observable
behavior — registers schemes http/https (http.go:28-32), downloads into the
job dir, emits a progress update every ``progress_interval`` seconds and a
final 100% (http.go:45-67) — with three deliberate upgrades:

- transfer errors PROPAGATE; the reference returns nil unconditionally and
  never checks resp.Err (http.go:70), silently uploading nothing,
- interrupted transfers resume with a Range request from a ``.part`` file
  (grab supports this but the reference never exercises it, SURVEY.md §5),
- cancellation actually aborts the stream mid-transfer (the reference only
  stops progress reporting on ctx.Done, leaving grab running).
"""

from __future__ import annotations

import email.message
import errno
import os
import re
import socket
import time
import urllib.error
import urllib.parse
import urllib.request

try:
    import fcntl
except ImportError:  # non-Unix: the splice path is gated off with it
    fcntl = None  # type: ignore[assignment]

from ..utils import flows, get_logger, metrics, tracing, watchdog
from ..utils.netio import SocketWaiter
from ..utils.cancel import Cancelled, CancelToken
from . import progress as transfer_progress
from .dispatch import BackendRegistration, ProgressFn

log = get_logger("fetch.http")

_CHUNK_SIZE = 1024 * 1024
_SPLICE_WINDOW = 1024 * 1024
_SAFE_NAME = re.compile(r"[^\w.\- ()\[\]]")


def _plain_socket_of(response) -> socket.socket | None:
    """The plain TCP socket behind an http.client response, or None when
    the transport is TLS (the fd would yield ciphertext) or anything but
    a real socket. Used to decide whether the zero-copy splice path is
    safe; every lookup is defensive because these are stdlib internals."""
    raw = getattr(getattr(response, "fp", None), "raw", None)
    sock = getattr(raw, "_sock", None)
    if not isinstance(sock, socket.socket):
        return None
    try:
        import ssl

        if isinstance(sock, ssl.SSLSocket):
            return None
    except ImportError:
        pass
    return sock


class SpliceUnsupported(Exception):
    """os.splice cannot operate on this socket/file pair (e.g. the sink
    lives on a filesystem without splice_write support). Bytes already
    moved were accounted through ``on_chunk``; ``moved`` carries the
    count so the caller can re-sync http.client's ``response.length``
    (splice consumed those bytes behind the response object's back)
    before falling back to the userspace copy loop."""

    def __init__(self, moved: int = 0):
        super().__init__(moved)
        self.moved = moved


# errnos that mean "splice will never work on these fds", as opposed to
# transient transfer errors that the resume path should retry
_SPLICE_FALLBACK_ERRNOS = frozenset(
    {errno.EINVAL, errno.ENOSYS, errno.EOPNOTSUPP, errno.EPERM}
)

# cleared on the first process-wide splice failure, so later downloads
# skip the doomed pipe + splice + log cycle and go straight to the
# userspace loop. ENOSYS (missing syscall) is permanent anywhere; EPERM
# is permanent only at the socket→pipe site (seccomp SCMP_ACT_ERRNO's
# historical default — the kernel proper never returns EPERM there),
# while sink-side errors like EINVAL are per-mount and NOT memoized.
_splice_works = True


def _note_splice_errno(code: int | None, from_sink: bool = False) -> None:
    global _splice_works
    if code == errno.ENOSYS or (code == errno.EPERM and not from_sink):
        _splice_works = False


def _splice_body(
    response, sock: socket.socket, sink, remaining: int, on_chunk
) -> int:
    """Kernel-side copy of ``remaining`` body bytes: socket → pipe → file
    via os.splice, so payload bytes never enter userspace (the analogue of
    keeping a hot loop on-chip instead of round-tripping through host
    memory). Returns bytes actually moved; short counts mean early EOF.

    The response's BufferedReader may already hold body bytes read along
    with the headers — the caller MUST have drained that buffer first
    (see download(): read1 loop) or those bytes would be skipped.
    """
    if remaining <= 0:
        # the header-parse buffer already held the whole body (tiny
        # files): nothing to splice, and the socket may already be
        # closed — constructing a waiter on it would raise
        return 0
    sink.flush()
    timeout = sock.gettimeout()
    pipe_r, pipe_w = os.pipe()
    try:
        # the pipe caps a single splice at its capacity (64 KiB default);
        # grow it or the 1 MiB window costs ~16 syscall pairs per MiB
        if fcntl is not None:
            fcntl.fcntl(pipe_w, fcntl.F_SETPIPE_SZ, _SPLICE_WINDOW)
    except OSError:
        pass  # over /proc/sys/fs/pipe-max-size for unprivileged: keep 64K
    moved = 0
    try:
        with SocketWaiter(sock, write=False, what="read") as waiter:
            while remaining > 0:
                window = min(_SPLICE_WINDOW, remaining)
                try:
                    got = os.splice(sock.fileno(), pipe_w, window)
                except BlockingIOError:
                    waiter.wait(timeout)
                    continue
                except OSError as exc:
                    if exc.errno in _SPLICE_FALLBACK_ERRNOS:
                        _note_splice_errno(exc.errno)
                        raise SpliceUnsupported(moved) from exc
                    raise
                if got == 0:
                    break
                drained = 0
                while drained < got:
                    try:
                        drained += os.splice(pipe_r, sink.fileno(), got - drained)
                    except OSError as exc:
                        if exc.errno not in _SPLICE_FALLBACK_ERRNOS:
                            raise
                        _note_splice_errno(exc.errno, from_sink=True)
                        # the sink can't take a splice (e.g. FUSE mount):
                        # rescue the bytes stranded in the pipe through
                        # userspace, fd-level to match the splice writes
                        while drained < got:
                            chunk = os.read(pipe_r, got - drained)
                            if not chunk:
                                break
                            view = memoryview(chunk)
                            while view:
                                view = view[os.write(sink.fileno(), view) :]
                            drained += len(chunk)
                        moved += drained
                        remaining -= drained
                        on_chunk(drained)
                        raise SpliceUnsupported(moved) from exc
                moved += got
                remaining -= got
                on_chunk(got)
        return moved
    finally:
        os.close(pipe_r)
        os.close(pipe_w)


def _copy_body(response, sink, token: CancelToken, on_chunk) -> None:
    """Userspace copy loop: reusable buffer + readinto when available
    (optional, so custom openers with plain file-like responses work)."""
    buffer = memoryview(bytearray(_CHUNK_SIZE))
    read_into = getattr(response, "readinto", None)
    while True:
        if token.cancelled():
            raise Cancelled()
        if read_into is not None:
            got = read_into(buffer)
            if not got:
                break
            sink.write(buffer[:got])
        else:
            chunk = response.read(_CHUNK_SIZE)
            if not chunk:
                break
            got = len(chunk)
            sink.write(chunk)
        on_chunk(got)


class TransferError(Exception):
    """A download failed (HTTP error status, short read, or network error)."""


def filename_for(url: str, content_disposition: str | None) -> str:
    """Pick the on-disk name: Content-Disposition filename if sane, else the
    URL path basename, else a fallback — always sanitized to a bare name so a
    hostile server cannot traverse out of the job dir."""
    name = ""
    if content_disposition:
        msg = email.message.Message()
        msg["content-disposition"] = content_disposition
        name = msg.get_param("filename", "", header="content-disposition") or ""
    if not name:
        path = urllib.parse.unquote(urllib.parse.urlparse(url).path)
        name = os.path.basename(path.rstrip("/"))
    name = os.path.basename(name.replace("\\", "/"))
    name = _SAFE_NAME.sub("_", name).strip(". ")
    return name or "download"


class HTTPBackend:
    # the dispatcher may pass a job's mirror URLs (X-Mirrors header +
    # MIRROR_URLS config fallback) to download(); the segmented fetcher
    # races byte spans across every admitted mirror
    supports_mirrors = True
    # http(s) artifacts are content-stable per normalized URL, so the
    # fleet data plane (fetch/singleflight.py) may front this backend
    # with the shared content cache + single-flight election
    supports_cache = True

    def __init__(
        self,
        progress_interval: float = 1.0,
        timeout: float = 30.0,
        max_resume_attempts: int = 3,
        opener: urllib.request.OpenerDirector | None = None,
        zero_copy: bool = True,
        segments: int | None = None,
        segment_min_bytes: int | None = None,
        pool_per_host: int | None = None,
        pool_idle: float | None = None,
    ):
        self._progress_interval = progress_interval
        self._timeout = timeout
        self._max_resume_attempts = max_resume_attempts
        self._opener = opener or urllib.request.build_opener()
        # operator escape hatch (ZEROCOPY=off) for filesystems where
        # splice misbehaves; also how the bench emulates the reference's
        # userspace data path (Go grab = io.Copy) for its baseline
        self._zero_copy = zero_copy
        # segmented multi-connection fetch (fetch/segments.py), with its
        # per-host keep-alive pool shared across segments AND jobs for
        # this backend's lifetime. A custom opener opts out: segments
        # speak http.client directly and would bypass whatever the
        # opener was installed to do (auth handlers, test fakes).
        # The fetcher is kept even with striping off (HTTP_SEGMENTS=1):
        # the small-object fast path and its probe cache ride the same
        # pool and work regardless of the stripe width.
        self._segmenter = None
        if opener is None:
            from .connpool import ConnectionPool
            from .segments import SegmentedFetcher

            self._segmenter = SegmentedFetcher(
                pool=ConnectionPool(
                    per_host=pool_per_host,
                    idle_ttl=pool_idle,
                    timeout=timeout,
                ),
                segments=segments,
                min_segment_bytes=segment_min_bytes,
                timeout=timeout,
                max_attempts=max_resume_attempts,
                progress_interval=progress_interval,
            )

    def register(self) -> BackendRegistration:
        # reference registers protocols only, no extensions (http.go:25-34)
        return BackendRegistration(name="http", protocols=("http", "https"))

    def close(self) -> None:
        """Release pooled keep-alive connections (daemon shutdown)."""
        if self._segmenter is not None:
            self._segmenter.close()

    # -- small-object fast path -------------------------------------------

    def probe_size(self, url: str, token: CancelToken | None = None) -> int | None:
        """Object size when a (cached) HEAD can say, else None — how
        the daemon's batch classifier sorts jobs into the fast lane."""
        if self._segmenter is None:
            return None
        return self._segmenter.probe_size(url, token)

    def fetch_small(
        self,
        token: CancelToken,
        base_dir: str,
        progress: ProgressFn,
        url: str,
        max_bytes: int,
    ) -> bool:
        """Fetch a small object over one pooled keep-alive connection
        (fetch/segments.py fetch_small). False → run ``download``."""
        if self._segmenter is None:
            return False
        return self._segmenter.fetch_small(
            token, base_dir, progress, url, max_bytes
        )

    # -- download --------------------------------------------------------

    def _open(self, url: str, offset: int):
        request = urllib.request.Request(url)
        if offset:
            request.add_header("Range", f"bytes={offset}-")
        response = self._opener.open(request, timeout=self._timeout)
        status = getattr(response, "status", 200)
        if offset and status != 206:
            # server ignored the Range; restart from scratch
            return response, 0
        return response, offset

    def download(
        self,
        token: CancelToken,
        base_dir: str,
        progress: ProgressFn,
        url: str,
        mirrors: "tuple[str, ...]" = (),
    ) -> None:
        if self._segmenter is not None and self._segmenter.enabled:
            # the segmented path handles everything when the probe says
            # the server supports ranges and the object is big enough;
            # with mirrors it races spans across every admitted source.
            # False means "run the single-stream path" — either the
            # probe declined (no side effects) or Range support
            # vanished mid-job on the last live source (speculative
            # state already invalidated)
            if self._segmenter.fetch(
                token, base_dir, progress, url, mirrors=mirrors
            ):
                return
        attempts = 0
        offset = 0
        known_total = 0
        part_path: str | None = None
        final_path: str | None = None
        last_tick = time.monotonic()
        # streaming-upload hand-off (fetch/progress.py): advertise the
        # contiguous write offset so the store can ship multipart parts
        # while this transfer is still running. No-op outside a job
        # with an installed sink.
        stream_sink = transfer_progress.current()
        # stall-watchdog heartbeat (utils/watchdog.py): one counter
        # bump per flushed chunk, captured once so the hot loop never
        # touches thread-local state
        fetch_hb = watchdog.current().heartbeat("fetch")
        # flow ledger attribution (utils/flows.py): the single-stream
        # lane is an origin ingress path like any other — same object
        # key as the segmented/batched lanes so a retry that switches
        # lanes still lands on one ledger row
        flow_obj = flows.object_key(tracing.redact_url(url))
        flow_host = flows.host_of(url)
        announced = False
        reported_high = 0
        sink_file: list = [None]  # the open part file, for flush-before-report

        while True:
            token.raise_if_cancelled()
            try:
                with tracing.span("http-request", offset=offset):
                    response, offset = self._open(url, offset)
            except urllib.error.HTTPError as exc:
                if exc.code < 500 and exc.code != 429:
                    # a deterministic 4xx answer: retrying won't change it
                    raise TransferError(f"http status {exc.code}") from exc
                # 5xx/429 are transient server states (flaky proxy,
                # overload, rate limit): treat like a network failure and
                # burn a resume attempt below
                exc.close()
                attempts += 1
                if attempts > self._max_resume_attempts:
                    raise TransferError(f"http status {exc.code}") from exc
                log.with_fields(
                    url=url, status=exc.code, attempt=attempts
                ).warning("transient http status; retrying")
                time.sleep(min(0.2 * attempts, 1.0))
                continue
            except (urllib.error.URLError, OSError) as exc:
                # transient network failure (conn refused/reset mid-job,
                # DNS blip): burns a resume attempt instead of killing
                # the job outright — on loopback tests a reconnect can
                # race the server's accept loop, and in production a
                # broker redelivery is far costlier than a retry here
                attempts += 1
                if attempts > self._max_resume_attempts:
                    raise TransferError(f"request failed: {exc}") from exc
                log.with_fields(url=url, attempt=attempts).warning(
                    "request failed; retrying"
                )
                time.sleep(min(0.2 * attempts, 1.0))
                continue

            # cancellation closes the in-flight response so a blocking
            # socket read aborts promptly instead of draining the stream
            remove_cancel_hook = token.add_callback(response.close)
            try:
                with response:
                    status = getattr(response, "status", 200)
                    if status >= 400:
                        raise TransferError(f"http status {status}")

                    if final_path is None:
                        name = filename_for(
                            url, response.headers.get("Content-Disposition")
                        )
                        final_path = os.path.join(base_dir, name)
                        part_path = final_path + ".part"

                    if offset and not os.path.exists(part_path):
                        # the partial file vanished underneath us: this
                        # response is ranged from the old offset, so it
                        # cannot be written from scratch — discard it and
                        # re-request from zero
                        log.with_fields(url=url).warning(
                            "partial file disappeared; restarting from zero"
                        )
                        offset = 0
                        continue

                    try:
                        total = _total_size(response, offset, known_total)
                    except TransferError:
                        # the server's size story changed mid-transfer:
                        # bytes already speculatively uploaded may not
                        # match what a re-fetch would return
                        if announced:
                            stream_sink.invalidate(final_path)
                        raise
                    known_total = total or known_total

                    if announced and offset < reported_high:
                        # restarted below bytes already advertised (the
                        # server ignored our Range, or the partial file
                        # vanished): this response may re-send DIFFERENT
                        # bytes than the ones speculatively uploaded —
                        # the stream consumer must discard them
                        stream_sink.invalidate(final_path)
                        reported_high = 0
                    if not announced and total:
                        stream_sink.begin_file(
                            final_path, total, read_path=part_path
                        )
                        announced = True

                    def tick(got: int) -> None:
                        nonlocal offset, last_tick, reported_high
                        if token.cancelled():
                            raise Cancelled()
                        fetch_hb.beat(got)
                        flows.LEDGER.note_ingress(
                            flow_obj, flow_host, "mirror", got
                        )
                        offset += got
                        if announced and offset > reported_high:
                            # only fd-flushed bytes may be advertised: a
                            # concurrent part reader sees the file through
                            # its own descriptor, not our write buffer
                            flushable = sink_file[0]
                            if flushable is not None:
                                flushable.flush()
                            reported_high = offset
                            stream_sink.advance(final_path, offset)
                        now = time.monotonic()
                        if now - last_tick >= self._progress_interval:
                            last_tick = now
                            if total:
                                progress(url, min(offset / total * 100, 99.9))

                    body_span = tracing.span("http-body", offset=offset)
                    span_start_offset = offset
                    try:
                        with body_span, open(
                            part_path, "r+b" if offset else "wb"
                        ) as sink:
                            sink_file[0] = sink
                            sink.seek(offset)
                            sock = _plain_socket_of(response)
                            if (
                                sock is not None
                                and total
                                and not getattr(response, "chunked", False)
                                and hasattr(response, "read1")
                                and hasattr(os, "splice")
                                and _splice_works
                                and self._zero_copy
                            ):
                                # zero-copy path: drain the bytes the
                                # header parse buffered, then splice the
                                # rest kernel-side
                                body_span.annotate(mode="splice")
                                head = response.read1(_CHUNK_SIZE)
                                if head:
                                    sink.write(head)
                                    tick(len(head))
                                try:
                                    _splice_body(
                                        response, sock, sink, total - offset, tick
                                    )
                                except SpliceUnsupported as unsup:
                                    # e.g. the sink filesystem rejects
                                    # splice_write; all fd-level writes so
                                    # far are accounted in offset — re-sync
                                    # the buffered writer and copy the rest
                                    # through userspace
                                    log.with_fields(url=url).info(
                                        "splice unsupported for this "
                                        "socket/file pair; using userspace copy"
                                    )
                                    # splice consumed bytes behind the
                                    # response object's back; on keep-alive
                                    # connections a stale length makes the
                                    # copy loop wait for bytes that never
                                    # arrive
                                    if getattr(response, "length", None):
                                        response.length = max(
                                            0, response.length - unsup.moved
                                        )
                                    body_span.annotate(mode="splice+userspace")
                                    sink.seek(offset)
                                    _copy_body(response, sink, token, tick)
                            else:
                                body_span.annotate(mode="userspace")
                                _copy_body(response, sink, token, tick)
                            # bytes THIS attempt moved — a resumed
                            # transfer's later spans must not re-count
                            # the earlier attempts' bytes
                            body_span.annotate(
                                bytes=offset - span_start_offset
                            )
                    except (urllib.error.URLError, OSError, TimeoutError) as exc:
                        sink_file[0] = None
                        token.raise_if_cancelled()  # closed by the cancel hook
                        attempts += 1
                        if attempts > self._max_resume_attempts:
                            raise TransferError(
                                f"transfer failed after {attempts} attempts: {exc}"
                            ) from exc
                        log.with_fields(
                            url=url, offset=offset, attempt=attempts
                        ).warning("transfer interrupted; resuming with Range request")
                        continue
            finally:
                remove_cancel_hook()

            if total and offset < total:
                # connection closed early without an exception: short read
                attempts += 1
                if attempts > self._max_resume_attempts:
                    raise TransferError(
                        f"short read: got {offset} of {total} bytes"
                    )
                log.with_fields(url=url, offset=offset, total=total).warning(
                    "short read; resuming with Range request"
                )
                continue
            break

        sink_file[0] = None
        # one complete copy served: max semantics, so a broker retry
        # re-fetching this object inflates demand, never unique bytes
        flows.LEDGER.note_unique(flow_obj, offset)
        os.replace(part_path, final_path)
        try:
            # a stale span journal from an earlier segmented attempt
            # must not outlive the part file it described
            os.unlink(part_path + ".spans")
        except OSError:
            pass
        if announced:
            stream_sink.finish_file(final_path)
        metrics.GLOBAL.add("http_bytes_fetched", offset)
        metrics.GLOBAL.add("http_files_fetched")
        progress(url, 100.0)


def _total_size(response, offset: int, known_total: int = 0) -> int:
    """Full object size from Content-Range (resumed) or Content-Length.

    ``known_total`` is the size earlier responses of the SAME transfer
    reported. A resumed attempt whose headers disagree with it — or
    whose Content-Range is present but unparseable — raises
    TransferError instead of silently trusting whichever response came
    first: a changed total means the object was replaced server-side,
    and stitching ranges of two different objects into one file (or one
    speculative multipart upload) produces silent corruption."""
    content_range = response.headers.get("Content-Range", "")
    if content_range:
        match = re.fullmatch(
            r"bytes (\d+)-(\d+)/(\d+|\*)", content_range.strip()
        )
        if not match:
            raise TransferError(
                f"malformed Content-Range: {content_range!r}"
            )
        start, end = int(match.group(1)), int(match.group(2))
        if start != offset or end < start:
            raise TransferError(
                f"Content-Range {content_range!r} inconsistent with "
                f"resume offset {offset}"
            )
        if match.group(3) != "*":
            total = int(match.group(3))
            if end >= total:
                raise TransferError(
                    f"Content-Range {content_range!r} ends past its total"
                )
            if known_total and total != known_total:
                raise TransferError(
                    f"Content-Range total changed {known_total} -> {total}; "
                    "object replaced mid-transfer"
                )
            return total
        # 'bytes x-y/*' (complete length unknown, RFC 9110 §14.4) is
        # legal: fall through to the Content-Length computation
    length = response.headers.get("Content-Length")
    if length and length.isdigit():
        total = int(length) + offset
        if known_total and total != known_total:
            raise TransferError(
                f"content length changed: total {known_total} -> {total}; "
                "object replaced mid-transfer"
            )
        return total
    return 0
