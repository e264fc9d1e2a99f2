"""Streaming fetch→upload pipeline: speculative S3 multipart uploads
fed by fetch progress, so a job's egress overlaps its ingress.

The serial pipeline (fetch the whole payload, scan, then re-read and
upload it) costs ``fetch + upload`` wall time per job. S3 multipart
parts are independent — any fully-covered part span of the target file
can ship as soon as its bytes are durably on disk, in any order — so a
job whose fetch backend advertises completed byte ranges
(fetch/progress.py) can bound its transfer time by ``max(fetch,
upload)`` instead.

Shape:

- ``StreamingPipeline`` — process-wide: the part-upload pool (bounded;
  in-flight upload memory is bounded by ``workers × part_size`` since
  queued parts hold only offsets, the bytes are read at upload time)
  plus config (``PIPELINE`` / ``PIPELINE_PARTS`` env knobs).
- ``PipelineSession`` — per job; implements the TransferSink protocol.
  Installed around the dispatcher call by the daemon.
- ``_FileStream`` — one file's speculative multipart upload: a span
  set merges completed ranges, fully-covered parts are handed to the
  pool, ``complete-multipart`` is gated on fetch success AND the scan
  accepting the file, ``abort-multipart`` fires on fetch failure, scan
  rejection, invalidation (an HTTP restart-from-zero may re-download
  different bytes), or cancellation.

Eligibility is decided up front, speculatively, from the target
filename alone (the scan predicate — media extension — on the
basename): the scan hasn't run yet, so a file that streams fully but
is then rejected by the real scan is aborted at finalize. Files that
are ineligible (name not media-shaped, size unknown or under the
multipart threshold, backend reports no progress) simply fall through
to the store-and-forward ``Uploader.upload_files`` path; so does any
file whose stream fails mid-flight — streaming is an optimization,
never a new failure mode for the job.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor

from ..fetch.progress import SpanSet  # noqa: F401  (re-export: span math lives with the writers)
from ..scan import MEDIA_EXTENSIONS
from ..utils import (
    admission, flows, get_logger, incident, metrics, profiling, tracing,
    watchdog,
)
from ..utils.cancel import Cancelled, CancelToken
from .s3 import S3Client, S3Error
from .uploader import object_key

log = get_logger("store.pipeline")

DEFAULT_PART_WORKERS = 3


def pipeline_enabled_from_env(environ=None) -> bool:
    from ..utils import flag_from_env

    return flag_from_env("PIPELINE", environ)


def part_workers_from_env(environ=None) -> int:
    env = os.environ if environ is None else environ
    raw = (env.get("PIPELINE_PARTS") or "").strip()
    if not raw:
        return DEFAULT_PART_WORKERS
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid PIPELINE_PARTS (want an integer)"
        )
        return DEFAULT_PART_WORKERS


def default_name_predicate(path: str) -> bool:
    """The scan predicate applied speculatively to the known target
    filename: would the media scan even consider this file?"""
    return os.path.splitext(os.path.basename(path))[1] in MEDIA_EXTENSIONS


class PartPlan:
    """Fixed part boundaries for a file of known size: parts are
    numbered from 1 (S3 convention); every part is ``part_size`` long
    except the last, which takes the remainder."""

    __slots__ = ("total", "part_size", "num_parts")

    def __init__(self, total: int, part_size: int):
        if total <= 0 or part_size <= 0:
            raise ValueError("PartPlan needs positive total and part_size")
        self.total = total
        self.part_size = part_size
        self.num_parts = -(-total // part_size)

    def part_range(self, number: int) -> tuple[int, int]:
        if not (1 <= number <= self.num_parts):
            raise ValueError(f"part {number} out of 1..{self.num_parts}")
        start = (number - 1) * self.part_size
        return start, min(start + self.part_size, self.total)

    def parts_touching(self, start: int, end: int) -> range:
        """Part numbers whose ranges intersect ``[start, end)``."""
        if end <= start:
            return range(0)
        first = start // self.part_size + 1
        last = min(self.num_parts, -(-end // self.part_size))
        return range(first, last + 1)


class _FileStream:
    """One target file's speculative multipart upload (see module doc).
    All state transitions happen under the owning session's lock; part
    uploads run on the shared pool and only touch their own slot."""

    def __init__(
        self,
        session: "PipelineSession",
        path: str,
        read_path: str | None,
        total: int,
        key: str,
        upload_id: str,
        part_size: int,
    ):
        self._session = session
        self.path = path
        self.read_path = read_path
        self.total = total
        self.key = key
        self.upload_id = upload_id
        # flow-ledger egress identity, computed once per stream (the
        # ship path runs per part on the upload pool)
        self._flow_object = flows.object_key(key)
        self.plan = PartPlan(total, part_size)
        self.spans = SpanSet()  # guarded-by: _session._lock
        self.submitted: set[int] = set()  # guarded-by: _session._lock
        self.futures: dict[int, Future] = {}  # guarded-by: _session._lock
        self.etags: dict[int, str] = {}  # guarded-by: _session._lock
        self.failed: str | None = None  # first failure; guarded-by: _session._lock
        self.sealed = False  # no new part submissions; guarded-by: _session._lock
        self.settled = False  # completed/aborted, terminal; guarded-by: _session._lock
        self.fetch_done_at: float | None = None  # guarded-by: _session._lock
        self.first_part_at: float | None = None
        self.last_part_done_at: float | None = None
        self.overlapped_bytes = 0  # guarded-by: _session._lock

    # -- coverage → part submission (session lock held) ------------------

    def feed(self, start: int, end: int) -> list[int]:  # holds: _session._lock
        """Merge a completed range; return part numbers that just became
        fully covered and should ship.

        Ingestion is explicitly NON-PREFIX: spans may arrive in any
        order and with gaps (torrent pieces; the segmented HTTP
        fetcher's concurrent ranges) — a part ships as soon as ITS
        range is covered, regardless of earlier bytes. Nothing here may
        assume a monotone write offset."""
        if self.failed or self.sealed:
            return []
        if end > self.total:
            # a writer reporting past the announced size means the
            # source disagrees with the size this upload was planned
            # around (e.g. a server changing Content-Length mid-job);
            # the over-claimed tail maps to parts that don't exist in
            # the plan, so fail the stream (→ store-and-forward
            # fallback) rather than ship a part plan built on a lie
            self.failed = f"span [{start}, {end}) beyond total {self.total}"
            return []
        self.spans.add(start, end)
        ready: list[int] = []
        for number in self.plan.parts_touching(start, end):
            if number in self.submitted:
                continue
            lo, hi = self.plan.part_range(number)
            if self.spans.covers(lo, hi):
                self.submitted.add(number)
                ready.append(number)
        return ready

    # -- part upload (pool thread) ----------------------------------------

    def ship(self, number: int, token: CancelToken | None) -> None:
        lo, hi = self.plan.part_range(number)
        length = hi - lo
        session = self._session
        # part-pool memory budget (utils/admission.py): each in-flight
        # part charges its window against the global memory ledger and
        # refunds it when the upload settles. An exhausted budget fails
        # THIS stream (→ store-and-forward fallback) instead of queueing
        # more buffered parts behind an already-full pool — streaming is
        # an optimization, and under memory pressure it is the first
        # thing the degradation ladder gives back.
        budget_key = admission.part_key(self.upload_id, number)
        if not admission.LEDGER.try_charge("memory", budget_key, length):
            metrics.GLOBAL.add("admission_memory_denials")
            with session._lock:
                if not self.failed:
                    self.failed = f"part {number}: memory budget exhausted"
            log.with_fields(key=self.key, part=number).info(
                "part-pool memory budget exhausted; will fall back"
            )
            return
        metrics.GLOBAL.gauge_add("pipeline_parts_in_flight", 1)
        metrics.GLOBAL.gauge_add("pipeline_bytes_in_flight", length)
        try:
            with tracing.adopt(session._trace_parent):
                with tracing.span(
                    "s3-stream-part", part=number, bytes=length, key=self.key
                ):
                    etag = self._ship_window(number, lo, length, token)
            with session._lock:
                self.etags[number] = etag
                now = time.monotonic()
                self.last_part_done_at = now
                if self.fetch_done_at is None:
                    # part landed while the fetch was still running:
                    # genuinely overlapped egress
                    self.overlapped_bytes += length
            # a completed part is the streaming path's unit of upload
            # progress for the stall watchdog
            session._upload_hb.beat()
            # egress accounting: one shipped part's bytes, attributed
            # to the destination object
            flows.LEDGER.note_egress(self._flow_object, length)
        except (S3Error, OSError, ValueError, Cancelled) as exc:
            with session._lock:
                if not self.failed:
                    self.failed = f"part {number}: {exc}"
            log.with_fields(key=self.key, part=number).info(
                f"streamed part failed; will fall back ({exc})"
            )
        finally:
            admission.LEDGER.refund(budget_key)
            metrics.GLOBAL.gauge_add("pipeline_parts_in_flight", -1)
            metrics.GLOBAL.gauge_add("pipeline_bytes_in_flight", -length)

    def _ship_window(
        self, number: int, start: int, length: int, token: CancelToken | None
    ) -> str:
        # the readable location can flip mid-stream (HTTP renames
        # .part → final on completion): try the side-channel read path
        # first, fall back to the final path
        candidates = [p for p in (self.read_path, self.path) if p]
        last: Exception | None = None
        for candidate in candidates:
            try:
                stream = open(candidate, "rb")
            except FileNotFoundError as exc:
                last = exc
                continue
            with stream:
                stream.seek(start)
                return self._session._client.upload_part(
                    self._session._bucket,
                    self.key,
                    self.upload_id,
                    number,
                    stream,
                    length,
                    token=token,
                )
        raise OSError(f"no readable source for part {number}: {last}")

    # -- terminal transitions ---------------------------------------------

    def _drain(self, cancel: bool) -> None:
        """Settle the submitted part uploads (no session lock held).
        ``cancel=True`` (abort): queued-not-started parts are dropped
        and only truly in-flight ones are waited out — a part racing an
        abort would otherwise resurrect state, and real S3 can even
        re-create an aborted upload's part storage. ``cancel=False``
        (complete): every submitted part must finish."""
        if cancel:
            # analysis: ignore[guarded-by] sealed was set under the lock before every _drain call, so feed() adds no new futures; the list() snapshot is atomic under the GIL
            for future in list(self.futures.values()):
                future.cancel()
        # analysis: ignore[guarded-by] same sealed-before-drain argument as above; waiting on futures under the session lock would deadlock ship()
        for future in list(self.futures.values()):
            if not future.cancelled():
                try:
                    # deadline: part uploads run S3 requests over sockets with finite timeouts, so every in-flight future settles within those bounds
                    future.result()
                except Exception as exc:
                    # ship() already recorded the first failure for the
                    # fallback decision; later ones only get a breadcrumb
                    log.debug(f"streamed part settled with error: {exc}")

    def complete(self) -> str | None:
        """Fetch succeeded and the scan accepted this file: wait for
        the in-flight parts and issue complete-multipart. Returns the
        object key, or None (after aborting) when the stream cannot be
        finished — the caller falls back to store-and-forward."""
        with self._session._lock:
            if self.settled:
                return None
            self.sealed = True  # feed() submits nothing past this point
        self._drain(cancel=False)
        with self._session._lock:
            complete_ok = (
                not self.failed
                and len(self.etags) == self.plan.num_parts
            )
            failed = self.failed
            manifest = sorted(self.etags.items())
        if not complete_ok:
            self.abort("incomplete stream" if not failed else failed)
            return None
        try:
            self._session._client.complete_multipart(
                self._session._bucket, self.key, self.upload_id, manifest
            )
        except (S3Error, OSError) as exc:
            log.with_fields(key=self.key).info(
                f"complete-multipart failed; falling back ({exc})"
            )
            self.abort(f"complete failed: {exc}")
            return None
        with self._session._lock:
            self.settled = True
        self._observe_completion()
        return self.key

    def abort(self, reason: str) -> None:
        with self._session._lock:
            if self.settled:
                return
            self.sealed = True
            self.settled = True
            if not self.failed:
                self.failed = reason
        self._drain(cancel=True)
        try:
            # no token: the abort must run even when the job token is
            # already cancelled — it is how cancellation cleans up
            self._session._client.abort_multipart(
                self._session._bucket, self.key, self.upload_id
            )
        except (S3Error, OSError) as exc:
            log.with_fields(key=self.key).warning(
                f"abort-multipart failed; upload may linger: {exc}"
            )
        metrics.GLOBAL.add("pipeline_aborted_uploads")

    def _observe_completion(self) -> None:
        metrics.GLOBAL.add("pipeline_streamed_files")
        metrics.GLOBAL.add("pipeline_streamed_bytes", self.total)
        # analysis: ignore[guarded-by] runs only after complete() settled the stream; every part worker has finished, so no writer remains
        ratio = self.overlapped_bytes / self.total if self.total else 0.0
        metrics.GLOBAL.observe(
            "pipeline_overlap_ratio", ratio, buckets=metrics.RATIO_BUCKETS
        )
        parent = self._session._trace_parent
        if parent is not None and self.first_part_at is not None:
            # one summary interval per streamed file on the job's trace:
            # how long the streamed egress ran and how much of it
            # overlapped the fetch (tracing folds top-level
            # ``stream_upload`` children into a latency histogram)
            parent.record(
                "stream_upload",
                self.first_part_at,
                self.last_part_done_at or time.monotonic(),
                key=self.key,
                parts=self.plan.num_parts,
                bytes=self.total,
                overlap_ratio=round(ratio, 3),
            )


class PipelineSession:
    """One job's transfer sink → speculative uploads (see module doc).
    Thread-safe: fetch backends report from job and worker threads."""

    def __init__(
        self,
        pipeline: "StreamingPipeline",
        media_id: str,
        token: CancelToken | None = None,
    ):
        self._pipeline = pipeline
        self._client = pipeline._client
        self._bucket = pipeline._bucket
        self._media_id = media_id
        self._token = token
        # named for lock-wait profiling: the fetch thread feeding
        # spans and every part worker shipping them meet here
        self._lock = profiling.named_lock(
            "pipeline_session", threading.Lock()
        )
        # a None value marks the path ineligible for streaming
        self._files: dict[str, _FileStream | None] = {}  # guarded-by: _lock
        self._trace_parent = tracing.current_span()
        # captured on the job thread (construction site); part workers
        # beat it as parts complete — upload-stage forward progress for
        # the stall watchdog
        self._upload_hb = watchdog.current().heartbeat("upload")
        pipeline._track(self)

    def probe_state(self) -> dict:
        """This session's live stream states for incident bundles —
        exactly the evidence a dangling-multipart post-mortem needs."""
        with self._lock:
            files = []
            for path, stream in self._files.items():
                if stream is None:
                    files.append(
                        {"path": os.path.basename(path), "streaming": False}
                    )
                    continue
                files.append(
                    {
                        "path": os.path.basename(path),
                        "streaming": True,
                        "key": stream.key,
                        "total": stream.total,
                        "parts_planned": stream.plan.num_parts,
                        "parts_submitted": len(stream.submitted),
                        "parts_done": len(stream.etags),
                        "failed": stream.failed,
                        "sealed": stream.sealed,
                        "settled": stream.settled,
                    }
                )
        return {"media_id": self._media_id, "files": files}

    # -- TransferSink protocol --------------------------------------------

    def begin_file(
        self, path: str, total: int, read_path: str | None = None
    ) -> None:
        with self._lock:
            if path in self._files:
                return
            self._files[path] = None  # ineligible until proven otherwise
        if total < self._client.multipart_threshold:
            return
        if not self._pipeline._name_predicate(path):
            # speculative scan predicate says the scan would never
            # return this file; don't burn an initiate on it
            return
        try:
            self._pipeline._prepare()
            key = object_key(self._media_id, path)
            # crash janitor: a worker SIGKILLed mid-stream left nothing
            # alive to abort its upload — the redelivered job owns the
            # key now and reclaims the orphan before starting its own
            # (zero dangling multiparts is a fleet invariant, not a
            # process one)
            self._client.abort_stale_multiparts(self._bucket, key)
            upload_id = self._client.initiate_multipart(self._bucket, key)
        except (S3Error, OSError) as exc:
            log.with_fields(path=os.path.basename(path)).info(
                f"streaming unavailable; store-and-forward ({exc})"
            )
            return
        stream = _FileStream(
            self,
            path,
            read_path,
            total,
            object_key(self._media_id, path),
            upload_id,
            self._client.part_size_for(total),
        )
        with self._lock:
            self._files[path] = stream
        log.with_fields(
            key=stream.key, parts=stream.plan.num_parts, size=total
        ).info("streaming upload started")

    def advance(self, path: str, offset: int) -> None:
        self.add_span(path, 0, offset)

    def add_span(self, path: str, start: int, end: int) -> None:
        with self._lock:
            stream = self._files.get(path)
            if stream is None:
                return
            ready = stream.feed(start, end)
            for number in ready:
                if stream.first_part_at is None:
                    stream.first_part_at = time.monotonic()
                stream.futures[number] = self._pipeline._submit(  # thread-role: part-uploader
                    stream.ship, number, self._token
                )

    def finish_file(self, path: str) -> None:
        with self._lock:
            stream = self._files.get(path)
            if stream is not None and stream.fetch_done_at is None:
                stream.fetch_done_at = time.monotonic()
        if stream is not None:
            # a sequential writer's final flush may land exactly at
            # total without a trailing advance(); force full coverage
            # so the last (short) part ships
            self.add_span(path, 0, stream.total)

    def invalidate(self, path: str) -> None:
        with self._lock:
            stream = self._files.get(path)
            # leave an ineligible marker: a restarted transfer
            # re-begins the file, and re-streaming bytes that already
            # burned one abort is not worth a second speculative upload
            self._files[path] = None
        if stream is not None:
            stream.abort("fetch restarted; streamed bytes invalid")
            metrics.GLOBAL.add("pipeline_fallbacks")

    # -- job-side lifecycle -----------------------------------------------

    def finalize(self, scanned_files: list[str]) -> dict[str, str]:
        """The fetch succeeded and the scan ran: complete streams the
        scan accepted, abort speculative streams it rejected. Returns
        ``{path: key}`` for files now fully uploaded — the uploader
        skips them."""
        accepted = set(scanned_files)
        now = time.monotonic()
        with self._lock:
            items = [
                (path, stream)
                for path, stream in self._files.items()
                if stream is not None
            ]
            for _, stream in items:
                # the fetch is over by definition here (finalize runs
                # after scan): backends that never report finish_file
                # (the torrent PieceStore) must not count parts landing
                # during the completion drain as overlapped, or their
                # overlap ratio reads a constant 1.0
                if stream.fetch_done_at is None:
                    stream.fetch_done_at = now
        streamed: dict[str, str] = {}
        for path, stream in items:
            if path not in accepted:
                stream.abort("scan rejected file")
                continue
            key = stream.complete()
            if key is not None:
                streamed[path] = key
            else:
                metrics.GLOBAL.add("pipeline_fallbacks")
        return streamed

    def close(self) -> None:
        """Terminal cleanup: abort every stream not already settled.
        Idempotent; the daemon calls it in a finally so fetch failure,
        scan crash, upload failure, and cancellation all converge here
        with zero multipart uploads left dangling."""
        with self._lock:
            items = [s for s in self._files.values() if s is not None]
        for stream in items:
            if not stream.settled:
                stream.abort("job did not complete")


class StreamingPipeline:
    """Process-wide streaming-upload state: config + the bounded part
    pool, shared by every job so concurrent jobs contend for the same
    egress budget instead of multiplying it."""

    def __init__(
        self,
        client: S3Client,
        bucket: str,
        enabled: bool | None = None,
        part_workers: int | None = None,
        name_predicate=default_name_predicate,
        prepare=None,
    ):
        self._client = client
        self._bucket = bucket
        self.enabled = (
            pipeline_enabled_from_env() if enabled is None else enabled
        )
        self._part_workers = (
            part_workers_from_env() if part_workers is None else part_workers
        )
        self._name_predicate = name_predicate
        # hook for the uploader's ensure-bucket (so the first streamed
        # job of the process creates the bucket exactly like
        # store-and-forward would)
        self._prepare = prepare or (lambda: None)
        self._pool: ThreadPoolExecutor | None = None  # guarded-by: _pool_lock
        self._pool_lock = threading.Lock()
        # live sessions for incident-bundle introspection; weak so a
        # leaked session expires instead of pinning its job's state
        self._sessions: "weakref.WeakSet[PipelineSession]" = weakref.WeakSet()
        incident.RECORDER.register_probe(
            "streaming-pipeline", self._incident_probe
        )

    def _track(self, session: "PipelineSession") -> None:
        self._sessions.add(session)

    def _incident_probe(self) -> dict:
        return {
            "enabled": self.enabled,
            "part_workers": self._part_workers,
            "sessions": [s.probe_state() for s in list(self._sessions)],
        }

    def session(
        self, media_id: str, token: CancelToken | None = None
    ) -> PipelineSession | None:
        if not self.enabled:
            return None
        return PipelineSession(self, media_id, token)

    def _submit(self, fn, *args) -> Future:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._part_workers,
                    thread_name_prefix="stream-part",
                )
            return self._pool.submit(self._run_part, fn, *args)

    @staticmethod
    def _run_part(fn, *args):
        # pool threads spawn lazily inside the executor, so the role
        # registration rides the task instead of the spawn surface
        # (idempotent after the first task on each worker)
        profiling.ROLES.register_current("part-uploader")
        return fn(*args)

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
