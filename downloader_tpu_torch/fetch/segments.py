"""Segmented multi-SOURCE HTTP fetch with cross-source tail racing.

The single-stream backend (fetch/http.py) is bounded by ONE
connection's throughput: server-side per-connection rate limits, a TCP
congestion window still opening, or a long-RTT path all cap a job well
below the host's actual capacity. Multi-path transfer work (PAPERS.md,
"Accelerating Intra-Node GPU-to-GPU Communication Through Multi-Path
Transfers") recovers that bandwidth by striping one logical transfer
across several concurrent paths; this module is the HTTP analogue —
and the *paths* are not just connections to one origin but
whole origins: one job draws byte spans concurrently from the primary
URL and any number of mirror URLs (job header ``X-Mirrors`` plus the
``MIRROR_URLS`` config fallback), each admitted only when its probe
matches the primary's size (and strong validator, when both have one).
Every source carries an EWMA bandwidth estimate and an error score
(fetch/sources.py); the span scheduler hands the next missing span to
the best idle source, demotes sources slower than a fraction of the
leader to a small-span trickle lane (recovery re-promotes), and
retires sources that die mid-job — connection reset, Range dropped,
deterministic 4xx/5xx — WITHOUT restarting the job: their in-flight
spans return to the missing set and the surviving sources absorb them.

1. **Probe** — one HEAD through the pooled connection: the object is
   segmentable iff the server advertises ``Accept-Ranges: bytes`` and
   a usable ``Content-Length``. Anything else (no ranges, redirects,
   userinfo URLs, HEAD unsupported, small objects) falls back to the
   single-stream path with no side effects.
2. **Stripe** — the object splits into N ranges (``HTTP_SEGMENTS``
   limit, size-based default) fetched concurrently through the
   per-host keep-alive pool (fetch/connpool.py), each written at its
   offset into the preallocated ``.part`` file via ``os.pwrite`` —
   positional, unbuffered, thread-safe.
3. **Report** — each segment's flushed window lands in the streaming
   pipeline as a NON-prefix span (``add_span``), so speculative
   multipart uploads overlap ALL in-flight segments, not just a
   monotone prefix.
4. **Journal** — every reported window is also appended to a sidecar
   span journal (``.part.spans``); a crashed or retried job reloads it
   and re-fetches only the missing ranges.
5. **Endgame** — when no unclaimed ranges remain, idle workers
   re-issue the slowest in-flight segment's remaining range — on a
   DIFFERENT source when one is live (the torrent endgame pattern,
   generalized across origins); whichever copy finishes first cancels
   the loser. Duplicate bytes are identical bytes at identical
   offsets — harmless.

If the server stops honoring Range mid-job (a cache tier change, a
failover to a dumber origin), the whole segmented attempt aborts, the
speculative upload is invalidated (the single-stream rerun may receive
different bytes), and the caller falls back to single-stream.
"""

from __future__ import annotations

import http.client
import os
import re
import socket
import threading
import time
import urllib.parse
import urllib.request

from ..utils import (
    admission, flows, get_logger, incident, metrics, profiling, tracing,
    watchdog,
)
from ..utils.cancel import Cancelled, CancelToken
from ..utils.failpoints import FAILPOINTS
from . import progress as transfer_progress
from . import sources as source_accounting
from .connpool import ConnectionPool
from .progress import SpanSet

log = get_logger("fetch.segments")

DEFAULT_MAX_SEGMENTS = 8
DEFAULT_MIN_SEGMENT_BYTES = 8 * 1024 * 1024
# a straggler must have at least this much left before an idle worker
# duplicates it — below that, the re-dispatch costs more than it saves
ENDGAME_MIN_REMAINING = 1024 * 1024
# segment bytes are journaled + advertised in windows of this size so
# the streaming pipeline sees coverage grow while segments run
REPORT_WINDOW = 1024 * 1024
_CHUNK = 256 * 1024
# a URL that declined segmentation (no ranges, too small, redirect)
# skips the HEAD probe for this long: broker retries and duplicate
# jobs for the same source shouldn't re-pay a round trip to relearn
# "single-stream". Purely an optimization — a stale decline only
# means one transfer runs unsegmented, never a wrong byte.
DECLINE_TTL = 60.0
_DECLINE_CACHE_MAX = 256
# probe results (size, validator, Accept-Ranges) are remembered for
# this long so the small-object fast path classifies batch jobs
# WITHOUT a per-job HEAD. A stale entry is gate-only: the actual GET's
# headers are re-validated, so the worst case is one fast-path attempt
# falling back — never a wrong byte.
PROBE_TTL = 60.0
_PROBE_CACHE_MAX = 256

_CONTENT_RANGE = re.compile(r"bytes (\d+)-(\d+)/(\d+)$")


def segments_from_env(environ=None) -> int:
    """HTTP_SEGMENTS knob → the segment-count LIMIT: unset/'auto' uses
    the size-based default (up to 8); 'off'/'0'/'1' forces
    single-stream; any other integer caps the stripe width."""
    env = os.environ if environ is None else environ
    raw = (env.get("HTTP_SEGMENTS") or "").strip().lower()
    if not raw or raw == "auto":
        return DEFAULT_MAX_SEGMENTS
    if raw in ("off", "no", "false", "disabled"):
        return 1
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid HTTP_SEGMENTS (want an integer or 'auto')"
        )
        return DEFAULT_MAX_SEGMENTS


def min_segment_bytes_from_env(environ=None) -> int:
    """HTTP_SEGMENT_MIN_MB knob: no segment is planned smaller than
    this, and objects under twice this size stay single-stream — the
    probe + fan-out overhead needs bytes to amortize against."""
    env = os.environ if environ is None else environ
    raw = (env.get("HTTP_SEGMENT_MIN_MB") or "").strip()
    if not raw:
        return DEFAULT_MIN_SEGMENT_BYTES
    try:
        return max(1, int(raw)) * 1024 * 1024
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid HTTP_SEGMENT_MIN_MB (want an integer)"
        )
        return DEFAULT_MIN_SEGMENT_BYTES


def segment_count(total: int, limit: int, min_bytes: int) -> int:
    """How many segments a ``total``-byte object gets: enough that each
    carries at least ``min_bytes``, capped at ``limit``; below twice
    the minimum the stripe never engages."""
    if limit <= 1 or total < 2 * min_bytes:
        return 1
    return min(limit, total // min_bytes)


def plan_ranges(
    gaps: list[tuple[int, int]], target: int, min_bytes: int
) -> list[tuple[int, int]]:
    """Split the missing byte ranges into at most ``target``-ish
    segments of at least ``min_bytes`` each (the final piece of a gap
    takes the remainder)."""
    missing_total = sum(hi - lo for lo, hi in gaps)
    if missing_total <= 0:
        return []
    size = max(min_bytes, -(-missing_total // max(1, target)))
    out: list[tuple[int, int]] = []
    for lo, hi in gaps:
        cursor = lo
        while cursor < hi:
            out.append((cursor, min(cursor + size, hi)))
            cursor += size
    return out


class RangeDropped(Exception):
    """A source answered a ranged GET with 200 mid-job: it no longer
    honors Range. With other sources live the source is simply retired
    and its spans reassigned; for the last source standing the striped
    plan is void — fall back to single-stream."""


class SourceRejected(Exception):
    """A source answered in a way retrying cannot fix (deterministic
    4xx, malformed or mismatched Content-Range, the wrong range):
    permanent for THIS source, recoverable for the job while other
    sources remain. The last source standing converts it into a plain
    TransferError so the job-level retry policy applies unchanged."""


# a demoted source's trickle lane carries spans at most this large: it
# keeps being measured (so recovery re-promotes) without parking
# megabytes of the object behind a known-slow lane
TRICKLE_SPAN = 1024 * 1024

# aggregate wall-clock budget for vetting a job's mirror candidates
# (the concurrent HEADs in _admit_mirrors): a dead mirror costs every
# job at most this once per PROBE_TTL, never a connect timeout each
MIRROR_PROBE_BUDGET = 5.0


def _abort_connection(conn: http.client.HTTPConnection) -> None:
    """Cancel hook: wake a thread BLOCKED in recv on this connection.
    ``conn.close()`` alone only drops the fd — a blocked recv keeps
    sleeping until the socket timeout; ``shutdown`` interrupts it
    immediately with EOF/reset."""
    sock = getattr(conn, "sock", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    try:
        conn.close()
    except OSError:
        pass


def _boot_id() -> str:
    """This boot's identity, for the journal header. Segment data is
    pwritten to the page cache and the journal line is merely flushed:
    after a process crash both are intact (the cache belongs to the
    kernel), but after a POWER LOSS the tiny journal append can reach
    disk while the megabyte of data pages did not — so a journal from
    a previous boot may describe zero-filled holes and must not be
    trusted. Empty on non-Linux: resume then survives reboots, at the
    (pre-existing) risk that an unclean power cut corrupts a resume."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as src:
            return src.read().strip()
    except OSError:
        return ""


_BOOT_ID = _boot_id()


class SpanJournal:
    """Append-only sidecar recording which byte spans of a ``.part``
    file are durably written, so a restarted job re-fetches only the
    gaps. One header line pins the object size AND the server's
    validator (ETag/Last-Modified) this journal describes; a change in
    either — the URL now serves a different object, possibly at the
    SAME size — discards the journal wholesale rather than stitching
    bytes of two objects together. Thread-safe appends; a torn final
    line from a crash mid-append is ignored on load."""

    _MAGIC = "downloader-spans v1"

    def __init__(self, path: str, total: int, spans: SpanSet, fresh: bool,
                 validator: str = ""):
        self.path = path
        self.total = total
        self.spans = spans  # guarded-by: _lock
        self._lock = threading.Lock()
        mode = "w" if fresh else "a"
        self._sink = open(path, mode)
        if fresh:
            self._sink.write(
                f"{self._MAGIC} total={total} boot={_BOOT_ID} "
                f"validator={validator}\n"
            )
            self._sink.flush()

    @classmethod
    def open(cls, path: str, total: int, validator: str = "") -> "SpanJournal":
        spans = SpanSet()
        fresh = True
        try:
            with open(path, "r") as src:
                header = src.readline().strip()
                expected = (
                    f"{cls._MAGIC} total={total} boot={_BOOT_ID} "
                    f"validator={validator}"
                )
                if header == expected:
                    fresh = False
                    for line in src:
                        parts = line.split()
                        if len(parts) != 2:
                            continue  # torn tail from a crash mid-append
                        try:
                            lo, hi = int(parts[0]), int(parts[1])
                        except ValueError:
                            continue
                        if 0 <= lo < hi <= total:
                            spans.add(lo, hi)
        except OSError:
            pass
        if fresh:
            spans = SpanSet()
        return cls(path, total, spans, fresh, validator)

    def add(self, start: int, end: int) -> None:
        with self._lock:
            self.spans.add(start, end)
            self._sink.write(f"{start} {end}\n")
            self._sink.flush()

    def missing(self) -> list[tuple[int, int]]:
        with self._lock:
            return self.spans.missing(self.total)

    def covered_spans(self) -> list[tuple[int, int]]:
        with self._lock:
            return self.spans.spans()

    def close(self) -> None:
        with self._lock:
            try:
                self._sink.close()
            except OSError:
                pass

    def remove(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


class _Probe:
    __slots__ = ("scheme", "host", "port", "request_path", "total",
                 "content_disposition", "validator", "accept_ranges")

    def __init__(self, scheme, host, port, request_path, total, cd,
                 validator="", accept_ranges=True):
        self.scheme = scheme
        self.host = host
        self.port = port
        self.request_path = request_path
        self.total = total
        self.content_disposition = cd
        # ETag/Last-Modified captured at probe time: pins the journal
        # to THIS version of the object and rides If-Range on segment
        # GETs (a weak ETag can do the former but not the latter)
        self.validator = validator
        # segmentation needs ranges; the small-object fast path does
        # not — it issues one whole-object GET either way
        self.accept_ranges = accept_ranges

    @property
    def strong_validator(self) -> str:
        return "" if self.validator.startswith("W/") else self.validator


class _Segment:
    """One claimed byte range. ``pos`` advances as bytes land on disk;
    ``stop`` is set when a rival copy (endgame) or a failure elsewhere
    makes further work on this range pointless. ``source`` is the
    transfer source (fetch/sources.py) the claim is assigned to."""

    __slots__ = (
        "start", "end", "pos", "reported", "stop", "rival", "done", "rescue",
        "source", "requeued",
    )

    def __init__(self, start: int, end: int, rival: "_Segment | None" = None):
        self.start = start
        self.end = end
        self.pos = start
        self.reported = start
        self.stop = threading.Event()
        self.rival = rival
        self.rescue = rival is not None  # born as an endgame duplicate
        self.done = False
        self.source: "source_accounting.Source | None" = None
        # a failed straggler/twin pair's tail goes back to the missing
        # set exactly ONCE (guarded by the state lock): whichever side
        # requeues marks both, or two live sources would fetch the same
        # offsets outside endgame
        self.requeued = False


class _FetchState:
    """Everything the segment workers share for one transfer."""

    def __init__(
        self,
        fetcher: "SegmentedFetcher",
        token: CancelToken,
        probe: _Probe,
        url: str,
        final_path: str,
        fd: int,
        journal: SpanJournal,
        sink,
        ranges: list[tuple[int, int]],
        progress,
        progress_interval: float,
        trace_parent,
        mirrors: "list[tuple[str, _Probe]] | None" = None,
    ):
        self.fetcher = fetcher
        self.token = token
        self.probe = probe
        self.url = url
        self.final_path = final_path
        self.fd = fd
        self.journal = journal
        self.sink = sink
        self.progress = progress
        self.trace_parent = trace_parent
        self._progress_interval = progress_interval
        # stall-watchdog heartbeat, captured on the job thread (like
        # trace_parent); segment workers bump it per received chunk —
        # a plain counter add, safe from any thread
        self.fetch_hb = watchdog.current().heartbeat("fetch")
        # named for lock-wait profiling: segment workers contend here
        # per claimed range, so waits land in lock_wait_seconds_*
        self._lock = profiling.named_lock(
            "segment_state", threading.Lock()
        )
        # the racing sources: primary first, then every admitted mirror
        # (probes already vetted by fetch() — same total, compatible
        # validator). The board owns rates/demotions; each source's
        # payload is its own probe, so segment GETs dial the RIGHT
        # origin with the RIGHT If-Range pin per source.
        self.board = source_accounting.SourceBoard(
            demote_ratio=getattr(fetcher, "_demote_ratio", None),
            retire_errors=getattr(fetcher, "_retire_errors", None),
            # flow-ledger attribution: every byte any source moves for
            # this transfer counts against ONE object identity — the
            # primary URL's — regardless of which mirror served it
            flow_object=flows.object_key(tracing.redact_url(url)),
        )
        self.primary = self.board.add(
            source_accounting.KIND_MIRROR, tracing.redact_url(url),
            payload=probe,
        )
        for mirror_url, mirror_probe in mirrors or ():
            self.board.add(
                source_accounting.KIND_MIRROR,
                tracing.redact_url(mirror_url),
                payload=mirror_probe,
            )
        self._queue: list[_Segment] = [  # guarded-by: _lock
            _Segment(lo, hi) for lo, hi in ranges
        ]
        self._active: list[_Segment] = []  # guarded-by: _lock
        self.failure: BaseException | None = None  # guarded-by: _lock
        self.redispatches = 0  # guarded-by: _lock
        # endgame budget. Single-source: ONE rescue per fetch (the
        # measured answer — healthy segments all finish around the same
        # time, and duplicating every tail re-downloads it, 0.78x on
        # the bench). Multi-source: one rescue per source — the whole
        # point of racing origins is that the last spans may sit on a
        # lane that just died or slowed, and each straggler is still
        # duplicated at most once.
        live_sources = self.board.live_count()
        self._rescue_budget = (  # guarded-by: _lock
            1 if live_sources <= 1 else live_sources
        )
        self._bytes_done = 0  # guarded-by: _lock
        self._last_tick = time.monotonic()  # guarded-by: _lock
        # incident-bundle introspection: this transfer's live internals
        # (active segment positions, queue depth, coverage). Held via
        # WeakMethod, so the probe expires with the state — no
        # unregister needed on the many exit paths of fetch()
        incident.RECORDER.register_probe(
            "http-segment-fetch", self.probe_state
        )

    def probe_state(self) -> dict:
        with self._lock:
            active = [
                {"start": seg.start, "end": seg.end, "pos": seg.pos,
                 "done": seg.done}
                for seg in self._active
            ]
            queued = len(self._queue)
            failure = str(self.failure) if self.failure else None
            redispatches = self.redispatches
        return {
            "url": tracing.redact_url(self.url),
            "total": self.probe.total,
            "covered_bytes": sum(
                hi - lo for lo, hi in self.journal.covered_spans()
            ),
            "queued_segments": queued,
            "active_segments": active,
            "redispatches": redispatches,
            "failure": failure,
            "heartbeat": self.fetch_hb.count,
            "sources": self.board.snapshot(),
        }

    # -- work distribution ------------------------------------------------

    def next_segment(self) -> _Segment | None:  # protocol: source-claim acquire conditional
        """Claim the next span for the best available source. Queued
        spans go to the board's pick (rate-weighted across active
        sources, one bounded span at a time for the trickle lane);
        with the queue drained, idle capacity races a straggler's
        remainder on ANOTHER source (endgame). None: nothing for this
        worker — done, failed, or every assignable lane is busy."""
        self.board.rebalance()
        with self._lock:
            if self.failure is not None:
                return None
            if self._queue:
                source = self.board.pick(queued=len(self._queue))
                if source is None:
                    # every live lane is at capacity (trickle-only
                    # moments); in-flight claims requeue through their
                    # own workers, so idle ones may stand down
                    return None
                seg = self._queue.pop(0)
                if (
                    source.state == source_accounting.TRICKLE
                    and seg.end - seg.start > TRICKLE_SPAN
                ):
                    # the trickle lane carries small spans only: the
                    # demoted source keeps being measured without
                    # parking megabytes behind a known-slow lane
                    self._queue.insert(
                        0, _Segment(seg.start + TRICKLE_SPAN, seg.end)
                    )
                    seg = _Segment(seg.start, seg.start + TRICKLE_SPAN)
                seg.source = source
                self.board.checkout(source)
                self._active.append(seg)
                return seg
            # endgame: duplicate the slowest straggler's remaining range
            # on this now-idle worker — on a DIFFERENT source when one
            # is live; at most one rival per segment and one rescue per
            # source (see _rescue_budget above)
            if self._rescue_budget <= 0:
                return None
            straggler = None
            for seg in self._active:
                if seg.done or seg.rival is not None or seg.stop.is_set():
                    continue
                remaining = seg.end - seg.pos
                if remaining < ENDGAME_MIN_REMAINING:
                    continue
                if straggler is None or remaining > (
                    straggler.end - straggler.pos
                ):
                    straggler = seg
            if straggler is None:
                return None
            rescue_source = self.board.pick_rescue(straggler.source)
            if rescue_source is None:
                return None
            # steal from the REPORTED mark, not the in-memory pos: the
            # journal (and the streaming sink) only cover up to
            # ``reported``, and a loser cancelled mid-window exits with
            # written-but-unreported bytes — starting the twin at pos
            # would leave [reported, pos) covered by neither copy. The
            # ≤1 report-window overlap re-downloads identical bytes.
            twin = _Segment(straggler.reported, straggler.end, rival=straggler)
            twin.source = rescue_source
            self.board.checkout(rescue_source)
            straggler.rival = twin
            self._active.append(twin)
            self.redispatches += 1
            self._rescue_budget -= 1
        metrics.GLOBAL.add("http_segment_redispatches")
        log.with_fields(
            url=tracing.redact_url(self.url),
            start=twin.start,
            end=twin.end,
            source=rescue_source.name,
        ).info("endgame: racing straggling segment range across sources")
        return twin

    def complete(self, seg: _Segment) -> None:  # protocol: source-claim release bind=seg
        with self._lock:
            seg.done = True
            rival = seg.rival
            source = seg.source
        if source is not None:
            self.board.checkin(source)
            self.board.note_success(source)
        # first copy across the finish line cancels the loser
        if rival is not None and not rival.done:
            rival.stop.set()

    def abandon(self, seg: _Segment) -> None:  # protocol: source-claim release bind=seg
        """A rescue twin giving up WITHOUT cancelling its rival — the
        straggler still owns the range; only the duplicate dies."""
        with self._lock:
            seg.done = True
            source = seg.source
        if source is not None:
            self.board.checkin(source)

    def release_failed(self, seg: _Segment, exc: BaseException) -> None:  # protocol: source-claim release bind=seg
        """The single release point for every failed claim: classify
        the failure, return the claim's unfinished range to the missing
        set when another live source can absorb it, and fail the whole
        fetch only when the job is truly out of sources. Written-but-
        unjournaled bytes are reported first — they are on disk, and a
        requeue from ``pos`` without them would leave [reported, pos)
        covered by neither source."""
        from .http import TransferError

        def job_level(err: BaseException) -> BaseException:
            # SourceRejected is a per-source verdict; when it must fail
            # the JOB it becomes a plain TransferError so the daemon's
            # transient-retry classification applies unchanged (a raw
            # SourceRejected would miss the retry's except clause)
            if isinstance(err, SourceRejected):
                wrapped = TransferError(str(err))
                wrapped.__cause__ = err
                return wrapped
            if (
                isinstance(err, RangeDropped)
                and source is not None
                and source is not self.primary
            ):
                # the single-source RangeDropped fallback discards the journal
                # and single-streams the PRIMARY URL — right when the
                # primary itself dropped Range, wrong when a last-
                # standing MIRROR did (the primary may already be dead,
                # and the journaled bytes are the job's only progress).
                # Fail job-level instead: the broker retry re-probes
                # and resumes from the journal.
                wrapped = TransferError(
                    f"mirror stopped honoring Range mid-job ({err!r}); "
                    "retry resumes from the span journal"
                )
                wrapped.__cause__ = err
                return wrapped
            return err

        source = seg.source
        if not isinstance(exc, (TransferError, RangeDropped, SourceRejected)):
            # cancellation / unexpected: the job dies (journal and part
            # file stay on disk for the broker retry)
            if source is not None:
                self.board.checkin(source)
            with self._lock:
                seg.done = True
            self.fail(exc)
            return
        if seg.rescue:
            # the rescue is a pure optimization and its range is still
            # owned by the straggler; an origin rejecting the EXTRA
            # connection (per-client caps → 503s) must not kill the
            # healthy transfer it was backing up
            self.abandon(seg)
            if source is not None:
                # a deterministic answer (200 instead of 206, 4xx) is
                # just as final on a rescue claim as on a primary one:
                # the source retires, it doesn't linger in the trickle
                # lane failing the same way per claim
                self.board.note_error(
                    source,
                    permanent=isinstance(
                        exc, (RangeDropped, SourceRejected)
                    ),
                )
            # the twin's written window is on disk: journal it, or an
            # orphan requeue from ``pos`` below would leave
            # [reported, pos) covered by neither copy
            self.report(seg)
            with self._lock:
                # ... unless the straggler ALREADY died: it skipped its
                # own requeue because this twin owned the range, so the
                # uncovered tail now belongs to NOBODY — return it to
                # the missing set (both writers journaled up to their
                # pos, so the requeue starts past the further of them)
                rival = seg.rival
                orphaned = (
                    rival is not None
                    and rival.done
                    and rival.pos < rival.end
                    and not seg.requeued
                    and not rival.requeued
                    and self.failure is None
                )
                if orphaned:
                    seg.requeued = rival.requeued = True
                    lo = max(seg.pos, rival.pos)
                    if lo < seg.end:
                        self._queue.insert(0, _Segment(lo, seg.end))
            log.with_fields(url=tracing.redact_url(self.url)).info(
                f"endgame rescue gave up ({exc})"
            )
            return
        if source is not None:
            self.board.checkin(source)
        permanent = isinstance(exc, (RangeDropped, SourceRejected))
        # survivors = live sources OTHER than the failing one: the
        # failing source never counts as its own survivor (a sibling
        # claim's failure may have retired it already, and counting
        # the healthy remainder as "last source standing" would kill
        # a job the mirror could finish)
        if source is None or self.board.live_count(exclude=source) < 1:
            # the last source standing: single-source semantics bit for bit —
            # the fetch fails (RangeDropped falls back to single-stream
            # upstream)
            with self._lock:
                seg.done = True
            if source is not None:
                self.board.retire(source)
            self.fail(job_level(exc))
            return
        self.board.note_error(source, permanent=permanent)
        metrics.GLOBAL.add("http_source_failovers")
        # journal the written-but-unreported window before the requeue
        self.report(seg)
        with self._lock:
            seg.done = True
            rival = seg.rival
            rival_owns = rival is not None and not rival.done
            already = seg.requeued or (rival is not None and rival.requeued)
            if (
                seg.pos < seg.end
                and not rival_owns
                and not already
                and self.failure is None
            ):
                seg.requeued = True
                if rival is not None:
                    rival.requeued = True
                # start past the further write mark of the pair: a dead
                # twin journaled up to its own pos too
                lo = (
                    max(seg.pos, rival.pos) if rival is not None else seg.pos
                )
                if lo < seg.end:
                    self._queue.insert(0, _Segment(lo, seg.end))
        log.with_fields(
            url=tracing.redact_url(self.url),
            source=source.name,
            start=seg.pos,
            end=seg.end,
        ).warning("source failed mid-job; remaining sources absorb its span")
        if self.board.live_count() == 0:
            # a concurrent failure retired the other sources too
            self.fail(job_level(exc))

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self.failure is None:
                self.failure = exc
            self._queue.clear()
            active = list(self._active)
        for seg in active:
            seg.stop.set()

    # -- byte accounting --------------------------------------------------

    def report(self, seg: _Segment) -> None:
        """Advertise ``[seg.reported, seg.pos)``: journal first (resume
        truth), then the streaming sink (speculative upload)."""
        lo, hi = seg.reported, seg.pos
        if hi <= lo:
            return
        seg.reported = hi
        self.journal.add(lo, hi)
        self.sink.add_span(self.final_path, lo, hi)

    def note_bytes(self, seg: _Segment, got: int) -> None:
        self.fetch_hb.beat(got)
        if seg.source is not None:
            # per-source EWMA + the per-kind byte counters: what the
            # scheduler's demotion/promotion decisions run on
            self.board.note_bytes(seg.source, got)
        with self._lock:
            self._bytes_done += got
            now = time.monotonic()
            if now - self._last_tick < self._progress_interval:
                return
            self._last_tick = now
            done = self.journal.spans.total()
        self.progress(
            self.url, min(done / self.probe.total * 100, 99.9)
        )


class SegmentedFetcher:
    """Plans and runs one segmented transfer (see module doc). Owned by
    the HTTP backend; the connection pool it holds is shared across
    segments AND across jobs for the backend's lifetime."""

    def __init__(
        self,
        pool: ConnectionPool | None = None,
        segments: int | None = None,
        min_segment_bytes: int | None = None,
        timeout: float = 30.0,
        max_attempts: int = 3,
        progress_interval: float = 1.0,
        demote_ratio: float | None = None,
        retire_errors: int | None = None,
    ):
        self.pool = pool or ConnectionPool(timeout=timeout)
        self._limit = segments_from_env() if segments is None else segments
        self._min_bytes = (
            min_segment_bytes_from_env()
            if min_segment_bytes is None
            else min_segment_bytes
        )
        self._timeout = timeout
        self._max_attempts = max_attempts
        self._progress_interval = progress_interval
        # multi-source racing knobs (fetch/sources.py): when to demote
        # a slow source to the trickle lane and when repeated failures
        # retire one for the job
        self._demote_ratio = (
            source_accounting.demote_ratio_from_env()
            if demote_ratio is None
            else demote_ratio
        )
        self._retire_errors = (
            source_accounting.retire_errors_from_env()
            if retire_errors is None
            else retire_errors
        )
        self._declined: dict[str, float] = {}  # url -> expiry; guarded-by: _declined_lock
        self._declined_lock = threading.Lock()
        # url -> (probe | None, expiry): every HEAD verdict — usable or
        # not — is remembered so batch classification and the fast path
        # pay at most one probe round trip per URL per PROBE_TTL.
        # None records "HEAD answered but unusable" (redirect, no
        # length); connection-level failures are NOT cached (transient).
        self._probes: dict[str, tuple[_Probe | None, float]] = {}  # guarded-by: _probes_lock
        self._probes_lock = profiling.named_lock(
            "probe_cache", threading.Lock()
        )

    @property
    def enabled(self) -> bool:
        return self._limit > 1

    def _declined_recently(self, url: str) -> bool:
        now = time.monotonic()
        with self._declined_lock:
            expires = self._declined.get(url)
            if expires is None:
                return False
            if expires <= now:
                del self._declined[url]
                return False
            return True

    def _note_declined(self, url: str) -> None:
        now = time.monotonic()
        with self._declined_lock:
            if len(self._declined) >= _DECLINE_CACHE_MAX:
                live = {
                    key: at for key, at in self._declined.items() if at > now
                }
                while len(live) >= _DECLINE_CACHE_MAX:
                    live.pop(min(live, key=live.get))
                self._declined = live
            self._declined[url] = now + DECLINE_TTL

    # -- probe cache ------------------------------------------------------

    _PROBE_MISS = object()  # "nothing cached" (None is a cached verdict)

    def _remember_probe(self, url: str, probe: "_Probe | None") -> None:
        now = time.monotonic()
        with self._probes_lock:
            if len(self._probes) >= _PROBE_CACHE_MAX:
                live = {
                    key: entry for key, entry in self._probes.items()
                    if entry[1] > now
                }
                while len(live) >= _PROBE_CACHE_MAX:
                    live.pop(min(live, key=lambda k: live[k][1]))
                self._probes = live
            self._probes[url] = (probe, now + PROBE_TTL)

    def _forget_probe(self, url: str) -> None:
        with self._probes_lock:
            self._probes.pop(url, None)

    def _cached_probe(self, url: str):
        """The cached probe verdict: a ``_Probe``, None (probed and
        unusable), or ``_PROBE_MISS`` (never probed / expired)."""
        now = time.monotonic()
        with self._probes_lock:
            entry = self._probes.get(url)
            if entry is None:
                return self._PROBE_MISS
            probe, expires = entry
            if expires <= now:
                del self._probes[url]
                return self._PROBE_MISS
        metrics.GLOBAL.add("http_probe_cache_hits")
        return probe

    def probe_size(self, url: str, token: CancelToken | None = None) -> int | None:
        """Object size in bytes when a (possibly cached) HEAD can say,
        else None — the batch classifier's one question. Warm cache
        answers without any network round trip."""
        cached = self._cached_probe(url)
        if cached is not self._PROBE_MISS:
            return None if cached is None else cached.total
        probe = self.probe(url, token)
        return None if probe is None else probe.total

    def close(self) -> None:
        self.pool.close()

    # -- probe ------------------------------------------------------------

    def probe(
        self, url: str, token: CancelToken | None = None
    ) -> _Probe | None:
        """One HEAD through the pool; None means the HEAD was unusable
        (non-http scheme, userinfo, proxy env, redirect, no
        Content-Length) — the caller falls back with no side effects.
        A returned probe may still decline STRIPING (``accept_ranges``
        False); the small-object fast path doesn't care. Every verdict
        that cost a round trip lands in the probe cache."""
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme not in ("http", "https"):
            return None
        if "@" in parsed.netloc:
            return None  # userinfo auth: the urllib path owns that
        host = parsed.hostname
        if not host:
            return None
        if parsed.scheme in urllib.request.getproxies():
            # the pooled connections dial origins DIRECTLY; in a
            # proxy-only network that stalls to the connect timeout per
            # URL. The urllib single-stream path honors the proxy env —
            # let it own these transfers (unless no_proxy exempts the
            # host).
            try:
                bypassed = urllib.request.proxy_bypass(host)
            except OSError:
                bypassed = False
            if not bypassed:
                return None
        port = parsed.port or (443 if parsed.scheme == "https" else 80)
        request_path = parsed.path or "/"
        if parsed.query:
            request_path += "?" + parsed.query
        while True:
            if token is not None and token.cancelled():
                return None
            pooled = self.pool.acquire(
                parsed.scheme, host, port, self._timeout
            )
            conn = pooled.conn
            remove_cancel_hook = (
                token.add_callback(lambda: _abort_connection(conn))
                if token is not None
                else lambda: None
            )
            try:
                with tracing.span("http-probe"):
                    pooled.conn.request(
                        "HEAD", request_path,
                        headers={"Accept-Encoding": "identity"},
                    )
                    response = pooled.conn.getresponse()
                    response.read()  # HEAD: no body, settle the parser
                break
            except (http.client.HTTPException, OSError):
                self.pool.release(pooled, reusable=False)
                if pooled.fresh:
                    return None
                # a parked keep-alive the server closed while idle:
                # per the pool's contract that's a stale entry, not a
                # probe verdict — declining here would cache 60 s of
                # "single-stream" off a dead socket. Loop: the pool
                # drains its stale shelf and eventually hands a fresh
                # connection, whose failure is a real answer.
            finally:
                remove_cancel_hook()
        self.pool.release(pooled, reusable=not response.will_close)
        if response.status != 200:
            self._remember_probe(url, None)
            return None  # redirects/405/errors: urllib handles those
        length = response.getheader("Content-Length") or ""
        if not length.isdigit() or int(length) <= 0:
            self._remember_probe(url, None)
            return None
        probe = _Probe(
            parsed.scheme, host, port, request_path, int(length),
            response.getheader("Content-Disposition"),
            validator=(
                response.getheader("ETag")
                or response.getheader("Last-Modified")
                or ""
            ).strip(),
            accept_ranges="bytes" in (
                response.getheader("Accept-Ranges") or ""
            ).lower(),
        )
        self._remember_probe(url, probe)
        return probe

    # -- the transfer ------------------------------------------------------

    def fetch(
        self,
        token: CancelToken,
        base_dir: str,
        progress,
        url: str,
        mirrors: "tuple[str, ...] | list[str]" = (),
    ) -> bool:
        """Run the (multi-source) segmented transfer end to end. True:
        the file is complete at its final path. False: not segmentable
        (or Range support vanished mid-job on the last live source) —
        run the single-stream path. ``mirrors`` are alternate URLs for
        the SAME object; each is admitted only when its probe matches
        the primary's size (and strong validator, when both carry
        one) — a mismatched mirror is skipped, never trusted."""
        from .http import TransferError, filename_for

        if not self.enabled or self._declined_recently(url):
            return False
        probe = self.probe(url, token)
        if probe is None or not probe.accept_ranges:
            # a probe killed by cancellation is not a verdict on the
            # server — caching it would single-stream the next 60 s
            token.raise_if_cancelled()
            self._note_declined(url)
            return False
        count = segment_count(probe.total, self._limit, self._min_bytes)
        if count < 2:
            self._note_declined(url)
            return False
        admitted = self._admit_mirrors(token, url, probe, mirrors)

        final_path = os.path.join(
            base_dir, filename_for(url, probe.content_disposition)
        )
        part_path = final_path + ".part"
        journal_path = part_path + ".spans"

        # the journal is only as good as the part file it describes: an
        # orphaned journal (crash between rename and journal removal, or
        # a single-stream fallback that replaced the .part under it)
        # over a fresh zero-filled file would mark garbage as covered —
        # silent corruption. Trust it only when the part file exists at
        # exactly the probed size (segmented part files are always
        # preallocated to total; a single-stream .part is its prefix).
        try:
            part_matches = os.path.getsize(part_path) == probe.total
        except OSError:
            part_matches = False
        if not part_matches:
            try:
                os.unlink(journal_path)
            except OSError:
                pass

        journal = SpanJournal.open(journal_path, probe.total, probe.validator)
        part_file = open(part_path, "r+b" if os.path.exists(part_path) else "w+b")
        # scratch-disk budget (utils/admission.py): the preallocation
        # below commits `total` bytes of scratch, so the global ledger
        # is charged here and refunded when this fetch stops being the
        # one holding the scratch (success, failure, or cancel — a
        # kept-on-disk resume file is idle capacity, not active
        # pressure). `charge`, not `try_charge`: the job was already
        # admitted, so the allocation proceeds and the admission ladder
        # reacts to the recorded pressure at the next dequeue wave.
        scratch = admission.scratch_key(part_path)
        admission.LEDGER.charge("disk", scratch, probe.total)
        state: _FetchState | None = None
        try:
            if FAILPOINTS.fire("segments.preallocate"):
                raise OSError(28, "failpoint: segments.preallocate disk full")
            os.truncate(part_file.fileno(), probe.total)

            sink = transfer_progress.current()
            sink.begin_file(final_path, probe.total, read_path=part_path)
            resumed = journal.covered_spans()
            for lo, hi in resumed:
                sink.add_span(final_path, lo, hi)
            resumed_bytes = sum(hi - lo for lo, hi in resumed)
            if resumed_bytes:
                metrics.GLOBAL.add("http_segment_bytes_resumed", resumed_bytes)
                log.with_fields(
                    url=tracing.redact_url(url), resumed=resumed_bytes
                ).info("span journal resume: refetching only missing ranges")

            ranges = plan_ranges(journal.missing(), count, self._min_bytes)
            state = _FetchState(
                self, token, probe, url, final_path, part_file.fileno(),
                journal, sink, ranges, progress, self._progress_interval,
                tracing.current_span(), mirrors=admitted,
            )
            if ranges:
                metrics.GLOBAL.observe(
                    "http_segments_per_fetch", len(ranges),
                    buckets=metrics.COUNT_BUCKETS,
                )
                if admitted:
                    metrics.GLOBAL.add("http_multi_source_fetches")
                workers = [
                    threading.Thread(  # thread-role: segment-worker
                        target=self._worker, args=(state,),
                        name=f"http-seg-{i}", daemon=True,
                    )
                    for i in range(min(count, len(ranges)))
                ]
                for worker in workers:
                    worker.start()
                    profiling.ROLES.register_thread(
                        worker, "segment-worker"
                    )
                for worker in workers:
                    # deadline: segment workers run on sockets with finite timeouts and the fetch cancel hook shuts their sockets down, so each join is bounded
                    worker.join()

            if state.failure is not None:
                if isinstance(state.failure, RangeDropped):
                    # the striped plan is void and a single-stream rerun
                    # may receive different bytes: discard everything
                    # speculative and hand back to the caller
                    part_file.close()
                    journal.remove()
                    try:
                        os.unlink(part_path)
                    except OSError:
                        pass
                    sink.invalidate(final_path)
                    # the HEAD said ranges work and the GETs said
                    # otherwise: believe the GETs for a while, or a
                    # broker retry loops probe→stripe→fallback forever
                    self._note_declined(url)
                    metrics.GLOBAL.add("http_segmented_fallbacks")
                    log.with_fields(url=tracing.redact_url(url)).warning(
                        "server stopped honoring Range mid-job; "
                        "falling back to single-stream"
                    )
                    return False
                # journal + part file stay on disk: a broker retry of
                # this job resumes from the span journal
                raise state.failure

            gaps = journal.missing()
            if gaps:
                raise TransferError(
                    f"segmented fetch left {len(gaps)} uncovered ranges"
                )
        except BaseException:
            # Cancelled and TransferError both keep the part file and
            # journal ON DISK — a broker retry resumes from them
            part_file.close()
            journal.close()
            raise
        finally:
            admission.LEDGER.refund(scratch)
            if state is not None:
                # settle the per-kind active-source gauges whichever
                # way this fetch ended
                state.board.close()
        part_file.close()

        os.replace(part_path, final_path)
        journal.remove()
        sink.finish_file(final_path)
        metrics.GLOBAL.add("http_bytes_fetched", probe.total - resumed_bytes)
        metrics.GLOBAL.add("http_files_fetched")
        metrics.GLOBAL.add("http_segmented_fetches")
        # one complete copy of the object served: unique bytes are the
        # amplification ratio's denominator (max semantics — a broker
        # retry re-fetching this object inflates demand, never unique)
        flows.LEDGER.note_unique(
            flows.object_key(tracing.redact_url(url)), probe.total
        )
        progress(url, 100.0)
        return True

    def _admit_mirrors(
        self, token: CancelToken, url: str, probe: _Probe, mirrors
    ) -> "list[tuple[str, _Probe]]":
        """Vet each candidate mirror with its own (cached) HEAD: only a
        mirror that accepts ranges and reports the primary's exact size
        may serve spans of this object — and when both ends carry a
        strong validator, those must agree too (same size, different
        ETag means a different object, and stitching two objects into
        one file is silent corruption). A rejected mirror just means
        fewer lanes; it is never fatal.

        Probes run CONCURRENTLY under one aggregate budget: a dead or
        black-holed mirror must cost the job one bounded wait, not
        MIRROR_MAX serial connect timeouts before the first byte (the
        same hostile-HEAD shape the admission layer budgets its byte
        probes against). A candidate whose probe outlives the budget is
        skipped for THIS job; its probe thread parks on its socket
        timeout and feeds the probe cache for the next one."""
        candidates = [
            m for m in dict.fromkeys(mirrors or ()) if m != url
        ]
        if not candidates:
            return []
        results: "dict[str, _Probe | None]" = {}

        def probe_one(mirror_url: str) -> None:
            try:
                cached = self._cached_probe(mirror_url)
                if cached is not self._PROBE_MISS:
                    results[mirror_url] = cached
                    return
                verdict = self.probe(mirror_url, token)
                if verdict is None:
                    # probe() deliberately does not cache connect-level
                    # failures (transient for a RETRYING caller); for
                    # admission the verdict is the same either way —
                    # negative-cache it here so a dead mirror costs
                    # jobs one budget per PROBE_TTL, not one each.
                    # This line also runs from a thread that outlived
                    # the budget, feeding the cache for the next job.
                    self._remember_probe(mirror_url, None)
                results[mirror_url] = verdict
            except Exception as exc:
                # a probe must never kill the job; unanswered == skip
                log.with_fields(
                    mirror=tracing.redact_url(mirror_url)
                ).debug(f"mirror probe failed ({exc})")
                results[mirror_url] = None

        threads = [
            threading.Thread(
                target=probe_one, args=(m,),
                name="mirror-probe", daemon=True,
            )
            for m in candidates
        ]
        for thread in threads:
            thread.start()
        deadline = time.monotonic() + min(self._timeout, MIRROR_PROBE_BUDGET)
        for thread in threads:
            # deadline: each join is bounded by the shared probe budget computed above
            thread.join(max(0.0, deadline - time.monotonic()))
        token.raise_if_cancelled()
        admitted: "list[tuple[str, _Probe]]" = []
        for mirror_url in candidates:
            in_time = mirror_url in results
            mirror_probe = results.get(mirror_url)
            reason = None
            if not in_time:
                reason = "probe outlived the admission budget"
            elif mirror_probe is None or not mirror_probe.accept_ranges:
                reason = "no usable ranged HEAD"
            elif mirror_probe.total != probe.total:
                reason = (
                    f"size {mirror_probe.total} != primary {probe.total}"
                )
            elif (
                probe.strong_validator
                and mirror_probe.strong_validator
                and mirror_probe.strong_validator != probe.strong_validator
            ):
                reason = "strong validator disagrees with the primary"
            if reason is not None:
                metrics.GLOBAL.add("http_mirror_rejects")
                log.with_fields(
                    url=tracing.redact_url(url),
                    mirror=tracing.redact_url(mirror_url),
                ).warning(f"mirror not admitted ({reason})")
                continue
            admitted.append((mirror_url, mirror_probe))
        return admitted

    # -- small-object fast path --------------------------------------------

    def fetch_small(
        self,
        token: CancelToken,
        base_dir: str,
        progress,
        url: str,
        max_bytes: int,
    ) -> bool:
        """One whole-object GET over a pooled keep-alive connection for
        objects at most ``max_bytes`` — the batched small-job data
        path. No striping, no preallocation, no span journal, no
        streaming sink (small objects are below the multipart floor, so
        store-and-forward is the upload path either way): the fixed
        cost left is ONE request on an (ideally reused) connection.

        True: the file is complete at its final path. False: the fast
        path can't own this URL (unknown size, too big, redirect, the
        GET's headers disagree with the probe) — run the normal path,
        which handles every such case already. Transfer-level failures
        after eligibility raise TransferError like any backend."""
        from .http import TransferError, filename_for

        probe = self._cached_probe(url)
        if probe is self._PROBE_MISS:
            probe = self.probe(url, token)
        if probe is None:
            token.raise_if_cancelled()
            return False
        if probe.total > max_bytes:
            return False

        final_path = os.path.join(
            base_dir, filename_for(url, probe.content_disposition)
        )
        part_path = final_path + ".part"
        fetch_hb = watchdog.current().heartbeat("fetch")
        attempts = 0
        span = tracing.span("http-small", url=tracing.redact_url(url))
        with span:
            while True:
                token.raise_if_cancelled()
                pooled = self.pool.acquire(
                    probe.scheme, probe.host, probe.port, self._timeout
                )
                reused = not pooled.fresh
                conn = pooled.conn
                remove_cancel_hook = token.add_callback(
                    lambda: _abort_connection(conn)
                )
                try:
                    try:
                        pooled.conn.request(
                            "GET", probe.request_path,
                            headers={"Accept-Encoding": "identity"},
                        )
                        response = pooled.conn.getresponse()
                    except (http.client.HTTPException, OSError) as exc:
                        self.pool.release(pooled, reusable=False)
                        token.raise_if_cancelled()
                        if reused:
                            # parked keep-alive the server closed while
                            # idle: stale pool entry, retry free
                            continue
                        attempts += 1
                        if attempts > self._max_attempts:
                            raise TransferError(
                                f"small-object request failed: {exc}"
                            ) from exc
                        time.sleep(min(0.2 * attempts, 1.0))
                        continue
                    try:
                        got = self._consume_small(
                            token, probe, url, response, part_path,
                            max_bytes, fetch_hb,
                        )
                    except BaseException:
                        # deterministic HTTP error or cancel: the
                        # checked-out socket must not strand
                        self.pool.release(pooled, reusable=False)
                        raise
                    if got is None:
                        # headers disagree with the probe (redirect,
                        # changed object, now-too-big): hand the job to
                        # the normal path, which handles all of those
                        self.pool.release(pooled, reusable=False)
                        self._forget_probe(url)
                        return False
                    self.pool.release(
                        pooled,
                        reusable=getattr(response, "length", None) == 0
                        and not response.will_close,
                    )
                    if got:
                        span.annotate(bytes=got, reused=reused)
                        break
                    # short read: restart the tiny transfer from scratch
                    attempts += 1
                    if attempts > self._max_attempts:
                        raise TransferError(
                            f"small-object fetch stalled after "
                            f"{attempts} attempts"
                        )
                    time.sleep(min(0.2 * attempts, 1.0))
                finally:
                    remove_cancel_hook()

        os.replace(part_path, final_path)
        try:
            # a stale span journal from an earlier segmented attempt
            # must not outlive the part file it described
            os.unlink(part_path + ".spans")
        except OSError:
            pass
        metrics.GLOBAL.add("http_bytes_fetched", got)
        metrics.GLOBAL.add("http_files_fetched")
        metrics.GLOBAL.add("http_small_fetches")
        # the batched lane bypasses the SourceBoard, so it feeds the
        # flow ledger directly: whole-object GET = demand AND one
        # served copy in one note pair
        small_obj = flows.object_key(tracing.redact_url(url))
        flows.LEDGER.note_ingress(
            small_obj, probe.host, source_accounting.KIND_MIRROR, got
        )
        flows.LEDGER.note_unique(small_obj, got)
        progress(url, 100.0)
        return True

    def _consume_small(
        self,
        token: CancelToken,
        probe: _Probe,
        url: str,
        response: http.client.HTTPResponse,
        part_path: str,
        max_bytes: int,
        fetch_hb,
    ) -> int | None:
        """Write one whole-object response to ``part_path``. Returns
        the byte count on success, 0 on a short read (caller retries),
        None when this response proves the fast path wrong for the URL
        (caller falls back). Raises TransferError on deterministic
        HTTP errors."""
        from .http import TransferError

        with response:
            if response.status != 200:
                if response.status >= 500 or response.status == 429:
                    response.read()  # drain; transient, caller retries
                    return 0
                if response.status in (301, 302, 303, 307, 308):
                    return None  # urllib's redirect handling owns these
                raise TransferError(
                    f"http status {response.status} for small-object GET"
                )
            length = response.getheader("Content-Length") or ""
            if not length.isdigit():
                return None  # chunked/unknown: the urllib path owns it
            total = int(length)
            if total != probe.total:
                # object changed since the probe; still fine if small
                if total > max_bytes or total <= 0:
                    return None
            wrote = 0
            with open(part_path, "wb") as sink:
                while wrote < total:
                    if token.cancelled():
                        raise Cancelled()
                    try:
                        if FAILPOINTS.fire("http.read"):
                            raise TimeoutError("failpoint: http.read")
                        chunk = response.read(min(_CHUNK, total - wrote))
                    except (
                        http.client.HTTPException, OSError, TimeoutError,
                        ValueError,  # cancel hook closed the fd mid-read
                    ):
                        token.raise_if_cancelled()
                        return 0  # retry from scratch
                    if not chunk:
                        return 0  # short read; retry from scratch
                    sink.write(chunk)
                    wrote += len(chunk)
                    fetch_hb.beat(len(chunk))
            return wrote

    # -- workers -----------------------------------------------------------

    def _worker(self, state: _FetchState) -> None:
        with tracing.adopt(state.trace_parent):
            while True:
                seg = state.next_segment()
                if not seg:
                    return
                try:
                    self._fetch_segment(state, seg)
                except BaseException as exc:
                    # every failure path releases through ONE gate: the
                    # state decides whether the source retires and the
                    # span requeues (other sources absorb it) or the
                    # whole fetch dies (last source standing)
                    state.release_failed(seg, exc)
                    if state.failure is not None:
                        return
                    continue
                state.complete(seg)

    def _fetch_segment(self, state: _FetchState, seg: _Segment) -> None:
        from .http import TransferError

        # the claim's own source decides which origin the GETs dial and
        # which validator pins If-Range — per-source, per the design's
        # "ETag/If-Range pinning and resume-journal semantics per
        # source" (the journal itself stays pinned to the primary)
        source = seg.source
        probe = source.payload if source is not None else state.probe
        attempts = 0
        span = tracing.span(
            "http-segment", start=seg.start, end=seg.end, rescue=seg.rescue,
            source=source.name if source is not None else "primary",
            kind=source.kind if source is not None else "mirror",
        )
        with span:
            metrics.GLOBAL.gauge_add("http_segments_in_flight", 1)
            try:
                while seg.pos < seg.end and not seg.stop.is_set():
                    state.token.raise_if_cancelled()
                    pooled = self.pool.acquire(
                        probe.scheme, probe.host, probe.port, self._timeout
                    )
                    reused = not pooled.fresh
                    headers = {
                        "Range": f"bytes={seg.pos}-{seg.end - 1}",
                        "Accept-Encoding": "identity",
                    }
                    if probe.strong_validator:
                        # the object replaced mid-transfer answers 200
                        # instead of 206 → RangeDropped → clean restart
                        headers["If-Range"] = probe.strong_validator
                    # cancellation must abort a blocked connect/read
                    # NOW, not at the socket timeout — same contract as
                    # every other transfer path (http.py, peerwire, s3)
                    conn = pooled.conn
                    remove_cancel_hook = state.token.add_callback(
                        lambda: _abort_connection(conn)
                    )
                    try:
                        try:
                            pooled.conn.request(
                                "GET", probe.request_path, headers=headers,
                            )
                            response = pooled.conn.getresponse()
                        except (http.client.HTTPException, OSError) as exc:
                            self.pool.release(pooled, reusable=False)
                            state.token.raise_if_cancelled()
                            if reused:
                                # a parked keep-alive the server closed:
                                # stale pool entry, not a transfer failure
                                continue
                            attempts += 1
                            if attempts > self._max_attempts:
                                raise TransferError(
                                    f"segment request failed: {exc}"
                                ) from exc
                            time.sleep(min(0.2 * attempts, 1.0))
                            continue

                        try:
                            drained = self._consume_response(
                                state, seg, response
                            )
                        except BaseException:
                            self.pool.release(pooled, reusable=False)
                            raise
                        self.pool.release(pooled, reusable=drained)
                    finally:
                        remove_cancel_hook()
                    if seg.pos < seg.end and not seg.stop.is_set():
                        # short read or transient status: burn an attempt
                        attempts += 1
                        if attempts > self._max_attempts:
                            raise TransferError(
                                f"segment [{seg.start}, {seg.end}) stalled "
                                f"at {seg.pos} after {attempts} attempts"
                            )
                        time.sleep(min(0.2 * attempts, 1.0))
            finally:
                metrics.GLOBAL.gauge_add("http_segments_in_flight", -1)
                span.annotate(bytes=seg.pos - seg.start)

    def _consume_response(
        self,
        state: _FetchState,
        seg: _Segment,
        response: http.client.HTTPResponse,
    ) -> bool:
        """Write one ranged response's body at its offsets. Returns
        True when the body was drained to its end (connection clean for
        reuse). Raises RangeDropped / SourceRejected on protocol-level
        surprises (permanent for the serving source); transient
        statuses just return False."""
        with response:
            if response.status == 200:
                # mid-job loss of Range support: this SOURCE is done —
                # other live sources absorb its spans; the last source
                # standing falls the whole fetch back to single-stream
                raise RangeDropped()
            if response.status != 206:
                response.read()  # drain the error body best-effort
                if response.status < 500 and response.status != 429:
                    raise SourceRejected(
                        f"http status {response.status} for ranged GET"
                    )
                return False  # transient; the attempt loop retries
            match = _CONTENT_RANGE.match(
                (response.getheader("Content-Range") or "").strip()
            )
            if not match:
                raise SourceRejected(
                    "malformed Content-Range on ranged response: "
                    f"{response.getheader('Content-Range')!r}"
                )
            got_start, got_total = int(match.group(1)), int(match.group(3))
            if got_total != state.probe.total:
                # the object changed size under THIS source: every byte
                # already journaled or speculatively uploaded is
                # suspect, so the stream is invalidated (the upload
                # degrades to store-and-forward) — but surviving
                # sources still pin the probed total and finish the job
                state.sink.invalidate(state.final_path)
                raise SourceRejected(
                    f"Content-Range total {got_total} != probed "
                    f"{state.probe.total}; object changed mid-transfer"
                )
            if got_start != seg.pos:
                raise SourceRejected(
                    f"server returned range at {got_start}, asked {seg.pos}"
                )

            remaining = seg.end - seg.pos
            while remaining > 0:
                if seg.stop.is_set():
                    # rival won (or failure elsewhere): the bytes this
                    # copy already wrote are real — journal them before
                    # standing down, or they'd be re-fetched on resume
                    state.report(seg)
                    return False
                state.token.raise_if_cancelled()
                try:
                    if FAILPOINTS.fire("segments.read"):
                        raise TimeoutError("failpoint: segments.read")
                    chunk = response.read(min(_CHUNK, remaining))
                except (
                    http.client.HTTPException, OSError, TimeoutError,
                    ValueError,  # cancel hook closed the fd mid-read
                ):
                    state.report(seg)
                    return False  # retry from seg.pos
                if not chunk:
                    state.report(seg)
                    return False  # short read; retry from seg.pos
                # pwrite may write short (near-full disk, RLIMIT_FSIZE):
                # advancing by len(chunk) anyway would journal — and
                # stream-upload — preallocated zeros as covered bytes
                if FAILPOINTS.fire("segments.pwrite"):
                    raise OSError(28, "failpoint: segments.pwrite disk full")
                view = memoryview(chunk)
                write_at = seg.pos
                while view:
                    wrote = os.pwrite(state.fd, view, write_at)
                    write_at += wrote
                    view = view[wrote:]
                seg.pos += len(chunk)
                remaining -= len(chunk)
                state.note_bytes(seg, len(chunk))
                if seg.pos - seg.reported >= REPORT_WINDOW or remaining == 0:
                    state.report(seg)
            # reusable only when the body is EXACTLY drained: a server
            # that sent more than the requested range leaves stray
            # bytes that would corrupt the next request on this socket
            return getattr(response, "length", None) == 0 and (
                not response.will_close
            )
