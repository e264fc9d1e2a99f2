"""Source-agnostic transfer-source accounting: the shared half of the
multi-source racing fetch (ROADMAP item 4).

One job can draw byte spans from several *sources* at once — N HTTP
mirror URLs (job header ``X-Mirrors`` plus the ``MIRROR_URLS`` config
fallback), BEP 19 webseeds, and torrent peers. The multi-path transfer
paper (PAPERS.md, "Accelerating Intra-Node GPU-to-GPU Communication
Through Multi-Path Transfers") stripes one logical copy across several
channels and lets per-channel bandwidth decide the split; this module
is the cross-ORIGIN analogue's bookkeeping: every source carries an
EWMA bandwidth estimate and an error score, and a per-job
:class:`SourceBoard` turns those into scheduling state —

- **active** sources compete for spans, weighted by measured rate;
- sources measurably slower than a fraction of the leader's rate are
  **demoted** to a trickle lane (one small span in flight, so the rate
  keeps being measured and recovery re-promotes — a demotion is never
  a ban);
- sources that keep failing (or fail deterministically: Range support
  dropped, 4xx) are **retired** — their in-flight spans return to the
  missing set and the surviving sources absorb them.

The span scheduler itself lives in fetch/segments.py (HTTP mirrors)
and the swarm claim pool in fetch/swarmstate.py (peers + webseeds);
both account through this board so /metrics tells one story:
``fetch_sources_active_<kind>``, ``source_bytes_total_<kind>``,
``source_demotions_total_<kind>`` for kind in mirror/webseed/peer.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils import flows, get_logger, metrics, profiling

log = get_logger("fetch.sources")

KIND_MIRROR = "mirror"
KIND_WEBSEED = "webseed"
KIND_PEER = "peer"
KINDS = (KIND_MIRROR, KIND_WEBSEED, KIND_PEER)

ACTIVE = "active"
TRICKLE = "trickle"
RETIRED = "retired"

# a source with no rate history yet scores as if it ran at this rate:
# optimistic, so every admitted source gets probed with real spans
# quickly instead of starving behind the first source to report bytes
OPTIMISTIC_RATE = 64e6
# rate comparisons need signal: a source is only demoted (or counted
# as the leader) once it has moved at least this many bytes
MIN_RATE_SAMPLE = 256 * 1024
# how often the board recomputes demotions/promotions; rebalance() is
# called from hot-ish paths and self-limits to this cadence
REBALANCE_INTERVAL = 0.5

DEFAULT_DEMOTE_RATIO = 0.25
DEFAULT_RETIRE_ERRORS = 3
DEFAULT_MIRROR_MAX = 4
_MIRROR_LIST_CAP = 16


def demote_ratio_from_env(environ=None) -> float:
    """SOURCE_DEMOTE_RATIO knob: a source slower than this fraction of
    the leader's measured rate is demoted to the trickle lane."""
    env = os.environ if environ is None else environ
    raw = (env.get("SOURCE_DEMOTE_RATIO") or "").strip()
    if not raw:
        return DEFAULT_DEMOTE_RATIO
    try:
        value = float(raw)
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid SOURCE_DEMOTE_RATIO (want a float)"
        )
        return DEFAULT_DEMOTE_RATIO
    return min(max(value, 0.0), 1.0)


def retire_errors_from_env(environ=None) -> int:
    """SOURCE_RETIRE_ERRORS knob: consecutive transfer failures before
    a source is retired for the job (deterministic failures retire
    immediately regardless)."""
    env = os.environ if environ is None else environ
    raw = (env.get("SOURCE_RETIRE_ERRORS") or "").strip()
    if not raw:
        return DEFAULT_RETIRE_ERRORS
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid SOURCE_RETIRE_ERRORS (want an integer)"
        )
        return DEFAULT_RETIRE_ERRORS


def mirror_max_from_env(environ=None) -> int:
    """MIRROR_MAX knob: at most this many mirror sources ride along a
    job's primary URL (header + config fallback combined)."""
    env = os.environ if environ is None else environ
    raw = (env.get("MIRROR_MAX") or "").strip()
    if not raw:
        return DEFAULT_MIRROR_MAX
    try:
        return max(0, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid MIRROR_MAX (want an integer)"
        )
        return DEFAULT_MIRROR_MAX


def parse_mirror_list(raw) -> tuple[str, ...]:
    """Mirror URLs out of a header/env value: comma- or whitespace-
    separated, scheme-checked, deduplicated, order-preserving, capped.
    Garbage entries are dropped, never fatal — a malformed mirror list
    must degrade to fewer sources, not a dropped job."""
    if not isinstance(raw, str) or not raw.strip():
        return ()
    out: list[str] = []
    seen: set[str] = set()
    for token in raw.replace(",", " ").split():
        lowered = token.lower()
        if not lowered.startswith(("http://", "https://", "ftp://")):
            continue
        if token in seen:
            continue
        seen.add(token)
        out.append(token)
        if len(out) >= _MIRROR_LIST_CAP:
            break
    return tuple(out)


def mirrors_from_env(environ=None) -> tuple[str, ...]:
    """MIRROR_URLS knob: the config fallback mirror list applied to
    every job (the job's own ``X-Mirrors`` header takes precedence in
    ordering; both are merged and capped at MIRROR_MAX)."""
    env = os.environ if environ is None else environ
    return parse_mirror_list(env.get("MIRROR_URLS") or "")


def merge_mirrors(
    primary: str, *lists: tuple[str, ...], cap: int = DEFAULT_MIRROR_MAX
) -> tuple[str, ...]:
    """Combine mirror lists (job header first, config fallback second)
    into one deduplicated tuple that never includes the primary URL.
    ``cap <= 0`` disables mirrors entirely (MIRROR_MAX=0 is the
    operator's off switch)."""
    if cap <= 0:
        return ()
    out: list[str] = []
    seen = {primary}
    for urls in lists:
        for url in urls:
            if url in seen:
                continue
            seen.add(url)
            out.append(url)
            if len(out) >= cap:
                return tuple(out)
    return tuple(out)


class SourceMeter:
    """EWMA bandwidth estimate for one source. Bytes accumulate into a
    short window; each closed window folds its rate into the EWMA. A
    window left open (the source stopped producing) drags the estimate
    down when read — a stalled source must read as slow, not as its
    last good rate. Not thread-safe: the owning board's lock guards
    every call."""

    WINDOW = 0.5
    ALPHA = 0.4

    __slots__ = ("_clock", "_rate", "_window_bytes", "_window_start", "total")

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._rate: float | None = None
        self._window_bytes = 0
        self._window_start = clock()
        self.total = 0

    def note(self, count: int) -> None:
        self.total += count
        self._window_bytes += count
        now = self._clock()
        elapsed = now - self._window_start
        if elapsed >= self.WINDOW:
            inst = self._window_bytes / elapsed
            self._rate = (
                inst
                if self._rate is None
                else self.ALPHA * inst + (1 - self.ALPHA) * self._rate
            )
            self._window_bytes = 0
            self._window_start = now

    def rate(self) -> float | None:
        """Best current estimate in bytes/s; None with no history. The
        open window only ever lowers the answer (stall detection) —
        a burst inside a half-open window is noise, not a promotion.
        The blend COMPOUNDS per elapsed window: a source stalled for k
        windows reads as if k near-empty windows had folded, decaying
        toward zero instead of flooring one blend below its last good
        rate (a stalled near-leader must sink under the demote floor,
        not hover above it forever)."""
        elapsed = self._clock() - self._window_start
        if elapsed >= self.WINDOW:
            inst = self._window_bytes / elapsed
            if self._rate is None:
                return inst if self.total else None
            if inst < self._rate:
                windows = min(int(elapsed / self.WINDOW), 32)
                decayed = self._rate
                for _ in range(windows):
                    decayed = self.ALPHA * inst + (1 - self.ALPHA) * decayed
                return decayed
        return self._rate


class Source:
    """One transfer source a job can draw spans/pieces from. State and
    counters are MUTATED only under the owning board's lock (a lock the
    static guarded-by rule cannot name across classes, hence prose);
    ``payload`` is opaque scheduler context (the segmented fetcher
    parks the mirror's probe there)."""

    __slots__ = (
        "kind", "name", "payload", "meter", "state", "inflight", "errors",
        "demotions", "host", "origin_label",
    )

    def __init__(self, kind: str, name: str, payload=None, clock=time.monotonic):
        self.kind = kind
        self.name = name
        self.payload = payload
        # origin identity, computed ONCE at registration (never on the
        # per-chunk byte path): the flow ledger's attribution host and
        # the bounded metric label the per-origin counters ride
        self.host = flows.host_of(name)
        self.origin_label = flows.origin_label(self.host)
        self.meter = SourceMeter(clock)  # mutated under the board's lock
        self.state = ACTIVE  # mutated under the board's lock
        self.inflight = 0  # mutated under the board's lock
        self.errors = 0  # consecutive; mutated under the board's lock
        self.demotions = 0  # mutated under the board's lock

    @property
    def retired(self) -> bool:
        """Deliberately lock-free: worker loops poll this between
        claims, and a stale read costs one extra claim attempt (the
        board re-checks under its lock), never a correctness bug."""
        return self.state == RETIRED


class SourceBoard:
    """Thread-safe per-job source registry: rates, demotion/promotion,
    retirement, and the per-kind /metrics accounting. One board lives
    for one fetch (segmented HTTP) or one swarm download; ``close()``
    settles the active-sources gauges whichever way the job ended."""

    def __init__(
        self,
        demote_ratio: float | None = None,
        retire_errors: int | None = None,
        clock=time.monotonic,
        flow_object: str = "",
    ):
        self._clock = clock
        # the flow ledger's object attribution for every byte this
        # board accounts (segments pass the primary URL's key, swarms
        # the torrent's) — empty attributes to the anonymous object
        self._flow_object = flow_object
        self._demote_ratio = (
            demote_ratio_from_env() if demote_ratio is None else demote_ratio
        )
        self._retire_errors = (
            retire_errors_from_env() if retire_errors is None
            else retire_errors
        )
        # named for lock-wait profiling: every span claim/completion
        # from every racing worker serializes on the board
        self._lock = profiling.named_lock(
            "source_board", threading.Lock()
        )
        self._sources: list[Source] = []  # guarded-by: _lock
        self._last_rebalance = clock()  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    # -- registration -----------------------------------------------------

    def add(self, kind: str, name: str, payload=None) -> Source:
        source = Source(kind, name, payload, self._clock)
        with self._lock:
            self._sources.append(source)
        metrics.GLOBAL.gauge_add(f"fetch_sources_active_{kind}", 1)
        return source

    def close(self) -> None:
        """Settle the active-source gauges for every still-live source
        (the job is over; retired ones already settled)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            live = [s for s in self._sources if s.state != RETIRED]
            for source in live:
                source.state = RETIRED
        for source in live:
            metrics.GLOBAL.gauge_add(f"fetch_sources_active_{source.kind}", -1)

    # -- accounting -------------------------------------------------------

    def note_bytes(self, source: Source, count: int) -> None:
        if count <= 0:
            return
        with self._lock:
            source.meter.note(count)
        metrics.GLOBAL.add(f"source_bytes_total_{source.kind}", count)
        # the per-origin-host dimension: bounded
        # by the flow plane's origin-label registry, so demotions can
        # be read against origin identity without unbounded series
        metrics.GLOBAL.add(
            f"source_bytes_total_{source.kind}_origin_{source.origin_label}",
            count,
        )
        flows.LEDGER.note_ingress(
            self._flow_object, source.host, source.kind, count
        )

    def note_success(self, source: Source) -> None:
        """A claim completed cleanly: the consecutive-error score that
        drives retirement resets (rate-based demotion is separate)."""
        with self._lock:
            source.errors = 0

    def note_error(self, source: Source, permanent: bool = False) -> str:
        """Record one claim-level failure. Transient errors demote (the
        trickle lane keeps measuring the source) and retire past the
        consecutive-error budget; ``permanent`` failures — the source
        answered in a way retrying cannot fix — retire immediately.
        Returns the source's resulting state."""
        demoted = retired = False
        with self._lock:
            if source.state == RETIRED:
                return RETIRED
            source.errors += 1
            if permanent or source.errors >= self._retire_errors:
                source.state = RETIRED
                retired = True
            elif source.state == ACTIVE:
                source.state = TRICKLE
                source.demotions += 1
                demoted = True
            state = source.state
        if demoted:
            metrics.GLOBAL.add(f"source_demotions_total_{source.kind}")
        if retired:
            metrics.GLOBAL.add(f"source_retires_total_{source.kind}")
            metrics.GLOBAL.gauge_add(
                f"fetch_sources_active_{source.kind}", -1
            )
            log.with_fields(kind=source.kind, source=source.name).warning(
                "source retired for this job; live sources absorb its spans"
            )
        elif demoted:
            log.with_fields(kind=source.kind, source=source.name).info(
                "source demoted to the trickle lane after an error"
            )
        return state

    def retire(self, source: Source) -> None:
        """Lifecycle retirement (a peer connection ending, a lane the
        job is done with): settles state and gauges without the error
        log — routine churn is not a warning."""
        with self._lock:
            if source.state == RETIRED:
                return
            source.state = RETIRED
        metrics.GLOBAL.add(f"source_retires_total_{source.kind}")
        metrics.GLOBAL.gauge_add(f"fetch_sources_active_{source.kind}", -1)

    # -- scheduling views -------------------------------------------------

    def live_count(self, exclude: Source | None = None) -> int:
        """Live sources, optionally not counting ``exclude`` — the
        failover path asks "who else can absorb this span", and the
        failing source must never count as its own survivor (it may
        already be retired from a sibling claim's failure)."""
        with self._lock:
            return sum(
                1
                for s in self._sources
                if s.state != RETIRED and s is not exclude
            )

    def live(self) -> list[Source]:
        with self._lock:
            return [s for s in self._sources if s.state != RETIRED]

    def checkout(self, source: Source) -> None:
        with self._lock:
            source.inflight += 1

    def checkin(self, source: Source) -> None:
        with self._lock:
            source.inflight = max(0, source.inflight - 1)

    def rebalance(self) -> None:
        """Demote sources measurably slower than ``demote_ratio`` of
        the leader's rate; re-promote trickle sources whose measured
        rate recovered. Self-limits to REBALANCE_INTERVAL so hot paths
        may call it freely."""
        demoted: list[Source] = []
        promoted: list[Source] = []
        with self._lock:
            now = self._clock()
            if now - self._last_rebalance < REBALANCE_INTERVAL:
                return
            self._last_rebalance = now
            rated = [
                (s, s.meter.rate())
                for s in self._sources
                if s.state != RETIRED and s.meter.total >= MIN_RATE_SAMPLE
            ]
            rates = [r for _, r in rated if r is not None]
            if not rates:
                return
            leader = max(rates)
            floor = leader * self._demote_ratio
            for source, rate in rated:
                if rate is None:
                    continue
                if source.state == ACTIVE and rate < floor and rate < leader:
                    source.state = TRICKLE
                    source.demotions += 1
                    demoted.append(source)
                elif source.state == TRICKLE and rate >= floor:
                    source.state = ACTIVE
                    promoted.append(source)
        for source in demoted:
            metrics.GLOBAL.add(f"source_demotions_total_{source.kind}")
            log.with_fields(
                kind=source.kind, source=source.name,
                rate_MBps=round((source.meter.rate() or 0) / 1e6, 2),
            ).info("slow source demoted to the trickle lane")
        for source in promoted:
            log.with_fields(kind=source.kind, source=source.name).info(
                "recovered source re-promoted from the trickle lane"
            )

    @staticmethod
    def _best(candidates: "list[Source]") -> Source | None:
        """Argmax of measured rate per already-assigned claim, with an
        optimistic score for the unmeasured so every new source gets
        probed. Caller holds the board lock."""
        best: Source | None = None
        best_score = -1.0
        for source in candidates:
            rate = source.meter.rate()
            score = (
                rate if rate is not None else OPTIMISTIC_RATE
            ) / (source.inflight + 1)
            if score > best_score:
                best, best_score = source, score
        return best

    def pick(self, queued: int = 0) -> Source | None:
        """The best source to hand the next span: active sources score
        by measured rate per already-assigned claim; trickle sources
        hold exactly ONE in-flight span — their lane — and only while
        there is work to spare (``queued`` exceeds the active pool), so
        the tail of a transfer is never handed to a known-slow source.
        With no active source left the trickle lane is the only lane
        and takes work regardless."""
        with self._lock:
            active = [s for s in self._sources if s.state == ACTIVE]
            best = self._best(active)
            idle_trickle = next(
                (
                    s
                    for s in self._sources
                    if s.state == TRICKLE and s.inflight == 0
                ),
                None,
            )
            if best is None:
                return idle_trickle  # the trickle lane is the only lane
            if idle_trickle is not None and queued > len(active):
                # work to spare: one span keeps the demoted source
                # measured, so recovery can re-promote it
                return idle_trickle
            return best

    def pick_rescue(self, exclude: Source | None) -> Source | None:
        """The source an endgame twin should race on: the best ACTIVE
        source other than the straggler's own; the straggler's source
        itself only when it is the last one standing (the single-source
        endgame). Trickle sources never rescue — duplicating a
        tail onto a known-slow lane delays the very win the rescue is
        for."""
        with self._lock:
            best = self._best(
                [
                    s
                    for s in self._sources
                    if s.state == ACTIVE and s is not exclude
                ]
            )
            if best is not None:
                return best
            if exclude is not None and exclude.state == ACTIVE:
                return exclude
            return None

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Live view for incident bundles and per-fetch probes."""
        with self._lock:
            return [
                {
                    "kind": s.kind,
                    "name": s.name,
                    "state": s.state,
                    "inflight": s.inflight,
                    "errors": s.errors,
                    "demotions": s.demotions,
                    "bytes": s.meter.total,
                    "rate_MBps": round((s.meter.rate() or 0.0) / 1e6, 3),
                }
                for s in self._sources
            ]
