"""Process-wide metric counters.

The daemon/queue layers keep their own structured stats objects; the
transfer layers (fetch backends, DHT node, uploader) are per-job and
ephemeral, so their totals accrue here instead — a tiny thread-safe
registry the health endpoint folds into ``/metrics``. The reference
has no metrics at all (SURVEY.md §5); this is part of the rebuild's
observability additions (SURVEY.md §7 step 9).

Three shapes, all folded into ``/metrics`` by the health endpoint:
counters (monotonic ``add``), gauges (``gauge_add``/``gauge_set`` —
live levels like active swarms/peers), and fixed-bucket histograms
(``observe`` — job latency). Callers pick snake_case names that read
as Prometheus metrics once prefixed, e.g. ``torrent_bytes_served`` →
``downloader_torrent_bytes_served``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque

# histogram buckets (seconds) for job-scale latencies: sub-second jobs
# land in the fine buckets, torrent jobs in the coarse tail
LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
                   120.0, 300.0, 600.0)

# buckets (seconds) for ms-scale per-job framework overhead: the whole
# point of the overhead_seconds series is alerting on a 2.3 → 4.3 ms
# drift, which the job-scale buckets above would fold
# entirely into their first le=0.01 bucket — percentiles pinned, alert
# blind
OVERHEAD_BUCKETS = (0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                    0.025, 0.05, 0.1, 0.5, 1.0, 5.0)

# buckets for small cardinalities (e.g. http_segments_per_fetch: how
# many ranges a segmented transfer striped across). The distribution's
# mass says whether the adaptive segment-count default actually
# engages, which a plain counter would hide
COUNT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)

# buckets for dimensionless 0..1 ratios (e.g. the streaming pipeline's
# pipeline_overlap_ratio: what fraction of a streamed file's bytes were
# uploaded while its fetch was still running). Uniform deciles — the
# interesting signal is the distribution's mass shifting toward 1.0 as
# overlap improves, not tail latency
RATIO_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# buckets (seconds) for lock-wait times (utils/profiling.py named
# locks): contention on a hot lock shows up as µs-to-ms waits long
# before it becomes a visible stall, so the fine end sits at 10 µs —
# the job-scale layouts would fold every real wait into one bucket
LOCK_WAIT_BUCKETS = (0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005,
                     0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

# `# HELP` text for the best-known series on /metrics; anything not
# listed gets a derived one-liner from help_text() so every exported
# family still carries a well-formed HELP line (the exposition lint in
# tests/test_metrics_lint.py enforces presence and shape for ALL
# families, catalogued or not)
HELP = {
    "jobs_processed": "jobs completed end-to-end (consume through ack)",
    "jobs_failed": "jobs dropped after exhausting their retry budget",
    "jobs_retried": "job attempts republished for retry",
    "jobs_dropped": "jobs nacked as malformed or unsupported",
    "queue_published": "messages confirmed onto the broker",
    "queue_delivered": "messages delivered to this consumer",
    "queue_publish_retries": "publish attempts that failed and re-buffered",
    "queue_reconnects": "broker connections re-established",
    "queue_consumer_errors": "shard consumer create failures",
    "broker_connected": "whether the broker connection is up (1) or down (0)",
    "job_duration_seconds": "completed job latency, consume to ack",
    "fetch_seconds": "per-job fetch stage duration",
    "scan_seconds": "per-job media scan stage duration",
    "upload_seconds": "per-job upload stage duration",
    "publish_seconds": "per-job Convert publish stage duration",
    "stream_upload_seconds": "per-file streamed-egress interval duration",
    "overhead_seconds": "per-job framework overhead (root minus stages)",
    "pipeline_overlap_ratio": (
        "fraction of streamed bytes uploaded while the fetch still ran"
    ),
    "batch_fast_jobs": "jobs completed through the batched small-object fast path",
    "batch_jobs_per_wave": "fast-lane jobs per dequeue wave (batched settles)",
    "queue_acks_coalesced": "ack frames saved by multiple-ack batch settles",
    "queue_publish_flushes": "publisher batches flushed under one confirm wait",
    "queue_publishes_coalesced": "confirm waits saved by publisher flush batching",
    "http_small_fetches": "small objects fetched whole over one pooled connection",
    "http_probe_cache_hits": "HEAD probes answered from the probe cache",
    "jobs_shed": "jobs explicitly load-shed to the dead-letter queue",
    "admission_shed_jobs": "jobs shed by the admission layer (overload or quota)",
    "admission_quota_rejects": "jobs rejected by per-tenant in-flight quotas",
    "admission_batch_slot_denials": (
        "fast-lane jobs diverted to the per-job path by the batch-slot budget"
    ),
    "admission_memory_denials": (
        "streamed parts refused by the part-pool memory budget (fallback)"
    ),
    "admission_inflight_jobs": "jobs currently admitted and in flight",
    "admission_lane_depth": "deliveries parked in admission lanes",
    "admission_pressure": "utilization of the tightest ledger budget (0..1+)",
    "admission_level": (
        "degradation ladder rung: 0 normal, 1 shrink-prefetch, "
        "2 pause-bulk, 3 shed"
    ),
    "admission_prefetch": "the prefetch window currently applied to consumers",
    "dlq_published": "shed jobs handed to the dead-letter queue",
    "dlq_dead_jobs": "shed jobs past the redelivery cap (terminal, X-Dead)",
    "slo_job_duration_seconds_interactive": (
        "completed interactive-class job latency, consume to ack"
    ),
    "slo_job_duration_seconds_bulk": (
        "completed bulk-class job latency, consume to ack"
    ),
    "http_multi_source_fetches": (
        "segmented fetches that raced spans across more than one source"
    ),
    "http_mirror_rejects": (
        "candidate mirrors refused admission (probe disagreed with the "
        "primary's size or validator)"
    ),
    "http_source_failovers": (
        "mid-job source failures whose spans were absorbed by the "
        "remaining live sources"
    ),
    "fetch_sources_active_mirror": (
        "live HTTP mirror sources (primary included) across in-flight jobs"
    ),
    "fetch_sources_active_webseed": (
        "live BEP 19 webseed sources across in-flight swarms"
    ),
    "fetch_sources_active_peer": (
        "live torrent peer sources across in-flight swarms"
    ),
    "source_bytes_total_mirror": "bytes fetched from HTTP mirror sources",
    "source_bytes_total_webseed": "bytes fetched from webseed sources",
    "source_bytes_total_peer": "bytes fetched from torrent peer sources",
    # flow-accounting plane (utils/flows.py); per-origin variants of the
    # source_bytes families are name-encoded with a bounded label set
    # (source_bytes_total_<kind>_origin_<label>, strangers -> overflow)
    # and carry the derived help line
    "flow_origin_bytes_total": (
        "bytes fetched FROM origins (flow-ledger ingress, all source "
        "kinds; the numerator of origin amplification)"
    ),
    "flow_unique_bytes_total": (
        "unique object bytes first materialized on this worker (the "
        "denominator of origin amplification; refetches don't count)"
    ),
    "flow_egress_bytes_total": (
        "bytes shipped to the object store (flow-ledger egress at "
        "pipeline ship)"
    ),
    "flow_origin_amplification": (
        "live origin-amplification ratio: origin bytes fetched over "
        "unique object bytes served (1.0 = no redundant fetching)"
    ),
    "flow_hot_object_share": (
        "share of all ingress bytes attributed to the single hottest "
        "object (heavy-hitter sketch top estimate over total)"
    ),
    "flow_cache_hit_bytes_total": (
        "bytes served from the shared content-addressed cache instead "
        "of an origin (fleet data plane; these enter demand but not "
        "origin ingress, so they pull amplification toward 1.0)"
    ),
    # fleet data plane (store/cas.py + fetch/singleflight.py)
    "cache_hits_total": (
        "content-addressed cache lookups served from a verified "
        "on-disk entry"
    ),
    "cache_misses_total": (
        "content-addressed cache lookups that found no fresh entry "
        "(includes TTL-expired and corrupt-evicted entries)"
    ),
    "cache_hit_bytes_total": (
        "object bytes served from the content-addressed cache"
    ),
    "cache_puts_total": (
        "objects admitted into the content-addressed cache "
        "(write-through after an origin fetch)"
    ),
    "cache_put_bytes_total": (
        "object bytes written into the content-addressed cache"
    ),
    "cache_evictions_total": (
        "cache entries evicted (LRU under the byte budget, TTL sweep, "
        "corrupt, or torn-put cleanup)"
    ),
    "cache_corrupt_evictions_total": (
        "cache entries evicted because their content digest no longer "
        "matched the recorded sha256 (never served; refetched instead)"
    ),
    "cache_admit_refusals_total": (
        "cache admissions refused (object too large for the budget, or "
        "the admission ledger denied scratch-disk charge and every "
        "remaining entry was lease-pinned)"
    ),
    "cache_entries": "live entries in the content-addressed cache",
    "cache_bytes": (
        "bytes currently held by the content-addressed cache"
    ),
    "singleflight_leads_total": (
        "single-flight elections won: this process became the one "
        "origin fetcher for a content key"
    ),
    "singleflight_joins_total": (
        "single-flight elections lost: this process waited on another "
        "worker's in-flight fetch instead of hitting the origin"
    ),
    "singleflight_promotions_total": (
        "followers promoted to leader after a lease expired (previous "
        "leader died or stalled mid-fetch)"
    ),
    "singleflight_wait_timeouts_total": (
        "single-flight followers that gave up waiting and degraded to "
        "a direct origin fetch (SINGLEFLIGHT_WAIT_S exceeded)"
    ),
    "singleflight_wait_seconds": (
        "seconds a single-flight follower waited before its object "
        "was served from the shared cache"
    ),
    "source_demotions_total_mirror": (
        "mirror sources demoted to the trickle lane (slow or erroring; "
        "recovery re-promotes)"
    ),
    "source_demotions_total_webseed": (
        "webseed sources demoted to the trickle lane (slow or erroring; "
        "recovery re-promotes)"
    ),
    "source_demotions_total_peer": (
        "peer sources demoted to the trickle lane (slow or erroring; "
        "recovery re-promotes)"
    ),
    "source_retires_total_mirror": (
        "mirror sources retired for their job (repeated or deterministic "
        "failures, or job end)"
    ),
    "source_retires_total_webseed": (
        "webseed sources retired for their job (repeated or deterministic "
        "failures, or job end)"
    ),
    "source_retires_total_peer": (
        "peer sources retired for their job (connection end, repeated or "
        "deterministic failures)"
    ),
    "queue_publisher_alive": (
        "whether the buffered-publisher thread is up (1) or down (0)"
    ),
    "alerts_firing": "alert rules currently in the firing state",
    "alerts_fired": "pending->firing alert transitions",
    "tsdb_scrapes": "registry scrapes taken into the local time-series store",
    "federate_scrapes": "merged /metrics/federate renders served",
    "federate_source_errors": (
        "child-worker scrape sources that failed during a federate render"
    ),
    "watchdog_stalls": "stall episodes flagged (no forward progress)",
    "watchdog_cancels": "stalled jobs cancelled (WATCHDOG_ACTION=cancel)",
    "watchdog_stalled_tasks": "watched tasks currently flagged as stalled",
    "incident_captures": "incident bundles captured",
    "incident_captures_suppressed": (
        "watchdog-triggered captures suppressed by rate limiting"
    ),
    # continuous profiling plane (utils/profiling.py)
    "profile_ticks": "sampling-profiler walks over all thread stacks",
    "profile_samples": "thread stack samples taken into the profile ring",
    "profile_threads": "threads seen by the last profiler tick",
    "profile_heap_snapshots": "tracemalloc heap snapshots taken",
    "lock_wait_seconds_queue_client": (
        "acquire wait on the queue client's state lock (contended "
        "waits always observed; uncontended sampled as zeros)"
    ),
    "lock_wait_seconds_connpool": (
        "acquire wait on the HTTP keep-alive pool's shelf lock"
    ),
    "lock_wait_seconds_pipeline_session": (
        "acquire wait on a streaming-pipeline session's span/part lock"
    ),
    "lock_wait_seconds_segment_state": (
        "acquire wait on a segmented fetch's shared range-queue lock"
    ),
    "lock_wait_seconds_probe_cache": (
        "acquire wait on the HEAD-probe cache lock"
    ),
    "lock_wait_seconds_source_board": (
        "acquire wait on a job's multi-source scheduling board lock"
    ),
    # crash-only worker fleet (daemon/fleet.py)
    "fleet_workers_target": "worker processes the supervisor is configured for",
    "fleet_workers_alive": "worker processes currently running",
    "fleet_worker_restarts": (
        "workers restarted after dying or wedging (the worker-flapping "
        "alert rule's series)"
    ),
    "fleet_worker_start_failures": (
        "workers that exited during startup without ever heartbeating "
        "(fatal-after-M slots escalate instead of restart-looping)"
    ),
    # fleet debug plane (daemon/fleetplane.py)
    "fleet_scrape_failures": (
        "per-worker scrapes that failed or timed out during a fleet "
        "fan-out (federation child sources and /debug/* queries; a "
        "wedged worker costs its timeout slice, never the response)"
    ),
    "fleet_debug_fanouts": (
        "fleet debug-plane fan-out queries served (each one concurrent "
        "scrape per ready worker)"
    ),
    "fleet_incidents": (
        "cross-worker incident bundles captured by the fleet supervisor "
        "(every worker's POST /debug/incident snapshot under one id)"
    ),
    "multipart_stale_aborts": (
        "stale multipart uploads aborted by the crash janitor (orphans "
        "of workers that died mid-stream)"
    ),
    "canary_probes_total": (
        "synthetic canary probes completed (cold + warm, pass or fail)"
    ),
    "canary_probe_failures_total": (
        "canary probes that failed any verification stage (publish, "
        "Convert round-trip, store read-back integrity)"
    ),
    "canary_failing": (
        "1 while the canary episode is failing, 0 when the last probe "
        "verified clean (the canary-failure page rule's input)"
    ),
    "canary_e2e_seconds": (
        "end-to-end latency of a verified canary probe (publish "
        "through outside-in integrity check), trace-id exemplars"
    ),
}


def help_text(name: str) -> str:
    """HELP line body for series ``name``: catalogued text, else a
    derived one so the exposition stays well-formed for every family."""
    return HELP.get(name, f"{name.replace('_', ' ')} (downloader)")


def instance_from_env(environ=None) -> str:
    """``WORKER_INSTANCE``: this worker's identity in the ``instance``
    label dimension — what a federated scrape tags each sample with so
    one ``/metrics/federate`` read distinguishes fleet members. Empty
    (the default) renders as ``worker-0``."""
    import os

    env = os.environ if environ is None else environ
    return (env.get("WORKER_INSTANCE") or "").strip()


class Federation:
    """The fleet-aggregation half of the fleet's "one /metrics
    scrape, per-worker labels": child workers (or a supervisor's
    per-process scrapers) register a named source — a callable
    returning a Prometheus exposition body — and the health server's
    ``/metrics/federate`` merges every source's samples under its
    ``instance`` label. Sources are plain callables so a future
    supervisor can hand in HTTP fetchers without this module learning
    about sockets."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: "dict[str, object]" = {}  # guarded-by: _lock
        self.instance = ""  # this process's own label value

    def register_source(self, instance: str, fetch) -> None:
        """``fetch() -> str`` must return exposition text; it is
        called on every federate render and its failures are counted,
        never fatal."""
        with self._lock:
            self._sources[instance] = fetch

    def unregister_source(self, instance: str) -> None:
        with self._lock:
            self._sources.pop(instance, None)

    def sources(self) -> "dict[str, object]":
        with self._lock:
            return dict(self._sources)

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._sources.clear()
        self.instance = ""


FEDERATION = Federation()


# recent exemplars retained per histogram family: enough to link a
# firing burn alert to a handful of example traces, small enough that
# the registry's memory stays fixed
EXEMPLARS_PER_FAMILY = 4


class Counters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: "defaultdict[str, int]" = defaultdict(int)  # guarded-by: _lock
        self._gauges: "defaultdict[str, float]" = defaultdict(float)  # guarded-by: _lock
        # name -> (le-bucket bounds, counts parallel to them, sum, count)
        self._hists: dict[  # guarded-by: _lock
            str, tuple[tuple[float, ...], list[int], float, int]
        ] = {}
        # name -> recent {trace_id, value, ts} exemplars (observe() with
        # exemplar=): the metric -> trace back-link a burn alert serves
        self._exemplars: dict[str, "deque[dict]"] = {}  # guarded-by: _lock

    def add(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._values[name] += value

    def gauge_add(self, name: str, delta: float) -> None:
        """Move a live level up or down (e.g. a swarm starting/ending)."""
        with self._lock:
            self._gauges[name] += delta

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def ensure_histogram(
        self,
        name: str,
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
    ) -> None:
        """Register ``name`` as a zeroed histogram if absent — for
        series that must EXIST from the first scrape (the TSDB records
        only families the registry has; a burn-rate window needs a
        true zero baseline, not a first sample that already carries
        the whole burst)."""
        with self._lock:
            if name not in self._hists:
                self._hists[name] = (buckets, [0] * len(buckets), 0.0, 0)

    def observe(
        self,
        name: str,
        value: float,
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
        exemplar: str | None = None,
    ) -> None:
        """Record one sample into the fixed-bucket histogram ``name``
        (cumulative le-buckets, Prometheus semantics). ``buckets`` is
        fixed at the first observation; later calls reuse the stored
        bounds (mixing bucket layouts per series is undefined in
        Prometheus anyway). ``exemplar`` (a trace id) is retained in a
        tiny per-family ring so a firing burn alert links straight to
        example traces — one deque append, nothing on the hot path
        when no exemplar is passed."""
        with self._lock:
            bounds, counts, total, count = self._hists.get(
                name, (buckets, [0] * len(buckets), 0.0, 0)
            )
            for i, le in enumerate(bounds):
                if value <= le:
                    counts[i] += 1
            self._hists[name] = (bounds, counts, total + value, count + 1)
            if exemplar:
                ring = self._exemplars.get(name)
                if ring is None:
                    ring = self._exemplars[name] = deque(
                        maxlen=EXEMPLARS_PER_FAMILY
                    )
                ring.append(
                    {
                        "trace_id": exemplar,
                        "value": round(value, 6),
                        "ts": time.time(),
                    }
                )

    def exemplars(self, name: str) -> list[dict]:
        """Recent exemplars for histogram family ``name`` (oldest
        first); empty when none were recorded."""
        with self._lock:
            ring = self._exemplars.get(name)
            return [dict(entry) for entry in ring] if ring else []

    def exemplars_snapshot(self) -> dict[str, list[dict]]:
        """Every family's recent exemplars — what the worker's
        ``/debug/exemplars`` endpoint serves so the fleet aggregator
        can link fleet-level burn alerts to per-worker traces."""
        with self._lock:
            return {
                name: [dict(entry) for entry in ring]
                for name, ring in sorted(self._exemplars.items())
                if ring
            }

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._values)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def histograms(
        self,
    ) -> dict[str, tuple[tuple[float, ...], list[int], float, int]]:
        with self._lock:
            return {
                name: (bounds, list(counts), total, count)
                for name, (bounds, counts, total, count)
                in self._hists.items()
            }

    def reset(self) -> None:
        """Test isolation only; production counters are monotonic."""
        with self._lock:
            self._values.clear()
            self._gauges.clear()
            self._hists.clear()
            self._exemplars.clear()


GLOBAL = Counters()
