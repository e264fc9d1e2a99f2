"""Process-wide metric counters, gauges and histograms (``GLOBAL``).

The port carries the registry of the JAX package's utils/metrics.py:
counters (monotonic ``add``), gauges (``gauge_add``/``gauge_set`` —
live levels like segments in flight), and fixed-bucket histograms
(``observe`` — stage latencies, segments per fetch, lock waits), with
the same bucket layouts. The ``# HELP`` catalogue, the Prometheus
exposition and the fleet federation come with the health server.
Callers pick snake_case names that read as Prometheus metrics once
prefixed, e.g. ``http_bytes_downloaded``.
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

# buckets (seconds) for lock-wait times (utils/profiling.py named
# locks): contention on a hot lock shows up as µs-to-ms waits long
# before it becomes a visible stall, so the fine end sits at 10 µs —
# the job-scale layouts would fold every real wait into one bucket
LOCK_WAIT_BUCKETS = (0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005,
                     0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

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
