"""Local fixed-memory time-series store over the in-process registry.

The metrics registry (utils/metrics.py) holds ONE value per series —
current counter totals, live gauges, cumulative histograms. That is
enough for an external Prometheus to scrape, but nothing IN-TREE can
ask "what was the error rate over the last five minutes", which is
exactly the question burn-rate alerting (utils/alerts.py) has to
answer and exactly what the multi-worker fleet needs
aggregated per worker. This module is the missing middle: a scraping
thread samples the registry on an interval into bounded rings, so
windowed rates, deltas, and histogram quantiles are answerable from a
running daemon with zero external infrastructure.

Cost discipline, mirroring tracing/watchdog:

- **Nothing on the job path.** Jobs keep bumping the registry exactly
  as before; the TSDB reads registry snapshots from its own thread.
  Per-job telemetry cost stays bounded by the ≤0.5 ms guard
  (tests/test_telemetry.py) regardless of scrape cadence.
- **Fixed memory.** Per series: a fine ring of ``TSDB_SAMPLES`` recent
  samples at scrape resolution plus a coarse ring of downsampled
  aggregates (every ``TSDB_DOWNSAMPLE`` fine samples fold into one),
  both ``deque(maxlen=...)``. Series count is bounded by the registry's
  family count; a runaway-cardinality registry is its own bug, caught
  by the metrics lint.
- **Liveness-watched.** The scrape thread carries a watchdog loop
  watch ("tsdb-scrape"), so a wedged scrape — the component that
  notices regressions — cannot itself die silently.

Queryable at ``GET /debug/tsdb?name=&window=`` on the health server:
counters come back with derived per-second rates, histograms with
windowed p50/p95/p99 estimates (Prometheus-style linear interpolation
inside the bucket). ``histogram_window``/``counter_rate``/``latest``
are the programmatic surface the alert engine evaluates over.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import metrics, profiling, watchdog
from .logging import get_logger

log = get_logger("tsdb")

DEFAULT_INTERVAL_S = 10.0
DEFAULT_SAMPLES = 360  # fine ring: 1 h of history at the 10 s default
DEFAULT_DOWNSAMPLE = 10  # coarse tier folds every N fine samples


def interval_from_env(environ=None) -> float:
    """``TSDB_INTERVAL``: seconds between registry scrapes; ``0``/
    ``off`` disables the store (queries answer empty, alerts that need
    windows stay silent)."""
    env = os.environ if environ is None else environ
    raw = (env.get("TSDB_INTERVAL") or "").strip().lower()
    if not raw:
        return DEFAULT_INTERVAL_S
    if raw in ("off", "false", "no", "disabled"):
        return 0.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid TSDB_INTERVAL (want seconds or 'off')"
        )
        return DEFAULT_INTERVAL_S


def samples_from_env(environ=None) -> int:
    """``TSDB_SAMPLES``: fine-resolution samples kept per series."""
    env = os.environ if environ is None else environ
    raw = (env.get("TSDB_SAMPLES") or "").strip()
    if not raw:
        return DEFAULT_SAMPLES
    try:
        return max(2, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid TSDB_SAMPLES (want an integer)"
        )
        return DEFAULT_SAMPLES


def downsample_from_env(environ=None) -> int:
    """``TSDB_DOWNSAMPLE``: fine samples folded into one coarse
    aggregate for the older-history tier."""
    env = os.environ if environ is None else environ
    raw = (env.get("TSDB_DOWNSAMPLE") or "").strip()
    if not raw:
        return DEFAULT_DOWNSAMPLE
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid TSDB_DOWNSAMPLE (want an integer)"
        )
        return DEFAULT_DOWNSAMPLE


def quantile(
    bounds: "tuple[float, ...]",
    counts: "list[int] | tuple[int, ...]",
    total_count: int,
    q: float,
) -> float | None:
    """Prometheus-style histogram quantile over CUMULATIVE le-bucket
    counts: linear interpolation inside the winning bucket, the top
    finite bound for mass in +Inf. None when the histogram is empty."""
    if total_count <= 0 or not bounds:
        return None
    rank = q * total_count
    previous_bound = 0.0
    previous_count = 0
    for le, cumulative in zip(bounds, counts):
        if cumulative >= rank:
            in_bucket = cumulative - previous_count
            if in_bucket <= 0:
                return le
            fraction = (rank - previous_count) / in_bucket
            return previous_bound + (le - previous_bound) * fraction
        previous_bound = le
        previous_count = cumulative
    return bounds[-1]  # mass beyond the top finite bucket


class _Series:
    """One metric family's bounded history: a fine ring at scrape
    resolution and a coarse ring of downsampled aggregates. Values are
    floats for counters/gauges; histograms store (counts tuple, sum,
    count) snapshots (bounds held once on the series)."""

    __slots__ = ("kind", "bounds", "fine", "coarse", "_fold")

    def __init__(self, kind: str, samples: int, coarse: int):
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.bounds: "tuple[float, ...] | None" = None
        self.fine: deque = deque(maxlen=samples)
        self.coarse: deque = deque(maxlen=coarse)
        self._fold = 0

    def append(self, ts: float, value, downsample: int) -> None:
        self.fine.append((ts, value))
        self._fold += 1
        if self._fold >= downsample:
            self._fold = 0
            # cumulative kinds (counters, histogram snapshots) keep the
            # window-edge value; gauges keep (last, min, max) so a
            # spike older than the fine ring is still visible
            if self.kind == "gauge":
                tail = list(self.fine)[-downsample:]
                values = [v for _, v in tail]
                self.coarse.append(
                    (ts, values[-1], min(values), max(values))
                )
            else:
                self.coarse.append((ts, value))


class TimeSeriesStore:
    """The process-wide store: scrape-on-interval over metrics.GLOBAL,
    bounded rings per family, windowed queries."""

    def __init__(
        self,
        interval_s: float = DEFAULT_INTERVAL_S,
        samples: int = DEFAULT_SAMPLES,
        downsample: int = DEFAULT_DOWNSAMPLE,
    ):
        self.interval_s = interval_s
        self._samples = samples
        self._downsample = downsample
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}  # guarded-by: _lock
        self._scrapes = 0  # guarded-by: _lock
        # extra sample sources beyond the registry: name -> callable
        # returning (name, kind, value) batch entries, folded into
        # every scrape. The fleet supervisor registers its worker
        # aggregator here so fleet-summed series get the same windowed
        # rate/quantile machinery local families do.
        self._collectors: dict[str, object] = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # guarded-by: _lock

    def configure(
        self,
        interval_s: float | None = None,
        samples: int | None = None,
        downsample: int | None = None,
    ) -> None:
        if interval_s is not None:
            self.interval_s = interval_s
        with self._lock:
            if samples is not None:
                self._samples = max(2, samples)
            if downsample is not None:
                self._downsample = max(1, downsample)

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    def reset(self) -> None:
        """Test isolation: stop the thread and forget all history."""
        self.stop()
        with self._lock:
            self._series.clear()
            self._scrapes = 0
            self._collectors.clear()

    # -- extra sample sources ----------------------------------------------

    def register_collector(self, name: str, fn) -> None:
        """``fn() -> iterable of (name, kind, value)`` entries folded
        into every scrape beside the registry's own — histogram values
        are ``(bounds, (counts tuple, sum, count))`` exactly like the
        registry snapshot's. A collector that raises costs its entries
        for that scrape, never the scrape."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    # -- scraping ----------------------------------------------------------

    def sample(self, now: float | None = None) -> None:
        """One scrape of the registry into the rings — the thread's
        tick, also driven directly by tests and by the alert engine's
        synchronous evaluations."""
        ts = time.time() if now is None else now
        # snapshot the registry BEFORE taking our lock (the registry
        # has its own), then fold under one hold
        batch: "list[tuple[str, str, object]]" = []
        for name, value in metrics.GLOBAL.snapshot().items():
            batch.append((name, "counter", float(value)))
        for name, value in metrics.GLOBAL.gauges().items():
            batch.append((name, "gauge", float(value)))
        for name, hist in metrics.GLOBAL.histograms().items():
            bounds, counts, total, count = hist
            batch.append(
                (name, "histogram", (bounds, (tuple(counts), total, count)))
            )
        # registered collectors run OUTSIDE our lock (a fleet
        # aggregator's collect() performs bounded-timeout HTTP
        # scrapes); each one's failure costs its entries, not the scrape
        with self._lock:
            collectors = list(self._collectors.items())
        for collector_name, fn in collectors:
            try:
                batch.extend(fn() or ())
            except Exception as exc:
                log.with_fields(collector=collector_name).warning(
                    f"tsdb collector failed: {exc}"
                )
        with self._lock:
            downsample = self._downsample
            coarse_len = max(2, self._samples * 4 // max(1, downsample))
            for name, kind, value in batch:
                series = self._series.get(name)
                if series is None or series.kind != kind:
                    series = self._series[name] = _Series(
                        kind, self._samples, coarse_len
                    )
                if kind == "histogram":
                    bounds, snapshot = value  # type: ignore[misc]
                    series.bounds = bounds
                    series.append(ts, snapshot, downsample)
                else:
                    series.append(ts, value, downsample)
            self._scrapes += 1
        metrics.GLOBAL.add("tsdb_scrapes")

    # -- thread ------------------------------------------------------------

    def start(self) -> "TimeSeriesStore":
        if not self.enabled:
            return self
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            thread = threading.Thread(  # thread-role: tsdb-scraper
                target=self._run, name="tsdb-scrape", daemon=True
            )
            self._thread = thread
        thread.start()
        profiling.ROLES.register_thread(thread, "tsdb-scraper")
        log.with_fields(
            interval_s=self.interval_s, samples=self._samples
        ).info("tsdb scrape thread running")
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=5.0)

    def _run(self) -> None:
        # stall-watchdog liveness: the scrape loop beats every tick, so
        # a wedged scrape (a registry lock held forever, a pathological
        # snapshot) reads as a stalled loop instead of silently blinding
        # every burn-rate alert downstream of it
        watch = watchdog.MONITOR.loop("tsdb-scrape")
        try:
            # poll in sub-second slices so stop() stays prompt at long
            # scrape intervals; beat each slice (the loop IS alive)
            next_at = time.monotonic()
            while True:
                watch.beat()
                interval = self.interval_s
                if interval <= 0:
                    # live-disabled: exit (never busy-spin), and hand
                    # the thread slot back so a later re-enable's
                    # start() actually spawns a fresh loop
                    with self._lock:
                        if self._thread is threading.current_thread():
                            self._thread = None
                    return
                now = time.monotonic()
                if now >= next_at:
                    try:
                        self.sample()
                    except Exception as exc:
                        # one bad scrape must not kill the history
                        log.error("tsdb scrape failed", exc=exc)
                    next_at = now + interval
                if self._stop.wait(min(0.2, interval)):
                    return
        finally:
            watchdog.MONITOR.unregister(watch)

    # -- queries -----------------------------------------------------------

    def names(self) -> dict[str, str]:
        with self._lock:
            return {
                name: series.kind
                for name, series in sorted(self._series.items())
            }

    def _window(
        self, series: _Series, window_s: float, now: float
    ) -> list:
        cut = now - window_s
        return [entry for entry in series.fine if entry[0] >= cut]

    def latest(self, name: str) -> float | None:
        """Newest sampled value for a counter/gauge series."""
        with self._lock:
            series = self._series.get(name)
            if series is None or not series.fine or series.kind == "histogram":
                return None
            return series.fine[-1][1]

    def counter_rate(
        self, name: str, window_s: float, now: float | None = None
    ) -> float | None:
        """Per-second increase of a counter over the window (oldest
        in-window sample vs newest); None without two samples. Counter
        resets (a test's registry reset) clamp to zero, not negative."""
        now = time.time() if now is None else now
        with self._lock:
            series = self._series.get(name)
            if series is None or series.kind != "counter":
                return None
            points = self._window(series, window_s, now)
        if len(points) < 2:
            return None
        (t0, v0), (t1, v1) = points[0], points[-1]
        if t1 <= t0:
            return None
        return max(0.0, v1 - v0) / (t1 - t0)

    def histogram_window(
        self,
        name: str,
        window_s: float,
        now: float | None = None,
        min_samples: int = 1,
    ) -> "tuple[tuple[float, ...], list[int], float, int] | None":
        """The histogram's increase across the window as (bounds,
        CUMULATIVE delta bucket counts, delta sum, delta count):
        newest in-window snapshot minus the oldest. The registry's
        buckets are Prometheus-cumulative, so the difference of two
        snapshots is itself cumulative — feed it to ``quantile``
        directly. With only one sample in the window the delta is
        measured from zero history — the honest display answer for a
        window longer than the uptime. Callers that must not act on a
        single startup snapshot (the burn-rate rules: a restart's
        first cold jobs must not page) pass ``min_samples=2``."""
        now = time.time() if now is None else now
        with self._lock:
            series = self._series.get(name)
            if (
                series is None
                or series.kind != "histogram"
                or series.bounds is None
                or not series.fine
            ):
                return None
            bounds = series.bounds
            points = self._window(series, window_s, now)
        if len(points) < max(1, min_samples):
            return None
        newest_counts, newest_sum, newest_count = points[-1][1]
        if len(points) >= 2:
            oldest_counts, oldest_sum, oldest_count = points[0][1]
        else:
            oldest_counts = (0,) * len(newest_counts)
            oldest_sum, oldest_count = 0.0, 0
        if len(oldest_counts) != len(newest_counts):
            # bucket layout changed under a registry reset; measure
            # from zero rather than subtracting mismatched shapes
            oldest_counts = (0,) * len(newest_counts)
            oldest_sum, oldest_count = 0.0, 0
        deltas = [
            max(0, n - o) for n, o in zip(newest_counts, oldest_counts)
        ]
        return (
            bounds,
            deltas,
            max(0.0, newest_sum - oldest_sum),
            max(0, newest_count - oldest_count),
        )

    def query(self, name: str, window_s: float) -> dict | None:
        """The /debug/tsdb view for one series: raw in-window points
        plus kind-appropriate derivations (counter rate, histogram
        quantile estimates). Points older than the fine ring come from
        the coarse tier, downsampled."""
        now = time.time()
        with self._lock:
            series = self._series.get(name)
            if series is None:
                return None
            kind = series.kind
            bounds = series.bounds
            fine = self._window(series, window_s, now)
            fine_floor = series.fine[0][0] if series.fine else now
            cut = now - window_s
            coarse = [
                entry for entry in series.coarse
                if cut <= entry[0] < fine_floor
            ]
        out: dict = {"name": name, "kind": kind, "window_s": window_s}
        if kind == "histogram":
            out["points"] = [
                {"ts": ts, "count": count, "sum": round(total, 6)}
                for ts, (_, total, count) in fine
            ]
            window = self.histogram_window(name, window_s, now)
            if window is not None:
                w_bounds, cumulative, d_sum, d_count = window
                out["window"] = {
                    "count": d_count,
                    "sum": round(d_sum, 6),
                    "p50": quantile(w_bounds, cumulative, d_count, 0.50),
                    "p95": quantile(w_bounds, cumulative, d_count, 0.95),
                    "p99": quantile(w_bounds, cumulative, d_count, 0.99),
                    # the windowed CUMULATIVE bucket deltas themselves:
                    # a fleet merge sums these across workers and
                    # re-derives true fleet percentiles (averaging
                    # per-worker p99s would be statistically wrong)
                    "buckets": list(cumulative),
                }
            if bounds is not None:
                out["le"] = list(bounds)
            return out
        out["points"] = [
            {"ts": ts, "value": value} for ts, value in fine
        ]
        if coarse:
            out["downsampled"] = [
                (
                    {"ts": e[0], "value": e[1], "min": e[2], "max": e[3]}
                    if kind == "gauge"
                    else {"ts": e[0], "value": e[1]}
                )
                for e in coarse
            ]
        if kind == "counter":
            out["rate_per_s"] = self.counter_rate(name, window_s, now)
        return out

    def snapshot(self) -> dict:
        """Store-level state for /debug/tsdb without a name: what is
        recorded, at what cadence, how deep."""
        with self._lock:
            scrapes = self._scrapes
            series = {
                name: {
                    "kind": s.kind,
                    "fine_samples": len(s.fine),
                    "coarse_samples": len(s.coarse),
                }
                for name, s in sorted(self._series.items())
            }
            running = self._thread is not None
        return {
            "enabled": self.enabled,
            "running": running,
            "interval_s": self.interval_s,
            "samples": self._samples,
            "downsample": self._downsample,
            "scrapes": scrapes,
            "series": series,
        }


# the process-wide store, mirroring tracing.TRACER / watchdog.MONITOR:
# scraping starts only when serve() (or a test) calls STORE.start()
STORE = TimeSeriesStore()
