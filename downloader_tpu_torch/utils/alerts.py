"""Declarative SLO burn-rate and threshold alerting, in-process.

Every job class has an SLO latency histogram and the daemon a flight
recorder, but the loop between them was open: nothing in-tree NOTICED
a burn — an operator had to scrape ``/metrics`` and do the division.
This module closes the loop: a rule engine evaluates multi-window burn
rates (fast + slow, the Google SRE workbook shape: the fast window
catches the page-worthy spike, the slow window keeps a transient blip
from paging) over the per-class SLO histograms sampled by the TSDB
(utils/tsdb.py), plus plain threshold rules on the pressure gauges —
ledger pressure, lane depth, watchdog stalls, publisher liveness.

A rule is a state machine: ``inactive → pending`` (condition first
true) ``→ firing`` (held for ``for_s``) ``→ resolved`` (condition
clear for ``resolve_evals`` consecutive evaluations — flap damping, so
a boundary-oscillating series cannot page once per tick). Firing bumps
``alerts_firing``, serves on ``/debug/alerts``, and captures ONE
rate-limited incident bundle tagged with the rule and offending series
— the alert → flight-recorder hand-off, so the evidence is already in
the bundle when a human arrives. The firing episode is a declared
lifecycle (``# protocol: alert-episode``): the static typestate rule
and the runtime recorder both enforce that every fire reaches exactly
one resolve.

The evaluation thread carries a watchdog liveness watch ("alert-eval")
— the component whose job is noticing burns must not die silently —
and costs nothing on the job path: rules read the TSDB's bounded rings
and the live gauge registry, never the pipeline.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import flows, metrics, profiling, tsdb, watchdog
from .logging import get_logger

log = get_logger("alerts")

DEFAULT_INTERVAL_S = 15.0
DEFAULT_FAST_WINDOW_S = 300.0  # 5 m: the page-worthy spike window
DEFAULT_SLOW_WINDOW_S = 3600.0  # 1 h: the is-it-sustained window
# burn-rate factor: how many times faster than "exactly spend the
# budget" the error rate must run in BOTH windows to fire (14.4 is the
# SRE-workbook pairing for 5m/1h on a 99.9%-style monthly budget)
DEFAULT_BURN_FACTOR = 14.4
DEFAULT_OBJECTIVE = 0.99  # fraction of jobs that must meet the target
DEFAULT_SLO_INTERACTIVE_S = 1.0
DEFAULT_SLO_BULK_S = 60.0
DEFAULT_RESOLVE_EVALS = 2  # consecutive clear evals before resolved
# how deep a queue lane may sit before the depth rule trips; depth is
# bounded by prefetch × workers in practice, so four figures means the
# admission layer is not keeping up
QUEUE_DEPTH_THRESHOLD = 1000.0
# the publisher gauge reads 0 during normal reconnects; only a dead
# publisher that stays dead should page
PUBLISHER_DOWN_FOR_S = 30.0
# origin amplification legitimately spikes while a cold worker warms
# (every first fetch is "redundant" until the object is unique-counted);
# only a SUSTAINED ratio is an origin-bill burn worth paging on
AMPLIFICATION_BURN_FOR_S = 120.0

_STATES = ("inactive", "pending", "firing", "resolved")


def _float_env(env, name: str, default: float, minimum: float = 0.0) -> float:
    raw = (env.get(name) or "").strip()
    if not raw:
        return default
    try:
        return max(minimum, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            f"ignoring invalid {name} (want a number)"
        )
        return default


def interval_from_env(environ=None) -> float:
    """``ALERT_INTERVAL``: seconds between rule evaluations; ``0``/
    ``off`` disables the engine."""
    env = os.environ if environ is None else environ
    raw = (env.get("ALERT_INTERVAL") or "").strip().lower()
    if raw in ("off", "false", "no", "disabled"):
        return 0.0
    return _float_env(env, "ALERT_INTERVAL", DEFAULT_INTERVAL_S)


def windows_from_env(environ=None) -> "tuple[float, float]":
    """``ALERT_FAST_WINDOW_S`` / ``ALERT_SLOW_WINDOW_S``: the two burn
    windows (seconds)."""
    env = os.environ if environ is None else environ
    fast = _float_env(
        env, "ALERT_FAST_WINDOW_S", DEFAULT_FAST_WINDOW_S, minimum=1.0
    )
    slow = _float_env(
        env, "ALERT_SLOW_WINDOW_S", DEFAULT_SLOW_WINDOW_S, minimum=1.0
    )
    return fast, max(slow, fast)


def burn_factor_from_env(environ=None) -> float:
    """``ALERT_BURN_FACTOR``: burn-rate multiple both windows must
    exceed to fire."""
    env = os.environ if environ is None else environ
    return _float_env(
        env, "ALERT_BURN_FACTOR", DEFAULT_BURN_FACTOR, minimum=0.001
    )


def objective_from_env(environ=None) -> float:
    """``ALERT_OBJECTIVE``: fraction of jobs that must meet their
    class's latency target (the SLO objective; 0.99 = 1% budget)."""
    env = os.environ if environ is None else environ
    value = _float_env(
        env, "ALERT_OBJECTIVE", DEFAULT_OBJECTIVE, minimum=0.0
    )
    return min(value, 0.9999)


def slo_targets_from_env(environ=None) -> "tuple[float, float]":
    """``ALERT_SLO_INTERACTIVE_S`` / ``ALERT_SLO_BULK_S``: per-class
    completion-latency targets the burn rules measure against."""
    env = os.environ if environ is None else environ
    return (
        _float_env(
            env, "ALERT_SLO_INTERACTIVE_S", DEFAULT_SLO_INTERACTIVE_S,
            minimum=0.001,
        ),
        _float_env(
            env, "ALERT_SLO_BULK_S", DEFAULT_SLO_BULK_S, minimum=0.001
        ),
    )


# -- the data the rules evaluate over -----------------------------------------


class RegistryView:
    """What a rule condition may read: live gauges from the registry
    (a threshold on a level must see NOW, not the last scrape),
    windowed counter rates / histogram deltas from the TSDB, and
    recent trace-id exemplars for a histogram family (local registry
    first; ``exemplar_source`` covers series that live only in the
    TSDB, like the fleet supervisor's aggregated worker sums)."""

    def __init__(
        self,
        store: "tsdb.TimeSeriesStore",
        exemplar_source=None,
    ):
        self._store = store
        self._exemplar_source = exemplar_source

    def gauge(self, name: str) -> float | None:
        gauges = metrics.GLOBAL.gauges()
        if name in gauges:
            return gauges[name]
        return self._store.latest(name)

    def exemplars(self, name: str) -> list[dict]:
        """Recent {trace_id, value, ts} exemplars for ``name`` — the
        metric→trace back-link a firing burn alert serves."""
        out = metrics.GLOBAL.exemplars(name)
        if not out and self._exemplar_source is not None:
            try:
                out = list(self._exemplar_source(name) or [])
            except Exception:
                # exemplars are evidence garnish, never a verdict input
                out = []
        return out

    def counter_rate(
        self, name: str, window_s: float, now: float
    ) -> float | None:
        return self._store.counter_rate(name, window_s, now)

    def error_burn(
        self,
        series: str,
        target_s: float,
        objective: float,
        window_s: float,
        now: float,
    ) -> float | None:
        """The burn-rate multiple for one window: (fraction of jobs
        over ``target_s``) / (1 - objective). None without data —
        an idle class burns nothing. Mass beyond the top finite bucket
        counts as over-target (conservative when the target exceeds
        the histogram's range)."""
        # min_samples=2: the burn is a DELTA between snapshots; a
        # single whole-short-life sample right after startup would
        # read as a 100% error window and bypass the multi-window
        # damping (a restart's first cold jobs must never page)
        window = self._store.histogram_window(
            series, window_s, now, min_samples=2
        )
        if window is None:
            return None
        # the window's bucket counts are already cumulative (the
        # registry stores Prometheus-style le-buckets)
        bounds, cumulative, _, count = window
        if count <= 0:
            return None
        good = self._count_at_or_below(bounds, cumulative, target_s)
        error_rate = max(0.0, 1.0 - good / count)
        budget = max(1e-6, 1.0 - objective)
        return error_rate / budget

    @staticmethod
    def _count_at_or_below(
        bounds: "tuple[float, ...]",
        cumulative: "list[float]",
        target: float,
    ) -> float:
        previous_bound, previous_count = 0.0, 0.0
        for le, count in zip(bounds, cumulative):
            if target <= le:
                if le <= previous_bound:
                    return count
                fraction = (target - previous_bound) / (le - previous_bound)
                return previous_count + (count - previous_count) * fraction
            previous_bound, previous_count = le, count
        return cumulative[-1] if cumulative else 0.0


# -- rules --------------------------------------------------------------------


class AlertRule:
    """Base rule: the pending/firing/resolved state machine. Concrete
    rules implement ``_condition(view, now) -> (breached, detail)``
    where ``breached`` is False on missing data (an alert must never
    fire because the process just started)."""

    kind = "rule"

    def __init__(
        self,
        name: str,
        series: str,
        severity: str = "page",
        for_s: float = 0.0,
        resolve_evals: int = DEFAULT_RESOLVE_EVALS,
        description: str = "",
    ):
        self.name = name
        self.series = series
        self.severity = severity
        self.for_s = for_s
        self.resolve_evals = max(1, resolve_evals)
        self.description = description
        self.state = "inactive"
        self.pending_since: float | None = None
        self.fired_at: float | None = None
        self.resolved_at: float | None = None
        self.fire_count = 0
        self.last_eval: float | None = None
        self.last_detail: dict = {}
        self._clear_streak = 0
        self._episode: "AlertRule | None" = None

    # -- the declared lifecycle: one fire, exactly one resolve -----------

    def _enter_firing(self) -> "AlertRule":  # protocol: alert-episode acquire
        self.state = "firing"
        return self

    def _exit_firing(self) -> None:  # protocol: alert-episode release
        self.state = "resolved"
        self._episode = None

    # -- evaluation -------------------------------------------------------

    def _condition(self, view: RegistryView, now: float):
        raise NotImplementedError

    def evaluate(self, view: RegistryView, now: float) -> str | None:
        """One evaluation tick; returns the transition taken this tick
        ("pending" | "firing" | "inactive" | "resolved") or None."""
        try:
            breached, detail = self._condition(view, now)
        except Exception as exc:
            # a rule bug must cost its own verdict, not the engine
            log.with_fields(rule=self.name).warning(
                f"alert rule evaluation failed: {exc}"
            )
            return None
        self.last_eval = now
        self.last_detail = detail
        if breached:
            self._clear_streak = 0
            if self.state in ("inactive", "resolved"):
                self.state = "pending"
                self.pending_since = now
                if self.for_s > 0:
                    return "pending"
            if (
                self.state == "pending"
                and now - (self.pending_since or now) >= self.for_s
            ):
                # the escaped episode handle is released by the resolve
                # path below (or an engine reset); the static rule sees
                # the store, the runtime recorder tracks the instance
                self._episode = self._enter_firing()
                self.fired_at = now
                self.fire_count += 1
                return "firing"
            return None
        if self.state == "pending":
            self.state = "inactive"
            self.pending_since = None
            return "inactive"
        if self.state == "firing":
            self._clear_streak += 1
            if self._clear_streak >= self.resolve_evals:
                self._exit_firing()
                self.resolved_at = now
                return "resolved"
        return None

    def reset(self) -> None:
        """Test isolation / engine teardown: a still-firing episode is
        resolved through the declared release, never dropped."""
        if self.state == "firing":
            self._exit_firing()
        self.state = "inactive"
        self.pending_since = None
        self.fired_at = None
        self.resolved_at = None
        self.fire_count = 0
        self.last_eval = None
        self.last_detail = {}
        self._clear_streak = 0

    def snapshot(self) -> dict:
        out = {
            "name": self.name,
            "kind": self.kind,
            "series": self.series,
            "severity": self.severity,
            "state": self.state,
            "for_s": self.for_s,
            "resolve_evals": self.resolve_evals,
            "fire_count": self.fire_count,
            "detail": dict(self.last_detail),
        }
        if self.description:
            out["description"] = self.description
        if self.pending_since is not None:
            out["pending_since"] = self.pending_since
        if self.fired_at is not None:
            out["fired_at"] = self.fired_at
        if self.resolved_at is not None:
            out["resolved_at"] = self.resolved_at
        return out


class BurnRateRule(AlertRule):
    """Multi-window SLO burn: fires when the error budget burns at
    ``factor``× in BOTH the fast and the slow window."""

    kind = "burn-rate"

    def __init__(
        self,
        name: str,
        series: str,
        target_s: float,
        objective: float = DEFAULT_OBJECTIVE,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        factor: float = DEFAULT_BURN_FACTOR,
        seed_registry: bool = True,
        **kwargs,
    ):
        """``seed_registry=False`` marks a series whose samples come
        from a TSDB collector rather than the local registry (the fleet
        supervisor's aggregated worker sums): seeding a zeroed registry
        histogram under that name would make the scrape loop record a
        second, always-zero series that fights the collector's."""
        super().__init__(name, series, **kwargs)
        self.target_s = target_s
        self.objective = objective
        self.fast_window_s = fast_window_s
        self.slow_window_s = max(slow_window_s, fast_window_s)
        self.factor = factor
        self.seed_registry = seed_registry

    def _condition(self, view: RegistryView, now: float):
        fast = view.error_burn(
            self.series, self.target_s, self.objective,
            self.fast_window_s, now,
        )
        slow = view.error_burn(
            self.series, self.target_s, self.objective,
            self.slow_window_s, now,
        )
        detail = {
            "target_s": self.target_s,
            "objective": self.objective,
            "factor": self.factor,
            "burn_fast": None if fast is None else round(fast, 3),
            "burn_slow": None if slow is None else round(slow, 3),
        }
        # the metric→trace link: recent exemplars for the watched
        # series ride the detail, so /debug/alerts and the incident
        # bundle point straight at example traces of the burn
        exemplars = view.exemplars(self.series)
        if exemplars:
            detail["exemplars"] = exemplars
        if fast is None or slow is None:
            return False, detail
        return fast >= self.factor and slow >= self.factor, detail

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["windows_s"] = [self.fast_window_s, self.slow_window_s]
        return out


class ThresholdRule(AlertRule):
    """A level (gauge) or windowed counter rate compared to a bound."""

    kind = "threshold"

    def __init__(
        self,
        name: str,
        series: str,
        threshold: float,
        op: str = ">=",
        source: str = "gauge",
        window_s: float = DEFAULT_FAST_WINDOW_S,
        **kwargs,
    ):
        super().__init__(name, series, **kwargs)
        if op not in (">=", "<="):
            raise ValueError(f"unsupported threshold op {op!r}")
        self.threshold = threshold
        self.op = op
        self.source = source
        self.window_s = window_s

    def _condition(self, view: RegistryView, now: float):
        if self.source == "counter_rate":
            value = view.counter_rate(self.series, self.window_s, now)
        else:
            value = view.gauge(self.series)
        detail = {
            "value": value,
            "threshold": self.threshold,
            "op": self.op,
        }
        if value is None:
            return False, detail
        if self.op == ">=":
            return value >= self.threshold, detail
        return value <= self.threshold, detail


class WorkerOutlierRule(AlertRule):
    """One fleet member far from the fleet median NAMES the instance:
    ``provider()`` returns ``{instance: value}`` (per-worker windowed
    p99 or error rate, computed by the fleet aggregator); the rule
    fires when the worst instance sits at ``ratio`` × its PEERS'
    median or beyond. Needs at least two reporting instances (one worker has
    no fleet to be an outlier of) and an absolute ``min_value`` floor
    so microsecond-scale medians cannot page on noise ratios."""

    kind = "worker-outlier"

    def __init__(
        self,
        name: str,
        series: str,
        provider,
        ratio: float = 4.0,
        min_value: float = 0.05,
        **kwargs,
    ):
        super().__init__(name, series, **kwargs)
        self._provider = provider
        self.ratio = max(1.0, ratio)
        self.min_value = min_value

    def _condition(self, view: RegistryView, now: float):
        import statistics

        raw = self._provider() or {}
        values = {
            instance: value
            for instance, value in raw.items()
            if value is not None
        }
        detail: dict = {
            "ratio": self.ratio,
            "min_value": self.min_value,
            "values": {
                instance: round(value, 4)
                for instance, value in sorted(values.items())
            },
        }
        if len(values) < 2:
            return False, detail
        worst_instance, worst = max(values.items(), key=lambda kv: kv[1])
        # median of the PEERS: including the candidate itself would
        # let a 2-worker fleet's outlier drag the median halfway to
        # its own value and never trip the ratio
        median = statistics.median(
            value
            for instance, value in values.items()
            if instance != worst_instance
        )
        detail["median"] = round(median, 4)
        detail["instance"] = worst_instance
        detail["worst"] = round(worst, 4)
        breached = worst >= self.min_value and worst >= max(
            median * self.ratio, self.min_value
        )
        return breached, detail


def default_rules(
    slo_interactive_s: float = DEFAULT_SLO_INTERACTIVE_S,
    slo_bulk_s: float = DEFAULT_SLO_BULK_S,
    objective: float = DEFAULT_OBJECTIVE,
    fast_window_s: float = DEFAULT_FAST_WINDOW_S,
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
    factor: float = DEFAULT_BURN_FACTOR,
) -> "list[AlertRule]":
    """The stock rule set serve() installs: per-class SLO burn plus
    threshold rules on every pressure signal the admission/watchdog
    layers export. Every referenced series is a registered family —
    tests/test_metrics_lint.py enforces the catalog stays closed."""
    return [
        BurnRateRule(
            "interactive-latency-burn",
            "slo_job_duration_seconds_interactive",
            target_s=slo_interactive_s,
            objective=objective,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
            factor=factor,
            description=(
                "interactive jobs are blowing their latency SLO fast "
                "enough to exhaust the error budget"
            ),
        ),
        BurnRateRule(
            "bulk-latency-burn",
            "slo_job_duration_seconds_bulk",
            target_s=slo_bulk_s,
            objective=objective,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
            factor=factor,
            severity="ticket",
            description="bulk-class latency burning its (looser) budget",
        ),
        ThresholdRule(
            "ledger-pressure-saturated",
            "admission_pressure",
            threshold=1.0,
            description=(
                "the tightest admission budget is at or past its "
                "limit; the shed rung is imminent or engaged"
            ),
        ),
        ThresholdRule(
            "queue-lane-depth",
            "admission_lane_depth",
            threshold=QUEUE_DEPTH_THRESHOLD,
            severity="ticket",
            description="parked deliveries piling up in admission lanes",
        ),
        ThresholdRule(
            "watchdog-stalled-tasks",
            "watchdog_stalled_tasks",
            threshold=1.0,
            description="at least one job/loop shows no forward progress",
        ),
        ThresholdRule(
            "publisher-dead",
            "queue_publisher_alive",
            threshold=0.0,
            op="<=",
            for_s=PUBLISHER_DOWN_FOR_S,
            description=(
                "the publisher thread has been down longer than a "
                "reconnect should take; Convert hand-offs are buffering"
            ),
        ),
        ThresholdRule(
            "origin-amplification-burn",
            "flow_origin_amplification",
            threshold=flows.amplification_alert_from_env(),
            for_s=AMPLIFICATION_BURN_FOR_S,
            description=(
                "this worker is fetching far more origin bytes than the "
                "unique object bytes it serves (dead cache layer, "
                "refetch loop, or a flash crowd hitting a cold fleet) — "
                "sustained, so it's the origin bill burning, not warmup"
            ),
        ),
        ThresholdRule(
            "hot-object-concentration",
            "flow_hot_object_share",
            threshold=flows.hot_share_alert_from_env(),
            severity="ticket",
            description=(
                "a single object dominates ingress (heavy-hitter "
                "sketch); a flash crowd or a stuck refetch on one key"
            ),
        ),
        ThresholdRule(
            "canary-failure",
            "canary_failing",
            threshold=1.0,
            description=(
                "a synthetic canary probe failed outside-in "
                "verification (publish, Convert round-trip, or store "
                "read-back integrity) — the pipeline is broken or "
                "silently corrupting even if every passive signal is "
                "green (utils/canary.py)"
            ),
        ),
    ]


# a worker restarting occasionally is the crash-only design WORKING;
# this many restarts across the fleet inside the fast window is a
# crash loop an operator must see (bad deploy, poisoned job class,
# dying host)
WORKER_FLAP_RESTARTS = 3.0


def fleet_rules(
    fast_window_s: float = DEFAULT_FAST_WINDOW_S,
) -> "list[AlertRule]":
    """The fleet supervisor's rule set (daemon/fleet.py installs it):
    restart churn and fatal start-failure slots, evaluated over the
    supervisor's own registry — the crash-only escalation path from
    "the supervisor handled it" to "a human must look"."""
    return [
        ThresholdRule(
            "worker-flapping",
            "fleet_worker_restarts",
            threshold=WORKER_FLAP_RESTARTS / fast_window_s,
            source="counter_rate",
            window_s=fast_window_s,
            description=(
                "fleet workers are restart-looping faster than the "
                "crash-only design can absorb (bad deploy or dying host)"
            ),
        ),
        ThresholdRule(
            "worker-start-failures",
            "fleet_worker_start_failures",
            threshold=1.0,
            source="counter_rate",
            window_s=fast_window_s,
            severity="ticket",
            description=(
                "workers are exiting during startup (bad config, port "
                "in use); slots go FATAL after the configured attempts"
            ),
        ),
    ]


# -- the engine ---------------------------------------------------------------


class AlertEngine:
    """Owns the rule set and the evaluation loop; serves
    ``/debug/alerts``; captures one rate-limited incident per firing
    transition so the flight recorder holds the evidence."""

    def __init__(
        self,
        rules: "list[AlertRule] | None" = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        store: "tsdb.TimeSeriesStore | None" = None,
    ):
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._rules: "list[AlertRule]" = list(rules or [])  # guarded-by: _lock
        self._store = store if store is not None else tsdb.STORE
        self._history: "deque[dict]" = deque(maxlen=64)  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._evals = 0  # guarded-by: _lock
        # firing hand-off override: the fleet supervisor installs a
        # cross-worker capture here (every worker's POST /debug/incident
        # bundled under one fleet id); None keeps the local flight-
        # recorder capture
        self._on_fire = None  # guarded-by: _lock
        # exemplar lookup for series that live only in the TSDB (the
        # supervisor's fleet-aggregated sums); None = registry only
        self._exemplar_source = None  # guarded-by: _lock

    def configure(
        self,
        rules: "list[AlertRule] | None" = None,
        interval_s: float | None = None,
        store: "tsdb.TimeSeriesStore | None" = None,
        on_fire=None,
        exemplar_source=None,
    ) -> None:
        with self._lock:
            if rules is not None:
                for stale in self._rules:
                    stale.reset()
                self._rules = list(rules)
            if store is not None:
                self._store = store
            if on_fire is not None:
                self._on_fire = on_fire
            if exemplar_source is not None:
                self._exemplar_source = exemplar_source
            installed = list(self._rules)
        if interval_s is not None:
            self.interval_s = interval_s
        # burn windows are DELTAS between registry snapshots, so each
        # watched histogram must exist (zeroed) before its first
        # observation: otherwise the family's first sample already
        # carries the whole burst and no in-window delta ever shows it.
        # Collector-fed series (seed_registry=False) are the exception:
        # a zeroed registry twin would fight the collector's samples.
        for rule in installed:
            if isinstance(rule, BurnRateRule) and rule.seed_registry:
                metrics.GLOBAL.ensure_histogram(rule.series)

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    def rules(self) -> "list[AlertRule]":
        with self._lock:
            return list(self._rules)

    def reset(self) -> None:
        """Test isolation: stop the loop, resolve every open episode,
        forget history."""
        self.stop()
        with self._lock:
            rules = list(self._rules)
            self._history.clear()
            self._evals = 0
            self._on_fire = None
            self._exemplar_source = None
        for rule in rules:
            rule.reset()
        metrics.GLOBAL.gauge_set("alerts_firing", 0)

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: float | None = None) -> "list[AlertRule]":
        """One pass over the rules; returns rules that transitioned to
        firing this pass (tests drive this synchronously)."""
        now = time.time() if now is None else now
        with self._lock:
            rules = list(self._rules)
            exemplar_source = self._exemplar_source
            on_fire = self._on_fire
            self._evals += 1
        view = RegistryView(self._store, exemplar_source=exemplar_source)
        fired: "list[AlertRule]" = []
        for rule in rules:
            transition = rule.evaluate(view, now)
            if transition is None:
                continue
            event = {
                "ts": now,
                "rule": rule.name,
                "transition": transition,
                "detail": dict(rule.last_detail),
            }
            with self._lock:
                self._history.append(event)
            level = log.with_fields(
                rule=rule.name, state=transition,
                series=rule.series,
            )
            if transition == "firing":
                fired.append(rule)
                level.error("alert firing")
            elif transition == "resolved":
                level.info("alert resolved")
            else:
                level.info("alert state changed")
        firing_now = sum(1 for rule in rules if rule.state == "firing")
        metrics.GLOBAL.gauge_set("alerts_firing", firing_now)
        for rule in fired:
            metrics.GLOBAL.add("alerts_fired")
            if on_fire is not None:
                # the installed hand-off owns its own threading (the
                # fleet capture fans out HTTP posts); its bug must cost
                # the capture, never the evaluator
                try:
                    on_fire(rule)
                except Exception as exc:
                    log.with_fields(rule=rule.name).warning(
                        f"alert on_fire hand-off failed: {exc}"
                    )
            else:
                self._capture_async(rule)
        return fired

    def _capture_async(self, rule: AlertRule) -> None:
        # the flight-recorder hand-off runs on its own thread, like the
        # watchdog's: whatever is burning the SLO (a hung filesystem
        # under INCIDENT_DIR included) must not wedge the evaluator
        def _capture():
            from . import incident

            try:
                incident.RECORDER.capture(
                    f"alert '{rule.name}' firing ({rule.series})",
                    trigger="alert",
                    extra={
                        "rule": rule.name,
                        "series": rule.series,
                        "severity": rule.severity,
                        "detail": dict(rule.last_detail),
                    },
                )
            except Exception as exc:
                log.warning(f"alert incident capture failed: {exc}")

        try:
            threading.Thread(
                target=_capture, name="alert-capture", daemon=True
            ).start()
        except RuntimeError:
            _capture()  # thread exhaustion: keep the evidence anyway

    # -- thread ------------------------------------------------------------

    def start(self) -> "AlertEngine":
        if not self.enabled:
            return self
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            rule_count = len(self._rules)
            thread = threading.Thread(  # thread-role: alert-evaluator
                target=self._run, name="alert-eval", daemon=True
            )
            self._thread = thread
        thread.start()
        profiling.ROLES.register_thread(thread, "alert-evaluator")
        log.with_fields(
            interval_s=self.interval_s, rules=rule_count
        ).info("alert engine running")
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=5.0)

    def _run(self) -> None:
        # liveness-watched like the TSDB scraper: the loop that notices
        # burns must itself be noticed if it wedges
        watch = watchdog.MONITOR.loop("alert-eval")
        try:
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
                        self.evaluate()
                    except Exception as exc:
                        log.error("alert evaluation failed", exc=exc)
                    next_at = now + interval
                if self._stop.wait(min(0.2, interval)):
                    return
        finally:
            watchdog.MONITOR.unregister(watch)

    # -- views -------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            rules = list(self._rules)
            history = list(self._history)
            evals = self._evals
            running = self._thread is not None
        return {
            "enabled": self.enabled,
            "running": running,
            "interval_s": self.interval_s,
            "evaluations": evals,
            "firing": sum(1 for r in rules if r.state == "firing"),
            "rules": [rule.snapshot() for rule in rules],
            "history": history,
        }


# process-wide engine, mirroring tsdb.STORE: serve() installs the
# default rule set and starts the loop; tests drive evaluate() directly
ENGINE = AlertEngine()
