"""Progress-based stall watchdog: notice the job that stopped moving.

Every regression class this codebase has paid for — the wedged
publisher thread (queue/client.py), silently dead peer loops, dangling
multipart uploads — manifests first as work that stops making forward
progress, not as an exception. Timeout-based supervision cannot tell a
*stalled* job (no progress) from a merely *slow* one (a 100 GB torrent
is supposed to take a while), so the watchdog watches progress
counters instead of wall clocks: pipeline stages bump a per-stage
heartbeat counter as bytes flush / parts complete / publishes confirm,
and a job is flagged only when its ACTIVE stage's counter has not
advanced for the configured deadline.

Cost discipline, in order:

- **The hot byte path pays one counter bump.** ``Heartbeat.beat(n)``
  is ``self.count += n`` — no lock, no ``time.monotonic()``, no
  branching. The watchdog thread owns all timekeeping: it remembers
  the last counter value it saw per stage and when it changed.
  Torn/lost increments between threads are harmless — the watchdog
  only needs the value to CHANGE, not to be exact.
- **Nothing runs when disabled.** The monitor thread starts only in
  ``serve()`` (``WATCHDOG_STALL_S=0``/``off`` keeps it off); code
  paths outside an installed watch get the shared no-op watch whose
  heartbeats nobody scans.
- **Propagation mirrors progress.py/tracing.py.** The daemon installs
  the job's watch thread-locally around the pipeline; components that
  fan out to worker threads capture the relevant ``Heartbeat`` on the
  job thread and beat it from wherever their writes happen.

On stall the watchdog logs, bumps ``watchdog_stalls``, fires the
incident recorder (utils/incident.py — one capture per stall episode),
and under ``WATCHDOG_ACTION=cancel`` cancels the job through its
per-job CancelToken (utils/cancel.py), which converges on the daemon's
normal transient-failure retry path. A stalled watch that advances
again is logged as recovered and re-armed.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from . import metrics, profiling
from .logging import get_logger

log = get_logger("watchdog")

DEFAULT_STALL_S = 120.0
# how long a service loop (dequeue poll, queue publisher) may go
# without an iteration before it reads as wedged; loops tick at >=5 Hz
# when healthy so this is generous by three orders of magnitude
DEFAULT_LOOP_STALL_S = 60.0
_ACTIONS = ("log", "cancel")


def stall_from_env(environ=None) -> float:
    """``WATCHDOG_STALL_S``: seconds of no forward progress before a
    stage is flagged. ``0``/``off`` disables the watchdog."""
    env = os.environ if environ is None else environ
    raw = (env.get("WATCHDOG_STALL_S") or "").strip().lower()
    if not raw:
        return DEFAULT_STALL_S
    if raw in ("off", "false", "no", "disabled"):
        return 0.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid WATCHDOG_STALL_S (want seconds or 'off')"
        )
        return DEFAULT_STALL_S


def action_from_env(environ=None) -> str:
    """``WATCHDOG_ACTION``: ``log`` (default) only records the stall;
    ``cancel`` also cancels the stalled job's token."""
    env = os.environ if environ is None else environ
    raw = (env.get("WATCHDOG_ACTION") or "log").strip().lower()
    if raw not in _ACTIONS:
        log.with_fields(value=raw).warning(
            "ignoring invalid WATCHDOG_ACTION (want log|cancel)"
        )
        return "log"
    return raw


def stage_overrides_from_env(environ=None) -> dict[str, float]:
    """``WATCHDOG_STALL_STAGES``: per-stage deadline overrides as
    ``stage=seconds`` pairs (``fetch=600,publish=30``) — a torrent
    fetch legitimately idles longer between verified pieces than a
    publish should between confirms."""
    env = os.environ if environ is None else environ
    raw = (env.get("WATCHDOG_STALL_STAGES") or "").strip()
    overrides: dict[str, float] = {}
    if not raw:
        return overrides
    for pair in raw.split(","):
        pair = pair.strip()
        if not pair:
            continue
        stage, _, value = pair.partition("=")
        try:
            overrides[stage.strip()] = max(0.0, float(value))
        except ValueError:
            log.with_fields(pair=pair).warning(
                "ignoring invalid WATCHDOG_STALL_STAGES entry "
                "(want stage=seconds)"
            )
    return overrides


class Heartbeat:
    """One stage's forward-progress counter. ``beat`` is the whole hot
    path: a plain int add, safe to call from any thread at any rate
    (the watchdog only needs change, not an exact total)."""

    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def beat(self, n: int = 1) -> None:
        self.count += n


# process-unique watch identities: keying the monitor's `_seen` map by
# id(watch) would let CPython recycle a freed watch's address onto the
# next registration, inheriting a stale (stage, count, timestamp) entry
# that could instantly flag a healthy new job
_WATCH_KEYS = itertools.count(1)


class TaskWatch:
    """One watched unit of work: a job moving through pipeline stages,
    or a long-lived service loop (kind='loop') with a single implicit
    stage. Stage transitions count as progress; ``suspend()`` parks a
    loop watch while its thread hands off to a job watch."""

    __slots__ = (
        "name", "kind", "key", "started", "meta", "stalled", "stall_count",
        "_watchdog", "_cancel", "_deadline", "_lock", "_stages", "_stage",
        "_suspended",
    )

    def __init__(
        self,
        watchdog: "Watchdog | None",
        name: str,
        kind: str = "job",
        deadline: float | None = None,
        cancel=None,
    ):
        self._watchdog = watchdog
        self.name = name
        self.kind = kind
        self.key = next(_WATCH_KEYS)
        self.started = time.monotonic()
        self.meta: dict = {}
        self.stalled = False  # set/cleared by the watchdog thread only
        self.stall_count = 0
        self._cancel = cancel
        self._deadline = deadline
        self._lock = threading.Lock()
        self._stages: dict[str, Heartbeat] = {}  # guarded-by: _lock
        self._stage: str | None = None  # guarded-by: _lock
        self._suspended = False  # guarded-by: _lock

    # -- stage lifecycle (job thread) -------------------------------------

    def heartbeat(self, name: str) -> Heartbeat:
        """Get-or-create the heartbeat for ``name`` WITHOUT making it
        the active stage — how backends grab the fetch counter once and
        then beat it lock-free from worker threads."""
        with self._lock:
            hb = self._stages.get(name)
            if hb is None:
                hb = self._stages[name] = Heartbeat(name)
        return hb

    def stage(self, name: str) -> Heartbeat:
        """Enter stage ``name``: its heartbeat becomes the one the
        watchdog scans. Entry itself counts as progress (the previous
        stage's silence is forgiven the moment the job moves on)."""
        hb = self.heartbeat(name)
        with self._lock:
            self._stage = name
        hb.beat()
        return hb

    def rename(self, name: str) -> None:
        """Late identity: the daemon learns the job id only after proto
        decode, like tracing's root annotate."""
        self.name = name

    def beat(self, n: int = 1) -> None:
        """Progress on the active stage (loop watches: the iteration
        tick). Creates the implicit stage on first use."""
        with self._lock:
            stage = self._stage
            hb = self._stages.get(stage) if stage is not None else None
        if hb is None:
            self.stage("loop" if self.kind == "loop" else "run")
        else:
            hb.beat(n)

    # -- suspension (loop watches around job hand-off) ---------------------

    class _Suspension:
        __slots__ = ("_watch",)

        def __init__(self, watch: "TaskWatch"):
            self._watch = watch

        def __enter__(self):
            with self._watch._lock:
                self._watch._suspended = True
            return self._watch

        def __exit__(self, exc_type, exc, tb):
            with self._watch._lock:
                self._watch._suspended = False
            # resuming is progress: the loop was legitimately busy
            self._watch.beat()

    def suspend(self) -> "TaskWatch._Suspension":
        return TaskWatch._Suspension(self)

    # -- watchdog-side views ----------------------------------------------

    def _active(self) -> tuple[str, int] | None:
        """(stage name, counter value) the watchdog should judge, or
        None when suspended / no stage entered yet."""
        with self._lock:
            if self._suspended or self._stage is None:
                return None
            return self._stage, self._stages[self._stage].count

    def cancel(self) -> bool:
        if self._cancel is None:
            return False
        try:
            self._cancel()
        except Exception as exc:
            # the cancel hook failing must not kill the monitor thread;
            # the stall is already logged — leave a breadcrumb
            log.with_fields(watch=self.name).warning(
                f"watchdog cancel hook raised: {exc}"
            )
        return True

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {name: hb.count for name, hb in self._stages.items()}


class _NoopWatch:
    """Shared do-nothing watch for code running outside an installed
    job. ``heartbeat()`` returns a real (unscanned) Heartbeat so hot
    paths keep the identical counter-bump shape with zero branching."""

    __slots__ = ()
    name = ""
    kind = "noop"
    key = 0  # never registered; unregister(NOOP_WATCH) is a no-op
    stalled = False

    _SINK = Heartbeat("noop")

    def heartbeat(self, name: str) -> Heartbeat:
        return self._SINK

    def stage(self, name: str) -> Heartbeat:
        return self._SINK

    def rename(self, name: str) -> None:
        pass

    def beat(self, n: int = 1) -> None:
        pass

    def suspend(self):
        return _NOOP_SUSPENSION


class _NoopSuspension:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        pass


_NOOP_SUSPENSION = _NoopSuspension()
NOOP_WATCH = _NoopWatch()


class Watchdog:
    """The monitor: a registry of watches plus one scanning thread.

    The thread owns all per-stage timekeeping in ``_seen`` (keyed by
    watch identity), so registering, beating, and unregistering stay
    cheap for the watched code. A stall is an EPISODE: flagged once
    when the deadline passes, re-armed only after progress resumes."""

    def __init__(
        self,
        stall_s: float = DEFAULT_STALL_S,
        action: str = "log",
        stage_overrides: dict[str, float] | None = None,
        loop_stall_s: float = DEFAULT_LOOP_STALL_S,
        on_stall=None,
    ):
        self.stall_s = stall_s
        self.action = action
        self.stage_overrides = dict(stage_overrides or {})
        self.loop_stall_s = loop_stall_s
        self.on_stall = on_stall  # (watch, stage, idle_s) -> None
        self._lock = threading.Lock()
        self._watches: dict[int, TaskWatch] = {}  # keyed by watch.key; guarded-by: _lock
        # watch.key -> (stage, count, last_change); STRICTLY confined
        # to the scan thread (scan()/reset() with the thread stopped) —
        # unregister must never touch it, or a worker thread pops
        # entries out from under scan()'s iteration
        self._seen: dict[int, tuple[str, int, float]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._stalled_now = 0

    # -- configuration -----------------------------------------------------

    def configure(
        self,
        stall_s: float | None = None,
        action: str | None = None,
        stage_overrides: dict[str, float] | None = None,
        loop_stall_s: float | None = None,
        on_stall=None,
    ) -> None:
        if stall_s is not None:
            self.stall_s = stall_s
        if action is not None:
            self.action = action
        if stage_overrides is not None:
            self.stage_overrides = dict(stage_overrides)
        if loop_stall_s is not None:
            self.loop_stall_s = loop_stall_s
        if on_stall is not None:
            self.on_stall = on_stall

    @property
    def enabled(self) -> bool:
        return self.stall_s > 0

    def deadline_for(self, watch: TaskWatch, stage: str) -> float:
        if stage in self.stage_overrides:
            return self.stage_overrides[stage]
        if watch._deadline is not None:
            return watch._deadline
        if watch.kind == "loop":
            return self.loop_stall_s
        return self.stall_s

    # -- registration ------------------------------------------------------

    def job(self, name: str, cancel=None) -> "TaskWatch | _NoopWatch":  # protocol: watchdog-watch acquire
        """Register a job watch — or hand out the shared no-op when the
        watchdog is disabled (WATCHDOG_STALL_S=0), so an ablated run
        pays nothing: no registration, no real counters, no scanning.
        ``unregister`` accepts the no-op harmlessly."""
        if not self.enabled:
            return NOOP_WATCH
        watch = TaskWatch(self, name, kind="job", cancel=cancel)
        with self._lock:
            self._watches[watch.key] = watch
        return watch

    def loop(  # protocol: watchdog-watch acquire
        self, name: str, deadline: float | None = None
    ) -> "TaskWatch | _NoopWatch":
        if not self.enabled:
            return NOOP_WATCH
        watch = TaskWatch(self, name, kind="loop", deadline=deadline)
        watch.stage("loop")
        with self._lock:
            self._watches[watch.key] = watch
        return watch

    def unregister(self, watch: TaskWatch) -> None:  # protocol: watchdog-watch release bind=watch
        stalled_now = None
        with self._lock:
            self._watches.pop(watch.key, None)
            if watch.stalled:
                watch.stalled = False
                self._stalled_now = max(0, self._stalled_now - 1)
                stalled_now = self._stalled_now
        if stalled_now is not None:
            metrics.GLOBAL.gauge_set("watchdog_stalled_tasks", stalled_now)
        # _seen is deliberately NOT touched here (scan-thread-confined);
        # scan()'s next pass prunes the dead key, and keys are never
        # reused so the entry can't be misattributed in the window

    # -- monitor thread ----------------------------------------------------

    def start(self, poll_interval: float | None = None) -> "Watchdog":
        if not self.enabled:
            return self
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            interval = poll_interval
            if interval is None:
                deadlines = [self.stall_s, self.loop_stall_s]
                deadlines.extend(self.stage_overrides.values())
                floor = min(d for d in deadlines if d > 0)
                interval = min(5.0, max(0.05, floor / 4.0))
            thread = threading.Thread(  # thread-role: watchdog-monitor
                target=self._run, args=(interval,),
                name="watchdog", daemon=True,
            )
            self._thread = thread
        thread.start()
        profiling.ROLES.register_thread(thread, "watchdog-monitor")
        log.with_fields(
            stall_s=self.stall_s, action=self.action
        ).info("stall watchdog running")
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=5.0)

    def reset(self) -> None:
        """Test isolation: forget every watch and episode."""
        self.stop()
        with self._lock:
            self._watches.clear()
            self._stalled_now = 0
        self._seen.clear()
        metrics.GLOBAL.gauge_set("watchdog_stalled_tasks", 0)

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.scan()
            except Exception as exc:
                # the monitor must outlive any single bad scan: it is
                # the thing that notices everything else dying
                log.error("watchdog scan failed", exc=exc)

    # -- the scan (monitor thread, or tests calling directly) --------------

    def scan(self, now: float | None = None) -> list[TaskWatch]:
        """One pass over the registry; returns watches newly flagged
        this pass (tests drive this synchronously)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            watches = list(self._watches.values())
        live_keys = {w.key for w in watches}
        for stale in [k for k in self._seen if k not in live_keys]:
            del self._seen[stale]
        flagged: list[TaskWatch] = []
        for watch in watches:
            active = watch._active()
            key = watch.key
            if active is None:
                # suspended or not yet staged: forget timing so the
                # deadline restarts from resume, and a suspended stall
                # episode ends
                self._seen.pop(key, None)
                self._clear_stall(watch)
                continue
            stage, count = active
            seen = self._seen.get(key)
            if seen is None or seen[0] != stage or seen[1] != count:
                self._seen[key] = (stage, count, now)
                if self._clear_stall(watch):
                    log.with_fields(
                        watch=watch.name, stage=stage
                    ).warning("stalled task resumed forward progress")
                continue
            idle = now - seen[2]
            deadline = self.deadline_for(watch, stage)
            if deadline <= 0 or idle < deadline or watch.stalled:
                continue
            with self._lock:
                if watch.key not in self._watches:
                    # settled and unregistered since the snapshot (a
                    # socket timeout firing right at the deadline is
                    # CORRELATED with the same silence): flagging now
                    # would leak the stalled gauge forever and fire a
                    # capture/cancel for a job that already finished
                    continue
                watch.stalled = True
                watch.stall_count += 1
                self._stalled_now += 1
                stalled_now = self._stalled_now
            flagged.append(watch)
            metrics.GLOBAL.add("watchdog_stalls")
            metrics.GLOBAL.gauge_set("watchdog_stalled_tasks", stalled_now)
            log.with_fields(
                watch=watch.name, kind=watch.kind, stage=stage,
                idle_s=round(idle, 1), deadline_s=deadline,
                action=self.action,
            ).error(
                "no forward progress: task is stalled (not merely slow)"
            )
            self._handle_stall(watch, stage, idle)
        return flagged

    def _clear_stall(self, watch: TaskWatch) -> bool:
        """End ``watch``'s stall episode if one is open; returns whether
        it was. The check-and-clear is atomic under the lock —
        unregister() runs the same sequence from worker threads, and an
        outside-the-lock ``watch.stalled`` read racing it would
        double-decrement the gauge (reading 0 while another task is
        still genuinely stalled)."""
        with self._lock:
            if not watch.stalled:
                return False
            watch.stalled = False
            self._stalled_now = max(0, self._stalled_now - 1)
            stalled_now = self._stalled_now
        metrics.GLOBAL.gauge_set("watchdog_stalled_tasks", stalled_now)
        return True

    def _handle_stall(self, watch: TaskWatch, stage: str, idle: float) -> None:
        # the hook (incident capture) runs on ITS OWN thread: it walks
        # subsystem probes and writes to INCIDENT_DIR, and the thing
        # that wedged the job (a hung filesystem, a stuck lock) can
        # wedge those too — the monitor thread and the cancel action
        # must never be gated on the capture completing, or the
        # component whose job is noticing everything else dying dies
        # with it
        hook = self.on_stall
        if hook is not None:
            threading.Thread(
                target=self._run_stall_hook, args=(hook, watch, stage, idle),
                name="watchdog-capture", daemon=True,
            ).start()
        if self.action == "cancel" and watch.kind == "job":
            if watch.cancel():
                metrics.GLOBAL.add("watchdog_cancels")
                log.with_fields(watch=watch.name, stage=stage).warning(
                    "cancelled stalled job (WATCHDOG_ACTION=cancel)"
                )

    @staticmethod
    def _run_stall_hook(hook, watch: TaskWatch, stage: str, idle: float) -> None:
        try:
            hook(watch, stage, idle)
        except Exception as exc:
            log.error("watchdog stall hook failed", exc=exc)

    # -- views -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Live registry state for /debug/watchdog and incident
        bundles: per watch, the active stage, idle seconds, counters."""
        now = time.monotonic()
        with self._lock:
            watches = list(self._watches.values())
            running = self._thread is not None
        out = []
        for watch in watches:
            active = watch._active()
            seen = self._seen.get(watch.key)
            entry = {
                "name": watch.name,
                "kind": watch.kind,
                "age_s": round(now - watch.started, 3),
                "stage": active[0] if active else None,
                "suspended": active is None,
                "stalled": watch.stalled,
                "stall_count": watch.stall_count,
                "counts": watch.counts(),
            }
            if watch.meta:
                # lane identity (tenant / job class, set by the daemon):
                # a stalled entry names whose traffic is wedged
                entry["meta"] = dict(watch.meta)
            if active and seen and seen[0] == active[0]:
                entry["idle_s"] = round(now - seen[2], 3)
                entry["deadline_s"] = self.deadline_for(watch, active[0])
            out.append(entry)
        return {
            "enabled": self.enabled,
            "running": running,
            "stall_s": self.stall_s,
            "action": self.action,
            "stage_overrides": dict(self.stage_overrides),
            "tasks": out,
        }


# the process-wide monitor, mirroring tracing.TRACER / metrics.GLOBAL:
# registration is always cheap; the scanning thread starts only when
# serve() (or a test) calls MONITOR.start()
MONITOR = Watchdog()

# -- thread-local current watch (mirrors progress.py) ---------------------

_local = threading.local()


def current() -> "TaskWatch | _NoopWatch":
    """The watch installed on this thread, or the shared no-op —
    callers never branch on None."""
    return getattr(_local, "watch", None) or NOOP_WATCH


class install:
    """Context manager installing ``watch`` as this thread's current
    watch for the duration. ``install(None)`` is a no-op so call sites
    don't branch. Jobs don't nest; the inner install wins until exit."""

    __slots__ = ("_watch", "_prev")

    def __init__(self, watch: TaskWatch | None):
        self._watch = watch
        self._prev = None

    def __enter__(self) -> TaskWatch | None:
        if self._watch is not None:
            self._prev = getattr(_local, "watch", None)
            _local.watch = self._watch
        return self._watch

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._watch is not None:
            _local.watch = self._prev
