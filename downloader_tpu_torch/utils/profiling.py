"""Continuous profiling plane: who is burning CPU, who is parked, on
what, holding which lock — answerable from a running daemon.

The telemetry stack up to here (tracing, watchdog, TSDB, alerts) says
WHAT moved and what stopped; none of it can say where the fleet's
threads actually spend their time. That is the one question both the
reactor refactor (thread count as the ceiling) and the accelerator
feed path (host packing and copies against hashlib) need answered with
samples, not adjectives.
Four cooperating pieces, all bounded, all off the job path:

- **Thread roles** (``ROLES``): a runtime registry mapping thread
  idents to the ``# thread-role:`` vocabulary the static race rule
  already names (analysis/races.py). Every spawn surface registers its
  thread at spawn, so a sample is attributed to ``job-worker`` or
  ``queue-publisher``, not ``Thread-7``.
- **The sampling profiler** (``PROFILER``): one thread walks
  ``sys._current_frames()`` every ``PROFILE_INTERVAL_MS``, collapses
  each stack to a ``module:function;...`` string, classifies the leaf
  as on-CPU or off-CPU-waiting (lock acquire / socket I/O / queue
  park — C-level blocking shows only its Python caller, so lock waits
  are named by the ``named_lock`` wrapper below, and the rest by a
  leaf-frame table), and appends to a bounded ring. Fixed overhead:
  cost scales with thread count and tick rate, never with job rate.
- **Lock-wait profiling** (``named_lock``): a lightweight wrapper on
  the hot locks already named by ``# guarded-by:``. Uncontended
  acquires pay one extra try-acquire (plus a 1-in-N sampled zero
  observation so the histogram keeps an honest denominator);
  contended acquires are timed and land in a per-lock
  ``lock_wait_seconds_<name>`` histogram on ``/metrics``, and the
  sampler names the lock a blocked thread is waiting on.
- **Heap snapshots**: a second thread takes periodic ``tracemalloc``
  snapshots and keeps top-N allocation-site deltas. Off by default
  (``PROFILE_HEAP_S=0``) because tracemalloc taxes every allocation —
  the sampling profiler's fixed-overhead contract must not silently
  inherit that.

Served at ``GET /debug/profile`` (``?mode=cpu|wait|heap``, ``?role=``,
``?window=``, ``?format=collapsed|svg|json``) as collapsed-stack text
or a self-contained SVG flamegraph; incident bundles embed the ring
tail so a wedged job's bundle shows where the fleet was spending time.
``PROFILE=0`` disables the whole plane via no-op stubs (``named_lock``
hands back the bare lock; ``start()`` refuses).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque

from . import metrics
from .logging import get_logger

log = get_logger("profiling")

DEFAULT_INTERVAL_MS = 50.0  # 20 Hz: ~1% of one core at ~15 threads
DEFAULT_RING = 16384  # samples kept (~14 min at 20 Hz x 1 busy thread)
DEFAULT_HEAP_S = 0.0  # heap snapshots are opt-in (tracemalloc tax)
DEFAULT_HEAP_TOP = 20
DEFAULT_HEAP_FRAMES = 5
DEFAULT_LOCK_SAMPLE = 64  # uncontended zero-wait sampled 1-in-N
_MAX_FRAMES = 64  # per collapsed stack
_HEAP_REPORTS = 4  # snapshot delta reports retained


def enabled_from_env(environ=None) -> bool:
    """``PROFILE``: the whole profiling plane; ``0``/``off`` disables
    via no-op stubs (bare locks, refused starts)."""
    from . import flag_from_env

    return flag_from_env("PROFILE", environ)


def interval_from_env(environ=None) -> float:
    """``PROFILE_INTERVAL_MS``: milliseconds between stack-sampling
    ticks; floored at 1 ms."""
    env = os.environ if environ is None else environ
    raw = (env.get("PROFILE_INTERVAL_MS") or "").strip()
    if not raw:
        return DEFAULT_INTERVAL_MS
    try:
        return max(1.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid PROFILE_INTERVAL_MS (want milliseconds)"
        )
        return DEFAULT_INTERVAL_MS


def ring_from_env(environ=None) -> int:
    """``PROFILE_RING``: samples kept in the collapsed-stack ring."""
    env = os.environ if environ is None else environ
    raw = (env.get("PROFILE_RING") or "").strip()
    if not raw:
        return DEFAULT_RING
    try:
        return max(64, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid PROFILE_RING (want an integer)"
        )
        return DEFAULT_RING


def heap_interval_from_env(environ=None) -> float:
    """``PROFILE_HEAP_S``: seconds between tracemalloc heap snapshots;
    ``0``/``off`` (the default) keeps tracemalloc entirely off."""
    env = os.environ if environ is None else environ
    raw = (env.get("PROFILE_HEAP_S") or "").strip().lower()
    if not raw:
        return DEFAULT_HEAP_S
    if raw in ("off", "false", "no", "disabled"):
        return 0.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid PROFILE_HEAP_S (want seconds or 'off')"
        )
        return DEFAULT_HEAP_S


def heap_top_from_env(environ=None) -> int:
    """``PROFILE_HEAP_TOP``: allocation sites kept per heap report."""
    env = os.environ if environ is None else environ
    raw = (env.get("PROFILE_HEAP_TOP") or "").strip()
    if not raw:
        return DEFAULT_HEAP_TOP
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid PROFILE_HEAP_TOP (want an integer)"
        )
        return DEFAULT_HEAP_TOP


def heap_frames_from_env(environ=None) -> int:
    """``PROFILE_HEAP_FRAMES``: traceback depth tracemalloc records
    per allocation (deeper = better flamegraphs, more overhead)."""
    env = os.environ if environ is None else environ
    raw = (env.get("PROFILE_HEAP_FRAMES") or "").strip()
    if not raw:
        return DEFAULT_HEAP_FRAMES
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid PROFILE_HEAP_FRAMES (want an integer)"
        )
        return DEFAULT_HEAP_FRAMES


def lock_sample_from_env(environ=None) -> int:
    """``PROFILE_LOCK_SAMPLE``: one uncontended acquire in N records a
    zero-wait observation (the histogram's denominator); contended
    acquires are always timed."""
    env = os.environ if environ is None else environ
    raw = (env.get("PROFILE_LOCK_SAMPLE") or "").strip()
    if not raw:
        return DEFAULT_LOCK_SAMPLE
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid PROFILE_LOCK_SAMPLE (want an integer)"
        )
        return DEFAULT_LOCK_SAMPLE


# ---------------------------------------------------------------------------
# thread roles


class RoleRegistry:
    """Thread ident -> role name, seeded at every spawn surface.

    The vocabulary is the ``# thread-role:`` one the static race rule
    enforces (analysis/races.py) — the sampler attributes stacks to
    the same names the analyzer reasons about, so "which role burns
    CPU" and "which roles race on this field" share a language."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._roles: dict[int, str] = {}  # ident -> role; guarded-by: _lock

    def register_thread(self, thread: threading.Thread, role: str) -> None:
        """Map a started thread (``ident`` is set) to ``role``; call
        right after ``thread.start()`` at the spawn surface."""
        ident = thread.ident
        if ident is None:
            return
        with self._lock:
            self._roles[ident] = role

    def register_current(self, role: str) -> None:
        """Map the calling thread to ``role`` — the registration shape
        for pool workers and request handlers, who register themselves
        on first task (idempotent; one uncontended lock acquire)."""
        ident = threading.get_ident()
        with self._lock:
            self._roles[ident] = role

    def role_of(self, ident: int) -> str | None:
        with self._lock:
            return self._roles.get(ident)

    def prune(self, live: "set[int]") -> None:
        """Forget idents no longer alive — the OS recycles them onto
        future threads, which must not inherit a dead thread's role.
        Called by the sampler with the union of current-frame idents
        and ``threading.enumerate()`` (a just-started thread may not
        have a frame yet)."""
        with self._lock:
            for ident in [i for i in self._roles if i not in live]:
                del self._roles[ident]

    def snapshot(self) -> dict[int, str]:
        with self._lock:
            return dict(self._roles)

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._roles.clear()


ROLES = RoleRegistry()


# ---------------------------------------------------------------------------
# lock-wait profiling

# ident -> lock name while blocked in a contended NamedLock acquire.
# Written only by the waiting thread itself (set before the blocking
# acquire, popped after), read by the sampler; per-key dict ops are
# GIL-atomic, and a torn read costs one mislabelled sample.
_WAITING: dict[int, str] = {}

# profiling plane on/off, latched from the environment at import and
# overridable via configure() — named_lock consults it at lock
# CREATION time, so a disabled plane hands out bare stdlib locks with
# literally zero wrapper cost on the hot path
_ENABLED = enabled_from_env()
_LOCK_SAMPLE = lock_sample_from_env()


def plane_enabled() -> bool:
    return _ENABLED


class NamedLock:
    """A timing wrapper over a stdlib lock, named after its
    ``# guarded-by:`` identity. Uncontended acquires pay one extra
    try-acquire; contended acquires record their wait into the
    ``lock_wait_seconds_<name>`` histogram and publish the name in
    ``_WAITING`` so a sampled blocked thread says WHICH lock it is
    parked on, not just "a lock"."""

    __slots__ = ("name", "_inner", "_metric", "_ticks")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner
        self._metric = f"lock_wait_seconds_{name}"
        self._ticks = 0  # shared-by-design: plain int sample trigger; a torn increment costs one zero-wait observation

    def acquire(self, blocking: bool = True, timeout: float = -1):
        inner = self._inner
        if inner.acquire(False):
            self._ticks += 1
            if self._ticks % _LOCK_SAMPLE == 0:
                metrics.GLOBAL.observe(
                    self._metric, 0.0, buckets=metrics.LOCK_WAIT_BUCKETS
                )
            return True
        if not blocking:
            return False
        ident = threading.get_ident()
        _WAITING[ident] = self.name
        start = time.perf_counter()
        try:
            acquired = inner.acquire(True, timeout)
        finally:
            _WAITING.pop(ident, None)
        if acquired:
            metrics.GLOBAL.observe(
                self._metric,
                time.perf_counter() - start,
                buckets=metrics.LOCK_WAIT_BUCKETS,
            )
        return acquired

    def release(self) -> None:
        self._inner.release()

    def locked(self) -> bool:
        # RLock has no locked() before Python 3.14; probe like the
        # runtime recorder's wrapper does. The try-acquire fallback
        # reads an RLock HELD BY THIS THREAD as unlocked (reentrant
        # acquire succeeds) — the same semantics the stdlib fallback
        # pattern has always had
        probe = getattr(self._inner, "locked", None)
        if probe is not None:
            return probe()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self) -> "NamedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._inner.release()

    def __repr__(self) -> str:
        return f"<NamedLock {self.name} {self._inner!r}>"


def named_lock(name: str, inner=None):
    """Wrap ``inner`` (default: a fresh ``threading.Lock``) in wait
    timing under ``name``. With the plane disabled (``PROFILE=0``)
    this returns the bare lock — the no-op stub contract: ablated
    runs pay nothing, not even a delegation call.

    Callers pass the lock they construct (``named_lock("connpool",
    threading.Lock())``) so the runtime lock-order recorder keys it by
    the REAL creation site, not a shared line in this module."""
    if inner is None:
        inner = threading.Lock()
    if not _ENABLED:
        return inner
    return NamedLock(name, inner)


def waiting_on(ident: int) -> str | None:
    """The named lock ``ident`` is currently blocked on, if any."""
    return _WAITING.get(ident)


# ---------------------------------------------------------------------------
# frame classification

# leaf (module, function) pairs that mean "this thread is parked in a
# C-level blocking call whose Python wrapper is the visible leaf".
# C builtins (lock.acquire, sock.recv, time.sleep) leave only their
# CALLER visible, which is why lock waits are named via _WAITING and
# everything else best-effort by this table.
_WAIT_LEAVES = {
    ("threading", "wait"): "park",
    ("threading", "_wait_for_tstate_lock"): "park",  # Thread.join
    ("selectors", "select"): "io",
    ("selectors", "_select"): "io",
    ("socket", "accept"): "io",
    ("socket", "readinto"): "io",  # SocketIO: makefile() readers
    ("socket", "write"): "io",
    ("socket", "sendall"): "io",
    ("ssl", "read"): "io",
    ("ssl", "write"): "io",
    ("ssl", "recv"): "io",
    ("ssl", "recv_into"): "io",
    ("ssl", "send"): "io",
    ("ssl", "sendall"): "io",
    ("socketserver", "serve_forever"): "io",
}

# a park whose CALLER is one of these refines to a more useful kind
_PARK_PARENTS = {
    "queue": "queue",
    "concurrent.futures.thread": "queue",
}


def _frame_name(frame) -> str:
    module = frame.f_globals.get("__name__", "?")
    return f"{module}:{frame.f_code.co_name}"


def _classify(ident: int, frame) -> tuple[str, str]:
    """(mode, wait_kind) for a thread's leaf frame: mode ``cpu`` or
    ``wait``; wait kinds are ``lock:<name>`` (from the named-lock
    wrapper), ``io``, ``queue``, ``park``."""
    lock_name = _WAITING.get(ident)
    if lock_name is not None:
        return "wait", f"lock:{lock_name}"
    module = frame.f_globals.get("__name__", "?")
    kind = _WAIT_LEAVES.get((module, frame.f_code.co_name))
    if kind is None:
        return "cpu", ""
    if kind == "park" and frame.f_back is not None:
        parent = frame.f_back.f_globals.get("__name__", "?")
        kind = _PARK_PARENTS.get(parent, kind)
    return "wait", kind


def _collapse(frame) -> str:
    """Root→leaf ``module:function`` frames joined with ``;`` —
    the folded-stack format flamegraph tooling shares."""
    names: list[str] = []
    while frame is not None and len(names) < _MAX_FRAMES:
        names.append(_frame_name(frame))
        frame = frame.f_back
    names.reverse()
    return ";".join(names)


# ---------------------------------------------------------------------------
# the sampling profiler


class SamplingProfiler:
    """The sampler thread plus its bounded ring of collapsed stacks,
    and (opt-in) the heap-snapshot thread. Mirrors tsdb.STORE's
    lifecycle: configure() then start() from serve(), reset() from
    tests; nothing runs until started."""

    def __init__(
        self,
        interval_ms: float = DEFAULT_INTERVAL_MS,
        ring: int = DEFAULT_RING,
        heap_interval_s: float = DEFAULT_HEAP_S,
        heap_top: int = DEFAULT_HEAP_TOP,
        heap_frames: int = DEFAULT_HEAP_FRAMES,
    ):
        self.interval_ms = interval_ms
        self.heap_interval_s = heap_interval_s
        self.heap_top = heap_top
        self.heap_frames = heap_frames
        self._lock = threading.Lock()
        # ring entries: (ts, role|None, mode, wait_kind, stack)
        self._ring: deque = deque(maxlen=ring)  # guarded-by: _lock
        self._ticks = 0  # guarded-by: _lock
        self._heap_reports: deque = deque(maxlen=_HEAP_REPORTS)  # guarded-by: _lock
        self._heap_started_tracing = False  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._heap_thread: threading.Thread | None = None  # guarded-by: _lock

    # -- lifecycle ---------------------------------------------------------

    def configure(
        self,
        interval_ms: float | None = None,
        ring: int | None = None,
        heap_interval_s: float | None = None,
        heap_top: int | None = None,
        heap_frames: int | None = None,
        enabled: bool | None = None,
    ) -> None:
        global _ENABLED
        if enabled is not None:
            _ENABLED = enabled
        if interval_ms is not None:
            self.interval_ms = max(1.0, interval_ms)
        if heap_interval_s is not None:
            self.heap_interval_s = max(0.0, heap_interval_s)
        if heap_top is not None:
            self.heap_top = max(1, heap_top)
        if heap_frames is not None:
            self.heap_frames = max(1, heap_frames)
        if ring is not None:
            with self._lock:
                if self._ring.maxlen != ring:
                    self._ring = deque(self._ring, maxlen=max(64, ring))

    @property
    def enabled(self) -> bool:
        return _ENABLED

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    def start(self) -> "SamplingProfiler":
        if not _ENABLED:
            return self
        with self._lock:
            ring = self._ring.maxlen
            if self._thread is None:
                self._stop.clear()
                thread = threading.Thread(  # thread-role: profile-sampler
                    target=self._run, name="profile-sample", daemon=True
                )
                self._thread = thread
            else:
                thread = None
            heap_thread = None
            if self.heap_interval_s > 0 and self._heap_thread is None:
                heap_thread = threading.Thread(  # thread-role: heap-snapshotter
                    target=self._heap_run, name="profile-heap", daemon=True
                )
                self._heap_thread = heap_thread
        if thread is not None:
            thread.start()
            ROLES.register_thread(thread, "profile-sampler")
            log.with_fields(
                interval_ms=self.interval_ms, ring=ring
            ).info("sampling profiler running")
        if heap_thread is not None:
            heap_thread.start()
            ROLES.register_thread(heap_thread, "heap-snapshotter")
            log.with_fields(
                interval_s=self.heap_interval_s, top=self.heap_top
            ).info("heap snapshot thread running")
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
            heap_thread, self._heap_thread = self._heap_thread, None
            started_tracing = self._heap_started_tracing
            self._heap_started_tracing = False
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        if heap_thread is not None:
            heap_thread.join(timeout=5.0)
        if started_tracing:
            import tracemalloc

            tracemalloc.stop()

    def reset(self) -> None:
        """Test isolation: stop threads, forget samples and reports."""
        self.stop()
        with self._lock:
            self._ring.clear()
            self._ticks = 0
            self._heap_reports.clear()

    # -- sampling ----------------------------------------------------------

    def sample(self, now: float | None = None) -> int:
        """One walk over every thread's current frame into the ring;
        returns the number of samples taken. The sampler thread's own
        frame is skipped — in an idle fleet the profiler must not
        read as the top CPU consumer of its own profile."""
        ts = time.time() if now is None else now
        own = threading.get_ident()
        roles = ROLES.snapshot()  # one registry hold per tick
        frames = sys._current_frames()
        try:
            batch = []
            for ident, frame in frames.items():
                if ident == own:
                    continue
                mode, kind = _classify(ident, frame)
                stack = _collapse(frame)
                if mode == "wait":
                    stack = f"{stack};wait:{kind}"
                batch.append(
                    (ts, roles.get(ident), mode, kind,
                     sys.intern(stack))
                )
        finally:
            del frames  # frames pin every thread's locals; drop now
        with self._lock:
            self._ring.extend(batch)
            self._ticks += 1
            ticks = self._ticks
        metrics.GLOBAL.add("profile_samples", len(batch))
        metrics.GLOBAL.gauge_set("profile_threads", len(batch))
        if ticks % 128 == 0:
            live = set(sys._current_frames().keys())
            live.update(
                t.ident for t in threading.enumerate()
                if t.ident is not None
            )
            ROLES.prune(live)
        return len(batch)

    def _run(self) -> None:
        from . import watchdog

        # liveness-watched like the tsdb scraper: the instrument that
        # explains every other stall must not die silently itself
        watch = watchdog.MONITOR.loop("profile-sample")
        try:
            while True:
                watch.beat()
                try:
                    self.sample()
                    metrics.GLOBAL.add("profile_ticks")
                except Exception as exc:
                    # one bad walk must not end the profile history
                    log.error("profile sample failed", exc=exc)
                if self._stop.wait(self.interval_ms / 1000.0):
                    return
        finally:
            watchdog.MONITOR.unregister(watch)

    # -- heap snapshots ----------------------------------------------------

    def _heap_run(self) -> None:
        import tracemalloc

        from . import watchdog

        # the loop beats once per snapshot interval, so its stall
        # deadline must scale with the interval — at PROFILE_HEAP_S
        # above the 60 s loop default every healthy cycle would
        # otherwise read as a stall and fire spurious captures
        watch = watchdog.MONITOR.loop(
            "profile-heap",
            deadline=max(
                watchdog.DEFAULT_LOOP_STALL_S,
                self.heap_interval_s * 3,
            ),
        )
        try:
            if not tracemalloc.is_tracing():
                tracemalloc.start(self.heap_frames)
                with self._lock:
                    self._heap_started_tracing = True
            previous = None
            while True:
                watch.beat()
                # floored only far enough to never busy-spin; the
                # configured sub-second cadences tests use are honored
                if self._stop.wait(max(0.05, self.heap_interval_s)):
                    return
                try:
                    previous = self._heap_snapshot(previous)
                    metrics.GLOBAL.add("profile_heap_snapshots")
                except Exception as exc:
                    log.error("heap snapshot failed", exc=exc)
        finally:
            watchdog.MONITOR.unregister(watch)

    def _heap_snapshot(self, previous):
        import tracemalloc

        snapshot = tracemalloc.take_snapshot().filter_traces(
            (
                tracemalloc.Filter(False, tracemalloc.__file__),
                tracemalloc.Filter(False, __file__),
            )
        )
        stats = snapshot.statistics("traceback")
        deltas: dict[str, int] = {}
        if previous is not None:
            for diff in snapshot.compare_to(previous, "traceback"):
                if diff.size_diff:
                    deltas[self._heap_site(diff.traceback)] = (
                        diff.size_diff
                    )
        top = []
        for stat in stats[: self.heap_top]:
            site = self._heap_site(stat.traceback)
            top.append(
                {
                    "site": site,
                    "stack": self._heap_stack(stat.traceback),
                    "size_kb": round(stat.size / 1024.0, 1),
                    "count": stat.count,
                    "delta_kb": round(deltas.get(site, 0) / 1024.0, 1),
                }
            )
        report = {
            "ts": time.time(),
            "total_kb": round(
                sum(s.size for s in stats) / 1024.0, 1
            ),
            "sites": len(stats),
            "top": top,
        }
        with self._lock:
            self._heap_reports.append(report)
        return snapshot

    @staticmethod
    def _heap_site(traceback) -> str:
        frame = traceback[-1]  # most recent call
        return f"{os.path.basename(frame.filename)}:{frame.lineno}"

    @staticmethod
    def _heap_stack(traceback) -> str:
        # tracemalloc stores most-recent-first; collapsed stacks read
        # root→leaf like the sampler's
        names = [
            f"{os.path.basename(frame.filename)}:{frame.lineno}"
            for frame in reversed(list(traceback))
        ]
        return ";".join(names)

    # -- queries -----------------------------------------------------------

    def collapsed(
        self,
        mode: str = "cpu",
        role: str | None = None,
        window_s: float | None = None,
        now: float | None = None,
    ) -> dict[str, int]:
        """Aggregate in-window samples to ``{collapsed stack: count}``
        — the folded format flamegraph tooling eats. ``mode='heap'``
        returns allocation stacks weighted in KB instead of sample
        counts (role/window do not apply: a snapshot is whole-process
        at an instant)."""
        if mode == "heap":
            report = self.heap_report()
            if report is None:
                return {}
            return {
                entry["stack"]: max(1, int(entry["size_kb"]))
                for entry in report["top"]
                if entry["stack"]
            }
        now = time.time() if now is None else now
        cut = None if window_s is None else now - window_s
        with self._lock:
            entries = list(self._ring)
        out: dict[str, int] = {}
        for ts, sample_role, sample_mode, _, stack in entries:
            if sample_mode != mode:
                continue
            if cut is not None and ts < cut:
                continue
            if role is not None and sample_role != role:
                continue
            out[stack] = out.get(stack, 0) + 1
        return out

    def attribution(
        self, window_s: float | None = None, now: float | None = None
    ) -> dict:
        """How well samples map onto named thread roles — the number
        the 1000-small-job acceptance run reads (≥90% attributed)."""
        now = time.time() if now is None else now
        cut = None if window_s is None else now - window_s
        with self._lock:
            entries = list(self._ring)
        total = 0
        attributed = 0
        by_role: dict[str, dict[str, int]] = {}
        for ts, role, mode, _, _ in entries:
            if cut is not None and ts < cut:
                continue
            total += 1
            name = role or "unattributed"
            if role is not None:
                attributed += 1
            slot = by_role.setdefault(name, {"cpu": 0, "wait": 0})
            slot[mode] = slot.get(mode, 0) + 1
        return {
            "samples": total,
            "attributed": attributed,
            "attributed_pct": (
                round(100.0 * attributed / total, 1) if total else None
            ),
            "by_role": {
                name: by_role[name] for name in sorted(by_role)
            },
        }

    def snapshot(self) -> dict:
        """Plane-level state for /debug/profile without a mode."""
        with self._lock:
            samples = len(self._ring)
            ring = self._ring.maxlen
            ticks = self._ticks
            running = self._thread is not None
            heap_running = self._heap_thread is not None
            heap_reports = len(self._heap_reports)
        return {
            "enabled": _ENABLED,
            "running": running,
            "interval_ms": self.interval_ms,
            "ring": ring,
            "ring_samples": samples,
            "ticks": ticks,
            "heap": {
                "running": heap_running,
                "interval_s": self.heap_interval_s,
                "reports": heap_reports,
            },
            "roles": sorted(set(ROLES.snapshot().values())),
        }

    def heap_report(self) -> dict | None:
        with self._lock:
            return self._heap_reports[-1] if self._heap_reports else None

    def incident_tail(
        self, window_s: float = 60.0, top: int = 15
    ) -> dict:
        """The bounded profile view incident bundles embed: where the
        fleet spent the last ``window_s`` — top CPU stacks, top wait
        stacks (lock names included), per-role sample shares."""
        out: dict = {
            "enabled": _ENABLED,
            "window_s": window_s,
            "attribution": self.attribution(window_s=window_s),
        }
        for mode in ("cpu", "wait"):
            stacks = self.collapsed(mode=mode, window_s=window_s)
            out[f"{mode}_top"] = [
                {"stack": stack, "samples": count}
                for stack, count in sorted(
                    stacks.items(), key=lambda kv: -kv[1]
                )[:top]
            ]
        heap = self.heap_report()
        if heap is not None:
            out["heap_top"] = heap["top"][:top]
        return out


PROFILER = SamplingProfiler()


def merge_folded(
    stacks_by_instance: "dict[str, dict[str, int]]",
) -> dict[str, int]:
    """Sum per-worker folded-stack aggregates into one fleet profile:
    identical collapsed stacks add their weights, so the merged total
    equals the sum of every worker's total (the fleet /debug/profile
    fold — per-instance attribution rides beside it in the JSON view,
    this is just the flamegraph's shared denominator)."""
    merged: dict[str, int] = {}
    for stacks in stacks_by_instance.values():
        for stack, weight in (stacks or {}).items():
            merged[stack] = merged.get(stack, 0) + int(weight)
    return merged


def configure(**kwargs) -> None:
    """Module-level convenience mirroring tsdb/alerts: serve() and
    tests configure the process-wide profiler (and the plane's
    enabled flag) in one call."""
    PROFILER.configure(**kwargs)


# ---------------------------------------------------------------------------
# flamegraph rendering

_SVG_ROW_H = 17
_SVG_WIDTH = 1200
_SVG_FONT = 11
# warm flamegraph palette, deterministic per frame name
_SVG_COLORS = (
    "#e4573d", "#e8743b", "#ec8f32", "#f0a830", "#d9622b",
    "#e2553a", "#ef9a3c", "#e5682f", "#dd7a35", "#f2b13a",
)


def _svg_escape(text: str) -> str:
    return (
        text.replace("&", "&amp;").replace("<", "&lt;")
        .replace(">", "&gt;").replace('"', "&quot;")
    )


def flamegraph_svg(
    stacks: "dict[str, int]", title: str = "profile"
) -> str:
    """A self-contained SVG flamegraph (no scripts, no external
    assets) from ``{collapsed stack: weight}``. Frames below ~0.1%
    of the root are elided; hover tooltips ride ``<title>``."""
    root: dict = {"w": 0, "children": {}}
    for stack, weight in stacks.items():
        if weight <= 0:
            continue
        root["w"] += weight
        node = root
        for frame in stack.split(";"):
            child = node["children"].get(frame)
            if child is None:
                child = node["children"][frame] = {
                    "w": 0, "children": {}
                }
            child["w"] += weight
            node = child
    total = root["w"]
    rects: list[str] = []
    max_depth = 0
    min_w = max(total * 0.001, 1e-9)

    def layout(node: dict, x: float, depth: int) -> None:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        offset = x
        for name in sorted(node["children"]):
            child = node["children"][name]
            if child["w"] < min_w:
                continue
            width = child["w"] * (_SVG_WIDTH - 2) / total
            if width >= 0.5:
                color = _SVG_COLORS[hash(name) % len(_SVG_COLORS)]
                y = 30 + depth * _SVG_ROW_H
                pct = 100.0 * child["w"] / total
                label = _svg_escape(name)
                rects.append(
                    f'<g><title>{label} — {child["w"]} '
                    f"({pct:.1f}%)</title>"
                    f'<rect x="{offset + 1:.1f}" y="{y}" '
                    f'width="{width:.2f}" height="{_SVG_ROW_H - 1}" '
                    f'fill="{color}" rx="1"/>'
                )
                if width > 40:
                    shown = name.rsplit(":", 1)[-1]
                    keep = max(1, int(width / (_SVG_FONT * 0.62)))
                    shown = _svg_escape(shown[:keep])
                    rects.append(
                        f'<text x="{offset + 4:.1f}" '
                        f'y="{y + _SVG_ROW_H - 5}" '
                        f'font-size="{_SVG_FONT}" fill="#fff" '
                        f'font-family="monospace">{shown}</text>'
                    )
                rects.append("</g>")
                layout(child, offset, depth + 1)
            offset += width

    if total:
        layout(root, 1.0, 0)
    height = 40 + (max_depth + 1) * _SVG_ROW_H
    head = (
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'width="{_SVG_WIDTH}" height="{height}" '
        f'viewBox="0 0 {_SVG_WIDTH} {height}">'
        f'<rect width="100%" height="100%" fill="#fdf6ee"/>'
        f'<text x="8" y="20" font-size="14" '
        f'font-family="monospace" fill="#333">'
        f"{_svg_escape(title)} — {total} samples</text>"
    )
    if not total:
        head += (
            '<text x="8" y="40" font-size="12" '
            'font-family="monospace" fill="#666">'
            "no samples in window</text>"
        )
    return head + "".join(rects) + "</svg>"
