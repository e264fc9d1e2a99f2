"""Stall-watchdog heartbeats and the registry of watched jobs.

Pipeline stages bump a per-stage ``Heartbeat`` counter as they make
forward progress; components that fan out to worker threads capture
their heartbeat on the job thread with ``current().heartbeat(name)`` and
beat it from wherever the work happens. ``MONITOR`` registers job
watches and reports their counters; ``install`` makes a watch the
thread's current one, and outside an installed watch ``current()`` is
the shared no-op watch, whose heartbeats nobody reads.

The port carries this part of the JAX package's utils/watchdog.py. The
scanning thread that flags a stalled stage, its WATCHDOG_* environment
readers, stall actions and loop watches come with the daemon.
"""

from __future__ import annotations

import itertools
import threading
import time


class Heartbeat:
    """One stage's forward-progress counter. ``beat`` is a plain int
    add, safe to call from any thread (only change matters, not an
    exact total)."""

    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def beat(self, n: int = 1) -> None:
        self.count += n


# process-unique watch identities: id(watch) could be recycled onto the
# next registration once a watch is freed
_WATCH_KEYS = itertools.count(1)


class TaskWatch:
    """One watched job moving through pipeline stages. Entering a stage
    counts as progress on it."""

    __slots__ = ("name", "key", "started", "_lock", "_stages", "_stage")

    def __init__(self, name: str):
        self.name = name
        self.key = next(_WATCH_KEYS)
        self.started = time.monotonic()
        self._lock = threading.Lock()
        self._stages: dict[str, Heartbeat] = {}  # guarded-by: _lock
        self._stage: str | None = None  # guarded-by: _lock

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
        """Enter stage ``name``; entry itself counts as progress."""
        hb = self.heartbeat(name)
        with self._lock:
            self._stage = name
        hb.beat()
        return hb

    def active_stage(self) -> str | None:
        with self._lock:
            return self._stage

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {name: hb.count for name, hb in self._stages.items()}


class _NoopWatch:
    """Shared do-nothing watch; ``heartbeat()`` returns a real, unscanned
    Heartbeat so hot paths keep the same counter-bump shape."""

    __slots__ = ()
    name = ""
    kind = "noop"

    _SINK = Heartbeat("noop")

    def heartbeat(self, name: str) -> Heartbeat:
        return self._SINK

    def stage(self, name: str) -> Heartbeat:
        return self._SINK


NOOP_WATCH = _NoopWatch()


class Watchdog:
    """The registry of job watches. Registering and unregistering are
    cheap for the watched code; ``snapshot`` reports each watch's active
    stage and counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._watches: dict[int, TaskWatch] = {}  # keyed by watch.key; guarded-by: _lock

    def job(self, name: str) -> TaskWatch:
        watch = TaskWatch(name)
        with self._lock:
            self._watches[watch.key] = watch
        return watch

    def unregister(self, watch: TaskWatch) -> None:
        with self._lock:
            self._watches.pop(watch.key, None)

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            watches = list(self._watches.values())
        return {
            "tasks": [
                {
                    "name": watch.name,
                    "age_s": round(now - watch.started, 3),
                    "stage": watch.active_stage(),
                    "counts": watch.counts(),
                }
                for watch in watches
            ]
        }


# the process-wide registry, mirroring tracing.TRACER / metrics.GLOBAL
MONITOR = Watchdog()

# -- thread-local current watch (mirrors progress.py) ---------------------

_local = threading.local()


def current() -> TaskWatch | _NoopWatch:
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
