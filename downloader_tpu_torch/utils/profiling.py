"""Thread roles and lock-wait profiling: the part the transfer path calls.

The port carries two pieces of the JAX package's utils/profiling.py:

- **Thread roles** (``ROLES``): a runtime registry mapping thread
  idents to the ``# thread-role:`` vocabulary, so a sample or an
  incident names ``job-worker``, not ``Thread-7``. Spawn surfaces
  register their threads right after ``start()``.
- **Lock-wait profiling** (``named_lock``): a lightweight wrapper on
  the hot locks already named by ``# guarded-by:``. Uncontended
  acquires pay one extra try-acquire (plus a 1-in-N sampled zero
  observation so the histogram keeps an honest denominator);
  contended acquires are timed and land in a per-lock
  ``lock_wait_seconds_<name>`` histogram.

``PROFILE=0`` makes ``named_lock`` hand back the bare lock. The
sampling profiler, heap snapshots and flamegraphs come with the
profiling plane.
"""

from __future__ import annotations

import os
import threading
import time

from . import metrics
from .logging import get_logger

log = get_logger("profiling")

DEFAULT_LOCK_SAMPLE = 64  # uncontended zero-wait sampled 1-in-N


def enabled_from_env(environ=None) -> bool:
    """``PROFILE``: the whole profiling plane; ``0``/``off`` disables
    it (``named_lock`` hands back bare locks)."""
    from . import flag_from_env

    return flag_from_env("PROFILE", environ)


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
    enforces (the JAX package's analysis/races.py)."""

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


ROLES = RoleRegistry()


# ---------------------------------------------------------------------------
# lock-wait profiling

# profiling plane on/off, latched from the environment at import —
# named_lock consults it at lock CREATION time, so a disabled plane hands out bare stdlib locks with
# literally zero wrapper cost on the hot path
_ENABLED = enabled_from_env()
_LOCK_SAMPLE = lock_sample_from_env()


class NamedLock:
    """A timing wrapper over a stdlib lock, named after its
    ``# guarded-by:`` identity. Uncontended acquires pay one extra
    try-acquire; contended acquires record their wait into the
    ``lock_wait_seconds_<name>`` histogram."""

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
        start = time.perf_counter()
        acquired = inner.acquire(True, timeout)
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
