"""Incident flight recorder: capture everything a wedged job's
post-mortem needs, at the moment the watchdog notices it.

A stall's evidence is perishable — the blocked thread's stack, the
job's live span tree, what every lock holder was doing — and is gone
the moment the process restarts or the job is cancelled. On trigger
(watchdog stall, or on demand via ``POST /debug/incident``) this
module snapshots a bounded JSON bundle:

- all-thread stack dumps (``sys._current_frames`` + thread names),
- the stalled job's span tree (utils/tracing.py, in-flight or recent),
- lock-acquisition state from the runtime lock-order recorder
  (analysis/runtime.py) when one is installed,
- a metrics snapshot plus counter deltas since the previous capture
  (what moved — and what conspicuously didn't — while it wedged),
- subsystem internals from registered probes (connection pool shelves,
  streaming-pipeline part states, segment fetch progress, queue client
  buffer depth),
- the tail of the in-memory structured-log ring (utils/logging.py),
- the profiling plane's ring tail (utils/profiling.py): top on-CPU
  and off-CPU-wait stacks with per-role shares — where the fleet was
  spending time in the window leading up to the wedge,
- the watchdog's own registry snapshot.

Bundles persist under ``INCIDENT_DIR`` (unset: memory only) with
bounded retention (``INCIDENT_KEEP`` newest kept, both on disk and in
the in-memory ring), listed and served via ``/debug/incidents`` on the
health server.

Probes are held via ``weakref.WeakMethod`` so a registree that forgets
to unregister (short-lived test fixtures) expires with its owner
instead of pinning it; a probe that raises contributes its error
string, never aborts the capture.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
import weakref
from collections import deque

from . import metrics
from .logging import get_logger, ring_tail

log = get_logger("incident")

DEFAULT_KEEP = 16
# auto (watchdog-triggered) captures are rate-limited: a mass stall —
# say the broker died and every in-flight job wedges at publish — must
# not turn the flight recorder into a disk-filling incident storm
DEFAULT_MIN_AUTO_INTERVAL_S = 10.0
# per-thread stack frames kept in a bundle; deep recursion must not
# balloon the bundle past what an operator (or retention) can handle
_MAX_STACK_FRAMES = 60
_MAX_LOG_TAIL = 200


def dir_from_env(environ=None) -> str:
    """``INCIDENT_DIR``: where bundles persist; empty keeps them
    in memory only (still listed/served via /debug/incidents)."""
    env = os.environ if environ is None else environ
    return (env.get("INCIDENT_DIR") or "").strip()


def keep_from_env(environ=None) -> int:
    """``INCIDENT_KEEP``: newest bundles retained (disk and memory)."""
    env = os.environ if environ is None else environ
    raw = (env.get("INCIDENT_KEEP") or "").strip()
    if not raw:
        return DEFAULT_KEEP
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid INCIDENT_KEEP (want an integer)"
        )
        return DEFAULT_KEEP


def _thread_dumps() -> list[dict]:
    threads = {t.ident: t for t in threading.enumerate()}
    dumps = []
    for ident, frame in sys._current_frames().items():
        thread = threads.get(ident)
        stack = traceback.format_stack(frame)[-_MAX_STACK_FRAMES:]
        dumps.append(
            {
                "name": thread.name if thread else f"thread-{ident}",
                "ident": ident,
                "daemon": bool(thread and thread.daemon),
                "stack": "".join(stack),
            }
        )
    dumps.sort(key=lambda d: d["name"])
    return dumps


def _lock_state() -> dict | None:
    """Edges + per-thread held stacks from the runtime lock-order
    recorder, when a test/diagnostic session has one installed."""
    from ..analysis import runtime

    recorder = runtime.current()
    if recorder is None:
        return None
    edges = [
        {"held": held, "acquired": acquired, "count": count}
        for (held, acquired), count in sorted(recorder.edges().items())
    ]
    return {"edges": edges, "held_by_thread": recorder.held_snapshot()}


class IncidentRecorder:
    """Process-wide capture state: probe registry, previous-capture
    metrics baseline, persistence config, bounded bundle ring."""

    def __init__(self, keep: int = DEFAULT_KEEP):
        self._lock = threading.Lock()
        self._dir: str | None = None  # guarded-by: _lock
        self._keep = keep  # guarded-by: _lock
        self._probes: dict[str, object] = {}  # name -> WeakMethod | callable; guarded-by: _lock
        self._bundles: "deque[dict]" = deque(maxlen=keep)  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._last_counters: dict[str, int] | None = None  # guarded-by: _lock
        self._last_auto = 0.0  # guarded-by: _lock
        self.min_auto_interval = DEFAULT_MIN_AUTO_INTERVAL_S

    def configure(self, directory: str | None = None, keep: int | None = None) -> None:
        with self._lock:
            if directory is not None:
                self._dir = directory or None
            if keep is not None:
                self._keep = max(1, keep)
                self._bundles = deque(self._bundles, maxlen=self._keep)

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._dir = None
            self._keep = DEFAULT_KEEP
            self._bundles = deque(maxlen=DEFAULT_KEEP)
            self._seq = 0
            self._last_counters = None
            self._last_auto = 0.0
            self.min_auto_interval = DEFAULT_MIN_AUTO_INTERVAL_S

    # -- probes ------------------------------------------------------------

    def register_probe(self, name: str, method) -> str:
        """Register a bound method contributing a JSON-able dict of
        subsystem internals to every bundle. Held weakly (WeakMethod)
        so the probe dies with its owner; returns the (uniquified)
        registered name for ``unregister_probe``."""
        try:
            ref: object = weakref.WeakMethod(method)
        except TypeError:  # plain function or lambda: hold it directly
            ref = method
        with self._lock:
            # dead registrations release their names NOW, not at the
            # next capture — a long test run churning short-lived
            # owners must not push live probes onto -N suffixes
            for key in [
                key
                for key, existing in self._probes.items()
                if isinstance(existing, weakref.WeakMethod)
                and existing() is None
            ]:
                del self._probes[key]
            unique = name
            n = 2
            while unique in self._probes:
                unique = f"{name}-{n}"
                n += 1
            self._probes[unique] = ref
        return unique

    def unregister_probe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)

    def _run_probes(self) -> dict:
        with self._lock:
            probes = dict(self._probes)
        out: dict[str, object] = {}
        dead: list[str] = []
        for name, ref in probes.items():
            fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if fn is None:
                dead.append(name)
                continue
            try:
                out[name] = fn()
            except Exception as exc:
                # a probe's bug must cost one entry, not the bundle
                out[name] = {"error": f"{type(exc).__name__}: {exc}"}
        if dead:
            with self._lock:
                for name in dead:
                    self._probes.pop(name, None)
        return out

    # -- capture -----------------------------------------------------------

    def capture(
        self,
        reason: str,
        job_id: str | None = None,
        trigger: str = "manual",
        extra: dict | None = None,
    ) -> dict | None:
        """Snapshot one incident bundle. ``trigger='watchdog'``
        captures are rate-limited (``min_auto_interval`` seconds);
        returns None when suppressed, else the bundle dict (already
        persisted and retained)."""
        now = time.time()
        with self._lock:
            # every automatic trigger shares one rate limit: a mass
            # stall (watchdog) or a shed storm (admission) must not
            # turn the flight recorder into its own incident
            auto = trigger != "manual"
            suppressed = (
                auto and now - self._last_auto < self.min_auto_interval
            )
            if not suppressed:
                if auto:
                    self._last_auto = now
                self._seq += 1
                seq = self._seq
                last_counters = self._last_counters
        if suppressed:
            metrics.GLOBAL.add("incident_captures_suppressed")
            return None
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        bundle_id = f"incident-{stamp}-{seq:04d}"

        from . import flows, profiling, tracing, watchdog

        counters = metrics.GLOBAL.snapshot()
        deltas = {
            name: value - (last_counters or {}).get(name, 0)
            for name, value in sorted(counters.items())
            if last_counters is None
            or value != last_counters.get(name, 0)
        }
        histograms = {
            name: {"count": count, "sum": round(total, 6)}
            for name, (_, _, total, count)
            in sorted(metrics.GLOBAL.histograms().items())
        }
        bundle = {
            "id": bundle_id,
            "captured_at": now,
            "captured_at_iso": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)
            ),
            "reason": reason,
            "trigger": trigger,
            "job_id": job_id,
            "threads": _thread_dumps(),
            "trace": tracing.TRACER.find(job_id) if job_id else None,
            "traces_in_flight": len(tracing.TRACER.in_flight()),
            "locks": _lock_state(),
            # where the fleet was SPENDING time while this wedged:
            # top cpu/wait stacks + per-role shares from the profile
            # ring's tail (utils/profiling.py) — stacks say where
            # threads ARE, the profile says where they have BEEN
            "profile": profiling.PROFILER.incident_tail(),
            "watchdog": watchdog.MONITOR.snapshot(),
            # what the worker was FETCHING when this wedged: origin
            # amplification, heavy hitters, and the per-job gating
            # stages (utils/flows.py) — an amplification burn's evidence
            # lands in the bundle without a second capture
            "flows": flows.LEDGER.incident_snapshot(),
            "critpath": flows.critpath_payload(
                tracing.TRACER.recent(), per_job=False
            ),
            "metrics": {
                "counters": dict(sorted(counters.items())),
                "gauges": dict(sorted(metrics.GLOBAL.gauges().items())),
                "histograms": histograms,
            },
            "metrics_delta": deltas,
            "probes": self._run_probes(),
            "log_tail": ring_tail(_MAX_LOG_TAIL),
        }
        if extra:
            bundle["extra"] = extra

        persisted = self._persist(bundle_id, bundle)
        bundle["persisted"] = persisted
        with self._lock:
            self._last_counters = counters
            self._bundles.append(bundle)
        metrics.GLOBAL.add("incident_captures")
        log.with_fields(
            id=bundle_id, reason=reason, trigger=trigger,
            job_id=job_id or "", persisted=persisted or "memory",
        ).warning("incident bundle captured")
        return bundle

    def _persist(self, bundle_id: str, bundle: dict) -> str | None:
        with self._lock:
            directory = self._dir
            keep = self._keep
        if not directory:
            return None
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"{bundle_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as handle:
                json.dump(bundle, handle, indent=1, default=str)
            os.replace(tmp, path)  # readers never see a torn bundle
            self._prune(directory, keep)
            return path
        except OSError as exc:
            log.warning(f"failed to persist incident bundle: {exc}")
            return None

    @staticmethod
    def _prune(directory: str, keep: int) -> None:
        try:
            names = sorted(
                n for n in os.listdir(directory)
                if n.startswith("incident-") and n.endswith(".json")
            )
        except OSError:
            return
        for name in names[:-keep] if len(names) > keep else []:
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass

    # -- views (health server) ----------------------------------------------

    def list_incidents(self) -> list[dict]:
        """Newest-last summaries: memory ring merged with whatever is
        on disk (a restart forgets the ring but not the files)."""
        with self._lock:
            directory = self._dir
            in_memory = list(self._bundles)
        summaries: dict[str, dict] = {}
        if directory:
            try:
                names = sorted(os.listdir(directory))
            except OSError:
                names = []
            for name in names:
                if not (name.startswith("incident-") and name.endswith(".json")):
                    continue
                path = os.path.join(directory, name)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    # pruned by a concurrent capture between listdir
                    # and stat — exactly when /debug/incidents is
                    # being watched; skip, never 500
                    continue
                summaries[name[:-5]] = {
                    "id": name[:-5],
                    "persisted": path,
                    "size_bytes": size,
                }
        for bundle in in_memory:
            summaries[bundle["id"]] = {
                "id": bundle["id"],
                "captured_at": bundle["captured_at"],
                "reason": bundle["reason"],
                "trigger": bundle["trigger"],
                "job_id": bundle.get("job_id"),
                "persisted": bundle.get("persisted"),
            }
        return [summaries[key] for key in sorted(summaries)]

    def get(self, bundle_id: str) -> dict | None:
        with self._lock:
            directory = self._dir
            for bundle in self._bundles:
                if bundle["id"] == bundle_id:
                    return bundle
        if directory and "/" not in bundle_id and ".." not in bundle_id:
            path = os.path.join(directory, f"{bundle_id}.json")
            try:
                with open(path, encoding="utf-8") as handle:
                    return json.load(handle)
            except (OSError, ValueError):
                return None
        return None


def merge_incident_indexes(
    indexes_by_instance: "dict[str, list[dict]]",
) -> list[dict]:
    """One fleet incident index from per-worker ``/debug/incidents``
    listings (plus the supervisor's own under its instance): every
    summary tagged with the worker that owns the bundle, sorted by id
    (ids embed the capture timestamp, so this is capture order).
    Fetch-by-id then routes to the tagged owner."""
    merged: list[dict] = []
    for instance in sorted(indexes_by_instance):
        for summary in indexes_by_instance[instance] or []:
            entry = dict(summary)
            entry["instance"] = instance
            merged.append(entry)
    merged.sort(key=lambda e: (str(e.get("id", "")), e.get("instance", "")))
    return merged


RECORDER = IncidentRecorder()
