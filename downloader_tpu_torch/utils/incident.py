"""Incident flight recorder: the probe registry the transfer path feeds.

The port carries the probe half of the JAX package's utils/incident.py.
Subsystems (connection pool shelves, segment fetch progress) register a
bound method that contributes a JSON-able dict of their internals to
every bundle; ``RECORDER._run_probes()`` collects them. Capturing,
persisting and serving bundles come with the daemon's health server.

Probes are held via ``weakref.WeakMethod`` so a registree that forgets
to unregister (short-lived test fixtures) expires with its owner
instead of pinning it; a probe that raises contributes its error
string, never aborts the collection.
"""

from __future__ import annotations

import threading
import weakref


class IncidentRecorder:
    """Process-wide probe registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._probes: dict[str, object] = {}  # name -> WeakMethod | callable; guarded-by: _lock

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


RECORDER = IncidentRecorder()
