"""Stall-watchdog heartbeats, the part the verification path touches.

Pipeline stages bump a per-stage ``Heartbeat`` counter as they make
forward progress; components that fan out to worker threads capture
their heartbeat with ``current().heartbeat(name)`` and beat it from
wherever the work happens. The job watches and the monitor thread that
scans them come with the daemon; until then ``current()`` is the shared
no-op watch, whose heartbeats nobody scans.
"""

from __future__ import annotations


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


class _NoopWatch:
    """Shared do-nothing watch; ``heartbeat()`` returns a real, unscanned
    Heartbeat so hot paths keep the same counter-bump shape."""

    __slots__ = ()
    name = ""
    kind = "noop"

    _SINK = Heartbeat("noop")

    def heartbeat(self, name: str) -> Heartbeat:
        return self._SINK


NOOP_WATCH = _NoopWatch()


def current() -> _NoopWatch:
    """The watch of the running job: the shared no-op until the daemon
    installs job watches."""
    return NOOP_WATCH
