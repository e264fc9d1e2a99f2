"""Per-job transfer-progress plumbing: how fetch backends advertise
completed byte ranges of each target file while the fetch is still
running.

The streaming upload pipeline consumes these reports to start shipping
parts before the fetch finishes. Backends report into whatever sink is
installed for the job, or a shared no-op when none is, and never import
the store layer. The daemon installs the job's sink on the job thread;
components that fan out to worker threads (the torrent PieceStore)
capture the sink at construction and report from wherever their writes
happen, so sinks must be thread-safe.

Report semantics:

- ``begin_file(path, total, read_path=None)`` — a fetch is about to
  populate ``path`` with exactly ``total`` bytes; ``read_path`` is where
  the bytes can be read back mid-transfer when that differs.
- ``advance(path, offset)`` — bytes ``[0, offset)`` are durably written.
- ``add_span(path, start, end)`` — bytes ``[start, end)`` are durably
  written (out-of-order writers such as SHA-1-verified torrent pieces).
- ``finish_file(path)`` — the file is complete at its final path.
- ``invalidate(path)`` — previously reported bytes are no longer
  trustworthy.
"""

from __future__ import annotations

import threading
from typing import Protocol


class TransferSink(Protocol):
    """What a per-job progress consumer implements (see module doc)."""

    def begin_file(
        self, path: str, total: int, read_path: str | None = None
    ) -> None: ...

    def advance(self, path: str, offset: int) -> None: ...

    def add_span(self, path: str, start: int, end: int) -> None: ...

    def finish_file(self, path: str) -> None: ...

    def invalidate(self, path: str) -> None: ...


class _NoopSink:
    """Shared do-nothing sink: what reporting code gets outside an
    installed job. Stateless — one instance serves every thread."""

    __slots__ = ()

    def begin_file(self, path, total, read_path=None) -> None:
        pass

    def advance(self, path, offset) -> None:
        pass

    def add_span(self, path, start, end) -> None:
        pass

    def finish_file(self, path) -> None:
        pass

    def invalidate(self, path) -> None:
        pass


NOOP = _NoopSink()

_local = threading.local()


def current() -> TransferSink:
    """The sink installed on this thread, or the shared no-op."""
    return getattr(_local, "sink", None) or NOOP


class install:
    """Context manager installing ``sink`` as this thread's transfer
    sink for the duration. ``install(None)`` is a no-op so call sites
    don't branch. Not reentrant per thread — the inner install wins
    until it exits."""

    __slots__ = ("_sink", "_prev")

    def __init__(self, sink: TransferSink | None):
        self._sink = sink
        self._prev = None

    def __enter__(self) -> TransferSink | None:
        if self._sink is not None:
            self._prev = getattr(_local, "sink", None)
            _local.sink = self._sink
        return self._sink

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._sink is not None:
            _local.sink = self._prev
