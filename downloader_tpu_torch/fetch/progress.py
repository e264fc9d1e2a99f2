"""Per-job transfer-progress plumbing: how fetch backends advertise
contiguous-completed byte ranges of each target file while the fetch is
still running.

The streaming upload pipeline (store/pipeline.py) consumes these
reports to start shipping S3 multipart parts before the fetch
finishes. The coupling is deliberately one-way and optional: backends
report into whatever sink is installed for the job (or a shared no-op
when none is), and never import the store layer.

Propagation mirrors tracing.py's thread-local model: the daemon
installs the job's sink around the dispatcher call on the job thread;
components that fan out to worker threads (the torrent PieceStore)
capture the sink at construction time on the job thread and report
directly from wherever their writes happen — sink implementations must
be thread-safe.

Report semantics:

- ``begin_file(path, total, read_path=None)`` — a fetch is about to
  populate ``path`` with exactly ``total`` bytes. ``read_path`` is
  where the bytes can be read back mid-transfer when that differs from
  the final path (the HTTP backend's ``.part`` file).
- ``advance(path, offset)`` — bytes ``[0, offset)`` are durably
  written (sequential writers: HTTP/webseed write offset). Monotonic;
  stale offsets are ignored.
- ``add_span(path, start, end)`` — bytes ``[start, end)`` are durably
  written (out-of-order writers: torrent pieces report them SHA-1
  verified; the segmented HTTP fetcher reports each segment's flushed
  window, so spans arrive as a NON-monotone, non-prefix set —
  consumers must merge, not assume a growing prefix).
- ``finish_file(path)`` — the file is complete at its final path.
- ``invalidate(path)`` — previously reported bytes are no longer
  trustworthy (an HTTP transfer restarting from zero may receive
  different bytes); consumers must discard speculative state.
"""

from __future__ import annotations

import threading
from typing import Protocol


class SpanSet:
    """Disjoint, sorted set of half-open byte ranges ``[start, end)``.

    The shared span arithmetic for everything that tracks partial
    coverage of a byte stream: the streaming pipeline's part math
    (store/pipeline.py), the segmented fetcher's resume journal and
    endgame bookkeeping (fetch/segments.py). Not thread-safe — callers
    hold their own lock. The merge keeps the list canonical (no
    overlaps, no adjacency) so coverage checks are a bisect-free linear
    probe over what is, in practice, a handful of spans (sequential
    writers keep exactly one)."""

    __slots__ = ("_spans",)

    def __init__(self) -> None:
        self._spans: list[tuple[int, int]] = []

    def add(self, start: int, end: int) -> None:
        if end <= start:
            return
        merged: list[tuple[int, int]] = []
        placed = False
        for lo, hi in self._spans:
            if hi < start or lo > end:  # strictly outside (not adjacent)
                if not placed and lo > end:
                    merged.append((start, end))
                    placed = True
                merged.append((lo, hi))
            else:  # overlaps or touches: fold into the new span
                start = min(start, lo)
                end = max(end, hi)
        if not placed:
            merged.append((start, end))
            merged.sort()
        self._spans = merged

    def covers(self, start: int, end: int) -> bool:
        if end <= start:
            return True
        for lo, hi in self._spans:
            if lo <= start and end <= hi:
                return True
        return False

    def total(self) -> int:
        return sum(hi - lo for lo, hi in self._spans)

    def spans(self) -> list[tuple[int, int]]:
        return list(self._spans)

    def missing(self, total: int) -> list[tuple[int, int]]:
        """The gaps in ``[0, total)`` not yet covered — what a resumed
        segmented fetch still has to request."""
        gaps: list[tuple[int, int]] = []
        cursor = 0
        for lo, hi in self._spans:
            if lo >= total:
                break
            if lo > cursor:
                gaps.append((cursor, min(lo, total)))
            cursor = max(cursor, hi)
        if cursor < total:
            gaps.append((cursor, total))
        return gaps


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
    """The sink installed on this thread, or the shared no-op — callers
    never need to branch on None."""
    return getattr(_local, "sink", None) or NOOP


class install:
    """Context manager installing ``sink`` as this thread's transfer
    sink for the duration. ``install(None)`` is a no-op so call sites
    don't branch. Not reentrant per thread — the inner install wins
    until it exits (jobs don't nest)."""

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
