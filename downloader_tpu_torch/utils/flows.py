"""Flow accounting, the part the verification path touches.

``object_key`` gives a stable, bounded identity for an object, and
``LEDGER.note_unique`` records how many unique bytes of it were served
(verified torrent pieces report a running total). The full ledger —
ingress by origin, heavy hitters, the amplification ratio — comes with
the fleet planes; this is the same unique-bytes bookkeeping with the
same max semantics and the same bound on distinct objects.
"""

from __future__ import annotations

import hashlib
import threading

from . import metrics

DEFAULT_MAX_OBJECTS = 512
OVERFLOW_KEY = "__overflow__"


def object_key(name: str) -> str:
    """A stable, bounded object identity: 12-hex digest of the full
    name plus a short human tail."""
    text = str(name)
    digest = hashlib.sha256(
        text.encode("utf-8", "backslashreplace")
    ).hexdigest()[:12]
    tail = text.split("?", 1)[0].rstrip("/").rsplit("/", 1)[-1][-40:]
    return f"{digest}:{tail}" if tail else digest


class FlowLedger:
    """Unique bytes served per object, bounded to ``max_objects`` keys
    (later strangers fold into one overflow slot)."""

    def __init__(self, max_objects: int = DEFAULT_MAX_OBJECTS):
        self._lock = threading.Lock()
        self._max_objects = max(1, max_objects)
        self._unique: dict[str, int] = {}  # guarded-by: _lock

    def note_unique(self, obj: str, total_bytes: int) -> None:
        """Object ``obj``'s served copy is (at least) ``total_bytes``
        long. Max semantics: callers report a running total, so a late
        or repeated report never inflates unique bytes."""
        if total_bytes <= 0:
            return
        with self._lock:
            if obj not in self._unique and len(self._unique) >= self._max_objects:
                obj = OVERFLOW_KEY
            delta = total_bytes - self._unique.get(obj, 0)
            if delta <= 0:
                return
            self._unique[obj] = total_bytes
        metrics.GLOBAL.add("flow_unique_bytes_total", delta)


LEDGER = FlowLedger()
