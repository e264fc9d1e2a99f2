"""Process-wide counters (``GLOBAL``).

The port carries the counter half of the JAX package's
utils/metrics.py — what the verification path bumps. Gauges,
histograms and the Prometheus exposition come with the health server.
"""

from __future__ import annotations

import threading
from collections import defaultdict


class Counters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: "defaultdict[str, int]" = defaultdict(int)  # guarded-by: _lock

    def add(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._values[name] += value

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._values)


GLOBAL = Counters()
