"""Flow accounting: the ledger half the transfer path feeds.

The port carries the flow ledger of the JAX package's utils/flows.py:
every byte moved is attributed to (object-key digest, origin host,
source kind) via bounded-cardinality counters plus a space-saving
heavy-hitter sketch over the object dimension. The headline number is
the live **origin-amplification ratio** — origin bytes fetched ÷ unique
object bytes served. The seams that report progress feed it:
``SourceBoard.note_bytes`` (segmented HTTP), ``fetch_small`` (the
small-object lane bypasses the board) and piece verification (unique
torrent bytes).

Cardinality discipline: past ``max_origins`` / ``max_objects`` distinct
keys, new strangers fold into one ``__overflow__`` bucket — totals stay
exact, per-key attribution degrades, memory stays bounded. Snapshots,
egress, cache hits, canary exclusion, the sketch merge and critical-path
extraction come with the fleet planes.
"""

import hashlib
import re
import threading
import urllib.parse

from . import metrics

DEFAULT_HITTERS = 64
DEFAULT_MAX_ORIGINS = 64
DEFAULT_MAX_OBJECTS = 512
OVERFLOW_KEY = "__overflow__"
OVERFLOW_LABEL = "overflow"

_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def object_key(name: str) -> str:
    """A stable, bounded object identity: 12-hex digest of the full
    (already credential-redacted) name plus a short human tail, so a
    heavy-hitter listing NAMES the object without unbounded strings.
    Call with a redacted URL, an S3 key, or a ``torrent:`` tag."""
    text = str(name)
    digest = hashlib.sha256(
        text.encode("utf-8", "backslashreplace")
    ).hexdigest()[:12]
    tail = text.split("?", 1)[0].rstrip("/").rsplit("/", 1)[-1][-40:]
    return f"{digest}:{tail}" if tail else digest


def host_of(name: str) -> str:
    """The origin-host component of a source name — a URL's hostname
    (mirrors, webseeds) or the address part of ``ip:port`` (peers)."""
    text = str(name)
    if "://" in text:
        try:
            host = urllib.parse.urlsplit(text).hostname or ""
        except ValueError:
            host = ""
        return host or "unknown"
    host = text.rsplit(":", 1)[0] if ":" in text else text
    return host.strip("[]") or "unknown"


# -- bounded origin-host metric labels (the per-origin-host dimension
# on source_bytes_total_*) ----------------------------------------------

_label_lock = threading.Lock()
_labels: "dict[str, str]" = {}  # guarded-by: _label_lock


def origin_label(host: str) -> str:
    """A metric-name-safe label for an origin host, bounded the same
    way the admission layer bounds lanes: the first ``FLOW_MAX_ORIGINS``
    distinct hosts get their own (sanitized) label, every later
    stranger shares ``overflow`` — a hostile job mix can widen the
    exposition only so far. Distinct hosts that sanitize to the same
    label share a series (documented, not detected: the label is a
    grouping dimension, the flow ledger keeps exact hosts)."""
    with _label_lock:
        label = _labels.get(host)
        if label is None:
            if len(_labels) >= LEDGER.max_origins:
                label = OVERFLOW_LABEL
            else:
                label = _LABEL_RE.sub("_", host).strip("_") or "unknown"
            _labels[host] = label
    return label


# -- the heavy-hitter sketch --------------------------------------------


class SpaceSaving:
    """Weighted space-saving sketch (Metwally et al.): at most
    ``capacity`` monitored keys; an unmonitored arrival evicts the
    current minimum and inherits its count as error floor. Guarantees:
    every monitored estimate overshoots the key's true weight by at
    most ``error`` (itself ≤ total ÷ capacity), and any key whose true
    weight exceeds total ÷ capacity is monitored. NOT thread-safe —
    the owning ledger serializes offers under its lock."""

    __slots__ = ("capacity", "total", "_counts")

    def __init__(self, capacity: int = DEFAULT_HITTERS):
        self.capacity = max(1, int(capacity))
        self.total = 0
        # key -> [estimate, error]
        self._counts: "dict[str, list]" = {}

    def offer(self, key: str, weight: int = 1) -> None:
        if weight <= 0:
            return
        self.total += weight
        entry = self._counts.get(key)
        if entry is not None:
            entry[0] += weight
            return
        if len(self._counts) < self.capacity:
            self._counts[key] = [weight, 0]
            return
        # evict the minimum-estimate key (deterministic tie-break on
        # the key itself so one stream replays identically)
        victim = min(self._counts, key=lambda k: (self._counts[k][0], k))
        floor, _ = self._counts.pop(victim)
        self._counts[key] = [floor + weight, floor]


# -- the flow ledger ----------------------------------------------------


class FlowLedger:
    """Process-wide byte-flow attribution. ``note_ingress`` runs per
    received chunk on the transfer hot paths, so the whole update is a
    few dict bumps under one lock; the amplification ratio and the
    hottest object's share of demand leave as two gauges."""

    def __init__(
        self,
        hitters: "int | None" = None,
        max_origins: "int | None" = None,
        max_objects: "int | None" = None,
        enabled: bool = True,
    ):
        self._lock = threading.Lock()
        self.enabled = enabled
        self.max_origins = (
            DEFAULT_MAX_ORIGINS if max_origins is None else max(1, max_origins)
        )
        self._max_objects = (
            DEFAULT_MAX_OBJECTS if max_objects is None else max(1, max_objects)
        )
        self._hitters = DEFAULT_HITTERS if hitters is None else max(1, hitters)
        # origin host -> {"ingress_bytes": int, "by_kind": {kind: int}}
        self._origins: "dict[str, dict]" = {}  # guarded-by: _lock
        # object key -> [demand, unique]
        self._objects: "dict[str, list]" = {}  # guarded-by: _lock
        self._sketch = SpaceSaving(self._hitters)  # guarded-by: _lock
        self._ingress_total = 0  # guarded-by: _lock
        self._unique_total = 0  # guarded-by: _lock
        # the ratio's inputs, TRACKED objects only: the overflow bucket
        # cannot dedupe re-fetches per stranger (no per-key state past
        # the bound), so folding it into the ratio would let a merely
        # DIVERSE workload fake amplification. Totals stay exact; the
        # headline ratio is computed over the objects the ledger can
        # attribute honestly.
        self._tracked_demand = 0  # guarded-by: _lock
        self._tracked_unique = 0  # guarded-by: _lock
        # max single-key sketch estimate: monotone (estimates only
        # grow), so the hot-share gauge is one division per note
        self._top_bytes = 0  # guarded-by: _lock

    # -- the hot-path notes ---------------------------------------------

    def _object_slot(self, key: str) -> "tuple[list, bool]":  # holds: _lock
        """The object's counter slot plus whether the key folded into
        the overflow bucket (folded bytes stay out of the ratio)."""
        slot = self._objects.get(key)
        if slot is not None:
            return slot, key == OVERFLOW_KEY
        if len(self._objects) >= self._max_objects:
            slot = self._objects.get(OVERFLOW_KEY)
            if slot is None:
                slot = self._objects[OVERFLOW_KEY] = [0, 0]
            return slot, True
        slot = self._objects[key] = [0, 0]
        return slot, False

    def note_ingress(self, obj: str, origin: str, kind: str, count: int) -> None:
        """``count`` bytes arrived from ``origin`` (host) over a
        ``kind`` lane toward object ``obj`` — called per chunk."""
        if not self.enabled or count <= 0:
            return
        with self._lock:
            self._ingress_total += count
            entry = self._origins.get(origin)
            if entry is None:
                if len(self._origins) >= self.max_origins:
                    origin = OVERFLOW_KEY
                    entry = self._origins.get(origin)
                if entry is None:
                    entry = self._origins[origin] = {
                        "ingress_bytes": 0,
                        "by_kind": {},
                    }
            entry["ingress_bytes"] += count
            by_kind = entry["by_kind"]
            by_kind[kind] = by_kind.get(kind, 0) + count
            slot, folded = self._object_slot(obj)
            slot[0] += count
            if not folded:
                self._tracked_demand += count
            self._sketch.offer(obj, count)
            est = self._sketch._counts.get(obj)
            if est is not None and est[0] > self._top_bytes:
                self._top_bytes = est[0]
            amplification, hot_share = self._ratios()
        metrics.GLOBAL.add("flow_origin_bytes_total", count)
        metrics.GLOBAL.gauge_set("flow_origin_amplification", amplification)
        metrics.GLOBAL.gauge_set("flow_hot_object_share", hot_share)

    def note_unique(self, obj: str, total_bytes: int) -> None:
        """Object ``obj``'s served copy is (at least) ``total_bytes``
        long. Max semantics: callers report a RUNNING total — the whole
        object at fetch completion, cumulative verified bytes on the
        torrent path — so re-fetching the same object never inflates
        unique bytes, only demand. Past the object bound, strangers'
        running totals max-fold into ONE overflow slot (distinct
        strangers cannot be told apart without per-key state), so
        folded bytes are kept out of the amplification ratio — see
        :meth:`_ratios`."""
        if not self.enabled or total_bytes <= 0:
            return
        with self._lock:
            slot, folded = self._object_slot(obj)
            delta = total_bytes - slot[1]
            if delta <= 0:
                return
            slot[1] = total_bytes
            self._unique_total += delta
            if not folded:
                self._tracked_unique += delta
            amplification, _ = self._ratios()
        metrics.GLOBAL.add("flow_unique_bytes_total", delta)
        metrics.GLOBAL.gauge_set("flow_origin_amplification", amplification)

    def _ratios(self) -> "tuple[float, float]":  # holds: _lock
        """Amplification over TRACKED objects only: the overflow bucket
        cannot dedupe per-stranger re-fetches, so a high-diversity
        workload folded past FLOW_MAX_OBJECTS would otherwise read as
        phantom amplification. Attribution degrades past the bound —
        the headline ratio does not."""
        unique = self._tracked_unique
        amplification = (
            self._tracked_demand / unique if unique > 0 else 0.0
        )
        total = self._sketch.total
        hot_share = self._top_bytes / total if total > 0 else 0.0
        return amplification, hot_share


LEDGER = FlowLedger()
