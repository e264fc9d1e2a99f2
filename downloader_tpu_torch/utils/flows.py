"""Flow accounting & critical-path extraction.

Two instruments the data-plane roadmap items are accepted against:

- **The flow ledger** (:class:`FlowLedger`, module global ``LEDGER``):
  every byte moved is attributed to (object-key digest, origin host,
  source kind) via bounded-cardinality counters plus a space-saving
  heavy-hitter sketch over the object dimension. The headline number is
  the live **origin-amplification ratio** — origin bytes fetched ÷
  unique object bytes served — the number the single-flight /
  fleet-as-swarm work must flatten. The seams that already report
  progress feed it: ``SourceBoard.note_bytes`` (segmented HTTP,
  webseed, and peer traffic all route through the board),
  ``fetch_small`` (the batched lane bypasses the board), piece
  verification (unique torrent bytes), and the pipeline's ``ship``
  (egress).

- **Critical-path extraction** (:func:`critical_path`,
  :func:`job_critical_paths`, :func:`waterfall`): pure functions over
  the tracer's serialized span trees that name which child span's
  completion each stage actually waited on — the per-job gating chain —
  and aggregate chains into a "where does p99 live" waterfall.

Both are served at worker ``/debug/flows`` + ``/debug/critpath``,
merged fleet-wide by ``daemon/fleetplane.py`` (via
:func:`merge_flow_snapshots` / :func:`merge_critpath_payloads` — fleet
amplification is computed from SUMMED bytes, never from averaged
per-worker ratios), exported to the TSDB through the metrics registry,
watched by two alert rules, and embedded in incident bundles.

Cardinality discipline mirrors the admission layer's overflow lane:
past ``FLOW_MAX_ORIGINS`` / ``FLOW_MAX_OBJECTS`` distinct keys, new
strangers fold into one ``__overflow__`` bucket — totals stay exact,
per-key attribution degrades, memory stays bounded. The sketch keeps
heavy-hitter ranking honest past the object bound: a space-saving
sketch's estimate overshoots a key's true weight by at most
``total / capacity``, and merging sketches (fleet fold) is exactly
associative because capacity is enforced at offer time, never at merge
(a fleet's merged sketch is bounded by workers × capacity entries —
display truncates, the fold does not).
"""

import hashlib
import os
import re
import threading
import urllib.parse
from collections import OrderedDict

from . import metrics

DEFAULT_HITTERS = 64
DEFAULT_MAX_ORIGINS = 64
DEFAULT_MAX_OBJECTS = 512
# thresholds the stock alert rules watch (utils/alerts.py): a steadily
# amplified origin is a capacity/cost burn, a single object taking most
# of the demand is the flash-crowd signature the swarm work targets
DEFAULT_AMPLIFICATION_ALERT = 3.0
DEFAULT_HOT_SHARE_ALERT = 0.8
OVERFLOW_KEY = "__overflow__"
OVERFLOW_LABEL = "overflow"
# bound on the canary-exclusion set (object keys whose bytes are
# synthetic and must stay out of every flow signal)
MAX_EXCLUDED = 256

# the stage spans daemon/app.py wraps each job phase in — the names a
# gating chain's first hop below the root resolves to
STAGE_SPANS = ("fetch", "scan", "upload", "publish", "stream_upload")

_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _int_env(env, name: str, default: int, minimum: int = 1) -> int:
    raw = (env.get(name) or "").strip()
    if not raw:
        return default
    try:
        return max(minimum, int(raw))
    except ValueError:
        return default


def _float_env(env, name: str, default: float, minimum: float) -> float:
    raw = (env.get(name) or "").strip()
    if not raw:
        return default
    try:
        return max(minimum, float(raw))
    except ValueError:
        return default


def enabled_from_env(environ=None) -> bool:
    """``FLOW``: the ledger's master switch (on by default — the hot
    path is a dict bump per chunk)."""
    env = os.environ if environ is None else environ
    return (env.get("FLOW") or "").strip().lower() not in ("0", "off", "false")


def hitters_from_env(environ=None) -> int:
    """``FLOW_HITTERS``: space-saving sketch capacity (the error bound
    is total ÷ capacity)."""
    env = os.environ if environ is None else environ
    return _int_env(env, "FLOW_HITTERS", DEFAULT_HITTERS)


def max_origins_from_env(environ=None) -> int:
    """``FLOW_MAX_ORIGINS``: distinct origin hosts tracked exactly
    before new ones fold into the overflow bucket."""
    env = os.environ if environ is None else environ
    return _int_env(env, "FLOW_MAX_ORIGINS", DEFAULT_MAX_ORIGINS)


def max_objects_from_env(environ=None) -> int:
    """``FLOW_MAX_OBJECTS``: distinct object keys tracked exactly
    before new ones fold into the overflow bucket."""
    env = os.environ if environ is None else environ
    return _int_env(env, "FLOW_MAX_OBJECTS", DEFAULT_MAX_OBJECTS)


def amplification_alert_from_env(environ=None) -> float:
    """``FLOW_AMPLIFICATION_ALERT``: the origin-amplification ratio at
    or past which the burn rule fires."""
    env = os.environ if environ is None else environ
    return _float_env(
        env, "FLOW_AMPLIFICATION_ALERT", DEFAULT_AMPLIFICATION_ALERT, 1.0
    )


def hot_share_alert_from_env(environ=None) -> float:
    """``FLOW_HOT_SHARE_ALERT``: the single-object demand share at or
    past which the concentration rule fires."""
    env = os.environ if environ is None else environ
    return _float_env(
        env, "FLOW_HOT_SHARE_ALERT", DEFAULT_HOT_SHARE_ALERT, 0.01
    )


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


# -- bounded origin-host metric labels (satellite: per-origin-host
# dimension on source_bytes_total_*) ------------------------------------

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


def reset_origin_labels() -> None:
    """Test isolation for the process-wide label registry."""
    with _label_lock:
        _labels.clear()


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

    def heavy_hitters(self, k: int = 16) -> "list[dict]":
        """Top-k by estimate, deterministically ordered (estimate desc,
        then key) — truncation happens HERE, at display, never in the
        merge."""
        ranked = sorted(
            self._counts.items(), key=lambda item: (-item[1][0], item[0])
        )
        return [
            {"key": key, "bytes": est, "error": err}
            for key, (est, err) in ranked[: max(0, int(k))]
        ]

    def snapshot(self) -> dict:
        """The mergeable wire form: full item set, canonically sorted."""
        return {
            "capacity": self.capacity,
            "total": self.total,
            "items": self.heavy_hitters(len(self._counts)),
        }

    @staticmethod
    def merge(snapshots: "list[dict]") -> dict:
        """Fold sketch snapshots: totals sum, per-key estimates and
        errors sum with absent-as-zero. No truncation — that makes the
        fold exactly associative and commutative (the merged item set
        is bounded by inputs × capacity, a handful of workers). The
        result is itself a valid snapshot for further folding."""
        capacity = 1
        total = 0
        folded: "dict[str, list]" = {}
        for snap in snapshots:
            if not snap:
                continue
            capacity = max(capacity, int(snap.get("capacity", 1)))
            total += int(snap.get("total", 0))
            for item in snap.get("items", ()):
                entry = folded.setdefault(str(item.get("key", "")), [0, 0])
                entry[0] += int(item.get("bytes", 0))
                entry[1] += int(item.get("error", 0))
        ranked = sorted(folded.items(), key=lambda kv: (-kv[1][0], kv[0]))
        return {
            "capacity": capacity,
            "total": total,
            "items": [
                {"key": key, "bytes": est, "error": err}
                for key, (est, err) in ranked
            ],
        }


# -- the flow ledger ----------------------------------------------------


class FlowLedger:
    """Process-wide byte-flow attribution. ``note_ingress`` runs per
    received chunk on the transfer hot paths, so the whole update is a
    few dict bumps under one lock; everything expensive (ranking,
    ratios, serialization) happens at snapshot time."""

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
        # object key -> [demand, unique, egress]
        self._objects: "dict[str, list]" = {}  # guarded-by: _lock
        self._sketch = SpaceSaving(self._hitters)  # guarded-by: _lock
        self._ingress_total = 0  # guarded-by: _lock
        self._unique_total = 0  # guarded-by: _lock
        self._egress_total = 0  # guarded-by: _lock
        # bytes served from the shared content cache (the fleet data
        # plane): they enter the ratio only through note_unique — this
        # lane exists so the snapshot can show HOW demand was met
        self._cache_hit_total = 0  # guarded-by: _lock
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
        # synthetic-probe object keys (utils/canary.py): their bytes
        # must never enter the amplification ratio or the heavy-hitter
        # sketch. Bounded FIFO — a runaway prober cannot grow it.
        self._excluded: "OrderedDict[str, None]" = OrderedDict()  # guarded-by: _lock

    # -- configuration --------------------------------------------------

    def configure(
        self,
        enabled: "bool | None" = None,
        hitters: "int | None" = None,
        max_origins: "int | None" = None,
        max_objects: "int | None" = None,
    ) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = enabled
            if max_origins is not None:
                self.max_origins = max(1, max_origins)
            if max_objects is not None:
                self._max_objects = max(1, max_objects)
            if hitters is not None and hitters != self._hitters:
                self._hitters = max(1, hitters)
                resized = SpaceSaving(self._hitters)
                for item in self._sketch.heavy_hitters(self._hitters):
                    resized.offer(item["key"], item["bytes"])
                resized.total = self._sketch.total
                self._sketch = resized

    def configure_from_env(self, environ=None) -> None:
        self.configure(
            enabled=enabled_from_env(environ),
            hitters=hitters_from_env(environ),
            max_origins=max_origins_from_env(environ),
            max_objects=max_objects_from_env(environ),
        )

    def reset(self) -> None:
        """Test isolation: drop every flow, keep configuration."""
        with self._lock:
            self._origins.clear()
            self._objects.clear()
            self._sketch = SpaceSaving(self._hitters)
            self._ingress_total = 0
            self._unique_total = 0
            self._egress_total = 0
            self._cache_hit_total = 0
            self._tracked_demand = 0
            self._tracked_unique = 0
            self._top_bytes = 0
            self._excluded.clear()
        metrics.GLOBAL.gauge_set("flow_origin_amplification", 0.0)
        metrics.GLOBAL.gauge_set("flow_hot_object_share", 0.0)

    # -- canary exclusion ------------------------------------------------

    def exclude(self, key: str) -> None:
        """Mark an object key as synthetic: every later note for it is
        dropped before it can touch the ledger, the amplification
        ratio, or the heavy-hitter sketch. The set is a bounded FIFO
        (:data:`MAX_EXCLUDED`): the oldest probe keys age out, which is
        fine — a probe's notes all land within one probe timeout."""
        with self._lock:
            self._excluded[key] = None
            self._excluded.move_to_end(key)
            while len(self._excluded) > MAX_EXCLUDED:
                self._excluded.popitem(last=False)

    def _is_excluded(self, key: str) -> bool:
        with self._lock:
            return key in self._excluded

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
                slot = self._objects[OVERFLOW_KEY] = [0, 0, 0]
            return slot, True
        slot = self._objects[key] = [0, 0, 0]
        return slot, False

    def note_ingress(self, obj: str, origin: str, kind: str, count: int) -> None:
        """``count`` bytes arrived from ``origin`` (host) over a
        ``kind`` lane toward object ``obj`` — called per chunk."""
        if not self.enabled or count <= 0:
            return
        with self._lock:
            if self._excluded and obj in self._excluded:
                return
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
            if self._excluded and obj in self._excluded:
                return
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

    def note_cache_hit(self, obj: str, count: int) -> None:
        """``count`` bytes of object ``obj`` served from the shared
        content cache instead of any origin. Pair with
        :meth:`note_unique` — a cache serve is a unique-object serve
        (the amplification denominator grows, the origin numerator
        does not, which is the data plane's whole claim)."""
        if not self.enabled or count <= 0:
            return
        with self._lock:
            if self._excluded and obj in self._excluded:
                return
            self._cache_hit_total += count
        metrics.GLOBAL.add("flow_cache_hit_bytes_total", count)

    def note_egress(self, obj: str, count: int) -> None:
        """``count`` bytes shipped downstream (an uploaded part) for
        object ``obj``."""
        if not self.enabled or count <= 0:
            return
        with self._lock:
            if self._excluded and obj in self._excluded:
                return
            self._egress_total += count
            slot, _ = self._object_slot(obj)
            slot[2] += count
        metrics.GLOBAL.add("flow_egress_bytes_total", count)

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

    # -- the served views -----------------------------------------------

    def snapshot(self, hitters: int = 16, compact: bool = False) -> dict:
        """The ``/debug/flows`` body. ``compact`` (incident bundles)
        drops the full object table and mergeable sketch, keeping the
        headline ratios and the named top objects."""
        with self._lock:
            amplification, hot_share = self._ratios()
            origins = {
                host: {
                    "ingress_bytes": entry["ingress_bytes"],
                    "by_kind": dict(entry["by_kind"]),
                }
                for host, entry in sorted(self._origins.items())
            }
            objects = [
                {
                    "key": key,
                    "demand_bytes": slot[0],
                    "unique_bytes": slot[1],
                    "egress_bytes": slot[2],
                }
                for key, slot in sorted(
                    self._objects.items(), key=lambda kv: (-kv[1][0], kv[0])
                )
            ]
            payload = {
                "enabled": self.enabled,
                "ingress_bytes": self._ingress_total,
                "unique_bytes": self._unique_total,
                "egress_bytes": self._egress_total,
                "cache_hit_bytes": self._cache_hit_total,
                "origin_amplification": round(amplification, 6),
                "hot_object_share": round(hot_share, 6),
                "origins": origins,
                "heavy_hitters": self._sketch.heavy_hitters(hitters),
            }
            if not compact:
                payload["objects"] = objects
                payload["sketch"] = self._sketch.snapshot()
        return payload

    def incident_snapshot(self) -> dict:
        """The bounded form incident bundles embed."""
        return self.snapshot(hitters=8, compact=True)


LEDGER = FlowLedger()


def merge_flow_snapshots(per_instance: "dict[str, dict]") -> dict:
    """Fold worker ``/debug/flows`` snapshots into the fleet view.

    The one rule that matters: fleet amplification = Σ origin bytes ÷
    Σ fleet-unique bytes, where an object's fleet-unique contribution
    is the MAX of its per-worker unique bytes (N workers each serving
    the same object hold one copy's worth each — the fleet serves ONE
    unique copy, fetched N times). Averaging per-worker ratios would
    report ~1.0 for exactly the redundant-fetch fleet this instrument
    exists to expose."""
    ingress = 0
    egress = 0
    cache_hit = 0
    origins: "dict[str, dict]" = {}
    # object key -> [demand summed, unique maxed, egress summed]
    objects: "dict[str, list]" = {}
    sketches: "list[dict]" = []
    instances: "dict[str, dict]" = {}
    for instance, snap in sorted(per_instance.items()):
        if not isinstance(snap, dict):
            continue
        ingress += int(snap.get("ingress_bytes", 0))
        egress += int(snap.get("egress_bytes", 0))
        cache_hit += int(snap.get("cache_hit_bytes", 0))
        for host, entry in (snap.get("origins") or {}).items():
            folded = origins.setdefault(
                host, {"ingress_bytes": 0, "by_kind": {}}
            )
            folded["ingress_bytes"] += int(entry.get("ingress_bytes", 0))
            for kind, count in (entry.get("by_kind") or {}).items():
                folded["by_kind"][kind] = (
                    folded["by_kind"].get(kind, 0) + int(count)
                )
        for item in snap.get("objects") or ():
            key = str(item.get("key", ""))
            slot = objects.setdefault(key, [0, 0, 0])
            slot[0] += int(item.get("demand_bytes", 0))
            slot[1] = max(slot[1], int(item.get("unique_bytes", 0)))
            slot[2] += int(item.get("egress_bytes", 0))
        sketch = snap.get("sketch")
        if sketch:
            sketches.append(sketch)
        instances[instance] = {
            "ingress_bytes": int(snap.get("ingress_bytes", 0)),
            "unique_bytes": int(snap.get("unique_bytes", 0)),
            "cache_hit_bytes": int(snap.get("cache_hit_bytes", 0)),
            "origin_amplification": snap.get("origin_amplification", 0.0),
        }
    unique = sum(slot[1] for slot in objects.values())
    # the ratio mirrors the worker-local discipline: tracked objects
    # only — one worker's overflow bucket must not dilute (or fake)
    # the fleet's amplification
    tracked_demand = sum(
        slot[0] for key, slot in objects.items() if key != OVERFLOW_KEY
    )
    tracked_unique = sum(
        slot[1] for key, slot in objects.items() if key != OVERFLOW_KEY
    )
    merged_sketch = SpaceSaving.merge(sketches)
    top = merged_sketch["items"][0]["bytes"] if merged_sketch["items"] else 0
    total = merged_sketch["total"]
    return {
        "workers": len(instances),
        "ingress_bytes": ingress,
        "unique_bytes": unique,
        "egress_bytes": egress,
        "cache_hit_bytes": cache_hit,
        "origin_amplification": (
            round(tracked_demand / tracked_unique, 6)
            if tracked_unique > 0
            else 0.0
        ),
        "hot_object_share": round(top / total, 6) if total > 0 else 0.0,
        "origins": {host: origins[host] for host in sorted(origins)},
        "objects": [
            {
                "key": key,
                "demand_bytes": slot[0],
                "unique_bytes": slot[1],
                "egress_bytes": slot[2],
            }
            for key, slot in sorted(
                objects.items(), key=lambda kv: (-kv[1][0], kv[0])
            )
        ],
        "heavy_hitters": merged_sketch["items"][:16],
        "sketch": merged_sketch,
        "instances": instances,
    }


# -- critical-path extraction -------------------------------------------


def _span_end(span: dict) -> float:
    try:
        return float(span.get("start_ms", 0.0)) + float(
            span.get("duration_ms", 0.0)
        )
    except (TypeError, ValueError):
        return 0.0


def _critical_children(node: dict) -> "list[tuple[dict, float]]":
    """The backward sweep at one node: walking from the node's end
    toward its start, at every instant the node was waiting on the
    child that (a) had already started and (b) would end latest — so
    each child on the sweep is credited with the slice of the parent's
    duration it actually gated. Returns ``(child, critical_ms)`` pairs
    in timeline order. This is what makes SEQUENTIAL stages honest:
    fetch → scan → upload → publish each get their own slice, instead
    of the last stage absorbing the whole path by merely ending last.
    Deterministic tie-break on equal ends: the later recorded child
    wins."""
    try:
        start = float(node.get("start_ms", 0.0))
        duration = float(node.get("duration_ms", 0.0))
    except (TypeError, ValueError):
        return []
    end = start + duration
    children = [
        (index, child)
        for index, child in enumerate(node.get("children") or ())
        if isinstance(child, dict)
    ]
    out: "list[tuple[dict, float]]" = []
    t = end
    while children and t > start:
        eligible = [
            (index, child)
            for index, child in children
            if float(child.get("start_ms", 0.0) or 0.0) < t
        ]
        if not eligible:
            break
        index, child = max(
            eligible,
            key=lambda pair: (min(_span_end(pair[1]), t), pair[0]),
        )
        child_start = max(start, float(child.get("start_ms", 0.0) or 0.0))
        covered = min(_span_end(child), t) - child_start
        if covered <= 0:
            break
        out.append((child, covered))
        t = child_start
        children = [
            (i, c) for i, c in children if c is not child
        ]
    out.reverse()
    return out


def critical_path(root: "dict | None") -> "list[dict]":
    """The gating chain of one span tree. At each node the backward
    sweep (:func:`_critical_children`) decomposes the node's duration
    into the slices its children gated; the chain then descends into
    the child carrying the MOST critical time (tie-break: later in the
    timeline), which for a sequential stage pipeline is the stage the
    job actually spent its wait on — not merely the one that finished
    last. Chain entries carry ``critical_ms`` (the slice this node
    gated at its parent; the full duration for the root) and
    ``exclusive_ms`` (duration not covered by any child on the sweep —
    the node's own time)."""
    chain: "list[dict]" = []
    node = root
    depth = 0
    credit: "float | None" = None
    while isinstance(node, dict):
        try:
            start = float(node.get("start_ms", 0.0))
            duration = float(node.get("duration_ms", 0.0))
        except (TypeError, ValueError):
            break
        end = start + duration
        segments = _critical_children(node)
        covered = sum(ms for _, ms in segments)
        chain.append(
            {
                "name": str(node.get("name", "")),
                "depth": depth,
                "start_ms": round(start, 3),
                "end_ms": round(end, 3),
                "duration_ms": round(duration, 3),
                "critical_ms": round(
                    duration if credit is None else credit, 3
                ),
                "exclusive_ms": round(max(0.0, duration - covered), 3),
            }
        )
        if not segments:
            break
        best_index = max(
            range(len(segments)), key=lambda i: (segments[i][1], i)
        )
        node, credit = segments[best_index]
        depth += 1
    return chain


def job_critical_paths(traces: "list[dict]") -> "list[dict]":
    """One entry per traced job: its gating chain plus the stage that
    gated it (the chain's first hop below the root — for daemon jobs
    that IS one of the stage spans)."""
    jobs: "list[dict]" = []
    for trace in traces or ():
        if not isinstance(trace, dict):
            continue
        chain = critical_path(trace.get("spans"))
        if not chain:
            continue
        gating = chain[1]["name"] if len(chain) > 1 else chain[0]["name"]
        jobs.append(
            {
                "job_id": str(trace.get("job_id", "")),
                "status": str(trace.get("status", "")),
                "attempt": trace.get("attempt", 0),
                "duration_ms": chain[0]["duration_ms"],
                "gating_stage": gating,
                "chain": chain,
            }
        )
    return jobs


def waterfall(jobs: "list[dict]") -> dict:
    """Aggregate per-job gating chains into the "where does p99 live"
    view: per-stage gated-job counts and exclusive-time totals over
    ALL jobs, and the same decomposition over the slow cohort (jobs at
    or past the p99 duration) — the stages a p99 story is made of."""

    def fold(cohort: "list[dict]") -> dict:
        stages: "dict[str, dict]" = {}
        exclusive_total = 0.0
        for job in cohort:
            for entry in job.get("chain") or ():
                if entry.get("depth", 0) == 0:
                    continue
                stage = stages.setdefault(
                    entry["name"], {"jobs_gated": 0, "exclusive_ms": 0.0}
                )
                stage["exclusive_ms"] += float(entry.get("exclusive_ms", 0.0))
                exclusive_total += float(entry.get("exclusive_ms", 0.0))
            gating = job.get("gating_stage")
            if gating:
                stages.setdefault(
                    gating, {"jobs_gated": 0, "exclusive_ms": 0.0}
                )["jobs_gated"] += 1
        for stage in stages.values():
            stage["exclusive_ms"] = round(stage["exclusive_ms"], 3)
            stage["share"] = round(
                stage["exclusive_ms"] / exclusive_total, 4
            ) if exclusive_total > 0 else 0.0
        return stages

    durations = sorted(
        float(job.get("duration_ms", 0.0)) for job in jobs
    )
    if durations:
        index = min(len(durations) - 1, int(0.99 * len(durations)))
        p99 = durations[index]
        slow = [
            job for job in jobs
            if float(job.get("duration_ms", 0.0)) >= p99
        ]
    else:
        p99 = 0.0
        slow = []
    slow_stages = fold(slow)
    gating = max(
        slow_stages.items(),
        key=lambda kv: (kv[1]["jobs_gated"], kv[1]["exclusive_ms"], kv[0]),
        default=(None, None),
    )[0]
    return {
        "jobs": len(jobs),
        "p99_ms": round(p99, 3),
        "stages": fold(jobs),
        "slow": {
            "jobs": len(slow),
            "gating_stage": gating,
            "stages": slow_stages,
        },
    }


def critpath_payload(traces: "list[dict]", per_job: bool = True) -> dict:
    """The worker ``/debug/critpath`` body over the tracer's completed
    ring. ``per_job=False`` (incident bundles) keeps only the
    aggregated waterfall — the chains are reconstructable from the
    traces the bundle already carries."""
    jobs = job_critical_paths(traces)
    payload = waterfall(jobs)
    if per_job:
        payload["per_job"] = jobs
    return payload


def merge_critpath_payloads(per_instance: "dict[str, dict]") -> dict:
    """Fold worker ``/debug/critpath`` bodies into the fleet waterfall:
    per-job chains concatenate (instance-tagged) and the aggregation is
    RECOMPUTED over the combined population — fleet p99 comes from the
    merged duration distribution, never from averaging per-worker
    p99s."""
    combined: "list[dict]" = []
    for instance, payload in sorted(per_instance.items()):
        if not isinstance(payload, dict):
            continue
        for job in payload.get("per_job") or ():
            combined.append({**job, "instance": instance})
    merged = waterfall(combined)
    merged["per_job"] = combined
    merged["workers"] = len(per_instance)
    return merged
