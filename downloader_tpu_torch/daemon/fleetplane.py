"""Fleet-scoped debug plane: one operator query, every worker answers.

The fleet is N supervised ``serve()`` processes, but each worker's
debug plane is per-process: a job SIGKILL-redelivered across workers
keeps ONE trace id whose spans are split across two rings nobody can
join, logs live in N separate rings, profiles in N separate sample
buffers, and the burn-rate rules each watch one process's slice of
the fleet's SLO. This module applies the
GPUOS lesson (PAPERS.md: fuse many small operations into one scheduled
context) to the OPERATOR plane: every fleet ``/debug/*`` query is one
scheduled fan-out — concurrent per-worker scrapes, each bounded by the
``FLEET_SCRAPE_TIMEOUT_S`` budget so a wedged worker costs its slice
and never the response — merged with ``instance`` attribution.

Three cooperating pieces:

- **FleetQueryPlane** — the fan-out/merge engine behind the
  supervisor's ``FleetHealthServer``: ``/debug/trace?trace_id=``
  stitches one logical trace across processes (attempts ordered, every
  span tagged with its worker), ``/debug/logs`` k-way-merges the rings
  by timestamp (stable under clock skew: per-worker order is never
  reordered), ``/debug/incidents`` serves a fleet index with
  fetch-by-id routed to the owning worker, ``/debug/profile`` sums
  folded stacks keeping role × instance dimensions, and
  ``/debug/tsdb`` aggregates counter rates (fleet rate = sum of
  per-instance rates) and histogram percentiles (quantiles re-derived
  from fleet-SUMMED bucket deltas, never averaged per-worker p99s).
- **FleetAggregator** — a TSDB collector: each supervisor scrape tick
  also parses every worker's ``/metrics`` exposition and records the
  per-class SLO histograms both fleet-summed (``fleet:<series>``) and
  per-instance (``fleet:<series>:<instance>``), so the supervisor's
  burn-rate rules evaluate the FLEET's error budget and the
  worker-outlier rule can name the instance whose p99 left the pack.
  Worker trace-id exemplars ride along (``/debug/exemplars``), closing
  the metric→trace loop fleet-wide.
- **Cross-worker incident capture** — a firing fleet rule triggers
  ``POST /debug/incident`` on every worker and bundles the returned
  snapshots under ONE fleet incident id in the supervisor's flight
  recorder (rate-limited like every automatic trigger).
"""

from __future__ import annotations

import http.client
import json
import re
import threading
import time
import urllib.parse

from ..utils import alerts, flows, incident, metrics, profiling, tracing, tsdb
from ..utils.logging import get_logger, merge_ring_records

log = get_logger("fleetplane")

DEFAULT_SCRAPE_TIMEOUT_S = 2.0
DEFAULT_OUTLIER_RATIO = 4.0
# grace past the per-worker budget before the fan-out declares a
# straggler timed out: the HTTP timeout already bounds the scrape; the
# join grace only covers scheduler jitter on a loaded host
_JOIN_GRACE_S = 0.5
# stacks kept in a merged JSON profile response
_MAX_JSON_STACKS = 200
_MAX_LOG_RECORDS = 1000

# the per-class SLO histograms the aggregator folds fleet-wide — the
# series the fleet burn rules and the worker-outlier rule read
AGGREGATED_HISTOGRAMS = (
    "slo_job_duration_seconds_interactive",
    "slo_job_duration_seconds_bulk",
)


def fleet_series(name: str) -> str:
    """The supervisor-TSDB name for a fleet-summed worker series."""
    return f"fleet:{name}"


def instance_series(name: str, instance: str) -> str:
    """The supervisor-TSDB name for one worker's slice of a series."""
    return f"fleet:{name}:{instance}"


# each worker's canary correctness gauge in its /metrics exposition —
# the aggregator scans it per instance so the fleet canary rule can
# NAME the failing worker
_CANARY_GAUGE_RE = re.compile(
    r"^downloader_canary_failing (\S+)$", re.MULTILINE
)


def _http_request(
    port: int,
    path: str,
    method: str = "GET",
    timeout: float = DEFAULT_SCRAPE_TIMEOUT_S,
    host: str = "127.0.0.1",
) -> "tuple[int, bytes]":
    connection = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        connection.request(method, path)
        response = connection.getresponse()
        return response.status, response.read()
    finally:
        connection.close()


# one exposition bucket sample: downloader_<name>_bucket{le="x"} v
_EXPOSITION_BUCKET_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)_bucket\{le="([^"]+)"\} (\S+)$'
)


def parse_exposition_histograms(
    text: str, names: "tuple[str, ...]" = AGGREGATED_HISTOGRAMS
) -> "dict[str, tuple[tuple[float, ...], tuple[int, ...], float, int]]":
    """Pull ``names``' histogram triples out of one worker's raw
    ``/metrics`` exposition: (bounds, cumulative finite-bucket counts,
    sum, count) in exactly the registry-snapshot shape the TSDB's
    histogram series store. Malformed lines cost themselves, never the
    parse."""
    wanted = {f"downloader_{name}": name for name in names}
    acc: "dict[str, dict]" = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        match = _EXPOSITION_BUCKET_RE.match(line)
        if match is not None:
            name = wanted.get(match.group(1))
            if name is None or match.group(2) == "+Inf":
                continue
            try:
                le = float(match.group(2))
                value = int(float(match.group(3)))
            except ValueError:
                continue
            acc.setdefault(name, {"buckets": []})["buckets"].append(
                (le, value)
            )
            continue
        sample, _, raw_value = line.rpartition(" ")
        for suffix, key in (("_sum", "sum"), ("_count", "count")):
            if sample.endswith(suffix):
                name = wanted.get(sample[: -len(suffix)])
                if name is None:
                    continue
                try:
                    acc.setdefault(name, {"buckets": []})[key] = float(
                        raw_value
                    )
                except ValueError:
                    pass
    out: dict = {}
    for name, parts in acc.items():
        buckets = sorted(parts.get("buckets") or [])
        out[name] = (
            tuple(le for le, _ in buckets),
            tuple(value for _, value in buckets),
            float(parts.get("sum", 0.0)),
            int(parts.get("count", 0.0)),
        )
    return out


def _json_body(payload: dict) -> "tuple[int, bytes, str]":
    return (
        200,
        (json.dumps(payload, indent=1, default=str) + "\n").encode(),
        "application/json",
    )


class FleetQueryPlane:
    """The fan-out/merge engine: ``workers()`` names the ready fleet
    members as ``(instance, health_port)`` pairs (the supervisor's
    heartbeat registry in production, a static list in tests), and
    every query scrapes them CONCURRENTLY under one per-worker
    ``timeout_s`` budget — the whole fan-out costs max one slice, and
    a wedged or dead worker degrades to an ``errors`` entry in the
    merged response, never a hang."""

    def __init__(
        self,
        workers,
        timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S,
        engine: "alerts.AlertEngine | None" = None,
    ):
        self._workers = workers
        self.timeout_s = max(0.05, timeout_s)
        self._engine = engine

    # -- fan-out machinery -------------------------------------------------

    def worker_map(self) -> "dict[str, int]":
        return {instance: port for instance, port in self._workers() or ()}

    def fetch_one(
        self, instance: str, path: str, method: str = "GET"
    ) -> "dict":
        """One bounded scrape of one named worker (the fetch-by-id
        routing path); same entry shape as ``fanout``'s values."""
        port = self.worker_map().get(instance)
        if not port:
            return {"ok": False, "error": "no such worker"}
        try:
            status, body = _http_request(
                port, path, method=method, timeout=self.timeout_s
            )
        except Exception as exc:
            metrics.GLOBAL.add("fleet_scrape_failures")
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        entry = {"ok": 200 <= status < 300, "status": status, "body": body}
        if not entry["ok"]:
            entry["error"] = f"HTTP {status}"
        return entry

    def fanout(self, path: str, method: str = "GET") -> "dict[str, dict]":
        """Scrape ``path`` from every ready worker concurrently; each
        worker's verdict is ``{ok, status, body}`` or ``{ok: False,
        error}``. The join budget is SHARED: N workers cost one
        timeout slice total, because the scrapes run in parallel and a
        straggler is abandoned at the deadline (its daemon thread dies
        at the HTTP timeout; its slot reads as a scrape failure)."""
        workers = list(self._workers() or ())
        results: "dict[str, dict]" = {}
        results_lock = threading.Lock()
        timeout = self.timeout_s

        def scrape(instance: str, port: int) -> None:
            try:
                status, body = _http_request(
                    port, path, method=method, timeout=timeout
                )
                entry: dict = {
                    "ok": 200 <= status < 300,
                    "status": status,
                    "body": body,
                }
                if not entry["ok"]:
                    entry["error"] = f"HTTP {status}"
            except Exception as exc:
                entry = {
                    "ok": False,
                    "error": f"{type(exc).__name__}: {exc}",
                }
            with results_lock:
                # a straggler finishing after the join deadline finds
                # its slot already marked timed-out: that failure was
                # counted there — recording (and counting) again would
                # double-book one logical scrape
                if instance in results:
                    return
                results[instance] = entry
            if not entry["ok"]:
                metrics.GLOBAL.add("fleet_scrape_failures")

        threads = []
        for instance, port in workers:
            thread = threading.Thread(  # thread-role: fleet-scraper
                target=scrape,
                args=(instance, port),
                name=f"fleet-scrape-{instance}",
                daemon=True,
            )
            threads.append(thread)
            thread.start()
            profiling.ROLES.register_thread(thread, "fleet-scraper")
        deadline = time.monotonic() + timeout + _JOIN_GRACE_S
        for thread in threads:
            # deadline: every scrape is bounded by its HTTP timeout; the shared join budget means N workers cost one slice, not N
            thread.join(timeout=max(0.05, deadline - time.monotonic()))
        timeouts = 0
        with results_lock:
            # mark stragglers in the SHARED dict so a late-finishing
            # scrape thread sees its slot taken and stands down instead
            # of double-counting the failure
            for instance, _ in workers:
                if instance not in results:
                    timeouts += 1
                    results[instance] = {
                        "ok": False,
                        "error": f"scrape timeout (> {timeout:g}s)",
                    }
            out = dict(results)
        if timeouts:
            metrics.GLOBAL.add("fleet_scrape_failures", timeouts)
        metrics.GLOBAL.add("fleet_debug_fanouts")
        return out

    @staticmethod
    def _parse_json(entry: dict):
        if not entry.get("ok"):
            return None
        try:
            return json.loads(entry["body"].decode())
        except (ValueError, UnicodeDecodeError, KeyError):
            return None

    def _split(
        self, results: "dict[str, dict]"
    ) -> "tuple[dict[str, dict], dict[str, str]]":
        """(parsed JSON per healthy instance, error string per failed
        one) — every merged view reports BOTH, so a degraded fleet
        answer says which workers it is missing."""
        payloads: "dict[str, dict]" = {}
        errors: "dict[str, str]" = {}
        for instance, entry in results.items():
            payload = self._parse_json(entry)
            if payload is None:
                errors[instance] = entry.get("error", "unparseable response")
            else:
                payloads[instance] = payload
        return payloads, errors

    # -- merged /debug views ----------------------------------------------

    def debug_trace(
        self, query: "dict | None" = None
    ) -> "tuple[int, bytes, str]":
        """``?trace_id=`` stitches ONE logical trace across worker
        processes: every live worker's lineage for the id, attempts
        ordered, every span tagged with the instance that recorded it.
        Without a trace id, each worker's Chrome-trace export is
        served per instance (cross-process span trees only join
        meaningfully under a shared trace id)."""
        trace_id = (query or {}).get("trace_id", [""])[0]
        if not trace_id:
            payloads, errors = self._split(self.fanout("/debug/trace"))
            payload: dict = {"instances": payloads}
            if errors:
                payload["errors"] = errors
            return _json_body(payload)
        results = self.fanout(
            f"/debug/trace?trace_id={urllib.parse.quote(trace_id)}"
        )
        payloads, errors = self._split(results)
        stitched = tracing.stitch_lineage(
            trace_id,
            {
                instance: payload.get("attempts") or []
                for instance, payload in payloads.items()
            },
        )
        if errors:
            stitched["errors"] = errors
        return _json_body(stitched)

    def debug_logs(
        self, query: "dict | None" = None
    ) -> "tuple[int, bytes, str]":
        """Every worker's in-memory log ring merged by timestamp (the
        k-way merge keeps each worker's own order even under clock
        skew), each record tagged with its instance."""
        raw_limit = (query or {}).get("limit", [""])[0]
        try:
            limit = max(1, int(raw_limit)) if raw_limit else _MAX_LOG_RECORDS
        except ValueError:
            limit = _MAX_LOG_RECORDS
        payloads, errors = self._split(self.fanout("/debug/logs"))
        merged = merge_ring_records(
            {
                instance: payload.get("records") or []
                for instance, payload in payloads.items()
            },
            limit=limit,
        )
        payload: dict = {"records": merged}
        if errors:
            payload["errors"] = errors
        return _json_body(payload)

    def debug_incidents(self) -> "tuple[int, bytes, str]":
        """The fleet incident index: every worker's listing plus the
        supervisor's own bundles (cross-worker captures included)
        under the ``fleet`` instance, each entry tagged with its
        owner so fetch-by-id routes there."""
        payloads, errors = self._split(self.fanout("/debug/incidents"))
        indexes = {
            instance: payload.get("incidents") or []
            for instance, payload in payloads.items()
        }
        indexes["fleet"] = incident.RECORDER.list_incidents()
        payload: dict = {"incidents": incident.merge_incident_indexes(indexes)}
        if errors:
            payload["errors"] = errors
        return _json_body(payload)

    def debug_incident(self, bundle_id: str) -> "tuple[int, bytes, str]":
        """Fetch-by-id routed to the owning worker: the supervisor's
        own store answers first (fleet bundles live there), then the
        workers are asked concurrently and the holder's copy is
        served, tagged with its instance."""
        local = incident.RECORDER.get(bundle_id)
        if local is not None:
            return _json_body({"instance": "fleet", **local})
        results = self.fanout(
            f"/debug/incidents/{urllib.parse.quote(bundle_id)}"
        )
        payloads, errors = self._split(results)
        for instance in sorted(payloads):
            return _json_body({"instance": instance, **payloads[instance]})
        scrape_errors = {
            instance: reason
            for instance, reason in errors.items()
            if not reason.startswith("HTTP 404")
        }
        if scrape_errors:
            # a worker we could not reach may OWN the bundle: a flat
            # 404 would claim an existing incident does not exist —
            # degrade honestly, naming the unreachable workers
            code, body, _ = _json_body(
                {
                    "error": "owning worker may be unreachable",
                    "errors": scrape_errors,
                }
            )
            return 503, body, "application/json"
        return 404, b"no such incident\n", "text/plain"

    def debug_profile(
        self, query: "dict | None" = None
    ) -> "tuple[int, bytes, str]":
        """The fleet flamegraph: every worker's folded stacks for
        ``mode`` (cpu|wait|heap) summed into one profile — identical
        stacks add, so the merged total is the fleet's total — while
        the JSON view keeps the role × instance attribution each
        worker reported. ``role=``/``window=`` filters pass through
        to the workers."""
        query = query or {}
        mode = query.get("mode", ["cpu"])[0]
        if mode not in ("cpu", "wait", "heap"):
            return 400, b"mode must be cpu|wait|heap\n", "text/plain"
        fmt = query.get("format", ["collapsed"])[0]
        if fmt not in ("collapsed", "svg", "json"):
            return 400, b"format must be collapsed|svg|json\n", "text/plain"
        role = query.get("role", [""])[0]
        window = query.get("window", [""])[0]
        worker_query = {"mode": mode, "format": "json"}
        if role:
            worker_query["role"] = role
        if window:
            worker_query["window"] = window
        path = "/debug/profile?" + urllib.parse.urlencode(worker_query)
        payloads, errors = self._split(self.fanout(path))
        stacks = profiling.merge_folded(
            {
                instance: payload.get("stacks") or {}
                for instance, payload in payloads.items()
            }
        )
        if fmt == "svg":
            title = f"fleet {mode} profile"
            if role:
                title += f" role={role}"
            if window:
                title += f" window={window}s"
            return (
                200,
                profiling.flamegraph_svg(stacks, title).encode(),
                "image/svg+xml",
            )
        if fmt == "json":
            payload = {
                "mode": mode,
                "role": role or None,
                "window_s": window or None,
                "instances": {
                    instance: {
                        "attribution": worker.get("attribution"),
                        "profiler": worker.get("profiler"),
                    }
                    for instance, worker in sorted(payloads.items())
                },
                "stacks": {
                    stack: stacks[stack]
                    for stack in sorted(stacks, key=lambda s: -stacks[s])[
                        :_MAX_JSON_STACKS
                    ]
                },
            }
            if errors:
                payload["errors"] = errors
            return _json_body(payload)
        lines = [
            f"{stack} {count}"
            for stack, count in sorted(
                stacks.items(), key=lambda kv: (-kv[1], kv[0])
            )
        ]
        return (
            200,
            ("\n".join(lines) + "\n").encode() if lines else b"\n",
            "text/plain",
        )

    def debug_tsdb(
        self, query: "dict | None" = None
    ) -> "tuple[int, bytes, str]":
        """Fleet-wide series aggregation: counter rates SUM across
        instances (the fleet's rate is by definition the sum of its
        members'), histogram windows sum their cumulative bucket
        deltas and re-derive true fleet percentiles, gauges sum their
        levels — always with the per-instance breakdown beside the
        fleet number, because 'which worker' is the next question."""
        query = query or {}
        name = query.get("name", [""])[0]
        if not name:
            payloads, errors = self._split(self.fanout("/debug/tsdb"))
            payload = {"instances": payloads}
            if errors:
                payload["errors"] = errors
            return _json_body(payload)
        window = query.get("window", ["300"])[0]
        path = (
            f"/debug/tsdb?name={urllib.parse.quote(name)}"
            f"&window={urllib.parse.quote(window)}"
        )
        payloads, errors = self._split(self.fanout(path))
        if not payloads:
            return 404, b"no worker serves that series\n", "text/plain"
        kinds = {p.get("kind") for p in payloads.values() if p.get("kind")}
        kind = sorted(kinds)[0] if kinds else "counter"
        out: dict = {
            "name": name,
            "kind": kind,
            "window_s": next(iter(payloads.values())).get("window_s"),
            "instances": dict(sorted(payloads.items())),
        }
        if kind == "counter":
            rates = {
                instance: payload.get("rate_per_s")
                for instance, payload in sorted(payloads.items())
            }
            measured = [r for r in rates.values() if r is not None]
            out["rates"] = rates
            out["rate_per_s"] = sum(measured) if measured else None
        elif kind == "histogram":
            bounds: "tuple[float, ...] | None" = None
            summed: "list[int] | None" = None
            total_sum = 0.0
            total_count = 0
            per_instance: dict = {}
            for instance, payload in sorted(payloads.items()):
                window_part = payload.get("window") or {}
                per_instance[instance] = {
                    "count": window_part.get("count"),
                    "p99": window_part.get("p99"),
                }
                buckets = window_part.get("buckets")
                le = payload.get("le")
                if not buckets or not le:
                    continue
                if bounds is None:
                    bounds = tuple(float(b) for b in le)
                    summed = [0] * len(bounds)
                if len(buckets) != len(summed or ()):
                    continue  # mismatched layout costs its worker
                assert summed is not None
                for i, value in enumerate(buckets):
                    summed[i] += int(value)
                total_sum += float(window_part.get("sum") or 0.0)
                total_count += int(window_part.get("count") or 0)
            out["per_instance"] = per_instance
            if bounds is not None and summed is not None and total_count:
                out["window"] = {
                    "count": total_count,
                    "sum": round(total_sum, 6),
                    "p50": tsdb.quantile(bounds, summed, total_count, 0.50),
                    "p95": tsdb.quantile(bounds, summed, total_count, 0.95),
                    "p99": tsdb.quantile(bounds, summed, total_count, 0.99),
                    "buckets": summed,
                }
        else:  # gauge
            values = {
                instance: (
                    (payload.get("points") or [{}])[-1].get("value")
                )
                for instance, payload in sorted(payloads.items())
            }
            measured = [v for v in values.values() if v is not None]
            out["values"] = values
            out["total"] = sum(measured) if measured else None
        if errors:
            out["errors"] = errors
        return _json_body(out)

    def debug_alerts(self) -> "tuple[int, bytes, str]":
        """The fleet alert view: the supervisor's own engine (fleet
        burn + outlier + supervisor rules) beside every worker's local
        engine snapshot."""
        engine = self._engine if self._engine is not None else alerts.ENGINE
        payloads, errors = self._split(self.fanout("/debug/alerts"))
        payload: dict = {
            "fleet": engine.snapshot(),
            "instances": dict(sorted(payloads.items())),
        }
        if errors:
            payload["errors"] = errors
        return _json_body(payload)

    def debug_flows(
        self, query: "dict | None" = None
    ) -> "tuple[int, bytes, str]":
        """The fleet flow ledger: every worker's ``/debug/flows``
        snapshot folded through ``flows.merge_flow_snapshots`` — fleet
        amplification is fleet ingress over fleet UNIQUE bytes (each
        object's unique contribution MAXed across the workers that
        materialized it), never an average of per-worker ratios, and
        the heavy-hitter sketches merge exactly (union + summed
        estimates), so the fleet's hottest objects are named even when
        no single worker saw them dominate."""
        raw = (query or {}).get("hitters", [""])[0]
        try:
            hitters = max(1, int(raw)) if raw else 16
        except ValueError:
            hitters = 16
        payloads, errors = self._split(
            self.fanout(f"/debug/flows?hitters={hitters}")
        )
        payload = flows.merge_flow_snapshots(payloads)
        payload["heavy_hitters"] = payload["sketch"]["items"][:hitters]
        if errors:
            payload["errors"] = errors
        return _json_body(payload)

    def debug_critpath(
        self, query: "dict | None" = None
    ) -> "tuple[int, bytes, str]":
        """The fleet latency waterfall: per-job gating chains from
        every worker combined (instance-tagged) and the "where does
        p99 live" aggregation RECOMPUTED over the merged population —
        the fleet p99 comes from the combined duration distribution,
        never from averaging per-worker p99s."""
        payloads, errors = self._split(self.fanout("/debug/critpath"))
        payload = flows.merge_critpath_payloads(payloads)
        if errors:
            payload["errors"] = errors
        return _json_body(payload)

    def debug_passthrough(self, path: str) -> "tuple[int, bytes, str]":
        """Per-instance passthrough for the views with no cross-worker
        merge semantics (watchdog, admission, jobs): one fan-out, each
        worker's JSON under its instance."""
        payloads, errors = self._split(self.fanout(path))
        payload: dict = {"instances": dict(sorted(payloads.items()))}
        if errors:
            payload["errors"] = errors
        return _json_body(payload)

    def debug_canary(self) -> "tuple[int, bytes, str]":
        """The fleet-merged canary scorecard: every worker's last-N
        probe verdicts under its instance plus the failing roster — the
        view a firing fleet canary rule points the operator at."""
        payloads, errors = self._split(self.fanout("/debug/canary"))
        failing = sorted(
            instance
            for instance, payload in payloads.items()
            if isinstance(payload, dict) and payload.get("failing")
        )
        payload: dict = {
            "instances": dict(sorted(payloads.items())),
            "failing": failing,
        }
        if errors:
            payload["errors"] = errors
        return _json_body(payload)

    # -- cross-worker incident capture -------------------------------------

    def capture_fleet_incident(
        self,
        reason: str,
        rule=None,
        trigger: str = "fleet-alert",
        extra: "dict | None" = None,
    ) -> "dict | None":
        """One fleet incident id over every worker's snapshot: POST
        ``/debug/incident`` fans out, each returned bundle is fetched
        back from its owner, and the supervisor's flight recorder
        persists the lot under one bundle (rate-limited like every
        automatic trigger; returns None when suppressed)."""
        posts = self.fanout("/debug/incident", method="POST")
        workers: dict = {}
        for instance, entry in sorted(posts.items()):
            payload = self._parse_json(entry)
            if payload is None:
                workers[instance] = {
                    "error": entry.get("error", "capture failed")
                }
                continue
            bundle_id = payload.get("id")
            bundle = None
            if bundle_id:
                fetched = self.fetch_one(
                    instance,
                    f"/debug/incidents/{urllib.parse.quote(bundle_id)}",
                )
                bundle = self._parse_json(fetched)
            workers[instance] = bundle if bundle is not None else payload
        meta: dict = {"fleet": True, "workers": workers}
        if rule is not None:
            meta["rule"] = rule.name
            meta["series"] = rule.series
            meta["severity"] = rule.severity
            meta["detail"] = dict(rule.last_detail)
        if extra:
            meta.update(extra)
        bundle = incident.RECORDER.capture(reason, trigger=trigger, extra=meta)
        if bundle is not None:
            metrics.GLOBAL.add("fleet_incidents")
        return bundle

    def alert_fired(self, rule) -> None:
        """The AlertEngine ``on_fire`` hand-off: capture the
        cross-worker bundle on its own thread — whatever is burning
        the fleet's SLO must not wedge the evaluator behind N worker
        round trips."""

        def _capture() -> None:
            try:
                self.capture_fleet_incident(
                    f"fleet alert '{rule.name}' firing ({rule.series})",
                    rule=rule,
                )
            except Exception as exc:
                log.with_fields(rule=rule.name).warning(
                    f"fleet incident capture failed: {exc}"
                )

        try:
            thread = threading.Thread(  # thread-role: fleet-incident
                target=_capture, name="fleet-incident", daemon=True
            )
            thread.start()
            profiling.ROLES.register_thread(thread, "fleet-incident")
        except RuntimeError:
            _capture()  # thread exhaustion: keep the evidence anyway


# ---------------------------------------------------------------------------
# the TSDB collector feeding fleet-level alerting


class FleetAggregator:
    """Parses every worker's ``/metrics`` exposition on each
    supervisor TSDB tick and records the per-class SLO histograms
    fleet-summed AND per-instance, so the supervisor's burn rules
    watch the fleet's error budget and the outlier rule can name the
    instance whose p99 left the pack. Worker exemplars ride along
    from ``/debug/exemplars`` — a firing fleet burn alert links
    straight to example traces on the worker that recorded them."""

    def __init__(
        self,
        plane: FleetQueryPlane,
        store: "tsdb.TimeSeriesStore | None" = None,
    ):
        self._plane = plane
        self._store = store if store is not None else tsdb.STORE
        self._lock = threading.Lock()
        self._instances: "list[str]" = []  # guarded-by: _lock
        self._exemplars: "dict[str, list[dict]]" = {}  # guarded-by: _lock
        # the fleet series must be MONOTONIC: summing the live workers'
        # cumulative histograms would DROP when a worker dies (and the
        # tsdb window's >=0 clamp would then read delta 0 across the
        # very SIGKILL window the burn rules exist to page on), so we
        # accumulate per-instance INCREASES into running totals instead.
        # _prev holds each (instance, family)'s last snapshot; _totals
        # only ever grows.
        self._prev: "dict[tuple[str, str], tuple]" = {}  # guarded-by: _lock
        self._totals: "dict[str, list]" = {}  # guarded-by: _lock
        # each live instance's last-scraped canary_failing gauge — the
        # fleet canary rule's provider input
        self._canary: "dict[str, float]" = {}  # guarded-by: _lock

    def collect(self) -> "list":
        """The TSDB collector: fan out over worker ``/metrics`` (and
        ``/debug/exemplars``, concurrently — two sequential fan-outs
        would cost the scrape tick two wedged-worker slices), returning
        histogram entries in the registry-snapshot shape the store's
        scrape loop records."""
        # one-element holders, assigned WHOLESALE by their threads: a
        # straggling fan-out past the join deadline must never mutate
        # a dict the main path is iterating
        exemplar_holder: "list[dict[str, dict]]" = [{}]
        flow_holder: "list[dict[str, dict]]" = [{}]

        def fetch_exemplars() -> None:
            try:
                exemplar_holder[0] = self._plane.fanout("/debug/exemplars")
            except Exception as exc:
                # exemplars are garnish: their fan-out failing costs
                # this tick's exemplars, never the histogram fold
                log.debug(f"exemplar fan-out failed: {exc}")

        def fetch_flows() -> None:
            try:
                flow_holder[0] = self._plane.fanout("/debug/flows")
            except Exception as exc:
                # same garnish contract as exemplars: a failed flow
                # fan-out costs this tick's fleet flow gauges only
                log.debug(f"flow fan-out failed: {exc}")

        side_threads = []
        for name, target in (
            ("fleet-exemplars", fetch_exemplars),
            ("fleet-flows", fetch_flows),
        ):
            thread = threading.Thread(  # thread-role: fleet-scraper
                target=target, name=name, daemon=True
            )
            thread.start()
            profiling.ROLES.register_thread(thread, "fleet-scraper")
            side_threads.append(thread)
        results = self._plane.fanout("/metrics")
        # deadline: each side fan-out is itself bounded by the plane's per-worker scrape timeout + join grace
        deadline = time.monotonic() + self._plane.timeout_s + 2 * _JOIN_GRACE_S
        for thread in side_threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        batch: list = []
        live: "list[str]" = []
        canary_values: "dict[str, float]" = {}
        with self._lock:
            for instance, entry in sorted(results.items()):
                if not entry.get("ok"):
                    continue
                try:
                    text = entry["body"].decode(errors="replace")
                except KeyError:
                    continue
                histograms = parse_exposition_histograms(text)
                live.append(instance)
                canary_match = _CANARY_GAUGE_RE.search(text)
                if canary_match:
                    try:
                        canary_values[instance] = float(
                            canary_match.group(1)
                        )
                    except ValueError:
                        pass
                for name, snapshot in histograms.items():
                    bounds, counts, total, count = snapshot
                    if not bounds:
                        continue
                    batch.append(
                        (
                            instance_series(name, instance),
                            "histogram",
                            (bounds, (counts, total, count)),
                        )
                    )
                    self._fold_increase(instance, name, snapshot)
            for name, (bounds, counts, total, count) in sorted(
                self._totals.items()
            ):
                batch.append(
                    (
                        fleet_series(name),
                        "histogram",
                        (bounds, (tuple(counts), total, count)),
                    )
                )
            self._instances = live
            self._exemplars = self._merge_exemplars(exemplar_holder[0])
            self._canary = canary_values
        if canary_values:
            # the fleet gauge is the WORST instance: any failing worker
            # makes the fleet canary signal red
            batch.append(
                (
                    fleet_series("canary_failing"),
                    "gauge",
                    max(canary_values.values()),
                )
            )
        # fleet flow gauges: fold the workers' flow snapshots with the
        # one correct merge (summed bytes over MAXed unique bytes —
        # utils/flows.py) and record the RATIOS as supervisor gauges;
        # the fleet amplification/concentration rules threshold these
        flow_payloads, _ = self._plane._split(flow_holder[0])
        if flow_payloads:
            merged = flows.merge_flow_snapshots(flow_payloads)
            batch.append(
                (
                    fleet_series("flow_origin_amplification"),
                    "gauge",
                    float(merged["origin_amplification"]),
                )
            )
            batch.append(
                (
                    fleet_series("flow_hot_object_share"),
                    "gauge",
                    float(merged["hot_object_share"]),
                )
            )
        return batch

    def _fold_increase(  # holds: _lock
        self, instance: str, name: str, snapshot: tuple
    ) -> None:
        """Add one instance's increase since its previous snapshot into
        the monotonic fleet totals (caller holds ``_lock``). A restarted
        worker's counters reset to ~zero: a shrunken count means the
        previous baseline is gone with the old process, so the fresh
        snapshot counts in full (its pre-restart tail died unreported —
        unavoidable, and never negative)."""
        bounds, counts, total, count = snapshot
        key = (instance, name)
        previous = self._prev.get(key)
        if (
            previous is None
            or len(previous[1]) != len(counts)
            or previous[3] > count
        ):
            previous = (bounds, (0,) * len(counts), 0.0, 0)
        delta_counts = [
            max(0, new - old) for new, old in zip(counts, previous[1])
        ]
        delta_total = max(0.0, total - previous[2])
        delta_count = max(0, count - previous[3])
        self._prev[key] = snapshot
        totals = self._totals.get(name)
        if totals is None or len(totals[1]) != len(counts):
            self._totals[name] = [bounds, delta_counts, delta_total,
                                  delta_count]
            return
        for i, value in enumerate(delta_counts):
            totals[1][i] += value
        totals[2] += delta_total
        totals[3] += delta_count

    @staticmethod
    def _merge_exemplars(
        results: "dict[str, dict]",
    ) -> "dict[str, list[dict]]":
        merged: "dict[str, list[dict]]" = {}
        for instance, entry in sorted(results.items()):
            payload = FleetQueryPlane._parse_json(entry)
            if payload is None:
                continue
            for name, entries in (payload.get("exemplars") or {}).items():
                for exemplar in entries:
                    merged.setdefault(name, []).append(
                        {**exemplar, "instance": instance}
                    )
        for entries in merged.values():
            entries.sort(key=lambda e: e.get("ts", 0.0))
        return merged

    def instances(self) -> "list[str]":
        with self._lock:
            return list(self._instances)

    def exemplars_for(self, series: str) -> "list[dict]":
        """The AlertEngine exemplar source: ``fleet:<name>`` (or a
        per-instance ``fleet:<name>:<inst>``) maps back to the worker
        family whose instance-tagged exemplars were merged on the
        last collect."""
        base = series
        if base.startswith("fleet:"):
            parts = base.split(":")
            base = parts[1] if len(parts) > 1 else base
        with self._lock:
            return list(self._exemplars.get(base, ()))

    def canary_by_instance(self) -> "dict[str, float]":
        """The fleet canary rule's provider: each live instance's
        last-scraped ``canary_failing`` gauge."""
        with self._lock:
            return dict(self._canary)

    def p99_by_instance(
        self, window_s: float, now: "float | None" = None
    ) -> "dict[str, float | None]":
        """Each instance's worst windowed SLO p99 across the
        aggregated classes — the worker-outlier rule's input. None for
        an instance with no in-window completions (idle is not an
        outlier)."""
        out: "dict[str, float | None]" = {}
        for instance in self.instances():
            worst: "float | None" = None
            for name in AGGREGATED_HISTOGRAMS:
                window = self._store.histogram_window(
                    instance_series(name, instance),
                    window_s,
                    now,
                    min_samples=2,
                )
                if window is None:
                    continue
                bounds, cumulative, _, count = window
                if count <= 0:
                    continue
                p99 = tsdb.quantile(bounds, cumulative, count, 0.99)
                if p99 is not None and (worst is None or p99 > worst):
                    worst = p99
            out[instance] = worst
        return out


class FleetCanaryRule(alerts.AlertRule):
    """The fleet twin of the worker ``canary-failure`` rule, and the
    one that NAMES the sick instance: ``provider()`` returns each live
    worker's ``canary_failing`` gauge; the rule fires while ANY
    instance reports failing. Not a :class:`alerts.WorkerOutlierRule`
    deliberately — median-of-peers semantics would stay silent when
    every instance fails at once (a broken store corrupts all of them
    equally), which is exactly the page this rule exists for."""

    kind = "fleet-canary"

    def __init__(self, name: str, series: str, provider, **kwargs):
        super().__init__(name, series, **kwargs)
        self._provider = provider

    def _condition(self, view, now: float):
        raw = self._provider() or {}
        values = {
            instance: value
            for instance, value in raw.items()
            if value is not None
        }
        failing = sorted(
            instance
            for instance, value in values.items()
            if value >= 1.0
        )
        detail: dict = {
            "values": {
                instance: round(value, 4)
                for instance, value in sorted(values.items())
            },
            "failing": failing,
        }
        if not failing:
            # no reporting instance is red — including the no-data
            # case: a scrape gap must not page as a canary failure
            return False, detail
        detail["instance"] = failing[0]
        return True, detail


def fleet_alert_rules(
    aggregator: FleetAggregator,
    slo_interactive_s: float = alerts.DEFAULT_SLO_INTERACTIVE_S,
    slo_bulk_s: float = alerts.DEFAULT_SLO_BULK_S,
    objective: float = alerts.DEFAULT_OBJECTIVE,
    fast_window_s: float = alerts.DEFAULT_FAST_WINDOW_S,
    slow_window_s: float = alerts.DEFAULT_SLOW_WINDOW_S,
    factor: float = alerts.DEFAULT_BURN_FACTOR,
    outlier_ratio: float = DEFAULT_OUTLIER_RATIO,
) -> "list[alerts.AlertRule]":
    """The fleet-level rule set the supervisor runs ON TOP of
    ``alerts.fleet_rules()``: burn over the fleet-summed SLO
    histograms (a fleet whose members each burn 60% of the page
    threshold IS burning, which no per-worker rule can see) plus the
    worker-outlier rule that names the instance."""
    return [
        alerts.BurnRateRule(
            "fleet-interactive-latency-burn",
            fleet_series("slo_job_duration_seconds_interactive"),
            target_s=slo_interactive_s,
            objective=objective,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
            factor=factor,
            seed_registry=False,
            description=(
                "the FLEET-summed interactive SLO histogram is burning "
                "its error budget (aggregated across every worker)"
            ),
        ),
        alerts.BurnRateRule(
            "fleet-bulk-latency-burn",
            fleet_series("slo_job_duration_seconds_bulk"),
            target_s=slo_bulk_s,
            objective=objective,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
            factor=factor,
            seed_registry=False,
            severity="ticket",
            description=(
                "the FLEET-summed bulk SLO histogram is burning its "
                "(looser) budget"
            ),
        ),
        alerts.WorkerOutlierRule(
            "fleet-worker-latency-outlier",
            fleet_series("slo_job_duration_seconds"),
            provider=lambda: aggregator.p99_by_instance(fast_window_s),
            ratio=outlier_ratio,
            description=(
                "one worker's windowed SLO p99 sits far above the fleet "
                "median — the detail names the instance"
            ),
        ),
        alerts.ThresholdRule(
            "fleet-origin-amplification-burn",
            fleet_series("flow_origin_amplification"),
            threshold=flows.amplification_alert_from_env(),
            for_s=alerts.AMPLIFICATION_BURN_FOR_S,
            description=(
                "the FLEET is fetching far more origin bytes than the "
                "unique bytes it serves (ratio from summed bytes, not "
                "averaged worker ratios — N cold workers each looking "
                "fine IS the amplification this rule pages on)"
            ),
        ),
        alerts.ThresholdRule(
            "fleet-hot-object-concentration",
            fleet_series("flow_hot_object_share"),
            threshold=flows.hot_share_alert_from_env(),
            severity="ticket",
            description=(
                "one object dominates fleet-wide ingress (merged "
                "heavy-hitter sketches) — a flash crowd concentrating "
                "on a single key"
            ),
        ),
        FleetCanaryRule(
            "fleet-canary-failure",
            fleet_series("canary_failing"),
            provider=aggregator.canary_by_instance,
            description=(
                "a worker's synthetic canary probe failed outside-in "
                "verification — the detail names the failing "
                "instance(s); /debug/canary has the per-stage verdicts"
            ),
        ),
    ]
