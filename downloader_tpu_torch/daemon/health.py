"""Health and metrics endpoint.

The reference has no health endpoint and no metrics — logging only
(SURVEY.md §5 "Metrics / logging / observability"); this is one of the
rebuild's deliberate additions (SURVEY.md §7 step 9). A tiny stdlib HTTP
server exposes:

- ``GET /healthz`` — JSON liveness: daemon worker count, broker
  connection state, in-flight/processed counters. 200 when the broker
  connection is up, 503 when it is down (so an orchestrator can restart
  a wedged instance).
- ``GET /metrics`` — Prometheus text exposition of the daemon and queue
  counters (no client library needed; the format is plain text).
- ``GET /debug/jobs`` — per-job span trees (utils/tracing.py): the ring
  of recently completed jobs plus a live in-flight view, so "where did
  this job's time go" is answerable from a running daemon without a
  profiler. ``GET /debug/trace`` serves the same data as Chrome
  trace-event JSON (load in chrome://tracing or Perfetto).
- ``GET /debug/watchdog`` — the stall watchdog's live registry
  (utils/watchdog.py): per watched job/loop, the active stage, its
  idle seconds against the deadline, and progress counters.
- ``GET /debug/logs`` — the in-memory structured-log ring
  (utils/logging.py) with job/trace correlation fields.
- ``GET /debug/incidents`` — captured incident bundles
  (utils/incident.py); ``/debug/incidents/<id>`` serves one bundle.
  ``POST /debug/incident`` captures a bundle on demand.
- ``GET /debug/tsdb`` — the local time-series store (utils/tsdb.py):
  store snapshot, or ``?name=&window=`` for one series' windowed
  points, counter rates, and histogram quantile estimates.
- ``GET /debug/alerts`` — the alert engine's rules, states, and recent
  transitions (utils/alerts.py). ``GET /debug/trace?trace_id=`` links
  every attempt of one logical job into a single lineage view.
- ``GET /debug/profile`` — the continuous profiling plane
  (utils/profiling.py): collapsed-stack text (default), a
  self-contained SVG flamegraph (``format=svg``), or JSON with
  role attribution (``format=json``); ``mode=cpu|wait|heap`` picks
  on-CPU samples, off-CPU waits (lock/io/queue, named locks
  included), or tracemalloc allocation sites; ``role=`` filters to
  one thread role, ``window=`` seconds bounds the sample window.
- ``GET /debug/exemplars`` — recent trace-id exemplars per histogram
  family (utils/metrics.py): the metric→trace back-link, scraped by
  the fleet supervisor's aggregator so a FLEET-level burn alert links
  to example traces on the worker that recorded them.
- ``GET /metrics/federate`` — this worker's exposition merged with
  every registered child-worker source, per-sample ``instance``
  labels (the fleet-aggregation groundwork).

The fleet supervisor's ``FleetHealthServer`` (daemon/fleet.py) serves
the same ``/debug/*`` paths FLEET-scoped: each one fans out to every
ready worker's health port and merges with instance attribution
(daemon/fleetplane.py).

The server is a ``ThreadingHTTPServer`` (daemon threads) on purpose: a
slow ``/debug/trace`` serialization or a fat incident bundle must
never block the ``/healthz`` liveness probe an orchestrator restarts
on — tests pin this by answering /healthz while another handler is
deliberately wedged.

Enabled by ``HEALTH_PORT`` (0 = disabled, the default); binds loopback
unless ``HEALTH_HOST`` says otherwise.
"""

from __future__ import annotations

import http.server
import json
import re
import threading
import urllib.parse

from ..utils import (
    admission, alerts, flows, get_logger, incident, metrics, profiling,
    tracing, tsdb, watchdog,
)
from ..utils.logging import ring_tail

log = get_logger("daemon.health")


class HealthServer:
    def __init__(self, daemon, client, port: int, host: str = "127.0.0.1"):
        self._daemon = daemon
        self._client = client
        health = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                # ThreadingHTTPServer runs each request on its own
                # short-lived thread; claim the role here so a sampled
                # mid-request handler attributes to health-server
                profiling.ROLES.register_current("health-server")
                try:
                    parsed = urllib.parse.urlsplit(self.path)
                    path = parsed.path
                    query = urllib.parse.parse_qs(parsed.query)
                    if path == "/healthz":
                        code, body, ctype = health._healthz()
                    elif path == "/readyz":
                        code, body, ctype = health._readyz()
                    elif path == "/debug/canary":
                        code, body, ctype = health._debug_canary()
                    elif path == "/metrics":
                        code, body, ctype = health._metrics()
                    elif path == "/metrics/federate":
                        code, body, ctype = health._metrics_federate()
                    elif path == "/debug/jobs":
                        code, body, ctype = health._debug_jobs()
                    elif path == "/debug/trace":
                        code, body, ctype = health._debug_trace(query)
                    elif path == "/debug/tsdb":
                        code, body, ctype = health._debug_tsdb(query)
                    elif path == "/debug/alerts":
                        code, body, ctype = health._debug_alerts()
                    elif path == "/debug/profile":
                        code, body, ctype = health._debug_profile(query)
                    elif path == "/debug/watchdog":
                        code, body, ctype = health._debug_watchdog()
                    elif path == "/debug/admission":
                        code, body, ctype = health._debug_admission()
                    elif path == "/debug/logs":
                        code, body, ctype = health._debug_logs()
                    elif path == "/debug/exemplars":
                        code, body, ctype = health._debug_exemplars()
                    elif path == "/debug/flows":
                        code, body, ctype = health._debug_flows(query)
                    elif path == "/debug/cache":
                        code, body, ctype = health._debug_cache()
                    elif path == "/debug/critpath":
                        code, body, ctype = health._debug_critpath()
                    elif path == "/debug/incidents":
                        code, body, ctype = health._debug_incidents()
                    elif path.startswith("/debug/incidents/"):
                        code, body, ctype = health._debug_incident(
                            path[len("/debug/incidents/"):]
                        )
                    else:
                        code, body, ctype = 404, b"not found\n", "text/plain"
                except Exception as exc:  # a view bug must answer, not abort
                    log.error("health view failed", exc=exc)
                    code, body, ctype = (
                        500, b"internal error\n", "text/plain"
                    )
                self._reply(code, body, ctype)

            def do_POST(self):
                profiling.ROLES.register_current("health-server")
                try:
                    if self.path == "/debug/incident":
                        code, body, ctype = health._capture_incident()
                    elif self.path == "/debug/canary/probe":
                        code, body, ctype = health._trigger_probe()
                    else:
                        code, body, ctype = 404, b"not found\n", "text/plain"
                except Exception as exc:
                    log.error("health view failed", exc=exc)
                    code, body, ctype = (
                        500, b"internal error\n", "text/plain"
                    )
                self._reply(code, body, ctype)

            def _reply(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(  # thread-role: health-server
            target=self._httpd.serve_forever, name="health", daemon=True
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "HealthServer":
        self._thread.start()
        profiling.ROLES.register_thread(self._thread, "health-server")
        log.with_field("port", self.port).info("health endpoint listening")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()  # release the listening socket now

    # -- views -----------------------------------------------------------

    def _connected(self) -> bool:
        return bool(self._client.connected())

    def _counters(self) -> dict:
        stats = self._daemon.stats
        queue_stats = self._client.stats
        return {
            "jobs_processed": stats.processed,
            "jobs_failed": stats.failed,
            "jobs_retried": stats.retried,
            "jobs_dropped": stats.dropped,
            "jobs_shed": stats.shed,
            "queue_published": queue_stats.published,
            "queue_delivered": queue_stats.delivered,
            "queue_publish_retries": queue_stats.publish_retries,
            "queue_reconnects": queue_stats.reconnects,
            "queue_consumer_errors": queue_stats.consumer_errors,
            # transfer-layer totals (http/torrent/dht/s3) accrue in the
            # process-wide registry — per-job objects are ephemeral
            **dict(sorted(metrics.GLOBAL.snapshot().items())),
        }

    def _healthz(self) -> tuple[int, bytes, str]:
        connected = self._connected()
        payload = {
            "status": "ok" if connected else "degraded",
            "broker_connected": connected,
            "workers": self._daemon.worker_count,
            **self._counters(),
        }
        code = 200 if connected else 503
        return code, (json.dumps(payload) + "\n").encode(), "application/json"

    def _readyz(self) -> tuple[int, bytes, str]:
        """Readiness, distinct from liveness: /healthz answers "is the
        process up", /readyz answers "may traffic be routed here" —
        ready only once run() has the queue consume established and
        (when configured) the cache plane attached."""
        consume = bool(getattr(self._daemon, "ready", None))
        consume = consume and self._daemon.ready.is_set()
        data_plane = bool(
            getattr(self._daemon, "data_plane_attached", True)
        )
        ready = consume and data_plane
        payload = {
            "ready": ready,
            "consume": consume,
            "data_plane": data_plane,
        }
        code = 200 if ready else 503
        return code, (json.dumps(payload) + "\n").encode(), "application/json"

    def _debug_canary(self) -> tuple[int, bytes, str]:
        """The canary scorecard: last-N probe verdicts per stage from
        the live prober (404 when the plane is off — CANARY=0)."""
        from ..utils import canary

        prober = canary.ACTIVE
        if prober is None:
            return (
                404,
                b'{"error": "canary plane disabled"}\n',
                "application/json",
            )
        return (
            200,
            (json.dumps(prober.scorecard(), indent=1) + "\n").encode(),
            "application/json",
        )

    def _trigger_probe(self) -> tuple[int, bytes, str]:
        """POST /debug/canary/probe: one immediate probe pair — the
        fleet scheduler's round-robin lane. Returns without waiting
        for the verdict (it lands in the scorecard)."""
        from ..utils import canary

        prober = canary.ACTIVE
        if prober is None:
            return (
                404,
                b'{"error": "canary plane disabled"}\n',
                "application/json",
            )
        prober.trigger()
        return 200, b'{"triggered": true}\n', "application/json"

    def _debug_jobs(self) -> tuple[int, bytes, str]:
        payload = {
            "tracing_enabled": tracing.TRACER.enabled,
            "in_flight": tracing.TRACER.in_flight(),
            "recent": tracing.TRACER.recent(),
        }
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_trace(self, query: dict | None = None) -> tuple[int, bytes, str]:
        # ?trace_id= serves the cross-attempt lineage view: every
        # attempt of one logical job (propagated X-Trace-Context),
        # ordered, each with its parent-span back-link — the linked
        # tree a retried/shed job's post-mortem walks. Without it the
        # Chrome export groups attempts under per-trace-id pids.
        trace_id = (query or {}).get("trace_id", [""])[0]
        if trace_id:
            attempts = tracing.TRACER.lineage(trace_id)
            payload = {"trace_id": trace_id, "attempts": attempts}
            return (
                200,
                (json.dumps(payload, indent=1) + "\n").encode(),
                "application/json",
            )
        return (
            200,
            (json.dumps(tracing.TRACER.chrome_trace()) + "\n").encode(),
            "application/json",
        )

    def _debug_tsdb(self, query: dict | None = None) -> tuple[int, bytes, str]:
        """The local time-series store: without ``name``, the store
        snapshot (what series exist, cadence, depth); with ``name`` (+
        optional ``window`` seconds), that series' in-window points and
        derived rate/quantiles."""
        query = query or {}
        name = query.get("name", [""])[0]
        if not name:
            payload = tsdb.STORE.snapshot()
            return (
                200,
                (json.dumps(payload, indent=1) + "\n").encode(),
                "application/json",
            )
        try:
            window = float(query.get("window", ["300"])[0])
        except ValueError:
            window = 300.0
        payload = tsdb.STORE.query(name, max(1.0, window))
        if payload is None:
            return 404, b"no such series\n", "text/plain"
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_alerts(self) -> tuple[int, bytes, str]:
        payload = alerts.ENGINE.snapshot()
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_profile(
        self, query: dict | None = None
    ) -> tuple[int, bytes, str]:
        """The profiling plane's flamegraph/collapsed-stack view:
        ``mode=cpu|wait|heap`` (+ ``role=``, ``window=`` seconds),
        rendered as collapsed-stack text (default), a self-contained
        SVG flamegraph (``format=svg``), or JSON carrying the plane
        snapshot, role attribution, and the aggregated stacks."""
        query = query or {}
        mode = query.get("mode", ["cpu"])[0]
        if mode not in ("cpu", "wait", "heap"):
            return 400, b"mode must be cpu|wait|heap\n", "text/plain"
        fmt = query.get("format", ["collapsed"])[0]
        if fmt not in ("collapsed", "svg", "json"):
            return (
                400, b"format must be collapsed|svg|json\n", "text/plain"
            )
        role = query.get("role", [""])[0] or None
        window = None
        raw_window = query.get("window", [""])[0]
        if raw_window:
            try:
                window = max(1.0, float(raw_window))
            except ValueError:
                return 400, b"window must be seconds\n", "text/plain"
        profiler = profiling.PROFILER
        stacks = profiler.collapsed(
            mode=mode, role=role, window_s=window
        )
        if fmt == "svg":
            title = f"{mode} profile"
            if role:
                title += f" role={role}"
            if window:
                title += f" window={window:g}s"
            body = profiling.flamegraph_svg(stacks, title).encode()
            return 200, body, "image/svg+xml"
        if fmt == "json":
            payload = {
                "mode": mode,
                "role": role,
                "window_s": window,
                "profiler": profiler.snapshot(),
                "attribution": profiler.attribution(window_s=window),
                "stacks": {
                    stack: stacks[stack]
                    for stack in sorted(
                        stacks, key=lambda s: -stacks[s]
                    )[:200]
                },
            }
            if mode == "heap":
                payload["heap"] = profiler.heap_report()
            return (
                200,
                (json.dumps(payload, indent=1) + "\n").encode(),
                "application/json",
            )
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

    def _debug_watchdog(self) -> tuple[int, bytes, str]:
        payload = watchdog.MONITOR.snapshot()
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_admission(self) -> tuple[int, bytes, str]:
        """The admission layer's live state: ladder rung, ledger
        budgets and usage, per-tenant in-flight, lane depths — the
        overload-triage view (which tenant, which budget, which rung)."""
        payload = admission.CONTROLLER.snapshot()
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_logs(self) -> tuple[int, bytes, str]:
        payload = {"records": ring_tail()}
        return (
            200,
            (json.dumps(payload, indent=1, default=str) + "\n").encode(),
            "application/json",
        )

    def _debug_exemplars(self) -> tuple[int, bytes, str]:
        """Recent trace-id exemplars per histogram family — what the
        fleet aggregator scrapes beside /metrics so fleet burn alerts
        link straight to example traces."""
        payload = {"exemplars": metrics.GLOBAL.exemplars_snapshot()}
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_flows(self, query: dict | None = None) -> tuple[int, bytes, str]:
        """The flow ledger (utils/flows.py): per-origin ingress,
        per-object demand vs unique bytes, the live origin-amplification
        ratio, and the heavy-hitter sketch (``?hitters=`` bounds the
        displayed top-k; the mergeable sketch rides along for the fleet
        fold)."""
        raw = (query or {}).get("hitters", [""])[0]
        try:
            hitters = max(1, int(raw)) if raw else 16
        except ValueError:
            hitters = 16
        payload = flows.LEDGER.snapshot(hitters=hitters)
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_cache(self) -> tuple[int, bytes, str]:
        """The fleet data plane's store + lease index (store/cas.py,
        fetch/singleflight.py): entry counts and bytes, hit/miss/
        eviction counters, and every live lease with its owner and
        heartbeat age. ``{"enabled": false}`` when no CACHE_DIR is
        configured, which in this build is always: the data plane comes
        with the fleet, and serve() refuses CACHE_DIR until then."""
        return (
            200,
            (json.dumps({"enabled": False}, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_critpath(self) -> tuple[int, bytes, str]:
        """Per-job gating chains over the tracer's completed ring plus
        the aggregated "where does p99 live" waterfall (utils/flows.py
        critical-path extraction — a pure function of the span trees
        /debug/jobs already serves)."""
        payload = flows.critpath_payload(tracing.TRACER.recent())
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_incidents(self) -> tuple[int, bytes, str]:
        payload = {"incidents": incident.RECORDER.list_incidents()}
        return (
            200,
            (json.dumps(payload, indent=1) + "\n").encode(),
            "application/json",
        )

    def _debug_incident(self, bundle_id: str) -> tuple[int, bytes, str]:
        bundle = incident.RECORDER.get(bundle_id)
        if bundle is None:
            return 404, b"no such incident\n", "text/plain"
        return (
            200,
            (json.dumps(bundle, indent=1, default=str) + "\n").encode(),
            "application/json",
        )

    def _capture_incident(self) -> tuple[int, bytes, str]:
        bundle = incident.RECORDER.capture(
            "operator-requested capture (POST /debug/incident)",
            trigger="manual",
        )
        payload = {"id": bundle["id"], "persisted": bundle.get("persisted")}
        return (
            200,
            (json.dumps(payload) + "\n").encode(),
            "application/json",
        )

    def _metrics(self) -> tuple[int, bytes, str]:
        body = render_metrics(self._counters(), self._connected())
        return 200, body, "text/plain; version=0.0.4"

    def _metrics_federate(self) -> tuple[int, bytes, str]:
        """The fleet's "one /metrics scrape, per-worker labels":
        this worker's exposition plus every registered child-worker
        source (metrics.FEDERATION), each sample tagged with its
        ``instance`` label. Family HELP/TYPE metadata is declared once
        (first worker wins); a failing child source costs its samples
        and a counter bump, never the scrape."""
        _, own_body, _ = self._metrics()
        body = render_federated(own_body)
        return 200, body, "text/plain; version=0.0.4"


# -- exposition renderers (module-level: the fleet supervisor serves the
# -- same formats without a Daemon/QueueClient behind it) -------------------


def render_metrics(
    extra_counters: "dict | None" = None,
    broker_connected: "bool | None" = None,
) -> bytes:
    """Prometheus text exposition of the process-wide registry plus
    ``extra_counters`` (the daemon/queue stats the worker's health
    server folds in; the fleet supervisor passes only the registry).
    Every family gets one well-formed `# HELP` + `# TYPE` pair before
    its samples (metrics.py keeps the help catalog) —
    tests/test_metrics_lint.py gates the format, histogram triples, and
    family uniqueness."""
    lines = []
    counters = (
        extra_counters
        if extra_counters is not None
        else dict(sorted(metrics.GLOBAL.snapshot().items()))
    )
    for name, value in counters.items():
        metric = f"downloader_{name}"
        lines.append(f"# HELP {metric} {metrics.help_text(name)}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {value}")
    if broker_connected is not None:
        metric = "downloader_broker_connected"
        lines.append(
            f"# HELP {metric} {metrics.help_text('broker_connected')}"
        )
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {1 if broker_connected else 0}")
    # live levels (active swarms / peer connections) — the level
    # series exist from the first scrape (value 0), not from the
    # first torrent job: dashboards and absent()-style alerts need
    # the series present before traffic
    gauges = {
        "torrent_active_swarms": 0.0,
        "torrent_active_peers": 0.0,
        # telemetry-plane levels, present from the first scrape so
        # alert expressions and dashboards never see a gap: the
        # publisher gauge goes live when the queue client builds
        # its publisher; alerts_firing when the engine evaluates
        "alerts_firing": 0.0,
        "queue_publisher_alive": 0.0,
        # canary correctness gauge: the canary-failure rule (and the
        # fleet aggregator's per-instance scan) need the series from
        # the first scrape, not the first probe
        "canary_failing": 0.0,
        **metrics.GLOBAL.gauges(),
    }
    for name, value in sorted(gauges.items()):
        metric = f"downloader_{name}"
        lines.append(f"# HELP {metric} {metrics.help_text(name)}")
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {value:g}")
    # fixed-bucket histograms, Prometheus exposition: cumulative
    # le-buckets + _sum + _count, per-series bucket bounds (job
    # latency uses job-scale buckets; the tracing layer's
    # overhead_seconds uses ms-scale ones — see metrics.py).
    # Seeded like the gauges: the series must exist from the first
    # scrape — an idle (or only-failing) daemon must read as zero
    # completions, not as "no data"
    histograms = {
        **{
            name: (
                metrics.LATENCY_BUCKETS,
                [0] * len(metrics.LATENCY_BUCKETS), 0.0, 0,
            )
            for name in (
                "job_duration_seconds", "fetch_seconds",
                "scan_seconds", "upload_seconds", "publish_seconds",
                # per-class SLO series: present from the first
                # scrape so an interactive-p99 alert can use
                # absent()-free expressions before any traffic
                "slo_job_duration_seconds_interactive",
                "slo_job_duration_seconds_bulk",
                # canary e2e latency: present before the first probe
                "canary_e2e_seconds",
            )
        },
        "overhead_seconds": (
            metrics.OVERHEAD_BUCKETS,
            [0] * len(metrics.OVERHEAD_BUCKETS), 0.0, 0,
        ),
        **metrics.GLOBAL.histograms(),
    }
    for name, (bounds, counts, total, count) in sorted(
        histograms.items()
    ):
        metric = f"downloader_{name}"
        lines.append(f"# HELP {metric} {metrics.help_text(name)}")
        lines.append(f"# TYPE {metric} histogram")
        for le, bucket_count in zip(bounds, counts):
            lines.append(
                f'{metric}_bucket{{le="{le:g}"}} {bucket_count}'
            )
        lines.append(f'{metric}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{metric}_sum {total:.6f}")
        lines.append(f"{metric}_count {count}")
    return ("\n".join(lines) + "\n").encode()


# one exposition sample line: name, optional {labels}, value. The
# label body is parsed quote-aware — label VALUES may legally
# contain '}' (path templates, regexes), so a naive [^}]* would
# drop those samples from the merge as "malformed"
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{(?:[^"}]|"(?:[^"\\]|\\.)*")*\})? (.+)$'
)


def render_federated(own_body: bytes) -> bytes:
    """Merge ``own_body`` (this process's exposition) with every
    registered child source in ``metrics.FEDERATION``, tagging each
    sample with its ``instance`` label. Family metadata is declared
    once (first source wins); a failing child source costs its samples
    and a counter bump, never the scrape. Shared by the worker's
    ``/metrics/federate`` and the fleet supervisor's, which registers
    one HTTP scraper per live worker process."""
    instance = metrics.FEDERATION.instance or "worker-0"
    lines: list[str] = []
    declared: set[tuple[str, str]] = set()

    def fold(text: str, inst: str) -> None:
        # label values are quoted strings in the exposition format:
        # an instance like us-"east" must escape, not break parsing
        escaped = inst.replace("\\", "\\\\").replace('"', '\\"')
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(" ", 3)
                if len(parts) >= 3:
                    key = (parts[1], parts[2])
                    if key in declared:
                        continue
                    declared.add(key)
                lines.append(line)
                continue
            match = _SAMPLE_RE.match(line)
            if match is None:
                continue  # a malformed child line never poisons ours
            name, labels, value = match.groups()
            inner = (labels or "{}")[1:-1]
            if inner.startswith('instance="') or ',instance="' in inner:
                # the source already tagged its samples (a child
                # that is itself federating): keep its labels —
                # duplicating the label name is a hard parse error.
                # Anchored match: a label NAMED xyz_instance must
                # not suppress the tagging
                lines.append(line)
                continue
            tag = f'instance="{escaped}"'
            inner = tag if not inner else f"{tag},{inner}"
            lines.append(f"{name}{{{inner}}} {value}")

    fold(own_body.decode(), instance)
    for inst, fetch in sorted(metrics.FEDERATION.sources().items()):
        try:
            text = fetch()
        except Exception as exc:
            metrics.GLOBAL.add("federate_source_errors")
            log.with_fields(instance=inst).warning(
                f"federate source scrape failed: {exc}"
            )
            continue
        fold(text, inst)
    metrics.GLOBAL.add("federate_scrapes")
    return ("\n".join(lines) + "\n").encode()
