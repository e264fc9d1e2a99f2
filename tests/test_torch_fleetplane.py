"""The port's fleet debug plane (daemon/fleetplane.py) against the JAX
package's.

Mirrors ``tests/test_fleetplane.py`` over both packages:

- pure merge semantics: the log k-way merge is stable under clock skew,
  the profile fold-sum preserves totals, lineage stitching orders
  attempts and tags every span with its instance, the incident index
  merge tags owners, and both packages merge the same inputs into the
  same outputs;
- stub workers over real HTTP: a wedged worker costs ONE scrape-timeout
  slice, incident fetch-by-id routes to the owning worker, fleet tsdb
  rates are the sum of per-instance rates with percentiles from summed
  bucket deltas, the aggregator folds worker ``/metrics`` into series a
  burn rule fires over, and a stale federation source cannot poison or
  hang ``/metrics/federate``;
- the cost guard: SLO exemplars plus a live fleet aggregation loop stay
  under 0.5 ms a job;
- the fleet walk: 2 real workers of each package, one SIGKILLed
  mid-multipart; the fleet ``/debug/trace?trace_id=`` stitches one
  lineage over both instances, fleet ``/debug/tsdb`` rates are the
  per-worker sum, and a fleet burn rule captures one cross-worker
  incident. Both packages' fleets run one after the other on the same
  job stream and must store the same objects and Converts.
"""

import json
import os
import signal
import time

import pytest

from test_fleetplane import (
    _exposition as exposition,
    _FleetOrigin as FleetOrigin,
    _in_flight_jobs as in_flight_jobs,
    _json_route as json_route,
    _StubWorker as StubWorker,
    _worker_lineage as worker_lineage,
)
from test_torch_fleet import (
    PACKAGE_IDS,
    PACKAGES,
    ConvertSink,
    fleet_isolation,  # noqa: F401  (autouse: ledger balance, federation reset)
    http_get,
    payload,
    publish_job,
    stored,
    wait,
    worker_env,
)


@pytest.fixture(params=PACKAGES, ids=PACKAGE_IDS)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def plane_isolation():
    yield
    for each in PACKAGES:
        each.metrics.FEDERATION.reset()
        each.metrics.GLOBAL.reset()
        # fleet captures land in the process-wide flight recorder; a
        # stale bundle must not satisfy a later test's wait
        each.incident.RECORDER.reset()


# -- pure merge semantics ---------------------------------------------------------


def test_log_merge_stable_under_clock_skew(pkg):
    """A worker's records keep their own order no matter what its clock
    says: the k-way merge only ever compares heads."""
    by_instance = {
        "worker-a": [{"ts": 50.0, "msg": "a1"}, {"ts": 10.0, "msg": "a2"},
                     {"ts": 60.0, "msg": "a3"}],
        "worker-b": [{"ts": 12.0, "msg": "b1"}, {"ts": 55.0, "msg": "b2"}],
    }
    merged = pkg.logging.merge_ring_records(by_instance)
    assert [r["msg"] for r in merged if r["instance"] == "worker-a"] == ["a1", "a2", "a3"]
    assert [r["msg"] for r in merged if r["instance"] == "worker-b"] == ["b1", "b2"]
    assert len(merged) == 5 and all("instance" in r for r in merged)
    assert [r["msg"] for r in pkg.logging.merge_ring_records(by_instance, limit=2)] == [
        r["msg"] for r in merged[-2:]]
    # both packages interleave the same way
    assert merged == PACKAGES[1].logging.merge_ring_records(by_instance)


def test_profile_fold_sum_preserves_totals(pkg):
    w0 = {"a;b;c": 10, "a;b;d": 4}
    w1 = {"a;b;c": 7, "x;y": 5}
    merged = pkg.profiling.merge_folded({"w0": w0, "w1": w1})
    assert merged == {"a;b;c": 17, "a;b;d": 4, "x;y": 5}
    assert sum(merged.values()) == sum(w0.values()) + sum(w1.values())
    assert pkg.profiling.merge_folded({}) == {}
    assert pkg.profiling.merge_folded({"w0": None}) == {}


def test_stitch_lineage_orders_attempts_and_tags_every_span(pkg):
    attempts = {
        "worker-1": [{"attempt": 1, "wall_start": 200.0, "status": "ok",
                      "spans": {"name": "job", "children": [{"name": "fetch"}]}}],
        "worker-0": [{"attempt": 0, "wall_start": 100.0, "status": "retried",
                      "spans": {"name": "job"}}],
    }
    stitched = pkg.tracing.stitch_lineage("t" * 32, json.loads(json.dumps(attempts)))
    assert [a["attempt"] for a in stitched["attempts"]] == [0, 1]
    assert [a["instance"] for a in stitched["attempts"]] == ["worker-0", "worker-1"]
    assert stitched["instances"] == ["worker-0", "worker-1"]
    tree = stitched["attempts"][1]["spans"]
    assert tree["instance"] == "worker-1"
    assert tree["children"][0]["instance"] == "worker-1"
    assert stitched == PACKAGES[1].tracing.stitch_lineage("t" * 32, attempts)


def test_incident_index_merge_tags_owner(pkg):
    indexes = {
        "worker-1": [{"id": "incident-20260804T000002-0001"}],
        "worker-0": [{"id": "incident-20260804T000001-0001"}],
        "fleet": [],
    }
    merged = pkg.incident.merge_incident_indexes(json.loads(json.dumps(indexes)))
    assert [e["id"] for e in merged] == ["incident-20260804T000001-0001",
                                         "incident-20260804T000002-0001"]
    assert [e["instance"] for e in merged] == ["worker-0", "worker-1"]
    assert merged == PACKAGES[1].incident.merge_incident_indexes(indexes)


def test_parse_exposition_histograms_shapes(pkg):
    text = "\n".join([
        "# HELP downloader_slo_job_duration_seconds_bulk x",
        "# TYPE downloader_slo_job_duration_seconds_bulk histogram",
        'downloader_slo_job_duration_seconds_bulk_bucket{le="0.01"} 1',
        'downloader_slo_job_duration_seconds_bulk_bucket{le="1"} 3',
        'downloader_slo_job_duration_seconds_bulk_bucket{le="+Inf"} 4',
        "downloader_slo_job_duration_seconds_bulk_sum 5.5",
        "downloader_slo_job_duration_seconds_bulk_count 4",
        "downloader_unrelated_total 9",
        "garbage line",
    ])
    parsed = pkg.fleetplane.parse_exposition_histograms(text)
    assert parsed == {"slo_job_duration_seconds_bulk": ((0.01, 1.0), (1, 3), 5.5, 4)}
    assert parsed == PACKAGES[1].fleetplane.parse_exposition_histograms(text)


# -- stub workers over real HTTP --------------------------------------------------


def test_fanout_wedged_worker_costs_one_timeout_slice(pkg):
    logs = json_route({"records": [{"ts": 1.0, "msg": "healthy"}]})
    with StubWorker({"/debug/logs": logs}) as healthy, StubWorker(
        {"/debug/logs": logs}, wedge={"/debug/logs"}
    ) as wedged:
        plane = pkg.fleetplane.FleetQueryPlane(
            lambda: [("worker-0", healthy.port), ("worker-1", wedged.port)], timeout_s=0.4)
        before = pkg.metrics.GLOBAL.snapshot().get("fleet_scrape_failures", 0)
        started = time.monotonic()
        code, body, _ = plane.debug_logs()
        wall = time.monotonic() - started
        assert code == 200
        assert wall < 2.0, f"fan-out took {wall:.2f}s with one wedged worker"
        answer = json.loads(body)
        assert [r["instance"] for r in answer["records"]] == ["worker-0"]
        assert "worker-1" in answer["errors"]
        assert pkg.metrics.GLOBAL.snapshot().get("fleet_scrape_failures", 0) > before


def test_incident_fetch_by_id_routes_to_owning_worker(pkg):
    bundle_0 = {"id": "incident-20260804T000001-0001", "reason": "w0"}
    bundle_1 = {"id": "incident-20260804T000002-0001", "reason": "w1"}
    with StubWorker({
        "/debug/incidents": json_route({"incidents": [{"id": bundle_0["id"]}]}),
        f"/debug/incidents/{bundle_0['id']}": json_route(bundle_0),
    }) as w0, StubWorker({
        "/debug/incidents": json_route({"incidents": [{"id": bundle_1["id"]}]}),
        f"/debug/incidents/{bundle_1['id']}": json_route(bundle_1),
    }) as w1:
        plane = pkg.fleetplane.FleetQueryPlane(
            lambda: [("worker-0", w0.port), ("worker-1", w1.port)], timeout_s=1.0)
        code, body, _ = plane.debug_incidents()
        assert code == 200
        owners = {e["id"]: e["instance"] for e in json.loads(body)["incidents"]}
        assert owners == {bundle_0["id"]: "worker-0", bundle_1["id"]: "worker-1"}
        code, body, _ = plane.debug_incident(bundle_1["id"])
        assert code == 200
        served = json.loads(body)
        assert served["instance"] == "worker-1" and served["reason"] == "w1"
        assert plane.debug_incident("incident-nope")[0] == 404


def test_tsdb_fleet_rate_is_sum_and_percentiles_from_summed_buckets(pkg):
    le = [0.1, 1.0, 5.0]
    counter_0 = {"name": "tsdb_scrapes", "kind": "counter", "window_s": 60.0, "points": [],
                 "rate_per_s": 2.0}
    counter_1 = dict(counter_0, rate_per_s=3.5)
    hist_0 = {"name": "h", "kind": "histogram", "window_s": 60.0, "le": le, "points": [],
              "window": {"count": 2, "sum": 0.3, "p99": 0.2, "buckets": [1, 2, 2]}}
    hist_1 = {"name": "h", "kind": "histogram", "window_s": 60.0, "le": le, "points": [],
              "window": {"count": 5, "sum": 9.0, "p99": 4.0, "buckets": [0, 3, 5]}}
    with StubWorker() as w0, StubWorker() as w1:
        plane = pkg.fleetplane.FleetQueryPlane(
            lambda: [("worker-0", w0.port), ("worker-1", w1.port)], timeout_s=1.0)
        w0.routes["/debug/tsdb"] = json_route(counter_0)
        w1.routes["/debug/tsdb"] = json_route(counter_1)
        code, body, _ = plane.debug_tsdb({"name": ["tsdb_scrapes"]})
        assert code == 200
        answer = json.loads(body)
        assert answer["rates"] == {"worker-0": 2.0, "worker-1": 3.5}
        assert answer["rate_per_s"] == pytest.approx(5.5)
        w0.routes["/debug/tsdb"] = json_route(hist_0)
        w1.routes["/debug/tsdb"] = json_route(hist_1)
        code, body, _ = plane.debug_tsdb({"name": ["h"]})
        answer = json.loads(body)
        window = answer["window"]
        assert window["buckets"] == [1, 5, 7]
        assert window["count"] == 7
        assert window["sum"] == pytest.approx(9.3)
        assert window["p99"] == pytest.approx(pkg.tsdb.quantile(tuple(le), [1, 5, 7], 7, 0.99))
        assert answer["per_instance"]["worker-0"]["count"] == 2
        w0.routes.pop("/debug/tsdb")
        w1.routes.pop("/debug/tsdb")
        assert plane.debug_tsdb({"name": ["gone"]})[0] == 404


def test_aggregator_sums_worker_histograms_and_burn_rule_fires(pkg):
    """Worker ``/metrics`` expositions fold into fleet-summed and
    per-instance TSDB series; the fleet burn rule fires on the sum with
    instance-tagged exemplars; the outlier rule names the slow worker."""
    trace_id = "ab" * 16
    exemplars = json_route({"exemplars": {"slo_job_duration_seconds_bulk": [
        {"trace_id": trace_id, "value": 8.0, "ts": 1.0}]}})
    with StubWorker() as w0, StubWorker() as w1:
        for stub in (w0, w1):
            stub.routes["/metrics"] = (200, exposition(0, 0, 0, 0.0), "text/plain")
            stub.routes["/debug/exemplars"] = exemplars
        plane = pkg.fleetplane.FleetQueryPlane(
            lambda: [("worker-0", w0.port), ("worker-1", w1.port)], timeout_s=1.0)
        store = pkg.tsdb.TimeSeriesStore(interval_s=0)
        aggregator = pkg.fleetplane.FleetAggregator(plane, store=store)
        store.register_collector("fleet", aggregator.collect)
        t0 = time.time()
        store.sample(now=t0)  # zero baseline
        w0.routes["/metrics"] = (200, exposition(20, 20, 20, 0.1), "text/plain")
        w1.routes["/metrics"] = (200, exposition(0, 0, 20, 160.0), "text/plain")
        store.sample(now=t0 + 5)
        store.sample(now=t0 + 10)
        series = pkg.fleetplane.fleet_series("slo_job_duration_seconds_bulk")
        window = store.histogram_window(series, 60.0, now=t0 + 10)
        assert window is not None and window[3] == 40
        assert store.histogram_window(
            pkg.fleetplane.instance_series("slo_job_duration_seconds_bulk", "worker-1"),
            60.0, now=t0 + 10, min_samples=2) is not None
        rules = pkg.fleetplane.fleet_alert_rules(
            aggregator, slo_bulk_s=0.05, objective=0.9, fast_window_s=60.0,
            slow_window_s=120.0, factor=1.2, outlier_ratio=3.0)
        engine = pkg.alerts.AlertEngine(rules=rules, interval_s=0, store=store)
        engine.configure(exemplar_source=aggregator.exemplars_for, on_fire=lambda rule: None)
        fired = engine.evaluate(now=t0 + 10)
        assert "fleet-bulk-latency-burn" in {rule.name for rule in fired}
        burn = next(r for r in fired if r.name == "fleet-bulk-latency-burn")
        assert any(e.get("trace_id") == trace_id and e.get("instance")
                   for e in burn.last_detail.get("exemplars", []))
        outlier = next(r for r in engine.rules() if r.name == "fleet-worker-latency-outlier")
        assert outlier.last_detail.get("instance") == "worker-1"
        engine.reset()
        store.reset()


def test_aggregator_fleet_totals_survive_worker_death(pkg):
    """The fleet series is monotonic: a death never lowers it, and the
    survivor's fresh completions still register."""
    with StubWorker() as w0, StubWorker() as w1:
        w0.routes["/metrics"] = (200, exposition(0, 10, 10, 5.0), "text/plain")
        w1.routes["/metrics"] = (200, exposition(0, 10, 10, 5.0), "text/plain")
        members = [("worker-0", w0.port), ("worker-1", w1.port)]
        plane = pkg.fleetplane.FleetQueryPlane(lambda: list(members), timeout_s=1.0)
        store = pkg.tsdb.TimeSeriesStore(interval_s=0)
        aggregator = pkg.fleetplane.FleetAggregator(plane, store=store)
        store.register_collector("fleet", aggregator.collect)
        t0 = time.time()
        store.sample(now=t0)
        series = pkg.fleetplane.fleet_series("slo_job_duration_seconds_bulk")
        window = store.histogram_window(series, 600.0, now=t0)
        assert window is not None and window[3] == 20
        members.remove(("worker-1", w1.port))
        store.sample(now=t0 + 5)
        assert store.histogram_window(series, 600.0, now=t0 + 5, min_samples=2)[3] == 0
        w0.routes["/metrics"] = (200, exposition(0, 12, 15, 9.0), "text/plain")
        store.sample(now=t0 + 10)
        assert store.histogram_window(series, 600.0, now=t0 + 10, min_samples=2)[3] == 5
        # the restarted worker re-counts from zero: counted in full
        w1.routes["/metrics"] = (200, exposition(0, 2, 3, 1.0), "text/plain")
        members.append(("worker-1", w1.port))
        store.sample(now=t0 + 15)
        assert store.histogram_window(series, 600.0, now=t0 + 15, min_samples=2)[3] == 8
        store.reset()


def test_worker_outlier_rule_unit(pkg):
    rule = pkg.alerts.WorkerOutlierRule(
        "outlier", "series", provider=lambda: {"w0": 0.1, "w1": 2.0}, ratio=4.0,
        min_value=0.05)
    view = pkg.alerts.RegistryView(pkg.tsdb.TimeSeriesStore(interval_s=0))
    breached, detail = rule._condition(view, time.time())
    assert breached and detail["instance"] == "w1"
    rule._provider = lambda: {"w0": 9.0, "w1": None}
    assert not rule._condition(view, time.time())[0]
    rule._provider = lambda: {"w0": 2.0, "w1": 2.1}
    assert not rule._condition(view, time.time())[0]


def test_stale_federation_source_cannot_poison_or_hang_federate(pkg):
    """A wedged child source costs its samples, a counter bump and at
    most one scrape-timeout slice, never the render; a reaped worker's
    source deregisters."""
    with StubWorker(wedge={"/metrics"}) as wedged:
        supervisor = pkg.fleet.FleetSupervisor(
            pkg.fleet.FleetConfig(workers=1, scrape_timeout_s=0.3))
        try:
            slot = supervisor._slots[0]
            with supervisor._lock:
                slot.health_port = wedged.port
            supervisor._register_federation(slot)
            assert "worker-0" in pkg.metrics.FEDERATION.sources()
            counters = pkg.metrics.GLOBAL.snapshot()
            before_scrape = counters.get("fleet_scrape_failures", 0)
            before_fed = counters.get("federate_source_errors", 0)
            started = time.monotonic()
            body = pkg.health.render_federated(pkg.health.render_metrics()).decode()
            wall = time.monotonic() - started
            assert wall < 2.0, f"wedged source hung the render {wall:.2f}s"
            assert "downloader_fleet_workers_target" in body
            counters = pkg.metrics.GLOBAL.snapshot()
            assert counters.get("fleet_scrape_failures", 0) > before_scrape
            assert counters.get("federate_source_errors", 0) > before_fed
            handle = pkg.fleet.WorkerHandle("worker-0", ["true"], {})
            supervisor._retire_handle(handle)
            assert "worker-0" not in pkg.metrics.FEDERATION.sources()
        finally:
            supervisor.drain()


def test_exemplars_recorded_bounded_and_served(pkg):
    registry = pkg.metrics.GLOBAL
    registry.reset()
    for i in range(10):
        registry.observe("slo_job_duration_seconds_bulk", 0.1, exemplar=f"{i:032x}")
    exemplars = registry.exemplars("slo_job_duration_seconds_bulk")
    assert len(exemplars) == pkg.metrics.EXEMPLARS_PER_FAMILY
    assert exemplars[-1]["trace_id"] == f"{9:032x}"
    assert "slo_job_duration_seconds_bulk" in registry.exemplars_snapshot()
    registry.observe("job_duration_seconds", 0.1)
    assert registry.exemplars("job_duration_seconds") == []


# -- the cost guard ---------------------------------------------------------------


def test_exemplar_and_aggregation_overhead_bounded(pkg):
    """A job recording its SLO observation with an exemplar, while a
    live fleet aggregation loop scrapes two stub workers in the
    background, costs at most 0.5 ms at the median: aggregation rides
    the supervisor's scrape thread, not the job path."""
    body = exposition(5, 10, 12, 4.0)
    tracing = pkg.tracing
    with StubWorker({"/metrics": (200, body, "text/plain")}) as w0, \
            StubWorker({"/metrics": (200, body, "text/plain")}) as w1:
        plane = pkg.fleetplane.FleetQueryPlane(
            lambda: [("worker-0", w0.port), ("worker-1", w1.port)], timeout_s=0.5)
        store = pkg.tsdb.TimeSeriesStore(interval_s=0.05)
        aggregator = pkg.fleetplane.FleetAggregator(plane, store=store)
        store.register_collector("fleet", aggregator.collect)
        store.start()
        inbound = tracing.TraceContext.mint()

        def one_job(i: int) -> None:
            with tracing.TRACER.job(f"guard-{i}", context=inbound) as root:
                with tracing.span("fetch"):
                    pass
                root.set_status("ok")
                pkg.metrics.GLOBAL.observe("slo_job_duration_seconds_bulk", 0.01,
                                           exemplar=root.trace_id)

        try:
            deadline = time.monotonic() + 30.0
            while True:
                one_job(0)  # warm
                laps = []
                for i in range(200):
                    started = time.perf_counter()
                    one_job(i)
                    laps.append(time.perf_counter() - started)
                laps.sort()
                median_ms = laps[len(laps) // 2] * 1000
                if median_ms < 0.5:
                    break
                # a loaded host can blow any budget; the guard asks
                # whether the plane CAN hit it, so it measures again
                assert time.monotonic() < deadline, (
                    f"exemplars + fleet aggregation cost {median_ms:.3f} ms/job")
        finally:
            store.reset()
            tracing.TRACER.clear()


# -- the fleet walk: 2 real workers, SIGKILL mid-multipart, stitched trace --------


def stitched_walk(pkg, objects, tmp_path):
    """The reference suite's walk for one package (see
    ``tests/test_fleetplane.py``): wedge/cancel ping-pong of one trace
    across both workers, a SIGKILL mid-multipart, the restarted worker
    taking an attempt again, completion, then the fleet debug plane."""
    with pkg.stub.S3Stub(pkg.creds) as s3, pkg.amqp_server.AmqpServerStub() as broker, \
            FleetOrigin(objects) as origin:
        origin.modes["/stitch.mp4"] = "wedge"
        origin.modes["/decoy.bin"] = "wedge"
        origin.rates["/stitch.mp4"] = 300 * 1024
        origin.rates["/decoy.bin"] = 128 * 1024
        origin.rates["/coda0.bin"] = 64 * 1024
        origin.rates["/coda1.bin"] = 64 * 1024
        supervisor = pkg.fleet.FleetSupervisor(
            pkg.fleet.FleetConfig(workers=2, heartbeat_s=0.2, stall_s=3.0,
                                  publisher_down_s=30.0, restart_backoff_s=0.1,
                                  restart_backoff_cap_s=0.5, start_grace_s=40.0,
                                  drain_s=10.0, scrape_timeout_s=2.0),
            worker_env=worker_env(pkg, broker, s3, str(tmp_path / pkg.name), PREFETCH="1",
                                  TSDB_INTERVAL="0.3", WATCHDOG_STALL_S="2",
                                  WATCHDOG_ACTION="cancel", MAX_JOB_RETRIES="200",
                                  RETRY_DELAY="0.3", RETRY_DELAY_CAP="1.0"),
        )
        sink = None
        store = pkg.tsdb.TimeSeriesStore(interval_s=0.25)
        engine = pkg.alerts.AlertEngine(interval_s=0.25, store=store)
        recorder = pkg.incident.RECORDER
        saved_interval = recorder.min_auto_interval
        recorder.min_auto_interval = 0.0
        pre_existing = {b["id"] for b in recorder.list_incidents()}

        def ports_now() -> dict:
            return {s["instance"]: s["health_port"] for s in supervisor.snapshot()["slots"]}

        try:
            supervisor.start()
            wait(lambda: all(s["ready"] for s in supervisor.snapshot()["slots"]), 60.0,
                 "both real workers ready")
            instances = sorted(ports_now())
            plane = pkg.fleetplane.FleetQueryPlane(supervisor.ready_workers, timeout_s=2.0,
                                                   engine=engine)
            aggregator = pkg.fleetplane.FleetAggregator(plane, store=store)
            store.register_collector("fleet", aggregator.collect)
            store.start()
            sink = ConvertSink(pkg, broker)
            # 1. wedge/cancel ping-pong until BOTH instances hold attempts
            context = publish_job(pkg, broker, "stitch-1", f"{origin.url}/stitch.mp4")
            publish_job(pkg, broker, "decoy-1", f"{origin.url}/decoy.bin")
            wait(lambda: all(worker_lineage(port, context.trace_id)
                             for port in ports_now().values()),
                 120.0, "attempts of the one trace on BOTH instances", interval=0.2)
            # 2. stream, then SIGKILL mid-multipart
            origin.modes["/stitch.mp4"] = "serve"
            victim = wait(
                lambda: (s3.list_multipart_uploads()
                         and [inst for inst, port in ports_now().items()
                              if "stitch-1" in in_flight_jobs(port)]),
                60.0, "a worker streaming the stitch job mid-multipart", interval=0.1)[0]
            origin.modes["/stitch.mp4"] = "wedge"
            victim_pid = next(s["pid"] for s in supervisor.snapshot()["slots"]
                              if s["instance"] == victim)
            os.kill(victim_pid, signal.SIGKILL)
            # 3. restart, ping-pong until the restarted instance holds an
            # attempt again
            wait(lambda: all(s["ready"] and s["pid"] != victim_pid
                             for s in supervisor.snapshot()["slots"]),
                 60.0, "the killed worker to restart and heartbeat")
            wait(lambda: worker_lineage(ports_now().get(victim, 0), context.trace_id),
                 120.0, "the restarted instance to hold an attempt again", interval=0.2)
            # 4. serve for real
            origin.modes["/stitch.mp4"] = "serve"
            origin.modes["/decoy.bin"] = "serve"
            wait(lambda: ("stitch-1", context.trace_id) in sink.snapshot(), 120.0,
                 "the stitch job to complete under the original trace id")
            foreign = [e for e in sink.snapshot()
                       if e[0] == "stitch-1" and e[1] != context.trace_id]
            assert not foreign, f"foreign trace ids: {foreign}"
            wait(lambda: not s3.list_multipart_uploads(), 30.0,
                 "the SIGKILLed worker's multipart orphan to be reclaimed")
            # 5. the fleet debug plane over real HTTP
            health = pkg.fleet.FleetHealthServer(supervisor, 0, "127.0.0.1").start()
            try:
                started = time.monotonic()
                status, body = http_get(health.port,
                                        f"/debug/trace?trace_id={context.trace_id}")
                fanout_wall = time.monotonic() - started
                assert status == 200
                stitched = json.loads(body)
                assert fanout_wall < 6.0, f"fleet trace fan-out took {fanout_wall:.1f}s"
                ordinals = [a["attempt"] for a in stitched["attempts"]]
                assert ordinals == sorted(ordinals)
                for attempt in stitched["attempts"]:
                    assert attempt["spans"]["instance"] == attempt["instance"]

                # 6. fleet tsdb: rate == sum of per-instance rates
                def fleet_rate():
                    status, body = http_get(health.port,
                                            "/debug/tsdb?name=tsdb_scrapes&window=120")
                    if status != 200:
                        return None
                    answer = json.loads(body)
                    measured = [r for r in answer.get("rates", {}).values() if r is not None]
                    if len(measured) != 2 or not answer.get("rate_per_s"):
                        return None
                    return answer

                rates = wait(fleet_rate, 60.0, "both workers' tsdb rates to be measurable")
                assert rates["rate_per_s"] == pytest.approx(sum(rates["rates"].values()))

                # 7. fleet burn over the aggregated SLO sums
                publish_job(pkg, broker, "coda-0", f"{origin.url}/coda0.bin")
                publish_job(pkg, broker, "coda-1", f"{origin.url}/coda1.bin")
                wait(lambda: {m for m, _ in sink.snapshot()} >= {"coda-0", "coda-1"}, 60.0,
                     "the coda jobs to complete")
                engine.configure(
                    rules=pkg.fleetplane.fleet_alert_rules(
                        aggregator, slo_interactive_s=0.05, slo_bulk_s=0.05, objective=0.9,
                        fast_window_s=30.0, slow_window_s=60.0, factor=1.2),
                    on_fire=plane.alert_fired, exemplar_source=aggregator.exemplars_for)
                engine.start()

                def fleet_bundle():
                    for summary in recorder.list_incidents():
                        if summary["id"] in pre_existing:
                            continue
                        bundle = recorder.get(summary["id"])
                        if bundle and bundle.get("trigger") == "fleet-alert":
                            return bundle
                    return None

                bundle = wait(fleet_bundle, 60.0, "a fleet burn rule to capture an incident")
                extra = bundle.get("extra", {})
                workers = extra.get("workers", {})
                return {
                    "lineage_instances": sorted({a["instance"] for a in stitched["attempts"]}),
                    "lineage_ok": any(a["status"] == "ok" for a in stitched["attempts"]),
                    "lineage_retried": any(a["status"] in ("retried", "requeued")
                                           for a in stitched["attempts"]),
                    "instances": instances,
                    "rate_positive": rates["rate_per_s"] > 0,
                    "rule_is_fleet": str(extra.get("rule", "")).startswith("fleet-"),
                    "bundle_workers": sorted(workers),
                    "full_snapshots": all("threads" in snap for snap in workers.values()),
                    "objects": stored(s3),
                    "dangling": s3.list_multipart_uploads(),
                }
            finally:
                health.stop()
        finally:
            for event in origin.releases.values():
                event.set()
            engine.reset()
            store.reset()
            recorder.min_auto_interval = saved_interval
            if sink is not None:
                sink.close()
            supervisor.drain()


def test_e2e_fleet_debug_plane_sigkill_stitches_cross_worker_trace(tmp_path):
    """Each package's fleet: the stitched lineage spans both instances
    with a completed and a retried attempt, fleet tsdb rates are the
    per-worker sum, a fleet burn rule captures one bundle holding both
    workers' full snapshots, and both packages store the same objects
    and leave no multipart upload open."""
    objects = {
        "/stitch.mp4": payload(1536 * 1024, 40),
        "/decoy.bin": payload(256 * 1024, 41),
        "/coda0.bin": payload(96 * 1024, 42),
        "/coda1.bin": payload(96 * 1024, 43),
    }
    port, ref = (stitched_walk(pkg, objects, tmp_path) for pkg in PACKAGES)
    assert port == ref
    assert port["lineage_instances"] == port["instances"] == ["worker-0", "worker-1"]
    assert port["lineage_ok"] and port["lineage_retried"] and port["rate_positive"]
    assert port["rule_is_fleet"] and port["full_snapshots"]
    assert port["bundle_workers"] == ["worker-0", "worker-1"]
    assert objects["/stitch.mp4"] in port["objects"].values()
    assert port["dangling"] == []
