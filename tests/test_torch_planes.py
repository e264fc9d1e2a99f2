"""The port's telemetry, admission, incident and canary planes against the
JAX package's.

- tsdb + alerts: one seeded series (SLO latencies by class, pressure
  gauges, counters) fed to each package's ``TimeSeriesStore`` and its
  stock alert rules at the same instants gives the same queries, rates,
  window quantiles, rule transitions and rule details.
- admission: one seeded stream of ledger charges and refunds, admission
  verdicts, releases, lane offers and takes gives the same ladder rungs,
  verdicts, quotas and lane order.
- incident: bundles have the same keys and the probe registry reports
  the same way; ``locks`` is ``None`` in both with no recorder, and
  under each package's ``LockOrderRecorder`` one scripted lock order
  gives the same edges and held locks once sites are made relative to
  their package.
- canary: the port's prober catches the one-byte flip that the
  ``canary.corrupt`` failpoint puts into its upload, at the integrity
  stage, and passes a clean probe pair.

Each package keeps its own process-wide registry; each is reset before
its run and the two runs never overlap.
"""

import contextlib
import json
import os
import random
import threading
import time

import numpy as np
import pytest

from test_torch_analysis import torch_protocol_guard  # noqa: F401  (module guards)
from downloader_tpu.analysis import runtime as ref_runtime
from downloader_tpu.utils import admission as ref_admission
from downloader_tpu.utils import alerts as ref_alerts
from downloader_tpu.utils import cancel as ref_cancel
from downloader_tpu.utils import incident as ref_incident
from downloader_tpu.utils import metrics as ref_metrics
from downloader_tpu.utils import tsdb as ref_tsdb
from downloader_tpu_torch.analysis import runtime
from downloader_tpu_torch.daemon.app import Daemon
from downloader_tpu_torch.daemon.config import Config
from downloader_tpu_torch.fetch import DispatchClient, HTTPBackend
from downloader_tpu_torch.queue import MemoryBroker, QueueClient
from downloader_tpu_torch.store import Credentials, S3Client, Uploader
from downloader_tpu_torch.store.stub import S3Stub
from downloader_tpu_torch.utils import admission, alerts, canary, cancel, failpoints, incident
from downloader_tpu_torch.utils import metrics, tsdb, watchdog
from downloader_tpu_torch.utils.cancel import CancelToken

PORT = {"metrics": metrics, "tsdb": tsdb, "alerts": alerts, "admission": admission,
        "incident": incident, "cancel": cancel, "runtime": runtime}
REF = {"metrics": ref_metrics, "tsdb": ref_tsdb, "alerts": ref_alerts,
       "admission": ref_admission, "incident": ref_incident, "cancel": ref_cancel,
       "runtime": ref_runtime}
T0 = 1_800_000_000.0
SERIES = ("slo_job_duration_seconds_interactive", "slo_job_duration_seconds_bulk")


def _telemetry(pkg, seed):
    registry = pkg["metrics"].GLOBAL
    registry.reset()
    store = pkg["tsdb"].TimeSeriesStore(interval_s=1.0, samples=32, downsample=4)
    fired = []
    engine = pkg["alerts"].AlertEngine(store=store, interval_s=1.0)
    engine.configure(
        rules=pkg["alerts"].default_rules(slo_interactive_s=0.5, slo_bulk_s=5.0,
                                          objective=0.99, fast_window_s=20.0,
                                          slow_window_s=60.0, factor=2.0),
        on_fire=lambda rule: fired.append(rule.name),
    )
    rng = np.random.default_rng(seed)
    trace = []
    try:
        for step in range(60):
            now = T0 + 5.0 * step
            # a clean first third, a latency storm, then recovery
            storm = 20 <= step < 35
            for name, target in zip(SERIES, (0.5, 5.0)):
                for value in rng.exponential(target * (4.0 if storm else 0.2),
                                             int(rng.integers(0, 12))):
                    registry.observe(name, float(value))
            registry.add("jobs_processed", int(rng.integers(0, 9)))
            registry.gauge_set("admission_pressure", float(rng.random() * (1.2 if storm else 0.5)))
            registry.gauge_set("queue_publisher_alive", 0.0 if 40 <= step < 44 else 1.0)
            store.sample(now=now)
            transitions = engine.evaluate(now=now)
            trace.append((
                step,
                [rule.name for rule in transitions],
                [(rule.name, rule.state, sorted(rule.last_detail.items()))
                 for rule in engine.rules()],
                store.counter_rate("jobs_processed", 30.0, now=now),
                store.histogram_window(SERIES[0], 30.0, now=now),
                store.query("admission_pressure", 30.0),
            ))
        trace.append(("fired", fired, sorted(store.names().items())))
    finally:
        engine.reset()
        store.reset()
        registry.reset()
    return trace


@pytest.mark.parametrize("seed", range(2))
def test_tsdb_and_alert_decisions_match_reference(seed):
    port, ref = _telemetry(PORT, seed), _telemetry(REF, seed)
    assert port == ref
    fired = port[-1][1]
    assert "interactive-latency-burn" in fired
    assert any(transitions for _, transitions, *_ in port[:-1])


def _admission(pkg, seed):
    adm = pkg["admission"]
    pkg["metrics"].GLOBAL.reset()
    ledger = adm.Ledger()
    controller = adm.AdmissionController(ledger)
    controller.configure(budgets={"scratch_bytes": 1000, "parts": 8}, quota_jobs=3,
                         quota_bytes=600, weights={"interactive": 3, "bulk": 1},
                         shrink_at=0.5, pause_at=0.75, shed_at=0.95)
    scheduler = adm.DeficitScheduler({"interactive": 3, "bulk": 1})
    rng = random.Random(seed)
    charges, releases, trace = [], [], []
    for step in range(400):
        op = rng.randrange(7)
        if op == 0:
            key = f"k{step}"
            budget = rng.choice(("scratch_bytes", "parts"))
            trace.append(("charge", ledger.charge(budget, key, rng.randrange(1, 300))))
            charges.append(key)
        elif op == 1 and charges:
            ledger.refund(charges.pop(rng.randrange(len(charges))))
        elif op in (2, 3):
            job_class = rng.choice(("interactive", "bulk", "canary"))
            tenant = rng.choice(("a", "b", "c"))
            rung = controller.level()
            first = controller.precheck(job_class, tenant, rung)
            decision = first or controller.decide(job_class, tenant, rng.choice((None, 50, 400)),
                                                  rung=rung)
            trace.append(("decide", rung, first is not None, decision.action, decision.reason))
            if decision.action == "admit":
                releases.append(decision.release)
        elif op == 4 and releases:
            releases.pop(rng.randrange(len(releases)))()
        elif op == 5:
            scheduler.offer(f"job{step}", rng.choice(("interactive", "bulk")),
                            rng.choice(("a", "b")))
        else:
            paused = frozenset(("bulk",)) if rng.random() < 0.3 else frozenset()
            trace.append(("take", scheduler.take(rng.randrange(1, 4), paused)))
        trace.append(("state", controller.level(), round(ledger.pressure(), 9),
                      ledger.tripped(), controller.tenants(), scheduler.pending(),
                      sorted(ledger.outstanding().items())))
    trace.append(("retry_after", [adm.retry_after_for(n, 5.0, 300.0) for n in range(8)],
                  [adm.normalize_class(v) for v in ("Interactive", "bulk", "x", None, 3)],
                  [adm.normalize_tenant(v) for v in ("Acme", "", None, "a" * 300, "ok-1")]))
    for release in releases:
        release()
    # every charge settles: the ledger-charge protocol balances
    for key in charges:
        ledger.refund(key)
    trace.append(("end", controller.tenants(), scheduler.pending(), ledger.outstanding()))
    return trace


@pytest.mark.parametrize("seed", range(3))
def test_admission_decisions_match_reference(seed):
    port, ref = _admission(PORT, seed), _admission(REF, seed)
    assert port == ref
    actions = {entry[3] for entry in port if entry[0] == "decide"}
    assert {"admit", "shed"} <= actions


def _scripted_bundle(pkg, recorded):
    """One bundle captured under a scripted lock order: a lock of this
    file, then a ``CancelToken``'s (a lock site of the package), the
    first still held at capture. ``recorded`` runs it under the package's
    own ``LockOrderRecorder``."""
    recorder = pkg["runtime"].LockOrderRecorder() if recorded else contextlib.nullcontext()
    with recorder:
        outer = threading.Lock()
        token = pkg["cancel"].CancelToken()
        incidents = pkg["incident"].IncidentRecorder()
        incidents.register_probe("demo", lambda: {"depth": 3})
        with outer:
            with token._lock:
                pass
            return incidents.capture("a drill", job_id="job-1", trigger="manual",
                                     extra={"why": "test"})


def _package_relative(locks, pkg):
    root = os.path.dirname(os.path.dirname(pkg["runtime"].__file__))
    return json.loads(json.dumps(locks).replace(root + os.sep, "PKG" + os.sep))


@pytest.mark.parametrize("recorded", [False, True], ids=["no-recorder", "recorder"])
def test_incident_bundles_have_the_same_keys(recorded):
    port, ref = (_scripted_bundle(pkg, recorded) for pkg in (PORT, REF))
    assert sorted(port) == sorted(ref)
    if recorded:
        assert sorted(port["locks"]) == sorted(ref["locks"]) == ["edges", "held_by_thread"]
        port_locks = _package_relative(port["locks"], PORT)
        assert port_locks == _package_relative(ref["locks"], REF)
        held_here = [
            edge["acquired"] for edge in port_locks["edges"]
            if edge["held"].startswith(__file__ + ":")
        ]
        assert any(site.startswith(os.path.join("PKG", "utils", "cancel.py:"))
                   for site in held_here), port_locks
        held = port_locks["held_by_thread"][threading.current_thread().name]
        assert [site.rsplit(":", 1)[0] for site in held] == [__file__]
    else:
        assert port["locks"] is None and ref["locks"] is None
    assert port["probes"] == ref["probes"]
    assert (port["reason"], port["trigger"], port["job_id"], port["extra"]) == (
        ref["reason"], ref["trigger"], ref["job_id"], ref["extra"])
    assert sorted(port["metrics"]) == sorted(ref["metrics"])


@pytest.fixture
def prober(tmp_path):
    """The port's daemon over its memory broker and S3 stub, with a
    canary prober whose loop is parked (probes run synchronously)."""
    token = CancelToken()
    broker = MemoryBroker()
    stub = S3Stub(credentials=Credentials("k", "s")).start()
    config = Config(broker="memory", base_dir=str(tmp_path), concurrency=1,
                    max_job_retries=1, retry_delay=0.05)
    client = QueueClient(token, broker.connect, supervisor_interval=0.05, drain_timeout=5)
    client.set_prefetch(8)
    dispatcher = DispatchClient(token, str(tmp_path), [
        HTTPBackend(progress_interval=0.01, timeout=2.0, zero_copy=False, segments=1)])
    uploader = Uploader(config.bucket, S3Client(stub.endpoint, Credentials("k", "s")))
    daemon = Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)
    incident.RECORDER.min_auto_interval = 0.0
    probe = canary.CanaryProber(client, uploader, consume_topic=config.consume_topic,
                                publish_topic=config.publish_topic, interval_s=600.0,
                                timeout_s=15.0, instance="w0")
    runner.start()
    probe.start()
    canary.ACTIVE = probe
    try:
        yield probe
    finally:
        canary.ACTIVE = None
        failpoints.FAILPOINTS.reset()
        probe.stop()
        token.cancel()
        runner.join(timeout=15)
        incident.RECORDER.min_auto_interval = incident.DEFAULT_MIN_AUTO_INTERVAL_S
        watchdog.MONITOR.reset()
        stub.stop()


def test_canary_catches_a_one_byte_flip(prober):
    clean = prober.run_probe_pair()
    assert [verdict["ok"] for verdict in clean] == [True, True], clean
    failpoints.FAILPOINTS.configure("canary.corrupt=fail:1")
    corrupt = prober.run_probe_pair()
    assert not any(verdict["ok"] for verdict in corrupt), corrupt
    for verdict in corrupt:
        assert verdict["stages"]["publish"] and verdict["stages"]["convert"], verdict
        assert verdict["error"].startswith("integrity: integrity mismatch"), verdict
    assert prober.failing
    assert metrics.GLOBAL.gauges().get("canary_failing") == 1.0
    failpoints.FAILPOINTS.reset()
    assert all(verdict["ok"] for verdict in prober.run_probe_pair())
    assert wait_for(lambda: not prober.failing)


def wait_for(predicate, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False
