"""Port twins of the JAX package's CI end-to-end smokes.

Each test here is the reference test of the same name (its file is in
the section's heading) re-rooted on ``downloader_tpu_torch``, with its
fixtures copied: the same rig, the same inputs, the same acceptance.
Where the outcome is deterministic for the same inputs (the batched
wave's objects and counters, the settled failure position, the
failover's stored object, the trace-id walk, the fleet flow merge), one
body runs over both packages (``PACKAGES``) and the port's outcome must
equal the JAX package's before the reference's acceptance is applied to
it; the timing smokes (p99, burn rate, profiler overhead, wedge
deadlines) hold the port to the reference's thresholds alone.
Where the reference reads a process-wide singleton (metrics, the
watchdog, the incident recorder, the admission ledger, the flow ledger,
the alert engine, the canary prober, the failpoints, the profiler), the
twin reads the port's. Fixtures that were autouse in their own file are
named per section and requested by that section's tests, and the port's
admission ledger must balance after every test, as ``tests/conftest.py``
holds the reference's. Helpers that two sections share identically are
defined once; names that clash between sections carry the section's
prefix. CI runs these in the port's smoke step.
"""

import base64
import contextlib
import functools
import http.client
import http.server
import importlib
import json
import os
import socketserver
import sys
import threading
import time
import types
import urllib.request

import pytest

from downloader_tpu_torch.daemon.app import Daemon, capture_stall_incident
from downloader_tpu_torch.daemon.config import Config
from downloader_tpu_torch.daemon.fleet import (
    FleetConfig,
    FleetHealthServer,
    FleetSupervisor,
)
from downloader_tpu_torch.daemon.health import HealthServer
from downloader_tpu_torch.fetch import DispatchClient, HTTPBackend
from downloader_tpu_torch.fetch.segments import SegmentedFetcher
from downloader_tpu_torch.queue import MemoryBroker, QueueClient
from downloader_tpu_torch.queue.amqp_server import AmqpServerStub
from downloader_tpu_torch.queue.delivery import (
    CLASS_HEADER,
    RETRY_AFTER_HEADER,
    SHED_HEADER,
    TENANT_HEADER,
    dlq_name,
)
from downloader_tpu_torch.store import Credentials, S3Client, Uploader
from downloader_tpu_torch.store.stub import S3Stub
from downloader_tpu_torch.utils import (
    admission,
    alerts,
    canary,
    failpoints,
    flows,
    incident,
    metrics,
    profiling,
    tracing,
    tsdb,
    watchdog,
)
from downloader_tpu_torch.utils import logging as ulog
from downloader_tpu_torch.utils.cancel import CancelToken
from downloader_tpu_torch.utils.profiling import NamedLock, SamplingProfiler
from downloader_tpu_torch.wire import Convert, Download, Media

# the twins whose outcome is deterministic for the same inputs run the
# JAX package on them too and compare: each package's modules by name
_MODULES = {
    "app": "daemon.app", "config": "daemon.config", "fetch": "fetch",
    "progress": "fetch.progress", "queue": "queue", "delivery": "queue.delivery",
    "scan": "scan", "store": "store", "stub": "store.stub", "wire": "wire",
    "admission": "utils.admission", "cancel": "utils.cancel", "flows": "utils.flows",
    "incident": "utils.incident", "logging": "utils.logging", "metrics": "utils.metrics",
    "tracing": "utils.tracing", "watchdog": "utils.watchdog",
}


def _package(root):
    modules = {key: importlib.import_module(f"{root}.{name}") for key, name in _MODULES.items()}
    return types.SimpleNamespace(name=root, **modules)


PORT = _package("downloader_tpu_torch")
REF = _package("downloader_tpu")
PACKAGES = (PORT, REF)

# the batched lane's byte bound in the batch and admission-chaos rigs
MAX_BYTES = 64 * 1024
# the watchdog rig's S3 stub and multipart shape
CREDS = Credentials(access_key="testkey", secret_key="testsecret")
PART = 64 * 1024
THRESHOLD = 128 * 1024
PAYLOAD_SIZE = 256 * 1024


def wait_for(predicate, timeout=15.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# each section's own default deadline, as its reference file has it
chaos_wait_for = functools.partial(wait_for, timeout=20.0, interval=0.005)
wait_for_20 = functools.partial(wait_for, timeout=20.0)
profiling_wait_for = functools.partial(wait_for, timeout=10.0)


class _QuietServer(http.server.ThreadingHTTPServer):
    def handle_error(self, request, client_address):
        pass  # cancelled fetches reset connections; expected


@pytest.fixture(autouse=True)
def port_admission_ledger_balances():
    """The port's admission ledger must balance to zero after every
    test (``tests/conftest.py`` holds the reference's so); the check
    runs after the test's own fixtures tore down, then resets the
    port's admission state."""
    yield
    outstanding = admission.LEDGER.outstanding()
    admission.CONTROLLER.reset()  # also resets the shared LEDGER
    assert not outstanding, f"admission ledger leaked charges: {outstanding}"


@pytest.fixture
def clean_observability():
    """tests/test_watchdog.py's autouse fixture."""
    watchdog.MONITOR.reset()
    watchdog.MONITOR.configure(
        stall_s=watchdog.DEFAULT_STALL_S, action="log",
        stage_overrides={}, on_stall=None,
    )
    incident.RECORDER.reset()
    tracing.TRACER.clear()
    yield
    watchdog.MONITOR.reset()
    watchdog.MONITOR.configure(
        stall_s=watchdog.DEFAULT_STALL_S, action="log",
        stage_overrides={}, on_stall=None,
    )
    incident.RECORDER.reset()
    tracing.TRACER.clear()


@pytest.fixture
def reset_metrics():
    """tests/test_multisource.py's autouse fixture."""
    metrics.GLOBAL.reset()
    yield
    metrics.GLOBAL.reset()


@pytest.fixture
def alerts_clean_state():
    """tests/test_alerts.py's autouse fixture."""
    metrics.GLOBAL.reset()
    yield
    alerts.ENGINE.reset()
    metrics.GLOBAL.reset()


@pytest.fixture
def telemetry_clean_tracer():
    """tests/test_telemetry.py's autouse fixture, over both packages'
    tracers (its twin runs both)."""
    def clean():
        for pkg in PACKAGES:
            pkg.tracing.TRACER.clear()
            pkg.tracing.TRACER.enabled = True
            pkg.tracing.TRACER.propagate = True

    clean()
    yield
    clean()


@pytest.fixture
def flow_isolation():
    """tests/test_flows.py's autouse fixture."""
    yield
    flows.LEDGER.reset()
    flows.LEDGER.configure(
        enabled=True,
        hitters=flows.DEFAULT_HITTERS,
        max_origins=flows.DEFAULT_MAX_ORIGINS,
        max_objects=flows.DEFAULT_MAX_OBJECTS,
    )
    flows.reset_origin_labels()
    metrics.GLOBAL.reset()


@pytest.fixture
def canary_clean_state():
    """tests/test_canary.py's autouse fixture, after clearing the port's
    flow ledger: an earlier suite in the same process can leave its
    hot-object gauge at 1.0, which fires a passive rule the canary test
    holds green (the JAX package's copy fails so under ``-n 6`` now and
    then)."""
    flows.LEDGER.reset()
    tracing.TRACER.clear()
    yield
    tracing.TRACER.clear()


# -- twins of tests/test_watchdog.py --------------------------------------------

class WedgeHandler(http.server.BaseHTTPRequestHandler):
    """Serves PAYLOAD_SIZE bytes but stops mid-stream and HOLDS the
    socket open — the canonical wedged transfer: no data, no error."""

    release = threading.Event()
    payload = os.urandom(PAYLOAD_SIZE)

    def log_message(self, *args):
        pass

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(PAYLOAD_SIZE))
        self.end_headers()
        self.wfile.write(WedgeHandler.payload[: PAYLOAD_SIZE // 2])
        self.wfile.flush()
        WedgeHandler.release.wait(30)  # wedge: keep the socket open


@pytest.fixture
def wedge_server():
    WedgeHandler.release = threading.Event()
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), WedgeHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base
    WedgeHandler.release.set()
    httpd.shutdown()


@pytest.fixture
def wedged_harness(wedge_server, tmp_path):
    """Fully wired daemon whose fetch WILL wedge: memory broker, S3
    stub with a small multipart threshold (the speculative upload is
    live when the stall hits), watchdog armed with a sub-second
    deadline and the production stall→incident hook, health server for
    /debug/incidents."""
    token = CancelToken()
    broker = MemoryBroker()
    stub = S3Stub(credentials=CREDS).start()
    config = Config(
        broker="memory", base_dir=str(tmp_path), concurrency=1,
        max_job_retries=1, retry_delay=0.05,
    )
    client = QueueClient(
        token, broker.connect, supervisor_interval=0.05, drain_timeout=5
    )
    dispatcher = DispatchClient(
        token,
        str(tmp_path),
        [
            HTTPBackend(
                progress_interval=0.01, timeout=2.0, zero_copy=False,
                segments=1,  # single-stream: the wedge is one socket
            )
        ],
    )
    uploader = Uploader(
        config.bucket,
        S3Client(
            stub.endpoint, CREDS,
            multipart_threshold=THRESHOLD, part_size=PART,
        ),
    )
    uploader.configure_pipeline(True, part_workers=2)
    daemon = Daemon(token, client, dispatcher, uploader, config)

    incident.RECORDER.configure(
        directory=str(tmp_path / "incidents"), keep=8
    )
    incident.RECORDER.min_auto_interval = 0.0
    stalls = []

    def on_stall(watch, stage, idle):
        stalls.append((watch.name, stage, idle, time.monotonic()))
        capture_stall_incident(watch, stage, idle)

    watchdog.MONITOR.configure(
        stall_s=0.6, action="cancel", stage_overrides={}, on_stall=on_stall
    )
    watchdog.MONITOR.start(poll_interval=0.05)

    health = HealthServer(daemon, client, 0).start()
    runner = threading.Thread(target=daemon.run, daemon=True)
    runner.start()
    time.sleep(0.1)
    producer = broker.connect().channel()

    class Harness:
        pass

    h = Harness()
    h.daemon = daemon
    h.stub = stub
    h.health_port = health.port
    h.stalls = stalls
    h.enqueued_at = None

    def enqueue(media_id, url):
        h.enqueued_at = time.monotonic()
        body = Download(media=Media(id=media_id, source_uri=url)).marshal()
        producer.publish("v1.download", "v1.download-0", body)

    h.enqueue = enqueue
    yield h
    WedgeHandler.release.set()
    token.cancel()
    runner.join(timeout=15)
    watchdog.MONITOR.stop()
    health.stop()
    uploader.close()
    stub.stop()


@pytest.mark.usefixtures("clean_observability")
def test_e2e_wedged_fetch_flagged_captured_cancelled(
    wedged_harness, wedge_server
):
    """The acceptance walk: stub server stops mid-stream → the watchdog
    flags job+stage within the deadline → the incident bundle carries
    thread stacks, the job's span tree, and the log-ring tail →
    /debug/incidents serves it → WATCHDOG_ACTION=cancel releases the
    job with zero dangling multipart uploads."""
    h = wedged_harness
    ulog.get_logger("test").info("pre-wedge breadcrumb")
    h.enqueue("wedged-1", f"{wedge_server}/movie.mkv")

    # the speculative multipart upload goes live once headers arrive
    assert wait_for(lambda: h.stub.list_multipart_uploads() != [])

    # -- the watchdog flags the right job+stage, within the deadline --
    assert wait_for(lambda: h.stalls, timeout=10)
    name, stage, idle, flagged_at = h.stalls[0]
    assert name == "wedged-1"
    assert stage == "fetch"
    assert idle >= 0.6
    # flagged promptly: deadline (0.6) + scan granularity + slack, not
    # the socket timeout (2 s) and nothing like the job timeout
    assert flagged_at - h.enqueued_at < 2.0
    assert metrics.GLOBAL.snapshot().get("watchdog_stalls", 0) >= 1

    # -- the incident bundle has the evidence --
    assert wait_for(
        lambda: incident.RECORDER.list_incidents() != [], timeout=5
    )
    bundles = incident.RECORDER.list_incidents()
    bundle = incident.RECORDER.get(bundles[-1]["id"])
    assert bundle["trigger"] == "watchdog"
    assert bundle["job_id"] == "wedged-1"
    # thread stacks: the wedged job worker is visible mid-read
    stacks = {t["name"]: t["stack"] for t in bundle["threads"]}
    assert any("job-worker" in n for n in stacks)
    # the job's span tree, in flight, with the fetch span open
    assert bundle["trace"]["job_id"] == "wedged-1"
    span_names = [
        c["name"] for c in bundle["trace"]["spans"]["children"]
    ]
    assert "fetch" in span_names
    # the log-ring tail carries the pre-wedge breadcrumb
    assert any(
        r["msg"] == "pre-wedge breadcrumb" for r in bundle["log_tail"]
    )
    # watchdog snapshot inside the bundle shows the stalled task
    assert any(
        t["name"] == "wedged-1" and t["stalled"]
        for t in bundle["watchdog"]["tasks"]
    )
    # subsystem probes rode along (names may carry -N suffixes when
    # earlier suites' clients are still alive)
    assert any(k.startswith("queue-client") for k in bundle["probes"])
    assert any(
        k.startswith("streaming-pipeline") for k in bundle["probes"]
    )
    # and it persisted to INCIDENT_DIR
    assert bundle["persisted"] and os.path.exists(bundle["persisted"])

    # -- /debug/incidents serves the bundle --
    with urllib.request.urlopen(
        f"http://127.0.0.1:{h.health_port}/debug/incidents", timeout=5
    ) as response:
        listing = json.loads(response.read())
    served_ids = [e["id"] for e in listing["incidents"]]
    assert bundle["id"] in served_ids
    with urllib.request.urlopen(
        f"http://127.0.0.1:{h.health_port}/debug/incidents/{bundle['id']}",
        timeout=5,
    ) as response:
        served = json.loads(response.read())
    assert served["job_id"] == "wedged-1"
    assert served["threads"]

    # -- cancel releases the job; retry wedges again, then drops --
    # attempt 1: watchdog-cancelled -> retried; attempt 2: retries
    # exhausted -> failed. Either way the job is RELEASED, the worker
    # returns to dequeue, and no multipart upload is left behind.
    assert wait_for(lambda: h.daemon.stats.retried >= 1, timeout=15)
    assert wait_for(lambda: h.daemon.stats.failed >= 1, timeout=30)
    assert metrics.GLOBAL.snapshot().get("watchdog_cancels", 0) >= 1
    assert wait_for(
        lambda: h.stub.list_multipart_uploads() == [], timeout=10
    ), "dangling multipart upload after watchdog cancel"


@pytest.mark.usefixtures("clean_observability")
def test_e2e_on_demand_incident_capture(wedged_harness, wedge_server):
    """POST /debug/incident captures a bundle without any stall."""
    h = wedged_harness
    request = urllib.request.Request(
        f"http://127.0.0.1:{h.health_port}/debug/incident", method="POST"
    )
    with urllib.request.urlopen(request, timeout=5) as response:
        payload = json.loads(response.read())
    assert payload["id"].startswith("incident-")
    bundle = incident.RECORDER.get(payload["id"])
    assert bundle["trigger"] == "manual"
    assert bundle["threads"]


# -- twins of tests/test_batch.py -----------------------------------------------

SMALL = os.urandom(16 * 1024)


MID = os.urandom(48 * 1024)  # under MAX_BYTES; 6 of them bust the budget


BIG = os.urandom(256 * 1024)  # above the tests' BATCH_MAX_BYTES


class BatchHandler(http.server.BaseHTTPRequestHandler):
    """HEAD-capable payload server (the fast path needs a probeable
    origin). ``/big.mkv`` exceeds MAX_BYTES; ``/fail-*.mkv`` answers
    GET with 404 (deterministic TransferError through the fast lane);
    ``/wedge.mkv`` sends headers then stalls until ``release`` fires."""

    protocol_version = "HTTP/1.1"
    release = threading.Event()

    def log_message(self, *args):
        pass

    def _payload(self):
        if self.path == "/big.mkv":
            return BIG
        if self.path.startswith("/mid"):
            return MID
        return SMALL

    def do_HEAD(self):
        body = self._payload()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        if self.path.startswith("/fail-"):
            self.send_error(404)
            return
        body = self._payload()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.path == "/wedge.mkv":
            self.wfile.write(body[:1024])
            self.wfile.flush()
            BatchHandler.release.wait(30)
            return
        self.wfile.write(body)


@pytest.fixture
def server():
    BatchHandler.release = threading.Event()
    httpd = _QuietServer(("127.0.0.1", 0), BatchHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    BatchHandler.release.set()
    httpd.shutdown()


@pytest.fixture
def harness(server, tmp_path):
    """A fully wired daemon of ``pkg`` shaped for deterministic
    batching: one worker, prefetch deep enough that a published burst
    accumulates in the sink, and a generous BATCH_WAIT so the wave forms
    reliably on loaded CI hosts."""

    def build(pkg, max_job_retries=1, batch_jobs=8):
        base_dir = str(tmp_path / pkg.name)
        token = pkg.cancel.CancelToken()
        broker = pkg.queue.MemoryBroker()
        stub = pkg.stub.S3Stub(credentials=pkg.store.Credentials("k", "s")).start()
        config = pkg.config.Config(
            broker="memory",
            base_dir=base_dir,
            concurrency=1,
            max_job_retries=max_job_retries,
            retry_delay=0.05,
        )
        config.batch_jobs = batch_jobs
        config.batch_wait_ms = 300.0
        config.batch_max_bytes = MAX_BYTES
        client = pkg.queue.QueueClient(
            token, broker.connect, supervisor_interval=0.05, drain_timeout=5
        )
        client.set_prefetch(32)
        dispatcher = pkg.fetch.DispatchClient(
            token,
            base_dir,
            [pkg.fetch.HTTPBackend(progress_interval=0.01, timeout=5)],
        )
        uploader = pkg.store.Uploader(
            config.bucket, pkg.store.S3Client(stub.endpoint, pkg.store.Credentials("k", "s"))
        )
        daemon = pkg.app.Daemon(token, client, dispatcher, uploader, config)
        runner = threading.Thread(target=daemon.run, daemon=True)

        h = type("Harness", (), {})()
        h.daemon, h.broker, h.stub, h.token = daemon, broker, stub, token
        h.config, h.runner, h.base = config, runner, server
        producer = broker.connect().channel()
        # jobs are published BEFORE the daemon starts (so the wave is
        # already waiting when the worker wakes): declare the topology
        # the daemon would otherwise declare in consume()
        producer.declare_exchange("v1.download")
        for i in range(2):
            name = f"v1.download-{i}"
            producer.declare_queue(name)
            producer.bind_queue(name, "v1.download", name)

        def enqueue(media_id, path):
            body = pkg.wire.Download(
                media=pkg.wire.Media(id=media_id, source_uri=f"{server}{path}")
            ).marshal()
            producer.publish("v1.download", "v1.download-0", body)

        h.enqueue = enqueue
        h.start = runner.start
        built.append(h)
        return h

    built = []
    yield build
    for h in built:
        h.token.cancel()
        if h.runner.ident is not None:  # a failed test may not have started it
            h.runner.join(timeout=10)
        h.stub.stop()


def _uploaded(h, media_id, name="small.mkv", payload=SMALL):
    key = f"{media_id}/original/{base64.b64encode(name.encode()).decode()}"
    return h.stub.buckets.get("triton-staging", {}).get(key) == payload


def _stats(h) -> dict:
    stats = h.daemon.stats
    return {name: getattr(stats, name) for name in ("processed", "failed", "retried", "dropped")}


# the wave's counters; both packages' waves move each by the same amount
WAVE_COUNTERS = ("batch_fast_jobs", "http_small_fetches", "http_probe_cache_hits",
                 "http_pool_created", "http_pool_reuse_hits", "queue_acks_coalesced")


def _batched_wave(harness, pkg) -> dict:
    h = harness(pkg)
    before = pkg.metrics.GLOBAL.snapshot()
    for i in range(8):
        h.enqueue(f"wave-{i}", "/small.mkv")
    h.start()
    assert wait_for(lambda: h.daemon.stats.processed == 8)
    after = pkg.metrics.GLOBAL.snapshot()
    return {
        "uploaded": [_uploaded(h, f"wave-{i}") for i in range(8)],
        "stats": _stats(h),
        "deltas": {name: after.get(name, 0) - before.get(name, 0) for name in WAVE_COUNTERS},
    }


def test_batched_wave_end_to_end_with_coalescing_counters(harness):
    """N tiny jobs published as one burst run through the fast lane:
    all complete and upload correctly, the fetches ride ONE pooled
    connection (a reuse streak, not per-job dials), and the settle is
    coalesced (multiple-ack saves frames) — asserted via the metrics
    counters the fast lane reports. The JAX package's wave on the same burst
    uploads the same objects and moves the counters alike."""
    port, ref = (_batched_wave(harness, pkg) for pkg in PACKAGES)
    assert port == ref
    assert port["uploaded"] == [True] * 8
    delta = port["deltas"]
    assert delta["batch_fast_jobs"] >= 2, "fast lane never engaged"
    assert delta["http_small_fetches"] >= 2
    # one probe on a cold cache, then warm hits — never one HEAD per job
    assert delta["http_probe_cache_hits"] >= 6
    # the reuse streak: 8 GETs (+1 HEAD) over ONE dialed connection
    assert delta["http_pool_created"] == 1
    assert delta["http_pool_reuse_hits"] >= 8
    # coalesced settle: multiple-ack saved at least one frame
    assert delta["queue_acks_coalesced"] >= 1
    assert port["stats"]["failed"] == 0 and port["stats"]["retried"] == 0


def _failure_position(harness, pkg, position) -> dict:
    h = harness(pkg, max_job_retries=1)
    for i in range(8):
        path = f"/fail-{i}.mkv" if i == position else "/small.mkv"
        h.enqueue(f"fz-{i}", path)
    h.start()
    assert wait_for(lambda: h.daemon.stats.processed == 7, timeout=30)
    assert wait_for(lambda: h.daemon.stats.failed == 1, timeout=30)
    return {
        "stats": _stats(h),
        "uploaded": [_uploaded(h, f"fz-{i}") for i in range(8)],
        "dangling": h.stub.list_multipart_uploads(),
        "depth": h.broker.queue_depth("v1.download-0"),
    }


@pytest.mark.parametrize("position", [0, 3, 7], ids=["first", "middle", "last"])
def test_failure_position_settles_only_that_job(harness, position):
    """A deterministic failure at any batch position drops exactly that
    job (after its capped retries) while every batch-mate acks — and no
    multipart upload dangles anywhere; the JAX package settles the same
    burst the same way."""
    port, ref = (_failure_position(harness, pkg, position) for pkg in PACKAGES)
    assert port == ref
    # the failed job burned its own retry budget, nobody else's
    assert port["stats"]["retried"] == 1
    assert port["uploaded"] == [i != position for i in range(8)]
    assert port["dangling"] == []
    # nothing left on the broker: every delivery settled exactly once
    assert port["depth"] == 0


# -- twins of tests/test_multisource.py -----------------------------------------

PAYLOAD = os.urandom(6 * 1024 * 1024)


SEG_MIN = 256 * 1024


class _QuietThreadingServer(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        pass  # aborted connections are this suite's bread and butter


class _Origin:
    """One configurable origin server: Range + HEAD capable, with the
    failure modes the scheduler must survive — per-chunk throttling, a
    kill switch (in-flight bodies abort, new requests are refused), a
    Range-support drop after N ranged GETs, and a deterministic error
    status. Tracks requests and bytes actually handed to the socket."""

    def __init__(
        self,
        payload=PAYLOAD,
        etag='"v1"',
        chunk_sleep=0.0,
        drop_ranges_after=None,
        reject_status=None,
        accept_ranges=True,
    ):
        origin = self
        origin.requests = []
        origin.head_requests = 0
        origin.served_bytes = 0
        origin.dead = threading.Event()
        origin.ranged_gets = 0
        origin._lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                origin.head_requests += 1
                if origin.dead.is_set():
                    self.close_connection = True
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                if accept_ranges:
                    self.send_header("Accept-Ranges", "bytes")
                if etag:
                    self.send_header("ETag", etag)
                self.end_headers()

            def do_GET(self):
                rng = self.headers.get("Range")
                with origin._lock:
                    origin.requests.append(rng)
                if origin.dead.is_set():
                    self.close_connection = True
                    return
                if reject_status is not None and rng is not None:
                    self.send_response(reject_status)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                honor = rng is not None
                if honor and drop_ranges_after is not None:
                    with origin._lock:
                        origin.ranged_gets += 1
                        honor = origin.ranged_gets <= drop_ranges_after
                body = payload
                if honor:
                    lo, hi = rng[6:].split("-")
                    lo, hi = int(lo), int(hi) if hi else len(payload) - 1
                    self.send_response(206)
                    self.send_header(
                        "Content-Range", f"bytes {lo}-{hi}/{len(payload)}"
                    )
                    body = body[lo : hi + 1]
                else:
                    self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                sent = 0
                while sent < len(body):
                    if origin.dead.is_set():
                        # mid-body death: promise broken, socket down
                        self.close_connection = True
                        return
                    chunk = body[sent : sent + 64 * 1024]
                    try:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                    except OSError:
                        return  # client cancelled (endgame loser)
                    sent += len(chunk)
                    with origin._lock:
                        origin.served_bytes += len(chunk)
                    if chunk_sleep:
                        time.sleep(chunk_sleep)

        self.httpd = _QuietThreadingServer(("127.0.0.1", 0), Handler)
        threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        ).start()
        self.url = (
            f"http://127.0.0.1:{self.httpd.server_address[1]}/movie.mkv"
        )

    def kill(self):
        """In-flight bodies abort at the next chunk; new requests get
        the connection closed in their face."""
        self.dead.set()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def make_fetcher(**kwargs):
    kwargs.setdefault("segments", 4)
    kwargs.setdefault("min_segment_bytes", SEG_MIN)
    kwargs.setdefault("timeout", 5)
    kwargs.setdefault("progress_interval", 0.01)
    return SegmentedFetcher(**kwargs)


@pytest.mark.usefixtures("reset_metrics")
class TestFailover:

    def test_primary_death_completes_from_mirror_without_refetch(
        self, tmp_path, monkeypatch
    ):
        """Kill the primary once it has served real bytes: the mirror
        absorbs the returned spans and the job completes WITHOUT
        re-fetching what the journal already covers — measured at the
        disk, where re-fetched bytes cannot hide."""
        # BOTH origins paced: an unthrottled loopback mirror can finish
        # the whole job before the kill thread fires, and the test
        # would measure nothing (the bench failover arm learned the
        # same lesson)
        primary = _Origin(chunk_sleep=0.02)
        mirror = _Origin(chunk_sleep=0.005)
        write_counts = bytearray(len(PAYLOAD))
        count_lock = threading.Lock()
        real_pwrite = os.pwrite

        def counting_pwrite(fd, data, offset):
            wrote = real_pwrite(fd, data, offset)
            with count_lock:
                for off in range(offset, offset + wrote):
                    write_counts[off] = min(255, write_counts[off] + 1)
            return wrote

        monkeypatch.setattr(os, "pwrite", counting_pwrite)
        fetcher = make_fetcher(timeout=5, max_attempts=2)
        killer = None
        try:
            def kill_when_warm():
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    if primary.served_bytes >= 256 * 1024:
                        primary.kill()
                        return
                    time.sleep(0.005)

            killer = threading.Thread(target=kill_when_warm, daemon=True)
            killer.start()
            done = fetcher.fetch(
                CancelToken(), str(tmp_path), lambda u, p: None,
                primary.url, mirrors=(mirror.url,),
            )
            assert done is True, "failover fell back instead of completing"
            assert (tmp_path / "movie.mkv").read_bytes() == PAYLOAD
            assert primary.dead.is_set(), "primary outlived the kill window"
            with count_lock:
                assert all(c >= 1 for c in write_counts), "holes in the file"
                doubled = sum(1 for c in write_counts if c > 1)
            # endgame twins may re-cover a straggler's tail per rescue
            # (budget: one per source, segments are a quarter of the
            # object here); a job that re-fetched its journaled spans
            # doubles well past that
            assert doubled < len(PAYLOAD) // 2, (
                f"{doubled} bytes fetched twice: journaled spans were "
                "re-fetched after the failover"
            )
            assert metrics.GLOBAL.snapshot().get(
                "http_source_failovers", 0
            ) >= 1
        finally:
            if killer is not None:
                killer.join(timeout=30)
            fetcher.close()
            primary.close()
            mirror.close()

    def test_primary_death_e2e_zero_dangling_multiparts(self, tmp_path):
        """The CI mirror-failover smoke: the full dispatcher + streaming
        session + real S3 stub. The primary dies mid-stream; the job
        completes from the secondary and the store shows ZERO dangling
        multipart uploads. The JAX package's job over the same origins
        stores the same objects."""
        port, ref = (_failover_job(pkg, tmp_path / pkg.name) for pkg in PACKAGES)
        assert port == ref
        assert port["file_equal"], "the job's file is not the payload"
        assert port["primary_dead"], port["primary_served"]
        # the acceptance bar: nothing dangling, however the stream
        # ended (completed or invalidated mid-failover)
        assert port["dangling"] == []
        assert port["streamed_named"]  # completed streams name their keys
        assert port["stored"] == {port["key"]: PAYLOAD}


def _failover_job(pkg, base) -> dict:
    """One failover job of ``pkg``: a throttled primary killed once
    warm, a throttled mirror, the dispatcher streaming into an S3 stub."""
    primary = _Origin(chunk_sleep=0.02)
    # the mirror is throttled too (like the refetch test above): an
    # unthrottled mirror can swallow the whole payload before the slow
    # primary has served the killer's warm threshold, and the kill then
    # never fires
    mirror = _Origin(chunk_sleep=0.005)
    creds = pkg.store.Credentials(access_key="k", secret_key="s")
    killer = None
    try:
        with pkg.stub.S3Stub(credentials=creds) as stub:
            client = pkg.store.S3Client(
                stub.endpoint, creds,
                multipart_threshold=1024 * 1024,
                part_size=1024 * 1024,
            )
            uploader = pkg.store.Uploader("bucket", client)
            uploader.configure_pipeline(True, part_workers=2)
            token = pkg.cancel.CancelToken()
            base.mkdir()
            backend = pkg.fetch.HTTPBackend(
                progress_interval=0.01, timeout=5,
                segments=4, segment_min_bytes=SEG_MIN,
            )
            dispatcher = pkg.fetch.DispatchClient(token, str(base), [backend])

            def kill_when_warm():
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    if primary.served_bytes >= 256 * 1024:
                        primary.kill()
                        return
                    time.sleep(0.01)

            killer = threading.Thread(target=kill_when_warm, daemon=True)
            killer.start()
            session = uploader.streaming_session("job-failover", token)
            with pkg.progress.install(session):
                job_dir = dispatcher.download(
                    "job-failover", primary.url, mirrors=(mirror.url,),
                )
            files = pkg.scan.scan_dir(job_dir)
            streamed = session.finalize(files)
            session.close()
            with open(job_dir + "/movie.mkv", "rb") as source:
                file_equal = source.read() == PAYLOAD
            outcome = {
                "file_equal": file_equal,
                "primary_dead": primary.dead.is_set(),
                "dangling": stub.list_multipart_uploads(),
                "streamed_named": all(streamed.values()),
                "stored": {key: bytes(data) for key, data in stub.buckets.get("bucket", {}).items()},
                "key": f"job-failover/original/{base64.b64encode(b'movie.mkv').decode()}",
            }
            uploader.close()
    finally:
        if killer is not None:
            killer.join(timeout=30)
        primary.close()
        mirror.close()
    outcome["primary_served"] = None if outcome["primary_dead"] else (
        f"primary served {primary.served_bytes}b over {len(primary.requests)} requests "
        f"(mirror {mirror.served_bytes}b over {len(mirror.requests)})")
    return outcome


# -- twins of tests/test_admission_chaos.py -------------------------------------

INTERACTIVE = b"i" * (16 * 1024)


BULK = b"b" * (256 * 1024)  # above BATCH_MAX_BYTES: takes the slow lane


class ChaosHandler(http.server.BaseHTTPRequestHandler):
    """``/quick-*.mkv`` answers instantly; ``/slow-*.mkv`` advertises
    its full size then dribbles bytes until ``release`` fires — the
    slow origin a hostile bulk tenant points the worker at."""

    protocol_version = "HTTP/1.1"
    release = threading.Event()

    def log_message(self, *args):
        pass

    def _payload(self):
        return BULK if self.path.startswith("/slow") else INTERACTIVE

    def do_HEAD(self):
        body = self._payload()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        body = self._payload()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if not self.path.startswith("/slow"):
            self.wfile.write(body)
            return
        # dribble: steady sub-timeout progress, never finishing until
        # released — slow, and deliberately not "stalled"
        sent = 0
        while sent < len(body):
            if ChaosHandler.release.wait(0.05):
                break
            try:
                self.wfile.write(body[sent:sent + 1024])
                self.wfile.flush()
            except OSError:
                return  # cancelled fetch reset the connection
            sent += 1024


@pytest.fixture
def chaos():
    ChaosHandler.release = threading.Event()
    httpd = _QuietServer(("127.0.0.1", 0), ChaosHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    token = CancelToken()
    broker = MemoryBroker()
    stub = S3Stub(credentials=Credentials("k", "s")).start()
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chaos-")
    config = Config(
        broker="memory",
        base_dir=workdir,
        concurrency=2,
        max_job_retries=1,
        retry_delay=0.05,
    )
    config.batch_jobs = 8
    config.batch_wait_ms = 150.0
    config.batch_max_bytes = MAX_BYTES
    # the admission shape under test: per-tenant in-flight quota of 1
    # (the N+1st job is rejected), bulk demoted behind interactive
    config.quota_tenant_jobs = 1
    config.dlq_max_redeliver = 3
    config.dlq_retry_after_base = 5.0
    client = QueueClient(
        token, broker.connect, supervisor_interval=0.05, drain_timeout=5
    )
    client.set_prefetch(32)
    dispatcher = DispatchClient(
        token, workdir, [HTTPBackend(progress_interval=0.01, timeout=5)]
    )
    uploader = Uploader(
        config.bucket, S3Client(stub.endpoint, Credentials("k", "s"))
    )
    daemon = Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)

    producer = broker.connect().channel()
    producer.declare_exchange("v1.download")
    for i in range(2):
        name = f"v1.download-{i}"
        producer.declare_queue(name)
        producer.bind_queue(name, "v1.download", name)

    h = type("Chaos", (), {})()
    h.daemon, h.broker, h.stub, h.token = daemon, broker, stub, token
    h.config, h.base = config, base

    def enqueue(media_id, path, tenant, job_class):
        body = Download(
            media=Media(id=media_id, source_uri=f"{base}{path}")
        ).marshal()
        producer.publish(
            "v1.download", "v1.download-0", body,
            headers={TENANT_HEADER: tenant, CLASS_HEADER: job_class},
        )

    h.enqueue = enqueue
    runner.start()
    yield h
    ChaosHandler.release.set()
    token.cancel()
    runner.join(timeout=15)
    stub.stop()
    httpd.shutdown()


def _run_interactive_round(h, prefix, count):
    """Publish ``count`` interactive jobs one at a time (per-tenant
    quota is 1) and return each one's publish→uploaded latency."""
    latencies = []
    for i in range(count):
        media_id, name = f"{prefix}-{i}", f"quick-{prefix}-{i}.mkv"
        started = time.monotonic()
        h.enqueue(media_id, f"/{name}", tenant="vip", job_class="interactive")
        assert chaos_wait_for(
            lambda: _uploaded(h, media_id, name, INTERACTIVE)
        ), f"interactive job {media_id} never completed"
        latencies.append(time.monotonic() - started)
        # the quota slot frees at settlement (ms after the upload);
        # wait it out so the NEXT job is admitted, not quota-shed
        assert chaos_wait_for(
            lambda: admission.CONTROLLER.tenants()
            .get("vip", {})
            .get("inflight_jobs", 0)
            == 0
        )
    return latencies


def _p99(latencies):
    ordered = sorted(latencies)
    return ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]


def test_interactive_p99_holds_while_bulk_tenant_saturates_slow_origin(chaos):
    h = chaos
    before = metrics.GLOBAL.snapshot()
    incident.RECORDER.min_auto_interval = 0.0  # isolate from other tests
    try:
        assert chaos_wait_for(lambda: h.daemon.worker_count == 2)

        # phase 1 — solo baseline: the interactive tenant alone
        solo = _run_interactive_round(h, "solo", 8)
        solo_p99 = _p99(solo)

        # phase 2 — the bulk tenant floods: a burst against the
        # dribbling origin. Quota admits ONE (wedging at most one
        # worker); the rest are explicitly shed to the DLQ.
        for i in range(6):
            h.enqueue(
                f"bulk-{i}", f"/slow-{i}.mkv",
                tenant="batch-co", job_class="bulk",
            )
        dlq = dlq_name("v1.download")
        assert chaos_wait_for(lambda: h.broker.queue_depth(dlq) >= 5), (
            "shed jobs never reached the DLQ"
        )
        # the admitted bulk job is actually occupying a worker
        assert chaos_wait_for(
            lambda: admission.CONTROLLER.tenants()
            .get("batch-co", {})
            .get("inflight_jobs", 0)
            == 1
        )

        # phase 3 — interactive under contention: p99 holds within 2x
        # the solo baseline (floored against host-noise on tiny
        # absolute latencies; without admission this measures the
        # dribbling origin's SECONDS, so the bar discriminates)
        mixed = _run_interactive_round(h, "mixed", 8)
        mixed_p99 = _p99(mixed)
        assert mixed_p99 <= max(2 * solo_p99, 0.75), (
            f"interactive p99 degraded: solo {solo_p99:.3f}s "
            f"vs mixed {mixed_p99:.3f}s"
        )

        # the DLQ contract: Retry-After + shed count + trace context
        # on every message — a shed job keeps its logical identity
        dlq_trace_ids = set()
        for body, headers, _, _, _ in list(h.broker._queues[dlq]):
            assert headers[SHED_HEADER] == 1
            assert headers[RETRY_AFTER_HEADER] >= 1
            assert headers[TENANT_HEADER] == "batch-co"
            context = tracing.TraceContext.parse(
                headers[tracing.TRACE_CONTEXT_HEADER]
            )
            assert context is not None, "shed message lost trace context"
            dlq_trace_ids.add(context.trace_id)
            job = Download.unmarshal(body)
            assert job.media.source_uri.startswith(h.base)

        # shed accounting: quota rejects recorded, stats agree
        after = metrics.GLOBAL.snapshot()
        shed_count = after.get("admission_shed_jobs", 0) - before.get(
            "admission_shed_jobs", 0
        )
        assert shed_count >= 5
        assert after.get("admission_quota_rejects", 0) > before.get(
            "admission_quota_rejects", 0
        )
        assert h.daemon.stats.shed >= 5

        # first shed of the episode captured an incident bundle
        # tagging the offending tenant (async capture thread)
        def _admission_bundle():
            for summary in incident.RECORDER.list_incidents():
                if summary.get("trigger") == "admission":
                    return True
            return False

        assert chaos_wait_for(_admission_bundle, timeout=10), (
            "no admission incident bundle captured"
        )
        # the bundle and the DLQ message it describes share ONE trace
        # id: the flight-recorder evidence is
        # joinable with the shed message by the propagated identity
        admission_bundles = [
            incident.RECORDER.get(s["id"])
            for s in incident.RECORDER.list_incidents()
            if s.get("trigger") == "admission"
        ]
        bundle_trace_ids = {
            b["extra"].get("trace_id")
            for b in admission_bundles
            if b and b.get("extra")
        }
        assert bundle_trace_ids & dlq_trace_ids, (
            "admission incident bundle and DLQ messages share no "
            f"trace id: bundle {bundle_trace_ids} vs DLQ {dlq_trace_ids}"
        )

        # per-class SLO series populated: interactive completions
        # landed in their own histogram
        hists = metrics.GLOBAL.histograms()
        assert "slo_job_duration_seconds_interactive" in hists
        assert hists["slo_job_duration_seconds_interactive"][3] >= 16
    finally:
        incident.RECORDER.min_auto_interval = (
            incident.DEFAULT_MIN_AUTO_INTERVAL_S
        )
        # stop the dribble and drain BEFORE asserting cleanliness
        ChaosHandler.release.set()
        h.token.cancel()

    # no dangling multipart uploads, whatever the bulk job was doing
    assert chaos_wait_for(
        lambda: not h.stub.list_multipart_uploads("triton-staging")
    )


def test_stalled_tenant_is_tagged_and_quota_refunds_on_cancel():
    """The watchdog→admission hand-off: a stalled job's incident is
    tagged with its tenant lane, note_stall records the tenant, and
    (the quota half) the release hook fires on settlement even when
    settlement is a watchdog cancel path."""
    incident.RECORDER.min_auto_interval = 0.0
    monitor = watchdog.Watchdog(stall_s=10.0)
    watch = monitor.job("wedged-job")
    watch.meta.update(tenant="batch-co", job_class="bulk")
    try:
        capture_stall_incident(watch, "fetch", 42.0)
        snap = admission.CONTROLLER.snapshot()
        assert snap["stalled_tenants"].get("batch-co") == 1
        bundles = [
            b for b in incident.RECORDER.list_incidents()
            if b.get("trigger") == "watchdog"
        ]
        assert bundles, "stall incident not captured"
        bundle = incident.RECORDER.get(bundles[-1]["id"])
        assert bundle["extra"]["tenant"] == "batch-co"
        assert bundle["extra"]["job_class"] == "bulk"
    finally:
        incident.RECORDER.min_auto_interval = (
            incident.DEFAULT_MIN_AUTO_INTERVAL_S
        )
        monitor.unregister(watch)
        monitor.reset()
        admission.CONTROLLER.reset()


# -- twins of tests/test_alerts.py ----------------------------------------------

BURN_INTERACTIVE = b"i" * (8 * 1024)


class SlowHandler(http.server.BaseHTTPRequestHandler):
    """Every fetch dawdles past the (tiny) interactive SLO target —
    the origin a bulk flood drags the whole worker onto."""

    protocol_version = "HTTP/1.1"
    delay_s = 0.15

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(BURN_INTERACTIVE)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        time.sleep(SlowHandler.delay_s)
        self.send_response(200)
        self.send_header("Content-Length", str(len(BURN_INTERACTIVE)))
        self.end_headers()
        self.wfile.write(BURN_INTERACTIVE)


@pytest.mark.usefixtures("alerts_clean_state")
def test_bulk_flood_trips_interactive_burn_rate_within_fast_window(tmp_path):
    """The chaos smoke: a bulk flood saturates the single worker, the
    interactive tenant's completions blow their (tiny) SLO target, and
    the interactive burn-rate rule fires within ONE fast window — with
    /debug/alerts showing it firing and the auto-captured incident
    naming the rule."""
    incident.RECORDER.min_auto_interval = 0.0
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), SlowHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    token = CancelToken()
    broker = MemoryBroker()
    stub = S3Stub(credentials=Credentials("k", "s")).start()
    config = Config(
        broker="memory", base_dir=str(tmp_path), concurrency=1,
        max_job_retries=0, retry_delay=0.05,
    )
    client = QueueClient(
        token, broker.connect, supervisor_interval=0.05, drain_timeout=5
    )
    client.set_prefetch(32)
    dispatcher = DispatchClient(
        token, str(tmp_path),
        [HTTPBackend(progress_interval=0.01, timeout=10)],
    )
    uploader = Uploader(
        config.bucket, S3Client(stub.endpoint, Credentials("k", "s"))
    )
    daemon = Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)

    store = tsdb.TimeSeriesStore(interval_s=0.2, samples=256, downsample=8)
    fast_window = 5.0
    alerts.ENGINE.configure(
        rules=alerts.default_rules(
            slo_interactive_s=0.01,  # everything the slow origin serves burns
            fast_window_s=fast_window,
            slow_window_s=2 * fast_window,
            factor=2.0,
        ),
        interval_s=0.2,
        store=store,
    )
    health = HealthServer(daemon, client, 0).start()
    producer = broker.connect().channel()
    producer.declare_exchange("v1.download")
    for i in range(2):
        name = f"v1.download-{i}"
        producer.declare_queue(name)
        producer.bind_queue(name, "v1.download", name)

    def enqueue(media_id, job_class):
        body = Download(
            media=Media(id=media_id, source_uri=f"{base}/{media_id}.mkv")
        ).marshal()
        producer.publish(
            "v1.download", "v1.download-0", body,
            headers={TENANT_HEADER: "t", CLASS_HEADER: job_class},
        )

    pre_existing = {b["id"] for b in incident.RECORDER.list_incidents()}
    try:
        runner.start()
        store.start()
        alerts.ENGINE.start()
        assert wait_for(lambda: daemon.worker_count == 1)
        # the flood: bulk jobs occupy the worker, interactive queued
        # behind them — every interactive completion blows the target
        for i in range(4):
            enqueue(f"bulk-{i}", "bulk")
        for i in range(4):
            enqueue(f"vip-{i}", "interactive")
        fired_at = time.monotonic()
        assert wait_for(
            lambda: any(
                r.state == "firing"
                and r.name == "interactive-latency-burn"
                for r in alerts.ENGINE.rules()
            ),
            timeout=30.0,
        ), "interactive burn-rate rule never fired"
        # fired within one fast window of the burn being measurable
        assert time.monotonic() - fired_at <= fast_window + 10.0
        # /debug/alerts shows it firing
        with urllib.request.urlopen(
            f"http://127.0.0.1:{health.port}/debug/alerts"
        ) as resp:
            payload = json.loads(resp.read())
        states = {r["name"]: r["state"] for r in payload["rules"]}
        assert states["interactive-latency-burn"] == "firing"
        assert payload["firing"] >= 1
        # the auto-captured incident names the rule
        def _fresh_alert_bundles():
            return [
                b for b in incident.RECORDER.list_incidents()
                if b.get("trigger") == "alert"
                and b["id"] not in pre_existing
            ]

        assert wait_for(
            lambda: len(_fresh_alert_bundles()) > 0
        ), "no alert incident captured"
        bundles = [
            incident.RECORDER.get(b["id"])
            for b in _fresh_alert_bundles()
        ]
        named = [
            b for b in bundles
            if b and b["extra"]["rule"] == "interactive-latency-burn"
        ]
        assert named, "no incident names the burn-rate rule"
        assert (
            named[-1]["extra"]["series"]
            == "slo_job_duration_seconds_interactive"
        )
    finally:
        incident.RECORDER.min_auto_interval = (
            incident.DEFAULT_MIN_AUTO_INTERVAL_S
        )
        alerts.ENGINE.reset()
        store.reset()
        health.stop()
        token.cancel()
        runner.join(timeout=15)
        stub.stop()
        httpd.shutdown()


# -- twins of tests/test_telemetry.py -------------------------------------------

MOVIE = b"\x1aFAKEMKV" * 1024


class TraceWedgeHandler(http.server.BaseHTTPRequestHandler):
    """First GET wedges (headers sent, then silence) until released;
    later GETs serve normally — attempt 0 stalls, a retry would work."""

    protocol_version = "HTTP/1.1"
    release = threading.Event()
    wedged_once = False

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(MOVIE)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(MOVIE)))
        self.end_headers()
        if not TraceWedgeHandler.wedged_once:
            TraceWedgeHandler.wedged_once = True
            # half the payload, then silence with the socket open: the
            # canonical wedge — no data, no error
            self.wfile.write(MOVIE[: len(MOVIE) // 2])
            self.wfile.flush()
            TraceWedgeHandler.release.wait(30.0)
            return
        self.wfile.write(MOVIE)


@contextlib.contextmanager
def wedge_daemon(pkg, base_dir):
    """A wired daemon of ``pkg`` over the wedge origin, the watchdog
    armed to cancel a sub-second stall into the retry path."""
    TraceWedgeHandler.release = threading.Event()
    TraceWedgeHandler.wedged_once = False
    httpd = _QuietServer(("127.0.0.1", 0), TraceWedgeHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    token = pkg.cancel.CancelToken()
    broker = pkg.queue.MemoryBroker()
    stub = pkg.stub.S3Stub(credentials=pkg.store.Credentials("k", "s")).start()
    config = pkg.config.Config(
        broker="memory", base_dir=base_dir, concurrency=1,
        max_job_retries=2, retry_delay=0.05,
    )
    client = pkg.queue.QueueClient(
        token, broker.connect, supervisor_interval=0.05, drain_timeout=5
    )
    client.set_prefetch(8)
    dispatcher = pkg.fetch.DispatchClient(
        token, base_dir,
        [
            pkg.fetch.HTTPBackend(
                # socket timeout shorter than the wedge hold so the
                # watchdog's cancel takes effect at the next read
                progress_interval=0.01, timeout=2.0, zero_copy=False,
                segments=1,
            )
        ],
    )
    uploader = pkg.store.Uploader(
        config.bucket, pkg.store.S3Client(stub.endpoint, pkg.store.Credentials("k", "s"))
    )
    daemon = pkg.app.Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)

    monitor = pkg.watchdog.MONITOR
    monitor.reset()
    monitor.configure(
        stall_s=0.6, action="cancel", stage_overrides={},
        on_stall=pkg.app.capture_stall_incident,
    )
    monitor.start(poll_interval=0.1)
    pkg.incident.RECORDER.min_auto_interval = 0.0

    producer = broker.connect().channel()
    producer.declare_exchange("v1.download")
    for i in range(2):
        name = f"v1.download-{i}"
        producer.declare_queue(name)
        producer.bind_queue(name, "v1.download", name)

    class H:
        pass

    h = H()
    h.daemon, h.broker, h.stub = daemon, broker, stub
    h.base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def enqueue(media_id, url, headers=None):
        body = pkg.wire.Download(media=pkg.wire.Media(id=media_id, source_uri=url)).marshal()
        producer.publish(
            "v1.download", "v1.download-0", body, headers=headers or {}
        )

    h.enqueue = enqueue
    runner.start()
    try:
        yield h
    finally:
        TraceWedgeHandler.release.set()
        token.cancel()
        runner.join(timeout=15)
        pkg.incident.RECORDER.min_auto_interval = (
            pkg.incident.DEFAULT_MIN_AUTO_INTERVAL_S
        )
        monitor.reset()
        stub.stop()
        httpd.shutdown()


def _trace_walk(pkg, base_dir) -> dict:
    """The wedge → cancel → retry → shed walk through ``pkg``'s daemon
    under one producer-minted trace id: what each surface shows of it."""
    tracing, incident, delivery = pkg.tracing, pkg.incident, pkg.delivery
    with wedge_daemon(pkg, base_dir) as h:
        ctx = tracing.TraceContext.mint()
        trace_id = ctx.trace_id
        pre_existing = {b["id"] for b in incident.RECORDER.list_incidents()}
        h.enqueue(
            "wedge-1", f"{h.base}/wedge-1.mkv",
            headers={
                tracing.TRACE_CONTEXT_HEADER: ctx.header_value(),
                delivery.TENANT_HEADER: "t-wedge",
                delivery.CLASS_HEADER: "bulk",
            },
        )
        # attempt 0 is admitted and wedged once the origin sees its GET;
        # trip the ledger NOW — before the watchdog cancel republishes —
        # so the redelivered attempt meets the shed rung at admission
        assert wait_for_20(lambda: TraceWedgeHandler.wedged_once, timeout=10), (
            "the wedge origin never saw the fetch"
        )
        pkg.admission.LEDGER.configure({"disk": 100})
        pkg.admission.LEDGER.charge("disk", "telemetry-pressure", 100)
        try:
            # the watchdog cancels the wedged attempt into the retry path
            assert wait_for_20(
                lambda: h.daemon.stats.retried >= 1, timeout=15
            ), "watchdog never cancelled the wedged attempt into retry"
            dlq = delivery.dlq_name("v1.download")
            assert wait_for_20(
                lambda: h.broker.queue_depth(dlq) >= 1, timeout=15
            ), "retried attempt was never shed to the DLQ"
            body, headers, _, _, _ = list(h.broker._queues[dlq])[0]
            dlq_ctx = tracing.TraceContext.parse(headers[tracing.TRACE_CONTEXT_HEADER])

            def fresh(trigger):
                return [
                    incident.RECORDER.get(b["id"])
                    for b in incident.RECORDER.list_incidents()
                    if b.get("trigger") == trigger
                    and b["id"] not in pre_existing
                ]

            assert wait_for_20(lambda: len(fresh("watchdog")) >= 1, timeout=10)
            assert wait_for_20(lambda: len(fresh("admission")) >= 1, timeout=10)
            attempts = tracing.TRACER.lineage(trace_id)
            return {
                "dlq": {
                    "same_trace": dlq_ctx is not None and dlq_ctx.trace_id == trace_id,
                    "attempt": dlq_ctx.attempt if dlq_ctx else None,
                    "shed": headers[delivery.SHED_HEADER],
                    "media_id": pkg.wire.Download.unmarshal(body).media.id,
                },
                "first_attempt": {key: attempts[0][key] for key in ("job_id", "attempt", "status")}
                if attempts else None,
                "log_ring": any(
                    record.get("trace_id") == trace_id for record in pkg.logging.ring_tail()
                ),
                "watchdog_bundle": any(
                    b and b.get("trace") and b["trace"].get("trace_id") == trace_id
                    for b in fresh("watchdog")
                ),
                "shed_bundle": any(
                    b and b.get("extra", {}).get("trace_id") == trace_id
                    for b in fresh("admission")
                ),
            }
        finally:
            pkg.admission.LEDGER.refund("telemetry-pressure")
            TraceWedgeHandler.release.set()


@pytest.mark.usefixtures("telemetry_clean_tracer")
def test_one_trace_id_across_cancel_retry_and_shed(tmp_path):
    """The acceptance walk: dequeued → wedged in fetch → watchdog
    cancel → retry republish → ledger tripped → shed to DLQ. ONE trace
    id on every surface, in the port as in the JAX package."""
    port, ref = (_trace_walk(pkg, str(tmp_path / pkg.name)) for pkg in PACKAGES)
    assert port == ref
    # 1. the DLQ message carries the SAME trace id
    assert port["dlq"]["same_trace"]
    assert port["dlq"]["attempt"] >= 2  # producer 0 → retry 1 → shed 2
    assert port["dlq"]["shed"] == 1
    assert port["dlq"]["media_id"] == "wedge-1"
    # 2. /debug/trace lineage links the attempt(s) under that id
    assert port["first_attempt"] == {"job_id": "wedge-1", "attempt": 0, "status": "retried"}
    # 3. the log ring correlates records by the propagated id
    assert port["log_ring"], "no log-ring record carries the trace id"
    # 4. incident bundles: the watchdog capture embeds the trace, the
    # admission shed capture names the id in extra
    assert port["watchdog_bundle"], "watchdog incident does not embed the propagated trace"
    assert port["shed_bundle"], "admission shed incident does not name the trace id"


# -- twins of tests/test_flows.py -----------------------------------------------

FLOW_CREDS = Credentials(access_key="ak", secret_key="sk")
FLOW_BUCKET = "flow-bkt"


def _wait(predicate, timeout: float, what: str, interval: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _fleet_merges(pkg) -> dict:
    """Two workers' flow snapshots of one object merged by ``pkg``: each
    fetched it once, then each fetched it twice."""
    flows_mod = pkg.flows
    obj = flows_mod.object_key("http://origin/hot.bin")
    out = {}
    for label, ingress in (("once", 1000), ("twice", 2000)):
        snaps = {}
        for worker in ("worker-0", "worker-1"):
            ledger = flows_mod.FlowLedger()
            ledger.note_ingress(obj, "origin", "mirror", ingress)
            ledger.note_unique(obj, 1000)
            snaps[worker] = ledger.snapshot()
        out[label] = {
            "naive_average": sum(s["origin_amplification"] for s in snaps.values()) / len(snaps),
            "merged": flows_mod.merge_flow_snapshots(snaps),
        }
    return out


@pytest.mark.usefixtures("flow_isolation")
def test_fleet_merge_sums_bytes_never_averages_ratios():
    """THE regression this plane exists for: two workers each fetch the
    same object once. Each worker's local amplification is a healthy
    1.0 — the fleet fetched the object twice to serve ONE unique copy,
    so fleet amplification is 2.0. Averaging the per-worker ratios
    would report 1.0 and hide the redundancy entirely. The JAX
    package merges the same snapshots to the same view."""
    port, ref = (_fleet_merges(pkg) for pkg in PACKAGES)
    assert port == ref
    once = port["once"]
    merged = once["merged"]
    assert once["naive_average"] == pytest.approx(1.0)
    assert merged["workers"] == 2
    assert merged["ingress_bytes"] == 2000
    assert merged["unique_bytes"] == 1000  # MAX per object, then summed
    assert merged["origin_amplification"] == pytest.approx(2.0)
    assert merged["origin_amplification"] != pytest.approx(once["naive_average"])
    # per-instance ratios ride along for the debug view
    assert set(merged["instances"]) == {"worker-0", "worker-1"}

    # and when each worker is ITSELF amplified (each fetched the same
    # object twice), the fleet ratio compounds: 4 fetches, one copy
    twice = port["twice"]
    assert twice["merged"]["origin_amplification"] == pytest.approx(4.0)
    assert twice["naive_average"] == pytest.approx(2.0)


class _FlowOrigin:
    """Throttled HTTP/1.1 origin: HEAD announces size + ranges, GET
    streams at a byte-rate cap so ``fetch`` is each job's dominant
    stage."""

    def __init__(self, objects, rate):
        origin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                payload = origin.objects.get(self.path)
                if payload is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                payload = origin.objects.get(self.path)
                with origin.lock:
                    origin.gets[self.path] = (
                        origin.gets.get(self.path, 0) + 1
                    )
                if payload is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                try:
                    chunk = 16 * 1024
                    for offset in range(0, len(payload), chunk):
                        piece = payload[offset:offset + chunk]
                        self.wfile.write(piece)
                        self.wfile.flush()
                        time.sleep(len(piece) / origin.rate)
                except OSError:
                    return

        self.objects = dict(objects)
        self.rate = float(rate)
        self.gets = {}
        self.lock = threading.Lock()
        self._server = socketserver.ThreadingTCPServer(
            ("127.0.0.1", 0), Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


def _worker_env(broker, s3, base_dir):
    return {
        "BROKER": "amqp",
        "RABBITMQ_ENDPOINT": broker.endpoint,
        "RABBITMQ_USERNAME": "",
        "RABBITMQ_PASSWORD": "",
        "S3_ENDPOINT": f"http://{s3.endpoint}",
        "S3_ACCESS_KEY": FLOW_CREDS.access_key,
        "S3_SECRET_KEY": FLOW_CREDS.secret_key,
        "BUCKET": FLOW_BUCKET,
        "DOWNLOAD_DIR": base_dir,
        "JOB_CONCURRENCY": "1",
        "PREFETCH": "1",
        "BATCH_JOBS": "1",
        "HTTP_SEGMENTS": "1",
        "S3_MULTIPART_THRESHOLD": str(512 * 1024),
        "S3_PART_SIZE": str(512 * 1024),
        "PROFILE": "0",
        "TSDB_INTERVAL": "0.3",
        "ALERT_INTERVAL": "off",
        "LSD": "off",
        "DHT_BOOTSTRAP": "off",
        "WATCHDOG_STALL_S": "600",
        "MAX_JOB_RETRIES": "50",
        "RETRY_DELAY": "0.3",
        "RETRY_DELAY_CAP": "1.0",
        "PUBLISH_CONFIRM_TIMEOUT": "10",
        "FAILPOINT_SPEC": "",
        "LOG_LEVEL": "info",
    }


def _declare_topology(channel, topic):
    channel.declare_exchange(topic)
    for index in range(2):
        name = f"{topic}-{index}"
        channel.declare_queue(name)
        channel.bind_queue(name, topic, name)


def _publish_job(broker, media_id, url):
    context = tracing.TraceContext.mint()
    connection = broker.broker.connect()
    try:
        channel = connection.channel()
        _declare_topology(channel, "v1.download")
        channel.publish(
            "v1.download",
            "v1.download-0",
            Download(media=Media(id=media_id, source_uri=url)).marshal(),
            headers={
                tracing.TRACE_CONTEXT_HEADER: context.header_value()
            },
            persistent=True,
        )
        channel.close()
    finally:
        connection.close()
    return context


class _ConvertSink:
    def __init__(self, broker):
        self.received = []
        self._lock = threading.Lock()
        self._connection = broker.broker.connect()
        channel = self._connection.channel()
        channel.set_prefetch(100)
        _declare_topology(channel, "v1.convert")

        def on_message(message, ch=channel):
            convert = Convert.unmarshal(message.body)
            with self._lock:
                self.received.append(
                    convert.media.id if convert.media else ""
                )
            ch.ack(message.delivery_tag)

        for index in range(2):
            channel.consume(f"v1.convert-{index}", on_message)

    def snapshot(self):
        with self._lock:
            return list(self.received)

    def close(self):
        self._connection.close()


def _fleet_get(port: int, path: str, timeout: float = 10.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        response = conn.getresponse()
        return response.status, response.read()
    finally:
        conn.close()


def _zipf_sizes(count: int, mean_bytes: int) -> "list[int]":
    """An inline zipf(1.1) size ladder (bench.py's generator stays out
    of this process — it configures logging at import)."""
    weights = [(rank + 1) ** -1.1 for rank in range(count)]
    scale = mean_bytes * count / sum(weights)
    return [max(16 * 1024, int(weight * scale)) for weight in weights]


@pytest.mark.usefixtures("flow_isolation")
def test_e2e_fleet_flows_zipf_wave_amplification(tmp_path):
    """The flow plane's acceptance walk: 2 real workers drain a zipf flash
    crowd in which every object is demanded TWICE. Whichever worker
    takes which copy, the fleet fetched each object twice to serve one
    unique copy — so the fleet ``/debug/flows`` must report origin
    amplification within 10% of the worker count (the per-object MAX
    merge rule), name the head-of-zipf object as the top heavy hitter,
    and ``/debug/critpath`` must name the throttled ``fetch`` stage as
    where the wave's p99 lives."""
    sizes = _zipf_sizes(6, 48 * 1024)
    objects = {
        f"/zipf_{index:03d}.bin": os.urandom(size)
        for index, size in enumerate(sizes)
    }
    total_unique = sum(sizes)
    with S3Stub(FLOW_CREDS) as s3, AmqpServerStub() as broker, _FlowOrigin(
        objects, rate=192 * 1024
    ) as origin:
        supervisor = FleetSupervisor(
            FleetConfig(
                workers=2,
                heartbeat_s=0.2,
                stall_s=30.0,
                restart_backoff_s=0.1,
                restart_backoff_cap_s=0.5,
                start_grace_s=40.0,
                drain_s=10.0,
                scrape_timeout_s=2.0,
            ),
            worker_env=_worker_env(broker, s3, str(tmp_path)),
        )
        sink = None
        health = None
        try:
            supervisor.start()
            _wait(
                lambda: all(
                    slot["ready"]
                    for slot in supervisor.snapshot()["slots"]
                ),
                60.0,
                "both real workers ready",
            )
            sink = _ConvertSink(broker)
            # the flash crowd: every object published twice
            expected = set()
            for index, path in enumerate(sorted(objects)):
                for copy in ("a", "b"):
                    media_id = f"zipf-{index}-{copy}"
                    expected.add(media_id)
                    _publish_job(broker, media_id, f"{origin.url}{path}")
            _wait(
                lambda: set(sink.snapshot()) >= expected,
                120.0,
                "the whole zipf wave to complete",
            )

            health = FleetHealthServer(supervisor, 0, "127.0.0.1").start()
            status, body = _fleet_get(health.port, "/debug/flows")
            assert status == 200
            fleet = json.loads(body)
            assert fleet["workers"] == 2
            assert not fleet.get("errors")
            # each object fetched twice, one unique copy: amplification
            # within 10% of the worker count
            assert fleet["unique_bytes"] == total_unique
            assert fleet["ingress_bytes"] >= 2 * total_unique
            amplification = fleet["origin_amplification"]
            assert amplification == pytest.approx(2.0, rel=0.1), (
                f"fleet amplification {amplification}, want ~2.0"
            )
            # the head-of-zipf object is NAMED, not just counted
            hitters = fleet["heavy_hitters"]
            assert hitters, "no heavy hitters over a 12-job wave"
            assert hitters[0]["key"].endswith("zipf_000.bin")
            assert hitters[0]["bytes"] >= 2 * sizes[0]
            # the origin host dimension survived the fold
            assert any(
                entry["by_kind"].get("mirror")
                for entry in fleet["origins"].values()
            ), f"no mirror-lane origin attribution: {fleet['origins']}"

            # the ?hitters= bound caps the fleet listing too
            status, body = _fleet_get(
                health.port, "/debug/flows?hitters=2"
            )
            assert status == 200
            assert len(json.loads(body)["heavy_hitters"]) <= 2

            status, body = _fleet_get(health.port, "/debug/critpath")
            assert status == 200
            critpath = json.loads(body)
            assert critpath["workers"] == 2
            completed = [
                job for job in critpath["per_job"]
                if job["status"] == "ok"
            ]
            assert len(completed) >= len(expected)
            assert {job["instance"] for job in critpath["per_job"]} <= {
                "worker-0", "worker-1",
            }
            # the throttled fetch gates the wave: the slow cohort names
            # it, and it gates every completed job (the chain then
            # descends INSIDE fetch — the dominant exclusive share
            # lands on its transfer-loop descendant, naming where the
            # wait actually lives)
            assert critpath["slow"]["gating_stage"] == "fetch", (
                f"slow cohort gated by {critpath['slow']['gating_stage']}"
            )
            assert critpath["stages"]["fetch"]["jobs_gated"] >= len(
                expected
            ), f"fetch does not gate the wave: {critpath['stages']}"
            dominant = max(
                critpath["stages"].items(), key=lambda kv: kv[1]["share"]
            )[0]
            fetch_chain_stages = {
                entry["name"]
                for job in completed
                for entry in job["chain"]
                if entry["depth"] > 0
            }
            assert dominant in fetch_chain_stages, (
                f"dominant stage {dominant} not on the fetch-bound "
                f"chains: {sorted(fetch_chain_stages)}"
            )

            if os.environ.get("FLOW_SMOKE_ARTIFACT_DIR"):
                out_dir = os.environ["FLOW_SMOKE_ARTIFACT_DIR"]
                os.makedirs(out_dir, exist_ok=True)
                with open(
                    os.path.join(out_dir, "flow-smoke.json"), "w"
                ) as artifact:
                    json.dump(
                        {"flows": fleet, "critpath": critpath},
                        artifact,
                        indent=1,
                    )
        finally:
            if health is not None:
                health.stop()
            if sink is not None:
                sink.close()
            supervisor.drain()


# -- twins of tests/test_canary.py ----------------------------------------------

@pytest.fixture
def canary_harness(tmp_path):
    token = CancelToken()
    broker = MemoryBroker()
    from downloader_tpu_torch.store.stub import S3Stub

    stub = S3Stub(credentials=Credentials("k", "s")).start()
    config = Config(
        broker="memory", base_dir=str(tmp_path), concurrency=1,
        max_job_retries=1, retry_delay=0.05,
    )
    client = QueueClient(
        token, broker.connect, supervisor_interval=0.05, drain_timeout=5
    )
    client.set_prefetch(8)
    dispatcher = DispatchClient(
        token, str(tmp_path),
        [
            HTTPBackend(
                progress_interval=0.01, timeout=2.0, zero_copy=False,
                segments=1,
            )
        ],
    )
    uploader = Uploader(
        config.bucket, S3Client(stub.endpoint, Credentials("k", "s"))
    )
    daemon = Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)

    incident.RECORDER.min_auto_interval = 0.0
    # a long interval parks the prober loop; tests drive probes
    # synchronously through run_probe_pair() / trigger()
    prober = canary.CanaryProber(
        client, uploader,
        consume_topic=config.consume_topic,
        publish_topic=config.publish_topic,
        interval_s=600.0, timeout_s=15.0, instance="w0",
    )
    runner.start()
    prober.start()
    canary.ACTIVE = prober

    class H:
        pass

    h = H()
    h.daemon, h.broker, h.stub = daemon, broker, stub
    h.client, h.prober, h.config = client, prober, config
    yield h
    canary.ACTIVE = None
    failpoints.FAILPOINTS.reset()
    prober.stop()
    token.cancel()
    runner.join(timeout=15)
    incident.RECORDER.min_auto_interval = (
        incident.DEFAULT_MIN_AUTO_INTERVAL_S
    )
    watchdog.MONITOR.reset()
    stub.stop()


@pytest.mark.usefixtures("canary_clean_state")
def test_canary_detects_silent_corruption_within_one_interval(
    canary_harness, tmp_path
):
    """THE proof obligation (and the CI canary-smoke test): a
    failpoint-injected byte flip past digest verification — every
    passive check green — is caught by the next probe's read-back,
    the ``canary-failure`` rule fires naming the instance, and the
    passive burn rules stay silent."""
    h = canary_harness
    pre_existing = {b["id"] for b in incident.RECORDER.list_incidents()}
    failpoints.FAILPOINTS.configure("canary.corrupt=fail:1")
    engine = alerts.AlertEngine(rules=alerts.default_rules())
    try:
        # drive the prober through its OWN loop (trigger wakes the
        # interval wait immediately): detection happens within one
        # probe cycle, not via a bespoke synchronous call
        h.prober.trigger()
        assert wait_for_20(lambda: h.prober.failing, timeout=30), (
            "silent corruption survived a full probe cycle undetected"
        )
        card = h.prober.scorecard()
        failed = [p for p in card["probes"] if not p["ok"]]
        assert failed, "failing episode without a failed verdict"
        assert any(
            p["error"] and p["error"].startswith("integrity:")
            and p["stages"]["publish"] and p["stages"]["convert"]
            for p in failed
        ), failed
        assert metrics.GLOBAL.gauges().get("canary_failing") == 1.0

        # the page rule fires — and ONLY the canary rule: every
        # passive burn/threshold rule still reads green
        fired = engine.evaluate()
        assert [rule.name for rule in fired] == ["canary-failure"]
        for rule in engine.rules():
            if rule.name != "canary-failure":
                assert rule.state != "firing", rule.name

        # first failure of the episode captured one incident bundle
        # naming the instance (capture runs on the prober thread and
        # snapshots thread dumps + the profile tail: give it a moment)
        def canary_bundles():
            return [
                incident.RECORDER.get(b["id"])
                for b in incident.RECORDER.list_incidents()
                if b.get("trigger") == "canary"
                and b["id"] not in pre_existing
            ]

        assert wait_for_20(lambda: canary_bundles(), timeout=15), (
            "no canary incident captured"
        )
        bundles = canary_bundles()
        assert bundles[0]["extra"]["instance"] == "w0"
        assert "canary probe failed" in bundles[0]["reason"]

        # the fleet twin names the sick instance from the per-worker
        # gauge roster
        from downloader_tpu_torch.daemon.fleetplane import FleetCanaryRule

        twin = FleetCanaryRule(
            "fleet-canary-failure", "fleet:canary_failing",
            provider=lambda: {
                "w0": metrics.GLOBAL.gauges().get("canary_failing"),
                "w1": 0.0,
            },
        )
        view = alerts.RegistryView(None)
        assert twin.evaluate(view, time.time()) == "firing"
        assert twin.last_detail["instance"] == "w0"

        # the CI smoke uploads the fleet-merged scorecard as evidence
        artifact_dir = os.environ.get("CANARY_SMOKE_ARTIFACT_DIR")
        if artifact_dir:
            from downloader_tpu_torch.daemon.fleetplane import FleetQueryPlane

            health = HealthServer(h.daemon, h.client, port=0).start()
            try:
                plane = FleetQueryPlane(
                    lambda: [("w0", health.port)], timeout_s=5.0
                )
                _, body, _ = plane.debug_canary()
            finally:
                health.stop()
            out = os.path.join(artifact_dir, "fleet-canary-scorecard.json")
            with open(out, "wb") as sink:
                sink.write(body)

        # recovery: the next clean probe pair closes the episode
        failpoints.FAILPOINTS.reset()
        verdicts = h.prober.run_probe_pair()
        assert all(v["ok"] for v in verdicts)
        assert h.prober.failing is False
        assert metrics.GLOBAL.gauges().get("canary_failing") == 0.0
    finally:
        failpoints.FAILPOINTS.reset()
        engine.reset()


@pytest.mark.usefixtures("canary_clean_state")
def test_probe_wave_excluded_from_passive_signals(canary_harness):
    """The exclusion invariants: a probe wave adds ZERO observations to
    the user SLO histograms and leaves the flow ledger's totals,
    amplification ratio and heavy-hitter sketch EXACTLY unchanged."""
    h = canary_harness
    flows.LEDGER.configure(enabled=True)
    # seed real signals first: one normal bulk job via the probe origin
    movie = b"\x1aFAKEMKV" * 512
    url = h.prober.origin.register("/user/real-movie.mkv", movie)
    producer = h.broker.connect().channel()
    producer.declare_exchange("v1.download")
    producer.declare_queue("v1.download-0")
    producer.bind_queue("v1.download-0", "v1.download", "v1.download-0")
    body = Download(media=Media(id="real-1", source_uri=url)).marshal()
    producer.publish(
        "v1.download", "v1.download-0", body,
        headers={CLASS_HEADER: "bulk", TENANT_HEADER: "t-user"},
    )
    assert wait_for_20(lambda: h.daemon.stats.processed >= 1)
    h.prober.origin.unregister("/user/real-movie.mkv")

    def slo_counts():
        hists = metrics.GLOBAL.histograms()
        return {
            name: hists[name][3]
            for name in (
                "slo_job_duration_seconds_interactive",
                "slo_job_duration_seconds_bulk",
            )
            if name in hists
        }

    before_slo = slo_counts()
    assert before_slo.get("slo_job_duration_seconds_bulk", 0) >= 1
    before_flows = flows.LEDGER.snapshot()
    assert before_flows["ingress_bytes"] >= len(movie)

    verdicts = h.prober.run_probe_pair()
    assert all(v["ok"] for v in verdicts), verdicts

    assert slo_counts() == before_slo, (
        "canary probes leaked into the user SLO histograms"
    )
    after_flows = flows.LEDGER.snapshot()
    for field in (
        "ingress_bytes", "unique_bytes", "egress_bytes",
        "cache_hit_bytes", "origin_amplification", "hot_object_share",
    ):
        assert after_flows[field] == before_flows[field], field
    assert after_flows["origins"] == before_flows["origins"]
    assert after_flows["heavy_hitters"] == before_flows["heavy_hitters"]


# -- twins of tests/test_profiling.py -------------------------------------------

@pytest.fixture
def plane():
    """Fresh plane state per test: the process-wide profiler stopped
    and cleared, the role registry forgotten, the enabled flag
    restored (tests flip it to exercise the PROFILE=0 stubs)."""
    was_enabled = profiling._ENABLED
    yield profiling
    profiling.PROFILER.reset()
    profiling.PROFILER.configure(
        interval_ms=profiling.DEFAULT_INTERVAL_MS,
        heap_interval_s=profiling.DEFAULT_HEAP_S,
    )
    profiling.ROLES.reset()
    profiling._ENABLED = was_enabled


def test_profiler_overhead_bounded(plane):
    """Profiler-on vs profiler-off <= 0.5 ms/job (same pattern as the
    watchdog/telemetry guards): a job-shaped loop — watch lifecycle,
    stage beats, 40 named-lock crossings — with the sampler live at a
    production-tight 5 ms tick against the same loop with the plane
    dark. The job path's only profiling cost is the named-lock
    try-acquire; the sampler runs off-thread."""
    plane._ENABLED = True
    monitor = watchdog.Watchdog(stall_s=120.0)
    locks = [
        NamedLock("pipeline_session", threading.Lock()),
        NamedLock("queue_client", threading.RLock()),
    ]

    def one_job():
        watch = monitor.job("bench")
        with watchdog.install(watch):
            hb = watch.stage("fetch")
            for _ in range(32):
                hb.beat(1024)
                with locks[0]:
                    pass
            watch.stage("upload")
            for _ in range(8):
                with locks[1]:
                    pass
            watch.stage("publish")
        monitor.unregister(watch)

    def median_ms(reps=200):
        laps = []
        for _ in range(reps):
            start = time.perf_counter()
            one_job()
            laps.append(time.perf_counter() - start)
        laps.sort()
        return laps[len(laps) // 2] * 1000

    profiler = SamplingProfiler(interval_ms=5)
    delta = None
    try:
        for _ in range(3):  # remeasure: shared 1-vCPU hosts burst
            one_job()  # warm
            off_ms = median_ms()
            profiler.start()
            time.sleep(0.02)  # the sampler is genuinely ticking
            on_ms = median_ms()
            profiler.stop()
            delta = on_ms - off_ms
            if delta <= 0.5:
                break
    finally:
        profiler.reset()
        monitor.reset()
    assert delta is not None and delta <= 0.5, (
        f"profiler adds {delta:.3f} ms/job — over the 0.5 ms budget"
    )


PROFILED_SMALL = b"x" * (16 * 1024)


class _PayloadHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(PROFILED_SMALL)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(PROFILED_SMALL)))
        self.end_headers()
        self.wfile.write(PROFILED_SMALL)


class _ProfiledServer(http.server.ThreadingHTTPServer):
    """Registers its per-request handler threads so the e2e's
    attribution covers the test rig the way bench's out-of-process
    servers simply aren't sampled at all."""

    def handle_error(self, request, client_address):
        pass

    def process_request_thread(self, request, client_address):
        profiling.ROLES.register_current("test-origin")
        super().process_request_thread(request, client_address)


def test_e2e_profiled_small_job_wave(plane, tmp_path):
    """The acceptance criteria, tier-1 sized: a wave of small jobs
    through the full daemon with the sampler at 2 ms — samples
    attribute >=90% to named roles, cpu/wait/heap modes all serve
    collapsed + SVG, the wait profile names a real guarded-by lock,
    and an incident bundle embeds the profile tail."""
    from downloader_tpu_torch.daemon.app import Daemon
    from downloader_tpu_torch.daemon.config import Config
    from downloader_tpu_torch.fetch import DispatchClient, HTTPBackend
    from downloader_tpu_torch.queue import MemoryBroker, QueueClient
    from downloader_tpu_torch.store import Credentials, S3Client, Uploader
    from downloader_tpu_torch.store.stub import S3Stub
    from downloader_tpu_torch.utils import incident
    from downloader_tpu_torch.utils.cancel import CancelToken
    from downloader_tpu_torch.wire import Download, Media

    plane._ENABLED = True
    profiling.PROFILER.configure(
        interval_ms=2.0, heap_interval_s=0.2
    )
    # threads left running by EARLIER suites (lingering daemon
    # threads, jax pools) are environment, not the system under
    # measurement: register them up front so the >=90% bar judges the
    # plane's spawn-surface coverage, exactly as serve() would have
    # registered them at their real spawn sites
    for alive in threading.enumerate():
        if alive.ident is not None:
            profiling.ROLES.register_thread(alive, "preexisting")
    # threading.enumerate() misses threads started with
    # _thread.start_new_thread, which the sampler sees all the same: in
    # a pytest-xdist worker, execnet's receiver reads its pipe for the
    # whole test, and its samples alone put the JAX package's copy of
    # this test under the bar there. Sweep every thread with a frame.
    for ident in sys._current_frames():
        if profiling.ROLES.role_of(ident) is None:
            profiling.ROLES.register_thread(types.SimpleNamespace(ident=ident), "preexisting")
    profiling.PROFILER.start()
    profiling.ROLES.register_current("test-harness")

    httpd = _ProfiledServer(("127.0.0.1", 0), _PayloadHandler)
    accept_thread = threading.Thread(
        target=httpd.serve_forever, daemon=True
    )
    accept_thread.start()
    profiling.ROLES.register_thread(accept_thread, "test-origin")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    token = CancelToken()
    broker = MemoryBroker()
    stub = S3Stub(credentials=Credentials("k", "s")).start()
    # the stub's accept thread + per-request threads are test rig;
    # register them like the origin's so the >=90% bar measures the
    # plane, not the harness (production spawn surfaces register
    # themselves)
    profiling.ROLES.register_thread(stub._thread, "test-stub")
    real_process = type(stub._server).process_request_thread

    def stub_process(request, client_address):
        profiling.ROLES.register_current("test-stub")
        real_process(stub._server, request, client_address)

    stub._server.process_request_thread = stub_process
    config = Config(
        broker="memory",
        base_dir=str(tmp_path),
        concurrency=2,
        max_job_retries=1,
        retry_delay=0.05,
    )
    config.batch_jobs = 8
    config.batch_wait_ms = 50.0
    config.batch_max_bytes = 64 * 1024
    client = QueueClient(
        token, broker.connect, supervisor_interval=0.05, drain_timeout=5
    )
    client.set_prefetch(32)
    dispatcher = DispatchClient(
        token,
        str(tmp_path),
        [HTTPBackend(progress_interval=0.01, timeout=5)],
    )
    uploader = Uploader(
        config.bucket, S3Client(stub.endpoint, Credentials("k", "s"))
    )
    daemon = Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)

    producer = broker.connect().channel()
    producer.declare_exchange("v1.download")
    for i in range(2):
        name = f"v1.download-{i}"
        producer.declare_queue(name)
        producer.bind_queue(name, "v1.download", name)

    jobs = 40
    incident.RECORDER.reset()
    try:
        for i in range(jobs):
            body = Download(
                media=Media(id=f"prof-{i}", source_uri=f"{base}/s.mkv")
            ).marshal()
            producer.publish("v1.download", "v1.download-0", body)
        runner.start()
        profiling.ROLES.register_thread(runner, "test-harness")
        assert profiling_wait_for(
            lambda: daemon.stats.processed >= jobs, timeout=30
        ), f"only {daemon.stats.processed}/{jobs} jobs completed"

        # deterministic contention on a REAL production named lock
        # (the queue client's guarded-by: _lock identity) so the wait
        # profile provably names it even on a fast host where organic
        # waits fall between 2 ms ticks
        assert isinstance(client._lock, NamedLock)
        assert client._lock.name == "queue_client"
        with client._lock:
            blocked = threading.Thread(
                target=lambda: (
                    client._lock.acquire(), client._lock.release()
                ),
                daemon=True,
            )
            blocked.start()
            profiling.ROLES.register_thread(blocked, "test-contender")
            assert profiling_wait_for(
                lambda: profiling.PROFILER.collapsed(
                    mode="wait", role="test-contender"
                ),
                timeout=5,
            )
        blocked.join(5)
        # heap snapshots have had >= one 0.2 s interval by now
        assert profiling_wait_for(
            lambda: profiling.PROFILER.heap_report() is not None,
            timeout=10,
        )

        attribution = profiling.PROFILER.attribution()
        assert attribution["samples"] > 100
        assert attribution["attributed_pct"] >= 90.0, attribution
        assert "job-worker" in attribution["by_role"]

        # the wait profile names the real lock by its guarded-by name
        wait_stacks = profiling.PROFILER.collapsed(mode="wait")
        assert any(
            stack.endswith(";wait:lock:queue_client")
            for stack in wait_stacks
        ), sorted(wait_stacks)[:10]

        # all three modes serve as collapsed text AND svg through the
        # health view (the /debug/profile surface)
        server = HealthServer(daemon, client, 0)
        try:
            for mode in ("cpu", "wait", "heap"):
                code, body_bytes, ctype = server._debug_profile(
                    {"mode": [mode]}
                )
                assert code == 200 and ctype == "text/plain"
                if mode != "heap":
                    assert body_bytes.strip()
                code, body_bytes, ctype = server._debug_profile(
                    {"mode": [mode], "format": ["svg"]}
                )
                assert code == 200 and ctype == "image/svg+xml"
                assert body_bytes.startswith(b"<svg")
        finally:
            server._httpd.server_close()

        # lock-wait histograms accrued on /metrics for real locks
        waited = [
            name for name, (_, _, _, count)
            in metrics.GLOBAL.histograms().items()
            if name.startswith("lock_wait_seconds_") and count
        ]
        assert "lock_wait_seconds_queue_client" in waited

        # incident bundles carry the ring tail
        bundle = incident.RECORDER.capture("profiling e2e")
        assert bundle["profile"]["attribution"]["samples"] > 0
        assert bundle["profile"]["cpu_top"] or (
            bundle["profile"]["wait_top"]
        )
    finally:
        token.cancel()
        if runner.ident is not None:
            runner.join(timeout=10)
        stub.stop()
        httpd.shutdown()
        incident.RECORDER.reset()
