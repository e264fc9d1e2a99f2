"""The port's crash-only fleet against the JAX package's.

Mirrors ``tests/test_fleet.py`` over both packages:

- the supervisor against SCRIPTED worker processes (start failures go
  fatal after M with the exit code named, crashed workers restart with
  backoff, wedged workers are killed and restarted, drain reaps
  everything): both packages' supervisors run the same scripts one
  after the other and must reach the same restart counts and fatal
  verdicts;
- the heartbeat file each package's worker writes;
- the chaos walk: two REAL ``serve()`` workers of one package over its
  AMQP and S3 stubs, one SIGKILLed mid-stream — the job redelivers to
  the survivor under its ORIGINAL trace id, no multipart upload is
  left open, the supervisor restarts the worker, and
  ``/metrics/federate`` shows both instances;
- the crash-during-multipart matrix and the failpoint storm.

Each real-worker test runs the port's fleet, then the JAX package's, on
the same job stream (payloads from a numpy seed), and compares the
stored objects byte for byte, the ``Convert`` messages (``created_at``
and the trace ids only for presence: a producer mints a fresh trace id
per run) and the open multipart uploads. The port's supervisor spawns
``python -m downloader_tpu_torch serve``, which a test pins.

The file also holds the harness the other fleet suites of the port
import: the package namespaces, the loopback origin, job publishing
and the ``Convert`` sink.
"""

import http.client
import http.server
import importlib
import json
import os
import signal
import socketserver
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_analysis import torch_protocol_guard  # noqa: F401  (module guards)
BUCKET = "fleet-bkt"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def package(root):
    """The modules of one package the fleet suites drive, by name."""
    names = {
        "fleet": "daemon.fleet", "fleetplane": "daemon.fleetplane",
        "health": "daemon.health", "app": "daemon.app", "config": "daemon.config",
        "amqp_server": "queue.amqp_server", "store": "store", "stub": "store.stub",
        "cas": "store.cas", "singleflight": "fetch.singleflight",
        "metrics": "utils.metrics", "tracing": "utils.tracing", "wire": "wire",
        "admission": "utils.admission", "failpoints": "utils.failpoints",
        "alerts": "utils.alerts", "incident": "utils.incident",
        "profiling": "utils.profiling", "tsdb": "utils.tsdb", "logging": "utils.logging",
        "cancel": "utils.cancel", "watchdog": "utils.watchdog", "canary": "utils.canary",
    }
    ns = {key: importlib.import_module(f"{root}.{name}") for key, name in names.items()}
    ns["name"] = root
    ns["creds"] = ns["store"].Credentials(access_key="ak", secret_key="sk")
    return type("Package", (), ns)


PORT = package("downloader_tpu_torch")
REF = package("downloader_tpu")
PACKAGES = (PORT, REF)
PACKAGE_IDS = ("port", "ref")


def payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, np.uint8).tobytes()


def wait(predicate, timeout: float, what: str, interval: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


@pytest.fixture(autouse=True)
def fleet_isolation():
    """Each package's federation sources are dropped after a test, and
    the port's admission ledger must balance to zero, as the suite-wide
    fixture holds the JAX package's."""
    yield
    for pkg in PACKAGES:
        pkg.metrics.FEDERATION.reset()
    outstanding = PORT.admission.LEDGER.outstanding()
    PORT.admission.CONTROLLER.reset()
    assert not outstanding, f"the port's admission ledger leaked charges: {outstanding}"


def fast_config(pkg, workers: int = 1, **overrides):
    base = dict(
        workers=workers,
        heartbeat_s=0.1,
        stall_s=1.0,
        publisher_down_s=30.0,
        restart_backoff_s=0.05,
        restart_backoff_cap_s=0.4,
        start_grace_s=10.0,
        start_failures_max=2,
        drain_s=5.0,
    )
    base.update(overrides)
    return pkg.fleet.FleetConfig(**base)


def script_argv(script: str):
    def argv(slot):
        return [sys.executable, "-c", script]

    return argv


BEAT_PREAMBLE = """
import json, os, signal, sys, time

def beat():
    path = os.environ["FLEET_HEARTBEAT_FILE"]
    with open(path + ".tmp", "w") as sink:
        json.dump({"pid": os.getpid(), "ts": time.time(),
                   "publisher_alive": 1, "stalled": 0,
                   "health_port": 0}, sink)
    os.replace(path + ".tmp", path)
"""


def verdict(slot: dict) -> dict:
    """What a supervisor decided about one slot, without pids and ports."""
    return {key: slot[key] for key in ("state", "restarts", "start_failures", "fatal", "ready")}


# -- the worker command ----------------------------------------------------------


def test_default_worker_argv_names_each_package(monkeypatch):
    """A port fleet runs port workers: the default command names
    ``downloader_tpu_torch`` (the reference's names ``downloader_tpu``),
    and the ``PYTHONPATH`` root handed down is the directory that holds
    each package."""
    monkeypatch.delenv("PYTHONPATH", raising=False)
    for pkg in PACKAGES:
        supervisor = pkg.fleet.FleetSupervisor(pkg.fleet.FleetConfig(workers=1))
        try:
            slot = supervisor._slots[0]
            assert supervisor._default_argv(slot) == [sys.executable, "-m", pkg.name, "serve"]
            handle = supervisor._build_handle(slot)
            assert handle.argv == [sys.executable, "-m", pkg.name, "serve"]
            root = handle.env["PYTHONPATH"]
            assert root == REPO
            assert os.path.isfile(os.path.join(root, pkg.name, "__main__.py"))
        finally:
            supervisor.drain()


# -- the supervisor against scripted workers -------------------------------------


def test_start_failure_goes_fatal_after_max_attempts():
    verdicts = []
    for pkg in PACKAGES:
        before = pkg.metrics.GLOBAL.snapshot().get("fleet_worker_start_failures", 0)
        supervisor = pkg.fleet.FleetSupervisor(
            fast_config(pkg, start_failures_max=2),
            worker_argv=script_argv("import sys; sys.exit(3)"),
        )
        try:
            supervisor.start()
            wait(lambda: supervisor.snapshot()["slots"][0]["fatal"], 15.0, "slot to go fatal")
            after = pkg.metrics.GLOBAL.snapshot().get("fleet_worker_start_failures", 0)
            assert after - before == 2
            # fatal means parked: no further spawns happen
            time.sleep(0.5)
            verdicts.append(verdict(supervisor.snapshot()["slots"][0]))
        finally:
            supervisor.drain()
    port, ref = verdicts
    assert port == ref
    assert port == {"state": "down", "restarts": 0, "start_failures": 2, "fatal": True,
                    "ready": False}


def test_crashed_worker_restarts_with_backoff():
    script = BEAT_PREAMBLE + "beat()\ntime.sleep(0.25)\nsys.exit(1)\n"
    verdicts = []
    for pkg in PACKAGES:
        before = pkg.metrics.GLOBAL.snapshot().get("fleet_worker_restarts", 0)
        supervisor = pkg.fleet.FleetSupervisor(fast_config(pkg), worker_argv=script_argv(script))
        try:
            supervisor.start()
            wait(lambda: supervisor.snapshot()["slots"][0]["restarts"] >= 2, 20.0,
                 "two restarts of a crashing worker")
            after = pkg.metrics.GLOBAL.snapshot().get("fleet_worker_restarts", 0)
            slot = supervisor.snapshot()["slots"][0]
            # it heartbeated before dying, so these were crashes, never
            # start failures
            verdicts.append({"restarted_twice": slot["restarts"] >= 2,
                             "counted": after - before >= 2,
                             "start_failures": slot["start_failures"], "fatal": slot["fatal"]})
        finally:
            supervisor.drain()
    assert verdicts[0] == verdicts[1] == {"restarted_twice": True, "counted": True,
                                          "start_failures": 0, "fatal": False}


def test_wedged_worker_is_killed_and_restarted():
    # beats once, then stops beating forever while staying alive: the
    # supervisor must read staleness as wedged and SIGKILL it
    script = BEAT_PREAMBLE + "beat()\ntime.sleep(600)\n"
    verdicts = []
    for pkg in PACKAGES:
        supervisor = pkg.fleet.FleetSupervisor(
            fast_config(pkg, stall_s=0.6), worker_argv=script_argv(script)
        )
        try:
            supervisor.start()
            wait(lambda: supervisor.snapshot()["slots"][0]["restarts"] >= 1, 20.0,
                 "wedged worker to be killed and counted as a restart")
            slot = supervisor.snapshot()["slots"][0]
            verdicts.append({"restarted": slot["restarts"] >= 1, "fatal": slot["fatal"]})
        finally:
            supervisor.drain()
    assert verdicts[0] == verdicts[1] == {"restarted": True, "fatal": False}


def test_drain_reaps_everything():
    script = BEAT_PREAMBLE + (
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
        "while True:\n    beat()\n    time.sleep(0.05)\n"
    )
    verdicts = []
    for pkg in PACKAGES:
        supervisor = pkg.fleet.FleetSupervisor(
            fast_config(pkg, workers=2), worker_argv=script_argv(script)
        )
        supervisor.start()
        wait(lambda: all(s["ready"] for s in supervisor.snapshot()["slots"]), 15.0,
             "both scripted workers ready")
        pids = [s["pid"] for s in supervisor.snapshot()["slots"]]
        supervisor.drain()
        snap = supervisor.snapshot()
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        verdicts.append({"alive": snap["workers_alive"],
                         "gauge": pkg.metrics.GLOBAL.gauges().get("fleet_workers_alive"),
                         "states": [s["state"] for s in snap["slots"]]})
    assert verdicts[0] == verdicts[1] == {"alive": 0, "gauge": 0, "states": ["down", "down"]}


def test_heartbeat_writer_writes_atomically(tmp_path):
    beats = []
    for pkg in PACKAGES:
        path = str(tmp_path / f"hb-{pkg.name}.json")
        writer = pkg.fleet.HeartbeatWriter(path, 0.05, health_port=1234).start()
        try:
            wait(lambda: os.path.exists(path), 5.0, "heartbeat file")
            beat = json.loads(open(path).read())
            assert beat["pid"] == os.getpid()
            assert beat["health_port"] == 1234
            assert beat["instance"] == pkg.metrics.FEDERATION.instance
            wait(lambda: json.loads(open(path).read())["ts"] > beat["ts"], 5.0, "a second beat")
            beats.append(beat)
        finally:
            writer.stop()
        assert not writer._thread.is_alive()
    # the same fields, and the same values but for the clock
    assert sorted(beats[0]) == sorted(beats[1])
    assert {k: v for k, v in beats[0].items() if k not in ("ts", "instance")} == {
        k: v for k, v in beats[1].items() if k not in ("ts", "instance")}


# -- real-worker plumbing --------------------------------------------------------


class Origin:
    """Threaded HTTP origin serving a dict of path -> payload, with HEAD
    and (optionally throttled) GET incl. Range support; counts data GETs
    per path."""

    def __init__(self, objects, rate_bps: float = 0.0):
        origin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                body = origin.objects.get(self.path)
                if body is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                body = origin.objects.get(self.path)
                with origin.lock:
                    origin.gets[self.path] = origin.gets.get(self.path, 0) + 1
                if body is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                start, end = 0, len(body)
                header = self.headers.get("Range")
                if header and header.startswith("bytes="):
                    lo, _, hi = header[len("bytes="):].partition("-")
                    start = int(lo) if lo else 0
                    end = int(hi) + 1 if hi else len(body)
                    self.send_response(206)
                    self.send_header("Content-Range", f"bytes {start}-{end - 1}/{len(body)}")
                else:
                    self.send_response(200)
                self.send_header("Content-Length", str(end - start))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()
                window = body[start:end]
                chunk = 64 * 1024
                for offset in range(0, len(window), chunk):
                    piece = window[offset:offset + chunk]
                    try:
                        self.wfile.write(piece)
                        self.wfile.flush()
                    except OSError:
                        return
                    if origin.rate_bps > 0:
                        time.sleep(len(piece) / origin.rate_bps)

        self.objects = dict(objects)
        self.rate_bps = rate_bps
        self.gets = {}
        self.lock = threading.Lock()
        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def data_gets(self) -> int:
        with self.lock:
            return sum(self.gets.values())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


def worker_env(pkg, broker, s3, base_dir, **extra):
    env = {
        "BROKER": "amqp",
        "RABBITMQ_ENDPOINT": broker.endpoint,
        "RABBITMQ_USERNAME": "",
        "RABBITMQ_PASSWORD": "",
        "S3_ENDPOINT": f"http://{s3.endpoint}",
        "S3_ACCESS_KEY": pkg.creds.access_key,
        "S3_SECRET_KEY": pkg.creds.secret_key,
        "BUCKET": BUCKET,
        "DOWNLOAD_DIR": base_dir,
        "JOB_CONCURRENCY": "1",
        "PREFETCH": "4",
        "BATCH_JOBS": "1",
        "HTTP_SEGMENTS": "1",
        "S3_MULTIPART_THRESHOLD": str(128 * 1024),
        "S3_PART_SIZE": str(128 * 1024),
        "PROFILE": "0",
        "TSDB_INTERVAL": "off",
        "ALERT_INTERVAL": "off",
        "LSD": "off",
        "DHT_BOOTSTRAP": "off",
        "WATCHDOG_STALL_S": "60",
        "MAX_JOB_RETRIES": "6",
        "RETRY_DELAY": "0.1",
        "RETRY_DELAY_CAP": "0.5",
        "PUBLISH_CONFIRM_TIMEOUT": "10",
        "FAILPOINT_SPEC": "",
        "LOG_LEVEL": "info",
    }
    env.update(extra)
    return env


def declare_topology(channel, topic: str) -> None:
    channel.declare_exchange(topic)
    for index in range(2):
        name = f"{topic}-{index}"
        channel.declare_queue(name)
        channel.bind_queue(name, topic, name)


def publish_job(pkg, broker, media_id: str, url: str, job_class: str = ""):
    """Publish one Download with a producer-minted trace context (the
    continuity anchor every redelivery must preserve); topology is
    declared first so a not-yet-started worker can't lose it."""
    context = pkg.tracing.TraceContext.mint()
    headers = {pkg.tracing.TRACE_CONTEXT_HEADER: context.header_value()}
    if job_class:
        headers["X-Job-Class"] = job_class
    connection = broker.broker.connect()
    try:
        channel = connection.channel()
        declare_topology(channel, "v1.download")
        body = pkg.wire.Download(media=pkg.wire.Media(id=media_id, source_uri=url)).marshal()
        channel.publish("v1.download", "v1.download-0", body, headers=headers, persistent=True)
        channel.close()
    finally:
        connection.close()
    return context


class ConvertSink:
    """Consumes both v1.convert shards: (media id, trace id) pairs as
    workers publish them, and each Convert's media bytes."""

    def __init__(self, pkg, broker):
        self.received = []
        self.media = []
        self.stamped = True
        self._lock = threading.Lock()
        self._connection = broker.broker.connect()
        channel = self._connection.channel()
        channel.set_prefetch(200)
        declare_topology(channel, "v1.convert")
        tracing = pkg.tracing

        def on_message(message, ch=channel):
            convert = pkg.wire.Convert.unmarshal(message.body)
            context = tracing.TraceContext.parse(message.headers.get(tracing.TRACE_CONTEXT_HEADER))
            with self._lock:
                self.received.append((convert.media.id if convert.media else "",
                                      context.trace_id if context else ""))
                self.media.append(convert.media)
                self.stamped = self.stamped and bool(convert.created_at)
            ch.ack(message.delivery_tag)

        for index in range(2):
            channel.consume(f"v1.convert-{index}", on_message)

    def snapshot(self):
        with self._lock:
            return list(self.received)

    def converts(self, origin_url: str):
        """The distinct Convert media payloads, sorted, with the run's
        loopback origin written as ``ORIGIN`` (a redelivered job may
        publish twice: at-least-once)."""
        with self._lock:
            media = list(self.media)
        out = set()
        for entry in media:
            if entry is not None:
                entry.source_uri = entry.source_uri.replace(origin_url, "ORIGIN")
            out.add(b"" if entry is None else entry.marshal())
        return sorted(out)

    def close(self):
        self._connection.close()


def http_get(port: int, path: str, timeout: float = 10.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        response = conn.getresponse()
        return response.status, response.read()
    finally:
        conn.close()


def scrape(port: int, path: str = "/metrics") -> str:
    return http_get(port, path, timeout=2.0)[1].decode()


def counter_from(exposition: str, family: str) -> float:
    for line in exposition.splitlines():
        if line.startswith(f"downloader_{family} "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def assert_worker_ledger_zero(port: int) -> None:
    budgets = json.loads(scrape(port, "/debug/admission")).get("ledger", {}).get("budgets", {})
    used = {name: entry.get("used", 0) for name, entry in budgets.items() if entry.get("used", 0)}
    assert not used, f"worker ledger not balanced to zero: {used}"


def stored(s3) -> dict:
    """The bucket's objects, but for the canary plane's own probes."""
    return {key: bytes(data) for key, data in s3.buckets.get(BUCKET, {}).items()
            if not key.startswith("canary-")}


def spawn_worker(pkg, instance: str, env_overrides):
    env = dict(os.environ)
    env.update(env_overrides)
    existing = env.get("PYTHONPATH", "")
    if REPO not in existing.split(os.pathsep):
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}{existing}" if existing else REPO
    handle = pkg.fleet.WorkerHandle(instance, [sys.executable, "-m", pkg.name, "serve"], env)
    return handle.spawn()


# -- the fleet chaos walk --------------------------------------------------------


def chaos_run(pkg, tmp_path, body):
    with pkg.stub.S3Stub(pkg.creds) as s3, pkg.amqp_server.AmqpServerStub() as broker, \
            Origin({"/video.mp4": body}, rate_bps=768 * 1024) as origin:
        supervisor = pkg.fleet.FleetSupervisor(
            fast_config(pkg, workers=2, heartbeat_s=0.2, stall_s=2.0, start_grace_s=30.0,
                        restart_backoff_s=0.1, restart_backoff_cap_s=0.5, drain_s=10.0),
            worker_env=worker_env(pkg, broker, s3, str(tmp_path / pkg.name)),
        )
        sink = None
        try:
            supervisor.start()
            wait(lambda: all(s["ready"] for s in supervisor.snapshot()["slots"]), 40.0,
                 "both real workers ready")
            sink = ConvertSink(pkg, broker)
            context = publish_job(pkg, broker, "chaos-1", f"{origin.url}/video.mp4",
                                  job_class="interactive")
            # mid-stream = the job's multipart upload is initiated and the
            # throttled fetch still runs
            wait(lambda: s3.list_multipart_uploads(), 20.0, "the streaming upload to initiate")
            snap = supervisor.snapshot()
            busy = wait(
                lambda: [s for s in supervisor.snapshot()["slots"] if s["health_port"]
                         and counter_from(scrape(s["health_port"]), "queue_delivered") > 0],
                10.0, "the busy worker to be identifiable",
            )[0]
            victim_pid = busy["pid"]
            killed_at = time.monotonic()
            os.kill(victim_pid, signal.SIGKILL)
            wait(lambda: ("chaos-1", context.trace_id) in sink.snapshot(), 60.0,
                 "the redelivered job to complete under the original trace id")
            foreign = [e for e in sink.snapshot() if e[1] != context.trace_id]
            assert not foreign, f"completions under a different trace id: {foreign}"
            wait(lambda: not s3.list_multipart_uploads(), 20.0,
                 "dangling multipart uploads to be reclaimed")
            wait(lambda: supervisor.snapshot()["workers_alive"] == 2, 20.0,
                 "the killed worker to be restarted")
            restart_latency = time.monotonic() - killed_at
            deadline = supervisor._config.stall_s + supervisor._config.restart_backoff_cap_s + 20.0
            assert restart_latency <= deadline, f"restart took {restart_latency:.1f}s"
            restarts = pkg.metrics.GLOBAL.snapshot().get("fleet_worker_restarts", 0)
            wait(lambda: all(s["ready"] for s in supervisor.snapshot()["slots"]), 40.0,
                 "the restarted worker to heartbeat")
            health = pkg.fleet.FleetHealthServer(supervisor, 0, "127.0.0.1").start()
            try:
                federated = scrape(health.port, "/metrics/federate")
            finally:
                health.stop()
            survivor = next(s for s in snap["slots"] if s["pid"] != victim_pid)
            assert_worker_ledger_zero(survivor["health_port"])
            return {
                "objects": stored(s3),
                "converts": sink.converts(origin.url),
                "stamped": sink.stamped,
                "dangling": s3.list_multipart_uploads(),
                "restarted": restarts >= 1,
                "instances": sorted(
                    i for i in ("worker-0", "worker-1") if f'instance="{i}"' in federated),
            }
        finally:
            if sink is not None:
                sink.close()
            supervisor.drain()


def test_fleet_chaos_sigkill_midstream_redelivers_to_survivor(tmp_path):
    body = payload(3 * 1024 * 1024, 60)
    port, ref = (chaos_run(pkg, tmp_path, body) for pkg in PACKAGES)
    assert port == ref
    assert port["objects"] == {f"chaos-1/original/{_b64('video.mp4')}": body}
    assert port["dangling"] == [] and port["restarted"] and port["stamped"]
    assert port["instances"] == ["worker-0", "worker-1"]


def _b64(name: str) -> str:
    import base64

    return base64.b64encode(name.encode()).decode()


# -- crash-during-multipart matrix -----------------------------------------------

# each cell: (lane, failpoint spec for the armed worker, label)
MATRIX = [
    ("streamed", "s3.part_put=kill:1:0", "before-first-part"),
    ("streamed", "s3.part_put=kill:1:2", "mid-part"),
    ("streamed", "daemon.pre_publish=kill", "pre-publish"),
    ("streamed", "daemon.pre_ack=kill", "post-publish-pre-ack"),
    ("batched", "net.connect=kill", "before-fetch"),
    ("batched", "http.read=kill", "mid-fetch"),
    ("batched", "daemon.pre_publish=kill", "pre-publish"),
    ("batched", "daemon.pre_ack=kill", "post-publish-pre-ack"),
]


def crash_cell(pkg, lane, spec, label, objects, tmp_path):
    lane_env = {"BATCH_JOBS": "1"} if lane == "streamed" else {
        "BATCH_JOBS": "4", "BATCH_WAIT_MS": "400"}
    base_dir = str(tmp_path / pkg.name)
    with pkg.stub.S3Stub(pkg.creds) as s3, pkg.amqp_server.AmqpServerStub() as broker, \
            Origin(objects) as origin:
        contexts = {}
        for index, path in enumerate(sorted(objects)):
            media_id = f"cell-{index}"
            contexts[media_id] = publish_job(pkg, broker, media_id, f"{origin.url}{path}",
                                             job_class="interactive")
        sink = ConvertSink(pkg, broker)
        armed = spawn_worker(pkg, "armed", worker_env(
            pkg, broker, s3, base_dir, FAILPOINT_SPEC=spec, **lane_env))
        survivor = None
        try:
            # the armed worker dies AT the seam: SIGKILL, no graceful path
            code = armed.proc.wait(timeout=60)
            armed.reap()
            survivor = spawn_worker(pkg, "survivor", worker_env(pkg, broker, s3, base_dir,
                                                                **lane_env))
            expected = {(media_id, c.trace_id) for media_id, c in contexts.items()}
            wait(lambda: expected <= set(sink.snapshot()), 90.0,
                 f"redelivered jobs to complete ({lane}/{label})")
            foreign = [e for e in sink.snapshot()
                       if e[0] in contexts and e[1] != contexts[e[0]].trace_id]
            assert not foreign, f"trace-id continuity broken: {foreign}"
            wait(lambda: not s3.list_multipart_uploads(), 20.0, "zero dangling multipart uploads")
            return {"armed_exit": code, "objects": stored(s3), "converts": sink.converts(origin.url),
                    "stamped": sink.stamped, "dangling": s3.list_multipart_uploads()}
        finally:
            sink.close()
            for handle in (survivor, armed):
                if handle is None:
                    continue
                handle.draining()
                try:
                    handle.proc.wait(timeout=10)
                except Exception:
                    handle.kill()
                handle.reap()


@pytest.mark.parametrize("lane,spec,label", MATRIX,
                         ids=[f"{lane}-{label}" for lane, _, label in MATRIX])
def test_crash_matrix_cell(lane, spec, label, tmp_path):
    """One SIGKILL cell for each package: an armed worker dies at the
    seam, the job(s) redeliver to a clean survivor, and both packages
    store the same objects, publish the same Converts under the original
    trace ids and leave no multipart upload open."""
    if lane == "streamed":
        objects = {"/video.mp4": payload(512 * 1024, 61)}
    else:
        objects = {"/clip1.mp4": payload(64 * 1024, 62), "/clip2.mp4": payload(64 * 1024, 63)}
    port, ref = (crash_cell(pkg, lane, spec, label, objects, tmp_path) for pkg in PACKAGES)
    assert port == ref
    assert port["armed_exit"] == -signal.SIGKILL, f"armed worker did not die at {label}"
    assert sorted(port["objects"].values()) == sorted(objects.values())
    assert port["dangling"] == [] and port["stamped"]


# -- failpoint storm: broker bounce + injected faults while draining -------------


def storm_run(pkg, objects, tmp_path):
    spec = "queue.publish=fail:0.25,s3.part_put=fail:0.1,net.connect=fail:0.03"
    with pkg.stub.S3Stub(pkg.creds) as s3, pkg.amqp_server.AmqpServerStub() as broker, \
            Origin(objects) as origin:
        contexts = {}
        for index, path in enumerate(sorted(objects)):
            media_id = f"storm-{index}"
            contexts[media_id] = publish_job(pkg, broker, media_id, f"{origin.url}{path}",
                                             job_class="interactive")
        sink = ConvertSink(pkg, broker)
        supervisor = pkg.fleet.FleetSupervisor(
            fast_config(pkg, workers=2, heartbeat_s=0.2, stall_s=5.0, start_grace_s=30.0,
                        drain_s=10.0),
            worker_env=worker_env(pkg, broker, s3, str(tmp_path / pkg.name),
                                  FAILPOINT_SPEC=spec),
        )
        try:
            supervisor.start()
            wait(lambda: len(sink.snapshot()) >= 2, 60.0, "the drain to get going")
            broker.drop_clients()  # broker restart mid-drain
            expected = {(media_id, c.trace_id) for media_id, c in contexts.items()}
            wait(lambda: expected <= set(sink.snapshot()), 120.0,
                 "every job to survive the storm")
            wait(lambda: not s3.list_multipart_uploads(), 30.0,
                 "zero dangling multiparts after the storm")
            for slot in supervisor.snapshot()["slots"]:
                if slot["health_port"] and slot["state"] == "ready":
                    assert_worker_ledger_zero(slot["health_port"])
        finally:
            sink.close()
            supervisor.drain()
        # read once the fleet has drained: a redelivered duplicate
        # (at-least-once) may still be uploading when the waits return
        return {"objects": stored(s3), "converts": sink.converts(origin.url),
                "dangling": s3.list_multipart_uploads()}


def test_failpoint_storm_two_workers_drain_everything(tmp_path):
    """Two real workers of each package drain 6 multipart jobs while
    seeded failpoints inject publish drops, part-PUT 5xxs and connect
    refusals, and the broker bounces every client once mid-drain: every
    job completes under its original trace id, the objects and Converts
    are the same for both packages, and nothing is left open."""
    objects = {f"/movie{index}.mp4": payload(256 * 1024, 70 + index) for index in range(6)}
    port, ref = (storm_run(pkg, objects, tmp_path) for pkg in PACKAGES)
    assert port == ref
    assert sorted(port["objects"].values()) == sorted(objects.values())
    assert port["dangling"] == []
