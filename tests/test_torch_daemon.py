"""The port's queue-driven daemon against the JAX package's.

Each package's ``Daemon`` runs over its own memory broker and S3 stub and
takes the same job stream, one step at a time: good and malformed jobs,
missing media, an unsupported scheme, a transient failure and its retry,
a permanent failure after the retry cap, a job shed to the dead-letter
queue by the tenant byte quota, a burst on the batched small-object lane,
a streamed multipart upload with a small part size, and a magnet job
verified by a hashlib engine. Both must store the same objects, publish
the same ``Convert`` payloads (``created_at`` is a wall-clock stamp and is
only checked to be set), count the same ``stats``, dead-letter the same
messages (their ``X-Trace-Context`` ids are drawn at random) and leave no
multipart upload open.

The packages run one after the other, never at once: each has its own
process-wide singletons (metrics, admission, the watchdog), reset before
its run. The file also holds ``serve()`` of the port end to end over its
AMQP stub, ``Config.from_env`` field by field across packages,
``serve()`` arming the fleet's knobs, and a fresh interpreter in which
a port daemon runs an HTTP job without loading the digest engine.
"""

import base64
import dataclasses
import http.server
import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from test_torch_analysis import torch_lock_order_guard, torch_protocol_guard  # noqa: F401  (module guards)
import downloader_tpu.parallel.engine as ref_engine
import downloader_tpu_torch.parallel.engine as port_engine
from downloader_tpu_torch.fetch.seeder import Seeder

REPO = Path(__file__).resolve().parents[1]
# seconds: every origin socket and backend request gives up after this
TIMEOUT = 10.0
PART = 64 * 1024
THRESHOLD = 128 * 1024
QUOTA_BYTES = 64 * 1024 * 1024
TORRENT_NAME = "Show.S01E02.mkv"
TRACE_HEADER = "X-Trace-Context"


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, np.uint8).tobytes()


def counts(stats):
    """A DaemonStats' counters (its lock aside)."""
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats) if f.name != "lock"}


def wait_for(predicate, timeout=15.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def package(root):
    """The modules of one package the harness drives, by name."""
    names = {
        "app": "daemon.app", "config": "daemon.config", "fetch": "fetch",
        "torrent": "fetch.torrent", "queue": "queue", "amqp": "queue.amqp",
        "amqp_server": "queue.amqp_server", "store": "store", "stub": "store.stub",
        "cancel": "utils.cancel", "wire": "wire", "metrics": "utils.metrics",
        "watchdog": "utils.watchdog", "tsdb": "utils.tsdb", "alerts": "utils.alerts",
        "profiling": "utils.profiling", "canary": "utils.canary",
        "tracing": "utils.tracing",
    }
    ns = {key: importlib.import_module(f"{root}.{name}") for key, name in names.items()}
    ns["name"] = root
    return type("Package", (), ns)


PORT = package("downloader_tpu_torch")
REF = package("downloader_tpu")
PACKAGES = (PORT, REF)


def stop_planes(pkg):
    """Stop and clear one package's process-wide planes and counters."""
    pkg.canary.ACTIVE = None
    pkg.profiling.PROFILER.stop()
    pkg.alerts.ENGINE.stop()
    pkg.tsdb.STORE.stop()
    pkg.watchdog.MONITOR.stop()
    pkg.metrics.GLOBAL.reset()
    pkg.tracing.TRACER.clear()


class Origin:
    """A loopback HTTP/1.1 origin: HEAD, ``Range`` answered 206, per-path
    payloads; ``fail_next[path]`` answers that many GETs (and meanwhile
    every HEAD) with 404; ``advertise[path]`` is the size a HEAD reports
    for a path whose body is never fetched; a path in ``hold`` waits on
    ``release`` before it answers a GET."""

    def __init__(self, files):
        self.files = dict(files)
        self.fail_next = {}
        self.advertise = {}
        self.hold = set()
        self.release = threading.Event()
        self.gets = []
        origin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = TIMEOUT

            def log_message(self, *args):
                pass

            def handle_error(self, *args):
                pass

            def _send(self, status, length, extra=()):
                self.send_response(status)
                self.send_header("Content-Length", str(length))
                self.send_header("Accept-Ranges", "bytes")
                for name, value in extra:
                    self.send_header(name, value)
                self.end_headers()

            def do_HEAD(self):
                if origin.fail_next.get(self.path, 0) > 0:
                    return self._send(404, 0)
                if self.path in origin.advertise:
                    return self._send(200, origin.advertise[self.path])
                if self.path not in origin.files:
                    return self._send(404, 0)
                self._send(200, len(origin.files[self.path]))

            def do_GET(self):
                origin.gets.append(self.path)
                if origin.fail_next.get(self.path, 0) > 0:
                    origin.fail_next[self.path] -= 1
                    return self._send(404, 0)
                if self.path in origin.hold:
                    origin.release.wait(TIMEOUT)
                body = origin.files.get(self.path)
                if body is None:
                    return self._send(404, 0)
                ranged = self.headers.get("Range", "")
                if ranged.startswith("bytes="):
                    lo, _, hi = ranged[len("bytes="):].partition("-")
                    start, end = int(lo), min(len(body), int(hi) + 1 if hi else len(body))
                    self._send(206, end - start,
                               [("Content-Range", f"bytes {start}-{end - 1}/{len(body)}")])
                    self.wfile.write(body[start:end])
                else:
                    self._send(200, len(body))
                    self.wfile.write(body)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.release.set()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(TIMEOUT)


MOVIE = _payload(5 * 16 * 1024 + 321, 1)
BIG = _payload(5 * PART + 1234, 2)  # above THRESHOLD: a streamed multipart upload
SMALL = {f"/Clip.{i:02d}.mkv": _payload(4096 + 97 * i, 10 + i) for i in range(8)}
FILES = {"/Show.S01E01.mkv": MOVIE, "/flaky.mkv": MOVIE, "/dead.mkv": MOVIE,
         "/big.mkv": BIG, "/hold-0.mkv": MOVIE, "/hold-1.mkv": MOVIE, **SMALL}


@pytest.fixture
def origin():
    server = Origin(FILES)
    yield server
    server.close()


@pytest.fixture
def hashlib_engines(monkeypatch):
    # the torrent job verifies pieces through each package's default
    # engine; hashlib keeps it light (the card path has its own tests)
    monkeypatch.setattr(port_engine, "_default", port_engine.DigestEngine(backend="hashlib"))
    monkeypatch.setattr(ref_engine, "_default", ref_engine.DigestEngine(backend="hashlib"))


@pytest.fixture
def seeder(hashlib_engines):
    with Seeder(TORRENT_NAME, MOVIE, piece_length=16 * 1024) as serving:
        yield serving


def key_of(media_id, name):
    return f"{media_id}/original/{base64.b64encode(name.encode()).decode()}"


def run_stream(pkg, origin, magnet, workdir):
    """Drive one package's daemon through the job stream; returns what an
    operator could observe afterwards, and the count of jobs the
    batched lane ran."""
    stop_planes(pkg)
    token = pkg.cancel.CancelToken()
    broker = pkg.queue.MemoryBroker()
    creds = pkg.store.Credentials("k", "s")
    stub = pkg.stub.S3Stub(credentials=creds).start()
    config = pkg.config.Config(
        broker="memory", base_dir=str(workdir), concurrency=2, max_job_retries=2,
        retry_delay=0.05, quota_tenant_bytes=QUOTA_BYTES, canary=False,
    )
    client = pkg.queue.QueueClient(token, broker.connect, supervisor_interval=0.05,
                                   drain_timeout=5)
    client.set_prefetch(config.batch_jobs)
    backends = [
        pkg.torrent.TorrentBackend(progress_interval=0.01, dht_bootstrap=(), lsd=False),
        pkg.fetch.HTTPBackend(progress_interval=0.01, timeout=5),
    ]
    dispatcher = pkg.fetch.DispatchClient(token, str(workdir), backends)
    s3 = pkg.store.S3Client(stub.endpoint, creds, multipart_threshold=THRESHOLD,
                            part_size=PART)
    uploader = pkg.store.Uploader(config.bucket, s3)
    uploader.configure_pipeline(True, part_workers=2)
    daemon = pkg.app.Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)
    runner.start()
    producer = broker.connect().channel()
    converts = []
    sink = broker.connect().channel()
    sink.declare_exchange("v1.convert")
    sink.declare_queue("convert-sink")
    for shard in (0, 1):
        sink.bind_queue("convert-sink", "v1.convert", f"v1.convert-{shard}")

    def on_convert(message):
        converts.append(pkg.wire.Convert.unmarshal(message.body))
        sink.ack(message.delivery_tag)

    sink.consume("convert-sink", on_convert)
    wire = pkg.wire
    stats = daemon.stats

    def enqueue(media_id, url, body=None):
        if body is None:
            body = wire.Download(media=wire.Media(id=media_id, source_uri=url)).marshal()
        producer.publish("v1.download", "v1.download-0", body)

    def settled():
        return stats.processed + stats.failed + stats.dropped + stats.shed

    def step(count, publish):
        target = settled() + count
        publish()
        assert wait_for(lambda: settled() >= target), (pkg.name, counts(stats))

    try:
        assert wait_for(daemon.ready.is_set)
        step(1, lambda: enqueue("ok-1", f"{origin.url}/Show.S01E01.mkv"))
        step(1, lambda: enqueue("", "", b"\xff\xff not proto"))
        step(1, lambda: enqueue("", "", wire.Download().marshal()))
        step(1, lambda: enqueue("gopher-1", "gopher://nope/file.mkv"))
        origin.fail_next["/flaky.mkv"] = 1
        step(1, lambda: enqueue("flaky-1", f"{origin.url}/flaky.mkv"))
        origin.fail_next["/dead.mkv"] = 99
        step(1, lambda: enqueue("dead-1", f"{origin.url}/dead.mkv"))
        origin.fail_next.pop("/dead.mkv")
        origin.advertise["/huge.mkv"] = 2 * QUOTA_BYTES
        step(1, lambda: enqueue("huge-1", f"{origin.url}/huge.mkv"))
        step(1, lambda: enqueue("big-1", f"{origin.url}/big.mkv"))
        step(1, lambda: enqueue("magnet-1", magnet))

        # the burst: both workers held on one job each while the burst
        # queues behind them, so the next dequeue wave takes it whole
        origin.release.clear()
        origin.hold.update(("/hold-0.mkv", "/hold-1.mkv"))
        before = settled()
        for index in (0, 1):
            enqueue(f"hold-{index}", f"{origin.url}/hold-{index}.mkv")
            assert wait_for(lambda: origin.gets.count(f"/hold-{index}.mkv") >= 1)
        for index, path in enumerate(SMALL):
            enqueue(f"clip-{index}", origin.url + path)
        origin.release.set()
        assert wait_for(lambda: settled() >= before + 2 + len(SMALL)), counts(stats)
        assert wait_for(lambda: len(converts) == stats.processed)
    finally:
        origin.hold.clear()
        origin.release.set()
        token.cancel()
        runner.join(timeout=15)
    assert not runner.is_alive()
    dlq = []
    dead_letters = broker.connect().channel()
    dead_letters.consume(config.dead_letter_queue, lambda m: dlq.append(m))
    assert wait_for(lambda: len(dlq) == stats.shed)
    uploader.close()
    for backend in backends:
        getattr(backend, "close", lambda: None)()
    try:
        bucket = {name: dict(objects) for name, objects in stub.buckets.items()}
        dangling = stub.list_multipart_uploads()
        multiparts = stub.completed_multiparts
    finally:
        stub.stop()
    assert all(convert.created_at for convert in converts)
    counters = pkg.metrics.GLOBAL.snapshot()
    return {
        "stats": counts(stats),
        "bucket": bucket,
        "dangling": dangling,
        "multiparts": multiparts,
        "converts": sorted(
            (c.media.id, c.media.source_uri, c.media is not None) for c in converts
        ),
        "dlq": [
            (m.body, m.routing_key,
             {k: v for k, v in m.headers.items() if k != TRACE_HEADER},
             TRACE_HEADER in m.headers)
            for m in dlq
        ],
        "streamed": counters.get("pipeline_streamed_files", 0),
    }, counters.get("batch_fast_jobs", 0)


def test_job_stream_matches_reference(origin, seeder, tmp_path):
    results, fast = {}, {}
    for pkg in PACKAGES:
        results[pkg.name], fast[pkg.name] = run_stream(
            pkg, origin, seeder.magnet_uri, tmp_path / pkg.name)
        origin.gets.clear()
    port, ref = results["downloader_tpu_torch"], results["downloader_tpu"]
    assert port == ref
    # how the burst splits into waves depends on thread timing: each
    # package must have run some of it on the batched lane
    assert min(fast.values()) >= 2, fast
    assert port["stats"] == {"processed": 14, "failed": 1, "retried": 3, "dropped": 3,
                             "shed": 1}
    want = {key_of("ok-1", "Show.S01E01.mkv"): MOVIE, key_of("flaky-1", "flaky.mkv"): MOVIE,
            key_of("big-1", "big.mkv"): BIG, key_of("magnet-1", TORRENT_NAME): MOVIE,
            key_of("hold-0", "hold-0.mkv"): MOVIE, key_of("hold-1", "hold-1.mkv"): MOVIE}
    want.update((key_of(f"clip-{i}", path[1:]), body)
                for i, (path, body) in enumerate(SMALL.items()))
    assert port["bucket"] == {"triton-staging": want}
    assert port["dangling"] == [] and port["multiparts"] == 1 and port["streamed"] == 1
    assert [media_id for media_id, _, _ in port["converts"]] == sorted(
        media_id.split("/")[0] for media_id in want
    )
    ((body, routing_key, headers, traced),) = port["dlq"]
    assert routing_key == "v1.download.dlq" and traced
    assert headers["X-Shed-Reason"] == "tenant-byte-quota" and headers["X-Shed-Count"] == 1


def free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _served(pkg, origin, tmp_path, monkeypatch):
    """``serve()`` of one package in a thread over its AMQP stub and S3
    stub, one job published by a foreign AMQP client; returns the stored
    bucket, the Convert shards' depth and the ``/metrics`` text."""
    stop_planes(pkg)
    token = pkg.cancel.CancelToken()
    creds = pkg.store.Credentials("k", "s")
    with pkg.amqp_server.AmqpServerStub(username="u", password="p") as amqp, \
            pkg.stub.S3Stub(credentials=creds) as stub:
        monkeypatch.setenv("S3_ENDPOINT", f"http://{stub.endpoint}")
        monkeypatch.setenv("S3_ACCESS_KEY", "k")
        monkeypatch.setenv("S3_SECRET_KEY", "s")
        monkeypatch.setenv("DHT_BOOTSTRAP", "off")
        monkeypatch.setenv("LSD", "off")
        config = pkg.config.Config.from_env({
            "BROKER": "amqp", "RABBITMQ_ENDPOINT": amqp.endpoint,
            "RABBITMQ_USERNAME": "u", "RABBITMQ_PASSWORD": "p",
            "DOWNLOAD_DIR": str(tmp_path / pkg.name), "JOB_CONCURRENCY": "2",
            "HEALTH_PORT": str(free_port()), "TSDB_INTERVAL": "0.2",
            "ALERT_INTERVAL": "0.2", "PROFILE_INTERVAL_MS": "20",
        })
        config.health_host = "127.0.0.1"
        threads_before = set(threading.enumerate())
        served = threading.Thread(
            target=pkg.app.serve,
            kwargs=dict(config=config, token=token, install_signal_handlers=False),
            daemon=True,
        )
        served.start()
        try:
            assert wait_for(lambda: "v1.download" in amqp.broker._exchanges, timeout=30)
            producer = pkg.amqp.AmqpConnection.dial(amqp.endpoint, username="u", password="p")
            body = pkg.wire.Download(media=pkg.wire.Media(
                id="sv-1", source_uri=f"{origin.url}/Show.S01E01.mkv")).marshal()
            producer.channel().publish("v1.download", "v1.download-0", body)
            key = key_of("sv-1", "Show.S01E01.mkv")
            assert wait_for(lambda: stub.buckets.get("triton-staging", {}).get(key) == MOVIE)
            depth = lambda: sum(amqp.broker.queue_depth(f"v1.convert-{i}") for i in (0, 1))
            assert wait_for(lambda: depth() == 1)
            producer.close()
            bucket = {name: dict(objects) for name, objects in stub.buckets.items()}
            url = f"http://127.0.0.1:{config.health_port}/metrics"

            def exposition() -> str:
                with urllib.request.urlopen(url, timeout=TIMEOUT) as answer:
                    return answer.read().decode()

            # the worker counts the job after the Convert is confirmed and
            # the delivery acked, so the count can trail the shard's depth
            assert wait_for(lambda: "downloader_jobs_processed 1" in exposition()), exposition()
        finally:
            token.cancel()
            served.join(timeout=20)
            # serve()'s stop leaves its alert rules as they are, in both
            # packages: a rule that fired (hot-object-concentration, from
            # the one stored object) holds its episode until the declared
            # release, which the module's protocol guard reads
            pkg.alerts.ENGINE.reset()
        assert not served.is_alive()
    # every thread serve() started has stopped
    leftover = lambda: [t.name for t in threading.enumerate()
                        if t not in threads_before and t.is_alive()]
    assert wait_for(lambda: not leftover(), timeout=10), leftover()
    return bucket, depth()


def test_serve_end_to_end_over_amqp(origin, tmp_path, monkeypatch):
    """``serve()`` of each package over its own AMQP stub: the job is
    stored and its Convert reaches the shards, and every plane serve()
    starts (watchdog, tsdb, alerts, profiler) stops with it."""
    results = [_served(pkg, origin, tmp_path, monkeypatch) for pkg in PACKAGES]
    assert results[0] == results[1]
    assert results[0][0] == {"triton-staging": {key_of("sv-1", "Show.S01E01.mkv"): MOVIE}}


ENVIRONMENTS = {
    "defaults": {},
    "amqp": {"BROKER": "AMQP", "RABBITMQ_ENDPOINT": "rabbit:5672", "RABBITMQ_USERNAME": "u",
             "RABBITMQ_PASSWORD": "p", "CONSUME_TOPIC": "in", "PUBLISH_TOPIC": "out",
             "BUCKET": "b", "DOWNLOAD_DIR": "/d", "PREFETCH": "4", "JOB_CONCURRENCY": "3"},
    "batch-and-retry": {"BATCH_JOBS": "1", "BATCH_WAIT_MS": "5", "BATCH_MAX_BYTES": "100",
                        "MAX_JOB_RETRIES": "7", "RETRY_DELAY": "0.5", "RETRY_DELAY_CAP": "9",
                        "PUBLISH_CONFIRM_TIMEOUT": "3", "HEALTH_PORT": "8080"},
    "planes": {"TRACE": "off", "TRACE_RING": "7", "TSDB_INTERVAL": "0", "ALERT_INTERVAL": "2",
               "ALERT_FAST_WINDOW_S": "10", "ALERT_SLOW_WINDOW_S": "50",
               "ALERT_BURN_FACTOR": "3", "ALERT_OBJECTIVE": "0.95", "PROFILE": "0",
               "PROFILE_INTERVAL_MS": "7", "WORKER_INSTANCE": "w-1", "CANARY": "off",
               "CANARY_INTERVAL_S": "5", "CANARY_OBJECT_BYTES": "1000"},
    "admission": {"WATCHDOG_STALL_S": "3", "WATCHDOG_ACTION": "cancel",
                  "WATCHDOG_STALL_STAGES": "publish=30,fetch=5", "INCIDENT_DIR": "/i",
                  "INCIDENT_KEEP": "2", "QUOTA_TENANT_JOBS": "2", "QUOTA_TENANT_BYTES": "9",
                  "DLQ_QUEUE": "dead", "DLQ_MAX_REDELIVER": "1", "DLQ_RETRY_AFTER_BASE": "2",
                  "ADMISSION_WEIGHTS": "interactive=8,bulk=1", "HTTP_SEGMENTS": "3",
                  "HTTP_POOL_PER_HOST": "2", "MIRROR_URLS": "http://m/a"},
    "fleet-knobs": {"FLEET_HEARTBEAT_FILE": "/hb", "FLEET_HEARTBEAT_S": "0.5",
                    "CACHE_DIR": "/c", "CACHE_MAX_BYTES": "10", "CACHE_TTL_S": "bad",
                    "SINGLEFLIGHT_LEASE_S": "2", "SINGLEFLIGHT_WAIT_S": "x"},
}


@pytest.mark.parametrize("case", sorted(ENVIRONMENTS))
def test_config_from_env_matches_reference(case):
    port = PORT.config.Config.from_env(ENVIRONMENTS[case])
    ref = REF.config.Config.from_env(ENVIRONMENTS[case])
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.dead_letter_queue == ref.dead_letter_queue


@pytest.mark.parametrize("knob", ["CACHE_DIR", "FLEET_HEARTBEAT_FILE"])
def test_serve_arms_the_fleet_knobs(knob, tmp_path, monkeypatch):
    """With ``CACHE_DIR`` set, serve() arms the fleet data plane and
    ``/debug/cache`` serves its live snapshot; with
    ``FLEET_HEARTBEAT_FILE`` set, it beats the file with its health
    port. Either way it stops with every thread it started."""
    stop_planes(PORT)
    port = free_port()
    monkeypatch.setenv("S3_ENDPOINT", "http://127.0.0.1:9")  # no job runs
    monkeypatch.setenv("DHT_BOOTSTRAP", "off")
    monkeypatch.setenv("LSD", "off")
    config = PORT.config.Config.from_env({
        knob: str(tmp_path / "x"), "BROKER": "memory", "HEALTH_PORT": str(port),
        "DOWNLOAD_DIR": str(tmp_path / "dl"), "CANARY": "off", "TSDB_INTERVAL": "0",
        "ALERT_INTERVAL": "0",
    })
    config.health_host = "127.0.0.1"
    token = PORT.cancel.CancelToken()
    before = set(threading.enumerate())
    served = threading.Thread(
        target=PORT.app.serve,
        kwargs=dict(config=config, token=token, install_signal_handlers=False),
        daemon=True,
    )
    served.start()
    try:
        if knob == "CACHE_DIR":
            def snapshot():
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/cache",
                                                timeout=TIMEOUT) as answer:
                        return json.loads(answer.read())
                except OSError:
                    return None

            assert wait_for(lambda: snapshot() is not None, timeout=30)
            cache = snapshot()
            assert cache["enabled"] is True
            assert cache["cas"]["root"] == os.path.abspath(config.cache_dir)
            assert cache["singleflight"]["root"] == os.path.join(
                os.path.abspath(config.cache_dir), "inflight")
        else:
            beat_file = tmp_path / "x"
            assert wait_for(beat_file.exists, timeout=30)
            beat = json.loads(beat_file.read_text())
            assert beat["health_port"] == port and beat["pid"] == os.getpid()
    finally:
        token.cancel()
        served.join(timeout=20)
    assert not served.is_alive()
    leftover = lambda: [t.name for t in threading.enumerate()
                        if t not in before and t.is_alive()]
    assert wait_for(lambda: not leftover(), timeout=10), leftover()


def test_torrent_job_without_a_card_fails(monkeypatch, tmp_path):
    """No hashlib fallback hides a missing card: with the port's real
    default engine on a host without CUDA, a magnet job fails after its
    retries and stores nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card; the job would verify on it")
    monkeypatch.setattr(port_engine, "_default", port_engine.DigestEngine(backend="hashlib"))
    with Seeder(TORRENT_NAME, MOVIE, piece_length=16 * 1024) as serving:
        monkeypatch.setattr(port_engine, "_default", None)
        stop_planes(PORT)
        token = PORT.cancel.CancelToken()
        broker = PORT.queue.MemoryBroker()
        creds = PORT.store.Credentials("k", "s")
        with PORT.stub.S3Stub(credentials=creds) as stub:
            config = PORT.config.Config(broker="memory", base_dir=str(tmp_path), concurrency=1,
                                        max_job_retries=1, retry_delay=0.05, canary=False)
            client = PORT.queue.QueueClient(token, broker.connect, supervisor_interval=0.05,
                                            drain_timeout=5)
            backend = PORT.torrent.TorrentBackend(progress_interval=0.01, dht_bootstrap=(),
                                                  lsd=False)
            dispatcher = PORT.fetch.DispatchClient(token, str(tmp_path), [backend])
            uploader = PORT.store.Uploader(config.bucket, PORT.store.S3Client(stub.endpoint, creds))
            daemon = PORT.app.Daemon(token, client, dispatcher, uploader, config)
            runner = threading.Thread(target=daemon.run, daemon=True)
            runner.start()
            try:
                assert wait_for(daemon.ready.is_set)
                body = PORT.wire.Download(media=PORT.wire.Media(
                    id="m", source_uri=serving.magnet_uri)).marshal()
                broker.connect().channel().publish("v1.download", "v1.download-0", body)
                assert wait_for(lambda: daemon.stats.failed == 1)
            finally:
                token.cancel()
                runner.join(timeout=15)
            assert counts(daemon.stats) == {"processed": 0, "failed": 1, "retried": 1,
                                            "dropped": 0, "shed": 0}
            assert stub.buckets.get("triton-staging", {}) == {}


def test_http_daemon_never_touches_cuda(origin, tmp_path):
    # a fresh interpreter: this test process has imported the engine
    script = (
        "import json, sys, threading, time\n"
        "from downloader_tpu_torch.daemon.app import serve\n"
        "from downloader_tpu_torch.daemon.config import Config\n"
        "from downloader_tpu_torch.queue.amqp import AmqpConnection\n"
        "from downloader_tpu_torch.queue.amqp_server import AmqpServerStub\n"
        "from downloader_tpu_torch.store import Credentials\n"
        "from downloader_tpu_torch.store.stub import S3Stub\n"
        "from downloader_tpu_torch.utils.cancel import CancelToken\n"
        "from downloader_tpu_torch.wire import Download, Media\n"
        "import os\n"
        "token = CancelToken()\n"
        "with AmqpServerStub() as amqp, S3Stub(credentials=Credentials('k', 's')) as stub:\n"
        "    os.environ.update(S3_ENDPOINT='http://' + stub.endpoint, S3_ACCESS_KEY='k',\n"
        "                      S3_SECRET_KEY='s', DHT_BOOTSTRAP='off', LSD='off')\n"
        "    config = Config.from_env({'RABBITMQ_ENDPOINT': amqp.endpoint,\n"
        f"                              'DOWNLOAD_DIR': {str(tmp_path)!r}}})\n"
        "    done = threading.Thread(target=serve, kwargs=dict(config=config, token=token,\n"
        "                            install_signal_handlers=False))\n"
        "    done.start()\n"
        "    deadline = time.monotonic() + 30\n"
        "    while 'v1.download' not in amqp.broker._exchanges and time.monotonic() < deadline:\n"
        "        time.sleep(0.01)\n"
        "    producer = AmqpConnection.dial(amqp.endpoint)\n"
        f"    body = Download(media=Media(id='e', source_uri={origin.url + '/Show.S01E01.mkv'!r}))\n"
        "    producer.channel().publish('v1.download', 'v1.download-0', body.marshal())\n"
        "    while not stub.buckets.get('triton-staging') and time.monotonic() < deadline:\n"
        "        time.sleep(0.01)\n"
        "    producer.close()\n"
        "    token.cancel()\n"
        "    done.join(30)\n"
        "    stored = sum(len(v) for v in stub.buckets.get('triton-staging', {}).values())\n"
        "torch = sys.modules.get('torch')\n"
        "print(json.dumps({'stored': stored,"
        " 'engine': 'downloader_tpu_torch.parallel.engine' in sys.modules,"
        " 'cuda_initialized': bool(torch and torch.cuda.is_initialized())}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    done = subprocess.run(
        [sys.executable, "-c", script], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=90,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.splitlines()[-1])
    assert result == {"stored": len(MOVIE), "engine": False, "cuda_initialized": False}
