"""Port twin of ``tests/test_soak.py``: the daemon endurance soak and
the torrent-job soak over ``downloader_tpu_torch``, marked ``slow`` as
the reference is.

Hundreds of jobs go through the memory broker with churn (source deaths
mid-body, 404 retries, malformed and unsupported messages, repeated
broker drops, a cancellation with jobs in flight), and the long-lived
consumer's fd count, thread count and RSS must stay flat; a string of
torrent jobs through one backend and a shared DHT node, half of them
losing their seeder mid-swarm, must release every socket and thread.
The torrent half verifies pieces with a hashlib ``DigestEngine``: the
port's default engine needs a card.
"""


from __future__ import annotations

import http.server
import os
import threading
import time

import pytest

from downloader_tpu_torch.daemon.app import Daemon
from downloader_tpu_torch.daemon.config import Config
from downloader_tpu_torch.fetch import DispatchClient, HTTPBackend
from downloader_tpu_torch.queue import MemoryBroker, QueueClient
from downloader_tpu_torch.store import Credentials, S3Client, Uploader
from downloader_tpu_torch.store.stub import S3Stub
from downloader_tpu_torch.utils.cancel import CancelToken
from downloader_tpu_torch.wire import Download, Media

JOBS = 500
PAYLOAD = os.urandom(64 * 1024)


def wait_for(predicate, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def _rss_kb() -> int:
    with open("/proc/self/status") as status:
        for line in status:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


class _ChurnHandler(http.server.BaseHTTPRequestHandler):
    """Payload server with injected churn: every 23rd request dies
    mid-body (source/peer death → ranged resume), every 31st 404s once
    (permanent per-attempt → daemon-level retry)."""

    counter = 0
    lock = threading.Lock()
    failed_once: set = set()

    def log_message(self, *args):
        pass

    def do_GET(self):
        with _ChurnHandler.lock:
            _ChurnHandler.counter += 1
            n = _ChurnHandler.counter
        if n % 31 == 0 and self.path not in _ChurnHandler.failed_once:
            _ChurnHandler.failed_once.add(self.path)
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(PAYLOAD)))
        self.end_headers()
        if n % 23 == 0:
            # die mid-body: connection reset after half the payload
            # (close_connection stops the handler loop from reading the
            # closed socket and dumping a traceback per injected death)
            self.close_connection = True
            self.wfile.write(PAYLOAD[: len(PAYLOAD) // 2])
            self.wfile.flush()
            self.connection.close()
            return
        if "/cancel-" in self.path:
            # slow body: guarantees these jobs are genuinely mid-
            # transfer when the cancellation fires
            self.wfile.write(PAYLOAD[: len(PAYLOAD) // 2])
            self.wfile.flush()
            time.sleep(3.0)
        self.wfile.write(PAYLOAD)


@pytest.mark.slow
def test_daemon_soak_fd_thread_rss_flat(tmp_path):
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _ChurnHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    token = CancelToken()
    broker = MemoryBroker()
    stub = S3Stub(
        credentials=Credentials("k", "s"), retain_objects=False
    ).start()
    config = Config(
        broker="memory",
        base_dir=str(tmp_path),
        concurrency=4,
        prefetch=4,
        max_job_retries=3,
        retry_delay=0.02,
    )
    client = QueueClient(
        token, broker.connect, supervisor_interval=0.05, drain_timeout=5
    )
    client.set_prefetch(config.prefetch)
    dispatcher = DispatchClient(
        token,
        str(tmp_path),
        [HTTPBackend(progress_interval=5.0, timeout=5)],
    )
    uploader = Uploader(
        config.bucket, S3Client(stub.endpoint, Credentials("k", "s"))
    )
    daemon = Daemon(token, client, dispatcher, uploader, config)
    runner = threading.Thread(target=daemon.run, daemon=True)
    runner.start()
    time.sleep(0.2)

    producer = broker.connect().channel()

    def enqueue(media_id: str, url: str) -> None:
        body = Download(media=Media(id=media_id, source_uri=url)).marshal()
        producer.publish("v1.download", "v1.download-0", body)

    def settled() -> int:
        stats = daemon.stats
        return stats.processed + stats.failed + stats.dropped

    try:
        # -- warmup: get past import-time/lazy allocations, then baseline
        for n in range(50):
            enqueue(f"warm-{n}", f"{base}/warm-{n}.mkv")
        assert wait_for(lambda: settled() >= 50, timeout=60)
        baseline_fds = _fd_count()
        baseline_threads = threading.active_count()
        baseline_rss = _rss_kb()

        # -- the soak: JOBS jobs with churn injections along the way
        dropped_messages = 0
        for n in range(JOBS):
            if n % 97 == 0:
                # malformed protobuf: decode-and-drop path
                producer.publish("v1.download", "v1.download-0", b"\xff\xfe")
                dropped_messages += 1
            if n % 131 == 0:
                # unsupported scheme: dispatch-and-drop path
                enqueue(f"bad-{n}", f"gopher://nope/{n}")
                dropped_messages += 1
            enqueue(f"soak-{n}", f"{base}/soak-{n}.mkv")
            if n % 100 == 99:
                # broker outage mid-stream: supervisor must reconnect,
                # unacked jobs redeliver (at-least-once)
                broker.drop_connections()
                producer = broker.connect().channel()
        # every enqueued job settles: processed, or dropped (bad ones);
        # at-least-once means processed can exceed the enqueue count
        assert wait_for(
            lambda: daemon.stats.processed >= 50 + JOBS - 10
            and settled() >= 50 + JOBS + dropped_messages - 10,
            timeout=300,
        ), f"settled={settled()} processed={daemon.stats.processed}"
        # drain the tail (redeliveries from the last drop)
        time.sleep(1.0)
        # DISTINCT completions, not counter sums: at-least-once
        # redelivery duplicates bump stats.processed and could mask
        # lost jobs — the stub records every uploaded key even with
        # retain_objects=False, so assert each job's object landed
        uploaded = set(stub.buckets.get("triton-staging", {}))
        missing = [
            n
            for n in range(JOBS)
            if not any(key.startswith(f"soak-{n}/") for key in uploaded)
        ]
        assert not missing, f"jobs never completed: {missing[:10]}"

        # -- mid-job cancellation: wait until the slow transfers are
        # demonstrably in flight (the server started streaming them),
        # THEN fire the token — the drain must interrupt live
        # downloads, not just an idle queue
        before = _ChurnHandler.counter
        for n in range(8):
            enqueue(f"cancel-{n}", f"{base}/cancel-{n}.mkv")
        assert wait_for(
            lambda: _ChurnHandler.counter >= before + 1, timeout=20
        ), "no cancel-phase transfer ever started"
    finally:
        token.cancel()
        runner.join(timeout=20)
        assert not runner.is_alive(), "daemon failed to drain on cancel"
        httpd.shutdown()
        stub.stop()

    # -- flatness: the process held no growth after ~550 jobs + churn
    end_fds = _fd_count()
    end_threads = threading.active_count()
    end_rss = _rss_kb()
    assert end_fds <= baseline_fds + 10, (
        f"fd leak: {baseline_fds} -> {end_fds}"
    )
    assert end_threads <= baseline_threads + 4, (
        f"thread leak: {baseline_threads} -> {end_threads}"
    )
    # threshold sized against the work: ~36 MB of payload moved; a
    # daemon retaining bodies (or buffers per reconnect) blows this,
    # ordinary allocator jitter does not
    assert end_rss <= baseline_rss + 25_000, (
        f"rss growth: {baseline_rss} KB -> {end_rss} KB"
    )


@pytest.mark.slow
def test_torrent_job_soak_no_socket_or_thread_leaks(tmp_path, monkeypatch):
    """The torrent stack is the process's heaviest socket/thread user
    (listener + uTP mux + DHT + per-peer threads per job). Run a
    string of jobs through ONE backend with a shared process-lifetime
    DHT node — half completing, half losing their seeder mid-swarm and
    failing — and assert fd/thread flatness afterward: failed jobs
    must release everything too."""
    from downloader_tpu_torch.fetch import TransferError
    from downloader_tpu_torch.fetch.dht import DHTNode
    from downloader_tpu_torch.fetch.seeder import Seeder
    from downloader_tpu_torch.fetch.torrent import TorrentBackend
    from downloader_tpu_torch.parallel import engine as engine_module

    # the port's default engine needs a card; pieces are checked with
    # hashlib here, as in the swarm twins
    monkeypatch.setattr(engine_module, "_default", engine_module.DigestEngine(backend="hashlib"))
    hub = DHTNode()
    backend = TorrentBackend(
        progress_interval=0.05,
        dht_bootstrap=(("127.0.0.1", hub.port),),
        shared_dht=True,
    )
    payload = os.urandom(256 * 1024)

    def run_job(n: int, kill_mid_job: bool) -> bool:
        job_dir = tmp_path / f"job-{n}"
        job_dir.mkdir()
        # kill jobs use the seeder's die-mid-download fixture: the
        # serve counter is GLOBAL, so after 6 blocks every connection
        # (including reconnects from retry rounds) drops immediately —
        # a deterministic mid-swarm peer death
        seeder = Seeder(
            f"media-{n}.mkv",
            payload,
            serve_limit=6 if kill_mid_job else None,
        ).__enter__()
        try:
            backend.download(
                CancelToken(),
                str(job_dir),
                lambda url, pct: None,
                seeder.magnet_uri,
            )
            completed = True
        except TransferError:
            completed = False
        finally:
            seeder.__exit__(None, None, None)
        if kill_mid_job:
            assert seeder.served_requests, "kill job never transferred"
        return completed

    # warmup: first job pays lazy imports/engine calibration
    assert run_job(0, kill_mid_job=False)
    baseline_fds = _fd_count()
    baseline_threads = threading.active_count()

    completed = failed = 0
    try:
        for n in range(1, 9):
            if run_job(n, kill_mid_job=(n % 2 == 0)):  # 4 of each
                completed += 1
            else:
                failed += 1
    finally:
        backend.close()
        hub.close()

    assert completed >= 4, f"only {completed} jobs completed"
    assert failed >= 1, "no job exercised the seeder-death path"
    # flatness: per-job listeners/muxes/DHT clients/peer threads all
    # released, for failed jobs exactly like completed ones
    assert wait_for(
        lambda: _fd_count() <= baseline_fds + 8, timeout=15
    ), f"fd leak: {baseline_fds} -> {_fd_count()}"
    assert wait_for(
        lambda: threading.active_count() <= baseline_threads + 4, timeout=15
    ), (
        f"thread leak: {baseline_threads} -> {threading.active_count()}: "
        f"{sorted(thread.name for thread in threading.enumerate())}"
    )
