"""The PyTorch/CUDA port's hermetic pipeline rig, shared by
``bench_torch.py``, ``hack/failpoint_matrix_torch.py`` and
``hack/profile_artifacts_torch.py``.

``Pipeline`` wires ``downloader_tpu_torch``'s ``Daemon`` to a payload
server and an S3 stub, each in a child process (in-process they would
share the GIL with the daemon's transfer threads), the memory broker
and a Convert sink. ``run_profile_arm`` drives a wave of small jobs
through it with the port's sampling profiler live and reports where
the samples went. The rig imports the port alone, and its HTTP path
imports no torch.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from downloader_tpu_torch.daemon.app import Daemon, build_connection_factory
from downloader_tpu_torch.daemon.config import Config
from downloader_tpu_torch.fetch import DispatchClient, HTTPBackend
from downloader_tpu_torch.queue import QueueClient
from downloader_tpu_torch.store import Credentials, S3Client, Uploader
from downloader_tpu_torch.utils import configure_from_env
from downloader_tpu_torch.utils.cancel import CancelToken
from downloader_tpu_torch.wire import Convert, Download, Media

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a loopback file server over one directory: GET of /<name> sends the
# file with sendfile
_PAYLOAD_SERVER = """
import http.server, os, sys
root = sys.argv[1]
class Quiet(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *args): pass
    def do_GET(self):
        path = os.path.join(root, os.path.basename(self.path))
        try:
            size = os.path.getsize(path)
        except OSError:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(size))
        self.end_headers()
        with open(path, "rb") as f:
            sent = 0
            while sent < size:  # sendfile may send short; always retry
                n = os.sendfile(self.wfile.fileno(), f.fileno(), sent, size - sent)
                if n == 0:
                    break
                sent += n
httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
print(httpd.server_address[1], flush=True)
httpd.serve_forever()
"""

# the port's S3 stub; retain_objects=False drains each body through a
# reusable window, so the stub does not grow with the run
_STUB_SERVER = """
import sys
sys.path.insert(0, sys.argv[1])
from downloader_tpu_torch.store import Credentials
from downloader_tpu_torch.store.stub import S3Stub
stub = S3Stub(credentials=Credentials("bench", "bench"), retain_objects=False).start()
print(stub.endpoint.split(":")[1], flush=True)
import threading
threading.Event().wait()
"""


def quiet_logging() -> None:
    """Log at warning level unless ``LOG_LEVEL`` says otherwise: the
    pipeline's per-job info lines are measurable overhead at loopback
    speeds. The tools call it before they run the pipeline."""
    os.environ.setdefault("LOG_LEVEL", "warning")
    configure_from_env()


def _spawn_server(code: str, *args: str) -> tuple[subprocess.Popen, int]:
    proc = subprocess.Popen(
        [sys.executable, "-c", code, *args],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        text=True,
    )
    port_line = proc.stdout.readline().strip()
    if not port_line:
        proc.kill()
        proc.wait()
        raise RuntimeError("pipeline helper server failed to start")
    return proc, int(port_line)


class Pipeline:
    """The port's full hermetic pipeline (payload server, daemon, S3
    stub, Convert sink) wired up and ready to take jobs: the files of
    ``site`` are the origin, ``payload`` the one a job names unless it
    names another. ``server`` is the origin's (code, extra arguments),
    by default the plain payload server; ``root`` holds the daemon's
    working directory (default: the system's temporary directory).
    ``pipeline`` pins the streaming upload pipeline on or off (None: the
    environment's default); the other options set the daemon's, the
    HTTP backend's and the S3 client's knobs of the same names."""

    def __init__(
        self,
        concurrency: int,
        prefetch: int,
        site: str,
        payload: str = "payload.mkv",
        multipart_threshold: int | None = None,
        part_size: int | None = None,
        batch_jobs: int | None = None,
        zero_copy: bool = True,
        pipeline: bool | None = None,
        part_workers: int | None = None,
        server: tuple[str, tuple[str, ...]] | None = None,
        http_segments: int | None = None,
        quota_jobs: int | None = None,
        root: str | None = None,
    ):
        self.token = CancelToken()
        self.payload = payload
        self.workdir = tempfile.mkdtemp(prefix="pipeline-torch-", dir=root)
        self.httpd = self.stub_proc = None
        try:
            server_code, server_args = server or (_PAYLOAD_SERVER, ())
            self.httpd, http_port = _spawn_server(server_code, site, *server_args)
            self.base_url = f"http://127.0.0.1:{http_port}"
            self.stub_proc, stub_port = _spawn_server(_STUB_SERVER, REPO)
            self.config = Config(
                broker="memory",
                base_dir=self.workdir,
                concurrency=concurrency,
                prefetch=prefetch,
                publish_confirm_timeout=60.0,
            )
            if batch_jobs is not None:
                self.config.batch_jobs = batch_jobs
            if quota_jobs is not None:
                self.config.quota_tenant_jobs = quota_jobs
            connect = build_connection_factory(self.config)
            self.client = QueueClient(self.token, connect, drain_timeout=10.0)
            self.client.set_prefetch(self.config.prefetch)
            dispatcher = DispatchClient(
                self.token,
                self.workdir,
                [
                    HTTPBackend(
                        progress_interval=5.0,
                        timeout=120.0,
                        zero_copy=zero_copy,
                        segments=http_segments,
                    )
                ],
            )
            client_kwargs = {}
            if multipart_threshold is not None:
                client_kwargs["multipart_threshold"] = multipart_threshold
            if part_size is not None:
                client_kwargs["part_size"] = part_size
            self.uploader = Uploader(
                self.config.bucket,
                S3Client(
                    f"127.0.0.1:{stub_port}",
                    Credentials("bench", "bench"),
                    zero_copy=zero_copy,
                    **client_kwargs,
                ),
            )
            if pipeline is not None:
                self.uploader.configure_pipeline(pipeline, part_workers=part_workers)
            daemon = Daemon(
                self.token, self.client, dispatcher, self.uploader, self.config
            )
            self.runner = threading.Thread(target=daemon.run, daemon=True)
            self.runner.start()

            self.producer = connect().channel()
            self.producer.declare_exchange(self.config.consume_topic)
            for i in range(self.client._num_queues):
                name = QueueClient.shard_name(self.config.consume_topic, i)
                self.producer.declare_queue(name)
                self.producer.bind_queue(name, self.config.consume_topic, name)

            self.converts: list[Convert] = []
            convert_channel = connect().channel()
            convert_channel.declare_exchange(self.config.publish_topic)
            convert_channel.declare_queue("pipeline-sink")
            for i in range(self.client._num_queues):
                convert_channel.bind_queue(
                    "pipeline-sink",
                    self.config.publish_topic,
                    QueueClient.shard_name(self.config.publish_topic, i),
                )

            def on_convert(message):
                self.converts.append(Convert.unmarshal(message.body))
                convert_channel.ack(message.delivery_tag)

            convert_channel.consume("pipeline-sink", on_convert)
        except BaseException:
            self.close()
            raise

    def publish_job(
        self,
        index: int,
        media_id: str | None = None,
        payload: str | None = None,
        headers: dict | None = None,
    ) -> None:
        body = Download(
            media=Media(
                id=media_id or f"bench-{index}",
                source_uri=f"{self.base_url}/{payload or self.payload}",
            )
        ).marshal()
        self.producer.publish(
            self.config.consume_topic,
            QueueClient.shard_name(
                self.config.consume_topic, index % self.client._num_queues
            ),
            body,
            headers=headers or {},
        )

    def wait_converts(self, n: int, timeout: float = 600.0) -> None:
        deadline = time.monotonic() + timeout
        while len(self.converts) < n:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"pipeline timed out: {len(self.converts)}/{n} converts"
                )
            time.sleep(0.002)

    def close(self) -> None:
        self.token.cancel()
        runner = getattr(self, "runner", None)
        if runner is not None:
            runner.join(timeout=30)
        uploader = getattr(self, "uploader", None)
        if uploader is not None:
            uploader.close()  # the part pool must not outlive the run
        for proc in (self.httpd, self.stub_proc):
            if proc is not None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.workdir, ignore_errors=True)


# the port's top-level packages, by the pipeline stage their CPU is
_PROFILE_STAGES = {
    "fetch": "fetch",
    "store": "upload",
    "queue": "queue",
    "scan": "scan",
    "wire": "decode",
    "daemon": "daemon",
    "utils": "telemetry",
    "parallel": "digest",
    "analysis": "analysis",
}
_PACKAGE = "downloader_tpu_torch"


def _profile_stage_of(stack: str) -> str:
    """Pipeline stage a CPU sample belongs to: the leaf-most frame
    inside the port decides (a job-worker frame deep in
    fetch/segments.py is fetch work whatever daemon frames sit above
    it); stacks that never enter the port are 'other'."""
    for frame in reversed(stack.split(";")):
        module = frame.split(":", 1)[0]
        if module == _PACKAGE or module.startswith(_PACKAGE + "."):
            parts = module.split(".")
            pkg = parts[1] if len(parts) > 1 else "daemon"
            return _PROFILE_STAGES.get(pkg, pkg)
    return "other"


def run_profile_arm(
    site: str,
    jobs: int,
    concurrency: int,
    artifact_dir: str | None = None,
    root: str | None = None,
) -> dict:
    """N small jobs (``site``'s ``tiny.bin``) through the port's
    pipeline (its working directory under ``root``) with its sampling
    profiler live at a 5 ms tick and heap snapshots on. Reports the share of samples attributed to named
    roles, per-stage CPU shares over the daemon's roles, the named
    locks that waited, and how many stacks each profile mode holds.
    ``artifact_dir`` also receives the collapsed CPU stacks
    (``bench.collapsed``) and their SVG flamegraph (``bench.svg``)."""
    from downloader_tpu_torch.utils import metrics as metrics_mod
    from downloader_tpu_torch.utils import profiling as profiling_mod

    profiler = profiling_mod.PROFILER
    profiler.reset()
    profiler.configure(enabled=True, interval_ms=5.0, heap_interval_s=2.0)
    metrics_before = {
        name: count
        for name, (_, _, _, count) in metrics_mod.GLOBAL.histograms().items()
        if name.startswith("lock_wait_seconds_")
    }
    profiler.start()
    profiling_mod.ROLES.register_current("bench-harness")
    pipeline = Pipeline(
        concurrency, max(concurrency, 32), site, payload="tiny.bin", root=root
    )
    start = time.monotonic()
    try:
        profiling_mod.ROLES.register_thread(pipeline.runner, "bench-harness")
        for i in range(jobs):
            pipeline.publish_job(i)
        pipeline.wait_converts(jobs, timeout=600.0)
    finally:
        elapsed = time.monotonic() - start
        pipeline.close()
    attribution = profiler.attribution()
    cpu = profiler.collapsed(mode="cpu")
    wait = profiler.collapsed(mode="wait")
    heap_stacks = profiler.collapsed(mode="heap")
    cpu_by_role = {
        role: profiler.collapsed(mode="cpu", role=role)
        for role in attribution["by_role"]
        if role != "unattributed"
    }
    svg = profiling_mod.flamegraph_svg(cpu, f"bench cpu — {jobs} small jobs")
    profiler.reset()

    # stage shares over the daemon's roles only: the harness's own
    # publish and poll loops are rig, not pipeline cost
    by_role = attribution["by_role"]
    stage_counts: dict[str, int] = {}
    stage_total = 0
    for role in by_role:
        if role in ("bench-harness", "unattributed"):
            continue
        for stack, count in cpu_by_role[role].items():
            stage = _profile_stage_of(stack)
            stage_counts[stage] = stage_counts.get(stage, 0) + count
            stage_total += count
    stage_cpu_pct = {
        stage: round(100.0 * count / stage_total, 1)
        for stage, count in sorted(stage_counts.items(), key=lambda kv: -kv[1])
        if stage_total
    }
    cpu_roles = sorted(
        (
            (counts.get("cpu", 0), role)
            for role, counts in by_role.items()
            if role not in ("unattributed", "bench-harness")
        ),
        reverse=True,
    )
    waited_locks = sorted(
        name[len("lock_wait_seconds_"):]
        for name, (_, _, _, count) in metrics_mod.GLOBAL.histograms().items()
        if name.startswith("lock_wait_seconds_")
        and count > metrics_before.get(name, 0)
    )
    if artifact_dir:
        os.makedirs(artifact_dir, exist_ok=True)
        with open(os.path.join(artifact_dir, "bench.collapsed"), "w") as sink:
            for stack, count in sorted(cpu.items(), key=lambda kv: -kv[1]):
                sink.write(f"{stack} {count}\n")
        with open(os.path.join(artifact_dir, "bench.svg"), "w") as sink:
            sink.write(svg)
    return {
        "metric": "profile_attribution",
        "jobs": jobs,
        "elapsed_s": round(elapsed, 2),
        "samples": attribution["samples"],
        "attributed_pct": attribution["attributed_pct"],
        "by_role": by_role,
        "top_cpu_role": cpu_roles[0][1] if cpu_roles else None,
        "stage_cpu_pct": stage_cpu_pct,
        "wait_locks": waited_locks,
        "modes_served": {
            "cpu": len(cpu),
            "wait": len(wait),
            "heap": len(heap_stacks),
        },
        "flamegraph_bytes": len(svg),
    }
