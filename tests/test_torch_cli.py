"""``download-once`` of the port against the JAX package's, end to end.

Both ``main()``s run against one loopback origin, each uploading into
an S3 stub of its own package. They must give the same exit codes, the
same printed media paths (relative to each base directory), the same
bucket contents, the same counter moves and, with ``--trace-out``, the
same span names and nesting. Times are not compared. Each package keeps
its own process-wide tracer and metrics registry: its tracer is cleared
before its run and its counters are read as deltas across the run.
"""

import base64
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from downloader_tpu import cli as ref_cli
from downloader_tpu.store import Credentials as RefCredentials
from downloader_tpu.store.stub import S3Stub as RefS3Stub
from downloader_tpu.utils import metrics as ref_metrics
from downloader_tpu.utils import tracing as ref_tracing
from downloader_tpu_torch import cli
from downloader_tpu_torch.store import Credentials
from downloader_tpu_torch.store.stub import S3Stub
from downloader_tpu_torch.utils import metrics, tracing
from test_torch_http import TIMEOUT, Origin, _payload

REPO = Path(__file__).resolve().parents[1]
NAME = "Show.S01E01.mkv"
KEY = f"episode-1/original/{base64.b64encode(NAME.encode()).decode()}"
# the metric families a download-once moves; threads other tests left
# running in this process may move other families of the JAX package
FAMILIES = ("http_", "flow_", "s3_", "fetch_", "scan_", "upload_", "overhead_")

PACKAGES = (
    ("port", cli.main, S3Stub, Credentials, tracing.TRACER, metrics.GLOBAL),
    ("ref", ref_cli.main, RefS3Stub, RefCredentials, ref_tracing.TRACER,
     ref_metrics.GLOBAL),
)


@pytest.fixture
def origin():
    server = Origin(_payload(512 * 1024 + 3))
    yield server
    server.close()


@pytest.fixture(autouse=True)
def _default_env(monkeypatch):
    # the reference's defaults: auto striping, 8 MiB minimum segments,
    # the 64 MiB multipart threshold, tracing on
    for name in ("HTTP_SEGMENTS", "HTTP_SEGMENT_MIN_MB", "S3_MULTIPART_THRESHOLD",
                 "S3_PART_SIZE", "TRACE", "TRACE_RING", "ZEROCOPY", "S3_ENDPOINT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("S3_ACCESS_KEY", "ak")
    monkeypatch.setenv("S3_SECRET_KEY", "sk")


def _span_tree(events):
    """The nesting of one job's complete events: the tracer emits each
    tree in preorder, so a span's parent is the innermost open span
    whose interval holds it."""
    spans = [e for e in events if e.get("ph") == "X"]
    root = {"name": None, "children": []}
    stack = [(root, float("inf"))]
    for event in spans:
        start, end = event["ts"], event["ts"] + event["dur"]
        while start >= stack[-1][1] and len(stack) > 1:
            stack.pop()
        node = {"name": event["name"], "children": []}
        stack[-1][0]["children"].append(node)
        stack.append((node, end + 0.2))  # the tracer rounds to 0.1 µs

    def canonical(node):
        return (node["name"], tuple(sorted(canonical(c) for c in node["children"])))

    return [canonical(child) for child in root["children"]]


def _run(monkeypatch, capsys, tmp_path, package, args, upload=True):
    name, main, stub_cls, creds_cls, tracer, registry = package
    base = tmp_path / name
    trace_out = tmp_path / f"{name}-trace.json"
    tracer.clear()
    capsys.readouterr()
    counters = registry.snapshot()
    observed = {k: v[3] for k, v in registry.histograms().items()}
    with stub_cls(credentials=creds_cls(access_key="ak", secret_key="sk")) as stub:
        if upload:
            monkeypatch.setenv("S3_ENDPOINT", f"http://{stub.endpoint}")
        code = main(["--trace-out", str(trace_out)] + args + ["--base-dir", str(base)])
        bucket = {
            bucket: dict(objects) for bucket, objects in stub.buckets.items()
        }
        dangling = stub.list_multipart_uploads()
    moved = {
        key: value - counters.get(key, 0)
        for key, value in registry.snapshot().items()
        if value != counters.get(key, 0) and key.startswith(FAMILIES)
    }
    # histogram families by samples taken (the values are times)
    moved.update(
        (f"{key}.count", value[3] - observed.get(key, 0))
        for key, value in registry.histograms().items()
        if value[3] != observed.get(key, 0) and key.startswith(FAMILIES)
    )
    printed = [
        os.path.relpath(line, str(base))
        for line in capsys.readouterr().out.splitlines()
    ]
    events = json.loads(trace_out.read_text())["traceEvents"]
    return {
        "code": code,
        "printed": printed,
        "bucket": bucket,
        "dangling": dangling,
        "counters": moved,
        "spans": _span_tree(events),
    }


CASES = {
    "upload": (f"/{NAME}", [], True),
    "not-found": ("/missing/Show.S01E02.mkv", [], True),
    "skip-upload": (f"/{NAME}", ["--skip-upload"], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_download_once_matches_reference(monkeypatch, capsys, tmp_path, origin, case):
    path, extra, upload = CASES[case]
    args = ["download-once", "--id", "episode-1", "--url", origin.url + path] + extra
    port, ref = (
        _run(monkeypatch, capsys, tmp_path, package, args, upload=upload)
        for package in PACKAGES
    )
    assert port == ref
    if case == "upload":
        assert port["code"] == 0 and port["printed"] == [f"episode-1/{NAME}"]
        assert port["bucket"] == {"triton-staging": {KEY: origin.payload}}
        assert port["counters"]["s3_bytes_uploaded"] == len(origin.payload)
        assert port["counters"]["flow_origin_bytes_total"] == len(origin.payload)
        (job,) = port["spans"]
        assert job[0] == "job"
        assert [child[0] for child in job[1]] == ["fetch", "scan", "upload"]
    elif case == "not-found":
        assert port["code"] == 1 and port["printed"] == []
        assert port["bucket"] == {}
    else:
        assert port["code"] == 0 and port["printed"] == [f"episode-1/{NAME}"]
        assert (tmp_path / "port" / "episode-1" / NAME).read_bytes() == origin.payload
        assert port["bucket"] == {}
    assert port["dangling"] == []


def test_serve_exits_2_without_the_daemon(monkeypatch):
    # the port has no queue-driven daemon yet; hiding the reference's
    # takes it down the same ImportError branch
    monkeypatch.setitem(sys.modules, "downloader_tpu.daemon.app", None)
    monkeypatch.delenv("FLEET_WORKERS", raising=False)
    assert cli.main(["serve"]) == ref_cli.main(["serve"]) == 2


def test_magnet_url_exits_1_until_the_torrent_engine(tmp_path):
    # the port registers the HTTP backend only, so a magnet link has no
    # backend and the job fails cleanly (the reference would fetch it)
    code = cli.main([
        "download-once", "--id", "m", "--url", "magnet:?xt=urn:btih:" + "ab" * 20,
        "--base-dir", str(tmp_path), "--skip-upload",
    ])
    assert code == 1


def test_http_job_never_touches_cuda(origin, tmp_path):
    # a fresh interpreter: this test process has imported the engine
    # for other tests
    script = (
        "import json, sys\n"
        "from downloader_tpu_torch.cli import main\n"
        f"code = main(['download-once', '--id', 'e', '--url', {origin.url + '/' + NAME!r},"
        f" '--base-dir', {str(tmp_path)!r}, '--skip-upload'])\n"
        "torch = sys.modules.get('torch')\n"
        "print(json.dumps({'code': code,"
        " 'engine': 'downloader_tpu_torch.parallel.engine' in sys.modules,"
        " 'cuda_initialized': bool(torch and torch.cuda.is_initialized())}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    done = subprocess.run(
        [sys.executable, "-c", script], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=6 * TIMEOUT,
    )
    assert done.returncode == 0, done.stderr
    result = json.loads(done.stdout.splitlines()[-1])
    assert result == {"code": 0, "engine": False, "cuda_initialized": False}
