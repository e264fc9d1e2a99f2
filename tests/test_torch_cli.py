"""``download-once`` of the port against the JAX package's, end to end.

Both ``main()``s run against one loopback origin (an HTTP file, or a
torrent seeder reached by magnet or by a ``.torrent`` URL), each
uploading into an S3 stub of its own package. They must give the same exit codes, the
same printed media paths (relative to each base directory), the same
bucket contents, the same counter moves and, with ``--trace-out``, the
same span names and nesting. Times are not compared. Each package keeps
its own process-wide tracer and metrics registry: its tracer is cleared
before its run and its counters are read as deltas across the run.
``serve`` is compared by the arguments each package's CLI hands its
daemon (both ``serve()``s replaced by recorders), and by the port's
exit 2 where the reference would start its fleet.
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
import downloader_tpu.parallel.engine as ref_engine
from downloader_tpu_torch import cli
import downloader_tpu_torch.parallel.engine as port_engine
from downloader_tpu_torch.fetch.seeder import Seeder, make_torrent
from downloader_tpu_torch.store import Credentials
from downloader_tpu_torch.store.stub import S3Stub
from downloader_tpu_torch.utils import metrics, tracing
from test_torch_http import TIMEOUT, Origin, _payload

REPO = Path(__file__).resolve().parents[1]
NAME = "Show.S01E01.mkv"
KEY = f"episode-1/original/{base64.b64encode(NAME.encode()).decode()}"
MOVIE = _payload(5 * 16 * 1024 + 321)
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
    # torrent jobs stay on loopback: no DHT routers, no LAN multicast
    monkeypatch.setenv("DHT_BOOTSTRAP", "off")
    monkeypatch.setenv("LSD", "off")


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


SERVE_CASES = {
    # (argv, env): the flags win over the env; the env wins over the
    # argparse defaults
    "env": (["serve"], {"DOWNLOAD_DIR": "dl", "BUCKET": "b-env", "JOB_CONCURRENCY": "3"}),
    "flags": (["serve", "--base-dir", "x", "--bucket", "b", "--concurrency", "2"],
              {"DOWNLOAD_DIR": "dl", "BUCKET": "b-env", "JOB_CONCURRENCY": "3"}),
    "workers-1": (["serve", "--workers", "1"], {}),
    "workers-2": (["serve", "--workers", "2"], {}),
    "fleet-env": (["serve"], {"FLEET_WORKERS": "2"}),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_matches_reference(monkeypatch, tmp_path, case):
    """``serve`` with one process calls each package's ``serve()`` with the
    same base dir, bucket and concurrency; with ``--workers N`` > 1 the
    reference runs its fleet and the port, which has none, exits 2 and
    starts nothing."""
    import downloader_tpu.daemon.app as ref_app
    import downloader_tpu.daemon.fleet as ref_fleet
    import downloader_tpu_torch.daemon.app as port_app

    argv, env = SERVE_CASES[case]
    monkeypatch.chdir(tmp_path)
    for name in ("DOWNLOAD_DIR", "BUCKET", "JOB_CONCURRENCY", "FLEET_WORKERS"):
        # set first so that monkeypatch restores them: the reference's
        # fleet branch writes them into os.environ itself
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = {"port": [], "ref": []}

    def recorder(name):
        def call(**kwargs):
            calls[name].append(kwargs)
            return 0
        return call

    monkeypatch.setattr(port_app, "serve", recorder("port"))
    monkeypatch.setattr(ref_app, "serve", recorder("ref"))
    monkeypatch.setattr(ref_fleet, "run_fleet", recorder("ref"))
    port_code = cli.main(argv)
    ref_code = ref_cli.main(argv)
    fleet = case in ("workers-2", "fleet-env")
    if fleet:
        assert port_code == 2 and calls["port"] == []
        assert ref_code == 0 and calls["ref"] == [{"workers": 2}]
        return
    assert port_code == ref_code == 0
    assert calls["port"] == calls["ref"]
    (kwargs,) = calls["port"]
    if case == "flags":
        assert kwargs == {"base_dir": str(tmp_path / "x"), "bucket": "b", "concurrency": 2}
    elif case == "env":
        assert kwargs == {"base_dir": str(tmp_path / "dl"), "bucket": "b-env",
                          "concurrency": 3}
    else:
        assert kwargs == {"base_dir": str(tmp_path / "downloading"),
                          "bucket": "triton-staging", "concurrency": 1}


@pytest.fixture
def hashlib_engines(monkeypatch):
    # the torrent jobs verify pieces through each package's default
    # engine; hashlib keeps them light (the card path has its own tests)
    monkeypatch.setattr(port_engine, "_default", port_engine.DigestEngine(backend="hashlib"))
    monkeypatch.setattr(ref_engine, "_default", ref_engine.DigestEngine(backend="hashlib"))


def test_magnet_url_matches_reference(monkeypatch, capsys, tmp_path, hashlib_engines):
    """A magnet job: both main()s fetch it from a loopback seeder (the
    magnet carries the tracker), exit 0 and store the same objects."""
    with Seeder(NAME, MOVIE, piece_length=16 * 1024) as seeder:
        args = ["download-once", "--id", "episode-1", "--url", seeder.magnet_uri]
        port, ref = (_run(monkeypatch, capsys, tmp_path, package, args)
                     for package in PACKAGES)
    assert port == ref
    assert port["code"] == 0 and port["printed"] == [f"episode-1/{NAME}"]
    assert port["bucket"] == {"triton-staging": {KEY: MOVIE}}
    (job,) = port["spans"]
    assert [child[0] for child in job[1]] == ["fetch", "scan", "upload"]


def test_torrent_file_url_matches_reference(monkeypatch, capsys, tmp_path, hashlib_engines):
    with Seeder(NAME, MOVIE, piece_length=16 * 1024) as seeder:
        _, meta, _ = make_torrent(NAME, MOVIE, piece_length=16 * 1024,
                                  trackers=(seeder.tracker_url,))
        server = Origin(meta)
        try:
            args = ["download-once", "--id", "episode-1", "--url", server.url + "/x.torrent"]
            port, ref = (_run(monkeypatch, capsys, tmp_path, package, args)
                         for package in PACKAGES)
            missing = ["download-once", "--id", "episode-2", "--url",
                       server.url + "/missing/y.torrent"]
            port_missing, ref_missing = (_run(monkeypatch, capsys, tmp_path, package, missing)
                                         for package in PACKAGES)
        finally:
            server.close()
    assert port == ref
    assert port["code"] == 0 and port["bucket"] == {"triton-staging": {KEY: MOVIE}}
    assert port_missing["code"] == ref_missing["code"] == 1
    assert port_missing["bucket"] == ref_missing["bucket"] == {}


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
