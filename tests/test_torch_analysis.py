"""The port's static analyzer and runtime recorders against the JAX
package's.

Mirrors ``tests/test_static_analysis.py`` and ``tests/test_schedules.py``
over ``downloader_tpu_torch.analysis``, in three parts:

- differential checks: every fixture under ``tests/data/analysis/``
  gives both analyzers the same ``(rule, line, message)`` list; the
  port's analyzer over ``downloader_tpu_torch/`` and the reference's
  over a copy of that tree named ``downloader_tpu`` give the same
  verdict and the same ``--emit-summary`` table once the package root is
  replaced; with ``amqp_wire.write_frame``'s suppression stripped, both
  report the same 12 ``no-blocking-under-lock`` findings (the ones a
  by-path run of the reference analyzer, which anchors module names on
  a ``downloader_tpu`` path part, never saw);
- port-only checks: the package gate, suppression reasons and the pin,
  the time budgets, the cache file of the port's own, the protocol
  vocabulary, the recorders on the port's classes, and equal shaker
  decisions;
- the reference's tests whose subject is its own source, mirrored on
  the port's twin where one exists. ``test_regression_device_probe_
  runs_outside_state_lock`` has none: the port's ``DigestEngine`` has no
  ``_devices_with_timeout`` probe (``resolve_devices`` reads the CUDA
  runtime, which needs no watchdog thread).

The file also defines the module-scoped guards that the port's
concurrency-heavy suites import by name, as ``tests/conftest.py``'s
guard the reference's: the lock-order recorder, the protocol recorder
and the schedule shaker, with the same 2 s settle window and the same
teardown assertions.
"""

import json
import queue
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from downloader_tpu import analysis as ref_analysis
from downloader_tpu.analysis import __main__ as ref_main
from downloader_tpu.analysis import cache as ref_cache
from downloader_tpu.analysis import protocols as ref_protocols
from downloader_tpu.analysis import schedules as ref_schedules
from downloader_tpu_torch.analysis import Analyzer, all_checkers, analyze_paths
from downloader_tpu_torch.analysis import __main__ as port_main
from downloader_tpu_torch.analysis import cache as port_cache
from downloader_tpu_torch.analysis.core import Module, iter_package_files
from downloader_tpu_torch.analysis.protocols import RUNTIME_PROTOCOLS, collect_table
from downloader_tpu_torch.analysis.runtime import LockOrderRecorder, ProtocolRecorder
from downloader_tpu_torch.analysis.schedules import DEFAULT_SEED, ScheduleShaker

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "downloader_tpu_torch"
FIXTURES = REPO / "tests" / "data" / "analysis"
RULES = (
    "guarded-by",
    "no-blocking-under-lock",
    "resource-finalization",
    "lock-order",
    "lock-balance",
    "exception-hygiene",
    "protocol",
    "blocking-deadline",
    "thread-role-race",
    "env-knob-documented",
)

# Every `analysis: ignore` in the port, as `--list-suppressions` counts
# them: the nine of the tree before the analyzer came plus
# amqp_wire.write_frame's. A reasoned suppression added later bumps
# this pin in the same diff.
SUPPRESSION_BUDGET = 10
WIRE = "queue/amqp_wire.py"
WIRE_SUPPRESSION = (
    "  # analysis: ignore[no-blocking-under-lock] callers hold the dedicated "
    "_write_lock whose whole job is serializing this send; the heartbeat "
    "monitor tears down a wedged peer's socket, waking the holder"
)


# -- the guards the port's concurrency-heavy suites import -----------------

# the port's twins of tests/conftest.py's module sets: lock order over the
# queue, the HTTP segment workers and the daemon (streaming pipeline,
# batched lane); protocols over the fleet, the data plane, the planes and
# the daemon; the shaker only where the reference shakes
TORCH_LOCK_ORDER_MODULES = {"test_torch_queue", "test_torch_http", "test_torch_daemon"}
TORCH_PROTOCOL_MODULES = {
    "test_torch_fleet",
    "test_torch_singleflight",
    "test_torch_planes",
    "test_torch_daemon",
}
TORCH_SHAKE_MODULES = {"test_torch_singleflight"}
SETTLE_S = 2.0


def _shaker_for(module: str):
    return ScheduleShaker.from_env() if module in TORCH_SHAKE_MODULES else None


@pytest.fixture(autouse=True, scope="module")
def torch_lock_order_guard(request):
    """The port's lock-order recorder over a whole suite: the observed
    acquisition graph (reference locks included) must be acyclic at
    module teardown."""
    module = request.module.__name__
    if module not in TORCH_LOCK_ORDER_MODULES:
        yield
        return
    shaker = _shaker_for(module)
    recorder = LockOrderRecorder(shaker=shaker).install()
    try:
        yield
    finally:
        recorder.uninstall()
        cycles = recorder.cycles()
        seed = getattr(shaker, "seed", None)
        assert not cycles, (
            f"lock-order cycles observed at runtime in {module}"
            + (f" (SCHEDULE_SHAKE_SEED={seed} reproduces)" if seed is not None else "")
            + f": {cycles}"
        )


@pytest.fixture(autouse=True, scope="module")
def torch_protocol_guard(request):
    """The port's protocol recorder over a whole suite: no obligation of
    the port's protocol classes may stay open at module teardown."""
    module = request.module.__name__
    if module not in TORCH_PROTOCOL_MODULES:
        yield
        return
    recorder = ProtocolRecorder(shaker=_shaker_for(module)).install()
    try:
        yield
        # worker/publisher threads release their liveness watches in
        # finally blocks that can still be running at teardown: a drain
        # is not a leak
        deadline = time.monotonic() + SETTLE_S
        while recorder.leaked() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        recorder.uninstall()
        leaks = recorder.leaked()
        assert not leaks, (
            f"protocol obligations leaked in {module}:\n" + "\n".join(leaks)
        )


# -- differential: the port's analyzer against the reference's -------------


def _triples(violations) -> list:
    return [(v.rule, v.line, v.message) for v in violations]


@pytest.mark.parametrize(
    "fixture", sorted(path.name for path in FIXTURES.glob("*.py"))
)
def test_fixture_verdicts_match_reference(fixture):
    port = analyze_paths([FIXTURES / fixture])
    ref = ref_analysis.analyze_paths([FIXTURES / fixture])
    assert _triples(port) == _triples(ref)
    if fixture.startswith("bad_"):
        assert port, f"{fixture} fired nothing"


def _copy_tree(root: Path, name: str, strip_wire_suppression: bool = False) -> Path:
    """The port's source tree copied under ``root/name``, with the repo's
    README beside it (the env-knob rule reads the nearest one)."""
    target = root / name
    shutil.copytree(PORT, target, ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    shutil.copy(REPO / "README.md", root / "README.md")
    if strip_wire_suppression:
        wire = target / WIRE
        source = wire.read_text()
        assert source.count(WIRE_SUPPRESSION) == 1
        wire.write_text(source.replace(WIRE_SUPPRESSION, ""))
    return target


def _normalized(violations, root: Path) -> list:
    prefix = str(root)
    return [
        (v.rule, v.path.replace(prefix, "PKG"), v.line, v.message.replace(prefix, "PKG"))
        for v in violations
    ]


def _cli(package: str, *args: str, cwd: Path = REPO) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{package}.analysis", *args],
        cwd=cwd,
        capture_output=True,
        text=True,
    )


def test_renamed_copy_matches_reference(tmp_path):
    """The port's analyzer over its own package and the reference's over
    the same tree named ``downloader_tpu`` (the name its module anchor
    needs) give the same verdict and the same call graph and summary
    table: both anchor module names and resolve calls across modules."""
    copy = _copy_tree(tmp_path, "downloader_tpu")
    port_summary, ref_summary = tmp_path / "port.json", tmp_path / "ref.json"
    port = _cli("downloader_tpu_torch", "--no-cache", "--json",
                "--emit-summary", str(port_summary))
    ref = _cli("downloader_tpu", str(copy), "--no-cache", "--json",
               "--emit-summary", str(ref_summary))
    assert port.returncode == ref.returncode == 0, port.stdout + ref.stdout
    assert json.loads(port.stdout) == json.loads(ref.stdout)
    port_table = port_summary.read_text().replace(str(PORT), "PKG")
    ref_table = ref_summary.read_text().replace(str(copy), "PKG")
    assert port_table == ref_table
    table = json.loads(port_table)
    # calls across modules resolve: amqp.py's writers reach amqp_wire.py
    assert any(
        "queue/amqp.py::" in src and f"{WIRE}::write_method" in dst
        for src, dst in table["edges"]
    )


def test_stripped_wire_suppression_matches_reference(tmp_path):
    """Without ``write_frame``'s reasoned suppression, both analyzers see
    the same 12 findings: every lock-holding AMQP writer reaches the
    ``sendall``. A by-path run of the reference analyzer over the port's
    tree (module names anchored on ``downloader_tpu``) resolves none of
    these calls and says "ok"."""
    port_copy = _copy_tree(tmp_path / "port", "downloader_tpu_torch", True)
    ref_copy = _copy_tree(tmp_path / "ref", "downloader_tpu", True)
    port = _normalized(analyze_paths([port_copy]), port_copy)
    ref = _normalized(ref_analysis.analyze_paths([ref_copy]), ref_copy)
    assert port == ref
    assert len(port) == 12
    assert {rule for rule, *_ in port} == {"no-blocking-under-lock"}
    assert {path for _, path, *_ in port} == {"PKG/queue/amqp.py", "PKG/queue/amqp_server.py"}
    assert all(f"'sendall()' at PKG/{WIRE}:" in message for *_, message in port)
    # the by-path run that reads the port's tree under its own name sees nothing
    assert ref_analysis.analyze_paths([port_copy]) == []


def test_diff_report_filter_matches_reference(tmp_path):
    """``--diff``'s report filter (changed files plus their transitive
    reverse call-graph dependents) agrees with the reference's and with
    a full run on the files both report on."""
    tree = tmp_path / "pkg"
    tree.mkdir()
    helper = tree / "helper.py"
    helper.write_text("import time\n\n\ndef pump():\n    time.sleep(0.1)\n")
    (tree / "caller.py").write_text(
        "import threading\n"
        "\n"
        "from helper import pump\n"
        "\n"
        "\n"
        "class Conn:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "\n"
        "    def send(self):\n"
        "        with self._lock:\n"
        "            pump()\n"
    )
    files = sorted(tree.rglob("*.py"))
    full = Analyzer(full_scope=True).run(list(files))
    assert any(v.path.endswith("caller.py") for v in full), full
    port = Analyzer(full_scope=True).run(
        list(files), report_paths=port_main._with_reverse_dependents({str(helper)})
    )
    ref = ref_analysis.Analyzer(full_scope=True).run(
        list(files), report_paths=ref_main._with_reverse_dependents({str(helper)})
    )
    assert [str(v) for v in port] == [str(v) for v in ref] == [
        str(v) for v in full if v.path.endswith(("helper.py", "caller.py"))
    ]


# -- the tier-1 gate over the port ------------------------------------------


def test_package_analyzes_clean():
    violations = analyze_paths([PORT])
    assert not violations, "\n".join(str(v) for v in violations)


def test_every_suppression_carries_a_reason():
    for path in iter_package_files(PORT):
        module = Module.load(path)
        for line, entries in module.suppressions.items():
            for rule, reason in entries:
                assert reason, f"{path}:{line}: ignore[{rule}] has no reason"


def test_full_rule_catalog_registered():
    rules = {cls.rule for cls in all_checkers()}
    assert rules == set(RULES) == {cls.rule for cls in ref_analysis.all_checkers()}


def test_suppression_budget_is_pinned():
    result = _cli("downloader_tpu_torch", "--list-suppressions", "--json")
    assert result.returncode == 0, result.stderr
    payload = json.loads(result.stdout)
    assert payload["count"] == SUPPRESSION_BUDGET == len(payload["suppressions"]), (
        f"suppression count {payload['count']} != pinned {SUPPRESSION_BUDGET}; if "
        "the new suppression carries a real reason, bump SUPPRESSION_BUDGET in "
        "this same diff"
    )
    for entry in payload["suppressions"]:
        assert entry["reason"] and entry["line"] and entry["rule"], entry
        assert Path(entry["path"]).is_relative_to(PORT), entry
    assert any(entry["path"].endswith(WIRE) for entry in payload["suppressions"])


def test_full_tree_analyze_stays_within_budget():
    """A full uncached analysis of the port stays under the reference's
    30 s budget; one remeasure absorbs a noisy-neighbour burst."""
    budget_s = 30.0
    for _ in range(2):
        start = time.monotonic()
        Analyzer(full_scope=True).run(iter_package_files(PORT))
        elapsed = time.monotonic() - start
        if elapsed <= budget_s:
            break
    assert elapsed <= budget_s, f"full-tree analyze took {elapsed:.1f}s"


def test_cached_replay_stays_subsecond(tmp_path):
    files = iter_package_files(PORT)
    cache_path = tmp_path / "cache.json"
    Analyzer(full_scope=True).run(list(files), scan_cache=port_cache.ScanCache(cache_path))
    start = time.monotonic()
    replayed = port_cache.ScanCache(cache_path).replay(list(files))
    elapsed = time.monotonic() - start
    assert replayed == [], "warm cache refused to replay"
    assert elapsed < 1.0, f"cached replay took {elapsed:.2f}s"


def test_cache_file_is_the_ports_own():
    """The two analyzers keep their scan caches apart: each replays
    verdicts of its own package only."""
    port_path, ref_path = port_cache.default_cache_path(), ref_cache.default_cache_path()
    assert port_path != ref_path
    assert port_path == REPO / ".analysis-cache-torch.json"
    assert ref_path.parent == port_path.parent
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert port_path.name in ignored and ref_path.name in ignored


def _run_with_cache(files, cache_path):
    cache = port_cache.ScanCache(cache_path)
    replayed = cache.replay(files)
    if replayed is not None:
        return replayed, cache
    return Analyzer(full_scope=True).run(files, scan_cache=cache), cache


def test_scan_cache_runs_are_byte_identical(tmp_path):
    tree = tmp_path / "pkg"
    tree.mkdir()
    leaky = tree / "leaky.py"
    leaky.write_text(
        "def leak(path):\n"
        "    handle = open(path)\n"
        "    data = handle.read()\n"
        "    if not data:\n"
        "        return None\n"
        "    handle.close()\n"
        "    return data\n"
    )
    (tree / "clean.py").write_text("def fine(items):\n    return sorted(items)\n")
    files = sorted(tree.rglob("*.py"))
    cache_path = tmp_path / "cache.json"
    baseline = Analyzer(full_scope=True).run(list(files))
    assert baseline
    cold, cache = _run_with_cache(list(files), cache_path)
    assert [str(v) for v in cold] == [str(v) for v in baseline]
    assert cache.adopted == 0
    warm, _ = _run_with_cache(list(files), cache_path)
    assert [str(v) for v in warm] == [str(v) for v in baseline]
    leaky.write_text(leaky.read_text())  # same content, new mtime
    partial, cache = _run_with_cache(list(files), cache_path)
    assert [str(v) for v in partial] == [str(v) for v in baseline]
    assert cache.adopted == 1


def test_scan_cache_replay_sees_readme_edits(tmp_path):
    tree = tmp_path / "pkg"
    tree.mkdir()
    readme = tmp_path / "README.md"
    readme.write_text("| `MY_KNOB` | does things |\n")
    (tree / "knobby.py").write_text('import os\n\nLIMIT = os.environ.get("MY_KNOB", "1")\n')
    cache_path = tmp_path / "cache.json"
    files = sorted(tree.rglob("*.py"))
    first, _ = _run_with_cache(list(files), cache_path)
    assert first == []
    readme.write_text("nothing documented anymore\n")
    stale, _ = _run_with_cache(list(files), cache_path)
    assert [v.rule for v in stale] == ["env-knob-documented"]


def test_protocol_vocabulary_agreement():
    """The port's runtime patch table names the port's modules, and it
    agrees with the ``# protocol:`` annotations of the port's tree as the
    reference's table agrees with the reference's."""
    modules = [Module.load(path) for path in iter_package_files(PORT)]
    table = collect_table(modules)
    static = {(m.protocol, m.kind, m.method): m for m in table.methods}
    assert {m.protocol for m in table.methods} == set(RUNTIME_PROTOCOLS)
    assert set(RUNTIME_PROTOCOLS) == set(ref_protocols.RUNTIME_PROTOCOLS)
    for protocol, spec in RUNTIME_PROTOCOLS.items():
        ref_spec = ref_protocols.RUNTIME_PROTOCOLS[protocol]
        assert spec["module"] == ref_spec["module"].replace(
            "downloader_tpu.", "downloader_tpu_torch.", 1
        )
        assert spec["methods"] == ref_spec["methods"]
        for entry in spec["methods"]:
            key = (protocol, entry["kind"], entry["name"])
            assert key in static, f"no `# protocol:` annotation declares {key}"
            assert bool(entry.get("conditional")) == static[key].conditional, key


# -- CLI ----------------------------------------------------------------------


def test_cli_diff_mode_smoke():
    result = _cli("downloader_tpu_torch", "--diff", "HEAD", "--json", "--no-cache")
    assert result.returncode in (0, 1), result.stderr
    payload = json.loads(result.stdout)
    assert payload["count"] == len(payload["violations"])


def test_cli_diff_reports_only_port_files(monkeypatch):
    """``--diff``'s changed set is cut to the analyzed package: what git
    lists in the reference's tree or the tests never enters the port's
    report."""
    listed = {
        ("diff",): "downloader_tpu_torch/queue/amqp.py\ndownloader_tpu/queue/amqp.py\n",
        ("ls-files",): "tests/test_torch_analysis.py\ndownloader_tpu_torch/analysis/new.py\n",
    }

    def fake_git(command, **kwargs):
        return subprocess.CompletedProcess(command, 0, stdout=listed[(command[1],)])

    monkeypatch.setattr(port_main.subprocess, "run", fake_git)
    files = iter_package_files(PORT)
    assert port_main._changed_vs("HEAD", files) == {str(PORT / "queue" / "amqp.py")}


def test_cli_emit_summary_writes_callgraph_artifact(tmp_path):
    out = tmp_path / "summary.json"
    result = _cli(
        "downloader_tpu_torch", str(FIXTURES / "bad_interproc_blocking.py"),
        "--emit-summary", str(out),
    )
    assert result.returncode == 1, result.stdout + result.stderr
    payload = json.loads(out.read_text())
    assert payload["functions"] >= 4
    assert any("send" in src and "_flush" in dst for src, dst in payload["edges"])
    assert any(entry.get("may_block") for entry in payload["summaries"].values())


def test_cli_json_output_and_exit_code_on_violations():
    result = _cli("downloader_tpu_torch", str(FIXTURES / "bad_guarded_by.py"), "--json")
    assert result.returncode == 1
    payload = json.loads(result.stdout)
    assert payload["count"] == len(payload["violations"]) >= 1
    entry = payload["violations"][0]
    assert (entry["rule"], Path(entry["path"]).name, entry["line"]) == (
        "guarded-by", "bad_guarded_by.py", 16)


def test_cli_usage_names_the_port():
    result = _cli("downloader_tpu_torch", "--help")
    assert result.returncode == 0
    assert result.stdout.startswith("usage: python -m downloader_tpu_torch.analysis")
    assert ".analysis-cache-torch.json" in "".join(result.stdout.split())


def test_cli_exits_zero_on_clean_input():
    result = _cli("downloader_tpu_torch", str(FIXTURES / "suppressed_ok.py"))
    assert result.returncode == 0, result.stdout + result.stderr
    assert "ok" in result.stdout


# -- the reference's tests of its own source, on the port's twin -------------


def test_regression_queue_prefetch_is_guarded():
    """QueueClient._prefetch, written by the admission ladder's worker and
    read by the supervisor, stays under _lock with its guarded-by
    declaration in the port as in the reference."""
    from downloader_tpu_torch.analysis.engine import scan_cached

    scan = scan_cached(Module.load(PORT / "queue" / "client.py"))
    assert any(d.attr == "_prefetch" and d.lock == "_lock" for d in scan.guards)
    accesses = [
        (fa.node.name, access)
        for fa in scan.functions
        if fa.node.name != "__init__"
        for access in fa.accesses
        if access.attr == "_prefetch"
    ]
    assert accesses
    for name, access in accesses:
        assert "_lock" in access.held, f"{name}() touches _prefetch without _lock"


def test_regression_calibration_probe_runs_under_its_own_lock_only():
    """The port's twin of the device-probe regression: the calibration
    probe (which loads and launches the kernel) runs under
    ``_calibrate_lock`` alone, by design (concurrent first flushes pay for
    one probe), and the launch itself under no lock of the engine."""
    from downloader_tpu_torch.analysis.engine import scan_cached

    scan = scan_cached(Module.load(PORT / "parallel" / "engine.py"))
    held = {
        site.name: site.held
        for fa in scan.functions
        for site in fa.call_sites
        if site.name in ("_measure_calibration", "sha1_states")
    }
    assert held == {"_measure_calibration": ("_calibrate_lock",), "sha1_states": ()}


# -- the runtime recorders on the port's classes ----------------------------


def test_recorder_detects_inverted_acquisition_order():
    with LockOrderRecorder() as recorder:
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        with lock_a:
            with lock_b:
                pass
        with lock_b:
            with lock_a:
                pass
    cycles = recorder.cycles()
    assert cycles and len(cycles[0]) == 3


def test_recorder_accepts_consistent_ordering():
    with LockOrderRecorder() as recorder:
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        for _ in range(3):
            with lock_a:
                with lock_b:
                    pass
    assert recorder.edges()
    assert recorder.cycles() == []


def test_recorder_keeps_condition_variables_working():
    with LockOrderRecorder() as recorder:
        channel: "queue.Queue[int]" = queue.Queue()

        def produce():
            for i in range(5):
                channel.put(i)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        got = [channel.get(timeout=5.0) for _ in range(5)]
        worker.join(timeout=5.0)
    assert not worker.is_alive()
    assert got == [0, 1, 2, 3, 4]
    assert recorder.cycles() == []


def test_recorder_across_queue_client_scenario():
    from downloader_tpu_torch.queue import QueueClient
    from downloader_tpu_torch.queue.memory import MemoryBroker
    from downloader_tpu_torch.utils.cancel import CancelToken

    with LockOrderRecorder() as recorder:
        broker = MemoryBroker()
        token = CancelToken()
        client = QueueClient(token, broker.connect, supervisor_interval=0.05)
        deliveries = client.consume("v1.download")
        assert client.publish("v1.download", b"payload", wait=5.0)
        delivery = deliveries.get(timeout=5.0)
        assert delivery.body == b"payload"
        delivery.ack()
        token.cancel()
        client.done()
    assert recorder.edges()
    assert recorder.cycles() == [], recorder.cycles()
    port_sites = {site for edge in recorder.edges() for site in edge if str(PORT) in site}
    assert any("queue/client.py" in site for site in port_sites), port_sites


def test_recorder_across_streaming_pipeline_scenario(tmp_path):
    import os

    from downloader_tpu_torch.store import Uploader
    from downloader_tpu_torch.store.credentials import Credentials
    from downloader_tpu_torch.store.s3 import S3Client
    from downloader_tpu_torch.store.stub import S3Stub

    creds = Credentials(access_key="testkey", secret_key="testsecret")
    part = 64 * 1024
    with LockOrderRecorder() as recorder:
        with S3Stub(credentials=creds) as stub:
            client = S3Client(stub.endpoint, creds, multipart_threshold=2 * part,
                              part_size=part)
            uploader = Uploader("bucket", client)
            uploader.configure_pipeline(True, part_workers=2)
            data = os.urandom(4 * part)
            path = tmp_path / "movie.mkv"
            path.write_bytes(data)
            session = uploader.streaming_session("m1")
            try:
                session.begin_file(str(path), len(data))
                for offset in range(0, len(data), part):
                    session.add_span(str(path), offset, offset + part)
                session.finish_file(str(path))
                assert session.finalize([str(path)]), "stream did not complete"
            finally:
                session.close()
                uploader.close()
    assert recorder.cycles() == [], recorder.cycles()


def test_protocol_recorder_flags_deliberate_leak():
    from downloader_tpu_torch.utils.cancel import CancelToken

    with ProtocolRecorder() as recorder:
        parent = CancelToken()
        child = parent.child()  # acquired and deliberately never detached
    leaks = recorder.leaked()
    assert len(leaks) == 1, leaks
    assert "cancel-token" in leaks[0]
    assert "test_torch_analysis.py" in leaks[0]  # the acquisition site
    child.detach()


def test_protocol_recorder_patches_only_the_ports_classes():
    """The port's recorder tracks the port's tokens; the reference's
    classes stay untouched under it."""
    from downloader_tpu.utils.cancel import CancelToken as RefCancelToken
    from downloader_tpu_torch.utils.cancel import CancelToken

    original = RefCancelToken.__dict__["child"]
    with ProtocolRecorder() as recorder:
        assert RefCancelToken.__dict__["child"] is original
        assert CancelToken.__dict__["child"] is not original
        ref_child = RefCancelToken().child()
    assert recorder.leaked() == []
    ref_child.detach()


def test_protocol_recorder_balances_released_lifecycles():
    from downloader_tpu_torch.utils.admission import Ledger
    from downloader_tpu_torch.utils.cancel import CancelToken
    from downloader_tpu_torch.utils.tracing import Tracer

    with ProtocolRecorder() as recorder:
        ledger = Ledger({"slots": 1})
        assert ledger.try_charge("slots", "job-1", 1)
        assert not ledger.try_charge("slots", "job-2", 5)
        token = CancelToken()
        child = token.child()
        child.detach()
        child.detach()
        trace = Tracer(capacity=4).open_job("job-1")
        trace.complete()
        ledger.refund("job-1")
        ledger.refund("job-1")
    assert recorder.leaked() == [], recorder.leaked()


def test_protocol_recorder_partial_install_unwinds():
    from downloader_tpu_torch.utils.cancel import CancelToken

    original_child = CancelToken.__dict__["child"]
    broken = {
        "cancel-token": {
            "module": "downloader_tpu_torch.utils.cancel",
            "methods": [
                {"class": "CancelToken", "name": "child", "kind": "acquire", "key": "result"},
                {"class": "CancelToken", "name": "no_such_method", "kind": "release",
                 "key": "self"},
            ],
        },
    }
    recorder = ProtocolRecorder(broken)
    with pytest.raises(KeyError):
        recorder.install()
    assert CancelToken.__dict__["child"] is original_child
    recorder.uninstall()
    assert CancelToken.__dict__["child"] is original_child


# -- the schedule shaker -----------------------------------------------------


def test_shaker_decisions_match_reference():
    """One seed, site and counter give the same decision in both
    packages: SCHEDULE_SHAKE_SEED bends both suites' schedules alike."""
    assert DEFAULT_SEED == ref_schedules.DEFAULT_SEED
    for seed in (DEFAULT_SEED, 7, 42):
        port, ref = ScheduleShaker(seed=seed), ref_schedules.ScheduleShaker(seed=seed)
        for site in ("x.py:10", "downloader_tpu_torch/parallel/engine.py:109"):
            for count in range(256):
                assert port.decision(site, count) == ref.decision(site, count)


def test_shaker_seeds_bend_the_schedule_differently():
    a, b = ScheduleShaker(seed=1), ScheduleShaker(seed=2)
    assert any(a.decision("site.py:1", n) != b.decision("site.py:1", n) for n in range(512))


def test_shaker_from_env_reads_the_shared_knob():
    assert ScheduleShaker.from_env({}).seed == DEFAULT_SEED
    assert ScheduleShaker.from_env({"SCHEDULE_SHAKE_SEED": "99"}).seed == 99
    assert ScheduleShaker.from_env({"SCHEDULE_SHAKE_SEED": "x"}).seed == DEFAULT_SEED


def _inversion_scenario(shaker):
    """tests/test_schedules.py's latent inversion, under the port's
    recorder: the second worker takes b -> a only when it observes the
    first inside its a-held window."""
    with LockOrderRecorder(shaker=shaker) as recorder:
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        observed = threading.Event()

        def first():
            with lock_a:
                with lock_b:
                    pass

        def second():
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                if lock_a.locked():
                    observed.set()
                    break

        if shaker is None:
            first()
            second()
        else:
            workers = [threading.Thread(target=fn, daemon=True) for fn in (first, second)]
            for worker in workers:
                worker.start()
            for worker in workers:
                worker.join(timeout=10.0)
                assert not worker.is_alive()
        if observed.is_set():
            with lock_b:
                with lock_a:
                    pass
    return recorder.cycles()


def test_shaker_reproduces_seeded_inversion_deterministically():
    assert _inversion_scenario(None) == []

    def shaken():
        return _inversion_scenario(ScheduleShaker(seed=7, rate=1, long_every=1, sleep_s=0.05))

    first_run = shaken()
    assert first_run and len(first_run[0]) == 3
    assert shaken() == first_run


def test_shaker_counts_yields_through_the_protocol_recorder():
    from downloader_tpu_torch.utils.admission import Ledger

    shaker = ScheduleShaker(seed=3, rate=1, long_every=10 ** 9)
    with ProtocolRecorder(shaker=shaker) as recorder:
        ledger = Ledger({"slots": 2})
        assert ledger.try_charge("slots", "job-1", 1)
        ledger.refund("job-1")
    assert recorder.leaked() == []
    assert shaker.yields >= 2


def test_guard_module_sets_name_existing_suites():
    """Each guarded suite exists and imports the guards it is listed
    for; nothing else imports them."""
    tests = REPO / "tests"
    listed = TORCH_LOCK_ORDER_MODULES | TORCH_PROTOCOL_MODULES
    assert TORCH_SHAKE_MODULES <= listed
    importers = set()
    for path in sorted(tests.glob("test_torch_*.py")):
        source = path.read_text()
        found = set(re.findall(r"\btorch_(?:lock_order|protocol)_guard\b", source))
        if path.stem != "test_torch_analysis" and found:
            importers.add(path.stem)
            if path.stem in TORCH_LOCK_ORDER_MODULES:
                assert "torch_lock_order_guard" in found, path.stem
            if path.stem in TORCH_PROTOCOL_MODULES:
                assert "torch_protocol_guard" in found, path.stem
    assert importers == listed
