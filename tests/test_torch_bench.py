"""The port's benchmark twins against the JAX package's root scripts.

``bench_torch.py``, ``bench_digest_torch.py`` and
``__graft_entry_torch__.py`` are twins of ``bench.py``,
``bench_digest.py`` and ``__graft_entry__.py`` over
``downloader_tpu_torch``. Here, on the CPU: both reports fold into the
same digest line, arm by arm, but for the ``pallas_*`` → ``cuda_*``
renames; every arm has the reference's signature, returned keys and
``BENCH_*`` knobs with their defaults; the zipf workload replays byte
for byte in both; both ``main()``s, at tiny knobs with the digest arm
off, each in a fresh interpreter, report the same metrics with the
same keys and the same deterministic outputs, and the port's run never
imports torch. The digest micro-benchmark and the graft entry points
run the plain PyTorch SHA-1 on the host (``device="cpu"``) and refuse
to run on a missing card. Throughput is compared nowhere. The
``cuda``-marked case runs on the card.
"""

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from downloader_tpu_torch.parallel.pack import digests_to_bytes
from test_torch_tooling import _returned_keys

REPO = Path(__file__).resolve().parents[1]
# the benchmark scripts live at the repo's root
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import bench_digest  # noqa: E402
import bench_digest_torch  # noqa: E402
import __graft_entry_torch__ as graft  # noqa: E402

REF_BENCH = REPO / "bench.py"
PORT_BENCH = REPO / "bench_torch.py"
PROFILE_TWIN = REPO / "hack" / "pipeline_torch.py"
ARMS = (
    "run_config", "run_ablation", "run_pipeline_ablation", "run_segmented_ablation",
    "run_multi_source_arm", "run_latency", "run_small_object_arm", "run_overload_arm",
    "run_watchdog_ablation", "run_telemetry_ablation", "run_canary_ablation",
    "run_profile_arm", "run_fleet_chaos_arm", "run_fleet_scrape_arm",
    "zipf_object_sizes", "zipf_sample", "run_flow_accounting_arm", "run_single_flight_arm",
)
# bench.py's arms at tiny knobs: every arm on but the digest arm, the
# multi-source arm at its 32 MB floor (a smaller object finishes before
# its failover can land, and the arm then waits out its deadline)
TINY = {
    "BENCH_JOBS": "2", "BENCH_MB": "1", "BENCH_CONCURRENCY": "2", "BENCH_REPEATS": "1",
    "BENCH_SLICES": "1", "BENCH_ABLATION_REPEATS": "1", "BENCH_PIPELINE_REPEATS": "1",
    "BENCH_SEGMENTED_REPEATS": "1", "BENCH_SEGMENTED_JOBS": "1", "BENCH_MULTI_REPEATS": "1",
    "BENCH_LATENCY_SAMPLES": "3", "BENCH_SMALL_WAVE": "2", "BENCH_SMALL_WAVES": "1",
    "BENCH_OVERLOAD_JOBS": "2", "BENCH_OVERLOAD_BULK": "1", "BENCH_PROFILE_JOBS": "10",
    "BENCH_FLEET_JOBS": "4", "BENCH_ZIPF_OBJECTS": "4", "BENCH_SINGLEFLIGHT_OBJECTS": "2",
    "BENCH_SINGLEFLIGHT_BYTES": "65536", "BENCH_DIGEST": "0", "FAILPOINT_SEED": "509",
}
# the outputs of the flow, single-flight and fleet-chaos arms that the
# seed and the at-least-once contract fix
DETERMINISTIC = {
    "flow_accounting": ("workers", "objects", "seed", "origin_amplification",
                        "hot_object_share", "unique_bytes", "ingress_bytes"),
    "single_flight": ("object_bytes", "demand_bytes_nominal", "singleflight_amp",
                      "singleflight_amp_off", "cache_hit_ratio"),
    "fleet_chaos": ("jobs", "workers", "failpoint_spec", "completed", "dangling_multiparts"),
}


def _function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _twin(name: str) -> Path:
    return PROFILE_TWIN if name == "run_profile_arm" else PORT_BENCH


def _returned_dicts(path: Path, name: str) -> list:
    """The key sets of every dict literal ``name`` (nested functions
    included) returns, in source order."""
    return [
        {key.value for key in node.value.keys}
        for node in ast.walk(_function(path, name))
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict)
    ]


def _env_knobs(path: Path) -> dict:
    """``BENCH_*`` name → default source text of every
    ``os.environ.get`` read in ``path``."""
    knobs = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and ast.unparse(node.func.value) == "os.environ"
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value.startswith("BENCH_")):
            knobs[node.args[0].value] = ast.unparse(node.args[1]) if len(node.args) > 1 else None
    return knobs


# -- the digest line ----------------------------------------------------------

# one report per arm; the shapes of the JAX package's digest-line tests
# (tests/test_ci_config.py) and the arms they leave out
ARM_REPORTS = {
    "job_overhead_latency_ms": {"metric": "job_overhead_latency_ms", "value": 2.2},
    "throughput_pairs": {"metric": "throughput_pairs", "pairs": [{"ratio": 1.7}]},
    "ablation": {"metric": "ablation", "data_path_ratio_c1": 1.13,
                 "concurrency_ratio_zero_copy": 1.35},
    "pipeline_overlap": {"metric": "pipeline_overlap", "pipelined_vs_store_forward": 0.96},
    "segmented_vs_single": {
        "metric": "segmented_vs_single", "segmented_vs_single_large": 3.1,
        "segmented_vs_single_small": 1.0,
        "rounds": [{"arms": {"segmented_large": {"overlap_ratio": 0.7, "pool_reuse_hits": 9}}}],
    },
    "multi_source": {"metric": "multi_source", "multi_vs_single": 2.4,
                     "failover": {"completed": True, "fetch_amplification": 1.04,
                                  "source_failovers": 1}},
    "small_object_overhead": {
        "metric": "small_object_overhead",
        "sizes": {"1k": {"batched_p50_ms": 1.5, "batched_vs_unbatched": 3.0},
                  "1m": {"batched_p50_ms": 6.5, "batched_vs_unbatched": 1.1}},
    },
    "overload_shedding": {"metric": "overload_shedding",
                          "protected": {"interactive_p99_ms": 40.0, "shed_jobs": 3},
                          "unprotected": {"interactive_p99_ms": 900.0},
                          "protection_ratio": 22.5},
    "watchdog_overhead": {"metric": "watchdog_overhead", "delta_ms": 0.01},
    "telemetry_overhead": {"metric": "telemetry_overhead", "delta_ms": 0.12},
    "canary_probe": {"metric": "canary_probe", "delta_ms": -0.09, "detect_s": 0.021},
    "profile_attribution": {"metric": "profile_attribution", "attributed_pct": 93.5,
                            "top_cpu_role": "job-worker",
                            "stage_cpu_pct": {"fetch": 61.0, "upload": 20.5}},
    "fleet_chaos": {"metric": "fleet_chaos", "jobs": 12, "completed": 12, "restart_s": 0.22,
                    "dangling_multiparts": 0, "duplicate_converts": 1},
    "fleet_scrape": {"metric": "fleet_scrape", "healthy_ms": 1.6, "wedged_ms": 501.8,
                     "within_one_timeout_budget": True},
    "flow_accounting": {"metric": "flow_accounting", "origin_amplification": 2.0,
                        "hot_object_share": 0.33},
    "single_flight": {"metric": "single_flight", "cache_hit_ratio": 0.5,
                      "singleflight_amp": 1.0, "singleflight_amp_off": 2.0},
    "digest_kernel": {"metric": "digest_kernel", "hashlib_GBps": 1.4, "pallas_GBps": None,
                      "device_reason": "TimeoutError: init [incident=incident-0001]",
                      "device_incident": "incident-0001"},
}
RENAMES = {"pallas_GBps": "cuda_GBps"}


def _renamed(mapping: dict) -> dict:
    return {RENAMES.get(key, key): value for key, value in mapping.items()}


@pytest.mark.parametrize("arm", sorted(ARM_REPORTS))
def test_digest_line_folds_each_arm_as_the_reference(arm):
    ref_report = {"value": 100.0, "vs_baseline": 2.0, "extra_metrics": [ARM_REPORTS[arm]]}
    port_report = {**ref_report, "extra_metrics": [_renamed(ARM_REPORTS[arm])]}
    want = _renamed(bench_digest.digest_line(ref_report))
    assert bench_digest_torch.digest_line(port_report) == want
    assert len(want) > 2 or arm == "throughput_pairs"  # the arm's numbers made it in


def test_digest_line_of_the_port_has_no_pallas_key():
    report = {"extra_metrics": [_renamed(ARM_REPORTS["digest_kernel"])]}
    line = bench_digest_torch.digest_line(report)
    assert "cuda_GBps" in line and not any(key.startswith("pallas") for key in line)


# -- the arms' interfaces -----------------------------------------------------


@pytest.mark.parametrize("name", ARMS)
def test_arm_signature_is_the_references(name):
    def signature(path):
        args = _function(path, name).args
        return [a.arg for a in args.args], [ast.unparse(d) for d in args.defaults]

    ref_names, ref_defaults = signature(REF_BENCH)
    names, defaults = signature(_twin(name))
    if name == "run_profile_arm":
        # the twin also takes the root of its pipeline's working directory
        assert (names[-1], defaults[-1]) == ("root", "None")
        names, defaults = names[:-1], defaults[:-1]
    assert (names, defaults) == (ref_names, ref_defaults)


@pytest.mark.parametrize("name", [n for n in ARMS if _returned_dicts(REF_BENCH, n)])
def test_arm_returns_the_references_keys(name):
    ref = _returned_dicts(REF_BENCH, name)
    assert _returned_dicts(_twin(name), name) == ref
    if len(ref) == 1:
        assert _returned_keys(_twin(name), name) == _returned_keys(REF_BENCH, name)


def test_knobs_and_defaults_are_the_references():
    knobs = _env_knobs(PORT_BENCH)
    assert knobs == _env_knobs(REF_BENCH)
    assert len(knobs) > 40 and knobs["BENCH_JOBS"] == "24" and knobs["BENCH_DIGEST"] == "'1'"
    # the docstring names every knob
    doc = ast.get_docstring(ast.parse(PORT_BENCH.read_text()))
    assert [name for name in knobs if name not in doc] == []


def test_chip_smoke_checks_the_references_metrics_and_knobs():
    smoke = {
        node.targets[0].id: ast.literal_eval(node.value)
        for node in ast.parse((REPO / "chip_smoke.py").read_text()).body
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id in ("BENCH_METRICS", "BENCH_KNOBS")
    }
    metrics = {
        value.value
        for node in ast.walk(ast.parse(REF_BENCH.read_text())) if isinstance(node, ast.Dict)
        for key, value in zip(node.keys, node.values)
        if isinstance(key, ast.Constant) and key.value == "metric"
    }
    assert smoke["BENCH_METRICS"] == metrics - {"e2e_fetch_upload_MBps"}
    assert len(smoke["BENCH_METRICS"]) == 17
    assert set(smoke["BENCH_KNOBS"]) <= set(_env_knobs(PORT_BENCH))


_ZIPF = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import {module} as bench\n"
    "sizes = bench.zipf_object_sizes(12, 1.1, 65536, 509)\n"
    "picks = bench.zipf_sample(sizes, 509, 'w0', 20)\n"
    "print(json.dumps({{'sizes': sizes, 'picks': picks}}))\n"
)


def test_zipf_workload_replays_byte_for_byte_in_both():
    env = {**os.environ, "FAILPOINT_SEED": "509", "JAX_PLATFORMS": "cpu"}
    runs = [
        subprocess.run([sys.executable, "-c", _ZIPF.format(module=module), str(REPO)],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
        for module in ("bench", "bench_torch", "bench_torch")
    ]
    assert [run.returncode for run in runs] == [0, 0, 0], [run.stderr[-2000:] for run in runs]
    outputs = [run.stdout.splitlines()[-1] for run in runs]
    assert outputs[0] == outputs[1] == outputs[2]
    assert len(set(json.loads(outputs[0])["picks"])) > 1


# -- both main()s at tiny knobs -----------------------------------------------

_MAIN = """
import contextlib, io, json, sys
sys.path.insert(0, sys.argv[1])
import {module} as bench
out = io.StringIO()
with contextlib.redirect_stdout(out):
    bench.main()
print(json.dumps({{"lines": out.getvalue().splitlines(),
                  "modules": sorted({{name.split(".")[0] for name in sys.modules}})}}))
"""


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """Both packages' main() at ``TINY``, at once, each in a fresh
    interpreter with its own bench root: {"ref": run, "port": run}."""
    procs = {}
    for key, module in (("ref", "bench"), ("port", "bench_torch")):
        root = tmp_path_factory.mktemp(key)
        env = {**os.environ, **TINY, "BENCH_DIR": str(root), "JAX_PLATFORMS": "cpu"}
        procs[key] = subprocess.Popen(
            [sys.executable, "-c", _MAIN.format(module=module), str(REPO)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    runs = {}
    try:
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-4000:]
            runs[key] = json.loads(out.splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return runs


def _report(run: dict) -> dict:
    assert len(run["lines"]) == 1, run["lines"]  # one JSON line on stdout
    return json.loads(run["lines"][0])


def _arms(run: dict) -> dict:
    return {extra["metric"]: extra for extra in _report(run)["extra_metrics"]}


def test_main_reports_the_references_metrics_without_torch(mains):
    port, ref = _report(mains["port"]), _report(mains["ref"])
    assert set(port) == set(ref) == {"metric", "value", "unit", "vs_baseline", "extra_metrics"}
    assert [e["metric"] for e in port["extra_metrics"]] == [
        e["metric"] for e in ref["extra_metrics"]]
    assert len(port["extra_metrics"]) == 16 and port["value"] > 0
    modules = set(mains["port"]["modules"])
    assert {"downloader_tpu_torch", "hack"} <= modules
    assert not modules & {"torch", "jax", "triton", "downloader_tpu", "bench", "bench_digest"}


@pytest.mark.parametrize("metric", sorted(set(ARM_REPORTS) - {"digest_kernel"}))
def test_main_arm_has_the_references_keys(mains, metric):
    port, ref = _arms(mains["port"])[metric], _arms(mains["ref"])[metric]
    assert set(port) == set(ref)
    for key, value in ref.items():
        if isinstance(value, dict) and key not in ("by_role", "stage_cpu_pct", "stages_ms"):
            assert set(port[key]) == set(value), key


@pytest.mark.parametrize("metric", sorted(DETERMINISTIC))
def test_main_arm_outputs_agree(mains, metric):
    port, ref = _arms(mains["port"])[metric], _arms(mains["ref"])[metric]
    fields = DETERMINISTIC[metric]
    assert {k: port[k] for k in fields} == {k: ref[k] for k in fields}
    if metric == "flow_accounting":
        assert port["origin_amplification"] == port["workers"] == 2
    elif metric == "single_flight":
        assert (port["singleflight_amp"], port["singleflight_amp_off"]) == (1.0, 2.0)
        for arm in ("cache_on", "cache_off"):
            assert port[arm]["origin_gets"] == ref[arm]["origin_gets"], arm
            assert port[arm]["completed"] == ref[arm]["completed"], arm
        assert port["cache_on"]["origin_gets"] == port["objects"]
    else:
        assert port["completed"] == port["jobs"] == 4 and port["dangling_multiparts"] == 0


# -- the digest micro-benchmark and the graft entry points --------------------


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this case is about its absence")


def test_measure_runs_the_plain_version_on_the_host():
    metrics = bench_digest_torch.measure(piece_kb=1, batch=2, reps=1, device="cpu")
    assert {"piece_kb", "batch", "hashlib_GBps", "device", "transfer_MBps", "sync_ms",
            "offload_wins_streaming"} <= set(metrics)
    assert (metrics["piece_kb"], metrics["batch"], metrics["device"]) == (1, 2, "cpu")
    assert metrics["cuda_digest_mismatches"] == 0 and metrics["cuda_launches"] == 0
    # the host's run times no kernel
    assert not {"cuda_GBps", "cuda_call_ms", "cuda_sustained_GBps"} & set(metrics)


def test_measure_and_main_refuse_a_missing_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_digest_torch.measure(piece_kb=1, batch=2, reps=1)
    done = subprocess.run([sys.executable, "bench_digest_torch.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and "no CUDA device" in done.stderr
    assert '"digest_kernel"' not in done.stdout


def test_bench_digest_arm_fails_without_a_card():
    _no_card()
    import bench_torch

    with pytest.raises(RuntimeError, match="digest arm failed"):
        bench_torch.run_digest_arm(piece_kb=1, batch=2)


def test_entry_digests_are_hashlibs():
    fn, (blocks, nblocks) = graft.entry(device="cpu")
    assert tuple(blocks.shape[1:]) == (16, 8) and nblocks.tolist() == [17] * 8
    got = digests_to_bytes(fn(blocks, nblocks).numpy(), 8)
    assert got == [hashlib.sha1(bytes([i]) * (1024 + i)).digest() for i in range(8)]


def test_dryrun_multichip_counts_one_mismatch(capsys):
    graft.dryrun_multichip(8, device="cpu")
    assert "16 pieces over 8 cpu devices, summed mismatch count = 1" in capsys.readouterr().out


def test_dryrun_multichip_refuses_too_few_cards():
    _no_card()
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 0"):
        graft.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="need 1 CUDA devices"):
        graft.entry()


@pytest.mark.cuda
def test_twins_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU cases cover the plain version")
    graft.dryrun_multichip(1)
    assert "over 1 cuda devices, summed mismatch count = 1" in capsys.readouterr().out
    metrics = bench_digest_torch.measure(16, 8)
    assert metrics["device"].startswith("cuda:0 ")
    assert metrics["cuda_digest_mismatches"] == 0 and metrics["cuda_launches"] > 0
    assert metrics["cuda_GBps"] > 0 and metrics["cuda_call_ms"] > 0
