"""The port's chaos and profiling tooling and its CI steps.

``hack/failpoint_matrix_torch.py`` and ``hack/profile_artifacts_torch.py``
are twins of the JAX package's ``hack/failpoint_matrix.py`` and
``hack/profile_artifacts.py`` over the port's hermetic pipeline
(``hack/pipeline_torch.py``). Here: the failpoint schedules of both
packages' registries agree seed for seed; one matrix seed, one small
profiled wave of the port and the matrix's SIGKILL-mid-coalesce cell
run in fresh interpreters that never import torch, jax or the JAX
package, and report what the reference's tools report, key for key; and ``.circleci/config.yml`` gives every smoke
step of the JAX package a port step that runs its twin.
"""

import ast
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from downloader_tpu.utils.failpoints import FailpointRegistry as RefRegistry
from downloader_tpu_torch.utils.failpoints import FailpointRegistry as PortRegistry

REPO = Path(__file__).resolve().parents[1]
HACK = REPO / "hack"
CONFIG = REPO / ".circleci" / "config.yml"
# schedule_fingerprint of the default spec in the JAX package's matrix
FINGERPRINTS = {509: "8c90e617660b966e", 1307: "2a2a3d381bf2bc21", 9001: "727a423415f816c3"}
# the JAX package's CI file and tool, each with the port's twin
TWIN_FILES = {"test_fleet": "test_torch_fleet", "test_fleetplane": "test_torch_fleetplane",
              "test_singleflight": "test_torch_singleflight", "test_federate": "test_torch_federate"}
TWIN_TOOLS = {"hack/failpoint_matrix.py": "hack/failpoint_matrix_torch.py",
              "hack/profile_artifacts.py": "hack/profile_artifacts_torch.py",
              "-m downloader_tpu.analysis": "-m downloader_tpu_torch.analysis"}


def _load(path: Path):
    """A hack script as a module (neither tool imports a package at
    module level)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PORT_MATRIX = _load(HACK / "failpoint_matrix_torch.py")
REF_MATRIX = _load(HACK / "failpoint_matrix.py")


def _returned_keys(path: Path, function: str) -> set:
    """The keys of the dict literal ``function`` in ``path`` returns."""
    tree = ast.parse(path.read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    returns = [n.value for n in ast.walk(node) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(returns) == 1, (path, function)
    return {key.value for key in returns[0].keys}


def test_matrix_defaults_are_the_references():
    assert PORT_MATRIX.DEFAULT_SEEDS == REF_MATRIX.DEFAULT_SEEDS
    assert PORT_MATRIX.DEFAULT_SPEC == REF_MATRIX.DEFAULT_SPEC
    assert PORT_MATRIX.SITES == REF_MATRIX.SITES
    assert PORT_MATRIX.COALESCE_KILL_SPEC == REF_MATRIX.COALESCE_KILL_SPEC
    # the cell's walk arms the same kill the reference's test arms
    cell = (REPO / PORT_MATRIX.COALESCE_KILL_CELL).read_text()
    assert re.search(rf'^LEADER_KILL_SPEC = "{re.escape(PORT_MATRIX.COALESCE_KILL_SPEC)}"$',
                     cell, re.M)
    assert f'"{REF_MATRIX.COALESCE_KILL_SPEC}"' in (REPO / "tests" / "test_singleflight.py").read_text()


@pytest.mark.parametrize("seed", sorted(FINGERPRINTS))
def test_schedule_fingerprints_agree_across_packages(seed):
    prints = []
    for registry_class in (PortRegistry, RefRegistry):
        registry = registry_class()
        registry.configure(PORT_MATRIX.DEFAULT_SPEC, seed=seed)
        prints.append(PORT_MATRIX.schedule_fingerprint(registry, PORT_MATRIX.SITES))
    assert prints == [FINGERPRINTS[seed]] * 2


# one matrix seed and one small profiled wave of the port, run as the
# tools run them in a fresh interpreter (quiet_logging sets LOG_LEVEL,
# which must not leak into this process); it reports its results and
# which packages it imported
_TOOL_RUN = """
import json, os, sys, tempfile
sys.path.insert(0, sys.argv[1])
from hack import failpoint_matrix_torch as matrix
from hack.pipeline_torch import quiet_logging, run_profile_arm
quiet_logging()
out = {}
with tempfile.TemporaryDirectory() as site:
    with open(os.path.join(site, matrix.PAYLOAD_NAME), "wb") as sink:
        sink.write(os.urandom(matrix.PAYLOAD_BYTES))
    out["row"] = matrix.run_seed(509, matrix.DEFAULT_SPEC, 4, site)
with tempfile.TemporaryDirectory() as site:
    with open(os.path.join(site, "tiny.bin"), "wb") as sink:
        sink.write(os.urandom(64 * 1024))
    out["profile"] = run_profile_arm(site, 40, concurrency=2, artifact_dir=sys.argv[2])
out["modules"] = sorted({name.split(".")[0] for name in sys.modules})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    artifacts = tmp_path_factory.mktemp("profile")
    done = subprocess.run(
        [sys.executable, "-c", _TOOL_RUN, str(REPO), str(artifacts)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.splitlines()[-1]), artifacts


def test_matrix_seed_holds_at_least_once(tool_run):
    row = tool_run[0]["row"]
    assert row["ok"], row
    assert (row["jobs"], row["completed"]) == (4, 4)
    assert row["dangling_multiparts"] == 0 and row["ledger_outstanding"] == []
    assert row["schedule_fingerprint"] == FINGERPRINTS[509]
    assert set(row["injections"]) == set(PORT_MATRIX.SITES)
    assert set(row) == _returned_keys(HACK / "failpoint_matrix.py", "run_seed")


def test_profile_arm_samples_and_reports_the_references_keys(tool_run):
    report, artifacts = tool_run[0]["profile"], tool_run[1]
    assert report["samples"] > 0 and report["jobs"] == 40
    assert set(report) == _returned_keys(REPO / "bench.py", "run_profile_arm")
    svg = (artifacts / "bench.svg").read_text()
    assert svg.startswith("<svg") and len(svg) == report["flamegraph_bytes"]
    assert (artifacts / "bench.collapsed").read_text().strip()


FORBIDDEN = {"torch", "jax", "jaxlib", "triton", "downloader_tpu", "bench"}


def test_tools_import_no_torch_jax_or_reference(tool_run):
    modules = set(tool_run[0]["modules"])
    assert "downloader_tpu_torch" in modules
    assert not modules & FORBIDDEN


def test_coalesce_cell_runs_the_ports_fleet_alone(tmp_path):
    """The matrix's SIGKILL-mid-coalesce cell passes, with the reference's
    row keys, and its process imports the port alone."""
    cell = PORT_MATRIX.run_coalesce_kill_cell(str(tmp_path))
    assert cell["ok"], cell["tail"]
    reference = _returned_keys(HACK / "failpoint_matrix.py", "run_coalesce_kill_cell")
    assert set(cell) == reference
    verdict = json.loads(cell["tail"].splitlines()[-1])
    assert verdict["failures"] == []
    modules = set(verdict["modules"])
    assert "downloader_tpu_torch" in modules
    assert not modules & FORBIDDEN


@pytest.fixture(scope="module")
def steps():
    yaml = pytest.importorskip("yaml")
    ci = yaml.safe_load(CONFIG.read_text())
    return [step["run"] for step in ci["jobs"]["tests"]["steps"]
            if isinstance(step, dict) and "run" in step]


def _nodes(command: str) -> list:
    """The pytest nodes (``tests/x.py`` or ``tests/x.py::name[::name]``)
    a command names."""
    return re.findall(r"tests/test_\w+\.py(?:::\w+)*", command)


def _defines(path: Path, names: list) -> bool:
    """Whether ``path`` defines the test (or class and method) ``names``."""
    scope = ast.parse(path.read_text()).body
    for name in names:
        found = [node for node in scope
                 if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name]
        if not found:
            return False
        scope = found[0].body
    return True


def test_port_steps_follow_the_references(steps):
    names = [step["name"] for step in steps]
    first_port = next(index for index, name in enumerate(names) if name.startswith("port "))
    assert all(name.startswith("port ") for name in names[first_port:]), names
    assert not any(name.startswith("port ") for name in names[:first_port])


def test_port_steps_name_tools_and_tests_that_exist(steps):
    port = [step["command"] for step in steps if step["name"].startswith("port ")]
    makefile = (REPO / "Makefile").read_text()
    nodes = [node for command in port for node in _nodes(command)]
    assert nodes
    for node in nodes:
        path, *names = node.split("::")
        assert Path(path).name.startswith("test_torch_"), node
        assert (REPO / path).is_file(), node
        assert _defines(REPO / path, names), node
    for tool in re.findall(r"hack/\w+\.py", " ".join(port)):
        assert (REPO / tool).is_file(), tool
        assert tool.endswith("_torch.py"), tool
    for target in re.findall(r"\bmake ([\w-]+)", " ".join(port)):
        assert re.search(rf"^{re.escape(target)}:", makefile, re.M), target
    assert "make build-torch" in " ".join(port)


def test_every_reference_smoke_has_its_twin_in_a_port_step(steps):
    reference = " ".join(step["command"] for step in steps if not step["name"].startswith("port "))
    port = " ".join(step["command"] for step in steps if step["name"].startswith("port "))
    smokes = [node for node in _nodes(reference) if not node.startswith("tests/test_torch_")]
    # the 21 named smokes and test_federate.py, run after `make test`
    assert len(smokes) == 22, smokes
    for node in smokes:
        path, *names = node.split("::")
        stem = Path(path).stem
        twins = [f"tests/{TWIN_FILES[stem]}.py" if stem in TWIN_FILES else None,
                 "tests/test_torch_smokes.py"]
        wanted = ["::".join([twin, *names]) for twin in twins if twin]
        assert any(re.search(re.escape(want) + r"(?![\w:])", port) for want in wanted), node
    for reference_tool, twin in TWIN_TOOLS.items():
        assert reference_tool in reference and twin in port, twin


def test_makefile_runs_the_tools_and_formats_them():
    makefile = (REPO / "Makefile").read_text()
    for target, tool in (("failpoints-torch", "hack/failpoint_matrix_torch.py"),
                         ("profile-torch", "hack/profile_artifacts_torch.py")):
        rule = re.search(rf"^{target}:\n\t(.*)$", makefile, re.M)
        assert rule and tool in rule.group(1), target
    fmt_paths = re.search(r"^FMT_PATHS := (.*)$", makefile, re.M).group(1).split()
    for name in ("pipeline_torch.py", "fleet_torch.py", "failpoint_matrix_torch.py",
                 "profile_artifacts_torch.py"):
        assert f"hack/{name}" in fmt_paths, name
