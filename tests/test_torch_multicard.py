"""The port's split verify step across several devices, and its
multi-card tool (``hack/multicard_torch.py``).

- The tool's ``--device cpu --shards 4`` mode runs every phase (split,
  engine, job) over four CPU shards, and the launches it reports are
  the plain path's calls, counted here by wrapping the
  ``sha1_cuda.sha1_states`` that ``mesh`` calls.
- ``mesh.verify_split`` over 8 CPU shards against the JAX package's
  ``sharded_verify_fn(default_mesh())`` over its 8 CPU devices, on the
  same seeded pieces and planted mismatches (the JAX side padded to a
  multiple of its devices): the real lanes' ``ok`` masks and the counts
  equal, exactly. JAX is imported inside that test, so the file also
  runs on the card's machine, which has none.
- ``DigestEngine`` over four CPU shards, called from four threads at
  once, gives hashlib's verdicts.
- Without CUDA the tool, asked for cards, exits non-zero with its "need
  N CUDA devices" error and never falls back.
- On the card (marker ``cuda``): four shards on one card, and, with two
  cards or more, each shard's launch on its own card.
"""

import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
from collections import Counter
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from downloader_tpu_torch.parallel import mesh, pack
from downloader_tpu_torch.parallel.engine import DigestEngine

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "hack" / "multicard_torch.py"


def _tool():
    spec = importlib.util.spec_from_file_location("multicard_torch", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pieces(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in sizes]


def test_cpu_mode_runs_every_phase_with_per_shard_launches(monkeypatch, tmp_path):
    tool = _tool()
    calls = []
    counted = mesh.sha1_states

    def counting(blocks, nblocks):
        calls.append(str(blocks.device))
        return counted(blocks, nblocks)

    # mesh looks sha1_cuda.sha1_states up under its own name
    monkeypatch.setattr(mesh, "sha1_states", counting)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = io.StringIO()
    with redirect_stdout(out):
        assert tool.main(["--device", "cpu", "--shards", "4", "--seed", "3"]) == 0
    lines = out.getvalue().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 4}}
    assert "dryrun_multichip OK: 8 pieces over 4 cpu devices" in out.getvalue()
    phases = {}
    for line in lines[:-1]:
        if line.startswith("{"):
            row = json.loads(line)
            phases[row["phase"]] = row
    assert list(phases) == ["warm", "split", "engine", "job"]

    split, engine, job = phases["split"], phases["engine"], phases["job"]
    assert list(split["batches"]) == [
        "ragged P=1", "ragged P=3", "ragged P=5", "ragged P=30", "ragged P=32",
        "ragged P=1031", "live 32x1024", "resume 64x2048"]
    for check in split["batches"].values():
        shards = check["shards"]
        assert sum(shards) == check["P"] and len(shards) == min(4, check["P"])
        assert check["mismatches"] == len(shards)
        assert check["launches"] == 2 * len(shards)
    (split_run,), (one_run,) = engine["split"], engine["one_card"]
    assert split_run["launches_by_device"] == {"cpu": 4 * 2 * 4}
    assert one_run["launches_by_device"] == {"cpu": 4 * 2}
    auto = engine["auto"]
    assert auto["device_batches"] + auto["host_batches"] == 8
    assert auto["launches"] == 4 * auto["device_batches"]
    # the dry run's 8 pieces are 4 shards; the tool's count of each
    # phase is the plain path's calls through mesh, one by one
    launched = (4 + split["launches"] + split_run["launches"]
                + one_run["launches"] + auto["launches"]
                + job["seeder_launches"])
    assert len(calls) == launched
    assert set(calls) == {"cpu"}

    runs = job["runs"]
    assert [run["cards"] for run in runs] == [4, 1]
    for run in runs:
        assert run["object_sha256_equal_payload"]
        assert run["host_batches"] == 0
        assert run["launches_by_card"] == {"cpu": {
            step: count for step, count in run["launches_by_step"].items() if count}}
        assert run["launches_by_step"]["resume"] == run["cards"]
    assert job["resumed_pieces"] == 16


@pytest.mark.parametrize("count, planted", [
    (1, [0]), (7, [0, 3, 6]), (9, [1, 4, 8]), (30, [0, 11, 22, 29]),
])
def test_verify_split_matches_the_references_sharded_verify(count, planted):
    # imported here: the card's machine has no JAX, and this file's card
    # tests run there
    jax = pytest.importorskip("jax")
    from downloader_tpu.parallel.mesh import default_mesh, sharded_verify_fn
    from downloader_tpu.parallel.pack import pack_pieces as ref_pack_pieces

    devices = jax.devices()
    assert len(devices) == 8
    pieces = _pieces(np.random.default_rng(count).integers(0, 400, count), seed=count + 1)
    digests = [hashlib.sha1(piece).digest() for piece in pieces]
    expected = pack.expected_words(digests)
    for lane in planted:
        expected[lane] ^= 1

    raw, nblocks = pack.pack_bytes(pieces)
    ok, mismatches = mesh.verify_split(
        torch.from_numpy(raw), torch.from_numpy(nblocks),
        torch.from_numpy(expected.view(np.int32)), [torch.device("cpu")] * 8)

    padded = -(-count // len(devices)) * len(devices)
    blocks, ref_nblocks = ref_pack_pieces(pieces, pad_to=padded)
    want = np.zeros((padded, 5), dtype=np.uint32)
    want[:count] = expected
    ref_ok, ref_mismatches = sharded_verify_fn(default_mesh())(blocks, ref_nblocks, want)

    assert ok.tolist() == np.asarray(ref_ok)[:count].tolist()
    assert mismatches == int(ref_mismatches) == len(planted)
    assert ok.tolist() == [lane not in planted for lane in range(count)]


def test_engine_over_four_cpu_shards_from_four_threads():
    engine = DigestEngine(backend="cuda", device=["cpu"] * 4)
    rng = np.random.default_rng(11)
    batches = []
    for index in range(4):
        pieces = [rng.bytes(int(n)) for n in rng.integers(1, 300, 9 + index)]
        expected = [hashlib.sha1(piece).digest() for piece in pieces]
        expected[index] = hashlib.sha1(pieces[index] + b"x").digest()
        batches.append((pieces, expected))
    together = threading.Barrier(4)
    results = [None] * 4

    def verify(index):
        pieces, expected = batches[index]
        together.wait(timeout=30)
        results[index] = [engine.verify_pieces(pieces, expected) for _ in range(3)]

    threads = [threading.Thread(target=verify, args=(i,)) for i in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
        assert not thread.is_alive()
    for index, (pieces, expected) in enumerate(batches):
        truth = [hashlib.sha1(p).digest() == d for p, d in zip(pieces, expected)]
        assert truth.count(False) == 1
        assert results[index] == [truth] * 3
    assert engine.device_batches == 12 and engine.host_batches == 0


@pytest.mark.parametrize("arguments, wanted", [
    ([], "need 1 CUDA devices, have 0"),
    (["--cards", "4"], "need 4 CUDA devices, have 0"),
], ids=["every_visible_card", "four_cards"])
def test_tool_refuses_without_cards(arguments, wanted):
    # with a card present, hide it: the tool must see none
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, str(TOOL), *arguments], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert wanted in done.stderr
    assert '"ok": true' not in done.stdout
    assert '"phase"' not in done.stdout


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests cover the split")
    return torch.device("cuda", 0)


@pytest.fixture
def cards():
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        pytest.skip(f"needs at least two CUDA devices, has {count}")
    return [torch.device("cuda", index) for index in range(count)]


@pytest.mark.cuda
def test_four_shards_on_one_card(card):
    tool = _tool()
    rng = np.random.default_rng(5)
    pieces = _pieces([300] * 30, seed=6)
    check = tool.chip_smoke.split_check(pieces, [card] * 4, rng)
    assert check["launches_by_device"] == {"cuda:0": 8}


@pytest.mark.cuda
def test_each_shard_launches_on_its_own_card(cards):
    tool = _tool()
    rng = np.random.default_rng(7)
    pieces = _pieces(rng.integers(0, 5000, 4 * len(cards) + 1), seed=8)
    check = tool.chip_smoke.split_check(pieces, cards, rng)
    assert check["launches_by_device"] == Counter({str(card): 2 for card in cards})
