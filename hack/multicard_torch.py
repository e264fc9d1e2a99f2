#!/usr/bin/env python3
"""Piece verification of the PyTorch/CUDA port across several cards:
the split verify step, the digest engine and a torrent job.

Run from the root of a checkout, on a host with N NVIDIA H100s:

    python3 hack/multicard_torch.py [--cards N] [--seed S]

``--cards`` defaults to every visible card. With fewer than N visible
CUDA devices the tool raises ("need N CUDA devices"); there is no CPU
stand-in. It prints the cards' name and power limit, then one JSON line
per phase:

- ``split``: ``__graft_entry_torch__.dryrun_multichip(N)``, then a grid
  of batches made from ``--seed`` (ragged sizes at P in {1, N-1, N+1,
  30, 32, 1031}, the live flush of 32 x 256 KiB and a resume batch of
  64 x 1 MiB) through ``chip_smoke.split_check`` over ``cuda:0..N-1``:
  ``mesh.digest_split`` equal to one unsplit ``sha1_states`` on
  ``cuda:0`` and to hashlib byte for byte, ``mesh.verify_split``
  counting one planted mismatch a non-empty shard, and one launch a
  non-empty shard, each on its own card.
- ``engine``: ``DigestEngine(backend="cuda")`` with no device must take
  the N cards; four threads each make 16 ``verify_pieces`` calls of 32 x
  256 KiB at once (the daemon's concurrent flushes), every verdict equal
  to hashlib's and 4 * 16 * N launches, 4 * 16 on each card. The same
  load then runs on a one-card engine and on ``backend="auto"``, whose
  split between the cards and hashlib is printed.
- ``job``: the port's ``Seeder`` serves a 256 MiB payload made from the
  seed in 256 KiB pieces; ``python3 -m downloader_tpu_torch
  download-once`` of its magnet runs in a child process
  (``chip_smoke.py --counted-job``) with half of the file already on
  disk, so the resume and the live flushes both run, once with the N
  cards visible and once with one. Both stored objects must have the
  payload's SHA-256; each run's wall, launches by step and by card and
  the profiler's copy and kernel times are printed.

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": N}}``. Any failed check raises and the tool exits
non-zero. Every card's first launch, which loads the kernel's module
into that card's context, is made before the phases.

``--device cpu --shards N`` runs the same phases over N CPU shards with
the plain PyTorch SHA-1 at small sizes, for the tests only.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import __graft_entry_torch__ as graft  # noqa: E402
import chip_smoke  # noqa: E402
from downloader_tpu_torch.parallel import engine as engine_module  # noqa: E402
from downloader_tpu_torch.parallel import sha1_cuda  # noqa: E402
from downloader_tpu_torch.parallel.engine import DigestEngine  # noqa: E402
from downloader_tpu_torch.store import Credentials  # noqa: E402
from downloader_tpu_torch.store.stub import S3Stub  # noqa: E402

KIB, MIB = 1024, 1024 * 1024
# the sizes each device type runs at: the card at the main path's, the
# host's plain version (~8 ms a block step) at small ones
SIZES = {
    "cuda": {
        "ragged_max": 16 * KIB + 100,
        "live": (32, 256 * KIB),  # a _PieceBatch flush at 256 KiB pieces
        "resume": (64, MIB),  # a resume_existing batch at 1 MiB pieces
        "engine_piece": 256 * KIB,
        "engine_calls": 16,  # a thread's verify_pieces calls
        "job_payload": 256 * MIB,
        "job_piece": 256 * KIB,
        # each comparison of N cards with one runs N, 1, 1, N: both arms
        # see the same warm and cold states
        "turns": 2,
    },
    "cpu": {
        "ragged_max": 700,
        "live": (32, KIB),
        "resume": (64, 2 * KIB),
        "engine_piece": 100,
        "engine_calls": 2,
        "job_payload": 128 * KIB,
        "job_piece": 4 * KIB,
        "turns": 1,
    },
}
RAGGED_COUNTS = (1, "N-1", "N+1", 30, 32, 1031)
THREADS = 4
FLUSH_PIECES = 32
JOB_NAME = chip_smoke.JOB_NAME
emit = chip_smoke.emit


def resolve(device: str, cards: int | None, shards: int) -> list[torch.device]:
    """The devices the phases run on: ``shards`` CPU shards, or the
    first ``cards`` CUDA cards (every visible card when None); raises
    with fewer cards than asked for."""
    if device == "cpu":
        return graft._devices(shards, "cpu")
    if cards is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return graft._devices(max(cards, 1))


def warm(devices: list[torch.device]) -> dict:
    """One small launch on each device, read back: the kernel's module
    is loaded into every card's context before anything is timed.
    Returns each device's first-launch seconds."""
    seconds = {}
    for device in dict.fromkeys(devices):
        blocks = torch.zeros((1, 16, 4), dtype=torch.int32, device=device)
        nblocks = torch.ones(4, dtype=torch.int32, device=device)
        start = time.perf_counter()
        sha1_cuda.sha1_states(blocks, nblocks).cpu()
        seconds[str(device)] = time.perf_counter() - start
    return seconds


def phase_split(devices: list[torch.device], sizes: dict, rng: np.random.Generator) -> dict:
    count = len(devices)
    graft.dryrun_multichip(count, None if devices[0].type == "cuda" else "cpu")
    batches = {}
    for wanted in RAGGED_COUNTS:
        lanes = {"N-1": count - 1, "N+1": count + 1}.get(wanted, wanted)
        if lanes > 0 and f"ragged P={lanes}" not in batches:
            lengths = rng.integers(0, sizes["ragged_max"] + 1, lanes)
            batches[f"ragged P={lanes}"] = [rng.bytes(int(n)) for n in lengths]
    for name in ("live", "resume"):
        lanes, length = sizes[name]
        batches[f"{name} {lanes}x{length}"] = [rng.bytes(length) for _ in range(lanes)]
    checks = {}
    for name, pieces in batches.items():
        start = time.perf_counter()
        checks[name] = chip_smoke.split_check(pieces, devices, rng)
        checks[name]["seconds"] = time.perf_counter() - start
    by_device: Counter = Counter()
    for check in checks.values():
        by_device.update(check["launches_by_device"])
    fields = dict(
        devices=[str(device) for device in devices],
        dryrun_multichip="OK",
        batches=checks,
        launches=sum(by_device.values()),
        launches_by_device=dict(sorted(by_device.items())),
    )
    emit("split", **fields)
    return fields


def in_turns(arms: tuple, turns: int) -> list:
    """``arms`` (a pair) in the order a, b, b, a, ... for ``turns`` pairs."""
    order = []
    for turn in range(turns):
        order += list(arms if turn % 2 == 0 else arms[::-1])
    return order


def _workload(piece_length: int, calls: int, rng: np.random.Generator) -> list:
    """Per thread: its flush of ``FLUSH_PIECES`` pieces and, for each of
    its ``calls`` calls, the expected digests with one lane made wrong."""
    work = []
    for thread in range(THREADS):
        pieces = [rng.bytes(piece_length) for _ in range(FLUSH_PIECES)]
        digests = [hashlib.sha1(piece).digest() for piece in pieces]
        planted = []
        for call in range(calls):
            wrong = (thread + call) % FLUSH_PIECES
            expected = list(digests)
            expected[wrong] = hashlib.sha1(pieces[wrong][1:]).digest()
            planted.append((expected, [lane != wrong for lane in range(FLUSH_PIECES)]))
        work.append((pieces, planted))
    return work


def concurrent_verify(engine: DigestEngine, work: list) -> dict:
    """``THREADS`` threads at once, each making its calls of
    ``engine.verify_pieces``; every verdict must be hashlib's. Returns
    the wall seconds and the launches by device."""
    together = threading.Barrier(THREADS)
    failures: list = []

    def run(index: int) -> None:
        pieces, calls = work[index]
        together.wait(timeout=60)
        for expected, truth in calls:
            got = engine.verify_pieces(pieces, expected)
            if got != truth:
                failures.append((index, got, truth))

    threads = [threading.Thread(target=run, args=(i,), name=f"verify-{i}") for i in range(THREADS)]
    with chip_smoke.recorded_launches() as seen:
        start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
        wall = time.perf_counter() - start
    assert not any(thread.is_alive() for thread in threads), "a verify thread did not finish"
    assert failures == [], failures[:2]
    for device, out, _ in seen:
        assert device == out, (device, out)
    by_device = Counter(device for device, _, _ in seen)
    calls = sum(len(planted) for _, planted in work)
    return {
        "wall_s": wall,
        "calls": calls,
        "ms_per_call": wall * 1e3 / calls,
        "launches": len(seen),
        "launches_by_device": dict(sorted(by_device.items())),
    }


def phase_engine(devices: list[torch.device], sizes: dict, rng: np.random.Generator) -> dict:
    cpu = devices[0].type == "cpu"
    calls = THREADS * sizes["engine_calls"]
    work = _workload(sizes["engine_piece"], sizes["engine_calls"], rng)
    engine = DigestEngine(backend="cuda", device=devices if cpu else None)
    assert engine.devices == devices, (engine.devices, devices)
    spread = Counter()
    for device in devices:
        spread[str(device)] += calls
    arms = {
        "split": (engine, dict(sorted(spread.items()))),
        "one_card": (DigestEngine(backend="cuda", device=devices[:1]), {str(devices[0]): calls}),
    }
    results: dict = {name: [] for name in arms}
    for name in in_turns(tuple(arms), sizes["turns"]):
        target, wanted = arms[name]
        result = concurrent_verify(target, work)
        assert result["launches_by_device"] == wanted, (name, result)
        results[name].append(result)
    auto_engine = DigestEngine(backend="auto", device=devices if cpu else None)
    start = time.perf_counter()
    calibration = auto_engine._calibrate()
    calibrate_s = time.perf_counter() - start
    auto = concurrent_verify(auto_engine, work)
    assert auto["launches"] == auto_engine.device_batches * len(devices), auto
    assert auto_engine.device_batches + auto_engine.host_batches == calls
    auto.update(
        backend_name=auto_engine.backend_name,
        device_batches=auto_engine.device_batches,
        host_batches=auto_engine.host_batches,
        calibration=dict(zip(("hashlib_Bps", "transfer_Bps", "sync_s", "block_s"), calibration)),
        calibrate_s=calibrate_s,
    )
    fields = dict(
        backend_name=engine.backend_name,
        threads=THREADS,
        calls_per_thread=sizes["engine_calls"],
        pieces_per_call=FLUSH_PIECES,
        piece_length=sizes["engine_piece"],
        split=results["split"],
        one_card=results["one_card"],
        auto=auto,
        verdicts_equal_hashlib=True,
    )
    emit("engine", **fields)
    return fields


def _copy_and_kernel_ms(device_by_name: dict) -> dict:
    """The profiler's device time split into host-to-device copies,
    read-backs, the SHA-1 kernel and the rest (layout, compare)."""
    split = {"h2d_ms": 0.0, "d2h_ms": 0.0, "sha1_ms": 0.0, "other_ms": 0.0}
    for name, row in device_by_name.items():
        if name.startswith("Memcpy HtoD"):
            key = "h2d_ms"
        elif name.startswith("Memcpy DtoH"):
            key = "d2h_ms"
        elif "sha1" in name:
            key = "sha1_ms"
        else:
            key = "other_ms"
        split[key] += row["ms"]
    return split


def _visible(count: int) -> str:
    """``CUDA_VISIBLE_DEVICES`` naming the first ``count`` cards this
    process sees."""
    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = listed.split(",") if listed else [str(i) for i in range(torch.cuda.device_count())]
    return ",".join(cards[:count])


def phase_job(devices: list[torch.device], sizes: dict, rng: np.random.Generator,
              workdir: str) -> dict:
    from downloader_tpu_torch.fetch.seeder import Seeder

    cpu = devices[0].type == "cpu"
    payload = rng.bytes(sizes["job_payload"])
    piece = sizes["job_piece"]
    half = len(payload) // piece // 2
    want_sha256 = hashlib.sha256(payload).hexdigest()
    key = f"episode-1/original/{base64.b64encode(JOB_NAME.encode()).decode()}"
    credentials = Credentials(access_key="multicard-ak", secret_key="multicard-sk")
    before = engine_module._default
    # the seeder hashes its pieces with the default engine: every card
    engine_module._default = seeding = DigestEngine(device=devices if cpu else None)
    seeding._calibrate()  # its launches stay out of the seeder's count
    try:
        with chip_smoke.recorded_launches() as seed_launches:
            seeder = Seeder(JOB_NAME, payload, piece_length=piece)
    finally:
        engine_module._default = before
    runs = []
    try:
        seeder.start()
        for cards in in_turns((len(devices), 1), sizes["turns"]):
            label = f"{cards} card{'s' if cards > 1 else ''}"
            knobs = dict(S3_ACCESS_KEY="multicard-ak", S3_SECRET_KEY="multicard-sk",
                         DHT_BOOTSTRAP="off", LSD="off")
            if not cpu:
                knobs["CUDA_VISIBLE_DEVICES"] = _visible(cards)
            base_dir = os.path.join(workdir, f"job-{len(runs)}")
            os.makedirs(os.path.join(base_dir, "episode-1"))
            with open(os.path.join(base_dir, "episode-1", JOB_NAME), "wb") as sink:
                sink.write(payload[: half * piece])
            with S3Stub(credentials=credentials) as stub:
                job = chip_smoke._torrent_job(
                    seeder.magnet_uri, base_dir,
                    chip_smoke.child_env(S3_ENDPOINT=f"http://{stub.endpoint}", **knobs),
                    rehearse=False, cpu_shards=cards if cpu else 0,
                )
                stored = stub.buckets["triton-staging"][key]
                assert stub.list_multipart_uploads() == []
            assert hashlib.sha256(stored).hexdigest() == want_sha256, f"{label}: object != payload"
            del stored
            report = job["report"]
            assert report["resumed"] == [half], report["resumed"]
            by_card = report["launches_by_card"]
            named = ["cpu"] if cpu else [f"cuda:{index}" for index in range(cards)]
            assert sorted(by_card) == named, (label, by_card)
            if not cpu:
                # every device batch holds at least auto's minimum of 8
                # pieces: one launch on each card
                batches = report["launches_live"] + report["launches_resume"]
                assert batches == report["device_batches"] * cards, report
                assert report["launches_live"] > 0 and report["launches_resume"] > 0, report
            runs.append({
                "cards": cards,
                "wall_s": job["wall_s"],
                "job_wall_s": report["wall_s"],
                "process_s": report["process_s"],
                "MBps": len(payload) / job["wall_s"] / 1e6,
                "launches": report["launches"],
                "launches_by_step": {
                    step: report[f"launches_{step}"] for step in ("resume", "live", "calibration")
                },
                "launches_by_card": by_card,
                "device_batches": report["device_batches"],
                "resume_device_batches": report["resume_device_batches"],
                "host_batches": report["host_batches"],
                "backend_name": report["backend_name"],
                "layers_s": report["layers_s"],
                "device_busy_ms": report["device_busy_ms"],
                "device_ms": _copy_and_kernel_ms(report["device_by_name"]),
                "object_sha256_equal_payload": True,
            })
            shutil.rmtree(base_dir)
    finally:
        seeder.stop()
    fields = dict(
        payload_bytes=len(payload),
        piece_length=piece,
        pieces=len(payload) // piece,
        resumed_pieces=half,
        seeder_backend=seeding.backend_name,
        seeder_launches=len(seed_launches),
        seeder_launches_by_device=dict(sorted(Counter(d for d, _, _ in seed_launches).items())),
        runs=runs,
    )
    emit("job", **fields)
    return fields


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, help="CUDA cards to use (default: every visible one)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu: the plain version over --shards CPU shards (tests only)")
    parser.add_argument("--shards", type=int, default=4)
    args = parser.parse_args(argv)
    devices = resolve(args.device, args.cards, args.shards)
    kind = devices[0].type
    if kind == "cuda":
        print(chip_smoke.nvidia_smi(), flush=True)
    sizes = SIZES[kind]
    rng = np.random.default_rng(args.seed)
    emit("warm", first_launch_s=warm(devices))
    phase_split(devices, sizes, rng)
    phase_engine(devices, sizes, rng)
    with tempfile.TemporaryDirectory(prefix="multicard-") as workdir:
        phase_job(devices, sizes, rng, workdir)
    device = {
        "platform": "gpu" if kind == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if kind == "cuda" else "cpu",
        "count": len(devices),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
