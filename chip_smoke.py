#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's piece-verification path on one card.

Run from the root of a checkout, on a host with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the CUDA SHA-1 kernel from the checkout's sources, holds it
against its plain PyTorch version and hashlib, drives the main path at
full size through the entry points a user calls (``make_torrent``,
``PieceStore.resume_existing``, ``_PieceBatch``) on a 1 GiB payload made
from the seed, checks every answer, times the kernel and the path around
it, and prints one JSON line per phase. The last line is
``{"ok": true, "device": {...}}``; any failed check raises and the
script exits non-zero without it. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from downloader_tpu_torch.fetch.peerwire import PeerProtocolError
from downloader_tpu_torch.fetch.pieces import PieceStore
from downloader_tpu_torch.fetch.seeder import make_torrent
from downloader_tpu_torch.fetch.swarmstate import _PieceBatch
from downloader_tpu_torch.parallel import sha1, sha1_cuda
from downloader_tpu_torch.parallel.engine import DigestEngine
from downloader_tpu_torch.parallel.pack import (
    H0,
    digests_to_bytes,
    max_blocks,
    pack_bytes,
    pack_pieces,
    to_gpu_layout,
)

# the JAX package's test set of padding edge cases (tests/test_parallel.py)
EDGE_SIZES = (0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 16384)
PAYLOAD_BYTES = 1 << 30  # one TV-episode-sized media file
PIECE_LENGTH = 1 << 20
RESUME_BATCH_BYTES = 64 * 1024 * 1024  # PieceStore.resume_existing's default
LIVE_BATCH_PIECES = 8  # _PieceBatch's default 8 MiB flush at 1 MiB pieces
REPS = 5

# H100 SXM peaks: HBM 3.35 TB/s; 132 SMs at 1.98 GHz (the clock of the
# 67 TFLOP/s fp32 figure, 128 fp32 lanes x 2 x 132). Per SM and clock,
# the integer ALU pipe (LOP3, SHF, IADD3, LEA, ...) takes 64 lanes'
# instructions, the FMA pipe (IMAD, VIADD) 64, and the four schedulers
# issue 128 lanes' instructions in all.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_LANES, FMA_LANES, ISSUE_LANES = 64, 64, 128
ALU_OPS = {
    "IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "IMNMX",
    "VIMNMX", "SHL", "SHR", "IABS", "BMSK", "SGXT", "FLO", "POPC", "BREV",
}
FMA_OPS = {"IMAD", "IMUL", "VIADD"}
# the kernel the main path launches (rows on 16 bytes: P % 4 == 0) and
# the chain-floor probe, by their names in the SASS
MAIN_FUNCTION = r"sha1_kernelILi4E"
PROBE_FUNCTION = r"chain_floor_kernel"
KERNEL = {
    "name": "sha1_batch",
    "route": "cuda",
    "source": "downloader_tpu_torch/parallel/csrc/sha1.cu",
    "replaces": "downloader_tpu/parallel/sha1_pallas.py:47",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = REPS) -> tuple[float, list[float]]:
    """Median device time of ``fn`` in ms by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def host_ms(fn, reps: int = REPS) -> tuple[float, list[float]]:
    """Median host wall time of ``fn`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times), times


def disassemble(library: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return subprocess.run(
        [os.path.join(cuda_home, "bin", "cuobjdump"), "-sass", library],
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    ).stdout


def sass_functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """``cuobjdump -sass`` text → {function name: [(address, instruction)]},
    each instruction without its guard predicate and its ``;``."""
    functions = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        functions[name.strip()] = [
            (int(addr, 16), re.sub(r"^@!?U?P\w+\s+", "", text.strip()))
            for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*?)\s*;", body)
        ]
    return functions


def _function(sass: str, function: str) -> list[tuple[int, str]]:
    """The code of the one function whose name matches ``function``."""
    functions = sass_functions(sass)
    names = [name for name in functions if re.search(function, name)]
    assert len(names) == 1, f"{function!r} names {names}"
    return functions[names[0]]


def _opcode(text: str) -> str:
    """The opcode without its modifiers; ``LDS RZ, [RZ]``, a load ptxas
    places before asynchronous copies that reads no message word, is
    ``LDS.RZ``, apart from the shared loads of message words."""
    op = text.split()[0].split(".")[0]
    return f"{op}.RZ" if op == "LDS" and re.match(r"LDS\S*\s+RZ\b", text) else op


def _loops(code: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(first, last) address of every loop: a backward branch and its
    target."""
    loops = set()
    for addr, text in code:
        branch = re.match(r"BRA\S*\s+(0x[0-9a-f]+)", text)
        if branch and int(branch.group(1), 16) < addr:
            loops.add((int(branch.group(1), 16), addr))
    return sorted(loops)


def _body(code, loop) -> list[str]:
    return [text for addr, text in code if loop[0] <= addr <= loop[1]]


_NO_DEST = {"ST", "STS", "STG", "STL", "LDGSTS", "BRA", "EXIT", "BAR", "WARPSYNC",
            "DEPBAR", "LDGDEPBAR", "NOP", "BSSY", "BSYNC", "RET", "CALL"}


def chain_depth(body: list[str]) -> int:
    """The longest chain of dependent instructions in straight-line code:
    each instruction comes one step after the last writer of any register
    it reads. Writes go to the first operand."""
    ready: dict[str, int] = {}
    longest = 0
    for text in body:
        op, _, rest = text.partition(" ")
        operands = [part.strip() for part in rest.split(",")]
        if not operands[0]:
            continue
        dest = None
        if _opcode(op) not in _NO_DEST and re.fullmatch(r"U?[RP]\d+(\.\w+)?", operands[0]):
            dest, operands = operands[0].split(".")[0], operands[1:]
        sources = re.findall(r"\b(U?[RP]\d+)\b", ",".join(operands))
        depth = 1 + max((ready.get(reg, 0) for reg in sources), default=0)
        longest = max(longest, depth)
        if dest:
            ready[dest] = depth
    return longest


def _per_block(ops: Counter, blocks: float) -> dict:
    """A count by pipe, per block. A block costs each SM the clocks of its
    busiest pipe or of issue (``sm_clocks``); one warp, on one of the
    SM's four sub-partitions, 16 ALU and 16 FMA lanes and one issue a
    clock (``warp_clocks``)."""
    issued = sum(ops.values()) / blocks
    alu = sum(n for op, n in ops.items() if op in ALU_OPS) / blocks
    fma = sum(n for op, n in ops.items() if op in FMA_OPS) / blocks
    return {
        "issued": issued,
        "alu": alu,
        "fma": fma,
        "sm_clocks": max(alu / ALU_LANES, fma / FMA_LANES, issued / ISSUE_LANES),
        "warp_clocks": max(alu * 32 / (ALU_LANES // 4), fma * 32 / (FMA_LANES // 4), issued),
        "by_opcode": {op: n / blocks for op, n in ops.most_common()},
    }


def sass_block_cost(sass: str, function: str, stage_blocks: int) -> dict:
    """The instructions the kernel ``function`` (a regex on its SASS name)
    issues per 64-byte block, by pipe, for each of its two warps and in
    all. The schedule warp's block loop is the innermost loop that stores
    to shared memory (W + K) and reads 16 message words a block from it;
    its stage loop, around it, issues the copies of ``stage_blocks``
    blocks a trip, and its own instructions count once per stage. The
    round warp's loop reads W + K, 20 16-byte loads a block, and neither
    stores nor copies; the longest dependent chain through its body is
    the rounds' chain."""
    code = _function(sass, function)
    loops = _loops(code)

    def count(loop) -> Counter:
        return Counter(_opcode(text) for text in _body(code, loop))

    def innermost(found: list, what: str) -> tuple[int, int]:
        assert found, f"no {what} in the kernel's SASS"
        return min(found, key=lambda loop: loop[1] - loop[0])

    block = innermost([loop for loop in loops if count(loop)["STS"]], "schedule loop")
    block_ops = count(block)
    per_trip = block_ops["LDS"] // 16
    assert per_trip >= 1 and block_ops["LDS"] % 16 == 0, f"loop LDS: {block_ops['LDS']}"
    # with one block a stage the two loops are one
    stage = innermost(
        [loop for loop in loops if loop[0] <= block[0] and block[1] <= loop[1]
         and count(loop)["LDGSTS"]],
        "copy loop around the schedule loop",
    )
    stage_ops = count(stage) - block_ops
    schedule_ops = Counter(
        {op: block_ops[op] / per_trip + stage_ops[op] / stage_blocks
         for op in block_ops | stage_ops}
    )
    rounds = innermost(
        [loop for loop in loops if count(loop)["LDS"] and not count(loop)["STS"]
         and not count(loop)["LDGSTS"]],
        "round loop",
    )
    round_ops = count(rounds)
    round_trip = round_ops["LDS"] // 20
    assert round_trip >= 1 and round_ops["LDS"] % 20 == 0, f"round LDS: {round_ops['LDS']}"
    round_ops = Counter({op: n / round_trip for op, n in round_ops.items()})
    depth = chain_depth(_body(code, rounds)) / round_trip
    total = _per_block(schedule_ops + round_ops, 1)
    del total["warp_clocks"]  # the two warps issue on two sub-partitions
    return {
        **total,
        "schedule_warp": _per_block(schedule_ops, 1),
        "round_warp": _per_block(round_ops, 1),
        "copies": schedule_ops["LDGSTS"],
        "blocks_per_trip": {"schedule": per_trip, "rounds": round_trip},
        "chain_depth": depth,
        "chain_per_round": depth / 80,
    }


def sass_probe_cost(sass: str, function: str) -> dict:
    """The chain-floor probe's loop, one block a trip: its instructions
    by pipe and its longest dependent chain."""
    code = _function(sass, function)
    loop = max(_loops(code), key=lambda loop: len(_body(code, loop)))
    body = _body(code, loop)
    depth = chain_depth(body)
    return {
        **_per_block(Counter(_opcode(text) for text in body), 1),
        "chain_depth": depth,
        "chain_per_round": depth / 80,
    }


def bounds(nblocks: torch.Tensor, cost: dict) -> dict:
    """Least time the card could take for this batch: each valid block
    read once (plus counts in, states out) over HBM, and each valid
    block's instructions on the busiest pipe of 132 SMs."""
    valid_blocks = int(nblocks.to(torch.int64).sum())
    count = nblocks.numel()
    moved = 64 * valid_blocks + 4 * count + 20 * count
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = cost["sm_clocks"] * valid_blocks / SM_CLOCKS_PER_S * 1e3
    return {
        "valid_blocks": valid_blocks,
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def chain_floor_ms(num_blocks: int) -> tuple[float, list[float]]:
    """Device time of the chain-floor probe (sha1_chain_floor in the
    kernel's source): the rounds' critical path alone for ``num_blocks``
    blocks on one lane."""
    lib = sha1_cuda.load()
    lib.sha1_chain_floor.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.sha1_chain_floor.restype = ctypes.c_int
    out = torch.empty(5, dtype=torch.int32, device="cuda")

    def run() -> None:
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.sha1_chain_floor(out.data_ptr(), num_blocks, stream)
        if status != 0:
            raise RuntimeError(f"sha1_chain_floor failed with CUDA error {status}")

    return cuda_ms(run)


def as_uint32(states: torch.Tensor) -> np.ndarray:
    return states.cpu().numpy().view(np.uint32).astype(np.int64)


def phase_kernel_vs_plain(rng: np.random.Generator) -> dict:
    """The kernel against its plain version on the card and hashlib."""
    device = torch.device("cuda", 0)
    ragged = [rng.bytes(4096) for _ in range(1029)] + [rng.bytes(1000), b""]
    worst = 0
    shapes = {}
    # 1024 lanes take the 16-byte copies of the main path, 1031 and the
    # edge sizes the 4-byte ones
    ragged_1024 = [rng.bytes(int(n)) for n in rng.integers(0, 8192, 1023)] + [b""]
    for label, pieces in (
        ("edge_sizes", [rng.bytes(n) for n in EDGE_SIZES]),
        ("ragged_1024", ragged_1024),
        ("ragged_1031", ragged),
    ):
        words, counts = pack_pieces(pieces)
        blocks = torch.from_numpy(words.view(np.int32)).to(device)
        nblocks = torch.from_numpy(counts).to(device)
        # the device-side layout the engine uses gives the same words
        raw, _ = pack_bytes(pieces)
        laid_out = to_gpu_layout(torch.from_numpy(raw).to(device))
        assert torch.equal(laid_out, blocks), f"{label}: device layout differs"
        # one padding lane (nblocks == 0) must come back as H0
        nblocks[len(pieces) // 2] = 0
        kernel = sha1_cuda.sha1_batch_cuda(blocks, nblocks)
        plain = sha1.sha1_states(blocks, nblocks)
        torch.cuda.synchronize()
        err = int(np.abs(as_uint32(kernel) - as_uint32(plain)).max())
        worst = max(worst, err)
        assert err == 0, f"{label}: kernel differs from plain by {err}"
        got = digests_to_bytes(kernel.cpu().numpy(), len(pieces))
        for lane, piece in enumerate(pieces):
            if lane == len(pieces) // 2:
                assert as_uint32(kernel)[:, lane].tolist() == list(H0), label
            else:
                want = hashlib.sha1(piece).digest()
                assert got[lane] == want, f"{label}: lane {lane} != hashlib"
        shapes[label] = {"P": len(pieces), "B": words.shape[0]}
    # the plain version against the kernel at the ragged shape: the plain
    # one runs ~20 small tensor ops per round, far too slow for the 1 GiB
    # phase, so it is timed only here
    plain_ms, plain_runs = cuda_ms(lambda: sha1.sha1_states(blocks, nblocks))
    kernel_ms, kernel_runs = cuda_ms(
        lambda: sha1_cuda.sha1_batch_cuda(blocks, nblocks)
    )
    emit(
        "kernel_vs_plain",
        shapes=shapes,
        max_abs_err=worst,
        plain_ms=plain_ms,
        plain_runs_ms=plain_runs,
        kernel_ms=kernel_ms,
        kernel_runs_ms=kernel_runs,
        timed_shape=shapes["ragged_1031"],
    )
    return {"max_abs_err": worst}


class _Swarm:
    """What a _PieceBatch needs of its swarm: the store and release()."""

    def __init__(self, store: PieceStore):
        self.store = store
        self.released: list[tuple[int, object]] = []

    def release(self, index: int, owner) -> None:
        self.released.append((index, owner))


def phase_main_path(payload: bytes, workdir: str, bad: int) -> dict:
    """make_torrent → resume_existing → corrupt + resume → _PieceBatch,
    all through DigestEngine(backend="cuda")."""
    engine = DigestEngine(backend="cuda")
    shards = len(engine.devices)
    num_pieces = PAYLOAD_BYTES // PIECE_LENGTH
    flushes = -(-PAYLOAD_BYTES // RESUME_BATCH_BYTES)
    steps = {}

    def launched(step: str, before: int, calls: int) -> None:
        moved = sha1_cuda.launches - before
        steps[step] = moved
        assert moved == calls * shards, (
            f"{step}: {moved} kernel launches, want {calls * shards}"
        )

    torch.cuda.synchronize()
    sha1_cuda.launches = 0
    start = time.perf_counter()

    before = sha1_cuda.launches
    t0 = time.perf_counter()
    info, _meta, _blob = make_torrent(
        "episode.mkv", payload, piece_length=PIECE_LENGTH, engine=engine
    )
    make_torrent_s = time.perf_counter() - t0
    launched("make_torrent", before, 1)
    table = [
        hashlib.sha1(payload[i : i + PIECE_LENGTH]).digest()
        for i in range(0, PAYLOAD_BYTES, PIECE_LENGTH)
    ]
    assert info[b"pieces"] == b"".join(table), "piece table != hashlib"

    seed_dir = os.path.join(workdir, "resume")
    os.makedirs(seed_dir)
    path = os.path.join(seed_dir, "episode.mkv")
    with open(path, "wb") as sink:
        sink.write(payload)

    before = sha1_cuda.launches
    t0 = time.perf_counter()
    resumed = PieceStore(info, seed_dir).resume_existing(
        engine, batch_bytes=RESUME_BATCH_BYTES
    )
    resume_s = time.perf_counter() - t0
    launched("resume", before, flushes)
    assert resumed == num_pieces, f"resumed {resumed} of {num_pieces}"

    offset = bad * PIECE_LENGTH + PIECE_LENGTH // 3
    with open(path, "r+b") as sink:
        sink.seek(offset)
        sink.write(bytes([payload[offset] ^ 0x01]))
    before = sha1_cuda.launches
    store = PieceStore(info, seed_dir)
    resumed = store.resume_existing(engine, batch_bytes=RESUME_BATCH_BYTES)
    launched("resume_corrupt", before, flushes)
    assert resumed == num_pieces - 1, f"resumed {resumed} after corruption"
    missing = [i for i, have in enumerate(store.have) if not have]
    assert missing == [bad], f"missing {missing}, want [{bad}]"

    live_dir = os.path.join(workdir, "live")
    store = PieceStore(info, live_dir)
    swarm = _Swarm(store)
    batch = _PieceBatch(swarm, engine=engine, owner="peer-1")
    lo = max(0, min(bad - 3, num_pieces - LIVE_BATCH_PIECES))
    indices = list(range(lo, lo + LIVE_BATCH_PIECES))
    before = sha1_cuda.launches
    raised = None
    try:
        for index in indices:
            data = bytearray(payload[index * PIECE_LENGTH : (index + 1) * PIECE_LENGTH])
            if index == bad:
                data[PIECE_LENGTH // 2] ^= 0xFF
            batch.add(index, bytes(data))
        batch.flush()
    except PeerProtocolError as exc:
        raised = str(exc)
    launched("piece_batch", before, 1)
    assert raised == f"pieces [{bad}] failed SHA-1 verification", raised
    assert swarm.released == [(bad, "peer-1")], swarm.released
    with open(os.path.join(live_dir, "episode.mkv"), "rb") as written:
        for index in indices:
            written.seek(index * PIECE_LENGTH)
            chunk = written.read(PIECE_LENGTH)
            want = payload[index * PIECE_LENGTH : (index + 1) * PIECE_LENGTH]
            assert store.have[index] == (index != bad), index
            if index != bad:
                assert chunk == want, f"piece {index} written wrong"

    torch.cuda.synchronize()
    total = sha1_cuda.launches
    assert engine.backend_name.startswith("cuda-sha1[cuda:"), engine.backend_name
    emit(
        "main_path",
        seconds=time.perf_counter() - start,
        make_torrent_s=make_torrent_s,
        first_resume_s=resume_s,
        pieces=num_pieces,
        bad_piece=bad,
        launches=total,
        launches_by_step=steps,
        backend_name=engine.backend_name,
    )
    return {"launches": total, "engine": engine, "path": path, "info": info}


def phase_times(payload: bytes, main: dict, cost: dict) -> dict:
    """Kernel, pack, copies, hashlib and the resume path, timed."""
    device = torch.device("cuda", 0)
    pieces = [
        payload[i : i + PIECE_LENGTH] for i in range(0, PAYLOAD_BYTES, PIECE_LENGTH)
    ]
    width = max_blocks(pieces) * 64
    pinned = torch.empty((len(pieces), width), dtype=torch.uint8, pin_memory=True)
    pack_ms, pack_runs = host_ms(lambda: pack_bytes(pieces, out=pinned.numpy()))
    _, counts = pack_bytes(pieces, out=pinned.numpy())
    nblocks = torch.from_numpy(counts).to(device)
    h2d_ms, _ = cuda_ms(lambda: pinned.to(device, non_blocking=True))
    raw = pinned.to(device)
    layout_ms, _ = cuda_ms(lambda: to_gpu_layout(raw))
    blocks = to_gpu_layout(raw)
    shapes = {}
    for count in (len(pieces), RESUME_BATCH_BYTES // PIECE_LENGTH):
        part = blocks if count == len(pieces) else to_gpu_layout(raw[:count])
        part_counts = nblocks[:count].contiguous()
        ms, runs = cuda_ms(lambda: sha1_cuda.sha1_batch_cuda(part, part_counts))
        floor_ms, floor_runs = chain_floor_ms(part.shape[0])
        shapes[f"P{count}_B{part.shape[0]}"] = {
            "P": count,
            "B": part.shape[0],
            "kernel_ms": ms,
            "kernel_runs_ms": runs,
            "kernel_ns_per_block": ms * 1e6 / part.shape[0],
            "chain_floor_ms": floor_ms,
            "chain_floor_runs_ms": floor_runs,
            "chain_floor_ns_per_block": floor_ms * 1e6 / part.shape[0],
            "GBps": count * PIECE_LENGTH / ms / 1e6,
            **bounds(part_counts, cost),
        }
    states = sha1_cuda.sha1_batch_cuda(blocks, nblocks)
    host_states = torch.empty(states.shape, dtype=states.dtype, pin_memory=True)
    d2h_ms, _ = cuda_ms(lambda: host_states.copy_(states, non_blocking=True))

    # the kernel against its plain version at the make_torrent shape, on
    # the same tensors; the plain version takes minutes here, so it runs
    # (and is timed) once
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = sha1.sha1_states(blocks, nblocks)
    end.record()
    end.synchronize()
    plain_main_ms = start.elapsed_time(end)
    err_main = int(np.abs(as_uint32(states) - as_uint32(plain)).max())
    assert err_main == 0, f"main shape: kernel differs from plain by {err_main}"
    table = b"".join(digests_to_bytes(states.cpu().numpy(), len(pieces)))
    assert table == main["info"][b"pieces"], "kernel states != piece table"
    hashlib_ms, hashlib_runs = host_ms(
        lambda: [hashlib.sha1(p).digest() for p in pieces]
    )

    info, path = main["info"], main["path"]
    base = os.path.dirname(path)

    def read_all() -> None:
        # resume_existing's host read of every piece, without the digest
        store, handles = PieceStore(info, base), {}
        try:
            for index in range(store.num_pieces):
                store.read_piece(index, handles=handles)
        finally:
            for handle in handles.values():
                handle.close()

    read_ms, read_runs = host_ms(read_all)
    engines = {"cuda": main["engine"], "hashlib": DigestEngine(backend="hashlib")}
    resume_s = {"cuda": [], "hashlib": []}
    for order in range(REPS):
        for name in ("cuda", "hashlib") if order % 2 == 0 else ("hashlib", "cuda"):
            start = time.perf_counter()
            resumed = PieceStore(info, base).resume_existing(
                engines[name], batch_bytes=RESUME_BATCH_BYTES
            )
            torch.cuda.synchronize()
            resume_s[name].append(time.perf_counter() - start)
            assert resumed == len(pieces) - 1, (name, resumed)

    # auto's choice at each caller's shape (printed, not asserted), and
    # what each choice costs: verify_pieces, the call resume and
    # _PieceBatch make, through auto, the card and hashlib
    auto = DigestEngine(backend="auto")
    engines["auto"] = auto
    digests = [table[i : i + 20] for i in range(0, len(table), 20)]
    decisions = {}
    for count in (
        len(pieces),
        RESUME_BATCH_BYTES // PIECE_LENGTH,
        LIVE_BATCH_PIECES,
    ):
        batch, want = pieces[:count], digests[:count]
        before = auto.device_batches
        assert auto.verify_pieces(batch, want) == [True] * count
        decision = "device" if auto.device_batches > before else "hashlib"
        timed = {
            f"{name}_ms": host_ms(lambda e=engines[name]: e.verify_pieces(batch, want))[0]
            for name in ("auto", "cuda", "hashlib")
        }
        decisions[f"P{count}"] = {"decision": decision, **timed}
    hashlib_bps, transfer_bps, sync_s, block_s = auto._calibrate()
    emit(
        "times",
        shapes=shapes,
        pack_ms=pack_ms,
        pack_runs_ms=pack_runs,
        h2d_pinned_ms=h2d_ms,
        h2d_GBps=pinned.numel() / h2d_ms / 1e6,
        layout_ms=layout_ms,
        d2h_states_ms=d2h_ms,
        plain_main_shape_ms=plain_main_ms,
        max_abs_err_main_shape=err_main,
        hashlib_ms=hashlib_ms,
        hashlib_runs_ms=hashlib_runs,
        read_pieces_ms=read_ms,
        read_pieces_runs_ms=read_runs,
        resume_s_median={k: statistics.median(v) for k, v in resume_s.items()},
        resume_s_runs=resume_s,
        auto_offload=decisions,
        auto_calibration={
            "hashlib_MBps": hashlib_bps / 1e6,
            "transfer_MBps": transfer_bps / 1e6,
            "sync_ms": sync_s * 1e3,
            "block_us": block_s * 1e6,
        },
        backend_name_auto=auto.backend_name,
    )
    return {
        **shapes[f"P{len(pieces)}_B{blocks.shape[0]}"],
        "plain_ms": plain_main_ms,
        "max_abs_err": err_main,
    }


def phase_profile(main: dict) -> None:
    """One resume_existing of the payload through the card under
    torch.profiler: device time by kernel and the card's idle share of
    the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    base = os.path.dirname(main["path"])
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        resumed = PieceStore(main["info"], base).resume_existing(
            main["engine"], batch_bytes=RESUME_BATCH_BYTES
        )
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    assert resumed == PAYLOAD_BYTES // PIECE_LENGTH - 1, resumed
    device = [
        (event.key, event.self_device_time_total / 1e3, event.count)
        for event in prof.key_averages()
        if event.device_type == DeviceType.CUDA
    ]
    busy_ms = sum(ms for _, ms, _ in device)
    assert busy_ms > 0, "the profiler saw no device time"
    emit(
        "profile_resume",
        wall_ms=wall_ms,
        device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms,
        device_ms_by_kernel=sorted(device, key=lambda row: -row[1])[:8],
    )


def nvidia_smi() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return result.stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    card = nvidia_smi()
    print(card, flush=True)

    start = time.perf_counter()
    built = sha1_cuda.build()
    sha1_cuda.load()
    build_s = time.perf_counter() - start
    sass = disassemble(str(built))
    _, stage_blocks = sha1_cuda.RING
    cost = sass_block_cost(sass, MAIN_FUNCTION, stage_blocks)
    emit(
        "build",
        seconds=build_s,
        library=os.path.basename(built),
        ptxas=[line for line in sha1_cuda.build_log.splitlines() if line.strip()],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=subprocess.run(
            [sha1_cuda._nvcc(), "--version"], capture_output=True, text=True, check=True
        ).stdout.strip().splitlines()[-1],
        instructions_per_block=cost,
        chain_floor_probe_per_block=sass_probe_cost(sass, PROBE_FUNCTION),
    )

    rng = np.random.default_rng(args.seed)
    checked = phase_kernel_vs_plain(rng)

    start = time.perf_counter()
    payload = rng.bytes(PAYLOAD_BYTES)
    bad = int(rng.integers(PAYLOAD_BYTES // PIECE_LENGTH))
    emit("payload", seconds=time.perf_counter() - start, bytes=PAYLOAD_BYTES)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
        main_path = phase_main_path(payload, workdir, bad)
        main_shape = phase_times(payload, main_path, cost)
        phase_profile(main_path)

    kernel = dict(KERNEL)
    kernel.update(
        launches=main_path["launches"],
        max_abs_err=max(checked["max_abs_err"], main_shape["max_abs_err"]),
        ms=main_shape["kernel_ms"],
        plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"],
        bound_by=main_shape["bound_by"],
        library_ms=None,
    )
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
