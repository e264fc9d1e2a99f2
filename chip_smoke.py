#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's piece-verification path, one HTTP job, one torrent job, the queue-driven daemon, its crash-only fleet, its analyzer's recorders, its installed forms, its chaos and profiling tooling and its benchmark on one card.

Run from the root of a checkout, on a host with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the CUDA SHA-1 kernel from the checkout's sources, holds it
against its plain PyTorch version and hashlib, drives the main path at
full size through the entry points a user calls (``make_torrent``,
``PieceStore.resume_existing``, ``_PieceBatch``) on a 1 GiB payload made
from the seed, checks every answer, times the kernel and the path around
it, and prints one JSON line per phase. The ``job`` phase then runs
``python3 -m downloader_tpu_torch download-once`` on the same payload
against a loopback origin and the port's S3 stub, three times, and holds
the stored object against the payload. The ``torrent_shapes`` phase
times the kernel at the torrent path's shapes (256 KiB pieces), and the
``torrent`` phase serves the payload from the port's ``Seeder`` and runs
``download-once`` of its magnet in a child process, once from nothing
and once resuming half of the file, counting the kernel's launches
inside the job's own process. The ``daemon`` phase runs ``python3 -m
downloader_tpu_torch serve`` with its default configuration in a child
process against the port's AMQP and S3 stubs: two magnet jobs (the
episode and a 256 MiB torrent) whose flushes share the card, then a
burst of 48 small HTTP jobs on the batched lane; it checks every
Convert and stored object, counts the worker's kernel launches and ends
the worker with SIGTERM. The ``fleet`` phase runs ``serve --workers 2``
with the content cache on (``CACHE_DIR``) on the same stream, every clip
published twice, and SIGKILLs the worker that holds the second torrent
partway through its fetch: the job is redelivered and the worker
restarted; both worker processes launch the kernel on the one card, and
their launches are counted per worker life. The ``analysis`` phase runs
the port's static analyzer over its own tree (no violation, ten reasoned
suppressions), then one 64 MiB torrent job in a child process that
installs the port's lock-order and protocol recorders before it imports
the port, has four threads verify pieces on the card at once after the
job and captures an incident bundle: the recorded lock graph must be
acyclic and hold the engine's and the kernel wrapper's locks, no
protocol obligation may leak, and the bundle must carry the lock
state. The ``packaging`` phase runs the port as an installed program
from outside the checkout: the wheel built offline and installed into a
target directory, whose counted torrent job must compile the kernel
from the wheel's own source into a fresh cache and whose console script
must reuse it; then the zipapp, whose counted job, with no nvcc to be
found, must take the kernel library from the archive and load the
native RC4 core. The ``tooling`` phase runs the port's failpoint
matrix and profiling artifacts as CI runs them and then one torrent job
whose peer-wire reads and writes fail at a seeded rate: both sites must
inject, every piece must be verified on the card and the stored object
must equal the payload. The ``bench`` phase runs the port's benchmark
twins: ``__graft_entry_torch__``'s entry and one-card dry run,
``bench_digest_torch.py`` (the kernel against hashlib at three batch
shapes) and ``bench_torch.py`` with its workload cut to a few minutes,
every arm on; it checks each arm's contract numbers and counts the
kernel's launches in each child. The last line is
``{"ok": true, "device": {...}}``; any failed check raises and the
script exits non-zero without it. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import base64
import ctypes
import hashlib
import http.server
import json
import os
import statistics
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter


def _recording_child() -> bool:
    """Whether this process is the analysis phase's recorded child,
    ``chip_smoke.py --counted-job REPORT --record ... -- <arguments>``."""
    argv = sys.argv
    return (__name__ == "__main__" and argv[1:2] == ["--counted-job"] and "--" in argv
            and "--record" in argv[3 : argv.index("--")])


# The recorded child installs the port's lock-order and protocol
# recorders before it imports anything else of the port: a lock made
# before install() is a real lock the recorder never sees, and the
# kernel wrapper's and the engine module's locks are module globals.
if _recording_child():
    from downloader_tpu_torch.analysis.runtime import LockOrderRecorder, ProtocolRecorder

    RECORDERS = (LockOrderRecorder().install(), ProtocolRecorder().install())
else:
    RECORDERS = None

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
from downloader_tpu_torch.store import Credentials
from downloader_tpu_torch.store.stub import S3Stub

# the JAX package's test set of padding edge cases (tests/test_parallel.py)
EDGE_SIZES = (0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 16384)
PAYLOAD_BYTES = 1 << 30  # one TV-episode-sized media file
PIECE_LENGTH = 1 << 20
RESUME_BATCH_BYTES = 64 * 1024 * 1024  # PieceStore.resume_existing's default
LIVE_BATCH_PIECES = 8  # _PieceBatch's default 8 MiB flush at 1 MiB pieces
# the make_torrent batch's depth for the plain version: 64 KiB of each
# 1 MiB piece, B=1025 blocks instead of 16385
PLAIN_PIECE_BYTES = 64 * 1024
REPS = 5
JOB_RUNS = 3
JOB_NAME = "Show.S01E01.mkv"
JOB_TIMEOUT_S = 300  # one download-once subprocess; ~10 s expected
JOB_SPANS = ("fetch", "backend", "scan", "upload")
# the torrent phase: the same episode as a 256 KiB-piece torrent, the
# piece length mktorrent picks by default (-l 18); 4096 pieces of 4097
# SHA-1 blocks each
TORRENT_PIECE = 256 * 1024
# pieces per engine call at that piece length: a live _PieceBatch flush
# (8 MiB), a resume flush (64 MiB), the seeder's make_torrent (1 GiB)
TORRENT_SHAPES = (8 * 1024 * 1024 // TORRENT_PIECE, RESUME_BATCH_BYTES // TORRENT_PIECE,
                  PAYLOAD_BYTES // TORRENT_PIECE)
TORRENT_PLAIN_SHAPE = TORRENT_SHAPES[0]  # the plain version runs here only
TORRENT_SPANS = ("job", "fetch", "backend", "peer-connect", "piece", "scan", "upload")
TORRENT_JOB_TIMEOUT_S = 600  # one swarm job; about a minute expected
# the daemon phase: a media pipeline's consumer, whole-episode torrents
# next to a burst of small clips and extras over HTTP
DAEMON_SECOND_BYTES = 256 * 1024 * 1024  # a second torrent, 1024 pieces
DAEMON_CLIPS = 48
DAEMON_CLIP_BYTES = (1 << 20, 4 << 20)  # at most BATCH_MAX_BYTES: the batched lane
DAEMON_SECOND_NAME = "Show.S01E02.mkv"
DAEMON_WAIT_S = 600  # both torrent jobs; about a minute expected
# the fleet phase: the daemon cell's stream through ``serve --workers 2``
# with the data plane on; the worker holding the second torrent is
# SIGKILLed once this share of its pieces was served
FLEET_WORKERS = 2
FLEET_KILL_SHARE = 1 / 3
# the launches PERF.md predicts for the fleet phase's jobs: the episode
# in one life, every 8 MiB flush on the card; the second torrent's live
# flushes over its two lives and the redelivered life's resume batches
# (64 MiB each) as ranges, since the kill lands between flushes
FLEET_EPISODE_LIVE = PAYLOAD_BYTES // (8 << 20)
FLEET_SECOND_LIVE = (DAEMON_SECOND_BYTES // (8 << 20), DAEMON_SECOND_BYTES // (8 << 20) + 4)
FLEET_SECOND_RESUME = (1, DAEMON_SECOND_BYTES // RESUME_BATCH_BYTES)
# the analysis phase: the port's analyzer over its own tree (no
# violations, this many reasoned suppressions), then a torrent job of
# this many bytes (256 KiB pieces: eight live flushes at P=32, B=4097)
# under the port's recorders, after which this many threads call
# verify_pieces at once on batches made from the seed
ANALYSIS_SUPPRESSIONS = 10
ANALYSIS_BYTES = 64 * 1024 * 1024
ANALYSIS_THREADS = 4
ANALYSIS_SEED = 7
ANALYSIS_TIMEOUT_S = 300  # each analyzer run; about 5 s expected
# the packaging phase: the port installed from its wheel and as its
# zipapp, each run from outside the checkout; the wheel's counted job
# takes the whole episode, the console script's and the archive's the
# first PACKAGING_BYTES (256 pieces); the archive's child then checks
# one live flush's shape made from PACKAGING_SEED
PACKAGING_BYTES = 64 * 1024 * 1024
PACKAGING_SEED = 8
PACKAGING_TIMEOUT_S = 600  # each build step; seconds to a minute expected
# the tooling phase: the port's failpoint matrix and profiling artifacts
# run as CI runs them (each receipt's schedule fingerprint must be the
# JAX package's), then one torrent job of the first TOOLING_BYTES (512
# pieces) with the peer wire's failpoints armed at a seeded rate. A
# 256 KiB piece takes about 50 socket calls; at 5 % a connection dies
# within about ten and, with one seeder, four rounds in a row complete
# nothing and the swarm gives up. At 0.2 % a connection lasts about ten
# pieces: some 45 injections and as many dials for the job
TOOLING_BYTES = 128 * 1024 * 1024
TOOLING_SPEC = "peer.recv=fail:0.002,peer.send=fail:0.002"
TOOLING_SEED = 9
TOOLING_PROFILE_JOBS = 300
TOOLING_TIMEOUT_S = 600  # each tool; about a minute expected
MATRIX_FINGERPRINTS = {509: "8c90e617660b966e", 1307: "2a2a3d381bf2bc21", 9001: "727a423415f816c3"}
# the bench phase: the port's benchmark twins. bench_torch.py runs with
# its workload cut to a few minutes (PERF.md §4 lists the cut); every
# knob it does not name stays at bench.py's default
BENCH_KNOBS = {
    "BENCH_JOBS": "12", "BENCH_MB": "16", "BENCH_REPEATS": "1", "BENCH_SLICES": "2",
    "BENCH_ABLATION_REPEATS": "1", "BENCH_PIPELINE_REPEATS": "1",
    "BENCH_SEGMENTED_REPEATS": "1", "BENCH_MULTI_REPEATS": "1", "BENCH_SMALL_WAVES": "1",
    "BENCH_PROFILE_JOBS": "300",
}
BENCH_TIMEOUT_S = 900  # bench_torch.py at the cut; a few minutes expected
BENCH_DIGEST_SHAPES = ((256, 1024), (256, 128), (16, 1024))  # bench_digest.py's main()
# the metrics of bench.py's report with every arm on
BENCH_METRICS = {
    "job_overhead_latency_ms", "throughput_pairs", "ablation", "pipeline_overlap",
    "segmented_vs_single", "multi_source", "small_object_overhead", "overload_shedding",
    "watchdog_overhead", "telemetry_overhead", "canary_probe", "profile_attribution",
    "fleet_chaos", "fleet_scrape", "flow_accounting", "single_flight", "digest_kernel",
}
# the fleet chaos arm's workers take PREFETCH=4: the deliveries a
# SIGKILLed worker held unacked are redelivered (at-least-once), and each
# may publish its Convert a second time
BENCH_FLEET_PREFETCH = 4
# what a child job or worker takes from this process's environment: the
# host's own variables and no knob of the port, so every knob a phase
# does not set stays at its default
HOST_ENV = {
    "PATH", "HOME", "TMPDIR", "TMP", "TEMP", "USER", "LOGNAME", "SHELL", "TZ", "LANG",
    "LD_LIBRARY_PATH", "VIRTUAL_ENV", "XDG_CACHE_HOME",
}
HOST_ENV_PREFIXES = ("LC_", "CUDA_", "NVIDIA_")


def child_env(**knobs: str) -> dict:
    """The environment of a child job or worker: the host's variables of
    this process and ``knobs``."""
    env = {
        name: value for name, value in os.environ.items()
        if name in HOST_ENV or name.startswith(HOST_ENV_PREFIXES)
    }
    env.update(PYTHONPATH=os.path.dirname(os.path.abspath(__file__)), **knobs)
    return env

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

    # at full depth the kernel's states are the piece table, which the
    # main path held against hashlib
    table = b"".join(digests_to_bytes(states.cpu().numpy(), len(pieces)))
    assert table == main["info"][b"pieces"], "kernel states != piece table"
    # the kernel against its plain version on the same tensors, at the
    # make_torrent batch's lanes cut to PLAIN_PIECE_BYTES: the plain
    # version takes about five minutes at the full depth (B=16385), so it
    # runs, and is timed, once at this depth
    cut = [piece[:PLAIN_PIECE_BYTES] for piece in pieces]
    cut_raw, cut_counts = pack_bytes(cut)
    cut_blocks = to_gpu_layout(torch.from_numpy(cut_raw).to(device))
    cut_nblocks = torch.from_numpy(cut_counts).to(device)
    cut_states = sha1_cuda.sha1_batch_cuda(cut_blocks, cut_nblocks)
    assert digests_to_bytes(cut_states.cpu().numpy(), len(cut)) == [
        hashlib.sha1(piece).digest() for piece in cut
    ], "cut shape: kernel digests != hashlib"
    cut_kernel_ms, cut_kernel_runs = cuda_ms(
        lambda: sha1_cuda.sha1_batch_cuda(cut_blocks, cut_nblocks)
    )
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = sha1.sha1_states(cut_blocks, cut_nblocks)
    end.record()
    end.synchronize()
    plain_cut_ms = start.elapsed_time(end)
    err_cut = int(np.abs(as_uint32(cut_states) - as_uint32(plain)).max())
    assert err_cut == 0, f"cut shape: kernel differs from plain by {err_cut}"
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
        plain_shape={"P": len(cut), "B": cut_blocks.shape[0]},
        plain_cut_shape_ms=plain_cut_ms,
        kernel_cut_shape_ms=cut_kernel_ms,
        kernel_cut_shape_runs_ms=cut_kernel_runs,
        max_abs_err_cut_shape=err_cut,
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
    return {"max_abs_err": err_cut}


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


class _OriginHandler(http.server.BaseHTTPRequestHandler):
    """Serves the files of one directory: HEAD, and GET with ``Range``
    answered 206, so the job's default HEAD probe stripes the fetch and
    the daemon's batched lane can size a job. Anything else is a 404."""

    protocol_version = "HTTP/1.1"  # keep-alive, as the segments expect
    timeout = 60
    root = ""

    def log_message(self, *args) -> None:
        pass

    def do_HEAD(self) -> None:
        self._answer(send=False)

    def do_GET(self) -> None:
        self._answer(send=True)

    def _answer(self, send: bool) -> None:
        file_path = os.path.join(self.root, os.path.basename(self.path))
        if self.path != "/" + os.path.basename(self.path) or not os.path.isfile(file_path):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        size = os.path.getsize(file_path)
        start, end = 0, size
        ranged = self.headers.get("Range", "")
        if send and ranged.startswith("bytes="):
            lo, _, hi = ranged[len("bytes="):].partition("-")
            start, end = int(lo), min(size, int(hi) + 1 if hi else size)
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{end - 1}/{size}")
        else:
            self.send_response(200)
        self.send_header("Content-Length", str(end - start))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
        if send:
            with open(file_path, "rb") as source:
                self.connection.sendfile(source, start, end - start)


class _OriginServer(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address) -> None:
        # a job's pooled keep-alive connections reset when its process
        # exits; anything else is a real fault
        if not isinstance(sys.exc_info()[1], ConnectionError):
            super().handle_error(request, client_address)


def _run_job(url: str, base_dir: str, trace_out: str, env: dict) -> tuple:
    """One ``download-once`` in a child interpreter (its own GIL, apart
    from the origin and the stub in this process): (exit code, stdout,
    wall seconds, stderr)."""
    command = [
        sys.executable, "-m", "downloader_tpu_torch", "--trace-out", trace_out,
        "download-once", "--id", "episode-1", "--url", url, "--base-dir", base_dir,
    ]
    start = time.perf_counter()
    done = subprocess.run(
        command, env=env, cwd=base_dir, capture_output=True, text=True,
        timeout=JOB_TIMEOUT_S,
    )
    wall = time.perf_counter() - start
    return done.returncode, done.stdout, wall, done.stderr


def phase_job(payload: bytes, workdir: str, card: str) -> dict:
    """``python3 -m downloader_tpu_torch download-once`` of the 1 GiB
    episode from a loopback origin into the port's S3 stub, JOB_RUNS
    times, each into a fresh base directory and a fresh stub; then a
    404 that must fail and store nothing. Every object is held against
    the payload by SHA-256. All times are host wall clock on the card's
    machine: this path does no device work."""
    phase_start = time.perf_counter()
    origin_dir = os.path.join(workdir, "origin")
    os.makedirs(origin_dir)
    origin_file = os.path.join(origin_dir, JOB_NAME)
    with open(origin_file, "wb") as sink:
        sink.write(payload)
    want_sha256 = hashlib.sha256(payload).hexdigest()
    key = f"episode-1/original/{base64.b64encode(JOB_NAME.encode()).decode()}"
    env = child_env(S3_ACCESS_KEY="smoke-ak", S3_SECRET_KEY="smoke-sk")
    credentials = Credentials(access_key="smoke-ak", secret_key="smoke-sk")

    handler = type("Origin", (_OriginHandler,), {"root": origin_dir})
    server = _OriginServer(("127.0.0.1", 0), handler)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    runs = []
    try:
        for run in range(JOB_RUNS + 1):
            failing = run == JOB_RUNS
            base_dir = os.path.join(workdir, f"job-{run}")
            os.makedirs(base_dir)
            trace_out = os.path.join(base_dir, "trace.json")
            url = f"{base_url}/{'missing.mkv' if failing else JOB_NAME}"
            with S3Stub(credentials=credentials) as stub:
                env["S3_ENDPOINT"] = f"http://{stub.endpoint}"
                code, stdout, wall, stderr = _run_job(url, base_dir, trace_out, env)
                objects = {
                    (bucket, name): data
                    for bucket, stored in stub.buckets.items()
                    for name, data in stored.items()
                }
                dangling = stub.list_multipart_uploads()
                multiparts = stub.completed_multiparts
            if failing:
                assert code == 1, f"404 job exited {code}: {stderr[-2000:]}"
                assert objects == {} and dangling == [], "404 job stored something"
                continue
            assert code == 0, f"job exited {code}: {stderr[-2000:]}"
            printed = stdout.splitlines()
            assert printed == [os.path.join(base_dir, "episode-1", JOB_NAME)], printed
            assert list(objects) == [("triton-staging", key)], list(objects)
            got_sha256 = hashlib.sha256(objects["triton-staging", key]).hexdigest()
            assert got_sha256 == want_sha256, "stored object != payload"
            assert dangling == [] and multiparts == 1, (dangling, multiparts)
            del objects
            with open(trace_out) as trace:
                events = json.load(trace)["traceEvents"]
            spans_ms = {}
            for event in events:
                if event.get("ph") == "X" and event["name"] in JOB_SPANS:
                    spans_ms[event["name"]] = spans_ms.get(event["name"], 0) + event["dur"] / 1e3
            job_status = [e for e in events if e.get("name") == "job"][0]["args"]["status"]
            assert job_status == "ok", job_status
            assert set(spans_ms) == set(JOB_SPANS), spans_ms
            runs.append({"wall_s": wall, "spans_ms": spans_ms})
            shutil.rmtree(base_dir)
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    walls = [run["wall_s"] for run in runs]
    median_wall = statistics.median(walls)
    fields = dict(
        clock="host wall clock on the card's machine; no device work on this path",
        seconds=time.perf_counter() - phase_start,
        payload_bytes=len(payload),
        runs=JOB_RUNS,
        wall_s_median=median_wall,
        wall_s_runs=walls,
        MBps_median=len(payload) / median_wall / 1e6,
        spans_ms_median={
            name: statistics.median(run["spans_ms"][name] for run in runs)
            for name in JOB_SPANS
        },
        spans_ms_runs=[run["spans_ms"] for run in runs],
        object_sha256_equal_payload=True,
        not_found_exit=1,
        host_cpus=os.cpu_count(),
        host_cpus_usable=len(os.sched_getaffinity(0)),
        card=card,
    )
    emit("job", **fields)
    return fields


def phase_torrent_shapes(payload: bytes, cost: dict) -> dict:
    """The kernel at the torrent path's shapes (256 KiB pieces, B=4097):
    a live flush, a resume flush and the seeder's make_torrent, each held
    bit-exact against hashlib, and against the plain version at the live
    flush's shape (the plain version takes 1.5 minutes at B=4097)."""
    device = torch.device("cuda", 0)
    pieces = [
        payload[i : i + TORRENT_PIECE] for i in range(0, PAYLOAD_BYTES, TORRENT_PIECE)
    ]
    width = max_blocks(pieces) * 64
    pinned = torch.empty((len(pieces), width), dtype=torch.uint8, pin_memory=True)
    _, counts = pack_bytes(pieces, out=pinned.numpy())
    raw = pinned.to(device)
    nblocks_all = torch.from_numpy(counts).to(device)
    shapes = {}
    worst = 0
    for count in TORRENT_SHAPES:
        blocks = to_gpu_layout(raw[:count])
        nblocks = nblocks_all[:count].contiguous()
        states = sha1_cuda.sha1_batch_cuda(blocks, nblocks)
        got = digests_to_bytes(states.cpu().numpy(), count)
        want = [hashlib.sha1(piece).digest() for piece in pieces[:count]]
        assert got == want, f"P={count}: kernel digests != hashlib"
        ms, runs = cuda_ms(lambda: sha1_cuda.sha1_batch_cuda(blocks, nblocks))
        entry = {
            "P": count,
            "B": blocks.shape[0],
            "kernel_ms": ms,
            "kernel_runs_ms": runs,
            "kernel_ns_per_block": ms * 1e6 / blocks.shape[0],
            "GBps": count * TORRENT_PIECE / ms / 1e6,
            "equal_hashlib": True,
            **bounds(nblocks, cost),
        }
        if count == TORRENT_PLAIN_SHAPE:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = sha1.sha1_states(blocks, nblocks)
            end.record()
            end.synchronize()
            err = int(np.abs(as_uint32(states) - as_uint32(plain)).max())
            assert err == 0, f"P={count}: kernel differs from plain by {err}"
            worst = max(worst, err)
            entry.update(plain_ms=start.elapsed_time(end), max_abs_err=err)
        shapes[f"P{count}_B{blocks.shape[0]}"] = entry
    floor_ms, floor_runs = chain_floor_ms(raw.shape[1] // 64)
    emit(
        "torrent_shapes",
        piece_length=TORRENT_PIECE,
        shapes=shapes,
        chain_floor_ms=floor_ms,
        chain_floor_runs_ms=floor_runs,
        max_abs_err=worst,
    )
    return {"max_abs_err": worst, "shapes": shapes}


def process_start_epoch() -> float:
    """When this process started, in epoch seconds (from /proc, to the
    kernel's clock tick)."""
    with open("/proc/self/stat") as source:
        fields = source.read().rsplit(")", 1)[1].split()
    with open("/proc/stat") as source:
        boot = next(int(line.split()[1]) for line in source if line.startswith("btime "))
    return boot + int(fields[19]) / os.sysconf("SC_CLK_TCK")


def counted_job(report_path: str, argv: list[str], rehearse: bool,
                launch_log: str | None = None, record: bool = False,
                check_batch: bool = False, cuda_engine: bool = False) -> int:
    """Run ``downloader_tpu_torch`` with ``argv`` in this process, the
    job's own, and write what the digest engine and the card did to
    ``report_path`` once ``cli.main`` returns: for ``download-once`` when
    the job ends, for ``serve`` when SIGTERM has made the daemon drain
    and return. The report holds the kernel wrapper's launches split
    into resume, calibration and live flushes, the default engine's
    batch counts, the most ``verify_pieces`` calls in flight at once,
    and the device time by kernel under a CUDA-only profiler. The
    tracer's span cap is raised so that every piece span is kept.
    ``rehearse`` puts a hashlib engine in place of the card (a CPU
    rehearsal).

    With ``launch_log`` (a fleet worker's life, which SIGKILL may end
    before any report is written) every launch is also appended to that
    file as it happens, one JSON line with its step, its job (the media
    id of the torrent whose pieces it verifies), its epoch start and end
    and its device ms by CUDA events, and so is every batch the engine
    sends to hashlib; the CUDA profiler is not started.

    With ``record`` (the analysis phase; ``RECORDERS`` were installed
    before the port was imported) the job runs under the port's
    lock-order and protocol recorders, without the profiler, and
    ``recorded_checks`` runs after it; the report gains its result
    under ``recorded``.

    The report's ``package`` says where this process imported the port
    from, where the kernel library came from (``sha1_cuda.origin``) and
    what its compile took, and whether an nvcc could be found. With
    ``check_batch`` (the packaging phase's archive child) the child also
    loads the native RC4 core and, after the job, launches the kernel
    on one live flush's shape as the ``check`` step; the ``package``
    entry gains both results.

    The port's failpoint registry is armed from ``FAILPOINT_SPEC`` and
    ``FAILPOINT_SEED`` before the job, as ``serve()`` arms it (only the
    tooling phase's torrent cell sets them), and the report's
    ``failpoints`` is its snapshot after the job. With ``cuda_engine``
    (that cell too) the default engine is
    ``DigestEngine(backend="cuda")``: every batch goes to the card, the
    few pieces a dropped connection's flush holds included, which
    ``auto`` would price to hashlib."""
    from contextlib import nullcontext

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from downloader_tpu_torch import cli
    from downloader_tpu_torch.parallel import engine as engine_module
    from downloader_tpu_torch.utils import tracing
    from downloader_tpu_torch.utils.failpoints import FAILPOINTS

    tracing.MAX_SPANS_PER_TRACE = 1 << 20
    FAILPOINTS.configure_from_env()
    if rehearse:
        engine_module._default = DigestEngine(backend="hashlib")
    elif cuda_engine:
        engine_module._default = DigestEngine(backend="cuda")
    if record and RECORDERS is None:
        raise RuntimeError("--record needs the recorders installed before the port's imports")
    counts = {"live": 0, "resume": 0, "calibration": 0, "concurrent": 0, "check": 0,
              "resume_device_batches": 0, "below_min_batch": [0, 0],
              "resumed": [], "verify_window": [float("inf"), float("-inf")]}
    # line-buffered: each line reaches the file as it is written
    log_sink = open(launch_log, "a", buffering=1) if launch_log else None
    # host seconds and calls of the layers under the swarm: the resume,
    # a live flush (verify + store write), the engine's verify in both
    layers = {"resume_existing": [0, 0.0], "piece_batch_flush": [0, 0.0],
              "engine_verify": [0, 0.0]}
    # calls of each layer in flight now and at most (the daemon runs
    # jobs on several threads)
    in_flight = {layer: [0, 0] for layer in layers}
    layers_lock = threading.Lock()

    def timed(cls, method: str, layer: str) -> None:
        inner = getattr(cls, method)

        def wrapper(*args, **kwargs):
            with layers_lock:
                in_flight[layer][0] += 1
                in_flight[layer][1] = max(in_flight[layer])
            start = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                elapsed = time.perf_counter() - start
                with layers_lock:
                    in_flight[layer][0] -= 1
                    layers[layer][0] += 1
                    layers[layer][1] += elapsed

        setattr(cls, method, wrapper)

    timed(_PieceBatch, "flush", "piece_batch_flush")
    timed(DigestEngine, "verify_pieces", "engine_verify")
    timed(PieceStore, "resume_existing", "resume_existing")
    resume_existing = PieceStore.resume_existing
    measure = DigestEngine._measure_calibration
    use_device = DigestEngine._use_device
    verify = DigestEngine.verify_pieces
    launch = sha1_cuda.sha1_batch_cuda
    # the step a thread is in: the daemon runs jobs on several threads, so
    # a launch or a device batch is the resume's (or the calibration's)
    # only if its own thread is inside resume_existing (or the calibration)
    local = threading.local()

    def step() -> str:
        if getattr(local, "calibrating", False):
            return "calibration"
        if getattr(local, "resuming", False):
            return "resume"
        return getattr(local, "step", "live")

    def log_line(**fields) -> None:
        if log_sink is not None:
            with layers_lock:
                log_sink.write(json.dumps(fields) + "\n")

    def job_of(store: PieceStore) -> str:
        # a job's files live under <base dir>/<media id>/
        return os.path.basename(os.path.dirname(store.files[0][0])) if store.files else ""

    def counted_launch(blocks, nblocks):
        if log_sink is None or not blocks.is_cuda:
            states = launch(blocks, nblocks)
            t0 = t1 = kernel_ms = None
        else:
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.time()
            begin.record()
            states = launch(blocks, nblocks)
            end.record()
            # the engine reads the states right after this call anyway
            end.synchronize()
            t1 = time.time()
            kernel_ms = begin.elapsed_time(end)
        with layers_lock:
            counts[step()] += 1
        log_line(step=step(), job=getattr(local, "job", ""), t0=t0, t1=t1, kernel_ms=kernel_ms)
        return states

    def counted_use_device(self, pieces):
        use = use_device(self, pieces)
        if use and step() == "resume":
            with layers_lock:
                counts["resume_device_batches"] += 1
        if use and len(pieces) < self._min_batch:
            # only a forced `cuda` engine sends these to the card: `auto`
            # verifies a batch under its minimum with hashlib
            with layers_lock:
                counts["below_min_batch"][0] += 1
                counts["below_min_batch"][1] += len(pieces)
        if not use:
            log_line(host_batch=len(pieces), job=getattr(local, "job", ""), t=time.time())
        return use

    flush = _PieceBatch.flush

    def tagged_flush(self, *args, **kwargs):
        local.job = job_of(self._swarm.store)
        return flush(self, *args, **kwargs)

    def counted_resume(self, engine=None, *args, **kwargs):
        engine = engine or engine_module.default_engine()
        local.job = job_of(self)
        local.resuming = True
        try:
            resumed = resume_existing(self, engine, *args, **kwargs)
        finally:
            local.resuming = False
        counts["resumed"].append(resumed)
        return resumed

    def counted_calibration(self):
        local.calibrating = True
        try:
            return measure(self)
        finally:
            local.calibrating = False

    def stamped_verify(self, *args, **kwargs):
        # the epoch seconds of the first verify_pieces call and of the
        # end of the last: the daemon's device work lies in between
        with layers_lock:
            counts["verify_window"][0] = min(counts["verify_window"][0], time.time())
        try:
            return verify(self, *args, **kwargs)
        finally:
            with layers_lock:
                counts["verify_window"][1] = max(counts["verify_window"][1], time.time())

    PieceStore.resume_existing = counted_resume
    _PieceBatch.flush = tagged_flush
    DigestEngine._measure_calibration = counted_calibration
    DigestEngine._use_device = counted_use_device
    DigestEngine.verify_pieces = stamped_verify
    # sha1_states looks the wrapper up in its module at each call
    sha1_cuda.sha1_batch_cuda = counted_launch
    sha1_cuda.launches = 0
    log_line(life_start=time.time(), pid=os.getpid(), process_started=process_start_epoch())
    profiled = not rehearse and log_sink is None and not record
    profiler = profile(activities=[ProfilerActivity.CUDA]) if profiled else nullcontext()
    stamps = {"started": time.time()}
    with profiler:
        stamps["job_start"] = time.time()
        start = time.perf_counter()
        code = cli.main(argv)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        stamps["job_end"] = time.time()
    stamps["profiler_stopped"] = time.time()
    recorded = recorded_checks(engine_module.default_engine(), local) if record else None
    package = package_report(local, check_batch, rehearse)
    device = {}
    if profiled:
        for event in profiler.key_averages():
            if event.device_type == DeviceType.CUDA:
                device[event.key] = {
                    "ms": event.self_device_time_total / 1e3,
                    "count": event.count,
                }
    engine = engine_module._default
    total = sha1_cuda.launches
    assert total == sum(
        counts[step] for step in ("live", "resume", "calibration", "concurrent", "check")
    ), (total, counts)
    first, last = counts["verify_window"]
    report = {
        "code": code,
        "wall_s": wall_s,
        "stamps": stamps,
        "verify_window": [first, last] if first <= last else None,
        "launches": total,
        "launches_resume": counts["resume"],
        "launches_calibration": counts["calibration"],
        "launches_live": counts["live"],
        "launches_concurrent": counts["concurrent"],
        "launches_check": counts["check"],
        "resume_device_batches": counts["resume_device_batches"],
        "below_min_batch": dict(zip(("batches", "pieces"), counts["below_min_batch"])),
        "layers_s": {name: {"calls": n, "s": s} for name, (n, s) in layers.items()},
        "max_in_flight": {name: most for name, (_, most) in in_flight.items()},
        "resumed": counts["resumed"],
        "device_batches": engine.device_batches if engine else 0,
        "host_batches": engine.host_batches if engine else 0,
        "backend_name": engine.backend_name if engine else None,
        "device_busy_ms": sum(row["ms"] for row in device.values()),
        "device_by_name": device,
        "kernel_launches_by_name": {
            name: row["count"] for name, row in device.items() if "sha1" in name
        },
        "recorded": recorded,
        "package": package,
        "failpoints": FAILPOINTS.snapshot(),
    }
    with open(report_path, "w") as sink:
        json.dump(report, sink)
    if log_sink is not None:
        log_sink.close()
    return code


def package_report(local: threading.local, check_batch: bool, rehearse: bool) -> dict:
    """Where this process took the port and its native libraries from:
    the package's ``__file__``, the kernel library's path, origin and
    compile seconds, and the nvcc ``sha1_cuda`` would run (None when none
    can be found). With ``check_batch``: the native RC4 core's path
    (None when RC4 runs in pure Python), and one live flush's shape
    (P=32, B=4097) through the kernel wrapper as the ``check`` step,
    held bit-exact against hashlib (a rehearsal runs the plain version
    on 4 KiB pieces)."""
    import downloader_tpu_torch
    from downloader_tpu_torch.fetch import rc4_native

    try:
        nvcc = sha1_cuda._nvcc()
    except RuntimeError:
        nvcc = None
    library = sha1_cuda._library
    report = {
        "file": downloader_tpu_torch.__file__,
        "kernel_library": library._name if library is not None else None,
        "kernel_origin": sha1_cuda.origin,
        "kernel_compile_s": sha1_cuda.compile_s,
        "nvcc": nvcc,
    }
    if not check_batch:
        return report
    native = rc4_native._load()
    report["rc4_native"] = native._name if native is not None else None
    rng = np.random.default_rng(PACKAGING_SEED)
    size = 4096 if rehearse else TORRENT_PIECE
    pieces = [rng.bytes(size) for _ in range(TORRENT_SHAPES[0])]
    raw, counts = pack_bytes(pieces)
    device = torch.device("cpu" if rehearse else "cuda")
    blocks = to_gpu_layout(torch.from_numpy(raw).to(device))
    nblocks = torch.from_numpy(counts).to(device)
    local.step = "check"
    try:
        states = sha1_cuda.sha1_states(blocks, nblocks)
    finally:
        local.step = "live"
    got = digests_to_bytes(states.cpu().numpy(), len(pieces))
    report["check"] = {
        "P": len(pieces),
        "B": blocks.shape[0],
        "equal_hashlib": got == [hashlib.sha1(piece).digest() for piece in pieces],
    }
    return report


def recorded_checks(engine: DigestEngine, local: threading.local) -> dict:
    """The recorded child's checks after its job: ``ANALYSIS_THREADS``
    threads call ``engine.verify_pieces`` at once, each on one live
    flush's shape (32 pieces of 256 KiB, one piece's digest wrong),
    and their launches count as the ``concurrent`` step; then the
    incident recorder captures a bundle. Returns the recorders' view:
    the lock creation sites in the observed edges, the edges, the cycles
    and the leaked protocol obligations (after the guards' 2 s settle
    window), and the bundle's ``locks``."""
    from downloader_tpu_torch.utils import incident

    lock_recorder, protocol_recorder = RECORDERS
    rng = np.random.default_rng(ANALYSIS_SEED)
    batches = []
    for index in range(ANALYSIS_THREADS):
        pieces = [rng.bytes(TORRENT_PIECE) for _ in range(TORRENT_SHAPES[0])]
        expected = [hashlib.sha1(piece).digest() for piece in pieces]
        expected[index] = hashlib.sha1(pieces[index][1:]).digest()
        batches.append((pieces, expected))
    together = threading.Barrier(ANALYSIS_THREADS)
    results: list = [None] * ANALYSIS_THREADS

    def verify(index: int) -> None:
        local.step = "concurrent"
        pieces, expected = batches[index]
        together.wait(timeout=60)
        try:
            results[index] = engine.verify_pieces(pieces, expected)
        except Exception as exc:  # reported below, with the others' results
            results[index] = repr(exc)

    threads = [threading.Thread(target=verify, args=(i,), name=f"verify-{i}")
               for i in range(ANALYSIS_THREADS)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
        assert not thread.is_alive(), f"{thread.name} did not finish"
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for index, got in enumerate(results):
        assert got == [piece != index for piece in range(TORRENT_SHAPES[0])], (index, got)
    bundle = incident.RECORDER.capture("chip smoke analysis phase", trigger="manual")
    deadline = time.monotonic() + 2.0
    while protocol_recorder.leaked() and time.monotonic() < deadline:
        time.sleep(0.05)
    edges = lock_recorder.edges()
    lock_recorder.uninstall()
    protocol_recorder.uninstall()
    return {
        "sites": sorted({site for edge in edges for site in edge}),
        "edges": [{"held": held, "acquired": acquired, "count": count}
                  for (held, acquired), count in sorted(edges.items())],
        "cycles": lock_recorder.cycles(),
        "leaked": protocol_recorder.leaked(),
        "bundle_locks": bundle["locks"],
    }


class _WholeBitfield:
    """A connection that has every piece, for timing the claim pool."""

    bitfield = b""

    def has_piece(self, index: int) -> bool:
        return True

    def queue_have(self, index: int) -> None:
        pass


def claim_pool_s(info: dict, workdir: str, flush_pieces: int) -> float:
    """Host seconds the swarm's claim pool takes to hand one peer every
    piece of ``info``, completing them ``flush_pieces`` at a time as the
    live flushes do: the claims alone, no network and no hashing."""
    from downloader_tpu_torch.fetch.swarmstate import _SwarmState

    swarm = _SwarmState(PieceStore(info, workdir), lambda percent: None, 1.0)
    conn = _WholeBitfield()
    swarm.register(conn)
    store, pending = swarm.store, []
    start = time.perf_counter()
    while (index := swarm.claim(conn)) is not None:
        pending.append(index)
        if len(pending) == flush_pieces:
            for done in pending:
                store.have[done] = True
            pending = []
    elapsed = time.perf_counter() - start
    assert len(pending) + sum(store.have) == store.num_pieces, "claims lost pieces"
    return elapsed


def _torrent_job(magnet: str, base_dir: str, env: dict, rehearse: bool,
                 record: bool = False, script: str | None = None,
                 check_batch: bool = False, cuda_engine: bool = False) -> dict:
    """One ``download-once`` of the magnet in a child interpreter under
    ``counted_job`` (``record``: under the port's recorders;
    ``check_batch``: with the kernel batch check after the job;
    ``cuda_engine``: every batch on the card), run as
    ``script`` (a copy of this file; this file by default): (exit code,
    stdout, stderr, wall seconds, report, span ms by name)."""
    report_path = os.path.join(base_dir, "report.json")
    trace_out = os.path.join(base_dir, "trace.json")
    command = [
        sys.executable, script or os.path.abspath(__file__), "--counted-job", report_path,
        *(["--rehearse"] if rehearse else []), *(["--record"] if record else []),
        *(["--check-batch"] if check_batch else []),
        *(["--cuda-engine"] if cuda_engine else []), "--",
        "--trace-out", trace_out, "download-once", "--id", "episode-1",
        "--url", magnet, "--base-dir", base_dir,
    ]
    launched = time.time()
    start = time.perf_counter()
    done = subprocess.run(
        command, env=env, cwd=base_dir, capture_output=True, text=True,
        timeout=TORRENT_JOB_TIMEOUT_S,
    )
    wall = time.perf_counter() - start
    ended = time.time()
    assert done.returncode == 0, f"torrent job exited {done.returncode}: {done.stderr[-3000:]}"
    with open(report_path) as source:
        report = json.load(source)
    stamps = report.pop("stamps")
    # where the child's wall went, on the host clock: interpreter start
    # and imports, the profiler's start, the job, its stop, the exit
    report["process_s"] = {
        "start": stamps["started"] - launched,
        "profiler_start": stamps["job_start"] - stamps["started"],
        "job": stamps["job_end"] - stamps["job_start"],
        "profiler_stop": stamps["profiler_stopped"] - stamps["job_end"],
        "exit": ended - stamps["profiler_stopped"],
    }
    with open(trace_out) as trace:
        events = json.load(trace)["traceEvents"]
    spans = [event for event in events if event.get("ph") == "X"]
    # every span name's count and summed ms (spans of one name may
    # overlap: piece spans of concurrent workers)
    by_name: dict = {}
    for event in spans:
        count, ms = by_name.get(event["name"], (0, 0.0))
        by_name[event["name"]] = (count + 1, ms + event["dur"] / 1e3)
    spans_ms = {name: by_name.get(name, (0, 0.0))[1] for name in TORRENT_SPANS}
    job_status = [e for e in spans if e["name"] == "job"][0]["args"]["status"]
    assert job_status == "ok", job_status
    return {
        "stdout": done.stdout, "stderr": done.stderr, "wall_s": wall,
        "report": report, "spans_ms": spans_ms,
        "spans_by_name": {name: {"count": c, "ms": ms} for name, (c, ms) in by_name.items()},
    }


def phase_torrent(payload: bytes, workdir: str, card: str, rehearse: bool = False) -> dict:
    """The torrent engine end to end: the port's ``Seeder`` in this
    process serves the episode as a 256 KiB-piece torrent; ``python3 -m
    downloader_tpu_torch download-once`` of its magnet runs in a child
    process (its own GIL) into a fresh S3 stub, once from nothing and
    once with the first half of the file already in the job directory.
    The child counts the kernel's launches in its own process; each run
    must launch it on the live path, the resume run on the resume too,
    and the profiler must see every launch the wrapper counted.
    ``rehearse`` runs it on a host without a card (hashlib engines)."""
    from downloader_tpu_torch.fetch.seeder import Seeder
    from downloader_tpu_torch.parallel import engine as engine_module

    phase_start = time.perf_counter()
    num_pieces = len(payload) // TORRENT_PIECE
    half = num_pieces // 2
    want_sha256 = hashlib.sha256(payload).hexdigest()
    key = f"episode-1/original/{base64.b64encode(JOB_NAME.encode()).decode()}"
    # the magnet carries the tracker; the card's machine has no network
    env = child_env(
        S3_ACCESS_KEY="smoke-ak", S3_SECRET_KEY="smoke-sk", DHT_BOOTSTRAP="off", LSD="off",
    )
    credentials = Credentials(access_key="smoke-ak", secret_key="smoke-sk")
    if rehearse:
        engine_module._default = DigestEngine(backend="hashlib")
    else:
        # the default engine's calibration launches stay out of the count
        engine_module.default_engine()._calibrate()
        torch.cuda.synchronize()
    sha1_cuda.launches = 0
    start = time.perf_counter()
    seeder = Seeder(JOB_NAME, payload, piece_length=TORRENT_PIECE)
    seed_s = time.perf_counter() - start
    seed_launches = sha1_cuda.launches
    table = b"".join(
        hashlib.sha1(payload[i : i + TORRENT_PIECE]).digest()
        for i in range(0, len(payload), TORRENT_PIECE)
    )
    assert seeder.info[b"pieces"] == table, "seeder's piece table != hashlib"
    claims_s = claim_pool_s(seeder.info, workdir, TORRENT_SHAPES[0])
    runs = []
    try:
        seeder.start()
        for kind in ("full", "resume"):
            base_dir = os.path.join(workdir, f"torrent-{len(runs)}")
            os.makedirs(os.path.join(base_dir, "episode-1"))
            if kind == "resume":
                with open(os.path.join(base_dir, "episode-1", JOB_NAME), "wb") as sink:
                    sink.write(payload[: half * TORRENT_PIECE])
            seeder.served_requests.clear()
            with S3Stub(credentials=credentials) as stub:
                env["S3_ENDPOINT"] = f"http://{stub.endpoint}"
                job = _torrent_job(seeder.magnet_uri, base_dir, env, rehearse)
                objects = {
                    (bucket, name): data
                    for bucket, stored in stub.buckets.items()
                    for name, data in stored.items()
                }
                dangling = stub.list_multipart_uploads()
            assert job["stdout"].splitlines() == [
                os.path.join(base_dir, "episode-1", JOB_NAME)
            ], job["stdout"]
            assert list(objects) == [("triton-staging", key)], list(objects)
            got_sha256 = hashlib.sha256(objects["triton-staging", key]).hexdigest()
            assert got_sha256 == want_sha256, f"{kind}: stored object != payload"
            assert dangling == [], dangling
            del objects
            report = job["report"]
            fetched = sorted(set(seeder.served_requests))
            if kind == "resume":
                assert report["resumed"] == [half], report["resumed"]
                assert f"resumed={half}" in job["stderr"], "no resume log line"
                assert fetched == list(range(half, num_pieces)), "resume refetched"
            else:
                assert report["resumed"] == [0], report["resumed"]
                assert fetched == list(range(num_pieces)), "pieces not fetched"
            if not rehearse:
                seen = sum(report["kernel_launches_by_name"].values())
                assert seen == report["launches"], (seen, report["launches"])
                assert report["launches_live"] > 0, f"{kind}: no live launch"
                assert report["launches_live"] == (
                    report["device_batches"] - report["resume_device_batches"]
                ), report
                if kind == "resume":
                    assert report["launches_resume"] > 0, "no resume launch"
                    assert report["launches_resume"] == report["resume_device_batches"]
            moved = len(payload) - (half * TORRENT_PIECE if kind == "resume" else 0)
            runs.append({
                "kind": kind,
                "wall_s": job["wall_s"],
                "job_wall_s": report["wall_s"],
                "MBps": len(payload) / job["wall_s"] / 1e6,
                "MBps_fetched": moved / job["wall_s"] / 1e6,
                "process_s": report["process_s"],
                "spans_ms": job["spans_ms"],
                "spans_by_name": job["spans_by_name"],
                "layers_s": report["layers_s"],
                "device_busy_ms": report["device_busy_ms"],
                "device_idle_share": 1 - report["device_busy_ms"] / (report["wall_s"] * 1e3),
                **{k: report[k] for k in (
                    "launches", "launches_live", "launches_resume", "launches_calibration",
                    "device_batches", "host_batches", "backend_name",
                    "kernel_launches_by_name", "device_by_name",
                )},
            })
            shutil.rmtree(base_dir)
    finally:
        seeder.stop()
    full, resume = runs
    steps = {
        "torrent_seed": seed_launches,
        "torrent_live": sum(run["launches_live"] for run in runs),
        "torrent_resume": resume["launches_resume"],
        "torrent_calibration": sum(run["launches_calibration"] for run in runs),
    }
    if not rehearse:
        assert steps["torrent_live"] > 0 and steps["torrent_resume"] > 0, steps
    fields = dict(
        clock="host wall clock on the card's machine; device time from the job's profiler",
        seconds=time.perf_counter() - phase_start,
        payload_bytes=len(payload),
        piece_length=TORRENT_PIECE,
        pieces=num_pieces,
        seed_make_torrent_s=seed_s,
        claim_pool_s=claims_s,
        runs=runs,
        full_wall_s=full["wall_s"],
        full_MBps=full["MBps"],
        resume_wall_s=resume["wall_s"],
        resume_MBps_fetched=resume["MBps_fetched"],
        resumed_pieces=half,
        launches=sum(steps.values()),
        launches_by_step=steps,
        object_sha256_equal_payload=True,
        host_cpus=os.cpu_count(),
        card=card,
    )
    emit("torrent", **fields)
    return fields


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=30) as answer:
            return answer.status, answer.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, ""
    except OSError:
        return 0, ""


def _percentile(values: list[float], share: float) -> float:
    return float(np.percentile(np.array(values), share))


def phase_daemon(payload: bytes, second: bytes, clips: dict, workdir: str, card: str,
                 rehearse: bool = False) -> dict:
    """``python3 -m downloader_tpu_torch serve`` with its default
    configuration in a child process (``counted_job``), fed over AMQP by
    this process, which runs the port's ``AmqpServerStub``, an
    ``S3Stub``, two ``Seeder``s (the episode, and a second torrent of
    ``second``; 256 KiB pieces) and a HEAD/Range origin with the
    ``clips``. The traffic: the two magnet jobs, the second as soon as
    the first fetches pieces, so the daemon's two workers run them at
    once and their flushes share the card; then every clip as one burst,
    which the batched lane takes. Every Convert must arrive on the
    ``v1.convert`` shards with its job's media id, every stored object
    must equal its payload by SHA-256, no multipart upload may be left
    open, ``/metrics`` must count the jobs and the batched lane, and
    SIGTERM must end the worker with exit 0. The worker's kernel
    launches are split into live flushes and calibration and held
    against its engine's device batches and its profiler's count.
    ``rehearse`` runs it on a host without a card (hashlib engines)."""
    from downloader_tpu_torch.fetch.seeder import Seeder
    from downloader_tpu_torch.parallel import engine as engine_module
    from downloader_tpu_torch.queue.amqp import AmqpConnection
    from downloader_tpu_torch.queue.amqp_server import AmqpServerStub
    from downloader_tpu_torch.wire import Convert, Download, Media

    phase_start = time.perf_counter()
    if rehearse:
        engine_module._default = DigestEngine(backend="hashlib")
    episodes = {"episode-1": (JOB_NAME, payload), "episode-2": (DAEMON_SECOND_NAME, second)}
    clip_dir = os.path.join(workdir, "clips")
    os.makedirs(clip_dir)
    for name, data in clips.items():
        with open(os.path.join(clip_dir, name), "wb") as sink:
            sink.write(data)
    want = {  # object key -> SHA-256 of its payload
        f"{media_id}/original/{base64.b64encode(name.encode()).decode()}":
            hashlib.sha256(data).hexdigest()
        for media_id, (name, data) in episodes.items()
    }
    clip_ids = {f"clip-{index:02d}": name for index, name in enumerate(sorted(clips))}
    for media_id, name in clip_ids.items():
        key = f"{media_id}/original/{base64.b64encode(name.encode()).decode()}"
        want[key] = hashlib.sha256(clips[name]).hexdigest()

    sha1_cuda.launches = 0
    start = time.perf_counter()
    seeders = {media_id: Seeder(name, data, piece_length=TORRENT_PIECE)
               for media_id, (name, data) in episodes.items()}
    seed_s = time.perf_counter() - start
    seed_launches = sha1_cuda.launches
    handler = type("Clips", (_OriginHandler,), {"root": clip_dir})
    origin = _OriginServer(("127.0.0.1", 0), handler)
    serving = threading.Thread(target=origin.serve_forever, daemon=True)
    serving.start()
    origin_url = f"http://127.0.0.1:{origin.server_address[1]}"
    health_port = _free_port()
    base_dir = os.path.join(workdir, "daemon")
    os.makedirs(base_dir)
    report_path = os.path.join(workdir, "daemon-report.json")
    credentials = Credentials(access_key="smoke-ak", secret_key="smoke-sk")
    arrived: dict = {}  # media id -> perf_counter when its Convert arrived
    published: dict = {}
    worker = None
    with AmqpServerStub(username="smoke", password="smoke-pw") as amqp, \
            S3Stub(credentials=credentials) as stub:
        try:
            for seeder in seeders.values():
                seeder.start()
            env = child_env(
                BROKER="amqp", RABBITMQ_ENDPOINT=amqp.endpoint,
                RABBITMQ_USERNAME="smoke", RABBITMQ_PASSWORD="smoke-pw",
                S3_ENDPOINT=f"http://{stub.endpoint}", S3_ACCESS_KEY="smoke-ak",
                S3_SECRET_KEY="smoke-sk", DHT_BOOTSTRAP="off", LSD="off",
                HEALTH_PORT=str(health_port), JOB_CONCURRENCY="2",
            )
            # the Convert shards, declared here as the daemon's publisher
            # declares them, and read straight off the stub's broker
            sink = amqp.broker.connect().channel()
            sink.declare_exchange("v1.convert")

            def on_convert(message) -> None:
                media_id = Convert.unmarshal(message.body).media.id
                arrived.setdefault(media_id, time.perf_counter())
                sink.ack(message.delivery_tag)

            for shard in (0, 1):
                sink.declare_queue(f"v1.convert-{shard}")
                sink.bind_queue(f"v1.convert-{shard}", "v1.convert", f"v1.convert-{shard}")
                sink.consume(f"v1.convert-{shard}", on_convert)

            command = [
                sys.executable, os.path.abspath(__file__), "--counted-job", report_path,
                *(["--rehearse"] if rehearse else []), "--", "serve", "--base-dir", base_dir,
            ]
            with open(os.path.join(workdir, "daemon.err"), "wb") as errors:
                worker = subprocess.Popen(command, env=env, cwd=base_dir,
                                          stdout=subprocess.DEVNULL, stderr=errors)
            health = f"http://127.0.0.1:{health_port}"
            deadline = time.monotonic() + 180
            while _get(health + "/readyz")[0] != 200:
                assert worker.poll() is None, f"worker exited {worker.returncode}"
                assert time.monotonic() < deadline, "worker never became ready"
                time.sleep(0.2)
            ready_s = time.perf_counter() - phase_start

            producer = AmqpConnection.dial(amqp.endpoint, username="smoke", password="smoke-pw")
            channel = producer.channel()
            sent = 0

            def publish(media_id: str, url: str) -> None:
                nonlocal sent
                body = Download(media=Media(id=media_id, source_uri=url)).marshal()
                published[media_id] = time.perf_counter()
                channel.publish("v1.download", f"v1.download-{sent % 2}", body)
                sent += 1

            def wait(ids, limit_s: float) -> None:
                deadline = time.monotonic() + limit_s
                while not all(media_id in arrived for media_id in ids):
                    assert worker.poll() is None, f"worker exited {worker.returncode}"
                    assert time.monotonic() < deadline, (
                        f"no Convert for {sorted(set(ids) - set(arrived))}")
                    time.sleep(0.05)

            torrent_start = time.perf_counter()
            torrent_start_epoch = time.time()
            first, later = list(seeders)
            publish(first, seeders[first].magnet_uri)
            deadline = time.monotonic() + 120
            while not seeders[first].served_requests:
                assert time.monotonic() < deadline, "first torrent job never fetched"
                time.sleep(0.01)
            publish(later, seeders[later].magnet_uri)
            wait(episodes, DAEMON_WAIT_S)
            torrent_s = max(arrived[m] for m in episodes) - torrent_start
            torrent_end_epoch = torrent_start_epoch + torrent_s

            burst_start = time.perf_counter()
            for media_id, name in clip_ids.items():
                publish(media_id, f"{origin_url}/{name}")
            wait(clip_ids, 300)
            burst_s = max(arrived[m] for m in clip_ids) - burst_start
            producer.close()

            # a job's Convert is confirmed before its delivery is acked and
            # counted: read /metrics until every job is counted
            deadline = time.monotonic() + 60
            while True:
                status, exposition = _get(health + "/metrics")
                assert status == 200, status
                samples = dict(
                    line.rsplit(" ", 1) for line in exposition.splitlines()
                    if line.startswith("downloader_") and " " in line and "{" not in line
                )
                processed = float(samples.get("downloader_jobs_processed", 0))
                fast = float(samples.get("downloader_batch_fast_jobs", 0))
                if processed >= len(want) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            assert processed >= len(want), f"/metrics counts {processed} jobs"
            assert fast > 0, "the burst never took the batched lane"

            sigterm = time.time()
            worker.send_signal(signal.SIGTERM)
            code = worker.wait(timeout=180)
            exit_s = time.time() - sigterm
            assert code == 0, f"worker exited {code} after SIGTERM"
            stored = {
                key: hashlib.sha256(data).hexdigest()
                for key, data in stub.buckets.get("triton-staging", {}).items()
                # the canary plane's own probes, if one ran, are not jobs
                if not key.startswith("canary-")
            }
            dangling = stub.list_multipart_uploads()
        finally:
            if worker is not None and worker.poll() is None:
                worker.kill()
                worker.wait(60)
            for seeder in seeders.values():
                seeder.stop()
            origin.shutdown()
            origin.server_close()
            serving.join(timeout=60)
    assert sorted(stored) == sorted(want), sorted(set(want) ^ set(stored))
    for key, digest in want.items():
        assert stored[key] == digest, f"{key}: stored object != payload"
    assert dangling == [], dangling
    for media_id in episodes:
        fetched = sorted(set(seeders[media_id].served_requests))
        assert fetched == list(range(len(episodes[media_id][1]) // TORRENT_PIECE)), media_id
    with open(report_path) as source:
        report = json.load(source)
    steps = {
        "daemon_seed": seed_launches,
        "daemon_live": report["launches_live"],
        "daemon_calibration": report["launches_calibration"],
    }
    expected_steps = {
        "daemon_seed": len(episodes),
        # one launch per 8 MiB _PieceBatch flush, every one on the card
        "daemon_live": sum(len(d) for _, d in episodes.values()) // (8 << 20),
        "daemon_calibration": 3,  # one engine in the worker
    }
    assert report["launches_resume"] == 0, report["launches_resume"]
    # every verify_pieces call of the worker, and so all its device work
    # (the worker touches the card nowhere else), lies in the torrent
    # window: the busy time below is the window's
    window = report["verify_window"]
    assert window is not None, "the worker never verified a piece"
    assert torrent_start_epoch <= window[0] and window[1] <= torrent_end_epoch, (
        window, torrent_start_epoch, torrent_end_epoch)
    if not rehearse:
        seen = sum(report["kernel_launches_by_name"].values())
        assert seen == report["launches"], (seen, report["launches"])
        assert report["launches_live"] == report["device_batches"], report
        assert report["host_batches"] == 0, report["host_batches"]
        assert steps == expected_steps, (steps, expected_steps)
    latencies = [arrived[m] - published[m] for m in clip_ids]
    stamps = report["stamps"]
    fields = dict(
        clock="host wall clock on the card's machine; device time from the worker's profiler",
        seconds=time.perf_counter() - phase_start,
        worker_ready_s=ready_s,
        seed_make_torrent_s=seed_s,
        torrent_jobs={
            media_id: {
                "bytes": len(data), "pieces": len(data) // TORRENT_PIECE,
                "publish_to_convert_s": arrived[media_id] - published[media_id],
            }
            for media_id, (_, data) in episodes.items()
        },
        torrent_window_s=torrent_s,
        device_busy_ms=report["device_busy_ms"],
        device_idle_share_torrent_window=1 - report["device_busy_ms"] / (torrent_s * 1e3),
        small_jobs=len(clip_ids),
        small_bytes=sum(len(data) for data in clips.values()),
        small_publish_to_convert_s_p50=_percentile(latencies, 50),
        small_publish_to_convert_s_p99=_percentile(latencies, 99),
        small_jobs_per_s=len(clip_ids) / burst_s,
        metrics_jobs_processed=processed,
        metrics_batch_fast_jobs=fast,
        sigterm_to_serve_return_s=stamps["job_end"] - sigterm,
        sigterm_to_exit_s=exit_s,
        launches=sum(steps.values()),
        launches_by_step=steps,
        expected_launches_by_step=expected_steps,
        **{k: report[k] for k in (
            "device_batches", "host_batches", "backend_name", "max_in_flight",
            "kernel_launches_by_name", "device_by_name", "layers_s",
        )},
        object_sha256_equal_payload=True,
        card=card,
    )
    emit("daemon", **fields)
    return fields


class _CountingOriginHandler(_OriginHandler):
    """The clip origin of the fleet phase: counts each path's GETs."""

    gets: Counter = Counter()
    lock = threading.Lock()

    def do_GET(self) -> None:
        with self.lock:
            self.gets[os.path.basename(self.path)] += 1
        super().do_GET()


def fleet_supervisor(life_dir: str, argv: list[str], rehearse: bool) -> int:
    """The fleet phase's supervisor: ``cli.main(argv)`` (``serve
    --workers N``) in this process, with each worker life started as
    ``chip_smoke.py --counted-job`` through the supervisor's worker
    command, so that every life logs its kernel launches to
    ``life_dir/<instance>.<life>.log`` as they happen. The port counts
    launches only in the worker's memory, which SIGKILL takes with it,
    so the entry point alone cannot report a killed life's launches."""
    from downloader_tpu_torch import cli
    from downloader_tpu_torch.daemon import fleet

    lives: Counter = Counter()

    def worker_argv(slot) -> list[str]:
        lives[slot.instance] += 1
        life = os.path.join(life_dir, f"{slot.instance}.{lives[slot.instance]}")
        return [
            sys.executable, os.path.abspath(__file__), "--counted-job", life + ".json",
            "--launch-log", life + ".log", *(["--rehearse"] if rehearse else []),
            "--", "serve",
        ]

    fleet.FleetSupervisor._default_argv = staticmethod(worker_argv)
    return cli.main(argv)


def _get_json(url: str):
    status, body = _get(url)
    return json.loads(body) if status == 200 else None


def _fleet_lives(life_dir: str) -> dict:
    """Each worker life's launch log (and report, when the life ended
    by SIGTERM): launches by step and by job, device ms, host batches."""
    lives = {}
    for name in sorted(os.listdir(life_dir)):
        if not name.endswith(".log"):
            continue
        life = name[: -len(".log")]
        entry = {"instance": life.rsplit(".", 1)[0], "launches": Counter(), "by_job": {},
                 "kernel_ms": 0.0, "host_batches": 0, "intervals": []}
        with open(os.path.join(life_dir, name)) as source:
            for line in source:
                row = json.loads(line)
                if "life_start" in row:
                    entry.update(pid=row["pid"], process_started=row["process_started"],
                                 wrapper_ready_s=row["life_start"] - row["process_started"])
                elif "host_batch" in row:
                    entry["host_batches"] += 1
                else:
                    entry["launches"][row["step"]] += 1
                    job = entry["by_job"].setdefault(row["job"], Counter())
                    job[row["step"]] += 1
                    if row["kernel_ms"] is not None:
                        entry["kernel_ms"] += row["kernel_ms"]
                        entry["intervals"].append((row["t0"], row["t1"], row["kernel_ms"]))
        report_path = os.path.join(life_dir, life + ".json")
        entry["report"] = None
        if os.path.exists(report_path):
            with open(report_path) as source:
                entry["report"] = json.load(source)
        lives[life] = entry
    return lives


def _overlapping_launches(lives: dict) -> int:
    """Launches whose wall interval overlaps a launch of another life:
    two processes on the card at once."""
    spans = [(t0, t1, life) for life, entry in lives.items() for t0, t1, _ in entry["intervals"]]
    spans.sort()
    overlapping = set()
    for i, (t0, t1, life) in enumerate(spans):
        for u0, u1, other in spans[i + 1:]:
            if u0 >= t1:
                break
            if other != life:
                overlapping.update({(t0, t1, life), (u0, u1, other)})
    return len(overlapping)


def _interleaved_launches(lives: dict) -> int:
    """Launches that start between the first and the last launch of a
    life of another process: two processes launching on the card in the
    same stretch of time, their kernels time-sliced."""
    spans = {life: (min(t0 for t0, _, _ in entry["intervals"]),
                    max(t1 for _, t1, _ in entry["intervals"]))
             for life, entry in lives.items() if entry["intervals"]}
    return sum(
        1 for life, entry in lives.items() for t0, _, _ in entry["intervals"]
        if any(other != life and lo <= t0 <= hi for other, (lo, hi) in spans.items())
    )


def phase_fleet(payload: bytes, second: bytes, clips: dict, workdir: str, card: str,
                rehearse: bool = False) -> dict:
    """``python3 -m downloader_tpu_torch serve --workers 2`` (through
    ``fleet_supervisor``) with ``CACHE_DIR`` set and every other knob at
    its default, fed over AMQP by this process, which runs the port's
    ``AmqpServerStub``, an ``S3Stub``, two ``Seeder``s (the episode and
    ``second``, 256 KiB pieces) and an origin for the ``clips`` that
    counts its GETs. The stream: the episode's magnet; once it fetches,
    every clip twice by URL (the second copy is served by the data
    plane: a cache hit or a coalesced follower); then the second
    torrent's magnet. Once a third of the second torrent's pieces were
    served, the worker holding it is SIGKILLed: the broker redelivers
    the job, the supervisor restarts the worker. Every Convert must name
    its job's media id, every stored object must equal its payload by
    SHA-256, no multipart upload may stay open, the supervisor must
    count a restart, and SIGTERM must drain the fleet with exit 0. The
    workers' kernel launches are counted per life, by step and job,
    from their launch logs, and no batch may go to hashlib.
    ``rehearse`` runs it on a host without a card (hashlib engines)."""
    from downloader_tpu_torch.fetch.seeder import Seeder
    from downloader_tpu_torch.parallel import engine as engine_module
    from downloader_tpu_torch.queue.amqp import AmqpConnection
    from downloader_tpu_torch.queue.amqp_server import AmqpServerStub
    from downloader_tpu_torch.wire import Convert, Download, Media

    phase_start = time.perf_counter()
    if rehearse:
        engine_module._default = DigestEngine(backend="hashlib")
    else:
        # the seeders' engine calibrates before the count starts
        engine_module.default_engine()._calibrate()
        torch.cuda.synchronize()
    episodes = {"episode-1": (JOB_NAME, payload), "episode-2": (DAEMON_SECOND_NAME, second)}
    clip_dir = os.path.join(workdir, "fleet-clips")
    os.makedirs(clip_dir)
    for name, data in clips.items():
        with open(os.path.join(clip_dir, name), "wb") as sink:
            sink.write(data)
    want = {  # object key -> SHA-256 of its payload
        f"{media_id}/original/{base64.b64encode(name.encode()).decode()}":
            hashlib.sha256(data).hexdigest()
        for media_id, (name, data) in episodes.items()
    }
    clip_ids = {}  # media id -> clip name: every clip twice
    for copy in ("a", "b"):
        for index, name in enumerate(sorted(clips)):
            clip_ids[f"clip-{index:02d}{copy}"] = name
    for media_id, name in clip_ids.items():
        key = f"{media_id}/original/{base64.b64encode(name.encode()).decode()}"
        want[key] = hashlib.sha256(clips[name]).hexdigest()

    sha1_cuda.launches = 0
    # the rehearsal's loopback swarm would finish the second torrent
    # before the kill: its seeder waits a little per block there
    seeders = {
        media_id: Seeder(name, data, piece_length=TORRENT_PIECE,
                         serve_delay=0.002 if rehearse and media_id == "episode-2" else 0.0)
        for media_id, (name, data) in episodes.items()
    }
    seed_launches = sha1_cuda.launches
    handler = type("FleetClips", (_CountingOriginHandler,),
                   {"root": clip_dir, "gets": Counter(), "lock": threading.Lock()})
    origin = _OriginServer(("127.0.0.1", 0), handler)
    serving = threading.Thread(target=origin.serve_forever, daemon=True)
    serving.start()
    origin_url = f"http://127.0.0.1:{origin.server_address[1]}"
    fleet_port = _free_port()
    base_dir = os.path.join(workdir, "fleet")
    life_dir = os.path.join(workdir, "fleet-lives")
    os.makedirs(base_dir)
    os.makedirs(life_dir)
    credentials = Credentials(access_key="smoke-ak", secret_key="smoke-sk")
    arrived: dict = {}  # media id -> perf_counter when its Convert arrived
    converts: Counter = Counter()  # media id -> Converts published
    published: dict = {}
    supervisor = None
    fleet = f"http://127.0.0.1:{fleet_port}"
    with AmqpServerStub(username="smoke", password="smoke-pw") as amqp, \
            S3Stub(credentials=credentials) as stub:
        try:
            for seeder in seeders.values():
                seeder.start()
            env = child_env(
                BROKER="amqp", RABBITMQ_ENDPOINT=amqp.endpoint,
                RABBITMQ_USERNAME="smoke", RABBITMQ_PASSWORD="smoke-pw",
                S3_ENDPOINT=f"http://{stub.endpoint}", S3_ACCESS_KEY="smoke-ak",
                S3_SECRET_KEY="smoke-sk", DHT_BOOTSTRAP="off", LSD="off",
                HEALTH_PORT=str(fleet_port), CACHE_DIR=os.path.join(workdir, "fleet-cache"),
            )
            sink = amqp.broker.connect().channel()
            sink.declare_exchange("v1.convert")

            def on_convert(message) -> None:
                media_id = Convert.unmarshal(message.body).media.id
                arrived.setdefault(media_id, time.perf_counter())
                converts[media_id] += 1
                sink.ack(message.delivery_tag)

            for shard in (0, 1):
                sink.declare_queue(f"v1.convert-{shard}")
                sink.bind_queue(f"v1.convert-{shard}", "v1.convert", f"v1.convert-{shard}")
                sink.consume(f"v1.convert-{shard}", on_convert)

            command = [
                sys.executable, os.path.abspath(__file__), "--fleet-supervisor", life_dir,
                *(["--rehearse"] if rehearse else []), "--",
                "serve", "--workers", str(FLEET_WORKERS), "--base-dir", base_dir,
            ]
            with open(os.path.join(workdir, "fleet.err"), "wb") as errors:
                supervisor = subprocess.Popen(command, env=env, cwd=base_dir,
                                              stdout=subprocess.DEVNULL, stderr=errors)
            deadline = time.monotonic() + 180
            while _get(fleet + "/readyz")[0] != 200:
                assert supervisor.poll() is None, f"supervisor exited {supervisor.returncode}"
                assert time.monotonic() < deadline, "the fleet never became ready"
                time.sleep(0.2)
            ready_s = time.perf_counter() - phase_start

            producer = AmqpConnection.dial(amqp.endpoint, username="smoke", password="smoke-pw")
            channel = producer.channel()
            sent = 0

            def publish(media_id: str, url: str) -> None:
                nonlocal sent
                body = Download(media=Media(id=media_id, source_uri=url)).marshal()
                published[media_id] = time.perf_counter()
                channel.publish("v1.download", f"v1.download-{sent % 2}", body)
                sent += 1

            def wait(ids, limit_s: float) -> None:
                deadline = time.monotonic() + limit_s
                while not all(media_id in arrived for media_id in ids):
                    assert supervisor.poll() is None, f"supervisor exited {supervisor.returncode}"
                    assert time.monotonic() < deadline, (
                        f"no Convert for {sorted(set(ids) - set(arrived))}")
                    time.sleep(0.05)

            def slots() -> list:
                snap = _get_json(fleet + "/healthz")
                return snap["slots"] if snap else []

            torrent_start = time.perf_counter()
            torrent_start_epoch = time.time()
            publish("episode-1", seeders["episode-1"].magnet_uri)
            deadline = time.monotonic() + 120
            while not seeders["episode-1"].served_requests:
                assert time.monotonic() < deadline, "the episode never fetched"
                time.sleep(0.01)
            burst_start = time.perf_counter()
            for media_id, name in clip_ids.items():
                publish(media_id, f"{origin_url}/{name}")
            publish("episode-2", seeders["episode-2"].magnet_uri)

            # the worker holding the second torrent, once a third of its
            # pieces were served
            second_pieces = len(second) // TORRENT_PIECE
            deadline = time.monotonic() + 300
            victim = None
            while victim is None or len(set(seeders["episode-2"].served_requests)) < (
                    second_pieces * FLEET_KILL_SHARE):
                assert "episode-2" not in arrived, "the second torrent finished before the kill"
                assert time.monotonic() < deadline, "the second torrent never got going"
                if victim is None:
                    for slot in slots():
                        jobs = _get_json(f"http://127.0.0.1:{slot['health_port']}/debug/jobs")
                        held = {t.get("job_id") for t in (jobs or {}).get("in_flight", [])}
                        if "episode-2" in held:
                            victim = slot
                time.sleep(0.01)
            served_at_kill = len(set(seeders["episode-2"].served_requests))
            killed = time.perf_counter()
            os.kill(victim["pid"], signal.SIGKILL)

            def restarted() -> dict | None:
                for slot in slots():
                    if slot["instance"] == victim["instance"] and slot["pid"] not in (
                            None, victim["pid"]) and slot["ready"]:
                        return slot
                return None

            deadline = time.monotonic() + 180
            while (heir := restarted()) is None:
                assert time.monotonic() < deadline, "the killed worker never came back"
                time.sleep(0.1)
            restart_heartbeat_s = time.perf_counter() - killed
            while _get(f"http://127.0.0.1:{heir['health_port']}/readyz")[0] != 200:
                assert time.monotonic() < deadline, "the restarted worker never got ready"
                time.sleep(0.1)
            restart_ready_s = time.perf_counter() - killed

            wait(episodes, DAEMON_WAIT_S)
            torrent_s = max(arrived[m] for m in episodes) - torrent_start
            torrent_end_epoch = torrent_start_epoch + torrent_s
            wait(clip_ids, 300)
            burst_s = max(arrived[m] for m in clip_ids) - burst_start
            producer.close()

            flows = _get_json(fleet + "/debug/flows")
            cache = _get_json(fleet + "/debug/cache")
            status, exposition = _get(fleet + "/metrics")
            assert status == 200, status
            restarts = sum(
                float(line.rsplit(" ", 1)[1]) for line in exposition.splitlines()
                if line.startswith("downloader_fleet_worker_restarts ")
            )
            sigterm = time.time()
            supervisor.send_signal(signal.SIGTERM)
            code = supervisor.wait(timeout=180)
            exit_s = time.time() - sigterm
            assert code == 0, f"supervisor exited {code} after SIGTERM"
            stored = {
                key: hashlib.sha256(data).hexdigest()
                for key, data in stub.buckets.get("triton-staging", {}).items()
                if not key.startswith("canary-")
            }
            dangling = stub.list_multipart_uploads()
        finally:
            if supervisor is not None and supervisor.poll() is None:
                supervisor.kill()
                supervisor.wait(60)
            for seeder in seeders.values():
                seeder.stop()
            origin.shutdown()
            origin.server_close()
            serving.join(timeout=60)
    assert sorted(converts) == sorted(published), sorted(set(published) ^ set(converts))
    assert sorted(stored) == sorted(want), sorted(set(want) ^ set(stored))
    for key, digest in want.items():
        assert stored[key] == digest, f"{key}: stored object != payload"
    assert dangling == [], dangling
    assert restarts >= 1, restarts

    lives = _fleet_lives(life_dir)
    host_batches = sum(entry["host_batches"] for entry in lives.values())
    by_job = {media_id: Counter() for media_id in episodes}
    for entry in lives.values():
        for job, steps in entry["by_job"].items():
            if job in by_job:
                by_job[job].update({k: v for k, v in steps.items() if k != "calibration"})
    expected = {
        "fleet_seed": len(episodes),
        "episode-1": {"live": FLEET_EPISODE_LIVE, "resume": 0},
        "episode-2": {"live": list(FLEET_SECOND_LIVE), "resume": list(FLEET_SECOND_RESUME)},
        "calibration_per_life_that_launched": 3,
    }
    launching = [life for life, entry in lives.items() if sum(entry["launches"].values())]
    if not rehearse:
        assert seed_launches == len(episodes), seed_launches
        assert host_batches == 0, {life: e["host_batches"] for life, e in lives.items()}
        assert by_job["episode-1"]["live"] == FLEET_EPISODE_LIVE, by_job
        assert by_job["episode-1"]["resume"] == 0, by_job
        assert FLEET_SECOND_LIVE[0] <= by_job["episode-2"]["live"] <= FLEET_SECOND_LIVE[1], by_job
        assert FLEET_SECOND_RESUME[0] <= by_job["episode-2"]["resume"] <= FLEET_SECOND_RESUME[1], (
            by_job)
        for life in launching:
            assert lives[life]["launches"]["calibration"] == 3, (life, lives[life]["launches"])
        # both slots' processes launched the kernel on the one card
        assert {lives[life]["instance"] for life in launching} == {
            f"worker-{i}" for i in range(FLEET_WORKERS)}, launching
        for life, entry in lives.items():
            report = entry["report"]
            if report is not None:
                assert report["launches"] == sum(entry["launches"].values()), (life, report)
                assert report["host_batches"] == 0, (life, report)
    clip_gets = dict(handler.gets)
    latencies = [arrived[m] - published[m] for m in clip_ids]
    in_window = sum(
        ms for entry in lives.values() for t0, t1, ms in entry["intervals"]
        if torrent_start_epoch <= t0 and t1 <= torrent_end_epoch
    )
    fields = dict(
        clock="host wall clock on the card's machine; device ms by CUDA events around each launch",
        seconds=time.perf_counter() - phase_start,
        workers=FLEET_WORKERS,
        fleet_ready_s=ready_s,
        torrent_jobs={
            media_id: {
                "bytes": len(data), "pieces": len(data) // TORRENT_PIECE,
                "publish_to_convert_s": arrived[media_id] - published[media_id],
                "converts": converts[media_id],
            }
            for media_id, (_, data) in episodes.items()
        },
        torrent_window_s=torrent_s,
        killed_instance=victim["instance"],
        second_pieces_served_at_kill=served_at_kill,
        sigkill_to_restarted_heartbeat_s=restart_heartbeat_s,
        sigkill_to_restarted_readyz_s=restart_ready_s,
        fleet_worker_restarts=restarts,
        kernel_ms_by_life={life: entry["kernel_ms"] for life, entry in lives.items()},
        kernel_ms_in_torrent_window=in_window,
        idle_share_of_torrent_window_by_summed_kernel_ms=1 - in_window / (torrent_s * 1e3),
        launches_overlapping_another_process=_overlapping_launches(lives),
        launches_interleaved_with_another_process=_interleaved_launches(lives),
        lives={
            life: {
                "instance": entry["instance"], "pid": entry.get("pid"),
                "ended_by": "SIGTERM" if entry["report"] is not None else "SIGKILL",
                "process_start_to_wrapper_ready_s": entry.get("wrapper_ready_s"),
                "launches_by_step": dict(entry["launches"]),
                "launches_by_job": {job: dict(steps) for job, steps in entry["by_job"].items()},
                "host_batches": entry["host_batches"],
            }
            for life, entry in lives.items()
        },
        launches_by_job={job: dict(steps) for job, steps in by_job.items()},
        expected_launches=expected,
        small_jobs=len(clip_ids),
        small_distinct=len(clips),
        small_origin_gets=sum(clip_gets.values()),
        small_origin_gets_max_per_clip=max(clip_gets.values()) if clip_gets else 0,
        small_publish_to_convert_s_p50=_percentile(latencies, 50),
        small_publish_to_convert_s_p99=_percentile(latencies, 99),
        small_jobs_per_s=len(clip_ids) / burst_s,
        flows={k: (flows or {}).get(k) for k in (
            "workers", "unique_bytes", "ingress_bytes", "cache_hit_bytes",
            "origin_amplification")},
        cache_instances=sorted((cache or {}).get("instances", {})),
        supervisor_sigterm_to_exit_s=exit_s,
        launches=seed_launches + sum(sum(e["launches"].values()) for e in lives.values()),
        host_batches=host_batches,
        object_sha256_equal_payload=True,
        card=card,
    )
    emit("fleet", **fields)
    return fields


def phase_analysis(payload: bytes, workdir: str, card: str, rehearse: bool = False) -> dict:
    """The port's static analyzer and runtime recorders on the card's
    machine. Static: ``python -m downloader_tpu_torch.analysis --no-cache
    --json`` must exit 0 with no violation, and ``--list-suppressions
    --json`` must count ``ANALYSIS_SUPPRESSIONS``. Recorded: the port's
    ``Seeder`` serves ``payload`` (256 KiB pieces) and a child
    ``download-once`` of its magnet runs with ``--record``: the port's
    ``LockOrderRecorder`` and ``ProtocolRecorder`` are installed before
    the child imports the port, and after the job ``ANALYSIS_THREADS``
    threads verify pieces on the card at once and an incident bundle is
    captured. The recorded graph must have no cycle, no obligation may
    leak, the bundle's ``locks`` must be set, and on the card the job
    must launch the kernel and send nothing to hashlib, with lock sites
    of the engine and the kernel wrapper in the graph. ``rehearse`` runs
    it on a host without a card (hashlib engines)."""
    from downloader_tpu_torch.fetch.seeder import Seeder
    from downloader_tpu_torch.parallel import engine as engine_module

    phase_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    static = {}
    for name, options in (("check", ["--no-cache", "--json"]),
                          ("suppressions", ["--list-suppressions", "--json"])):
        start = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "downloader_tpu_torch.analysis", *options],
            cwd=root, env=child_env(), capture_output=True, text=True,
            timeout=ANALYSIS_TIMEOUT_S,
        )
        seconds = time.perf_counter() - start
        assert done.returncode == 0, f"analysis {name} exited {done.returncode}: {done.stdout[-3000:]}"
        static[name] = {"seconds": seconds, "count": json.loads(done.stdout)["count"]}
    assert static["check"]["count"] == 0, static
    assert static["suppressions"]["count"] == ANALYSIS_SUPPRESSIONS, static

    num_pieces = len(payload) // TORRENT_PIECE
    key = f"episode-1/original/{base64.b64encode(JOB_NAME.encode()).decode()}"
    env = child_env(
        S3_ACCESS_KEY="smoke-ak", S3_SECRET_KEY="smoke-sk", DHT_BOOTSTRAP="off", LSD="off",
    )
    credentials = Credentials(access_key="smoke-ak", secret_key="smoke-sk")
    if rehearse:
        engine_module._default = DigestEngine(backend="hashlib")
    else:
        engine_module.default_engine()._calibrate()
        torch.cuda.synchronize()
    sha1_cuda.launches = 0
    seeder = Seeder(JOB_NAME, payload, piece_length=TORRENT_PIECE)
    seed_launches = sha1_cuda.launches
    base_dir = os.path.join(workdir, "analysis")
    os.makedirs(os.path.join(base_dir, "episode-1"))
    try:
        seeder.start()
        with S3Stub(credentials=credentials) as stub:
            env["S3_ENDPOINT"] = f"http://{stub.endpoint}"
            job = _torrent_job(seeder.magnet_uri, base_dir, env, rehearse, record=True)
            stored = stub.buckets.get("triton-staging", {})
            assert list(stored) == [key], list(stored)
            assert hashlib.sha256(stored[key]).digest() == hashlib.sha256(payload).digest()
            assert stub.list_multipart_uploads() == []
    finally:
        seeder.stop()
    shutil.rmtree(base_dir)
    report = job["report"]
    recorded = report["recorded"]
    steps = {
        "analysis_seed": seed_launches,
        "analysis_live": report["launches_live"],
        "analysis_resume": report["launches_resume"],
        "analysis_calibration": report["launches_calibration"],
        "analysis_concurrent": report["launches_concurrent"],
    }
    assert recorded["cycles"] == [], recorded["cycles"]
    assert recorded["leaked"] == [], recorded["leaked"]
    assert recorded["bundle_locks"] is not None, "the bundle has no lock state"
    sites = sorted({os.path.relpath(site, root) for site in recorded["sites"]})
    port_edges = [
        {**edge, "held": os.path.relpath(edge["held"], root),
         "acquired": os.path.relpath(edge["acquired"], root)}
        for edge in recorded["edges"]
        if os.path.join(root, "downloader_tpu_torch") in edge["held"] + edge["acquired"]
    ]
    if not rehearse:
        assert report["launches"] > 0 and report["host_batches"] == 0, report
        assert steps["analysis_concurrent"] == ANALYSIS_THREADS, steps
        for module in ("parallel/engine.py", "parallel/sha1_cuda.py"):
            assert any(site.startswith(f"downloader_tpu_torch/{module}:") for site in sites), (
                module, sites)
    fields = dict(
        clock="host wall clock on the card's machine",
        seconds=time.perf_counter() - phase_start,
        static_check_s=static["check"]["seconds"],
        static_suppressions_s=static["suppressions"]["seconds"],
        violations=static["check"]["count"],
        suppressions=static["suppressions"]["count"],
        payload_bytes=len(payload),
        pieces=num_pieces,
        job_wall_s=job["wall_s"],
        threads=ANALYSIS_THREADS,
        launches=sum(steps.values()),
        launches_by_step=steps,
        host_batches=report["host_batches"],
        device_batches=report["device_batches"],
        lock_sites=len(sites),
        lock_sites_of_the_port=[site for site in sites if site.startswith("downloader_tpu_torch")],
        edges=len(recorded["edges"]),
        edges_of_the_port=port_edges,
        cycles=recorded["cycles"],
        leaked=recorded["leaked"],
        bundle_locks={
            "edges": len(recorded["bundle_locks"]["edges"]),
            "held_by_thread": recorded["bundle_locks"]["held_by_thread"],
        },
        object_sha256_equal_payload=True,
        card=card,
    )
    emit("analysis", **fields)
    return fields


def _files(directory: str) -> dict:
    """Each file in ``directory``: (size, mtime in ns)."""
    if not os.path.isdir(directory):
        return {}
    return {
        entry.name: (entry.stat().st_size, entry.stat().st_mtime_ns)
        for entry in os.scandir(directory) if entry.is_file()
    }


def ldd(path: str) -> list[str]:
    done = subprocess.run(["ldd", path], capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in done.stdout.splitlines() if line.strip()]


def packaging_tools() -> dict:
    """What this host offers the build steps: the programs the Makefile
    and the CUDA image call, and this interpreter's packaging modules."""
    import importlib.util
    from importlib import metadata

    tools = {name: shutil.which(name) for name in ("make", "cc", "nvcc", "docker", "ldd")}
    for name in ("setuptools", "wheel", "pip"):
        try:
            tools[name] = metadata.version(name)
        except metadata.PackageNotFoundError:
            tools[name] = None
    # setuptools 70.1 and later build wheels without the wheel package;
    # looked up by file, since importing setuptools changes sys.path
    spec = importlib.util.find_spec("setuptools")
    own = spec is not None and os.path.isfile(
        os.path.join(os.path.dirname(spec.origin), "command", "bdist_wheel.py"))
    tools["bdist_wheel"] = "setuptools" if own else ("wheel" if tools["wheel"] else None)
    tools["python"] = sys.version.split()[0]
    tools["prefix"] = sys.prefix
    return tools


def _run_build(command: list[str], cwd: str, env: dict) -> tuple[float, str]:
    """One build step in a child: (seconds, its standard output)."""
    start = time.perf_counter()
    done = subprocess.run(command, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=PACKAGING_TIMEOUT_S)
    seconds = time.perf_counter() - start
    assert done.returncode == 0, f"{command[:4]} exited {done.returncode}: {done.stderr[-3000:]}"
    return seconds, done.stdout


def _packaging_job(seeder, payload: bytes, base_dir: str, env: dict, rehearse: bool,
                   script: str | None = None, check_batch: bool = False,
                   program: str | None = None) -> dict:
    """One ``download-once`` of ``seeder``'s magnet into a fresh S3 stub,
    holding the stored object against ``payload``: counted, through
    ``script`` (``_torrent_job``), or, with ``program``, the installed
    console script itself (no count: the entry point alone)."""
    key = f"episode-1/original/{base64.b64encode(JOB_NAME.encode()).decode()}"
    credentials = Credentials(access_key="smoke-ak", secret_key="smoke-sk")
    os.makedirs(os.path.join(base_dir, "episode-1"))
    with S3Stub(credentials=credentials) as stub:
        env = dict(env, S3_ENDPOINT=f"http://{stub.endpoint}")
        if program is None:
            job = _torrent_job(seeder.magnet_uri, base_dir, env, rehearse, script=script,
                               check_batch=check_batch)
        else:
            command = [program, "download-once", "--id", "episode-1",
                       "--url", seeder.magnet_uri, "--base-dir", base_dir]
            start = time.perf_counter()
            done = subprocess.run(command, env=env, cwd=base_dir, capture_output=True, text=True,
                                  timeout=TORRENT_JOB_TIMEOUT_S)
            job = {"wall_s": time.perf_counter() - start, "stdout": done.stdout, "report": None}
            assert done.returncode == 0, f"{program} exited {done.returncode}: {done.stderr[-3000:]}"
        stored = stub.buckets.get("triton-staging", {})
        assert list(stored) == [key], list(stored)
        assert hashlib.sha256(stored[key]).digest() == hashlib.sha256(payload).digest(), (
            "stored object != payload")
        assert stub.list_multipart_uploads() == []
    assert job["stdout"].splitlines() == [os.path.join(base_dir, "episode-1", JOB_NAME)], (
        job["stdout"])
    shutil.rmtree(base_dir)
    summary = {"wall_s": job["wall_s"], "MBps": len(payload) / job["wall_s"] / 1e6,
               "object_sha256_equal_payload": True}
    report = job["report"]
    if report is not None:
        summary.update(
            process_s=report["process_s"],
            launches_by_step={step: report[f"launches_{step}"]
                              for step in ("live", "resume", "calibration", "check")},
            device_batches=report["device_batches"],
            host_batches=report["host_batches"],
            package=report["package"],
        )
    return summary


def phase_packaging(payload: bytes, workdir: str, card: str, rehearse: bool = False) -> dict:
    """The port as an installed program, run from outside the checkout.

    Wheel: the wheel is built offline from a copy of the checkout's
    sources and installed with ``pip install --target T/site``. A copy
    of this script outside the checkout, with ``PYTHONPATH=T/site``, runs
    the installed ``cli.main`` as a counted ``download-once`` of the
    episode: it must import the port from ``T/site`` and compile the
    kernel from the wheel's own source into its fresh cache. Then the
    installed console script prints its help and downloads the first
    ``PACKAGING_BYTES``, reusing that library (no new file in the cache).

    Zipapp: ``hack/build_torch_pyz.py`` builds the archive (with the
    kernel library, when nvcc exists); a counted child with
    ``PYTHONPATH`` set to the archive and no nvcc it could find (an empty
    ``CUDA_HOME``, no nvcc on ``PATH``: the CUDA image's runtime) runs
    the first ``PACKAGING_BYTES`` and then one live flush's shape through
    the kernel. It must take the library from the archive and load the
    native RC4 core. Every child gets a fresh ``HOME`` and
    ``XDG_CACHE_HOME`` and a working directory outside the checkout.

    On the card each counted job must launch the kernel and send nothing
    to hashlib. Without a setuptools that builds wheels the wheel part
    prints why it did not run. ``rehearse`` runs it on a host without a
    card (hashlib engines)."""
    from downloader_tpu_torch.fetch.seeder import Seeder
    from downloader_tpu_torch.parallel import engine as engine_module

    phase_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(workdir, "packaging")
    outside = os.path.join(base, "outside")
    os.makedirs(outside)
    script = shutil.copy(os.path.abspath(__file__), outside)
    small = payload[:PACKAGING_BYTES]
    knobs = dict(S3_ACCESS_KEY="smoke-ak", S3_SECRET_KEY="smoke-sk", DHT_BOOTSTRAP="off", LSD="off")

    def env_for(name: str, pythonpath: str | None, **more) -> dict:
        # a fresh HOME and XDG cache for each installation; PYTHONPATH
        # the installation, or none (a build step)
        env = child_env(HOME=os.path.join(base, name, "home"),
                        XDG_CACHE_HOME=os.path.join(base, name, "xdg"), **knobs, **more)
        if pythonpath is None:
            del env["PYTHONPATH"]
        else:
            env["PYTHONPATH"] = pythonpath
        return env

    if rehearse:
        engine_module._default = DigestEngine(backend="hashlib")
    else:
        engine_module.default_engine()._calibrate()
        torch.cuda.synchronize()
    sha1_cuda.launches = 0
    episode = Seeder(JOB_NAME, payload, piece_length=TORRENT_PIECE)
    first = Seeder(JOB_NAME, small, piece_length=TORRENT_PIECE)
    seed_launches = sha1_cuda.launches
    libraries: dict = {}
    fields: dict = {}
    try:
        episode.start()
        first.start()
        tools = fields["tools"] = packaging_tools()
        if tools["setuptools"] is None or tools["bdist_wheel"] is None:
            reason = f"no setuptools with a bdist_wheel in {sys.executable}"
            print(json.dumps({"wheel": f"not run: {reason}"}), flush=True)
            fields["wheel"] = f"not run: {reason}"
        else:
            source = os.path.join(base, "src")
            os.makedirs(source)
            for name in ("pyproject.toml", "README.md"):
                shutil.copy(os.path.join(root, name), source)
            skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.tmp")
            for package in ("downloader_tpu", "downloader_tpu_torch"):
                shutil.copytree(os.path.join(root, package), os.path.join(source, package),
                                ignore=skip)
            build_env = env_for("wheel", None)
            dist = os.path.join(base, "dist")
            build_s, _ = _run_build(
                [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
                 "--no-index", "-w", dist, source], base, build_env)
            (wheel,) = os.listdir(dist)
            site = os.path.join(base, "T", "site")
            install_s, _ = _run_build(
                [sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
                 "--target", site, os.path.join(dist, wheel)], base, build_env)
            env = env_for("wheel", site)
            cache = os.path.join(env["XDG_CACHE_HOME"], "downloader_tpu_torch")
            job = _packaging_job(episode, payload, os.path.join(base, "wheel-job"), env,
                                 rehearse, script=script)
            package = job["package"]
            assert os.path.commonpath([package["file"], site]) == site, package
            program = os.path.join(site, "bin", "downloader-torch")
            done = subprocess.run([program, "--help"], env=env, cwd=outside,
                                  capture_output=True, text=True, timeout=120)
            assert done.returncode == 0 and "download-once" in done.stdout, done.stderr[-3000:]
            before = _files(cache)
            # the entry point alone has no hashlib engine to rehearse with
            console = None if rehearse else _packaging_job(
                first, small, os.path.join(base, "console-job"), env, rehearse, program=program)
            after = _files(cache)
            if not rehearse:
                assert package["kernel_origin"] == "compiled" and package["kernel_compile_s"], package
                assert os.path.dirname(package["kernel_library"]) == cache, package
                assert after == before, ("the console script's job wrote the cache", before, after)
                libraries["libsha1 (compiled from the wheel)"] = ldd(package["kernel_library"])
            fields["wheel"] = dict(
                wheel=wheel, build_s=build_s, install_s=install_s, site=site,
                job=job, help_ok=True, console_job=console,
                cache_files=sorted(after), console_job_reused_library=after == before,
            )
        archive = os.path.join(base, "downloader-torch.pyz")
        pyz_s, out = _run_build(
            [sys.executable, os.path.join(root, "hack", "build_torch_pyz.py"), "--out", archive],
            outside, env_for("pyz-build", None))
        built = json.loads(out.splitlines()[-1])
        empty = os.path.join(base, "no-cuda")
        os.makedirs(empty)
        path = os.pathsep.join(
            part for part in os.environ.get("PATH", "").split(os.pathsep)
            if part and not os.path.exists(os.path.join(part, "nvcc"))
        )
        env = env_for("zipapp", archive, CUDA_HOME=empty, PATH=path)
        job = _packaging_job(first, small, os.path.join(base, "zipapp-job"), env, rehearse,
                             script=script, check_batch=True)
        package = job["package"]
        assert package["file"].startswith(archive + os.sep), package
        assert package["nvcc"] is None, package
        assert package["check"]["equal_hashlib"], package["check"]
        if not rehearse:
            assert package["kernel_origin"] == "archive", package
            assert package["kernel_compile_s"] is None, package
            assert package["rc4_native"] is not None, package
            libraries["libsha1 (from the archive)"] = ldd(package["kernel_library"])
            libraries["_rc4.so (from the archive)"] = ldd(package["rc4_native"])
        fields["zipapp"] = dict(
            build_s=pyz_s, bytes=os.path.getsize(archive), libraries=built["libraries"],
            dropped=built["dropped"], job=job,
        )
    finally:
        episode.stop()
        first.stop()
    shutil.rmtree(base)
    jobs = [fields["zipapp"]["job"]]
    if isinstance(fields["wheel"], dict):
        jobs.append(fields["wheel"]["job"])
    steps = {"packaging_seed": seed_launches}
    for step in ("live", "resume", "calibration", "check"):
        steps[f"packaging_{step}"] = sum(job["launches_by_step"][step] for job in jobs)
    if not rehearse:
        for job in jobs:
            assert job["launches_by_step"]["live"] > 0 and job["host_batches"] == 0, job
        assert steps["packaging_check"] == 1, steps
    fields = dict(
        clock="host wall clock on the card's machine",
        seconds=time.perf_counter() - phase_start,
        payload_bytes=len(payload),
        first_bytes=len(small),
        piece_length=TORRENT_PIECE,
        **fields,
        ldd=libraries,
        launches=sum(steps.values()),
        launches_by_step=steps,
        card=card,
    )
    emit("packaging", **fields)
    return fields


def _run_tool(script: str, out_dir: str, report: str, *arguments: str) -> dict:
    """One of the port's hack tools as CI runs it (``python script
    out_dir arguments``), in a child process from the checkout's root;
    it must exit 0. Returns its wall seconds and its JSON report,
    ``report`` in ``out_dir``."""
    start = time.perf_counter()
    done = subprocess.run(
        [sys.executable, script, out_dir, *arguments],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=child_env(),
        capture_output=True, text=True, timeout=TOOLING_TIMEOUT_S,
    )
    seconds = time.perf_counter() - start
    assert done.returncode == 0, (
        f"{script} exited {done.returncode}: {done.stdout[-2000:]} {done.stderr[-3000:]}")
    with open(os.path.join(out_dir, report)) as source:
        return {"seconds": seconds, "report": json.load(source)}


def phase_tooling(payload: bytes, workdir: str, card: str, rehearse: bool = False) -> dict:
    """The port's chaos and profiling tooling on the card's machine.

    ``hack/failpoint_matrix_torch.py`` runs as CI runs it: every default
    seed must complete its jobs with no multipart upload left open and
    an empty admission ledger, under the JAX package's schedule
    fingerprint, and the SIGKILL-mid-coalesce cell (the port's 2-worker
    fleet, ``hack/fleet_torch.py``) must pass.
    ``hack/profile_artifacts_torch.py`` must sample its wave of
    ``TOOLING_PROFILE_JOBS`` small jobs and write the collapsed stacks,
    the SVG flamegraph and ``profile.json``.

    The torrent cell: the port's ``Seeder`` serves ``payload`` (256 KiB
    pieces) and a counted ``download-once`` of its magnet runs in a
    child with ``FAILPOINT_SPEC`` = ``TOOLING_SPEC`` armed at
    ``TOOLING_SEED``: its peer-wire reads and writes fail at a seeded
    rate, so connections drop and the job dials again. The child's
    engine is ``DigestEngine(backend="cuda")``, so a dropped
    connection's partial flush goes to the card too. Both sites must
    inject and the stored object must equal the payload byte for byte;
    on the card every piece must be verified by the kernel (launches
    counted by step, 0 hashlib batches). The forced engine bypasses
    ``auto``: ``below_auto_min_batch`` counts the flushes under its
    minimum batch, which ``auto`` would verify with hashlib. ``rehearse``
    runs it on a host without a card (hashlib engines)."""
    from downloader_tpu_torch.fetch.seeder import Seeder
    from downloader_tpu_torch.parallel import engine as engine_module

    phase_start = time.perf_counter()
    base = os.path.join(workdir, "tooling")
    matrix = _run_tool("hack/failpoint_matrix_torch.py", os.path.join(base, "failpoints"),
                       "failpoint_matrix.json")
    rows = matrix["report"]["seeds"]
    assert {row["seed"]: row["schedule_fingerprint"] for row in rows} == MATRIX_FINGERPRINTS, rows
    for row in rows:
        assert row["ok"] and row["completed"] == row["jobs"], row
        assert row["dangling_multiparts"] == 0 and row["ledger_outstanding"] == [], row
    coalesce = matrix["report"]["sigkill_mid_coalesce"]
    assert coalesce["ok"], coalesce
    profile_dir = os.path.join(base, "profile")
    profile = _run_tool("hack/profile_artifacts_torch.py", profile_dir, "profile.json",
                        str(TOOLING_PROFILE_JOBS))
    assert profile["report"]["samples"] > 0, profile
    artifacts = _files(profile_dir)
    assert {"bench.collapsed", "bench.svg", "profile.json"} <= set(artifacts), artifacts
    assert all(size > 0 for size, _ in artifacts.values()), artifacts

    key = f"episode-1/original/{base64.b64encode(JOB_NAME.encode()).decode()}"
    env = child_env(
        S3_ACCESS_KEY="smoke-ak", S3_SECRET_KEY="smoke-sk", DHT_BOOTSTRAP="off", LSD="off",
        FAILPOINT_SPEC=TOOLING_SPEC, FAILPOINT_SEED=str(TOOLING_SEED),
    )
    credentials = Credentials(access_key="smoke-ak", secret_key="smoke-sk")
    if rehearse:
        engine_module._default = DigestEngine(backend="hashlib")
    else:
        engine_module.default_engine()._calibrate()
        torch.cuda.synchronize()
    sha1_cuda.launches = 0
    seeder = Seeder(JOB_NAME, payload, piece_length=TORRENT_PIECE)
    seed_launches = sha1_cuda.launches
    base_dir = os.path.join(base, "torrent")
    os.makedirs(os.path.join(base_dir, "episode-1"))
    try:
        seeder.start()
        with S3Stub(credentials=credentials) as stub:
            env["S3_ENDPOINT"] = f"http://{stub.endpoint}"
            job = _torrent_job(seeder.magnet_uri, base_dir, env, rehearse, cuda_engine=True)
            stored = stub.buckets.get("triton-staging", {})
            assert list(stored) == [key], list(stored)
            assert stored[key] == payload, "stored object != payload"
            assert stub.list_multipart_uploads() == []
    finally:
        seeder.stop()
    shutil.rmtree(base)
    report = job["report"]
    injections = {site: entry["injected"] for site, entry in report["failpoints"]["sites"].items()}
    assert injections.get("peer.recv", 0) > 0 and injections.get("peer.send", 0) > 0, injections
    steps = {
        "tooling_seed": seed_launches,
        "tooling_live": report["launches_live"],
        "tooling_resume": report["launches_resume"],
        "tooling_calibration": report["launches_calibration"],
    }
    if not rehearse:
        seen = sum(report["kernel_launches_by_name"].values())
        assert seen == report["launches"], (seen, report["launches"])
        assert report["launches_live"] > 0 and report["host_batches"] == 0, report
        assert report["launches_live"] == (
            report["device_batches"] - report["resume_device_batches"]), report
    fields = dict(
        clock="host wall clock on the card's machine; device time from the job's profiler",
        seconds=time.perf_counter() - phase_start,
        failpoint_matrix={
            "seconds": matrix["seconds"],
            "seeds": [{k: row[k] for k in ("seed", "schedule_fingerprint", "jobs", "completed",
                                          "elapsed_s", "injections", "dangling_multiparts",
                                          "ledger_outstanding", "ok")} for row in rows],
            "sigkill_mid_coalesce": {k: coalesce[k] for k in ("seed", "elapsed_s", "rc", "ok")},
        },
        profile_artifacts={
            "seconds": profile["seconds"],
            "files": {name: size for name, (size, _) in artifacts.items()},
            **{k: profile["report"][k] for k in ("jobs", "elapsed_s", "samples", "attributed_pct",
                                                 "top_cpu_role", "stage_cpu_pct", "wait_locks",
                                                 "modes_served")},
        },
        torrent={
            "payload_bytes": len(payload),
            "pieces": len(payload) // TORRENT_PIECE,
            "spec": TOOLING_SPEC,
            "failpoint_seed": TOOLING_SEED,
            "injections": injections,
            "wall_s": job["wall_s"],
            "job_wall_s": report["wall_s"],
            "MBps": len(payload) / job["wall_s"] / 1e6,
            "process_s": report["process_s"],
            "peer_connects": job["spans_by_name"].get("peer-connect", {}).get("count", 0),
            "piece_spans": job["spans_by_name"].get("piece", {}).get("count", 0),
            "device_busy_ms": report["device_busy_ms"],
            "backend_name": report["backend_name"],
            "device_batches": report["device_batches"],
            "host_batches": report["host_batches"],
            # the cell forces a `cuda` engine; under the installed
            # program's `auto` these flushes, at least, would go to hashlib
            "below_auto_min_batch": report["below_min_batch"],
            "object_equal_payload": True,
        },
        launches=sum(steps.values()),
        launches_by_step=steps,
        card=card,
    )
    emit("tooling", **fields)
    return fields


def _bench_child(argv: list[str], **knobs: str) -> tuple[float, str, str]:
    """A benchmark script in a child process from the checkout's root;
    it must exit 0. Returns its wall seconds, stdout and stderr."""
    start = time.perf_counter()
    done = subprocess.run(
        [sys.executable, *argv], cwd=os.path.dirname(os.path.abspath(__file__)),
        env=child_env(**knobs), capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
    )
    seconds = time.perf_counter() - start
    assert done.returncode == 0, (
        f"{argv[0]} exited {done.returncode}: {done.stdout[-2000:]} {done.stderr[-4000:]}")
    return seconds, done.stdout, done.stderr


def phase_bench(card: str) -> dict:
    """The port's benchmark twins on the card.

    ``__graft_entry_torch__``: ``entry()``'s function on its example
    arguments must give hashlib's digests, and ``dryrun_multichip(1)``
    must count its one deliberate mismatch. ``bench_digest_torch.py``
    runs as its ``main()``: each of ``BENCH_DIGEST_SHAPES`` must show 0
    digests that differ from hashlib and a kernel rate. ``bench_torch.py``
    runs at ``BENCH_KNOBS`` with every arm on: its report must carry
    every metric of ``bench.py``'s; the fleet chaos arm must complete
    every job under its trace id with no multipart upload left open and
    no more duplicate Converts than its killed workers held deliveries;
    the flow arm's fleet amplification must equal its worker count; the
    single-flight arm's cache-on amplification must be 1.0; the wedged
    fan-out must stay within its budget; the canary must detect its
    corruption; the digest arm must agree with hashlib. Launches are
    counted by step: the graft entry points in this process, each digest
    shape in its child (``cuda_launches``)."""
    from bench_digest_torch import digest_line

    import __graft_entry_torch__ as graft

    phase_start = time.perf_counter()
    sha1_cuda.launches = 0
    fn, (blocks, nblocks) = graft.entry()
    got = digests_to_bytes(fn(blocks, nblocks).cpu().numpy(), blocks.shape[2])
    assert got == [hashlib.sha1(bytes([i]) * (1024 + i)).digest() for i in range(8)], got
    graft.dryrun_multichip(1)
    graft_launches = sha1_cuda.launches

    digest_s, out, _ = _bench_child(["bench_digest_torch.py"])
    shapes = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [(s["piece_kb"], s["batch"]) for s in shapes] == list(BENCH_DIGEST_SHAPES), shapes
    for shape in shapes:
        assert shape["cuda_digest_mismatches"] == 0 and shape["cuda_GBps"], shape
        assert shape["hashlib_GBps"] and shape["cuda_launches"] > 0, shape

    bench_s, out, _ = _bench_child(["bench_torch.py"], **BENCH_KNOBS)
    report = json.loads(out.splitlines()[-1])
    arms = {extra["metric"]: extra for extra in report["extra_metrics"]}
    assert report["metric"] == "e2e_fetch_upload_MBps" and report["value"] > 0, report
    assert set(arms) == BENCH_METRICS and len(arms) == len(report["extra_metrics"]), sorted(arms)
    fleet = arms["fleet_chaos"]
    assert fleet["completed"] == fleet["jobs"] and fleet["dangling_multiparts"] == 0, fleet
    assert fleet["duplicate_converts"] <= BENCH_FLEET_PREFETCH * fleet["restarts"], fleet
    flow = arms["flow_accounting"]
    assert flow["origin_amplification"] == flow["workers"], flow
    assert arms["single_flight"]["singleflight_amp"] == 1.0, arms["single_flight"]
    assert arms["fleet_scrape"]["within_one_timeout_budget"], arms["fleet_scrape"]
    assert arms["canary_probe"]["detect_s"] is not None, arms["canary_probe"]
    digest = arms["digest_kernel"]
    assert digest["cuda_digest_mismatches"] == 0 and digest["cuda_GBps"], digest
    steps = {"bench_graft": graft_launches}
    steps.update({f"bench_digest_{s['piece_kb']}x{s['batch']}": s["cuda_launches"] for s in shapes})
    steps["bench_arm"] = digest["cuda_launches"]
    fields = dict(
        clock="host wall clock on the card's machine; kernel times by CUDA events in the children",
        seconds=time.perf_counter() - phase_start,
        digest_s=digest_s,
        digest_shapes=shapes,
        bench_s=bench_s,
        knobs=BENCH_KNOBS,
        line=digest_line(report),
        fleet_chaos={k: fleet[k] for k in ("jobs", "completed", "elapsed_s", "restart_s",
                                          "restarts", "duplicate_converts",
                                          "dangling_multiparts")},
        single_flight={arm: arms["single_flight"][arm] for arm in ("cache_off", "cache_on")},
        digest_arm=digest,
        launches=sum(steps.values()),
        launches_by_step=steps,
        card=card,
    )
    emit("bench", **fields)
    return fields


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
    if sys.argv[1:2] == ["--counted-job"]:
        # the child of the torrent, daemon, fleet and analysis phases:
        # python3 chip_smoke.py --counted-job REPORT [--launch-log LOG]
        # [--rehearse] [--record] [--check-batch] [--cuda-engine]
        # -- <downloader_tpu_torch arguments>
        split = sys.argv.index("--")
        options = sys.argv[3:split]
        launch_log = options[options.index("--launch-log") + 1] if "--launch-log" in options else None
        return counted_job(sys.argv[2], sys.argv[split + 1 :], "--rehearse" in options, launch_log,
                           "--record" in options, "--check-batch" in options,
                           "--cuda-engine" in options)
    if sys.argv[1:2] == ["--fleet-supervisor"]:
        # the fleet phase's supervisor: python3 chip_smoke.py
        # --fleet-supervisor LIFE_DIR [--rehearse] -- serve --workers N ...
        split = sys.argv.index("--")
        return fleet_supervisor(sys.argv[2], sys.argv[split + 1 :], "--rehearse" in sys.argv[3:split])
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
        origin=sha1_cuda.origin,
        compile_s=sha1_cuda.compile_s,
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
        phase_job(payload, workdir, card)
        torrent_shapes = phase_torrent_shapes(payload, cost)
        torrent = phase_torrent(payload, workdir, card)
        second = rng.bytes(DAEMON_SECOND_BYTES)
        clips = {
            f"Extra.{index:02d}.mkv": rng.bytes(int(rng.integers(*DAEMON_CLIP_BYTES) + 1))
            for index in range(DAEMON_CLIPS)
        }
        daemon = phase_daemon(payload, second, clips, workdir, card)
        fleet = phase_fleet(payload, second, clips, workdir, card)
        analysis = phase_analysis(payload[:ANALYSIS_BYTES], workdir, card)
        packaging = phase_packaging(payload, workdir, card)
        tooling = phase_tooling(payload[:TOOLING_BYTES], workdir, card)
    bench = phase_bench(card)

    # the line's times are at the live flush's shape (P=32, B=4097),
    # which most launches of the torrent, daemon and fleet paths take
    # and where the plain version runs at full depth
    live = torrent_shapes["shapes"][f"P{TORRENT_PLAIN_SHAPE}_B{TORRENT_PIECE // 64 + 1}"]
    kernel = dict(KERNEL)
    kernel.update(
        launches=(main_path["launches"] + torrent["launches"] + daemon["launches"]
                  + fleet["launches"] + analysis["launches"] + packaging["launches"]
                  + tooling["launches"] + bench["launches"]),
        max_abs_err=max(
            checked["max_abs_err"], main_shape["max_abs_err"], torrent_shapes["max_abs_err"]
        ),
        ms=live["kernel_ms"],
        plain_ms=live["plain_ms"],
        bound_ms=live["bound_ms"],
        bound_by=live["bound_by"],
        library_ms=None,
        shape={"P": live["P"], "B": live["B"]},
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
