"""The port's CUDA SHA-1 kernel on the card (marker ``cuda``).

Run on a host with an NVIDIA GPU, ``nvcc`` and PyTorch built for CUDA:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The first test builds csrc/sha1.cu into build/downloader_tpu_torch/.
Without a card every test here skips. The kernel is held bit-exact
against its plain PyTorch version on the same tensors on the card and
against hashlib. This file imports nothing of JAX, so it runs where JAX
is not installed.
"""

import hashlib

import numpy as np
import pytest
import torch

from downloader_tpu_torch.parallel import mesh, pack, sha1, sha1_cuda
from downloader_tpu_torch.parallel.engine import DigestEngine

pytestmark = pytest.mark.cuda

EDGE_SIZES = (0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 16384)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests cover the plain version")
    return torch.device("cuda", 0)


def _pieces(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in sizes]


def _sized(rng, ends):
    """One random piece for each block count in ``ends``."""
    return [
        rng.bytes(int(rng.integers(max(0, 64 * (n - 1) - 8), 64 * n - 8)))
        for n in ends
    ]


def _on(card, pieces):
    blocks, nblocks = pack.pack_pieces(pieces)
    return (
        torch.from_numpy(blocks.view(np.int32)).to(card),
        torch.from_numpy(nblocks).to(card),
    )


@pytest.mark.parametrize(
    "sizes",
    [EDGE_SIZES, [4096] * 1029 + [1000, 0]],
    ids=["edge_sizes", "ragged_1031"],
)
def test_kernel_matches_plain_and_hashlib(card, sizes):
    pieces = _pieces(sizes, seed=len(sizes))
    blocks, nblocks = _on(card, pieces)
    nblocks[len(pieces) // 2] = 0  # a padding lane keeps H0
    before = sha1_cuda.launches
    kernel = sha1_cuda.sha1_batch_cuda(blocks, nblocks)
    assert sha1_cuda.launches == before + 1
    plain = sha1.sha1_states(blocks, nblocks)
    torch.cuda.synchronize()
    assert kernel.device == card and torch.equal(kernel, plain)
    digests = pack.digests_to_bytes(kernel.cpu().numpy(), len(pieces))
    for lane, piece in enumerate(pieces):
        if lane == len(pieces) // 2:
            assert kernel[:, lane].cpu().numpy().view(np.uint32).tolist() == list(pack.H0)
        else:
            assert digests[lane] == hashlib.sha1(piece).digest()


def test_wrapper_raises_on_bad_cuda_arguments(card):
    blocks, nblocks = _on(card, _pieces([10, 200]))
    with pytest.raises(ValueError, match="contiguous"):
        sha1_cuda.sha1_states(blocks.transpose(0, 2).contiguous().transpose(0, 2), nblocks)
    with pytest.raises(ValueError):
        sha1_cuda.sha1_states(blocks, nblocks.cpu())
    with pytest.raises(TypeError):
        sha1_cuda.sha1_states(blocks.to(torch.int64), nblocks)


def test_engine_on_the_card(card):
    engine = DigestEngine(backend="cuda", device=card)
    pieces = _pieces(EDGE_SIZES, seed=3)
    want = [hashlib.sha1(p).digest() for p in pieces]
    before = sha1_cuda.launches
    assert engine.sha1_many(pieces) == want
    expected = list(want)
    expected[7] = bytes(20)
    assert engine.verify_pieces(pieces, expected) == [i != 7 for i in range(14)]
    assert sha1_cuda.launches == before + 2
    assert engine.backend_name == f"cuda-sha1[{card}]"


def test_split_across_the_visible_cards(card):
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    pieces = _pieces([300] * 20, seed=4)
    raw, counts = pack.pack_bytes(pieces)
    states = mesh.digest_split(torch.from_numpy(raw), torch.from_numpy(counts), devices)
    assert pack.digests_to_bytes(states.numpy(), 20) == [
        hashlib.sha1(p).digest() for p in pieces
    ]


@pytest.mark.parametrize("count", [1, 31, 33, 64, 1024, 1031])
@pytest.mark.parametrize("depth", ["below", "at", "above"])
def test_ragged_lanes_around_the_ring(card, count, depth):
    # B below, at and above the ring's blocks; the lanes end at every
    # offset within a stage and across stage boundaries; P % 4 == 0 takes
    # the 16-byte copies, the other counts the 4-byte ones
    stages, stage_blocks = sha1_cuda.RING
    ring = stages * stage_blocks
    num_blocks = {"below": ring - 1, "at": ring, "above": ring + stage_blocks + 1}[depth]
    ends = [1 + (7 * lane) % num_blocks for lane in range(count)]
    ends[0] = ends[-1] = num_blocks
    rng = np.random.default_rng(count * 3 + num_blocks)
    pieces = _sized(rng, ends)
    blocks, nblocks = _on(card, pieces)
    assert blocks.shape == (num_blocks, 16, count)
    zero = count // 2 if count > 2 else None
    if zero is not None:
        nblocks[zero] = 0  # a padding lane keeps H0
    if count > 1:
        nblocks[-1] = num_blocks + 9  # counts above B are clamped to B
    kernel = sha1_cuda.sha1_batch_cuda(blocks, nblocks)
    plain = sha1.sha1_states(blocks, nblocks)
    torch.cuda.synchronize()
    assert torch.equal(kernel, plain)
    digests = pack.digests_to_bytes(kernel.cpu().numpy(), count)
    for lane, piece in enumerate(pieces):
        if lane == zero:
            assert kernel[:, lane].cpu().numpy().view(np.uint32).tolist() == list(pack.H0)
        else:
            assert digests[lane] == hashlib.sha1(piece).digest(), lane


def test_rows_off_16_bytes_take_the_4_byte_copies(card):
    # P % 4 == 0 but the tensor starts 4 bytes past a 16-byte boundary
    pieces = _sized(np.random.default_rng(5), [1 + lane % 20 for lane in range(64)])
    words, counts = pack.pack_pieces(pieces)
    flat = torch.empty(words.size + 1, dtype=torch.int32, device=card)
    blocks = flat[1:].view(words.shape)
    blocks.copy_(torch.from_numpy(words.view(np.int32)))
    assert blocks.data_ptr() % 16 == 4 and blocks.is_contiguous()
    kernel = sha1_cuda.sha1_batch_cuda(blocks, torch.from_numpy(counts).to(card))
    assert pack.digests_to_bytes(kernel.cpu().numpy(), 64) == [
        hashlib.sha1(p).digest() for p in pieces
    ]


def test_calibration_chain_of_one_lane(card):
    # the engine prices the kernel by one lane's chain of 1024 blocks
    # (64 KiB, held in L2): the same launch on a real message
    piece = np.random.default_rng(6).bytes(1024 * 64 - 9)
    blocks, nblocks = _on(card, [piece])
    assert blocks.shape == (1024, 16, 1)
    kernel = sha1_cuda.sha1_batch_cuda(blocks, nblocks)
    assert pack.digests_to_bytes(kernel.cpu().numpy(), 1) == [hashlib.sha1(piece).digest()]
    engine = DigestEngine(backend="auto", device=card)
    hashlib_bps, transfer_bps, sync_s, block_s = engine._calibrate()
    assert hashlib_bps > 0 and transfer_bps > 0 and sync_s > 0 and block_s > 0


def test_verify_pieces_from_four_threads(card):
    """Four threads call one engine's verify_pieces at once, as two or
    more torrent jobs of the daemon flush into the shared default engine:
    every thread gets hashlib's verdicts for its own pieces, and the one
    corrupted piece (thread 2's, piece 5) is refused in that thread only."""
    import threading

    engine = DigestEngine(backend="cuda", device=card)
    rng = np.random.default_rng(7)
    batches = [[rng.bytes(256 * 1024) for _ in range(32)] for _ in range(4)]
    digests = [[hashlib.sha1(p).digest() for p in batch] for batch in batches]
    corrupt = bytearray(batches[2][5])
    corrupt[1000] ^= 0x40
    batches[2][5] = bytes(corrupt)
    rounds = 12
    start = threading.Barrier(4)
    results: list = [None] * 4
    errors: list = []

    def run(index):
        try:
            start.wait(30)
            results[index] = [
                engine.verify_pieces(batches[index], digests[index]) for _ in range(rounds)
            ]
        except Exception as exc:  # reported below with its thread
            errors.append((index, repr(exc)))

    before = sha1_cuda.launches
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(120)
    assert not errors, errors
    for index, verdicts in enumerate(results):
        want = [not (index == 2 and piece == 5) for piece in range(32)]
        assert verdicts == [want] * rounds, index
    assert sha1_cuda.launches == before + 4 * rounds
    assert engine.device_batches == 4 * rounds
