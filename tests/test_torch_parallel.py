"""The PyTorch port's compute path (downloader_tpu_torch/parallel) held
against the JAX package (downloader_tpu/parallel) on the CPU.

Every input is made from a numpy seed and fed to both packages; every
comparison is bit-exact, because digests, verdicts and counts are
integers. The JAX side runs as tests/test_parallel.py runs it: the XLA
kernel on the conftest's CPU backend, and the Pallas kernel through the
Pallas interpreter. The port's CUDA kernel cannot run here; its wrapper
takes the plain PyTorch version for CPU tensors, and
tests/test_torch_cuda.py holds the kernel itself on the card.
"""

import ast
import hashlib
import importlib.util
import os
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from downloader_tpu.parallel import DigestEngine as RefEngine
from downloader_tpu.parallel import pack as ref_pack
from downloader_tpu.parallel.mesh import verify_step_jit as ref_verify_step
from downloader_tpu.parallel.sha1 import sha1_blocks_jit as ref_sha1_blocks
from downloader_tpu.parallel.sha1_pallas import sha1_tiled as ref_sha1_tiled
from downloader_tpu_torch.parallel import engine as engine_mod
from downloader_tpu_torch.parallel import mesh, pack, sha1, sha1_cuda
from downloader_tpu_torch.parallel.engine import DigestEngine

EDGE_SIZES = (0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 16384)
REPO = Path(__file__).resolve().parents[1]


def _want(pieces):
    return [hashlib.sha1(p).digest() for p in pieces]


def _pieces(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in sizes]


def _ragged(seed=7, count=24, top=500):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in rng.integers(0, top, size=count)]


def _port_states(blocks, nblocks):
    """The port's plain SHA-1 on (B, 16, P) uint32 words → (5, P) uint32."""
    out = sha1_cuda.sha1_states(
        torch.from_numpy(np.ascontiguousarray(blocks).view(np.int32)),
        torch.from_numpy(np.ascontiguousarray(nblocks, dtype=np.int32)),
    )
    return out.numpy().view(np.uint32)


def _tensors(blocks, nblocks):
    return (
        torch.from_numpy(np.ascontiguousarray(blocks).view(np.int32)),
        torch.from_numpy(np.ascontiguousarray(nblocks, dtype=np.int32)),
    )


class TestPack:
    @pytest.mark.parametrize("size", EDGE_SIZES)
    def test_pad_piece_and_block_count_match_reference(self, size):
        (piece,) = _pieces([size], seed=size)
        assert pack.block_count(size) == ref_pack.block_count(size)
        np.testing.assert_array_equal(
            pack.pad_piece(piece), ref_pack.pad_piece(piece)
        )

    def test_pack_equals_reference_flat(self):
        pieces = _pieces(EDGE_SIZES)
        blocks, nblocks = pack.pack_pieces(pieces)
        want_blocks, want_counts = pack.from_reference_flat(
            *ref_pack.pack_pieces(pieces)
        )
        assert blocks.dtype == np.uint32 and blocks.shape == (257, 16, 14)
        np.testing.assert_array_equal(blocks, want_blocks)
        np.testing.assert_array_equal(nblocks, want_counts)

    def test_pack_equals_reference_tiled(self):
        pieces = _pieces(EDGE_SIZES)
        blocks, nblocks = pack.pack_pieces(pieces)
        tiled_blocks, tiled_counts = pack.from_reference_tiled(
            *ref_pack.pack_pieces_tiled(pieces)
        )
        count = len(pieces)
        assert tiled_blocks.shape == (257, 16, 1024)
        np.testing.assert_array_equal(tiled_blocks[:, :, :count], blocks)
        np.testing.assert_array_equal(tiled_counts[:count], nblocks)
        assert not tiled_blocks[:, :, count:].any()
        assert not tiled_counts[count:].any()

    def test_device_layout_equals_host_layout(self):
        pieces = _ragged(seed=11, count=9, top=300)
        raw, counts = pack.pack_bytes(pieces)
        blocks, want_counts = pack.pack_pieces(pieces)
        laid_out = pack.to_gpu_layout(torch.from_numpy(raw))
        assert laid_out.dtype == torch.int32 and laid_out.is_contiguous()
        np.testing.assert_array_equal(laid_out.numpy().view(np.uint32), blocks)
        np.testing.assert_array_equal(counts, want_counts)

    def test_pack_bytes_into_a_dirty_buffer(self):
        pieces = _ragged(seed=5, count=6, top=200)
        clean, counts = pack.pack_bytes(pieces)
        dirty = np.full_like(clean, 0xA5)
        raw, dirty_counts = pack.pack_bytes(pieces, out=dirty)
        assert raw is dirty
        np.testing.assert_array_equal(raw, clean)
        np.testing.assert_array_equal(dirty_counts, counts)
        with pytest.raises(ValueError):
            pack.pack_bytes(pieces, out=np.zeros((1, 64), dtype=np.uint8))

    def test_digest_words_round_trip(self):
        digests = _want(_pieces([0, 10, 100]))
        words = pack.expected_words(digests)
        assert words.dtype == np.uint32 and words.shape == (3, 5)
        assert pack.digests_to_bytes(words.T, 3) == digests
        assert pack.digests_to_bytes(words.T.view(np.int32), 2) == digests[:2]

    def test_digests_from_reference_flat_and_tiled(self):
        pieces = _pieces(EDGE_SIZES[:6])
        flat = np.asarray(ref_sha1_blocks(*ref_pack.pack_pieces(pieces)))
        states = pack.digests_from_reference(flat)
        assert states.shape == (5, len(pieces))
        assert pack.digests_to_bytes(states, len(pieces)) == _want(pieces)
        tiled = np.asarray(
            ref_sha1_tiled(*ref_pack.pack_pieces_tiled(pieces), interpret=True)
        )
        states = pack.digests_from_reference(tiled)
        assert states.shape == (5, 1024)
        assert pack.digests_to_bytes(states, len(pieces)) == _want(pieces)


class TestPlainSha1:
    def test_edge_sizes_match_hashlib(self):
        pieces = _pieces(EDGE_SIZES, seed=1)
        states = _port_states(*pack.pack_pieces(pieces))
        assert pack.digests_to_bytes(states, len(pieces)) == _want(pieces)

    def test_known_vectors(self):
        # FIPS 180-4 / RFC 3174 test vectors
        vectors = {
            b"abc": "a9993e364706816aba3e25717850c26c9cd0d89d",
            b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq":
                "84983e441c3bd26ebaae4aa1f95129e5e54670f1",
            b"": "da39a3ee5e6b4b0d3255bfef95601890afd80709",
        }
        pieces = list(vectors)
        states = _port_states(*pack.pack_pieces(pieces))
        got = pack.digests_to_bytes(states, len(pieces))
        assert [g.hex() for g in got] == list(vectors.values())

    def test_ragged_batch_matches_reference_xla_kernel(self):
        pieces = [_pieces([64 * k + 7], seed=k)[0] for k in range(6)]
        pieces += _ragged(seed=3, count=10, top=700)
        ref_blocks, ref_counts = ref_pack.pack_pieces(pieces, pad_to=8)
        ref_states = np.asarray(ref_sha1_blocks(ref_blocks, ref_counts))
        states = _port_states(*pack.from_reference_flat(ref_blocks, ref_counts))
        np.testing.assert_array_equal(states, ref_states.T)
        assert pack.digests_to_bytes(states, len(pieces)) == _want(pieces)

    def test_edge_sizes_match_reference_pallas_kernel(self):
        pieces = _pieces(EDGE_SIZES, seed=2)
        ref_blocks, ref_counts = ref_pack.pack_pieces_tiled(pieces)
        ref_states = np.asarray(
            ref_sha1_tiled(ref_blocks, ref_counts, interpret=True)
        )
        states = _port_states(*pack.from_reference_tiled(ref_blocks, ref_counts))
        # every lane, the 1010 padding lanes (H0) included
        np.testing.assert_array_equal(
            states, pack.digests_from_reference(ref_states)
        )
        assert (states[:, len(pieces):] == np.array(pack.H0)[:, None]).all()

    def test_lanes_freeze_independently(self):
        pieces = _pieces([200, 10, 130, 0, 64])
        blocks, nblocks = pack.pack_pieces(pieces)
        states = _port_states(blocks, nblocks)
        for lane, piece in enumerate(pieces):
            alone = _port_states(*pack.pack_pieces([piece]))
            np.testing.assert_array_equal(states[:, lane], alone[:, 0])
        # a lane with no blocks keeps H0, whatever its words hold
        nblocks[1] = 0
        states = _port_states(blocks, nblocks)
        assert states[:, 1].tolist() == list(pack.H0)

    def test_block_count_above_b_is_clamped(self):
        pieces = _pieces([10, 100])
        blocks, nblocks = pack.pack_pieces(pieces)
        assert blocks.shape[0] == 2 and nblocks.tolist() == [1, 2]
        # a count above B runs min(nblocks, B) blocks, as the kernel does
        want = _port_states(blocks, np.array([2, 2], dtype=np.int32))
        states = _port_states(blocks, np.array([50, 2], dtype=np.int32))
        np.testing.assert_array_equal(states, want)


def _expected(pieces, count=None):
    want = np.zeros((count or len(pieces), 5), dtype=np.uint32)
    for lane, digest in enumerate(_want(pieces)):
        want[lane] = np.frombuffer(digest, dtype=">u4").astype(np.uint32)
    return want


class TestVerifyStep:
    def test_matches_reference_with_padding_and_a_flipped_word(self):
        pieces = _ragged(seed=9, count=13, top=400)
        ref_blocks, ref_counts = ref_pack.pack_pieces(pieces, pad_to=16)
        want = _expected(pieces, count=16)
        want[4, 2] ^= 1 << 7
        want[14] = 0xFFFFFFFF  # a padding lane: reads ok whatever it holds
        ref_ok, ref_bad = ref_verify_step(ref_blocks, ref_counts, want)
        ok, bad = mesh.verify_step(
            *_tensors(*pack.from_reference_flat(ref_blocks, ref_counts)),
            torch.from_numpy(want.view(np.int32)),
        )
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
        assert int(bad) == int(ref_bad) == 1
        assert not ok[4] and bool(ok[13:].all())


CPU8 = [torch.device("cpu")] * 8


class TestDeviceSplit:
    """The counterpart of test_parallel.TestShardedVerify: the batch cut
    into one shard per device, the mismatch counts summed."""

    def _shipped(self, pieces):
        raw, counts = pack.pack_bytes(pieces)
        return torch.from_numpy(raw), torch.from_numpy(counts)

    def test_split_digest_equals_unsplit(self):
        pieces = _ragged(seed=4, count=24, top=500)
        raw, counts = self._shipped(pieces)
        split = mesh.digest_split(raw, counts, CPU8)
        whole = mesh.digest_split(raw, counts, CPU8[:1])
        assert torch.equal(split, whole)
        assert pack.digests_to_bytes(split.numpy(), 24) == _want(pieces)

    def test_split_verify_matches(self):
        pieces = _pieces([500] * 24, seed=6)
        raw, counts = self._shipped(pieces)
        want = torch.from_numpy(_expected(pieces).view(np.int32))
        ok, mismatches = mesh.verify_split(raw, counts, want, CPU8)
        assert bool(ok.all()) and mismatches == 0

    def test_split_verify_counts_mismatches_across_shards(self):
        pieces = _pieces([100] * 16, seed=8)
        raw, counts = self._shipped(pieces)
        want = _expected(pieces)
        want[3] ^= 1  # two corrupt lanes on different shards
        want[12] ^= 1
        ok, mismatches = mesh.verify_split(
            raw, counts, torch.from_numpy(want.view(np.int32)), CPU8
        )
        whole_ok, whole_bad = mesh.verify_step(
            pack.to_gpu_layout(raw), counts, torch.from_numpy(want.view(np.int32))
        )
        assert mismatches == int(whole_bad) == 2
        assert torch.equal(ok, whole_ok)
        assert not ok[3] and not ok[12]
        assert bool(ok[[0, 1, 2, 4, 5, 11, 13, 15]].all())

    def test_fewer_pieces_than_devices(self):
        pieces = _pieces([1, 70, 300])
        raw, counts = self._shipped(pieces)
        states = mesh.digest_split(raw, counts, CPU8)
        assert pack.digests_to_bytes(states.numpy(), 3) == _want(pieces)


@pytest.fixture
def no_cuda(monkeypatch):
    """This host as one without a card, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestDigestEngine:
    @pytest.mark.parametrize("backend", ["auto", "cuda", "hashlib"])
    def test_matches_reference_engine_and_hashlib(self, backend, monkeypatch):
        monkeypatch.setenv("DIGEST_OFFLOAD", "always")
        engine = DigestEngine(backend=backend, device="cpu", min_batch=1)
        pieces = _pieces(EDGE_SIZES[:-1], seed=12)
        reference = RefEngine(backend="jax")
        digests = engine.sha1_many(pieces)
        assert digests == reference.sha1_many(pieces) == _want(pieces)
        expected = _want(pieces)
        expected[5] = bytes(20)
        verdicts = engine.verify_pieces(pieces, expected)
        assert verdicts == reference.verify_pieces(pieces, expected)
        assert verdicts == [i != 5 for i in range(len(pieces))]
        if backend == "hashlib":
            assert engine.backend_name == "hashlib"
            assert engine.device_batches == 0
        else:
            assert engine.device_batches == 2 and engine.host_batches == 0

    def test_length_mismatch_raises(self):
        engine = DigestEngine(backend="cuda", device="cpu")
        with pytest.raises(ValueError, match="length mismatch"):
            engine.verify_pieces([b"a"], [])

    def test_bad_digest_length_raises(self):
        engine = DigestEngine(backend="cuda", device="cpu")
        with pytest.raises(ValueError, match="20 bytes"):
            engine.verify_pieces([b"x" * 10] * 9, [b"short"] * 9)

    def test_empty_batch(self):
        engine = DigestEngine(backend="cuda", device="cpu")
        assert engine.sha1_many([]) == []
        assert engine.verify_pieces([], []) == []
        assert engine.device_batches == engine.host_batches == 0

    def test_unknown_backend_rejected(self):
        for backend in ("jax", "pallas", "triton"):
            with pytest.raises(ValueError):
                DigestEngine(backend=backend, device="cpu")

    @pytest.mark.parametrize("mode", ["always", "never"])
    def test_offload_env_override(self, mode, monkeypatch):
        monkeypatch.setenv("DIGEST_OFFLOAD", mode)
        engine = DigestEngine(backend="auto", device="cpu", min_batch=1)
        engine._calibration = (1.0, 1.0, 1.0, 1.0)  # pricing never consulted
        pieces = _pieces([64] * 3)
        assert engine.sha1_many(pieces) == _want(pieces)
        device = 1 if mode == "always" else 0
        assert (engine.device_batches, engine.host_batches) == (device, 1 - device)
        assert engine.backend_name == (
            f"auto(torch-sha1[cpu]: {device} device, {1 - device} hashlib batches)"
        )

    def test_small_batch_takes_hashlib_as_policy(self, monkeypatch):
        monkeypatch.setenv("DIGEST_OFFLOAD", "always")
        engine = DigestEngine(backend="auto", device="cpu", min_batch=8)
        pieces = _pieces([64] * 7)
        assert engine.sha1_many(pieces) == _want(pieces)
        assert (engine.device_batches, engine.host_batches) == (0, 1)
        assert engine._calibration is None  # not even priced

    def test_no_cuda_raises_instead_of_falling_back(self, no_cuda):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DigestEngine()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DigestEngine(backend="cuda")
        with pytest.raises(RuntimeError, match="not available"):
            DigestEngine(backend="cuda", device="cuda")
        assert DigestEngine(backend="hashlib").backend_name == "hashlib"

    def test_default_engine_is_shared_and_needs_a_card(self, no_cuda, monkeypatch):
        monkeypatch.setattr(engine_mod, "_default", None)
        with pytest.raises(RuntimeError):
            engine_mod.default_engine()
        shared = DigestEngine(backend="hashlib")
        monkeypatch.setattr(engine_mod, "_default", shared)
        assert engine_mod.default_engine() is shared

    def test_device_list_and_unsupported_device(self):
        engine = DigestEngine(backend="cuda", device=["cpu", "cpu"])
        assert engine.backend_name == "torch-sha1[cpu,cpu]"
        pieces = _ragged(seed=2, count=5, top=300)
        assert engine.sha1_many(pieces) == _want(pieces)
        with pytest.raises(ValueError):
            DigestEngine(backend="cuda", device="meta")
        with pytest.raises(ValueError):
            DigestEngine(backend="cuda", device=[])


class _Sized:
    """A length without the bytes: prices large batches without
    allocating them (only len() is consulted)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


class TestOffloadPolicy:
    def _engine(self, hashlib_bps, transfer_bps, sync_s, block_s=0.0):
        engine = DigestEngine(backend="auto", device="cpu", min_batch=1)
        engine._calibration = (hashlib_bps, transfer_bps, sync_s, block_s)
        return engine

    def test_slow_link_never_offloads(self):
        engine = self._engine(1.4e9, 25e6, 0.067)
        assert not engine._worth_offloading([_Sized(1 << 20)] * 1024)

    def test_fast_link_offloads_dense_batches_only(self):
        engine = self._engine(1.4e9, 25e9, 20e-6)
        assert engine._worth_offloading([_Sized(1 << 20)] * 1024)
        # one long straggler pads every lane to its block count
        straggler = [_Sized(64)] * 1023 + [_Sized(1 << 30)]
        assert not engine._worth_offloading(straggler)

    def test_kernel_chain_keeps_few_long_pieces_on_the_host(self):
        # an H100-like card: each lane runs its 16,385 blocks of a 1 MiB
        # piece in turn at ~0.9 us a block, ~15 ms whatever the lane count
        engine = self._engine(1.36e9, 45e9, 33e-6, 0.9e-6)
        mib = _Sized(1 << 20)
        assert not engine._worth_offloading([mib] * 8)  # 6 ms on the host
        assert engine._worth_offloading([mib] * 64)  # 49 ms on the host
        assert engine._worth_offloading([mib] * 1024)
        # the same 8 pieces priced without the kernel would go to the card
        assert self._engine(1.36e9, 45e9, 33e-6)._worth_offloading([mib] * 8)

    def test_cost_model_prices_the_array_actually_shipped(self):
        engine = DigestEngine(backend="auto", device="cpu")
        rng = np.random.default_rng(3)
        for sizes in (
            [256 * 1024] * 7,
            [32 * 1024] * 40 + [100],
            [1],
            list(rng.integers(1, 100_000, size=50)),
        ):
            pieces = [b"\x00" * int(n) for n in sizes]
            raw, counts = engine._ship(pieces)
            assert engine.shipped_bytes(pieces) == raw.nbytes + counts.nbytes

    def test_calibration_measures_once(self):
        engine = DigestEngine(backend="auto", device="cpu", min_batch=1)
        first = engine._calibrate()
        assert engine._calibrate() is first
        assert all(rate > 0 for rate in first[:2]) and first[2] >= 0
        assert first[3] > 0  # the plain version's seconds per block here

    def test_calibration_once_under_concurrent_first_flush(self):
        engine = DigestEngine(backend="auto", device="cpu", min_batch=1)
        calls = []

        def fake_measure():
            calls.append(1)
            threading.Event().wait(0.05)  # a window wide enough for every racer
            return (1.4e9, 25e6, 0.067, 1e-6)

        engine._measure_calibration = fake_measure
        results = []
        workers = [
            threading.Thread(target=lambda: results.append(engine._calibrate()))
            for _ in range(8)
        ]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join()
        assert len(calls) == 1
        assert results == [(1.4e9, 25e6, 0.067, 1e-6)] * 8


class TestKernelWrapper:
    """Argument checks of the CUDA wrapper. A CPU tensor never reaches
    the kernel: it raises; sha1_states takes the plain version for it."""

    def _batch(self):
        return _tensors(*pack.pack_pieces(_pieces([10, 100])))

    def test_cpu_tensor_raises(self):
        blocks, nblocks = self._batch()
        before = sha1_cuda.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            sha1_cuda.sha1_batch_cuda(blocks, nblocks)
        assert sha1_cuda.launches == before

    def test_wrong_dtype_raises(self):
        blocks, nblocks = self._batch()
        with pytest.raises(TypeError):
            sha1_cuda.sha1_batch_cuda(blocks.to(torch.int64), nblocks)
        with pytest.raises(TypeError):
            sha1_cuda.sha1_states(blocks, nblocks.to(torch.int64))

    @pytest.mark.parametrize(
        "shape", [(3, 15, 2), (3, 16), (3, 16, 2, 1), (0, 16, 2), (3, 16, 0)]
    )
    def test_wrong_shape_raises(self, shape):
        blocks = torch.zeros(shape, dtype=torch.int32)
        nblocks = torch.ones(shape[-1] if len(shape) == 3 else 2, dtype=torch.int32)
        with pytest.raises(ValueError):
            sha1_cuda.sha1_batch_cuda(blocks, nblocks)

    def test_count_shape_and_contiguity_raise(self):
        blocks, nblocks = self._batch()
        with pytest.raises(ValueError):
            sha1_cuda.sha1_states(blocks, nblocks[:1])
        with pytest.raises(ValueError, match="contiguous"):
            sha1_cuda.sha1_states(blocks.transpose(0, 2).contiguous().transpose(0, 2), nblocks)

    def test_cpu_dispatch_takes_the_plain_version(self):
        blocks, nblocks = self._batch()
        before = sha1_cuda.launches
        states = sha1_cuda.sha1_states(blocks, nblocks)
        assert torch.equal(states, sha1.sha1_states(blocks, nblocks))
        assert sha1_cuda.launches == before

    def test_library_name_follows_the_source(self):
        name = sha1_cuda.library_name()
        digest = hashlib.sha256(sha1_cuda.SOURCE.read_bytes()).hexdigest()[:16]
        assert name == f"libsha1-{digest}.so"
        assert sha1_cuda._build_dir(REPO) == REPO / "build" / "downloader_tpu_torch"

    def test_ring_constant_matches_the_source(self):
        # the tests and chip_smoke.py size their cases by RING
        text = sha1_cuda.SOURCE.read_text()
        stages, stage_blocks = sha1_cuda.RING
        assert f"constexpr int kStages = {stages};" in text
        assert f"constexpr int kStageBlocks = {stage_blocks};" in text

    def test_installed_package_builds_into_the_user_cache(self, tmp_path, monkeypatch):
        # installed, the package's grandparent is site-packages: no
        # pyproject.toml there, so the build goes where the user can write
        site = tmp_path / "site-packages"
        site.mkdir()
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        cache = tmp_path / "xdg" / "downloader_tpu_torch"
        assert sha1_cuda._build_dir(site) == cache
        (tmp_path / "pyproject.toml").write_text("")
        assert sha1_cuda._build_dir(tmp_path) == tmp_path / "build" / "downloader_tpu_torch"


# The kernel the main path launches (16-byte copies), disassembled with
# cuobjdump -sass from a build of csrc/sha1.cu for sm_90a on the card and
# trimmed: each loop keeps its first and last instructions, its shared
# loads and stores, copies and barriers, and the first rounds of the round
# warp; addresses and branch targets are as built.
SASS_EXCERPT = """\
Function : _ZN39_GLOBAL__N__6ba34cf8_7_sha1_cu_c8eb647911sha1_kernelILi4EEEvPKjPKiPjii
        /*0360*/  IMAD.IADD R16, R7, 0x1, R16 ;
        /*0370*/  LOP3.LUT R0, R20.reuse, R22, R21, 0xb8, !PT ;
        /*0380*/  IMAD.IADD R17, R20, 0x1, R17 ;
        /*0390*/  SHF.L.W.U32.HI R14, R22, 0x1e, R22 ;
        /*03a0*/  IMAD.IADD R25, R21, 0x1, R18 ;
        /*03b0*/  LEA.HI R13, R23, R16, R23, 0x5 ;
        /*03c0*/  IMAD.IADD R27, R14, 0x1, R19 ;
        /*03d0*/  IMAD.IADD R12, R0, 0x1, R13 ;
        /*03e0*/  LOP3.LUT R13, R21, R23, R14, 0xb8, !PT ;
        /*03f0*/  LOP3.LUT R0, R6, 0x3, RZ, 0xc0, !PT ;
        /*0400*/  LEA.HI R16, R12.reuse, R17, R12.reuse, 0x5 ;
        /*0410*/  SHF.L.W.U32.HI R17, R23, 0x1e, R23 ;
        /*0420*/  SHF.L.W.U32.HI R19, R12, 0x1e, R12 ;
        /*0430*/  IMAD.IADD R16, R13, 0x1, R16 ;
        /*0440*/  LOP3.LUT R15, R14, R12, R17, 0xb8, !PT ;
        /*0450*/  IMAD R13, R0, 0x280, R5 ;
        /*04c0*/  LDS.128 R12, [R24+0x8400] ;
        /*05f0*/  LDS.128 R8, [R24+0x8600] ;
        /*0740*/  LDS.128 R12, [R24+0x8800] ;
        /*08a0*/  LDS.128 R8, [R24+0x8a00] ;
        /*09e0*/  LDS.128 R12, [R24+0x8c00] ;
        /*0b30*/  LDS.128 R8, [R24+0x8e00] ;
        /*0c90*/  LDS.128 R12, [R24+0x9000] ;
        /*0dd0*/  LDS.128 R8, [R24+0x9200] ;
        /*0f20*/  LDS.128 R12, [R24+0x9400] ;
        /*1080*/  LDS.128 R8, [R24+0x9600] ;
        /*11c0*/  LDS.128 R12, [R24+0x9800] ;
        /*1310*/  LDS.128 R8, [R24+0x9a00] ;
        /*1470*/  LDS.128 R12, [R24+0x9c00] ;
        /*15b0*/  LDS.128 R8, [R24+0x9e00] ;
        /*1700*/  LDS.128 R12, [R24+0xa000] ;
        /*1860*/  LDS.128 R8, [R24+0xa200] ;
        /*19b0*/  LDS.128 R16, [R24+0xa400] ;
        /*1ac0*/  LDS.128 R12, [R24+0xa600] ;
        /*1c90*/  @!P0 BAR.SYNC.DEFER_BLOCKING R27, 0x40 ;
        /*1e00*/  LDS.128 R16, [R28+0x8000] ;
        /*1e30*/  LDS.128 R8, [R28+0x8200] ;
        /*1e60*/  @!P1 BAR.ARV R6, 0x40 ;
        /*1f20*/  @!P1 BRA 0x360 ;
        /*3060*/  DEPBAR.LE SB0, 0x2 ;
        /*30b0*/  @P0 BRA 0x3520 ;
        /*3230*/  @!P4 LDGSTS.E.BYPASS.128 [R17], desc[UR6][R18.64], !P1 ;
        /*3260*/  @!P4 LDGSTS.E.BYPASS.128 [R17+0x200], desc[UR6][R12.64], !P1 ;
        /*3290*/  @!P4 LDGSTS.E.BYPASS.128 [R17+0x400], desc[UR6][R14.64], !P1 ;
        /*32a0*/  @!P4 LDGSTS.E.BYPASS.128 [R17+0x600], desc[UR6][R10.64], !P1 ;
        /*3320*/  @!P3 LDGSTS.E.BYPASS.128 [R17+0x800], desc[UR6][R10.64], !P1 ;
        /*3340*/  @!P3 LDGSTS.E.BYPASS.128 [R17+0xa00], desc[UR6][R8.64], !P1 ;
        /*3360*/  @!P3 LDGSTS.E.BYPASS.128 [R17+0xc00], desc[UR6][R20.64], !P1 ;
        /*3370*/  @!P3 LDGSTS.E.BYPASS.128 [R17+0xe00], desc[UR6][R22.64], !P1 ;
        /*3410*/  @!P2 LDGSTS.E.BYPASS.128 [R17+0x1000], desc[UR6][R20.64], !P1 ;
        /*3440*/  @!P2 LDGSTS.E.BYPASS.128 [R17+0x1200], desc[UR6][R18.64], !P1 ;
        /*3460*/  @!P2 LDGSTS.E.BYPASS.128 [R17+0x1400], desc[UR6][R14.64], !P1 ;
        /*3480*/  @!P2 LDGSTS.E.BYPASS.128 [R17+0x1600], desc[UR6][R12.64], !P1 ;
        /*34e0*/  @!P0 LDGSTS.E.BYPASS.128 [R17+0x1800], desc[UR6][R14.64], !P1 ;
        /*34f0*/  @!P0 LDGSTS.E.BYPASS.128 [R17+0x1a00], desc[UR6][R10.64], !P1 ;
        /*3500*/  @!P0 LDGSTS.E.BYPASS.128 [R17+0x1c00], desc[UR6][R8.64], !P1 ;
        /*3510*/  @!P0 LDGSTS.E.BYPASS.128 [R17+0x1e00], desc[UR6][R20.64], !P1 ;
        /*35b0*/  ISETP.GE.AND P0, PT, R28, R3, PT ;
        /*35c0*/  @P0 BRA 0x49c0 ;
        /*35d0*/  ISETP.GE.AND P0, PT, R28.reuse, 0x4, PT ;
        /*35e0*/  VIADD R28, R28, 0x1 ;
        /*35f0*/  @P0 VIADD R8, R26.reuse, 0x5 ;
        /*3600*/  @P0 WARPSYNC.ALL ;
        /*3610*/  @P0 NOP ;
        /*3620*/  @P0 BAR.SYNC.DEFER_BLOCKING R8, 0x40 ;
        /*3630*/  VIADD R26, R26, 0x1 ;
        /*3670*/  LDS R23, [R27] ;
        /*3680*/  LDS R22, [R27+0x80] ;
        /*3690*/  LDS R21, [R27+0x100] ;
        /*36a0*/  LDS R20, [R27+0x180] ;
        /*36b0*/  LDS R39, [R27+-0x300] ;
        /*36c0*/  LDS R18, [R27+0x280] ;
        /*36d0*/  LDS R40, [R27+-0x400] ;
        /*36e0*/  LDS R37, [R27+-0x280] ;
        /*36f0*/  LDS R17, [R27+0x300] ;
        /*3700*/  LDS R38, [R27+-0x380] ;
        /*3710*/  LDS R36, [R27+-0x200] ;
        /*3730*/  LDS R16, [R27+0x380] ;
        /*3750*/  LDS R35, [R27+-0x180] ;
        /*3770*/  LDS R34, [R27+-0x100] ;
        /*3790*/  LDS R19, [R27+0x200] ;
        /*37b0*/  LDS R33, [R27+-0x80] ;
        /*37d0*/  STS.128 [R25+-0x2200], R12 ;
        /*3840*/  STS.128 [R25+-0x2600], R8 ;
        /*3970*/  STS.128 [R25+-0x2400], R8 ;
        /*3aa0*/  STS.128 [R25+-0x2000], R8 ;
        /*3bd0*/  STS.128 [R25+-0x1e00], R8 ;
        /*3d00*/  STS.128 [R25+-0x1c00], R8 ;
        /*3e30*/  STS.128 [R25+-0x1a00], R8 ;
        /*3f60*/  STS.128 [R25+-0x1800], R8 ;
        /*4090*/  STS.128 [R25+-0x1600], R8 ;
        /*41c0*/  STS.128 [R25+-0x1400], R8 ;
        /*42d0*/  STS.128 [R25+-0x1200], R8 ;
        /*43f0*/  STS.128 [R25+-0x1000], R8 ;
        /*4470*/  STS.128 [R25+-0xe00], R8 ;
        /*44c0*/  STS.128 [R25+-0xc00], R8 ;
        /*4510*/  STS.128 [R25+-0xa00], R8 ;
        /*46d0*/  STS.128 [R25+-0x600], R8 ;
        /*4950*/  STS.128 [R25+-0x800], R8 ;
        /*4960*/  STS.128 [R25+-0x400], R12 ;
        /*4970*/  STS.128 [R25+-0x200], R16 ;
        /*4980*/  STS.128 [R25], R20 ;
        /*49a0*/  BAR.ARV R26, 0x40 ;
        /*49b0*/  @!P0 BRA 0x35b0 ;
        /*49f0*/  @!P0 BRA 0x3050 ;
"""

# two rounds of the chain-floor probe's loop from the same build: the
# round is LEA.HI (rotl5(a) + e + wk) then IMAD.IADD (+ f), f's LOP3 and
# rotl30's SHF beside them
PROBE_ROUNDS = [
    "IMAD.IADD R11, R5, 0x1, R0.reuse",
    "LOP3.LUT R5, R7.reuse, R4, R9, 0xb8, !PT",
    "IMAD.IADD R10, R7, 0x1, R0",
    "SHF.L.W.U32.HI R4, R4, 0x1e, R4",
    "IMAD.IADD R12, R9.reuse, 0x1, R0",
    "LEA.HI R8, R6, R11, R6, 0x5",
    "UIADD3 UR4, UR4, 0x1, URZ",
    "LOP3.LUT R7, R9, R6, R4, 0xb8, !PT",
    "IMAD.IADD R11, R4, 0x1, R0",
    "SHF.L.W.U32.HI R6, R6, 0x1e, R6",
    "IMAD.IADD R5, R5, 0x1, R8",
    "LEA.HI R10, R5.reuse, R10, R5.reuse, 0x5",
    "LOP3.LUT R8, R4, R5, R6, 0xb8, !PT",
    "SHF.L.W.U32.HI R5, R5, 0x1e, R5",
    "IMAD.IADD R7, R7, 0x1, R10",
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class TestSassCounter:
    """chip_smoke.py's count of the built kernel's instructions a block,
    on real SASS: a parser regression fails here, not only on the card."""

    def test_functions_and_loops(self):
        smoke = _chip_smoke()
        functions = smoke.sass_functions(SASS_EXCERPT)
        (name,) = functions
        assert re.search(smoke.MAIN_FUNCTION, name)
        code = functions[name]
        assert len(code) == 105 and code[0] == (0x360, "IMAD.IADD R16, R7, 0x1, R16")
        # guard predicates are stripped; LDS RZ-style dummies are apart
        assert (0x1f20, "BRA 0x360") in code
        assert smoke._loops(code) == [(0x360, 0x1F20), (0x3050, 0x49F0), (0x35B0, 0x49B0)]
        assert smoke._opcode("LDS RZ, [RZ]") == "LDS.RZ"
        assert smoke._opcode("LDS.128 R12, [R24+0x8400]") == "LDS"

    def test_block_cost_by_pipe_and_warp(self):
        smoke = _chip_smoke()
        cost = smoke.sass_block_cost(SASS_EXCERPT, smoke.MAIN_FUNCTION, stage_blocks=4)
        assert cost["blocks_per_trip"] == {"schedule": 1, "rounds": 1}
        # round warp: 16 rounds' instructions (LOP3 4, SHF 3, LEA 2 on the
        # ALU pipe; IMAD 7 on the FMA pipe), 20 LDS.128, 2 BAR, 1 BRA
        rounds = cost["round_warp"]
        assert (rounds["issued"], rounds["alu"], rounds["fma"]) == (39, 9, 7)
        assert rounds["warp_clocks"] == 39  # issue-bound: 1 a clock
        assert rounds["by_opcode"]["LDS"] == 20
        # schedule warp: its block loop (47) plus the stage loop's own 19
        # (16 LDGSTS, DEPBAR, 2 BRA) over the stage's 4 blocks
        schedule = cost["schedule_warp"]
        assert schedule["issued"] == 47 + 19 / 4
        assert (schedule["alu"], schedule["fma"]) == (2, 3)  # ISETP; VIADD
        assert schedule["by_opcode"]["STS"] == 20 and schedule["by_opcode"]["LDS"] == 16
        assert cost["copies"] == 4  # 16-byte copies a lane, 2 KiB a warp
        assert cost["issued"] == 39 + 47 + 19 / 4
        assert (cost["alu"], cost["fma"]) == (11, 10)
        assert cost["sm_clocks"] == pytest.approx((39 + 47 + 19 / 4) / 128)
        assert "warp_clocks" not in cost
        # the longest chain: IMAD.IADD 0x360 -> LEA.HI 0x3b0 -> IMAD.IADD
        # 0x3d0 -> LEA.HI 0x400 -> IMAD.IADD 0x430
        assert cost["chain_depth"] == 5

    def test_a_round_is_two_dependent_instructions(self):
        smoke = _chip_smoke()
        # e + wk (IMAD.IADD R11, off the chain: ready a round early), then
        # a -> LEA.HI R8 -> IMAD.IADD R5 -> LEA.HI R10 -> IMAD.IADD R7
        assert smoke.chain_depth(PROBE_ROUNDS) == 1 + 2 * 2
        # a round's chain, alone: LEA.HI then IMAD.IADD
        assert smoke.chain_depth(PROBE_ROUNDS[5:6] + PROBE_ROUNDS[10:11]) == 2

    def test_block_cost_needs_the_loops_it_divides_by(self):
        smoke = _chip_smoke()
        without_stores = "\n".join(
            line for line in SASS_EXCERPT.splitlines() if "STS" not in line
        )
        with pytest.raises(AssertionError, match="schedule loop"):
            smoke.sass_block_cost(without_stores, smoke.MAIN_FUNCTION, stage_blocks=4)
        with pytest.raises(AssertionError, match="names"):
            smoke.sass_block_cost(SASS_EXCERPT, "no_such_kernel", stage_blocks=4)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_triton_or_reference_package():
    files = sorted((REPO / "downloader_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    # the port's chaos and profiling tooling
    files += [REPO / "hack" / name for name in (
        "pipeline_torch.py", "fleet_torch.py", "failpoint_matrix_torch.py",
        "profile_artifacts_torch.py")]
    # the port's benchmark twins, which also keep their own copies of
    # what they need from the reference's root scripts
    roots = [REPO / name for name in (
        "bench_torch.py", "bench_digest_torch.py", "__graft_entry_torch__.py")]
    files += roots
    assert len(files) > 20
    offenders = [
        f"{path.relative_to(REPO)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if name.split(".")[0] in ("jax", "jaxlib", "triton", "downloader_tpu")
        or (path in roots and name.split(".")[0] in ("bench", "bench_digest"))
    ]
    assert offenders == []


def test_jax_runs_on_the_cpu_here():
    # the reference side of every comparison above ran on the CPU backend
    assert jax.devices()[0].platform == "cpu"
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
