"""DigestEngine: the facade piece hashing and verification go through.

Policy lives here, math lives in pack.py / sha1.py / sha1_cuda.py /
mesh.py:

- **Backend.** ``cuda`` always runs the device path: pieces are packed
  on the host into the shipped byte layout (pinned memory when the
  device is a CUDA card), copied to the device, laid out and hashed by
  the CUDA kernel (on a CPU device, by the plain PyTorch version), and
  the digests or verdicts come back. ``hashlib`` always hashes on the
  host. ``auto`` takes the device path when the batch holds at least
  ``min_batch`` pieces AND a one-time calibration says the offload
  wins: ``raw_bytes/hashlib_rate > shipped_bytes/transfer_rate +
  sync_overhead + B * block_time``, with shipped bytes the padded array
  this batch's shape actually moves and ``B * block_time`` the kernel,
  whose lanes each run their B blocks in turn. Choosing hashlib there is policy, not a
  fallback: such batches are counted as ``host_batches``, apart from
  ``device_batches``, and ``backend_name`` reports both.
- **Devices.** ``device=None`` means every visible CUDA device, and the
  batch splits across them (mesh.py). With no CUDA device the engine
  raises; the plain PyTorch path on the host runs only when the caller
  asks for it with ``device="cpu"``. A CUDA failure raises too: the
  engine never swaps in hashlib behind the caller's back.
- ``DIGEST_OFFLOAD=always|never|auto`` overrides the ``auto`` decision.

The callers are fetch/pieces.py (resume re-verification of on-disk
pieces), fetch/swarmstate.py (batched live verification) and
fetch/seeder.py (hashing pieces when building a torrent).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..utils import get_logger
from . import mesh
from .pack import digests_to_bytes, expected_words, max_blocks, pack_bytes
from .sha1_cuda import sha1_states

log = get_logger("parallel")

_DEFAULT_MIN_BATCH = 8
_CALIBRATE_BYTES = 4 * 1024 * 1024
# blocks in the one-lane launch that prices the kernel: about 0.5 ms of
# the CUDA kernel; the plain version on the host is far slower per block
_CALIBRATE_BLOCKS = {"cuda": 1024, "cpu": 2}
BACKENDS = ("auto", "cuda", "hashlib")


def _timed(fn) -> float:
    start = time.perf_counter()
    fn()
    return time.perf_counter() - start


def resolve_devices(device=None) -> list[torch.device]:
    """``None`` → every visible CUDA device (raises if there is none);
    a device or a list of devices → that list."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for the digest engine; pass "
                "device='cpu' to run the plain PyTorch SHA-1 on the host"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    listed = device if isinstance(device, (list, tuple)) else [device]
    devices = [torch.device(d) for d in listed]
    if not devices:
        raise ValueError("empty device list")
    for i, dev in enumerate(devices):
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{dev} requested but CUDA is not available")
            if dev.index is None:
                devices[i] = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported digest device {dev}")
    return devices


class DigestEngine:
    """Batched SHA-1 with accelerator offload."""

    def __init__(
        self,
        backend: str = "auto",
        device=None,
        min_batch: int = _DEFAULT_MIN_BATCH,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown digest backend {backend!r}")
        self._backend = backend
        self._min_batch = max(1, min_batch)
        self.devices = [] if backend == "hashlib" else resolve_devices(device)
        self._pinned = any(d.type == "cuda" for d in self.devices)
        self._count_lock = threading.Lock()
        self.device_batches = 0  # guarded-by: _count_lock
        self.host_batches = 0  # guarded-by: _count_lock
        # (hashlib_Bps, transfer_Bps, sync_s, block_s) measured once;
        # None = not yet. One lock held across the whole measurement, so
        # concurrent first flushes pay for one probe, not one each.
        self._calibrate_lock = threading.Lock()
        self._calibration: tuple[float, float, float, float] | None = None

    # -- offload policy ---------------------------------------------------

    def _calibrate(self) -> tuple[float, float, float, float]:
        """Measure (hashlib B/s, host→device B/s, per-call sync seconds,
        kernel seconds per block) once for this engine's first device."""
        if self._calibration is not None:
            return self._calibration
        with self._calibrate_lock:
            if self._calibration is None:
                calibration = self._measure_calibration()
                log.with_fields(
                    hashlib_MBps=round(calibration[0] / 1e6),
                    transfer_MBps=round(calibration[1] / 1e6),
                    sync_ms=round(calibration[2] * 1e3, 3),
                    block_us=round(calibration[3] * 1e6, 3),
                ).info("digest offload calibration")
                self._calibration = calibration
        return self._calibration

    def _measure_calibration(self) -> tuple[float, float, float, float]:
        probe = os.urandom(_CALIBRATE_BYTES)
        hashlib_bps = _CALIBRATE_BYTES / max(
            _timed(lambda: hashlib.sha1(probe).digest()), 1e-9
        )
        device = self.devices[0]
        big = torch.frombuffer(bytearray(probe), dtype=torch.uint8)
        tiny = torch.zeros(64, dtype=torch.int32)
        if self._pinned:
            big, tiny = big.pin_memory(), tiny.pin_memory()

        def round_trip(host: torch.Tensor) -> None:
            # a copy in, one element back: the host waits for the device
            host.to(device, non_blocking=self._pinned)[:1].cpu()

        round_trip(tiny)  # warm the runtime
        sync_s = min(_timed(lambda: round_trip(tiny)) for _ in range(3))
        elapsed = min(_timed(lambda: round_trip(big)) for _ in range(2))
        transfer_bps = _CALIBRATE_BYTES / max(elapsed - sync_s, 1e-9)

        # One piece's chain of blocks: a lane's blocks run one after
        # another, so the kernel takes about B x this per launch whatever
        # the lane count, until the lanes fill the card (by then the copy
        # of their bytes costs far more than the kernel).
        count = _CALIBRATE_BLOCKS[device.type]
        blocks = torch.zeros((count, 16, 1), dtype=torch.int32, device=device)
        nblocks = torch.full((1,), count, dtype=torch.int32, device=device)

        def chain() -> None:
            sha1_states(blocks, nblocks)[:, :1].cpu()

        chain()  # builds and loads the kernel on a CUDA device
        elapsed = min(_timed(chain) for _ in range(2))
        block_s = max(elapsed - sync_s, 0.0) / count
        return hashlib_bps, transfer_bps, sync_s, block_s

    def shipped_bytes(self, pieces: Sequence[bytes]) -> int:
        """The bytes the host→device copy moves for this batch: the
        padded (P, B*64) message array plus the (P,) int32 block counts."""
        return len(pieces) * (max_blocks(pieces) * 64 + 4)

    def _worth_offloading(self, pieces: Sequence[bytes]) -> bool:
        """True when the device path beats hashing on the host:
        raw_bytes/hashlib > shipped_bytes/transfer + sync + B*block_s,
        the last term the kernel's chain of B blocks per lane."""
        mode = os.environ.get("DIGEST_OFFLOAD", "auto")
        if mode == "always":
            return True
        if mode == "never":
            return False
        hashlib_bps, transfer_bps, sync_s, block_s = self._calibrate()
        hash_s = sum(len(p) for p in pieces) / hashlib_bps
        kernel_s = max_blocks(pieces) * block_s
        device_s = self.shipped_bytes(pieces) / transfer_bps + sync_s + kernel_s
        return hash_s > device_s

    def _use_device(self, pieces: Sequence[bytes]) -> bool:
        if self._backend == "hashlib":
            use = False
        elif self._backend == "cuda":
            use = True
        else:
            use = len(pieces) >= self._min_batch and self._worth_offloading(pieces)
        with self._count_lock:
            if use:
                self.device_batches += 1
            else:
                self.host_batches += 1
        return use

    # -- the device path ----------------------------------------------------

    def _ship(self, pieces: Sequence[bytes]) -> tuple[torch.Tensor, torch.Tensor]:
        """Pack the batch into host tensors, pinned for a CUDA device."""
        width = max_blocks(pieces) * 64
        raw = torch.empty(
            (len(pieces), width), dtype=torch.uint8, pin_memory=self._pinned
        )
        _, nblocks = pack_bytes(pieces, out=raw.numpy())
        return raw, torch.from_numpy(nblocks)

    def _device_digests(self, pieces: Sequence[bytes]) -> list[bytes]:
        raw, nblocks = self._ship(pieces)
        states = mesh.digest_split(raw, nblocks, self.devices)
        return digests_to_bytes(states.numpy(), len(pieces))

    def _device_verify(
        self, pieces: Sequence[bytes], expected: Sequence[bytes]
    ) -> list[bool]:
        raw, nblocks = self._ship(pieces)
        want = torch.from_numpy(expected_words(expected).view(np.int32))
        ok, _ = mesh.verify_split(raw, nblocks, want, self.devices)
        return ok.tolist()

    # -- public API -----------------------------------------------------------

    def sha1_many(self, pieces: Sequence[bytes]) -> list[bytes]:
        """Digest a batch of byte strings; order-preserving."""
        if not pieces:
            return []
        if self._use_device(pieces):
            return self._device_digests(pieces)
        return [hashlib.sha1(p).digest() for p in pieces]

    def verify_pieces(
        self, pieces: Sequence[bytes], expected: Sequence[bytes]
    ) -> list[bool]:
        """Check each piece against its expected 20-byte digest."""
        if len(pieces) != len(expected):
            raise ValueError("pieces and expected digests length mismatch")
        if not pieces:
            return []
        for digest in expected:
            if len(digest) != 20:
                raise ValueError("expected digests must be 20 bytes")
        if self._use_device(pieces):
            return self._device_verify(pieces, expected)
        return [
            hashlib.sha1(piece).digest() == digest
            for piece, digest in zip(pieces, expected)
        ]

    @property
    def backend_name(self) -> str:
        if self._backend == "hashlib":
            return "hashlib"
        kind = "cuda-sha1" if self._pinned else "torch-sha1"
        path = f"{kind}[{','.join(str(d) for d in self.devices)}]"
        if self._backend == "cuda":
            return path
        with self._count_lock:
            device, host = self.device_batches, self.host_batches
        return f"auto({path}: {device} device, {host} hashlib batches)"


_default_lock = threading.Lock()
_default: DigestEngine | None = None


def default_engine() -> DigestEngine:
    """Process-wide shared engine on every visible CUDA device."""
    global _default
    with _default_lock:
        if _default is None:
            _default = DigestEngine()
        return _default
