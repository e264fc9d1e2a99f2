"""The CUDA SHA-1 kernel (csrc/sha1.cu): build, bind and launch.

The kernel replaces the JAX package's Pallas kernel
(downloader_tpu/parallel/sha1_pallas.py:_sha1_kernel). It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C entry,
at first use, into ``build/downloader_tpu_torch/`` under the checkout
(an installed package builds into ``~/.cache/downloader_tpu_torch/``);
the file name carries a hash of the source, so an edited ``.cu``
rebuilds. It is loaded with ``ctypes``.

:func:`sha1_states` is what the rest of the package calls: for tensors
on the CPU it runs the plain PyTorch version (parallel/sha1.py), for
CUDA tensors it launches the kernel or raises — there is no fallback.
:func:`sha1_batch_cuda` is the kernel wrapper itself; ``launches``
counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import sha1

SOURCE = Path(__file__).resolve().parent / "csrc" / "sha1.cu"
# the kernel's message ring: kStages stages of kStageBlocks blocks
RING = (4, 4)


def _build_dir(root: Path) -> Path:
    """Where the library is built: ``build/downloader_tpu_torch/`` when
    the package lies in a checkout (``root`` holds its pyproject.toml),
    else the user's cache, for an installed package whose site-packages
    may not be writable."""
    if (root / "pyproject.toml").is_file():
        return root / "build" / "downloader_tpu_torch"
    return Path.home() / ".cache" / "downloader_tpu_torch"


BUILD_DIR = _build_dir(Path(__file__).resolve().parents[2])
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# kernel launches since import (or the last reset by a caller); bumped
# under _count_lock right after a launch the runtime accepted
launches = 0
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_library: ctypes.CDLL | None = None
# nvcc's output (ptxas register/spill report) from the build this
# process made; empty when the library was already built
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); it is "
            f"needed to build {SOURCE.name}"
        )
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libsha1-{digest}.so"


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    raise with nvcc's output if the build fails."""
    global build_log
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    command = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(SOURCE)]
    result = subprocess.run(command, capture_output=True, text=True)
    if result.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {SOURCE} (exit {result.returncode}):\n"
            f"{result.stderr}{result.stdout}"
        )
    os.replace(partial, target)
    build_log = result.stderr + result.stdout
    return target


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _library
    with _build_lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            lib.sha1_batch.argtypes = [
                ctypes.c_void_p,  # blocks
                ctypes.c_void_p,  # nblocks
                ctypes.c_void_p,  # out
                ctypes.c_int,  # P
                ctypes.c_int,  # B
                ctypes.c_void_p,  # cudaStream_t
            ]
            lib.sha1_batch.restype = ctypes.c_int
            _library = lib
        return _library


def _check(blocks: torch.Tensor, nblocks: torch.Tensor) -> None:
    if blocks.dtype != torch.int32 or nblocks.dtype != torch.int32:
        raise TypeError(
            f"blocks and nblocks must be int32, got {blocks.dtype} and "
            f"{nblocks.dtype}"
        )
    if (
        blocks.dim() != 3
        or blocks.shape[1] != 16
        or nblocks.shape != (blocks.shape[2],)
    ):
        raise ValueError(
            "want blocks (B, 16, P) and nblocks (P,), got "
            f"{tuple(blocks.shape)} and {tuple(nblocks.shape)}"
        )
    if blocks.shape[0] == 0 or blocks.shape[2] == 0:
        raise ValueError(f"empty batch: blocks {tuple(blocks.shape)}")
    if blocks.shape[0] >= 2**31 or blocks.shape[2] >= 2**31:  # C int P, B
        raise ValueError(f"batch too large: blocks {tuple(blocks.shape)}")
    if not (blocks.is_contiguous() and nblocks.is_contiguous()):
        raise ValueError("blocks and nblocks must be contiguous")
    if blocks.device != nblocks.device:
        raise ValueError(
            f"blocks on {blocks.device} but nblocks on {nblocks.device}"
        )


def sha1_batch_cuda(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream of the tensors' device.

    ``blocks`` (B, 16, P) int32 and ``nblocks`` (P,) int32, contiguous,
    on one CUDA device. Returns (5, P) int32 state words. Does not
    synchronise."""
    global launches
    _check(blocks, nblocks)
    if blocks.device.type != "cuda":
        raise ValueError(
            f"the CUDA SHA-1 kernel needs CUDA tensors, got {blocks.device}"
        )
    lib = load()
    num_blocks, _, count = blocks.shape
    out = torch.empty((5, count), dtype=torch.int32, device=blocks.device)
    # the launch goes to the thread's current device: make it the
    # tensors' device, whose current stream the kernel runs on
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        status = lib.sha1_batch(
            blocks.data_ptr(),
            nblocks.data_ptr(),
            out.data_ptr(),
            count,
            num_blocks,
            stream,
        )
    if status != 0:
        raise RuntimeError(
            f"sha1_batch launch failed with CUDA error {status} "
            f"(P={count}, B={num_blocks})"
        )
    with _count_lock:
        launches += 1
    return out


def sha1_states(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """(B, 16, P) int32 blocks + (P,) int32 counts → (5, P) int32 states:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if blocks.device.type != "cpu":
        return sha1_batch_cuda(blocks, nblocks)
    _check(blocks, nblocks)
    return sha1.sha1_states(blocks, nblocks)
