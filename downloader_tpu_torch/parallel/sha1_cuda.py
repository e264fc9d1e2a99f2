"""The CUDA SHA-1 kernel (csrc/sha1.cu): build, bind and launch.

The kernel replaces the JAX package's Pallas kernel
(downloader_tpu/parallel/sha1_pallas.py:_sha1_kernel). It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C entry,
``libsha1-<hash>.so``, whose name carries a hash of the source, so an
edited ``.cu`` rebuilds and no library of another source is ever loaded.
:func:`build` takes the first of:

1. a prebuilt library beside this module (the CUDA image);
2. inside a zipapp, the same file in the archive, extracted to the
   per-user cache (utils/usercache.py);
3. in a checkout, ``build/downloader_tpu_torch/``, compiled there at
   first use;
4. otherwise the per-user cache, compiled there at first use (from an
   archive, the source is written out first: nvcc cannot read a zip).

``origin`` says which it was (``prebuilt``, ``archive`` or
``compiled``) and ``compile_s`` how long this process's compile took.
The library is loaded with ``ctypes``. ``python -m
downloader_tpu_torch.parallel --out DIR`` (parallel/__main__.py) calls
``build(DIR)`` and prints the path: the Makefile, the CUDA image and
the zipapp build call that step.

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
import subprocess
import threading
import time
from importlib import resources
from pathlib import Path

import torch

from ..utils import usercache
from . import sha1

_HERE = Path(__file__).resolve().parent
# a real file in a checkout or an install; inside a zipapp only a member
# of the archive, read through source_bytes()
SOURCE = _HERE / "csrc" / "sha1.cu"
# the kernel's message ring: kStages stages of kStageBlocks blocks
RING = (4, 4)
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
# where the library build() returned came from: "prebuilt", "archive"
# or "compiled"; None before the first call
origin: str | None = None
# seconds this process's nvcc run took; None when it compiled nothing
compile_s: float | None = None


def _build_dir(root: Path) -> Path:
    """Where the library is compiled: ``build/downloader_tpu_torch/``
    when the package lies in a checkout (``root`` holds its
    pyproject.toml), else the per-user cache, for an installed package
    whose site-packages may not be writable or for an archive."""
    if (root / "pyproject.toml").is_file():
        return root / "build" / "downloader_tpu_torch"
    return Path(usercache.cache_dir())


def _nvcc() -> str:
    found = usercache.find_nvcc()
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            f"when it is unset, and on PATH); it is needed to build "
            f"{library_name()} from {SOURCE.name}, and no prebuilt library "
            "of that name lies beside the module or in the archive"
        )
    return found


def source_bytes() -> bytes:
    """The kernel's source, read through the package's loader: a file in
    a checkout or an install, a member inside a zipapp."""
    return (resources.files(__package__) / "csrc" / "sha1.cu").read_bytes()


def library_name() -> str:
    digest = hashlib.sha256(source_bytes()).hexdigest()[:16]
    return f"libsha1-{digest}.so"


def _extract(name: str) -> Path | None:
    """Running from a zipapp: the archive's ``name`` placed in the
    per-user cache, or None if the archive has none. A cached file with
    other bytes (a compile of the same source) is replaced by the
    archive's."""
    member = resources.files(__package__) / name
    if not member.is_file():
        return None
    return usercache.place(name, member.read_bytes())


def _compile(target: Path) -> None:
    """nvcc with ``NVCC_FLAGS`` into ``target``; raise with its output
    if the build fails."""
    global build_log, compile_s
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    source, staged = SOURCE, None
    if not SOURCE.is_file():
        staged = target.with_name(f"{target.stem}.{os.getpid()}.cu")
        staged.write_bytes(source_bytes())
        source = staged
    command = [nvcc, *NVCC_FLAGS, "-o", str(partial), str(source)]
    start = time.perf_counter()
    try:
        result = subprocess.run(command, capture_output=True, text=True)
    finally:
        if staged is not None:
            staged.unlink(missing_ok=True)
    if result.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {SOURCE} (exit {result.returncode}):\n"
            f"{result.stderr}{result.stdout}"
        )
    os.replace(partial, target)
    compile_s = time.perf_counter() - start
    build_log = result.stderr + result.stdout


def build(out_dir: Path | None = None) -> Path:
    """The library of this source: found in the first of the places the
    module's docstring lists, or compiled into the first place that
    compiles. With ``out_dir``, compiled into that directory unless it
    holds the library already."""
    global origin
    name = library_name()
    if out_dir is None:
        beside = _HERE / name
        if beside.is_file():
            origin = "prebuilt"
            return beside
        if not _HERE.is_dir():
            extracted = _extract(name)
            if extracted is not None:
                origin = "archive"
                return extracted
        out_dir = _build_dir(_HERE.parents[1])
    target = Path(out_dir) / name
    if not target.is_file():
        _compile(target)
    origin = "compiled"
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
