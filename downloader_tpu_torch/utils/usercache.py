"""The per-user cache for the port's native libraries, and the nvcc that
builds the kernel.

Both of the port's native libraries may have to land outside the
package: the RC4 core (fetch/rc4_native.py) when the package directory
is read-only or lies inside a zipapp, and the CUDA SHA-1 kernel
(parallel/sha1_cuda.py) when it is compiled or extracted from an
archive. Both ask :func:`cache_dir` for the one place, which tries, in
the JAX package's order (downloader_tpu/fetch/rc4_native.py):

1. ``$XDG_CACHE_HOME/downloader_tpu_torch`` (``~/.cache`` when unset);
2. ``<tempdir>/downloader_tpu_torch-<uid>``, a per-user 0700 directory,
   never the shared tempdir itself, where another local user could plant
   a library at the predictable name and have it loaded;
3. a fresh ``mkdtemp``, removed at interpreter exit, one per process.

A candidate is taken only if it is a directory this user owns, that no
one else can write to, and that takes a file. :func:`place` writes a
library shipped inside an archive there, and :func:`find_nvcc` is the
one answer to where nvcc is, for the kernel module and for the zipapp
build (hack/build_torch_pyz.py), which must decide without torch.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Callable

NAME = "downloader_tpu_torch"

_lock = threading.Lock()
# the last resort of this process, made once and shared by both libraries
_fallback: str | None = None


def _usable(path: Path) -> bool:
    try:
        path.mkdir(mode=0o700, parents=True, exist_ok=True)
        stat = path.stat()
        if hasattr(os, "getuid") and (
            stat.st_uid != os.getuid() or stat.st_mode & 0o022
        ):
            return False  # squatted or group/other-writable: unsafe
        # a probe of this process's own: the workers of a fleet resolve
        # the cache at once, and with one shared name one worker's unlink
        # would fail another's check and split the cache
        fd, probe = tempfile.mkstemp(prefix=".probe-", dir=path)
        os.close(fd)
        os.unlink(probe)
        return True
    except OSError:
        return False


def cache_dir() -> str:
    """The first usable of the places above."""
    global _fallback
    xdg = os.environ.get("XDG_CACHE_HOME")
    root = Path(xdg) if xdg else Path(os.path.expanduser("~")) / ".cache"
    uid = os.getuid() if hasattr(os, "getuid") else "win"
    for path in (root / NAME, Path(tempfile.gettempdir()) / f"{NAME}-{uid}"):
        if _usable(path):
            return str(path)
    # last resort: a fresh private directory (0700 by construction);
    # the cache is cold every run, safe over fast. Removed at exit: on a
    # host whose cache is never usable every process comes here, and each
    # would otherwise strand a directory and a library in the tempdir
    with _lock:
        if _fallback is None or not os.path.isdir(_fallback):
            _fallback = tempfile.mkdtemp(prefix=f"{NAME}-")
            atexit.register(shutil.rmtree, _fallback, ignore_errors=True)
        return _fallback


def place(
    name: str, data: bytes, loads: Callable[[Path], bool] | None = None
) -> Path | None:
    """``data`` as the file ``name`` in the cache, for a library that
    ships inside an archive (ctypes cannot load from a zip). A file there
    with these bytes is reused; otherwise the bytes go to a temp file,
    then ``os.replace``, so a racing process never loads half a file.
    With ``loads``, a file that fails it (a library that does not load
    here) is neither reused nor written, and the result is None."""
    target = Path(cache_dir()) / name
    if target.is_file() and target.read_bytes() == data:
        if loads is None or loads(target):
            return target
    fd, partial = tempfile.mkstemp(suffix=target.suffix, dir=target.parent)
    try:
        with os.fdopen(fd, "wb") as sink:
            sink.write(data)
        if loads is not None and not loads(Path(partial)):
            os.unlink(partial)
            return None
        os.replace(partial, target)
    except BaseException:
        Path(partial).unlink(missing_ok=True)
        raise
    return target


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc`` (``/usr/local/cuda`` when unset), else
    the first nvcc on ``PATH``, else None."""
    candidate = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    return shutil.which("nvcc")
