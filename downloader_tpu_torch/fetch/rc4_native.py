"""RC4 stream cipher with a lazily-compiled native core.

MSE (fetch/mse.py) encrypts every payload byte with RC4; the reference
gets this at native speed from Go's crypto/rc4 via anacrolix. Here the
keystream loop is 40 lines of C (_rc4.c, the port's own copy of the JAX
package's source) compiled on first use with the system compiler into
the package directory (``_rc4.so``, beside its source) and loaded
through ctypes — no pybind11, no build-time dependency. When no compiler
is available (or the build fails) a pure-Python implementation takes
over: identical output (cross-checked in tests against RFC 6229 vectors
and the JAX package's RC4), just slower — fine for handshakes and tests,
throttling only bulk encrypted transfers on compiler-less hosts.

The port ships no zipapp, so the JAX package's extraction of a prebuilt
``_rc4.so`` out of an archive is not carried over: a read-only package
directory compiles into the per-user cache instead.
"""

from __future__ import annotations

import atexit
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_SO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_rc4.so")
_C_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_rc4.c")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None | bool" = None  # None = not tried, False = unavailable


def _find_compiler() -> str | None:
    return shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")


def _compile_source(src_path: str, final: str) -> str | None:
    """Compile C source to ``final`` via a temp file + atomic rename
    (a concurrent process never loads a half-written .so). Returns the
    loadable path — which is the temp file itself when the rename
    fails (cross-device, perms) — or None."""
    compiler = _find_compiler()
    if compiler is None:
        return None
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(final))
        os.close(fd)
        subprocess.run(
            [compiler, "-O2", "-shared", "-fPIC", "-o", tmp, src_path],
            check=True,
            capture_output=True,
            timeout=60,
        )
    except (subprocess.SubprocessError, OSError):
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None
    try:
        os.replace(tmp, final)
    except OSError:
        return tmp
    return final


def _compile() -> str | None:
    """Normal (on-disk) install: build _rc4.c next to itself, or into
    the per-user cache when the package dir is read-only. One compile
    attempt either way — a failed compile would fail identically on a
    retry, and probing the cache dir on compiler-less hosts would
    create an empty directory for nothing."""
    if not os.path.exists(_C_PATH) or _find_compiler() is None:
        return None
    if os.access(os.path.dirname(_SO_PATH), os.W_OK):
        return _compile_source(_C_PATH, _SO_PATH)
    return _compile_source(
        _C_PATH, os.path.join(_cache_dir(), "_rc4-local.so")
    )


def _cache_dir() -> str:
    """Per-user cache for the library when the package directory is
    read-only (XDG-style). The fallback when $HOME is unusable is a PER-USER,
    0700 directory under the tempdir — never the shared tempdir
    itself, where another local user could pre-plant a .so at the
    predictable content-hash name and have us CDLL it."""
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    candidates = [os.path.join(root, "downloader_tpu_torch")]
    uid = os.getuid() if hasattr(os, "getuid") else "win"
    candidates.append(
        os.path.join(tempfile.gettempdir(), f"downloader_tpu_torch-{uid}")
    )
    for path in candidates:
        try:
            os.makedirs(path, mode=0o700, exist_ok=True)
            stat = os.stat(path)
            if hasattr(os, "getuid") and (
                stat.st_uid != os.getuid() or stat.st_mode & 0o022
            ):
                continue  # squatted or group/other-writable: unsafe
            probe = os.path.join(path, ".probe")
            with open(probe, "w"):
                pass
            os.unlink(probe)
            return path
        except OSError:
            continue
    # last resort: a fresh private directory (0700 by construction);
    # per-process, so the cache is cold every run — safe over fast.
    # Removed at interpreter exit: on hosts whose $HOME/XDG cache is
    # permanently unusable this path runs EVERY process, and without
    # cleanup each run would strand one directory (plus a compiled
    # .so) in the tempdir forever
    path = tempfile.mkdtemp(prefix="downloader_tpu_torch-")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def _load() -> "ctypes.CDLL | None":
    global _lib
    if _lib is not None:
        return _lib or None
    with _lock:
        if _lib is not None:
            return _lib or None
        if os.path.exists(_SO_PATH):
            path = _SO_PATH
        else:
            path = _compile()
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                lib.rc4_init.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_size_t,
                ]
                lib.rc4_init.restype = None
                lib.rc4_crypt.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_size_t,
                ]
                lib.rc4_crypt.restype = None
            except (OSError, AttributeError):
                lib = None
        _lib = lib if lib is not None else False
    return lib


class RC4:
    """Stateful RC4; ``crypt`` both encrypts and decrypts (XOR stream).
    ``drop`` discards the first N keystream bytes (MSE uses 1024, the
    standard mitigation for RC4's biased early output)."""

    __slots__ = ("_native", "_st", "_S", "_i", "_j")

    def __init__(self, key: bytes, drop: int = 0):
        if not key:
            raise ValueError("RC4 key must be non-empty")
        lib = _load()
        self._native = lib
        if lib is not None:
            self._st = ctypes.create_string_buffer(258)
            lib.rc4_init(self._st, key, len(key))
        else:
            s = list(range(256))
            j = 0
            for i in range(256):
                j = (j + s[i] + key[i % len(key)]) & 0xFF
                s[i], s[j] = s[j], s[i]
            self._S, self._i, self._j = s, 0, 0
        if drop:
            self.crypt(bytes(drop))

    def crypt(self, data: bytes) -> bytes:
        if not data:
            return b""
        if self._native is not None:
            out = ctypes.create_string_buffer(len(data))
            self._native.rc4_crypt(self._st, bytes(data), out, len(data))
            return out.raw
        s = self._S
        i, j = self._i, self._j
        out = bytearray(len(data))
        for n, byte in enumerate(data):
            i = (i + 1) & 0xFF
            j = (j + s[i]) & 0xFF
            s[i], s[j] = s[j], s[i]
            out[n] = byte ^ s[(s[i] + s[j]) & 0xFF]
        self._i, self._j = i, j
        return bytes(out)
