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

Zipapp deployments (bin/downloader-torch.pyz, built by
hack/build_torch_pyz.py): ctypes cannot load a .so from inside a zip,
so when the package files are not real paths the loader pulls
``_rc4.so`` (shipped prebuilt in the archive) — or failing that the C
source — out via importlib.resources into the per-user cache
(utils/usercache.py) keyed by content hash, and loads/compiles from
there. An extracted .so that fails to load (foreign arch) falls through
to compiling the shipped source. First run pays one extraction; every
later run hits the cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from ..utils import usercache

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
    """Where a library goes when it cannot go beside its source: the
    per-user cache the port's CUDA kernel shares."""
    return usercache.cache_dir()


def _resource_bytes(name: str) -> bytes | None:
    """Read a packaged file through importlib.resources — works from a
    zipapp where plain paths do not exist."""
    try:
        import importlib.resources as resources

        return (
            resources.files(__package__).joinpath(name).read_bytes()
        )
    except Exception:
        return None


def _loadable(path: str) -> bool:
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def _materialize_from_archive() -> str | None:
    """Running from a zipapp: place a loadable .so in the cache dir —
    extract the shipped prebuilt if the archive has one AND it loads
    on this host (a foreign-arch .so must not dead-end us), else
    compile the shipped C source. Content-hash names make upgrades
    rebuild and concurrent processes converge on the same file."""
    cache = _cache_dir()
    so_bytes = _resource_bytes("_rc4.so")
    if so_bytes:
        digest = hashlib.sha1(so_bytes).hexdigest()[:12]
        try:
            # temp file, then os.replace: racers never half-load; a
            # foreign-arch .so is refused and falls through to the source
            placed = usercache.place(
                f"_rc4-{digest}.so", so_bytes, lambda path: _loadable(str(path))
            )
        except OSError:
            placed = None  # extraction failed: fall through to the source
        if placed is not None:
            return str(placed)
    c_bytes = _resource_bytes("_rc4.c")
    if not c_bytes:
        return None
    digest = hashlib.sha1(c_bytes).hexdigest()[:12]
    final = os.path.join(cache, f"_rc4-{digest}.so")
    if os.path.exists(final) and _loadable(final):
        return final
    tmp_c = None
    try:
        fd, tmp_c = tempfile.mkstemp(suffix=".c", dir=cache)
        with os.fdopen(fd, "wb") as handle:
            handle.write(c_bytes)
        return _compile_source(tmp_c, final)
    except OSError:
        return None
    finally:
        if tmp_c is not None:
            try:
                os.unlink(tmp_c)
            except OSError:
                pass


def _load() -> "ctypes.CDLL | None":
    global _lib
    if _lib is not None:
        return _lib or None
    with _lock:
        if _lib is not None:
            return _lib or None
        if os.path.exists(_SO_PATH):
            path = _SO_PATH
        elif not os.path.isfile(_C_PATH):
            # package files are not real paths: we are inside a zipapp
            path = _materialize_from_archive()
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
