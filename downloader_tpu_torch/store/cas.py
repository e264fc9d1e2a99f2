"""Bounded on-disk content-addressed cache: the fleet data plane's
shared artifact store.

The flow ledger shows the fleet's one big perf hole in numbers:
N workers fetch the same hot object N times (origin amplification ==
worker count on a zipf workload). This module is half of the fix — a
content-addressed cache on shared disk that every worker in a fleet
fronts its fetch lanes with, so a flash crowd costs ONE origin fetch
and every later job serves from verified local spans. The other half
(who gets to do that one fetch) lives in ``fetch/singleflight.py``.

Design points:

- **Content identity**, not URL identity: ``content_key`` normalizes
  the URL (lowercased scheme/host, default ports dropped, fragments
  stripped; magnet links collapse to their btih infohash) and hashes
  it, so trivially-different spellings of one object share an entry.
- **Verified on every hit**: an entry is ``<key>.obj`` (the bytes) +
  ``<key>.json`` (size, sha256, original filename). ``lookup`` re-
  digests the data file against the recorded sha256 before serving —
  a corrupt entry is evicted and refetched, never served.
- **Bounded**: ``CACHE_MAX_BYTES`` caps the store; admission evicts
  LRU entries (data-file mtime, refreshed on hit) after sweeping TTL-
  expired ones. Entries the pin callback claims (the single-flight
  registry's live leases) are never evicted — under pressure the
  store refuses admission rather than touch a leased entry.
- **Ledger-accounted**: every admitted entry carries a scratch-disk
  charge in the admission ledger, so cache bytes compete with
  ``.part`` scratch under one budget. Charges this process did not
  make (entries found on disk from an earlier life) are idle capacity,
  exactly like a resumable ``.part`` file; ``close()`` refunds what
  this process charged without deleting the artifacts.

Crash safety is write-ordering, not locking: the data file lands
first (tmp + ``os.replace``), the meta file second — an entry without
meta does not exist and is swept. Cross-worker races (two puts of one
key, concurrent evictions) converge because both sides write identical
content and unlink tolerates the other side having won.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import shutil
import threading
import time
import urllib.parse

from ..utils import admission, metrics
from ..utils.failpoints import FAILPOINTS
from ..utils.logging import get_logger

log = get_logger("cas")

DEFAULT_MAX_BYTES = 2 * 1024**3
DEFAULT_TTL_S = 24 * 3600.0
_DEFAULT_PORTS = {"http": 80, "https": 443}
_DIGEST_CHUNK = 1 << 20


def content_key(url: str) -> str:
    """Content identity of ``url`` as a hex digest: normalized enough
    that trivially-different spellings of one object coalesce, strict
    enough that distinct objects never collide (query strings are
    significant; fragments are not — they never reach the origin)."""
    raw = (url or "").strip()
    parts = urllib.parse.urlsplit(raw)
    scheme = parts.scheme.lower()
    identity = raw
    if scheme == "magnet":
        for name, value in urllib.parse.parse_qsl(parts.query):
            if name == "xt" and value.lower().startswith("urn:btih:"):
                identity = "magnet:" + value.lower()
                break
    elif scheme in ("http", "https"):
        try:
            host = (parts.hostname or "").lower()
            port = parts.port
        except ValueError:
            host, port = parts.netloc.lower(), None
        if port is not None and port != _DEFAULT_PORTS[scheme]:
            host = f"{host}:{port}"
        identity = f"{scheme}://{host}{parts.path or '/'}"
        if parts.query:
            identity += "?" + parts.query
    return hashlib.sha256(identity.encode("utf-8", "replace")).hexdigest()


def file_digest(path: str) -> str:
    """sha256 of the file at ``path`` (streaming; the verify half of
    the hit path and the record half of the put path)."""
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_DIGEST_CHUNK)
            if not chunk:
                break
            digest.update(chunk)
    return digest.hexdigest()


def materialize(src: str, dst: str) -> None:
    """Make ``dst`` contain ``src``'s bytes without disturbing ``src``:
    hardlink when the filesystem allows (same device, zero copy), else
    copy through a temp file + atomic replace. Raises OSError when
    ``src`` vanished (caller treats as a cache miss)."""
    if os.path.exists(dst):
        return
    try:
        os.link(src, dst)
        return
    except FileNotFoundError:
        raise
    except OSError:
        pass  # cross-device / link-unsupported: fall through to copy
    tmp = dst + ".cas-tmp"
    try:
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
    finally:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass


class CacheHit:
    """One verified entry: the shared data path plus the metadata a
    serve needs (original filename for the job dir, byte size for the
    streaming sink's spans)."""

    __slots__ = ("key", "path", "size", "name")

    def __init__(self, key: str, path: str, size: int, name: str):
        self.key = key
        self.path = path
        self.size = size
        self.name = name


def dir_from_env(environ=None) -> str:
    """``CACHE_DIR``: root of the shared content-addressed cache;
    empty (the default) disables the fleet data plane entirely."""
    env = os.environ if environ is None else environ
    return (env.get("CACHE_DIR") or "").strip()


def max_bytes_from_env(environ=None) -> int:
    """``CACHE_MAX_BYTES``: byte bound on the store (eviction keeps it
    under this; 0 = unbounded)."""
    env = os.environ if environ is None else environ
    raw = (env.get("CACHE_MAX_BYTES") or "").strip()
    if not raw:
        return DEFAULT_MAX_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CACHE_MAX_BYTES (want an integer)"
        )
        return DEFAULT_MAX_BYTES


def ttl_from_env(environ=None) -> float:
    """``CACHE_TTL_S``: entry time-to-live in seconds (0 disables TTL
    expiry; LRU still bounds the store)."""
    env = os.environ if environ is None else environ
    raw = (env.get("CACHE_TTL_S") or "").strip()
    if not raw:
        return DEFAULT_TTL_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CACHE_TTL_S (want seconds)"
        )
        return DEFAULT_TTL_S


class ContentStore:
    """The on-disk store. One instance per process; many processes
    share one root (the fleet supervisor hands every worker the same
    ``CACHE_DIR``). ``pinned`` is the single-flight registry's
    ``is_leased`` — entries it claims are never evicted."""

    def __init__(
        self,
        root: str,
        max_bytes: int = DEFAULT_MAX_BYTES,
        ttl_s: float = DEFAULT_TTL_S,
        pinned=None,
    ):
        self._root = os.path.abspath(root)
        os.makedirs(self._root, exist_ok=True)
        self._max_bytes = max(0, int(max_bytes))
        self._ttl_s = max(0.0, float(ttl_s))
        self._pinned = pinned
        self._lock = threading.Lock()
        # cache key -> bytes charged to the admission ledger BY THIS
        # process (a sibling worker's entries are not ours to refund)
        self._charged: dict[str, int] = {}  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._evictions = 0  # guarded-by: _lock
        self._refusals = 0  # guarded-by: _lock

    # -- layout -----------------------------------------------------------

    @property
    def root(self) -> str:
        return self._root

    def _data_path(self, key: str) -> str:
        return os.path.join(self._root, key[:2], key + ".obj")

    def _meta_path(self, key: str) -> str:
        return os.path.join(self._root, key[:2], key + ".json")

    def _entries(self) -> "list[tuple[str, dict, float]]":
        """Every complete entry on disk as (key, meta, data mtime)."""
        found = []
        try:
            shards = os.listdir(self._root)
        except OSError:
            return found
        for shard in shards:
            shard_dir = os.path.join(self._root, shard)
            if len(shard) != 2 or not os.path.isdir(shard_dir):
                continue
            try:
                names = os.listdir(shard_dir)
            except OSError:
                continue
            for name in names:
                if not name.endswith(".json"):
                    continue
                key = name[: -len(".json")]
                meta = self._read_meta(key)
                if meta is None:
                    continue
                try:
                    mtime = os.stat(self._data_path(key)).st_mtime
                except OSError:
                    continue
                found.append((key, meta, mtime))
        return found

    def _read_meta(self, key: str) -> "dict | None":
        try:
            with open(self._meta_path(key), encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            return None
        return meta if isinstance(meta, dict) else None

    # -- the read path ----------------------------------------------------

    def lookup(self, key: str) -> "CacheHit | None":
        """Verified entry for ``key``, or None. Every hit re-digests
        the data file against the recorded sha256: a corrupt entry is
        evicted and counted, never served. A hit refreshes the entry's
        LRU clock."""
        if FAILPOINTS.fire("cas.lookup"):
            self._miss(key)
            return None
        meta = self._read_meta(key)
        data = self._data_path(key)
        if meta is None:
            # a data file without meta is a torn put: sweep it
            if os.path.exists(data):
                self._evict(key, "torn")
            self._miss(key)
            return None
        created = float(meta.get("created", 0.0))
        if self._ttl_s > 0 and time.time() - created > self._ttl_s:
            self._evict(key, "ttl")
            self._miss(key)
            return None
        size = int(meta.get("size", -1))
        recorded = str(meta.get("sha256", ""))
        try:
            intact = (
                os.path.getsize(data) == size
                and size >= 0
                and file_digest(data) == recorded
            )
        except OSError:
            intact = False
        if not intact:
            self._evict(key, "corrupt")
            metrics.GLOBAL.add("cache_corrupt_evictions_total", 1)
            self._miss(key)
            return None
        try:
            os.utime(data)  # LRU clock: hits keep an entry warm
        except OSError:
            pass
        with self._lock:
            self._hits += 1
        metrics.GLOBAL.add("cache_hits_total", 1)
        metrics.GLOBAL.add("cache_hit_bytes_total", size)
        name = str(meta.get("name") or "") or key
        return CacheHit(key, data, size, name)

    def _miss(self, key: str) -> None:
        with self._lock:
            self._misses += 1
        metrics.GLOBAL.add("cache_misses_total", 1)

    # -- the write path ---------------------------------------------------

    def put(self, key: str, source: str, url: str = "", name: str = "") -> bool:
        """Admit the verified artifact at ``source`` under ``key``
        (write-through: the caller keeps its file; the store hardlinks
        or copies). Returns False when admission was refused — over
        budget with nothing evictable, which the caller treats as
        "this object just isn't cached". Raises OSError only when the
        disk itself failed mid-write."""
        if FAILPOINTS.fire("cas.put"):
            raise OSError(errno.ENOSPC, "failpoint: cas.put")
        try:
            size = os.path.getsize(source)
            digest = file_digest(source)
        except OSError:
            return False  # the artifact vanished under us: nothing to admit
        if not self._admit(key, size):
            with self._lock:
                self._refusals += 1
            metrics.GLOBAL.add("cache_admit_refusals_total", 1)
            return False
        data = self._data_path(key)
        os.makedirs(os.path.dirname(data), exist_ok=True)
        try:
            materialize(source, data)
            meta = {
                "size": size,
                "sha256": digest,
                "url": url,
                "name": name or os.path.basename(source),
                "created": time.time(),
            }
            tmp = self._meta_path(key) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(meta, fh)
            os.replace(tmp, self._meta_path(key))
        except OSError:
            # a torn admit must not leak its ledger charge or a
            # meta-less data file
            self._evict(key, "torn-put")
            raise
        metrics.GLOBAL.add("cache_puts_total", 1)
        metrics.GLOBAL.add("cache_put_bytes_total", size)
        self._publish_gauges()
        return True

    def _admit(self, key: str, size: int) -> bool:
        """Make room for ``size`` bytes: sweep expired entries, then
        evict LRU unpinned ones until both the byte bound and the
        admission ledger say yes. A store full of pinned (leased)
        entries refuses admission rather than evict a leader."""
        if self._max_bytes > 0 and size > self._max_bytes:
            return False
        self._reconcile()
        self._sweep_expired()
        while True:
            usage = sum(
                int(meta.get("size", 0)) for _, meta, _ in self._entries()
            )
            fits = self._max_bytes <= 0 or usage + size <= self._max_bytes
            if fits and admission.LEDGER.try_charge(
                "disk", self._ledger_key(key), size
            ):
                with self._lock:
                    self._charged[key] = size
                return True
            victim = self._lru_victim(exclude=key)
            if victim is None:
                return False
            self._evict(victim, "lru")

    def _ledger_key(self, key: str) -> str:
        # rides the same scratch-disk budget as .part files
        return admission.scratch_key(self._data_path(key))

    def _lru_victim(self, exclude: str = "") -> "str | None":
        oldest_key, oldest_mtime = None, None
        for key, _, mtime in self._entries():
            if key == exclude or self._is_pinned(key):
                continue
            if oldest_mtime is None or mtime < oldest_mtime:
                oldest_key, oldest_mtime = key, mtime
        return oldest_key

    def _is_pinned(self, key: str) -> bool:
        pinned = self._pinned
        if pinned is None:
            return False
        try:
            return bool(pinned(key))
        except Exception as exc:
            # a broken pin callback must fail SAFE (nothing evictable),
            # never let eviction touch what might be a live lease
            log.with_fields(key=key).warning(f"pin callback failed: {exc}")
            return True

    def _sweep_expired(self) -> None:
        if self._ttl_s <= 0:
            return
        now = time.time()
        for key, meta, _ in self._entries():
            created = float(meta.get("created", 0.0))
            if now - created > self._ttl_s and not self._is_pinned(key):
                self._evict(key, "ttl")

    def _evict(self, key: str, reason: str) -> None:
        for path in (self._data_path(key), self._meta_path(key)):
            try:
                os.unlink(path)
            except OSError:
                pass  # a sibling worker won the unlink race
        with self._lock:
            charged = self._charged.pop(key, None)
            self._evictions += 1
        if charged is not None:
            admission.LEDGER.refund(self._ledger_key(key))
        metrics.GLOBAL.add("cache_evictions_total", 1)
        log.with_fields(key=key[:12], reason=reason).info("cache entry evicted")
        self._publish_gauges()

    def _reconcile(self) -> None:
        """Refund charges for entries a sibling worker evicted: the
        file is gone, the capacity is free, our ledger must agree."""
        with self._lock:
            charged = list(self._charged)
        for key in charged:
            if not os.path.exists(self._data_path(key)):
                with self._lock:
                    self._charged.pop(key, None)
                admission.LEDGER.refund(self._ledger_key(key))

    def _publish_gauges(self) -> None:
        entries = self._entries()
        metrics.GLOBAL.gauge_set("cache_entries", float(len(entries)))
        metrics.GLOBAL.gauge_set(
            "cache_bytes",
            float(sum(int(meta.get("size", 0)) for _, meta, _ in entries)),
        )

    # -- lifecycle / observability ----------------------------------------

    def close(self) -> None:
        """Refund this process's ledger charges without deleting the
        artifacts: entries on shared disk are idle capacity for the
        next life, exactly like a resumable ``.part``."""
        with self._lock:
            charged = list(self._charged)
            self._charged.clear()
        for key in charged:
            admission.LEDGER.refund(self._ledger_key(key))

    def snapshot(self) -> dict:
        entries = self._entries()
        with self._lock:
            counters = {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "admit_refusals": self._refusals,
            }
        return {
            "root": self._root,
            "max_bytes": self._max_bytes,
            "ttl_s": self._ttl_s,
            "entries": len(entries),
            "bytes": sum(int(meta.get("size", 0)) for _, meta, _ in entries),
            **counters,
        }
