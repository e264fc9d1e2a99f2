"""Cross-process single-flight coalescing: one origin fetch per hot
object, fleet-wide.

The other half of the fleet data plane (``store/cas.py`` holds the
artifacts; this module decides who fetches them). Concurrent jobs for
one content key elect exactly one LEADER via an on-disk lease; every
other job is a FOLLOWER that subscribes to the leader's progress and
completes from the shared cache entry the leader admits. The index
lives under the supervisor-coordinated cache root, so the election
spans worker processes, not just threads.

The lease is crash-only, like everything else in the fleet:

- the lease file's mtime is the owner's heartbeat (a beater thread
  touches it while the fetch runs); a leader SIGKILLed mid-fetch
  simply stops beating,
- a follower that sees a stale lease PROMOTES itself — it replaces
  the lease under the index flock and re-leads the fetch from the
  dead leader's journaled spans (the ``.part`` + span journal live in
  a content-keyed staging dir, so the segmented fetcher's normal
  resume path does the recovery),
- release verifies the owner nonce before unlinking, so a zombie
  leader that wakes up late cannot tear down its successor's lease.

A coalesced follower can therefore never strand: the leader finishes,
or its lease expires and somebody else finishes. Every degraded path
(lease IO failure, join failpoint, wait timeout, cache refusal) falls
back to a plain direct fetch — amplification returns, correctness
never leaves.

The lease lifecycle is an analyzer protocol (``cache-lease``): a
conditional ``acquire`` (None = somebody else leads) paired with a
``release`` on every path, checked statically by the analyzer.
Failpoint seams:
``coalesce.lead`` (die/fail at the moment of election) and
``coalesce.join`` (die/fail as a follower subscribes), plus
``cas.lookup``/``cas.put`` in the store.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..store.cas import CacheHit, ContentStore, content_key, materialize
from ..utils import flows, metrics, tracing, watchdog
from ..utils.failpoints import FAILPOINTS
from ..utils.logging import get_logger
from . import progress as transfer_progress

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback, untested
    fcntl = None

log = get_logger("singleflight")

DEFAULT_LEASE_S = 10.0
DEFAULT_WAIT_S = 120.0
_POLL_S = 0.1


def inflight_dir_from_env(environ=None) -> str:
    """``SINGLEFLIGHT_DIR``: where the in-flight lease index lives;
    empty derives ``<CACHE_DIR>/inflight`` (the supervisor pins one
    absolute path into every worker so the index is fleet-shared)."""
    env = os.environ if environ is None else environ
    return (env.get("SINGLEFLIGHT_DIR") or "").strip()


def lease_ttl_from_env(environ=None) -> float:
    """``SINGLEFLIGHT_LEASE_S``: how long a lease may go un-beaten
    before a follower may promote itself over it."""
    env = os.environ if environ is None else environ
    raw = (env.get("SINGLEFLIGHT_LEASE_S") or "").strip()
    if not raw:
        return DEFAULT_LEASE_S
    try:
        return max(0.1, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid SINGLEFLIGHT_LEASE_S (want seconds)"
        )
        return DEFAULT_LEASE_S


def wait_from_env(environ=None) -> float:
    """``SINGLEFLIGHT_WAIT_S``: how long a follower waits on a live
    leader before giving up and fetching directly (correctness over
    dedup: a timeout re-amplifies, it never fails the job)."""
    env = os.environ if environ is None else environ
    raw = (env.get("SINGLEFLIGHT_WAIT_S") or "").strip()
    if not raw:
        return DEFAULT_WAIT_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid SINGLEFLIGHT_WAIT_S (want seconds)"
        )
        return DEFAULT_WAIT_S


class Lease:
    """One held leadership claim (returned by
    ``LeaseRegistry.acquire_lease``, owed back to ``release_lease``)."""

    __slots__ = ("key", "path", "nonce", "promoted", "released")

    def __init__(self, key: str, path: str, nonce: str, promoted: bool):
        self.key = key
        self.path = path
        self.nonce = nonce
        self.promoted = promoted
        self.released = False


class LeaseRegistry:
    """The on-disk in-flight index: one ``<key>.lease`` JSON per
    object being fetched, mutations serialized by an index-wide flock
    so election is atomic across worker processes."""

    def __init__(
        self,
        root: str,
        lease_ttl_s: float = DEFAULT_LEASE_S,
        instance: str = "",
    ):
        self._root = os.path.abspath(root)
        os.makedirs(self._root, exist_ok=True)
        self._ttl_s = max(0.1, float(lease_ttl_s))
        self._instance = instance or f"pid-{os.getpid()}"

    @property
    def lease_ttl_s(self) -> float:
        return self._ttl_s

    def _lease_path(self, key: str) -> str:
        return os.path.join(self._root, key + ".lease")

    class _Flock:
        """Index-wide advisory lock (context manager): every lease
        mutation across every worker process serializes here. Held
        only for tiny read-modify-write windows."""

        def __init__(self, root: str):
            self._path = os.path.join(root, ".index.lock")
            self._fh = None

        def __enter__(self):
            self._fh = open(self._path, "a+")
            if fcntl is not None:
                fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
            return self

        def __exit__(self, *exc):
            try:
                if fcntl is not None:
                    fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            finally:
                self._fh.close()
            return False

    def _read(self, key: str) -> "dict | None":
        """Current lease record + its heartbeat age, or None. Lease
        writes are tmp + atomic replace, so a lock-free read sees a
        whole record or nothing."""
        path = self._lease_path(key)
        try:
            age = time.time() - os.stat(path).st_mtime
            with open(path, encoding="utf-8") as fh:
                record = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(record, dict):
            return None
        record["age_s"] = age
        return record

    def _write(self, key: str, record: dict) -> None:
        path = self._lease_path(key)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(record, fh)
        os.replace(tmp, path)

    def acquire_lease(self, key: str, url: str = "") -> "Lease | None":  # protocol: cache-lease acquire conditional may-raise
        """Try to become the fetch leader for ``key``. None means a
        live leader already holds it (the caller follows); a returned
        Lease — fresh or promoted over a stale owner — is owed back to
        ``release``. Raises OSError when the index itself failed (the
        caller degrades to a direct, uncoalesced fetch)."""
        nonce = os.urandom(8).hex()
        promoted = False
        with self._Flock(self._root):
            existing = self._read(key)
            if existing is not None and existing["age_s"] <= self._ttl_s:
                return None
            promoted = existing is not None
            self._write(
                key,
                {
                    "owner": self._instance,
                    "pid": os.getpid(),
                    "nonce": nonce,
                    "url": url,
                    "created": time.time(),
                },
            )
        lease = Lease(key, self._lease_path(key), nonce, promoted)
        if promoted:
            metrics.GLOBAL.add("singleflight_promotions_total", 1)
            log.with_fields(
                key=key[:12], owner=self._instance
            ).warning("stale lease: promoting self to fetch leader")
        # the seam sits while the lease is HELD: kill mode dies as the
        # elected leader (followers must detect staleness and promote);
        # fail mode surfaces as index IO failure and degrades
        if FAILPOINTS.fire("coalesce.lead"):
            self.release_lease(lease)
            raise OSError("failpoint: coalesce.lead lease index io")
        return lease

    def release_lease(self, lease: Lease) -> None:  # protocol: cache-lease release bind=lease
        """Give leadership back. Owner-checked: only the nonce that
        acquired may unlink, so a zombie leader cannot tear down the
        follower promoted over it. Safe to call twice."""
        if lease.released:
            return
        lease.released = True
        try:
            with self._Flock(self._root):
                current = self._read(lease.key)
                if current is not None and current.get("nonce") == lease.nonce:
                    try:
                        os.unlink(lease.path)
                    except OSError:
                        pass
        except OSError as exc:
            # best effort: an unreleasable lease just expires by TTL
            log.with_fields(key=lease.key[:12]).warning(
                f"lease release failed (will expire): {exc}"
            )

    def beat(self, lease: Lease) -> None:
        """Refresh the lease heartbeat — owner-checked, so a zombie's
        beat cannot keep a superseded lease looking alive."""
        try:
            with self._Flock(self._root):
                current = self._read(lease.key)
                if current is not None and current.get("nonce") == lease.nonce:
                    os.utime(lease.path)
        except OSError:
            pass  # a missed beat only ages the lease; TTL still governs

    def peek(self, key: str) -> "dict | None":
        """The live lease record for ``key`` (fresh heartbeats only),
        or None when nobody leads / the owner went stale."""
        record = self._read(key)
        if record is None or record["age_s"] > self._ttl_s:
            return None
        return record

    def is_leased(self, key: str) -> bool:
        """Whether ``key`` has a live leader — the cache store's pin
        callback (eviction never touches leased entries)."""
        return self.peek(key) is not None

    def snapshot(self) -> dict:
        leases = []
        try:
            names = os.listdir(self._root)
        except OSError:
            names = []
        for name in sorted(names):
            if not name.endswith(".lease"):
                continue
            record = self._read(name[: -len(".lease")])
            if record is None:
                continue
            leases.append(
                {
                    "key": name[: -len(".lease")][:12],
                    "owner": record.get("owner", ""),
                    "pid": record.get("pid", 0),
                    "age_s": round(record["age_s"], 3),
                    "stale": record["age_s"] > self._ttl_s,
                    "url": record.get("url", ""),
                }
            )
        return {
            "root": self._root,
            "lease_ttl_s": self._ttl_s,
            "instance": self._instance,
            "leases": leases,
        }


class _LeaseBeater:
    """Heartbeats a held lease while the leader's fetch runs; the
    whole point of the mtime heartbeat is that SIGKILL stops it."""

    def __init__(self, registry: LeaseRegistry, lease: Lease):
        self._registry = registry
        self._lease = lease
        self._stop = threading.Event()
        self._thread = threading.Thread(  # thread-role: lease-beater
            target=self._run, name="lease-beater", daemon=True
        )

    def start(self) -> "_LeaseBeater":
        self._thread.start()
        return self

    def _run(self) -> None:
        from ..utils import profiling

        profiling.ROLES.register_current("lease-beater")
        interval = max(0.05, self._registry.lease_ttl_s / 3.0)
        while not self._stop.wait(interval):
            try:
                self._registry.beat(self._lease)
            except Exception as exc:
                # the beater must outlive any one bad beat: a stale
                # heartbeat only invites promotion, never corruption
                log.debug(f"lease beat failed: {exc}")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class CoalescingDataPlane:
    """What the dispatcher fronts its fetch lanes with when the fleet
    data plane is configured: cache hits serve from verified CAS
    spans, misses elect one leader per content key, and everyone else
    completes from the entry the leader admits write-through."""

    def __init__(
        self,
        store: ContentStore,
        registry: LeaseRegistry,
        wait_s: float = DEFAULT_WAIT_S,
        poll_s: float = _POLL_S,
    ):
        self._store = store
        self._registry = registry
        self._wait_s = max(0.0, float(wait_s))
        self._poll_s = max(0.01, float(poll_s))

    @property
    def store(self) -> ContentStore:
        return self._store

    @property
    def registry(self) -> LeaseRegistry:
        return self._registry

    def covers(self, backend, url: str) -> bool:
        """Only backends that opt in (``supports_cache``) and schemes
        whose artifacts are content-stable ride the data plane."""
        if not getattr(backend, "supports_cache", False):
            return False
        scheme = url.split(":", 1)[0].lower() if ":" in url else ""
        return scheme in ("http", "https")

    # -- the two dispatcher lanes -----------------------------------------

    def fetch_small(self, backend, token, job_dir, progress, url,
                    max_bytes) -> bool:
        """The batched fast lane through the data plane. True = the
        job dir holds the object (from cache or a coalesced fetch);
        False = the plane declines (object too big for the lane, wait
        timeout, index failure) and the caller proceeds as if the
        plane did not exist."""
        return self._run("small", backend, token, job_dir, progress, url,
                         max_bytes=max_bytes)

    def download(self, backend, token, job_dir, progress, url,
                 mirrors=()) -> bool:
        """The segmented lane through the data plane; same contract as
        ``fetch_small`` (False = caller falls back to a direct
        ``backend.download``)."""
        return self._run("segmented", backend, token, job_dir, progress,
                         url, mirrors=tuple(mirrors))

    # -- coalescing core --------------------------------------------------

    def _run(self, lane, backend, token, job_dir, progress, url,
             max_bytes=0, mirrors=()) -> bool:
        key = content_key(url)
        obj = flows.object_key(tracing.redact_url(url))
        hit = self._store.lookup(key)
        if hit is not None and self._serve(hit, job_dir, obj, url, progress):
            return True
        deadline = time.monotonic() + self._wait_s
        wait_started = None
        fetch_hb = watchdog.current().heartbeat("fetch")
        while True:
            if token is not None:
                token.raise_if_cancelled()
            try:
                lease = self._registry.acquire_lease(
                    key, url=tracing.redact_url(url)
                )
            except OSError:
                return False  # index io failed: degrade to direct fetch
            if lease is not None:
                try:
                    return self._lead(
                        lease, lane, backend, token, job_dir, progress,
                        url, obj, max_bytes, mirrors,
                    )
                finally:
                    self._registry.release_lease(lease)
            if wait_started is None:
                if FAILPOINTS.fire("coalesce.join"):
                    return False  # degrade: uncoalesced direct fetch
                wait_started = time.monotonic()
                metrics.GLOBAL.add("singleflight_joins_total", 1)
                log.with_fields(key=key[:12], url=tracing.redact_url(url)).info(
                    "joining in-flight fetch (following the leader)"
                )
            if self._registry.peek(key) is None:
                # leader released: either the entry is there, or the
                # leader failed/declined and the next acquire re-leads
                hit = self._store.lookup(key)
                if hit is not None and self._serve(
                    hit, job_dir, obj, url, progress
                ):
                    metrics.GLOBAL.observe(
                        "singleflight_wait_seconds",
                        time.monotonic() - wait_started,
                    )
                    return True
                continue
            if time.monotonic() >= deadline:
                metrics.GLOBAL.add("singleflight_wait_timeouts_total", 1)
                log.with_fields(key=key[:12]).warning(
                    "gave up following (wait timeout): fetching directly"
                )
                return False
            # a waiting follower's forward progress IS the leader's:
            # keep the stall watchdog fed while we ride along
            fetch_hb.beat()
            time.sleep(self._poll_s)  # deadline: bounded by wait_s check above

    def _lead(self, lease, lane, backend, token, job_dir, progress, url,
              obj, max_bytes, mirrors) -> bool:
        metrics.GLOBAL.add("singleflight_leads_total", 1)
        # the cache may have been populated between our miss and the
        # election (a previous leader finishing as we promoted)
        hit = self._store.lookup(lease.key)
        if hit is not None and self._serve(hit, job_dir, obj, url, progress):
            return True
        staging = os.path.join(self._store.root, "staging", lease.key)
        os.makedirs(staging, exist_ok=True)
        beater = _LeaseBeater(self._registry, lease).start()
        try:
            if lane == "small":
                done = backend.fetch_small(
                    token, staging, progress, url, max_bytes
                )
                if not done:
                    return False  # too big for the fast lane: caller falls back
            else:
                # the backend fetches into content-keyed staging (so a
                # promoted successor resumes the journaled spans), while
                # the job's streaming sink sees job-dir paths
                sink = _RelocatingSink(
                    transfer_progress.current(), staging, job_dir
                )
                with transfer_progress.install(sink):
                    if mirrors and getattr(backend, "supports_mirrors", False):
                        backend.download(
                            token, staging, progress, url,
                            mirrors=tuple(mirrors),
                        )
                    else:
                        backend.download(token, staging, progress, url)
        finally:
            beater.stop()
        name = self._staged_product(staging)
        if name is None:
            return False  # nothing landed (backend declined without raising)
        src = os.path.join(staging, name)
        try:
            self._store.put(
                lease.key, src, url=tracing.redact_url(url), name=name
            )
        except OSError as exc:
            # write-through is best effort: the job completes either
            # way, followers time out and fetch for themselves
            log.with_fields(key=lease.key[:12]).warning(
                f"cache write-through failed: {exc}"
            )
        dst = os.path.join(job_dir, name)
        try:
            materialize(src, dst)
        finally:
            try:
                os.unlink(src)  # staging's job is done; the entry owns the bytes
            except OSError:
                pass
        return True

    @staticmethod
    def _staged_product(staging: str) -> "str | None":
        """The finished artifact in the staging dir (``.part`` and
        span journals are in-progress state, never products)."""
        try:
            names = os.listdir(staging)
        except OSError:
            return None
        products = [
            n for n in names
            if not n.endswith((".part", ".spans", ".cas-tmp"))
            and os.path.isfile(os.path.join(staging, n))
        ]
        if not products:
            return None
        # newest mtime wins if a crashed lead left an older sibling
        return max(
            products,
            key=lambda n: os.path.getmtime(os.path.join(staging, n)),
        )

    def _serve(self, hit: CacheHit, job_dir, obj, url, progress) -> bool:
        """Complete a job straight from a verified cache entry: the
        bytes hardlink into the job dir and the streaming sink is
        driven exactly as a fetch would (begin, one whole-file span,
        finish), so the uploader pipeline needs no special case."""
        dst = os.path.join(job_dir, hit.name)
        try:
            materialize(hit.path, dst)
        except OSError:
            return False  # entry evicted mid-serve: caller refetches
        sink = transfer_progress.current()
        sink.begin_file(dst, hit.size, read_path=dst)
        sink.add_span(dst, 0, hit.size)
        sink.finish_file(dst)
        # cache-served bytes are unique-object serves in the flow
        # ledger: they enter the amplification denominator (the whole
        # point — demand grows, origin bytes do not) and are broken
        # out on their own lane so the ratio reads honestly
        flows.LEDGER.note_cache_hit(obj, hit.size)
        flows.LEDGER.note_unique(obj, hit.size)
        progress(url, 100.0)
        log.with_fields(
            url=tracing.redact_url(url), bytes=hit.size
        ).info("served from content cache")
        return True


class _RelocatingSink:
    """TransferSink adapter for a coalesced leader: the segmented
    fetcher writes into the shared staging dir, but the job's real
    sink (the streaming uploader) must see the file at its job path —
    parts stream from the staging ``.part`` via ``read_path`` while
    the advertised identity stays the job's. ``finish_file``
    materializes the artifact into the job dir before forwarding, so
    the pipeline's final whole-file reads find it."""

    def __init__(self, inner, staging_dir: str, job_dir: str):
        self._inner = inner
        self._staging = staging_dir
        self._job_dir = job_dir

    def _map(self, path: str) -> str:
        if os.path.dirname(path) == self._staging:
            return os.path.join(self._job_dir, os.path.basename(path))
        return path

    def begin_file(self, path, total, read_path=None):
        self._inner.begin_file(
            self._map(path), total, read_path=read_path or path
        )

    def advance(self, path, offset):
        self._inner.advance(self._map(path), offset)

    def add_span(self, path, start, end):
        self._inner.add_span(self._map(path), start, end)

    def finish_file(self, path):
        mapped = self._map(path)
        if mapped != path:
            try:
                materialize(path, mapped)
            except OSError:
                pass  # pipeline falls back to its read_path candidates
        self._inner.finish_file(mapped)

    def invalidate(self, path):
        self._inner.invalidate(self._map(path))


# the process-wide active plane (mirrors metrics.GLOBAL / flows.LEDGER):
# serve() installs it when CACHE_DIR is configured so the health
# server's /debug/cache view can see it without plumbing
_ACTIVE: "CoalescingDataPlane | None" = None


def activate(plane: "CoalescingDataPlane | None") -> None:
    global _ACTIVE
    _ACTIVE = plane


def debug_snapshot() -> dict:
    plane = _ACTIVE
    if plane is None:
        return {"enabled": False}
    return {
        "enabled": True,
        "cas": plane.store.snapshot(),
        "singleflight": plane.registry.snapshot(),
    }
