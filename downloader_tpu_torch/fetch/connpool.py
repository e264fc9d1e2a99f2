"""Per-host keep-alive HTTP connection pool for the segmented fetcher.

One logical transfer split into N ranges (fetch/segments.py) would
otherwise pay N TCP (+TLS) handshakes per job, and the next job to the
same host pays them all again. The pool keeps idle ``http.client``
connections keyed by (scheme, host, port), hands them back out for
later segments and later jobs, and bounds the hoard two ways:

- a per-host cap on RETAINED idle connections (``HTTP_POOL_PER_HOST``)
  — in-flight connections are bounded by the segment count, so only
  the idle side can accumulate;
- an idle TTL (``HTTP_POOL_IDLE`` seconds) after which a parked
  connection is closed on the next acquire sweep rather than reused —
  most servers close keep-alive sockets after 5-75 s, and reusing a
  half-dead socket costs a retry.

A reused connection can still be dead (the server closed it while
parked); callers must treat the FIRST failure on a reused connection
as "stale pool entry, retry on a fresh one", not as a transfer error —
``PooledConnection.fresh`` tells them which case they're in.

Observability: ``http_pool_idle_connections`` gauge plus
``http_pool_reuse_hits`` / ``http_pool_created`` / ``http_pool_evicted``
counters on ``/metrics``.
"""

from __future__ import annotations

import http.client
import os
import threading
import time
from collections import deque

from ..utils import get_logger, incident, metrics, profiling
from ..utils.netio import create_connection

log = get_logger("fetch.connpool")

DEFAULT_PER_HOST = 6
DEFAULT_IDLE_TTL = 30.0


def pool_per_host_from_env(environ=None) -> int:
    env = os.environ if environ is None else environ
    raw = (env.get("HTTP_POOL_PER_HOST") or "").strip()
    if not raw:
        return DEFAULT_PER_HOST
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid HTTP_POOL_PER_HOST (want an integer)"
        )
        return DEFAULT_PER_HOST


def pool_idle_from_env(environ=None) -> float:
    env = os.environ if environ is None else environ
    raw = (env.get("HTTP_POOL_IDLE") or "").strip()
    if not raw:
        return DEFAULT_IDLE_TTL
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid HTTP_POOL_IDLE (want seconds)"
        )
        return DEFAULT_IDLE_TTL


class PooledConnection:
    """One checked-out connection. ``fresh`` is False when it came off
    the idle shelf — the caller's first failure on it should burn a
    pool retry, not a transfer attempt."""

    __slots__ = ("conn", "key", "fresh", "parked_at")

    def __init__(self, conn: http.client.HTTPConnection, key: tuple, fresh: bool):
        self.conn = conn
        self.key = key
        self.fresh = fresh
        self.parked_at = 0.0

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


class ConnectionPool:
    """Thread-safe keep-alive pool (see module doc). ``clock`` is
    injectable so tests can expire idle entries without sleeping."""

    def __init__(
        self,
        per_host: int | None = None,
        idle_ttl: float | None = None,
        timeout: float = 30.0,
        clock=time.monotonic,
    ) -> None:
        self._per_host = (
            pool_per_host_from_env() if per_host is None else max(1, per_host)
        )
        self._idle_ttl = (
            pool_idle_from_env() if idle_ttl is None else max(0.0, idle_ttl)
        )
        self._timeout = timeout
        self._clock = clock
        # named for lock-wait profiling (utils/profiling.py): every
        # segment/job acquire crosses this shelf lock
        self._lock = profiling.named_lock("connpool", threading.Lock())
        self._idle: dict[tuple, deque[PooledConnection]] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # incident-bundle introspection: which hosts hold how many
        # parked connections. WeakMethod-held, expires with the pool;
        # close() unregisters eagerly for determinism.
        self._probe_name = incident.RECORDER.register_probe(
            "http-connpool", self._incident_probe
        )

    def _incident_probe(self) -> dict:
        with self._lock:
            shelves = {
                f"{key[0]}://{key[1]}:{key[2]}": len(shelf)
                for key, shelf in self._idle.items()
            }
            closed = self._closed
        return {
            "closed": closed,
            "per_host_cap": self._per_host,
            "idle_ttl_s": self._idle_ttl,
            "idle_by_host": shelves,
            "idle_total": sum(shelves.values()),
        }

    # -- lifecycle --------------------------------------------------------

    def acquire(
        self, scheme: str, host: str, port: int, timeout: float | None = None
    ) -> PooledConnection:
        """A ready connection to (scheme, host, port): a parked live one
        when available (reuse hit), else a new unconnected one — the
        actual TCP/TLS handshake happens lazily on the first request,
        through the cached resolver."""
        key = (scheme, host, port)
        now = self._clock()
        with self._lock:
            shelf = self._idle.get(key)
            reuse = None
            while shelf:
                pooled = shelf.popleft()
                metrics.GLOBAL.gauge_add("http_pool_idle_connections", -1)
                if now - pooled.parked_at > self._idle_ttl:
                    metrics.GLOBAL.add("http_pool_evicted")
                    pooled.close()
                    continue
                reuse = pooled
                break
            if shelf is not None and not shelf:
                # emptied shelves are dropped, or the dict accretes one
                # dead key per distinct host the daemon ever contacted
                self._idle.pop(key, None)
            if reuse is not None:
                metrics.GLOBAL.add("http_pool_reuse_hits")
                reuse.fresh = False
                return reuse
        if scheme == "https":
            conn: http.client.HTTPConnection = http.client.HTTPSConnection(
                host, port, timeout=timeout or self._timeout
            )
        else:
            conn = http.client.HTTPConnection(
                host, port, timeout=timeout or self._timeout
            )
        # route the lazy connect through the process DNS cache so N
        # segments to one host resolve once, not N times
        conn._create_connection = create_connection  # type: ignore[attr-defined]
        metrics.GLOBAL.add("http_pool_created")
        return PooledConnection(conn, key, fresh=True)

    def release(self, pooled: PooledConnection, reusable: bool) -> None:
        """Hand a connection back. ``reusable=False`` (errored, or the
        response wasn't drained to its end) closes it — a keep-alive
        socket with stray body bytes would corrupt the next request."""
        if not reusable:
            pooled.close()
            return
        pooled.parked_at = self._clock()
        with self._lock:
            if self._closed:
                pooled.close()
                return
            shelf = self._idle.setdefault(pooled.key, deque())
            if len(shelf) >= self._per_host:
                metrics.GLOBAL.add("http_pool_evicted")
                pooled.close()
                return
            shelf.append(pooled)
        metrics.GLOBAL.gauge_add("http_pool_idle_connections", 1)

    def idle_count(self) -> int:
        with self._lock:
            return sum(len(shelf) for shelf in self._idle.values())

    def close(self) -> None:
        incident.RECORDER.unregister_probe(self._probe_name)
        with self._lock:
            self._closed = True
            shelves = list(self._idle.values())
            self._idle.clear()
        dropped = 0
        for shelf in shelves:
            for pooled in shelf:
                pooled.close()
                dropped += 1
        if dropped:
            metrics.GLOBAL.gauge_add("http_pool_idle_connections", -dropped)
