"""Shared swarm-download state: the claim pool / rarest-first piece
selection (``_SwarmState``) and the per-worker verified piece batch
(``_PieceBatch``), as in the JAX package's fetch/swarmstate.py.

Every live piece from a peer or a webseed is verified by a
``_PieceBatch`` flush through the digest engine: the CUDA SHA-1 kernel
on the card, or hashlib for a flush the engine's ``auto`` policy finds
too small to offload.
"""

from __future__ import annotations

import collections
import hashlib
import random
import secrets
import threading
import time

from ..parallel import DigestEngine, default_engine
from ..utils import get_logger, metrics
from . import sources as source_accounting
from .http import TransferError
from .peerwire import BLOCK_SIZE, PeerProtocolError

log = get_logger("fetch.peer")

class _PieceBatch:
    """Downloaded-but-unverified pieces from ONE peer, verified through
    the digest engine in batches.

    Routing the live path through :meth:`DigestEngine.verify_pieces`
    lets the engine's offload policy apply to swarm traffic, and still
    collapses to per-piece hashlib for trickle flushes under ``auto``
    (engine min_batch). Batching per worker keeps bad-peer attribution:
    every piece in a batch came from this worker's current peer, so a
    failed verdict indicts that peer exactly as per-piece hashing did.

    Flush points: ``max_bytes`` reached, the worker idling (WAIT), or
    worker exit. A crash loses at most ``max_bytes`` of unwritten
    download per worker — the resume scan re-fetches those pieces.
    """

    def __init__(
        self,
        swarm: "_SwarmState",
        engine: DigestEngine | None = None,
        max_bytes: int = 8 * 1024 * 1024,
        owner=None,
    ):
        self._swarm = swarm
        self._engine = engine or default_engine()
        self._max_bytes = max_bytes
        # the conn whose claims these pieces ride on (release scoping)
        self._owner = owner
        self._items: list[tuple[int, bytes]] = []  # shared-by-design: one _PieceBatch per worker thread (peer or webseed); instances never cross threads, only the swarm/store they flush into are shared (and those lock)
        self._bytes = 0  # shared-by-design: same owner-scoping as _items — thread-confined per-worker tally

    def add(self, index: int, data: bytes) -> None:
        self._items.append((index, data))
        self._bytes += len(data)
        if self._bytes >= self._max_bytes:
            self.flush()

    def flush(self) -> None:
        """Verify and write everything pending. Raises
        PeerProtocolError naming the failed pieces (claims released so
        other workers re-fetch them); verified pieces are always written
        first, so one bad piece cannot discard its good batch-mates."""
        if not self._items:
            return
        items, self._items, self._bytes = self._items, [], 0
        store = self._swarm.store
        verdicts = self._engine.verify_pieces(
            [data for _, data in items],
            [store.piece_hashes[index] for index, _ in items],
        )
        bad: list[int] = []
        for (index, data), good in zip(items, verdicts):
            if good:
                if not store.have[index]:  # endgame: a duplicate may have won
                    store.write_verified(index, data)
            else:
                self._swarm.release(index, self._owner)
                bad.append(index)
        if bad:
            raise PeerProtocolError(
                f"pieces {bad} failed SHA-1 verification"
            )


class _SwarmState:
    """Shared state for the concurrent peer workers: the peer queue, the
    claimed-piece set, and throttled progress reporting."""

    WAIT = object()  # claim(): all missing pieces are claimed elsewhere

    def __init__(self, store: PieceStore, progress, progress_interval: float):
        self.store = store
        self.peer_queue: list[tuple[str, int]] = []
        # a short error history, not a single slot: an unwinding batch
        # flush records its verification failure moments before the
        # worker records the error that triggered the unwind, and the
        # job's failure message must keep both diagnostics
        self._errors: "collections.deque[Exception]" = collections.deque(maxlen=3)
        # piece -> the conn that holds the original (exclusive) claim.
        # Conn OBJECTS, not id(conn): holding the reference pins the
        # object so a recycled id can never alias a dead connection's
        # bookkeeping, and release() can tell an owner from a stranger.
        self._claimed: dict[int, object] = {}
        # endgame bookkeeping: piece -> conns already duplicating it, so
        # one idle worker doesn't re-download the same in-flight piece
        # in a tight loop
        self._dup_claims: dict[int, set] = {}
        self.endgame = False  # sticky; flips when the first dup is handed out
        # connected peers' bitfields drive rarest-first availability
        self._conns: set = set()
        # every peer address ever enqueued (dedupes PEX gossip and
        # feeds the listener's own outgoing PEX messages)
        self.seen_peers: set[tuple[str, int]] = set()
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._progress = progress
        self._progress_interval = progress_interval
        self._last_tick = time.monotonic()
        # scan cursor: everything below it is permanently complete, so
        # claims stay O(total) over the torrent instead of O(n^2)
        self._scan_start = 0
        # multi-source accounting (fetch/sources.py): webseed and peer
        # workers register here so swarm traffic lands on the same
        # per-kind rate/demotion board as the HTTP span scheduler —
        # one /metrics story for mirror, webseed, and peer bytes
        self.sources = source_accounting.SourceBoard(
            # webseed and peer bytes attribute to the torrent's one
            # flow-ledger object, the same identity the verified-piece
            # path reports unique bytes against
            flow_object=getattr(store, "flow_key", ""),
        )

    def register(self, conn) -> None:
        """Track a live connection; its (HAVE-updated) bitfield feeds
        rarest-first availability ranking."""
        with self._lock:
            self._conns.add(conn)

    def unregister(self, conn) -> None:
        with self._lock:
            self._conns.discard(conn)

    def broadcast_have(self, index: int) -> None:
        """Store observer: queue a HAVE for every live outbound
        connection (each conn's owner thread flushes — queue only, so
        a stalled remote can never block the completing worker)."""
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.queue_have(index)

    def done(self) -> bool:
        return all(self.store.have)

    @property
    def last_error(self) -> Exception | None:
        return self._errors[-1] if self._errors else None

    @last_error.setter
    def last_error(self, exc: Exception) -> None:
        self._errors.append(exc)

    def error_summary(self) -> str:
        if not self._errors:
            return "None"
        return "; ".join(str(exc) for exc in self._errors)

    def next_peer(self) -> tuple[str, int] | None:
        with self._lock:
            return self.peer_queue.pop(0) if self.peer_queue else None

    def add_peers(self, peers) -> None:
        """Fold gossiped (PEX) peers into the queue, each at most once
        for the life of the job — tracker/DHT rediscovery handles
        deliberate retries; gossip must not re-queue dead peers
        forever."""
        with self._lock:
            for peer in peers:
                if peer not in self.seen_peers:
                    self.seen_peers.add(peer)
                    self.peer_queue.append(peer)

    def known_peers(self) -> list[tuple[str, int]]:
        """Snapshot of every peer this job has seen (the listener's
        outgoing PEX payload)."""
        with self._lock:
            return list(self.seen_peers)

    def enqueue_discovered(self, peers) -> None:
        """Tracker/DHT (re)discovery: (re)queue anything not already
        queued — deliberate retries are the point — and register in
        seen_peers under the lock (listener threads snapshot that set
        concurrently for PEX gossip)."""
        with self._lock:
            for peer in peers:
                self.seen_peers.add(peer)
                if peer not in self.peer_queue:
                    self.peer_queue.append(peer)

    def claim(self, conn: PeerConnection, only=None):
        """The RAREST unclaimed missing piece this peer advertises
        (availability ranked across registered connections' live
        bitfields, ties broken randomly — anacrolix's selection order
        behind DownloadAll, reference torrent.go:79; lowest-index
        serialises real swarms on hot pieces).

        Endgame: when every missing piece is already claimed, hand out
        a DUPLICATE claim for an in-flight piece this peer has (each
        conn at most once per piece) — first verified write wins and
        the losers abandon via the store.have check in the download
        loop. This is what keeps the tail from stalling behind one slow
        peer. Returns WAIT when the peer could help later but not now;
        None when the torrent is done or this peer has nothing useful.

        With ``only`` (a set of indices), claims are restricted to it —
        the BEP 6 allowed-fast case, where a still-choked peer may be
        asked for exactly those pieces.

        O(pieces × conns) per claim; fine for the handful of
        connections a job runs (reference effective concurrency is 1)."""
        store = self.store
        with self._lock:
            while self._scan_start < store.num_pieces and store.have[
                self._scan_start
            ]:
                self._scan_start += 1
            if self._scan_start >= store.num_pieces:
                return None  # torrent complete
            candidates: list[int] = []
            in_flight: list[int] = []  # claimed by ANOTHER conn, missing, peer has
            for index in range(self._scan_start, store.num_pieces):
                if store.have[index]:
                    self._dup_claims.pop(index, None)
                    continue
                if only is not None and index not in only:
                    continue
                peer_has = not conn.bitfield or conn.has_piece(index)
                if index in self._claimed:
                    # never duplicate a piece this conn itself claimed:
                    # its unflushed batch may already hold the bytes
                    if peer_has and self._claimed[index] is not conn:
                        in_flight.append(index)
                    continue
                if peer_has:
                    candidates.append(index)

            def pick_rarest(indices: list[int]) -> int:
                avail = {
                    i: sum(
                        1
                        for c in self._conns
                        if not c.bitfield or c.has_piece(i)
                    )
                    for i in indices
                }
                best = min(avail.values())
                return self._rng.choice(
                    [i for i in indices if avail[i] == best]
                )

            if candidates:
                index = pick_rarest(candidates)
                self._claimed[index] = conn
                return index
            # endgame: nothing unclaimed, but this peer could race an
            # in-flight piece it hasn't already duplicated
            fresh = [
                i
                for i in in_flight
                if conn not in self._dup_claims.get(i, ())
            ]
            if fresh:
                index = pick_rarest(fresh)
                self._dup_claims.setdefault(index, set()).add(conn)
                self.endgame = True
                return index
            return self.WAIT if in_flight else None

    def release(self, index: int, owner=None) -> None:
        """Give a claim back. With ``owner`` (the conn the claim was
        handed to), only that conn's stake is released: a failed endgame
        DUPLICATE clears its dup record — letting another conn race the
        piece — without yanking the original downloader's still-active
        claim out from under it. ``owner=None`` (direct callers, tests)
        releases the original claim unconditionally."""
        with self._lock:
            if owner is not None:
                dups = self._dup_claims.get(index)
                if dups is not None:
                    dups.discard(owner)
                if self._claimed.get(index) is not owner:
                    return  # we only held (at most) a duplicate
            self._claimed.pop(index, None)

    def tick_progress(self) -> None:
        store = self.store
        with self._lock:
            now = time.monotonic()
            if now - self._last_tick < self._progress_interval:
                return
            self._last_tick = now
        self._progress(store.bytes_completed() / store.total_length * 100)
