"""Shared swarm-download state: the per-worker verified piece batch
(``_PieceBatch``).

The claim pool and rarest-first piece selection (``_SwarmState``) come
with the BitTorrent slice. A ``_PieceBatch`` needs only two things of
its swarm: ``.store`` (the PieceStore) and ``.release(index, owner)``.
"""

from __future__ import annotations

from ..parallel import DigestEngine, default_engine
from .peerwire import PeerProtocolError


class _PieceBatch:
    """Downloaded-but-unverified pieces from ONE peer, verified through
    the digest engine in batches.

    Routing the live path through :meth:`DigestEngine.verify_pieces`
    lets the engine's offload policy apply to swarm traffic, and still
    collapses to per-piece hashlib for trickle flushes under ``auto``
    (engine min_batch). Batching per worker keeps bad-peer attribution:
    every piece in a batch came from this worker's current peer, so a
    failed verdict indicts that peer exactly as per-piece hashing did.

    Flush points: ``max_bytes`` reached, the worker idling, or worker
    exit. A crash loses at most ``max_bytes`` of unwritten download per
    worker — the resume scan re-fetches those pieces.
    """

    def __init__(
        self,
        swarm,
        engine: DigestEngine | None = None,
        max_bytes: int = 8 * 1024 * 1024,
        owner=None,
    ):
        self._swarm = swarm
        self._engine = engine or default_engine()
        self._max_bytes = max_bytes
        # the conn whose claims these pieces ride on (release scoping)
        self._owner = owner
        self._items: list[tuple[int, bytes]] = []  # shared-by-design: one _PieceBatch per worker thread; instances never cross threads, only the swarm/store they flush into are shared (and those lock)
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
