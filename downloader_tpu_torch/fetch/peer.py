"""BitTorrent transfer engine: tracker announce, peer wire protocol,
metadata exchange, piece verification, and file assembly.

The reference gets all of this from anacrolix/torrent (torrent.go:10); this
module implements the protocol stack directly on stdlib sockets:

- HTTP(S) tracker announce with compact peer lists (BEP 3 / BEP 23) and
  UDP tracker announce (BEP 15), plus explicit x.pe peer hints (BEP 9),
- the peer wire protocol — handshake, choke/interest, request/piece
  (BEP 3), with the extension protocol handshake (BEP 10),
- magnet metadata exchange via ut_metadata (BEP 9), SHA-1-verified against
  the info-hash, matching the reference's GotInfo phase (torrent.go:67-76),
- per-piece SHA-1 verification and single/multi-file assembly rooted at
  the job dir, as anacrolix's file storage does (torrent.go:40-41),
- partial-download resume: pieces already on disk are batch-re-verified
  through the digest engine (parallel/, the CUDA SHA-1 kernel on the
  card) before the swarm is contacted — a capability the reference
  never exercises (it builds a fresh client per job, torrent.go:43-44).
  Pieces from peers and webseeds are verified in batches through the
  same engine (swarmstate._PieceBatch).

Peers come from x.pe hints, trackers, and — when the trackers yield
nothing — a mainline DHT get_peers lookup (BEP 5, fetch/dht.py), so
trackerless magnets work like the reference's anacrolix client.
"""


# The engine is split by role — tracker.py (announce), peerwire.py
# (outbound wire + PeerConnection), pieces.py (PieceStore), webseed.py
# (BEP 19), inbound.py (listener + choker), swarmstate.py (claim pool +
# piece batch), as in the JAX package. This module keeps the
# SwarmDownloader orchestration and re-exports the split names, so
# ``downloader_tpu_torch.fetch.peer`` is the stable import surface.

from __future__ import annotations

import collections
import concurrent.futures
import hashlib
import ipaddress
import random
import struct
import threading
import time

from ..utils import get_logger, metrics, profiling, tracing
from ..utils.cancel import Cancelled, CancelToken
from . import bencode, utp
from .http import TransferError
from .magnet import TorrentJob
from .inbound import PeerListener, _InboundPeer
from .peerwire import (
    ALLOWED_FAST_K,
    BLOCK_SIZE,
    ENCRYPTION_MODES,
    HANDSHAKE_PSTR,
    IDLE_REAP_TIMEOUT,
    MAX_REQUEST_LENGTH,
    MSG_ALLOWED_FAST,
    MSG_BITFIELD,
    MSG_CANCEL,
    MSG_CHOKE,
    MSG_EXTENDED,
    MSG_HAVE,
    MSG_HAVE_ALL,
    MSG_HAVE_NONE,
    MSG_INTERESTED,
    MSG_NOT_INTERESTED,
    MSG_PIECE,
    MSG_REJECT,
    MSG_REQUEST,
    MSG_UNCHOKE,
    TRANSPORT_MODES,
    UTP_CONNECT_TIMEOUT,
    UT_METADATA,
    UT_PEX,
    PeerConnection,
    PeerIdentityError,
    PeerProtocolError,
    _frame,
    _is_private,
    _recv_into,
    allowed_fast_set,
    fetch_metadata,
    generate_peer_id,
    pack_bitfield,
)
from . import sources as source_board
from .pieces import PieceStore
from .swarmstate import _PieceBatch, _SwarmState
from .tracker import (
    announce,
    announce_udp,
    decode_compact_peers,
    decode_compact_peers6,
)
from .webseed import (
    _WebSeedClient,
    _WebSeedPermanent,
    _WebSeedSource,
    _fetch_webseed_piece,
    _webseed_file_url,
)

log = get_logger("fetch.peer")


# ---------------------------------------------------------------------------
# swarm download




class SwarmDownloader:
    def __init__(
        self,
        job: TorrentJob,
        base_dir: str,
        metadata_timeout: float = 600.0,
        progress_interval: float = 1.0,
        peer_id: bytes | None = None,
        dht_bootstrap: tuple[tuple[str, int], ...] | None = None,
        max_peer_connections: int = 4,
        listen: bool = True,
        listen_port: int = 0,
        seed_drain_timeout: float = 10.0,
        discovery_rounds: int = 4,
        encryption: str = "allow",
        transport: str = "both",
        lsd: bool = False,
        announce_all: bool = False,
        dht_node: "object | None" = None,
    ):
        self._job = job
        # externally-owned process-lifetime DHTNode (daemon): shared
        # across jobs so lookups bootstrap from its warm routing table
        # instead of the BEP 5 routers, and never closed here. None =
        # per-job construction (one-shot CLI / library default),
        # mirroring the reference's per-job client (torrent.go:43-44)
        # — anacrolix itself keeps its DHT server process-wide.
        self._shared_dht_node = dht_node
        self._base_dir = base_dir
        self._metadata_timeout = metadata_timeout
        self._progress_interval = progress_interval
        self._peer_id = peer_id or generate_peer_id()
        # None = BEP 5 default routers; () disables DHT entirely
        self._dht_bootstrap = dht_bootstrap
        self._max_peer_connections = max(1, max_peer_connections)
        self._listen = listen
        self._listen_port = listen_port
        # MSE policy for both halves (ENCRYPTION_MODES keys)
        self._encryption = encryption
        # BEP 27 private flag; set properly once the info dict is known
        self._private = False
        # outbound transport policy (TRANSPORT_MODES keys); the
        # listener accepts both TCP and uTP regardless
        self._transport = transport
        self._utp_mux: "utp.UTPMultiplexer | None" = None
        # BEP 14 local discovery (needs a listener). Library default
        # OFF: real multicast on the well-known group would let
        # unrelated processes/tests with identical info-hashes
        # cross-dial into each other's swarms; the daemon/CLI turns it
        # on (TorrentBackend default) for production jobs.
        self._lsd = lsd
        self._seed_drain_timeout = seed_drain_timeout
        self._discovery_rounds = max(1, discovery_rounds)
        # BEP 12 announce state. Default: tier-ordered announce with a
        # per-tier shuffle (load-spreading, per the BEP) and
        # promote-on-success; ``announce_all=True`` opts into
        # announcing to every tracker concurrently instead (bounded
        # discovery latency when most trackers are dead, at the cost
        # of tracker-etiquette compliance).
        self._announce_all = announce_all
        tiers = job.tracker_tiers or tuple((t,) for t in job.trackers)
        self._tiers: list[list[str]] = []
        for tier in tiers:
            shuffled = list(tier)
            random.shuffle(shuffled)
            self._tiers.append(shuffled)
        # trackers that have accepted an announce this job — the only
        # ones lifecycle events (completed/stopped) should bother
        self._announced: dict[str, None] = {}
        # per-tracker failure backoff for the tiered walk: a dead
        # tracker in a HIGH tier would otherwise cost its full timeout
        # (up to ~15 s) at the top of EVERY discovery round before the
        # walk reaches the tier that works (anacrolix/libtorrent track
        # per-tracker failure state the same way). tracker ->
        # (retry_after_monotonic, current_delay)
        self._tracker_backoff: dict[str, tuple[float, float]] = {}
        # populated by run(): the live announced port and upload stats
        self.listen_port: int | None = None
        self.blocks_served = 0
        self.bytes_served = 0
        # job-thread span worker threads adopt (set by run())
        self._trace_parent = None

    def _discover_peers(
        self,
        left: int,
        token: CancelToken | None = None,
        port: int = 6881,
        allow_empty: bool = False,
        event: str = "started",
        uploaded: int = 0,
        downloaded: int = 0,
        dht_announce_port: int | None = None,
    ) -> list[tuple[str, int]]:
        """Explicit x.pe hints first (they cost nothing), then every
        tracker — http(s) per BEP 3/23, udp per BEP 15 — and a DHT
        get_peers lookup (BEP 5) when the trackers yield nothing: x.pe
        hints are unverified, so they must not suppress the lookup.

        ``port`` is the live listener port to advertise. With
        ``allow_empty`` an empty swarm is returned as [] so the caller
        can re-announce later — but only when at least one tracker
        responded or a DHT lookup completed; a job whose every peer
        source is dead still raises, keeping failure prompt and
        diagnosable."""
        peers: list[tuple[str, int]] = list(self._job.peer_hints)
        tracker_answered = False  # some tracker returned a non-empty swarm
        tracker_responded = False  # some tracker answered at all
        errors: list[str] = []

        def one_announce(tracker: str) -> list[tuple[str, int]]:
            if tracker.startswith(("http://", "https://")):
                return announce(
                    tracker,
                    self._job.info_hash,
                    self._peer_id,
                    left,
                    port=port,
                    event=event,
                    uploaded=uploaded,
                    downloaded=downloaded,
                )
            if tracker.startswith("udp://"):
                return announce_udp(
                    tracker,
                    self._job.info_hash,
                    self._peer_id,
                    left,
                    port=port,
                    event=event,
                    uploaded=uploaded,
                    downloaded=downloaded,
                )
            raise TransferError("unsupported tracker scheme")

        def record_success(tracker: str, found: list) -> None:
            nonlocal tracker_responded, tracker_answered
            tracker_responded = True
            # a tracker now lists us: the teardown "stopped" announce
            # has someone to inform
            self._tracker_contacted = True
            self._announced[tracker] = None
            # any non-empty announce counts, even if it only repeats
            # the x.pe hints — a tracker-confirmed peer is no reason
            # to fall through to a DHT lookup
            tracker_answered = tracker_answered or bool(found)
            for peer in found:
                if peer not in peers:
                    peers.append(peer)

        if self._job.trackers and self._announce_all:
            if token is not None:
                token.raise_if_cancelled()
            # opt-in divergence from BEP 12's try-tiers-in-order
            # semantics: real magnets carry many tr= entries, mostly
            # dead, and each dead one costs its full timeout —
            # serially that is minutes before DHT fires. The cost is
            # more tracker traffic; the win is bounded discovery
            # latency.
            announce_parent = tracing.current_span()

            def pooled_announce(tracker: str) -> list[tuple[str, int]]:
                # pool threads have no thread-local trace; attach their
                # tracker-announce spans to the job that spawned them
                with tracing.adopt(announce_parent):
                    return one_announce(tracker)

            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(self._job.trackers)),
                thread_name_prefix="announce",
            ) as pool:
                futures = {
                    pool.submit(pooled_announce, tracker): tracker
                    for tracker in self._job.trackers
                }
                for future in concurrent.futures.as_completed(futures):
                    try:
                        # deadline: each announce runs with per-tracker HTTP/UDP timeouts, so the future settles within those bounds
                        found = future.result()
                    except TransferError as exc:
                        errors.append(f"{futures[future]}: {exc}")
                        continue
                    record_success(futures[future], found)
            if token is not None:
                token.raise_if_cancelled()
        elif self._job.trackers:
            # BEP 12: walk tiers in order; within a tier (shuffled once
            # per job) try trackers in order and stop at the first that
            # responds, promoting it to the tier's front so later
            # announces go straight to the tracker that works. Lower
            # tiers are touched only when every higher tier failed.
            def attempt(tracker: str) -> bool:
                backoff = self._tracker_backoff.get(tracker)
                try:
                    found = one_announce(tracker)
                except TransferError as exc:
                    # deadline from a FRESH clock: a timing-out tracker
                    # must not consume its own backoff window during
                    # the failing call (urlopen's 15 s would expire a
                    # 15 s window exactly as it is recorded)
                    failed_at = time.monotonic()
                    delay = min(backoff[1] * 2 if backoff else 15.0, 300.0)
                    self._tracker_backoff[tracker] = (
                        failed_at + delay,
                        delay,
                    )
                    errors.append(f"{tracker}: {exc}")
                    return False
                self._tracker_backoff.pop(tracker, None)
                record_success(tracker, found)
                return True

            skipped: list[tuple[str, float]] = []
            for tier in self._tiers:
                succeeded: str | None = None
                for tracker in list(tier):
                    if token is not None:
                        token.raise_if_cancelled()
                    backoff = self._tracker_backoff.get(tracker)
                    if (
                        backoff is not None
                        and time.monotonic() < backoff[0]
                    ):
                        skipped.append((tracker, backoff[0]))
                        errors.append(f"{tracker}: backing off")
                        continue  # recently failed: skip, no timeout
                    if attempt(tracker):
                        succeeded = tracker
                        break
                if succeeded is not None:
                    if tier[0] != succeeded:
                        tier.remove(succeeded)
                        tier.insert(0, succeeded)
                    break
            if not tracker_responded and skipped:
                # every candidate sat inside its backoff window: a round
                # with ZERO actual attempts must not read as "all
                # trackers dead" (a private job with no DHT/LSD would
                # abort while a recovered tracker waits out its window).
                # Try the one closest to its retry time anyway.
                if token is not None:
                    token.raise_if_cancelled()
                attempt(min(skipped, key=lambda item: item[1])[0])

        dht_responded = False
        if (
            not tracker_answered
            and self._dht_bootstrap != ()
            # BEP 27: private torrents never touch the DHT
            and not self._private
        ):
            from .dht import DHTClient, DHTError

            log.with_fields(
                info_hash=self._job.info_hash.hex()
            ).info("no peers from trackers; trying dht")
            try:
                # NOTE: our own serving node is deliberately NOT in the
                # client's bootstrap — announcing to it over loopback
                # would register 127.0.0.1 (useless to remote queriers)
                # and our own lookups would read back our own listener,
                # bypassing the empty-swarm retry. Remote nodes learn
                # our node via its bootstrap pings and return it in
                # their `nodes` answers, so announces reach it with a
                # real source address.
                warm: tuple = ()
                if self._shared_dht_node is not None:
                    # process-lifetime node: bootstrap the lookup from
                    # its warm routing table — zero router queries for
                    # every job after the first (a dead-table lookup
                    # just fails this round; the node self-heals)
                    warm = self._shared_dht_node.routing_nodes()
                if warm:
                    client = DHTClient(bootstrap=warm)
                elif self._dht_bootstrap is not None:
                    client = DHTClient(bootstrap=self._dht_bootstrap)
                else:
                    client = DHTClient()
                # announce our live listener port into the DHT so other
                # leechers can find us (anacrolix's node does the same);
                # None when no listener actually BOUND — a config flag
                # alone must never register a dead port in the DHT
                for peer in client.get_peers(
                    self._job.info_hash,
                    token,
                    announce_port=dht_announce_port,
                ):
                    if (
                        peer[1] == dht_announce_port
                        and ipaddress.ip_address(peer[0]).is_loopback
                    ):
                        # our own announce read back through our own
                        # serving node — not a swarm member
                        continue
                    if peer not in peers:
                        peers.append(peer)
                # responded = some node actually answered; a lookup
                # into a dead network returns [] WITHOUT error and must
                # not count as "the swarm is just empty, retry"
                dht_responded = client.responded
                if self._shared_dht_node is not None and client.seen_nodes:
                    # feed responders back into the shared node's table
                    # (ping-verified there) so the NEXT job's lookup
                    # starts warm — the serving half alone only learns
                    # nodes that happen to contact it
                    self._shared_dht_node.add_candidates(client.seen_nodes)
            except DHTError as exc:
                errors.append(str(exc))

        if not peers:
            if allow_empty and (tracker_responded or dht_responded):
                # a live tracker (or a completed DHT lookup) answered;
                # the swarm just hasn't formed yet — retry next round
                return []
            raise TransferError(
                f"no peers from {len(self._job.trackers)} tracker(s), "
                f"{len(self._job.peer_hints)} hint(s), or dht: "
                + "; ".join(errors[:3])
            )
        return peers

    def run(self, token: CancelToken, progress) -> None:
        # the job thread's open span (the dispatcher's backend span, or
        # None outside a traced job): worker threads spawned below
        # adopt it so their spans (announces, peer connects, piece
        # rounds, webseed ranges) attach to the job's trace
        self._trace_parent = tracing.current_span()
        metrics.GLOBAL.gauge_add("torrent_active_swarms", 1)
        try:
            self._run_guarded(token, progress)
        finally:
            metrics.GLOBAL.gauge_add("torrent_active_swarms", -1)
            # settle the per-kind active-source gauges for whatever
            # webseed/peer sources the swarm registered, however the
            # job ended (the board is created with the swarm state)
            swarm = getattr(self, "_swarm_ref", None)
            if swarm is not None:
                swarm.sources.close()

    def _run_guarded(self, token: CancelToken, progress) -> None:
        listener: PeerListener | None = None
        if self._listen:
            try:
                listener = PeerListener(
                    self._job.info_hash,
                    self._peer_id,
                    port=self._listen_port,
                    encryption=self._encryption,
                )
            except OSError as exc:
                # cannot bind (port taken, restricted host): leech-only
                log.warning(f"peer listener disabled: {exc}")
        completed = False
        self._observed_leecher_ids: set[bytes] = set()
        self.blocks_served = 0  # per-run totals: listener + outbound conns
        self.bytes_served = 0
        self._tracker_contacted = False
        # set by _run once metadata/store exist; the teardown announce
        # computes real downloaded/left counters from them
        self._store_ref: "PieceStore | None" = None
        self._session_start_bytes = 0
        self._lsd_client = None  # set by _run when BEP 14 is live
        # LSD-heard peers before the swarm exists (metadata phase)
        self._lsd_heard: "collections.deque[tuple[str, int]]" = (
            collections.deque(maxlen=64)
        )
        self._lsd_swarm_sink = None  # set once the swarm exists
        # our serving DHT node (BEP 5), when DHT + listener are live:
        # this host answers ping/find_node/get_peers/announce_peer so
        # other leechers can route through and register with us — the
        # full-citizen role anacrolix's node plays (torrent.go:44)
        # per-job serving node, owned and closed by this run. With a
        # shared process-lifetime node (self._shared_dht_node, daemon)
        # none is built: the shared node serves for every job and the
        # lookup/feedback paths read _shared_dht_node directly (private
        # jobs are gated there via BEP 27's _private flag).
        self._dht_node = None
        if self._shared_dht_node is None and (
            listener is not None
            and self._dht_bootstrap != ()
            # a metainfo job already known private (BEP 27) has no use
            # for a serving node; magnets learn too late to gate here
            and not _is_private(self._job.info)
        ):
            try:
                from .dht import DEFAULT_BOOTSTRAP, DHTNode

                self._dht_node = DHTNode(
                    bootstrap=self._dht_bootstrap or DEFAULT_BOOTSTRAP
                )
            except OSError as exc:
                log.with_fields(error=str(exc)).info("dht node unavailable")
        # our live listener port, advertised on outbound connections
        # via BEP 10 "p" so dialed peers can dial us back
        self._advertise_port = (
            listener.port if listener is not None else None
        )
        # outbound uTP rides the listener's mux (so our source port is
        # the announced one, as uTP peers expect); listener-less runs
        # get a private outbound-only mux when the policy wants uTP
        owns_mux = False
        if listener is not None and listener.utp_mux is not None:
            self._utp_mux = listener.utp_mux
        elif "utp" in TRANSPORT_MODES.get(self._transport, ()):
            try:
                self._utp_mux = utp.UTPMultiplexer()
                owns_mux = True
            except OSError as exc:
                log.warning(f"outbound uTP disabled: {exc}")
        try:
            self._run(token, progress, listener)
            completed = True
        finally:
            if owns_mux and self._utp_mux is not None:
                self._utp_mux.close()
            if self._lsd_client is not None:
                self._lsd_client.close()
            if self._dht_node is not None:
                self._dht_node.close()
            if listener is not None:
                # drain only after a successful download: a completed
                # job lingers briefly so remote leechers (peers seen
                # with incomplete bitfields) can finish pulling from us;
                # failed/cancelled jobs tear down immediately
                listener.close(
                    drain_timeout=self._seed_drain_timeout
                    if completed and not token.cancelled()
                    else 0.0,
                    expected_leechers=self._observed_leecher_ids,
                )
                self.blocks_served += listener.blocks_served
                self.bytes_served += listener.bytes_served
                if self.bytes_served:
                    log.with_fields(
                        blocks=self.blocks_served, bytes=self.bytes_served
                    ).info("served peers while downloading")
            metrics.GLOBAL.add("torrent_bytes_served", self.bytes_served)
            metrics.GLOBAL.add("torrent_blocks_served", self.blocks_served)
            # lifecycle announces, fire-and-forget (teardown must not
            # wait on trackers) but SEQUENCED in one thread: "completed"
            # first (anacrolix announces completion too), then BEP 3
            # "stopped" so trackers stop handing out our dead port —
            # a "completed" landing after "stopped" would re-register
            # it. Sent whenever a tracker may list us: a discovery-time
            # response proved it, and a completed job's own announce
            # can register us even when discovery never got through.
            if self._job.trackers and (self._tracker_contacted or completed):
                store = self._store_ref
                downloaded = left = 0
                if store is not None:
                    done = store.bytes_completed()
                    downloaded = done - self._session_start_bytes
                    left = store.total_length - done
                elif not completed:
                    left = 1  # no metadata: true remainder unknowable
                threading.Thread(
                    target=self._announce_teardown,
                    args=(
                        completed,
                        self.listen_port or 6881,
                        self.bytes_served,
                        downloaded,
                        left,
                    ),
                    daemon=True,
                    name="announce-teardown",
                ).start()

    def _announce_teardown(
        self, completed: bool, port: int, uploaded: int, downloaded: int, left: int
    ) -> None:
        try:
            if completed:
                self._announce_event("completed", port, uploaded, downloaded, 0)
            self._announce_event("stopped", port, uploaded, downloaded, left)
        except Exception as exc:
            # lifecycle events are best-effort courtesy to the tracker;
            # the job is already settled when this thread runs
            log.debug(f"tracker teardown announce failed: {exc}")

    def _run(
        self, token: CancelToken, progress, listener: "PeerListener | None"
    ) -> None:
        deadline = time.monotonic() + self._metadata_timeout
        port = listener.port if listener is not None else 6881
        self.listen_port = port

        info = self._job.info
        peers: list[tuple[str, int]] | None = None
        last_error: Exception | None = None
        # "started" exactly once per job; every later announce is a
        # regular re-announce (event="") per tracker semantics
        announce_event = "started"
        dht_port = listener.port if listener is not None else None

        # BEP 27: a private torrent must use its trackers ONLY — no
        # DHT, no LSD, no PEX. Known up front for metainfo jobs; magnet
        # jobs learn it with the metadata (the bootstrap lookup that
        # fetched the metadata is the unavoidable exception, noted
        # below where it lands).
        self._private = _is_private(info)

        # BEP 14 local discovery starts NOW — before the metadata
        # phase — so a magnet whose only peer is on the LAN can
        # bootstrap its metadata from it. Heard peers buffer in
        # _lsd_heard until the swarm exists, then flow into its queue.
        # Needs a real listener (the announce carries a port someone
        # must be able to dial); degrades silently without multicast.
        if listener is not None and self._lsd and not self._private:
            try:
                from .lsd import LSD

                def lsd_sink(peer):
                    sink = self._lsd_swarm_sink
                    if sink is not None:
                        sink(peer)
                    else:
                        self._lsd_heard.append(peer)

                # closed by run()'s teardown, which wraps this method
                self._lsd_client = LSD(
                    self._job.info_hash, listener.port, lsd_sink
                )
            except OSError as exc:
                log.with_fields(error=str(exc)).info("lsd unavailable")

        if info is None:
            discovery_error: Exception | None = None
            try:
                # dht_announce_port=None: whether this magnet is
                # PRIVATE (BEP 27) is unknown until the metadata
                # arrives, and a DHT announce for a private info-hash
                # would persist in remote nodes for their peer TTL; the
                # first post-metadata discovery round announces instead
                peers = self._discover_peers(
                    left=1, token=token, port=port, dht_announce_port=None
                )
                announce_event = ""
            except TransferError as exc:
                if self._lsd_client is None:
                    raise  # fail-fast: every peer source is dead
                discovery_error = exc
                peers = []
            log.info("fetching torrent metadata")
            # bounded BEP 14 grace: when the classic sources are dead
            # or dry, the LAN gets a short window to answer before the
            # job fails — without LSD the single pass below preserves
            # the original fail-fast behavior. Peers are retried on
            # every pass (dedup within a pass only): a LAN peer dialed
            # a beat too early legitimately has no metadata YET (its
            # own resume/attach may still be running)
            lsd_grace = time.monotonic() + (
                5.0 if self._lsd_client is not None else 0.0
            )
            # LAN peers drained out of the LSD deque (popleft is safe
            # against the listen thread's concurrent appends; iterating
            # the live deque is not) — accumulated so passes retry them,
            # and handed to the swarm with the tracker peers afterwards
            lan_peers: list[tuple[str, int]] = []
            while info is None:
                while self._lsd_heard:
                    lan_peers.append(self._lsd_heard.popleft())
                tried: set[tuple[str, int]] = set()
                for host, peer_port in list(peers) + lan_peers:
                    if (host, peer_port) in tried:
                        continue
                    tried.add((host, peer_port))
                    token.raise_if_cancelled()
                    try:
                        with PeerConnection(
                            host,
                            peer_port,
                            self._job.info_hash,
                            self._peer_id,
                            token,
                            encryption=self._encryption,
                            transport=self._transport,
                            utp_mux=self._utp_mux,
                            listen_port=self._advertise_port,
                        ) as conn:
                            info = fetch_metadata(
                                conn, self._job.info_hash, deadline
                            )
                            break
                    except (TransferError, OSError) as exc:
                        last_error = exc
                if info is not None:
                    break
                now = time.monotonic()
                if now >= lsd_grace or now >= deadline:
                    raise TransferError(
                        f"failed to get metadata: {last_error or discovery_error}"
                    )
                token.raise_if_cancelled()
                time.sleep(0.1)
            log.info("fetched torrent metadata")
            if _is_private(info):
                # a magnet that turned out private (BEP 27): the
                # metadata-bootstrap lookup already happened — that is
                # the unavoidable exception — but from here on the job
                # is trackers-only: stop LSD, forget LAN/DHT-sourced
                # peers (peers=None forces a tracker-only rediscovery),
                # and the _private flag gates DHT and PEX below
                self._private = True
                if self._lsd_client is not None:
                    self._lsd_client.close()
                    self._lsd_client = None
                self._lsd_heard.clear()
                lan_peers.clear()
                peers = None
                log.info("private torrent: dht/lsd/pex disabled")
            else:
                # metadata-phase LAN peers must reach the swarm queue
                for peer in lan_peers:
                    if peer not in peers:
                        peers.append(peer)

        store = PieceStore(info, self._base_dir)

        # resume whatever an interrupted job left behind before touching
        # the swarm (batch re-verify through the digest engine)
        resumed = store.resume_existing()
        if resumed:
            log.with_fields(
                resumed=resumed, pieces=store.num_pieces
            ).info("resumed verified pieces from disk")
        if all(store.have):
            progress(100.0)
            return
        # BEP 3 "downloaded" is a per-SESSION counter: bytes verified
        # off disk by the resume scan were not served by anyone this
        # session and must not inflate tracker ratio accounting
        session_start_bytes = store.bytes_completed()
        # the teardown announce derives its counters from the store
        self._store_ref = store
        self._session_start_bytes = session_start_bytes

        swarm = _SwarmState(store, progress, self._progress_interval)
        self._swarm_ref = swarm  # run()'s finally settles its source board
        # outbound reciprocation: completed pieces are announced (HAVE)
        # on every live outbound connection, mirroring the listener's
        # observer on the inbound side
        store.add_observer(swarm.broadcast_have)

        if listener is not None:
            # arm the serving side; metadata is served only if the
            # canonical re-encoding reproduces the info-hash (a peer
            # could have delivered non-canonical metadata bytes whose
            # re-encoding would hash differently — serving those would
            # poison downstream magnet bootstraps)
            info_bytes = bencode.encode(info)
            if hashlib.sha1(info_bytes).digest() != self._job.info_hash:
                info_bytes = None
            listener.attach(
                store,
                info_bytes,
                # BEP 27: no outgoing PEX gossip for private torrents
                # (a None source suppresses ut_pex sends entirely)
                peer_source=None if self._private else swarm.known_peers,
                peer_sink=lambda peer: swarm.enqueue_discovered([peer]),
            )

        # LSD peers now flow straight into the swarm queue; drain
        # whatever the LAN answered during the metadata phase
        self._lsd_swarm_sink = lambda peer: swarm.enqueue_discovered([peer])
        while self._lsd_heard:
            swarm.enqueue_discovered([self._lsd_heard.popleft()])

        log.with_fields(
            pieces=store.num_pieces,
            total=store.total_length,
        ).info("waiting for torrent download")
        # Re-announce loop: anacrolix keeps announcing on the tracker
        # interval for the life of the client; this loop does the
        # bounded-job version — when the current peers are exhausted but
        # pieces remain, re-discover and retry. This is what lets two
        # leechers bootstrap off each other: whichever announces first
        # sees an empty swarm, and finds the other on the next round.
        # BEP 19 webseeds run as independent workers for the life of
        # the job: they claim pieces through the same swarm state, so
        # rarest-first/endgame coordination covers them, and a job with
        # zero reachable peers can still complete over HTTP
        web_workers = [
            threading.Thread(  # thread-role: webseed-worker
                target=self._web_seed_worker,
                args=(url, swarm, token),
                daemon=True,
                name=f"webseed-{i}",
            )
            for i, url in enumerate(self._job.web_seeds)
        ]
        for worker in web_workers:
            worker.start()
            profiling.ROLES.register_thread(worker, "webseed-worker")

        # count CONSECUTIVE fruitless rounds: a round that completed
        # pieces proves the swarm is alive, so the budget resets — a
        # large torrent trickling through flaky peers must not be
        # aborted after a fixed number of rounds while it is working
        fruitless_rounds = 0
        while True:
            progress_before = store.bytes_completed()
            if peers is None:
                try:
                    peers = self._discover_peers(
                        left=store.total_length - store.bytes_completed(),
                        token=token,
                        port=port,
                        allow_empty=True,
                        event=announce_event,
                        uploaded=(listener.bytes_served if listener else 0)
                        + self.bytes_served,
                        downloaded=store.bytes_completed() - session_start_bytes,
                        dht_announce_port=dht_port,
                    )
                    announce_event = ""
                except TransferError as exc:
                    swarm.last_error = exc
                    if self._lsd_client is None:
                        break  # every PEER source is dead (webseeds below)
                    # BEP 14 may still feed the queue even with every
                    # classic source dead: spend a (budgeted) round on
                    # whatever the LAN announces
                    peers = []
            swarm.enqueue_discovered(peers)
            workers = [
                threading.Thread(  # thread-role: peer-worker
                    target=self._peer_worker,
                    args=(swarm, token),
                    daemon=True,
                    name=f"peer-worker-{i}",
                )
                for i in range(min(self._max_peer_connections, len(swarm.peer_queue)))
            ]
            for worker in workers:
                worker.start()
                profiling.ROLES.register_thread(worker, "peer-worker")
            for worker in workers:
                # deadline: each PeerConnection registers a cancel hook that closes its socket, so a cancel unblocks every worker promptly and they exit
                worker.join()
            token.raise_if_cancelled()
            if swarm.done():
                break
            if store.bytes_completed() > progress_before:
                fruitless_rounds = 0
            else:
                fruitless_rounds += 1
                if fruitless_rounds >= self._discovery_rounds:
                    break
            time.sleep(min(0.2 * (fruitless_rounds + 1), 1.0))
            token.raise_if_cancelled()
            peers = None  # re-announce next round

        # webseeds may still be mid-fetch when the peer rounds end —
        # including the zero-peers case, where they're the only source
        for worker in web_workers:
            # deadline: webseed workers run HTTP/FTP ops under 30s connection timeouts and exit on the cancelled token between requests
            worker.join()
        token.raise_if_cancelled()

        if not all(store.have):
            missing = store.have.count(False)
            raise TransferError(
                f"failed to download torrents: {missing}/{store.num_pieces} "
                f"pieces missing (recent errors: {swarm.error_summary()})"
            )

        # the "completed" announce fires from run()'s teardown thread,
        # sequenced BEFORE the "stopped" announce — racing them lets a
        # late "completed" re-register the just-deregistered dead port

    def _announce_event(
        self,
        event: str,
        port: int,
        uploaded: int,
        downloaded: int,
        left: int = 0,
    ) -> None:
        """Best-effort lifecycle announce ("completed"/"stopped");
        short timeouts, errors swallowed — stats only. Tiered mode
        informs only the trackers that actually accepted an announce
        this job (BEP 12 etiquette: the others never listed us) —
        unless NONE did, where a completed job's announce can still
        register us (the run() teardown gate's promise), so fall back
        to every tracker. Announce-all mode always tells everyone,
        matching its registration."""
        targets = (
            tuple(self._announced)
            if not self._announce_all and self._announced
            else self._job.trackers
        )
        for tracker in targets:
            try:
                if tracker.startswith(("http://", "https://")):
                    announce(
                        tracker,
                        self._job.info_hash,
                        self._peer_id,
                        left=left,
                        port=port,
                        timeout=5.0,
                        event=event,
                        uploaded=uploaded,
                        downloaded=downloaded,
                    )
                elif tracker.startswith("udp://"):
                    announce_udp(
                        tracker,
                        self._job.info_hash,
                        self._peer_id,
                        left=left,
                        port=port,
                        timeout=2.0,
                        retries=0,
                        event=event,
                        uploaded=uploaded,
                        downloaded=downloaded,
                    )
            except TransferError:
                pass  # best-effort: lifecycle stats only

    def _web_seed_worker(
        self, url: str, swarm: "_SwarmState", token: CancelToken
    ) -> None:
        with tracing.adopt(self._trace_parent):
            self._web_seed_worker_traced(url, swarm, token)

    def _web_seed_worker_traced(
        self, url: str, swarm: "_SwarmState", token: CancelToken
    ) -> None:
        """One BEP 19 webseed: claim pieces like any worker, fetch them
        over HTTP Range, verify through the same batch path. Tolerates
        transient fetch failures (peers get retried via re-announce
        rounds; a webseed's retry budget lives here) and gives up for
        the job after 3 consecutive ones."""
        source = _WebSeedSource()
        batch = _PieceBatch(swarm, owner=source)
        store = swarm.store
        client = _WebSeedClient()
        # multi-source accounting (fetch/sources.py): this webseed's
        # rate and error score land on the swarm's shared board next to
        # the peers'; a demotion slows the lane down (trickle pacing
        # below) instead of banning it, and retirement ends the worker
        board = swarm.sources
        lane = board.add(source_board.KIND_WEBSEED, tracing.redact_url(url))
        # cancellation must unblock an in-flight HTTP read immediately
        # (the established pattern — HTTPBackend registers the same
        # kind of hook on its response)
        remove_hook = token.add_callback(client.close)
        failures = 0
        try:
            while not token.cancelled() and not swarm.done():
                if lane.retired:
                    break  # the board gave this webseed up for the job
                if lane.state == source_board.TRICKLE:
                    # the trickle lane: demoted-but-not-banned — keep
                    # fetching (the rate stays measured, recovery
                    # re-promotes) at a pace that cannot crowd the
                    # claim pool's tail
                    time.sleep(0.1)
                board.rebalance()
                index = swarm.claim(source)
                if index is swarm.WAIT:
                    batch.flush()
                    time.sleep(0.05)
                    continue
                if index is None:
                    break
                try:
                    data = _fetch_webseed_piece(client, url, store, index)
                    failures = 0
                    board.note_success(lane)
                except _WebSeedPermanent:
                    swarm.release(index, source)
                    board.note_error(lane, permanent=True)
                    raise  # retrying cannot fix a 4xx/redirect
                except TransferError as exc:
                    swarm.release(index, source)
                    token.raise_if_cancelled()  # close() looks transient
                    swarm.last_error = exc
                    board.note_error(lane)
                    failures += 1
                    if failures >= 3:
                        raise
                    time.sleep(0.2 * failures)
                    continue
                except BaseException:
                    swarm.release(index, source)
                    raise
                board.note_bytes(lane, len(data))
                batch.add(index, data)
                if swarm.endgame:
                    batch.flush()
                swarm.tick_progress()
            if not token.cancelled():
                batch.flush()
        except Cancelled:
            return
        except Exception as exc:
            swarm.last_error = exc
            log.with_fields(webseed=url).warning(f"webseed failed: {exc}")
        finally:
            remove_hook()
            client.close()
            if not token.cancelled():
                try:
                    batch.flush()
                except Exception as exc:
                    swarm.last_error = exc
                    log.warning(f"webseed flush while unwinding failed: {exc}")
            swarm.tick_progress()

    def _peer_worker(self, swarm: "_SwarmState", token: CancelToken) -> None:
        with tracing.adopt(self._trace_parent):
            self._peer_worker_traced(swarm, token)

    def _peer_worker_traced(
        self, swarm: "_SwarmState", token: CancelToken
    ) -> None:
        """One swarm worker: pull peers off the shared queue and serve
        claimable pieces from each until the swarm is done."""
        while not token.cancelled() and not swarm.done():
            peer = swarm.next_peer()
            if peer is None:
                return  # no peers left to try
            host, port = peer
            try:
                # span covers the dial + handshake only; piece traffic
                # gets its own spans in _serve_pieces
                with tracing.span("peer-connect", peer=f"{host}:{port}"):
                    conn = PeerConnection(
                        host,
                        port,
                        self._job.info_hash,
                        self._peer_id,
                        token,
                        encryption=self._encryption,
                        transport=self._transport,
                        utp_mux=self._utp_mux,
                        listen_port=self._advertise_port,
                    )
                with conn:
                    swarm.register(conn)
                    # per-peer lane on the swarm's source board: piece
                    # bytes feed its EWMA so /metrics and the incident
                    # probes tell the same mirror/webseed/peer story
                    lane = swarm.sources.add(
                        source_board.KIND_PEER, f"{host}:{port}"
                    )
                    try:
                        self._serve_pieces(conn, swarm, token, lane)
                    finally:
                        swarm.sources.retire(lane)  # connection over
                        swarm.unregister(conn)
                        with swarm._lock:  # concurrent worker exits
                            self.blocks_served += conn.blocks_served
                            self.bytes_served += conn.bytes_served
                        # a peer whose bitfield is incomplete is a
                        # leecher that will want our pieces; remember
                        # its peer_id so the post-completion drain gives
                        # it time to finish pulling from our listener
                        num = swarm.store.num_pieces
                        if conn.bitfield and not all(
                            conn.has_piece(i) for i in range(num)
                        ):
                            self._observed_leecher_ids.add(conn.remote_peer_id)
            except Cancelled:
                return  # quiet exit; run() re-raises in the main thread
            except Exception as exc:
                # broad on purpose: an unexpected error (progress callback
                # bug, select on a closed fd) must surface in the job's
                # final error message, not die silently in the thread's
                # excepthook and leave 'last error: None'
                swarm.last_error = exc
                log.with_fields(peer=f"{host}:{port}").warning(
                    f"peer failed: {exc}; trying next"
                )

    @staticmethod
    def _download_piece(
        conn: PeerConnection, store: PieceStore, index: int
    ) -> bytes | None:
        """Pipeline all block requests for one piece and collect the
        blocks; None when the piece was abandoned because an endgame
        duplicate verified first (cancel-on-first-win). Raises on CHOKE
        mid-piece and on a BEP 6 REJECT of this piece — both mean the
        caller should release the claim and move on."""
        size = store.piece_size(index)
        blocks: dict[int, bytes] = {}
        offsets = list(range(0, size, BLOCK_SIZE))
        for begin in offsets:
            conn.send_message(
                MSG_REQUEST,
                struct.pack(
                    ">III", index, begin, min(BLOCK_SIZE, size - begin)
                ),
            )
        while len(blocks) < len(offsets):
            if store.have[index]:
                # endgame cancel-on-first-win: another worker's
                # duplicate of this piece verified first; cancel the
                # outstanding requests and move on rather than
                # finishing a download nobody needs
                for begin in offsets:
                    if begin not in blocks:
                        conn.send_message(
                            MSG_CANCEL,
                            struct.pack(
                                ">III",
                                index,
                                begin,
                                min(BLOCK_SIZE, size - begin),
                            ),
                        )
                return None
            msg_id, payload = conn.read_message()
            if msg_id == MSG_CHOKE and index not in conn.allowed_fast:
                # a CHOKE does not void allowed-fast transfers (BEP 6)
                raise PeerProtocolError("peer choked mid-piece")
            if (
                msg_id == MSG_REJECT
                and len(payload) >= 4
                and struct.unpack(">I", payload[:4])[0] == index
            ):
                # BEP 6: an explicit no — move on NOW instead of
                # grinding to the 20 s socket timeout
                raise PeerProtocolError(f"peer rejected piece {index}")
            if msg_id != MSG_PIECE or len(payload) < 8:
                continue
            got_index, begin = struct.unpack(">II", payload[:8])
            if got_index == index:
                blocks[begin] = payload[8:]
        return b"".join(blocks[b] for b in sorted(blocks))

    def _serve_pieces(
        self,
        conn: PeerConnection,
        swarm: "_SwarmState",
        token: CancelToken,
        lane: "source_board.Source | None" = None,
    ) -> None:
        store = swarm.store
        batch = _PieceBatch(swarm, owner=conn)
        # reciprocate on this connection too: the remote may have no
        # inbound path to us (NAT); serve its requests from the store
        # and announce what we already have / newly acquire
        conn.attach_store(store)
        conn.send_message(MSG_INTERESTED)
        # announce what we hold BEFORE waiting on the unchoke: a
        # tit-for-tat remote that keeps unproven peers choked decides
        # whether to reciprocate based on these HAVEs — flushing only
        # after unchoke would deadlock against exactly such peers
        def drain_gossip() -> None:
            if self._private:
                # BEP 27: PEX must not grow a private torrent's swarm
                conn.pex_peers = []
                return
            if conn.pex_peers:
                swarm.add_peers(conn.pex_peers)
                conn.pex_peers = []

        conn.flush_haves()
        # BEP 6: allowed-fast grants let a still-choked peer start on
        # those pieces immediately — tit-for-tat bootstrapping
        while conn.choked and not conn.allowed_fast:
            msg_id, _ = conn.read_message()
            conn.flush_haves()
            drain_gossip()

        try:
            while True:
                token.raise_if_cancelled()
                conn.flush_haves()
                drain_gossip()
                index = swarm.claim(
                    conn, only=conn.allowed_fast if conn.choked else None
                )
                if index is None and conn.choked:
                    # settle our own batch FIRST: the claims this conn
                    # holds may be the very pieces completing the
                    # torrent (claim() returns None for self-claimed
                    # pieces), and polling with them unflushed would
                    # spin forever waiting for a done() that can't come
                    batch.flush()
                    if swarm.done():
                        break  # complete: don't wait out an unchoke
                    # allowed-fast exhausted while still choked: the
                    # peer may yet unchoke us. Poll (not block) so a
                    # completion by another worker releases us promptly
                    conn.poll_messages(0.05)
                    conn.flush_haves()
                    drain_gossip()
                    continue
                if index is swarm.WAIT:
                    # every missing piece is claimed by another worker;
                    # one may come back via release() if that worker's
                    # peer dies, so hold this healthy connection instead
                    # of dropping it — and settle our pending pieces
                    # while idle so claims don't sit unverified
                    batch.flush()
                    conn.poll_messages(0.05)
                    continue
                if index is None:
                    break  # done, or nothing left this peer can provide
                try:
                    if conn.choked and index not in conn.allowed_fast:
                        # choked while we idled in WAIT; poll so an
                        # endgame win on this piece frees us promptly
                        while conn.choked and not store.have[index]:
                            conn.poll_messages(0.05)
                    # piece rounds: chatty on real torrents, so the
                    # trace's span cap (MAX_SPANS_PER_TRACE) bounds
                    # them; overflow is counted, not accumulated
                    with tracing.span("piece", index=index):
                        data = self._download_piece(conn, store, index)
                    if data is not None:
                        if lane is not None:
                            # per-peer rate accounting on the shared
                            # source board (fetch/sources.py)
                            swarm.sources.note_bytes(lane, len(data))
                            swarm.sources.note_success(lane)
                        batch.add(index, data)
                        if swarm.endgame:
                            # tail pieces settle immediately: batching an
                            # endgame piece would delay the very win that
                            # cancels the redundant downloads
                            batch.flush()
                except BaseException:
                    # our stake only: an endgame duplicate's failure must
                    # not yank the original downloader's claim
                    swarm.release(index, conn)
                    raise
                swarm.tick_progress()
            # normal exit: settle the tail batch here, where a failed
            # verdict propagates and the worker moves to the next peer
            batch.flush()
            drain_gossip()
        finally:
            # exception paths only (flush() is a no-op when empty): a
            # second failure while unwinding — verification OR a write
            # error — must not mask the original error; record it and
            # move on. After cancellation, skip the flush entirely: the
            # job is being torn down and must not keep writing (the
            # resume scan re-fetches whatever the batch still held).
            if not token.cancelled():
                try:
                    batch.flush()
                except Exception as exc:
                    swarm.last_error = exc
                    log.warning(f"flush while unwinding failed: {exc}")
            swarm.tick_progress()
