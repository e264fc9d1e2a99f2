"""The inbound peer half: the listener behind the announced port
(TCP + uTP multiplexed on one port number, MSE auto-detected), the
per-connection serve loop, and the slot-bounded upload choker
(least-served fairness + optimistic rotation).

Matches the serving role anacrolix's client plays for the reference
(torrent.go:44); this is the JAX package's fetch/inbound.py, with the
same behaviour.
"""

from __future__ import annotations

import hashlib
import os
import queue
import random
import secrets
import socket
import struct
import threading
import time

from ..utils import get_logger, metrics
from . import bencode, mse, utp
from .dualstack import bind_dual_stack_tcp, display_form
from .peerwire import (
    ALLOWED_FAST_K,
    BLOCK_SIZE,
    ENCRYPTION_MODES,
    HANDSHAKE_PSTR,
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
    UT_METADATA,
    UT_PEX,
    PeerProtocolError,
    _frame,
    _recv_into,
    allowed_fast_set,
    pack_bitfield,
)
from .pieces import PieceStore

log = get_logger("fetch.peer")



class _InboundPeer:
    """One accepted connection: handshake, then serve the remote leecher.

    INTERESTED is answered with UNCHOKE when the listener grants an
    upload slot (PeerListener's choker — slot-bounded with an optimistic
    rotation, the shape anacrolix's choking algorithm gives the
    reference, torrent.go:44); REQUESTs for completed pieces are
    answered from the store, and ut_metadata requests are served from
    the raw info dict so magnet-only peers can bootstrap metadata from
    us (BEP 9).
    """

    def __init__(self, listener: "PeerListener", sock: socket.socket, addr):
        self._listener = listener
        self._sock = sock
        self.addr = addr
        # the serve loop and the sender thread interleave writes on one
        # socket; frames must not shear
        self._send_lock = threading.Lock()
        self.interested = False
        # sticky: drain accounting must still count a leecher that sent
        # NOT_INTERESTED when finished (spec-compliant behavior)
        self.ever_interested = False
        self.remote_peer_id = b""  # set once the handshake arrives
        self.remote_supports_fast = False  # BEP 6, from the handshake
        self._unchoked = False
        # BEP 6 allowed-fast pieces granted to this peer: requests for
        # them are served even while choked
        self._fast_grants: set[int] = set()
        # total bytes served to this peer; the choker's fairness key.
        # Written by the serve thread, read by the rechoke thread — a
        # plain int is fine, a stale read only shifts one ranking round
        self.bytes_to_peer = 0
        self._remote_ext: dict[bytes, int] = {}
        # nothing may be written before our handshake reply is on the
        # wire: attach()/HAVE broadcasts land mid-handshake otherwise
        # and the remote reads them as garbled handshake bytes
        self._ready = threading.Event()
        # async outbound frames (HAVE broadcasts, deferred UNCHOKE) go
        # through a sender thread so a stalled remote's full TCP buffer
        # can never block the piece-writer thread that completed a piece
        self._outq: "queue.Queue[bytes | None]" = queue.Queue(maxsize=65536)
        # bytes already consumed from the wire that the read path must
        # yield first (the MSE initial-payload hand-off)
        self._prefix = bytearray()
        # generous: a remote in its WAIT state (all missing pieces
        # claimed elsewhere) legitimately idles without keepalives
        sock.settimeout(120.0)

    # -- outgoing --------------------------------------------------------

    def _send(self, msg_id: int, payload: bytes = b"") -> None:
        with self._send_lock:
            # analysis: ignore[no-blocking-under-lock] _send_lock is this connection's dedicated write lock; serializing the blocking send is its entire job
            self._sock.sendall(_frame(msg_id, payload))

    def _enqueue(self, frame: bytes) -> None:
        if not self._ready.is_set():
            return  # pre-handshake; the post-handshake catch-up covers it
        try:
            self._outq.put_nowait(frame)
        except queue.Full:
            self.close()  # pathologically slow consumer: reap

    def _sender_loop(self) -> None:
        while True:
            try:
                frame = self._outq.get(timeout=55.0)
            except queue.Empty:
                if not self._ready.is_set():
                    continue  # mid-handshake: nothing may precede it
                # nothing to say for ~a minute: keepalive, so a remote
                # idling in its WAIT state doesn't reap us as dead
                frame = struct.pack(">I", 0)
            if frame is None:
                return
            # batch whatever else is queued into one sendall: an
            # attach-time catch-up can queue thousands of 9-byte HAVE
            # frames, and per-frame syscalls would flood the socket path
            batch = bytearray(frame)
            done = False
            while True:
                try:
                    extra = self._outq.get_nowait()
                except queue.Empty:
                    break
                if extra is None:
                    done = True
                    break
                batch += extra
            try:
                with self._send_lock:
                    # analysis: ignore[no-blocking-under-lock] _send_lock is this connection's dedicated write lock; serializing the blocking send is its entire job
                    self._sock.sendall(batch)
            except OSError:
                return  # dying connection; the serve loop reaps it
            except Exception as exc:
                # an escaped bug would kill the sender silently while
                # the serve loop keeps queueing frames into the void;
                # close the connection so both halves get reaped
                log.with_fields(peer=self.addr[0]).warning(
                    f"inbound sender failed: {exc}"
                )
                self.close()
                return
            if done:
                return

    def notify_have(self, index: int) -> None:
        self._enqueue(_frame(MSG_HAVE, struct.pack(">I", index)))

    def arm(self, have_indices: list[int]) -> None:
        """Attach-time catch-up for an already-handshaken connection:
        pieces that existed before attach (resume) go out as HAVE
        frames — a late BITFIELD is not spec-legal — and a remote that
        declared INTERESTED while we had nothing to serve gets its
        deferred UNCHOKE plus its allowed-fast grants. Connections
        still mid-handshake are skipped (_enqueue no-ops pre-ready);
        their post-handshake catch-up re-snapshots the store and
        covers the same ground."""
        for index in have_indices:
            self.notify_have(index)
        store, _ = self._listener.snapshot()
        if store is not None and self._ready.is_set():
            # pre-ready, _enqueue silently drops frames — granting here
            # would mark the set sent without it ever reaching the
            # wire; the post-handshake catch-up covers that window
            self._grant_allowed_fast(store.num_pieces, enqueue=True)
        self._maybe_unchoke()

    def _grant_allowed_fast(self, num_pieces: int, enqueue: bool) -> None:
        """Send the BEP 6 allowed-fast set once (idempotent): pieces
        this remote may request even while choked — tit-for-tat
        bootstrapping for peers the choker keeps waiting."""
        if not self.remote_supports_fast or self._fast_grants:
            return
        self._fast_grants = allowed_fast_set(
            self.addr[0], self._listener.info_hash, num_pieces
        )
        for index in sorted(self._fast_grants):
            payload = struct.pack(">I", index)
            if enqueue:
                self._enqueue(_frame(MSG_ALLOWED_FAST, payload))
            else:
                self._send(MSG_ALLOWED_FAST, payload)

    def _maybe_unchoke(self) -> None:
        store, _ = self._listener.snapshot()
        if store is None or not self.interested:
            return  # defer: nothing to serve until attach
        self._listener.request_unchoke(self)

    def grant_unchoke(self) -> None:
        """Choker decision: this peer holds an upload slot now.
        Benign race: two callers can both pass the check and enqueue a
        duplicate UNCHOKE, which the protocol tolerates."""
        if self._unchoked:
            return
        self._unchoked = True
        self._enqueue(_frame(MSG_UNCHOKE))

    def revoke_unchoke(self) -> None:
        """Choker decision: slot lost; the remote must stop requesting
        (requests that race the CHOKE are REJECTed/dropped by
        _serve_request's _unchoked check)."""
        if not self._unchoked:
            return
        self._unchoked = False
        self._enqueue(_frame(MSG_CHOKE))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            self._outq.put_nowait(None)  # wake the sender so it exits
        except queue.Full:
            pass  # sender will die on the closed socket instead

    # -- serve loop ------------------------------------------------------

    def run(self) -> None:
        sender = threading.Thread(
            target=self._sender_loop,
            daemon=True,
            name=f"peer-send-{self.addr[0]}:{self.addr[1]}",
        )
        sender.start()
        metrics.GLOBAL.gauge_add("torrent_active_peers", 1)
        try:
            self._serve()
        except (OSError, PeerProtocolError, struct.error):
            pass  # remote gone or misbehaving: reap quietly
        finally:
            metrics.GLOBAL.gauge_add("torrent_active_peers", -1)
            self.close()
            self._listener.discard(self)

    def _recv_exact(self, count: int) -> bytes:
        out = bytearray()
        if self._prefix:
            out += self._prefix[:count]
            del self._prefix[:count]
        if len(out) < count:
            data = _recv_into(self._sock, count - len(out))
            if data is None:
                raise OSError("remote closed")
            out += data
        return bytes(out)

    def _serve(self) -> None:
        # plaintext vs MSE detection: a plaintext BT handshake begins
        # with 0x13"BitTorrent protocol"; anything else is an MSE DH
        # public key (anacrolix's listener does the same detection)
        head = self._recv_exact(20)
        if head[0] == len(HANDSHAKE_PSTR) and head[1:20] == HANDSHAKE_PSTR:
            if self._listener.encryption == "require":
                return  # policy: obfuscated connections only
            hs = head + self._recv_exact(48)
        else:
            if self._listener.encryption == "off":
                return
            try:
                wrapped, ia = mse.accept(
                    self._sock,
                    self._listener.info_hash,
                    prefix=head,
                    allow_plaintext=self._listener.encryption != "require",
                )
            except mse.MSEError:
                return  # not MSE either (or wrong torrent): reap
            self._sock = wrapped
            self._prefix = bytearray(ia)
            hs = self._recv_exact(68)
        if hs[1:20] != HANDSHAKE_PSTR or hs[28:48] != self._listener.info_hash:
            return
        self.remote_peer_id = hs[48:68]
        remote_supports_ext = bool(hs[25] & 0x10)
        self.remote_supports_fast = bool(hs[27] & 0x04)  # BEP 6
        reserved = bytearray(8)
        reserved[5] |= 0x10  # BEP 10
        reserved[7] |= 0x04  # BEP 6
        with self._send_lock:
            # analysis: ignore[no-blocking-under-lock] _send_lock is this connection's dedicated write lock; serializing the blocking send is its entire job
            self._sock.sendall(
                bytes([len(HANDSHAKE_PSTR)])
                + HANDSHAKE_PSTR
                + bytes(reserved)
                + self._listener.info_hash
                + self._listener.peer_id
            )
        store, info_bytes = self._listener.snapshot()
        sent_have: list[bool] = []
        if store is not None:
            # availability goes out post-attach, even when empty: an
            # absent bitfield reads as "seeder" to permissive clients
            # (including our own claim heuristic). BEP 6 remotes get
            # the compact HAVE_ALL/HAVE_NONE forms.
            sent_have = list(store.have)
            if self.remote_supports_fast and all(sent_have):
                self._send(MSG_HAVE_ALL)
            elif self.remote_supports_fast and not any(sent_have):
                self._send(MSG_HAVE_NONE)
            else:
                self._send(MSG_BITFIELD, pack_bitfield(sent_have))
            self._grant_allowed_fast(store.num_pieces, enqueue=False)
        elif self.remote_supports_fast:
            # pre-attach (metadata/resume still running): BEP 6 demands
            # an availability message first; HAVE_NONE is the truthful
            # one, and the attach catch-up upgrades it with HAVEs
            self._send(MSG_HAVE_NONE)
        if remote_supports_ext:
            # only to peers that advertised BEP 10 — a vanilla client
            # would drop us over an unknown message id
            ext = {b"m": {b"ut_metadata": UT_METADATA, b"ut_pex": UT_PEX}}
            if info_bytes is not None:
                ext[b"metadata_size"] = len(info_bytes)
            self._send(MSG_EXTENDED, bytes([0]) + bencode.encode(ext))
        # open the async channel, then catch up on anything that
        # completed (or an attach that landed) while the handshake was
        # in flight — those broadcasts were suppressed by _ready
        self._ready.set()
        store, _ = self._listener.snapshot()
        if store is not None:
            for index, done in enumerate(store.have):
                if done and (index >= len(sent_have) or not sent_have[index]):
                    self.notify_have(index)
            # an attach that landed mid-handshake could not grant yet
            # (arm() skips pre-ready connections); idempotent
            self._grant_allowed_fast(store.num_pieces, enqueue=True)

        while True:
            length = struct.unpack(">I", self._recv_exact(4))[0]
            if length == 0:
                continue  # keepalive
            if length > (1 << 20) + 9:
                raise PeerProtocolError(f"oversized frame: {length}")
            body = self._recv_exact(length)
            msg_id, payload = body[0], body[1:]
            if msg_id == MSG_INTERESTED:
                self.interested = True
                self.ever_interested = True
                self._maybe_unchoke()
            elif msg_id == MSG_NOT_INTERESTED:
                self.interested = False
                # a finished leecher frees its slot; let a waiting one in
                self._listener.poke_choker()
            elif msg_id == MSG_REQUEST and len(payload) == 12:
                self._serve_request(payload)
            elif msg_id == MSG_EXTENDED and payload:
                self._serve_extended(payload)
            # HAVE/BITFIELD from the remote and CANCEL need no action:
            # leeching happens on outbound connections only, and serving
            # is synchronous so a CANCEL always arrives too late.

    def _serve_request(self, payload: bytes) -> None:
        index, begin, length = struct.unpack(">III", payload)
        if length > MAX_REQUEST_LENGTH:
            raise PeerProtocolError(f"oversized block request: {length}")
        block = None
        # spec: requests while choked are dropped — EXCEPT the BEP 6
        # allowed-fast grants, which exist to be served while choked
        if self._unchoked or index in self._fast_grants:
            store, _ = self._listener.snapshot()
            block = store.read_block(index, begin, length) if store else None
        if block is None:
            # BEP 6 remotes get an explicit REJECT so they re-request
            # elsewhere now; legacy remotes get the silent drop
            if self.remote_supports_fast:
                self._send(MSG_REJECT, payload)
            return
        # count before the send: a reader that saw the PIECE frame must
        # also see it counted (the reverse order races observers)
        self.bytes_to_peer += len(block)
        self._listener.count_block(len(block))
        self._send(MSG_PIECE, struct.pack(">II", index, begin) + block)

    def _serve_extended(self, payload: bytes) -> None:
        ext_id, body = payload[0], payload[1:]
        if ext_id == 0:  # remote's extended handshake: learn their ids
            try:
                info = bencode.decode(body)
            except bencode.BencodeError:
                return
            if isinstance(info, dict) and isinstance(info.get(b"m"), dict):
                # one-byte ids only: bytes([v]) on a crafted id > 255
                # would raise and kill this serving thread
                self._remote_ext = {
                    k: v
                    for k, v in info[b"m"].items()
                    if isinstance(v, int) and 0 < v < 256
                }
            if isinstance(info, dict):
                # BEP 10 "p": the remote's own listening port — the
                # only dialable address an inbound (serve-only)
                # connection yields, and what lets us leech BACK from
                # a peer that discovered us first (LSD/PEX asymmetry)
                p = info.get(b"p")
                if isinstance(p, int) and 0 < p < 65536:
                    self._listener.peer_heard((self.addr[0], p))
            self._maybe_send_pex()
            return
        if ext_id != UT_METADATA:
            return
        _, info_bytes = self._listener.snapshot()
        remote_id = self._remote_ext.get(b"ut_metadata")
        if info_bytes is None or not remote_id:
            return
        try:
            request, _ = bencode._decode(body, 0)
        except bencode.BencodeError:
            return
        if not isinstance(request, dict) or request.get(b"msg_type") != 0:
            return
        piece = request.get(b"piece")
        if not isinstance(piece, int) or piece < 0:
            return
        start = piece * BLOCK_SIZE
        chunk = info_bytes[start : start + BLOCK_SIZE]
        header = bencode.encode(
            {b"msg_type": 1, b"piece": piece, b"total_size": len(info_bytes)}
        )
        self._send(MSG_EXTENDED, bytes([remote_id]) + header + chunk)

    def _maybe_send_pex(self) -> None:
        """One-shot BEP 11 ut_pex after the extended handshakes: share
        the peers this job knows about with a leecher that asked to
        gossip: v4 compact in ``added``, v6 in ``added6`` (BEP 11);
        flags bytes are zeros."""
        remote_id = self._remote_ext.get(b"ut_pex")
        peers = self._listener.known_peers()
        if not remote_id or not peers:
            return
        compact = bytearray()
        compact6 = bytearray()
        for host, port in peers:
            # v4-mapped literals (a v6 tracker's added6, uTP wire
            # forms) are v4 peers: normalize so v4-only receivers
            # still learn them from the added list
            host = display_form((host, port))[0]
            if ":" in host:
                try:
                    compact6 += socket.inet_pton(
                        socket.AF_INET6, host
                    ) + struct.pack(">H", port)
                except (OSError, struct.error):
                    continue
            else:
                try:
                    compact += socket.inet_aton(host) + struct.pack(
                        ">H", port
                    )
                except (OSError, struct.error):
                    continue  # hostname: not compact-able
        if not compact and not compact6:
            return
        message = {
            b"added": bytes(compact),
            b"added.f": bytes(len(compact) // 6),
        }
        if compact6:  # BEP 11: v6 peers gossip in added6
            message[b"added6"] = bytes(compact6)
            message[b"added6.f"] = bytes(len(compact6) // 18)
        self._send(MSG_EXTENDED, bytes([remote_id]) + bencode.encode(message))


class PeerListener:
    """The inbound half of the peer: a live TCP listener on the port the
    trackers are told about.

    The reference's anacrolix client is a full peer — it listens on its
    announced port, serves REQUESTs, and reciprocates while leeching
    (torrent.go:44). This class puts a real socket behind the announce:
    constructed (bound) before the first announce so the advertised port
    is live from the start, ``attach``-ed once metadata and the
    PieceStore exist, closed when the job ends — optionally draining so
    remote leechers mid-transfer can finish (two downloaders completing
    a torrent from each other must not cut the slower one off when the
    faster finishes).
    """

    def __init__(
        self,
        info_hash: bytes,
        peer_id: bytes,
        host: str = "0.0.0.0",
        port: int = 0,
        max_inbound: int = 32,
        max_unchoked: int = 8,
        rechoke_interval: float = 10.0,
        encryption: str = "allow",
    ):
        self.info_hash = info_hash
        self.peer_id = peer_id
        self._max_inbound = max_inbound
        # MSE policy (ENCRYPTION_MODES keys): every policy but "off"
        # auto-detects and accepts obfuscated inbound connections;
        # "require" additionally rejects plaintext ones
        self.encryption = encryption
        # upload-slot choker (see _rechoke): at most this many inbound
        # leechers are unchoked at once
        self._max_unchoked = max_unchoked
        self._rechoke_interval = rechoke_interval
        self._choker_wake = threading.Event()
        self._store: PieceStore | None = None
        self._info_bytes: bytes | None = None
        self._peer_source = None  # ut_pex gossip source (attach)
        self._peer_sink = None  # inbound-learned peers flow here (attach)
        self._pending_heard: list[tuple[str, int]] = []  # pre-attach buffer
        self._lock = threading.Lock()
        self._conns: set[_InboundPeer] = set()
        self._finished_leecher_ids: set[bytes] = set()
        self._closed = False
        self.blocks_served = 0
        self.bytes_served = 0
        # dual-stack TCP when listening on the any-address: v6 peers
        # can dial our announced port too (uTP below already takes
        # both); explicit hosts pin the family, v6-less stacks fall
        # back to plain AF_INET
        self._sock = bind_dual_stack_tcp(host, port)
        self.port = self._sock.getsockname()[1]
        # uTP (BEP 29) rides UDP on the SAME number as the announced
        # TCP port — that is where remotes will try it. Bind failure
        # (port race) degrades to TCP-only, quietly.
        self.utp_mux: "utp.UTPMultiplexer | None" = None
        try:
            self.utp_mux = utp.UTPMultiplexer(
                host=host, port=self.port, on_accept=self._accept_utp
            )
        except OSError:
            pass
        threading.Thread(
            target=self._accept_loop,
            daemon=True,
            name=f"peer-listen-{self.port}",
        ).start()
        threading.Thread(
            target=self._choker_loop,
            daemon=True,
            name=f"peer-choker-{self.port}",
        ).start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return  # listener closed
            try:
                # identity form: mapped-v4 collapses so the allowed-fast
                # derivation, PEX, and logs see the real v4 address
                self._admit(sock, display_form(addr))
            except Exception as exc:
                # one hostile/odd connection must not kill the accept
                # loop — its death would silently stop ALL inbound
                # serving for the rest of the process
                log.warning(f"inbound admit failed: {exc}")
                try:
                    sock.close()
                except OSError:
                    pass

    def _accept_utp(self, stream: "utp.UTPSocket") -> None:
        # uTP streams enter the exact same serving path as TCP ones:
        # _InboundPeer only needs the socket duck-type, so plaintext
        # detection, MSE, the choker, and block serving all just work
        self._admit(stream, stream.addr)

    def _admit(self, sock, addr) -> None:
        with self._lock:
            if self._closed or len(self._conns) >= self._max_inbound:
                try:
                    sock.close()
                except OSError:
                    pass
                return
            conn = _InboundPeer(self, sock, addr)
            self._conns.add(conn)
        threading.Thread(
            target=conn.run,
            daemon=True,
            name=f"peer-inbound-{addr[0]}:{addr[1]}",
        ).start()

    # -- choker ----------------------------------------------------------
    #
    # Upload slots are rationed the way anacrolix's choking algorithm
    # does for the reference (torrent.go:44): at most ``max_unchoked``
    # inbound leechers hold a slot. Regular slots go to the interested
    # peers served the LEAST so far (max-min fairness — a swarm's tail
    # catches up instead of starving), and when oversubscribed one slot
    # is optimistic: rotated randomly each interval so newcomers get
    # bandwidth and a chance to prove themselves, per the canonical
    # BitTorrent choking design.

    def request_unchoke(self, conn: _InboundPeer) -> None:
        """Immediate grant when a slot is free, so small swarms (and the
        common single-leecher case) never wait out a rechoke interval;
        oversubscribed arrivals stay choked until rotation. Decision and
        flag flip are atomic under the lock — two racing INTERESTED
        arrivals must not both take the last slot."""
        with self._lock:
            if self._closed or self._store is None:
                return
            holders = sum(1 for c in self._conns if c._unchoked)
            if holders >= self._max_unchoked:
                return
            conn.grant_unchoke()

    def poke_choker(self) -> None:
        """Wake the choker now (slot freed: NOT_INTERESTED/disconnect)."""
        self._choker_wake.set()

    def _choker_loop(self) -> None:
        while True:
            self._choker_wake.wait(timeout=self._rechoke_interval)
            self._choker_wake.clear()
            with self._lock:
                if self._closed:
                    return
            try:
                self._rechoke()
            except Exception as exc:
                # a rechoke bug must not kill the loop: with no choker,
                # every current slot holder keeps it forever and no new
                # leecher is ever unchoked
                log.warning(f"rechoke failed: {exc}")

    def _rechoke(self) -> None:
        # the whole redistribution runs under the lock so the slot count
        # can never transiently exceed the cap against request_unchoke
        with self._lock:
            if self._store is None:
                return
            conns = list(self._conns)
            if self._max_unchoked <= 0:
                # uploading disabled: the slicing below would invert the
                # cap (ranked[:-1] + choice = everyone wins)
                for conn in conns:
                    if conn._unchoked:
                        conn.revoke_unchoke()
                return
            candidates = [c for c in conns if c.interested]
            if len(candidates) <= self._max_unchoked:
                winners = set(candidates)
            else:
                ranked = sorted(candidates, key=lambda c: c.bytes_to_peer)
                winners = set(ranked[: self._max_unchoked - 1])
                # the optimistic slot: uniform over the rest
                winners.add(random.choice(ranked[self._max_unchoked - 1 :]))
            for conn in conns:
                if conn in winners:
                    conn.grant_unchoke()
                elif conn._unchoked:
                    # lost the slot (or went NOT_INTERESTED while unchoked)
                    conn.revoke_unchoke()

    # -- serving state ---------------------------------------------------

    def snapshot(self) -> tuple["PieceStore | None", bytes | None]:
        with self._lock:
            return self._store, self._info_bytes

    def known_peers(self) -> list[tuple[str, int]]:
        """Peers to gossip via ut_pex; empty until attach provides a
        source (and on any source failure — gossip is best-effort)."""
        source = self._peer_source
        if source is None:
            return []
        try:
            return list(source())[:50]
        except Exception:  # pragma: no cover - defensive
            return []

    def attach(
        self,
        store: PieceStore,
        info_bytes: bytes | None,
        peer_source=None,
        peer_sink=None,
    ) -> None:
        """Arm serving once metadata + store exist. Connections accepted
        during the metadata/resume phase are caught up (HAVE frames +
        deferred UNCHOKE); the store observer keeps every connection
        fed with HAVE as new pieces complete. ``peer_source`` feeds
        outgoing ut_pex gossip; ``peer_sink(peer)`` receives dialable
        addresses learned FROM inbound connections (BEP 10 "p")."""
        store.add_observer(self.notify_have)
        with self._lock:
            self._store = store
            self._info_bytes = info_bytes
            self._peer_source = peer_source
            self._peer_sink = peer_sink
            heard, self._pending_heard = self._pending_heard, []
            conns = list(self._conns)
        if peer_sink is not None:
            for peer in heard:  # replay addresses heard before attach
                try:
                    peer_sink(peer)
                except Exception as exc:  # pragma: no cover - best effort
                    log.debug(f"peer sink rejected replayed {peer}: {exc}")
        have = [i for i, done in enumerate(store.have) if done]
        for conn in conns:
            conn.arm(have)

    def peer_heard(self, peer: tuple[str, int]) -> None:
        """A dialable address learned from an inbound connection's
        extended handshake; best-effort hand-off to the swarm. Heard
        before attach() (metadata/resume still running) it is buffered
        — the handshake is sent once per connection, so dropping it
        would lose that peer's only dialable address."""
        with self._lock:
            sink = self._peer_sink
            if sink is None:
                if len(self._pending_heard) < 64:
                    self._pending_heard.append(peer)
                return
        try:
            sink(peer)
        except Exception as exc:  # pragma: no cover - best effort
            log.debug(f"peer sink rejected heard {peer}: {exc}")

    def notify_have(self, index: int) -> None:
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.notify_have(index)

    def count_block(self, size: int) -> None:
        with self._lock:
            self.blocks_served += 1
            self.bytes_served += size

    def discard(self, conn: _InboundPeer) -> None:
        with self._lock:
            self._conns.discard(conn)
            if conn.ever_interested:
                # a leecher that connected, leeched, and went away has
                # had its chance — the drain in close() keys off this
                # (sticky flag: a compliant client sends NOT_INTERESTED
                # once complete, which must still count as served).
                # Keyed by peer_id, not ip: several leechers can sit
                # behind one NAT/host and must be counted separately.
                self._finished_leecher_ids.add(conn.remote_peer_id)
        # a departing peer may have held an upload slot
        self.poke_choker()

    def active_leechers(self) -> int:
        with self._lock:
            return sum(1 for conn in self._conns if conn.interested)

    # -- lifecycle -------------------------------------------------------

    def close(
        self,
        drain_timeout: float = 0.0,
        expected_leechers: "set[bytes] | frozenset[bytes]" = frozenset(),
    ) -> None:
        """Tear down; with ``drain_timeout`` > 0, keep accepting and
        serving that long until every currently-interested remote AND
        every ``expected_leechers`` peer_id (peers this job observed
        with incomplete bitfields — they will want our pieces) has
        connected, leeched, and disconnected. This is what lets two
        downloaders complete a torrent from each other: the faster one
        must not slam its listener shut before the slower one has
        caught up."""
        if drain_timeout > 0:
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                with self._lock:
                    unserved = set(expected_leechers) - self._finished_leecher_ids
                if not unserved and not self.active_leechers():
                    break
                time.sleep(0.05)
        with self._lock:
            if self._closed and self._sock.fileno() < 0:
                return  # idempotent
            self._closed = True
        self._choker_wake.set()  # let the choker thread observe _closed
        try:
            # shutdown BEFORE close: close() alone only drops the fd
            # and leaves the accept thread blocked in accept() forever
            # (one leaked thread per job); shutdown wakes it with an
            # error and the loop exits
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            # BSD/macOS: shutdown on a LISTENING socket is ENOTCONN —
            # wake the accept with a self-connect to the BOUND address
            # (loopback only substitutes for the wildcard; a listener
            # bound elsewhere isn't reachable at 127.0.0.1) — _admit
            # sees _closed and drops the poke connection
            try:
                bound_host = self._sock.getsockname()[0]
                if bound_host in ("0.0.0.0", ""):
                    bound_host = "127.0.0.1"
                elif bound_host == "::":
                    bound_host = "::1"
                socket.create_connection(
                    (bound_host, self.port), timeout=1.0
                ).close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self.utp_mux is not None:
            self.utp_mux.close()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close()
