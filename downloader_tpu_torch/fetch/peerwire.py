"""The outbound peer-wire half: constants, BEP 6 helpers, the
``PeerConnection`` state machine (handshake, MSE/uTP transport
fallback, choke/interest, fast extension, ut_metadata, ut_pex), and
``fetch_metadata`` (BEP 9).

The reference gets the peer wire from anacrolix/torrent
(torrent.go:44); this is the JAX package's fetch/peerwire.py, with the
same behaviour.
"""

from __future__ import annotations

import collections
import hashlib
import secrets
import socket
import struct
import time

from ..utils import get_logger, metrics
from ..utils.failpoints import FAILPOINTS
from ..utils.netio import SocketWaiter
from . import bencode, mse, utp
from .http import TransferError
from .tracker import decode_compact_peers, decode_compact_peers6

log = get_logger("fetch.peer")


BLOCK_SIZE = 16 * 1024
HANDSHAKE_PSTR = b"BitTorrent protocol"

MSG_CHOKE = 0
MSG_UNCHOKE = 1
MSG_INTERESTED = 2
MSG_NOT_INTERESTED = 3
MSG_HAVE = 4
MSG_BITFIELD = 5
MSG_REQUEST = 6
MSG_PIECE = 7
MSG_CANCEL = 8
# BEP 6 fast extension (reserved[7] & 0x04); anacrolix speaks it too
MSG_HAVE_ALL = 14
MSG_HAVE_NONE = 15
MSG_REJECT = 16
MSG_ALLOWED_FAST = 17
MSG_EXTENDED = 20

# BEP 6 allowed-fast set size; also the cap on how many ALLOWED_FAST
# grants we accept from a remote (a hostile flood must not grow state)
ALLOWED_FAST_K = 10


def allowed_fast_set(
    ip: str, info_hash: bytes, num_pieces: int, k: int = ALLOWED_FAST_K
) -> set[int]:
    """BEP 6 canonical allowed-fast generation: pieces a choked peer at
    ``ip`` may download anyway, derived from SHA-1 over the /24-masked
    address + info-hash so both ends can compute the same set."""
    if num_pieces <= 0:
        return set()
    try:
        packed = socket.inet_aton(ip)
    except OSError:
        return set()  # v6/hostname: the spec defines the v4 derivation
    x = bytes(a & b for a, b in zip(packed, b"\xff\xff\xff\x00")) + info_hash
    allowed: set[int] = set()
    k = min(k, num_pieces)
    while len(allowed) < k:
        x = hashlib.sha1(x).digest()
        for offset in range(0, 20, 4):
            if len(allowed) >= k:
                break
            index = int.from_bytes(x[offset : offset + 4], "big") % num_pieces
            allowed.add(index)
    return allowed

# largest block an inbound REQUEST may ask for; the de-facto norm is
# 16 KiB but mainstream clients tolerate up to 128 KiB before dropping
# the requester as hostile
MAX_REQUEST_LENGTH = 128 * 1024

UT_METADATA = 1  # our local extended-message id for ut_metadata
UT_PEX = 2  # our local extended-message id for ut_pex (BEP 11)


def _is_private(info) -> bool:
    """BEP 27: the info dict's private flag (trackers-only swarm)."""
    return isinstance(info, dict) and info.get(b"private") == 1

# MSE policy → outbound connection attempts, in order. The reference's
# anacrolix client accepts and initiates obfuscated connections by
# default (Config.HeaderObfuscationPolicy); inbound, every policy but
# "off" auto-detects plaintext vs MSE from the first bytes.
ENCRYPTION_MODES: dict[str, tuple[str, ...]] = {
    "off": ("plain",),  # plaintext only, encrypted inbound rejected
    "allow": ("plain", "mse"),  # default: plaintext first, MSE fallback
    "prefer": ("mse", "plain"),  # MSE first, plaintext fallback
    "require": ("mse",),  # MSE only, plaintext inbound rejected
}

# transport policy → outbound attempt order. The reference's anacrolix
# client dials TCP and uTP (BEP 29) both; here TCP is tried first (fast
# refusal on datacenter networks) with uTP as the fallback that reaches
# NAT'd peers inbound-TCP can't. The listener accepts both always.
TRANSPORT_MODES: dict[str, tuple[str, ...]] = {
    "tcp": ("tcp",),
    "utp": ("utp",),
    "both": ("tcp", "utp"),
}
UTP_CONNECT_TIMEOUT = 5.0  # a dead UDP port gives no refusal signal
# dead-silent-peer reap horizon for idle poll loops: 2x BEP 3's upper
# keepalive cadence ("generally sent once every two minutes") plus
# grace, so one jittered keepalive never gets a healthy choked peer
# reaped — the same dead-vs-quiet margin the AMQP heartbeat uses
IDLE_REAP_TIMEOUT = 250.0


def generate_peer_id() -> bytes:
    # Azureus-style prefix; "dT" = downloader_tpu (the peer id is
    # shared with the JAX package: both speak as the same client)
    return b"-DT0100-" + secrets.token_bytes(12)


def _frame(msg_id: int, payload: bytes = b"") -> bytes:
    """One length-prefixed peer-wire frame (shared by both halves)."""
    return struct.pack(">IB", 1 + len(payload), msg_id) + payload


def _recv_into(sock: socket.socket, count: int) -> bytes | None:  # deadline: callers set settimeout on the socket first (PeerConnection dial timeout, inbound listener 120s, seeder 20s)
    """Read exactly ``count`` bytes; None on EOF (callers raise their
    side's idiomatic exception — TransferError outbound, OSError inbound)."""
    data = bytearray()
    while len(data) < count:
        if FAILPOINTS.fire("peer.recv"):
            raise ConnectionResetError("failpoint: peer.recv reset")
        chunk = sock.recv(count - len(data))
        if not chunk:
            return None
        data += chunk
    return bytes(data)


def pack_bitfield(flags) -> bytes:
    """BEP 3 BITFIELD payload from an iterable of have-booleans
    (MSB-first within each byte)."""
    flags = list(flags)
    field = bytearray((len(flags) + 7) // 8)
    for i, done in enumerate(flags):
        if done:
            field[i // 8] |= 0x80 >> (i % 8)
    return bytes(field)




class PeerProtocolError(TransferError):
    pass


class PeerIdentityError(PeerProtocolError):
    """The transport worked and the remote answered a valid BT
    handshake that proves no retry can help: it IS us, or it serves a
    different torrent. Distinct from plain PeerProtocolError because an
    EOF mid-handshake IS retryable — an MSE-only peer closes plaintext
    handshakes cleanly, and that close must fall through to the MSE
    attempt, not abort the whole attempt matrix."""


class PeerConnection:
    """One wire connection to a peer: handshake + message framing."""

    def __init__(
        self,
        host: str,
        port: int,
        info_hash: bytes,
        peer_id: bytes,
        token: CancelToken,
        timeout: float = 20.0,
        encryption: str = "allow",
        transport: str = "tcp",
        utp_mux: "utp.UTPMultiplexer | None" = None,
        listen_port: int | None = None,
    ):
        self.host, self.port = host, port
        self.info_hash = info_hash
        # our OWN listener port, advertised via BEP 10 "p" so the
        # remote can dial us back
        self.listen_port = listen_port
        self.choked = True
        self.bitfield = b""
        self.remote_have_all = False  # BEP 6 HAVE_ALL received
        self.allowed_fast: set[int] = set()  # BEP 6 grants received
        self.remote_extensions: dict[bytes, int] = {}
        self.metadata_size = 0
        # BEP 11 gossip: peers this peer told us about; the swarm
        # worker drains these into the shared peer queue
        self.pex_peers: list[tuple[str, int]] = []
        self._pex_received = 0  # lifetime count, enforces _PEX_PER_CONN
        # reciprocation state: with a store attached (attach_store),
        # the remote's INTERESTED/REQUEST frames are served inline from
        # read_message — a real peer serves on connections it initiated
        # too (anacrolix does; NAT'd remotes may have no other way in)
        self._serve_store: "PieceStore | None" = None
        self._remote_interested = False
        self._remote_unchoked = False
        # deque: appends come from other workers (GIL-atomic), popleft
        # from the owner; O(1) both ways even for a 10k-piece catch-up
        self._pending_haves: "collections.deque[int]" = collections.deque()
        self.blocks_served = 0
        self.bytes_served = 0
        self._timeout = timeout
        self._last_send = time.monotonic()
        self._last_recv = time.monotonic()
        self._poll_waiter: SocketWaiter | None = None
        self._sock: "socket.socket | mse.EncryptedSocket | None" = None
        self._remove_cancel_hook = token.add_callback(self.close)
        modes = ENCRYPTION_MODES.get(encryption)
        if modes is None:
            self._remove_cancel_hook()
            raise ValueError(f"unknown encryption policy {encryption!r}")
        transports = TRANSPORT_MODES.get(transport)
        if transports is None:
            self._remove_cancel_hook()
            raise ValueError(f"unknown transport policy {transport!r}")
        if utp_mux is None:
            transports = tuple(t for t in transports if t != "utp")
            if not transports:
                self._remove_cancel_hook()
                raise ValueError("uTP transport requires a utp_mux")
        try:
            self._dial(
                peer_id, token, timeout, encryption, transports, modes, utp_mux
            )
        except Exception:
            self.close()
            raise

    def _dial(
        self, peer_id, token, timeout, encryption, transports, modes, utp_mux
    ) -> None:
        """Attempt matrix: transports outer, crypto modes inner. A
        CONNECT failure skips the transport's remaining crypto modes (a
        socket that never established cannot depend on the crypto), so
        a dead peer costs one dial per transport, not per (transport,
        mode) pair; a HANDSHAKE failure retries the next crypto mode
        over a fresh dial of the same transport."""
        last_exc: Exception | None = None
        for trans in transports:
            for mode in modes:
                try:
                    if trans == "utp":
                        self._sock = utp_mux.connect(
                            (self.host, self.port),
                            timeout=min(timeout, UTP_CONNECT_TIMEOUT),
                        )
                    else:
                        self._sock = socket.create_connection(
                            (self.host, self.port), timeout=timeout
                        )
                except OSError as exc:
                    token.raise_if_cancelled()
                    last_exc = exc
                    break  # next transport: redialing can't succeed now
                try:
                    self._sock.settimeout(timeout)
                    if mode == "mse":
                        # under "require" the offer must not include
                        # plaintext, or a plaintext-preferring receiver
                        # could legally downgrade the session
                        provide = (
                            mse.CRYPTO_RC4
                            if encryption == "require"
                            else mse.CRYPTO_RC4 | mse.CRYPTO_PLAINTEXT
                        )
                        self._sock = mse.initiate(
                            self._sock, self.info_hash, crypto_provide=provide
                        )
                    self._handshake(peer_id)
                    self._gauge_counted = True
                    metrics.GLOBAL.gauge_add("torrent_active_peers", 1)
                    return
                except PeerIdentityError:
                    # the remote proved its identity wrong for this job
                    # (ourselves / foreign info-hash): no other attempt
                    # can change that — fail now, but still report a
                    # cancel-hook close as the cancellation it is
                    self.close()
                    token.raise_if_cancelled()
                    raise
                except (
                    OSError, mse.MSEError, PeerProtocolError, struct.error
                ) as exc:
                    self.close()
                    self._sock = None
                    token.raise_if_cancelled()
                    last_exc = exc
        assert last_exc is not None
        raise last_exc

    def _handshake(self, peer_id: bytes) -> None:
        reserved = bytearray(8)
        reserved[5] |= 0x10  # BEP 10 extension protocol
        reserved[7] |= 0x04  # BEP 6 fast extension
        self._sock.sendall(
            bytes([len(HANDSHAKE_PSTR)])
            + HANDSHAKE_PSTR
            + bytes(reserved)
            + self.info_hash
            + peer_id
        )
        reply = self._recv_exact(68)
        if reply[1:20] != HANDSHAKE_PSTR:
            raise PeerProtocolError("bad handshake protocol string")
        if reply[28:48] != self.info_hash:
            raise PeerIdentityError("peer served a different info-hash")
        self.remote_peer_id = reply[48:68]
        if self.remote_peer_id == peer_id:
            # trackers echo our own announce back; a connection to our
            # own listener would idle-loop (we have nothing we need)
            raise PeerIdentityError("connected to ourselves")
        self.remote_supports_extended = bool(reply[25] & 0x10)
        self.remote_supports_fast = bool(reply[27] & 0x04)
        if self.remote_supports_fast:
            # BEP 6: exactly one of BITFIELD/HAVE_ALL/HAVE_NONE MUST
            # precede any other message once fast is negotiated. The
            # store isn't attached yet, so HAVE_NONE now + HAVE catch-up
            # later (the lazy-bitfield flow BEP 6 sanctions).
            self.send_message(MSG_HAVE_NONE)
        if self.remote_supports_extended:
            self.send_extended_handshake()

    def send_extended_handshake(self) -> None:
        ext: dict = {b"m": {b"ut_metadata": UT_METADATA, b"ut_pex": UT_PEX}}
        if self.listen_port:
            # BEP 10 "p": our listening port. This is how a peer we
            # DIALED learns a dialable address for us — inbound
            # connections are serve-only, so without it a peer that
            # discovered us asymmetrically (LSD, PEX) could never
            # leech back (anacrolix advertises it the same way)
            ext[b"p"] = self.listen_port
        self.send_message(MSG_EXTENDED, bytes([0]) + bencode.encode(ext))

    def attach_store(self, store: "PieceStore") -> None:
        """Arm reciprocation: the remote's INTERESTED is answered with
        UNCHOKE and its REQUESTs are served from ``store`` as side
        effects of read_message. Everything runs on the single worker
        thread that owns this connection — socket writes stay
        single-writer (no shearing), and a served block adds at most
        one write between our own reads. Pieces we already have go out
        as HAVE frames (a post-handshake BITFIELD is not spec-legal),
        via the pending queue the owner flushes at its loop points."""
        self._serve_store = store
        for index, done in enumerate(store.have):
            if done:
                self._pending_haves.append(index)
        # the remote may have declared interest before the store existed
        if self._remote_interested and not self._remote_unchoked:
            self._remote_unchoked = True
            self.send_message(MSG_UNCHOKE)

    def queue_have(self, index: int) -> None:
        """Record a newly-acquired piece for the remote. Called by
        WHICHEVER worker completed the piece — only queues (deque
        append, GIL-atomic); the owning worker sends on its next
        flush_haves so the socket keeps a single writer."""
        self._pending_haves.append(index)

    def flush_haves(self) -> None:
        """Owner-thread only: send queued HAVE announcements, batched
        into ONE sendall (a mostly-resumed 10k-piece torrent queues
        thousands of 9-byte frames at attach; one syscall each would
        flood the socket path)."""
        if not self._pending_haves:
            return
        frames = bytearray()
        while True:
            try:
                index = self._pending_haves.popleft()
            except IndexError:
                break
            frames += _frame(MSG_HAVE, struct.pack(">I", index))
        if frames:
            self._sock.sendall(frames)

    def _serve_remote_request(self, payload: bytes) -> None:
        if len(payload) != 12:
            return
        index, begin, length = struct.unpack(">III", payload)
        block = None
        if (
            self._serve_store is not None
            and self._remote_unchoked
            and length <= MAX_REQUEST_LENGTH
        ):
            block = self._serve_store.read_block(index, begin, length)
        if block is None:
            # BEP 6 remotes get an explicit REJECT (echoed request) so
            # they re-request elsewhere now; legacy remotes get the
            # historical silent drop
            if self.remote_supports_fast:
                self.send_message(MSG_REJECT, payload)
            return
        self.blocks_served += 1
        self.bytes_served += len(block)
        self.send_message(MSG_PIECE, struct.pack(">II", index, begin) + block)

    # -- framing ---------------------------------------------------------

    def _recv_exact(self, count: int) -> bytes:
        data = _recv_into(self._sock, count)
        if data is None:
            raise PeerProtocolError("peer closed connection")
        return data

    def send_message(self, msg_id: int, payload: bytes = b"") -> None:
        self._last_send = time.monotonic()
        if FAILPOINTS.fire("peer.send"):
            raise BrokenPipeError("failpoint: peer.send broken")
        self._sock.sendall(_frame(msg_id, payload))

    def read_message(self) -> tuple[int, bytes]:
        """Return (msg_id, payload); keepalives are skipped. Updates choke /
        bitfield / extension state as a side effect."""
        while True:
            length = struct.unpack(">I", self._recv_exact(4))[0]
            # any complete frame header — keepalives included — proves
            # the peer alive; poll_messages' idle reaper keys off this
            self._last_recv = time.monotonic()
            if length == 0:
                continue  # keepalive
            if length > (1 << 20) + 9:
                raise PeerProtocolError(f"oversized frame: {length}")
            body = self._recv_exact(length)
            msg_id, payload = body[0], body[1:]
            if msg_id == MSG_CHOKE:
                self.choked = True
            elif msg_id == MSG_UNCHOKE:
                self.choked = False
            elif msg_id == MSG_BITFIELD:
                self.bitfield = payload
            elif msg_id == MSG_HAVE and len(payload) >= 4:
                self._mark_have(struct.unpack(">I", payload[:4])[0])
            elif msg_id == MSG_HAVE_ALL:
                # BEP 6: empty bitfield already means "assume seeder"
                # to the claim heuristic; the flag keeps has_piece
                # truthful too
                self.bitfield = b""
                self.remote_have_all = True
            elif msg_id == MSG_HAVE_NONE:
                # one all-zero byte: non-empty => "has nothing (yet)";
                # later HAVE frames grow it via _mark_have
                self.bitfield = b"\x00"
                self.remote_have_all = False
            elif msg_id == MSG_ALLOWED_FAST and len(payload) >= 4:
                # BEP 6: pieces we may request even while choked. Cap
                # so a hostile grant-flood can't grow state; trusting
                # the grants (vs recomputing the canonical set) is
                # safe — a peer over-granting only helps us
                if len(self.allowed_fast) < 4 * ALLOWED_FAST_K:
                    self.allowed_fast.add(
                        struct.unpack(">I", payload[:4])[0]
                    )
            elif msg_id == MSG_INTERESTED:
                self._remote_interested = True
                if self._serve_store is not None and not self._remote_unchoked:
                    self._remote_unchoked = True
                    self.send_message(MSG_UNCHOKE)
            elif msg_id == MSG_NOT_INTERESTED:
                self._remote_interested = False
            elif msg_id == MSG_REQUEST:
                self._serve_remote_request(payload)
            elif msg_id == MSG_EXTENDED and payload and payload[0] == 0:
                self._parse_extended_handshake(payload[1:])
            elif msg_id == MSG_EXTENDED and payload and payload[0] == UT_PEX:
                self._parse_pex(payload[1:])
            return msg_id, payload

    # gossip bounds: BEP 11 suggests <=50 peers per message, and one
    # connection has no business naming hundreds of peers over a job's
    # lifetime — beyond that it's an address-flood, not a swarm
    _PEX_PER_MESSAGE = 50
    _PEX_PER_CONN = 200

    def _parse_pex(self, body: bytes) -> None:
        """BEP 11 ut_pex: fold the peer's 'added' lists into
        ``pex_peers`` for the swarm to drain — tracker-thin swarms grow
        through gossip this way (anacrolix speaks PEX too). Bounded per
        message and per connection so a hostile peer cannot flood the
        job with bogus addresses."""
        try:
            info = bencode.decode(body)
        except bencode.BencodeError:
            return
        if not isinstance(info, dict):
            return
        fresh: list[tuple[str, int]] = []
        added = info.get(b"added")
        if isinstance(added, bytes):
            fresh.extend(decode_compact_peers(added))
        added6 = info.get(b"added6")
        if isinstance(added6, bytes):
            fresh.extend(decode_compact_peers6(added6))
        # cumulative per-conn budget: pex_peers is drained (emptied) by
        # the worker, so its length cannot carry the cap
        room = self._PEX_PER_CONN - self._pex_received
        take = fresh[: min(self._PEX_PER_MESSAGE, max(0, room))]
        self._pex_received += len(take)
        self.pex_peers.extend(take)

    def _mark_have(self, index: int) -> None:
        """Fold a HAVE announcement into the peer's bitfield, so piece
        selection sees leechers gain pieces live (anacrolix tracks HAVE
        the same way; without this, a peer's availability is frozen at
        its initial bitfield and leecher-to-leecher swarms starve)."""
        byte_index, bit = divmod(index, 8)
        if byte_index >= 4 * 1024 * 1024:  # 32M pieces: hostile nonsense
            raise PeerProtocolError(f"HAVE index out of range: {index}")
        field = bytearray(self.bitfield)
        if byte_index >= len(field):
            field.extend(bytes(byte_index + 1 - len(field)))
        field[byte_index] |= 0x80 >> bit
        self.bitfield = bytes(field)

    def _parse_extended_handshake(self, payload: bytes) -> None:
        try:
            info = bencode.decode(payload)
        except bencode.BencodeError:
            return
        if isinstance(info, dict):
            mapping = info.get(b"m", {})
            if isinstance(mapping, dict):
                # ids outside one byte can't go on the wire: bytes([v])
                # would raise and kill the worker on a crafted handshake
                self.remote_extensions = {
                    k: v
                    for k, v in mapping.items()
                    if isinstance(v, int) and 0 < v < 256
                }
            size = info.get(b"metadata_size", 0)
            if isinstance(size, int):
                self.metadata_size = size

    def has_piece(self, index: int) -> bool:
        if self.remote_have_all:
            return True  # BEP 6 HAVE_ALL
        byte_index, bit = divmod(index, 8)
        if byte_index >= len(self.bitfield):
            return False
        return bool(self.bitfield[byte_index] & (0x80 >> bit))

    def poll_messages(self, duration: float) -> None:
        """Drain incoming messages for up to ``duration`` seconds,
        updating choke/bitfield state. Used while holding a connection
        idle (swarm WAIT) so a remote CHOKE is processed now instead of
        surfacing as a stale frame mid-piece later. Readability is
        checked first so an idle wait never consumes a partial frame.

        Reaps dead-silent peers: the worker's choked/WAIT states call
        this in a loop that (unlike a blocking read_message, which hits
        the socket timeout) would otherwise never time out, so a peer
        that handshakes and then says nothing forever would pin a
        worker thread. A peer silent past the connection timeout is
        raised out as a protocol error. The horizon is NOT the socket
        timeout: a healthy choked peer with nothing to say legitimately
        sends only keepalives, every ~60-120 s per BEP 3 (our own
        cadence is 60 s, and our inbound loop reads under a 120 s
        socket timeout) — so reap only past 2x the 120 s upper
        cadence, the same dead-vs-quiet margin the AMQP heartbeat
        uses."""
        reap_after = max(self._timeout, IDLE_REAP_TIMEOUT)
        if time.monotonic() - self._last_recv > reap_after:
            raise PeerProtocolError(
                f"peer silent for over {reap_after:.0f}s while idle"
            )
        deadline = time.monotonic() + duration
        # SocketWaiter, not bare select.select: select raises ValueError
        # for fds >= FD_SETSIZE (possible in the long-lived daemon) and
        # for the socket being closed mid-wait by the cancel hook; the
        # waiter turns both into OSError, which the worker's error
        # handling treats as an ordinary peer failure/cancel. Created
        # once per connection — the swarm WAIT state polls every 50 ms
        # and must not pay epoll setup/teardown per poll.
        if self._poll_waiter is None:
            self._poll_waiter = SocketWaiter(self._sock, write=False, what="read")
        while True:
            # a long WAIT state is pure silence from our side; peers
            # following the spec reap connections idle ~2 min, so send
            # the 4-byte keepalive frame once a minute (BEP 3)
            if time.monotonic() - self._last_send > 60.0:
                self._last_send = time.monotonic()
                self._sock.sendall(struct.pack(">I", 0))
            remain = deadline - time.monotonic()
            if remain <= 0:
                return
            # an encrypted transport may hold already-decrypted surplus
            # from the MSE handshake; the fd won't signal for those
            pending = getattr(self._sock, "pending", None)
            if pending is None or not pending():
                try:
                    self._poll_waiter.wait(remain)
                except TimeoutError:
                    return
            # a frame has started arriving; read_message blocks under
            # the normal socket timeout until it completes, keeping
            # framing
            self.read_message()

    def close(self) -> None:
        # gauge decrement exactly once: close is called from the cancel
        # hook AND __exit__, possibly concurrently, so the test-and-
        # clear must be one atomic operation — dict.pop is a single C
        # call under the GIL, where a read-then-assign pair is not
        if self.__dict__.pop("_gauge_counted", None):
            metrics.GLOBAL.gauge_add("torrent_active_peers", -1)
        waiter, self._poll_waiter = self._poll_waiter, None
        if waiter is not None:
            waiter.close()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._remove_cancel_hook()
        self.close()


# ---------------------------------------------------------------------------
# metadata exchange (BEP 9)


def fetch_metadata(conn: PeerConnection, info_hash: bytes, deadline: float) -> dict:
    """Download the info dict from a peer via ut_metadata and verify its
    SHA-1 equals the info-hash (the reference's GotInfo phase)."""
    if not conn.remote_supports_extended:
        # no BEP 10 bit in its handshake: this peer can never provide
        # metadata — fail in microseconds, not a read-timeout stall
        raise PeerProtocolError("peer does not support extensions (BEP 10)")
    while not conn.remote_extensions and time.monotonic() < deadline:
        conn.read_message()
    remote_id = conn.remote_extensions.get(b"ut_metadata")
    if not remote_id or conn.metadata_size <= 0:
        raise PeerProtocolError("peer does not offer ut_metadata")

    piece_count = (conn.metadata_size + BLOCK_SIZE - 1) // BLOCK_SIZE
    blob = bytearray()
    for piece in range(piece_count):
        request = bencode.encode({b"msg_type": 0, b"piece": piece})
        conn.send_message(MSG_EXTENDED, bytes([remote_id]) + request)
        while True:
            if time.monotonic() > deadline:
                raise TransferError("metadata exchange timed out")
            msg_id, payload = conn.read_message()
            if msg_id != MSG_EXTENDED or not payload or payload[0] != UT_METADATA:
                continue
            header, offset = bencode._decode(payload[1:], 0)
            if not isinstance(header, dict) or header.get(b"msg_type") != 1:
                if isinstance(header, dict) and header.get(b"msg_type") == 2:
                    raise PeerProtocolError("peer rejected metadata request")
                continue
            if header.get(b"piece") != piece:
                continue
            blob += payload[1 + offset :]
            break

    if hashlib.sha1(blob).digest() != info_hash:
        raise PeerProtocolError("metadata failed info-hash verification")
    info = bencode.decode(bytes(blob))
    if not isinstance(info, dict):
        raise PeerProtocolError("metadata is not a dict")
    return info
