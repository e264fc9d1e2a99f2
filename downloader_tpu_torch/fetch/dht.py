"""Mainline DHT (BEP 5): trackerless peer discovery, both halves.

The reference's anacrolix/torrent ships a full DHT node (server +
routing table). Here ``DHTClient`` is the lookup/announce half (an
iterative ``get_peers`` over KRPC/UDP) and ``DHTNode`` is the serving
half (answers ping/find_node/get_peers/announce_peer), each created
fresh per job, mirroring the reference's per-job client design
(torrent.go:43-44).

Lookup algorithm (Kademlia): keep a shortlist of nodes sorted by XOR
distance to the info-hash, query the closest unqueried ones in rounds of
α concurrent queries (all datagrams go out first, replies are collected
until the round deadline), fold in the closer nodes each reply returns,
and stop when a round yields nothing new or enough peers are in hand.
"""

from __future__ import annotations

import hashlib
import hmac
import ipaddress
import json
import os
import secrets
import selectors
import socket
import struct
import threading
import time

from ..utils import get_logger, metrics
from ..utils.cancel import CancelToken
from . import bencode
from .dualstack import bind_dual_stack_udp, display_form, wire_form
from .http import TransferError

log = get_logger("fetch.dht")

# well-known bootstrap routers (overridable; tests inject loopback nodes)
DEFAULT_BOOTSTRAP = (
    ("router.bittorrent.com", 6881),
    ("dht.transmissionbt.com", 6881),
    ("router.utorrent.com", 6881),
)

ALPHA = 3  # concurrent queries per lookup round (Kademlia's α)
K = 8  # shortlist width per round


class DHTError(TransferError):
    pass


def _decode_compact_nodes(blob: bytes) -> list[tuple[bytes, str, int]]:
    """BEP 5 compact node info: 26 bytes per node (id + IPv4 + port)."""
    nodes = []
    for i in range(0, len(blob) - 25, 26):
        node_id = blob[i : i + 20]
        host = str(ipaddress.IPv4Address(blob[i + 20 : i + 24]))
        port = struct.unpack(">H", blob[i + 24 : i + 26])[0]
        nodes.append((node_id, host, port))
    return nodes


def _decode_compact_nodes6(blob: bytes) -> list[tuple[bytes, str, int]]:
    """BEP 32 ``nodes6``: 38 bytes per node (id + IPv6 + port)."""
    nodes = []
    for i in range(0, len(blob) - 37, 38):
        node_id = blob[i : i + 20]
        host = str(ipaddress.IPv6Address(blob[i + 20 : i + 36]))
        port = struct.unpack(">H", blob[i + 36 : i + 38])[0]
        nodes.append((node_id, host, port))
    return nodes


def _decode_compact_values(values) -> list[tuple[str, int]]:
    """BEP 5 ``values``: compact peer addresses — 6-byte IPv4 entries,
    and per BEP 32 also 18-byte IPv6 entries in the same list."""
    peers = []
    if isinstance(values, list):
        for value in values:
            if isinstance(value, bytes) and len(value) == 6:
                host = str(ipaddress.IPv4Address(value[:4]))
                peers.append((host, struct.unpack(">H", value[4:6])[0]))
            elif isinstance(value, bytes) and len(value) == 18:
                host = str(ipaddress.IPv6Address(value[:16]))
                peers.append((host, struct.unpack(">H", value[16:18])[0]))
    return peers


class _SockPool:
    """One UDP socket per address family (bootstrap nodes may be IPv6
    even though BEP 5 compact replies are IPv4-only), non-blocking, with
    a selector spanning both so a round can await replies on either."""

    def __init__(self) -> None:
        self._socks: dict[int, socket.socket] = {}
        self.selector = selectors.DefaultSelector()

    def for_addr(self, addr: tuple[str, int]) -> socket.socket:
        family = socket.AF_INET6 if ":" in addr[0] else socket.AF_INET
        sock = self._socks.get(family)
        if sock is None:
            sock = socket.socket(family, socket.SOCK_DGRAM)
            sock.setblocking(False)
            self._socks[family] = sock
            self.selector.register(sock, selectors.EVENT_READ)
        return sock

    def close(self) -> None:
        self.selector.close()
        for sock in self._socks.values():
            sock.close()

    def __enter__(self) -> "_SockPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DHTClient:
    """One-lookup KRPC client; create per job, like the reference's
    per-job torrent client."""

    def __init__(
        self,
        bootstrap: tuple[tuple[str, int], ...] = DEFAULT_BOOTSTRAP,
        node_id: bytes | None = None,
        query_timeout: float = 2.0,
    ):
        self._bootstrap = bootstrap
        self._node_id = node_id or secrets.token_bytes(20)
        self._query_timeout = query_timeout
        # did the LAST get_peers lookup hear from any node at all?
        # Distinguishes "lookup completed, swarm just empty" (worth
        # retrying) from "nobody answered" (every source dead)
        self.responded = False
        # addresses of nodes that answered the LAST lookup well-formed:
        # fodder for a shared process-lifetime DHTNode's routing table
        # (the daemon feeds these back so later jobs bootstrap from a
        # warm table instead of the BEP 5 routers)
        self.seen_nodes: list[tuple[str, int]] = []

    # -- KRPC ------------------------------------------------------------

    def _query_round(
        self,
        pool: _SockPool,
        addrs: list[tuple[str, int]],
        method: bytes,
        args,
    ) -> dict[tuple[str, int], dict]:
        """Send one KRPC query to every address concurrently and collect
        replies until all have answered or the round times out. Returns
        {addr: reply_args} for the nodes that answered well-formed.
        ``args`` is either one dict for every address, or a callable
        addr -> dict for queries that differ per node (announce_peer's
        per-node write token)."""
        # pending is keyed on (transaction id, resolved source address):
        # matching on the 2-byte tid alone would let any host that
        # guesses a tid answer for another node and inject bogus
        # peers/nodes, so the datagram's recvfrom address must also match
        # the node the query went to. Hostnames (bootstrap routers) are
        # resolved up front so the comparison is IP-vs-IP.
        # keyed by (tid, source IP) — NOT (tid, ip, port): NAT'd nodes
        # legitimately answer from a different source port than the one
        # queried, and dropping those silently loses real nodes. The
        # tid (unique per batch) plus the IP match keeps the
        # stale/spoofed-reply protection; a spoofer must now guess the
        # 16-bit tid AND forge the source address.
        pending: dict[tuple[bytes, str], tuple[str, int]] = {}
        used_tids: set[bytes] = set()
        for addr in addrs:
            try:
                ipaddress.ip_address(addr[0])
                resolved = (addr[0], addr[1])  # already a literal (the
                # common case: every non-bootstrap node comes from compact
                # node info); no resolver call
            except ValueError:
                try:
                    info = socket.getaddrinfo(
                        addr[0], addr[1], type=socket.SOCK_DGRAM
                    )
                except OSError as exc:
                    log.with_fields(node=f"{addr[0]}:{addr[1]}").debug(
                        f"dht resolve failed: {exc}"
                    )
                    continue
                # prefer IPv4 (the pre-resolution code always sent
                # hostname queries over an AF_INET socket): on dual-stack
                # hosts with a black-holed v6 path, an AAAA-first answer
                # would silently lose every bootstrap router
                info.sort(key=lambda entry: entry[0] != socket.AF_INET)
                resolved = info[0][4][:2]
            tid = secrets.token_bytes(2)
            while tid in used_tids:
                tid = secrets.token_bytes(2)
            used_tids.add(tid)
            node_args = args(addr) if callable(args) else args
            payload = bencode.encode(
                {
                    b"t": tid,
                    b"y": b"q",
                    b"q": method,
                    b"a": {b"id": self._node_id, **node_args},
                }
            )
            try:
                # deadline: pool sockets are non-blocking (setblocking(False) in _SockPool); a full buffer raises instead of parking
                pool.for_addr(resolved).sendto(payload, resolved)
            except OSError as exc:
                log.with_fields(node=f"{addr[0]}:{addr[1]}").debug(
                    f"dht send failed: {exc}"
                )
                continue
            pending[(tid, resolved[0])] = addr

        replies: dict[tuple[str, int], dict] = {}
        deadline = time.monotonic() + self._query_timeout
        while pending:
            remain = deadline - time.monotonic()
            if remain <= 0:
                break
            ready = pool.selector.select(remain)
            for key, _ in ready:
                sock = key.fileobj
                while True:
                    try:
                        # deadline: pool sockets are non-blocking; the select(remain) above is the only wait and it is bounded
                        datagram, src = sock.recvfrom(65536)
                    except (BlockingIOError, OSError):
                        break
                    try:
                        reply = bencode.decode(datagram)
                    except bencode.BencodeError:
                        continue  # junk datagram
                    if not isinstance(reply, dict):
                        continue
                    tid = reply.get(b"t")
                    if not isinstance(tid, bytes):
                        # attacker-controlled bencode may decode b"t" to
                        # an unhashable list/dict; treat as junk rather
                        # than letting a TypeError abort the whole job
                        continue
                    addr = pending.pop((tid, src[0]), None)
                    if addr is None:
                        continue  # stale, foreign, or spoofed transaction
                    kind = reply.get(b"y")
                    if kind == b"r" and isinstance(reply.get(b"r"), dict):
                        replies[addr] = reply[b"r"]
                    else:  # KRPC error or malformed: drop the node
                        log.with_fields(node=f"{addr[0]}:{addr[1]}").debug(
                            f"dht error reply: {reply.get(b'e')!r}"
                        )
        return replies

    # -- iterative lookup ------------------------------------------------

    def get_peers(
        self,
        info_hash: bytes,
        token: CancelToken | None = None,
        max_peers: int = 50,
        max_rounds: int = 12,
        announce_port: int | None = None,
    ) -> list[tuple[str, int]]:
        """Iterative get_peers lookup; returns discovered peer addresses
        (possibly empty — the caller decides whether that is fatal).

        With ``announce_port``, the lookup finishes with a BEP 5
        announce_peer to the closest responding nodes (using the write
        token each returned), registering this client's live listener
        in the DHT so other leechers can find it — the reciprocating
        half of what anacrolix's full node does (torrent.go:44). The
        SERVING half (answering queries) is DHTNode below; a job runs
        one of each, fresh per job (torrent.go:43-44)."""
        if len(info_hash) != 20:
            raise DHTError("info-hash must be 20 bytes")
        self.responded = False
        self.seen_nodes = []

        def distance(node_id: bytes) -> int:
            return int.from_bytes(node_id, "big") ^ int.from_bytes(
                info_hash, "big"
            )

        peers: list[tuple[str, int]] = []
        # addr -> (node distance, write token): announce targets
        write_tokens: dict[tuple[str, int], tuple[int, bytes]] = {}
        queried: set[tuple[str, int]] = set()
        # shortlist entries: (distance, node_id, host, port); bootstrap
        # routers get the maximum distance so real nodes displace them
        shortlist: list[tuple[int, bytes, str, int]] = [
            (1 << 161, b"", host, port) for host, port in self._bootstrap
        ]

        with _SockPool() as pool:
            for _ in range(max_rounds):
                if token is not None:
                    token.raise_if_cancelled()
                candidates = [
                    (entry[2], entry[3])
                    for entry in sorted(shortlist)[:K]
                    if (entry[2], entry[3]) not in queried
                ][:ALPHA]
                if not candidates:
                    break  # converged: everything near the target queried
                queried.update(candidates)
                replies = self._query_round(
                    pool,
                    candidates,
                    b"get_peers",
                    # BEP 32: ask dual-stack nodes for both families;
                    # v4-only nodes ignore the key
                    {b"info_hash": info_hash, b"want": [b"n4", b"n6"]},
                )
                if replies:
                    self.responded = True
                    for reply_addr in replies:
                        if (
                            reply_addr not in self.seen_nodes
                            and len(self.seen_nodes) < 64
                        ):
                            self.seen_nodes.append(reply_addr)
                progressed = False
                for reply_addr, reply in replies.items():
                    reply_token = reply.get(b"token")
                    node_id = reply.get(b"id")
                    if (
                        isinstance(reply_token, bytes)
                        and isinstance(node_id, bytes)
                        and len(node_id) == 20
                    ):
                        write_tokens[reply_addr] = (
                            distance(node_id),
                            reply_token,
                        )
                    for peer in _decode_compact_values(reply.get(b"values")):
                        if peer not in peers:
                            peers.append(peer)
                            progressed = True
                    decoded_nodes: list[tuple[bytes, str, int]] = []
                    nodes = reply.get(b"nodes")
                    if isinstance(nodes, bytes):
                        decoded_nodes.extend(_decode_compact_nodes(nodes))
                    nodes6 = reply.get(b"nodes6")
                    if isinstance(nodes6, bytes):  # BEP 32
                        decoded_nodes.extend(_decode_compact_nodes6(nodes6))
                    for node_id, host, port in decoded_nodes:
                        entry = (distance(node_id), node_id, host, port)
                        if (
                            entry not in shortlist
                            and (host, port) not in queried
                        ):
                            shortlist.append(entry)
                            progressed = True
                if len(peers) >= max_peers:
                    break
                if not progressed:
                    break  # round learned nothing new: lookup is done

            if announce_port and write_tokens:
                # BEP 5: announce to the K closest token-bearing nodes;
                # best-effort (an unregistered announce only costs us
                # inbound discoverability, never the download)
                targets = sorted(
                    write_tokens.items(), key=lambda item: item[1][0]
                )[:K]
                acks = self._query_round(
                    pool,
                    [addr for addr, _ in targets],
                    b"announce_peer",
                    lambda addr: {
                        b"info_hash": info_hash,
                        b"port": announce_port,
                        b"implied_port": 0,
                        b"token": write_tokens[addr][1],
                    },
                )
                log.with_fields(
                    announced=len(acks), targets=len(targets)
                ).info("dht announce_peer")
        if peers:
            log.with_fields(peers=len(peers), queried=len(queried)).info(
                "dht lookup found peers"
            )
        return peers


# ---------------------------------------------------------------------------
# serving node


def _compact_nodes(entries) -> bytes:
    """BEP 5 compact node info: 26 bytes per (node_id, ip, port)."""
    blob = bytearray()
    for node_id, host, port in entries:
        try:
            blob += node_id + socket.inet_aton(host) + struct.pack(">H", port)
        except (OSError, struct.error):
            continue  # non-v4 addr: lives in the nodes6 answer instead
    return bytes(blob)


def _compact_nodes6(entries) -> bytes:
    """BEP 32 compact node info: 38 bytes per (node_id, ip, port)."""
    blob = bytearray()
    for node_id, host, port in entries:
        if ":" not in host:
            continue
        try:
            blob += (
                node_id
                + socket.inet_pton(socket.AF_INET6, host)
                + struct.pack(">H", port)
            )
        except (OSError, struct.error):
            continue
    return bytes(blob)


def _compact_peer(host: str, port: int) -> bytes | None:
    """6-byte (v4) or 18-byte (v6, BEP 32) compact peer entry."""
    try:
        if ":" in host:
            return socket.inet_pton(socket.AF_INET6, host) + struct.pack(
                ">H", port
            )
        return socket.inet_aton(host) + struct.pack(">H", port)
    except (OSError, struct.error):
        return None


PEER_TTL = 30 * 60.0  # announce_peer registrations expire after 30 min
TOKEN_ROTATE = 300.0  # BEP 5: tokens stay valid up to ~10 min (2 epochs)


class DHTNode:
    """The serving half of a mainline DHT citizen (BEP 5): answers
    ping / find_node / get_peers / announce_peer over KRPC, so peers
    can discover THIS host through the DHT — the role anacrolix's
    long-running node plays for the reference (torrent.go:44), scoped
    to a job here like everything else.

    Documented simplifications vs a full Kademlia implementation:
    the routing table is a bounded cache of the nodes XOR-closest to
    our id (no K-bucket splitting/replacement lists), queriers are
    admitted tentatively without a verification ping, and it is
    IPv4-only like the compact wire format the client half speaks.
    """

    def __init__(
        self,
        node_id: bytes | None = None,
        host: str = "0.0.0.0",
        port: int = 0,
        bootstrap: tuple[tuple[str, int], ...] = (),
        max_nodes: int = 256,
        max_peers_per_hash: int = 64,
        max_hashes: int = 64,
        state_path: str | None = None,
    ):
        self.node_id = node_id or secrets.token_bytes(20)
        # optional routing-table persistence: saved node addresses are
        # re-pinged on startup (respondents re-enter the table), so a
        # restarted daemon warms up without touching the BEP 5 routers
        self._state_path = state_path
        self._max_nodes = max_nodes
        self._max_peers_per_hash = max_peers_per_hash
        # tokens bind the announcer's IP, not the info-hash, so one
        # token holder could otherwise register unbounded distinct
        # hashes — cap the registry breadth too
        self._max_hashes = max_hashes
        self._lock = threading.Lock()
        # node_id -> (host, port); bounded, XOR-closest to our id win
        self._table: dict[bytes, tuple[str, int]] = {}
        # info_hash -> {(host, port): registered_at}
        self._peers: dict[bytes, dict[tuple[str, int], float]] = {}
        # two-epoch write-token secrets (current, previous)
        self._secrets = [secrets.token_bytes(8), secrets.token_bytes(8)]
        self._rotated = time.monotonic()
        self._closed = False
        # dual-stack when serving on the any-address (BEP 32: answer
        # v6 queriers too); explicit hosts pin the family, v6-less
        # stacks fall back to plain AF_INET
        self.sock = bind_dual_stack_udp(host, port)
        self.sock.settimeout(1.0)  # close() can't interrupt recvfrom
        self.port = self.sock.getsockname()[1]
        threading.Thread(
            target=self._serve, daemon=True, name=f"dht-node-{self.port}"
        ).start()
        candidates = list(bootstrap) + self._load_state()
        if candidates:
            # off the constructor: hostname routers mean synchronous
            # DNS, and __init__ runs on the job's startup path
            threading.Thread(
                target=lambda: [self._send_ping(a) for a in candidates],
                daemon=True,
                name=f"dht-bootstrap-{self.port}",
            ).start()

    # -- shared-node surface ---------------------------------------------

    def routing_nodes(self, limit: int = 64) -> tuple[tuple[str, int], ...]:
        """Snapshot of the routing table's addresses, XOR-closest to our
        id first: bootstrap fodder for job lookups sharing this
        process-lifetime node — a warm table means zero queries to the
        BEP 5 routers (anacrolix keeps its node alive the same way;
        the per-job alternative re-bootstraps every job)."""
        with self._lock:
            ordered = sorted(self._table, key=self._distance)
            return tuple(self._table[nid] for nid in ordered[:limit])

    def add_candidates(self, addrs, limit: int = 16) -> None:
        """Ping addresses a job's lookup heard from; respondents enter
        the table via the normal reply path. This is how the shared
        node's table grows from job traffic (its serving half only
        learns nodes that contact it)."""
        with self._lock:
            known = set(self._table.values())
        # filter BEFORE limiting: in steady state the first responders
        # are exactly the already-known table nodes, and spending the
        # limit on them would starve the genuinely new nodes heard in
        # later lookup rounds — freezing the table's growth
        fresh = [addr for addr in addrs if addr not in known]
        for addr in fresh[:limit]:
            self._send_ping(addr)

    def _load_state(self) -> list[tuple[str, int]]:
        if not self._state_path:
            return []
        try:
            with open(self._state_path, "rb") as handle:
                raw = json.load(handle)
        except (OSError, ValueError):
            return []
        addrs: list[tuple[str, int]] = []
        if isinstance(raw, list):
            for entry in raw[: self._max_nodes]:
                if (
                    isinstance(entry, list)
                    and len(entry) == 2
                    and isinstance(entry[0], str)
                    and isinstance(entry[1], int)
                    and 0 < entry[1] < 65536
                ):
                    addrs.append((entry[0], entry[1]))
        return addrs

    def save_state(self) -> None:
        """Write the table's addresses for the next process; atomic
        replace so a crash mid-write can't truncate the state."""
        if not self._state_path:
            return
        with self._lock:
            addrs = list(self._table.values())
        if not addrs:
            # a run that never warmed up (routers unreachable) must not
            # clobber the last GOOD snapshot with an empty list
            return
        tmp = f"{self._state_path}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as handle:
                json.dump([[host, port] for host, port in addrs], handle)
            os.replace(tmp, self._state_path)
        except OSError as exc:
            log.with_fields(path=self._state_path).debug(
                f"dht state save failed: {exc}"
            )

    # -- token + table ---------------------------------------------------

    def _token_for(self, ip: str, secret: bytes) -> bytes:
        return hashlib.sha1(secret + ip.encode()).digest()[:8]

    def _check_token(self, ip: str, token: bytes) -> bool:
        # constant-time compare: token bytes are attacker-supplied, and
        # == leaks a timing oracle an off-path attacker could use to
        # forge announce_peer registrations without doing get_peers
        ok = False
        for s in self._secrets:
            ok |= hmac.compare_digest(token, self._token_for(ip, s))
        return ok

    def _distance(self, node_id: bytes) -> int:
        return int.from_bytes(node_id, "big") ^ int.from_bytes(
            self.node_id, "big"
        )

    def _learn(self, node_id, addr) -> None:
        """Admit a node (querier or ping respondent) into the table;
        when full, only nodes closer than the current farthest get in."""
        if (
            not isinstance(node_id, bytes)
            or len(node_id) != 20
            or node_id == self.node_id
        ):
            return
        with self._lock:
            if node_id in self._table:
                self._table[node_id] = addr
                return
            if len(self._table) >= self._max_nodes:
                farthest = max(self._table, key=self._distance)
                if self._distance(node_id) >= self._distance(farthest):
                    return
                del self._table[farthest]
            self._table[node_id] = addr

    def _closest(self, target: bytes, k: int = K) -> list:
        t = int.from_bytes(target, "big")
        with self._lock:
            entries = [
                (int.from_bytes(nid, "big") ^ t, nid, host, port)
                for nid, (host, port) in self._table.items()
            ]
        entries.sort()
        return [(nid, host, port) for _, nid, host, port in entries[:k]]

    # -- serving ---------------------------------------------------------

    @staticmethod
    def _display_addr(addr) -> tuple[str, int]:
        """Identity form (dualstack.display_form): tokens, the routing
        table, and peer registrations must see the same address
        whether the packet came in over v4 or the dual-stack socket."""
        return display_form(addr)

    def _wire_addr(self, addr) -> tuple[str, int]:
        """sendto form for THIS socket's family — resolves hostname
        bootstrap targets before mapping (dualstack.wire_form)."""
        return wire_form(self.sock.family, addr)

    def _send_ping(self, addr) -> None:
        addr = self._wire_addr(addr)
        try:
            self.sock.sendto(
                bencode.encode(
                    {
                        b"t": secrets.token_bytes(2),
                        b"y": b"q",
                        b"q": b"ping",
                        b"a": {b"id": self.node_id},
                    }
                ),
                addr,
            )
        except OSError:
            pass  # bootstrap is best-effort

    def _reply(self, addr, tid: bytes, args: dict) -> None:
        try:
            self.sock.sendto(
                bencode.encode(
                    {b"t": tid, b"y": b"r", b"r": {b"id": self.node_id, **args}}
                ),
                self._wire_addr(addr),
            )
        except OSError:
            pass

    def _error(self, addr, tid: bytes, code: int, text: bytes) -> None:
        try:
            self.sock.sendto(
                bencode.encode({b"t": tid, b"y": b"e", b"e": [code, text]}),
                self._wire_addr(addr),
            )
        except OSError:
            pass

    def _serve(self) -> None:
        while not self._closed:
            # every iteration, not just idle ones: a node fed at least
            # one datagram per second would otherwise never rotate and
            # its write tokens would stay valid forever
            self._maybe_rotate()
            try:
                datagram, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return  # closed
            # identity form everywhere below (tokens, table, peers);
            # _reply/_error re-map to the socket's wire form
            addr = self._display_addr(addr)
            try:
                msg = bencode.decode(datagram)
            except bencode.BencodeError:
                continue
            if not isinstance(msg, dict):
                continue
            tid = msg.get(b"t")
            if not isinstance(tid, bytes):
                continue
            kind = msg.get(b"y")
            if kind == b"r":
                # a reply to one of our bootstrap pings: learn the node
                reply = msg.get(b"r")
                if isinstance(reply, dict):
                    self._learn(reply.get(b"id"), addr)
                continue
            if kind != b"q":
                continue
            args = msg.get(b"a")
            if not isinstance(args, dict):
                self._error(addr, tid, 203, b"missing arguments")
                continue
            self._learn(args.get(b"id"), addr)
            method = msg.get(b"q")
            # counted pre-validation, so named "received" not "served":
            # garbage that only draws an error reply must not read as
            # legitimate DHT load
            metrics.GLOBAL.add("dht_queries_received")
            try:
                if method == b"ping":
                    self._reply(addr, tid, {})
                elif method == b"find_node":
                    self._on_find_node(addr, tid, args)
                elif method == b"get_peers":
                    self._on_get_peers(addr, tid, args)
                elif method == b"announce_peer":
                    self._on_announce(addr, tid, args)
                else:
                    self._error(addr, tid, 204, b"method unknown")
            except Exception:  # pragma: no cover - hostile input guard
                self._error(addr, tid, 202, b"server error")

    @staticmethod
    def _wants_v6(addr, args) -> bool:
        """BEP 32: include nodes6 when the querier asked (want n6) or
        is itself a v6 node (its own family is its implied want)."""
        want = args.get(b"want")
        if isinstance(want, list) and b"n6" in want:
            return True
        return ":" in addr[0]

    def _on_find_node(self, addr, tid, args) -> None:
        target = args.get(b"target")
        if not isinstance(target, bytes) or len(target) != 20:
            self._error(addr, tid, 203, b"bad target")
            return
        closest = self._closest(target)
        answer: dict = {b"nodes": _compact_nodes(closest)}
        if self._wants_v6(addr, args):
            answer[b"nodes6"] = _compact_nodes6(closest)
        self._reply(addr, tid, answer)

    def _on_get_peers(self, addr, tid, args) -> None:
        info_hash = args.get(b"info_hash")
        if not isinstance(info_hash, bytes) or len(info_hash) != 20:
            self._error(addr, tid, 203, b"bad info_hash")
            return
        token = self._token_for(addr[0], self._secrets[0])
        now = time.monotonic()
        # loopback registrations (same-host announcers, e.g. this very
        # job's client) are meaningless to a remote querier — scope
        # them to requesters that are themselves loopback
        requester_local = ipaddress.ip_address(addr[0]).is_loopback
        with self._lock:
            registry = self._peers.get(info_hash, {})
            live = [
                peer
                for peer, seen in registry.items()
                if now - seen < PEER_TTL
                and (
                    requester_local
                    or not ipaddress.ip_address(peer[0]).is_loopback
                )
            ]
        if live:
            # BEP 32: 6-byte v4 and 18-byte v6 entries share the list;
            # v6 registrations only go to queriers that can use them
            wants_v6 = self._wants_v6(addr, args)
            # family-filter BEFORE the cap: v6 registrations must not
            # consume a v4-only querier's 50 slots
            usable = [
                peer for peer in live if wants_v6 or ":" not in peer[0]
            ]
            values = []
            for host, port in usable[:50]:
                entry = _compact_peer(host, port)
                if entry is not None:
                    values.append(entry)
            self._reply(addr, tid, {b"token": token, b"values": values})
        else:
            closest = self._closest(info_hash)
            answer = {b"token": token, b"nodes": _compact_nodes(closest)}
            if self._wants_v6(addr, args):
                answer[b"nodes6"] = _compact_nodes6(closest)
            self._reply(addr, tid, answer)

    def _on_announce(self, addr, tid, args) -> None:
        info_hash = args.get(b"info_hash")
        token = args.get(b"token")
        port = args.get(b"port")
        if not isinstance(info_hash, bytes) or len(info_hash) != 20:
            self._error(addr, tid, 203, b"bad info_hash")
            return
        if not isinstance(token, bytes) or not self._check_token(
            addr[0], token
        ):
            # BEP 5: announces must present a token from a recent
            # get_peers, or anyone could register arbitrary victims
            self._error(addr, tid, 203, b"bad token")
            return
        if args.get(b"implied_port"):
            port = addr[1]
        if not isinstance(port, int) or not 0 < port < 65536:
            self._error(addr, tid, 203, b"bad port")
            return
        now = time.monotonic()
        with self._lock:
            # purge expired registrations/registries so memory shrinks
            # (get_peers only filters at read time)
            for known_hash in list(self._peers):
                registry = self._peers[known_hash]
                for peer, seen in list(registry.items()):
                    if now - seen >= PEER_TTL:
                        del registry[peer]
                if not registry:
                    del self._peers[known_hash]
            if (
                info_hash not in self._peers
                and len(self._peers) >= self._max_hashes
            ):
                # evict the registry whose freshest entry is stalest
                victim = min(
                    self._peers, key=lambda h: max(self._peers[h].values())
                )
                del self._peers[victim]
            registry = self._peers.setdefault(info_hash, {})
            registry[(addr[0], port)] = now
            if len(registry) > self._max_peers_per_hash:
                # evict the stalest registration
                oldest = min(registry, key=registry.get)
                del registry[oldest]
        self._reply(addr, tid, {})

    def _maybe_rotate(self) -> None:
        now = time.monotonic()
        if now - self._rotated >= TOKEN_ROTATE:
            self._secrets = [secrets.token_bytes(8), self._secrets[0]]
            self._rotated = now

    def close(self) -> None:
        self.save_state()
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass
