"""Local Service Discovery (BEP 14): find swarm peers on the local
network via UDP multicast, no tracker or DHT required.

Announces ``BT-SEARCH`` messages to the BEP 14 groups — IPv4
(239.192.152.143:6771) and, when the host can join it, IPv6
([ff15::efc0:988f]:6771) — and listens for other hosts' announces; a
matching info-hash from a foreign cookie yields a peer for the swarm.
Per the spec, hearing a matching announce also triggers a (rate-
limited) responsive announce of our own, so two hosts that start
moments apart still find each other without waiting out an interval.

This EXCEEDS the reference: anacrolix/torrent (torrent.go:44) has no
BEP 14 support — it is the libtorrent-family feature that makes
same-LAN peers (e.g. co-located tritonmedia services) find each other
without external infrastructure. Everything here degrades silently —
multicast being unavailable (locked-down bridge, no group join) just
means discovery falls back to trackers/DHT/PEX.
"""

from __future__ import annotations

import secrets
import socket
import struct
import threading
import time

from ..utils import get_logger

log = get_logger("fetch.lsd")

GROUP_V4 = "239.192.152.143"
GROUP_V6 = "ff15::efc0:988f"  # BEP 14's site-local v6 group
MCAST_PORT = 6771
# floor between announces. BEP 14 asks for at most ~1/min steady-state;
# the one deliberate divergence is an immediate responsive announce the
# FIRST time a given peer is heard (floored at this gap, retried from
# the listen loop's tick when the floor blocks it): two hosts starting
# moments apart would otherwise each miss the other's initial announce
# and wait out a full interval. The known-peer cap bounds how often a
# flood of spoofed addresses could trigger this.
RESPONSIVE_FLOOR = 1.0
MAX_KNOWN_REMOTES = 128


def build_announce(
    group: str, mcast_port: int, port: int, info_hash: bytes, cookie: str
) -> bytes:
    return (
        f"BT-SEARCH * HTTP/1.1\r\n"
        f"Host: {group}:{mcast_port}\r\n"
        f"Port: {port}\r\n"
        f"Infohash: {info_hash.hex()}\r\n"
        f"cookie: {cookie}\r\n"
        "\r\n\r\n"
    ).encode("ascii")


def parse_announce(data: bytes) -> tuple[int, list[bytes], str] | None:
    """(port, info_hashes, cookie) from a BT-SEARCH datagram, or None
    when it isn't one. Header names are case-insensitive; multiple
    Infohash headers are allowed (BEP 14 revision)."""
    if not data.startswith(b"BT-SEARCH"):
        return None
    port = 0
    hashes: list[bytes] = []
    cookie = ""
    for line in data.split(b"\r\n")[1:]:
        name, _, value = line.partition(b":")
        name = name.strip().lower()
        value = value.strip()
        if name == b"port":
            try:
                port = int(value)
            except ValueError:
                return None
        elif name == b"infohash":
            try:
                raw = bytes.fromhex(value.decode("ascii"))
            except (ValueError, UnicodeDecodeError):
                continue
            if len(raw) == 20:
                hashes.append(raw)
        elif name == b"cookie":
            cookie = value.decode("ascii", errors="replace")
    if not 0 < port < 65536 or not hashes:
        return None
    return port, hashes, cookie


class LSD:
    """One torrent's LSD presence: announce our listening port, call
    ``on_peer((host, port))`` for every foreign matching announce."""

    def __init__(
        self,
        info_hash: bytes,
        port: int,
        on_peer,
        interval: float = 300.0,
        group: str = GROUP_V4,
        mcast_port: int = MCAST_PORT,
        announce_gap: float = RESPONSIVE_FLOOR,
    ):
        self._info_hash = info_hash
        self._port = port
        self._on_peer = on_peer
        self._interval = interval
        self._mcast_port = mcast_port
        self._announce_gap = announce_gap
        # the cookie filters our own multicast echoes (the group loops
        # our datagrams back to us by design)
        self._cookie = secrets.token_hex(8)
        self._closed = threading.Event()
        self._last_announce = 0.0
        self._known_remotes: set[tuple[str, int]] = set()
        self._pending_responsive = False
        self._lock = threading.Lock()

        # one leg per address family: (rx, tx, host-header, sendto
        # dest). v4 and v6 degrade independently — a host that can
        # join only one group still discovers on that one; the
        # constructor raises only when NEITHER is joinable (callers
        # treat LSD as optional).
        self._legs: list[tuple[socket.socket, socket.socket, str, tuple]] = []
        errors: list[OSError] = []
        try:
            self._legs.append(self._make_v4_leg(group, mcast_port))
        except OSError as exc:
            errors.append(exc)
        if group == GROUP_V4:
            # the v6 leg joins the WELL-KNOWN v6 group; tests that use
            # a custom v4 group stay single-leg and hermetic
            try:
                self._legs.append(self._make_v6_leg(GROUP_V6, mcast_port))
            except OSError as exc:
                errors.append(exc)
        if not self._legs:
            raise errors[0]

        for index, leg in enumerate(self._legs):
            threading.Thread(
                target=self._listen_loop,
                args=(leg[0],),
                daemon=True,
                name=f"lsd-listen-{index}",
            ).start()
        threading.Thread(
            target=self._announce_loop, daemon=True, name="lsd-announce"
        ).start()

    @staticmethod
    def _make_leg(family: int, join, tx_setup, host_header: str, dest):
        """One multicast leg: bound+joined rx (1 s timeout — close()
        cannot interrupt a thread already blocked in recvfrom, so the
        timeout bounds how long the listen thread outlives close() on
        a quiet LAN), LAN-scoped tx. ``join``/``tx_setup`` hold the
        only family-specific parts."""
        rx = socket.socket(family, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            # several jobs (or processes) share the well-known port
            try:
                rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except OSError:
                pass
        try:
            join(rx)
        except OSError:
            rx.close()
            raise
        rx.settimeout(1.0)
        try:
            tx = socket.socket(family, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
            tx_setup(tx)
        except OSError:
            # the bound rx (port + group membership) must not outlive
            # a failed constructor
            rx.close()
            raise
        return rx, tx, host_header, dest

    @classmethod
    def _make_v4_leg(cls, group: str, mcast_port: int):
        def join(rx: socket.socket) -> None:
            rx.bind(("", mcast_port))
            rx.setsockopt(
                socket.IPPROTO_IP,
                socket.IP_ADD_MEMBERSHIP,
                struct.pack("4sl", socket.inet_aton(group), socket.INADDR_ANY),
            )

        def tx_setup(tx: socket.socket) -> None:
            # local scope: BEP 14 discovery must not leak past the LAN
            tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
            tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)

        return cls._make_leg(
            socket.AF_INET, join, tx_setup, group, (group, mcast_port)
        )

    @classmethod
    def _make_v6_leg(cls, group: str, mcast_port: int):
        def join(rx: socket.socket) -> None:
            rx.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 1)
            rx.bind(("", mcast_port))
            rx.setsockopt(
                socket.IPPROTO_IPV6,
                socket.IPV6_JOIN_GROUP,
                socket.inet_pton(socket.AF_INET6, group)
                + struct.pack("@I", 0),  # 0 = default interface
            )

        def tx_setup(tx: socket.socket) -> None:
            tx.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_HOPS, 1)
            tx.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_LOOP, 1)

        # BEP 14: the Host header carries the bracketed v6 group
        return cls._make_leg(
            socket.AF_INET6, join, tx_setup, f"[{group}]", (group, mcast_port)
        )

    # -- announcing ------------------------------------------------------

    def _announce(self) -> None:
        with self._lock:
            self._last_announce = time.monotonic()
        for _, tx, host_header, dest in self._legs:
            try:
                tx.sendto(
                    build_announce(
                        host_header,
                        self._mcast_port,
                        self._port,
                        self._info_hash,
                        self._cookie,
                    ),
                    dest,
                )
            except OSError:
                pass  # transient; the periodic loop retries

    def _announce_loop(self) -> None:
        try:
            self._announce()  # immediate presence
            while not self._closed.wait(timeout=self._interval):
                self._announce()
        except Exception as exc:
            # LSD is a best-effort discovery side channel: a dead
            # announce loop must degrade to "no LAN presence", never
            # take anything else down — but say so, once
            log.warning(f"LSD announce loop stopped: {exc}")

    # -- listening -------------------------------------------------------

    def _flush_pending_responsive(self) -> None:
        with self._lock:
            due = (
                self._pending_responsive
                and time.monotonic() - self._last_announce
                >= self._announce_gap
            )
            if due:
                self._pending_responsive = False
        if due:
            self._announce()

    def _listen_loop(self, rx: socket.socket) -> None:
        while not self._closed.is_set():
            try:
                data, addr = rx.recvfrom(1400)
            except socket.timeout:
                self._flush_pending_responsive()
                continue  # periodic _closed re-check
            except OSError:
                return  # closed
            parsed = parse_announce(data)
            if parsed is None:
                continue
            peer_port, hashes, cookie = parsed
            if cookie == self._cookie:
                continue  # our own echo
            if self._info_hash not in hashes:
                continue
            try:
                self._on_peer((addr[0], peer_port))
            except Exception as exc:  # pragma: no cover - best effort
                log.debug(f"LSD peer callback failed for {addr[0]}: {exc}")
            # responsive announce for NEW peers: the sender may have
            # started after our last announce and not know us. Floored
            # (see RESPONSIVE_FLOOR); when the floor blocks it, the
            # listen tick retries so the reply is delayed, not lost.
            peer_key = (addr[0], peer_port)
            with self._lock:
                is_new = (
                    peer_key not in self._known_remotes
                    and len(self._known_remotes) < MAX_KNOWN_REMOTES
                )
                if is_new:
                    self._known_remotes.add(peer_key)
                    self._pending_responsive = True
            if is_new:
                self._flush_pending_responsive()

    def close(self) -> None:
        self._closed.set()
        for rx, tx, _, _ in self._legs:
            for sock in (rx, tx):
                try:
                    sock.close()
                except OSError:
                    pass
