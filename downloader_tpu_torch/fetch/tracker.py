"""Tracker announce: HTTP(S) per BEP 3/23 and UDP per BEP 15, plus
compact peer-list decoding (IPv4 and the BEP 7 ``peers6`` form).

The reference gets announce handling wholesale from anacrolix/torrent
(torrent.go:44); this is the JAX package's fetch/tracker.py, with the
same behaviour.
"""

from __future__ import annotations

import ipaddress
import secrets
import socket
import struct
import time
import urllib.parse
import urllib.request

from ..utils import get_logger, tracing
from ..utils.tracing import redact_url
from . import bencode
from .http import TransferError

log = get_logger("fetch.peer")



def announce(
    tracker_url: str,
    info_hash: bytes,
    peer_id: bytes,
    left: int,
    port: int = 6881,
    timeout: float = 15.0,
    event: str = "started",
    uploaded: int = 0,
    downloaded: int = 0,
) -> list[tuple[str, int]]:
    """HTTP announce; returns peer (host, port) pairs. Supports compact
    (BEP 23) and dict-form peer lists. ``event=""`` is a regular
    re-announce — repeating "started" would reset the session on real
    trackers (and some rate-limit it). ``uploaded``/``downloaded`` are
    real session counters (the listener serves blocks now), not the
    zeros a leech-only client reports."""
    params = {
        "info_hash": info_hash,
        "peer_id": peer_id,
        "port": str(port),
        "uploaded": str(uploaded),
        "downloaded": str(downloaded),
        "left": str(left),
        "compact": "1",
    }
    if event:
        params["event"] = event
    query = urllib.parse.urlencode(
        params,
        quote_via=urllib.parse.quote,
        safe="",
    )
    separator = "&" if "?" in tracker_url else "?"
    url = f"{tracker_url}{separator}{query}"
    try:
        with tracing.span(
            "tracker-announce", tracker=redact_url(tracker_url), event=event
        ), urllib.request.urlopen(url, timeout=timeout) as response:
            body = response.read()
    except (urllib.error.URLError, OSError) as exc:
        raise TransferError(f"tracker announce failed: {exc}") from exc

    try:
        reply = bencode.decode(body)
    except bencode.BencodeError as exc:
        raise TransferError(f"tracker returned invalid bencoding: {exc}") from exc
    if not isinstance(reply, dict):
        raise TransferError("tracker reply is not a dict")
    if b"failure reason" in reply:
        reason = reply[b"failure reason"]
        raise TransferError(
            f"tracker failure: {reason.decode('utf-8', 'replace') if isinstance(reason, bytes) else reason}"
        )

    peers = reply.get(b"peers", b"")
    result: list[tuple[str, int]] = []
    if isinstance(peers, bytes):
        result.extend(decode_compact_peers(peers))
    elif isinstance(peers, list):
        for entry in peers:
            if isinstance(entry, dict) and b"ip" in entry and b"port" in entry:
                result.append(
                    (entry[b"ip"].decode("utf-8", "replace"), int(entry[b"port"]))
                )
    peers6 = reply.get(b"peers6", b"")
    if isinstance(peers6, bytes):
        result.extend(decode_compact_peers6(peers6))
    return result


def decode_compact_peers(blob: bytes) -> list[tuple[str, int]]:
    """BEP 23 compact peer list: 6 bytes per peer (IPv4 + big-endian port)."""
    return [
        (
            str(ipaddress.IPv4Address(blob[i : i + 4])),
            struct.unpack(">H", blob[i + 4 : i + 6])[0],
        )
        for i in range(0, len(blob) - 5, 6)
    ]


def decode_compact_peers6(blob: bytes) -> list[tuple[str, int]]:
    """BEP 7 compact IPv6 peer list: 18 bytes per peer (IPv6 + port).
    socket.create_connection takes the literal address as-is, so these
    flow through the normal peer path."""
    return [
        (
            str(ipaddress.IPv6Address(blob[i : i + 16])),
            struct.unpack(">H", blob[i + 16 : i + 18])[0],
        )
        for i in range(0, len(blob) - 17, 18)
    ]


# UDP tracker protocol (BEP 15)

_UDP_PROTOCOL_ID = 0x41727101980  # magic constant from the spec
_UDP_ACTION_CONNECT = 0
_UDP_ACTION_ANNOUNCE = 1
_UDP_ACTION_ERROR = 3


def _udp_roundtrip(
    sock: socket.socket,
    addr: tuple[str, int],
    request: bytes,
    transaction_id: int,
    timeout: float,
    retries: int,
) -> bytes:
    """Send and await the reply with matching transaction id; BEP 15
    prescribes resend-on-timeout (spec: 15*2^n — scaled down here by the
    caller's timeout since a media job shouldn't stall a minute per
    tracker). Each attempt runs against a monotonic deadline, so a
    chatty host spraying non-matching datagrams cannot reset the clock
    and stall the announce past its documented bound."""
    for attempt in range(retries + 1):
        sock.sendto(request, addr)
        deadline = time.monotonic() + timeout * (2**attempt)
        try:
            while True:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise socket.timeout()
                sock.settimeout(remain)
                reply, _ = sock.recvfrom(65536)
                if len(reply) < 8:
                    continue
                action, tid = struct.unpack(">II", reply[:8])
                if tid != transaction_id:
                    continue  # stale datagram from an earlier attempt
                if action == _UDP_ACTION_ERROR:
                    message = reply[8:].decode("utf-8", "replace")
                    raise TransferError(f"tracker error: {message}")
                return reply
        except socket.timeout:
            continue
    raise TransferError(f"tracker timed out after {retries + 1} attempts")


def announce_udp(
    tracker_url: str,
    info_hash: bytes,
    peer_id: bytes,
    left: int,
    port: int = 6881,
    timeout: float = 3.0,
    retries: int = 1,
    event: str = "started",
    uploaded: int = 0,
    downloaded: int = 0,
) -> list[tuple[str, int]]:
    """UDP announce (BEP 15): connect handshake to obtain a connection
    id, then announce; returns peer (host, port) pairs. Defaults bound a
    dead tracker to ~9 s (3+6), not the spec's minute-plus schedule — a
    media job with several dead trackers shouldn't stall the pipeline."""
    parsed = urllib.parse.urlparse(tracker_url)
    if parsed.scheme != "udp" or not parsed.hostname:
        raise TransferError(f"not a udp tracker url: {tracker_url}")
    try:
        tracker_port = parsed.port  # raises ValueError when out of range
    except ValueError as exc:
        raise TransferError(f"udp tracker port invalid: {tracker_url}") from exc
    if tracker_port is None:
        # there is no meaningful default port for UDP trackers; guessing
        # one buys a silent full-timeout stall instead of a clear error
        raise TransferError(f"udp tracker url has no port: {tracker_url}")
    # family-aware dialing: v6-only trackers exist; prefer v4 answers
    # (BEP 15's compact peer format is v4 there, 18-byte over v6)
    try:
        info = socket.getaddrinfo(
            parsed.hostname, tracker_port, type=socket.SOCK_DGRAM
        )
    except OSError as exc:
        raise TransferError(
            f"udp tracker resolve failed: {tracker_url}: {exc}"
        ) from exc
    info.sort(key=lambda entry: entry[0] != socket.AF_INET)
    family = info[0][0]
    addr = info[0][4][:2]

    try:
        sock = socket.socket(family, socket.SOCK_DGRAM)
    except OSError as exc:
        # e.g. an AAAA-only tracker on a v6-less host: one bad tracker
        # must be a recorded TransferError, not an announce-round abort
        raise TransferError(
            f"udp tracker socket failed: {tracker_url}: {exc}"
        ) from exc
    with sock, tracing.span(
        "tracker-announce", tracker=redact_url(tracker_url), event=event
    ):
        try:
            tid = struct.unpack(">I", secrets.token_bytes(4))[0]
            reply = _udp_roundtrip(
                sock,
                addr,
                struct.pack(">QII", _UDP_PROTOCOL_ID, _UDP_ACTION_CONNECT, tid),
                tid,
                timeout,
                retries,
            )
            if len(reply) < 16 or struct.unpack(">I", reply[:4])[0] != 0:
                raise TransferError("malformed connect reply from tracker")
            connection_id = struct.unpack(">Q", reply[8:16])[0]

            tid = struct.unpack(">I", secrets.token_bytes(4))[0]
            request = struct.pack(
                ">QII20s20sQQQIIIiH",
                connection_id,
                _UDP_ACTION_ANNOUNCE,
                tid,
                info_hash,
                peer_id,
                downloaded,
                left,
                uploaded,
                # BEP 15 event codes; 0 = none (regular re-announce)
                {"": 0, "completed": 1, "started": 2, "stopped": 3}[event],
                0,  # IP (default: sender address)
                struct.unpack(">I", secrets.token_bytes(4))[0],  # key
                -1,  # num_want: default
                port,
            )
            reply = _udp_roundtrip(sock, addr, request, tid, timeout, retries)
            if len(reply) < 20 or struct.unpack(">I", reply[:4])[0] != 1:
                raise TransferError("malformed announce reply from tracker")
            if family == socket.AF_INET6:
                # BEP 15 over v6: the announce reply carries 18-byte
                # compact entries
                return decode_compact_peers6(reply[20:])
            return decode_compact_peers(reply[20:])
        except OSError as exc:
            raise TransferError(f"tracker announce failed: {exc}") from exc
