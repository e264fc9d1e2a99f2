"""In-process BitTorrent seeder + HTTP tracker, for hermetic tests and
benchmarks.

Serves exactly one torrent from memory: the tracker half answers announces
with this seeder as the only peer (compact form), and the peer half speaks
enough of the wire protocol to seed — handshake, bitfield, unchoke on
interest, request→piece, and ut_metadata (BEP 9) so magnet flows can be
tested without .torrent files. The Go reference has no hermetic torrent
fixture at all. ``make_torrent`` hashes every piece through the digest
engine in one call (the CUDA kernel on the card by default).
"""

from __future__ import annotations

import hashlib
import http.server
import socket
import socketserver
import struct
import threading
import urllib.parse

from ..parallel import DigestEngine, default_engine
from . import bencode
from .peer import (
    BLOCK_SIZE,
    HANDSHAKE_PSTR,
    MSG_BITFIELD,
    MSG_EXTENDED,
    MSG_INTERESTED,
    MSG_PIECE,
    MSG_REQUEST,
    MSG_UNCHOKE,
)


def make_torrent(
    name: str,
    data: bytes | dict[str, bytes],
    piece_length: int = 32 * 1024,
    trackers: tuple[str, ...] = (),
    private: bool = False,
    engine: DigestEngine | None = None,
) -> tuple[dict, bytes, bytes]:
    """Build (info_dict, metainfo_bytes, content_blob) for a single- or
    multi-file torrent held in memory. ``engine`` hashes the pieces
    (the process-wide default engine when None)."""
    if isinstance(data, dict):
        blob = b"".join(data.values())
        files = [
            {b"path": [part.encode() for part in path.split("/")], b"length": len(content)}
            for path, content in data.items()
        ]
        info: dict = {
            b"name": name.encode(),
            b"piece length": piece_length,
            b"files": files,
        }
    else:
        blob = data
        info = {
            b"name": name.encode(),
            b"piece length": piece_length,
            b"length": len(blob),
        }
    piece_digests = (engine or default_engine()).sha1_many(
        [
            blob[i : i + piece_length]
            for i in range(0, max(len(blob), 1), piece_length)
        ]
    )
    pieces = b"".join(piece_digests)
    info[b"pieces"] = pieces
    if private:
        info[b"private"] = 1  # BEP 27
    meta: dict = {b"info": info}
    if trackers:
        meta[b"announce"] = trackers[0].encode()
        meta[b"announce-list"] = [[t.encode()] for t in trackers]
    return info, bencode.encode(meta), blob


class SwarmTracker:
    """Standalone HTTP tracker for multi-peer swarms: registers every
    announcing peer (client IP + its announced port) and answers with
    the rest of the swarm, compact form (BEP 23).

    Unlike Seeder's built-in tracker — which always answers with the
    seeder itself — this one knows only what peers announce, so a swarm
    formed through it proves the announced ports are real, live
    listeners (reference parity: anacrolix announces the port its
    client actually serves on, torrent.go:44)."""

    def __init__(self):
        tracker = self
        self.peers: dict[tuple[str, int], bool] = {}
        self.announces: list[dict] = []
        self._lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                query = dict(
                    urllib.parse.parse_qsl(
                        urllib.parse.urlparse(self.path).query,
                        encoding="latin-1",
                    )
                )
                ip = self.client_address[0]
                try:
                    port = int(query.get("port", "0"))
                except ValueError:
                    port = 0
                with tracker._lock:
                    if 0 < port < 65536:
                        tracker.peers[(ip, port)] = True
                    others = [p for p in tracker.peers if p != (ip, port)]
                    tracker.announces.append(dict(query, _src=ip))
                compact = b"".join(
                    socket.inet_aton(host) + struct.pack(">H", peer_port)
                    for host, peer_port in others
                )
                body = bencode.encode({b"interval": 1, b"peers": compact})
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/announce"

    def __enter__(self) -> "SwarmTracker":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()


class Seeder:
    """One-torrent seeder; ``endpoint`` properties expose the tracker URL
    and a magnet URI for the served torrent."""

    def __init__(
        self,
        name: str,
        data: bytes | dict[str, bytes],
        piece_length: int = 32 * 1024,
        corrupt_pieces: tuple[int, ...] = (),
        serve_limit: int | None = None,
        serve_delay: float = 0.0,
        private: bool = False,
    ):
        self.info, self.metainfo, self.blob = make_torrent(
            name, data, piece_length, private=private
        )
        self.info_bytes = bencode.encode(self.info)
        self.info_hash = hashlib.sha1(self.info_bytes).digest()
        self.piece_length = piece_length
        self.served_requests: list[int] = []  # piece indexes peers requested
        # pieces served with flipped bytes: a hostile/broken peer for
        # verification tests (the announced hashes stay the honest ones)
        self.corrupt_pieces = frozenset(corrupt_pieces)
        # die-mid-download fixture: drop the connection after this many
        # block requests, so tests can exercise unwinding paths
        self.serve_limit = serve_limit
        # slow-seeder fixture: sleep this long before each block, so
        # concurrency tests on a single-core box can't be won outright
        # by whichever worker thread the GIL schedules first
        self.serve_delay = serve_delay

        seeder = self

        # -- peer half ---------------------------------------------------

        class PeerHandler(socketserver.BaseRequestHandler):
            def handle(self):
                sock: socket.socket = self.request
                sock.settimeout(20)
                try:
                    seeder._serve_peer(sock)
                except (OSError, struct.error, ValueError):
                    pass

        self._peer_server = socketserver.ThreadingTCPServer(
            ("127.0.0.1", 0), PeerHandler
        )
        self._peer_server.daemon_threads = True

        # -- tracker half ------------------------------------------------

        class TrackerHandler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                query = dict(
                    urllib.parse.parse_qsl(
                        urllib.parse.urlparse(self.path).query,
                        encoding="latin-1",
                    )
                )
                seeder.announces.append(query)
                host, port = seeder.peer_address
                compact = socket.inet_aton(host) + struct.pack(">H", port)
                body = bencode.encode({b"interval": 60, b"peers": compact})
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._tracker_server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), TrackerHandler
        )
        self.announces: list[dict] = []
        self._threads = [
            threading.Thread(target=self._peer_server.serve_forever, daemon=True),
            threading.Thread(target=self._tracker_server.serve_forever, daemon=True),
        ]

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Seeder":
        for thread in self._threads:
            thread.start()
        return self

    def stop(self) -> None:
        self._peer_server.shutdown()
        self._peer_server.server_close()
        self._tracker_server.shutdown()
        self._tracker_server.server_close()

    def __enter__(self) -> "Seeder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def peer_address(self) -> tuple[str, int]:
        return self._peer_server.server_address[:2]

    @property
    def tracker_url(self) -> str:
        host, port = self._tracker_server.server_address[:2]
        return f"http://{host}:{port}/announce"

    @property
    def magnet_uri(self) -> str:
        return (
            f"magnet:?xt=urn:btih:{self.info_hash.hex()}"
            f"&dn={urllib.parse.quote(self.info.get(b'name', b'').decode())}"
            f"&tr={urllib.parse.quote(self.tracker_url, safe='')}"
        )

    # -- peer protocol ---------------------------------------------------

    def _recv_exact(self, sock: socket.socket, count: int) -> bytes:
        from .peer import _recv_into

        data = _recv_into(sock, count)
        if data is None:
            raise OSError("client gone")
        return data

    def _serve_peer(self, sock: socket.socket) -> None:
        hs = self._recv_exact(sock, 68)
        if hs[1:20] != HANDSHAKE_PSTR or hs[28:48] != self.info_hash:
            return
        reserved = bytearray(8)
        reserved[5] |= 0x10
        sock.sendall(
            bytes([len(HANDSHAKE_PSTR)])
            + HANDSHAKE_PSTR
            + bytes(reserved)
            + self.info_hash
            + b"-SEED00-" + b"0" * 12
        )
        from .peer import pack_bitfield

        num_pieces = len(self.info[b"pieces"]) // 20
        self._send(sock, MSG_BITFIELD, pack_bitfield([True] * num_pieces))
        # extended handshake advertising ut_metadata
        ext_hs = bencode.encode(
            {b"m": {b"ut_metadata": 3}, b"metadata_size": len(self.info_bytes)}
        )
        self._send(sock, MSG_EXTENDED, bytes([0]) + ext_hs)

        while True:
            length = struct.unpack(">I", self._recv_exact(sock, 4))[0]
            if length == 0:
                continue
            body = self._recv_exact(sock, length)
            msg_id, payload = body[0], body[1:]
            if msg_id == MSG_INTERESTED:
                self._send(sock, MSG_UNCHOKE)
            elif msg_id == MSG_REQUEST:
                index, begin, want = struct.unpack(">III", payload)
                if self.serve_delay:
                    import time

                    time.sleep(self.serve_delay)
                if (
                    self.serve_limit is not None
                    and len(self.served_requests) >= self.serve_limit
                ):
                    return  # connection drops mid-download
                self.served_requests.append(index)  # list.append: GIL-atomic
                start = index * self.piece_length + begin
                chunk = self.blob[start : start + want]
                if index in self.corrupt_pieces and chunk:
                    # hostile/broken peer: first byte of every block in
                    # the piece flipped, so the SHA-1 verify must fail
                    chunk = bytes([chunk[0] ^ 0xFF]) + chunk[1:]
                self._send(
                    sock, MSG_PIECE, struct.pack(">II", index, begin) + chunk
                )
            elif msg_id == MSG_EXTENDED and payload and payload[0] == 3:
                request = bencode.decode(payload[1:])
                if isinstance(request, dict) and request.get(b"msg_type") == 0:
                    piece = request.get(b"piece", 0)
                    start = piece * BLOCK_SIZE
                    chunk = self.info_bytes[start : start + BLOCK_SIZE]
                    header = bencode.encode(
                        {
                            b"msg_type": 1,
                            b"piece": piece,
                            b"total_size": len(self.info_bytes),
                        }
                    )
                    # remote's local id for ut_metadata is 1 (peer.py UT_METADATA)
                    self._send(sock, MSG_EXTENDED, bytes([1]) + header + chunk)

    def _send(self, sock: socket.socket, msg_id: int, payload: bytes = b"") -> None:  # deadline: PeerHandler.handle sets settimeout(20) on every peer socket before serving
        sock.sendall(struct.pack(">IB", 1 + len(payload), msg_id) + payload)
