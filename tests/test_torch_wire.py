"""The port's BitTorrent wire helpers against the JAX package's.

Same inputs, made from a seed, must give the same bytes: the RC4
keystream (native and pure), the MSE handshake both ways across the
packages over a socket pair, the BEP 6 allowed-fast set and the
BITFIELD payload, tracker announce query strings and the decoded
compact v4 and v6 peer lists (HTTP and BEP 15 UDP), the BEP 14 LSD
datagram, and the dual-stack address forms. Every socket has a
timeout; nothing leaves the loopback interface.
"""

from __future__ import annotations

import http.server
import ipaddress
import random
import socket
import struct
import threading

import pytest

from downloader_tpu.fetch import dualstack as ref_dualstack
from downloader_tpu.fetch import lsd as ref_lsd
from downloader_tpu.fetch import mse as ref_mse
from downloader_tpu.fetch import peerwire as ref_peerwire
from downloader_tpu.fetch import rc4_native as ref_rc4
from downloader_tpu.fetch import tracker as ref_tracker
from downloader_tpu.fetch.bencode import encode as ref_encode
from downloader_tpu_torch.fetch import dualstack, lsd, mse, peerwire, rc4_native, tracker
from test_torrent import FakeUDPTracker

TIMEOUT = 10.0
SEED = 20261016


def _rng(salt: int = 0) -> random.Random:
    return random.Random(SEED + salt)


def _pure(module, key: bytes, drop: int = 0):
    """An RC4 of ``module`` forced onto its pure-Python keystream."""
    saved = module._lib
    module._lib = False
    try:
        return module.RC4(key, drop=drop)
    finally:
        module._lib = saved


class TestRC4:
    CASES = [(klen, drop, size) for klen in (1, 5, 16, 20, 256)
             for drop, size in ((0, 1), (1024, 777), (0, 40_000))]

    @pytest.mark.parametrize("klen,drop,size", CASES)
    def test_keystream_equals_reference(self, klen, drop, size):
        rng = _rng(klen * 7 + size)
        key = rng.randbytes(klen)
        data = rng.randbytes(size)
        want = ref_rc4.RC4(key, drop=drop).crypt(data)
        assert rc4_native.RC4(key, drop=drop).crypt(data) == want
        assert _pure(rc4_native, key, drop).crypt(data) == want
        assert _pure(ref_rc4, key, drop).crypt(data) == want

    def test_state_carries_across_chunks(self):
        rng = _rng(1)
        key, data = rng.randbytes(20), rng.randbytes(10_000)
        port, ref, pure = (rc4_native.RC4(key, 1024), ref_rc4.RC4(key, 1024),
                           _pure(rc4_native, key, 1024))
        offset = 0
        for size in (1, 7, 250, 4096, 13, 5633):
            chunk = data[offset:offset + size]
            want = ref.crypt(chunk)
            assert port.crypt(chunk) == want and pure.crypt(chunk) == want
            offset += size

    def test_native_library_builds_from_the_ports_own_source(self):
        assert rc4_native._C_PATH != ref_rc4._C_PATH
        assert rc4_native._C_PATH.endswith("downloader_tpu_torch/fetch/_rc4.c")
        with open(rc4_native._C_PATH, "rb") as port_src, open(ref_rc4._C_PATH, "rb") as ref_src:
            assert port_src.read() == ref_src.read()
        if rc4_native._find_compiler() is None:
            pytest.skip("no C compiler on this host")
        assert rc4_native.RC4(b"Key")._native is not None
        assert rc4_native.RC4(b"Key").crypt(b"Plaintext").hex() == "bbf316e8d940af0ad3"

    def test_compile_failure_falls_back_to_pure(self, monkeypatch):
        import tempfile

        def deny_mkstemp(*args, **kwargs):
            raise PermissionError("read-only package dir")

        monkeypatch.setattr(tempfile, "mkstemp", deny_mkstemp)
        monkeypatch.setattr(rc4_native, "_lib", None)
        monkeypatch.setattr(rc4_native, "_SO_PATH", "/nonexistent/_rc4.so")
        cipher = rc4_native.RC4(b"Key")
        assert cipher._native is None
        assert cipher.crypt(b"Plaintext") == ref_rc4.RC4(b"Key").crypt(b"Plaintext")


class TestMSE:
    """A port initiator against a reference receiver, and the reverse.
    Both sides draw their DH keys and padding from one seeded stream, so
    the derived RC4 keys are the same in every pairing; the test compares
    the keystream each side derived and the first payload bytes."""

    INFO_HASH = bytes(range(20))

    @staticmethod
    def _seed_handshake(monkeypatch, salt: int) -> None:
        rng = _rng(100 + salt)
        lock = threading.Lock()

        def keypair(module):
            def draw():
                with lock:
                    private = rng.getrandbits(160) | 1
                public = pow(module.DH_GENERATOR, private, module.DH_PRIME)
                return private, public.to_bytes(module.DH_KEY_BYTES, "big")
            return draw

        def pad():
            with lock:
                return rng.randbytes(rng.randrange(mse.MAX_PAD + 1))

        for module in (mse, ref_mse):
            monkeypatch.setattr(module, "_keypair", keypair(module))
            monkeypatch.setattr(module, "_pad", pad)

    def _handshake(self, initiator, receiver, crypto_provide):
        a, b = socket.socketpair()
        a.settimeout(TIMEOUT)
        b.settimeout(TIMEOUT)
        result: dict = {}

        def accept():
            try:
                result["sock"], result["ia"] = receiver.accept(b, self.INFO_HASH)
            except Exception as exc:  # noqa: BLE001 - asserted below
                result["err"] = exc
                b.close()

        thread = threading.Thread(target=accept)
        thread.start()
        try:
            out = initiator.initiate(
                a, self.INFO_HASH, ia=b"\x13BitTorrent protocol",
                crypto_provide=crypto_provide,
            )
        finally:
            thread.join(timeout=TIMEOUT)
        assert "err" not in result, result.get("err")
        out.sendall(b"first payload from A")
        got_b = result["sock"].recv(64)
        result["sock"].sendall(b"reply from B")
        got_a = out.recv(64)
        keys = None
        if isinstance(out, (mse.EncryptedSocket, ref_mse.EncryptedSocket)) and out._tx:
            keys = (out._tx.crypt(bytes(32)), out._rx.crypt(bytes(32)))
        a.close()
        b.close()
        return {"ia": result["ia"], "got_b": got_b, "got_a": got_a, "keys": keys,
                "encrypted": keys is not None}

    @pytest.mark.parametrize("provide", ["rc4", "plaintext"])
    def test_handshake_both_ways_matches_reference(self, monkeypatch, provide):
        crypto = mse.CRYPTO_RC4 | mse.CRYPTO_PLAINTEXT if provide == "rc4" else mse.CRYPTO_PLAINTEXT
        runs = {}
        for label, initiator, receiver in (
            ("ref->ref", ref_mse, ref_mse),
            ("port->ref", mse, ref_mse),
            ("ref->port", ref_mse, mse),
            ("port->port", mse, mse),
        ):
            # the same draws for every pairing: keys, padding, keystreams
            self._seed_handshake(monkeypatch, 0)
            runs[label] = self._handshake(initiator, receiver, crypto)
        want = runs["ref->ref"]
        assert want["got_b"] == b"first payload from A"
        assert want["got_a"] == b"reply from B"
        assert want["ia"] == b"\x13BitTorrent protocol"
        assert want["encrypted"] == (provide == "rc4")
        for label, got in runs.items():
            assert got == want, label

    def test_refusals_match_reference(self, monkeypatch):
        errors = []
        for initiator, receiver in ((mse, ref_mse), (ref_mse, mse)):
            self._seed_handshake(monkeypatch, 1)
            a, b = socket.socketpair()
            a.settimeout(TIMEOUT)
            b.settimeout(TIMEOUT)
            caught: dict = {}

            def accept(receiver=receiver, b=b, caught=caught):
                try:
                    receiver.accept(b, self.INFO_HASH, allow_plaintext=False)
                except Exception as exc:  # noqa: BLE001 - asserted below
                    caught["err"] = exc
                finally:
                    b.close()

            thread = threading.Thread(target=accept)
            thread.start()
            with pytest.raises(Exception):
                initiator.initiate(a, self.INFO_HASH, crypto_provide=mse.CRYPTO_PLAINTEXT)
            thread.join(timeout=TIMEOUT)
            a.close()
            errors.append(str(caught["err"]))
        assert errors[0] == errors[1] == "no acceptable crypto in provide 0x1"


class TestPeerWireHelpers:
    @pytest.mark.parametrize("salt", range(6))
    def test_allowed_fast_set(self, salt):
        rng = _rng(200 + salt)
        ip = str(ipaddress.IPv4Address(rng.getrandbits(32)))
        info_hash = rng.randbytes(20)
        for num_pieces in (0, 1, 7, 10, 11, 1000, 4096):
            for k in (1, peerwire.ALLOWED_FAST_K, 25):
                want = ref_peerwire.allowed_fast_set(ip, info_hash, num_pieces, k)
                assert peerwire.allowed_fast_set(ip, info_hash, num_pieces, k) == want
        assert peerwire.allowed_fast_set("::1", info_hash, 10) == set()

    def test_bep6_spec_vector(self):
        # BEP 6's worked example: 80.4.4.200, info-hash of 0xaa, 1313 pieces
        got = sorted(peerwire.allowed_fast_set("80.4.4.200", b"\xaa" * 20, 1313, 7))
        assert got == sorted([1059, 431, 808, 1217, 287, 376, 1188])
        assert got == sorted(ref_peerwire.allowed_fast_set("80.4.4.200", b"\xaa" * 20, 1313, 7))

    @pytest.mark.parametrize("count", [0, 1, 7, 8, 9, 64, 1001])
    def test_pack_bitfield(self, count):
        rng = _rng(300 + count)
        flags = [rng.random() < 0.5 for _ in range(count)]
        assert peerwire.pack_bitfield(flags) == ref_peerwire.pack_bitfield(flags)
        assert peerwire.pack_bitfield([True] * count) == ref_peerwire.pack_bitfield([True] * count)

    def test_frames_and_constants(self):
        for msg_id, payload in ((peerwire.MSG_REQUEST, struct.pack(">III", 3, 0, 16384)),
                                (peerwire.MSG_HAVE_ALL, b""), (peerwire.MSG_EXTENDED, b"\x00d1:md")):
            assert peerwire._frame(msg_id, payload) == ref_peerwire._frame(msg_id, payload)
        names = [name for name in dir(ref_peerwire) if name.startswith(("MSG_", "UT_"))]
        names += ["HANDSHAKE_PSTR", "BLOCK_SIZE", "ALLOWED_FAST_K", "MAX_REQUEST_LENGTH",
                  "ENCRYPTION_MODES", "TRANSPORT_MODES"]
        for name in names:
            assert getattr(peerwire, name) == getattr(ref_peerwire, name), name
        assert peerwire.generate_peer_id()[:8] == ref_peerwire.generate_peer_id()[:8]


def _peers(rng: random.Random, count: int, v6: bool) -> list[tuple[str, int]]:
    if v6:
        return [(str(ipaddress.IPv6Address(rng.getrandbits(128))), rng.randrange(1, 65536))
                for _ in range(count)]
    return [(str(ipaddress.IPv4Address(rng.getrandbits(32))), rng.randrange(1, 65536))
            for _ in range(count)]


def _compact(peers) -> bytes:
    return b"".join(ipaddress.ip_address(h).packed + struct.pack(">H", p) for h, p in peers)


class _HTTPTracker:
    """Records each announce's raw query string and answers with fixed
    compact v4 and v6 peer lists."""

    def __init__(self, peers4, peers6):
        body = ref_encode({b"interval": 60, b"peers": _compact(peers4),
                           b"peers6": _compact(peers6)})
        self.queries: list[str] = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                outer.queries.append(self.path.partition("?")[2])
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.timeout = TIMEOUT
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}/announce"

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class TestTracker:
    @pytest.mark.parametrize("salt", range(3))
    def test_compact_decoding(self, salt):
        rng = _rng(400 + salt)
        v4, v6 = _peers(rng, 9, False), _peers(rng, 5, True)
        blob4, blob6 = _compact(v4), _compact(v6)
        for blob in (blob4, blob4 + b"\x01\x02", b""):
            assert tracker.decode_compact_peers(blob) == ref_tracker.decode_compact_peers(blob)
        for blob in (blob6, blob6 + b"\x00" * 7, b""):
            assert tracker.decode_compact_peers6(blob) == ref_tracker.decode_compact_peers6(blob)
        assert tracker.decode_compact_peers(blob4) == v4
        assert tracker.decode_compact_peers6(blob6) == v6

    @pytest.mark.parametrize("event", ["started", "", "completed", "stopped"])
    def test_http_announce_query_and_peers(self, event):
        rng = _rng(500 + len(event))
        v4, v6 = _peers(rng, 4, False), _peers(rng, 3, True)
        info_hash, peer_id = rng.randbytes(20), b"-DT0100-" + rng.randbytes(12)
        server = _HTTPTracker(v4, v6)
        try:
            got = [module.announce(server.url, info_hash, peer_id, left=12345, port=51413,
                                   timeout=TIMEOUT, event=event, uploaded=7, downloaded=99)
                   for module in (tracker, ref_tracker)]
        finally:
            server.close()
        assert got[0] == got[1] == v4 + v6
        assert server.queries[0] == server.queries[1]
        assert ("event=" in server.queries[0]) == bool(event)

    def test_udp_announce_matches_reference(self):
        rng = _rng(600)
        v4 = _peers(rng, 6, False)
        info_hash, peer_id = rng.randbytes(20), b"-DT0100-" + rng.randbytes(12)
        with FakeUDPTracker(v4) as fake:
            got = [module.announce_udp(fake.url, info_hash, peer_id, left=5, port=6881,
                                       timeout=TIMEOUT, retries=0, event="completed",
                                       uploaded=3, downloaded=4)
                   for module in (tracker, ref_tracker)]
            datagrams = list(fake.announces)
        assert got[0] == got[1] == v4
        # the announce datagrams differ only in the transaction id and key
        fields = [struct.unpack(">QII20s20sQQQIIIiH", d) for d in datagrams]
        assert len(fields) == 2
        for index in (2, 10):  # transaction id, key: random per announce
            fields[0] = fields[0][:index] + (0,) + fields[0][index + 1:]
            fields[1] = fields[1][:index] + (0,) + fields[1][index + 1:]
        assert fields[0] == fields[1]

    def test_udp_tracker_error_matches_reference(self):
        with FakeUDPTracker([], error="torrent not registered") as fake:
            messages = []
            for module in (tracker, ref_tracker):
                with pytest.raises(Exception) as caught:
                    module.announce_udp(fake.url, b"\x01" * 20, b"\x02" * 20, left=1,
                                        timeout=TIMEOUT, retries=0)
                messages.append((type(caught.value).__name__, str(caught.value)))
        assert messages[0] == messages[1] == ("TransferError", "tracker error: torrent not registered")


class TestLSDAndDualStack:
    def test_lsd_datagram_roundtrip(self):
        rng = _rng(700)
        for _ in range(5):
            info_hash, port, cookie = rng.randbytes(20), rng.randrange(1, 65536), rng.randbytes(8).hex()
            datagram = lsd.build_announce(lsd.GROUP_V4, lsd.MCAST_PORT, port, info_hash, cookie)
            assert datagram == ref_lsd.build_announce(
                ref_lsd.GROUP_V4, ref_lsd.MCAST_PORT, port, info_hash, cookie
            )
            assert lsd.parse_announce(datagram) == ref_lsd.parse_announce(datagram) == (
                port, [info_hash], cookie
            )
        for junk in (b"", b"NOTIFY * HTTP/1.1\r\n", b"BT-SEARCH * HTTP/1.1\r\nPort: 0\r\n",
                     b"BT-SEARCH * HTTP/1.1\r\nPort: 9\r\nInfohash: zz\r\n"):
            assert lsd.parse_announce(junk) == ref_lsd.parse_announce(junk)

    def test_address_forms(self):
        cases = [("::ffff:10.1.2.3", 80), ("10.1.2.3", 80), ("::1", 7, 0, 0), ("fe80::1", 9, 0, 3)]
        for addr in cases:
            assert dualstack.display_form(addr) == ref_dualstack.display_form(addr)
        for family in (socket.AF_INET, socket.AF_INET6):
            for addr in (("10.1.2.3", 80), ("::1", 7)):
                try:
                    want = ref_dualstack.wire_form(family, addr)
                except OSError as exc:
                    with pytest.raises(type(exc)):
                        dualstack.wire_form(family, addr)
                    continue
                assert dualstack.wire_form(family, addr) == want

    def test_udp_bind_falls_back_like_reference(self):
        sockets = [module.bind_dual_stack_udp("127.0.0.1", 0) for module in (dualstack, ref_dualstack)]
        try:
            assert sockets[0].family == sockets[1].family == socket.AF_INET
        finally:
            for sock in sockets:
                sock.close()
