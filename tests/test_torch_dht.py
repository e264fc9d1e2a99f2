"""The port's mainline DHT (BEP 5) and uTP (BEP 29) against the JAX
package's, on loopback.

- KRPC: a port ``DHTNode`` and a reference node with the same id, write
  token secrets and routing table answer the same queries with the same
  decoded replies.
- Lookups across packages: a port ``DHTClient`` finds a peer registered
  on a reference node, and the reverse.
- The routing-table state file one package's node writes, the other's
  loads unchanged.
- uTP: a port connection to a reference listener, and the reverse, move
  the same bytes both ways.

Every node binds 127.0.0.1 and every wait has a deadline.
"""

from __future__ import annotations

import hashlib
import json
import random
import socket
import threading
import time

import pytest

from downloader_tpu.fetch import bencode as ref_bencode
from downloader_tpu.fetch import dht as ref_dht
from downloader_tpu.fetch import utp as ref_utp
from downloader_tpu_torch.fetch import bencode, dht, utp

TIMEOUT = 10.0
SEED = 4242


def _wait(predicate, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _node_ids(rng: random.Random, count: int) -> list[bytes]:
    return [rng.randbytes(20) for _ in range(count)]


class TestKRPC:
    def _twin_nodes(self):
        rng = random.Random(SEED)
        node_id = rng.randbytes(20)
        secrets_pair = [rng.randbytes(8), rng.randbytes(8)]
        table = [(nid, (f"10.0.{i}.{i + 1}", 6881 + i)) for i, nid in enumerate(_node_ids(rng, 12))]
        nodes = []
        for module in (dht, ref_dht):
            node = module.DHTNode(node_id=node_id, host="127.0.0.1")
            node._secrets = list(secrets_pair)
            for nid, addr in table:
                node._learn(nid, addr)
            nodes.append(node)
        return nodes, rng

    @staticmethod
    def _ask(sock, port: int, message: dict) -> dict:
        sock.sendto(ref_bencode.encode(message), ("127.0.0.1", port))
        data, _ = sock.recvfrom(65536)
        return ref_bencode.decode(data)

    def test_replies_match_reference(self):
        nodes, rng = self._twin_nodes()
        querier = rng.randbytes(20)
        info_hash = rng.randbytes(20)
        target = rng.randbytes(20)
        client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        client.bind(("127.0.0.1", 0))
        client.settimeout(TIMEOUT)
        try:
            queries = [
                {b"t": b"aa", b"y": b"q", b"q": b"ping", b"a": {b"id": querier}},
                {b"t": b"ab", b"y": b"q", b"q": b"find_node",
                 b"a": {b"id": querier, b"target": target}},
                {b"t": b"ac", b"y": b"q", b"q": b"find_node",
                 b"a": {b"id": querier, b"target": target, b"want": [b"n4", b"n6"]}},
                {b"t": b"ad", b"y": b"q", b"q": b"get_peers",
                 b"a": {b"id": querier, b"info_hash": info_hash}},
                {b"t": b"ae", b"y": b"q", b"q": b"find_node", b"a": {b"id": querier, b"target": b"x"}},
                {b"t": b"af", b"y": b"q", b"q": b"vote", b"a": {b"id": querier}},
                {b"t": b"ag", b"y": b"q", b"q": b"ping"},
                {b"t": b"ah", b"y": b"q", b"q": b"announce_peer",
                 b"a": {b"id": querier, b"info_hash": info_hash, b"port": 7, b"token": b"bad"}},
            ]
            replies = [[self._ask(client, node.port, q) for q in queries] for node in nodes]
            assert replies[0] == replies[1]
            token = replies[0][3][b"r"][b"token"]
            # a registration with the token both nodes handed out, then a
            # lookup that now returns the registered peer as a value
            follow = [
                {b"t": b"ba", b"y": b"q", b"q": b"announce_peer",
                 b"a": {b"id": querier, b"info_hash": info_hash, b"port": 51413, b"token": token}},
                {b"t": b"bb", b"y": b"q", b"q": b"get_peers",
                 b"a": {b"id": querier, b"info_hash": info_hash}},
            ]
            replies = [[self._ask(client, node.port, q) for q in follow] for node in nodes]
            assert replies[0] == replies[1]
            assert replies[0][1][b"r"][b"values"] == [socket.inet_aton("127.0.0.1") + (51413).to_bytes(2, "big")]
            assert [n._closest(target) for n in nodes][0] == nodes[1]._closest(target)
        finally:
            client.close()
            for node in nodes:
                node.close()

    def test_compact_codecs_match_reference(self):
        rng = random.Random(SEED + 1)
        entries = [(nid, f"10.{i}.0.1", 1000 + i) for i, nid in enumerate(_node_ids(rng, 5))]
        entries6 = [(nid, f"2001:db8::{i + 1}", 2000 + i) for i, nid in enumerate(_node_ids(rng, 3))]
        blob, blob6 = dht._compact_nodes(entries), dht._compact_nodes6(entries6)
        assert blob == ref_dht._compact_nodes(entries)
        assert blob6 == ref_dht._compact_nodes6(entries6)
        assert dht._decode_compact_nodes(blob) == ref_dht._decode_compact_nodes(blob)
        assert dht._decode_compact_nodes6(blob6) == ref_dht._decode_compact_nodes6(blob6)
        values = [dht._compact_peer("10.9.8.7", 6881), dht._compact_peer("2001:db8::5", 7),
                  b"short", 12]
        assert values[:2] == [ref_dht._compact_peer("10.9.8.7", 6881),
                              ref_dht._compact_peer("2001:db8::5", 7)]
        assert dht._decode_compact_values(values) == ref_dht._decode_compact_values(values)


class TestLookupAcrossPackages:
    @pytest.mark.parametrize("direction", ["port-client->ref-node", "ref-client->port-node"])
    def test_get_peers_finds_the_registered_peer(self, direction):
        client_module, node_module = (dht, ref_dht) if direction.startswith("port") else (ref_dht, dht)
        info_hash = hashlib.sha1(direction.encode()).digest()
        node = node_module.DHTNode(host="127.0.0.1")
        try:
            bootstrap = (("127.0.0.1", node.port),)
            # the other package registers the peer (get_peers, then
            # announce_peer with the token), the client looks it up
            node_module.DHTClient(bootstrap=bootstrap).get_peers(
                info_hash, announce_port=7777, max_rounds=1
            )
            client = client_module.DHTClient(bootstrap=bootstrap, query_timeout=2.0)
            peers = client.get_peers(info_hash)
            assert ("127.0.0.1", 7777) in peers
            assert client.responded
        finally:
            node.close()


class TestStateFile:
    @pytest.mark.parametrize("writer,reader", [(dht, ref_dht), (ref_dht, dht)],
                             ids=["port-writes", "ref-writes"])
    def test_state_file_read_by_the_other_package(self, tmp_path, writer, reader):
        hub = reader.DHTNode(host="127.0.0.1")
        state = str(tmp_path / "dht_state.json")
        node = writer.DHTNode(host="127.0.0.1", bootstrap=(("127.0.0.1", hub.port),),
                              state_path=state)
        try:
            assert _wait(lambda: ("127.0.0.1", hub.port) in node.routing_nodes())
        finally:
            node.close()  # persists the table
        with open(state) as handle:
            assert json.load(handle) == [["127.0.0.1", hub.port]]
        reborn = reader.DHTNode(host="127.0.0.1", state_path=state)
        try:
            assert reborn._load_state() == [("127.0.0.1", hub.port)]
            assert _wait(lambda: ("127.0.0.1", hub.port) in reborn.routing_nodes())
        finally:
            reborn.close()
            hub.close()


def test_backend_shared_node_state_read_by_the_reference(tmp_path):
    # the daemon's posture: one process-lifetime node per backend, its
    # routing table persisted at close
    from downloader_tpu_torch.fetch.torrent import TorrentBackend

    hub = ref_dht.DHTNode(host="127.0.0.1")
    state = str(tmp_path / "state.json")
    backend = TorrentBackend(
        dht_bootstrap=(("127.0.0.1", hub.port),), shared_dht=True, dht_state_path=state
    )
    try:
        node = backend._shared_node()
        assert node is not None and backend._shared_node() is node
        assert _wait(lambda: node.routing_nodes())
    finally:
        backend.close()
    reborn = ref_dht.DHTNode(host="127.0.0.1", state_path=state)
    try:
        assert _wait(lambda: ("127.0.0.1", hub.port) in reborn.routing_nodes())
    finally:
        reborn.close()
        hub.close()
    assert TorrentBackend(dht_bootstrap=())._shared_node() is None


def _recv_all(sock, count: int) -> bytes:
    out = bytearray()
    while len(out) < count:
        chunk = sock.recv(count - len(out))
        if not chunk:
            break
        out += chunk
    return bytes(out)


class TestUTPAcrossPackages:
    @pytest.mark.parametrize("dialer,listener", [(utp, ref_utp), (ref_utp, utp)],
                             ids=["port-dials-ref", "ref-dials-port"])
    def test_stream_moves_the_same_bytes(self, dialer, listener):
        accepted: list = []
        server = listener.UTPMultiplexer(host="127.0.0.1", on_accept=accepted.append)
        client_mux = dialer.UTPMultiplexer(host="127.0.0.1")
        try:
            conn = client_mux.connect(("127.0.0.1", server.port), timeout=5)
            assert _wait(lambda: accepted, 5), "accept callback never fired"
            peer = accepted[0]
            conn.settimeout(TIMEOUT)
            peer.settimeout(TIMEOUT)
            rng = random.Random(SEED + 2)
            up, down = rng.randbytes(300_000), rng.randbytes(120_000)
            sender = threading.Thread(target=conn.sendall, args=(up,), daemon=True)
            sender.start()
            assert _recv_all(peer, len(up)) == up
            sender.join(timeout=TIMEOUT)
            sender = threading.Thread(target=peer.sendall, args=(down,), daemon=True)
            sender.start()
            assert _recv_all(conn, len(down)) == down
            sender.join(timeout=TIMEOUT)
            conn.close()
            assert peer.recv(16) == b""  # FIN reaches the other package
        finally:
            server.close()
            client_mux.close()

    def test_header_codec_matches_reference(self):
        args = (utp.ST_DATA, 0x1234, 99, 65535, 17, 4, b"payload")
        assert len(utp._pack(*args[:6], payload=args[6])) == 20 + 7
        a = utp._pack(*args[:6], payload=args[6])
        b = ref_utp._pack(*args[:6], payload=args[6])
        # byte 4..8 is the microsecond send timestamp
        assert a[:4] + a[8:] == b[:4] + b[8:]
        for x, y in ((1, 2), (65535, 0), (5, 5), (40000, 100)):
            assert utp._seq_lt(x, y) == ref_utp._seq_lt(x, y)
