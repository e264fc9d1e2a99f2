"""The port's BitTorrent engine against the JAX package's, on loopback.

- ``_SwarmState``: claim, release, rarest-first and endgame decisions
  are the same, with both claim pools' ``_rng`` seeded alike, also over
  P up to 1000 and conns at every bitfield edge (empty, HAVE_ALL,
  HAVE_NONE, short, bits past P, replaced by frames); the port's
  per-conn mask is ``has_piece`` index by index.
- Swarms across packages: a reference ``Seeder`` serves a port
  ``SwarmDownloader``; a port ``Seeder`` serves a reference one; port
  and reference downloaders complete from each other's listeners, once
  with MSE required and once over uTP only. Each gives a byte-identical
  payload and equal piece tables.
- A corrupt peer's piece is refused from the same peer as the reference
  refuses it; a partial payload a reference job left resumes under the
  port with the reference's count; a webseed-only job gives the
  reference's bytes.

Both packages' default digest engines hash with hashlib here (one test
file elsewhere runs the plain PyTorch SHA-1 on the swarm path). Every
downloader runs with DHT and LSD off, every server with a timeout.
"""

from __future__ import annotations

import hashlib
import random
import shutil
import sys
import threading
import types

import numpy as np
import pytest

import downloader_tpu.parallel.engine as ref_engine
import downloader_tpu_torch.parallel.engine as port_engine
from downloader_tpu.fetch import peer as ref_peer
from downloader_tpu.fetch import peerwire as ref_peerwire
from downloader_tpu.fetch import pieces as ref_pieces
from downloader_tpu.fetch import seeder as ref_seeder
from downloader_tpu.fetch import swarmstate as ref_swarmstate
from downloader_tpu.fetch.magnet import parse_magnet as ref_parse_magnet
from downloader_tpu.fetch.magnet import parse_metainfo as ref_parse_metainfo
from downloader_tpu.utils.cancel import CancelToken as RefCancelToken
from downloader_tpu_torch.fetch import peer, peerwire, pieces, seeder, swarmstate
from downloader_tpu_torch.fetch.bencode import decode, encode
from downloader_tpu_torch.fetch.magnet import parse_magnet, parse_metainfo
from downloader_tpu_torch.utils.cancel import CancelToken
from test_torrent import FakeUDPTracker, _RangeHTTPServer

JOIN_S = 60.0
PIECE = 16 * 1024
SEED = 77

PORT = {"name": "port", "peer": peer, "peerwire": peerwire, "pieces": pieces,
        "seeder": seeder, "swarmstate": swarmstate, "magnet": parse_magnet, "metainfo": parse_metainfo,
        "token": CancelToken}
REF = {"name": "ref", "peer": ref_peer, "peerwire": ref_peerwire, "pieces": ref_pieces,
       "seeder": ref_seeder, "swarmstate": ref_swarmstate, "magnet": ref_parse_magnet,
       "metainfo": ref_parse_metainfo, "token": RefCancelToken}


@pytest.fixture(autouse=True)
def _hashlib_engines(monkeypatch):
    monkeypatch.setattr(port_engine, "_default", port_engine.DigestEngine(backend="hashlib"))
    monkeypatch.setattr(ref_engine, "_default", ref_engine.DigestEngine(backend="hashlib"))


def _payload(size: int, salt: int = 0) -> bytes:
    return random.Random(SEED + salt).randbytes(size)


def _downloader(pkg, job, base, **kwargs):
    kwargs.setdefault("progress_interval", 0.01)
    kwargs.setdefault("dht_bootstrap", ())
    kwargs.setdefault("seed_drain_timeout", 0.5)
    return pkg["peer"].SwarmDownloader(job, str(base), **kwargs)


def _run(pkg, downloader) -> None:
    downloader.run(pkg["token"](), lambda percent: None)


# -- the claim pool ---------------------------------------------------------


class _StubConn:
    def __init__(self, num_pieces: int, indices):
        field = bytearray((num_pieces + 7) // 8)
        for i in indices:
            field[i // 8] |= 0x80 >> (i % 8)
        self.bitfield = bytes(field)

    def has_piece(self, index: int) -> bool:
        return bool(self.bitfield[index // 8] & (0x80 >> (index % 8)))

    def queue_have(self, index: int) -> None:
        pass


def _claim_script(pkg, tmp_path, seed: int) -> list:
    """A seeded sequence of claims, releases, completions and HAVE
    updates against one package's claim pool; returns every decision."""
    num = 24
    info, _, _ = pkg["seeder"].make_torrent("r.bin", b"Z" * (num * PIECE), piece_length=PIECE)
    store = pkg["pieces"].PieceStore(info, str(tmp_path / pkg["name"]))
    swarm = pkg["swarmstate"]._SwarmState(store, lambda p: None, 1.0)
    swarm._rng = random.Random(seed)
    script = random.Random(seed + 1)
    conns = [_StubConn(num, range(num)), _StubConn(num, range(0, num, 2)),
             _StubConn(num, range(num // 2)), _StubConn(num, [])]
    for conn in conns:
        swarm.register(conn)
    decisions = []
    held: list[tuple[int, int]] = []
    for _ in range(200):
        who = script.randrange(len(conns))
        action = script.random()
        if action < 0.6:
            index = swarm.claim(conns[who])
            label = "WAIT" if index is swarm.WAIT else index
            decisions.append(("claim", who, label, swarm.endgame))
            if isinstance(index, int):
                held.append((index, who))
        elif action < 0.75 and held:
            index, owner = held.pop(script.randrange(len(held)))
            swarm.release(index, conns[owner])
            decisions.append(("release", owner, index))
        elif action < 0.9 and held:
            index, _ = held.pop(script.randrange(len(held)))
            store.have[index] = True
            decisions.append(("have", index))
        else:
            extra = script.randrange(num)
            conns[3] = _StubConn(num, {extra} | {i for i in range(num) if conns[3].has_piece(i)})
            swarm.register(conns[3])
            decisions.append(("bitfield", extra))
        if swarm.done():
            break
    decisions.append(("only", swarm.claim(conns[0], only={1, 2, 3})))
    return decisions


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_swarm_state_decisions_match_reference(tmp_path, seed):
    port = _claim_script(PORT, tmp_path, seed)
    ref = _claim_script(REF, tmp_path, seed)
    assert port == ref
    kinds = {d[0] for d in port}
    assert {"claim", "release", "have"} <= kinds
    assert any(d[0] == "claim" and d[3] for d in port), "endgame never reached"


def _bits(num: int, indices) -> bytearray:
    field = bytearray((num + 7) // 8)
    for i in indices:
        field[i // 8] |= 0x80 >> (i % 8)
    return field


# every edge a claim's "held by this peer" rule has to get right
CONN_KINDS = ("empty", "have_all", "have_none", "short", "past_end", "partial", "no_flag")


def _edge_conn(pkg, kind: str, num: int, rng: random.Random):
    """A ``PeerConnection`` of ``pkg`` with no socket (claims read only
    its bitfield and HAVE_ALL flag), in the state ``kind`` names; or,
    for ``no_flag``, a ``_StubConn``, which has no such flag."""
    some = [i for i in range(num) if rng.random() < 0.5]
    if kind == "no_flag":
        return _StubConn(num, some)
    conn = object.__new__(pkg["peerwire"].PeerConnection)
    conn.bitfield, conn.remote_have_all = {
        "empty": (b"", False),
        "have_all": (b"", True),
        "have_none": (b"\x00", False),
        # the first half's bytes only: the rest reads 0
        "short": (bytes(_bits(num, some)[: max(1, num // 16)]), False),
        # every bit of the last byte set past P, and two bytes beyond
        "past_end": (bytes(_bits(num, some + list(range(num, -(-num // 8) * 8))))
                     + b"\xff\xff", False),
        "partial": (bytes(_bits(num, some)), False),
    }[kind]
    return conn


def _wire_update(pkg, conn, num: int, rng: random.Random) -> str:
    """Replace a conn's bitfield as a received frame does: HAVE (through
    the package's own ``_mark_have``), BITFIELD, HAVE_ALL or HAVE_NONE."""
    if isinstance(conn, _StubConn):
        conn.bitfield = bytes(_bits(num, [i for i in range(num) if rng.random() < 0.5]))
        return "bitfield"
    frame = rng.choice(("have", "have", "have", "bitfield", "have_all", "have_none"))
    if frame == "have":
        pkg["peerwire"].PeerConnection._mark_have(conn, rng.randrange(num + 9))
    elif frame == "bitfield":
        conn.bitfield = bytes(_bits(num, [i for i in range(num) if rng.random() < 0.3]))
    else:
        conn.bitfield = b"" if frame == "have_all" else b"\x00"
        conn.remote_have_all = frame == "have_all"
    return frame


def _edge_script(pkg, num: int, conns_n: int, seed: int) -> list:
    """A seeded script over the edge conns against one package's claim
    pool: claims with and without ``only``, releases by owners, by
    strangers and by nobody, direct ``store.have`` writes, bitfields
    replaced as frames arrive, unregister and register; returns every
    decision. An unregistered webseed-like source claims too, so even
    one registered conn meets endgame."""
    store = types.SimpleNamespace(num_pieces=num, have=[False] * num)
    script = random.Random(seed)
    for i in range(num):
        store.have[i] = script.random() < 0.25  # a resume found these
    swarm = pkg["swarmstate"]._SwarmState(store, lambda p: None, 1.0)
    swarm._rng = random.Random(seed + 1)
    offset = script.randrange(len(CONN_KINDS))
    conns = [_edge_conn(pkg, CONN_KINDS[(offset + k) % len(CONN_KINDS)], num, script)
             for k in range(conns_n)]
    conns.append(_StubConn(0, ()))  # the webseed: b"" holds everything; never registered
    live = set(range(conns_n))
    for k in live:
        swarm.register(conns[k])
    decisions: list = []
    held: list[tuple[int, int]] = []
    for _ in range(4 * num + 80):
        who = script.randrange(len(conns))
        action = script.random()
        if action < 0.5:
            only = None
            if script.random() < 0.15:  # allowed-fast grants: any 32-bit index
                only = {script.randrange(-2, num + 8) for _ in range(script.randrange(6))}
                missing = [i for i in range(num) if not store.have[i]]
                if missing and script.random() < 0.7:
                    only.add(script.choice(missing))
            index = swarm.claim(conns[who], only=only)
            label = "WAIT" if index is swarm.WAIT else index
            decisions.append(("claim", who, only is not None, label, swarm.endgame))
            if isinstance(index, int):
                held.append((index, who))
        elif action < 0.58 and held:
            index, owner = held.pop(script.randrange(len(held)))
            stranger = script.random() < 0.5
            by = conns[(owner + 1) % len(conns)] if stranger else conns[owner]
            swarm.release(index, None if script.random() < 0.1 else by)
            decisions.append(("release", owner, index, stranger))
        elif action < 0.75 and held:
            index, _ = held.pop(script.randrange(len(held)))
            store.have[index] = True  # a verified write lands
            decisions.append(("have", index))
        elif action < 0.77:
            store.have[script.randrange(num)] = True
        elif action < 0.9 and who < conns_n:
            decisions.append(("frame", who, _wire_update(pkg, conns[who], num, script)))
        elif who < conns_n:
            if who in live and len(live) > 1:
                swarm.unregister(conns[who])
                live.discard(who)
            else:
                swarm.register(conns[who])
                live.add(who)
            decisions.append(("live", who, who in live))
        if swarm.done():
            break
    last = [swarm.claim(c, only={0, 1, num - 1, num}) for c in conns]
    decisions.append(("last", ["WAIT" if index is swarm.WAIT else index for index in last]))
    return decisions


@pytest.mark.parametrize("conns_n", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("num", [24, 257, 1000])
def test_swarm_state_edge_conns_match_reference(num, conns_n):
    seed = num * 10 + conns_n
    port = _edge_script(PORT, num, conns_n, seed)
    ref = _edge_script(REF, num, conns_n, seed)
    assert port == ref
    assert any(d[0] == "claim" and d[2] and d[3] is not None for d in port), "no only= claim"
    assert any(d[0] == "claim" and d[4] for d in port), "endgame never reached"
    assert any(d[0] == "release" and d[3] for d in port), "no stranger release"


@pytest.mark.parametrize("num", [1, 24, 257, 1000])
@pytest.mark.parametrize("kind", CONN_KINDS + ("have_then_have_all", "have_past_end"))
def test_held_mask_matches_has_piece(kind, num):
    """The claim pool's per-conn mask is, index by index, the rule
    ``not conn.bitfield or conn.has_piece(i)`` under both packages'
    ``PeerConnection.has_piece`` (a flagless stub: its own)."""
    rng = random.Random(num)
    base = "partial" if kind == "have_past_end" else kind
    conn = _edge_conn(PORT, "have_all" if kind == "have_then_have_all" else base, num, rng)
    if kind == "have_then_have_all":  # HAVE_ALL, then a HAVE grows a bitfield
        peerwire.PeerConnection._mark_have(conn, num // 2)
    if kind == "have_past_end":  # a HAVE past P grows the bitfield beyond P/8
        peerwire.PeerConnection._mark_have(conn, num + 20)
    valid = swarmstate._packed(b"\x01" * num, num)
    bits = swarmstate._held_bits(conn, valid)
    assert bits.shape == ((num + 63) // 64,)
    mask = np.unpackbits(bits.view(np.uint8)).astype(bool)
    assert not mask[num:].any()
    mask = mask[:num]
    rules = [type(conn).has_piece] if kind == "no_flag" else [
        peerwire.PeerConnection.has_piece, ref_peerwire.PeerConnection.has_piece]
    for has_piece in rules:
        assert mask.tolist() == [not conn.bitfield or has_piece(conn, i) for i in range(num)]


def test_steady_state_claim_keeps_the_gil():
    """A claim whose have list and bitfields did not change runs every
    array op on P/64 words, none of which drops the GIL: a spinning
    thread, given the GIL only when the claiming thread lets it go,
    makes no step during 100 such claims (numpy drops the GIL over more
    than 500 elements; ``argmax`` and ``searchsorted`` at any size)."""
    num = 4096
    store = types.SimpleNamespace(num_pieces=num, have=[i % 2 == 0 for i in range(num)])
    swarm = swarmstate._SwarmState(store, lambda p: None, 1.0)
    conn = _StubConn(num, range(num))
    swarm.register(conn)
    swarm.claim(conn)  # packs the have list and the levels once
    steps, stop = [0], threading.Event()

    def spin() -> None:
        while not stop.is_set():
            steps[0] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)  # the spinner must wait this long to force a switch
    spinner = threading.Thread(target=spin, daemon=True)
    try:
        spinner.start()
        before = steps[0]
        claimed = [swarm.claim(conn) for _ in range(100)]
        during = steps[0] - before
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        spinner.join(timeout=JOIN_S)
    assert not spinner.is_alive()
    assert len(set(claimed)) == 100 and all(i % 2 for i in claimed)
    assert during == 0, f"the spinner ran {during} steps inside 100 claims"


# -- swarms across packages ------------------------------------------------


def _table(meta: bytes) -> bytes:
    return decode(meta)[b"info"][b"pieces"]


@pytest.mark.parametrize("seeds,leeches", [(REF, PORT), (PORT, REF)],
                         ids=["ref-seeds-port-leeches", "port-seeds-ref-leeches"])
def test_seeder_serves_the_other_package(tmp_path, seeds, leeches):
    data = _payload(9 * PIECE + 1234, salt=1)
    with seeds["seeder"].Seeder("Show.S01E01.mkv", data, piece_length=PIECE) as source:
        job = leeches["magnet"](source.magnet_uri)
        downloader = _downloader(leeches, job, tmp_path)
        _run(leeches, downloader)
        assert source.served_requests
    assert (tmp_path / "Show.S01E01.mkv").read_bytes() == data
    # the piece table the leecher verified against is the other
    # package's make_torrent, and equals its own
    port_info, port_meta, _ = seeder.make_torrent("Show.S01E01.mkv", data, piece_length=PIECE)
    _, ref_meta, _ = ref_seeder.make_torrent("Show.S01E01.mkv", data, piece_length=PIECE)
    assert port_meta == ref_meta
    assert encode(source.info) == encode(port_info)
    assert source.info[b"pieces"] == _table(port_meta)


@pytest.mark.parametrize("mode", ["encryption-require", "transport-utp"])
def test_downloaders_complete_from_each_others_listeners(tmp_path, mode):
    data = _payload(12 * PIECE + 999, salt=2)
    kwargs = {"encryption": "require"} if mode.startswith("encryption") else {"transport": "utp"}
    tracker_pkg = PORT if mode.startswith("encryption") else REF
    with tracker_pkg["seeder"].SwarmTracker() as tracker:
        _, meta, _ = seeder.make_torrent("movie.mkv", data, PIECE, trackers=(tracker.url,))
        _, ref_meta, _ = ref_seeder.make_torrent("movie.mkv", data, PIECE, trackers=(tracker.url,))
        assert meta == ref_meta
        packages = (PORT, REF)
        dirs = [tmp_path / pkg["name"] for pkg in packages]
        stores = [pkg["pieces"].PieceStore(pkg["metainfo"](meta).info, str(d))
                  for pkg, d in zip(packages, dirs)]
        for i in range(stores[0].num_pieces):
            owner = stores[i % 2]  # interleaved halves, written by each package
            owner.write_piece(i, data[i * PIECE: i * PIECE + owner.piece_size(i)])
        downloaders = [
            _downloader(pkg, pkg["metainfo"](meta), d, discovery_rounds=8, **kwargs)
            for pkg, d in zip(packages, dirs)
        ]
        results: dict = {}

        def run(idx: int) -> None:
            try:
                _run(packages[idx], downloaders[idx])
                results[idx] = None
            except Exception as exc:  # noqa: BLE001 - asserted below
                results[idx] = exc

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=JOIN_S)
        assert results == {0: None, 1: None}
    for d in dirs:
        assert (d / "movie.mkv").read_bytes() == data
    # mutual leeching: each side served the other across the packages
    assert all(dl.blocks_served > 0 for dl in downloaders)
    assert [s.piece_hashes for s in stores][0] == stores[1].piece_hashes


# -- verification and resume -----------------------------------------------


class _UDPTracker(FakeUDPTracker):
    def _serve(self):
        try:
            super()._serve()
        except OSError:
            pass  # closed while a job's late "stopped" announce came in


def _corrupt_peer_run(pkg, tmp_path, data, bad):
    with pkg["seeder"].Seeder("movie.mkv", data, piece_length=PIECE,
                              corrupt_pieces=(bad,)) as corrupt, \
         pkg["seeder"].Seeder("movie.mkv", data, piece_length=PIECE) as honest, \
         _UDPTracker([corrupt.peer_address, honest.peer_address]) as udp:
        magnet = f"magnet:?xt=urn:btih:{corrupt.info_hash.hex()}&tr={udp.url}"
        # one worker: peers are tried in the tracker's order, so the
        # corrupt peer serves every piece first and the honest one only
        # what the corrupt one got refused
        downloader = _downloader(pkg, pkg["magnet"](magnet), tmp_path / pkg["name"],
                                 max_peer_connections=1)
        _run(pkg, downloader)
        return {
            "corrupt_served": sorted(set(corrupt.served_requests)),
            "honest_served": list(honest.served_requests),
            "errors": downloader._swarm_ref.error_summary(),
            "bytes": (tmp_path / pkg["name"] / "movie.mkv").read_bytes(),
        }


def test_corrupt_peer_refused_as_the_reference_refuses_it(tmp_path):
    data = _payload(6 * PIECE + 100, salt=3)
    bad = 4
    port = _corrupt_peer_run(PORT, tmp_path, data, bad)
    ref = _corrupt_peer_run(REF, tmp_path, data, bad)
    assert port == ref
    assert port["bytes"] == data
    assert port["corrupt_served"] == list(range(7))
    assert port["honest_served"] == [bad]
    assert port["errors"] == f"pieces [{bad}] failed SHA-1 verification"


def test_partial_payload_from_a_reference_job_resumes_under_the_port(tmp_path, monkeypatch):
    data = _payload(10 * PIECE + 77, salt=4)
    served = 4
    left = tmp_path / "left"
    # a reference job whose only peer drops it after four pieces
    with ref_seeder.Seeder("movie.mkv", data, piece_length=PIECE, serve_limit=served) as dying:
        job = ref_parse_magnet(dying.magnet_uri)
        with pytest.raises(Exception, match="pieces missing"):
            _run(REF, _downloader(REF, job, left, discovery_rounds=1))
    counts: dict = {}
    for pkg in (PORT, REF):
        store_cls = pkg["pieces"].PieceStore
        original = store_cls.resume_existing

        def recording(self, *args, _original=original, _name=pkg["name"], **kwargs):
            resumed = _original(self, *args, **kwargs)
            counts.setdefault(_name, []).append(resumed)
            return resumed

        monkeypatch.setattr(store_cls, "resume_existing", recording)
        job_dir = tmp_path / pkg["name"]
        shutil.copytree(left, job_dir)
        with pkg["seeder"].Seeder("movie.mkv", data, piece_length=PIECE) as honest:
            _run(pkg, _downloader(pkg, pkg["magnet"](honest.magnet_uri), job_dir))
            # the resumed pieces were not fetched again
            assert len(honest.served_requests) == 11 - counts[pkg["name"]][0]
        assert (job_dir / "movie.mkv").read_bytes() == data
    assert counts["port"] == counts["ref"] == [served]


def test_webseed_only_job_gives_the_reference_bytes(tmp_path):
    data = _payload(7 * PIECE + 5, salt=5)
    with _RangeHTTPServer({"movie.mkv": data}) as server:
        _, meta, _ = seeder.make_torrent("movie.mkv", data, piece_length=PIECE)
        raw = decode(meta)
        raw[b"url-list"] = (server.url + "/").encode()
        meta = encode(raw)
        for pkg in (PORT, REF):
            job = pkg["metainfo"](meta)
            assert job.web_seeds == (server.url + "/",)
            _run(pkg, _downloader(pkg, job, tmp_path / pkg["name"], seed_drain_timeout=0.2))
        ranged = [r for r in server.requests if r[1]]
    port_bytes = (tmp_path / "port" / "movie.mkv").read_bytes()
    assert port_bytes == (tmp_path / "ref" / "movie.mkv").read_bytes() == data
    assert len(ranged) >= 2 * 8
    assert hashlib.sha1(port_bytes).digest() == hashlib.sha1(data).digest()
