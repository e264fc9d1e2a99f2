"""The PyTorch port's verification callers (downloader_tpu_torch/fetch)
held against the JAX package's (downloader_tpu/fetch) on the CPU.

Inputs are made from a numpy seed and given to both packages; every
comparison is exact: bencoded bytes, metainfo fields, resume counts,
``have`` bitmaps, error messages and the bytes written to disk. The
port's digest engine runs its device path on the CPU (``device="cpu"``,
the plain PyTorch SHA-1); the reference's runs its XLA kernel on the
conftest's CPU backend.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest

from downloader_tpu.fetch import bencode as ref_bencode
from downloader_tpu.fetch import magnet as ref_magnet
from downloader_tpu.fetch.peerwire import PeerProtocolError as RefPeerProtocolError
from downloader_tpu.fetch.pieces import PieceStore as RefPieceStore
from downloader_tpu.fetch.seeder import make_torrent as ref_make_torrent
from downloader_tpu.fetch.swarmstate import _PieceBatch as RefPieceBatch
from downloader_tpu.parallel import DigestEngine as RefEngine
from downloader_tpu.utils import metrics as ref_metrics
from downloader_tpu_torch.fetch import bencode, magnet
from downloader_tpu_torch.fetch.peerwire import BLOCK_SIZE, PeerProtocolError
from downloader_tpu_torch.fetch.pieces import PieceStore
from downloader_tpu_torch.fetch.seeder import make_torrent
from downloader_tpu_torch.fetch.swarmstate import _PieceBatch
from downloader_tpu_torch.parallel import DigestEngine
from downloader_tpu_torch.utils import metrics

PIECE = 32 * 1024


def _engine():
    return DigestEngine(backend="cuda", device="cpu")


def _bytes(size, seed):
    return np.random.default_rng(seed).bytes(size)


BENCODE_VALUES = [
    0,
    -17,
    2**70,
    b"",
    b"spam",
    "unicode é",
    [],
    [1, b"two", [3, [b"four"]]],
    {},
    {b"zeta": 1, b"alpha": [b"x", {b"k": b"v"}], "mid": -3},
    {b"info": {b"pieces": bytes(range(40)), b"piece length": PIECE}},
]

BENCODE_BAD = [
    b"",
    b"i01e",
    b"i-0e",
    b"i12",
    b"ix3e",
    b"5:abc",
    b"05:abcde",
    b"l1:a",
    b"di1e1:ae",
    b"x",
    b"i1ei2e",
    b"1:",
    b"l" * 150 + b"e" * 150,
]


class TestBencode:
    @pytest.mark.parametrize("value", BENCODE_VALUES, ids=range(len(BENCODE_VALUES)))
    def test_encode_and_decode_match_reference(self, value):
        encoded = bencode.encode(value)
        assert encoded == ref_bencode.encode(value)
        assert bencode.decode(encoded) == ref_bencode.decode(encoded)

    def test_decode_tolerates_missorted_keys_like_reference(self):
        data = b"d1:bi2e1:ai1ee"
        assert bencode.decode(data) == ref_bencode.decode(data)
        assert list(bencode.decode(data)) == [b"b", b"a"]

    @pytest.mark.parametrize("data", BENCODE_BAD, ids=range(len(BENCODE_BAD)))
    def test_bad_input_raises_the_same_error(self, data):
        with pytest.raises(ref_bencode.BencodeError) as want:
            ref_bencode.decode(data)
        with pytest.raises(bencode.BencodeError) as got:
            bencode.decode(data)
        assert str(got.value) == str(want.value)

    def test_unencodable_values_raise_the_same_error(self):
        for value in (True, 1.5, None, [b"ok", set()], {b"k": object()}):
            with pytest.raises(Exception) as want:
                ref_bencode.encode(value)
            with pytest.raises(Exception) as got:
                bencode.encode(value)
            assert (type(got.value).__name__, str(got.value)) == (
                type(want.value).__name__,
                str(want.value),
            )


def _job_fields(job):
    return dataclasses.asdict(job)


class TestMetainfo:
    def _metainfo(self):
        info, meta, _ = ref_make_torrent(
            "show",
            {"s01/e01.mkv": _bytes(40_000, 1), "s01/e01.srt": _bytes(3_000, 2)},
            piece_length=16 * 1024,
            trackers=("http://t1/announce", "udp://t2:80", "http://t1/announce"),
        )
        raw = ref_bencode.decode(meta)
        raw[b"url-list"] = [b"http://seed/a/", b"ftp://seed/b/", b"gopher://x"]
        return ref_bencode.encode(raw)

    def test_parse_metainfo_matches_reference(self):
        data = self._metainfo()
        job = magnet.parse_metainfo(data)
        want = ref_magnet.parse_metainfo(data)
        assert _job_fields(job) == _job_fields(want)
        assert job.info_hash == hashlib.sha1(
            bencode.encode(bencode.decode(data)[b"info"])
        ).digest()

    def test_info_hash_covers_the_raw_info_span(self):
        # missorted keys inside info: the hash is over the bytes as given
        data = b"d4:infod4:name1:x12:piece lengthi1e6:pieces0:6:lengthi0eee"
        job = magnet.parse_metainfo(data)
        assert job.info_hash == ref_magnet.parse_metainfo(data).info_hash

    @pytest.mark.parametrize(
        "data",
        [b"le", b"d4:infoi1ee", b"d3:fooi1ee", b"i1e", b"d4:info"],
    )
    def test_bad_metainfo_raises_the_same_error(self, data):
        with pytest.raises(ref_magnet.MagnetError) as want:
            ref_magnet.parse_metainfo(data)
        with pytest.raises(magnet.MagnetError) as got:
            magnet.parse_metainfo(data)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize(
        "uri",
        [
            "magnet:?xt=urn:btih:" + "ab" * 20 + "&dn=Show&tr=http://t/a&tr=udp://u:1"
            "&x.pe=10.0.0.1:6881&x.pe=[::1]:7000&x.pe=bad&ws=http://w/&ws=file:///x",
            "magnet:?xt=urn:btih:" + "A" * 32,
            "magnet:?xt=urn:btih:xyz",
            "magnet:?dn=nothing",
            "http://not-a-magnet/",
            "magnet:?xt=urn:btih:" + "zz" * 20,
        ],
    )
    def test_parse_magnet_matches_reference(self, uri):
        try:
            want = _job_fields(ref_magnet.parse_magnet(uri))
        except ref_magnet.MagnetError as exc:
            with pytest.raises(magnet.MagnetError) as got:
                magnet.parse_magnet(uri)
            assert str(got.value) == str(exc)
            return
        assert _job_fields(magnet.parse_magnet(uri)) == want


class TestMakeTorrent:
    def test_single_file_with_a_ragged_last_piece(self):
        data = _bytes(5 * 16384 + 1234, 3)
        got = make_torrent(
            "episode.mkv", data, piece_length=16384, engine=_engine()
        )
        want = ref_make_torrent("episode.mkv", data, piece_length=16384)
        assert got == want
        assert got[0][b"pieces"][-20:] == hashlib.sha1(data[-1234:]).digest()

    def test_multi_file_private_with_trackers(self):
        files = {
            "Show/S01/e01.mkv": _bytes(30_000, 4),
            "Show/S01/e01.srt": _bytes(700, 5),
            "Show/extras/x.nfo": b"",
            "Show/S01/e02.mkv": _bytes(20_001, 6),
        }
        trackers = ("http://tracker/announce", "udp://backup:6969")
        got = make_torrent(
            "Show", files, piece_length=8192, trackers=trackers, private=True,
            engine=_engine(),
        )
        want = ref_make_torrent(
            "Show", files, piece_length=8192, trackers=trackers, private=True
        )
        assert got[1] == want[1]  # byte-equal metainfo
        assert got == want

    def test_empty_payload_hashes_one_empty_piece(self):
        got = make_torrent("empty", b"", engine=_engine())
        assert got == ref_make_torrent("empty", b"")
        assert got[0][b"pieces"] == hashlib.sha1(b"").digest()


def _pad_torrent():
    """A multi-file torrent with a BEP 47 pad file aligning the second
    file to a piece boundary; returns (info, {relative path: bytes})."""
    first = _bytes(700_000, 10)
    pad = (-len(first)) % PIECE
    second = _bytes(600_000, 11)
    third = _bytes(12_345, 12)
    blob = first + bytes(pad) + second + third
    hashes = b"".join(
        hashlib.sha1(blob[i : i + PIECE]).digest()
        for i in range(0, len(blob), PIECE)
    )
    info = {
        b"name": b"season",
        b"piece length": PIECE,
        b"pieces": hashes,
        b"files": [
            {b"path": [b"e01.mkv"], b"length": len(first)},
            {b"path": [b".pad", str(pad).encode()], b"length": pad, b"attr": b"p"},
            {b"path": [b"e02.mkv"], b"length": len(second)},
            {b"path": [b"notes", b"e02.nfo"], b"length": len(third)},
        ],
    }
    files = {"e01.mkv": first, "e02.mkv": second, "notes/e02.nfo": third}
    return info, files, blob


def _write_files(base, files):
    for rel, content in files.items():
        path = os.path.join(base, "season", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as sink:
            sink.write(content)


class TestResumeExisting:
    def test_resume_matches_reference_over_several_flushes(self, tmp_path):
        info, files, blob = _pad_torrent()
        num_pieces = -(-len(blob) // PIECE)
        assert num_pieces == 41
        corrupt = 30  # inside e02.mkv
        offset = corrupt * PIECE + 100 - len(files["e01.mkv"]) - (
            (-len(files["e01.mkv"])) % PIECE
        )
        damaged = bytearray(files["e02.mkv"])
        damaged[offset] ^= 0x40
        files = {**files, "e02.mkv": bytes(damaged)}
        _write_files(str(tmp_path), files)

        batch_bytes = 512 * 1024  # 16 pieces a flush: three flushes
        engine = _engine()
        store = PieceStore(info, str(tmp_path))
        resumed = store.resume_existing(engine, batch_bytes=batch_bytes)
        reference = RefPieceStore(info, str(tmp_path))
        want = reference.resume_existing(
            RefEngine(backend="jax"), batch_bytes=batch_bytes
        )
        assert resumed == want == num_pieces - 1
        assert store.have == reference.have
        assert [i for i, have in enumerate(store.have) if not have] == [corrupt]
        assert engine.device_batches == 3
        assert store.bytes_completed() == reference.bytes_completed()
        # the pad file never reaches the disk
        assert sorted(os.listdir(tmp_path / "season")) == ["e01.mkv", "e02.mkv", "notes"]

    def test_missing_and_short_files_resume_like_reference(self, tmp_path):
        info, files, _ = _pad_torrent()
        files = dict(files)
        del files["notes/e02.nfo"]  # the last piece cannot be read
        files["e02.mkv"] = files["e02.mkv"][: 5 * PIECE]  # a short file
        _write_files(str(tmp_path), files)
        store = PieceStore(info, str(tmp_path))
        resumed = store.resume_existing(_engine(), batch_bytes=1 << 30)
        reference = RefPieceStore(info, str(tmp_path))
        assert resumed == reference.resume_existing(RefEngine(backend="jax"))
        assert store.have == reference.have
        assert store.piece_file_ranges(21) == reference.piece_file_ranges(21)


class _Swarm:
    """What a piece batch needs of its swarm: the store and release()."""

    def __init__(self, store):
        self.store = store
        self.released = []

    def release(self, index, owner):
        self.released.append((index, owner))


class TestPieceBatch:
    def test_one_corrupt_piece_matches_reference(self, tmp_path):
        info, _, blob = _pad_torrent()
        indices = [3, 4, 5, 20, 21, 22, 39, 40]  # 40 is the short last piece
        bad = 21
        results = {}
        for name, store_cls, batch_cls, error, engine, counters in (
            ("port", PieceStore, _PieceBatch, PeerProtocolError, _engine(),
             metrics.GLOBAL),
            ("ref", RefPieceStore, RefPieceBatch, RefPeerProtocolError,
             RefEngine(backend="jax"), ref_metrics.GLOBAL),
        ):
            base = tmp_path / name
            before = counters.snapshot()
            swarm = _Swarm(store_cls(info, str(base)))
            batch = batch_cls(swarm, engine=engine, max_bytes=1 << 30, owner="peer")
            for index in indices:
                data = bytearray(blob[index * PIECE : (index + 1) * PIECE])
                if index == bad:
                    data[BLOCK_SIZE + 5] ^= 0xFF
                batch.add(index, bytes(data))
            with pytest.raises(error) as raised:
                batch.flush()
            batch.flush()  # nothing left pending
            tree = {
                str(path.relative_to(base)): path.read_bytes()
                for path in sorted(base.rglob("*"))
                if path.is_file()
            }
            after = counters.snapshot()
            counted = [
                after.get(key, 0) - before.get(key, 0)
                for key in ("torrent_pieces_verified", "torrent_bytes_downloaded")
            ]
            results[name] = (
                str(raised.value), swarm.released, swarm.store.have, tree, counted
            )
        assert results["port"] == results["ref"]
        message, released, have, tree, counted = results["port"]
        assert counted == [7, 6 * PIECE + len(blob) - 40 * PIECE]
        assert message == f"pieces [{bad}] failed SHA-1 verification"
        assert released == [(bad, "peer")]
        assert [i for i, done in enumerate(have) if done] == [
            i for i in indices if i != bad
        ]
        assert set(tree) == {"season/e01.mkv", "season/e02.mkv", "season/notes/e02.nfo"}

    def test_good_batch_flushes_at_max_bytes(self, tmp_path):
        info, _, blob = _pad_torrent()
        swarm = _Swarm(PieceStore(info, str(tmp_path)))
        engine = _engine()
        batch = _PieceBatch(swarm, engine=engine, max_bytes=2 * PIECE)
        batch.add(0, blob[:PIECE])
        assert not swarm.store.have[0] and engine.device_batches == 0
        batch.add(1, blob[PIECE : 2 * PIECE])  # reaches max_bytes: flushes
        assert swarm.store.have[:2] == [True, True]
        assert engine.device_batches == 1 and swarm.released == []
