"""One swarm job of the port through its device path on the CPU.

A reference ``Seeder`` serves a port ``SwarmDownloader`` whose default
digest engine is ``DigestEngine(backend="cuda", device="cpu")``: the
resume at job start and the live ``_PieceBatch`` flush both verify
through the plain PyTorch SHA-1 (the kernel's twin; on the card the
same calls launch the CUDA kernel). The plain version costs about 10 ms
a 64-byte block here, so the torrent is four 16 KiB pieces, two of them
already on disk: one resume flush and one live flush.
"""

from __future__ import annotations

import random

import downloader_tpu.parallel.engine as ref_engine
import downloader_tpu_torch.parallel.engine as port_engine
from downloader_tpu.fetch.seeder import Seeder as RefSeeder
from downloader_tpu_torch.fetch.magnet import parse_magnet
from downloader_tpu_torch.fetch.peer import SwarmDownloader
from downloader_tpu_torch.fetch.pieces import PieceStore
from downloader_tpu_torch.fetch.seeder import make_torrent
from downloader_tpu_torch.utils.cancel import CancelToken

PIECE = 16 * 1024


def test_swarm_job_verifies_through_the_plain_sha1(tmp_path, monkeypatch):
    engine = port_engine.DigestEngine(backend="cuda", device="cpu")
    monkeypatch.setattr(port_engine, "_default", engine)
    monkeypatch.setattr(ref_engine, "_default", ref_engine.DigestEngine(backend="hashlib"))
    data = random.Random(5).randbytes(4 * PIECE)
    info, _, _ = make_torrent("movie.mkv", data, piece_length=PIECE,
                              engine=port_engine.DigestEngine(backend="hashlib"))
    store = PieceStore(info, str(tmp_path))
    for index in (0, 2):
        store.write_piece(index, data[index * PIECE:(index + 1) * PIECE])
    with RefSeeder("movie.mkv", data, piece_length=PIECE) as seeder:
        SwarmDownloader(
            parse_magnet(seeder.magnet_uri), str(tmp_path), progress_interval=0.01,
            dht_bootstrap=(), seed_drain_timeout=0.2,
        ).run(CancelToken(), lambda percent: None)
        assert sorted(seeder.served_requests) == [1, 3]
    assert (tmp_path / "movie.mkv").read_bytes() == data
    # one resume flush (pieces 0 and 2) and one live flush (1 and 3)
    assert (engine.device_batches, engine.host_batches) == (2, 0)
    assert engine.backend_name == "torch-sha1[cpu]"
