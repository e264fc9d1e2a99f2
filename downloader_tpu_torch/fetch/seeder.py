"""Torrent construction for hermetic tests and benchmarks.

``make_torrent`` builds a torrent held in memory, hashing every piece
through the digest engine in one call. The in-process ``Seeder`` and
``SwarmTracker`` servers come with the BitTorrent slice.
"""

from __future__ import annotations

from ..parallel import DigestEngine, default_engine
from . import bencode


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
