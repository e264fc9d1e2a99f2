"""Piece storage: SHA-1-verified single/multi-file assembly rooted at
the job dir, resume re-verification through the digest engine (the CUDA
kernel on the card), and HAVE observer fan-out.

Matches anacrolix's file storage role for the reference
(torrent.go:40-41), as the JAX package's fetch/pieces.py does, with the
same behaviour.
"""

from __future__ import annotations

import hashlib
import os
import threading

from ..parallel import DigestEngine, default_engine
from ..utils import flows, get_logger, metrics, watchdog
from . import progress as transfer_progress
from .http import TransferError
from .peerwire import PeerProtocolError

log = get_logger("fetch.peer")


class PieceStore:
    """Maps verified pieces onto the torrent's file layout under base_dir,
    mirroring anacrolix file storage (reference torrent.go:40-41)."""

    def __init__(self, info: dict, base_dir: str):
        self.piece_length = info.get(b"piece length", 0)
        hashes = info.get(b"pieces", b"")
        if (
            not isinstance(self.piece_length, int)
            or self.piece_length <= 0
            or not isinstance(hashes, bytes)
            or len(hashes) % 20
        ):
            raise TransferError("invalid torrent info dict")
        self.piece_hashes = [hashes[i : i + 20] for i in range(0, len(hashes), 20)]

        name_raw = info.get(b"name", b"download")
        name = os.path.basename(
            name_raw.decode("utf-8", "replace") if isinstance(name_raw, bytes) else "download"
        ) or "download"

        self.files: list[tuple[str, int]] = []  # (path, length)
        # torrent-relative path segments per file (webseed URL building)
        self.relative_paths: list[tuple[str, ...]] = []
        # BEP 47: pad entries (attr contains 'p', or the legacy
        # .pad/-directory convention) exist only to align the next real
        # file to a piece boundary. Their bytes are all zeros BY SPEC:
        # never written to disk (no junk files for the media scanner /
        # uploader to trip on), read back as zeros for verification and
        # serving, zero-filled instead of fetched from webseeds.
        self.pad_file: list[bool] = []
        self.single_file = b"files" not in info
        if not self.single_file:  # multi-file: base_dir/name/<path...>
            for entry in info[b"files"]:
                parts = [
                    p.decode("utf-8", "replace")
                    for p in entry[b"path"]
                    if isinstance(p, bytes)
                ]
                safe_parts = [os.path.basename(p) for p in parts if p not in ("", ".", "..")]
                if not safe_parts:
                    raise TransferError("torrent file entry has no usable path")
                attr = entry.get(b"attr", b"")
                is_pad = (
                    isinstance(attr, bytes) and b"p" in attr
                ) or parts[:1] == [".pad"]
                self.files.append(
                    (os.path.join(base_dir, name, *safe_parts), int(entry[b"length"]))
                )
                self.relative_paths.append((name, *safe_parts))
                self.pad_file.append(is_pad)
        else:  # single file: base_dir/name
            self.files.append((os.path.join(base_dir, name), int(info[b"length"])))
            self.relative_paths.append((name,))
            self.pad_file.append(False)

        self.total_length = sum(length for _, length in self.files)
        expected_pieces = (
            self.total_length + self.piece_length - 1
        ) // self.piece_length
        if expected_pieces != len(self.piece_hashes):
            raise TransferError(
                f"piece count mismatch: {len(self.piece_hashes)} hashes for "
                f"{expected_pieces} pieces"
            )
        self.have = [False] * len(self.piece_hashes)
        # flow-ledger identity: one torrent = one object, shared by the
        # swarm's SourceBoard (demand side) and the verified-piece path
        # (unique side) so amplification compares like with like
        self.flow_key = flows.object_key(
            f"torrent:{name}:{self.total_length}"
        )
        self._flow_lock = threading.Lock()
        self._verified_bytes = 0  # guarded-by: _flow_lock
        # serializes write_piece file IO: concurrent peer workers would
        # otherwise race the exists()/"wb" decision and truncate each
        # other's bytes in shared files
        self._write_lock = threading.Lock()
        # piece-complete callbacks (index) — the inbound listener hangs
        # its HAVE broadcast here so remote leechers learn of new pieces
        self._observers: list = []
        # streaming-upload hand-off: captured at construction (the
        # SwarmDownloader builds the store on the job thread, where the
        # job's sink is installed); verified piece spans are reported
        # from whatever worker thread wins them — sinks are thread-safe.
        # Pieces are SHA-1 verified before write, so unlike the HTTP
        # write offset these spans can ship out of order safely.
        self._transfer_sink = transfer_progress.current()
        # stall-watchdog heartbeat, captured on the job thread like the
        # sink; beaten per SHA-1-verified piece from whichever worker
        # thread won it (a counter bump — no lock, no clock)
        self._fetch_hb = watchdog.current().heartbeat("fetch")
        for (path, length), is_pad in zip(self.files, self.pad_file):
            if not is_pad and length > 0:
                self._transfer_sink.begin_file(path, length)

    def add_observer(self, callback) -> None:
        self._observers.append(callback)

    @property
    def num_pieces(self) -> int:
        return len(self.piece_hashes)

    def piece_size(self, index: int) -> int:
        if index == self.num_pieces - 1:
            remainder = self.total_length - self.piece_length * (self.num_pieces - 1)
            return remainder
        return self.piece_length

    def bytes_completed(self) -> int:
        return sum(
            self.piece_size(i) for i, done in enumerate(self.have) if done
        )

    def piece_file_ranges(
        self, index: int
    ) -> list[tuple[tuple[str, ...] | None, int, int]]:
        """[(relative_path_parts, offset_in_file, length)] covering one
        piece — the per-file ranges a webseed fetch must request.
        ``parts`` is None for a BEP 47 pad range: those bytes are zeros
        by spec and are not on the webseed — callers zero-fill them
        locally instead of requesting them."""
        offset = index * self.piece_length
        size = self.piece_size(index)
        out = []
        file_start = 0
        for (path, length), parts, is_pad in zip(
            self.files, self.relative_paths, self.pad_file
        ):
            file_end = file_start + length
            lo = max(offset, file_start)
            hi = min(offset + size, file_end)
            if lo < hi:
                # BEP 47: pad ranges are all zeros and are NOT on the
                # webseed — parts=None tells the fetch to zero-fill
                out.append((None if is_pad else parts, lo - file_start, hi - lo))
            file_start = file_end
        return out

    def _report_verified(self, index: int) -> None:
        """Advertise one verified piece's on-disk byte ranges to the
        job's transfer sink (streaming upload): per overlapped file,
        the file-relative span the piece covers. Pad ranges are never
        on disk and never advertised."""
        size = self.piece_size(index)
        # forward progress for the stall watchdog: a verified piece is
        # the torrent backend's unit of durable progress
        self._fetch_hb.beat(size)
        # unique object bytes for the flow ledger: verified-once bytes,
        # reported as a running total (note_unique's max semantics make
        # out-of-order delivery from racing workers harmless)
        with self._flow_lock:
            self._verified_bytes += size
            verified = self._verified_bytes
        flows.LEDGER.note_unique(self.flow_key, verified)
        if self._transfer_sink is transfer_progress.NOOP:
            return  # keep the per-piece hot path free of the file walk
        offset = index * self.piece_length
        file_start = 0
        for (path, length), is_pad in zip(self.files, self.pad_file):
            file_end = file_start + length
            lo = max(offset, file_start)
            hi = min(offset + size, file_end)
            if lo < hi and not is_pad:
                self._transfer_sink.add_span(path, lo - file_start, hi - file_start)
            file_start = file_end

    def read_piece(self, index: int, handles: dict | None = None) -> bytes | None:
        """Read one piece back from the on-disk file layout.

        Returns None if any file covering the piece is missing or too
        short (nothing to resume for that piece). ``handles`` is an
        optional path→open-file cache so a whole-torrent scan
        (resume_existing) opens each file once instead of once per piece.
        """
        return self._read_range(
            index * self.piece_length, self.piece_size(index), handles
        )

    def read_block(self, index: int, begin: int, length: int) -> bytes | None:
        """One block of a COMPLETED piece, for serving inbound REQUESTs.
        Returns None for pieces we don't have or out-of-bounds ranges —
        the serving side drops such requests rather than erroring."""
        if not (0 <= index < self.num_pieces) or not self.have[index]:
            return None
        if begin < 0 or length <= 0 or begin + length > self.piece_size(index):
            return None
        return self._read_range(index * self.piece_length + begin, length)

    def _read_range(
        self, offset: int, size: int, handles: dict | None = None
    ) -> bytes | None:
        out = bytearray()
        file_start = 0
        for (path, length), is_pad in zip(self.files, self.pad_file):
            file_end = file_start + length
            lo = max(offset, file_start)
            hi = min(offset + size, file_end)
            if lo < hi and is_pad:
                out += bytes(hi - lo)  # BEP 47: zeros, never on disk
            elif lo < hi:
                if handles is not None and path in handles:
                    src = handles[path]
                else:
                    try:
                        src = open(path, "rb")
                    except OSError:
                        src = None
                    if handles is not None:
                        handles[path] = src
                if src is None:
                    return None
                try:
                    src.seek(lo - file_start)
                    chunk = src.read(hi - lo)
                except OSError:
                    return None
                finally:
                    if handles is None:
                        src.close()
                if len(chunk) != hi - lo:
                    return None
                out += chunk
            file_start = file_end
        if len(out) != size:
            return None
        return bytes(out)

    def resume_existing(
        self,
        engine: DigestEngine | None = None,
        batch_bytes: int = 64 * 1024 * 1024,
    ) -> int:
        """Mark pieces already valid on disk as complete.

        Re-verifies whatever a previous (interrupted) job left in the
        file layout, batching pieces through the digest engine
        (accelerator-offloaded for large batches) in ``batch_bytes``
        chunks to bound host memory. Returns the number of resumed
        pieces. Sparse regions written by out-of-order ``write_piece``
        calls read back as zeros and simply fail verification.
        """
        engine = engine or default_engine()
        resumed = 0
        indices: list[int] = []
        pieces: list[bytes] = []
        pending = 0
        handles: dict = {}  # one open per file for the whole scan

        def flush() -> int:
            nonlocal indices, pieces, pending
            if not indices:
                return 0
            verdicts = engine.verify_pieces(
                pieces, [self.piece_hashes[i] for i in indices]
            )
            count = 0
            for index, good in zip(indices, verdicts):
                if good:
                    self.have[index] = True
                    self._report_verified(index)
                    count += 1
            indices, pieces, pending = [], [], 0
            return count

        try:
            for index in range(self.num_pieces):
                if self.have[index]:
                    continue
                data = self.read_piece(index, handles=handles)
                if data is None:
                    continue
                indices.append(index)
                pieces.append(data)
                pending += len(data)
                if pending >= batch_bytes:
                    resumed += flush()
        finally:
            for handle in handles.values():
                if handle is not None:
                    handle.close()
        resumed += flush()
        return resumed

    def write_piece(self, index: int, data: bytes) -> None:
        """Verify one piece against its torrent hash and write it.
        Per-piece hashlib verification: right for trickle arrivals and
        direct callers; the swarm's batch path verifies through the
        digest engine first and calls :meth:`write_verified`."""
        if hashlib.sha1(data).digest() != self.piece_hashes[index]:
            raise PeerProtocolError(f"piece {index} failed SHA-1 verification")
        self.write_verified(index, data)

    def write_verified(self, index: int, data: bytes) -> None:
        """Write a piece that has ALREADY been verified (batch path)."""
        offset = index * self.piece_length
        cursor = 0
        file_start = 0
        with self._write_lock:
            for (path, length), is_pad in zip(self.files, self.pad_file):
                file_end = file_start + length
                if offset + cursor < file_end and offset + len(data) > file_start:
                    begin_in_file = max(offset + cursor - file_start, 0)
                    take = min(file_end - (offset + cursor), len(data) - cursor)
                    if not is_pad:  # BEP 47: padding never reaches disk
                        os.makedirs(os.path.dirname(path), exist_ok=True)
                        with open(path, "r+b" if os.path.exists(path) else "wb") as sink:
                            sink.seek(begin_in_file)
                            sink.write(data[cursor : cursor + take])
                    cursor += take
                    if cursor == len(data):
                        break
                file_start = file_end
            self.have[index] = True
        metrics.GLOBAL.add("torrent_pieces_verified")
        metrics.GLOBAL.add("torrent_bytes_downloaded", len(data))
        # outside the write lock, like the observers below: the span
        # report may hand a fully-covered part to the upload pool, and
        # that submission must not serialize piece writes
        self._report_verified(index)
        # notify outside the write lock: observers hit the network (HAVE
        # broadcasts) and must not serialize piece writes behind a slow
        # remote's socket
        for callback in list(self._observers):
            callback(index)
