"""Host-side packing: raw pieces → padded SHA-1 message blocks in the
layout the CUDA kernel reads.

SHA-1 consumes 64-byte blocks of big-endian 32-bit words after the
FIPS 180-4 padding (0x80, zeros, 64-bit bit length). A batch of P pieces
travels in two forms:

- **shipped**: ``raw`` (P, B*64) uint8, each row one piece's padded
  message bytes. Rows are contiguous, so a split of the batch across
  devices is a slice of rows, and the host writes each piece with one
  copy (into pinned memory when the target is a CUDA device).
- **GPU layout**: ``blocks`` (B, 16, P) of 32-bit words holding the
  big-endian word values, word-major with the pieces contiguous, so the
  32 threads of a warp read 32 neighbouring words.
  :func:`to_gpu_layout` turns shipped bytes into it on the device.

Tensors carry the words as ``torch.int32`` (the same bits), because
torch's uint32 support is thin; numpy views them as ``uint32``.

The ``from_reference_*`` helpers turn the JAX package's packed arrays
(flat ``(P, B, 16)`` and tiled ``(T, B, 16, 8, 128)``) and its digest
outputs into this layout, so tests can feed both packages identical
arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

H0 = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def block_count(length: int) -> int:
    """SHA-1 block count for a message of ``length`` bytes after FIPS
    180-4 padding. The engine's cost model prices shipped arrays with
    this same formula."""
    return (length + 9 + 63) // 64


def pad_piece(piece: bytes) -> np.ndarray:
    """Pad one message per FIPS 180-4 → (B, 16) big-endian uint32 words."""
    length = len(piece)
    num_blocks = block_count(length)
    buf = np.zeros(num_blocks * 64, dtype=np.uint8)
    buf[:length] = np.frombuffer(piece, dtype=np.uint8)
    buf[length] = 0x80
    bit_length = np.array([length * 8], dtype=">u8")
    buf[-8:] = np.frombuffer(bit_length.tobytes(), dtype=np.uint8)
    words = buf.view(">u4").astype(np.uint32)
    return words.reshape(num_blocks, 16)


def max_blocks(pieces: Sequence[bytes]) -> int:
    """B of a batch: the largest padded block count (1 for no pieces)."""
    return max((block_count(len(p)) for p in pieces), default=1)


def pack_bytes(
    pieces: Sequence[bytes], out: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pad every piece into one row of a (P, B*64) uint8 array.

    ``out``, when given, is that array already allocated (for example a
    numpy view of a pinned host tensor) and is filled in place; its
    contents beforehand do not matter. Returns ``(raw, nblocks)`` with
    ``nblocks`` (P,) int32. Bytes past a piece's own padded blocks are
    zero, as in the JAX package's packing.
    """
    count = len(pieces)
    width = max_blocks(pieces) * 64
    if out is None:
        raw = np.zeros((count, width), dtype=np.uint8)
    else:
        if out.shape != (count, width) or out.dtype != np.uint8:
            raise ValueError(
                f"pack buffer must be ({count}, {width}) uint8, got "
                f"{out.shape} {out.dtype}"
            )
        raw = out
    nblocks = np.empty(count, dtype=np.int32)
    for lane, piece in enumerate(pieces):
        length = len(piece)
        end = block_count(length) * 64
        row = raw[lane]
        row[:length] = np.frombuffer(piece, dtype=np.uint8)
        row[length] = 0x80
        row[length + 1 : end - 8] = 0
        row[end - 8 : end] = np.frombuffer(
            (length * 8).to_bytes(8, "big"), dtype=np.uint8
        )
        if out is not None:
            row[end:] = 0
        nblocks[lane] = end // 64
    return raw, nblocks


def to_gpu_layout(raw: torch.Tensor) -> torch.Tensor:
    """Shipped bytes (P, B*64) uint8 → (B, 16, P) int32 word values, on
    whatever device ``raw`` lies on. Reversing each 4-byte group turns a
    big-endian word into the little-endian int32 with the same value."""
    count, width = raw.shape
    num_blocks = width // 64
    swapped = raw.view(count, num_blocks, 16, 4).flip(-1)
    return (
        swapped.permute(1, 2, 0, 3)
        .contiguous()
        .view(torch.int32)
        .view(num_blocks, 16, count)
    )


def pack_pieces(pieces: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pack pieces straight into the GPU layout on the host:
    ``(blocks (B, 16, P) uint32, nblocks (P,) int32)``."""
    raw, nblocks = pack_bytes(pieces)
    count = raw.shape[0]
    words = raw.view(">u4").astype(np.uint32).reshape(count, -1, 16)
    return np.ascontiguousarray(words.transpose(1, 2, 0)), nblocks


def digests_to_bytes(states: np.ndarray, count: int) -> list[bytes]:
    """(5, P) state words (uint32 or their int32 bits) → ``count``
    20-byte digests."""
    words = np.ascontiguousarray(np.asarray(states).view(np.uint32).T)
    return [row.tobytes() for row in words[:count].astype(">u4")]


def expected_words(digests: Sequence[bytes]) -> np.ndarray:
    """20-byte digests → (P, 5) uint32 state words."""
    flat = np.frombuffer(b"".join(digests), dtype=">u4")
    return flat.astype(np.uint32).reshape(len(digests), 5)


# -- the JAX package's layouts --------------------------------------------

_SUBLANES = 8
_LANES = 128
_TILE = _SUBLANES * _LANES


def from_reference_flat(
    blocks: np.ndarray, nblocks: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's ``pack_pieces`` output ((P, B, 16), (P,)) →
    ``(blocks (B, 16, P) uint32, nblocks (P,) int32)``."""
    words = np.asarray(blocks, dtype=np.uint32)
    return (
        np.ascontiguousarray(words.transpose(1, 2, 0)),
        np.asarray(nblocks, dtype=np.int32).copy(),
    )


def from_reference_tiled(
    blocks: np.ndarray, nblocks: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's ``pack_pieces_tiled`` output
    ((T, B, 16, 8, 128), (T, 8, 128)) → the GPU layout over T*1024
    lanes, padding lanes included (their ``nblocks`` is 0)."""
    words = np.asarray(blocks, dtype=np.uint32)
    tiles, num_blocks = words.shape[0], words.shape[1]
    flat = words.transpose(1, 2, 0, 3, 4).reshape(
        num_blocks, 16, tiles * _TILE
    )
    return (
        np.ascontiguousarray(flat),
        np.asarray(nblocks, dtype=np.int32).reshape(tiles * _TILE).copy(),
    )


def digests_from_reference(states: np.ndarray) -> np.ndarray:
    """The JAX package's digest states, (P, 5) or tiled (T, 5, 8, 128),
    → (5, P) uint32."""
    arr = np.asarray(states, dtype=np.uint32)
    if arr.ndim == 2:
        return np.ascontiguousarray(arr.T)
    tiles = arr.shape[0]
    return np.ascontiguousarray(
        arr.transpose(1, 0, 2, 3).reshape(5, tiles * _TILE)
    )
