"""Batched SHA-1 in plain PyTorch: the reference version of the CUDA
kernel (parallel/csrc/sha1.cu).

It computes the same function as the kernel on the same layout
(parallel/pack.py): every operation is vectorised over the piece axis,
the loops run over blocks and the 80 rounds, and a piece's state
freezes once ``b >= nblocks[p]``, so a short final piece batches with
full-size ones. The CPU tests use it, the kernel wrapper takes it for
tensors that lie on the CPU, and the card's smoke run holds the kernel
against it.

torch has no uint32 add, shift, not or compare on the CPU, so the
words are widened to int64 and every result is cut back to 32 bits
with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

import torch

from .pack import H0

_MASK = 0xFFFFFFFF
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & _MASK) | (x >> (32 - n))


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → int32 tensors with the same bits."""
    return (((x + 2**31) & _MASK) - 2**31).to(torch.int32)


def sha1_states(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Digest a packed batch.

    ``blocks``: (B, 16, P) int32 big-endian word values; ``nblocks``:
    (P,) int32 valid block count per piece. Returns (5, P) int32 final
    state words on the same device (H0 for pieces with no blocks).
    """
    num_blocks, _, count = blocks.shape
    device = blocks.device
    state = torch.tensor(H0, dtype=torch.int64, device=device)
    state = state[:, None].expand(5, count).clone()
    counts = nblocks.to(torch.int64)
    for b in range(num_blocks):
        live = counts > b
        if not bool(live.any()):
            break
        w = [blocks[b, t].to(torch.int64) & _MASK for t in range(16)]
        a, bb, c, d, e = state.unbind(0)
        for t in range(80):
            if t < 16:
                w_t = w[t]
            else:
                w_t = _rotl(
                    w[(t + 13) % 16] ^ w[(t + 8) % 16] ^ w[(t + 2) % 16]
                    ^ w[t % 16],
                    1,
                )
                w[t % 16] = w_t
            if t < 20:
                f = d ^ (bb & (c ^ d))
            elif t < 40 or t >= 60:
                f = bb ^ c ^ d
            else:
                f = (bb & c) | (d & (bb | c))
            temp = (_rotl(a, 5) + f + e + _K[t // 20] + w_t) & _MASK
            a, bb, c, d, e = temp, a, _rotl(bb, 30), c, d
        new_state = (state + torch.stack([a, bb, c, d, e])) & _MASK
        state = torch.where(live, new_state, state)
    return _to_int32_bits(state)
