"""Piece verification, on one device or split across several.

:func:`verify_step` is the counterpart of the JAX package's
``mesh.verify_step``: digest a packed batch, compare with the expected
state words, and return the ``ok`` mask and the mismatch count.

:func:`digest_split` / :func:`verify_split` take the place of its
``shard_map`` + ``psum`` wrappers: the batch's pieces are cut into one
contiguous shard per device, each shard's shipped bytes go to its
device, are laid out and hashed there (every launch is queued before
any result is read back, so devices run at once), and the per-shard
mismatch counts are summed on the host. One H100 is one shard.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .pack import to_gpu_layout
from .sha1_cuda import sha1_states


def verify_step(
    blocks: torch.Tensor, nblocks: torch.Tensor, expected: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Digest a batch and compare against expected digests.

    ``blocks`` (B, 16, P) and ``nblocks`` (P,) int32 as in pack.py;
    ``expected`` (P, 5) int32 state words (anything for padding lanes).
    Returns ``(ok, mismatches)``: ``ok`` a (P,) bool mask, True for
    padding lanes (``nblocks == 0``), and ``mismatches`` the scalar count
    of real lanes whose digest differed.
    """
    digests = sha1_states(blocks, nblocks)
    live = nblocks > 0
    matches = (digests.T == expected).all(dim=1)
    ok = matches | ~live
    mismatches = (live & ~matches).sum()
    return ok, mismatches


def _shards(count: int, devices: Sequence[torch.device]) -> list[tuple[int, int]]:
    """Contiguous [lo, hi) piece ranges, one per device (some may be
    empty when there are fewer pieces than devices)."""
    bounds = np.linspace(0, count, len(devices) + 1).round().astype(int)
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


def _per_shard(fn, raw: torch.Tensor, devices: Sequence[torch.device], *rows):
    """Ship each device its rows of ``raw`` (laid out there) and of each
    of ``rows``, and queue ``fn(blocks, *shard_rows)`` on it; returns the
    per-shard results, none of them read back yet."""
    pending = []
    for device, (lo, hi) in zip(devices, _shards(raw.shape[0], devices)):
        if hi > lo:
            shipped = [
                array[lo:hi].to(device, non_blocking=array.is_pinned())
                for array in (raw, *rows)
            ]
            pending.append(fn(to_gpu_layout(shipped[0]), *shipped[1:]))
    return pending


def digest_split(
    raw: torch.Tensor, nblocks: torch.Tensor, devices: Sequence[torch.device]
) -> torch.Tensor:
    """Shipped bytes (P, B*64) uint8 and (P,) int32 counts on the host →
    (5, P) int32 states on the host, computed across ``devices``."""
    pending = _per_shard(sha1_states, raw, devices, nblocks)
    return torch.cat([states.cpu() for states in pending], dim=1)


def verify_split(
    raw: torch.Tensor,
    nblocks: torch.Tensor,
    expected: torch.Tensor,
    devices: Sequence[torch.device],
) -> tuple[torch.Tensor, int]:
    """Like :func:`verify_step` over shipped bytes, split across
    ``devices``: returns the (P,) bool ``ok`` mask on the host and the
    mismatch count summed over the shards."""
    pending = _per_shard(verify_step, raw, devices, nblocks, expected)
    ok = torch.cat([shard_ok.cpu() for shard_ok, _ in pending])
    return ok, sum(int(count) for _, count in pending)
