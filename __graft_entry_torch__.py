"""Entry points of the PyTorch/CUDA port: the single-card check and the
multi-card dry run. The twin of ``__graft_entry__.py``.

The reference (tritonmedia/downloader-go) is an I/O microservice with no
model (SURVEY.md §0); the port's compute path is batched SHA-1 piece
verification (downloader_tpu_torch/parallel). ``entry()`` returns the
batched digest function and example arguments on the card;
``dryrun_multichip(n)`` splits one verify step over ``n`` cards — every
card digests and compares its shard of the pieces, and the mismatch
counts are summed — on tiny shapes.

There is no CPU stand-in for missing cards: with fewer than ``n`` CUDA
devices ``dryrun_multichip`` raises. ``device="cpu"`` runs the plain
PyTorch SHA-1 on the host (``n`` CPU shards), for the tests only.

    python3 __graft_entry_torch__.py [N]   # N cards, default 8
"""

from __future__ import annotations

import os


def _devices(n_devices: int, device=None) -> list:
    """``n_devices`` devices: the first CUDA cards, or ``device`` repeated."""
    import torch

    if device is not None:
        return [torch.device(device)] * n_devices
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if available < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {available}")
    return [torch.device("cuda", index) for index in range(n_devices)]


def entry(device=None):
    """Return (fn, example_args) for the single-card check.

    The fn is the batched SHA-1 digest: (B, 16, P) int32 padded message
    blocks + (P,) int32 valid-block counts → (5, P) int32 state words.
    """
    import numpy as np
    import torch

    from downloader_tpu_torch.parallel.pack import pack_pieces
    from downloader_tpu_torch.parallel.sha1_cuda import sha1_states

    (target,) = _devices(1, device)
    blocks, nblocks = pack_pieces([bytes([i]) * (1024 + i) for i in range(8)])
    return sha1_states, (
        torch.from_numpy(blocks.view(np.int32)).to(target),
        torch.from_numpy(nblocks).to(target),
    )


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Split one verify step over ``n_devices`` devices and run it on
    tiny shapes.

    Cuts the pieces into one contiguous shard per device (data
    parallelism, the only parallelism this workload has, SURVEY.md §2),
    verifies each shard on its device and sums the mismatch counts.
    """
    import hashlib

    import numpy as np
    import torch

    from downloader_tpu_torch.parallel.mesh import verify_split
    from downloader_tpu_torch.parallel.pack import expected_words, pack_bytes

    devices = _devices(n_devices, device)
    pieces = [os.urandom(256) for _ in range(2 * n_devices)]
    raw, nblocks = pack_bytes(pieces)
    expected = expected_words([hashlib.sha1(piece).digest() for piece in pieces])
    expected[1] ^= 1  # one deliberate mismatch to exercise the sum
    ok, mismatches = verify_split(
        torch.from_numpy(raw),
        torch.from_numpy(nblocks),
        torch.from_numpy(expected.view(np.int32)),
        devices,
    )
    ok = ok.numpy()
    if mismatches != 1 or ok[1] or not ok[0]:
        raise AssertionError(
            f"split verify wrong: mismatches={mismatches}, ok={ok}"
        )
    print(
        f"dryrun_multichip OK: {len(pieces)} pieces over {n_devices} "
        f"{devices[0].type} devices, summed mismatch count = {mismatches}"
    )


if __name__ == "__main__":
    import sys

    count = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dryrun_multichip(count)
