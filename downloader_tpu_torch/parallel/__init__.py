"""The compute path: batched piece digests on the card.

The only compute in the service is SHA-1 verification of BitTorrent
pieces. Pieces are packed on the host into padded message blocks
(pack.py), shipped to the device and hashed there by a hand-written
CUDA kernel (sha1_cuda.py, csrc/sha1.cu), one thread per piece; the
plain PyTorch version beside it (sha1.py) runs on tensors on the CPU.
mesh.py compares digests with the expected ones and splits a batch
across devices. ``DigestEngine`` (engine.py) is the facade the rest of
the package uses.
"""

from .engine import DigestEngine, default_engine
from .mesh import verify_step
from .pack import pack_bytes, pack_pieces, to_gpu_layout
from .sha1_cuda import sha1_states

__all__ = [
    "DigestEngine",
    "default_engine",
    "pack_bytes",
    "pack_pieces",
    "sha1_states",
    "to_gpu_layout",
    "verify_step",
]
