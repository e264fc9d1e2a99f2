"""downloader_tpu_torch — the downloader service on PyTorch and CUDA.

A port of ``downloader_tpu`` (the JAX package, which stays as the
reference) to an NVIDIA H100. Subpackages keep the reference's layout
and module names, so every file here has its twin at the same relative
path. What is ported so far is the piece hashing and verification path:

- ``parallel`` — packing, the CUDA SHA-1 kernel and its plain PyTorch
  version, verification, and the ``DigestEngine`` facade;
- ``fetch``    — bencode, metainfo parsing, ``PieceStore`` (resume
  re-verification), ``_PieceBatch`` (live verification) and
  ``make_torrent``;
- ``utils``    — logging, counters, watchdog heartbeats and the flow
  ledger's unique-bytes half.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
