"""downloader_tpu_torch — the downloader service on PyTorch and CUDA.

A port of ``downloader_tpu`` (the JAX package, which stays as the
reference) to an NVIDIA H100. Subpackages keep the reference's layout
and module names, so every file here has its twin at the same relative
path. What is ported so far:

- ``parallel`` — packing, the CUDA SHA-1 kernel and its plain PyTorch
  version, verification, and the ``DigestEngine`` facade;
- ``fetch``    — the HTTP backend (HEAD probe, striped segments,
  resume, the small-object lane) behind ``DispatchClient``; bencode,
  metainfo parsing, ``PieceStore`` (resume re-verification),
  ``_PieceBatch`` (live verification) and ``make_torrent``;
- ``scan``     — the media scanner;
- ``store``    — SigV4, the S3 client (single PUT and multipart), the
  in-process S3 stub and the uploader;
- ``utils``    — logging, cancellation, failpoints, metrics, span
  tracing, socket waits, the watchdog, and the parts of the flow,
  admission, profiling and incident planes the transfer path calls;
- ``cli``      — ``python -m downloader_tpu_torch download-once``: one
  job (download, scan, upload) with no broker.

The digest entry points run on the card unless the caller passes
``device="cpu"``; the HTTP job path does no device work.
"""

__version__ = "0.1.0"
