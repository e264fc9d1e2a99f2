"""downloader_tpu_torch — the downloader service on PyTorch and CUDA.

A port of ``downloader_tpu`` (the JAX package, which stays as the
reference) to an NVIDIA H100. Subpackages keep the reference's layout
and module names, so every file here has its twin at the same relative
path. What is ported so far:

- ``parallel`` — packing, the CUDA SHA-1 kernel and its plain PyTorch
  version, verification, and the ``DigestEngine`` facade;
- ``fetch``    — the HTTP backend (HEAD probe, striped segments,
  resume, the small-object lane) and the BitTorrent engine
  (``TorrentBackend``, the swarm, ``Seeder``) behind ``DispatchClient``;
  bencode, metainfo parsing, ``PieceStore`` (resume re-verification),
  ``_PieceBatch`` (live verification) and ``make_torrent``; the env
  readers of the fleet data plane's single-flight election;
- ``scan``     — the media scanner;
- ``store``    — SigV4, the S3 client (single PUT and multipart), the
  in-process S3 stub, the uploader and the streaming fetch→upload
  pipeline;
- ``utils``    — logging, cancellation, failpoints, metrics, span
  tracing, socket waits, and the daemon's planes: the stall watchdog,
  incidents, flows, admission, the time-series store, alerts, the
  profiler and the canary;
- ``wire``     — the ``Download``/``Convert``/``Media`` protobuf contract;
- ``queue``    — AMQP 0-9-1 (client and server stub), the memory broker,
  deliveries and the ``QueueClient``;
- ``daemon``   — configuration, the health server and the daemon;
- ``cli``      — ``python -m downloader_tpu_torch download-once``: one
  job (download, scan, upload) with no broker; ``serve``: the
  queue-driven daemon, in one process or as a fleet (``--workers N``);
- ``analysis`` — the concurrency and resource-safety analyzer over this
  package (``python -m downloader_tpu_torch.analysis``) and its runtime
  lock-order and protocol recorders.

The digest entry points run on the card unless the caller passes
``device="cpu"``; the HTTP job path does no device work.
"""

__version__ = "0.1.0"
