"""Command-line interface.

``python -m downloader_tpu_torch download-once`` runs one job end-to-end
with no broker — download → scan → upload — the minimum slice of the
reference's pipeline (cmd/downloader/downloader.go:116-147 without the
AMQP wrapper), as ``python -m downloader_tpu download-once`` does.
``serve`` exits 2 until the port has the queue-driven daemon.

The reference's single CLI flag is ``-cpuprofile`` writing a pprof CPU
profile (cmd/downloader/downloader.go:26,32-43); ``--cpuprofile`` here
writes a cProfile dump readable with ``python -m pstats``.
``--trace-out FILE`` dumps the per-job span trees (utils/tracing.py) as
Chrome trace-event JSON on exit — load it in chrome://tracing or
Perfetto to see where each job's wall-clock went.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import sys

from .fetch import DispatchClient, HTTPBackend
from .scan import scan_dir
from .store import Uploader
from .utils import configure_from_env, get_logger, tracing, zero_copy_from_env
from .utils.cancel import CancelToken

log = get_logger("cli")

DEFAULT_BUCKET = "triton-staging"  # reference cmd/downloader/downloader.go:95


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="downloader_tpu_torch")
    parser.add_argument(
        "--cpuprofile", default="", help="write a cProfile dump to this file"
    )
    parser.add_argument(
        "--trace-out",
        default="",
        help="write per-job span traces as Chrome trace-event JSON "
        "(chrome://tracing / Perfetto) to this file on exit",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    once = sub.add_parser(
        "download-once", help="run one job (download, scan, upload) with no broker"
    )
    once.add_argument("--id", required=True, help="media id for the job")
    once.add_argument("--url", required=True, help="source URI to download")
    once.add_argument(
        "--base-dir",
        default=os.path.join(os.getcwd(), "downloading"),
        help="directory jobs download into (default: ./downloading)",
    )
    once.add_argument("--bucket", default=DEFAULT_BUCKET)
    once.add_argument(
        "--skip-upload",
        action="store_true",
        help="stop after scan (no S3_ENDPOINT needed)",
    )

    # the daemon's options (--base-dir, --bucket, --concurrency,
    # --workers) come with the daemon; until then `serve` exits 2
    sub.add_parser("serve", help="run the queue-driven daemon (not in this build)")
    return parser


def _download_once(args: argparse.Namespace) -> int:
    token = CancelToken()
    base_dir = os.path.abspath(args.base_dir)
    dispatcher = DispatchClient(token, base_dir, _default_backends())

    # one-shot runs get the same span tree as daemon jobs (minus the
    # queue stages), so --trace-out answers "where did the time go"
    # for a single job without standing up the broker
    with tracing.TRACER.job(args.id) as trace:
        with tracing.span("fetch", url=tracing.redact_url(args.url)):
            job_dir = dispatcher.download(args.id, args.url)
        with tracing.span("scan"):
            files = scan_dir(job_dir)
        log.with_fields(count=len(files)).info("found media files")
        for path in files:
            print(path)

        if args.skip_upload:
            trace.set_status("ok")
            return 0

        uploader = Uploader.from_env(args.bucket)
        with tracing.span("upload", files=len(files)):
            result = uploader.upload_files(token, args.id, files)
        log.with_fields(
            uploaded=len(result.uploaded), failed=len(result.failed)
        ).info("upload complete")
        trace.set_status("ok" if not result.failed else "failed")
    return 0 if not result.failed else 1


def _default_backends():
    """The HTTP backend, its knobs read from the env (HTTP_SEGMENTS /
    HTTP_POOL_* / ZEROCOPY).

    The port registers the HTTP backend only: the BitTorrent backend and
    its env readers (DHT_BOOTSTRAP, PEER_ENCRYPTION, PEER_TRANSPORT,
    TRACKER_ANNOUNCE, LSD) come with the torrent engine. Until then a
    ``magnet:`` or ``.torrent`` URL fails with UnsupportedJobError."""
    return [HTTPBackend(zero_copy=zero_copy_from_env())]


def main(argv: list[str] | None = None) -> int:
    configure_from_env()
    args = _build_parser().parse_args(argv)

    # honor the documented tracing knobs on EVERY command — serve()
    # re-applies them from Config, but one-shot runs come through here
    from .utils import flag_from_env

    tracing.TRACER.enabled = flag_from_env("TRACE")
    tracing.TRACER.set_capacity(
        tracing.ring_from_value(
            os.environ.get("TRACE_RING"), tracing.DEFAULT_RING
        )
    )

    profiler = None
    if args.cpuprofile:
        profiler = cProfile.Profile()
        profiler.enable()
        log.info("started cpu profiler")

    try:
        if args.command == "download-once":
            return _download_once(args)
        if args.command == "serve":
            log.error("the queue-driven daemon is not available in this build")
            return 2
        raise AssertionError(f"unhandled command {args.command}")
    except Exception as exc:  # surface a clean error, not a traceback
        log.error("job failed", exc=exc)
        return 1
    finally:
        if profiler is not None:
            profiler.disable()
            profiler.dump_stats(args.cpuprofile)
            log.info(f"wrote cpu profile to {args.cpuprofile}")
        if args.trace_out:
            try:
                with open(args.trace_out, "w") as sink:
                    json.dump(tracing.TRACER.chrome_trace(), sink)
                log.info(f"wrote chrome trace to {args.trace_out}")
            except OSError as exc:
                log.error("failed to write trace file", exc=exc)


if __name__ == "__main__":
    sys.exit(main())
