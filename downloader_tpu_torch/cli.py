"""Command-line interface.

``python -m downloader_tpu_torch download-once`` runs one job end-to-end
with no broker — download → scan → upload — the minimum slice of the
reference's pipeline (cmd/downloader/downloader.go:116-147 without the
AMQP wrapper), as ``python -m downloader_tpu download-once`` does.
A job takes a magnet URI, an http(s) URL of a ``.torrent`` file, or a
plain http(s) URL. ``python -m downloader_tpu_torch serve`` runs the
queue-driven daemon in one process; the fleet (``--workers N`` with
N > 1) is not in this build and exits 2.

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
from .utils import configure_from_env, get_logger, tracing
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

    serve = sub.add_parser("serve", help="run the queue-driven daemon")
    # flag defaults come FROM the documented env contract: a fleet
    # supervisor (or an operator) configuring BUCKET/DOWNLOAD_DIR in
    # the environment must not be silently overridden by the argparse
    # defaults riding every `serve` invocation
    serve.add_argument(
        "--base-dir",
        default=os.environ.get("DOWNLOAD_DIR")
        or os.path.join(os.getcwd(), "downloading"),
    )
    serve.add_argument(
        "--bucket", default=os.environ.get("BUCKET", DEFAULT_BUCKET)
    )
    serve.add_argument(
        "--concurrency",
        type=int,
        default=int(os.environ.get("JOB_CONCURRENCY", "1")),
        help="parallel job workers (reference fixes this at 1, cmd:100-103)",
    )
    serve.add_argument(
        "--workers",
        type=int,
        default=int(os.environ.get("FLEET_WORKERS", "0")),
        help="worker processes; 0/1 = single process (default). The "
        "crash-only fleet (N > 1) is not in this build and exits 2",
    )
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


def _dht_bootstrap_from_env() -> tuple[tuple[str, int], ...] | None:
    """DHT_BOOTSTRAP env: unset/empty = BEP 5 default routers;
    "off" disables DHT; otherwise "host:port,host:port"."""
    from .fetch.magnet import parse_hostport

    raw = os.environ.get("DHT_BOOTSTRAP", "").strip()
    if not raw:
        return None
    if raw.lower() in ("off", "none", "disabled", "0"):
        return ()
    nodes = []
    for part in raw.split(","):
        node = parse_hostport(part)
        if node is not None:
            nodes.append(node)
        else:
            log.with_fields(entry=part.strip()).warning(
                "ignoring malformed DHT_BOOTSTRAP entry (want host:port)"
            )
    if not nodes:
        # a fully-malformed value must not silently become the
        # disable-DHT sentinel (); fall back to the defaults loudly
        log.warning(
            "DHT_BOOTSTRAP had no usable host:port entries; using defaults"
        )
        return None
    return tuple(nodes)


def _encryption_from_env() -> str:
    """PEER_ENCRYPTION env: MSE policy off|allow|prefer|require
    (default allow — accept both inbound, plaintext-first outbound
    with MSE fallback, matching anacrolix's default posture)."""
    from .fetch.peerwire import ENCRYPTION_MODES

    raw = os.environ.get("PEER_ENCRYPTION", "").strip().lower()
    if not raw:
        return "allow"
    if raw not in ENCRYPTION_MODES:
        log.with_fields(value=raw).warning(
            "unknown PEER_ENCRYPTION (want off|allow|prefer|require); "
            "using 'allow'"
        )
        return "allow"
    return raw


def _transport_from_env() -> str:
    """PEER_TRANSPORT env: outbound transport policy tcp|utp|both
    (default both — TCP first with uTP fallback, the posture the
    reference gets from anacrolix)."""
    from .fetch.peerwire import TRANSPORT_MODES

    raw = os.environ.get("PEER_TRANSPORT", "").strip().lower()
    if not raw:
        return "both"
    if raw not in TRANSPORT_MODES:
        log.with_fields(value=raw).warning(
            "unknown PEER_TRANSPORT (want tcp|utp|both); using 'both'"
        )
        return "both"
    return raw


def _announce_all_from_env() -> bool:
    """TRACKER_ANNOUNCE env: 'tiered' (default — BEP 12 tier order,
    per-tier shuffle, promote-on-success) or 'all' (announce to every
    tracker concurrently; bounded latency when most are dead)."""
    raw = os.environ.get("TRACKER_ANNOUNCE", "").strip().lower()
    if raw in ("", "tiered"):
        return False
    if raw == "all":
        return True
    log.with_fields(value=raw).warning(
        "unknown TRACKER_ANNOUNCE (want tiered|all); using 'tiered'"
    )
    return False


def _default_backends(
    shared_dht: bool = False,
    http_segments: int | None = None,
    http_pool_per_host: int | None = None,
    http_pool_idle: float | None = None,
):
    """The BitTorrent backend, then the HTTP backend, each with its knobs
    read from the env (DHT_BOOTSTRAP / PEER_ENCRYPTION / PEER_TRANSPORT /
    LSD / TRACKER_ANNOUNCE; HTTP_SEGMENTS / HTTP_POOL_* / ZEROCOPY).

    ``shared_dht=True`` (the daemon) keeps ONE process-lifetime DHT
    node across jobs, with optional routing-table persistence via
    DHT_STATE_PATH; the one-shot CLI keeps per-job construction like
    the reference's per-job client (torrent.go:43-44). The HTTP knobs
    default to the env (HTTP_SEGMENTS / HTTP_POOL_*); the daemon passes
    its Config's resolved values instead so serve() has one source of
    truth. The torrent backend's module is light: the swarm engine, and
    with it the digest engine, loads only when a torrent job runs."""
    from .fetch.torrent import TorrentBackend
    from .utils import flag_from_env, zero_copy_from_env

    # torrent first, then http, matching the reference's registration order
    # (cmd/downloader/downloader.go:87-90)
    return [
        TorrentBackend(
            dht_bootstrap=_dht_bootstrap_from_env(),
            encryption=_encryption_from_env(),
            transport=_transport_from_env(),
            # LSD env: "off" disables BEP 14 multicast discovery
            lsd=flag_from_env("LSD"),
            announce_all=_announce_all_from_env(),
            shared_dht=shared_dht,
            dht_state_path=(
                os.environ.get("DHT_STATE_PATH") or None
            ) if shared_dht else None,
        ),
        HTTPBackend(
            zero_copy=zero_copy_from_env(),
            segments=http_segments,
            pool_per_host=http_pool_per_host,
            pool_idle=http_pool_idle,
        ),
    ]


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
            if args.workers and args.workers > 1:
                log.with_fields(workers=args.workers).error(
                    "the crash-only fleet is not available in this build; "
                    "run serve without --workers"
                )
                return 2
            from .daemon.app import serve

            return serve(
                base_dir=os.path.abspath(args.base_dir),
                bucket=args.bucket,
                concurrency=args.concurrency,
            )
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
