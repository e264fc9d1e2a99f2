"""End-to-end benchmark of the PyTorch/CUDA port: queue-driven
fetch→scan→upload throughput. The twin of ``bench.py``, over
``downloader_tpu_torch``.

The reference publishes no numbers (BASELINE.md), so the baseline
measured here is the reference's own CONFIGURATION run on the port:
effective job concurrency 1 (prefetch 1 + a single job goroutine,
reference cmd/downloader/downloader.go:62,100-103), userspace copies
(the reference's Go grab and minio-go stream through io.Copy) and one
HTTP connection per transfer. The headline value is the same pipeline
at the port's defaults (N concurrent workers, splice/sendfile
zero-copy); ``vs_baseline`` is the speedup over the reference-shaped
run.

Everything is hermetic and local: a threaded HTTP file server as the
source, the in-memory at-least-once broker as the queue, and the port's
S3 stub as the object store, so the number measures the port (dispatch,
verification, disk, upload path), not the network. The pipeline rig is
``hack/pipeline_torch.py``'s ``Pipeline``; the profiling arm is its
``run_profile_arm``.

Prints exactly one JSON line on stdout:
  {"metric": "e2e_fetch_upload_MBps", "value": N, "unit": "MB/s",
   "vs_baseline": N, "extra_metrics": [...]}
Details go to stderr, ending with the one-line fold of
``bench_digest_torch.digest_line``.

Working directories live on tmpfs (/dev/shm) when available: the point
is the port's dispatch/copy/protocol overhead, and disk writeback
throttling would otherwise floor both configurations at the disk's
speed. Set BENCH_DIR to force a location.

The knobs are ``bench.py``'s, with its defaults: BENCH_JOBS (24),
BENCH_MB (MB per job, 48), BENCH_CONCURRENCY (6), BENCH_SLICES
(alternating sub-runs per pair, 4), BENCH_REPEATS (pairs, 5),
BENCH_DIR; BENCH_ABLATION=0 skips the sub-ratio ablation
(BENCH_ABLATION_REPEATS triples, 3); BENCH_PIPELINE=0 the
streaming-pipeline ablation (BENCH_PIPELINE_REPEATS pairs, 3);
BENCH_SEGMENTED=0 the segmented-fetch ablation
(BENCH_SEGMENTED_REPEATS 3, BENCH_SEGMENTED_JOBS 2,
BENCH_SEGMENTED_CONCURRENCY 2, BENCH_SEGMENT_THROTTLE_MBPS 25);
BENCH_MULTI_SOURCE=0 the multi-source racing arm (BENCH_MULTI_MB 32,
BENCH_MULTI_THROTTLE_MBPS 10, BENCH_MULTI_REPEATS 3);
BENCH_LATENCY_SAMPLES (15) tiny jobs for the per-job overhead and the
watchdog/telemetry/canary arms; BENCH_SMALL=0 the small-object arm
(BENCH_SMALL_WAVE 16, BENCH_SMALL_WAVES 3); BENCH_OVERLOAD=0 the
overload-shedding arm (BENCH_OVERLOAD_JOBS 6, BENCH_OVERLOAD_BULK 4);
BENCH_WATCHDOG=0, BENCH_TELEMETRY=0 and BENCH_CANARY=0 the
watchdog, whole-telemetry-plane and canary-plane on/off arms;
BENCH_PROFILE=0 the profiling arm (BENCH_PROFILE_JOBS 1000,
BENCH_PROFILE_DIR for its collapsed stacks and SVG); BENCH_FLEET=0
the crash-only fleet chaos arm (BENCH_FLEET_JOBS 12,
BENCH_FLEET_WORKERS 2, BENCH_FLEET_SPEC "queue.publish=fail:0.1");
BENCH_FLEETPLANE=0 the fleet debug-plane fan-out arm
(BENCH_FLEETPLANE_WORKERS 4, BENCH_FLEETPLANE_TIMEOUT_S 0.5);
BENCH_FLOW=0 the flow-accounting arm (BENCH_ZIPF_OBJECTS 16,
BENCH_ZIPF_SKEW 1.1, BENCH_ZIPF_BYTES 65536, BENCH_ZIPF_WORKERS 2,
BENCH_ZIPF_REQUESTS 0; deterministic under FAILPOINT_SEED);
BENCH_SINGLEFLIGHT=0 the single-flight arm
(BENCH_SINGLEFLIGHT_WORKERS 2, BENCH_SINGLEFLIGHT_OBJECTS 3,
BENCH_SINGLEFLIGHT_BYTES 524288, BENCH_SINGLEFLIGHT_THROTTLE_MBPS 3);
BENCH_DIGEST=0 the digest-kernel arm.

The digest arm runs ``bench_digest_torch.measure(256, 1024)`` on the
card in a child process (its own interpreter, clear of the fleet arms'
leftover threads). It has no fallback: without a card, or when the
kernel fails to build, launch or agree with hashlib, the run exits
non-zero. Every other arm is host I/O, and this process never imports
torch: with BENCH_DIGEST=0 the whole run needs no card.

On the measurement noise: host throughput swings on multi-second
timescales, and the swings hit baseline and port runs alike. The
defense is structural: alternate sub-runs so bursts land on both
configurations, take per-pair ratios so shared noise cancels, and take
the median so one unlucky pair cannot set the contract number.
"""

from __future__ import annotations

import http.server
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from downloader_tpu_torch.fetch import HTTPBackend
from downloader_tpu_torch.utils.cancel import CancelToken
from downloader_tpu_torch.wire import Convert, Download, Media
from hack.pipeline_torch import (
    Pipeline,
    _spawn_server,
    quiet_logging,
    run_profile_arm,
)

REPO = os.path.dirname(os.path.abspath(__file__))


def _log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def _bench_root() -> str | None:
    """tmpfs if available (see module docstring), else the default tmp."""
    forced = os.environ.get("BENCH_DIR")
    if forced:
        return forced
    return "/dev/shm" if os.path.isdir("/dev/shm") else None


# The origins, like the rig's payload server and S3 stub, run as CHILD
# PROCESSES: in-process they would share the GIL with the daemon's
# download/upload threads, and the measurement would degrade into GIL
# ping-pong between the pump loops. Out of process the bench measures
# the port as production runs it: peers on the other end of a socket.

# Range + HEAD capable variant for the segmented-fetch ablation, with a
# per-CONNECTION bandwidth cap: the segmented fetcher's whole value
# proposition is recovering bandwidth a single connection can't reach
# (server rate limits, congestion windows), and an unthrottled loopback
# server has no such cap to recover from. The throttle paces each
# response stream independently, so N segments stream at N x the cap.
_RANGE_SERVER = """
import http.server, os, sys, time
root, throttle_mbps = sys.argv[1], float(sys.argv[2])
class RangeQuiet(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *args): pass
    def _meta(self):
        path = os.path.join(root, os.path.basename(self.path))
        try:
            return path, os.path.getsize(path)
        except OSError:
            return None, 0
    def do_HEAD(self):
        path, size = self._meta()
        if path is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(size))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
    def do_GET(self):
        path, size = self._meta()
        if path is None:
            self.send_error(404)
            return
        lo, hi = 0, size - 1
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            a, b = rng[6:].split("-", 1)
            lo = int(a)
            hi = int(b) if b else size - 1
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
        else:
            self.send_response(200)
        length = hi - lo + 1
        self.send_header("Content-Length", str(length))
        self.end_headers()
        window = 256 * 1024
        per_window = window / (throttle_mbps * 1e6) if throttle_mbps > 0 else 0.0
        try:
            with open(path, "rb") as f:
                f.seek(lo)
                sent = 0
                while sent < length:
                    chunk = f.read(min(window, length - sent))
                    if not chunk:
                        break
                    start = time.monotonic()
                    self.wfile.write(chunk)
                    sent += len(chunk)
                    if per_window > 0:
                        wait = per_window - (time.monotonic() - start)
                        if wait > 0:
                            time.sleep(wait)
        except (BrokenPipeError, ConnectionResetError):
            pass  # endgame loser cancellation closes mid-body; expected
httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), RangeQuiet)
print(httpd.server_address[1], flush=True)
httpd.serve_forever()
"""

# Range server with an ORIGIN-AGGREGATE bandwidth cap (one token
# bucket across every connection) for the multi-source ablation: the
# per-connection throttle above is what the single-origin stripe
# defeats; a whole origin being slow — rate-limited egress, a
# saturated uplink — is what racing a SECOND origin defeats, and that
# cap must bind no matter how many connections one job opens to it.
_AGGREGATE_RANGE_SERVER = """
import http.server, os, sys, threading, time
root, throttle_mbps = sys.argv[1], float(sys.argv[2])
rate = throttle_mbps * 1e6
bucket_lock = threading.Lock()
bucket = {"at": time.monotonic(), "tokens": 0.0}
def take(n):
    if rate <= 0:
        return
    while True:
        with bucket_lock:
            now = time.monotonic()
            bucket["tokens"] = min(
                rate / 4, bucket["tokens"] + (now - bucket["at"]) * rate
            )
            bucket["at"] = now
            if bucket["tokens"] >= n:
                bucket["tokens"] -= n
                return
            short = (n - bucket["tokens"]) / rate
        time.sleep(min(short, 0.05))
class AggQuiet(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *args): pass
    def _meta(self):
        path = os.path.join(root, os.path.basename(self.path))
        try:
            return path, os.path.getsize(path)
        except OSError:
            return None, 0
    def do_HEAD(self):
        path, size = self._meta()
        if path is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(size))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
    def do_GET(self):
        path, size = self._meta()
        if path is None:
            self.send_error(404)
            return
        lo, hi = 0, size - 1
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            a, b = rng[6:].split("-", 1)
            lo = int(a)
            hi = int(b) if b else size - 1
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
        else:
            self.send_response(200)
        length = hi - lo + 1
        self.send_header("Content-Length", str(length))
        self.end_headers()
        window = 256 * 1024
        try:
            with open(path, "rb") as f:
                f.seek(lo)
                sent = 0
                while sent < length:
                    chunk = f.read(min(window, length - sent))
                    if not chunk:
                        break
                    take(len(chunk))
                    self.wfile.write(chunk)
                    sent += len(chunk)
        except (BrokenPipeError, ConnectionResetError):
            pass  # endgame loser / failover cancellation; expected
httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), AggQuiet)
print(httpd.server_address[1], flush=True)
httpd.serve_forever()
"""


def _pipeline(concurrency: int, prefetch: int, site: str, **kwargs) -> Pipeline:
    """The port's hermetic pipeline (``hack/pipeline_torch.py``) with its
    working directory under the bench root."""
    return Pipeline(concurrency, prefetch, site, root=_bench_root(), **kwargs)


def run_config(
    jobs: int,
    mb_per_job: int,
    concurrency: int,
    prefetch: int,
    site: str,
    zero_copy: bool = True,
    **pipeline_kwargs,
) -> tuple[float, float]:
    """Drain ``jobs`` download jobs through the full daemon pipeline;
    returns (MB moved, seconds) end-to-end (first enqueue → last
    Convert consumed) so callers can aggregate across runs."""
    pipeline = _pipeline(
        concurrency, prefetch, site, zero_copy=zero_copy, **pipeline_kwargs
    )
    try:
        start = time.monotonic()
        for i in range(jobs):
            pipeline.publish_job(i)
        pipeline.wait_converts(jobs)
        elapsed = time.monotonic() - start
        return jobs * mb_per_job, elapsed
    finally:
        pipeline.close()


def run_ablation(
    jobs: int,
    mb_per_job: int,
    concurrency: int,
    site: str,
    repeats: int,
) -> dict:
    """Decompose the headline into two FIXED sub-ratios so the combined
    figure is separable (the headline otherwise conflates "we lifted
    the reference's single-goroutine limit" with "our data path is
    faster"):

    - ``data_path_ratio_c1``: zero-copy vs userspace copies, BOTH at
      concurrency 1 — isolates the splice/sendfile data-path win
      against the reference's io.Copy shape at the reference's own
      concurrency (cmd/downloader/downloader.go:62,100-103).
    - ``concurrency_ratio_zero_copy``: concurrency N vs 1, zero-copy
      fixed on both sides — isolates the concurrency win.

    Same noise defense as the headline: the three configurations run
    interleaved (A B C per triple) so a noise burst lands on all
    three, per-triple ratios cancel shared noise, and the median is
    reported."""
    configs = (
        # all three arms pin http_segments=1: these ratios isolate the
        # data path and the concurrency lift; the segmented stripe has
        # its own ablation (run_segmented_ablation)
        ("userspace_c1", dict(concurrency=1, prefetch=1, zero_copy=False)),
        ("zerocopy_c1", dict(concurrency=1, prefetch=1, zero_copy=True)),
        ("zerocopy_cN", dict(
            concurrency=concurrency, prefetch=concurrency, zero_copy=True
        )),
    )
    triples: list[dict] = []
    for i in range(repeats):
        rates: dict[str, float] = {}
        for name, kwargs in configs:
            moved, took = run_config(
                jobs,
                mb_per_job,
                kwargs["concurrency"],
                kwargs["prefetch"],
                site,
                zero_copy=kwargs["zero_copy"],
                http_segments=1,
            )
            rates[name] = moved / took
        triples.append(
            {
                "MBps": {k: round(v, 1) for k, v in rates.items()},
                "data_path_ratio_c1": round(
                    rates["zerocopy_c1"] / rates["userspace_c1"], 2
                ),
                "concurrency_ratio_zero_copy": round(
                    rates["zerocopy_cN"] / rates["zerocopy_c1"], 2
                ),
            }
        )
        _log(
            f"bench: ablation triple {i + 1}: "
            f"userspace_c1 {rates['userspace_c1']:.1f} MB/s, "
            f"zerocopy_c1 {rates['zerocopy_c1']:.1f} MB/s, "
            f"zerocopy_c{concurrency} {rates['zerocopy_cN']:.1f} MB/s "
            f"-> data-path {triples[-1]['data_path_ratio_c1']:.2f}x, "
            f"concurrency {triples[-1]['concurrency_ratio_zero_copy']:.2f}x"
        )

    def median_of(key: str) -> float:
        ordered = sorted(triple[key] for triple in triples)
        return ordered[len(ordered) // 2]

    return {
        "metric": "ablation",
        "data_path_ratio_c1": median_of("data_path_ratio_c1"),
        "concurrency_ratio_zero_copy": median_of(
            "concurrency_ratio_zero_copy"
        ),
        "concurrency": concurrency,
        "triples": triples,
    }


def run_pipeline_ablation(
    jobs: int,
    mb_per_job: int,
    concurrency: int,
    site: str,
    repeats: int,
) -> dict:
    """The streaming-pipeline ablation: pipelined (multipart parts ship
    while the fetch runs) vs store-and-forward (fetch completes, then
    upload), INTERLEAVED pairs with per-pair ratios and the median
    reported — the same noise defense as the headline.

    Both arms run the identical multipart shape (threshold/part size
    pinned small enough that the bench payload takes the multipart
    path), so the ratio isolates the overlap itself rather than
    conflating it with single-PUT-vs-multipart differences."""
    part_mb = 8 * 1024 * 1024
    arms = dict(
        concurrency=concurrency,
        prefetch=concurrency,
        multipart_threshold=part_mb,
        part_size=part_mb,
    )
    pairs: list[dict] = []
    for i in range(repeats):
        moved, took = run_config(
            jobs, mb_per_job, site=site, pipeline=False, **arms
        )
        store_forward = moved / took
        moved, took = run_config(
            jobs,
            mb_per_job,
            site=site,
            pipeline=True,
            part_workers=concurrency,
            **arms,
        )
        pipelined = moved / took
        pairs.append(
            {
                "MBps": {
                    "store_and_forward": round(store_forward, 1),
                    "pipelined": round(pipelined, 1),
                },
                "ratio": round(pipelined / store_forward, 2),
            }
        )
        _log(
            f"bench: pipeline pair {i + 1}: store-and-forward "
            f"{store_forward:.1f} MB/s, pipelined {pipelined:.1f} MB/s, "
            f"ratio {pairs[-1]['ratio']:.2f}"
        )
    ordered = sorted(pair["ratio"] for pair in pairs)
    return {
        "metric": "pipeline_overlap",
        "pipelined_vs_store_forward": ordered[len(ordered) // 2],
        "part_size_mb": part_mb // (1024 * 1024),
        "concurrency": concurrency,
        "pairs": pairs,
    }


def run_segmented_ablation(
    jobs: int,
    mb_per_job: int,
    concurrency: int,
    site: str,
    repeats: int,
) -> dict:
    """The segmented-fetch ablation: segmented (HTTP_SEGMENTS default)
    vs single-stream (segments pinned to 1), both against the in-tree
    Range-capable test server with a per-CONNECTION bandwidth cap — the
    condition the stripe exists to beat. Two object sizes per arm:

    - ``large``: the striped case; N ranges stream concurrently so the
      per-connection cap stops bounding the job.
    - ``small``: under the 2x-minimum-segment threshold, so the probe
      declines and the segmented arm must cost no more than
      single-stream (fallback is the whole point of the adaptive
      default).

    Reports per-arm wall seconds + MB/s, the streaming pipeline's
    overlap ratio, and the pool/segment counters, all as deltas of
    metrics.GLOBAL around each arm (the daemon runs in-process).
    Interleaved repeats, median ratios — the standard noise defense."""
    from downloader_tpu_torch.utils import metrics as global_metrics

    throttle = float(os.environ.get("BENCH_SEGMENT_THROTTLE_MBPS", 25))
    server = (_RANGE_SERVER, (str(throttle),))
    # the small arm measures the FALLBACK cost (one pooled HEAD per
    # job, ~1 RTT): 4 MiB keeps it under the 2 x HTTP_SEGMENT_MIN_MB
    # threshold while giving the wall clock enough signal that a
    # millisecond of probe doesn't drown in timer noise; 2 x the jobs
    # for the same reason
    small_mb = 4
    small_payload = os.path.join(site, "seg_small.mkv")
    if not os.path.exists(small_payload):
        with open(small_payload, "wb") as sink:
            sink.write(os.urandom(small_mb * 1024 * 1024))
    part_mb = 8 * 1024 * 1024
    shared = dict(
        concurrency=concurrency,
        prefetch=concurrency,
        multipart_threshold=part_mb,
        part_size=part_mb,
        pipeline=True,
        part_workers=concurrency,
        server=server,
    )

    def run_arm(arm_jobs, arm_mb, payload, segments):
        counters0 = global_metrics.GLOBAL.snapshot()
        hists0 = global_metrics.GLOBAL.histograms()
        moved, took = run_config(
            arm_jobs, arm_mb, site=site, payload=payload,
            http_segments=segments, **shared,
        )
        counters1 = global_metrics.GLOBAL.snapshot()
        hists1 = global_metrics.GLOBAL.histograms()

        def counter_delta(name):
            return counters1.get(name, 0) - counters0.get(name, 0)

        overlap = None
        if "pipeline_overlap_ratio" in hists1:
            _, _, sum1, count1 = hists1["pipeline_overlap_ratio"]
            _, _, sum0, count0 = hists0.get(
                "pipeline_overlap_ratio", ((), [], 0.0, 0)
            )
            if count1 > count0:
                overlap = (sum1 - sum0) / (count1 - count0)
        return {
            "wall_s": round(took, 2),
            "MBps": round(moved / took, 1),
            "overlap_ratio": None if overlap is None else round(overlap, 3),
            "pool_reuse_hits": counter_delta("http_pool_reuse_hits"),
            "segmented_fetches": counter_delta("http_segmented_fetches"),
            "segment_redispatches": counter_delta("http_segment_redispatches"),
        }

    rounds: list[dict] = []
    for i in range(repeats):
        arms = {
            "single_large": run_arm(jobs, mb_per_job, "payload.mkv", 1),
            "segmented_large": run_arm(jobs, mb_per_job, "payload.mkv", None),
            "single_small": run_arm(2 * jobs, small_mb, "seg_small.mkv", 1),
            "segmented_small": run_arm(
                2 * jobs, small_mb, "seg_small.mkv", None
            ),
        }
        rounds.append(
            {
                "arms": arms,
                "large_ratio": round(
                    arms["segmented_large"]["MBps"]
                    / arms["single_large"]["MBps"], 2
                ),
                "small_ratio": round(
                    arms["segmented_small"]["MBps"]
                    / arms["single_small"]["MBps"], 2
                ),
            }
        )
        _log(
            f"bench: segmented round {i + 1}: large "
            f"{arms['single_large']['MBps']:.1f} -> "
            f"{arms['segmented_large']['MBps']:.1f} MB/s "
            f"({rounds[-1]['large_ratio']:.2f}x, overlap "
            f"{arms['segmented_large']['overlap_ratio']}, reuse "
            f"{arms['segmented_large']['pool_reuse_hits']}), small "
            f"{rounds[-1]['small_ratio']:.2f}x (fallback)"
        )

    def median_ratio(key: str) -> float:
        ordered = sorted(r[key] for r in rounds)
        return ordered[len(ordered) // 2]

    return {
        "metric": "segmented_vs_single",
        "segmented_vs_single_large": median_ratio("large_ratio"),
        "segmented_vs_single_small": median_ratio("small_ratio"),
        "throttle_MBps_per_conn": throttle,
        "large_mb": mb_per_job,
        "small_mb": small_mb,
        "rounds": rounds,
    }


def run_multi_source_arm(
    site: str,
    mb: int = 32,
    throttle_mbps: float = 10.0,
    repeats: int = 3,
) -> dict:
    """The multi-source racing ablation. Two measurements:

    - **throughput**: one job from an origin with an AGGREGATE
      bandwidth cap (the condition racing a second origin exists to
      beat — the single-origin stripe cannot exceed it however many
      connections it opens), single-source vs the same job carrying an
      unthrottled mirror in ``X-Mirrors``. Interleaved rounds, median
      ratio — the acceptance bar is >= 1.8x.
    - **failover**: one multi-source job whose throttled primary is
      KILLED mid-stream; the job must complete from the mirror, and
      the per-kind byte counters must show the object fetched ~once
      (``fetch_amplification`` near 1.0 — journaled spans were not
      re-fetched).
    """
    from downloader_tpu_torch.queue.delivery import MIRRORS_HEADER
    from downloader_tpu_torch.utils import metrics as metrics_mod

    payload = os.path.join(site, "multi_src.mkv")
    if not os.path.exists(payload):
        with open(payload, "wb") as sink:
            chunk = os.urandom(1024 * 1024)
            for _ in range(mb):
                sink.write(chunk)
    primary_server = (_AGGREGATE_RANGE_SERVER, (str(throttle_mbps),))

    def run_job(mirror_url: "str | None") -> float:
        headers = (
            {MIRRORS_HEADER: mirror_url} if mirror_url is not None else {}
        )
        pipeline = _pipeline(
            1, 1, site, payload="multi_src.mkv", server=primary_server,
            batch_jobs=1,
        )
        try:
            start = time.monotonic()
            pipeline.publish_job(0, headers=headers)
            pipeline.wait_converts(1, timeout=300.0)
            return mb / (time.monotonic() - start)
        finally:
            pipeline.close()

    mirror_proc, mirror_port = _spawn_server(
        _AGGREGATE_RANGE_SERVER, site, "0"
    )
    mirror_url = f"http://127.0.0.1:{mirror_port}/multi_src.mkv"
    try:
        rounds: list[dict] = []
        for i in range(repeats):
            single = run_job(None)
            multi = run_job(mirror_url)
            rounds.append(
                {
                    "single_MBps": round(single, 1),
                    "multi_MBps": round(multi, 1),
                    "ratio": round(multi / single, 2),
                }
            )
            _log(
                f"bench: multi-source round {i + 1}: single "
                f"{single:.1f} MB/s -> multi {multi:.1f} MB/s "
                f"({rounds[-1]['ratio']:.2f}x)"
            )

        # -- failover: kill the throttled primary mid-stream ---------------
        # the failover mirror is THROTTLED too (3x the primary's cap):
        # an unthrottled loopback mirror finishes the whole object
        # before the kill can land, and the arm would measure nothing
        failover_mirror_proc, failover_mirror_port = _spawn_server(
            _AGGREGATE_RANGE_SERVER, site, str(3 * throttle_mbps)
        )
        failover_mirror_url = (
            f"http://127.0.0.1:{failover_mirror_port}/multi_src.mkv"
        )
        counters0 = metrics_mod.GLOBAL.snapshot()
        pipeline = _pipeline(
            1, 1, site, payload="multi_src.mkv", server=primary_server,
            batch_jobs=1,
        )
        completed = False
        try:
            pipeline.publish_job(
                0, headers={MIRRORS_HEADER: failover_mirror_url}
            )
            # wait until the job has real progress, then kill the origin
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                fetched = (
                    metrics_mod.GLOBAL.snapshot().get(
                        "source_bytes_total_mirror", 0
                    )
                    - counters0.get("source_bytes_total_mirror", 0)
                )
                if fetched >= 1024 * 1024:
                    break
                time.sleep(0.005)
            pipeline.httpd.kill()
            pipeline.httpd.wait()
            pipeline.wait_converts(1, timeout=300.0)
            completed = True
        finally:
            pipeline.close()
            failover_mirror_proc.kill()
            failover_mirror_proc.wait()
        counters1 = metrics_mod.GLOBAL.snapshot()
        fetched = counters1.get("source_bytes_total_mirror", 0) - counters0.get(
            "source_bytes_total_mirror", 0
        )
        failover = {
            "completed": completed,
            "fetch_amplification": round(fetched / (mb * 1024 * 1024), 3),
            "source_failovers": counters1.get("http_source_failovers", 0)
            - counters0.get("http_source_failovers", 0),
        }
        _log(
            f"bench: multi-source failover: completed={completed}, "
            f"amplification {failover['fetch_amplification']:.3f}, "
            f"failovers {failover['source_failovers']}"
        )
    finally:
        mirror_proc.kill()
        mirror_proc.wait()

    ordered = sorted(r["ratio"] for r in rounds)
    return {
        "metric": "multi_source",
        "multi_vs_single": ordered[len(ordered) // 2],
        "throttle_MBps_aggregate": throttle_mbps,
        "mb": mb,
        "rounds": rounds,
        "failover": failover,
    }


def run_latency(
    site: str, samples: int, concurrency: int
) -> tuple[float, dict]:
    """Per-job overhead: enqueue → Convert hand-off consumed, for a tiny
    payload, one job in flight at a time. Returns (median ms, per-stage
    attribution) — the attribution comes from the span traces
    (utils/tracing.py, enabled as in production), so a future overhead
    regression names the stage that moved instead of printing one
    unexplainable number. (BASELINE.md's "job-overhead latency (enqueue→ack for a tiny file)";
    the Convert arrives right after the ack-gating publish confirm, so it
    bounds the same path and is observable without daemon hooks)."""
    from downloader_tpu_torch.utils import tracing

    tracing.TRACER.clear()  # drop traces from the throughput runs
    # the attribution must describe the SAME sample set as the headline
    # median: size the ring to hold every sample (default 64 would
    # silently keep only the tail of a longer run)
    tracing.TRACER.set_capacity(max(samples, tracing.DEFAULT_RING))
    pipeline = _pipeline(concurrency, concurrency, site, payload="tiny.bin")
    try:
        laps: list[float] = []
        for i in range(samples):
            start = time.monotonic()
            pipeline.publish_job(i)
            pipeline.wait_converts(i + 1, timeout=60.0)
            laps.append((time.monotonic() - start) * 1000.0)
        laps.sort()
        # the Convert can be consumed a beat before the job's trace
        # completes (publish → sink callback races the ack + trace
        # hand-off): give the final trace a moment to land
        deadline = time.monotonic() + 2.0
        while (
            len(tracing.TRACER.recent()) < samples
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
        stages: dict[str, list[float]] = {}
        for trace in tracing.TRACER.recent():
            for child in trace["spans"].get("children", []):
                stages.setdefault(child["name"], []).append(
                    child["duration_ms"]
                )
        attribution = {
            name: sorted(values)[len(values) // 2]
            for name, values in sorted(stages.items())
        }
        return laps[len(laps) // 2], attribution
    finally:
        pipeline.close()


def _pct(values: "list[float]", q: float) -> float:
    ordered = sorted(values)
    return round(ordered[min(len(ordered) - 1, int(len(ordered) * q))], 2)


def run_small_object_arm(
    site: str, wave: int = 16, waves: int = 3
) -> dict:
    """Small-object per-job overhead: p50/p99 per object size (1 KB /
    64 KB / 1 MB), batched fast path vs unbatched ablation, against the
    HEAD-capable Range server with no throttle (the probe cache and the
    pooled single-connection GET need a server that answers HEAD — the
    plain payload server doesn't).

    Unbatched jobs run one at a time, so each lap is a true per-job
    latency. Batched jobs are published a wave at a time and the wall
    clock is amortized over the wave (the per-job cost OF the batch),
    one sample per wave. Interleaved unbatched/batched rounds per size,
    percentiles over the samples — the standard noise defense."""
    sizes = (("1k", 1024), ("64k", 64 * 1024), ("1m", 1024 * 1024))
    server = (_RANGE_SERVER, ("0",))
    for label, size in sizes:
        path = os.path.join(site, f"so_{label}.mkv")
        if not os.path.exists(path):
            with open(path, "wb") as sink:
                sink.write(os.urandom(size))

    out_sizes: dict = {}
    for label, size in sizes:
        laps: dict[str, list[float]] = {"unbatched": [], "batched": []}
        for _ in range(waves):
            pipeline = _pipeline(
                1, wave * 2, site, payload=f"so_{label}.mkv",
                server=server, batch_jobs=1,
            )
            try:
                for i in range(wave):
                    start = time.monotonic()
                    pipeline.publish_job(i)
                    pipeline.wait_converts(i + 1, timeout=60.0)
                    laps["unbatched"].append(
                        (time.monotonic() - start) * 1e3
                    )
            finally:
                pipeline.close()
            pipeline = _pipeline(
                1, wave * 2, site, payload=f"so_{label}.mkv",
                server=server, batch_jobs=wave,
            )
            try:
                start = time.monotonic()
                for i in range(wave):
                    pipeline.publish_job(i)
                pipeline.wait_converts(wave, timeout=120.0)
                laps["batched"].append(
                    (time.monotonic() - start) * 1e3 / wave
                )
            finally:
                pipeline.close()
        entry = {
            "unbatched_p50_ms": _pct(laps["unbatched"], 0.5),
            "unbatched_p99_ms": _pct(laps["unbatched"], 0.99),
            "batched_p50_ms": _pct(laps["batched"], 0.5),
            "batched_p99_ms": _pct(laps["batched"], 0.99),
        }
        entry["batched_vs_unbatched"] = round(
            entry["unbatched_p50_ms"] / max(entry["batched_p50_ms"], 1e-9), 2
        )
        out_sizes[label] = entry
        _log(
            f"bench: small-object {label}: unbatched p50 "
            f"{entry['unbatched_p50_ms']:.2f} ms / p99 "
            f"{entry['unbatched_p99_ms']:.2f} ms, batched p50 "
            f"{entry['batched_p50_ms']:.2f} ms / p99 "
            f"{entry['batched_p99_ms']:.2f} ms "
            f"({entry['batched_vs_unbatched']:.2f}x)"
        )
    return {
        "metric": "small_object_overhead",
        "unit": "ms",
        "wave": wave,
        "waves": waves,
        "sizes": out_sizes,
    }


def run_overload_arm(
    site: str,
    interactive_jobs: int = 6,
    bulk_jobs: int = 4,
    throttle_mbps: float = 2.0,
) -> dict:
    """Overload shedding ablation: one bulk tenant floods the
    worker with large objects from a throttled origin while an
    interactive tenant submits small jobs one at a time. Two arms over
    identical load:

    - **unprotected** (no per-tenant quota): bulk occupies every
      worker; interactive latency absorbs the bulk transfer times.
    - **protected** (``QUOTA_TENANT_JOBS=1``): one bulk job is
      admitted, the rest are shed to the DLQ with Retry-After, and
      interactive jobs ride the free worker.

    Reported: interactive p50/p99 per arm, the protection ratio, and
    how many jobs the protected arm shed."""
    from downloader_tpu_torch.queue.delivery import CLASS_HEADER, TENANT_HEADER
    from downloader_tpu_torch.utils import metrics as metrics_mod

    bulk_payload = os.path.join(site, "overload_bulk.mkv")
    tiny_payload = os.path.join(site, "overload_tiny.mkv")
    if not os.path.exists(bulk_payload):
        with open(bulk_payload, "wb") as sink:
            sink.write(os.urandom(6 * 1024 * 1024))
    if not os.path.exists(tiny_payload):
        with open(tiny_payload, "wb") as sink:
            sink.write(os.urandom(16 * 1024))
    server = (_RANGE_SERVER, (str(throttle_mbps),))

    def run_arm(quota_jobs: "int | None") -> dict:
        shed_before = metrics_mod.GLOBAL.snapshot().get(
            "admission_shed_jobs", 0
        )
        pipeline = _pipeline(
            2, 32, site, payload="overload_tiny.mkv",
            server=server, batch_jobs=1, quota_jobs=quota_jobs,
        )
        try:
            for i in range(bulk_jobs):
                pipeline.publish_job(
                    i, payload="overload_bulk.mkv",
                    media_id=f"bulk-{i}",
                    headers={TENANT_HEADER: "bulk-co", CLASS_HEADER: "bulk"},
                )
            time.sleep(0.5)  # let the bulk wave occupy what it can
            laps: list[float] = []
            for i in range(interactive_jobs):
                media_id = f"int-{i}"
                start = time.monotonic()
                pipeline.publish_job(
                    1000 + i, media_id=media_id,
                    headers={
                        TENANT_HEADER: "vip", CLASS_HEADER: "interactive",
                    },
                )
                deadline = time.monotonic() + 120.0
                while not any(
                    c.media.id == media_id for c in pipeline.converts
                ):
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"overload arm: {media_id} never converted"
                        )
                    time.sleep(0.002)
                laps.append((time.monotonic() - start) * 1e3)
        finally:
            pipeline.close()
        shed = (
            metrics_mod.GLOBAL.snapshot().get("admission_shed_jobs", 0)
            - shed_before
        )
        return {
            "interactive_p50_ms": _pct(laps, 0.5),
            "interactive_p99_ms": _pct(laps, 0.99),
            "shed_jobs": shed,
        }

    unprotected = run_arm(None)
    protected = run_arm(1)
    ratio = round(
        unprotected["interactive_p99_ms"]
        / max(protected["interactive_p99_ms"], 1e-9),
        2,
    )
    _log(
        f"bench: overload shedding: interactive p99 "
        f"{unprotected['interactive_p99_ms']:.0f} ms unprotected vs "
        f"{protected['interactive_p99_ms']:.0f} ms protected "
        f"({ratio:.1f}x), {protected['shed_jobs']} bulk jobs shed"
    )
    return {
        "metric": "overload_shedding",
        "unit": "ms",
        "interactive_jobs": interactive_jobs,
        "bulk_jobs": bulk_jobs,
        "throttle_MBps_per_conn": throttle_mbps,
        "unprotected": unprotected,
        "protected": protected,
        "protection_ratio": ratio,
    }


def run_watchdog_ablation(
    site: str, samples: int, concurrency: int, repeats: int = 3
) -> dict:
    """The stall-watchdog ablation: per-job latency with progress
    heartbeats + the scanning thread live (production default) vs the
    watchdog disabled (WATCHDOG_STALL_S=0 semantics: no-op watches on
    the streaming path). Interleaved off/on pairs, median of per-pair
    deltas — the heartbeat contract is 'a counter bump, nothing more',
    so the delta should be statistically indistinguishable from zero."""
    from downloader_tpu_torch.utils import watchdog as watchdog_mod

    monitor = watchdog_mod.MONITOR

    def run_arm(enabled: bool) -> float:
        monitor.reset()
        if enabled:
            monitor.configure(stall_s=60.0, action="log")
            monitor.start()
        else:
            monitor.stall_s = 0.0  # job()/loop() hand out no-op watches
        pipeline = _pipeline(
            concurrency, concurrency, site, payload="tiny.bin"
        )
        try:
            laps: list[float] = []
            for i in range(samples):
                start = time.monotonic()
                pipeline.publish_job(i)
                pipeline.wait_converts(i + 1, timeout=60.0)
                laps.append((time.monotonic() - start) * 1000.0)
        finally:
            pipeline.close()
            monitor.reset()
            monitor.stall_s = watchdog_mod.DEFAULT_STALL_S
        laps.sort()
        return laps[len(laps) // 2]

    pairs = []
    for _ in range(repeats):
        off_ms = run_arm(False)
        on_ms = run_arm(True)
        pairs.append({"off_ms": round(off_ms, 2), "on_ms": round(on_ms, 2),
                      "delta_ms": round(on_ms - off_ms, 3)})
    deltas = sorted(p["delta_ms"] for p in pairs)
    return {
        "metric": "watchdog_overhead",
        "unit": "ms",
        "delta_ms": deltas[len(deltas) // 2],
        "pairs": pairs,
    }


def run_telemetry_ablation(
    site: str, samples: int, concurrency: int, repeats: int = 3
) -> dict:
    """The whole-telemetry-plane ablation: per-job
    latency with EVERYTHING on — span tracing, trace-context
    propagation on every publish, watchdog heartbeats + scanner, TSDB
    scraping at a production-tight cadence, alert evaluation over the
    default rule set — against all of it off. Interleaved off/on
    pairs, median of per-pair deltas; the always-on contract is that
    this delta stays inside host noise."""
    from downloader_tpu_torch.utils import alerts as alerts_mod
    from downloader_tpu_torch.utils import tracing as tracing_mod
    from downloader_tpu_torch.utils import tsdb as tsdb_mod
    from downloader_tpu_torch.utils import watchdog as watchdog_mod

    monitor = watchdog_mod.MONITOR

    def run_arm(enabled: bool) -> float:
        monitor.reset()
        tsdb_mod.STORE.reset()
        alerts_mod.ENGINE.reset()
        tracing_mod.TRACER.clear()
        tracing_mod.TRACER.enabled = enabled
        tracing_mod.TRACER.propagate = enabled
        if enabled:
            monitor.configure(stall_s=60.0, action="log")
            monitor.start()
            tsdb_mod.STORE.configure(interval_s=1.0)
            tsdb_mod.STORE.start()
            alerts_mod.ENGINE.configure(
                rules=alerts_mod.default_rules(),
                interval_s=1.0,
                store=tsdb_mod.STORE,
            )
            alerts_mod.ENGINE.start()
        else:
            monitor.stall_s = 0.0  # no-op watches on the hot path
        pipeline = _pipeline(
            concurrency, concurrency, site, payload="tiny.bin"
        )
        try:
            laps: list[float] = []
            for i in range(samples):
                start = time.monotonic()
                pipeline.publish_job(i)
                pipeline.wait_converts(i + 1, timeout=60.0)
                laps.append((time.monotonic() - start) * 1000.0)
        finally:
            pipeline.close()
            alerts_mod.ENGINE.reset()
            tsdb_mod.STORE.reset()
            monitor.reset()
            monitor.stall_s = watchdog_mod.DEFAULT_STALL_S
            tracing_mod.TRACER.enabled = True
            tracing_mod.TRACER.propagate = True
            tracing_mod.TRACER.clear()
        laps.sort()
        return laps[len(laps) // 2]

    pairs = []
    for _ in range(repeats):
        off_ms = run_arm(False)
        on_ms = run_arm(True)
        pairs.append({"off_ms": round(off_ms, 2), "on_ms": round(on_ms, 2),
                      "delta_ms": round(on_ms - off_ms, 3)})
    deltas = sorted(p["delta_ms"] for p in pairs)
    return {
        "metric": "telemetry_overhead",
        "unit": "ms",
        "delta_ms": deltas[len(deltas) // 2],
        "pairs": pairs,
    }


def run_canary_ablation(
    site: str, samples: int, concurrency: int, repeats: int = 3
) -> dict:
    """The canary-plane arm: per-job latency on
    NON-canary traffic with a live prober (exclusion table armed, shed
    hook active, canary Convert lane consuming) against the plane off
    — interleaved off/on pairs, median of per-pair deltas, same
    always-on contract as the watchdog/telemetry arms. Plus the number
    the plane exists for: detection latency from an armed
    ``canary.corrupt`` failpoint to the prober reading the corruption
    back and flipping ``canary_failing``."""
    from downloader_tpu_torch.utils import canary as canary_mod
    from downloader_tpu_torch.utils import failpoints as failpoints_mod

    def build_prober(pipeline: Pipeline) -> "canary_mod.CanaryProber":
        prober = canary_mod.CanaryProber(
            pipeline.client, pipeline.uploader,
            consume_topic=pipeline.config.consume_topic,
            publish_topic=pipeline.config.publish_topic,
            interval_s=3600.0, timeout_s=60.0, instance="bench",
        )
        prober.start()
        canary_mod.ACTIVE = prober
        return prober

    def teardown_prober(prober) -> None:
        canary_mod.ACTIVE = None
        prober.stop()

    def run_arm(enabled: bool) -> float:
        pipeline = _pipeline(
            concurrency, concurrency, site, payload="tiny.bin"
        )
        prober = build_prober(pipeline) if enabled else None
        try:
            laps: list[float] = []
            for i in range(samples):
                start = time.monotonic()
                pipeline.publish_job(i)
                pipeline.wait_converts(i + 1, timeout=60.0)
                laps.append((time.monotonic() - start) * 1000.0)
        finally:
            if prober is not None:
                teardown_prober(prober)
            pipeline.close()
        laps.sort()
        return laps[len(laps) // 2]

    pairs = []
    for _ in range(repeats):
        off_ms = run_arm(False)
        on_ms = run_arm(True)
        pairs.append({"off_ms": round(off_ms, 2), "on_ms": round(on_ms, 2),
                      "delta_ms": round(on_ms - off_ms, 3)})
    deltas = sorted(p["delta_ms"] for p in pairs)

    # detection latency: arm silent corruption, trigger one probe pair
    # through the prober's own loop, clock until the episode opens
    pipeline = _pipeline(concurrency, concurrency, site, payload="tiny.bin")
    prober = build_prober(pipeline)
    detect_s = None
    try:
        failpoints_mod.FAILPOINTS.configure("canary.corrupt=fail:1")
        start = time.monotonic()
        prober.trigger()
        deadline = start + 120.0
        while time.monotonic() < deadline:
            if prober.failing:
                detect_s = round(time.monotonic() - start, 3)
                break
            time.sleep(0.01)
    finally:
        failpoints_mod.FAILPOINTS.reset()
        teardown_prober(prober)
        pipeline.close()
    return {
        "metric": "canary_probe",
        "unit": "ms",
        "delta_ms": deltas[len(deltas) // 2],
        "detect_s": detect_s,
        "pairs": pairs,
    }


def run_fleet_chaos_arm(
    jobs: int = 12, workers: int = 2, spec: str = ""
) -> dict:
    """The crash-only fleet proof as a measured arm: K real
    worker processes drain N multipart jobs from a TCP AMQP broker
    stub while seeded failpoints (``spec``) inject faults; one worker
    is SIGKILLed mid-drain. Reports whether every job completed under
    its original trace id, the drain wall time, the supervisor's
    restart latency for the killed worker, and the dangling-multipart
    count after the drain — the number that must be zero."""
    import threading as threading_mod

    from downloader_tpu_torch.daemon.fleet import FleetConfig, FleetSupervisor
    from downloader_tpu_torch.queue.amqp_server import AmqpServerStub
    from downloader_tpu_torch.store.credentials import Credentials
    from downloader_tpu_torch.store.stub import S3Stub
    from downloader_tpu_torch.utils import metrics as metrics_mod
    from downloader_tpu_torch.utils import tracing as tracing_mod
    from downloader_tpu_torch.wire import Convert, Download, Media

    creds = Credentials(access_key="bench-ak", secret_key="bench-sk")
    bucket = "bench-fleet"
    payloads = {
        f"/movie{index}.mp4": os.urandom(512 * 1024)
        for index in range(jobs)
    }

    class _Origin(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _serve(self, head: bool) -> None:
            payload = payloads.get(self.path)
            if payload is None:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            if not head:
                self.wfile.write(payload)

        def do_HEAD(self):
            self._serve(head=True)

        def do_GET(self):
            self._serve(head=False)

    origin = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Origin)
    origin_thread = threading_mod.Thread(
        target=origin.serve_forever, daemon=True
    )
    origin_thread.start()
    origin_url = f"http://127.0.0.1:{origin.server_address[1]}"

    site = tempfile.mkdtemp(prefix="bench-fleet-", dir=_bench_root())
    s3 = S3Stub(creds).start()
    broker = AmqpServerStub().start()
    converts: "list[tuple[str, str]]" = []
    converts_lock = threading_mod.Lock()
    supervisor = None
    restarts_before = metrics_mod.GLOBAL.snapshot().get(
        "fleet_worker_restarts", 0
    )
    try:
        # topology + the convert sink BEFORE any worker exists, so no
        # publish can be lost to a missing queue
        sink_conn = broker.broker.connect()
        sink_channel = sink_conn.channel()
        sink_channel.set_prefetch(max(100, jobs * 4))
        for topic in ("v1.download", "v1.convert"):
            sink_channel.declare_exchange(topic)
            for index in range(2):
                name = f"{topic}-{index}"
                sink_channel.declare_queue(name)
                sink_channel.bind_queue(name, topic, name)

        def on_convert(message, ch=sink_channel):
            convert = Convert.unmarshal(message.body)
            context = tracing_mod.TraceContext.parse(
                message.headers.get(tracing_mod.TRACE_CONTEXT_HEADER)
            )
            with converts_lock:
                converts.append(
                    (
                        convert.media.id if convert.media else "",
                        context.trace_id if context else "",
                    )
                )
            ch.ack(message.delivery_tag)

        for index in range(2):
            sink_channel.consume(f"v1.convert-{index}", on_convert)

        contexts: "dict[str, str]" = {}
        for index, path in enumerate(sorted(payloads)):
            context = tracing_mod.TraceContext.mint()
            contexts[f"fleet-{index}"] = context.trace_id
            sink_channel.publish(
                "v1.download",
                "v1.download-0",
                Download(
                    media=Media(
                        id=f"fleet-{index}",
                        source_uri=f"{origin_url}{path}",
                    )
                ).marshal(),
                headers={
                    tracing_mod.TRACE_CONTEXT_HEADER: context.header_value()
                },
                persistent=True,
            )

        supervisor = FleetSupervisor(
            FleetConfig(
                workers=workers,
                heartbeat_s=0.2,
                stall_s=2.0,
                restart_backoff_s=0.1,
                restart_backoff_cap_s=0.5,
                start_grace_s=60.0,
                drain_s=15.0,
            ),
            worker_env={
                "BROKER": "amqp",
                "RABBITMQ_ENDPOINT": broker.endpoint,
                "RABBITMQ_USERNAME": "",
                "RABBITMQ_PASSWORD": "",
                "S3_ENDPOINT": f"http://{s3.endpoint}",
                "S3_ACCESS_KEY": creds.access_key,
                "S3_SECRET_KEY": creds.secret_key,
                "BUCKET": bucket,
                "DOWNLOAD_DIR": site,
                "JOB_CONCURRENCY": "2",
                "PREFETCH": "4",
                "BATCH_JOBS": "1",
                "HTTP_SEGMENTS": "1",
                "S3_MULTIPART_THRESHOLD": str(128 * 1024),
                "S3_PART_SIZE": str(128 * 1024),
                "PROFILE": "0",
                "TSDB_INTERVAL": "off",
                "ALERT_INTERVAL": "off",
                "LSD": "off",
                "DHT_BOOTSTRAP": "off",
                "MAX_JOB_RETRIES": "8",
                "RETRY_DELAY": "0.1",
                "RETRY_DELAY_CAP": "0.5",
                "FAILPOINT_SPEC": spec,
                "LOG_LEVEL": "error",
            },
        )
        started = time.monotonic()
        supervisor.start()

        def completed() -> int:
            with converts_lock:
                done = {
                    media_id
                    for media_id, trace_id in converts
                    if contexts.get(media_id) == trace_id
                }
            return len(done)

        # SIGKILL one worker once the drain is demonstrably mid-flight
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and completed() < max(
            1, jobs // 4
        ):
            time.sleep(0.1)
        victim = next(
            (
                slot
                for slot in supervisor.snapshot()["slots"]
                if slot["pid"] and slot["state"] == "ready"
            ),
            None,
        )
        restart_s = None
        if victim is not None:
            killed_at = time.monotonic()
            try:
                os.kill(victim["pid"], signal.SIGKILL)
            except ProcessLookupError:
                # the armed failpoints (or a crash of its own) beat us
                # to it: the restart machinery still gets exercised,
                # only the latency measurement is forfeit
                victim = None
        if victim is not None:
            # observe the dip first (poll() flips fast on SIGKILL) so a
            # sub-poll-interval respawn doesn't read as restart_s=0
            while (
                time.monotonic() - killed_at < 5.0
                and supervisor.snapshot()["workers_alive"] >= workers
            ):
                time.sleep(0.02)
            while (
                time.monotonic() - killed_at < 60.0
                and supervisor.snapshot()["workers_alive"] < workers
            ):
                time.sleep(0.1)
            if supervisor.snapshot()["workers_alive"] >= workers:
                restart_s = time.monotonic() - killed_at
        while time.monotonic() < deadline and completed() < jobs:
            time.sleep(0.2)
        elapsed = time.monotonic() - started
        with converts_lock:
            total_converts = len(converts)
        dangling_deadline = time.monotonic() + 20.0
        while time.monotonic() < dangling_deadline and (
            s3.list_multipart_uploads()
        ):
            time.sleep(0.2)
        dangling = len(s3.list_multipart_uploads())
        return {
            "metric": "fleet_chaos",
            "jobs": jobs,
            "workers": workers,
            "failpoint_spec": spec,
            "completed": completed(),
            "elapsed_s": round(elapsed, 2),
            "restart_s": None if restart_s is None else round(restart_s, 2),
            "restarts": metrics_mod.GLOBAL.snapshot().get(
                "fleet_worker_restarts", 0
            )
            - restarts_before,
            "duplicate_converts": total_converts - completed(),
            "dangling_multiparts": dangling,
        }
    finally:
        if supervisor is not None:
            supervisor.drain()
        try:
            sink_conn.close()
        except Exception:
            _log("bench: fleet sink close failed (already gone)")
        broker.stop()
        s3.stop()
        origin.shutdown()
        origin.server_close()
        shutil.rmtree(site, ignore_errors=True)


def run_fleet_scrape_arm(
    workers: int = 4, timeout_s: float = 0.5
) -> dict:
    """Fleet debug-plane fan-out wall time: N stub worker
    health endpoints — one of them WEDGED (accepts the request, never
    answers) — scraped concurrently by the FleetQueryPlane. The
    contract number: the fan-out WITH the wedged worker stays within
    ~one per-worker scrape-timeout budget, because a wedged worker
    costs its slice, never the response."""
    import http.server as http_server
    import socketserver

    from downloader_tpu_torch.daemon.fleetplane import FleetQueryPlane

    body = json.dumps(
        {"records": [{"ts": float(i), "msg": f"r{i}"} for i in range(50)]}
    ).encode()
    release = threading.Event()

    def make_server(wedge: bool):
        class Handler(http_server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if wedge:
                    release.wait(30.0)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except OSError:
                    pass

        server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server

    healthy = [make_server(False) for _ in range(max(1, workers - 1))]
    wedged = make_server(True)
    try:
        def members(include_wedged: bool):
            fleet = [
                (f"worker-{i}", server.server_address[1])
                for i, server in enumerate(healthy)
            ]
            if include_wedged:
                fleet.append(("worker-wedged", wedged.server_address[1]))
            return fleet

        def timed(include_wedged: bool):
            plane = FleetQueryPlane(
                lambda: members(include_wedged), timeout_s=timeout_s
            )
            laps = []
            results: dict = {}
            for _ in range(3):
                start = time.monotonic()
                results = plane.fanout("/debug/logs")
                laps.append(time.monotonic() - start)
            ok = sum(1 for entry in results.values() if entry.get("ok"))
            return min(laps), ok

        healthy_s, healthy_ok = timed(False)
        wedged_s, wedged_ok = timed(True)
        # one timeout slice + the join grace + scheduler jitter on a
        # loaded host; N workers must never cost N slices
        budget_s = timeout_s + 1.0
        return {
            "metric": "fleet_scrape",
            "unit": "ms",
            "workers": len(healthy) + 1,
            "timeout_s": timeout_s,
            "healthy_ms": round(healthy_s * 1000, 1),
            "wedged_ms": round(wedged_s * 1000, 1),
            "healthy_ok": healthy_ok,
            "wedged_ok": wedged_ok,
            "within_one_timeout_budget": wedged_s <= budget_s,
        }
    finally:
        release.set()
        for server in healthy + [wedged]:
            server.shutdown()
            server.server_close()


def zipf_object_sizes(
    count: int, skew: float, mean_bytes: int, seed: int
) -> "list[int]":
    """Zipf-skewed object sizes for the flash-crowd workload: rank r
    carries weight r^-skew, scaled so the MEAN object is ~mean_bytes
    (total work stays fixed as the skew knob moves). Which OBJECT gets
    which rank is decided by hashing ``sha256(seed:zipf:i)`` — the
    failpoint registry's derivation discipline (utils/failpoints.py
    decision()), so the hot object's identity is a pure function of
    the seed and a run reproduces bit-for-bit from FAILPOINT_SEED."""
    import hashlib

    weights = [(r + 1) ** -skew for r in range(count)]
    scale = mean_bytes * count / sum(weights)
    sizes_by_rank = [max(1024, int(w * scale)) for w in weights]
    order = sorted(
        range(count),
        key=lambda i: hashlib.sha256(f"{seed}:zipf:{i}".encode()).digest(),
    )
    sizes = [0] * count
    for rank, index in enumerate(order):
        sizes[index] = sizes_by_rank[rank]
    return sizes


def zipf_sample(
    sizes: "list[int]", seed: int, site: str, count: int
) -> "list[int]":
    """``count`` object indices drawn from the size-weighted zipf
    distribution, deterministically: draw ``n`` maps
    ``sha256(seed:site:n)`` to a [0,1) fraction walked through the
    cumulative weights — the exact shape of the failpoint decision
    function, so replay waves reproduce from the seed alone."""
    import hashlib

    total = float(sum(sizes))
    out: "list[int]" = []
    for n in range(count):
        digest = hashlib.sha256(f"{seed}:{site}:{n}".encode()).digest()
        fraction = int.from_bytes(digest[:8], "big") / 2**64
        acc = 0.0
        pick = len(sizes) - 1
        for index, size in enumerate(sizes):
            acc += size / total
            if fraction < acc:
                pick = index
                break
        out.append(pick)
    return out


def run_flow_accounting_arm(
    site: str,
    objects: int = 16,
    skew: float = 1.1,
    mean_bytes: int = 64 * 1024,
    workers: int = 2,
    requests: int = 0,
) -> dict:
    """Flow-accounting arm: a zipf-sized flash crowd served
    by a CACHE-LESS fleet of W workers, each fetching every object from
    the one origin through the real small-object fast path — so every
    ledger seam (probe, pooled GET, note_ingress/note_unique) is the
    production code. Workers run SEQUENTIALLY against a reset ledger
    (per-process ledgers, exactly the production shape) and the fleet
    view comes from ``flows.merge_flow_snapshots``: the contract number
    is fleet origin amplification ≈ W (W workers each fetched the same
    unique byte population once), computed from SUMMED bytes. The
    naive average of per-worker ratios reads ~1.0 on the same run —
    reported beside it as the standing proof of why the merge rule
    matters. BENCH_ZIPF_REQUESTS>0 adds sampled repeat waves per
    worker (zipf-weighted replays, seeded like everything else), which
    push per-worker amplification above 1.0 too."""
    from downloader_tpu_torch.utils import flows
    from downloader_tpu_torch.utils.failpoints import seed_from_env

    seed = seed_from_env()
    sizes = zipf_object_sizes(objects, skew, mean_bytes, seed)
    for index, size in enumerate(sizes):
        with open(os.path.join(site, f"flow_{index:03d}.bin"), "wb") as sink:
            sink.write(os.urandom(size))
    proc, port = _spawn_server(_RANGE_SERVER, site, "0")
    urls = [
        f"http://127.0.0.1:{port}/flow_{index:03d}.bin"
        for index in range(objects)
    ]
    max_bytes = max(sizes) + 1
    snapshots: "dict[str, dict]" = {}
    start = time.monotonic()
    try:
        for w in range(workers):
            flows.LEDGER.reset()
            backend = HTTPBackend()
            workdir = tempfile.mkdtemp(prefix=f"flow-w{w}-", dir=site)
            token = CancelToken()
            try:
                wave = list(range(objects)) + zipf_sample(
                    sizes, seed, f"flow:w{w}", requests
                )
                for index in wave:
                    if not backend.fetch_small(
                        token, workdir, lambda *_args: None, urls[index],
                        max_bytes,
                    ):
                        raise RuntimeError(
                            f"fetch_small refused {urls[index]}"
                        )
            finally:
                backend.close()
                shutil.rmtree(workdir, ignore_errors=True)
            snapshots[f"w{w}"] = flows.LEDGER.snapshot()
    finally:
        proc.kill()
        flows.LEDGER.reset()
    elapsed = time.monotonic() - start
    fleet = flows.merge_flow_snapshots(snapshots)
    worker_ratios = [
        snap["origin_amplification"] for snap in snapshots.values()
    ]
    return {
        "metric": "flow_accounting",
        "unit": "ratio",
        "workers": workers,
        "objects": objects,
        "skew": skew,
        "requests_per_worker": requests,
        "seed": seed,
        "elapsed_s": round(elapsed, 2),
        "origin_amplification": fleet["origin_amplification"],
        "hot_object_share": fleet["hot_object_share"],
        "ingress_bytes": fleet["ingress_bytes"],
        "unique_bytes": fleet["unique_bytes"],
        # the wrong aggregation, kept on display: averaging per-worker
        # ratios hides exactly the redundancy the fleet merge exposes
        "naive_ratio_average": round(
            sum(worker_ratios) / max(1, len(worker_ratios)), 6
        ),
        "heavy_hitters": fleet["heavy_hitters"][:4],
    }


def run_single_flight_arm(
    workers: int = 2,
    objects: int = 3,
    skew: float = 1.1,
    mean_bytes: int = 512 * 1024,
    throttle_mbps: float = 3.0,
) -> dict:
    """Single-flight coalescing arm: a zipf flash crowd —
    every object demanded once per worker, sizes zipf-skewed so the
    hot object carries most of the bytes — drained by a REAL W-worker
    fleet against a throttled counting origin, once with the shared
    data plane off and once with it on. The contract numbers come
    from the fleet ``/debug/flows`` merge: origin bytes (summed
    ingress) vs demand bytes (ingress + cache-hit lane). Cache off
    every worker pays the origin for every object it drains, so fleet
    amplification reads ~W; cache on the elected leader fetches once
    and the crowd completes from the shared artifact, so origin GETs
    collapse to ~one per object and amplification reads ~1.0."""
    import http.client
    import socketserver
    import threading as threading_mod

    from downloader_tpu_torch.daemon.fleet import (
        FleetConfig,
        FleetHealthServer,
        FleetSupervisor,
    )
    from downloader_tpu_torch.queue.amqp_server import AmqpServerStub
    from downloader_tpu_torch.store.credentials import Credentials
    from downloader_tpu_torch.store.stub import S3Stub
    from downloader_tpu_torch.utils import tracing as tracing_mod
    from downloader_tpu_torch.utils.failpoints import seed_from_env

    seed = seed_from_env()
    sizes = zipf_object_sizes(objects, skew, mean_bytes, seed)
    # .mp4: only media extensions survive the scan stage into S3
    payloads = {
        f"/crowd_{index:02d}.mp4": os.urandom(size)
        for index, size in enumerate(sizes)
    }
    rate_bps = int(throttle_mbps * 1e6)
    creds = Credentials(access_key="bench-ak", secret_key="bench-sk")
    bucket = "bench-singleflight"
    demand_bytes = workers * sum(sizes)

    def run_arm(cache_on: bool) -> dict:
        gets: "dict[str, int]" = {}
        gets_lock = threading_mod.Lock()

        class _Origin(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                payload = payloads.get(self.path)
                if payload is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                payload = payloads.get(self.path)
                with gets_lock:
                    gets[self.path] = gets.get(self.path, 0) + 1
                if payload is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()
                chunk = 64 * 1024
                for offset in range(0, len(payload), chunk):
                    piece = payload[offset:offset + chunk]
                    try:
                        self.wfile.write(piece)
                        self.wfile.flush()
                    except OSError:
                        return
                    if rate_bps > 0:
                        time.sleep(len(piece) / rate_bps)

        origin = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Origin)
        origin.daemon_threads = True
        origin_thread = threading_mod.Thread(
            target=origin.serve_forever, daemon=True
        )
        origin_thread.start()
        origin_url = f"http://127.0.0.1:{origin.server_address[1]}"

        site = tempfile.mkdtemp(prefix="bench-sf-", dir=_bench_root())
        s3 = S3Stub(creds).start()
        broker = AmqpServerStub().start()
        done: "set[str]" = set()
        done_lock = threading_mod.Lock()
        supervisor = None
        health = None
        started = time.monotonic()
        try:
            sink_conn = broker.broker.connect()
            sink_channel = sink_conn.channel()
            sink_channel.set_prefetch(100)
            for topic in ("v1.download", "v1.convert"):
                sink_channel.declare_exchange(topic)
                for index in range(2):
                    name = f"{topic}-{index}"
                    sink_channel.declare_queue(name)
                    sink_channel.bind_queue(name, topic, name)

            def on_convert(message, ch=sink_channel):
                convert = Convert.unmarshal(message.body)
                with done_lock:
                    done.add(convert.media.id if convert.media else "")
                ch.ack(message.delivery_tag)

            for index in range(2):
                sink_channel.consume(f"v1.convert-{index}", on_convert)

            supervisor = FleetSupervisor(
                FleetConfig(
                    workers=workers,
                    heartbeat_s=0.2,
                    stall_s=30.0,
                    restart_backoff_s=0.1,
                    restart_backoff_cap_s=0.5,
                    start_grace_s=60.0,
                    drain_s=15.0,
                    scrape_timeout_s=2.0,
                ),
                worker_env={
                    "BROKER": "amqp",
                    "RABBITMQ_ENDPOINT": broker.endpoint,
                    "RABBITMQ_USERNAME": "",
                    "RABBITMQ_PASSWORD": "",
                    "S3_ENDPOINT": f"http://{s3.endpoint}",
                    "S3_ACCESS_KEY": creds.access_key,
                    "S3_SECRET_KEY": creds.secret_key,
                    "BUCKET": bucket,
                    "DOWNLOAD_DIR": site,
                    "JOB_CONCURRENCY": "1",
                    "PREFETCH": "1",
                    "BATCH_JOBS": "1",
                    "HTTP_SEGMENTS": "1",
                    "S3_MULTIPART_THRESHOLD": str(256 * 1024),
                    "S3_PART_SIZE": str(256 * 1024),
                    "PROFILE": "0",
                    "TSDB_INTERVAL": "off",
                    "ALERT_INTERVAL": "off",
                    "LSD": "off",
                    "DHT_BOOTSTRAP": "off",
                    "WATCHDOG_STALL_S": "600",
                    "MAX_JOB_RETRIES": "8",
                    "RETRY_DELAY": "0.1",
                    "RETRY_DELAY_CAP": "0.5",
                    "FAILPOINT_SPEC": "",
                    "LOG_LEVEL": "error",
                    "CACHE_DIR": (
                        os.path.join(site, "shared-cache") if cache_on
                        else ""
                    ),
                    "SINGLEFLIGHT_LEASE_S": "2.0",
                    "SINGLEFLIGHT_WAIT_S": "120",
                },
            )
            supervisor.start()
            ready_deadline = time.monotonic() + 60.0
            while time.monotonic() < ready_deadline and not all(
                slot["ready"] for slot in supervisor.snapshot()["slots"]
            ):
                time.sleep(0.1)

            # the flash crowd: the whole crowd for an object lands
            # back-to-back, so its copies are in flight on different
            # workers AT THE SAME TIME — the coalescing scenario, not
            # a warm-cache replay
            expected: "set[str]" = set()
            for index, path in enumerate(sorted(payloads)):
                for wave in range(workers):
                    media_id = f"sf-{index}-{wave}"
                    expected.add(media_id)
                    context = tracing_mod.TraceContext.mint()
                    sink_channel.publish(
                        "v1.download",
                        "v1.download-0",
                        Download(
                            media=Media(
                                id=media_id,
                                source_uri=f"{origin_url}{path}",
                            )
                        ).marshal(),
                        headers={
                            tracing_mod.TRACE_CONTEXT_HEADER: (
                                context.header_value()
                            )
                        },
                        persistent=True,
                    )

            drain_deadline = time.monotonic() + 180.0
            while time.monotonic() < drain_deadline:
                with done_lock:
                    if done >= expected:
                        break
                time.sleep(0.2)
            elapsed = time.monotonic() - started

            health = FleetHealthServer(supervisor, 0, "127.0.0.1").start()
            conn = http.client.HTTPConnection(
                "127.0.0.1", health.port, timeout=10.0
            )
            try:
                conn.request("GET", "/debug/flows")
                flows = json.loads(conn.getresponse().read())
            finally:
                conn.close()
            with gets_lock:
                origin_gets = sum(gets.values())
            with done_lock:
                completed = len(done & expected)
            ingress = flows.get("ingress_bytes", 0)
            hits = flows.get("cache_hit_bytes", 0)
            return {
                "cache": "on" if cache_on else "off",
                "completed": f"{completed}/{len(expected)}",
                "elapsed_s": round(elapsed, 2),
                "origin_gets": origin_gets,
                "origin_bytes": ingress,
                "demand_bytes": ingress + hits,
                "cache_hit_bytes": hits,
                "amplification": flows.get("origin_amplification"),
            }
        finally:
            if health is not None:
                health.stop()
            if supervisor is not None:
                supervisor.drain()
            try:
                sink_conn.close()
            except Exception:
                _log("bench: single-flight sink close failed (already gone)")
            broker.stop()
            s3.stop()
            origin.shutdown()
            origin.server_close()
            shutil.rmtree(site, ignore_errors=True)

    off = run_arm(cache_on=False)
    on = run_arm(cache_on=True)
    hit_denominator = on["cache_hit_bytes"] + on["origin_bytes"]
    return {
        "metric": "single_flight",
        "unit": "ratio",
        "workers": workers,
        "objects": objects,
        "crowd_per_object": workers,
        "jobs": workers * objects,
        "skew": skew,
        "seed": seed,
        "object_bytes": sizes,
        "demand_bytes_nominal": demand_bytes,
        "cache_off": off,
        "cache_on": on,
        "cache_hit_ratio": (
            round(on["cache_hit_bytes"] / hit_denominator, 6)
            if hit_denominator else None
        ),
        "singleflight_amp": on["amplification"],
        "singleflight_amp_off": off["amplification"],
    }


# the digest arm's child: one shape of the kernel micro-benchmark on the
# card, its report as the last line of stdout
_DIGEST_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from bench_digest_torch import measure
print(json.dumps(measure(piece_kb=int(sys.argv[2]), batch=int(sys.argv[3]))))
"""


def run_digest_arm(piece_kb: int = 256, batch: int = 1024) -> dict:
    """``bench_digest_torch.measure`` on the card, in a child process of
    its own, so this process never imports torch and the kernel's timing
    shares no interpreter with the fleet arms' leftover threads. Raises
    when the child fails (no card, a kernel that does not build or
    launch) or reports a digest that is not hashlib's."""
    done = subprocess.run(
        [sys.executable, "-c", _DIGEST_CHILD, REPO, str(piece_kb), str(batch)],
        stdout=subprocess.PIPE,
        text=True,
        timeout=600,
    )
    if done.returncode != 0:
        raise RuntimeError(
            f"digest arm failed: bench_digest_torch.measure exited "
            f"{done.returncode}"
        )
    digest = json.loads(done.stdout.splitlines()[-1])
    if digest["cuda_digest_mismatches"]:
        raise RuntimeError(
            f"digest arm: {digest['cuda_digest_mismatches']} digests differ "
            "from hashlib"
        )
    return digest


def main() -> None:
    quiet_logging()  # warning level unless LOG_LEVEL says otherwise
    jobs = int(os.environ.get("BENCH_JOBS", 24))
    mb_per_job = int(os.environ.get("BENCH_MB", 48))
    concurrency = int(os.environ.get("BENCH_CONCURRENCY", 6))

    site = tempfile.mkdtemp(prefix="bench-site-", dir=_bench_root())
    try:
        payload_path = os.path.join(site, "payload.mkv")
        with open(payload_path, "wb") as sink:
            chunk = os.urandom(1024 * 1024)
            for _ in range(mb_per_job):
                sink.write(chunk)

        repeats = max(1, int(os.environ.get("BENCH_REPEATS", 5)))
        # the baseline emulates the REFERENCE's shape on the port:
        # concurrency 1 + prefetch 1 (cmd/downloader/downloader.go:62,
        # 100-103) AND userspace copy loops (Go grab/minio stream through
        # io.Copy; they have no splice/sendfile path)
        #
        # INTERLEAVED baseline/framework PAIRS, median of per-pair
        # ratios: back-to-back pairing puts both configurations in the
        # same host-noise regime, the per-pair ratio cancels the shared
        # noise, and the MEDIAN keeps one outlier pair from deciding the
        # contract number.
        #
        # Each pair is further SLICED into alternating
        # baseline/framework sub-runs (B F B F ...) whose MB and seconds
        # are summed per config: a multi-second noise burst then lands
        # on sub-runs of BOTH configs instead of deciding one side of
        # the ratio wholesale.
        slices = max(1, int(os.environ.get("BENCH_SLICES", 4)))
        # never inflate or truncate the requested workload: shrink the
        # slice count when BENCH_JOBS can't fill the slices with at
        # least one full concurrency wave each, and spread any
        # remainder over the first slices so every requested job runs
        jobs = max(1, jobs)
        if jobs >= concurrency:
            slices = max(1, min(slices, jobs // concurrency))
        else:
            slices = 1
        slice_jobs = [
            jobs // slices + (1 if i < jobs % slices else 0)
            for i in range(slices)
        ]
        _log(
            f"bench: {repeats} pairs x {slices} alternating slices of "
            f"{slice_jobs} jobs x {mb_per_job} MB per config"
        )
        pairs: list[tuple[float, float]] = []
        for i in range(repeats):
            mb = {"b": 0.0, "f": 0.0}
            secs = {"b": 0.0, "f": 0.0}
            for slice_n in slice_jobs:
                # http_segments=1: the reference has no range probe and
                # one connection per transfer; the baseline arm keeps
                # that shape exactly
                moved, took = run_config(
                    slice_n, mb_per_job, 1, 1, site, zero_copy=False,
                    http_segments=1,
                )
                mb["b"] += moved
                secs["b"] += took
                moved, took = run_config(
                    slice_n, mb_per_job, concurrency, concurrency, site
                )
                mb["f"] += moved
                secs["f"] += took
            base = mb["b"] / secs["b"]
            frame = mb["f"] / secs["f"]
            pairs.append((base, frame))
            _log(
                f"bench: pair {i + 1}: baseline {base:.1f} MB/s, "
                f"framework {frame:.1f} MB/s, ratio {frame / base:.2f}"
            )
        ratios = sorted(frame / base for base, frame in pairs)
        vs_baseline = ratios[len(ratios) // 2]
        baseline = sorted(base for base, _ in pairs)[len(pairs) // 2]
        value = sorted(frame for _, frame in pairs)[len(pairs) // 2]
        _log(
            f"bench: baseline {baseline:.1f} MB/s median (concurrency 1, "
            f"userspace), framework {value:.1f} MB/s median (concurrency "
            f"{concurrency}, zero-copy), per-pair ratios "
            f"{[round(r, 2) for r in ratios]} -> vs_baseline {vs_baseline:.2f}"
        )

        ablation = None
        if os.environ.get("BENCH_ABLATION", "1") != "0":
            ablation_repeats = max(
                1, int(os.environ.get("BENCH_ABLATION_REPEATS", 3))
            )
            # never inflate the requested workload (same invariant as
            # the slice logic above): one concurrency wave per config
            # when BENCH_JOBS allows it, else exactly what was asked
            ablation_jobs = min(jobs, max(concurrency, jobs // max(1, slices)))
            _log(
                f"bench: ablation, {ablation_repeats} interleaved triples of "
                f"{ablation_jobs} jobs x {mb_per_job} MB per config"
            )
            ablation = run_ablation(
                ablation_jobs, mb_per_job, concurrency, site, ablation_repeats
            )
            _log(
                f"bench: ablation medians: data-path (zero-copy vs userspace "
                f"@ c1) {ablation['data_path_ratio_c1']:.2f}x, concurrency "
                f"(c{concurrency} vs c1, zero-copy fixed) "
                f"{ablation['concurrency_ratio_zero_copy']:.2f}x"
            )

        pipeline_ablation = None
        if os.environ.get("BENCH_PIPELINE", "1") != "0":
            pipeline_repeats = max(
                1, int(os.environ.get("BENCH_PIPELINE_REPEATS", 3))
            )
            pipeline_jobs = min(jobs, max(concurrency, jobs // max(1, slices)))
            _log(
                f"bench: pipeline ablation, {pipeline_repeats} interleaved "
                f"pairs of {pipeline_jobs} jobs x {mb_per_job} MB per config"
            )
            pipeline_ablation = run_pipeline_ablation(
                pipeline_jobs, mb_per_job, concurrency, site, pipeline_repeats
            )
            _log(
                "bench: pipeline ablation median: pipelined vs "
                "store-and-forward "
                f"{pipeline_ablation['pipelined_vs_store_forward']:.2f}x"
            )

        segmented_ablation = None
        if os.environ.get("BENCH_SEGMENTED", "1") != "0":
            segmented_repeats = max(
                1, int(os.environ.get("BENCH_SEGMENTED_REPEATS", 3))
            )
            # LOW job concurrency on purpose: this ablation isolates
            # the per-CONNECTION bandwidth cap the stripe exists to
            # beat. At the headline's concurrency a small host is
            # CPU-bound, not connection-bound, and the ratio would
            # measure scheduler contention instead of the stripe (the
            # concurrency lift has its own ablation above).
            segmented_jobs = max(
                1, int(os.environ.get("BENCH_SEGMENTED_JOBS", 2))
            )
            segmented_conc = max(
                1, int(os.environ.get("BENCH_SEGMENTED_CONCURRENCY", 2))
            )
            _log(
                f"bench: segmented ablation, {segmented_repeats} interleaved "
                f"rounds of {segmented_jobs} jobs x {mb_per_job} MB (large) "
                f"and 4 MB (small, fallback) per arm, concurrency "
                f"{segmented_conc}"
            )
            segmented_ablation = run_segmented_ablation(
                segmented_jobs, mb_per_job, segmented_conc, site,
                segmented_repeats,
            )
            _log(
                "bench: segmented ablation medians: large "
                f"{segmented_ablation['segmented_vs_single_large']:.2f}x, "
                f"small {segmented_ablation['segmented_vs_single_small']:.2f}x"
            )

        multi_source = None
        if os.environ.get("BENCH_MULTI_SOURCE", "1") != "0":
            multi_repeats = max(
                1, int(os.environ.get("BENCH_MULTI_REPEATS", 3))
            )
            # 32 MB: big enough that the mid-job kill reliably lands
            # while spans are still in flight on BOTH origins (a small
            # object can finish before the kill fires, measuring nothing)
            multi_mb = max(8, int(os.environ.get("BENCH_MULTI_MB", 32)))
            multi_throttle = float(
                os.environ.get("BENCH_MULTI_THROTTLE_MBPS", 10.0)
            )
            _log(
                f"bench: multi-source ablation, {multi_repeats} interleaved "
                f"single/multi rounds of one {multi_mb} MB job against an "
                f"origin capped at {multi_throttle} MB/s aggregate, plus a "
                "mid-job primary kill"
            )
            multi_source = run_multi_source_arm(
                site, mb=multi_mb, throttle_mbps=multi_throttle,
                repeats=multi_repeats,
            )
            _log(
                "bench: multi-source ablation median: "
                f"{multi_source['multi_vs_single']:.2f}x vs single-source; "
                "failover completed="
                f"{multi_source['failover']['completed']}, amplification "
                f"{multi_source['failover']['fetch_amplification']:.3f}"
            )

        latency_samples = max(3, int(os.environ.get("BENCH_LATENCY_SAMPLES", 15)))
        _log(f"bench: per-job overhead latency, {latency_samples} tiny jobs")
        tiny = os.path.join(site, "tiny.bin")
        with open(tiny, "wb") as sink:
            sink.write(os.urandom(64 * 1024))
        latency_ms, stage_attribution = run_latency(
            site, latency_samples, concurrency
        )
        _log(
            f"bench: job overhead latency {latency_ms:.1f} ms (median); "
            f"stage medians {json.dumps(stage_attribution)}"
        )

        small_object = None
        if os.environ.get("BENCH_SMALL", "1") != "0":
            small_wave = max(2, int(os.environ.get("BENCH_SMALL_WAVE", 16)))
            small_waves = max(1, int(os.environ.get("BENCH_SMALL_WAVES", 3)))
            _log(
                f"bench: small-object arm, {small_waves} interleaved "
                f"unbatched/batched waves of {small_wave} jobs at "
                "1 KB / 64 KB / 1 MB"
            )
            small_object = run_small_object_arm(
                site, wave=small_wave, waves=small_waves
            )

        overload = None
        if os.environ.get("BENCH_OVERLOAD", "1") != "0":
            _log(
                "bench: overload-shedding arm, quota-protected vs "
                "unprotected interactive latency under a bulk flood"
            )
            overload = run_overload_arm(
                site,
                interactive_jobs=max(
                    2, int(os.environ.get("BENCH_OVERLOAD_JOBS", 6))
                ),
                bulk_jobs=max(
                    1, int(os.environ.get("BENCH_OVERLOAD_BULK", 4))
                ),
            )

        watchdog_ablation = None
        if os.environ.get("BENCH_WATCHDOG", "1") != "0":
            _log(
                f"bench: watchdog ablation, interleaved off/on pairs of "
                f"{latency_samples} tiny jobs"
            )
            watchdog_ablation = run_watchdog_ablation(
                site, latency_samples, concurrency
            )
            _log(
                "bench: watchdog ablation median delta "
                f"{watchdog_ablation['delta_ms']:+.3f} ms/job"
            )

        telemetry_ablation = None
        if os.environ.get("BENCH_TELEMETRY", "1") != "0":
            _log(
                f"bench: telemetry-plane ablation, interleaved off/on "
                f"pairs of {latency_samples} tiny jobs"
            )
            telemetry_ablation = run_telemetry_ablation(
                site, latency_samples, concurrency
            )
            _log(
                "bench: telemetry ablation median delta "
                f"{telemetry_ablation['delta_ms']:+.3f} ms/job"
            )

        canary_ablation = None
        if os.environ.get("BENCH_CANARY", "1") != "0":
            _log(
                f"bench: canary-plane ablation, interleaved off/on "
                f"pairs of {latency_samples} tiny jobs + one corrupt "
                "probe pair"
            )
            canary_ablation = run_canary_ablation(
                site, latency_samples, concurrency
            )
            _log(
                "bench: canary ablation median delta "
                f"{canary_ablation['delta_ms']:+.3f} ms/job; corruption "
                f"detected in {canary_ablation['detect_s']}s"
            )

        profile_arm = None
        if os.environ.get("BENCH_PROFILE", "1") != "0":
            profile_jobs = max(
                10, int(os.environ.get("BENCH_PROFILE_JOBS", 1000))
            )
            _log(
                f"bench: profiling arm, {profile_jobs} small jobs with "
                "the sampling profiler + heap snapshots live"
            )
            profile_arm = run_profile_arm(
                site, profile_jobs, concurrency,
                artifact_dir=os.environ.get("BENCH_PROFILE_DIR") or None,
                root=_bench_root(),
            )
            _log(
                "bench: profile attribution "
                f"{profile_arm['attributed_pct']}% of "
                f"{profile_arm['samples']} samples; stage cpu "
                f"{json.dumps(profile_arm['stage_cpu_pct'])}; waited "
                f"locks {profile_arm['wait_locks']}"
            )

        fleet_chaos = None
        if os.environ.get("BENCH_FLEET", "1") != "0":
            fleet_jobs = max(4, int(os.environ.get("BENCH_FLEET_JOBS", 12)))
            fleet_workers = max(
                2, int(os.environ.get("BENCH_FLEET_WORKERS", 2))
            )
            fleet_spec = os.environ.get(
                "BENCH_FLEET_SPEC", "queue.publish=fail:0.1"
            )
            _log(
                f"bench: fleet chaos arm, {fleet_workers} worker processes "
                f"draining {fleet_jobs} multipart jobs with one mid-drain "
                f"SIGKILL and failpoints '{fleet_spec}'"
            )
            fleet_chaos = run_fleet_chaos_arm(
                jobs=fleet_jobs, workers=fleet_workers, spec=fleet_spec
            )
            _log(
                f"bench: fleet chaos completed {fleet_chaos['completed']}/"
                f"{fleet_chaos['jobs']} in {fleet_chaos['elapsed_s']}s, "
                f"restart {fleet_chaos['restart_s']}s, dangling "
                f"multiparts {fleet_chaos['dangling_multiparts']}"
            )

        fleet_scrape = None
        if os.environ.get("BENCH_FLEETPLANE", "1") != "0":
            scrape_workers = max(
                2, int(os.environ.get("BENCH_FLEETPLANE_WORKERS", 4))
            )
            scrape_timeout = float(
                os.environ.get("BENCH_FLEETPLANE_TIMEOUT_S", 0.5)
            )
            _log(
                f"bench: fleet scrape arm, {scrape_workers} stub workers "
                f"(one wedged) under a {scrape_timeout:g}s per-worker budget"
            )
            fleet_scrape = run_fleet_scrape_arm(
                workers=scrape_workers, timeout_s=scrape_timeout
            )
            _log(
                "bench: fleet scrape healthy "
                f"{fleet_scrape['healthy_ms']}ms, with wedged worker "
                f"{fleet_scrape['wedged_ms']}ms (budget ok: "
                f"{fleet_scrape['within_one_timeout_budget']})"
            )

        flow_accounting = None
        if os.environ.get("BENCH_FLOW", "1") != "0":
            zipf_objects = max(
                2, int(os.environ.get("BENCH_ZIPF_OBJECTS", 16))
            )
            zipf_skew = float(os.environ.get("BENCH_ZIPF_SKEW", 1.1))
            zipf_bytes = max(
                1024, int(os.environ.get("BENCH_ZIPF_BYTES", 64 * 1024))
            )
            zipf_workers = max(
                2, int(os.environ.get("BENCH_ZIPF_WORKERS", 2))
            )
            zipf_requests = max(
                0, int(os.environ.get("BENCH_ZIPF_REQUESTS", 0))
            )
            _log(
                f"bench: flow-accounting arm, {zipf_workers} cache-less "
                f"workers x {zipf_objects} zipf-sized objects "
                f"(skew {zipf_skew:g}, mean {zipf_bytes} B, "
                f"{zipf_requests} replay requests per worker)"
            )
            flow_accounting = run_flow_accounting_arm(
                site,
                objects=zipf_objects,
                skew=zipf_skew,
                mean_bytes=zipf_bytes,
                workers=zipf_workers,
                requests=zipf_requests,
            )
            _log(
                "bench: flow accounting fleet amplification "
                f"{flow_accounting['origin_amplification']} "
                f"(naive ratio average "
                f"{flow_accounting['naive_ratio_average']}), hot object "
                f"share {flow_accounting['hot_object_share']}"
            )

        single_flight = None
        if os.environ.get("BENCH_SINGLEFLIGHT", "1") != "0":
            sf_workers = max(
                2, int(os.environ.get("BENCH_SINGLEFLIGHT_WORKERS", 2))
            )
            sf_objects = max(
                1, int(os.environ.get("BENCH_SINGLEFLIGHT_OBJECTS", 3))
            )
            sf_bytes = max(
                64 * 1024,
                int(os.environ.get("BENCH_SINGLEFLIGHT_BYTES", 512 * 1024)),
            )
            sf_throttle = float(
                os.environ.get("BENCH_SINGLEFLIGHT_THROTTLE_MBPS", 3.0)
            )
            _log(
                f"bench: single-flight arm, {sf_workers} worker processes "
                f"x {sf_objects} zipf-sized objects (mean {sf_bytes} B) "
                f"demanded once per worker, origin at {sf_throttle:g} MB/s, "
                "cache off then on"
            )
            single_flight = run_single_flight_arm(
                workers=sf_workers,
                objects=sf_objects,
                mean_bytes=sf_bytes,
                throttle_mbps=sf_throttle,
            )
            _log(
                "bench: single-flight amplification "
                f"{single_flight['singleflight_amp']} cache-on vs "
                f"{single_flight['singleflight_amp_off']} cache-off "
                f"(hit ratio {single_flight['cache_hit_ratio']}, origin "
                f"GETs {single_flight['cache_on']['origin_gets']} on / "
                f"{single_flight['cache_off']['origin_gets']} off)"
            )

        extra_metrics = [
            {
                "metric": "job_overhead_latency_ms",
                "value": round(latency_ms, 1),
                "unit": "ms",
                # per-stage medians from the span traces: fetch is the
                # source round trip, publish the confirm-gated Convert
                # hand-off; dequeue/decode/ack (+ inter-stage gaps) are
                # the framework's own overhead. A drift in the headline
                # must show up in a named stage here.
                "stages_ms": stage_attribution,
                "tracing": "enabled",
            },
            {
                # per-pair evidence for the contract number: one noisy
                # pair must be visible, not silently folded in
                "metric": "throughput_pairs",
                "unit": "MB/s",
                "pairs": [
                    {"baseline": round(b, 1), "framework": round(f, 1),
                     "ratio": round(f / b, 2)}
                    for b, f in pairs
                ],
            },
        ]
        if ablation is not None:
            extra_metrics.append(ablation)
        if pipeline_ablation is not None:
            extra_metrics.append(pipeline_ablation)
        if segmented_ablation is not None:
            extra_metrics.append(segmented_ablation)
        if multi_source is not None:
            extra_metrics.append(multi_source)
        if small_object is not None:
            extra_metrics.append(small_object)
        if overload is not None:
            extra_metrics.append(overload)
        if watchdog_ablation is not None:
            extra_metrics.append(watchdog_ablation)
        if telemetry_ablation is not None:
            extra_metrics.append(telemetry_ablation)
        if canary_ablation is not None:
            extra_metrics.append(canary_ablation)
        if profile_arm is not None:
            extra_metrics.append(profile_arm)
        if fleet_chaos is not None:
            extra_metrics.append(fleet_chaos)
        if fleet_scrape is not None:
            extra_metrics.append(fleet_scrape)
        if flow_accounting is not None:
            extra_metrics.append(flow_accounting)
        if single_flight is not None:
            extra_metrics.append(single_flight)
        if os.environ.get("BENCH_DIGEST", "1") != "0":
            _log("bench: digest kernel micro-benchmark (cuda vs hashlib)")
            digest = run_digest_arm(piece_kb=256, batch=1024)
            _log(f"bench: digest kernel {json.dumps(digest)}")
            extra_metrics.append(
                {"metric": "digest_kernel", "unit": "GB/s", **digest}
            )

        # one JSON line, as bench.py prints it; the secondary
        # metrics ride along as extra keys
        report = {
            "metric": "e2e_fetch_upload_MBps",
            "value": round(value, 1),
            "unit": "MB/s",
            "vs_baseline": round(vs_baseline, 2),
            "extra_metrics": extra_metrics,
        }
        from bench_digest_torch import digest_line

        _log(f"bench: digest {json.dumps(digest_line(report))}")
        print(json.dumps(report))
    finally:
        shutil.rmtree(site, ignore_errors=True)


if __name__ == "__main__":
    main()
