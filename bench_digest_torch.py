"""Digest-kernel micro-benchmark of the PyTorch/CUDA port: the CUDA
SHA-1 kernel against hashlib. The twin of ``bench_digest.py``.

Measures, on the card:

- ``hashlib_GBps``: single-thread CPython hashlib over the batch, what
  the reference effectively uses (anacrolix/torrent's CPU hasher,
  reference internal/downloader/torrent/torrent.go:79-106).
- ``cuda_GBps``: the kernel on device-resident data, one launch timed
  with CUDA events (``cuda_call_ms``); ``cuda_sustained_GBps`` from
  R = 2 against R = 32 back-to-back launches, median of 5.
- ``transfer_MBps`` / ``sync_ms``: the ``DigestEngine`` calibration
  that decides whether streaming workloads offload at all
  (``parallel/engine.py``: ``_worth_offloading``).

Every digest of the check batch and of the timing batch is held
against hashlib before anything is timed. There is no fallback: with
no card, or a kernel that does not build or launch, :func:`measure`
raises and ``python bench_digest_torch.py`` exits non-zero; a wrong
digest sets ``cuda_digest_mismatches`` and exits 1. ``device="cpu"``
runs the plain PyTorch SHA-1 (``parallel/sha1.py``) through the same
gates and times nothing; the tests use it.

Standalone: ``python bench_digest_torch.py`` prints one JSON line per
batch shape. ``bench_torch.py`` runs :func:`measure` in a child
process for its ``digest_kernel`` metric and folds its report with
:func:`digest_line`.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

SUSTAINED_REPS = (2, 32)
SUSTAINED_SAMPLES = 5


def _log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def digest_line(report: dict) -> dict:
    """Fold a full bench_torch.py report into one flat summary line: the
    headline plus every ablation's contract number, so a reader sees
    the whole run without walking the nested ``extra_metrics`` list."""
    out: dict = {
        "e2e_MBps": report.get("value"),
        "vs_baseline": report.get("vs_baseline"),
    }
    for extra in report.get("extra_metrics", []):
        metric = extra.get("metric")
        if metric == "job_overhead_latency_ms":
            out["overhead_ms"] = extra.get("value")
        elif metric == "ablation":
            out["data_path_x"] = extra.get("data_path_ratio_c1")
            out["concurrency_x"] = extra.get("concurrency_ratio_zero_copy")
        elif metric == "pipeline_overlap":
            out["pipeline_x"] = extra.get("pipelined_vs_store_forward")
        elif metric == "segmented_vs_single":
            out["segmented_large_x"] = extra.get("segmented_vs_single_large")
            out["segmented_small_x"] = extra.get("segmented_vs_single_small")
            rounds = extra.get("rounds") or []
            if rounds:
                arm = rounds[-1]["arms"].get("segmented_large", {})
                out["segmented_overlap_ratio"] = arm.get("overlap_ratio")
                out["segmented_pool_reuse_hits"] = arm.get("pool_reuse_hits")
        elif metric == "multi_source":
            out["multi_source_x"] = extra.get("multi_vs_single")
            failover = extra.get("failover") or {}
            out["multi_failover_completed"] = failover.get("completed")
            out["multi_failover_amplification"] = failover.get(
                "fetch_amplification"
            )
        elif metric == "small_object_overhead":
            sizes = extra.get("sizes") or {}
            for label in ("1k", "64k", "1m"):
                entry = sizes.get(label)
                if not entry:
                    continue
                out[f"small_{label}_batched_p50_ms"] = entry.get(
                    "batched_p50_ms"
                )
                out[f"small_{label}_x"] = entry.get("batched_vs_unbatched")
        elif metric == "overload_shedding":
            protected = extra.get("protected") or {}
            unprotected = extra.get("unprotected") or {}
            out["overload_protected_p99_ms"] = protected.get(
                "interactive_p99_ms"
            )
            out["overload_unprotected_p99_ms"] = unprotected.get(
                "interactive_p99_ms"
            )
            out["overload_shed_jobs"] = protected.get("shed_jobs")
            out["overload_protection_x"] = extra.get("protection_ratio")
        elif metric == "watchdog_overhead":
            out["watchdog_ms"] = extra.get("delta_ms")
        elif metric == "telemetry_overhead":
            out["telemetry_ms"] = extra.get("delta_ms")
        elif metric == "digest_kernel":
            out["hashlib_GBps"] = extra.get("hashlib_GBps")
            out["cuda_GBps"] = extra.get("cuda_GBps")
            # the port's measure() never writes these (it raises
            # instead); a report folded from elsewhere keeps them
            if extra.get("device_reason"):
                out["device_reason"] = extra["device_reason"]
            if extra.get("device_incident"):
                out["device_incident"] = extra["device_incident"]
        elif metric == "profile_attribution":
            out["profile_attributed_pct"] = extra.get("attributed_pct")
            out["profile_top_cpu_role"] = extra.get("top_cpu_role")
            stages = extra.get("stage_cpu_pct") or {}
            for stage, pct in stages.items():
                out[f"profile_cpu_{stage}_pct"] = pct
        elif metric == "fleet_chaos":
            out["fleet_completed"] = (
                f"{extra.get('completed')}/{extra.get('jobs')}"
            )
            out["fleet_restart_s"] = extra.get("restart_s")
            out["fleet_dangling_multiparts"] = extra.get(
                "dangling_multiparts"
            )
            out["fleet_duplicate_converts"] = extra.get(
                "duplicate_converts"
            )
        elif metric == "fleet_scrape":
            out["fleet_scrape_ms"] = extra.get("healthy_ms")
            out["fleet_scrape_wedged_ms"] = extra.get("wedged_ms")
            out["fleet_scrape_budget_ok"] = extra.get(
                "within_one_timeout_budget"
            )
        elif metric == "flow_accounting":
            out["origin_amplification"] = extra.get("origin_amplification")
            out["hot_object_share"] = extra.get("hot_object_share")
        elif metric == "single_flight":
            out["cache_hit_ratio"] = extra.get("cache_hit_ratio")
            out["singleflight_amp"] = extra.get("singleflight_amp")
            out["singleflight_amp_off"] = extra.get("singleflight_amp_off")
        elif metric == "canary_probe":
            out["canary_ms"] = extra.get("delta_ms")
            out["canary_detect_s"] = extra.get("detect_s")
    return out


def _mismatches(states, pieces) -> int:
    """Lanes of the (5, P) device states whose digest is not hashlib's."""
    import hashlib

    from downloader_tpu_torch.parallel.pack import digests_to_bytes

    got = digests_to_bytes(states.cpu().numpy(), len(pieces))
    return sum(
        digest != hashlib.sha1(piece).digest()
        for digest, piece in zip(got, pieces)
    )


def _on(device, pieces):
    """Pieces packed in the kernel's layout, as tensors on ``device``."""
    import numpy as np
    import torch

    from downloader_tpu_torch.parallel.pack import pack_pieces

    blocks, nblocks = pack_pieces(pieces)
    return (
        torch.from_numpy(blocks.view(np.int32)).to(device),
        torch.from_numpy(nblocks).to(device),
    )


def _event_ms(launch, count: int) -> float:
    """Milliseconds of ``count`` back-to-back launches, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def measure(
    piece_kb: int = 256, batch: int = 1024, reps: int = 3, device=None
) -> dict:
    """One shape; returns the metrics dict. ``device=None`` is the first
    CUDA device and raises without one; ``"cpu"`` runs the plain
    version through the correctness gates and times nothing."""
    import hashlib

    import numpy as np

    rng = np.random.default_rng(0)
    pieces = [rng.bytes(piece_kb * 1024) for _ in range(batch)]
    total_bytes = piece_kb * 1024 * batch

    start = time.monotonic()
    for piece in pieces:
        hashlib.sha1(piece).digest()
    hashlib_gbps = total_bytes / (time.monotonic() - start) / 1e9

    result = {
        "piece_kb": piece_kb,
        "batch": batch,
        "hashlib_GBps": round(hashlib_gbps, 2),
    }

    import torch

    from downloader_tpu_torch.parallel import sha1_cuda
    from downloader_tpu_torch.parallel.engine import DigestEngine

    launches_before = sha1_cuda.launches
    engine = DigestEngine(device=device)
    target = engine.devices[0]
    on_card = target.type == "cuda"
    result["device"] = (
        f"{target} {torch.cuda.get_device_name(target)}" if on_card else str(target)
    )
    _, transfer_bps, sync_s, _ = engine._calibrate()
    result["transfer_MBps"] = round(transfer_bps / 1e6, 1)
    result["sync_ms"] = round(sync_s * 1e3, 1)
    result["offload_wins_streaming"] = engine._worth_offloading(pieces)

    # full-batch correctness gate BEFORE any timing: 1031 pieces fill
    # more than one 1024-lane tile (a ragged second one), the short
    # piece takes the mask path, the empty one the lone padding block
    check_pieces = [rng.bytes(4096) for _ in range(1029)] + [rng.bytes(1000), b""]
    bad = _mismatches(sha1_cuda.sha1_states(*_on(target, check_pieces)), check_pieces)
    if not bad:
        blocks, nblocks = _on(target, pieces)
        if on_card:
            _log(
                f"bench_digest_torch: {blocks.numel() * 4 >> 20} MB on "
                f"{target} (compute is timed device-resident)"
            )
        # the timing batch itself must also be fully right
        bad = _mismatches(sha1_cuda.sha1_states(blocks, nblocks), pieces)
        if bad:
            _log(
                "bench_digest_torch: KERNEL VALIDATION FAILED on the timing "
                f"batch: {bad} lanes wrong; refusing to time a broken kernel"
            )
    else:
        _log(
            "bench_digest_torch: KERNEL VALIDATION FAILED: "
            f"{bad}/{len(check_pieces)} digests wrong; refusing to time a "
            "broken kernel"
        )
    result["cuda_digest_mismatches"] = bad
    if bad:
        result["cuda_GBps"] = None
    elif on_card:

        def launch():
            sha1_cuda.sha1_batch_cuda(blocks, nblocks)

        call_ms = min(_event_ms(launch, 1) for _ in range(reps))
        result["cuda_call_ms"] = round(call_ms, 3)
        result["cuda_GBps"] = round(total_bytes / (call_ms / 1e3) / 1e9, 2)
        low, high = SUSTAINED_REPS
        lows = [_event_ms(launch, low) for _ in range(SUSTAINED_SAMPLES)]
        highs = [_event_ms(launch, high) for _ in range(SUSTAINED_SAMPLES)]
        per_pass_ms = (statistics.median(highs) - statistics.median(lows)) / (
            high - low
        )
        result["cuda_sustained_GBps"] = (
            round(total_bytes / (per_pass_ms / 1e3) / 1e9, 2)
            if per_pass_ms > 0
            else None
        )
    result["cuda_launches"] = sha1_cuda.launches - launches_before
    return result


def main() -> int:
    broken = False
    for piece_kb, batch in ((256, 1024), (256, 128), (16, 1024)):
        metrics = measure(piece_kb, batch)
        print(json.dumps({"metric": "digest_kernel", **metrics}), flush=True)
        broken = broken or bool(metrics["cuda_digest_mismatches"])
    # a wrong-answer kernel must not look like a clean run
    return 1 if broken else 0


if __name__ == "__main__":
    sys.exit(main())
