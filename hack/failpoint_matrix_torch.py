#!/usr/bin/env python3
"""Per-seed failpoint matrix over the PyTorch/CUDA port: run the port's
hermetic pipeline (``hack/pipeline_torch.py``) under a fixed fault spec
at several FAILPOINT_SEEDs and write the outcome table CI stores as an
artifact.

For each seed the harness records the pure decision schedule
fingerprint (re-running a seed must reproduce it, call for call), the
injections each site landed, and the at-least-once outcome: jobs
completed, dangling multipart uploads (must be zero), and the admission
ledger's outstanding charges (must be empty). The SIGKILL-mid-coalesce
cell runs the port's fleet with its coalesce leader killed mid-fetch
(``hack/fleet_torch.py``).

Usage: python hack/failpoint_matrix_torch.py OUTDIR [seed ...]
Knobs: FAILPOINT_MATRIX_SPEC (the armed sites; a fail-heavy default),
FAILPOINT_MATRIX_JOBS (default 8). Exits 1 when any seed loses a job,
leaves a dangling upload, or leaks a ledger charge, or when the
coalesce cell fails. The payload is written under OUTDIR and removed
after the run.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULT_SEEDS = (509, 1307, 9001)
DEFAULT_SPEC = (
    "s3.part_put=fail:0.15,queue.publish=fail:0.2,"
    "net.connect=fail:0.05,http.read=fail:0.1,"
    # the fleet data plane's seams ride the same spec: the hermetic
    # pipeline runs without a cache (0 injections is expected), but the
    # schedule fingerprint still receipts their determinism, and the
    # SIGKILL-mid-coalesce cell exercises them for real
    "cas.lookup=fail:0.2,cas.put=fail:0.2,"
    "coalesce.join=fail:0.2,coalesce.lead=fail:0.1"
)
SITES = (
    "s3.part_put", "queue.publish", "net.connect", "http.read",
    "cas.lookup", "cas.put", "coalesce.join", "coalesce.lead",
)
# the cell that cannot run in-process: the elected coalesce leader
# process dies (SIGKILL, no finally blocks) while followers wait on its
# lease. The port's fleet walk runs as a script of its own, on the port
# alone (the fleet tests drive the same walk over both packages)
COALESCE_KILL_CELL = "hack/fleet_torch.py"
COALESCE_KILL_SPEC = "segments.pwrite=kill:1:16"
PAYLOAD_NAME = "fp_payload.mkv"  # a media name, or the scan stores nothing
PAYLOAD_BYTES = 256 * 1024


def schedule_fingerprint(registry, sites, calls: int = 200) -> str:
    """sha256 over the first ``calls`` pure decisions at every armed
    site: the receipt a failing run is reproduced from."""
    digest = hashlib.sha256()
    for site in sites:
        bits = "".join(
            "1" if hit else "0" for hit in registry.schedule(site, calls)
        )
        digest.update(f"{site}:{bits};".encode())
    return digest.hexdigest()[:16]


def run_seed(seed: int, spec: str, jobs: int, site: str) -> dict:
    """``jobs`` jobs of ``site``'s payload through the port's pipeline
    with ``spec`` armed at ``seed``."""
    from hack.pipeline_torch import Pipeline
    from downloader_tpu_torch.utils import admission
    from downloader_tpu_torch.utils.failpoints import FAILPOINTS

    FAILPOINTS.configure(spec, seed=seed)
    fingerprint = schedule_fingerprint(FAILPOINTS, SITES)
    started = time.monotonic()
    completed = 0
    error = ""
    pipeline = Pipeline(
        concurrency=2,
        prefetch=8,
        site=site,
        payload=PAYLOAD_NAME,
        multipart_threshold=64 * 1024,
        part_size=64 * 1024,
        batch_jobs=1,
    )
    dangling = -1
    try:
        for index in range(jobs):
            pipeline.publish_job(index, media_id=f"matrix-{seed}-{index}")
        try:
            pipeline.wait_converts(jobs, timeout=180.0)
            completed = jobs
        except RuntimeError as exc:
            completed = len(pipeline.converts)
            error = str(exc)
        # the seams must stop firing before teardown aborts run
        # through the same (injected) store path
        snapshot = FAILPOINTS.snapshot()
        FAILPOINTS.reset()
        client = pipeline.uploader._client
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            dangling = len(client.list_multipart_uploads(pipeline.config.bucket))
            if dangling == 0:
                break
            time.sleep(0.2)
    finally:
        FAILPOINTS.reset()
        pipeline.close()
    outstanding = admission.LEDGER.outstanding()
    admission.CONTROLLER.reset()
    return {
        "seed": seed,
        "spec": spec,
        "schedule_fingerprint": fingerprint,
        "jobs": jobs,
        "completed": completed,
        "elapsed_s": round(time.monotonic() - started, 2),
        "injections": {
            name: entry["injected"] for name, entry in snapshot["sites"].items()
        },
        "dangling_multiparts": dangling,
        "ledger_outstanding": list(outstanding),
        "error": error,
        "ok": completed == jobs and dangling == 0 and not outstanding,
    }


def run_coalesce_kill_cell(outdir: str, seed: int = 509) -> dict:
    """SIGKILL-mid-coalesce: the port's 2-worker fleet in which a seeded
    kill failpoint SIGKILLs the elected coalesce leader mid-multipart;
    it passes when a follower promotes itself, every job completes
    under its original trace id, the dead worker restarts and no
    multipart upload is left open. It runs as a subprocess
    (``hack/fleet_torch.py``), whose last line reports its verdict and
    the modules it imported."""
    started = time.monotonic()
    env = dict(os.environ)
    env["FAILPOINT_SEED"] = str(seed)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, COALESCE_KILL_CELL), outdir],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    # the workers' logs first: the cell's verdict line stays the last
    lines = (proc.stderr.strip() + "\n" + proc.stdout.strip()).strip().splitlines()
    tail = "\n".join(lines[-12:])
    return {
        "cell": "sigkill-mid-coalesce",
        "seed": seed,
        "spec": COALESCE_KILL_SPEC,
        # the reference names its pytest node here; the port's cell is
        # the script it runs
        "test": COALESCE_KILL_CELL,
        "elapsed_s": round(time.monotonic() - started, 2),
        "rc": proc.returncode,
        "tail": tail,
        "ok": proc.returncode == 0,
    }


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    outdir = argv[1]
    seeds = [int(raw, 0) for raw in argv[2:]] or list(DEFAULT_SEEDS)
    spec = os.environ.get("FAILPOINT_MATRIX_SPEC", DEFAULT_SPEC)
    jobs = int(os.environ.get("FAILPOINT_MATRIX_JOBS", "8"))
    os.makedirs(outdir, exist_ok=True)

    from hack.pipeline_torch import quiet_logging
    from downloader_tpu_torch.utils.failpoints import FailpointRegistry

    quiet_logging()
    rows = []
    coalesce_cell = None
    try:
        with tempfile.TemporaryDirectory(prefix="payload-", dir=outdir) as site:
            with open(os.path.join(site, PAYLOAD_NAME), "wb") as sink:
                sink.write(os.urandom(PAYLOAD_BYTES))
            for seed in seeds:
                print(f"failpoint-matrix-torch: seed {seed} ...", flush=True)
                row = run_seed(seed, spec, jobs, site)
                print(
                    f"failpoint-matrix-torch: seed {seed} -> "
                    f"{row['completed']}/{row['jobs']} jobs, injections "
                    f"{row['injections']}, dangling "
                    f"{row['dangling_multiparts']}, ok={row['ok']}",
                    flush=True,
                )
                rows.append(row)
                # the determinism receipt: re-deriving the schedule must
                # reproduce the fingerprint bit for bit
                registry = FailpointRegistry()
                registry.configure(spec, seed=seed)
                replay = schedule_fingerprint(registry, SITES)
                assert replay == row["schedule_fingerprint"], (
                    f"seed {seed} schedule not reproducible: "
                    f"{replay} != {row['schedule_fingerprint']}"
                )
        print("failpoint-matrix-torch: sigkill-mid-coalesce cell ...", flush=True)
        coalesce_cell = run_coalesce_kill_cell(outdir)
        print(
            "failpoint-matrix-torch: sigkill-mid-coalesce -> "
            f"rc={coalesce_cell['rc']}, ok={coalesce_cell['ok']}",
            flush=True,
        )
    finally:
        with open(os.path.join(outdir, "failpoint_matrix.json"), "w") as sink:
            json.dump(
                {
                    "spec": spec,
                    "jobs": jobs,
                    "seeds": rows,
                    "sigkill_mid_coalesce": coalesce_cell,
                },
                sink, indent=1,
            )
    ok = rows and all(row["ok"] for row in rows)
    return 0 if ok and coalesce_cell and coalesce_cell["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
