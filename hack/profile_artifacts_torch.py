#!/usr/bin/env python3
"""The PyTorch/CUDA port's profiling artifacts: run the port's profiling
arm (``hack/pipeline_torch.run_profile_arm``), a wave of small jobs
through its hermetic pipeline with the sampling profiler and heap
snapshots live, and write the collapsed CPU stacks
(``bench.collapsed``), their SVG flamegraph (``bench.svg``) and the
attribution report (``profile.json``) into ``out_dir``.

Usage: ``python hack/profile_artifacts_torch.py [out_dir] [jobs]``
(defaults: ``/tmp/profile-torch``, 300 jobs). Exits 1 when the sampler
took no sample.
"""

import json
import os
import sys
import tempfile


def main() -> int:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from hack.pipeline_torch import quiet_logging, run_profile_arm

    quiet_logging()

    out_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/profile-torch"
    jobs = int(sys.argv[2]) if len(sys.argv) > 2 else 300
    with tempfile.TemporaryDirectory(prefix="profile-artifact-") as site:
        with open(os.path.join(site, "tiny.bin"), "wb") as sink:
            sink.write(os.urandom(64 * 1024))
        report = run_profile_arm(site, jobs, concurrency=2, artifact_dir=out_dir)
    with open(os.path.join(out_dir, "profile.json"), "w") as sink:
        json.dump(report, sink, indent=1)
    print(
        json.dumps(
            {
                key: report[key]
                for key in (
                    "jobs", "samples", "attributed_pct",
                    "stage_cpu_pct", "wait_locks", "modes_served",
                )
            }
        )
    )
    # a run whose sampler never sampled means the plane is broken: say
    # so here rather than store an empty flamegraph
    if not report["samples"]:
        print("profile_artifacts_torch: no samples taken", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
