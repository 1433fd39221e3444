"""Readings from which the correctness limits are set: sound runs of the
program, the lower-precision control, and the planted faults
(``cptbench/faults.py``), each on the given seeds, in one process.

    python benchmark/calibrate.py --workload <cell> --kinds sound,control,unchanged,half,altered \\
        --seeds 11,12,13 [--seconds 3]

Prints one JSON line per seed: the kind, the seed, ``correct`` and every
compared number beside its present limit. Needs a CUDA device. For a
training cell the control needs no window: it is the reference itself with
bfloat16 carries, put in the program's place for the first steps of the
seed's first job and held against the float32 reference.
"""
import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import torch  # noqa: E402

from cptbench import checks, faults, inputs, manifest, runner  # noqa: E402


def fit_control(cell: dict, seed: int) -> dict:
    """The reference with bfloat16 carries against the float32 reference,
    over the first steps of job 0 of ``seed``."""
    from cptbench.reference import fit

    run = runner.Run(cell, seed, 0.0, False, "cuda")
    job = cell["job"].Job(run)
    job.setup()
    arrays, job_seed = job._start(0)
    start = {k: torch.from_numpy(arrays[k].copy()) for k in job.fields}
    args = (inputs.scene_tensors(job.arrays), start, job.cam, job_seed,
            cell["traffic"]["checked_steps"], job.lr, job.resample, job.width,
            job.height, job.spp, job.bounces, job.target, job.physical, "cuda")
    numbers, _ = checks.training_numbers(fit.follow(*args, state_bf16=True),
                                         fit.follow(*args), start)
    ok, compared, _ = runner.compare(numbers, cell["limits"])
    return dict(correct=ok, checks=compared)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--kinds", required=True,
                   help="comma-separated: sound and any of " + ", ".join(faults.KINDS))
    p.add_argument("--seeds", required=True,
                   help="comma-separated, for every kind")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    runner.cache_env(manifest.ROOT)
    cell = manifest.cell(manifest.load(), args.workload)
    training = cell["traffic"]["job"] == "fit"
    for kind in args.kinds.split(","):
        if kind not in ("sound",) + faults.KINDS:
            p.error(f"unknown kind {kind!r}")
        for seed in (int(s) for s in args.seeds.split(",")):
            if kind == "control" and training:
                line = fit_control(cell, seed)
            elif kind == "sound":
                line = runner.run_cell(cell, seed, args.seconds, False)
            else:
                with faults.planted(kind):
                    line = runner.run_cell(cell, seed, args.seconds, False)
            print(json.dumps(dict(kind=kind, workload=args.workload, seed=seed,
                                  correct=line["correct"], checks=line["checks"],
                                  metrics=line.get("metrics"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
