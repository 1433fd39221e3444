"""Readings from which the correctness limits are set: sound runs of the
program, the lower-precision control, and the planted faults
(``cptbench/faults.py``), each on the given seeds, in one process.

    python benchmark/calibrate.py --workload <cell> --kinds sound,control,unchanged,half,altered \\
        --seeds 11,12,13 [--seconds 3]

Prints one JSON line per seed: the kind, the seed, ``correct`` and every
compared number beside its present limit. Needs a CUDA device. For a
training cell the control needs no window: it is the reference itself with
bfloat16 carries, put in the program's place for the first steps of the
seed's first job and held against the float32 reference. Each job kind
plants its own control and faults (``plant`` and ``control_line`` in
``jobs/<kind>.py``).
"""
import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from cptbench import faults, manifest, runner  # noqa: E402


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
    for kind in args.kinds.split(","):
        if kind not in ("sound",) + faults.KINDS:
            p.error(f"unknown kind {kind!r}")
        for seed in (int(s) for s in args.seeds.split(",")):
            line = faults.line(cell, kind, seed, args.seconds)
            print(json.dumps(dict(kind=kind, workload=args.workload, seed=seed,
                                  correct=line["correct"], checks=line["checks"],
                                  metrics=line.get("metrics"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
