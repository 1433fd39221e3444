"""Run one benchmark cell once and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/README.md``.
"""
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the harness's own package, and the checkout's root, where the program is
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from cptbench import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main())
