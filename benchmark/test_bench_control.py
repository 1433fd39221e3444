"""Tests on the card: the correctness control and each planted fault must
make a run come out not correct (``cptbench/faults.py``), at each cell's own
size, on three seeds. Marked ``cuda``; without a card they skip. Run on the
card with ``python -m pytest benchmark/test_bench_control.py -m cuda``."""
import os
import sys

import pytest
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from cptbench import faults, manifest, runner  # noqa: E402

SEEDS = (2 ** 31 + 101, 2 ** 32 + 202, 303)
CELLS = [w["name"] for w in manifest.load()["workloads"]]
# each kind breaks the path the cell runs, as the cell's job kind plants it
# (``plant`` / ``control_line`` in ``jobs/<kind>.py``)
FAULTS = [(c, k) for c in CELLS for k in faults.KINDS]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner.cache_env(manifest.ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kind", FAULTS)
def test_control_and_faults_are_not_correct(card, cell, kind):
    c = manifest.cell(manifest.load(), cell)
    for seed in SEEDS:
        line = faults.line(c, kind, seed, 2.0)
        assert not line["correct"], (cell, kind, seed, line["checks"])
