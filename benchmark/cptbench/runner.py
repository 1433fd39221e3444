"""One run of one cell: set-up, the measured window, the check, the line.

``main`` is what ``benchmark/run.py`` runs. ``run_cell`` is the same run
without the look for a chip, for tests that drive it on the CPU or with the
timed path broken underneath.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, Optional

from . import isolation, manifest, trace


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def cache_env(root: str) -> None:
    """Every build and kernel cache of the program at a fixed path inside the
    checkout, so that only the first run of a checkout builds."""
    base = os.path.join(root, ".bench_cache")
    os.environ["CPT_TORCH_BUILD_DIR"] = os.path.join(base, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


class Slicer:
    """Profiles a short steady slice of the window: the job calls ``begin``
    and ``end`` at unit boundaries; ``summary`` is the trace's reduction
    (``trace.summarize``). Disabled, both calls do nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.summary: Optional[dict] = None
        self._stack = None
        self._dir = None

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start is
        slow."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                pass

    def begin(self) -> None:
        if not self.enabled or self.active or self.summary is not None:
            return
        import torch
        from cuda_path_tracer_ss_torch.utils import profiling

        torch.cuda.synchronize()
        self._dir = tempfile.mkdtemp(prefix="bench_trace_")
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(profiling.trace(self._dir))
        self._stack.enter_context(torch.profiler.record_function(trace.SLICE))
        self.active = True

    def end(self) -> None:
        if not self.active:
            return
        import torch
        from cuda_path_tracer_ss_torch.utils import profiling

        torch.cuda.synchronize()
        self._stack.close()
        self.active = False
        path = os.path.join(self._dir, profiling.TRACE_FILE)
        try:
            self.summary = trace.summarize(trace.load(path))
        finally:
            os.remove(path)
            os.rmdir(self._dir)


class Run:
    """What a job and a metric reader see of one run."""

    def __init__(self, cell: dict, seed: int, seconds: float, traced: bool,
                 device: str):
        self.cell = cell
        self.name = cell["entry"]["name"]
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = traced
        self.device = device
        self.setup_s: Optional[float] = None
        self.window: Dict = {}
        self.trace: Optional[dict] = None
        self.job = None
        self._work: Dict[str, object] = {}

    def kernel_work(self, symbol: str):
        """(float32 operations, bytes) the traced slice's launches of kernel
        ``symbol`` needed, from the reference's tally; None where the job
        has no such launches."""
        if symbol not in self._work:
            self._work[symbol] = self.job.slice_work(symbol)
        return self._work[symbol]


def compare(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}, how many failed): each number at or
    under its limit; a number that is missing or not finite fails."""
    out, failed = {}, 0
    for name, limit in limits.items():
        v = numbers.get(name)
        failed += not (v is not None and math.isfinite(v) and v <= limit)
        out[name] = {"value": v, "limit": limit}
    return failed == 0, out, failed


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Set up, measure, check; returns the result line as a dict."""
    import torch

    on_card = torch.device(device).type == "cuda"
    t_start = time.time() if t_start is None else t_start
    run = Run(cell, seed, seconds, traced, device)
    slicer = Slicer(traced and on_card)
    run.job = job = cell["job"].Job(run)
    job.setup()
    slicer.warm()
    if on_card:
        torch.cuda.synchronize()
    run.setup_s = time.time() - t_start
    run.window = job.window(seconds, slicer)
    if slicer.active:
        slicer.end()
    run.trace = slicer.summary
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    job.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = job.check()
    correct, compared, failed = compare(numbers, cell["limits"])
    kinds = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = {}
    for m in kinds:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    line = {"correct": correct, "attempted": int(run.window["units"]),
            "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = compared
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = process_start() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    cache_env(manifest.ROOT)

    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    "cuda", t_start)
    banned = isolation.banned_loaded()
    if banned:
        print("error: the run loaded modules it may not load: "
              + ", ".join(banned), file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
