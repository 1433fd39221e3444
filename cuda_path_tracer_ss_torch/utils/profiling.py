"""Profiling and observability.

The reference's entire story is one cudaEvent pair + a console line
(``CudaTracer.h:37``, ``CudaTracer.cu:611-646``). Here:

* ``sync``: wait for the device (``torch.cuda.synchronize`` on a card, a
  no-op on the CPU) — PyTorch returns before the device finishes, so a host
  clock is read only after it.
* ``timed``: time a callable, warm-up excluded; CUDA events on a card, the
  host clock on the CPU.
* ``trace``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) of the block into a
  directory: host operations always, device kernels and copies on a card.
* ``PassMeter``: running rays/s, spp, and per-pass ms; renders the reference's
  one-line console format or structured JSONL.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


def sync(device) -> None:
    """Block until all work queued on ``device`` has finished."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, *args, reps: int = 3, warmup: int = 1, device="cuda"):
    """(result, seconds_per_call) over ``reps`` calls after ``warmup``."""
    device = torch.device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = fn(*args)
            end.record()
            end.synchronize()
        return out, start.elapsed_time(end) * 1e-3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    return out, (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: yields the ``torch.profiler.profile`` (its
    ``key_averages()`` and ``events()`` are read after the block) and writes
    its Chrome trace to ``log_dir/trace.json``. CPU activity always, CUDA
    activity too when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class PassMeter:
    """Per-pass metrics accumulator; the analog of the reference's
    'Rays per pixel: N  Time per pass: ms' line (CudaTracer.cu:645)."""

    def __init__(self, width: int, height: int, jsonl_path: Optional[str] = None):
        self.width = width
        self.height = height
        self.jsonl_path = jsonl_path
        self.samples = 0
        self.total_time = 0.0

    def record(self, samples_this_pass: int, seconds: float) -> dict:
        self.samples += samples_this_pass
        self.total_time += seconds
        m = {
            "pass_samples": samples_this_pass,
            "samples_per_pixel": self.samples,
            "pass_time_s": seconds,
            "primary_rays_per_s": self.width * self.height * samples_this_pass / seconds,
            "avg_rays_per_s": self.width * self.height * self.samples / self.total_time,
        }
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(m) + "\n")
        return m

    def console_line(self, m: dict) -> str:
        return (f"Rays per pixel: {m['samples_per_pixel']}  "
                f"Time per pass: {m['pass_time_s'] * 1e3:.1f} ms  "
                f"({m['primary_rays_per_s'] / 1e6:.2f} M primary rays/s)")
