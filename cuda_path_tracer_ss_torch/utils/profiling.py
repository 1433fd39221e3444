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
  On exit it reduces the trace to a span report (``last_report``).
* ``span``: a named host range of the port's own code (the frame driver,
  the training loop, the kernels' host entries). Under a profiler it is a
  ``record_function`` range in the trace; with none it does nothing.
* ``host_waits``: how often the port's own code blocked on the device.
* ``PassMeter``: running rays/s, spp, and per-pass ms; renders the reference's
  one-line console format or structured JSONL.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time
from typing import Dict, Iterable, List, Optional

import torch

TRACE_FILE = "trace.json"

# Every point where the port's own code blocks on the device: ``sync``, the
# frame driver's reads of the image and the accumulator into host memory,
# ``invert``'s read of the loss. Counted on every device.
host_waits = 0

_NO_SPAN = contextlib.nullcontext()
# the names ``span`` opened under a profiler: a span report counts only these
_SPAN_NAMES = set()
# ... and those of whole units of work (a render, a pass, a step)
_UNIT_NAMES = set()
# the category a unit span takes in the written trace (see ``trace``)
UNIT_CATEGORY = "program_unit"
_LAST_REPORT: Optional[dict] = None


def span(name: str, unit: bool = False):
    """A context manager that marks the block as the port's span ``name``.
    While a ``torch.profiler`` profile runs it is a ``record_function``
    range, on the same clock as the device's kernels and copies; with none,
    one check and a shared no-op (no op dispatch, no allocation, no
    synchronisation). ``unit``: the span is a whole unit of work, one
    render, pass or Adam step (see ``trace``)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    (_UNIT_NAMES if unit else _SPAN_NAMES).add(name)
    return torch.profiler.record_function(name)


def sync(device) -> None:
    """Block until all work queued on ``device`` has finished."""
    global host_waits
    host_waits += 1
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


def _counters() -> Dict[str, int]:
    from ..ops.cuda import lightkernel, megakernel, megakernel_vjp

    return dict(host_waits=host_waits, k1_launches=megakernel.LAUNCH_COUNT,
                k2_launches=megakernel_vjp.LAUNCH_COUNT,
                k2_resident_launches=megakernel_vjp.RESIDENT_LAUNCHES,
                k3_launches=lightkernel.LAUNCH_COUNT)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: yields the ``torch.profiler.profile`` (its
    ``key_averages()`` and ``events()`` are read after the block) and writes
    its Chrome trace to ``log_dir/trace.json``, the only file it writes
    there. CPU activity always, CUDA activity too when a card is present.

    On exit the trace is reduced to a span report, kept in memory as
    ``last_report()``: ``span_report`` of its events, and under
    ``counters`` the growth over the block of ``host_waits`` and of the
    kernels' launch counts. A unit span (a render, a pass, a step) is
    written with the category ``UNIT_CATEGORY`` in place of
    ``user_annotation``: it covers every idle gap of its unit, and a reader
    that names a gap by the host range overlapping it most would otherwise
    name them all after the unit."""
    from torch.profiler import ProfilerActivity, profile

    global _LAST_REPORT
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = _counters()
    with profile(activities=activities) as prof:
        yield prof
    grown = {k: v - before[k] for k, v in _counters().items()}
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    report = span_report(events, _SPAN_NAMES | _UNIT_NAMES,
                         device=ProfilerActivity.CUDA in activities)
    report["counters"] = grown
    _LAST_REPORT = report
    units = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in _UNIT_NAMES]
    if units:
        for e in units:
            e["cat"] = UNIT_CATEGORY
        with open(path, "w") as f:
            json.dump(doc, f)


def last_report() -> Optional[dict]:
    """The span report of the last ``trace`` block to end (None before
    any)."""
    return _LAST_REPORT


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def span_report(events: List[dict], names: Iterable[str],
                device: bool = True) -> dict:
    """Reduce a Chrome trace's ``traceEvents`` (microseconds) to the host
    and device time of the spans called ``names``; other ranges (a
    caller's own ``record_function``) are not spans. Spans open at either
    edge of the profiled block are clipped to it.

    Returns ``spans`` ({name: count, host_s, self_s (less its child spans),
    device_s (the device work launched inside it, joined by correlation
    id), idle_s (the device-idle time put down to it), parent (the most
    common enclosing span's name)}), ``block_s``, ``busy_s``, ``idle_s``
    and ``unattributed_idle_s`` (idle under no span). A device-idle instant
    goes to the innermost span covering it on any thread: the one that
    began last. A span's parent is the innermost span on its own thread
    that holds it, else on another thread (autograd runs a backward on a
    thread of its own). ``device=False`` (no card traced): the device
    fields are None."""
    names = set(names)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    # the profiler's own range over the whole block, where it wrote one
    block = [e for e in xs if e.get("cat") == "Trace"]
    if block:
        b0, b1 = block[0]["ts"], block[0]["ts"] + block[0]["dur"]
    elif xs:
        b0 = min(e["ts"] for e in xs)
        b1 = max(e["ts"] + e["dur"] for e in xs)
    else:
        b0 = b1 = 0.0
    spans = []      # (start, end, name, thread), clipped to the block
    for e in xs:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            a, b = max(e["ts"], b0), min(e["ts"] + e["dur"], b1)
            if b >= a:
                spans.append((a, b, e["name"], e.get("tid")))
    spans.sort(key=lambda s: (s[0], -s[1]))
    n = len(spans)

    # parents: nesting on each thread, then across threads for a thread's
    # outermost spans
    parent: List[Optional[int]] = [None] * n
    stacks: Dict[object, List[int]] = {}
    for i, (a, b, _, tid) in enumerate(spans):
        st = stacks.setdefault(tid, [])
        while st and spans[st[-1]][1] < b:
            st.pop()
        parent[i] = st[-1] if st else None
        st.append(i)
    if len(stacks) > 1:
        for i, (a, b, _, tid) in enumerate(spans):
            if parent[i] is None:
                # only spans sorted before this one: no cycle of parents
                holders = [j for j, s in enumerate(spans[:i]) if s[3] != tid
                           and s[1] >= b]
                parent[i] = holders[-1] if holders else None

    # the innermost span over each piece of the block: a sweep over the
    # spans' edges (sorted by start, the last open one is the innermost)
    # (piece k runs from edges[k] to edges[k + 1])
    edges = sorted({b0, b1, *(s[0] for s in spans), *(s[1] for s in spans)})
    by_end = sorted(range(n), key=lambda i: spans[i][1])
    owners: List[Optional[int]] = []
    active, k_open, k_close = set(), 0, 0
    for x in edges[:-1]:
        while k_open < n and spans[k_open][0] <= x:
            active.add(k_open)
            k_open += 1
        while k_close < n and spans[by_end[k_close]][1] <= x:
            active.discard(by_end[k_close])
            k_close += 1
        owners.append(max(active) if active else None)

    def owner_at(t: float) -> Optional[int]:
        k = bisect.bisect_right(edges, t) - 1
        return owners[k] if 0 <= k < len(owners) else None

    host = collections.defaultdict(float)
    child = collections.defaultdict(float)
    count = collections.Counter()
    parents = collections.defaultdict(collections.Counter)
    for i, (a, b, name, _) in enumerate(spans):
        count[name] += 1
        host[name] += b - a
        p = parent[i]
        parents[name][spans[p][2] if p is not None else None] += 1
        if p is not None:
            child[spans[p][2]] += b - a

    idle = collections.defaultdict(float)
    dev = collections.defaultdict(float)
    busy_s = idle_s = unattributed = None
    if device:
        busy = [iv for iv in _union(
            (max(e["ts"], b0), min(e["ts"] + e["dur"], b1))
            for e in xs if e.get("cat") in DEVICE_CATS) if iv[1] > iv[0]]
        busy_s = sum(b - a for a, b in busy) * 1e-6
        gaps, t = [], b0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if b1 > t:
            gaps.append((t, b1))
        idle_s = sum(b - a for a, b in gaps) * 1e-6
        unattributed = 0.0
        for a, b in gaps:
            k = max(bisect.bisect_right(edges, a) - 1, 0)
            while k < len(owners) and edges[k] < b:
                part = min(b, edges[k + 1]) - max(a, edges[k])
                if part > 0:
                    if owners[k] is None:
                        unattributed += part
                    else:
                        idle[spans[owners[k]][2]] += part
                k += 1
        unattributed *= 1e-6
        # device work, to the innermost span over its launch and each span
        # that holds that one
        launched = {e["args"]["correlation"]: e["ts"] for e in xs
                    if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            t = launched.get(e.get("args", {}).get("correlation"))
            i = owner_at(t) if t is not None else None
            held = set()
            while i is not None:
                held.add(spans[i][2])
                i = parent[i]
            for name in held:
                dev[name] += e["dur"]

    report = {}
    for name in count:
        report[name] = dict(
            count=count[name], host_s=host[name] * 1e-6,
            self_s=(host[name] - child[name]) * 1e-6,
            device_s=dev[name] * 1e-6 if device else None,
            idle_s=idle[name] * 1e-6 if device else None,
            parent=parents[name].most_common(1)[0][0])
    return dict(spans=report, block_s=(b1 - b0) * 1e-6, busy_s=busy_s,
                idle_s=idle_s, unattributed_idle_s=unattributed)


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
