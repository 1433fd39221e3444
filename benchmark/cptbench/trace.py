"""What a profiler trace of a slice of the window shows on the device.

The arithmetic of the port's smoke script (``chip_smoke.py::trace_summary``)
copied here: the device events launched inside the slice's host range
(``record_function(SLICE)``), joined to it by their correlation ids; the
device-busy seconds as the union of those events' intervals; the slice's
wall seconds as the range's duration. Added: device time by kernel symbol
(the kernels launched through ctypes have no aten op, so they are named by
their own symbols) and the idle gaps between busy intervals, each named by
the host activity that overlaps it most.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple

import numpy as np

SLICE = "bench.slice"
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[dict], window: str = SLICE, top: int = 10) -> dict:
    """``events``: the ``traceEvents`` of a Chrome trace (microseconds).
    Returns ``busy_s``, ``window_s``, ``kernels`` (device seconds by kernel
    symbol or op), ``device_ops`` and ``idle_gaps`` ([name, seconds], the
    ``top`` largest each; gaps summed by the host activity that covers them)
    and ``device_events``."""
    events = [e for e in events if e.get("ph") == "X"]
    rng_ev = [e for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == window]
    if not rng_ev:
        raise ValueError(f"the trace holds no {window!r} range")
    rng_ev = max(rng_ev, key=lambda e: e["dur"])
    t0, t1 = rng_ev["ts"], rng_ev["ts"] + rng_ev["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}
    all_launches = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
    # a device event whose launch the trace did not record counts where it
    # starts inside the slice
    device = [e for e in events if e.get("cat") in DEVICE_EVENT_CATS
              and (e.get("args", {}).get("correlation") in launched
                   or (e.get("args", {}).get("correlation") not in all_launches
                       and t0 <= e["ts"] <= t1))]
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    busy_iv = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy = sum(b - a for a, b in busy_iv)
    by_symbol: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    for e in device:
        by_symbol[e["name"]] = by_symbol.get(e["name"], 0.0) + e["dur"] * 1e-6
        # an aten op names its kernels; a hand-written kernel, launched
        # through ctypes or inside an autograd Function, keeps its symbol
        op = ops.get(e.get("args", {}).get("External id"), "")
        name = op if op.startswith("aten::") else e["name"][:80]
        by_op[name] = by_op.get(name, 0.0) + e["dur"] * 1e-6
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e["ts"] < t1 and e["ts"] + e["dur"] > t0 and e is not rng_ev]
    h_start = np.array([e["ts"] for e in host], np.float64)
    h_end = h_start + np.array([e["dur"] for e in host], np.float64)
    gaps: Dict[str, float] = {}
    edges = [t0] + [x for iv in busy_iv for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        # the host activity that overlaps the gap most
        overlap = np.clip(np.minimum(h_end, b) - np.maximum(h_start, a), 0, None)
        name = (host[int(np.argmax(overlap))]["name"][:80]
                if overlap.size and overlap.max() > 0 else "host, no traced op")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return dict(busy_s=busy * 1e-6, window_s=(t1 - t0) * 1e-6,
                kernels=by_symbol, device_events=len(device),
                device_ops=sorted(([k, v] for k, v in by_op.items()),
                                  key=lambda kv: -kv[1])[:top],
                idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                                 key=lambda kv: -kv[1])[:top])


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def kernel_seconds(summary: dict, symbol: str) -> float:
    """Device seconds of the kernels whose name holds ``symbol`` as a whole
    identifier (``render_kernel`` matches ``void render_kernel<...>(...)``)."""
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(symbol)
                     + r"(?![A-Za-z0-9_])")
    return sum(v for k, v in summary["kernels"].items() if pat.search(k))
