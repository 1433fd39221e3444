"""What the program's own spans and counters show of the traced slice.

The program reduces the profiler trace of the slice to a span report when
the slice ends (``cuda_path_tracer_ss_torch.utils.profiling.trace``, read
back through ``last_report()``): per span name its count, host, device and
device-idle seconds (each idle instant goes to the innermost span over it),
and the growth of the program's counters. The per-layer metrics of the
program's spans read it here, per unit of the slice. A program without the
report, or a report without the span, gives None, never 0: a renamed span
shows as missing.
"""
from __future__ import annotations

from typing import Callable, Optional


def report(run) -> Optional[dict]:
    """The program's span report of the run's traced slice, or None (an
    untraced run, a program that keeps none)."""
    if run.trace is None:
        return None
    from cuda_path_tracer_ss_torch.utils import profiling

    last = getattr(profiling, "last_report", None)
    return last() if last is not None else None


def _units(run) -> int:
    return run.job.slice_units() if run.job is not None else 0


def idle_ms(run, match: Callable[[str], bool]) -> Optional[float]:
    """Device-idle milliseconds per unit of the slice put down to the spans
    whose names ``match``; None where no such span was recorded."""
    rep, units = report(run), _units(run)
    if rep is None or not units:
        return None
    spans = [s for name, s in rep["spans"].items() if match(name)]
    if not spans or any(s["idle_s"] is None for s in spans):
        return None
    return sum(s["idle_s"] for s in spans) * 1e3 / units


def counter_per_unit(run, name: str) -> Optional[float]:
    """The growth of the program's counter ``name`` over the slice, per
    unit; None where the report has no such counter."""
    rep, units = report(run), _units(run)
    if rep is None or not units or name not in rep.get("counters", {}):
        return None
    return rep["counters"][name] / units
