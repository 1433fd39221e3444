"""CPU tests of the readers of the program's spans and counters: each reads
the program's span report of the traced slice per unit, and gives None
where the run was not traced, the program keeps no report, or the report
lacks its span."""
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

import accepted  # noqa: E402
from cptbench import manifest  # noqa: E402

from cuda_path_tracer_ss_torch.utils import profiling  # noqa: E402


def _span(idle_s, parent=None):
    return dict(count=1, host_s=idle_s, self_s=idle_s, device_s=0.0,
                idle_s=idle_s, parent=parent)


REPORT = dict(
    spans={"renderer.run": _span(0.001), "renderer.pass": _span(0.002, "renderer.run"),
           "renderer.readback": _span(0.004, "renderer.run"),
           "renderer.setup": _span(0.008),
           "k1.launch": _span(0.016, "renderer.pass"),
           "inverse.pack": _span(0.032, "inverse.forward"),
           "inverse.adam": _span(0.064, "inverse.step"),
           "inverse.backward": _span(0.128, "inverse.step"),
           "k2.launch": _span(0.256, "inverse.backward")},
    block_s=1.0, busy_s=0.5, idle_s=0.5, unattributed_idle_s=0.0,
    counters=dict(host_waits=12, k1_launches=4, k2_launches=0, k3_launches=0))

# metric: its value on REPORT over 4 units
WANT = {
    "renderer.readback_ms.preview": 1.0,
    "renderer.host_waits_per_pass.preview": 3.0,
    "renderer.driver_ms.render": (1 + 2 + 4 + 8) / 4,
    "k1.launch_ms.render": 4.0,
    "inverse.pack_ms": 8.0,
    "inverse.adam_ms": 16.0,
    "inverse.autograd_ms": 32.0,
}


class _Job:
    def slice_units(self):
        return 4


class _Run:
    def __init__(self, traced=True):
        self.trace = {"busy_s": 0.5, "window_s": 1.0} if traced else None
        self.job = _Job()


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_of_a_program_span_or_counter(metric, monkeypatch):
    read = manifest.reader(metric)
    monkeypatch.setattr(profiling, "last_report", lambda: REPORT)
    assert read(_Run()) == pytest.approx(WANT[metric])
    assert read(_Run(traced=False)) is None
    without = dict(REPORT, spans={}, counters={})
    monkeypatch.setattr(profiling, "last_report", lambda: without)
    assert read(_Run()) is None
    cpu = dict(REPORT, spans={k: dict(v, idle_s=None) for k, v in REPORT["spans"].items()})
    monkeypatch.setattr(profiling, "last_report", lambda: cpu)
    if "host_waits" not in metric:
        assert read(_Run()) is None
    monkeypatch.delattr(profiling, "last_report")   # a program that keeps no report
    assert read(_Run()) is None


def test_the_span_metrics_are_in_the_manifest_beside_the_accepted_ones():
    m = manifest.load()
    assert manifest.problems(m) == []
    cells = {w["name"] for w in m["workloads"][:accepted.ACCEPTED["workloads"][0]]}
    new = {e["name"]: e for e in m["per_layer"] if e["name"] in WANT}
    assert set(new) == set(WANT)
    for e in new.values():   # each lists an accepted cell; later ones may follow
        assert e["source"] in ("program_span", "program_counter")
        assert e["better"] == "lower" and cells & set(e["workloads"])
