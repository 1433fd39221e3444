"""The port's spans and counters (``utils/profiling``) on the CPU: ``span``
is a shared no-op with no profiler, ``host_waits`` counts the port's waits on
the device, ``trace`` reduces its trace to a span report of the frame
driver's and the training loop's spans, and ``span_report`` puts each idle
instant of a hand-made trace down to the innermost span over it."""
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from cuda_path_tracer_ss_torch.render.renderer import ProgressiveRenderer, RenderConfig
from cuda_path_tracer_ss_torch.utils import profiling

CP = camera_arrays(Camera())


class _Ops(TorchDispatchMode):
    """Every op the dispatcher runs inside the mode."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_span_without_a_profiler_is_the_shared_no_op_and_host_waits_still_counts():
    """No profiler: ``span`` returns one shared object and neither it nor the
    counter dispatches an op (no record_function op, no copy, no
    synchronisation); ``sync`` counts a wait on the CPU as on a card. Under
    a profiler the same call is a ``record_function`` range, which the
    mode does see."""
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b", unit=True)
    before = profiling.host_waits
    with _Ops() as quiet:
        with profiling.span("renderer.pass", unit=True):
            with profiling.span("renderer.sync"):
                profiling.sync("cpu")
        profiling.host_waits += 1
    assert quiet.ops == []
    assert profiling.host_waits == before + 2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with _Ops() as loud:
            with profiling.span("renderer.sync"):
                pass
    assert any(op.startswith("profiler._record_function_enter") for op in loud.ops)


def test_trace_reports_the_frame_driver_s_spans(tmp_path):
    """A plain-engine renderer on the CPU (8x8, 2 passes of 4 spp, one
    display read) under ``trace``: the spans the frame driver opened, their
    parents, the waits (2 syncs a pass + the read), no device fields without
    a card; the directory holds trace.json alone, its unit spans under
    ``UNIT_CATEGORY``."""
    log_dir = str(tmp_path / "t")
    with profiling.trace(log_dir):
        r = ProgressiveRenderer(tpresets.cornell(), Camera(),
                                RenderConfig(width=8, height=8, max_bounces=2,
                                             device="cpu"))
        r.step()
        r.step()
        u8 = r.image_u8()
    assert u8.shape == (8, 8, 3)
    rep = profiling.last_report()
    spans = rep["spans"]
    want = {"renderer.setup": (1, None), "renderer.reset": (1, "renderer.setup"),
            "renderer.pass": (2, None), "renderer.sync": (4, "renderer.pass"),
            "renderer.readback": (1, None)}
    assert {k: (v["count"], v["parent"]) for k, v in spans.items()} == want
    for v in spans.values():
        assert 0.0 <= v["self_s"] <= v["host_s"] <= rep["block_s"]
        assert v["device_s"] is None and v["idle_s"] is None
    assert rep["unattributed_idle_s"] is None
    assert rep["counters"] == dict(host_waits=5, k1_launches=0, k2_launches=0,
                                   k2_resident_launches=0, k3_launches=0)
    assert os.listdir(log_dir) == [profiling.TRACE_FILE]
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    cats = {e["name"]: e.get("cat") for e in events if e.get("name", "").startswith("renderer.")}
    assert cats["renderer.pass"] == profiling.UNIT_CATEGORY
    assert cats["renderer.readback"] == "user_annotation"


def test_trace_reports_the_training_loop_s_spans(tmp_path):
    """``invert(engine="plain")``, 2 steps at 8x8: each step one
    ``inverse.step`` with pack (inside the loss), forward, backward, Adam
    (zero_grad and step), the loss read and the callback under it; one wait
    a step (the loss read)."""
    scene = tpresets.cornell()
    target = tmk.render_megakernel_plain(tmk.pack_scene(scene, "cpu"), CP, 1, 8, 8, 1, 2)
    start = tinverse.with_field(scene, "materials.diffuse",
                                scene.materials.diffuse.clamp(0.1, 0.9) * 0.8)
    seen = []
    with profiling.trace(str(tmp_path / "t")):
        tinverse.invert(start, CP, target, ["materials.diffuse"], 8, 8, spp=1, steps=2,
                        max_bounces=2, engine="plain",
                        callback=lambda step, val, p: seen.append(step))
    assert seen == [0, 1]
    rep = profiling.last_report()
    got = {k: (v["count"], v["parent"]) for k, v in rep["spans"].items()}
    assert got == {"inverse.step": (2, None), "inverse.adam": (4, "inverse.step"),
                   "inverse.forward": (2, "inverse.step"),
                   "inverse.pack": (2, "inverse.forward"),
                   "inverse.backward": (2, "inverse.step"),
                   "inverse.loss_read": (2, "inverse.step"),
                   "inverse.callback": (2, "inverse.step")}
    assert rep["counters"]["host_waits"] == 2


def _x(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid, args=args)


# a profiled block [0, 100] us: spans nested on thread 1, one on thread 2 inside
# the outer one, one open at the start (clipped to 0) and one at the end; a
# caller's annotation over it all; four kernels, three launched inside spans
HAND_MADE = [
    _x("PyTorch Profiler (0)", "Trace", 0, 100),
    _x("bench.slice", "user_annotation", 0, 100),
    _x("s.early", "user_annotation", -5, 8),
    _x("s.outer", "user_annotation", 10, 50),
    _x("s.inner", "user_annotation", 20, 10),
    _x("s.other", "user_annotation", 35, 15, tid=2),
    _x("s.edge", "user_annotation", 90, 10, finished=False),
    _x("cudaLaunchKernel", "cuda_runtime", 1, 1, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 21, 1, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 36, 1, tid=2, correlation=3),
    _x("cudaLaunchKernel", "cuda_runtime", 65, 1, correlation=4),
    _x("k_a", "kernel", 0, 5, tid=7, correlation=1),
    _x("k_b", "kernel", 22, 3, tid=7, correlation=2),
    _x("k_c", "gpu_memcpy", 40, 5, tid=7, correlation=3),
    _x("k_d", "kernel", 70, 10, tid=7, correlation=4),
]
SPAN_NAMES = ("s.early", "s.outer", "s.inner", "s.other", "s.edge")


def test_span_report_puts_each_idle_instant_down_to_the_innermost_span():
    """Busy [0,5] [22,25] [40,45] [70,80]; idle 77 us: s.outer 10 + 5 + 10,
    s.inner 2 + 5, s.other (thread 2, the latest begun) 5 + 5, s.edge 10
    (clipped at the end), none 5 + 10 + 10 (the caller's annotation is no
    span). Device time follows the launch up the parents."""
    rep = profiling.span_report(HAND_MADE, SPAN_NAMES)
    us = 1e-6
    assert rep["block_s"] == pytest.approx(100 * us)
    assert rep["busy_s"] == pytest.approx(23 * us)
    assert rep["idle_s"] == pytest.approx(77 * us)
    assert rep["unattributed_idle_s"] == pytest.approx(25 * us)
    want = {  # count, host, self, device, idle (us), parent
        "s.early": (1, 3, 3, 5, 0, None),
        "s.outer": (1, 50, 25, 8, 25, None),
        "s.inner": (1, 10, 10, 3, 7, "s.outer"),
        "s.other": (1, 15, 15, 5, 10, "s.outer"),
        "s.edge": (1, 10, 10, 0, 10, None),
    }
    spans = rep["spans"]
    assert set(spans) == set(want)
    for name, (count, host, self_, dev, idle, parent) in want.items():
        s = spans[name]
        assert (s["count"], s["parent"]) == (count, parent), name
        assert [s["host_s"], s["self_s"], s["device_s"], s["idle_s"]] == pytest.approx(
            [host * us, self_ * us, dev * us, idle * us], abs=1e-12), name
    assert sum(s["idle_s"] for s in spans.values()) + rep["unattributed_idle_s"] == \
        pytest.approx(rep["idle_s"])
    host_only = profiling.span_report(HAND_MADE, SPAN_NAMES, device=False)
    assert host_only["spans"]["s.outer"]["device_s"] is None
    assert host_only["idle_s"] is None
    assert host_only["spans"]["s.outer"]["self_s"] == pytest.approx(25 * us)
