"""The correctness control and the planted faults, as context managers that
break the timed path underneath a run (``runner.run_cell``). Used by the
calibration script and the tests that must see ``correct`` come out false;
the benchmark's own runs never enter them.

* ``control``: the program with its own lower-precision path switched on:
  K1's ``state_bf16`` carries (radiance and throughput stored as bfloat16
  between bounces), the step below the configuration's float32.
* ``unchanged``: a step that returns its state unchanged (the renderer's
  accumulation adds nothing; Adam's update does nothing).
* ``half``: half of the batch left out, the mean taken over the rest (each
  launch renders half of its samples and returns their mean).
* ``altered``: an answer altered where it is produced (the display image
  three levels up; the rendered image of a training step scaled by 1.01).
"""
from __future__ import annotations

import contextlib
import functools

KINDS = ("control", "unchanged", "half", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(kind: str):
    """Break the program's timed path as ``kind`` says, inside the block."""
    import torch
    from cuda_path_tracer_ss_torch.ops import tonemap
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel, megakernel_vjp
    from cuda_path_tracer_ss_torch.render.renderer import ProgressiveRenderer

    render = megakernel.render_megakernel
    diff = megakernel_vjp.render_megakernel_diff
    with contextlib.ExitStack() as stack:
        if kind == "control":
            stack.enter_context(_patched(
                megakernel, "render_megakernel",
                functools.partial(render, state_bf16=True)))
        elif kind == "unchanged":
            stack.enter_context(_patched(
                ProgressiveRenderer, "_accumulate", lambda self, *a: None))
            stack.enter_context(_patched(
                torch.optim.Adam, "step", lambda self, closure=None: None))
        elif kind == "half":
            def half(packed, cam, seed, w, h, spp, *a, **k):
                return render(packed, cam, seed, w, h, max(spp // 2, 1), *a, **k)

            def half_diff(packed, cam, seed, w, h, spp, *a, **k):
                return diff(packed, cam, seed, w, h, max(spp // 2, 1), *a, **k)

            stack.enter_context(_patched(megakernel, "render_megakernel", half))
            stack.enter_context(_patched(megakernel_vjp, "render_megakernel_diff",
                                         half_diff))
        elif kind == "altered":
            u8 = tonemap.to_uint8
            stack.enter_context(_patched(
                tonemap, "to_uint8",
                lambda d: (u8(d).to(torch.int32) + 3).clamp(0, 255).to(torch.uint8)))
            stack.enter_context(_patched(
                megakernel_vjp, "render_megakernel_diff",
                lambda *a, **k: diff(*a, **k) * 1.01))
        else:
            raise ValueError(f"unknown fault {kind!r}; use one of {KINDS}")
        yield
