"""The correctness control and the planted faults, which break the timed path
underneath a run (``runner.run_cell``). Used by the calibration script and
the tests that must see ``correct`` come out false; the benchmark's own runs
never enter them.

* ``control``: the program with its own lower-precision path switched on:
  K1's ``state_bf16`` carries (radiance and throughput stored as bfloat16
  between bounces), the step below the configuration's float32.
* ``unchanged``: a step that returns its state unchanged (the renderer's
  accumulation adds nothing; Adam's update does nothing).
* ``half``: half of the batch left out, the mean taken over the rest (each
  launch renders half of its samples and returns their mean).
* ``altered``: an answer altered where it is produced (the display image
  three levels up; the rendered image of a training step scaled by 1.01).

Each job kind says how they reach its own timed path: ``jobs/<kind>.py``
defines ``plant(kind, stack)``, which enters the patches for ``kind`` into
an ``ExitStack``, made of the pieces below or of its own. A job kind whose
control needs no window (training: the reference with the lower precision
put in the program's place) defines ``control_line(cell, seed)`` instead.
The pieces take the modules that hold the patched name, since a module that
imported a function by name keeps its own reference to it.
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


def patch(stack, owners, name, value) -> None:
    """Set ``name`` to ``value`` on each of ``owners`` until ``stack`` closes."""
    for owner in owners:
        stack.enter_context(_patched(owner, name, value))


def _megakernel():
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel
    return megakernel


def _megakernel_vjp():
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp
    return megakernel_vjp


def k1_control(stack, *owners) -> None:
    """K1 with its bfloat16 carries, wherever ``render_megakernel`` is held
    (default: its own module)."""
    mk = _megakernel()
    patch(stack, owners or (mk,), "render_megakernel",
          functools.partial(mk.render_megakernel, state_bf16=True))


def k1_half(stack, *owners) -> None:
    """Each K1 launch renders half of its samples."""
    mk = _megakernel()
    render = mk.render_megakernel

    def half(packed, cam, seed, w, h, spp, *a, **k):
        return render(packed, cam, seed, w, h, max(spp // 2, 1), *a, **k)

    patch(stack, owners or (mk,), "render_megakernel", half)


def k2_half(stack, *owners) -> None:
    """Each forward and backward of ``render_megakernel_diff`` on half of
    its samples."""
    vjp = _megakernel_vjp()
    diff = vjp.render_megakernel_diff

    def half_diff(packed, cam, seed, w, h, spp, *a, **k):
        return diff(packed, cam, seed, w, h, max(spp // 2, 1), *a, **k)

    patch(stack, owners or (vjp,), "render_megakernel_diff", half_diff)


def k2_altered(stack, *owners) -> None:
    """The rendered image of a training step scaled by 1.01."""
    vjp = _megakernel_vjp()
    diff = vjp.render_megakernel_diff
    patch(stack, owners or (vjp,), "render_megakernel_diff",
          lambda *a, **k: diff(*a, **k) * 1.01)


def renderer_unchanged(stack) -> None:
    """The renderer's accumulation adds nothing."""
    from cuda_path_tracer_ss_torch.render.renderer import ProgressiveRenderer

    patch(stack, (ProgressiveRenderer,), "_accumulate", lambda self, *a: None)


def adam_unchanged(stack) -> None:
    """Adam's update does nothing."""
    import torch

    patch(stack, (torch.optim.Adam,), "step", lambda self, closure=None: None)


def display_altered(stack) -> None:
    """The display image three levels up."""
    import torch
    from cuda_path_tracer_ss_torch.ops import tonemap

    u8 = tonemap.to_uint8
    patch(stack, (tonemap,), "to_uint8",
          lambda d: (u8(d).to(torch.int32) + 3).clamp(0, 255).to(torch.uint8))


@contextlib.contextmanager
def planted(kind: str, job):
    """Break the timed path of job kind ``job`` (its module) as ``kind``
    says, inside the block."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; use one of {KINDS}")
    plant = getattr(job, "plant", None)
    if plant is None:
        raise AttributeError(f"{job.__file__} defines no plant(kind, stack): "
                             "its control and faults cannot be planted")
    with contextlib.ExitStack() as stack:
        plant(kind, stack)
        yield


def line(cell: dict, kind: str, seed: int, seconds: float,
         device: str = "cuda") -> dict:
    """One reading of the cell under ``kind``: ``sound``, or the control or
    a fault planted through the cell's job kind; the result line as a dict
    (``correct``, ``checks``, and ``metrics`` where a window ran)."""
    from . import runner

    job = cell["job"]
    if kind == "sound":
        return runner.run_cell(cell, seed, seconds, False, device=device)
    if kind == "control" and hasattr(job, "control_line"):
        return job.control_line(cell, seed)
    with planted(kind, job):
        return runner.run_cell(cell, seed, seconds, False, device=device)
