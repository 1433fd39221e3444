"""Numerical-health checks.

The counterpart of the JAX package's ``utils/debug.py``. What is worth
guarding is numerics: a NaN escaping a ``where`` in the estimator (the MIS
weights' clamped ratios are the known risk). ``checked_render`` runs the
eager renderer with every operation's float outputs inspected, as
``checkify.float_checks`` instruments the reference's, and names the first
operation whose output holds a NaN (the sweeps' ``+inf`` slots are
legitimate and pass); ``assert_finite`` is a cheap post-hoc scan for
pipelines and tests.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# Operations whose outputs are uninitialised memory, not computed values.
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


class _NaNCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operation whose float
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"NaN in the output of {func} "
                        f"(shape {tuple(t.shape)})")
        return out


def checked_render(scene, cam_params, width: int, height: int, spp: int,
                   seed, max_bounces: int = 8, device="cuda") -> torch.Tensor:
    """The eager ``integrator.render`` (``live_cutoff=None``) with every
    operation's float outputs checked for NaN; raises
    ``FloatingPointError`` naming the first operation that made one. One
    host read per operation: a debugging tool, not a renderer."""
    from ..render.integrator import render

    with torch.no_grad(), _NaNCheck():
        return render(scene, cam_params, width, height, spp, seed,
                      max_bounces=max_bounces, live_cutoff=None,
                      device=device)


def assert_finite(tree, name: str = "output") -> None:
    """Raise ``FloatingPointError`` if a float tensor of ``tree`` (a tensor,
    or a dict, list or tuple of them, nested) holds NaN or Inf; the message
    names the leaf's path as ``name['key'][0]``."""
    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
        elif isinstance(obj, torch.Tensor) and obj.is_floating_point():
            if not bool(torch.isfinite(obj).all()):
                raise FloatingPointError(f"non-finite values in {name}{path}")

    walk(tree, "")
