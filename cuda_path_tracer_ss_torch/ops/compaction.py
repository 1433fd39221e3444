"""Wavefront compaction: the ``thrust::partition`` analog
(``CudaTracer.cu:629-631``), as the JAX package's ``ops/compaction.py``.

A stable partition moves the live rays of a wavefront into a dense prefix
and keeps their relative order. The eager engine's bounce loop
(``render/integrator.py::trace``) partitions after every bounce and traces
only the prefix, so a bounce costs what its live rays cost; each ray's
arithmetic is unchanged, so the image is the same bit for bit.
"""
from __future__ import annotations

import torch

from .vec import Vec3


def _take(leaf, order):
    if isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
        return tree_take(leaf, order)
    if isinstance(leaf, Vec3):
        return leaf.map(lambda a: a[order])
    if isinstance(leaf, torch.Tensor) and leaf.dim():
        return leaf[order]
    return leaf


def tree_take(state, order):
    """Rows ``order`` of every ``[N]``-leading leaf of a NamedTuple whose
    fields are tensors, Vec3 or NamedTuples of them (0-d tensors and Python
    scalars pass)."""
    return type(state)(*(_take(leaf, order) for leaf in state))


def partition_by_activity(state):
    """Stable-partition ``state`` so that the entries where ``state.active``
    is True form a dense prefix. Returns (state, live_count); the count is a
    0-d tensor on the state's device."""
    active = state.active
    # stable argsort of (not active): False (live) sorts first
    order = torch.argsort(torch.logical_not(active).to(torch.uint8),
                          stable=True)
    return tree_take(state, order), torch.sum(active)


def live_count(state) -> torch.Tensor:
    return torch.sum(state.active)
