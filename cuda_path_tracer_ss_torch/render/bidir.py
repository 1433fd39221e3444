"""Bidirectional path tracing: eye paths plus light-traced splats, combined
with multiple-importance-sampling weights.

Each half owns a path family the other struggles with: eye paths render
specular surfaces SEEN by the camera (glass, mirrors) but find caustics only
through vanishing-probability chains; light paths render caustics directly but
cannot reach the camera through a specular surface at all (a light-trace-only
render shows black glass). This module runs both and MIS-weights every
contribution, so each family dominates where its sampling density is sharpest.

Techniques (restricted BDPT): a BSDF-sampled hit on a light and next-event
estimation, both from the eye path (count ``spp`` per pixel), and the light
path's camera connection with the emitter-surface splat (count ``n_paths``).
The weights are the power heuristic over count x density with
``nu = n_paths / spp`` folding the counts; both halves evaluate every
per-vertex factor through the same chain-model function
(``ops/cuda/megakernel._chain_model_lobes``), so the weights of a path sum to 1.

``render_bidir_fast`` runs on the two hand-written kernels: the physical
megakernel with the bidirectional carries and the light-tracing kernel. The
entries that run on the eager engine or across devices are not ported yet.
"""
from __future__ import annotations

import torch

from ..constants import DEFAULT_MAX_BOUNCES
from ..ops.cuda.lightkernel import render_lighttrace_fast
from ..ops.cuda.megakernel import PackedScene, _unported, render_megakernel
from ..utils import rng


def render_bidir_fast(packed: PackedScene, cam_params, width: int,
                      height: int, spp: int, n_paths: int, seed: int,
                      max_bounces: int = DEFAULT_MAX_BOUNCES,
                      sample_offset: int = 0,
                      light_sample_idx: int = 0) -> torch.Tensor:
    """Combined bidirectional render -> ``[height, width, 3]`` radiance on
    the packed tables' device: ``spp`` eye samples per pixel (the physical
    megakernel with ``bidir_nu``) plus ``n_paths`` light paths (the light
    kernel), each contribution MIS-weighted. ``packed`` is a ``pack_scene``
    result: pack once, render many. Batch for more samples with distinct
    ``sample_offset`` (eye) and ``light_sample_idx`` (light) per batch and
    average."""
    if packed.counts[4] == 0:
        raise ValueError("bidirectional rendering needs an area light")
    if packed.textured:
        # checked before the eye half runs: the light half would refuse
        raise ValueError("textured light tracing is not on this kernel "
                         "(the light kernel has no texture block)")
    nu = float(n_paths) / float(spp)
    fwd = render_megakernel(packed, cam_params, seed, width, height, spp,
                            max_bounces=max_bounces,
                            sample_offset=sample_offset, physical=True,
                            bidir_nu=nu)
    # the light half draws from another seed: pixel and path indices are
    # both small integers, so a shared seed would alias their stream keys
    lt = render_lighttrace_fast(packed, cam_params, rng.seed_for(seed, 1),
                                width, height, n_paths,
                                max_bounces=max_bounces,
                                sample_idx=light_sample_idx, bidir_nu=nu)
    return fwd + lt


def render_bidir(*args, **kwargs):
    """The eager-engine bidirectional render: not ported yet."""
    _unported("render_bidir on the eager engine (use render_bidir_fast)",
              "Queue 1 item 8")


def render_bidir_sharded(*args, **kwargs):
    """The eager-engine bidirectional render over a device mesh: not ported
    yet."""
    _unported("render_bidir_sharded", "Queue 1 items 8 and 10")


def render_bidir_fast_sharded(*args, **kwargs):
    """``render_bidir_fast`` over several devices: not ported yet."""
    _unported("render_bidir_fast_sharded", "Queue 1 item 10")
