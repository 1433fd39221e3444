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

``render_bidir`` runs on the eager engine (``render/integrator.py`` with the
bidirectional carries, ``render/lighttrace.py`` with the weights), so
autograd differentiates it (``make_loss(engine="bidir")``);
``render_bidir_fast`` runs on the two hand-written kernels: the physical
megakernel with the bidirectional carries and the light-tracing kernel.
``render_bidir_sharded`` and ``render_bidir_fast_sharded`` run the same two
halves over several ranks (``parallel.mesh``): the eye half over a pixel mesh
(no collective but the merge of the tiles), the light half over a path mesh
(one psum of the splat images).
"""
from __future__ import annotations

import torch

from ..constants import DEFAULT_MAX_BOUNCES
from ..ops.cuda.lightkernel import (render_lighttrace_fast,
                                    render_lighttrace_fast_sharded)
from ..ops.cuda.megakernel import (PackedScene, render_megakernel,
                                   render_megakernel_sharded)
from ..parallel.sharding import render_lighttrace_sharded, render_pixel_sharded
from ..utils import rng
from . import integrator
from .lighttrace import render_lighttrace


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


def render_bidir(scene, cam_params, width: int, height: int, spp: int,
                 n_paths: int, seed: int,
                 max_bounces: int = DEFAULT_MAX_BOUNCES,
                 sample_offset: int = 0, light_sample_idx: int = 0,
                 device="cuda") -> torch.Tensor:
    """Combined bidirectional render on the eager engine -> ``[height,
    width, 3]`` radiance on ``device``: ``spp`` eye samples per pixel plus
    ``n_paths`` light paths, each contribution MIS-weighted with
    ``nu = n_paths / spp``; an unbiased estimate of the same per-pixel means
    as the forward ``physical=True`` estimator. Batch with distinct
    ``sample_offset`` (eye) and ``light_sample_idx`` (light) and average.
    Autograd reaches the scene's fields."""
    if not scene.num_area_lights:
        raise ValueError("bidirectional rendering needs an area light "
                         "(use the forward estimator for point-light-only "
                         "scenes)")
    nu = float(n_paths) / float(spp)
    fwd = integrator.render(scene, cam_params, width, height, spp, seed,
                            max_bounces=max_bounces, live_cutoff=None,
                            sample_offset=sample_offset, physical=True,
                            bidir_nu=nu, device=device)
    # the light half draws from another seed: pixel and path indices are
    # both small integers, so a shared seed would alias their stream keys
    lt = render_lighttrace(scene, cam_params, width, height, n_paths,
                           rng.seed_for(seed, 1), max_bounces=max_bounces,
                           sample_idx=light_sample_idx, bidir_nu=nu,
                           device=device)
    return fwd + lt


def render_bidir_sharded(scene, cam_params, width: int, height: int,
                         spp: int, n_paths: int, seed: int, mesh_pixels,
                         mesh_paths, max_bounces: int = DEFAULT_MAX_BOUNCES,
                         sample_offset: int = 0,
                         light_sample_idx: int = 0) -> torch.Tensor:
    """``render_bidir`` over several ranks on the eager engine: the eye half
    in pixel tiles over ``mesh_pixels`` (``render_pixel_sharded``), the light
    half in blocks of global path indices over ``mesh_paths``
    (``render_lighttrace_sharded``), two meshes over the same ranks. The eye
    half equals the single-device one bit for bit, the light half up to the
    order of its splat sums; autograd reaches the scene's fields, their
    gradients summed over the ranks once per half."""
    if not scene.num_area_lights:
        raise ValueError("bidirectional rendering needs an area light")
    nu = float(n_paths) / float(spp)
    fwd = render_pixel_sharded(scene, cam_params, width, height, spp, seed,
                               mesh_pixels, max_bounces=max_bounces,
                               live_cutoff=None, sample_offset=sample_offset,
                               physical=True, bidir_nu=nu)
    lt = render_lighttrace_sharded(scene, cam_params, width, height, n_paths,
                                   rng.seed_for(seed, 1), mesh_paths,
                                   max_bounces=max_bounces,
                                   sample_idx=light_sample_idx, bidir_nu=nu)
    return fwd + lt


def render_bidir_fast_sharded(packed: PackedScene, cam_params, width: int,
                              height: int, spp: int, n_paths: int, seed: int,
                              mesh_pixels, mesh_paths,
                              max_bounces: int = DEFAULT_MAX_BOUNCES,
                              sample_offset: int = 0,
                              light_sample_idx: int = 0) -> torch.Tensor:
    """``render_bidir_fast`` over several ranks: the physical megakernel with
    the bidirectional carries in pixel tiles over ``mesh_pixels``
    (``render_megakernel_sharded``: bit-equal to one device), the light
    kernel's paths over ``mesh_paths`` (``render_lighttrace_fast_sharded``:
    equal up to the order of the splat sums)."""
    if packed.counts[4] == 0:
        raise ValueError("bidirectional rendering needs an area light")
    if packed.textured:
        # checked before the eye half runs: the light half would refuse
        raise ValueError("textured light tracing is not on this kernel "
                         "(the light kernel has no texture block)")
    nu = float(n_paths) / float(spp)
    fwd = render_megakernel_sharded(packed, cam_params, seed, width, height,
                                    spp, mesh_pixels, max_bounces=max_bounces,
                                    sample_offset=sample_offset, physical=True,
                                    bidir_nu=nu)
    lt = render_lighttrace_fast_sharded(packed, cam_params,
                                        rng.seed_for(seed, 1), width, height,
                                        n_paths, mesh_paths,
                                        max_bounces=max_bounces,
                                        sample_idx=light_sample_idx,
                                        bidir_nu=nu)
    return fwd + lt
