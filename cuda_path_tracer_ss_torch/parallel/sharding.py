"""Rendering over a device mesh on the eager engine: the counterpart of the
JAX package's ``parallel/sharding.py``.

Each rank of the mesh traces its share against a full copy of the scene,
on its own device (``mesh.rank_device``):

* pixel sharding: a rank traces a tile of flat pixel indices; the tiles
  merge with one psum over the pixel axis of the tiles written into zero
  images, so the image is bit-equal to ``integrator.render`` (same streams
  per pixel and sample, the same wavefront batching, and exact zeros);
* sample sharding: every rank traces the whole image with its own slice of
  the global sample indices, and one psum over the sample axis merges the
  sums (the order of the sample sum changes: float tolerance, not bits);
* both at once on a 2-D mesh, one psum over every rank;
* light paths: a rank traces a block of global path indices and splats into
  its own full-size image; one psum over the path axis merges them.

Gradients: the scene's and the camera's tensors that require grad pass
through ``mesh.replicate`` inside each entry, so their gradients are summed
over the ranks once, as the ``shard_map`` transpose does in the reference.
``live_cutoff`` applies to each rank's tile, as in ``shard_map``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..constants import DEFAULT_MAX_BOUNCES
from ..render import integrator
from ..render.lighttrace import lighttrace_block
from .mesh import (PATH_AXIS, PIXEL_AXIS, SAMPLE_AXIS, axis_index, axis_size,
                   in_full_image, psum, rank_device, replicate)


def _replicated_scene(scene, cam_params, mesh):
    """``scene`` and the camera on this rank's device, their tensors that
    require grad passed through ``replicate``: ``(scene, camera tensors,
    keep)``, ``keep`` being what ``psum`` takes so that every rank reduces
    their gradients."""
    dev = rank_device(mesh.device_type)
    scene = scene.to(dev)
    cam = integrator.camera_tensors(cam_params, dev)
    fields = [(obj, f.name) for obj in (scene, scene.materials)
              for f in dataclasses.fields(obj)
              if isinstance(getattr(obj, f.name), torch.Tensor)
              and getattr(obj, f.name).requires_grad]
    leaves = [getattr(obj, name) for obj, name in fields]
    cam_grad = [i for i, c in enumerate(cam) if c.requires_grad]
    keep = replicate(leaves + [cam[i] for i in cam_grad], mesh)
    mats = {name: k for (obj, name), k in zip(fields, keep)
            if obj is scene.materials}
    top = {name: k for (obj, name), k in zip(fields, keep) if obj is scene}
    scene = scene.replace(materials=dataclasses.replace(scene.materials, **mats),
                          **top)
    cam = list(cam)
    for i, k in zip(cam_grad, keep[len(leaves):]):
        cam[i] = k
    return scene, tuple(cam), tuple(keep)


def _sample_sum(scene, cam, width, height, seed, samples, max_bounces,
                live_cutoff, physical, nee, bidir_nu, pixel_idx):
    acc = None
    for r in integrator.sample_radiance(
            scene, cam, width, height, seed, samples, max_bounces=max_bounces,
            live_cutoff=live_cutoff, physical=physical, nee=nee,
            bidir_nu=bidir_nu, pixel_idx=pixel_idx):
        acc = r if acc is None else acc + r
    return acc


def render_pixel_sharded(scene, cam_params, width: int, height: int, spp: int,
                         seed, mesh, max_bounces: int = DEFAULT_MAX_BOUNCES,
                         live_cutoff: Optional[int] = None,
                         sample_offset: int = 0, physical: bool = False,
                         nee: bool = True, bidir_nu: Optional[float] = None
                         ) -> torch.Tensor:
    """Pixel tiles over ``mesh``'s pixel axis -> ``[height, width, 3]`` on
    every rank's device, bit-equal to ``integrator.render`` (``live_cutoff
    =None``). Samples ``sample_offset .. sample_offset + spp`` (global
    indices: a render resumes across mesh shapes); ``physical`` / ``nee`` /
    ``bidir_nu`` select the estimator as in ``render/integrator.py``."""
    n = width * height
    n_dev = axis_size(mesh, PIXEL_AXIS, "render_pixel_sharded")
    if n % n_dev:
        raise ValueError(f"{width}x{height} pixels not divisible by {n_dev} devices")
    per = n // n_dev
    scene, cam, keep = _replicated_scene(scene, cam_params, mesh)
    first = axis_index(mesh, PIXEL_AXIS) * per
    idx = torch.arange(first, first + per, dtype=torch.int64,
                       device=scene.background.device)
    acc = _sample_sum(scene, cam, width, height, seed,
                      range(sample_offset, sample_offset + spp), max_bounces,
                      live_cutoff, physical, nee, bidir_nu, idx)
    img = psum(in_full_image(acc, first, n), mesh, PIXEL_AXIS, keep)
    return (img / spp).reshape(height, width, 3)


def render_sample_sharded(scene, cam_params, width: int, height: int,
                          spp: int, seed, mesh,
                          max_bounces: int = DEFAULT_MAX_BOUNCES,
                          live_cutoff: Optional[int] = None,
                          physical: bool = False, nee: bool = True
                          ) -> torch.Tensor:
    """The sample axis over ``mesh``'s sample axis: every rank renders the
    whole image with its slice of the sample indices, one psum merges.
    The mesh MUST have a ``"samples"`` axis (a pixel-named axis is not
    silently reused)."""
    n_dev = axis_size(mesh, SAMPLE_AXIS, "render_sample_sharded")
    if spp % n_dev:
        raise ValueError(f"spp={spp} not divisible by {n_dev} devices")
    per = spp // n_dev
    scene, cam, keep = _replicated_scene(scene, cam_params, mesh)
    first = axis_index(mesh, SAMPLE_AXIS) * per
    acc = _sample_sum(scene, cam, width, height, seed,
                      range(first, first + per), max_bounces, live_cutoff,
                      physical, nee, None, None)
    return (psum(acc, mesh, SAMPLE_AXIS, keep) / spp).reshape(height, width, 3)


def render_2d_sharded(scene, cam_params, width: int, height: int, spp: int,
                      seed, mesh, max_bounces: int = DEFAULT_MAX_BOUNCES,
                      live_cutoff: Optional[int] = None,
                      physical: bool = False, nee: bool = True
                      ) -> torch.Tensor:
    """A 2-D mesh (``parallel.mesh.make_mesh_2d``): pixel tiles over the
    pixel axis, sample slices over the sample axis, one psum over every
    rank."""
    n = width * height
    n_px = axis_size(mesh, PIXEL_AXIS, "render_2d_sharded")
    n_sp = axis_size(mesh, SAMPLE_AXIS, "render_2d_sharded")
    if n % n_px:
        raise ValueError(f"{n} pixels not divisible by {n_px}")
    if spp % n_sp:
        raise ValueError(f"spp={spp} not divisible by {n_sp}")
    per_px, per_sp = n // n_px, spp // n_sp
    scene, cam, keep = _replicated_scene(scene, cam_params, mesh)
    first = axis_index(mesh, PIXEL_AXIS) * per_px
    s0 = axis_index(mesh, SAMPLE_AXIS) * per_sp
    idx = torch.arange(first, first + per_px, dtype=torch.int64,
                       device=scene.background.device)
    acc = _sample_sum(scene, cam, width, height, seed, range(s0, s0 + per_sp),
                      max_bounces, live_cutoff, physical, nee, None, idx)
    img = psum(in_full_image(acc, first, n), mesh, (SAMPLE_AXIS, PIXEL_AXIS),
               keep)
    return (img / spp).reshape(height, width, 3)


def render_lighttrace_sharded(scene, cam_params, width: int, height: int,
                              n_paths: int, seed, mesh,
                              max_bounces: int = DEFAULT_MAX_BOUNCES,
                              sample_idx: int = 0,
                              bidir_nu: Optional[float] = None) -> torch.Tensor:
    """Light tracing (``render/lighttrace.py``) over ``mesh``'s path axis:
    each rank traces a block of GLOBAL light-path indices into its own
    full-size splat image (in blocks of ``integrator.WAVE_RAYS``); one psum
    merges them. Streams key on the global path index, so only the order of
    the splat sums differs from ``render_lighttrace``."""
    if not scene.num_area_lights:
        raise ValueError("light tracing needs at least one area light")
    n_dev = axis_size(mesh, PATH_AXIS, "render_lighttrace_sharded")
    if n_paths % n_dev:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_dev} devices")
    per = n_paths // n_dev
    scene, cam, keep = _replicated_scene(scene, cam_params, mesh)
    dev = scene.background.device
    first = axis_index(mesh, PATH_AXIS) * per
    img = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    for p0 in range(first, first + per, integrator.WAVE_RAYS):
        idx = torch.arange(p0, min(p0 + integrator.WAVE_RAYS, first + per),
                           dtype=torch.int64, device=dev)
        img = img + lighttrace_block(scene, cam, width, height, idx, seed,
                                     max_bounces=max_bounces,
                                     sample_idx=sample_idx, bidir_nu=bidir_nu)
    return (psum(img, mesh, PATH_AXIS, keep) / n_paths).reshape(height, width, 3)


def jit_pixel_sharded(scene, cam_params, width, height, spp, seed, mesh,
                      max_bounces=DEFAULT_MAX_BOUNCES, live_cutoff=None,
                      physical=False, nee=True) -> torch.Tensor:
    """``render_pixel_sharded`` under the reference's name for its jitted
    entry; the port compiles nothing, so it is the same call."""
    return render_pixel_sharded(scene, cam_params, width, height, spp, seed,
                                mesh, max_bounces=max_bounces,
                                live_cutoff=live_cutoff, physical=physical,
                                nee=nee)
