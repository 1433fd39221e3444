"""The eager engine: the JAX package's jnp path tracer in plain PyTorch.

The counterpart of the JAX package's ``render/integrator.py`` (the
reference's ``computeEyeRay`` and ``pathTraceKernel`` bounce recurrence,
``CudaTracer/CudaTracer.cu:106-206``, ``:321-343``, ``:620-633``). Every
function is a sequence of tensor operations on ``[N]`` lanes, so autograd
differentiates it where the reference uses ``jax.grad``; discrete decisions
(hits, branches, visibility) are detached as the reference detaches them.

The bounce loop (``trace``) replaces the reference's two loops:

* ``live_cutoff=None`` runs every bounce (the reference's ``lax.scan``; the
  last one skips scattering) and is the one autograd goes through;
* ``live_cutoff=k`` stops a sample's wavefront once at most ``k`` of its
  rays are live (the reference's ``lax.while_loop``, ``numRays > 128`` of
  ``CudaTracer.cu:622``): one host read per bounce.

Either way, after each bounce the live rays are stably partitioned into a
dense prefix (``ops/compaction.py``, the ``thrust::partition`` of the
reference) and only they are traced on; a ray's arithmetic is the same
whatever its neighbours, so this changes no pixel. ``render`` traces many
samples in one wavefront (at most ``WAVE_RAYS`` rays) and adds their
radiance sample by sample, in the reference's order.

Random numbers are the counter-based Threefry streams of ``utils/rng.py``,
shared with the kernels and with the reference, so the engines agree per
pixel.

Entry points take ``device`` ("cuda" by default) and raise without a card;
the scene, camera and grid are host data moved to it once per call.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import time

import numpy as np
import torch

from ..constants import (DEFAULT_MAX_BOUNCES, INV_PI, LIVE_RAY_CUTOFF,
                         MIS_RATIO_CLAMP)
from ..ops.bsdf import (UNIFORMS_PER_SCATTER, chain_model_pdf_taken,
                        lookup_materials, scatter, scatter_lobe_pdfs)
from ..ops.compaction import partition_by_activity, tree_take
from ..ops.intersect import nearest_hit, surfel_at
from ..ops.optics import fresnel_reflectance, media_and_sin_t2, reflect_signed
from ..ops.sampling import phong_lobe_axis
from ..ops.shading import (UNIFORMS_PER_AREA_LIGHT, BidirNEE, CTLobe,
                           GlossLobe, light_areas, shade, shade_physical)
from ..ops.vec import Vec3, gather, where as vwhere
from ..utils import rng

# Most rays ``render`` traces in one wavefront (samples are batched up to it).
WAVE_RAYS = 1 << 22

# Per-bounce timing, off by default. Set to a list and every bounce step of a
# wavefront (the cutoff test, ``bounce``, the partition) appends ``(bounce
# index, rays entering it, ms)``, the device synchronized before and after.
BOUNCE_TIMES: Optional[list] = None


class PathState(NamedTuple):
    origin: Vec3       # [N]
    direction: Vec3    # [N]
    radiance: Vec3     # [N] accumulated estimate (reference ``radiance0``)
    throughput: Vec3   # [N] path throughput (reference ``radiance1``)
    active: torch.Tensor  # [N] bool
    prev_pdf: torch.Tensor  # [N] solid-angle density of the last scatter for
                            # the branches NEE competes with (physical MIS)
    # the bidirectional-MIS carries (zeros unless bidir_nu is set), in the
    # chain-model pdf convention of ops/bsdf.chain_model_pdfs
    lt_chain: torch.Tensor        # [N] light-tracer-over-eye prefix ratio
    prev_pdf_model: torch.Tensor  # [N] chain-model density of the last scatter
    prev_cos_out: torch.Tensor    # [N] |n_hat . d_out| at the last vertex
    j_img: torch.Tensor           # [N] camera importance of the eye ray


class _Wave(NamedTuple):
    """The live part of a wavefront: the path states and, per ray, its
    Threefry counters, its slot in the caller's ray order and its group (a
    sample, for the live cutoff)."""

    path: PathState
    pixel: torch.Tensor
    sample: torch.Tensor
    slot: torch.Tensor
    group: torch.Tensor

    @property
    def active(self):
        return self.path.active


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the eager engine was asked for device={device!s} "
                           "but no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return device


def camera_tensors(cam_params, device):
    """``models.camera.camera_arrays`` -> (rot [3, 3], pos [3], tan(fov/2),
    z_near) as float32 tensors on ``device`` (a tensor keeps its graph)."""
    return tuple(torch.as_tensor(np.asarray(p, np.float32)
                                 if not isinstance(p, torch.Tensor) else p,
                                 dtype=torch.float32).to(device)
                 for p in cam_params)


def eye_rays_for_indices(cam_params, width: int, height: int, pixel_idx,
                         jitter_x, jitter_y):
    """Jittered pinhole eye rays for flat pixel indices (pixel (0, 0) at
    the bottom left). ``cam_params`` are :func:`camera_tensors`. Returns
    (origins, directions) as Vec3 of [len(pixel_idx)]."""
    rot, pos, tan_half_fov, z_near = cam_params
    n = pixel_idx.shape[0]
    px = (pixel_idx % width).to(torch.float32) + jitter_x
    py = torch.div(pixel_idx, width, rounding_mode="floor").to(torch.float32) + jitter_y

    s = -2.0 * tan_half_fov
    aspect = height / width
    sx = (px / width - 0.5) * s * z_near
    sy = (py / height - 0.5) * s * aspect * z_near
    sz = torch.full((n,), 1.0, dtype=torch.float32, device=px.device) * z_near

    d = Vec3(rot[0, 0] * sx + rot[0, 1] * sy + rot[0, 2] * sz,
             rot[1, 0] * sx + rot[1, 1] * sy + rot[1, 2] * sz,
             rot[2, 0] * sx + rot[2, 1] * sy + rot[2, 2] * sz
             ).normalize(eps=1e-20)
    o = Vec3(pos[0].expand(n), pos[1].expand(n), pos[2].expand(n))
    return o, d


def uniforms_per_bounce(scene) -> int:
    return UNIFORMS_PER_SCATTER + UNIFORMS_PER_AREA_LIGHT * scene.num_area_lights


def bounce(scene, state: PathState, uniforms, do_scatter: bool = True,
           grid=None, physical: bool = False,
           nee: bool = True, light_area_table=None,
           bidir_nu: Optional[float] = None,
           bounce_idx: Optional[int] = None) -> PathState:
    """One wavefront bounce (the ``pathTraceKernel`` body), masked over
    ``active``. ``grid`` walks the DDA for the intersection and shadow
    sweeps (the same hits). ``physical=True`` is the unbiased estimator:
    uniform-area light sampling in the correct measure combined with BSDF
    sampling by the power heuristic; ``nee=False`` (physical only) drops
    light sampling; ``bidir_nu`` adds the bidirectional carries and weights
    (``bounce_idx`` then tells the primary hit)."""
    if grid is None:
        hit = nearest_hit(state.origin, state.direction, scene)
    else:
        from ..ops.grid import nearest_hit_grid
        hit = nearest_hit_grid(state.origin, state.direction, scene, grid)
    surfel = surfel_at(state.origin, state.direction, hit, scene)
    m = lookup_materials(scene.materials, surfel.mat)
    if scene.num_textures:
        # no random numbers: textured and untextured scenes share streams
        from ..ops.texture import apply_maps_eager
        m, surfel = apply_maps_eager(scene, state.origin, state.direction,
                                     hit, surfel, m)

    cos_i = (-state.direction).dot(surfel.normal)
    inside = cos_i <= 0.0
    act_hit = state.active & hit.hit
    zeros1 = torch.zeros_like(cos_i)
    zeros3 = Vec3(zeros1, zeros1, zeros1)

    # ---- bidirectional-MIS chain quantities (T: the nu-free ratio of the
    # light-tracer prefix over the eye prefix up to this vertex)
    bidir = physical and nee and (bidir_nu is not None)
    bd_nee = None
    if bidir:
        n_unit_b = surfel.normal.normalize(eps=1e-12)
        cos_arr = torch.abs(state.direction.dot(n_unit_b))
        t2_arr = torch.clamp_min(torch.where(hit.hit, hit.t, 1.0) ** 2, 1e-12)
        is_primary = bounce_idx == 0
        c_a = state.j_img * cos_arr / t2_arr
        e_prev = state.prev_pdf_model * cos_arr / t2_arr
        # clamped like the light tracer's carry: an inf carry would NaN the
        # forward 0 * inf gates and every product's gradient
        T = torch.clamp_max(
            1.0 / torch.clamp_min(c_a, 1e-20) if is_primary
            else state.lt_chain / torch.clamp_min(e_prev, 1e-20),
            MIS_RATIO_CLAMP)
        L_lights = max(scene.num_area_lights, 1)
        bd_nee = BidirNEE(mult=(bidir_nu / L_lights) * T,
                          out_dir=-state.direction, m=m,
                          normal=surfel.normal,
                          prev_cos_out=state.prev_cos_out, t2_arr=t2_arr,
                          is_primary=is_primary)

    # Direct light: emission always, NEE only from outside.
    gloss = ct_lobe = None
    if physical and nee:
        # the specular lobes scatter() would draw here, so that NEE can
        # light-sample them too (delta cases carry density 0)
        cos_i_pos, sin_t2, n1, n2, _ = media_and_sin_t2(m.ior, cos_i)
        fres = fresnel_reflectance(cos_i_pos, sin_t2, n1, n2)
        pure = (m.flags & 0x01) != 0
        ct = (m.flags & 0x03) != 0
        p_spec = m.spec_avg * torch.where(pure, 1.0, fres)
        gloss = GlossLobe(
            axis=phong_lobe_axis(
                reflect_signed(state.direction, surfel.normal, cos_i_pos)),
            exponent=m.spec_exp, weight=m.specular,
            prob=torch.where(ct, 0.0, p_spec))
        ct_lobe = CTLobe(
            axis=phong_lobe_axis(surfel.normal), roughness=m.roughness,
            weight=m.specular,
            prob=torch.where(ct & (m.roughness > 0.0), p_spec, 0.0),
            d=state.direction, normal=surfel.normal,
            nv=torch.clamp_min(torch.abs(cos_i), 1e-6))
    if physical:
        if nee:
            nee_l = shade_physical(scene, surfel.point, surfel.normal,
                                   m.diffuse, m.diff_avg,
                                   uniforms[UNIFORMS_PER_SCATTER:],
                                   grid=grid, mis=True,
                                   gloss=gloss, ct=ct_lobe, bidir=bd_nee)
            # the MIS weight of BSDF-sampled emission, complementary to the
            # NEE weight of the light this ray hit (prev_pdf == 0: no NEE
            # competed, weight 1; unregistered emitters keep weight 1)
            S = scene.num_spheres
            if scene.num_area_lights and scene.num_triangles:
                areas = (light_area_table if light_area_table is not None
                         else light_areas(scene))
                ti = torch.clamp(hit.prim - S, 0, scene.num_triangles - 1)
                a_hit = torch.where(hit.prim >= S, areas[ti], 0.0)
                # cos at the light from its GEOMETRIC normal, as
                # shade_physical's p_l
                v0 = gather(scene.tri_v0, ti)
                n_geom = (gather(scene.tri_v1, ti) - v0).cross(
                    gather(scene.tri_v2, ti) - v0).normalize(eps=1e-12)
            else:
                a_hit = zeros1
                n_geom = surfel.normal.normalize(eps=1e-12)
            cos_l_hit = torch.abs(state.direction.dot(n_geom))
            t_hit = torch.where(hit.hit, hit.t, 1.0)
            p_l_hit = (t_hit * t_hit) / torch.clamp_min(a_hit * cos_l_hit,
                                                        1e-12)
            p_b = state.prev_pdf
            if bidir:
                # three-way weight: BSDF hit vs NEE vs the light tracer's
                # camera connection
                r_nee = torch.where(p_b > 0.0,
                                    p_l_hit / torch.clamp_min(p_b, 1e-20), 0.0)
                inv_pl_a = 1.0 / torch.clamp_min(L_lights * a_hit, 1e-20)
                l_emit_hit = (0.5 * cos_l_hit * INV_PI
                              * state.prev_cos_out / t2_arr)
                rho = (bidir_nu * inv_pl_a
                       * (1.0 if is_primary else l_emit_hit) * T)
                # clamp before squaring: r ~ 1e20 squares to inf, whose
                # reverse-mode cotangent is NaN
                r_nee = torch.clamp_max(r_nee, MIS_RATIO_CLAMP)
                rho = torch.clamp_max(rho, MIS_RATIO_CLAMP)
                w_emit = torch.where(
                    a_hit > 0.0, 1.0 / (1.0 + r_nee * r_nee + rho * rho), 1.0)
            else:
                w_emit = torch.where(
                    (p_b > 0.0) & (a_hit > 0.0),
                    (p_b * p_b) / torch.clamp_min(p_b * p_b
                                                  + p_l_hit * p_l_hit, 1e-20),
                    1.0)
            direct = m.emission * w_emit + vwhere(~inside, nee_l, zeros3)
        else:
            direct = m.emission
    else:
        nee_l = shade(scene, surfel.point, surfel.normal, m.diffuse,
                      m.diff_avg, uniforms[UNIFORMS_PER_SCATTER:], grid=grid)
        direct = m.emission + vwhere(~inside, nee_l, zeros3)

    # Beer-Lambert absorbance over the interior path length
    t_safe = torch.where(hit.hit, hit.t, 0.0)
    beer = Vec3(torch.exp(-t_safe * m.absorption.x),
                torch.exp(-t_safe * m.absorption.y),
                torch.exp(-t_safe * m.absorption.z))
    throughput = vwhere(act_hit & inside, state.throughput * beer,
                        state.throughput)

    radiance = state.radiance + vwhere(act_hit, throughput * direct, zeros3)
    # miss: add the background, kill the ray
    miss = state.active & ~hit.hit
    bg = Vec3.from_array(scene.background)
    radiance = radiance + vwhere(miss, bg * state.throughput, zeros3)
    active = state.active & hit.hit

    origin, direction = state.origin, state.direction
    prev_pdf = state.prev_pdf
    lt_chain = state.lt_chain
    prev_pdf_model = state.prev_pdf_model
    prev_cos_out = state.prev_cos_out
    if do_scatter:
        sc = scatter(state.direction, surfel.point, surfel.normal, m, cos_i,
                     uniforms[0], uniforms[1], uniforms[2])
        origin = vwhere(act_hit, sc.origin, origin)
        direction = vwhere(act_hit, sc.direction, direction)
        throughput = vwhere(act_hit, throughput * sc.weight, throughput)
        active = active & sc.alive
        if physical and nee:
            pdf_diff, pdf_gloss, pdf_ct = scatter_lobe_pdfs(
                state.direction, surfel.normal, m, cos_i, sc.direction)
            pdf_new = torch.where(
                sc.diffuse_branch, pdf_diff,
                torch.where(sc.gloss_branch, pdf_gloss,
                            torch.where(sc.ct_branch, pdf_ct, 0.0)))
            # an inside hit had no NEE: its continuation carries full weight
            prev_pdf = torch.where(act_hit,
                                   torch.where(~inside, pdf_new, 0.0),
                                   prev_pdf)
        if bidir:
            # chain-model densities of the taken branch, both directions
            pdf_fwd_m = chain_model_pdf_taken(state.direction, surfel.normal,
                                              m, cos_i, sc.direction, sc)
            cos_i_rev = sc.direction.dot(surfel.normal)
            pdf_rev_m = chain_model_pdf_taken(-sc.direction, surfel.normal,
                                              m, cos_i_rev,
                                              -state.direction, sc)
            lam_full = pdf_rev_m * state.prev_cos_out / t2_arr
            if is_primary:
                s_new = (torch.where(sc.diffuse_branch & (cos_i > 0.0),
                                     1.0, 0.0)
                         / torch.clamp_min(c_a, 1e-20))
            else:
                s_new = T * lam_full
            s_new = torch.clamp_max(s_new, MIS_RATIO_CLAMP)
            lt_chain = torch.where(act_hit, s_new, lt_chain)
            prev_pdf_model = torch.where(act_hit, pdf_fwd_m, prev_pdf_model)
            prev_cos_out = torch.where(
                act_hit, torch.abs(sc.direction.dot(n_unit_b)), prev_cos_out)

    return PathState(origin=origin, direction=direction, radiance=radiance,
                     throughput=throughput, active=active, prev_pdf=prev_pdf,
                     lt_chain=lt_chain, prev_pdf_model=prev_pdf_model,
                     prev_cos_out=prev_cos_out, j_img=state.j_img)


def initial_state(origins: Vec3, directions: Vec3, j_img=None) -> PathState:
    zeros = torch.zeros_like(origins.x)
    return PathState(
        origin=origins, direction=directions,
        radiance=Vec3(zeros, zeros, zeros),
        throughput=Vec3.ones(zeros.shape, like=zeros),
        active=torch.ones(zeros.shape, dtype=torch.bool, device=zeros.device),
        prev_pdf=zeros, lt_chain=zeros, prev_pdf_model=zeros,
        prev_cos_out=torch.ones_like(zeros),
        j_img=zeros if j_img is None else j_img)


def eye_j_img(cam_params, d: Vec3, width: int, height: int):
    """Camera importance ``J_img = dA_img / dOmega`` of unit eye directions
    (the light tracer's splat Jacobian). ``cam_params`` are
    :func:`camera_tensors`."""
    rot, _, thf, _ = cam_params
    vz = rot[0, 2] * d.x + rot[1, 2] * d.y + rot[2, 2] * d.z
    cos_t = torch.clamp(torch.abs(vz), 1e-4, 1.0)
    s = -2.0 * thf
    aspect = height / width
    denom = s * s * aspect * cos_t ** 3
    # a true division (a Python scalar over a tensor multiplies by the
    # reciprocal)
    return torch.full_like(denom, float(width * height)) / denom


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trace_wave(scene, origins: Vec3, directions: Vec3, seed, sample_idx,
                pixel_idx, max_bounces: int, live_cutoff: Optional[int],
                grid, physical: bool, nee: bool, bidir_nu: Optional[float],
                j_img, group=None, n_groups: int = 1,
                live_counts: Optional[List[int]] = None) -> Vec3:
    """Trace a wavefront to completion and return each ray's radiance.
    The live cutoff applies to each ``group`` of rays on its own (a sample
    of ``render``); ``live_counts`` (a list) receives the number of live
    rays entering each bounce."""
    if bidir_nu is not None and live_cutoff is not None:
        raise ValueError("bidir_nu requires the scan driver "
                         "(live_cutoff=None)")
    n = origins.x.shape[0]
    dev = origins.x.device
    if n == 0 or max_bounces < 1:
        return Vec3(*(torch.zeros(n, device=dev),) * 3)
    sample = torch.as_tensor(sample_idx, device=dev).to(torch.int64)
    # a loop constant of the MIS weights, computed once
    area_table = None
    if physical and nee and scene.num_area_lights and scene.num_triangles:
        area_table = light_areas(scene)
    wave = _Wave(
        path=initial_state(origins, directions, j_img=j_img),
        pixel=pixel_idx.to(torch.int64), sample=sample.expand(n),
        slot=torch.arange(n, device=dev),
        group=(torch.zeros(n, dtype=torch.int64, device=dev) if group is None
               else group))
    running = torch.ones(n_groups, dtype=torch.bool, device=dev)
    done_slots, done_rad = [], []

    def retire(w):
        done_slots.append(w.slot)
        done_rad.append(w.path.radiance)

    timing = BOUNCE_TIMES
    for b in range(max_bounces):
        if timing is not None:
            _sync(dev)
            t0, rays_in = time.perf_counter(), wave.slot.shape[0]
        if live_counts is not None:
            live_counts.append(wave.slot.shape[0])
        if live_cutoff is not None and b > 0:
            # the while loop's test: a group goes on while more than
            # live_cutoff of its rays are live
            live = torch.bincount(wave.group, minlength=n_groups)
            still = running & (live > live_cutoff)
            if bool((still != running).any()):   # a group stops here
                running = still
                keep = running[wave.group]
                retire(tree_take(wave, ~keep))
                wave = tree_take(wave, keep)
        if not wave.slot.shape[0]:
            break
        # a range of its own in a profiler's trace (utils/profiling.trace)
        with torch.profiler.record_function(f"eye bounce {b}"):
            u = rng.bounce_rows(seed, wave.pixel, wave.sample, b,
                                scene.num_area_lights)
            # the last bounce's scattered state is never read: not drawn
            last = b == max_bounces - 1
            wave = wave._replace(path=bounce(
                scene, wave.path, u, do_scatter=not last, grid=grid,
                physical=physical, nee=nee, light_area_table=area_table,
                bidir_nu=bidir_nu, bounce_idx=b))
            if not last:
                wave, live = partition_by_activity(wave)
                live = int(live)
                retire(tree_take(wave, slice(live, None)))
                wave = tree_take(wave, slice(0, live))
        if timing is not None:
            _sync(dev)
            timing.append((b, rays_in, (time.perf_counter() - t0) * 1e3))
    retire(wave)
    rad = Vec3(*(torch.cat([getattr(r, c) for r in done_rad]) for c in "xyz"))
    return rad[torch.argsort(torch.cat(done_slots))]


def trace(scene, origins: Vec3, directions: Vec3, seed, sample_idx, pixel_idx,
          max_bounces: int = DEFAULT_MAX_BOUNCES,
          live_cutoff: Optional[int] = None, grid=None,
          physical: bool = False, nee: bool = True,
          bidir_nu: Optional[float] = None, j_img=None) -> Vec3:
    """Trace the wavefront to completion; returns per-ray radiance.
    ``pixel_idx`` is each ray's flat pixel (its Threefry key), ``(seed,
    sample_idx)`` complete the counter. ``live_cutoff=None`` traces every
    bounce (the differentiable loop); ``live_cutoff=k`` stops once at most
    ``k`` rays are live. The tensors are on one device, the scene (and the
    grid) with them."""
    return _trace_wave(scene, origins, directions, seed, sample_idx,
                       pixel_idx, max_bounces, live_cutoff, grid, physical,
                       nee, bidir_nu, j_img)


def render_block(scene, cam_params, width: int, height: int, pixel_idx,
                 seed, sample_idx, max_bounces: int = DEFAULT_MAX_BOUNCES,
                 live_cutoff: Optional[int] = None, grid=None,
                 physical: bool = False, nee: bool = True,
                 bidir_nu: Optional[float] = None) -> Vec3:
    """One sample for a block of pixels: jittered eye rays + the full path
    trace (on ``pixel_idx``'s device; ``cam_params`` are
    :func:`camera_tensors`)."""
    jx, jy = rng.eye_jitter(seed, pixel_idx, sample_idx)
    origins, directions = eye_rays_for_indices(cam_params, width, height,
                                               pixel_idx, jx, jy)
    j = (eye_j_img(cam_params, directions, width, height)
         if bidir_nu is not None else None)
    return trace(scene, origins, directions, seed, sample_idx, pixel_idx,
                 max_bounces=max_bounces, live_cutoff=live_cutoff, grid=grid,
                 physical=physical, nee=nee, bidir_nu=bidir_nu, j_img=j)


def render_sample(scene, cam_params, width: int, height: int, seed,
                  sample_idx, max_bounces: int = DEFAULT_MAX_BOUNCES,
                  live_cutoff: Optional[int] = None, grid=None,
                  physical: bool = False, nee: bool = True,
                  bidir_nu: Optional[float] = None) -> Vec3:
    """One sample per pixel over the whole image: radiance as a Vec3 of
    [W*H] (row 0 = bottom), on the scene's device."""
    dev = scene.background.device
    pixel_idx = torch.arange(width * height, dtype=torch.int64, device=dev)
    return render_block(scene, camera_tensors(cam_params, dev), width, height,
                        pixel_idx, seed, sample_idx, max_bounces=max_bounces,
                        live_cutoff=live_cutoff, grid=grid, physical=physical,
                        nee=nee, bidir_nu=bidir_nu)


def sample_radiance(scene, cam_params, width: int, height: int, seed,
                    samples, max_bounces: int = DEFAULT_MAX_BOUNCES,
                    live_cutoff: Optional[int] = None, grid=None,
                    physical: bool = False, nee: bool = True,
                    bidir_nu: Optional[float] = None, pixel_idx=None):
    """Yield the ``[W*H, 3]`` radiance of each global sample index in
    ``samples``, in order. Samples are traced together, up to
    ``WAVE_RAYS`` rays per wavefront; the live cutoff applies to each
    sample on its own. ``scene`` (and ``grid``) are on the render device.
    ``pixel_idx`` (flat indices on that device) traces those pixels alone
    and yields ``[len(pixel_idx), 3]``: a tile of the same image, the live
    cutoff counting the tile's rays."""
    dev = scene.background.device
    cam = camera_tensors(cam_params, dev)
    pix = (torch.arange(width * height, dtype=torch.int64, device=dev)
           if pixel_idx is None else pixel_idx.to(torch.int64))
    n = pix.shape[0]
    samples = list(samples)
    per_wave = max(1, WAVE_RAYS // max(n, 1))
    for k0 in range(0, len(samples), per_wave):
        batch = samples[k0:k0 + per_wave]
        b = len(batch)
        pixel_idx = pix.repeat(b)
        group = torch.arange(b, device=dev).repeat_interleave(n)
        sample_idx = torch.as_tensor(batch, dtype=torch.int64,
                                     device=dev)[group]
        jx, jy = rng.eye_jitter(seed, pixel_idx, sample_idx)
        o, d = eye_rays_for_indices(cam, width, height, pixel_idx, jx, jy)
        j = (eye_j_img(cam, d, width, height) if bidir_nu is not None
             else None)
        rad = _trace_wave(scene, o, d, seed, sample_idx, pixel_idx,
                          max_bounces, live_cutoff, grid, physical, nee,
                          bidir_nu, j, group=group, n_groups=b)
        arr = rad.to_array().reshape(b, n, 3)
        for i in range(b):
            yield arr[i]


def _on_device(scene, grid, device):
    device = resolve_device(device)
    return scene.to(device), (grid.to(device) if grid is not None else None)


def live_ray_stats(scene, cam_params, width: int, height: int, seed,
                   max_bounces: int = DEFAULT_MAX_BOUNCES, device="cuda"):
    """Wavefront occupancy: the fraction of rays still live entering each
    bounce of sample 0, every bounce scattering (the observable the
    reference prints through its shrinking ``numRays``). Returns a
    ``[max_bounces]`` float32 tensor on ``device``; 0 after the wavefront
    has emptied."""
    scene, _ = _on_device(scene, None, device)
    dev = scene.background.device
    n = width * height
    pixel_idx = torch.arange(n, dtype=torch.int64, device=dev)
    cam = camera_tensors(cam_params, dev)
    jx, jy = rng.eye_jitter(seed, pixel_idx, 0)
    o, d = eye_rays_for_indices(cam, width, height, pixel_idx, jx, jy)
    counts: List[int] = []
    with torch.no_grad():
        _trace_wave(scene, o, d, seed, 0, pixel_idx, max_bounces, None, None,
                    False, True, None, None, live_counts=counts)
    live = torch.zeros(max_bounces, dtype=torch.float32, device=dev)
    live[:len(counts)] = torch.as_tensor(counts, dtype=torch.float32,
                                         device=dev)
    return live / torch.full_like(live, float(n))


def render(scene, cam_params, width: int, height: int, spp: int, seed,
           max_bounces: int = DEFAULT_MAX_BOUNCES,
           live_cutoff: Optional[int] = LIVE_RAY_CUTOFF,
           sample_offset: int = 0, grid=None, physical: bool = False,
           nee: bool = True, bidir_nu: Optional[float] = None,
           device="cuda") -> torch.Tensor:
    """Render ``spp`` samples per pixel; returns the mean radiance image
    ``[height, width, 3]`` float32 on ``device``. Samples use global
    indices ``sample_offset .. sample_offset + spp`` (progressive passes
    reproduce one render); their radiance is summed sample by sample, as
    the reference's scan does. ``grid`` is ``ops.grid.build_grid``'s;
    autograd reaches the scene's fields (use ``live_cutoff=None``)."""
    scene, grid = _on_device(scene, grid, device)
    acc = torch.zeros((width * height, 3), dtype=torch.float32,
                      device=scene.background.device)
    for r in sample_radiance(scene, cam_params, width, height, seed,
                             range(sample_offset, sample_offset + spp),
                             max_bounces=max_bounces, live_cutoff=live_cutoff,
                             grid=grid, physical=physical, nee=nee,
                             bidir_nu=bidir_nu):
        acc = acc + r
    return (acc / spp).reshape(height, width, 3)
