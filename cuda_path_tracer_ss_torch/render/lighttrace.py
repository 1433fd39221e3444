"""Light tracing on the eager engine: paths start ON the area lights, walk
into the scene, and every vertex connects to the pinhole camera.

The counterpart of the JAX package's ``render/lighttrace.py`` (its jnp
engine), in plain PyTorch: the same estimator, formulas and float order, so
the two agree per pixel, and autograd differentiates it where the reference
uses ``jax.grad`` (``render/inverse.py``, ``engine="lighttrace"|"bidir"``).
The hand-written kernel of the same estimator is
``ops/cuda/lightkernel.py`` (forward only, no textures).

Estimator (the implied-BSDF algebra of ``ops/bsdf.py``):

* a path starts at a point uniform on a uniformly picked area light
  (throughput ``n_lights * area * Le``) with a cosine-hemisphere direction
  on a random side of the two-sided emitter (factor ``2 pi``);
* interior vertices scatter with the eye paths' ``ops/bsdf.scatter``
  cascade, interior segments attenuate by Beer-Lambert;
* every vertex connects to the camera through the diffuse lobe in forward
  orientation, one-sided like the forward estimator, and splats
  ``beta * f_d * cos_cam / r^2 * J_img`` into the pixel it projects to
  (``J_img = dA_img / dOmega``, the inverse of the jittered eye-ray map);
  the emitter surface itself splats at vertex 0;
* ``bidir_nu`` weights every splat against the eye-path techniques
  (``render/bidir.py``); every ratio is clamped at ``MIS_RATIO_CLAMP``
  before it is squared or carried on.

The splat is the reference's ``.at[pixel].add``: an out-of-place
``index_add`` on the graph, once per bounce. The pixel index is discrete and
detached, the value differentiable; an off-screen or gated splat adds zero
to pixel 0. ``index_add`` sums in another order than XLA's scatter, and on
a card it uses float atomics, so an image is not bit-stable there.

After each bounce the live paths are stably partitioned into a dense prefix
(``ops/compaction.py``) and only they are traced on. Each path carries its
GLOBAL index, and every draw keys on (seed, global path index,
``sample_idx``, draw), so any block of paths gives the splats that slice
of the whole batch gives (``lighttrace_block``).

``project_dir`` lives here: the reference keeps it in
``render/silhouette.py`` and imports it into its light tracer; the port's
silhouette module imports it from this module.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..constants import DEFAULT_MAX_BOUNCES, MIS_RATIO_CLAMP, RAY_BUMP_EPSILON
from ..ops.bsdf import chain_model_pdf_taken, lookup_materials, scatter
from ..ops.compaction import partition_by_activity, tree_take
from ..ops.intersect import any_hit, nearest_hit, surfel_at
from ..ops.sampling import lambert_direction
from ..ops.shading import area_light_sample_uniform
from ..ops.vec import Vec3, where as vwhere
from ..utils import rng
from .integrator import WAVE_RAYS, _on_device, camera_tensors, eye_j_img

# the reference's own 1/pi here (not constants.INV_PI, a rounded literal)
INV_PI = 1.0 / math.pi


def project_dir(cam_params, d: Vec3, width: int, height: int):
    """World direction -> continuous pixel coordinates ``(px, py, front)``.

    The exact inverse of ``integrator.eye_rays_for_indices``: rotate into
    the camera frame, divide out depth, undo the fov / aspect scaling.
    ``front`` is False for directions behind the near plane. The camera
    looks along the sign of ``z_near``. ``cam_params`` are
    ``integrator.camera_tensors``."""
    rot, pos, thf, z_near = cam_params
    vx, vy, vz = _camera_frame(cam_params, d)
    s = -2.0 * thf
    aspect = height / width
    safe_vz = torch.where(torch.abs(vz) < 1e-12, 1e-12, vz)
    px = (vx / (safe_vz * s) + 0.5) * width
    py = (vy / (safe_vz * s * aspect) + 0.5) * height
    return px, py, vz * torch.sign(z_near) > 1e-7


def _camera_frame(cam_params, d: Vec3):
    """Camera-frame components of world direction d (columns of R)."""
    rot = cam_params[0]
    vx = rot[0, 0] * d.x + rot[1, 0] * d.y + rot[2, 0] * d.z
    vy = rot[0, 1] * d.x + rot[1, 1] * d.y + rot[2, 1] * d.z
    vz = rot[0, 2] * d.x + rot[1, 2] * d.y + rot[2, 2] * d.z
    return vx, vy, vz


def camera_splat_weights(cam_params, p: Vec3, width: int, height: int):
    """Everything the pinhole connection of points ``p`` needs: (pixel
    index int64, on screen and in front, unit direction eye -> p, squared
    distance, distance, ``J_img``). ``J_img = W*H / (s^2 aspect
    cos^3 theta)`` with ``s = -2 tan(fov/2)`` converts camera solid angle
    to image-plane pixel area. ``cam_params`` are
    ``integrator.camera_tensors``."""
    pos = cam_params[1]
    to_p = p - Vec3(pos[0], pos[1], pos[2])
    r2 = torch.clamp_min(to_p.norm2(), 1e-12)
    r = torch.sqrt(r2)
    d = to_p / r
    with torch.no_grad():
        px, py, front = project_dir(cam_params, d, width, height)
        on = front & (px >= 0) & (px < width) & (py >= 0) & (py < height)
        ix = torch.clamp(torch.floor(px), 0, width - 1).to(torch.int64)
        iy = torch.clamp(torch.floor(py), 0, height - 1).to(torch.int64)
        pixel_idx = iy * width + ix
    return pixel_idx, on, d, r2, r, eye_j_img(cam_params, d, width, height)


def _visible_to_eye(scene, p: Vec3, d_to_eye: Vec3, dist):
    o = p + d_to_eye * RAY_BUMP_EPSILON
    return ~any_hit(o, d_to_eye, dist - 2.0 * RAY_BUMP_EPSILON, scene)


def _splat(img, pix, on, contrib: Vec3):
    """``img.at[where(on, pix, 0)].add(where(on, contrib, 0))`` out of place:
    the pixel index is detached, the value differentiable."""
    c = torch.stack([torch.where(on, contrib.x, 0.0),
                     torch.where(on, contrib.y, 0.0),
                     torch.where(on, contrib.z, 0.0)], -1)
    return img.index_add(0, torch.where(on, pix, 0), c)


class _LightPaths(NamedTuple):
    """The live light paths: their state, global index and the
    bidirectional-MIS carries (ones / zeros when ``bidir_nu`` is None; see
    ``render/bidir.py``)."""

    origin: Vec3
    direction: Vec3
    beta: Vec3
    active: torch.Tensor
    path_idx: torch.Tensor
    inv_pl_a: torch.Tensor      # 1 / P_L_A: L times the picked light's area
    U: torch.Tensor             # chain ratio
    r0: torch.Tensor            # pr_0 (complete, area measure)
    pr_carry: torch.Tensor      # pr_{n-2}
    nee_ok: torch.Tensor        # the NEE gate at x_1 (float)
    pf_pending: torch.Tensor    # forward model pdf of the last scatter
    prev_cos_out: torch.Tensor  # |n_hat . d_out| at the last vertex


def lighttrace_block(scene, cam_params, width: int, height: int, path_idx,
                     seed, max_bounces: int = DEFAULT_MAX_BOUNCES,
                     sample_idx=0, bidir_nu: Optional[float] = None
                     ) -> torch.Tensor:
    """UNNORMALISED splat image ``[width * height, 3]`` of a block of global
    light-path indices ``path_idx``, on their device (the scene with them;
    ``cam_params`` as ``camera_arrays`` gives them or as
    ``integrator.camera_tensors``). Streams key on (seed, GLOBAL path index,
    sample_idx, draw), so any tiling of the paths gives the same per-path
    splats; the caller sums blocks and divides by the total path count."""
    dev = path_idx.device
    cam = camera_tensors(cam_params, dev)
    path_idx = path_idx.to(torch.int64)
    n = path_idx.shape[0]
    L = scene.num_area_lights
    img = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return img
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)

    # ---- the emission vertex: a light picked uniformly, every light
    # evaluated and masked (L is tiny) ----------------------------------------
    u = rng.bounce_rows(seed, path_idx, sample_idx, 0, L)
    u0, u1, u2, u3 = u[0], u[1], u[2], u[3]
    li = torch.clamp_max((u0 * L).to(torch.int32), L - 1)
    point = Vec3(zeros, zeros, zeros)
    n_l = Vec3(zeros, zeros, zeros)
    area = zeros
    l_e = Vec3(zeros, zeros, zeros)
    for k in range(L):
        pk, nk, ak, ek = area_light_sample_uniform(scene, k, u1, u2, u3)
        sel = li == k
        point = vwhere(sel, pk, point)
        n_l = vwhere(sel, nk, n_l)
        area = torch.where(sel, ak, area)
        l_e = vwhere(sel, ek, l_e)

    # ---- the emitter surface's own splat (what eye rays see as Le) -----------
    t_emit = l_e * (float(L) * area)          # 1 / pdf of (light, point)
    pix, on, d_c, r2, r, j_img = camera_splat_weights(cam, point, width, height)
    vis = _visible_to_eye(scene, point, -d_c, r)
    cos_c = torch.abs(n_l.dot(d_c))           # two-sided emitter
    w_splat = 1.0
    if bidir_nu is not None:
        # against a camera ray hitting the emitter: p_fwd = J_img cos / r^2
        # in area measure at the light point, p_splat = 1 / (L area)
        c_a0 = j_img * cos_c / r2
        r_spl = torch.clamp_max(c_a0 * (float(L) * area) / bidir_nu,
                                MIS_RATIO_CLAMP)
        w_splat = 1.0 / (1.0 + r_spl * r_spl)
    img = _splat(img, pix, on & vis, t_emit * (w_splat * cos_c / r2 * j_img))

    # ---- leave the light: cosine hemisphere on a random side -----------------
    side = torch.where(u0 * L - li.to(torch.float32) < 0.5, 1.0, -1.0)
    n_emit = n_l * side
    u_dir = rng.bounce_rows(seed, path_idx, sample_idx, 1, L)
    d0 = lambert_direction(n_emit, u_dir[0], u_dir[1])
    # (cos/pi) direction density and the 1/2 side pick: beta gains 2 pi
    beta = t_emit * (2.0 * math.pi)
    origin = point + n_emit * RAY_BUMP_EPSILON
    cos0 = torch.abs(n_emit.dot(d0))
    paths = _LightPaths(
        origin=origin, direction=d0, beta=beta,
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        path_idx=path_idx, inv_pl_a=float(L) * area, U=zeros, r0=zeros,
        pr_carry=torch.ones_like(zeros), nee_ok=torch.ones_like(zeros),
        pf_pending=0.5 * cos0 * INV_PI,       # emission solid-angle density
        prev_cos_out=cos0)

    for b in range(max_bounces):
        last = b == max_bounces - 1
        # a range of its own in a profiler's trace (utils/profiling.trace)
        with torch.profiler.record_function(f"light bounce {b}"):
            img, paths = _light_bounce(scene, cam, width, height, seed,
                                       sample_idx, b, bidir_nu, img, paths,
                                       scatter_on=not last)
            if last:
                break
            # the live paths into a dense prefix, their global indices too
            paths, live = partition_by_activity(paths)
            live = int(live)
            if not live:
                break
            paths = tree_take(paths, slice(0, live))
    return img


def _light_bounce(scene, cam, width, height, seed, sample_idx, b, bidir_nu,
                  img, p: _LightPaths, scatter_on: bool):
    """One bounce of the live paths ``p``: the camera connection of the
    vertex it hits and (``scatter_on``) the continuation."""
    L = scene.num_area_lights
    first = b == 0
    direction = p.direction
    hit = nearest_hit(p.origin, direction, scene)
    surfel = surfel_at(p.origin, direction, hit, scene)
    m = lookup_materials(scene.materials, surfel.mat)
    if scene.num_textures:
        # the connection reads the same modulated albedo as the eye paths
        from ..ops.texture import apply_maps_eager
        m, surfel = apply_maps_eager(scene, p.origin, direction, hit, surfel, m)
    act = p.active & hit.hit

    # Beer-Lambert over interior segments (symmetric in the direction)
    cos_in = (-direction).dot(surfel.normal)
    t_seg = torch.where(hit.hit, hit.t, 0.0)
    beer_on = act & (cos_in <= 0.0)
    beta = vwhere(beer_on,
                  p.beta * Vec3(torch.exp(-t_seg * m.absorption.x),
                                torch.exp(-t_seg * m.absorption.y),
                                torch.exp(-t_seg * m.absorption.z)),
                  p.beta)

    # ---- the camera connection: diffuse lobe, forward orientation, ONE-SIDED
    # like the forward estimator (the eye on the front side, the light from
    # outside) -----------------------------------------------------------------
    pix, on, d_c, r2, r, j_img = camera_splat_weights(cam, surfel.point,
                                                      width, height)
    n_unit = surfel.normal.normalize(eps=1e-20)
    cos_i = (-direction).dot(surfel.normal)
    cos_c = torch.clamp_min(-n_unit.dot(d_c), 0.0)
    front = (cos_c > 0.0) & (cos_i > 0.0)
    vis = _visible_to_eye(scene, surfel.point, -d_c, r)
    f_d = m.diffuse * (m.diff_avg * INV_PI)
    w_conn = 1.0
    t2 = torch.clamp_min(torch.where(hit.hit, hit.t, 1.0) ** 2, 1e-12)
    U = p.U
    if bidir_nu is not None:
        cos_arr = torch.abs(direction.dot(n_unit))
        # complete the pending forward pdf with this arrival's area term
        pf_full = torch.clamp_min(p.pf_pending * cos_arr / t2, 1e-20)
        # clamped per bounce: repeated / pf at the floor would run U to inf,
        # and an inf carry NaNs the forward value and every product's VJP
        U = torch.clamp_max(p.inv_pl_a / pf_full if first
                            else U * p.pr_carry / pf_full, MIS_RATIO_CLAMP)
        c_a = j_img * cos_c / r2
        prd_sa = m.diff_avg * torch.clamp_min((-direction).dot(n_unit),
                                              0.0) * INV_PI
        geo_prev = p.prev_cos_out / t2
        prd_eff = 1.0 if first else prd_sa * geo_prev
        # P_NEE_A = 1 / area = L / (L area)
        p_nee_a = (torch.full_like(p.inv_pl_a, float(L))
                   / torch.clamp_min(p.inv_pl_a, 1e-20))
        rho_n = (1.0 if first else p.nee_ok) * c_a * p_nee_a * prd_eff * U
        r0_eff = prd_sa * geo_prev if first else p.r0
        rho_b = c_a * prd_eff * U * r0_eff
        rn = torch.clamp_max(rho_n / bidir_nu, MIS_RATIO_CLAMP)
        rb = torch.clamp_max(rho_b / bidir_nu, MIS_RATIO_CLAMP)
        w_conn = 1.0 / (1.0 + rn * rn + rb * rb)
    contrib = beta * f_d * (w_conn * cos_c / r2 * j_img)
    img = _splat(img, pix, on & vis & act & front, contrib)
    if not scatter_on:
        return img, p

    # ---- continue the path with the eye paths' scatter cascade ---------------
    uu = rng.bounce_rows(seed, p.path_idx, sample_idx, b + 2, L)
    sc = scatter(direction, surfel.point, surfel.normal, m, cos_i,
                 uu[0], uu[1], uu[2])
    r0, pr_carry, nee_ok = p.r0, p.pr_carry, p.nee_ok
    pf_pending, prev_cos_out = p.pf_pending, p.prev_cos_out
    if bidir_nu is not None:
        pf_new = chain_model_pdf_taken(direction, surfel.normal, m, cos_i,
                                       sc.direction, sc)
        pr_sa = chain_model_pdf_taken(-sc.direction, surfel.normal, m,
                                      sc.direction.dot(surfel.normal),
                                      -direction, sc)
        pr_full = pr_sa * p.prev_cos_out / t2
        if first:
            r0 = pr_full
            pr_carry = torch.ones_like(pr_full)
            nee_ok = (sc.direction.dot(n_unit) > 0.0).to(torch.float32)
        else:
            pr_carry = pr_full
        pf_pending = torch.where(act, pf_new, pf_pending)
        prev_cos_out = torch.where(act, torch.abs(sc.direction.dot(n_unit)),
                                   prev_cos_out)
    return img, p._replace(origin=sc.origin, direction=sc.direction,
                           beta=beta * sc.weight, active=act & sc.alive, U=U,
                           r0=r0, pr_carry=pr_carry, nee_ok=nee_ok,
                           pf_pending=pf_pending, prev_cos_out=prev_cos_out)


def render_lighttrace(scene, cam_params, width: int, height: int,
                      n_paths: int, seed,
                      max_bounces: int = DEFAULT_MAX_BOUNCES,
                      sample_idx=0, bidir_nu: Optional[float] = None,
                      device="cuda") -> torch.Tensor:
    """One batch of ``n_paths`` light paths -> the ``[height, width, 3]``
    image estimate on ``device`` (average batches with distinct
    ``sample_idx`` for more samples). ``bidir_nu`` MIS-weights every splat
    against the eye-path techniques (``render/bidir.py``; pass
    ``n_paths / spp``). Paths are traced in blocks of at most
    ``integrator.WAVE_RAYS``; autograd reaches the scene's fields."""
    if not scene.num_area_lights:
        raise ValueError("light tracing needs at least one area light")
    scene, _ = _on_device(scene, None, device)
    dev = scene.background.device
    cam = camera_tensors(cam_params, dev)
    img = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    for p0 in range(0, n_paths, WAVE_RAYS):
        path_idx = torch.arange(p0, min(p0 + WAVE_RAYS, n_paths),
                                dtype=torch.int64, device=dev)
        img = img + lighttrace_block(scene, cam, width, height, path_idx, seed,
                                     max_bounces=max_bounces,
                                     sample_idx=sample_idx, bidir_nu=bidir_nu)
    return (img / n_paths).reshape(height, width, 3)
