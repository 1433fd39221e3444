"""Light tracing in ONE kernel launch: paths start on the area lights, walk
into the scene, and every vertex connects to the pinhole camera — wrapper,
plain PyTorch version, and the image entry point.

The CUDA kernel (``csrc/lightkernel.cu``, device math in
``csrc/lightkernel.cuh``) replaces the TPU kernel
``cuda_path_tracer_ss_tpu/ops/pallas/lightkernel.py::_make_light_kernel``,
with and without the bidirectional MIS weights (``bidir_nu``), and the
scatter-add the TPU kernel leaves to XLA. It has two sinks for the splats
its gates pass, each an instantiation of the same per-path arithmetic:

- the IMAGE sink (``light_image_cuda``, the render path): every splat is
  added into the unnormalised image ``[width * height, 3]`` with float
  atomics; no records, no ``index_add_``;
- the RECORD sink (``light_records_cuda``): one splat record per path vertex
  — planes ``pix`` (int32) and ``r, g, b`` (float32) of ``[max_bounces + 1,
  n_local]``, slot 0 the emitter surface, slot ``b + 1`` the camera
  connection of bounce ``b``, zeros where a gate fails or the path has ended
  — the contract the plain version keeps, so that the kernel can be held
  against it record by record.

What bounds it on an H100: FP32 arithmetic throughput. A path tests every
primitive twice per bounce (nearest hit, visibility of the eye), while a
launch of the image sink reads a few KB of tables and adds into 12 bytes per
pixel. What the design does about it: one thread per light path runs a plain
bounce loop on scalar registers, loads its light and its material by index,
skips the visibility sweep of a vertex that is off screen or faces away, and
leaves the loop when its path dies; about one splat per path passes its
gates, spread over the image, so the image sink's atomics barely meet.
Per-lane regeneration (a persistent grid whose lanes open their next path as
soon as one ends) doubles the bounce loop's lane efficiency but was measured
slower and is not used (``csrc/lightkernel.cu``). ``n_paths``,
``max_bounces``, the sample index and the path offset are runtime arguments:
one build serves every batch.

RNG: the counter streams of ``utils/rng.py`` keyed on (seed, GLOBAL path
index, sample_idx); the kernel, the plain version and the eye paths' scatter
cascade (``megakernel._scatter_sample``) are shared, so kernel and plain
version agree record by record up to float op-order noise, whatever the
schedule.

Device rule: the records and the image are made on the device the packed
tables live on. On a CUDA device the kernel is launched or the call raises;
the plain version (records, summed by ``splat_records``) runs only for tables
on the CPU, or when called by name. ``render_lighttrace_fast_sharded`` splits
the paths over the ranks of a mesh (``parallel.mesh``): one launch per rank,
one psum of the images.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ...constants import (DEFAULT_MAX_BOUNCES, INV_PI, MIS_RATIO_CLAMP,
                          RAY_BUMP_EPSILON)
from ...parallel.mesh import PATH_AXIS, axis_index, axis_size, check_device, psum
from ...utils import rng
from . import megakernel as mk
from .megakernel import (AL_COLS, CAM_FLOATS, M_COLS, PackedScene,
                         _al_light_geom, _al_sample_point, _cam_table,
                         _cam_tensor, _camera_j_img, _chain_model_taken,
                         _check_tables, _dot, _make_sweep_fns, _normalize3,
                         _rotate_y_to, _scatter_sample)

# Launches of the CUDA kernel made by this module's wrappers (and nowhere
# else), in all and per instantiation <SPLAT, BIDIR>: [records, plain
# weights; records, bidirectional weights; image, plain weights; image,
# bidirectional weights].
LAUNCH_COUNT = 0
LAUNCHES_BY_VARIANT = [0, 0, 0, 0]
# Calls of splat_records (one index_add_ each; no kernel of this package).
SPLAT_CALLS = 0

_TWO_PI = 2.0 * math.pi

Records = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check_light_args(packed, width, height, n_paths, max_bounces,
                      path_offset, n_local, sample_idx, seed, bidir_nu):
    if not isinstance(packed, PackedScene):
        raise TypeError("packed must be a PackedScene (see pack_scene)")
    if packed.counts[4] == 0:
        raise ValueError("light tracing needs at least one area light")
    if packed.tex_counts[0]:
        raise ValueError("textured light tracing is not on this kernel "
                         "(the light kernel has no texture block)")
    for name, v in (("width", width), ("height", height),
                    ("n_paths", n_paths), ("n_local", n_local)):
        if int(v) != v or v < 1:
            raise ValueError(f"{name} must be a positive integer, got {v!r}")
    if int(max_bounces) != max_bounces or max_bounces < 0:
        raise ValueError(f"max_bounces must be >= 0, got {max_bounces!r}")
    for name, v in (("path_offset", path_offset), ("sample_idx", sample_idx)):
        if int(v) != v or not 0 <= v < 2 ** 31:
            raise ValueError(f"{name} must be in [0, 2**31), got {v!r}")
    if width * height >= 2 ** 31 or path_offset + n_local >= 2 ** 31:
        raise ValueError("pixel and path indices must fit int32")
    if not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed must fit int32, got {seed!r}")
    if bidir_nu is not None and not float(bidir_nu) > 0.0:
        raise ValueError(f"bidir_nu must be positive, got {bidir_nu!r}")


# ---------------------------------------------------------------------------
# Plain PyTorch version: vectorised over paths with masks, a Python loop over
# bounces. Same counters, formulas and guards as the kernel.
# ---------------------------------------------------------------------------

def _splat_weights(camf, width: int, height: int, px, py, pz):
    """The pinhole connection of points p: (pixel index, on screen and in
    front — decided BEFORE the index is clipped —, unit direction eye -> p,
    squared distance, distance, camera importance dA_img/dOmega)."""
    tox, toy, toz = px - camf[9], py - camf[10], pz - camf[11]
    r2 = torch.clamp_min(tox * tox + toy * toy + toz * toz, 1e-12)
    r = torch.sqrt(r2)
    inv_r = 1.0 / r
    ex, ey, ez = tox * inv_r, toy * inv_r, toz * inv_r
    vx = camf[0] * ex + camf[3] * ey + camf[6] * ez
    vy = camf[1] * ex + camf[4] * ey + camf[7] * ez
    vz = camf[2] * ex + camf[5] * ey + camf[8] * ez
    s = -2.0 * camf[12]
    aspect = height / width
    safe_vz = torch.where(torch.abs(vz) < 1e-12, 1e-12, vz)
    px_img = (vx / (safe_vz * s) + 0.5) * width
    py_img = (vy / (safe_vz * s * aspect) + 0.5) * height
    front = vz * torch.sign(camf[13]) > 1e-7
    on = (front & (px_img >= 0) & (px_img < width)
          & (py_img >= 0) & (py_img < height))
    ix = torch.clamp(torch.floor(px_img), 0, width - 1).to(torch.int32)
    iy = torch.clamp(torch.floor(py_img), 0, height - 1).to(torch.int32)
    pixel = iy * width + ix
    j_img = _camera_j_img(camf[12], width, height, torch.abs(vz))
    return pixel, on, (ex, ey, ez), r2, r, j_img


@torch.no_grad()
def _light_records_plain(packed: PackedScene, cam: torch.Tensor, seed: int,
                         width: int, height: int, n_paths: int,
                         max_bounces: int, path_offset: int, n_local: int,
                         sample_idx: int, bidir_nu: Optional[float],
                         stats: Optional[dict]):
    """The records of one chunk of paths, and each path's bounces (the
    kernel's loop iterations on it)."""
    device = packed.device
    num_als = packed.counts[4]
    L = num_als
    eps = RAY_BUMP_EPSILON
    bidir = bidir_nu is not None
    camf = cam.unbind()
    intersect_sweep, occlusion_sweep = _make_sweep_fns(packed)
    mats = packed.materials

    path = (path_offset
            + torch.arange(n_local, dtype=torch.int64, device=device))
    in_range = path < n_paths
    zero = torch.zeros(n_local, dtype=torch.float32, device=device)
    if bidir:
        nu = torch.tensor(bidir_nu, dtype=torch.float32, device=device)

    pix = torch.zeros((max_bounces + 1, n_local), dtype=torch.int32,
                      device=device)
    cr, cg, cb = (torch.zeros((max_bounces + 1, n_local),
                              dtype=torch.float32, device=device)
                  for _ in range(3))

    def pair(p):
        return rng.uniform_pair(seed, path, sample_idx, p)

    def visible_to_eye(px_, py_, pz_, ex, ey, ez, dist, needed):
        occ = occlusion_sweep(px_ + ex * eps, py_ + ey * eps, pz_ + ez * eps,
                              ex, ey, ez, dist - 2.0 * eps)
        if stats is not None:
            for key, mask in (("vis_rays", needed),
                              ("vis_rays_occluded", needed & occ)):
                stats[key] = stats.get(key, 0) + int(mask.sum())
        return ~occ

    def put(slot, ok, pixel, red, green, blue):
        pix[slot] = torch.where(ok, pixel, 0)
        cr[slot] = torch.where(ok, red, 0.0)
        cg[slot] = torch.where(ok, green, 0.0)
        cb[slot] = torch.where(ok, blue, 0.0)
        if stats is not None:
            stats["splats"] = stats.get("splats", 0) + int(ok.sum())

    # ---- emission vertex: pairs 1, 2, 3 ----------------------------------
    u0, u1 = pair(1)
    u2, _ = pair(2)
    u3, _ = pair(3)
    li = torch.clamp_max((u0 * L).to(torch.int32), L - 1)
    al = packed.area_lights[li.long()]               # the picked light's row
    geom = _al_light_geom([al[:, k] for k in range(AL_COLS)])
    (ptx, pty, ptz), (nlx, nly, nlz) = _al_sample_point(geom, u1, u2, u3)
    area = geom["total"]
    le = mats[al[:, 22].long()]
    t_emit_r = le[:, 9] * (float(L) * area)
    t_emit_g = le[:, 10] * (float(L) * area)
    t_emit_b = le[:, 11] * (float(L) * area)

    # ---- record 0: the emitter surface as the eye sees it -----------------
    pix0, on0, (ex0, ey0, ez0), r2_0, r_0, j0 = _splat_weights(
        camf, width, height, ptx, pty, ptz)
    vis0 = visible_to_eye(ptx, pty, ptz, -ex0, -ey0, -ez0, r_0,
                          on0 & in_range)
    cos_c0 = torch.abs(_dot(nlx, nly, nlz, ex0, ey0, ez0))
    w_splat = 1.0
    if bidir:
        c_a0 = j0 * cos_c0 / r2_0
        ratio = torch.clamp_max(c_a0 * (float(L) * area) / nu,
                                MIS_RATIO_CLAMP)
        w_splat = 1.0 / (1.0 + ratio * ratio)
    ok0 = on0 & vis0 & in_range
    s0 = w_splat * cos_c0 / r2_0 * j0
    put(0, ok0, pix0, t_emit_r * s0, t_emit_g * s0, t_emit_b * s0)

    # ---- leave the light: cosine hemisphere, two-sided --------------------
    side = torch.where(u0 * L - li.to(torch.float32) < 0.5, 1.0, -1.0)
    nex, ney, nez = nlx * side, nly * side, nlz * side
    d1a, d1b = pair(rng.pair_base(1, L))
    theta = d1a * _TWO_PI
    yy = torch.sqrt(d1b)
    rr = torch.sqrt(torch.clamp_min(1.0 - yy * yy, 0.0))
    dx, dy, dz = _rotate_y_to(nex, ney, nez, rr * torch.cos(theta), yy,
                              rr * torch.sin(theta))
    beta_r = t_emit_r * _TWO_PI
    beta_g = t_emit_g * _TWO_PI
    beta_b = t_emit_b * _TWO_PI
    ox = ptx + nex * eps
    oy = pty + ney * eps
    oz = ptz + nez * eps
    active = in_range
    length = torch.zeros(n_local, dtype=torch.int64, device=device)

    # bidirectional carries (render/bidir.py's U / r0 / pr recurrences)
    cos0 = torch.abs(_dot(nex, ney, nez, dx, dy, dz))
    inv_pl_a = float(L) * area
    U = zero
    r0c = zero
    pr_carry = torch.ones_like(zero)
    nee_ok = torch.ones_like(zero)
    pf_pending = 0.5 * cos0 * INV_PI
    prev_cos_out = cos0

    for b in range(max_bounces):
        if not bool(active.any()):
            break                       # the remaining records stay zero
        length += active
        if stats is not None:
            stats["path_bounces"] = (stats.get("path_bounces", 0)
                                     + int(active.sum()))
        best_t, nx, ny, nz, mat = intersect_sweep(ox, oy, oz, dx, dy, dz)
        hit = best_t < math.inf
        t_safe = torch.where(hit, best_t, 0.0)
        px = ox + dx * t_safe
        py = oy + dy * t_safe
        pz = oz + dz * t_safe
        mrow = mats[mat]
        mf = tuple(mrow[:, f] for f in range(M_COLS))
        act = active & hit

        # Beer-Lambert over the segment inside a medium
        cos_i = -_dot(dx, dy, dz, nx, ny, nz)
        beer_on = act & (cos_i <= 0.0)
        beta_r = torch.where(beer_on, beta_r * torch.exp(-t_safe * mf[6]),
                             beta_r)
        beta_g = torch.where(beer_on, beta_g * torch.exp(-t_safe * mf[7]),
                             beta_g)
        beta_b = torch.where(beer_on, beta_b * torch.exp(-t_safe * mf[8]),
                             beta_b)

        # ---- camera connection (diffuse lobe, front faces only) -----------
        pixb, onb, (ecx, ecy, ecz), r2b, rb, jb = _splat_weights(
            camf, width, height, px, py, pz)
        nux, nuy, nuz = _normalize3(nx, ny, nz, 1e-20)
        cos_c = torch.clamp_min(-_dot(nux, nuy, nuz, ecx, ecy, ecz), 0.0)
        front = (cos_c > 0.0) & (cos_i > 0.0)
        visb = visible_to_eye(px, py, pz, -ecx, -ecy, -ecz, rb,
                              onb & front & act)
        f_scale = mf[14] * INV_PI
        w_conn = 1.0
        first = b == 0
        t_w = torch.where(hit, best_t, 1.0)
        t2 = torch.clamp_min(t_w * t_w, 1e-12)
        if bidir:
            cos_arr = torch.abs(_dot(dx, dy, dz, nux, nuy, nuz))
            pf_full = torch.clamp_min(pf_pending * cos_arr / t2, 1e-20)
            U = torch.clamp_max(
                inv_pl_a / pf_full if first else U * pr_carry / pf_full,
                MIS_RATIO_CLAMP)
            c_a = jb * cos_c / r2b
            prd_sa = (mf[14] * torch.clamp_min(
                -_dot(dx, dy, dz, nux, nuy, nuz), 0.0) * INV_PI)
            geo_prev = prev_cos_out / t2
            prd_eff = 1.0 if first else prd_sa * geo_prev
            p_nee_a = float(L) / torch.clamp_min(inv_pl_a, 1e-20)
            rho_n = (1.0 if first else nee_ok) * c_a * p_nee_a * prd_eff * U
            r0_eff = prd_sa * geo_prev if first else r0c
            rho_b = c_a * prd_eff * U * r0_eff
            rn = torch.clamp_max(rho_n / nu, MIS_RATIO_CLAMP)
            rb_ = torch.clamp_max(rho_b / nu, MIS_RATIO_CLAMP)
            w_conn = 1.0 / (1.0 + rn * rn + rb_ * rb_)
        okb = onb & visb & act & front
        sb_ = w_conn * cos_c / r2b * jb
        put(b + 1, okb, pixb, beta_r * mf[0] * f_scale * sb_,
            beta_g * mf[1] * f_scale * sb_, beta_b * mf[2] * f_scale * sb_)

        # ---- continue the path: the eye paths' scatter cascade ------------
        base = rng.pair_base(b + 2, L)
        u_branch, u_a = pair(base)
        u_b, _un = pair(base + 1)
        (n_ox, n_oy, n_oz, n_dx, n_dy, n_dz, wr, wg, wb, alive, take_diff,
         take_spec, take_refr, _tir, ct_m, _cw) = _scatter_sample(
             dx, dy, dz, nx, ny, nz, px, py, pz, cos_i, u_branch, u_a, u_b,
             mf)
        if bidir:
            pf_new = _chain_model_taken(
                dx, dy, dz, nx, ny, nz, cos_i, n_dx, n_dy, n_dz, mf,
                take_diff, take_spec, take_refr, ct_m)
            cos_rev = _dot(n_dx, n_dy, n_dz, nx, ny, nz)
            pr_sa = _chain_model_taken(
                -n_dx, -n_dy, -n_dz, nx, ny, nz, cos_rev, -dx, -dy, -dz, mf,
                take_diff, take_spec, take_refr, ct_m)
            pr_full = pr_sa * prev_cos_out / t2
            if first:
                r0c = pr_full
                pr_carry = torch.ones_like(pr_full)
                nee_ok = (_dot(n_dx, n_dy, n_dz, nux, nuy, nuz)
                          > 0.0).to(torch.float32)
            else:
                pr_carry = pr_full
            pf_pending = torch.where(act, pf_new, pf_pending)
            prev_cos_out = torch.where(
                act, torch.abs(_dot(n_dx, n_dy, n_dz, nux, nuy, nuz)),
                prev_cos_out)
        ox, oy, oz = n_ox, n_oy, n_oz
        dx, dy, dz = n_dx, n_dy, n_dz
        beta_r = beta_r * wr
        beta_g = beta_g * wg
        beta_b = beta_b * wb
        active = act & alive

    if stats is not None:
        stats["paths"] = stats.get("paths", 0) + int(in_range.sum())
    return (pix, cr, cg, cb), length


def _warp_iterations(length: torch.Tensor, n_lanes: int) -> int:
    """The bounce loop's iterations 32-lane warps issue over paths of
    ``length`` bounces (local order) when ``n_lanes`` lanes trace them
    regenerating: lane ``l`` takes paths ``l, l + n_lanes, ...`` and iterates
    once per bounce of each; a warp iterates as long as its busiest lane.
    With ``n_lanes`` >= the path count, one path per lane: the kernel's
    schedule."""
    n_lanes = max(1, min(int(n_lanes), length.numel()))
    lanes = torch.arange(length.numel(), device=length.device) % n_lanes
    per_lane = torch.zeros(-(-n_lanes // 32) * 32, dtype=torch.int64,
                           device=length.device).index_add_(0, lanes, length)
    return int(per_lane.reshape(-1, 32).amax(1).sum())


def light_records_plain(packed: PackedScene, cam_params, seed: int,
                        width: int, height: int, n_paths: int,
                        max_bounces: int = DEFAULT_MAX_BOUNCES,
                        path_offset: int = 0, n_local: Optional[int] = None,
                        sample_idx: int = 0,
                        bidir_nu: Optional[float] = None,
                        stats: Optional[dict] = None,
                        n_lanes: Optional[int] = None) -> Records:
    """The plain PyTorch version of the light kernel: records ``(pix, r, g,
    b)`` of ``[max_bounces + 1, n_local]`` for the paths with global indices
    ``[path_offset, path_offset + n_local)`` of a batch of ``n_paths``, on
    the tables' device. ``stats``, when a dict, receives ``paths``,
    ``path_bounces`` (sweeps for the nearest hit), ``vis_rays`` (visibility
    sweeps whose result can change a record), ``vis_rays_occluded`` and
    ``splats`` (non-empty records) — the operation count behind the kernel's
    bound — and ``warp_iterations_nested`` / ``warp_iterations``: the bounce
    loop's iterations the kernel's warps of 32 paths issue (one path per
    lane), and those a schedule that regenerates paths over ``n_lanes``
    lanes would issue (default: one lane per path). ``path_bounces`` over 32
    times either is that schedule's lane efficiency."""
    if n_local is None:
        n_local = n_paths - path_offset
    _check_light_args(packed, width, height, n_paths, max_bounces,
                      path_offset, n_local, sample_idx, seed, bidir_nu)
    cam = _cam_tensor(cam_params, packed.device)
    prims = max(packed.counts[0] + packed.counts[1], 1)
    chunk = max(1, mk._PLAIN_CHUNK_ENTRIES // prims)
    parts, lengths = zip(*(
        _light_records_plain(packed, cam, int(seed), width, height, n_paths,
                             max_bounces, path_offset + start,
                             min(chunk, n_local - start), int(sample_idx),
                             bidir_nu, stats)
        for start in range(0, n_local, chunk)))
    if stats is not None:
        length = torch.cat(lengths)
        for key, lanes in (("warp_iterations", n_lanes or n_local),
                           ("warp_iterations_nested", n_local)):
            stats[key] = stats.get(key, 0) + _warp_iterations(length, lanes)
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(planes, 1) for planes in zip(*parts))


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _kernel_fn():
    """The built kernel library — built at first use by utils/build.py —
    with its functions' C types declared."""
    from ...utils.build import load_kernels

    lib = load_kernels("lightkernel")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    head = [vp, ci, vp, ci, vp, ci, vp, ci, vp, ci,              # tables
            ctypes.POINTER(ctypes.c_float),                      # camera
            ci, ci, ci, ci, ci, ci, ci, ci, ci]                  # scalars
    lib.cpt_light_records.argtypes = head + [vp, vp, vp, vp, vp]  # out, stream
    lib.cpt_light_image.argtypes = head + [vp, vp]                # image, stream
    lib.cpt_light_records.restype = lib.cpt_light_image.restype = ci
    lib.cpt_light_occupancy.argtypes = [ci, ci] + [ctypes.POINTER(ci)] * 4
    lib.cpt_light_occupancy.restype = ci
    lib.cpt_light_error_string.argtypes = [ci]
    lib.cpt_light_error_string.restype = ctypes.c_char_p
    return lib


def _launch(splat: bool, packed: PackedScene, cam_params, seed: int,
            width: int, height: int, n_paths: int, max_bounces: int,
            path_offset: int, n_local: Optional[int], sample_idx: int,
            bidir_nu: Optional[float]):
    """Launch instantiation <SPLAT = splat, BIDIR = bidir_nu given> on the
    current stream of the tables' device, into outputs zeroed here; returns
    the image ``[width * height, 3]`` or the records."""
    global LAUNCH_COUNT
    if n_local is None:
        n_local = n_paths - path_offset
    _check_light_args(packed, width, height, n_paths, max_bounces,
                      path_offset, n_local, sample_idx, seed, bidir_nu)
    _check_tables(packed)
    lib = _kernel_fn()
    cam = _cam_table(cam_params, 0.0, bidir_nu)
    cam_c = (ctypes.c_float * CAM_FLOATS)(*cam.tolist())
    args = []
    for table, count in zip(packed.tables()[:5], packed.counts):
        args += [table.data_ptr(), count]
    args += [cam_c, int(seed), int(path_offset), int(n_local),
             int(sample_idx), int(n_paths), int(max_bounces), int(width),
             int(height), int(bidir_nu is not None)]
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        if splat:
            out = torch.zeros((width * height, 3), dtype=torch.float32,
                              device=packed.device)
            err = lib.cpt_light_image(*args, out.data_ptr(), stream)
        else:
            shape = (max_bounces + 1, n_local)
            out = (torch.zeros(shape, dtype=torch.int32, device=packed.device),
                   *(torch.zeros(shape, dtype=torch.float32,
                                 device=packed.device) for _ in range(3)))
            err = lib.cpt_light_records(*args, *(t.data_ptr() for t in out),
                                        stream)
    if err != 0:
        raise RuntimeError("light kernel launch failed: CUDA error "
                           f"{err} ({lib.cpt_light_error_string(err).decode()})")
    LAUNCH_COUNT += 1
    LAUNCHES_BY_VARIANT[2 * int(splat) + int(bidir_nu is not None)] += 1
    return out


def light_records_cuda(packed: PackedScene, cam_params, seed: int,
                       width: int, height: int, n_paths: int,
                       max_bounces: int = DEFAULT_MAX_BOUNCES,
                       path_offset: int = 0, n_local: Optional[int] = None,
                       sample_idx: int = 0,
                       bidir_nu: Optional[float] = None) -> Records:
    """Launch the CUDA light kernel with its record sink: records ``(pix, r,
    g, b)`` of ``[max_bounces + 1, n_local]``. Launches on the current stream
    of the tables' device and does not synchronise; raises if the kernel
    does not build or the launch is refused."""
    return _launch(False, packed, cam_params, seed, width, height, n_paths,
                   max_bounces, path_offset, n_local, sample_idx, bidir_nu)


def light_image_cuda(packed: PackedScene, cam_params, seed: int, width: int,
                     height: int, n_paths: int,
                     max_bounces: int = DEFAULT_MAX_BOUNCES,
                     path_offset: int = 0, n_local: Optional[int] = None,
                     sample_idx: int = 0,
                     bidir_nu: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA light kernel with its image sink: the UNNORMALISED
    image ``[width * height, 3]`` the paths splat into — the sum of their
    records, added with atomics (two calls agree to rounding, not to the
    bit). Launches on the current stream of the tables' device and does not
    synchronise; raises if the kernel does not build or the launch is
    refused."""
    return _launch(True, packed, cam_params, seed, width, height, n_paths,
                   max_bounces, path_offset, n_local, sample_idx, bidir_nu)


def light_occupancy(bidir: bool = False, splat: bool = True) -> dict:
    """What a launch of instantiation <SPLAT = splat, BIDIR = bidir> gets on
    the current CUDA device: ``registers`` per thread, ``blocks_per_sm``
    (resident blocks of ``threads_per_block``), ``sms``, and
    ``resident_lanes``, the threads the card holds at once."""
    lib = _kernel_fn()
    regs, blocks, sms, threads = (ctypes.c_int(0) for _ in range(4))
    err = lib.cpt_light_occupancy(int(bidir), int(splat), ctypes.byref(regs),
                                  ctypes.byref(blocks), ctypes.byref(sms),
                                  ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err} "
                           f"({lib.cpt_light_error_string(err).decode()})")
    return {"registers": regs.value, "blocks_per_sm": blocks.value,
            "sms": sms.value, "threads_per_block": threads.value,
            "resident_lanes": blocks.value * sms.value * threads.value}


def light_records(packed: PackedScene, cam_params, seed: int, width: int,
                  height: int, n_paths: int,
                  max_bounces: int = DEFAULT_MAX_BOUNCES,
                  path_offset: int = 0, n_local: Optional[int] = None,
                  sample_idx: int = 0,
                  bidir_nu: Optional[float] = None) -> Records:
    """Splat records of a block of light paths. CUDA tables go to the
    kernel's record sink; CPU tables to the plain version."""
    fn = (light_records_cuda if packed.device.type == "cuda"
          else light_records_plain)
    return fn(packed, cam_params, seed, width, height, n_paths, max_bounces,
              path_offset, n_local, sample_idx, bidir_nu)


def splat_records(records: Records, width: int, height: int) -> torch.Tensor:
    """Sum splat records into an UNNORMALISED image ``[width * height, 3]``
    with one ``index_add_`` (empty records add zero to pixel 0). On a CUDA
    device the sum runs on atomics: two calls agree to rounding, not to the
    bit."""
    global SPLAT_CALLS
    pix, r, g, b = records
    SPLAT_CALLS += 1
    rgb = torch.stack([r.reshape(-1), g.reshape(-1), b.reshape(-1)], -1)
    img = torch.zeros((width * height, 3), dtype=torch.float32,
                      device=pix.device)
    return img.index_add_(0, pix.reshape(-1), rgb)


def light_image(packed: PackedScene, cam_params, seed: int, width: int,
                height: int, n_paths: int,
                max_bounces: int = DEFAULT_MAX_BOUNCES,
                path_offset: int = 0, n_local: Optional[int] = None,
                sample_idx: int = 0,
                bidir_nu: Optional[float] = None) -> torch.Tensor:
    """The UNNORMALISED image ``[width * height, 3]`` a block of light paths
    splats. CUDA tables go to the kernel's image sink (one launch, nothing
    else); CPU tables to the plain version's records, summed by
    ``splat_records``."""
    args = (packed, cam_params, seed, width, height, n_paths, max_bounces,
            path_offset, n_local, sample_idx, bidir_nu)
    if packed.device.type == "cuda":
        return light_image_cuda(*args)
    return splat_records(light_records_plain(*args), width, height)


def render_lighttrace_fast(packed: PackedScene, cam_params, seed: int,
                           width: int, height: int, n_paths: int,
                           max_bounces: int = DEFAULT_MAX_BOUNCES,
                           sample_idx: int = 0,
                           bidir_nu: Optional[float] = None) -> torch.Tensor:
    """One batch of ``n_paths`` light paths -> ``[height, width, 3]`` image
    estimate (divided by ``n_paths``; average over batches with distinct
    ``sample_idx`` for more samples), on the packed tables' device.
    ``bidir_nu`` weights every splat against the eye side's techniques
    (render/bidir.py): pass ``n_paths / spp`` of the eye half."""
    img = light_image(packed, cam_params, seed, width, height, n_paths,
                      max_bounces, 0, n_paths, sample_idx, bidir_nu)
    return (img / n_paths).reshape(height, width, 3)


def render_lighttrace_fast_sharded(packed: PackedScene, cam_params, seed: int,
                                   width: int, height: int, n_paths: int, mesh,
                                   max_bounces: int = DEFAULT_MAX_BOUNCES,
                                   sample_idx: int = 0,
                                   bidir_nu: Optional[float] = None
                                   ) -> torch.Tensor:
    """``render_lighttrace_fast`` over ``mesh``'s path axis
    (``parallel.mesh``): each rank splats a block of ``n_paths / ranks``
    GLOBAL path indices into its own full-size image (``light_image``: one
    launch of the kernel's image sink on a card), one psum over the path
    axis merges them, then the division by ``n_paths``. Streams key on the
    global path index, so only the order of the float splat sums differs
    from a single device. The tables must be on the mesh's device type."""
    if packed.counts[4] == 0:
        raise ValueError("light tracing needs at least one area light")
    if packed.tex_counts[0]:
        raise ValueError("textured light tracing is not on this kernel "
                         "(the light kernel has no texture block)")
    n_dev = axis_size(mesh, PATH_AXIS, "render_lighttrace_fast_sharded")
    check_device(mesh, packed.device, "render_lighttrace_fast_sharded")
    if n_paths % n_dev:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_dev} devices")
    per = n_paths // n_dev
    img = light_image(packed, cam_params, seed, width, height, n_paths,
                      max_bounces, axis_index(mesh, PATH_AXIS) * per, per,
                      sample_idx, bidir_nu)
    return (psum(img, mesh, PATH_AXIS) / n_paths).reshape(height, width, 3)
