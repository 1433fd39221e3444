"""Whole-render megakernel: eye rays + all samples + all bounces of a pixel
in ONE kernel launch — wrapper, scene packing, and the plain PyTorch version.

The CUDA kernel (``csrc/megakernel.cu``, device math in
``csrc/megakernel.cuh``) replaces the TPU kernel
``cuda_path_tracer_ss_tpu/ops/pallas/megakernel.py::_make_render_kernel`` in
three variants, each an instantiation of the one kernel source: the default
(reference-parity estimator), ``physical=True`` (the unbiased estimator:
uniform-area light sampling with power-heuristic MIS) and ``physical=True,
bidir_nu=nu`` (the same with the carries of the bidirectional weights, the
eye half of ``render/bidir.py``). Each comes in an untextured and a textured
build (``_texture_block`` of the TPU kernel: color-map albedo and normal-map
perturbation at every hit, before the cosine, NEE and the scatter), and each
with linear sweeps or with the supercell grid's (``packed_grid``: ``pack_grid``
of ``ops/grid.py::build_grid``), and each with float32 carries or, under
``state_bf16``, radiance and throughput carries stored as bfloat16 between
bounces (an instantiation of its own, so the float32 ones carry no rounding).

What bounds it on an H100: FP32 arithmetic throughput. A launch reads a few
KB of scene tables and writes ``12 * width * height`` bytes (7.7 MB at
800x800), while every path-bounce tests every primitive once for the nearest
hit and once more per light for the shadow ray. What the design does about
it: one thread per pixel runs plain ``for sample { for bounce }`` loops on
scalar registers and branches on its own path — a miss, an inside hit, a
light facing away or a non-diffuse surface skips its shadow sweeps, an
occluded shadow ray stops at the first occluder, and only the scatter branch
that was drawn is evaluated. The tables are read through read-only global
memory, whatever their size (a small scene's stay in L1). With the grid a
thread tests the few wide primitives, then gates each supercell box on its
OWN ray (one slab test against its best t so far) and tests only the lists of
the boxes it reaches — no block vote: rays that go different ways diverge
instead of dragging each other through every box. ``spp``, ``max_bounces``,
the seed, the offsets, the clamp, the primitive counts and the grid are
runtime arguments: one build serves every scene and sampling configuration.

RNG: counter-based Threefry-2x32 on (seed, pixel, sample, pair) — see
``utils/rng.py``; the kernel and the plain version draw the same streams, so
they agree per pixel up to float op-order noise.

Device rule: ``render_megakernel`` renders on the device its packed tables
live on. On a CUDA device it launches the kernel or raises; the plain
version runs only for tables on the CPU, or when called by name.
``render_megakernel_sharded`` splits the pixels over the ranks of a mesh
(``parallel.mesh``): one launch per rank on its tile, one psum of the tiles.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...constants import INV_PI, MIS_RATIO_CLAMP, RAY_BUMP_EPSILON
from ...parallel.mesh import (PIXEL_AXIS, axis_index, axis_size, check_device,
                              in_full_image, psum, tile_range)
from ...utils import rng
from ...utils.profiling import span
from ..texture import (_sphere_tangent, bilinear, perturb_normal, sphere_uv,
                       triangle_uv_tangent, wrap)

# table row widths
S_COLS = 5
T_COLS = 19
M_COLS = 20
PL_COLS = 6
AL_COLS = 23
CAM_FLOATS = 16

# Launches of the CUDA kernel made by this module's wrapper (and nowhere
# else): a run can show that it went through the kernel.
LAUNCH_COUNT = 0
# ... and the same count per estimator: [default, physical, bidir] ...
LAUNCHES_BY_VARIANT = [0, 0, 0]
# ... of which the textured instantiations (a scene with textures) ...
LAUNCHES_TEXTURED = [0, 0, 0]
# ... the grid instantiations ...
LAUNCHES_GRID = [0, 0, 0]
# ... and the launches with bfloat16 carries
LAUNCHES_BF16 = [0, 0, 0]

_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Kernel-side scene tables, float32, contiguous, all on one device.
    Empty tables are padded to one zero row that is never read; ``counts``
    = (S, T, M, Lp, La) holds the true row counts.

    spheres [S,5] = cx cy cz r mat; triangles [T,19] = v0 e1 e2 n0 n1 n2 mat
    (e1 = v1-v0, e2 = v2-v0 precomputed; per-corner normals are
    barycentrically interpolated exactly as Primitives.h:71-73);
    materials [M,20] = diff spec absorb emit specExp ior diffAvg specAvg
    refrAvg rough pureRefl ct; point_lights [Lp,6] = pos power;
    area_lights [La,23] = two triangles' vertices + power + owning-triangle
    index + light material index; background [3].

    A textured scene adds its texture bundle (``None`` without textures):
    ``tex_atlas [texels, 3]`` every texture's true h x w texels, row-major
    from the top row, one texture after the other; ``tex_meta [K, 3]`` =
    (first texel, h, w); ``tex_triuv [T, 6]`` the corner UVs; ``tex_matids
    [M, 2]`` = (color map, normal map) per material, -1 = none.
    ``tex_counts`` = (K, texels); ``tex_nmap``: some material has a normal
    map.
    """

    spheres: torch.Tensor
    triangles: torch.Tensor
    materials: torch.Tensor
    point_lights: torch.Tensor
    area_lights: torch.Tensor
    background: torch.Tensor
    counts: Tuple[int, int, int, int, int]
    tex_counts: Tuple[int, int] = (0, 0)
    tex_atlas: Optional[torch.Tensor] = None
    tex_meta: Optional[torch.Tensor] = None
    tex_triuv: Optional[torch.Tensor] = None
    tex_matids: Optional[torch.Tensor] = None
    tex_nmap: bool = False

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    @property
    def textured(self) -> bool:
        return self.tex_counts[0] > 0

    def tables(self):
        return (self.spheres, self.triangles, self.materials,
                self.point_lights, self.area_lights, self.background)

    def tex_tables(self):
        """(atlas, meta, triuv, matids); all None without textures."""
        return (self.tex_atlas, self.tex_meta, self.tex_triuv,
                self.tex_matids)

    @property
    def table_bytes(self) -> int:
        return 4 * sum(t.numel() for t in self.tables() + self.tex_tables()
                       if t is not None)


def pack_scene(scene, device="cuda") -> PackedScene:
    """Flatten the scene into the kernel's tables on ``device``. Built from
    ``torch.cat`` and indexing alone: a scene field that requires grad keeps
    its graph (a texel cotangent flows back into ``scene.textures``; padding
    texels get 0)."""
    device = torch.device(device)
    f32 = torch.float32

    spheres = torch.cat([
        scene.sph_center, scene.sph_radius[:, None],
        scene.sph_mat[:, None].to(f32)], -1)
    tris = torch.cat([
        scene.tri_v0, scene.tri_v1 - scene.tri_v0, scene.tri_v2 - scene.tri_v0,
        scene.tri_n0, scene.tri_n1, scene.tri_n2,
        scene.tri_mat[:, None].to(f32)], -1)
    m = scene.materials
    mats = torch.cat([
        m.diffuse, m.specular, m.absorption, m.emission,
        m.spec_exp[:, None], m.ior[:, None], m.diff_avg[:, None],
        m.spec_avg[:, None], m.refr_avg[:, None], m.roughness[:, None],
        ((m.flags & 0x01) != 0).to(f32)[:, None],
        ((m.flags & 0x03) != 0).to(f32)[:, None]], -1)
    pls = torch.cat([scene.pl_pos, scene.pl_power], -1)
    t0 = scene.al_tri0.long()
    t1 = t0 + 1
    als = torch.cat([
        scene.tri_v0[t0], scene.tri_v1[t0], scene.tri_v2[t0],
        scene.tri_v0[t1], scene.tri_v1[t1], scene.tri_v2[t1],
        scene.al_power,
        t0[:, None].to(f32), scene.tri_mat[t0][:, None].to(f32)], -1)

    def put(a, cols):
        a = a.reshape(-1, cols)
        if not a.shape[0]:
            # one zero row, appended so that an empty field that requires
            # grad stays in the graph (its gradient is empty, not missing)
            a = torch.cat([a.to(f32), torch.zeros((1, cols), dtype=f32,
                                                  device=a.device)])
        return a.to(device=device, dtype=f32).contiguous()

    counts = (scene.num_spheres, scene.num_triangles, m.flags.shape[0],
              scene.num_point_lights, scene.num_area_lights)
    tex = {}
    if scene.num_textures:
        # the true sizes are scene structure, never trained: read on the host
        hw = scene.tex_hw.detach().cpu().numpy().astype(np.int64)
        flats, meta, off = [], [], 0
        for k, (h, w) in enumerate(hw):
            flats.append(scene.textures[k, :h, :w, :].reshape(h * w, 3))
            meta.append((off, h, w))
            off += int(h * w)
        tex = dict(
            tex_atlas=put(torch.cat(flats), 3),
            tex_meta=put(torch.tensor(meta, dtype=f32), 3),
            tex_triuv=put(torch.cat([scene.tri_uv0, scene.tri_uv1,
                                     scene.tri_uv2], -1), 6),
            tex_matids=put(torch.stack([m.tex_id.to(f32),
                                        m.nmap_id.to(f32)], -1), 2),
            tex_counts=(len(hw), off),
            tex_nmap=bool((m.nmap_id >= 0).any()))
    return PackedScene(put(spheres, S_COLS), put(tris, T_COLS),
                       put(mats, M_COLS), put(pls, PL_COLS),
                       put(als, AL_COLS),
                       scene.background.to(device=device, dtype=f32).contiguous(),
                       counts, **tex)


@dataclasses.dataclass(frozen=True)
class PackedGrid:
    """Kernel-side uniform grid (``ops/grid.py``), all on one device.

    ``scal`` [8] float32 = origin (3), cell size (3), 2 spare. ``idx`` int32
    is one CSR table: ``[sc_sph_start (SC+1), sc_tri_start (SC+1), supercell
    sphere ids, supercell triangle ids, global sphere ids, global triangle
    ids]``, the start tables holding absolute offsets into ``idx``. A
    supercell is a box of F^3 grid cells; its lists are the deduplicated union
    of its cells' lists. Primitives spanning more than GLOBAL_SPAN_CELLS
    cells (the Cornell walls) would land in nearly every box and are swept
    for every ray instead: the global lists. ``meta`` = (rx, ry, rz, F,
    sc_off, gs_off, n_gs, gt_off, n_gt): resolution, supercell factor, the
    start tables' offset, and the global lists' offsets and lengths. A CUDA
    thread reads the table with direct loads."""

    scal: torch.Tensor
    idx: torch.Tensor
    meta: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def supercells(self) -> Tuple[int, int, int]:
        """Supercells per axis."""
        rx, ry, rz, f = self.meta[:4]
        return ((rx + f - 1) // f, (ry + f - 1) // f, (rz + f - 1) // f)


SUPERCELL_F = 4          # grid cells per supercell axis
GLOBAL_SPAN_CELLS = 16   # primitives in more cells go to the global lists


def pack_grid(grid, device="cuda") -> PackedGrid:
    """``ops/grid.UniformGrid`` -> the kernels' CSR bundle on ``device``: the
    supercell union lists (deduplicated, global primitives removed) and the
    global lists. Bit-equal to the reference's ``pack_grid``."""
    scal = torch.cat([grid.origin.to(torch.float32),
                      grid.cell_size.to(torch.float32),
                      torch.zeros(2, dtype=torch.float32)])
    sph_list = grid.sph_list.cpu().numpy()
    tri_list = grid.tri_list.cpu().numpy()
    rx, ry, rz = grid.res
    F = SUPERCELL_F
    scx, scy, scz = (rx + F - 1) // F, (ry + F - 1) // F, (rz + F - 1) // F
    SC = scx * scy * scz

    def wide(lists):
        """Ids listed in more than GLOBAL_SPAN_CELLS cells."""
        ids = lists[lists >= 0]
        span = np.bincount(ids, minlength=max(1, int(lists.max() + 1)
                                              if lists.size else 1))
        return np.nonzero(span > GLOBAL_SPAN_CELLS)[0].astype(np.int64)

    glob_sph, glob_tri = wide(sph_list), wide(tri_list)
    gs, gt = set(glob_sph.tolist()), set(glob_tri.tolist())
    sph3 = sph_list.reshape(rz, ry, rx, -1)
    tri3 = tri_list.reshape(rz, ry, rx, -1)
    sc_sph, sc_tri = [], []
    for bz in range(scz):
        for by in range(scy):
            for bx in range(scx):
                box = (slice(bz * F, (bz + 1) * F), slice(by * F, (by + 1) * F),
                       slice(bx * F, (bx + 1) * F))
                s = np.unique(sph3[box].reshape(-1))
                t = np.unique(tri3[box].reshape(-1))
                sc_sph.append(np.asarray([i for i in s[s >= 0] if i not in gs],
                                         np.int64))
                sc_tri.append(np.asarray([i for i in t[t >= 0] if i not in gt],
                                         np.int64))
    sph_start = 2 * (SC + 1) + np.concatenate(
        [[0], np.cumsum([len(l) for l in sc_sph])])
    tri_start = sph_start[-1] + np.concatenate(
        [[0], np.cumsum([len(l) for l in sc_tri])])
    gs_off = int(tri_start[-1])
    gt_off = gs_off + len(glob_sph)
    idx = np.concatenate([sph_start, tri_start] + sc_sph + sc_tri
                         + [glob_sph, glob_tri]).astype(np.int32)
    device = torch.device(device)
    return PackedGrid(scal.to(device), torch.from_numpy(idx).to(device),
                      (rx, ry, rz, F, 0, gs_off, len(glob_sph), gt_off,
                       len(glob_tri)))


def _cam_tensor(cam_params, device) -> torch.Tensor:
    """The camera as 14 float32 values on ``device``: rotation (row-major
    9), position 3, tan(fov/2), z_near. ``cam_params`` holds numpy values or
    tensors; a tensor that carries an autograd graph keeps it."""
    f32 = torch.float32
    return torch.cat([torch.as_tensor(v, dtype=f32, device=device).reshape(-1)
                      for v in cam_params])


def _cam_table(cam_params, sample_clamp: float,
               bidir_nu: Optional[float] = None) -> np.ndarray:
    """The kernels' 16-float host camera table: the 14 values of
    ``_cam_tensor``, the per-sample clamp (<= 0 disables), and the
    bidirectional count ratio nu (0 when off)."""
    cam = np.zeros(CAM_FLOATS, np.float32)
    cam[0:14] = _cam_tensor(cam_params, "cpu").detach().numpy()
    cam[14] = np.float32(sample_clamp)
    cam[15] = np.float32(0.0 if bidir_nu is None else bidir_nu)
    return cam


def _check_variant(physical: bool, bidir_nu: Optional[float]) -> int:
    """The kernel instantiation of an estimator choice: 0 reference-parity,
    1 physical, 2 physical with the bidirectional carries."""
    if bidir_nu is None:
        return 1 if physical else 0
    if not physical:
        raise ValueError("bidir mode runs on the physical estimator")
    if not float(bidir_nu) > 0.0:
        raise ValueError(f"bidir_nu must be positive, got {bidir_nu!r}")
    return 2


# ---------------------------------------------------------------------------
# Plain PyTorch version: vectorised over pixels with masks, Python loops over
# samples and bounces. Same counters, formulas and guards as the kernel.
# Helper names and signatures follow the JAX package one for one.
# ---------------------------------------------------------------------------

def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _sqrt0(x):
    """``sqrt(max(x, 0))`` whose gradient is 0, not inf or NaN, where
    ``x <= 0``: a lane that an outer ``torch.where`` drops must not poison
    the sum of gradients."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _normalize3(x, y, z, eps=1e-20):
    inv = torch.rsqrt(torch.clamp_min(x * x + y * y + z * z, eps))
    return x * inv, y * inv, z * inv


def _rotate_y_to(tx, ty, tz, sx, sy, sz):
    """rotate +Y onto target t, applied to sample s (CudaTracer.cu:579-585)."""
    w = 1.0 + ty
    rx, ry, rz = tz, torch.zeros_like(tz), -tx
    n2 = w * w + rx * rx + rz * rz
    degen = n2 < 1e-12
    inv = torch.rsqrt(torch.where(degen, 1.0, n2))
    w, rx, rz = w * inv, rx * inv, rz * inv
    # t = r x s + w*s
    t_x = ry * sz - rz * sy + w * sx
    t_y = rz * sx - rx * sz + w * sy
    t_z = rx * sy - ry * sx + w * sz
    ox = sx + 2.0 * (ry * t_z - rz * t_y)
    oy = sy + 2.0 * (rz * t_x - rx * t_z)
    oz = sz + 2.0 * (rx * t_y - ry * t_x)
    return (torch.where(degen, sx, ox), torch.where(degen, -sy, oy),
            torch.where(degen, -sz, oz))


def _sphere_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r):
    vx, vy, vz = ox - cx, oy - cy, oz - cz
    b = 2.0 * _dot(dx, dy, dz, vx, vy, vz)
    c = vx * vx + vy * vy + vz * vz - r * r
    disc = b * b - 4.0 * c
    sq = _sqrt0(disc)
    t0 = (-b - sq) * 0.5
    t1 = (-b + sq) * 0.5
    t = torch.where(t0 < 0.0, t1, t0)
    return t, (disc >= 0.0) & (t >= 0.0)


def _triangle_t(ox, oy, oz, dx, dy, dz, v0, e1, e2):
    """Moller-Trumbore with precomputed edges e1 = v1-v0, e2 = v2-v0."""
    qx = dy * e2[2] - dz * e2[1]
    qy = dz * e2[0] - dx * e2[2]
    qz = dx * e2[1] - dy * e2[0]
    det = e1[0] * qx + e1[1] * qy + e1[2] * qz
    degen = torch.abs(det) <= 1e-7
    inv = 1.0 / torch.where(degen, 1.0, det)
    sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
    rx = sy * e1[2] - sz * e1[1]
    ry = sz * e1[0] - sx * e1[2]
    rz = sx * e1[1] - sy * e1[0]
    t = (e2[0] * rx + e2[1] * ry + e2[2] * rz) * inv
    w1 = (sx * qx + sy * qy + sz * qz) * inv
    w2 = (dx * rx + dy * ry + dz * rz) * inv
    w0 = 1.0 - w1 - w2
    valid = (~degen) & (t > 0.0) & (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    return t, w1, w2, valid


def _scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz, cos_i,
                    u_branch, u_a, u_b, m):
    """The branch-cascade scatter step (CudaTracer.cu:208-318).

    ``m`` is the 20-tuple of per-pixel material columns in pack_scene
    order. Returns (new origin, new direction, weight, alive, branch masks
    take_diff/take_spec/take_refr, tir, ct mask, ct_w)."""
    (m_dr, m_dg, m_db, m_sr, m_sg, m_sb, _m_ar, _m_ag, _m_ab,
     _m_er, _m_eg, _m_eb, m_exp, m_ior, m_pd, m_ps, m_prf, m_rough,
     m_pure, m_ct) = m

    outside = cos_i > 0.0
    cos_pos = torch.abs(cos_i)
    # Which branch is taken is a discrete decision, made on the material's
    # own values outside autograd. (An infinite ior, a mirror's, gives NaN
    # here; every comparison reads it as false.)
    with torch.no_grad():
        n1 = torch.where(outside, 1.0, m_ior)
        n2 = torch.where(outside, m_ior, 1.0)
        n_ratio = n1 / torch.clamp_min(n2, 1e-12)
        sin_t2 = n_ratio * n_ratio * (1.0 - cos_pos * cos_pos)
        tir = sin_t2 > 1.0
        cos_t = _sqrt0(torch.where(tir, 1.0, 1.0 - sin_t2))
        rs = ((n1 * cos_pos - n2 * cos_t)
              / torch.clamp_min(n1 * cos_pos + n2 * cos_t, 1e-12))
        rp = ((n2 * cos_pos - n1 * cos_t)
              / torch.clamp_min(n2 * cos_pos + n1 * cos_t, 1e-12))
        fres = torch.where(tir, 1.0, (rs * rs + rp * rp) * 0.5)

        pure = m_pure > 0.5
        ct = m_ct > 0.5
        p_diff = m_pd
        p_spec = m_ps * torch.where(pure, 1.0, fres)
        p_refr = m_prf * (1.0 - fres)
        take_diff = u_branch < p_diff
        take_spec = (~take_diff) & (u_branch < p_diff + p_spec)
        take_refr = ((~take_diff) & (~take_spec)
                     & (u_branch < p_diff + p_spec + p_refr))
        refr = take_refr & (~tir)   # the lanes that use the refracted ray
        # ... and what every other lane hands on in its place (such a lane
        # has died, or took another branch)
        k = n_ratio * cos_pos - cos_t
        rf_else = _normalize3(n_ratio * dx + k * nx, n_ratio * dy + k * ny,
                              n_ratio * dz + k * nz, 1e-12)

    theta = u_a * _TWO_PI
    yy = torch.sqrt(u_b)
    rr = torch.sqrt(torch.clamp_min(1.0 - yy * yy, 0.0))
    ddx, ddy, ddz = _rotate_y_to(nx, ny, nz, rr * torch.cos(theta), yy,
                                 rr * torch.sin(theta))

    # reference quirk: reflRay receives the cosine already flipped
    # positive (CudaTracer.cu:238/484), so inside hits reflect with
    # +|cosI| (unnormalized, outward-bent)
    mrx = dx + 2.0 * cos_pos * nx
    mry = dy + 2.0 * cos_pos * ny
    mrz = dz + 2.0 * cos_pos * nz
    fin = torch.isfinite(m_exp)
    pexp = 1.0 / (torch.where(fin, m_exp, 0.0) + 1.0)
    s_cl = torch.clamp(u_b, 1e-12, 1.0)
    ph_y = torch.where(fin, torch.exp(pexp * torch.log(s_cl)), 1.0)
    ph_r = _sqrt0(1.0 - ph_y * ph_y)
    phx, phy_, phz = _rotate_y_to(mrx, mry, mrz, ph_r * torch.cos(theta),
                                  ph_y, ph_r * torch.sin(theta))
    gsx = torch.where(fin, phx, mrx)
    gsy = torch.where(fin, phy_, mry)
    gsz = torch.where(fin, phz, mrz)

    u_ac = torch.clamp_max(u_a, 1.0 - 1e-7)
    btan = -(m_rough * m_rough) * torch.log1p(-u_ac)
    binv = torch.rsqrt(1.0 + btan * btan)
    bphi = u_b * _TWO_PI
    sb, cb2 = btan * binv, binv
    mx, my, mz = _rotate_y_to(nx, ny, nz, sb * torch.cos(bphi), cb2,
                              sb * torch.sin(bphi))
    cos_m = torch.abs(_dot(dx, dy, dz, mx, my, mz))
    ctx = dx + 2.0 * cos_m * mx
    cty = dy + 2.0 * cos_m * my
    ctz = dz + 2.0 * cos_m * mz
    hx, hy, hz = _normalize3(ctx - dx, cty - dy, ctz - dz, 1e-12)
    nh = torch.abs(_dot(nx, ny, nz, hx, hy, hz))
    nl = torch.abs(_dot(nx, ny, nz, ctx, cty, ctz))
    vh = torch.clamp_min(torch.abs(_dot(dx, dy, dz, hx, hy, hz)), 1e-12)
    nv = torch.clamp_min(torch.abs(cos_i), 1e-6)
    geom = torch.minimum(torch.clamp_max(2.0 * nh * nl / vh, 1.0),
                         2.0 * nh * nv / vh)
    ct_w = geom / nv

    eps = RAY_BUMP_EPSILON
    spx = torch.where(ct, ctx, gsx)
    spy = torch.where(ct, cty, gsy)
    spz = torch.where(ct, ctz, gsz)
    sp_ox = torch.where(ct, px + mx * eps, px + nx * eps)
    sp_oy = torch.where(ct, py + my * eps, py + ny * eps)
    sp_oz = torch.where(ct, pz + mz * eps, pz + nz * eps)
    spw = torch.where(ct, ct_w, 1.0)

    # The refracted ray, by the same formulas with a graph, on the lanes
    # that use it; elsewhere the ior is replaced by 1: a NaN, even on a lane
    # that is dropped, would turn the zero gradient that reaches it into NaN.
    ior_r = torch.where(refr, m_ior, 1.0)
    nr = (torch.where(outside, 1.0, ior_r)
          / torch.clamp_min(torch.where(outside, ior_r, 1.0), 1e-12))
    ct_r = _sqrt0(1.0 - nr * nr * (1.0 - cos_pos * cos_pos))
    rfx0 = nr * dx + (nr * cos_pos - ct_r) * nx
    rfy0 = nr * dy + (nr * cos_pos - ct_r) * ny
    rfz0 = nr * dz + (nr * cos_pos - ct_r) * nz
    rfx, rfy, rfz = (torch.where(refr, a, b) for a, b in
                     zip(_normalize3(rfx0, rfy0, rfz0, 1e-12), rf_else))

    new_dx = torch.where(take_diff, ddx, torch.where(take_spec, spx, rfx))
    new_dy = torch.where(take_diff, ddy, torch.where(take_spec, spy, rfy))
    new_dz = torch.where(take_diff, ddz, torch.where(take_spec, spz, rfz))
    new_ox = torch.where(take_diff, px + nx * eps,
                         torch.where(take_spec, sp_ox, px + rfx * eps))
    new_oy = torch.where(take_diff, py + ny * eps,
                         torch.where(take_spec, sp_oy, py + rfy * eps))
    new_oz = torch.where(take_diff, pz + nz * eps,
                         torch.where(take_spec, sp_oz, pz + rfz * eps))
    refr_w = torch.where(take_refr, 1.0, 0.0)
    wr = torch.where(take_diff, m_dr, torch.where(take_spec, m_sr * spw, refr_w))
    wg = torch.where(take_diff, m_dg, torch.where(take_spec, m_sg * spw, refr_w))
    wb = torch.where(take_diff, m_db, torch.where(take_spec, m_sb * spw, refr_w))
    alive = take_diff | take_spec | refr

    return (new_ox, new_oy, new_oz, new_dx, new_dy, new_dz, wr, wg, wb,
            alive, take_diff, take_spec, take_refr, tir, ct, ct_w)


# ---------------------------------------------------------------------------
# Physical (unbiased MIS) estimator math: uniform-area light sampling in the
# correct measure with power-heuristic MIS against the scatter continuation,
# and, with ``bd``, the three-way weights against the light tracer's camera
# connections (render/bidir.py). Function for function the JAX package's
# ``_phong_pdf_p`` ... ``_physical_direct``; csrc/megakernel.cuh states the
# same formulas in the same operation order. Autograd through them is the
# plain version of the backward kernel's physical mode (render/inverse.py's
# engine="plain"), so no NaN may enter the graph on a lane that a ``where``
# drops.
# ---------------------------------------------------------------------------

def _phong_pdf_p(ax, ay, az, exponent, wx, wy, wz):
    """(n+1)/(2 pi) cos^n about the unit lobe axis; an infinite exponent is
    a delta lobe (density 0)."""
    cos_a = _dot(wx, wy, wz, ax, ay, az)
    finite = torch.isfinite(exponent)
    e = torch.where(finite, exponent, 1.0)
    safe = torch.clamp_min(cos_a, 1e-12)
    pdf = (e + 1.0) / _TWO_PI * torch.exp(e * torch.log(safe))
    return torch.where(finite & (cos_a > 0.0), pdf, 0.0)


def _beckmann_pdf_p(ax, ay, az, roughness, mx, my, mz):
    """The Beckmann sampler's exact density of microfacet normal m about
    axis a (not the textbook NDF)."""
    cos_t = _dot(mx, my, mz, ax, ay, az)
    valid = (cos_t > 0.0) & (roughness > 0.0)
    # the lanes the where drops compute a moderate density: an overflow there
    # would turn their zero cotangent into NaN
    cos_t = torch.where(valid, cos_t, 1.0)
    r2 = torch.where(valid, roughness * roughness, 1.0)
    cos_safe = torch.clamp_min(cos_t, 1e-12)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
    tan_t = sin_t / cos_safe
    r2_safe = torch.clamp_min(r2, 1e-12)
    pdf = (torch.exp(-tan_t / r2_safe) * (1.0 + tan_t * tan_t)
           / (_TWO_PI * r2_safe * sin_t))
    return torch.where(valid, pdf, 0.0)


def _lobe_axis(tx, ty, tz):
    """The image of +Y under rotate_y_to(target): the true unit lobe axis
    even for an unnormalised target."""
    zero = torch.zeros_like(tx)
    return _rotate_y_to(tx, ty, tz, zero, torch.ones_like(tx), zero)


def _fresnel_p(cos_i, m_ior):
    """Fresnel reflectance of the reference's cascade at |cos_i| for the
    side that was hit."""
    outside = cos_i > 0.0
    n1 = torch.where(outside, 1.0, m_ior)
    n2 = torch.where(outside, m_ior, 1.0)
    cos_pos = torch.abs(cos_i)
    n_ratio = n1 / torch.clamp_min(n2, 1e-12)
    sin_t2 = n_ratio * n_ratio * (1.0 - cos_pos * cos_pos)
    cos_t = torch.sqrt(torch.where(sin_t2 < 1.0,
                                   torch.clamp_min(1.0 - sin_t2, 0.0), 1.0))
    rs = ((n1 * cos_pos - n2 * cos_t)
          / torch.clamp_min(n1 * cos_pos + n2 * cos_t, 1e-12))
    rp = ((n2 * cos_pos - n1 * cos_t)
          / torch.clamp_min(n2 * cos_pos + n1 * cos_t, 1e-12))
    return torch.where(sin_t2 > 1.0, 1.0, (rs * rs + rp * rp) * 0.5)


def _spec_probability(cos_i, m_ps, m_ior, m_pure):
    """Selection probability of the specular branch. Where the Fresnel term
    is undefined (inf/inf at an infinite ior on a material not flagged pure)
    the cascade's comparisons never take the branch: its probability is 0
    here too, with no gradient. Where the ior is infinite the Fresnel term
    carries no gradient; elsewhere it does, and so does spec_avg, also where
    the probability is 0 (the gradient of the physical estimator)."""
    finite = torch.isfinite(m_ior)
    with torch.no_grad():
        f_raw = _fresnel_p(cos_i, m_ior)
        f_raw = torch.where(torch.isnan(f_raw), 0.0, f_raw)
    # a lane with an infinite ior computes with 1 in its place: nothing
    # undefined enters the graph
    f = torch.where(finite, _fresnel_p(cos_i, torch.where(finite, m_ior, 1.0)),
                    f_raw)
    return m_ps * torch.where(m_pure > 0.5, 1.0, f)


def _physical_lobes(dx, dy, dz, nx, ny, nz, cos_i, m):
    """Per-surfel lobe description the physical NEE and the continuation
    density share; a dict of per-lane tensors."""
    (m_dr, m_dg, m_db, m_sr, m_sg, m_sb, _a, _b, _c, _d, _e, _f,
     m_exp, m_ior, m_pd, m_ps, _m_prf, m_rough, m_pure, m_ct) = m
    nux, nuy, nuz = _normalize3(nx, ny, nz, 1e-12)
    cos_pos = torch.abs(cos_i)
    ct = m_ct > 0.5
    p_spec = _spec_probability(cos_i, m_ps, m_ior, m_pure)
    # Phong glossy lobe about the quirk mirror direction (raw normal)
    mrx = dx + 2.0 * cos_pos * nx
    mry = dy + 2.0 * cos_pos * ny
    mrz = dz + 2.0 * cos_pos * nz
    gax, gay, gaz = _lobe_axis(mrx, mry, mrz)
    prob_g = torch.where(ct, 0.0, p_spec)
    # Cook-Torrance / Beckmann lobe about the raw surfel normal
    cax, cay, caz = _lobe_axis(nx, ny, nz)
    prob_ct = torch.where(ct & (m_rough > 0.0), p_spec, 0.0)
    nv = torch.clamp_min(torch.abs(cos_i), 1e-6)
    return dict(n_unit=(nux, nuy, nuz), gloss_axis=(gax, gay, gaz),
                prob_g=prob_g, ct_axis=(cax, cay, caz), prob_ct=prob_ct,
                nv=nv, spec=(m_sr, m_sg, m_sb), diffuse=(m_dr, m_dg, m_db),
                diff_avg=m_pd, exponent=m_exp, roughness=m_rough)


def _lobe_terms(lb, dx, dy, dz, nx, ny, nz, wx, wy, wz):
    """(s_d, p_g, s_ct, p_ct, cos_s) toward direction w: f*cos scalars per
    lobe and their densities; contribution = diffuse * s_d + spec *
    (p_g + s_ct)."""
    nux, nuy, nuz = lb["n_unit"]
    cos_s = torch.clamp_min(_dot(nux, nuy, nuz, wx, wy, wz), 0.0)
    s_d = lb["diff_avg"] * INV_PI * cos_s
    gax, gay, gaz = lb["gloss_axis"]
    p_g = lb["prob_g"] * _phong_pdf_p(gax, gay, gaz, lb["exponent"],
                                      wx, wy, wz)
    # Cook-Torrance reflection branch: h = normalize(w - d)
    hx, hy, hz = _normalize3(wx - dx, wy - dy, wz - dz, 1e-12)
    dh = torch.clamp_min(torch.abs(_dot(dx, dy, dz, hx, hy, hz)), 1e-12)
    cax, cay, caz = lb["ct_axis"]
    p_dir = _beckmann_pdf_p(cax, cay, caz, lb["roughness"],
                            hx, hy, hz) / (4.0 * dh)
    p_ct = lb["prob_ct"] * p_dir
    nh = torch.abs(_dot(nx, ny, nz, hx, hy, hz))
    nl = torch.abs(_dot(nx, ny, nz, wx, wy, wz))
    geom = torch.minimum(torch.clamp_max(2.0 * nh * nl / dh, 1.0),
                         2.0 * nh * lb["nv"] / dh)
    s_ct = geom / lb["nv"] * p_ct
    return s_d, p_g, s_ct, p_ct, cos_s


def _al_light_geom(al_vals):
    """Per-light geometry from one area-light row (23 values): triangle
    areas, unit geometric normals, total area."""
    a = al_vals

    def tri_geom(v0, v1, v2):
        e1 = (v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2])
        e2 = (v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2])
        rx = e1[1] * e2[2] - e1[2] * e2[1]
        ry = e1[2] * e2[0] - e1[0] * e2[2]
        rz = e1[0] * e2[1] - e1[1] * e2[0]
        n2 = rx * rx + ry * ry + rz * rz
        area = 0.5 * torch.sqrt(torch.clamp_min(n2, 1e-12))
        inv = torch.rsqrt(torch.clamp_min(n2, 1e-12))
        return area, (rx * inv, ry * inv, rz * inv)

    v = [(a[3 * k], a[3 * k + 1], a[3 * k + 2]) for k in range(6)]
    area0, n0 = tri_geom(v[0], v[1], v[2])
    area1, n1 = tri_geom(v[3], v[4], v[5])
    return dict(v=v, area0=area0, area1=area1, total=area0 + area1,
                n0=n0, n1=n1)


def _al_sample_point(geom, u1, u2, upick):
    """Uniform-area point on the light (area-proportional triangle pick,
    sqrt-reparameterised barycentrics): (point, unit geometric normal of
    the picked triangle), per lane."""
    first = upick < (geom["area0"] / geom["total"])
    su = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
    w0 = 1.0 - su
    w1 = su * (1.0 - u2)
    w2 = su * u2
    v = geom["v"]
    point = tuple(
        torch.where(first, v[0][c] * w0 + v[1][c] * w1 + v[2][c] * w2,
                    v[3][c] * w0 + v[4][c] * w1 + v[5][c] * w2)
        for c in range(3))
    n0, n1 = geom["n0"], geom["n1"]
    normal = tuple(torch.where(first, n0[c] + torch.zeros_like(point[0]), n1[c])
                   for c in range(3))
    return point, normal


def _chain_model_lobes(dx, dy, dz, nx, ny, nz, cos_i, wx, wy, wz, mf):
    """Chain-model solid-angle densities per label (p_diff, p_gloss, p_ct,
    p_refr) of scattering d -> w; a delta lobe reports its branch
    probability — the pdf-model convention of render/bidir.py. The eye side
    and the light side evaluate this one function at the same (in, out)
    pairs, so their MIS weights sum to 1."""
    (_dr, _dg, _db, _sr, _sg, _sb, _aa, _ab, _ac, _e0, _e1, _e2,
     m_exp, m_ior, m_pd, m_ps, m_prf, m_rough, m_pure, m_ct) = mf
    cos_pos = torch.abs(cos_i)
    ct = m_ct > 0.5
    p_spec = _spec_probability(cos_i, m_ps, m_ior, m_pure)

    nux, nuy, nuz = _normalize3(nx, ny, nz, 1e-12)
    cos_w = torch.clamp_min(_dot(wx, wy, wz, nux, nuy, nuz), 0.0)
    p_diff = m_pd * cos_w * INV_PI

    mrx = dx + 2.0 * cos_pos * nx
    mry = dy + 2.0 * cos_pos * ny
    mrz = dz + 2.0 * cos_pos * nz
    gax, gay, gaz = _lobe_axis(mrx, mry, mrz)
    fin = torch.isfinite(m_exp)
    p_gloss_cont = _phong_pdf_p(gax, gay, gaz, m_exp, wx, wy, wz)
    p_gloss = torch.where(ct, 0.0,
                          torch.where(fin, p_spec * p_gloss_cont, p_spec))
    hx, hy, hz = _normalize3(wx - dx, wy - dy, wz - dz, 1e-12)
    dm = _dot(dx, dy, dz, hx, hy, hz)
    cax, cay, caz = _lobe_axis(nx, ny, nz)
    p_ct_cont = (_beckmann_pdf_p(cax, cay, caz, m_rough, hx, hy, hz)
                 / (4.0 * torch.clamp_min(torch.abs(dm), 1e-12)))
    p_ct = torch.where(ct, torch.where((m_rough > 0.0) & (dm < 0.0),
                                       p_spec * p_ct_cont, p_spec), 0.0)
    p_refr = m_prf * (1.0 - _fresnel_p(cos_i, m_ior))
    return p_diff, p_gloss, p_ct, p_refr


def _chain_model_taken(dx, dy, dz, nx, ny, nz, cos_i, wx, wy, wz, mf,
                       take_diff, take_spec, take_refr, ct_m):
    """Chain-model density of the branch that was taken."""
    p_diff, p_gloss, p_ct, p_refr = _chain_model_lobes(
        dx, dy, dz, nx, ny, nz, cos_i, wx, wy, wz, mf)
    p_sp = torch.where(ct_m, p_ct, p_gloss)
    return torch.where(take_diff, p_diff,
                       torch.where(take_spec, p_sp,
                                   torch.where(take_refr, p_refr, 0.0)))


def _physical_prev_pdf(lb, dx, dy, dz, ndx, ndy, ndz,
                       take_diff, gloss_br, ct_br):
    """Effective solid-angle density of the scatter continuation: what MIS
    weighs an emission hit against."""
    nux, nuy, nuz = lb["n_unit"]
    cos_new = torch.clamp_min(_dot(ndx, ndy, ndz, nux, nuy, nuz), 0.0)
    pdf_diff = lb["diff_avg"] * cos_new * INV_PI
    gax, gay, gaz = lb["gloss_axis"]
    pdf_gloss = lb["prob_g"] * _phong_pdf_p(gax, gay, gaz, lb["exponent"],
                                            ndx, ndy, ndz)
    hx, hy, hz = _normalize3(ndx - dx, ndy - dy, ndz - dz, 1e-12)
    dm = _dot(dx, dy, dz, hx, hy, hz)
    cax, cay, caz = lb["ct_axis"]
    # the lanes the where drops divide by 1: a tiny |dm| there would turn
    # their zero cotangent into NaN
    den = torch.where(dm < 0.0, 4.0 * torch.clamp_min(torch.abs(dm), 1e-12), 1.0)
    pdf_ct = torch.where(
        dm < 0.0,
        lb["prob_ct"] * _beckmann_pdf_p(cax, cay, caz, lb["roughness"],
                                        hx, hy, hz) / den,
        0.0)
    return torch.where(take_diff, pdf_diff,
                       torch.where(gloss_br, pdf_gloss,
                                   torch.where(ct_br, pdf_ct, 0.0)))


def _light_direction(lx, ly, lz, px, py, pz):
    """Unit direction from p to the light point, with the clamped squared
    distance and the distance."""
    offx, offy, offz = lx - px, ly - py, lz - pz
    d2 = torch.clamp_min(offx * offx + offy * offy + offz * offz, 1e-12)
    dist = torch.sqrt(d2)
    inv_d = 1.0 / dist
    return offx * inv_d, offy * inv_d, offz * inv_d, d2, dist


def _physical_direct(num_spheres, num_pls, num_als,
                     px, py, pz, nx, ny, nz, dx, dy, dz, t_w, pp,
                     lb, mf, pl_planes, le_planes, geoms, al_draws,
                     occ_pl, occ_al, prim_f, al_t0f, bd=None):
    """Physical-mode direct radiance at the hit — emission times its MIS
    weight plus per-lobe NEE over point and area lights — as elementwise
    math; the occlusion booleans and the area-light draws come in.

    ``t_w`` is the hit distance (1.0 on a miss), ``pp`` the carried density
    of the last scatter, ``lb`` the ``_physical_lobes`` of (d, n, mf),
    ``pl_planes`` 6 values per point light, ``le_planes`` 3 emission values
    per area light, ``geoms`` the ``_al_light_geom`` dicts, ``al_draws``
    (u1, u2, upick) per light, ``al_t0f`` each light's first-triangle index,
    ``bd`` the bidirectional carries (nu, T, pco, t2, is_primary) or None.
    Returns (dir_r, dir_g, dir_b), not masked by hit or activity."""
    zero = torch.zeros_like(px)
    cos_i = -_dot(dx, dy, dz, nx, ny, nz)
    inside = cos_i <= 0.0
    n_l = float(len(geoms)) if geoms else 1.0

    # emission MIS weight for a BSDF-sampled hit on a light
    a_hit = zero
    cgx = cgy = cgz = zero
    for i in range(num_als):
        g = geoms[i]
        t0f = al_t0f[i] + float(num_spheres)
        is0 = prim_f == t0f
        is1 = prim_f == t0f + 1.0
        a_hit = torch.where(is0 | is1, g["total"], a_hit)
        cgx = torch.where(is0, g["n0"][0], torch.where(is1, g["n1"][0], cgx))
        cgy = torch.where(is0, g["n0"][1], torch.where(is1, g["n1"][1], cgy))
        cgz = torch.where(is0, g["n0"][2], torch.where(is1, g["n1"][2], cgz))
    cos_l_hit = torch.abs(_dot(dx, dy, dz, cgx, cgy, cgz))
    p_l_hit = (t_w * t_w) / torch.clamp_min(a_hit * cos_l_hit, 1e-12)
    if bd is None:
        w_emit = torch.where(
            (pp > 0.0) & (a_hit > 0.0),
            (pp * pp) / torch.clamp_min(pp * pp + p_l_hit * p_l_hit, 1e-20),
            1.0)
    else:
        # three-way weight: BSDF hit vs NEE vs the light tracer's camera
        # connection / emitter splat
        r_nee = torch.where(pp > 0.0,
                            p_l_hit / torch.clamp_min(pp, 1e-20), 0.0)
        inv_pl_a = 1.0 / torch.clamp_min(n_l * a_hit, 1e-20)
        l_emit_hit = 0.5 * cos_l_hit * INV_PI * bd["pco"] / bd["t2"]
        rho = (bd["nu"] * inv_pl_a
               * torch.where(bd["is_primary"], 1.0, l_emit_hit) * bd["T"])
        # every ratio is clamped before it is squared (MIS_RATIO_CLAMP)
        r_nee = torch.clamp_max(r_nee, MIS_RATIO_CLAMP)
        rho = torch.clamp_max(rho, MIS_RATIO_CLAMP)
        w_emit = torch.where(a_hit > 0.0,
                             1.0 / (1.0 + r_nee * r_nee + rho * rho), 1.0)

    dir_r = mf[9] * w_emit
    dir_g = mf[10] * w_emit
    dir_b = mf[11] * w_emit
    m_dr_, m_dg_, m_db_ = lb["diffuse"]
    m_sr_, m_sg_, m_sb_ = lb["spec"]

    for i in range(num_pls):
        wx, wy, wz, d2, _dist = _light_direction(
            pl_planes[6 * i + 0], pl_planes[6 * i + 1], pl_planes[6 * i + 2],
            px, py, pz)
        s_d, p_g, s_ct, _p_ct, _cs = _lobe_terms(lb, dx, dy, dz, nx, ny, nz,
                                                 wx, wy, wz)
        vis = torch.where(occ_pl[i], 0.0, 1.0)
        irr = vis / (4.0 * math.pi * d2)
        cr = pl_planes[6 * i + 3] * irr * (m_dr_ * s_d + m_sr_ * (p_g + s_ct))
        cg = pl_planes[6 * i + 4] * irr * (m_dg_ * s_d + m_sg_ * (p_g + s_ct))
        cb = pl_planes[6 * i + 5] * irr * (m_db_ * s_d + m_sb_ * (p_g + s_ct))
        dir_r = dir_r + torch.where(inside, 0.0, cr)
        dir_g = dir_g + torch.where(inside, 0.0, cg)
        dir_b = dir_b + torch.where(inside, 0.0, cb)

    for i in range(num_als):
        g = geoms[i]
        (lx, ly, lz), (nlx, nly, nlz) = _al_sample_point(g, *al_draws[i])
        wx, wy, wz, d2, _dist = _light_direction(lx, ly, lz, px, py, pz)
        s_d, p_g, s_ct, p_ct, cos_s = _lobe_terms(lb, dx, dy, dz, nx, ny, nz,
                                                  wx, wy, wz)
        cos_l = torch.abs(_dot(nlx, nly, nlz, wx, wy, wz))
        geo = torch.where(occ_al[i], 0.0, cos_l * g["total"] / d2)
        p_l = d2 / torch.clamp_min(g["total"] * cos_l, 1e-12)
        p_b = lb["diff_avg"] * cos_s * INV_PI
        if bd is None:
            lt_d = lt_g = lt_ct = 0.0
        else:
            # nu * p_LT / p_NEE of this labelled path
            nux, nuy, nuz = lb["n_unit"]
            l_emit = (0.5 * cos_l * INV_PI
                      * torch.abs(_dot(nux, nuy, nuz, wx, wy, wz)) / d2)
            cos_rev = _dot(wx, wy, wz, nx, ny, nz)
            lam_d, lam_g, lam_ct, _lr = _chain_model_lobes(
                -wx, -wy, -wz, nx, ny, nz, cos_rev, -dx, -dy, -dz, mf)
            geo_prev = bd["pco"] / torch.clamp_min(bd["t2"], 1e-12)
            base = (bd["nu"] / n_l) * bd["T"] * l_emit
            r_lt_d = base * torch.where(bd["is_primary"], 1.0,
                                        lam_d * geo_prev)
            r_lt_g = torch.where(bd["is_primary"], 0.0,
                                 base * lam_g * geo_prev)
            r_lt_ct = torch.where(bd["is_primary"], 0.0,
                                  base * lam_ct * geo_prev)
            rl_d = torch.clamp_max(r_lt_d * p_l, MIS_RATIO_CLAMP)
            rl_g = torch.clamp_max(r_lt_g * p_l, MIS_RATIO_CLAMP)
            rl_ct = torch.clamp_max(r_lt_ct * p_l, MIS_RATIO_CLAMP)
            lt_d = rl_d * rl_d
            lt_g = rl_g * rl_g
            lt_ct = rl_ct * rl_ct
        w_d = (p_l * p_l) / torch.clamp_min(p_l * p_l + p_b * p_b + lt_d, 1e-12)
        w_g = (p_l * p_l) / torch.clamp_min(p_l * p_l + p_g * p_g + lt_g, 1e-12)
        w_ct = (p_l * p_l) / torch.clamp_min(p_l * p_l + p_ct * p_ct + lt_ct,
                                             1e-12)
        ler, leg, leb = le_planes[3 * i:3 * i + 3]
        cr = ler * (m_dr_ * s_d * geo * w_d
                    + m_sr_ * (p_g * geo * w_g + s_ct * geo * w_ct))
        cg = leg * (m_dg_ * s_d * geo * w_d
                    + m_sg_ * (p_g * geo * w_g + s_ct * geo * w_ct))
        cb = leb * (m_db_ * s_d * geo * w_d
                    + m_sb_ * (p_g * geo * w_g + s_ct * geo * w_ct))
        dir_r = dir_r + torch.where(inside, 0.0, cr)
        dir_g = dir_g + torch.where(inside, 0.0, cg)
        dir_b = dir_b + torch.where(inside, 0.0, cb)

    return dir_r, dir_g, dir_b


def _camera_j_img(tan_half, width: int, height: int, cos_abs):
    """The camera importance dA_img/dOmega = W H / (s^2 aspect cos^3 theta)
    at |cos theta| = ``cos_abs`` off the optical axis."""
    s_fov = -2.0 * tan_half
    cos_t = torch.clamp(cos_abs, 1e-4, 1.0)
    return (width * height) / (s_fov * s_fov * (height / width)
                               * (cos_t * cos_t * cos_t))


def _safe_inv(d):
    """1 / d with |d| floored at 1e-12 (the grid's slab test)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0.0, -1e-12, 1e-12), d)


def _supercell_slab(scal, lo, hi, ox, oy, oz, ivx, ivy, ivz, t_limit):
    """Per ray: does the segment [0, t_limit] overlap the box whose corners
    are grid cells ``lo`` and ``hi`` (float cell coordinates per axis)?
    The kernel's ``supercell_slab`` formula for formula."""
    ts = []
    for a, (o, iv) in enumerate(((ox, ivx), (oy, ivy), (oz, ivz))):
        ts.append(((scal[a] + lo[a] * scal[3 + a] - o) * iv,
                   (scal[a] + hi[a] * scal[3 + a] - o) * iv))
    (t0x, t1x), (t0y, t1y), (t0z, t1z) = ts
    mn, mx = torch.minimum, torch.maximum
    tn = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mx(mn(t0z, t1z), torch.zeros_like(ox)))
    tf = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    return (tn <= tf) & (tn <= t_limit)


def _grid_boxes(grid: PackedGrid):
    """The supercells in the kernel's visit order: (cell-coordinate corners lo
    and hi as float32 tensors, sphere ids, triangle ids), empty boxes left
    out (the kernel skips them before their slab test)."""
    rx, ry, rz, F, sc_off = grid.meta[:5]
    scx, scy, scz = grid.supercells
    SC = scx * scy * scz
    idx = grid.idx.long()
    start = idx[sc_off:sc_off + 2 * (SC + 1)].tolist()
    boxes, bi = [], 0
    for bz in range(scz):
        for by in range(scy):
            for bx in range(scx):
                s0, s1 = start[bi], start[bi + 1]
                t0, t1 = start[SC + 1 + bi], start[SC + 2 + bi]
                bi += 1
                if s1 == s0 and t1 == t0:
                    continue
                lo = [float(bx * F), float(by * F), float(bz * F)]
                hi = [min(lo[0] + F, float(rx)), min(lo[1] + F, float(ry)),
                      min(lo[2] + F, float(rz))]
                boxes.append((torch.tensor(lo, dtype=torch.float32, device=idx.device),
                              torch.tensor(hi, dtype=torch.float32, device=idx.device),
                              idx[s0:s1], idx[t0:t1]))
    return boxes


def _make_sweep_fns(packed: PackedScene, track_index: bool = False,
                    grid: Optional[PackedGrid] = None,
                    stats: Optional[dict] = None):
    """The two scene sweeps every bounce runs. Linear form: every primitive
    is tested for every ray, as a ``[rays, primitives]`` tensor. Tie rule of
    the sequential sweep: ``valid & (t <= best_t)`` — the LATER primitive
    wins equal t, spheres first then triangles. ``track_index=True`` makes
    ``intersect_sweep`` also return the winning primitive's index as float32
    (sphere i: i; triangle i: num_spheres + i; -1 on a miss).

    With ``grid`` (``pack_grid``'s bundle on the tables' device) the sweeps
    are the kernel's grid sweeps in tensor form: the global lists for every
    ray, then per supercell box, in the kernel's order, a mask of the rays
    whose slab test passes against their best t so far (the shadow distance
    for occlusion; occluded rays drop out) and the box's lists tested on
    those rays alone, with the index-based tie rule ``(t < best) | (t == best
    & idx >= best_idx)``: the same winner as the linear sweep. ``stats``
    then receives the kernel's work on the rays a sweep is given as ``live``:
    ``grid_slab_tests``, ``grid_sphere_tests`` and ``grid_triangle_tests``
    (an occlusion test list counts up to its first occluder)."""
    num_spheres, num_tris = packed.counts[0], packed.counts[1]
    sph = packed.spheres[:num_spheres]
    tri = packed.triangles[:num_tris]
    sph_c = [sph[:, k] for k in range(S_COLS)]
    tri_c = [tri[:, k] for k in range(T_COLS)]
    if grid is not None:
        boxes = _grid_boxes(grid)
        scal = grid.scal.unbind()
        _, _, _, _, _, gs_off, n_gs, gt_off, n_gt = grid.meta
        glob_sph = grid.idx[gs_off:gs_off + n_gs].long()
        glob_tri = grid.idx[gt_off:gt_off + n_gt].long()

    def _col(v):
        return v[:, None]

    def sph_tests(ox, oy, oz, dx, dy, dz, ids=None):
        c = sph_c if ids is None else [col[ids] for col in sph_c]
        return _sphere_t(_col(ox), _col(oy), _col(oz), _col(dx), _col(dy),
                         _col(dz), c[0], c[1], c[2], c[3])

    def tri_tests(ox, oy, oz, dx, dy, dz, ids=None):
        c = tri_c if ids is None else [col[ids] for col in tri_c[:9]]
        return _triangle_t(_col(ox), _col(oy), _col(oz), _col(dx), _col(dy),
                           _col(dz), c[0:3], c[3:6], c[6:9])

    def _last_min(t, valid):
        """Nearest valid t per ray and the LAST primitive index reaching it."""
        inf = torch.full_like(t, math.inf)
        tm = torch.where(valid, t, inf)
        best = tm.min(dim=1).values
        is_best = valid & (tm == _col(best))
        count = t.shape[1]
        idx = count - 1 - torch.flip(is_best, (1,)).to(torch.int8).argmax(dim=1)
        return best, idx, is_best.any(dim=1)

    def tally(key, count):
        if stats is not None:
            stats[key] = stats.get(key, 0) + int(count)

    def grid_walk(ray, live, t_limit, consider, done=None):
        """The kernel's ``grid_walk`` on tensors: ``consider(rows, ids,
        tri_list)`` for the global lists on every ray, then per box, in the
        kernel's order, for the rays whose slab test passes against
        ``t_limit`` (read anew at each box: ``consider`` may lower it in
        place), spheres before triangles. ``done`` (updated in place by
        ``consider``) marks rays that have returned: they gate and test
        nothing more. Tallies one slab test per box for every live ray still
        walking."""
        def walking(rows):
            return rows if done is None else rows[~done[rows]]

        everyone = torch.arange(ray[0].shape[0], device=ray[0].device)
        consider(everyone, glob_sph, False)
        consider(walking(everyone), glob_tri, True)
        iv = [_safe_inv(d) for d in ray[3:]]
        for lo, hi, s_ids, t_ids in boxes:
            tally("grid_slab_tests", (live if done is None else live & ~done).sum())
            rows = walking(torch.nonzero(_supercell_slab(scal, lo, hi, *ray[:3], *iv,
                                                         t_limit))[:, 0])
            consider(rows, s_ids, False)
            consider(walking(rows), t_ids, True)

    def grid_nearest(ray, live):
        """(best_t, best index) per ray through the grid: index i < S a
        sphere, S + j triangle j, -1 a miss."""
        n = ray[0].shape[0]
        best_t = torch.full((n,), math.inf, dtype=torch.float32, device=ray[0].device)
        best_i = torch.full((n,), -1, dtype=torch.long, device=ray[0].device)

        def consider(rows, ids, tri_list):
            if not ids.numel() or not rows.numel():
                return
            r = [v[rows] for v in ray]
            if tri_list:
                t, _, _, valid = tri_tests(*r, ids)
                index = ids + num_spheres
            else:
                t, valid = sph_tests(*r, ids)
                index = ids
            tally("grid_triangle_tests" if tri_list else "grid_sphere_tests",
                  int(live[rows].sum()) * ids.numel())
            tm = torch.where(valid, t, math.inf)
            m = tm.min(dim=1).values
            at_min = valid & (tm == _col(m))
            cand = torch.where(at_min, index[None, :], -1).max(dim=1).values
            bt, bi = best_t[rows], best_i[rows]
            better = at_min.any(dim=1) & ((m < bt) | ((m == bt) & (cand >= bi)))
            best_t[rows] = torch.where(better, m, bt)
            best_i[rows] = torch.where(better, cand, bi)

        grid_walk(ray, live, best_t, consider)
        return best_t, best_i

    def intersect_sweep(ox, oy, oz, dx, dy, dz, live=None):
        """(best_t, nx, ny, nz, mat index); a miss leaves t=inf, n=0, mat 0.
        Which primitive wins is a discrete decision and
        is taken outside autograd; the winner's t and normal are then
        evaluated alone, by the same formulas, so a gradient flows through
        the hit that was taken and through nothing else. ``live`` marks the
        rays whose grid work is tallied (default: all)."""
        n = ox.shape[0]
        inf = torch.full((n,), math.inf, dtype=torch.float32, device=ox.device)
        idx0 = torch.zeros((n,), dtype=torch.long, device=ox.device)
        with torch.no_grad():
            if grid is not None:
                ray = [v.detach() for v in (ox, oy, oz, dx, dy, dz)]
                _, best_i = grid_nearest(ray, torch.ones((n,), dtype=torch.bool,
                                                         device=ox.device)
                                         if live is None else live)
                is_sph = (best_i >= 0) & (best_i < num_spheres)
                is_tri = best_i >= num_spheres
                s_idx = torch.where(is_sph, best_i, 0)
                t_idx = torch.where(is_tri, best_i - num_spheres, 0)
            else:
                best_t, s_idx, t_idx = inf, idx0, idx0
                is_sph = is_tri = torch.zeros((n,), dtype=torch.bool,
                                              device=ox.device)
                if num_spheres:
                    t, valid = sph_tests(ox, oy, oz, dx, dy, dz)
                    bt, s_idx, is_sph = _last_min(t, valid)
                    best_t = torch.where(is_sph, bt, best_t)
                if num_tris:
                    t, _, _, valid = tri_tests(ox, oy, oz, dx, dy, dz)
                    bt, t_idx, found = _last_min(t, valid)
                    is_tri = found & (bt <= best_t)
                    is_sph = is_sph & (~is_tri)
        best_t = inf
        nx, ny, nz = (torch.zeros_like(ox) for _ in range(3))
        mat = idx0
        if num_spheres:
            cx, cy, cz, r = (sph_c[k][s_idx] for k in range(4))
            t, _ = _sphere_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r)
            px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
            snx, sny, snz = _normalize3(px - cx, py - cy, pz - cz)
            best_t = torch.where(is_sph, t, best_t)
            nx = torch.where(is_sph, snx, nx)
            ny = torch.where(is_sph, sny, ny)
            nz = torch.where(is_sph, snz, nz)
            mat = torch.where(is_sph, sph_c[4][s_idx].long(), mat)
        if num_tris:
            row = [c[t_idx] for c in tri_c]
            t, w1, w2, _ = _triangle_t(ox, oy, oz, dx, dy, dz, row[0:3],
                                       row[3:6], row[6:9])
            # barycentric normal interpolation, unnormalized — exactly
            # Primitives.h:71-73
            w0 = 1.0 - w1 - w2
            tnx = row[9] * w0 + row[12] * w1 + row[15] * w2
            tny = row[10] * w0 + row[13] * w1 + row[16] * w2
            tnz = row[11] * w0 + row[14] * w1 + row[17] * w2
            best_t = torch.where(is_tri, t, best_t)
            nx = torch.where(is_tri, tnx, nx)
            ny = torch.where(is_tri, tny, ny)
            nz = torch.where(is_tri, tnz, nz)
            mat = torch.where(is_tri, row[18].long(), mat)
        if track_index:
            prim = torch.where(is_tri, num_spheres + t_idx,
                               torch.where(is_sph, s_idx, -1))
            return best_t, nx, ny, nz, mat, prim.to(torch.float32)
        return best_t, nx, ny, nz, mat

    def grid_occlusion(ray, max_d, live):
        occ = torch.zeros(ray[0].shape, dtype=torch.bool, device=ray[0].device)

        def consider(rows, ids, tri_list):
            if not ids.numel() or not rows.numel():
                return
            r = [v[rows] for v in ray]
            if tri_list:
                t, _, _, valid = tri_tests(*r, ids)
            else:
                t, valid = sph_tests(*r, ids)
            hits = valid & (t <= _col(max_d[rows]))
            found = hits.any(dim=1)
            # the kernel stops at the first occluder of the list
            tests = torch.where(found, hits.to(torch.int8).argmax(dim=1) + 1,
                                ids.numel())
            tally("grid_triangle_tests" if tri_list else "grid_sphere_tests",
                  (tests * live[rows]).sum())
            occ[rows] |= found

        # an occluded ray has returned: it gates and tests nothing more
        grid_walk(ray, live, max_d, consider, done=occ)
        return occ

    @torch.no_grad()
    def occlusion_sweep(sox, soy, soz, wx, wy, wz, max_d, live=None):
        """Visibility is a discrete decision: no gradient passes through.
        ``live`` marks the rays whose grid work is tallied (default: all)."""
        if grid is not None:
            return grid_occlusion(
                (sox, soy, soz, wx, wy, wz), max_d,
                torch.ones(sox.shape, dtype=torch.bool, device=sox.device)
                if live is None else live)
        occ = torch.zeros(sox.shape, dtype=torch.bool, device=sox.device)
        if num_spheres:
            t, valid = sph_tests(sox, soy, soz, wx, wy, wz)
            occ = occ | (valid & (t <= _col(max_d))).any(dim=1)
        if num_tris:
            t, _, _, valid = tri_tests(sox, soy, soz, wx, wy, wz)
            occ = occ | (valid & (t <= _col(max_d))).any(dim=1)
        return occ

    return intersect_sweep, occlusion_sweep


def _texture_block_plain(packed: PackedScene, ox, oy, oz, dx, dy, dz, prim,
                         mat, nx, ny, nz, m_d):
    """Color and normal mapping at the hit, the kernel's ``texture_block``
    formula for formula: sphere UVs from the polynomial ``atan2f`` /
    ``asinf`` of the unit normal, triangle UVs from a barycentric recompute
    of the winning triangle, the bilinear fetch from the flat atlas, the
    tangent-frame perturbation. ``prim`` [N] int64 (-1 on a miss), ``mat``
    [N] int64, ``m_d`` the three diffuse columns. Returns (diffuse r/g/b,
    normal x/y/z). Differentiable in the atlas, the diffuse columns and the
    ray and normal (the UVs move with the hit)."""
    num_spheres, num_tris = packed.counts[0], packed.counts[1]
    atlas, meta, triuv, matids = packed.tex_tables()
    n2 = nx * nx + ny * ny + nz * nz
    inv_nl = torch.rsqrt(torch.clamp_min(n2, 1e-20))
    nux, nuy, nuz = nx * inv_nl, ny * inv_nl, nz * inv_nl
    is_tri = prim >= num_spheres
    u, v = sphere_uv(nux, nuy, nuz)
    tg = _sphere_tangent(nux, nuy, nuz)
    if num_tris:
        ti = torch.clamp(prim - num_spheres, 0, num_tris - 1)
        rc = packed.triangles[ti].unbind(-1)
        uc = triuv[ti].unbind(-1)
        _, w1, w2, _ = _triangle_t(ox, oy, oz, dx, dy, dz, rc[0:3], rc[3:6],
                                   rc[6:9])
        w0 = 1.0 - (w1 + w2)
        u = torch.where(is_tri, uc[0] * w0 + uc[2] * w1 + uc[4] * w2, u)
        v = torch.where(is_tri, uc[1] * w0 + uc[3] * w1 + uc[5] * w2, v)
        tt = triangle_uv_tangent(rc[3:6], rc[6:9], uc[0:2], uc[2:4], uc[4:6])
        tg = tuple(torch.where(is_tri, a, b) for a, b in zip(tt, tg))
    ids = matids[mat]
    num_tex = packed.tex_counts[0]

    def sample(tid):
        k = torch.clamp(tid, 0.0, float(num_tex - 1)).to(torch.int64)
        base, h, w = meta[k].unbind(-1)
        bi, hi, wi = base.to(torch.int64), h.to(torch.int64), w.to(torch.int64)

        def texel(xi, yi):
            return atlas[bi + wrap(yi, hi) * wi + wrap(xi, wi)]

        return bilinear(texel, h, w, u, v).unbind(-1)

    a = sample(ids[:, 0])
    has_c = ids[:, 0] >= 0.0
    new_d = tuple(m_d[c] * torch.where(has_c, a[c], 1.0) for c in range(3))
    t0, t1, t2 = sample(ids[:, 1])
    has_n = ids[:, 1] >= 0.0
    pert = perturb_normal(nx, ny, nz, *tg, t0, t1, t2)
    new_n = tuple(torch.where(has_n, p, n) for p, n in zip(pert, (nx, ny, nz)))
    return new_d, new_n


def _render_sums_plain(packed: PackedScene, cam: torch.Tensor,
                       clamp_v: float, seed: int,
                       width: int, height: int, spp: int, max_bounces: int,
                       pixel_offset: int, n_local: int, sample_offset: int,
                       stats: Optional[dict] = None, physical: bool = False,
                       bidir_nu: Optional[float] = None,
                       packed_grid: Optional[PackedGrid] = None,
                       state_bf16: bool = False,
                       lane_tally=None) -> torch.Tensor:
    """Radiance SUMS over spp for ``n_local`` pixels from ``pixel_offset``,
    ``[n_local, 3]`` float32 on the tables' device. ``cam`` is
    ``_cam_tensor``'s. Differentiable in the default variant: tables or a
    camera that carry an autograd graph receive gradients, with every
    discrete decision (which primitive is hit, visibility, the scatter
    branch) detached. ``physical`` selects the unbiased MIS estimator (state
    gains the density of the last scatter), ``bidir_nu`` adds the carries of
    the bidirectional weights (chain ratio, chain-model density and outgoing
    cosine of the last scatter, the eye ray's camera importance).
    ``packed_grid`` sweeps through the supercell grid; ``state_bf16`` rounds
    the radiance and throughput carries to bfloat16 at the end of every
    bounce, as the kernel stores them. ``lane_tally`` = (``_LaneTally``,
    lane0): these pixels are the kernels' lanes from lane0 on; each path's
    sweeps and stored bounces go to the tally."""
    bidir = bidir_nu is not None
    textured = packed.textured
    device = packed.device
    num_spheres, num_tris, _, num_pls, num_als = packed.counts
    # Table entries enter the arithmetic as 0-d float32 tensors: against a
    # float32 tensor that rounds nothing, and a graph stays attached.
    camf = cam.unbind()
    z_near = camf[13]
    s_fov = -2.0 * camf[12]
    n_pixels = width * height
    ppb = rng.pairs_per_bounce(num_als)
    eps = RAY_BUMP_EPSILON
    intersect_sweep, occlusion_sweep = _make_sweep_fns(
        packed, track_index=physical or textured or stats is not None,
        grid=packed_grid, stats=stats)
    mats, pls, als, bg = (packed.materials, packed.point_lights,
                          packed.area_lights, packed.background)
    pl_rows = [pls[i].unbind() for i in range(num_pls)]
    al_rows = [als[i].unbind() for i in range(num_als)]
    bgf = bg.unbind()
    if physical:
        al_geoms = [_al_light_geom(row) for row in al_rows]
        pl_planes = [v for row in pl_rows for v in row]
        le_planes = [v for row in al_rows
                     for v in mats[int(row[22])][9:12].unbind()]
        al_t0f = [row[21] for row in al_rows]
    if bidir:
        nu_b = torch.tensor(bidir_nu, dtype=torch.float32, device=device)

    pixel = (pixel_offset
             + torch.arange(n_local, dtype=torch.int64, device=device))
    in_image = (pixel < n_pixels) & (pixel >= 0)
    pxi = (pixel % width).to(torch.float32)
    pyi = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    zero = torch.zeros(n_local, dtype=torch.float32, device=device)

    def draw(sample, pair):
        return rng.uniform_pair(seed, pixel, sample, pair)

    def eye(sample):
        """Jittered pinhole eye ray per pixel (computeEyeRay,
        CudaTracer.cu:321-343)."""
        ju, jv = draw(sample, rng.PAIR_EYE)
        jx = pxi + ju
        jy = pyi + jv
        sx = (jx * (1.0 / width) - 0.5) * s_fov * z_near
        sy = ((jy * (1.0 / height) - 0.5) * s_fov * z_near
              * (height / width))
        sz = zero + z_near
        dx0 = camf[0] * sx + camf[1] * sy + camf[2] * sz
        dy0 = camf[3] * sx + camf[4] * sy + camf[5] * sz
        dz0 = camf[6] * sx + camf[7] * sy + camf[8] * sz
        j_img = None
        if bidir:
            s_len = torch.sqrt(torch.clamp_min(sx * sx + sy * sy + sz * sz,
                                               1e-20))
            j_img = _camera_j_img(camf[12], width, height,
                                  torch.abs(sz) / s_len)
        return _normalize3(dx0, dy0, dz0) + (j_img,)

    def bounce(state, sample, b_cur):
        (ox, oy, oz, dx, dy, dz, r0x, r0y, r0z, r1x, r1y, r1z, active,
         prev_pdf, lt_S, pf_model, pco, j_img) = state
        pair0 = rng.pair_base(b_cur, num_als)

        best_t, nx, ny, nz, mat, *prim_f = intersect_sweep(ox, oy, oz,
                                                           dx, dy, dz, active)
        prim_f = prim_f[0] if prim_f else None
        hit = best_t < math.inf
        t_safe = torch.where(hit, best_t, 0.0)
        px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe

        if stats is not None:
            stats["triangle_hits"] = stats.get("triangle_hits", 0) + int(
                (active & hit & (prim_f >= num_spheres)).sum())
        mrow = mats[mat]                       # direct indexed material fetch
        mf = tuple(mrow[:, f] for f in range(M_COLS))
        if textured:
            # color map on the diffuse albedo, normal map on the shading
            # normal, before the cosine, NEE and the scatter
            (m_d, (nx, ny, nz)) = _texture_block_plain(
                packed, ox, oy, oz, dx, dy, dz, prim_f.to(torch.int64), mat,
                nx, ny, nz, mf[0:3])
            mf = m_d + mf[3:]
            if stats is not None:
                # the texture block's work: one per hit, a fetch per map
                ids = packed.tex_matids[mat]
                live = active & hit
                on_sphere = live & (prim_f < num_spheres)
                for key, mask in (("tex_sphere_hits", on_sphere),
                                  ("tex_triangle_hits", live & ~on_sphere),
                                  ("color_fetches", live & (ids[:, 0] >= 0)),
                                  ("normal_fetches", live & (ids[:, 1] >= 0))):
                    stats[key] = stats.get(key, 0) + int(mask.sum())
        (m_dr, m_dg, m_db, _sr, _sg, _sb, m_ar, m_ag, m_ab,
         m_er, m_eg, m_eb, _e, _i, m_pd, _ps, _prf, _ro, _pu, _ct) = mf

        cos_i = -_dot(dx, dy, dz, nx, ny, nz)
        inside = cos_i <= 0.0

        def light_contribution(lx, ly, lz, pwx, pwy, pwz):
            offx, offy, offz = lx - px, ly - py, lz - pz
            d2 = torch.clamp_min(offx * offx + offy * offy + offz * offz, 1e-12)
            dist = torch.sqrt(d2)
            inv_d = 1.0 / dist
            wx, wy, wz = offx * inv_d, offy * inv_d, offz * inv_d
            cos_l = torch.clamp_min(_dot(nx, ny, nz, wx, wy, wz), 0.0)
            # the shadow sweeps the kernel runs: where the result can matter
            needed = active & hit & (~inside) & (cos_l > 0.0) & (m_pd > 0.0)
            occ = occlusion_sweep(px + nx * eps, py + ny * eps, pz + nz * eps,
                                  wx, wy, wz, dist - 2.0 * eps, needed)
            if stats is not None:
                for key, mask in (("shadow_rays", needed),
                                  ("shadow_rays_occluded", needed & occ)):
                    stats[key] = stats.get(key, 0) + int(mask.sum())
            scale = (torch.where(occ, 0.0, cos_l) * m_pd * INV_PI
                     / (4.0 * math.pi) / d2)
            return pwx * m_dr * scale, pwy * m_dg * scale, pwz * m_db * scale

        def parity_direct():
            """The reference-parity direct term: emission always, NEE from
            outside with the reference's falloff."""
            dir_r, dir_g, dir_b = m_er, m_eg, m_eb
            for i in range(num_pls):
                p = pl_rows[i]
                cr, cg, cb = light_contribution(zero + p[0], zero + p[1],
                                                zero + p[2], p[3], p[4], p[5])
                dir_r = dir_r + torch.where(inside, 0.0, cr)
                dir_g = dir_g + torch.where(inside, 0.0, cg)
                dir_b = dir_b + torch.where(inside, 0.0, cb)
            for i in range(num_als):
                u1, u2 = draw(sample, pair0 + 2 + 2 * i)
                u3, upick = draw(sample, pair0 + 3 + 2 * i)
                inv_tot = 1.0 / torch.clamp_min(u1 + u2 + u3, 1e-12)
                w0, w1, w2 = u1 * inv_tot, u2 * inv_tot, u3 * inv_tot
                first = upick > 0.5
                a = al_rows[i][0:9]
                b = al_rows[i][9:18]
                lx = torch.where(first, a[0] * w0 + a[3] * w1 + a[6] * w2,
                                 b[0] * w0 + b[3] * w1 + b[6] * w2)
                ly = torch.where(first, a[1] * w0 + a[4] * w1 + a[7] * w2,
                                 b[1] * w0 + b[4] * w1 + b[7] * w2)
                lz = torch.where(first, a[2] * w0 + a[5] * w1 + a[8] * w2,
                                 b[2] * w0 + b[5] * w1 + b[8] * w2)
                cr, cg, cb = light_contribution(lx, ly, lz, al_rows[i][18],
                                                al_rows[i][19], al_rows[i][20])
                dir_r = dir_r + torch.where(inside, 0.0, cr)
                dir_g = dir_g + torch.where(inside, 0.0, cg)
                dir_b = dir_b + torch.where(inside, 0.0, cb)
            return dir_r, dir_g, dir_b

        def physical_direct():
            """The physical estimator's direct term, its occlusion sweeps
            taken here from the hit point bumped along the UNIT normal."""
            nux, nuy, nuz = lb["n_unit"]
            al_draws = []
            for i in range(num_als):
                u1, u2 = draw(sample, pair0 + 2 + 2 * i)
                _u3, upick = draw(sample, pair0 + 3 + 2 * i)
                al_draws.append((u1, u2, upick))

            def occ_of(lx, ly, lz):
                wx, wy, wz, _d2, dist = _light_direction(lx, ly, lz,
                                                         px, py, pz)
                needed = None
                if stats is not None:
                    # the sweeps whose result can change the image
                    s_d, p_g, s_ct, _p, _c = _lobe_terms(
                        lb, dx, dy, dz, nx, ny, nz, wx, wy, wz)
                    needed = (active & hit & (~inside)
                              & ((s_d != 0.0) | (p_g != 0.0) | (s_ct != 0.0)))
                occ = occlusion_sweep(px + nux * eps, py + nuy * eps,
                                      pz + nuz * eps, wx, wy, wz,
                                      dist - 2.0 * eps, needed)
                if stats is not None:
                    for key, mask in (("shadow_rays", needed),
                                      ("shadow_rays_occluded", needed & occ)):
                        stats[key] = stats.get(key, 0) + int(mask.sum())
                return occ

            occ_pl = [occ_of(zero + p[0], zero + p[1], zero + p[2])
                      for p in pl_rows]
            occ_al = [occ_of(*_al_sample_point(al_geoms[i], *al_draws[i])[0])
                      for i in range(num_als)]
            t_w = torch.where(hit, best_t, 1.0)
            return _physical_direct(
                num_spheres, num_pls, num_als, px, py, pz, nx, ny, nz,
                dx, dy, dz, t_w, prev_pdf, lb, mf, pl_planes, le_planes,
                al_geoms, al_draws, occ_pl, occ_al, prim_f, al_t0f, bd=bd)

        if physical:
            lb = _physical_lobes(dx, dy, dz, nx, ny, nz, cos_i, mf)
            bd = None
            if bidir:
                # the chain ratio T up to this vertex: p_LT prefix over
                # p_eye prefix, without nu
                nux, nuy, nuz = lb["n_unit"]
                cos_arr = torch.abs(_dot(dx, dy, dz, nux, nuy, nuz))
                t_w = torch.where(hit, best_t, 1.0)
                t2_arr = torch.clamp_min(t_w * t_w, 1e-12)
                is_primary = torch.full_like(hit, b_cur == 0)
                c_a = j_img * cos_arr / t2_arr
                e_prev = pf_model * cos_arr / t2_arr
                T_bd = torch.clamp_max(
                    torch.where(is_primary,
                                1.0 / torch.clamp_min(c_a, 1e-20),
                                lt_S / torch.clamp_min(e_prev, 1e-20)),
                    MIS_RATIO_CLAMP)
                bd = dict(nu=nu_b, T=T_bd, pco=pco, t2=t2_arr,
                          is_primary=is_primary)
            dir_r, dir_g, dir_b = physical_direct()
        else:
            dir_r, dir_g, dir_b = parity_direct()

        act_hit = active & hit
        if lane_tally is not None:
            hits.append(act_hit)
        beer_mask = act_hit & inside
        r1x = torch.where(beer_mask, r1x * torch.exp(-t_safe * m_ar), r1x)
        r1y = torch.where(beer_mask, r1y * torch.exp(-t_safe * m_ag), r1y)
        r1z = torch.where(beer_mask, r1z * torch.exp(-t_safe * m_ab), r1z)

        r0x = r0x + torch.where(act_hit, r1x * dir_r, 0.0)
        r0y = r0y + torch.where(act_hit, r1y * dir_g, 0.0)
        r0z = r0z + torch.where(act_hit, r1z * dir_b, 0.0)
        miss = active & (~hit)
        r0x = r0x + torch.where(miss, bgf[0] * r1x, 0.0)
        r0y = r0y + torch.where(miss, bgf[1] * r1y, 0.0)
        r0z = r0z + torch.where(miss, bgf[2] * r1z, 0.0)

        u_branch, u_a = draw(sample, pair0)
        u_b, _unused = draw(sample, pair0 + 1)
        (new_ox, new_oy, new_oz, new_dx, new_dy, new_dz, wr, wg, wb,
         alive, take_diff, take_spec, take_refr, _tir, ct_m,
         _ctw) = _scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz,
                                 cos_i, u_branch, u_a, u_b, mf)

        if physical:
            # the density of the continuation taken; a lane that died takes
            # none (its direction may be NaN there: an infinite ior) and its
            # density is never read
            nd = [torch.where(alive, v, 0.0) for v in (new_dx, new_dy, new_dz)]
            pdf_new = _physical_prev_pdf(
                lb, dx, dy, dz, *nd, take_diff, take_spec & (~ct_m), take_spec & ct_m)
            prev_pdf = torch.where(act_hit,
                                   torch.where(~inside, pdf_new, 0.0),
                                   prev_pdf)
        if bidir:
            # chain-model densities of the taken branch, both directions
            pdf_fwd_m = _chain_model_taken(
                dx, dy, dz, nx, ny, nz, cos_i, new_dx, new_dy, new_dz, mf,
                take_diff, take_spec, take_refr, ct_m)
            cos_rev = _dot(new_dx, new_dy, new_dz, nx, ny, nz)
            pdf_rev_m = _chain_model_taken(
                -new_dx, -new_dy, -new_dz, nx, ny, nz, cos_rev,
                -dx, -dy, -dz, mf, take_diff, take_spec, take_refr, ct_m)
            lam_full = pdf_rev_m * pco / t2_arr
            s_new = torch.clamp_max(torch.where(
                is_primary,
                torch.where(take_diff & (cos_i > 0.0), 1.0, 0.0)
                / torch.clamp_min(c_a, 1e-20),
                T_bd * lam_full), MIS_RATIO_CLAMP)
            lt_S = torch.where(act_hit, s_new, lt_S)
            pf_model = torch.where(act_hit, pdf_fwd_m, pf_model)
            pco = torch.where(
                act_hit, torch.abs(_dot(new_dx, new_dy, new_dz, *lb["n_unit"])),
                pco)

        ox = torch.where(act_hit, new_ox, ox)
        oy = torch.where(act_hit, new_oy, oy)
        oz = torch.where(act_hit, new_oz, oz)
        dx = torch.where(act_hit, new_dx, dx)
        dy = torch.where(act_hit, new_dy, dy)
        dz = torch.where(act_hit, new_dz, dz)
        r1x = torch.where(act_hit, r1x * wr, r1x)
        r1y = torch.where(act_hit, r1y * wg, r1y)
        r1z = torch.where(act_hit, r1z * wb, r1z)
        if state_bf16:
            # the kernel's stores of the carries (idempotent on a ray whose
            # carries did not change)
            r0x, r0y, r0z, r1x, r1y, r1z = (
                v.to(torch.bfloat16).float() for v in (r0x, r0y, r0z, r1x, r1y, r1z))
        return (ox, oy, oz, dx, dy, dz, r0x, r0y, r0z, r1x, r1y, r1z,
                act_hit & alive, prev_pdf, lt_S, pf_model, pco, j_img)

    acc = [zero.clone() for _ in range(3)]
    one = torch.ones_like(zero)
    for s in range(spp):
        sample = sample_offset + s
        dx, dy, dz, j_img = eye(sample)
        # a camera ray carries density 0, chain ratio 0, chain-model density
        # 0, outgoing cosine 1 and its own camera importance
        state = (zero + camf[9], zero + camf[10], zero + camf[11], dx, dy, dz,
                 zero, zero, zero, one, one, one, in_image,
                 zero, zero, zero, one, j_img)
        # a path ends when it dies or is still alive after max_bounces
        # bounces (it keeps its radiance, no background term); the first
        # bounce always runs
        b = 0
        lane_b = torch.zeros(n_local, dtype=torch.int64, device=device)
        hits = []   # per bounce, the lanes whose sweep hit (a bounce stored)
        while True:
            if stats is not None:
                stats["path_bounces"] = (stats.get("path_bounces", 0)
                                         + int(state[12].sum()))
            if lane_tally is not None:
                lane_b += state[12]
            state = bounce(state, sample, b)
            b += 1
            if b >= max_bounces or not bool(state[12].any()):
                break
        if lane_tally is not None:
            tally, lane0 = lane_tally
            tally.add(s, lane0, lane_b, torch.stack(hits).sum(0))
        for c in range(3):
            r0 = state[6 + c]
            if clamp_v > 0.0:
                r0 = torch.clamp_max(r0, clamp_v)
            acc[c] = acc[c] + r0
    if stats is not None:
        stats["paths"] = stats.get("paths", 0) + int(in_image.sum()) * spp
    return torch.stack(acc, -1)


# Rays x primitives entries the plain version holds per tensor at most;
# larger renders are cut into independent pixel ranges.
_PLAIN_CHUNK_ENTRIES = 1 << 25


def _check_render_args(packed, width, height, spp, max_bounces,
                       pixel_offset, n_local, sample_offset, seed):
    if not isinstance(packed, PackedScene):
        raise TypeError("packed must be a PackedScene (see pack_scene)")
    for name, v in (("width", width), ("height", height), ("spp", spp),
                    ("n_local", n_local)):
        if int(v) != v or v < 1:
            raise ValueError(f"{name} must be a positive integer, got {v!r}")
    if int(max_bounces) != max_bounces or max_bounces < 0:
        raise ValueError(f"max_bounces must be >= 0, got {max_bounces!r}")
    for name, v in (("pixel_offset", pixel_offset),
                    ("sample_offset", sample_offset)):
        if int(v) != v or not 0 <= v < 2 ** 31:
            raise ValueError(f"{name} must be in [0, 2**31), got {v!r}")
    if width * height >= 2 ** 31 or pixel_offset + n_local >= 2 ** 31:
        raise ValueError("pixel indices must fit int32")
    if sample_offset + spp >= 2 ** 31:
        raise ValueError("sample indices must fit int32")
    if not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed must fit int32, got {seed!r}")


def render_block_sums_plain(packed: PackedScene, cam_params, seed: int,
                            width: int, height: int, spp: int,
                            max_bounces: int, pixel_offset: int, n_local: int,
                            sample_offset: int = 0, sample_clamp: float = 0.0,
                            stats: Optional[dict] = None,
                            physical: bool = False,
                            bidir_nu: Optional[float] = None,
                            packed_grid: Optional[PackedGrid] = None,
                            state_bf16: bool = False,
                            k2_capacity: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch radiance sums ``[n_local, 3]`` for the pixel range
    ``[pixel_offset, pixel_offset + n_local)``, on the tables' device.
    ``stats`` as ``render_megakernel_plain`` fills it; ``k2_capacity``: the
    slots of the backward kernel's checkpoint stacks that its tally assumes
    (default: max(max_bounces, 1) * spp, one round)."""
    _check_render_args(packed, width, height, spp, max_bounces, pixel_offset,
                       n_local, sample_offset, seed)
    _check_variant(physical, bidir_nu)
    _check_grid(packed, packed_grid)
    cam = _cam_tensor(cam_params, packed.device)
    prims = max(packed.counts[0] + packed.counts[1], 1)
    chunk = max(1, _PLAIN_CHUNK_ENTRIES // prims)
    tally = None
    if stats is not None:
        span = max(max_bounces, 1)
        tally = _LaneTally(n_local, spp, span,
                           span * spp if k2_capacity is None else k2_capacity,
                           packed.device)
    parts = [
        _render_sums_plain(packed, cam, float(sample_clamp), int(seed),
                           width, height, spp,
                           max_bounces, pixel_offset + start,
                           min(chunk, n_local - start), sample_offset, stats,
                           physical, bidir_nu, packed_grid, bool(state_bf16),
                           None if tally is None else (tally, start))
        for start in range(0, n_local, chunk)]
    if tally is not None:
        for key, count in tally.counts().items():
            stats[key] = stats.get(key, 0) + count
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


class _LaneTally:
    """The loop iterations the kernels' 32-lane warps of consecutive threads
    run over the paths of a pixel range, from each path's sweeps f (a
    miss included) and stored bounces r (the sweeps that hit).

    K1 nested: a warp runs each sample as long as its longest path (sum over
    samples of the max over lanes of f); regenerating, as long as its
    busiest lane (max over lanes of the sum of f over samples). K2 runs a
    replay of f and a reverse sweep of r iterations per path. Nested, each
    sample costs the warp's longest replay plus its longest reverse sweep;
    in two flat passes, each round costs the most replay iterations one lane
    makes in it plus the most reverse iterations. A lane starts a path in
    the current round only while ``capacity - slots in use >= span``, else
    it opens a new round with an empty stack (csrc: backward_pixel)."""

    def __init__(self, n_lanes: int, spp: int, span: int, capacity: int,
                 device):
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)

        self.warps = (n_lanes + 31) // 32
        self.span, self.capacity = span, capacity
        self.warp = torch.arange(n_lanes, device=device) // 32
        self.f_max, self.r_max = zeros(spp, self.warps), zeros(spp, self.warps)
        self.f_sum = zeros(n_lanes)
        self.stored = 0
        # K2's rounds: per lane its stack top, round, and the round's replay
        # and reverse iterations; per (round, warp) the most of each
        self.top, self.round = zeros(n_lanes), zeros(n_lanes)
        self.p1, self.p2 = zeros(n_lanes), zeros(n_lanes)
        self.p1_max, self.p2_max = zeros(spp * self.warps), zeros(spp * self.warps)

    def _close(self, lanes: torch.Tensor) -> None:
        """The rounds of ``lanes`` end: their iterations into the maxima."""
        idx = self.round[lanes] * self.warps + self.warp[lanes]
        self.p1_max.scatter_reduce_(0, idx, self.p1[lanes], "amax")
        self.p2_max.scatter_reduce_(0, idx, self.p2[lanes], "amax")

    def add(self, s: int, lane0: int, f: torch.Tensor, r: torch.Tensor) -> None:
        """Sample s of lanes lane0.. took f sweeps and stored r bounces."""
        lanes = lane0 + torch.arange(f.numel(), device=f.device)
        warp = self.warp[lanes]
        self.f_max[s].scatter_reduce_(0, warp, f, "amax")
        self.r_max[s].scatter_reduce_(0, warp, r, "amax")
        self.f_sum[lanes] += f
        self.stored += int(r.sum())
        full = lanes[self.capacity - self.top[lanes] < self.span]
        self._close(full)
        self.round[full] += 1
        self.top[full] = 0
        self.p1[full] = 0
        self.p2[full] = 0
        self.top[lanes] += r
        self.p1[lanes] += f
        self.p2[lanes] += r

    def counts(self) -> dict:
        self._close(torch.arange(self.f_sum.numel(), device=self.f_sum.device))
        busiest = torch.zeros(self.warps, dtype=torch.int64, device=self.f_sum.device)
        busiest.scatter_reduce_(0, self.warp, self.f_sum, "amax")
        return {"warp_iterations": int(busiest.sum()),
                "warp_iterations_nested": int(self.f_max.sum()),
                "stored_bounces": self.stored,
                "k2_warp_iterations": int(self.p1_max.sum() + self.p2_max.sum()),
                "k2_warp_iterations_nested": int(self.f_max.sum() + self.r_max.sum())}


def render_megakernel_plain(packed: PackedScene, cam_params, seed: int,
                            width: int, height: int, spp: int,
                            max_bounces: int = 15, sample_clamp: float = 0.0,
                            sample_offset: int = 0,
                            stats: Optional[dict] = None,
                            physical: bool = False,
                            bidir_nu: Optional[float] = None,
                            packed_grid: Optional[PackedGrid] = None,
                            state_bf16: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the megakernel: mean radiance
    ``[H, W, 3]`` (row 0 = bottom) on whatever device the packed tables are
    on. ``stats``, when a dict, receives ``paths``, ``path_bounces`` (sweeps
    for the nearest hit), ``shadow_rays`` (shadow sweeps whose result can
    change the image) and ``shadow_rays_occluded``, on a textured scene
    ``triangle_hits`` (hits on a triangle), on a textured scene
    ``tex_sphere_hits`` / ``tex_triangle_hits`` (texture blocks run) and
    ``color_fetches`` / ``normal_fetches``, and with ``packed_grid``
    ``grid_slab_tests`` / ``grid_sphere_tests`` / ``grid_triangle_tests``
    (the grid sweeps' box gates and primitive tests on those sweeps) — the
    operation count behind the kernel's bound — and ``warp_iterations`` /
    ``warp_iterations_nested``: the loop iterations the kernel's 32-lane
    warps of consecutive pixels issue with per-lane path regeneration (per
    warp, the most bounces one lane makes over all samples) and with a loop
    over samples around a loop over bounces (per warp and sample, the most
    bounces one lane makes). ``path_bounces`` over 32 times either is that
    schedule's lane efficiency. The backward kernel replays the same paths:
    ``stored_bounces`` (the sweeps that hit, which its reverse sweep
    visits) and ``k2_warp_iterations`` / ``k2_warp_iterations_nested``, its
    warps' iterations over both passes in its two flat passes and in the
    nested loops (``_LaneTally``); ``path_bounces + stored_bounces`` over 32
    times either is its lane efficiency."""
    n = width * height
    sums = render_block_sums_plain(packed, cam_params, seed, width, height,
                                   spp, max_bounces, 0, n, sample_offset,
                                   sample_clamp, stats, physical, bidir_nu,
                                   packed_grid, state_bf16)
    return (sums / spp).reshape(height, width, 3)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _kernel_fn(fmad: bool = False):
    """(library, launch function) of the built kernel library — built at
    first use by utils/build.py — with the function's C types declared."""
    from ...utils.build import load_kernels

    lib = load_kernels("megakernel", fmad=fmad)
    fn = lib.cpt_render_megakernel
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, ci, vp, ci, vp, ci, vp, ci, vp,   # tables
                   vp, vp, vp, vp, ci,                           # textures
                   vp, vp, ctypes.POINTER(ctypes.c_int),         # grid
                   ctypes.POINTER(ctypes.c_float),               # camera
                   ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,       # scalars
                   vp, vp]                                       # out, stream
    fn.restype = ci
    lib.cpt_error_string.argtypes = [ci]
    lib.cpt_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_tables(packed: PackedScene):
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs tables on a CUDA device, "
                         f"got {device}")
    want = (("spheres", S_COLS), ("triangles", T_COLS), ("materials", M_COLS),
            ("point_lights", PL_COLS), ("area_lights", AL_COLS))
    rows = packed.counts
    for (name, cols), count in zip(want, rows):
        t = getattr(packed, name)
        if t.dtype != torch.float32 or t.device != device:
            raise TypeError(f"{name}: need float32 on {device}, got "
                            f"{t.dtype} on {t.device}")
        if t.ndim != 2 or t.shape[1] != cols or t.shape[0] != max(count, 1):
            raise ValueError(f"{name}: need shape [{max(count, 1)}, {cols}], "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: table must be contiguous")
    bg = packed.background
    if (bg.dtype != torch.float32 or bg.device != device
            or tuple(bg.shape) != (3,) or not bg.is_contiguous()):
        raise ValueError("background: need a contiguous float32 [3] on "
                         f"{device}")
    if rows[2] < 1:
        raise ValueError("materials: need at least one material")
    if packed.textured:
        num_tex, texels = packed.tex_counts
        for name, shape in (("tex_atlas", (texels, 3)), ("tex_meta", (num_tex, 3)),
                            ("tex_triuv", (max(rows[1], 1), 6)),
                            ("tex_matids", (rows[2], 2))):
            t = getattr(packed, name)
            if (t is None or t.dtype != torch.float32 or t.device != device
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"{name}: need a contiguous float32 {list(shape)} "
                                 f"on {device}")


def _check_grid(packed: PackedScene, grid: Optional[PackedGrid]):
    if grid is None:
        return
    if not isinstance(grid, PackedGrid):
        raise TypeError("packed_grid must be a PackedGrid (see pack_grid)")
    if len(grid.meta) != 9:
        raise ValueError("packed grid meta must be (rx, ry, rz, F, sc_off, "
                         "gs_off, n_gs, gt_off, n_gt): re-pack with pack_grid()")
    if grid.device != packed.device:
        raise ValueError(f"the grid is on {grid.device}, the tables on "
                         f"{packed.device}: pack both for one device")
    if (grid.idx.dtype != torch.int32 or grid.scal.dtype != torch.float32
            or grid.scal.shape != (8,) or grid.idx.ndim != 1
            or not grid.idx.is_contiguous() or not grid.scal.is_contiguous()):
        raise ValueError("packed grid: need a contiguous int32 idx and a float32 "
                         "scal[8]")


def grid_args(grid: Optional[PackedGrid]):
    """The grid arguments of the kernels' C entries: the CSR table and the
    scalars (device pointers) and the nine meta ints; null pointers for
    linear sweeps."""
    if grid is None:
        return (None, None, None)
    return (grid.idx.data_ptr(), grid.scal.data_ptr(),
            (ctypes.c_int * 9)(*grid.meta))


def tex_args(packed: PackedScene):
    """The texture arguments of the kernels' C entries: four table pointers
    and the texture count; null pointers and 0 for an untextured scene."""
    if not packed.textured:
        return (None, None, None, None, 0)
    return tuple(t.detach().data_ptr() for t in packed.tex_tables()) + (
        packed.tex_counts[0],)


def render_block_sums_cuda(packed: PackedScene, cam_params, seed: int,
                           width: int, height: int, spp: int,
                           max_bounces: int, pixel_offset: int, n_local: int,
                           sample_offset: int = 0, sample_clamp: float = 0.0,
                           fmad: bool = False, physical: bool = False,
                           bidir_nu: Optional[float] = None,
                           packed_grid: Optional[PackedGrid] = None,
                           state_bf16: bool = False) -> torch.Tensor:
    """Launch the CUDA megakernel: radiance sums ``[n_local, 3]`` float32
    for the pixel range ``[pixel_offset, pixel_offset + n_local)``. Launches
    on the current stream of the tables' device and does not synchronise;
    raises if the kernel does not build or the launch is refused.
    ``physical`` / ``bidir_nu`` pick the kernel's estimator, a textured scene
    its textured instantiation, ``packed_grid`` its grid instantiation;
    ``state_bf16`` stores the carries as bfloat16.
    ``fmad=True`` selects the build that lets the compiler contract
    ``a*b+c`` (measurement only; the default build does not)."""
    global LAUNCH_COUNT
    with span("k1.launch"):
        _check_render_args(packed, width, height, spp, max_bounces,
                           pixel_offset, n_local, sample_offset, seed)
        variant = _check_variant(physical, bidir_nu)
        _check_tables(packed)
        _check_grid(packed, packed_grid)
        lib, fn = _kernel_fn(fmad)
        cam = _cam_table(cam_params, sample_clamp, bidir_nu)
        cam_c = (ctypes.c_float * CAM_FLOATS)(*cam.tolist())
        num_s, num_t, num_m, num_pl, num_al = packed.counts
        with torch.cuda.device(packed.device):
            out = torch.empty((n_local, 3), dtype=torch.float32,
                              device=packed.device)
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(packed.spheres.data_ptr(), num_s,
                     packed.triangles.data_ptr(), num_t,
                     packed.materials.data_ptr(), num_m,
                     packed.point_lights.data_ptr(), num_pl,
                     packed.area_lights.data_ptr(), num_al,
                     packed.background.data_ptr(), *tex_args(packed),
                     *grid_args(packed_grid), cam_c,
                     int(seed), int(pixel_offset), int(n_local),
                     int(sample_offset), int(spp), int(max_bounces),
                     int(width), int(height), variant, int(bool(state_bf16)),
                     out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("megakernel launch failed: CUDA error "
                               f"{err} ({lib.cpt_error_string(err).decode()})")
        LAUNCH_COUNT += 1
        LAUNCHES_BY_VARIANT[variant] += 1
        if packed.textured:
            LAUNCHES_TEXTURED[variant] += 1
        if packed_grid is not None:
            LAUNCHES_GRID[variant] += 1
        if state_bf16:
            LAUNCHES_BF16[variant] += 1
        return out


def render_occupancy(packed: PackedScene, physical: bool = False,
                     bidir_nu: Optional[float] = None,
                     packed_grid: Optional[PackedGrid] = None,
                     state_bf16: bool = False) -> dict:
    """What a launch of the kernel on ``packed`` gets on the current CUDA
    device: ``blocks_per_sm`` (resident blocks of 128 threads), ``registers``
    per thread of the instantiation, and ``smem_bytes``, the scene's small
    tables copied into each block's shared memory (0: they are read from
    global memory, because they exceed 48 KB or would cost a resident
    block)."""
    variant = _check_variant(physical, bidir_nu)
    lib, _ = _kernel_fn()
    fn = lib.cpt_render_occupancy
    ci = ctypes.c_int
    fn.argtypes = [ci] * 10 + [ctypes.POINTER(ci)] * 2
    fn.restype = ci
    smem, regs = ci(0), ci(0)
    blocks = fn(variant, int(packed.textured), int(packed_grid is not None),
                int(bool(state_bf16)), *packed.counts, packed.tex_counts[0],
                ctypes.byref(smem), ctypes.byref(regs))
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-blocks} "
                           f"({lib.cpt_error_string(-blocks).decode()})")
    return {"blocks_per_sm": blocks, "registers": regs.value,
            "smem_bytes": smem.value}


def uniform_pairs_cuda(seed: torch.Tensor, pixel: torch.Tensor,
                       sample: torch.Tensor, pair: torch.Tensor):
    """Debug entry of the kernel library: ``uniform_pair`` as the CUDA code
    computes it, elementwise over four equal-length int32 CUDA tensors —
    held bit-equal against ``utils/rng.py`` to localise a fault."""
    args = (seed, pixel, sample, pair)
    n = seed.numel()
    for t in args:
        if (t.dtype != torch.int32 or t.device.type != "cuda"
                or t.device != seed.device or t.ndim != 1 or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError("need four contiguous 1-D int32 tensors of one "
                             "length on one CUDA device")
    lib, _ = _kernel_fn()
    fn = lib.cpt_uniform_pairs
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp, vp]
    fn.restype = ctypes.c_int
    with torch.cuda.device(seed.device):
        u0 = torch.empty(n, dtype=torch.float32, device=seed.device)
        u1 = torch.empty_like(u0)
        err = fn(*(t.data_ptr() for t in args), n, u0.data_ptr(),
                 u1.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("uniform_pairs launch failed: CUDA error "
                           f"{err} ({lib.cpt_error_string(err).decode()})")
    return u0, u1


def render_block_sums(packed: PackedScene, cam_params, seed: int, width: int,
                      height: int, spp: int, max_bounces: int,
                      pixel_offset: int, n_local: int, sample_offset: int = 0,
                      sample_clamp: float = 0.0, physical: bool = False,
                      bidir_nu: Optional[float] = None,
                      packed_grid: Optional[PackedGrid] = None,
                      state_bf16: bool = False) -> torch.Tensor:
    """Radiance SUMS over spp for ``n_local`` pixels starting at flat index
    ``pixel_offset``. ``sample_offset`` selects the global sample range
    [offset, offset+spp) of each pixel's counter stream — progressive passes
    and tiles continue the exact streams a monolithic render would use.
    CUDA tables go to the kernel; CPU tables to the plain version."""
    kw = dict(physical=physical, bidir_nu=bidir_nu, packed_grid=packed_grid,
              state_bf16=state_bf16)
    if packed.device.type == "cuda":
        return render_block_sums_cuda(packed, cam_params, seed, width, height,
                                      spp, max_bounces, pixel_offset, n_local,
                                      sample_offset, sample_clamp, **kw)
    return render_block_sums_plain(packed, cam_params, seed, width, height,
                                   spp, max_bounces, pixel_offset, n_local,
                                   sample_offset, sample_clamp, **kw)


def render_megakernel(packed: PackedScene, cam_params, seed: int,
                      width: int, height: int, spp: int,
                      max_bounces: int = 15, sample_clamp: float = 0.0,
                      sample_offset: int = 0, packed_grid=None,
                      physical: bool = False, state_bf16: bool = False,
                      bidir_nu: Optional[float] = None) -> torch.Tensor:
    """Full render in one kernel launch; returns mean radiance ``[H, W, 3]``
    (row 0 = bottom) on the packed tables' device. ``sample_clamp > 0``
    clamps every sample's radiance to that value before accumulation (the
    reference's per-frame [0,1] clamp; firefly control). ``physical=True``
    runs the unbiased MIS estimator; ``bidir_nu`` (with ``physical``) weights
    it against ``bidir_nu`` light paths per eye sample — the eye half of
    ``render/bidir.py``. ``packed_grid`` (``pack_grid(build_grid(scene))`` on
    the tables' device) sweeps through the supercell grid: the same image,
    less work per ray on a large scene. ``state_bf16`` stores the radiance /
    throughput carries as bfloat16 between bounces (another image: the
    storage precision changes, the arithmetic stays float32)."""
    n = width * height
    sums = render_block_sums(packed, cam_params, seed, width, height, spp,
                             max_bounces, 0, n, sample_offset, sample_clamp,
                             physical=physical, bidir_nu=bidir_nu,
                             packed_grid=packed_grid, state_bf16=state_bf16)
    return (sums / spp).reshape(height, width, 3)


def render_megakernel_sharded(packed: PackedScene, cam_params, seed: int,
                              width: int, height: int, spp: int, mesh,
                              max_bounces: int = 15, sample_clamp: float = 0.0,
                              sample_offset: int = 0, packed_grid=None,
                              physical: bool = False, state_bf16: bool = False,
                              bidir_nu: Optional[float] = None) -> torch.Tensor:
    """``render_megakernel`` over ``mesh``'s pixel axis (``parallel.mesh``):
    each rank launches the kernel once on its tile of flat pixels (ceil(W*H /
    ranks) each, the last rank the remainder), writes the sums into a zero
    image and one psum over the pixel axis merges them before the division by
    ``spp`` — the single-device op order, so the image is bit-equal to
    ``render_megakernel``'s, on every rank. The tables must be on the
    mesh's device type."""
    n = width * height
    n_dev = axis_size(mesh, PIXEL_AXIS, "render_megakernel_sharded")
    check_device(mesh, packed.device, "render_megakernel_sharded")
    first, n_local = tile_range(n, n_dev, axis_index(mesh, PIXEL_AXIS))
    sums = render_block_sums(packed, cam_params, seed, width, height, spp,
                             max_bounces, first, n_local, sample_offset,
                             sample_clamp, physical=physical, bidir_nu=bidir_nu,
                             packed_grid=packed_grid, state_bf16=state_bf16)
    return (psum(in_full_image(sums, first, n), mesh, PIXEL_AXIS) / spp
            ).reshape(height, width, 3)


def render_fast2(scene, cam_params, width: int, height: int, spp: int,
                 seed: int, max_bounces: int = 15, sample_offset: int = 0,
                 grid=None, physical: bool = False,
                 device="cuda") -> torch.Tensor:
    """Convenience wrapper: pack + launch on ``device``. ``grid`` is an
    ``ops/grid.UniformGrid`` or an already packed ``PackedGrid``."""
    packed = pack_scene(scene, device)
    if grid is not None and not isinstance(grid, PackedGrid):
        grid = pack_grid(grid, device)
    return render_megakernel(packed, cam_params, seed, width, height, spp,
                             max_bounces=max_bounces,
                             sample_offset=sample_offset, packed_grid=grid,
                             physical=physical)
