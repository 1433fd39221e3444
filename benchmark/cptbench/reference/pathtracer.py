"""The benchmark's plain reference of the path tracer: what the port's
kernels compute, in plain PyTorch, for any list of paths.

A frozen copy of the port's plain version (``render_megakernel_plain`` and
the helpers it shares with the physical estimator, in
``cuda_path_tracer_ss_torch/ops/cuda/megakernel.py`` as of the benchmark's
first version), cut to what the benchmark's cells run: untextured scenes,
linear primitive sweeps, the reference-parity and the physical estimator.
It differs from that version in one way: it traces a list of paths, each
named by its (pixel, sample) pair, in one wavefront, where the plain version
loops over the samples of a range of pixels. The paths' random streams are
keyed by (seed, pixel, sample, pair) (``rng.py``), so any pixel's samples,
or a seeded share of a render's paths, are traced on their own and come out
as the kernel's.

Autograd through ``radiance`` is the reference's gradient: every discrete
decision (which primitive is hit, visibility, the scatter branch) is taken
outside the graph and the continuous factors are differentiated, as the
backward kernel does. ``state_bf16`` rounds the radiance and throughput
carries to bfloat16 after every bounce: the precision below the
configuration's float32, which the correctness control puts in the
program's place. ``tally`` counts the work behind the kernels' rooflines.

It imports torch and the benchmark's own ``rng`` only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from . import rng

RAY_BUMP_EPSILON = 1e-4
INV_PI = 0.31830988618
MIS_RATIO_CLAMP = 1e18
_TWO_PI = 2.0 * math.pi

# table row widths of the kernels' packed scene
S_COLS = 5
T_COLS = 19
M_COLS = 20
PL_COLS = 6
AL_COLS = 23


@dataclasses.dataclass(frozen=True)
class Tables:
    """The scene as the kernels read it, float32 rows on one device (the
    layout of the port's ``PackedScene``, untextured): spheres [S,5] = centre,
    radius, material; triangles [T,19] = v0, e1, e2, n0, n1, n2, material;
    materials [M,20]; point lights [Lp,6]; area lights [La,23] = two
    triangles' vertices, power, first triangle, material; background [3].
    An empty table holds one zero row; ``counts`` are the true row counts."""

    spheres: torch.Tensor
    triangles: torch.Tensor
    materials: torch.Tensor
    point_lights: torch.Tensor
    area_lights: torch.Tensor
    background: torch.Tensor
    counts: tuple


def pack(scene: Dict[str, torch.Tensor], device) -> Tables:
    """The scene arrays (keys as in the configuration's ``scene``: field
    names, materials as ``materials.<field>``) as the kernels' tables on
    ``device``. Built from ``torch.cat`` and indexing alone, so a field that
    requires grad keeps its graph."""
    f32 = torch.float32
    s = scene

    def flag(bits):
        return ((s["materials.flags"] & bits) != 0).to(f32)[:, None]

    spheres = torch.cat([s["sph_center"], s["sph_radius"][:, None],
                         s["sph_mat"][:, None].to(f32)], -1)
    tris = torch.cat([s["tri_v0"], s["tri_v1"] - s["tri_v0"],
                      s["tri_v2"] - s["tri_v0"], s["tri_n0"], s["tri_n1"],
                      s["tri_n2"], s["tri_mat"][:, None].to(f32)], -1)
    m = {k[len("materials."):]: v for k, v in s.items()
         if k.startswith("materials.")}
    mats = torch.cat([m["diffuse"], m["specular"], m["absorption"],
                      m["emission"], m["spec_exp"][:, None], m["ior"][:, None],
                      m["diff_avg"][:, None], m["spec_avg"][:, None],
                      m["refr_avg"][:, None], m["roughness"][:, None],
                      flag(0x01), flag(0x03)], -1)
    pls = torch.cat([s["pl_pos"], s["pl_power"]], -1)
    t0 = s["al_tri0"].long()
    t1 = t0 + 1
    v0, v1, v2 = s["tri_v0"], s["tri_v1"], s["tri_v2"]
    als = torch.cat([v0[t0], v1[t0], v2[t0], v0[t1], v1[t1], v2[t1],
                     s["al_power"], t0[:, None].to(f32),
                     s["tri_mat"][t0][:, None].to(f32)], -1)

    def put(a, cols):
        a = a.reshape(-1, cols)
        if not a.shape[0]:
            a = torch.cat([a.to(f32), torch.zeros((1, cols), dtype=f32,
                                                  device=a.device)])
        return a.to(device=device, dtype=f32).contiguous()

    counts = (int(s["sph_radius"].shape[0]), int(s["tri_mat"].shape[0]),
              int(m["flags"].shape[0]), int(s["pl_pos"].shape[0]),
              int(s["al_power"].shape[0]))
    return Tables(put(spheres, S_COLS), put(tris, T_COLS), put(mats, M_COLS),
                  put(pls, PL_COLS), put(als, AL_COLS),
                  s["background"].to(device=device, dtype=f32).contiguous(),
                  counts)


def cam_tensor(cam, device) -> torch.Tensor:
    """The camera (rotation [3,3], position [3], tan(fov/2), z_near) as 14
    float32 values on ``device``."""
    return torch.cat([torch.as_tensor(v, dtype=torch.float32,
                                      device=device).reshape(-1) for v in cam])


# ---------------------------------------------------------------------------
# Frozen copy of the plain version's elementwise helpers (unchanged).
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


# ---------------------------------------------------------------------------
# The sweeps and the wavefront over a list of paths.
# ---------------------------------------------------------------------------

def _make_sweeps(tb: Tables):
    """(intersect_sweep, occlusion_sweep): every primitive tested for every
    ray as a [rays, primitives] tensor. Tie rule of the kernels' sequential
    sweep: the LATER primitive wins an equal t, spheres before triangles.
    The winner is chosen outside autograd; its t and normal are then
    evaluated alone, so a gradient flows through the hit that was taken."""
    num_spheres, num_tris = tb.counts[0], tb.counts[1]
    sph = tb.spheres[:num_spheres]
    tri = tb.triangles[:num_tris]
    sph_c = [sph[:, k] for k in range(S_COLS)]
    tri_c = [tri[:, k] for k in range(T_COLS)]

    def col(v):
        return v[:, None]

    def sph_tests(ox, oy, oz, dx, dy, dz):
        return _sphere_t(col(ox), col(oy), col(oz), col(dx), col(dy), col(dz),
                         sph_c[0], sph_c[1], sph_c[2], sph_c[3])

    def tri_tests(ox, oy, oz, dx, dy, dz):
        return _triangle_t(col(ox), col(oy), col(oz), col(dx), col(dy),
                           col(dz), tri_c[0:3], tri_c[3:6], tri_c[6:9])

    def last_min(t, valid):
        tm = torch.where(valid, t, math.inf)
        best = tm.min(dim=1).values
        is_best = valid & (tm == col(best))
        idx = (t.shape[1] - 1
               - torch.flip(is_best, (1,)).to(torch.int8).argmax(dim=1))
        return best, idx, is_best.any(dim=1)

    def intersect_sweep(ox, oy, oz, dx, dy, dz):
        """(best_t, nx, ny, nz, material, primitive index as float32: sphere
        i is i, triangle j is S + j, a miss -1); a miss has t = inf."""
        n = ox.shape[0]
        inf = torch.full((n,), math.inf, dtype=torch.float32, device=ox.device)
        idx0 = torch.zeros((n,), dtype=torch.long, device=ox.device)
        with torch.no_grad():
            best_t, s_idx, t_idx = inf, idx0, idx0
            is_sph = is_tri = torch.zeros((n,), dtype=torch.bool,
                                          device=ox.device)
            if num_spheres:
                t, valid = sph_tests(ox, oy, oz, dx, dy, dz)
                bt, s_idx, is_sph = last_min(t, valid)
                best_t = torch.where(is_sph, bt, best_t)
            if num_tris:
                t, _, _, valid = tri_tests(ox, oy, oz, dx, dy, dz)
                bt, t_idx, found = last_min(t, valid)
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
            w0 = 1.0 - w1 - w2
            tnx = row[9] * w0 + row[12] * w1 + row[15] * w2
            tny = row[10] * w0 + row[13] * w1 + row[16] * w2
            tnz = row[11] * w0 + row[14] * w1 + row[17] * w2
            best_t = torch.where(is_tri, t, best_t)
            nx = torch.where(is_tri, tnx, nx)
            ny = torch.where(is_tri, tny, ny)
            nz = torch.where(is_tri, tnz, nz)
            mat = torch.where(is_tri, row[18].long(), mat)
        prim = torch.where(is_tri, num_spheres + t_idx,
                           torch.where(is_sph, s_idx, -1))
        return best_t, nx, ny, nz, mat, prim.to(torch.float32)

    @torch.no_grad()
    def occlusion_sweep(sox, soy, soz, wx, wy, wz, max_d):
        occ = torch.zeros(sox.shape, dtype=torch.bool, device=sox.device)
        if num_spheres:
            t, valid = sph_tests(sox, soy, soz, wx, wy, wz)
            occ = occ | (valid & (t <= col(max_d))).any(dim=1)
        if num_tris:
            t, _, _, valid = tri_tests(sox, soy, soz, wx, wy, wz)
            occ = occ | (valid & (t <= col(max_d))).any(dim=1)
        return occ

    return intersect_sweep, occlusion_sweep


def radiance(tb: Tables, cam: torch.Tensor, seed: int, width: int,
             height: int, pixel: torch.Tensor, sample: torch.Tensor,
             max_bounces: int, physical: bool = False,
             state_bf16: bool = False,
             tally: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Radiance ``[n, 3]`` of the n paths (``pixel[i]``, ``sample[i]``): flat
    pixel index (row 0 = bottom) and global sample index, int64 tensors on
    the tables' device. ``physical`` selects the unbiased MIS estimator.
    ``tally``, when a dict, receives the kernels' work on these paths:
    ``paths``, ``path_bounces`` (sweeps for the nearest hit),
    ``stored_bounces`` (of them, the sweeps that hit: the backward kernel's
    reverse sweep visits them), ``shadow_rays`` (shadow sweeps whose result
    can change the image) and ``shadow_rays_occluded``."""
    device = tb.spheres.device
    num_spheres, num_tris, _, num_pls, num_als = tb.counts
    camf = cam.unbind()
    z_near = camf[13]
    s_fov = -2.0 * camf[12]
    eps = RAY_BUMP_EPSILON
    intersect_sweep, occlusion_sweep = _make_sweeps(tb)
    mats = tb.materials
    pl_rows = [tb.point_lights[i].unbind() for i in range(num_pls)]
    al_rows = [tb.area_lights[i].unbind() for i in range(num_als)]
    bgf = tb.background.unbind()
    if physical:
        al_geoms = [_al_light_geom(row) for row in al_rows]
        pl_planes = [v for row in pl_rows for v in row]
        le_planes = [v for row in al_rows
                     for v in mats[int(row[22])][9:12].unbind()]
        al_t0f = [row[21] for row in al_rows]

    def count(key, mask):
        if tally is not None:
            tally[key] = tally.get(key, 0) + int(mask.sum())

    n = pixel.shape[0]
    pxi = (pixel % width).to(torch.float32)
    pyi = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    one = torch.ones_like(zero)

    def draw(pair):
        return rng.uniform_pair(seed, pixel, sample, pair)

    # the jittered pinhole eye ray
    ju, jv = draw(rng.PAIR_EYE)
    sx = ((pxi + ju) * (1.0 / width) - 0.5) * s_fov * z_near
    sy = ((pyi + jv) * (1.0 / height) - 0.5) * s_fov * z_near * (height / width)
    sz = zero + z_near
    dx, dy, dz = _normalize3(camf[0] * sx + camf[1] * sy + camf[2] * sz,
                             camf[3] * sx + camf[4] * sy + camf[5] * sz,
                             camf[6] * sx + camf[7] * sy + camf[8] * sz)
    ox, oy, oz = zero + camf[9], zero + camf[10], zero + camf[11]
    r0x = r0y = r0z = zero
    r1x = r1y = r1z = one
    active = torch.ones(n, dtype=torch.bool, device=device)
    prev_pdf = zero
    count("paths", active)

    # a path ends when it dies or is still alive after max_bounces bounces
    # (it keeps its radiance, no background term); the first bounce always runs
    for b_cur in range(max(max_bounces, 1)):
        count("path_bounces", active)
        pair0 = rng.pair_base(b_cur, num_als)
        best_t, nx, ny, nz, mat, prim_f = intersect_sweep(ox, oy, oz,
                                                          dx, dy, dz)
        hit = best_t < math.inf
        t_safe = torch.where(hit, best_t, 0.0)
        px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
        mrow = mats[mat]
        mf = tuple(mrow[:, f] for f in range(M_COLS))
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
            needed = active & hit & (~inside) & (cos_l > 0.0) & (m_pd > 0.0)
            occ = occlusion_sweep(px + nx * eps, py + ny * eps, pz + nz * eps,
                                  wx, wy, wz, dist - 2.0 * eps)
            count("shadow_rays", needed)
            count("shadow_rays_occluded", needed & occ)
            scale = (torch.where(occ, 0.0, cos_l) * m_pd * INV_PI
                     / (4.0 * math.pi) / d2)
            return pwx * m_dr * scale, pwy * m_dg * scale, pwz * m_db * scale

        def parity_direct():
            dir_r, dir_g, dir_b = m_er, m_eg, m_eb
            for i in range(num_pls):
                p = pl_rows[i]
                cr, cg, cb = light_contribution(zero + p[0], zero + p[1],
                                                zero + p[2], p[3], p[4], p[5])
                dir_r = dir_r + torch.where(inside, 0.0, cr)
                dir_g = dir_g + torch.where(inside, 0.0, cg)
                dir_b = dir_b + torch.where(inside, 0.0, cb)
            for i in range(num_als):
                u1, u2 = draw(pair0 + 2 + 2 * i)
                u3, upick = draw(pair0 + 3 + 2 * i)
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

        def physical_direct(lb):
            nux, nuy, nuz = lb["n_unit"]
            al_draws = []
            for i in range(num_als):
                u1, u2 = draw(pair0 + 2 + 2 * i)
                _u3, upick = draw(pair0 + 3 + 2 * i)
                al_draws.append((u1, u2, upick))

            def occ_of(lx, ly, lz):
                wx, wy, wz, _d2, dist = _light_direction(lx, ly, lz,
                                                         px, py, pz)
                if tally is not None:
                    s_d, p_g, s_ct, _p, _c = _lobe_terms(
                        lb, dx, dy, dz, nx, ny, nz, wx, wy, wz)
                    needed = (active & hit & (~inside)
                              & ((s_d != 0.0) | (p_g != 0.0) | (s_ct != 0.0)))
                occ = occlusion_sweep(px + nux * eps, py + nuy * eps,
                                      pz + nuz * eps, wx, wy, wz,
                                      dist - 2.0 * eps)
                if tally is not None:
                    count("shadow_rays", needed)
                    count("shadow_rays_occluded", needed & occ)
                return occ

            occ_pl = [occ_of(zero + p[0], zero + p[1], zero + p[2])
                      for p in pl_rows]
            occ_al = [occ_of(*_al_sample_point(al_geoms[i], *al_draws[i])[0])
                      for i in range(num_als)]
            t_w = torch.where(hit, best_t, 1.0)
            return _physical_direct(
                num_spheres, num_pls, num_als, px, py, pz, nx, ny, nz,
                dx, dy, dz, t_w, prev_pdf, lb, mf, pl_planes, le_planes,
                al_geoms, al_draws, occ_pl, occ_al, prim_f, al_t0f)

        if physical:
            lb = _physical_lobes(dx, dy, dz, nx, ny, nz, cos_i, mf)
            dir_r, dir_g, dir_b = physical_direct(lb)
        else:
            dir_r, dir_g, dir_b = parity_direct()

        act_hit = active & hit
        count("stored_bounces", act_hit)
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

        u_branch, u_a = draw(pair0)
        u_b, _unused = draw(pair0 + 1)
        (new_ox, new_oy, new_oz, new_dx, new_dy, new_dz, wr, wg, wb,
         alive, take_diff, take_spec, _take_refr, _tir, ct_m,
         _ctw) = _scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz,
                                 cos_i, u_branch, u_a, u_b, mf)
        if physical:
            nd = [torch.where(alive, v, 0.0) for v in (new_dx, new_dy, new_dz)]
            pdf_new = _physical_prev_pdf(lb, dx, dy, dz, *nd, take_diff,
                                         take_spec & (~ct_m), take_spec & ct_m)
            prev_pdf = torch.where(act_hit,
                                   torch.where(~inside, pdf_new, 0.0),
                                   prev_pdf)
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
            r0x, r0y, r0z, r1x, r1y, r1z = (
                v.to(torch.bfloat16).float()
                for v in (r0x, r0y, r0z, r1x, r1y, r1z))
        active = act_hit & alive
        if not bool(active.any()):
            break
    return torch.stack([r0x, r0y, r0z], -1)
