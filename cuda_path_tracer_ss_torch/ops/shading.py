"""Next-event estimation (direct lighting) of the eager engine.

The counterpart of the JAX package's ``ops/shading.py``
(``CudaTracer/CudaTracer.cu:345-455``). ``shade`` keeps the reference's
estimator quirks: area lights use the point-light ``power/(4 pi d^2)``
falloff with no light-side cosine or area pdf, only the diffuse lobe
receives NEE, and area-light points come from the center-biased
three-normalized-uniforms scheme with a 50/50 pick between the light's two
triangles. ``shade_physical`` is the unbiased estimator's NEE: uniform-area
light sampling in the correct measure with power-heuristic MIS weights
against the diffuse, Phong and Cook-Torrance lobes, and (``bidir``) the
light tracer's camera connection; every competing ratio is clamped at
``MIS_RATIO_CLAMP`` before it is squared.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..constants import INV_PI, MIS_RATIO_CLAMP, RAY_BUMP_EPSILON
from .intersect import any_hit
from .sampling import beckmann_pdf, phong_pdf
from .vec import Vec3, gather, where as vwhere

_EPS = 1e-12

# RNG rows consumed per area light: 3 barycentric + 1 triangle pick.
UNIFORMS_PER_AREA_LIGHT = 4


def _shadow_query(scene, point: Vec3, normal: Vec3, light_point: Vec3,
                  grid=None):
    """Shadow ray toward one light sample: epsilon-bumped origin, distance
    shortened by 2 epsilon, any-hit occlusion. Returns (visible, w_i, dist2)
    with dist2 clamped away from zero; ``grid`` walks the DDA instead."""
    offset = light_point - point
    dist2 = torch.clamp_min(offset.norm2(), _EPS)
    dist = torch.sqrt(dist2)
    w_i = offset * (1.0 / dist)
    origin = point + normal * RAY_BUMP_EPSILON
    max_d = dist - 2.0 * RAY_BUMP_EPSILON
    if grid is None:
        visible = ~any_hit(origin, w_i, max_d, scene)
    else:
        from .grid import any_hit_grid
        visible = ~any_hit_grid(origin, w_i, max_d, scene, grid)
    return visible, w_i, dist2


def _light_contribution(scene, point: Vec3, normal: Vec3, diffuse: Vec3,
                        diff_avg, light_point: Vec3, power: Vec3, grid=None):
    """Shadow ray + the reference's point-source falloff."""
    visible, w_i, dist2 = _shadow_query(scene, point, normal, light_point,
                                        grid=grid)
    l_i = power * (1.0 / (4.0 * math.pi * dist2))
    cos_l = torch.clamp_min(normal.dot(w_i), 0.0)
    scale = torch.where(visible, cos_l, 0.0) * diff_avg * INV_PI
    return l_i * diffuse * scale


def _row(table: torch.Tensor, i: int) -> Vec3:
    return Vec3(table[i, 0], table[i, 1], table[i, 2])


def shade(scene, point: Vec3, normal: Vec3, diffuse: Vec3, diff_avg,
          uniforms, grid=None) -> Vec3:
    """Direct radiance at each surfel from all point and area lights;
    ``uniforms`` is the ``[4 * num_area_lights, N]`` block, 4 rows per area
    light."""
    radiance = Vec3.zeros(point.x.shape, like=point.x)
    for i in range(scene.num_point_lights):
        radiance = radiance + _light_contribution(
            scene, point, normal, diffuse, diff_avg, _row(scene.pl_pos, i),
            _row(scene.pl_power, i), grid=grid)
    for li in range(scene.num_area_lights):
        u1, u2, u3, upick = (uniforms[UNIFORMS_PER_AREA_LIGHT * li + k]
                             for k in range(4))
        light_point = area_light_point(scene, li, u1, u2, u3, upick)
        radiance = radiance + _light_contribution(
            scene, point, normal, diffuse, diff_avg, light_point,
            _row(scene.al_power, li), grid=grid)
    return radiance


def area_light_point(scene, light_idx: int, u1, u2, u3, upick) -> Vec3:
    """A point on area light ``light_idx`` by the reference's center-biased
    scheme: three uniforms normalized into barycentric weights, a 50/50
    triangle pick (u > 0.5 -> the first)."""
    inv_total = 1.0 / torch.clamp_min(u1 + u2 + u3, _EPS)
    w0, w1, w2 = u1 * inv_total, u2 * inv_total, u3 * inv_total
    tri0 = scene.al_tri0[light_idx].long()
    tri = torch.where(upick > 0.5, tri0, tri0 + 1)
    return (gather(scene.tri_v0, tri) * w0 + gather(scene.tri_v1, tri) * w1
            + gather(scene.tri_v2, tri) * w2)


# ---------------------------------------------------------------------------
# The unbiased estimator's direct lighting (physical=True).
# ---------------------------------------------------------------------------

def _tri_area_normal(scene, tri):
    """(area, raw geometric normal, verts) of triangle ``tri``."""
    v0, v1, v2 = (gather(scene.tri_v0, tri), gather(scene.tri_v1, tri),
                  gather(scene.tri_v2, tri))
    n_raw = (v1 - v0).cross(v2 - v0)
    area = 0.5 * torch.sqrt(torch.clamp_min(n_raw.norm2(), _EPS))
    return area, n_raw, (v0, v1, v2)


def area_light_sample_uniform(scene, light_idx: int, u1, u2, upick):
    """Uniform-area sample on area light ``light_idx`` (a triangle picked in
    proportion to its area, sqrt-reparameterized barycentrics). Returns
    (point, unit geometric normal, total light area, emitted radiance = the
    light triangles' material emission)."""
    tri0 = scene.al_tri0[light_idx].long()
    area0, n0_raw, (a0, b0, c0) = _tri_area_normal(scene, tri0)
    area1, n1_raw, (a1, b1, c1) = _tri_area_normal(scene, tri0 + 1)
    total = area0 + area1
    first = upick < (area0 / total)

    va, vb, vc = vwhere(first, a0, a1), vwhere(first, b0, b1), vwhere(first, c0, c1)
    n_l = vwhere(first, n0_raw, n1_raw).normalize(eps=_EPS)

    su = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
    w0 = 1.0 - su
    w1 = su * (1.0 - u2)
    w2 = su * u2
    point = va * w0 + vb * w1 + vc * w2

    mat = scene.tri_mat[tri0].long()  # both halves share the light material
    return point, n_l, total, gather(scene.materials.emission, mat)


def light_areas(scene) -> torch.Tensor:
    """``[num_triangles]``: 0 for non-emitting triangles, else the owning
    area light's total area (both halves)."""
    areas = torch.zeros((scene.num_triangles,), dtype=torch.float32,
                        device=scene.tri_v0.device)
    for li in range(scene.num_area_lights):
        tri0 = scene.al_tri0[li].long()
        t0, _, _ = _tri_area_normal(scene, tri0)
        t1, _, _ = _tri_area_normal(scene, tri0 + 1)
        total = t0 + t1
        idx = torch.stack([tri0, tri0 + 1])
        areas = areas.index_put((idx,), torch.stack([total, total]))
    return areas


class GlossLobe(NamedTuple):
    """The Phong glossy lobe at each surfel, as ``shade_physical`` needs it
    to light-sample it."""

    axis: Vec3              # unit lobe axis
    exponent: torch.Tensor  # Phong exponent (inf == delta mirror: pdf 0)
    weight: Vec3            # branch albedo (the material's specular color)
    prob: torch.Tensor      # branch probability (0 where Cook-Torrance)


class CTLobe(NamedTuple):
    """The Cook-Torrance (Beckmann) lobe at each surfel: the sampler's
    reflection branch h = normalize(w - d) with density
    beckmann_pdf(h) / (4 |d.h|) and weight specular * G(h) / nv."""

    axis: Vec3                # unit lobe axis (phong_lobe_axis of the normal)
    roughness: torch.Tensor   # 0 == delta mirror: pdf 0
    weight: Vec3              # the material's specular color
    prob: torch.Tensor        # branch probability, 0 where mirror / Phong
    d: Vec3                   # incoming ray direction
    normal: Vec3              # RAW surfel normal
    nv: torch.Tensor          # max(|cos_i|, 1e-6)


def ct_lobe_terms(ct: CTLobe, w: Vec3):
    """(implied f*cos toward ``w``, density p_ct) of the Cook-Torrance
    lobe's reflection branch."""
    h = (w - ct.d).normalize(eps=_EPS)
    dh = torch.clamp_min(torch.abs(ct.d.dot(h)), _EPS)
    p_dir = beckmann_pdf(ct.axis, ct.roughness, h) / (4.0 * dh)
    p_ct = ct.prob * p_dir
    nh = torch.abs(ct.normal.dot(h))
    nl = torch.abs(ct.normal.dot(w))
    geometric = torch.minimum(torch.clamp_max(2.0 * nh * nl / dh, 1.0),
                              2.0 * nh * ct.nv / dh)
    f_cos = ct.weight * (geometric / ct.nv * p_ct)
    return f_cos, p_ct


class BidirNEE(NamedTuple):
    """Per-ray context of the bidirectional estimator's third competitor
    (the light tracer's camera connection) in each NEE weight."""

    mult: torch.Tensor          # (nu / n_lights) * T
    out_dir: Vec3               # -d_in: toward the previous eye vertex
    m: object                   # MaterialLookup at this vertex
    normal: Vec3                # RAW surfel normal
    prev_cos_out: torch.Tensor  # |n_hat . d_out| at the previous vertex
    t2_arr: torch.Tensor        # squared length of the arrival segment
    is_primary: bool            # this vertex is the primary hit


def shade_physical(scene, point: Vec3, normal: Vec3, diffuse: Vec3, diff_avg,
                   uniforms, grid=None,
                   mis: bool = False, gloss: Optional[GlossLobe] = None,
                   ct: Optional[CTLobe] = None,
                   bidir: Optional[BidirNEE] = None) -> Vec3:
    """Unbiased next-event estimation: point lights by irradiance,
    area lights by uniform-area sampling in the correct measure
    (``f cos_s L_e |cos_l| A / d^2``, two-sided emitter); ``mis`` weights
    each lobe's contribution by the power heuristic against its BSDF
    sampling density (and, with ``bidir``, the light tracer's); one shadow
    ray per light sample serves every lobe."""
    n = point.x.shape
    radiance = Vec3.zeros(n, like=point.x)
    n_unit = normal.normalize(eps=_EPS)
    zeros1 = torch.zeros(n, dtype=torch.float32, device=point.x.device)

    def lobe_terms(w_i):
        cos_s = torch.clamp_min(n_unit.dot(w_i), 0.0)
        f_cos_d = diffuse * (diff_avg * INV_PI * cos_s)
        if gloss is None:
            f_cos_g, p_g = Vec3(zeros1, zeros1, zeros1), zeros1
        else:
            p_g = gloss.prob * phong_pdf(gloss.axis, gloss.exponent, w_i)
            f_cos_g = gloss.weight * p_g
        if ct is None:
            f_cos_ct, p_ct = Vec3(zeros1, zeros1, zeros1), zeros1
        else:
            f_cos_ct, p_ct = ct_lobe_terms(ct, w_i)
        return f_cos_d, f_cos_g, p_g, f_cos_ct, p_ct, cos_s

    for i in range(scene.num_point_lights):
        visible, w_i, dist2 = _shadow_query(scene, point, n_unit,
                                            _row(scene.pl_pos, i), grid=grid)
        f_cos_d, f_cos_g, _, f_cos_ct, _, _ = lobe_terms(w_i)
        irr = _row(scene.pl_power, i) * (1.0 / (4.0 * math.pi * dist2))
        vis = torch.where(visible, 1.0, 0.0)
        # a point light has no competing BSDF strategy: full weight
        radiance = radiance + irr * (f_cos_d + f_cos_g + f_cos_ct) * vis

    for li in range(scene.num_area_lights):
        u1, u2, _u3, upick = (uniforms[UNIFORMS_PER_AREA_LIGHT * li + k]
                              for k in range(4))
        lp, n_l, area, l_e = area_light_sample_uniform(scene, li, u1, u2,
                                                       upick)
        visible, w_i, dist2 = _shadow_query(scene, point, n_unit, lp,
                                            grid=grid)
        f_cos_d, f_cos_g, p_g, f_cos_ct, p_ct, cos_s = lobe_terms(w_i)
        cos_l = torch.abs(n_l.dot(w_i))  # two-sided emitter
        geo = torch.where(visible, cos_l * area / dist2, 0.0)
        w_mis_d = w_mis_g = w_mis_ct = 1.0
        if mis:
            p_l = dist2 / torch.clamp_min(area * cos_l, _EPS)
            p_b = diff_avg * cos_s * INV_PI
            if bidir is None:
                r_lt_d = r_lt_g = r_lt_ct = 0.0
            else:
                from .bsdf import chain_model_pdfs
                l_emit = (0.5 * cos_l * INV_PI
                          * torch.abs(n_unit.dot(w_i)) / dist2)
                d_rev = -w_i
                cos_rev = w_i.dot(bidir.normal)
                lam_d, lam_g, lam_ct, _ = chain_model_pdfs(
                    d_rev, bidir.normal, bidir.m, cos_rev, bidir.out_dir)
                geo_prev = bidir.prev_cos_out / torch.clamp_min(bidir.t2_arr,
                                                                _EPS)
                base = bidir.mult * l_emit
                if bidir.is_primary:
                    # the light tracer's connection IS this vertex: no
                    # lambda factor, and only the diffuse lobe competes
                    r_lt_d, r_lt_g, r_lt_ct = base, zeros1, zeros1
                else:
                    r_lt_d = base * (lam_d * geo_prev)
                    r_lt_g = base * lam_g * geo_prev
                    r_lt_ct = base * lam_ct * geo_prev
            rl_d = torch.clamp_max(r_lt_d * p_l, MIS_RATIO_CLAMP)
            rl_g = torch.clamp_max(r_lt_g * p_l, MIS_RATIO_CLAMP)
            rl_ct = torch.clamp_max(r_lt_ct * p_l, MIS_RATIO_CLAMP)
            w_mis_d = (p_l * p_l) / torch.clamp_min(
                p_l * p_l + p_b * p_b + rl_d * rl_d, _EPS)
            w_mis_g = (p_l * p_l) / torch.clamp_min(
                p_l * p_l + p_g * p_g + rl_g * rl_g, _EPS)
            w_mis_ct = (p_l * p_l) / torch.clamp_min(
                p_l * p_l + p_ct * p_ct + rl_ct * rl_ct, _EPS)
        radiance = radiance + l_e * (f_cos_d * (geo * w_mis_d)
                                     + f_cos_g * (geo * w_mis_g)
                                     + f_cos_ct * (geo * w_mis_ct))
    return radiance
