"""BSDF branch selection and scattering of the eager engine.

The counterpart of the JAX package's ``ops/bsdf.py``
(``computeIndirectRadianceAndScatter``, ``CudaTracer/CudaTracer.cu:208-318``).
One uniform walks the branch weights Russian-roulette style: diffuse ->
specular (Fresnel-weighted unless PURE_REFLECTION) -> refraction
(1 - Fresnel) -> absorbed; the weights act as albedos. The reference's
quirk is kept: COOK_TORRANCE is 0x03 and the test is ``flags & 0x03``, so a
pure-reflection material takes the Cook-Torrance path with roughness 0.

Autodiff: the branch decision is detached (booleans carry no gradient, the
branch uniform is detached); colors, the Cook-Torrance geometric term and
the sampled directions are differentiable.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import RAY_BUMP_EPSILON
from .optics import fresnel_reflectance, media_and_sin_t2, reflect_signed, refract
from .sampling import (beckmann_direction, beckmann_pdf, lambert_direction,
                       phong_direction, phong_lobe_axis, phong_pdf)
from .vec import Vec3, gather, where as vwhere

_EPS = 1e-12

# RNG rows consumed by scatter(): 1 branch select + 2 direction sample.
UNIFORMS_PER_SCATTER = 3


class MaterialLookup(NamedTuple):
    """Per-ray gathered material fields."""

    diffuse: Vec3
    specular: Vec3
    absorption: Vec3
    emission: Vec3
    spec_exp: torch.Tensor
    ior: torch.Tensor
    diff_avg: torch.Tensor
    spec_avg: torch.Tensor
    refr_avg: torch.Tensor
    roughness: torch.Tensor
    flags: torch.Tensor


def lookup_materials(materials, idx) -> MaterialLookup:
    idx = idx.long()
    return MaterialLookup(
        diffuse=gather(materials.diffuse, idx),
        specular=gather(materials.specular, idx),
        absorption=gather(materials.absorption, idx),
        emission=gather(materials.emission, idx),
        spec_exp=materials.spec_exp[idx],
        ior=materials.ior[idx],
        diff_avg=materials.diff_avg[idx],
        spec_avg=materials.spec_avg[idx],
        refr_avg=materials.refr_avg[idx],
        roughness=materials.roughness[idx],
        flags=materials.flags[idx],
    )


class Scatter(NamedTuple):
    origin: Vec3          # new ray origin (epsilon-bumped)
    direction: Vec3       # new ray direction
    weight: Vec3          # path throughput multiplier
    alive: torch.Tensor   # False where the path was absorbed
    diffuse_branch: torch.Tensor  # the diffuse lobe was sampled
    gloss_branch: torch.Tensor    # the mirror / Phong lobe was sampled
    ct_branch: torch.Tensor       # the Cook-Torrance lobe was sampled


def scatter_lobe_pdfs(direction: Vec3, normal: Vec3, m: MaterialLookup,
                      cos_i, w: Vec3):
    """Labeled effective solid-angle densities ``(p_diff, p_gloss, p_ct)``
    with which :func:`scatter` emits direction ``w``: branch probability
    times lobe density. Delta lobes, refraction and the Cook-Torrance quirk
    preimage (d.m > 0) report 0."""
    cos_i_pos, sin_t2, n1, n2, _ = media_and_sin_t2(m.ior, cos_i)
    fres = fresnel_reflectance(cos_i_pos, sin_t2, n1, n2)
    pure = (m.flags & 0x01) != 0
    ct = (m.flags & 0x03) != 0
    p_spec = m.spec_avg * torch.where(pure, 1.0, fres)

    n_unit = normal.normalize(eps=_EPS)
    cos_w = torch.clamp_min(w.dot(n_unit), 0.0)
    p_diff = m.diff_avg * cos_w * (1.0 / math.pi)

    gloss_axis = phong_lobe_axis(reflect_signed(direction, normal, cos_i_pos))
    p_gloss = (torch.where(ct, 0.0, p_spec)
               * phong_pdf(gloss_axis, m.spec_exp, w))

    m_half = (w - direction).normalize(eps=_EPS)
    dm = direction.dot(m_half)
    ct_prob = torch.where(ct & (m.roughness > 0.0), p_spec, 0.0)
    p_ct = torch.where(
        dm < 0.0,
        ct_prob * beckmann_pdf(phong_lobe_axis(normal), m.roughness, m_half)
        / (4.0 * torch.clamp_min(torch.abs(dm), _EPS)),
        0.0)
    return p_diff, p_gloss, p_ct


def chain_model_pdfs(direction: Vec3, normal: Vec3, m: MaterialLookup,
                     cos_i, w: Vec3):
    """Per-label CHAIN-MODEL densities ``(p_diff, p_gloss, p_ct, p_refr)``
    of scattering ``direction -> w``, the pdf model of the bidirectional MIS
    weights: as :func:`scatter_lobe_pdfs`, but a lobe with no continuous
    density (delta mirror, delta Cook-Torrance, the quirk preimage,
    refraction) reports its branch probability."""
    p_diff, p_gloss, p_ct = scatter_lobe_pdfs(direction, normal, m, cos_i, w)

    cos_i_pos, sin_t2, n1, n2, _ = media_and_sin_t2(m.ior, cos_i)
    fres = fresnel_reflectance(cos_i_pos, sin_t2, n1, n2)
    pure = (m.flags & 0x01) != 0
    ct = (m.flags & 0x03) != 0
    p_spec = m.spec_avg * torch.where(pure, 1.0, fres)

    p_gloss = torch.where(ct, 0.0,
                          torch.where(torch.isfinite(m.spec_exp), p_gloss,
                                      p_spec))
    m_half = (w - direction).normalize(eps=_EPS)
    dm = direction.dot(m_half)
    p_ct = torch.where(ct, torch.where((m.roughness > 0.0) & (dm < 0.0),
                                       p_ct, p_spec), 0.0)
    p_refr = m.refr_avg * (1.0 - fres)
    return p_diff, p_gloss, p_ct, p_refr


def chain_model_pdf_taken(direction: Vec3, normal: Vec3, m: MaterialLookup,
                          cos_i, w: Vec3, sc: Scatter):
    """The chain-model density of the branch ``sc`` actually took."""
    p_diff, p_gloss, p_ct, p_refr = chain_model_pdfs(direction, normal, m,
                                                     cos_i, w)
    refr = sc.alive & ~sc.diffuse_branch & ~sc.gloss_branch & ~sc.ct_branch
    return torch.where(
        sc.diffuse_branch, p_diff,
        torch.where(sc.gloss_branch, p_gloss,
                    torch.where(sc.ct_branch, p_ct,
                                torch.where(refr, p_refr, 0.0))))


def scatter(direction: Vec3, point: Vec3, normal: Vec3, m: MaterialLookup,
            cos_i, u_branch, u_a, u_b) -> Scatter:
    """Sample the next path segment of every ray. ``cos_i`` is the signed
    dot(-direction, normal); one branch fires per ray, so the two direction
    rows are shared by all branch samplers."""
    cos_i_pos, sin_t2, n1, n2, n_ratio = media_and_sin_t2(m.ior, cos_i)
    fres = fresnel_reflectance(cos_i_pos, sin_t2, n1, n2)

    pure = (m.flags & 0x01) != 0
    ct = (m.flags & 0x03) != 0  # deliberate: includes PURE_REFLECTION

    # branch cascade: cumulative thresholds on one (detached) uniform
    with torch.no_grad():
        p_diff = m.diff_avg
        p_spec = m.spec_avg * torch.where(pure, 1.0, fres)
        p_refr = m.refr_avg * (1.0 - fres)
        u = u_branch
        take_diff = u < p_diff
        take_spec = (~take_diff) & (u < p_diff + p_spec)
        take_refr = (~take_diff) & (~take_spec) & (u < p_diff + p_spec + p_refr)

    # ---- diffuse branch ----------------------------------------------------
    d_diff = lambert_direction(normal, u_a, u_b)
    o_diff = point + normal * RAY_BUMP_EPSILON
    w_diff = m.diffuse

    # ---- specular: Cook-Torrance microfacet ---------------------------------
    m_normal = beckmann_direction(normal, m.roughness, u_a, u_b)
    cos_m = torch.abs(direction.dot(m_normal))
    d_ct = direction + m_normal * (2.0 * cos_m)
    o_ct = point + m_normal * RAY_BUMP_EPSILON
    half = (d_ct - direction).normalize(eps=_EPS)
    nh = torch.abs(normal.dot(half))
    nl = torch.abs(normal.dot(d_ct))
    vh = torch.clamp_min(torch.abs(direction.dot(half)), _EPS)
    nv = torch.clamp_min(torch.abs(cos_i), 1e-6)
    geometric = torch.minimum(
        torch.clamp_max(2.0 * nh * nl / vh, 1.0), 2.0 * nh * nv / vh)
    w_ct = m.specular * (geometric / nv)

    # ---- specular: mirror / Phong lobe (reflects with +|cos_i|, the
    # reference's quirk) -------------------------------------------------------
    d_mirror = reflect_signed(direction, normal, cos_i_pos)
    d_phong = phong_direction(d_mirror, m.spec_exp, u_a, u_b)
    d_gloss = vwhere(torch.isfinite(m.spec_exp), d_phong, d_mirror)
    o_gloss = point + normal * RAY_BUMP_EPSILON

    d_spec = vwhere(ct, d_ct, d_gloss)
    o_spec = vwhere(ct, o_ct, o_gloss)
    w_spec = vwhere(ct, w_ct, m.specular)

    # ---- refraction -----------------------------------------------------------
    d_refr = refract(direction, normal, cos_i_pos, sin_t2, n_ratio)
    o_refr = point + d_refr * RAY_BUMP_EPSILON
    refr_alive = sin_t2 <= 1.0  # TIR kills the ray (unreachable: Fresnel=1)

    # ---- combine ----------------------------------------------------------------
    zeros = torch.zeros_like(cos_i)
    new_d = vwhere(take_diff, d_diff, vwhere(take_spec, d_spec, d_refr))
    new_o = vwhere(take_diff, o_diff, vwhere(take_spec, o_spec, o_refr))
    weight = vwhere(take_diff, w_diff,
                    vwhere(take_spec, w_spec,
                           vwhere(take_refr, Vec3.ones(cos_i.shape, like=cos_i),
                                  Vec3(zeros, zeros, zeros))))
    alive = take_diff | take_spec | (take_refr & refr_alive)
    return Scatter(origin=new_o, direction=new_d, weight=weight, alive=alive,
                   diffuse_branch=take_diff, gloss_branch=take_spec & ~ct,
                   ct_branch=take_spec & ct)
