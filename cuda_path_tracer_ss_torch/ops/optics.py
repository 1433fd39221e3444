"""Fresnel, Snell, reflection, refraction of the eager engine.

The counterpart of the JAX package's ``ops/optics.py``
(``CudaTracer/CudaTracer.cu:457-531``): full unpolarized Fresnel from the
r_s / r_p amplitude equations, media chosen by hit side, total internal
reflection clamps reflectance to 1. Every expression is guarded so that the
untaken side of a ``where`` cannot put NaN into a gradient.
"""
from __future__ import annotations

import torch

from .vec import Vec3, sqrt_clamped_grad

_EPS = 1e-12


def media_and_sin_t2(ior, cos_i):
    """(cos_i_pos, sin_t2, n1, n2, n_ratio); ``cos_i`` is signed
    (dot(-d, n)), negative inside."""
    outside = cos_i > 0.0
    n1 = torch.where(outside, 1.0, ior)
    n2 = torch.where(outside, ior, 1.0)
    cos_i_pos = torch.abs(cos_i)
    n_ratio = n1 / torch.clamp_min(n2, _EPS)
    sin_t2 = n_ratio * n_ratio * (1.0 - cos_i_pos * cos_i_pos)
    return cos_i_pos, sin_t2, n1, n2, n_ratio


def _cos_t(sin_t2):
    # TIR lanes take the where(...) == 1 side; the guarded operand keeps
    # their gradient exactly zero rather than NaN
    return sqrt_clamped_grad(
        torch.where(sin_t2 < 1.0, torch.clamp_min(1.0 - sin_t2, 0.0), 1.0))


def fresnel_reflectance(cos_i_pos, sin_t2, n1, n2):
    """Unpolarized Fresnel reflectance; 1 under TIR."""
    cos_t = _cos_t(sin_t2)
    denom_s = n1 * cos_i_pos + n2 * cos_t
    denom_p = n2 * cos_i_pos + n1 * cos_t
    r_s = (n1 * cos_i_pos - n2 * cos_t) / torch.clamp_min(denom_s, _EPS)
    r_p = (n2 * cos_i_pos - n1 * cos_t) / torch.clamp_min(denom_p, _EPS)
    f = (r_s * r_s + r_p * r_p) * 0.5
    return torch.where(sin_t2 > 1.0, 1.0, f)


def reflect_signed(direction: Vec3, normal: Vec3, cos_i) -> Vec3:
    """Mirror reflection w_o = d + 2 cos_i n. The reference always passes a
    cosine already flipped positive, so an inside hit reflects to the
    reference's unnormalized outward-bent direction."""
    return direction + normal * (2.0 * cos_i)


def reflect_abs(direction: Vec3, normal: Vec3) -> Vec3:
    """Reflection about an arbitrary (microfacet) normal with |cos|."""
    c = torch.abs(direction.dot(normal))
    return direction + normal * (2.0 * c)


def refract(direction: Vec3, normal: Vec3, cos_i_pos, sin_t2, n_ratio) -> Vec3:
    """Snell refraction, normalized. Under TIR the sqrt operand is guarded
    and the caller kills the ray."""
    cos_t = _cos_t(sin_t2)
    w_o = direction * n_ratio + normal * (n_ratio * cos_i_pos - cos_t)
    return w_o.normalize(eps=_EPS)
