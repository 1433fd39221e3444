"""Importance samplers of the eager engine: cosine hemisphere, Phong lobe,
Beckmann microfacet normal, and their densities.

The counterpart of the JAX package's ``ops/sampling.py``
(``CudaTracer/CudaTracer.cu:533-585``): each sampler draws in a +Y-up frame
and rotates into the target frame with the reference's half-angle
quaternion. Uniforms come in as tensors (counter-based Threefry rows), so
every sampler is a pure, replayable, differentiable function.
"""
from __future__ import annotations

import math

import torch

from .vec import Vec3, where as vwhere

TWO_PI = 2.0 * math.pi
_TINY = 1e-12


def rotate_y_to(target: Vec3, sample: Vec3) -> Vec3:
    """Rotate ``sample`` from the +Y frame so that +Y maps onto ``target``:
    q = normalize(w = 1 + target.y, r = (target.z, 0, -target.x)), applied
    as v' = v + 2 r x (r x v + w v); the antipodal case flips 180 degrees
    about X."""
    w = 1.0 + target.y
    r = Vec3(target.z, torch.zeros_like(w), -target.x)
    n2 = w * w + r.norm2()
    degenerate = n2 < 1e-12
    inv = torch.where(degenerate, 1.0,
                      1.0 / torch.sqrt(torch.clamp_min(n2, _TINY)))
    w = w * inv
    r = r * inv
    t = r.cross(sample) + sample * w
    rotated = sample + r.cross(t) * 2.0
    flipped = Vec3(sample.x, -sample.y, -sample.z)
    return vwhere(degenerate, flipped, rotated)


def _spherical_cap(y, u_theta) -> Vec3:
    """(r cos(theta), y, r sin(theta)) with r = sqrt(1 - y^2)."""
    theta = u_theta * TWO_PI
    r = torch.sqrt(torch.clamp_min(1.0 - y * y, 0.0))
    return Vec3(r * torch.cos(theta), y, r * torch.sin(theta))


def lambert_direction(normal: Vec3, u_theta, u_s) -> Vec3:
    """Cosine-weighted hemisphere about ``normal``."""
    y = torch.sqrt(u_s)
    return rotate_y_to(normal, _spherical_cap(y, u_theta))


def phong_direction(axis: Vec3, exponent, u_theta, u_s) -> Vec3:
    """Phong lobe about ``axis``: y = s^(1/(exp+1)); an infinite exponent
    is the axis itself (a perfect mirror)."""
    s = torch.clamp(u_s, _TINY, 1.0)
    p = 1.0 / (exponent + 1.0)
    y = torch.where(torch.isfinite(exponent), torch.exp(p * torch.log(s)), 1.0)
    return rotate_y_to(axis, _spherical_cap(y, u_theta))


def phong_lobe_axis(axis: Vec3) -> Vec3:
    """The unit lobe axis of ``phong_direction(axis, ...)``: the image of +Y
    under its ``rotate_y_to``."""
    zero = torch.zeros_like(axis.x)
    return rotate_y_to(axis, Vec3(zero, torch.ones_like(axis.x), zero))


def phong_pdf(axis_unit: Vec3, exponent, w: Vec3):
    """Solid-angle density of ``phong_direction`` samples,
    (n+1)/(2 pi) cos^n on cos > 0; 0 for a delta lobe (infinite exponent)."""
    cos_a = w.dot(axis_unit)
    finite = torch.isfinite(exponent)
    e = torch.where(finite, exponent, 1.0)
    # the clamp keeps the untaken (cos_a <= 0) side's gradient finite
    safe = torch.clamp_min(cos_a, _TINY)
    pdf = (e + 1.0) / TWO_PI * torch.exp(e * torch.log(safe))
    return torch.where(finite & (cos_a > 0.0), pdf, 0.0)


def beckmann_pdf(axis_unit: Vec3, roughness, m: Vec3):
    """Solid-angle density of ``beckmann_direction`` samples about the unit
    lobe axis: exp(-tan/r^2) (1 + tan^2) / (2 pi r^2 sin) on cos > 0, 0
    elsewhere and for roughness 0 (a delta)."""
    cos_t = m.dot(axis_unit)
    r2 = roughness * roughness
    valid = (cos_t > 0.0) & (roughness > 0.0)
    cos_safe = torch.clamp_min(cos_t, _TINY)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, _TINY))
    tan_t = sin_t / cos_safe
    r2_safe = torch.clamp_min(r2, _TINY)
    pdf = (torch.exp(-tan_t / r2_safe) * (1.0 + tan_t * tan_t)
           / (TWO_PI * r2_safe * sin_t))
    return torch.where(valid, pdf, 0.0)


def beckmann_direction(normal: Vec3, roughness, u1, u2) -> Vec3:
    """Beckmann microfacet normal about ``normal``: theta = atan(-m^2
    ln(1-u)); roughness 0 is the macro normal (a mirror)."""
    u1 = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    theta = torch.arctan(-(roughness * roughness) * torch.log1p(-u1))
    phi = u2 * TWO_PI
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    m = Vec3(sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
    return rotate_y_to(normal, m)
