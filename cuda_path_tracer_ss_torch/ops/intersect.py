"""Ray-primitive intersection of the eager engine.

The counterpart of the JAX package's ``ops/intersect.py``: Moller-Trumbore
triangles with barycentric-interpolated normals and the sphere quadratic
with inside-hit handling, the same formulas in the same float order.

The reference runs a ``lax.scan`` over primitives. Here a sweep broadcasts
the rays against a chunk of primitives at a time (``[N, C]`` tensors, the
chunk sized so that one such temporary stays within ``SWEEP_BYTES``) and
takes each chunk's winner with ``argmin``. The tie rule is the scan's: a
later primitive wins an equal ``t`` (``t <= best``), so the chunk's winner is
its LAST minimum (``argmin`` of the flipped chunk), and a later chunk beats
the carry on a tie. Spheres sweep before triangles. Invalid slots are +inf.

The sweeps run without a graph. Where a gradient is wanted, ``nearest_hit``
evaluates the winning primitive's ``t`` once more, ray by ray, with a graph:
the same operations on the same values give the same bits, and the gradient
is the scan's, which flows only through the winner's ``t``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import Vec3, gather, sqrt_clamped_grad, where as vwhere

TRI_DET_EPSILON = 1e-7  # Primitives.h:31

# Bytes of one [rays, chunk] float32 temporary of a sweep.
SWEEP_BYTES = 1 << 26


class Hit(NamedTuple):
    t: torch.Tensor       # [N] distance (inf on miss)
    prim: torch.Tensor    # [N] int64: 0..S-1 spheres, S..S+T-1 triangles
    hit: torch.Tensor     # [N] bool


class Surfel(NamedTuple):
    point: Vec3           # [N]
    normal: Vec3          # [N] (triangle normals barycentric, NOT renormalized)
    mat: torch.Tensor     # [N] int64


def sphere_t(ro: Vec3, rd: Vec3, cx, cy, cz, radius):
    """Quadratic sphere test; (t, valid) of one sphere per ray (or of every
    sphere of a broadcast chunk). The near root, else the far root when
    inside (an accepted far root may be 0)."""
    v = ro - Vec3(cx, cy, cz)
    b = 2.0 * rd.dot(v)
    c = v.norm2() - radius * radius
    disc = b * b - 4.0 * c
    # sqrt of a guarded operand: a miss lane must not put NaN into a
    # gradient through an unselected where, a grazing hit no inf
    sq = sqrt_clamped_grad(torch.where(disc >= 0.0, disc, 1.0))
    t0 = (-b - sq) * 0.5
    t1 = (-b + sq) * 0.5
    t = torch.where(t0 < 0.0, t1, t0)
    valid = (disc >= 0.0) & (t >= 0.0)
    return t, valid


def triangle_t(ro: Vec3, rd: Vec3, v0: Vec3, v1: Vec3, v2: Vec3):
    """Moller-Trumbore; (t, w1, w2, valid). Edge hits (weight 0) are
    accepted; t must be strictly positive."""
    e1 = v1 - v0
    e2 = v2 - v0
    q = rd.cross(e2)
    det = e1.dot(q)
    degenerate = torch.abs(det) <= TRI_DET_EPSILON
    inv = 1.0 / torch.where(degenerate, 1.0, det)
    s = ro - v0
    r = s.cross(e1)
    t = e2.dot(r) * inv
    w1 = s.dot(q) * inv
    w2 = rd.dot(r) * inv
    w0 = 1.0 - (w1 + w2)
    valid = (~degenerate) & (t > 0.0) & (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    return t, w1, w2, valid


def _needs_graph(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _chunk(n_rays: int) -> int:
    return max(1, SWEEP_BYTES // (4 * max(n_rays, 1)))


def _col(a: torch.Tensor) -> torch.Tensor:
    return a[:, None]


def _row(table: torch.Tensor, c0: int, c1: int) -> Vec3:
    """Rows c0..c1 of an [M, 3] table as a Vec3 of [1, C]."""
    rows = table[c0:c1]
    return Vec3(rows[None, :, 0], rows[None, :, 1], rows[None, :, 2])


def _sphere_chunks(ro: Vec3, rd: Vec3, scene):
    """(first index, t [N, C], valid [N, C]) per chunk of spheres."""
    roc, rdc = ro.map(_col), rd.map(_col)
    S = scene.num_spheres
    step = _chunk(ro.x.shape[0])
    for c0 in range(0, S, step):
        c1 = min(S, c0 + step)
        c = _row(scene.sph_center, c0, c1)
        t, valid = sphere_t(roc, rdc, c.x, c.y, c.z,
                            scene.sph_radius[None, c0:c1])
        yield c0, t, valid


def _triangle_chunks(ro: Vec3, rd: Vec3, scene):
    """(first index, t [N, C], valid [N, C]) per chunk of triangles."""
    roc, rdc = ro.map(_col), rd.map(_col)
    T = scene.num_triangles
    step = _chunk(ro.x.shape[0])
    for c0 in range(0, T, step):
        c1 = min(T, c0 + step)
        t, _, _, valid = triangle_t(roc, rdc, _row(scene.tri_v0, c0, c1),
                                    _row(scene.tri_v1, c0, c1),
                                    _row(scene.tri_v2, c0, c1))
        yield c0, t, valid


def _fold_min(best_t, best_i, t, valid, first: int):
    """Fold one chunk into the running (t, index) minimum with the scan's
    rule: the chunk's last minimum, and the chunk wins a tie."""
    t = torch.where(valid, t, torch.inf)
    last = t.shape[1] - 1 - torch.argmin(torch.flip(t, (1,)), dim=1)
    ct = torch.gather(t, 1, last[:, None])[:, 0]
    closer = torch.isfinite(ct) & (ct <= best_t)
    return (torch.where(closer, ct, best_t),
            torch.where(closer, last + first, best_i))


def _winner_t(ro: Vec3, rd: Vec3, scene, prim, hit):
    """The winning primitive's t per ray, evaluated again with a graph."""
    S, T = scene.num_spheres, scene.num_triangles
    t = torch.zeros_like(ro.x)
    if S:
        si = torch.clamp(prim, 0, S - 1)
        c = gather(scene.sph_center, si)
        ts, _ = sphere_t(ro, rd, c.x, c.y, c.z, scene.sph_radius[si])
        t = torch.where(prim < S, ts, t)
    if T:
        ti = torch.clamp(prim - S, 0, T - 1)
        tt, _, _, _ = triangle_t(ro, rd, gather(scene.tri_v0, ti),
                                 gather(scene.tri_v1, ti),
                                 gather(scene.tri_v2, ti))
        t = torch.where(prim >= S, tt, t)
    return torch.where(hit, t, torch.inf)


def nearest_hit(ro: Vec3, rd: Vec3, scene) -> Hit:
    """Nearest intersection of every ray with every primitive."""
    S = scene.num_spheres
    with torch.no_grad():
        best_t = torch.full_like(ro.x, torch.inf)
        best_i = torch.full(ro.x.shape, -1, dtype=torch.int64,
                            device=ro.x.device)
        for c0, t, valid in _sphere_chunks(ro, rd, scene):
            best_t, best_i = _fold_min(best_t, best_i, t, valid, c0)
        for c0, t, valid in _triangle_chunks(ro, rd, scene):
            best_t, best_i = _fold_min(best_t, best_i, t, valid, S + c0)
        hit = torch.isfinite(best_t)
    if _needs_graph(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, scene.sph_center,
                    scene.sph_radius, scene.tri_v0, scene.tri_v1,
                    scene.tri_v2):
        best_t = _winner_t(ro, rd, scene, best_i, hit)
    return Hit(t=best_t, prim=best_i, hit=hit)


def surfel_at(ro: Vec3, rd: Vec3, hit: Hit, scene) -> Surfel:
    """The surface element of each ray's winning primitive (its barycentrics
    evaluated again)."""
    S, T = scene.num_spheres, scene.num_triangles
    t = torch.where(hit.hit, hit.t, 0.0)
    point = ro + rd * t
    is_tri = hit.prim >= S

    normal = Vec3.zeros(t.shape, like=t)
    mat = torch.zeros(t.shape, dtype=torch.int64, device=t.device)

    if S:
        si = torch.clamp(hit.prim, 0, S - 1)
        sph_n = (point - gather(scene.sph_center, si)).normalize(eps=1e-20)
        normal = vwhere(~is_tri, sph_n, normal)
        mat = torch.where(~is_tri, scene.sph_mat[si].long(), mat)

    if T:
        ti = torch.clamp(hit.prim - S, 0, T - 1)
        _, w1, w2, _ = triangle_t(ro, rd, gather(scene.tri_v0, ti),
                                  gather(scene.tri_v1, ti),
                                  gather(scene.tri_v2, ti))
        w0 = 1.0 - (w1 + w2)
        tri_n = (gather(scene.tri_n0, ti) * w0 + gather(scene.tri_n1, ti) * w1
                 + gather(scene.tri_n2, ti) * w2)
        normal = vwhere(is_tri, tri_n, normal)
        mat = torch.where(is_tri, scene.tri_mat[ti].long(), mat)

    return Surfel(point=point, normal=normal, mat=mat)


def any_hit(ro: Vec3, rd: Vec3, max_dist, scene) -> torch.Tensor:
    """Occlusion: does anything lie within ``max_dist`` along each ray? A hit
    exactly at ``max_dist`` occludes."""
    with torch.no_grad():
        md = _col(max_dist.detach()) if isinstance(max_dist, torch.Tensor) \
            else max_dist
        occluded = torch.zeros(ro.x.shape, dtype=torch.bool, device=ro.x.device)
        for chunks in (_sphere_chunks, _triangle_chunks):
            for _, t, valid in chunks(ro, rd, scene):
                occluded |= (valid & (t <= md)).any(dim=1)
    return occluded
