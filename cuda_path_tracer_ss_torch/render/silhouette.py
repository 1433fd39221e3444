"""Silhouette (visibility-boundary) gradients for geometry parameters.

The counterpart of the JAX package's ``render/silhouette.py``, in plain
PyTorch on the eager engine. Autograd of the estimator differentiates what
varies continuously with the scene, but the nearest-hit choice is a discrete
argmin: as a sphere or a triangle vertex moves, the set of pixels it covers
changes, and that visibility jump adds a boundary integral the interior
gradient cannot see. This module estimates it by edge sampling:

    dL/dtheta |_boundary
        = \\oint_C (dL/dI)(x) . (f_in - f_out)(x) (n_hat . dx/dtheta) ds

over every image-space discontinuity curve C(theta). Five curve families
are sampled (``boundary_grad``): sphere silhouettes (the cone of grazing
directions from the camera), triangle edges, sphere-triangle intersection
creases, and spheres and triangle edges seen in flat pure mirrors (the
reflected-camera construction). Each family is an explicit differentiable
function of the scene fields and the camera. The radiance jump across a
curve point is measured by tracing paired eye rays ``eps_px`` to either
side on one random stream (``_shade_jump``, the eager engine's ``trace``),
so everything but the jump cancels; the tangent comes from
``torch.func.jvp`` through the curve, and the parameter gradient from
``torch.autograd.grad`` of the scalar ``sum(coef_k * (n_hat_k . x_k))``
with ``coef`` and ``n_hat`` detached.

``shadow_boundary_grad`` adds the NEE shadow-ray term: the silhouettes of
blocker spheres and the edges of blocker triangles, seen from a receiver per
pixel and projected onto each area light's plane, with the jump integrand
evaluated analytically (every light-sampled lobe in physical mode; the
parity estimator's two direct terms otherwise) times a traced visibility.
Pure-mirror pixels follow up to two reflections to their first non-mirror
receiver, their adjoint scaled by the chain's throughput.

``unsampled_reflection_mass`` measures the adjoint mass on reflections this
module does not sample (curved mirrors, glossy reflectors showing an
optimized primitive); ``make_grad_with_boundary`` warns past 2 %.

Known behaviour kept from the reference: when a sphere barely pokes through
a wall the crease and the sphere's horizon sit within ``eps_px`` of each
other, both families' probe rays straddle the same jump, and the term is
counted up to twice (an O(eps_px) bias of finite-offset jump probing).

The curve strata's jitter comes from the JAX package's ``jax.random``
streams, reproduced bit for bit by ``utils/rng.py``'s ``jax_*`` functions,
so both packages sample the same curve points. The curve-shading rays run on
the eager engine whatever engine computes the interior gradient: the
boundary term reaches no kernel. Host-side decisions (which triangles are
mirrors, which families run) read the concrete scene.
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..constants import DEFAULT_MAX_BOUNCES, INV_PI, RAY_BUMP_EPSILON
from ..ops.bsdf import lookup_materials
from ..ops.intersect import Hit, Surfel, any_hit, nearest_hit, surfel_at
from ..ops.optics import fresnel_reflectance, media_and_sin_t2, reflect_signed
from ..ops.sampling import phong_lobe_axis, phong_pdf
from ..ops.shading import (CTLobe, GlossLobe, _row, _tri_area_normal,
                           _tri_verts, ct_lobe_terms)
from ..ops.vec import Vec3, where as vwhere
from ..utils import rng
from . import integrator
from .integrator import _sync, eye_rays_for_indices, trace
from .inverse import make_loss, merge_params, value_and_grad as _value_and_grad
from .lighttrace import project_dir

# Sample indices for the boundary-shading rays start here so their RNG
# streams never collide with the main render's samples 0..spp.
BOUNDARY_SAMPLE_BASE = 1 << 20

# Per-step timing of make_grad_with_boundary, off by default. Set to a list
# and every step appends {"interior", "adjoint", "detector", "boundary",
# "shadow"} in ms, the device synchronized around each part.
STEP_TIMES: Optional[list] = None

_TWO_PI = 2 * math.pi


def _v(table: torch.Tensor) -> Vec3:
    """A scene's ``[N, 3]`` field as a Vec3 of ``[N]``."""
    return Vec3.from_array(table)


def _guard(x, eps):
    """``x`` pushed away from 0 to +-eps, keeping its sign."""
    return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)


def _detached(params, dev):
    return {k: v.detach().to(dev) for k, v in params.items()}


def _mirror_mask(materials):
    """Host-side pure-mirror test of every material (numpy)."""
    fl = materials.flags.cpu().numpy()
    return (((fl & 0x01) != 0) & (materials.roughness.cpu().numpy() <= 0.0)
            & (materials.diff_avg.cpu().numpy() <= 0.0))


def unsampled_reflection_mass(scene, cam_params, dL_dI, width: int,
                              height: int, seed, want_spheres: bool,
                              want_tris: bool) -> torch.Tensor:
    """Fraction of the adjoint image's mass on pixels whose primary hit is a
    reflector this module does NOT sample — a curved pure mirror (a
    pure-reflection sphere; flat mirror triangles are sampled) or a glossy
    reflector (finite spec_exp or rough Cook-Torrance with spec_avg > 0) —
    and whose reflection shows an optimized primitive class
    (``want_spheres`` / ``want_tris``). A 0-d tensor on ``dL_dI``'s
    device."""
    dev = dL_dI.device
    scene = scene.to(dev)
    cam = integrator.camera_tensors(cam_params, dev)
    with torch.no_grad():
        n_pix = width * height
        pixel_idx = torch.arange(n_pix, dtype=torch.int64, device=dev)
        jx, jy = rng.eye_jitter(seed, pixel_idx, BOUNDARY_SAMPLE_BASE - 2)
        o, dirs = eye_rays_for_indices(cam, width, height, pixel_idx, jx, jy)
        hit = nearest_hit(o, dirs, scene)
        surfel = surfel_at(o, dirs, hit, scene)
        m = lookup_materials(scene.materials, surfel.mat)
        S = scene.num_spheres
        is_sphere_prim = hit.prim < S
        pure = ((m.flags & 0x01) != 0) & (m.roughness <= 0.0) & (
            m.diff_avg <= 0.0)
        glossy = (m.spec_avg > 0.0) & (torch.isfinite(m.spec_exp)
                                       | (m.roughness > 0.0))
        # flat pure mirrors (triangles) are sampled; everything else that
        # deterministically or sharply reflects is not
        unsampled_reflector = hit.hit & ((pure & is_sphere_prim) | glossy)

        cos_pos = torch.abs((-dirs).dot(surfel.normal))
        d2 = reflect_signed(dirs, surfel.normal, cos_pos)
        o2 = surfel.point + surfel.normal * RAY_BUMP_EPSILON
        h2 = nearest_hit(o2, d2, scene)
        sees_opt = torch.zeros_like(hit.hit)
        if want_spheres and S:
            sees_opt = sees_opt | (h2.hit & (h2.prim < S))
        if want_tris and scene.num_triangles:
            sees_opt = sees_opt | (h2.hit & (h2.prim >= S))
        flagged = unsampled_reflector & sees_opt
        mass = torch.sum(torch.abs(dL_dI.reshape(n_pix, 3))
                         * flagged[:, None].to(torch.float32))
        total = torch.sum(torch.abs(dL_dI)) + 1e-30
        return mass / total


def _cam_origin(cam_params) -> Vec3:
    pos = cam_params[1]
    return Vec3(pos[0], pos[1], pos[2])


def _bx(v: Vec3) -> Vec3:
    """Lift a [S] Vec3 to [S, 1] for broadcasting against [S, K]."""
    return v.map(lambda t: t[:, None])


def _cone(a: Vec3, r, phi):
    """Silhouette-cone directions d(phi) around axis ``a`` ([S] Vec3) of
    spheres of radius ``r`` ([S]): [S, K] Vec3, and |a|."""
    L = torch.sqrt(torch.clamp_min(a.norm2(), 1e-20))
    sin_a = torch.clamp(r / L, 0.0, 1.0 - 1e-7)
    cos_a = torch.sqrt(1.0 - sin_a * sin_a)
    ahat = a / L
    # basis normal to the axis; the hard component switch only
    # reparameterizes phi (tangential), which the n_hat dot kills
    use_x = torch.abs(ahat.x) < 0.9
    e = Vec3(torch.where(use_x, 1.0, 0.0), torch.where(use_x, 0.0, 1.0),
             torch.zeros_like(ahat.x))
    u = ahat.cross(e).normalize(eps=1e-20)
    w = ahat.cross(u)
    d = (_bx(ahat) * cos_a[:, None]
         + (_bx(u) * torch.cos(phi) + _bx(w) * torch.sin(phi))
         * sin_a[:, None])
    return d, L, cos_a


def _sphere_curve_xy(scene, cam_params, phi, width, height):
    """Silhouette points of every sphere. ``phi``: [S, K] angles. Returns
    (px, py, front) of [S, K], differentiable in sph_center, sph_radius and
    the camera. Spheres enclosing the camera produce garbage; the caller
    masks them with ``_sphere_valid``."""
    o = _cam_origin(cam_params)
    d, _, _ = _cone(_v(scene.sph_center) - o, scene.sph_radius, phi)
    return project_dir(cam_params, d, width, height)


def _sphere_valid(scene, cam_params):
    o = _cam_origin(cam_params)
    a = _v(scene.sph_center) - o
    L = torch.sqrt(torch.clamp_min(a.norm2(), 1e-20))
    return (L > scene.sph_radius + 1e-6) & (scene.sph_radius > 0)


def _stack_edges(scene):
    """(va, vb, opp) Vec3 [T, 3]: edge e of triangle j runs va -> vb with
    opposite vertex opp."""
    vs = (scene.tri_v0, scene.tri_v1, scene.tri_v2)

    def stack3(f):
        return Vec3(*(torch.stack([f(e)[:, c] for e in range(3)], dim=1)
                      for c in range(3)))

    return (stack3(lambda e: vs[e]), stack3(lambda e: vs[(e + 1) % 3]),
            stack3(lambda e: vs[(e + 2) % 3]))


def _edge_points(va: Vec3, vb: Vec3, t) -> Vec3:
    return (va.map(lambda q: q[:, :, None])
            + (vb - va).map(lambda q: q[:, :, None]) * t)


def _tri_edge_xy(scene, cam_params, t, width, height):
    """Points on every triangle edge. ``t``: [T, 3, K] in [0, 1). Edge e of
    triangle j runs v_e -> v_{(e+1)%3}. Returns (px, py, front) of
    [T, 3, K], differentiable in the vertices and the camera."""
    o = _cam_origin(cam_params)
    va, vb, _ = _stack_edges(scene)
    d = _edge_points(va, vb, t) - o.map(lambda q: q[None, None])
    return project_dir(cam_params, d, width, height)


def _tri_opposite_xy(scene, cam_params, width, height):
    """Projection of each edge's opposite vertex, [T, 3]: the inward
    reference that orients the edge normal."""
    o = _cam_origin(cam_params)
    vs = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    xs, ys = [], []
    for e in range(3):
        px, py, _ = project_dir(cam_params, _v(vs[(e + 2) % 3]) - o,
                                width, height)
        xs.append(px)
        ys.append(py)
    return torch.stack(xs, dim=1), torch.stack(ys, dim=1)


def _tri_plane(scene):
    """Unit plane normal + offset of every triangle: (n [T] Vec3, d [T])."""
    v0 = _v(scene.tri_v0)
    n = (_v(scene.tri_v1) - v0).cross(_v(scene.tri_v2) - v0).normalize(
        eps=1e-20)
    return n, n.dot(v0)


def _plane_height(c: Vec3, n: Vec3, dpl):
    """Signed distance [S, T] of sphere centres ``c`` to the planes."""
    return (c.x[:, None] * n.x[None, :] + c.y[:, None] * n.y[None, :]
            + c.z[:, None] * n.z[None, :]) - dpl[None, :]


def _sphere_tri_geom(scene):
    """Pairwise sphere-triangle intersection-circle geometry: (h [S, T]
    signed center-to-plane distance, rho [S, T] circle radius, q Vec3
    [S, T] circle center, u / w Vec3 [T] in-plane basis). Pairs that do not
    intersect give garbage rho / q; callers mask with ``_sphere_tri_valid``."""
    c = _v(scene.sph_center)
    r = scene.sph_radius
    n, dpl = _tri_plane(scene)
    h = _plane_height(c, n, dpl)
    rho = torch.sqrt(torch.clamp_min(r[:, None] ** 2 - h * h, 1e-12))
    q = Vec3(c.x[:, None] - h * n.x[None, :],
             c.y[:, None] - h * n.y[None, :],
             c.z[:, None] - h * n.z[None, :])
    use_x = torch.abs(n.x) < 0.9
    e = Vec3(torch.where(use_x, 1.0, 0.0), torch.where(use_x, 0.0, 1.0),
             torch.zeros_like(n.x))
    u = n.cross(e).normalize(eps=1e-20)
    w = n.cross(u)
    return h, rho, q, u, w


def _circle(rho, q: Vec3, u: Vec3, w: Vec3, phi) -> Vec3:
    """Points q + rho (cos phi u + sin phi w), [S, T, K] componentwise."""
    cph, sph = torch.cos(phi), torch.sin(phi)

    def comp(qc, uc, wc):
        return (qc[:, :, None]
                + rho[:, :, None] * (cph * uc[None, :, None]
                                     + sph * wc[None, :, None]))

    return Vec3(comp(q.x, u.x, w.x), comp(q.y, u.y, w.y), comp(q.z, u.z, w.z))


def _sphere_tri_curve_xy(scene, cam_params, phi, width, height):
    """Surface-intersection curves: the circle where sphere (c, r) meets
    triangle j's plane, projected. ``phi``: [S, T, K]. Returns (px, py,
    front) of [S, T, K], differentiable in sph_center, sph_radius, the
    triangle vertices and the camera. Crossing the curve switches the
    nearest hit between the sphere and the triangle; parts outside the
    triangle, behind the sphere's horizon or occluded measure ~0 jump."""
    o = _cam_origin(cam_params)
    _, rho, q, u, w = _sphere_tri_geom(scene)
    y = _circle(rho, q, u, w, phi)
    return project_dir(cam_params, Vec3(y.x - o.x, y.y - o.y, y.z - o.z),
                       width, height)


def _sphere_tri_valid(scene):
    """[S, T] mask: the sphere crosses the triangle's plane (with a margin
    that keeps rho's sqrt well-conditioned) and the triangle is not
    degenerate."""
    r = scene.sph_radius
    v0 = _v(scene.tri_v0)
    area2 = (_v(scene.tri_v1) - v0).cross(_v(scene.tri_v2) - v0).norm2()
    n, dpl = _tri_plane(scene)
    h = _plane_height(_v(scene.sph_center), n, dpl)
    return ((torch.abs(h) < r[:, None] * (1.0 - 1e-5))
            & (r[:, None] > 0) & (area2[None, :] > 1e-16))


def _sphere_tri_inside(scene, phi):
    """[S, T, K] mask: circle point y(phi) lies inside triangle j (the
    barycentric test in its plane), so that a crease over coplanar
    neighbours is counted once."""
    _, rho, q, u, w = _sphere_tri_geom(scene)
    v0 = _v(scene.tri_v0)
    e1 = _v(scene.tri_v1) - v0
    e2 = _v(scene.tri_v2) - v0
    y = _circle(rho, q, u, w, phi)
    dx = y.x - v0.x[None, :, None]
    dy = y.y - v0.y[None, :, None]
    dz = y.z - v0.z[None, :, None]
    d11 = e1.norm2()[None, :, None]
    d22 = e2.norm2()[None, :, None]
    d12 = e1.dot(e2)[None, :, None]
    s1 = (dx * e1.x[None, :, None] + dy * e1.y[None, :, None]
          + dz * e1.z[None, :, None])
    s2 = (dx * e2.x[None, :, None] + dy * e2.y[None, :, None]
          + dz * e2.z[None, :, None])
    det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-20)
    a = (s1 * d22 - s2 * d12) / det
    b = (s2 * d11 - s1 * d12) / det
    return (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)


def mirror_triangles(scene, max_mirrors: int = 16) -> tuple:
    """Host-side indices of the flat-mirror triangles: those whose material
    carries the pure-reflection flag. These are the reflectors of the
    reflected-silhouette families; past ``max_mirrors`` it warns and keeps
    the first ones."""
    if not scene.num_triangles:
        return ()
    flags = scene.materials.flags.cpu().numpy()
    tm = scene.tri_mat.cpu().numpy()
    ids = np.nonzero((flags[tm] & 0x01) != 0)[0]
    if len(ids) > max_mirrors:
        warnings.warn(
            f"silhouette mirror term: {len(ids)} flat-mirror triangles "
            f"exceed max_mirrors={max_mirrors}; reflected-silhouette/"
            "edge gradients cover only the first "
            f"{max_mirrors} (raise max_mirrors / pass an explicit "
            "'mirrors' tuple to make_grad_with_boundary to choose).",
            stacklevel=2)
    return tuple(int(i) for i in ids[:max_mirrors])


def _inside_tri(yv: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Barycentric inside-test of points ``yv`` against the triangle
    (v0, v0 + e1, v0 + e2) (scalar Vec3s)."""
    d = yv - v0
    d11, d22, d12 = e1.norm2(), e2.norm2(), e1.dot(e2)
    s1, s2 = d.dot(e1), d.dot(e2)
    det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-20)
    aa = (s1 * d22 - s2 * d12) / det
    bb = (s2 * d11 - s1 * d12) / det
    return (aa >= 0.0) & (bb >= 0.0) & (aa + bb <= 1.0)


def _mirror_frames(scene, cam_params, mirror_tris):
    """Per mirror: (v0, e1, e2 (scalar Vec3), n (unit Vec3), dpl, o' = the
    camera origin reflected across the mirror's plane)."""
    o = _cam_origin(cam_params)
    for mj in mirror_tris:
        v0 = _row(scene.tri_v0, mj)
        e1 = _row(scene.tri_v1, mj) - v0
        e2 = _row(scene.tri_v2, mj) - v0
        n = e1.cross(e2).normalize(eps=1e-20)
        dpl = n.dot(v0)
        op = o - n * (2.0 * (o.dot(n) - dpl))
        yield v0, e1, e2, n, dpl, op


def _mirror_sphere_points(scene, op: Vec3, n: Vec3, dpl, phi):
    """The sphere-silhouette cones seen from the reflected origin ``op``,
    met with the mirror plane: (y [S, K] Vec3, t, L)."""
    d, L, _ = _cone(_v(scene.sph_center) - op, scene.sph_radius, phi)
    t = (dpl - op.dot(n)) / _guard(d.dot(n), 1e-9)
    return op + d * t, t, L


def _mirror_sphere_curve_xy(scene, cam_params, mirror_tris, phi,
                            width, height):
    """Reflected-silhouette curves: every sphere's silhouette seen in each
    flat pure-mirror triangle. ``phi``: [Tm, S, K]. Returns (px, py, front)
    of [Tm, S, K], differentiable in sph_center, sph_radius, the mirror's
    vertices and the camera. The camera origin o is reflected across the
    mirror plane to o'; the sphere's silhouette cone from o' met with the
    plane gives the 3-D point y(phi), and the image curve is project(y - o).
    Occlusion self-cancels through the traced two-sided jump."""
    o = _cam_origin(cam_params)
    xs, ys, fs = [], [], []
    for i, (_, _, _, n, dpl, op) in enumerate(
            _mirror_frames(scene, cam_params, mirror_tris)):
        y, t, _ = _mirror_sphere_points(scene, op, n, dpl, phi[i])
        px, py, front = project_dir(cam_params, y - o, width, height)
        xs.append(px)
        ys.append(py)
        fs.append(front & (t > 1e-5))
    return torch.stack(xs), torch.stack(ys), torch.stack(fs)


def _mirror_sphere_ref(scene, cam_params, mirror_tris, phi, width, height):
    """Aux of the reflected-silhouette family: (cx, cy [Tm, S] projected
    reflected sphere centres, the n_hat orientation reference; valid
    [Tm, S, K]: y inside the mirror triangle and the sphere outside o')."""
    o = _cam_origin(cam_params)
    c = _v(scene.sph_center)
    cxs, cys, vals = [], [], []
    for i, (v0, e1, e2, n, dpl, op) in enumerate(
            _mirror_frames(scene, cam_params, mirror_tris)):
        y, t, L = _mirror_sphere_points(scene, op, n, dpl, phi[i])
        inside = _inside_tri(y, v0, e1, e2)
        lvalid = (L > scene.sph_radius + 1e-6) & (scene.sph_radius > 0)
        vals.append(inside & lvalid[:, None] & (t > 1e-5))
        a = c - op
        tc = (dpl - op.dot(n)) / _guard(a.dot(n), 1e-9)
        cx, cy, _ = project_dir(cam_params, op + a * tc - o, width, height)
        cxs.append(cx)
        cys.append(cy)
    return torch.stack(cxs), torch.stack(cys), torch.stack(vals)


def _mirror_point(op: Vec3, n: Vec3, dpl, p: Vec3):
    """Mirror-plane point where scene point(s) ``p`` appear reflected: the
    segment o' -> p met with the plane. Returns (y, s); a real reflection
    needs 0 < s < 1 (the mirror's own in-plane edges land at s == 1)."""
    dd = p - op
    s = (dpl - op.dot(n)) / _guard(dd.dot(n), 1e-9)
    return op + dd * s, s


def _mirror_tri_edge_curve_xy(scene, cam_params, mirror_tris, t,
                              width, height):
    """Triangle edges seen in each flat mirror. ``t``: [Tm, T, 3, K].
    Returns (px, py, front) of [Tm, T, 3, K], differentiable in every
    vertex (as reflected subject and as the mirror's plane) and the camera;
    the mirror's own and coplanar edges are masked by s < 1."""
    o = _cam_origin(cam_params)
    va, vb, _ = _stack_edges(scene)
    xs, ys, fs = [], [], []
    for i, (_, _, _, n, dpl, op) in enumerate(
            _mirror_frames(scene, cam_params, mirror_tris)):
        y, s = _mirror_point(op, n, dpl, _edge_points(va, vb, t[i]))
        px, py, front = project_dir(cam_params, y - o, width, height)
        xs.append(px)
        ys.append(py)
        fs.append(front & (s > 1e-5) & (s < 1.0 - 1e-5))
    return torch.stack(xs), torch.stack(ys), torch.stack(fs)


def _mirror_tri_edge_ref(scene, cam_params, mirror_tris, t, width, height):
    """Aux of the reflected-edge family: (ox, oy [Tm, T, 3] projected
    reflected opposite vertices; valid [Tm, T, 3, K]: the reflection point
    inside the mirror triangle)."""
    o = _cam_origin(cam_params)
    va, vb, opp = _stack_edges(scene)
    oxs, oys, vals = [], [], []
    for i, (v0, e1, e2, n, dpl, op) in enumerate(
            _mirror_frames(scene, cam_params, mirror_tris)):
        y, _ = _mirror_point(op, n, dpl, _edge_points(va, vb, t[i]))
        vals.append(_inside_tri(y, v0, e1, e2))
        yo, _ = _mirror_point(op, n, dpl, opp)
        ox, oy, _ = project_dir(cam_params, yo - o, width, height)
        oxs.append(ox)
        oys.append(oy)
    return torch.stack(oxs), torch.stack(oys), torch.stack(vals)


def _unit_normal(tx, ty, ref_dx, ref_dy):
    """Unit normal to the tangent (tx, ty), oriented AWAY from the
    reference offset (ref pointing toward the primitive's interior)."""
    speed = torch.sqrt(tx * tx + ty * ty)
    inv = 1.0 / torch.clamp_min(speed, 1e-12)
    nx, ny = -ty * inv, tx * inv
    flip = torch.where(nx * ref_dx + ny * ref_dy > 0, -1.0, 1.0)
    return nx * flip, ny * flip, speed


def _curve_jvp(curve, q):
    """(px, py, front, tx, ty): the curve at ``q`` and its tangent along
    ``q`` (forward mode with a ones tangent; ``front`` rides as aux)."""
    def f(q):
        px, py, front = curve(q)
        return (px, py), front

    (px, py), (tx, ty), front = torch.func.jvp(
        f, (q,), (torch.ones_like(q),), has_aux=True)
    return px, py, front, tx, ty


def _on_screen(px, py, width, height):
    return (px >= 0) & (px < width) & (py >= 0) & (py < height)


def _shade_jump(scene, cam_params, x, y, nx, ny, width, height, seed, spp,
                max_bounces, physical, nee, eps_px):
    """Mean radiance jump f_in - f_out across curve points, by tracing ray
    pairs offset +-eps_px along the normal. [M] in, [M, 3] out. A pair
    shares one stream (pixel and sample index), so everything but the
    visibility jump cancels sample by sample. The samples are traced in one
    wavefront (up to ``integrator.WAVE_RAYS`` rays) and summed in sample
    order."""
    ix = torch.clamp(torch.floor(x), 0, width - 1)
    iy = torch.clamp(torch.floor(y), 0, height - 1)
    pixel_idx = (iy * width + ix).to(torch.int64)
    jx = torch.cat([x - eps_px * nx - ix, x + eps_px * nx - ix])
    jy = torch.cat([y - eps_px * ny - iy, y + eps_px * ny - iy])
    pix2 = torch.cat([pixel_idx, pixel_idx])
    o, d = eye_rays_for_indices(cam_params, width, height, pix2, jx, jy)
    m2 = pix2.shape[0]
    m = m2 // 2
    acc = torch.zeros((m, 3), dtype=torch.float32, device=x.device)
    per_wave = max(1, integrator.WAVE_RAYS // max(m2, 1))
    for s0 in range(0, spp, per_wave):
        b = min(spp, s0 + per_wave) - s0
        sample = (BOUNDARY_SAMPLE_BASE + s0
                  + torch.arange(b, device=x.device)).repeat_interleave(m2)
        rad = trace(scene, o.map(lambda t: t.repeat(b)),
                    d.map(lambda t: t.repeat(b)), seed, sample,
                    pix2.repeat(b), max_bounces=max_bounces,
                    live_cutoff=None, physical=physical, nee=nee)
        arr = rad.to_array().reshape(b, m2, 3)
        for i in range(b):
            acc = acc + (arr[i, :m] - arr[i, m:])
    return acc / spp


def _strata(xi, n: int, period: Optional[float] = None):
    """Stratified parameters over the last axis: (k + xi) / n on [0, 1),
    or (k + xi) * (period / n), each rounded as the reference rounds it."""
    k = torch.arange(n, device=xi.device)
    return (k + xi) / n if period is None else (k + xi) * (period / n)


def _curve_chunks(scene_d, base, cam, width, height, seed, n_sphere,
                  n_edge, n_isect, isect, mirror_tris, n_mirror):
    """The sampled curve points of every family of ``boundary_grad``:
    {family: (xy_fn(params, cam) -> (px, py) flat, weight, px, py, nx,
    ny)}, families "sphere", "tri", "isect", "mirror" (spheres in mirrors)
    and "medge" (edges in mirrors). ``base`` is the scene at the current
    parameters (detached), ``scene_d`` the one ``xy_fn`` merges them into;
    everything but ``xy_fn`` is detached."""
    key = rng.jax_fold_in(rng.jax_key(0, cam[0].device), seed)
    k_phi, k_u = rng.jax_split(key)

    S = base.num_spheres
    T = base.num_triangles
    chunks = {}

    with torch.no_grad():
        if S:
            phi = _strata(rng.jax_uniform(k_phi, (S, n_sphere)), n_sphere,
                          _TWO_PI)

            def sphere_xy(p, c, phi=phi):
                px, py, _ = _sphere_curve_xy(merge_params(scene_d, p), c, phi,
                                             width, height)
                return px.reshape(-1), py.reshape(-1)

            px, py, front, tx, ty = _curve_jvp(
                lambda q: _sphere_curve_xy(base, cam, q, width, height), phi)
            # orient away from the projected center direction
            cx, cy, _ = project_dir(cam, _v(base.sph_center) - _cam_origin(cam),
                                    width, height)
            nx, ny, speed = _unit_normal(tx, ty, cx[:, None] - px,
                                         cy[:, None] - py)
            valid = (front & _sphere_valid(base, cam)[:, None]
                     & _on_screen(px, py, width, height))
            # stratified phi: measure 2 pi / K per sample
            w = torch.where(valid, speed * (_TWO_PI / n_sphere), 0.0)
            chunks["sphere"] = (sphere_xy, w, px, py, nx, ny)

        if T:
            tt = _strata(rng.jax_uniform(k_u, (T, 3, n_edge)), n_edge)

            def tri_xy(p, c, tt=tt):
                px, py, _ = _tri_edge_xy(merge_params(scene_d, p), c, tt,
                                         width, height)
                return px.reshape(-1), py.reshape(-1)

            px, py, front, tx, ty = _curve_jvp(
                lambda q: _tri_edge_xy(base, cam, q, width, height), tt)
            ox, oy = _tri_opposite_xy(base, cam, width, height)
            nx, ny, speed = _unit_normal(tx, ty, ox[:, :, None] - px,
                                         oy[:, :, None] - py)
            valid = front & _on_screen(px, py, width, height)
            # t stratified on [0, 1): measure 1 / K per sample
            w = torch.where(valid, speed / n_edge, 0.0)
            chunks["tri"] = (tri_xy, w, px, py, nx, ny)

        # the sphere-through-wall creases: one circle per (sphere, triangle)
        # pair, off by default on big meshes
        do_isect = isect if isect is not None else (S * T <= 1024)
        if S and T and do_isect and n_isect:
            iphi = _strata(rng.jax_uniform(rng.jax_fold_in(key, 7),
                                           (S, T, n_isect)), n_isect, _TWO_PI)

            def isect_xy(p, c, iphi=iphi):
                px, py, _ = _sphere_tri_curve_xy(merge_params(scene_d, p), c,
                                                 iphi, width, height)
                return px.reshape(-1), py.reshape(-1)

            px, py, front, tx, ty = _curve_jvp(
                lambda q: _sphere_tri_curve_xy(base, cam, q, width, height),
                iphi)
            # orient away from the projected circle center (the orientation
            # only needs to be consistent: jump and n_hat flip together)
            _, _, qc, _, _ = _sphere_tri_geom(base)
            cx, cy, _ = project_dir(cam, qc - _cam_origin(cam), width, height)
            nx, ny, speed = _unit_normal(tx, ty, cx[:, :, None] - px,
                                         cy[:, :, None] - py)
            valid = (front & _sphere_tri_valid(base)[:, :, None]
                     & _sphere_tri_inside(base, iphi)
                     & _on_screen(px, py, width, height))
            w = torch.where(valid, speed * (_TWO_PI / n_isect), 0.0)
            chunks["isect"] = (isect_xy, w, px, py, nx, ny)

        # spheres seen in flat pure-mirror triangles (one specular bounce)
        if S and mirror_tris and n_mirror:
            Tm = len(mirror_tris)
            mphi = _strata(rng.jax_uniform(rng.jax_fold_in(key, 11),
                                           (Tm, S, n_mirror)), n_mirror,
                           _TWO_PI)

            def mirror_xy(p, c, mphi=mphi):
                px, py, _ = _mirror_sphere_curve_xy(
                    merge_params(scene_d, p), c, mirror_tris, mphi, width,
                    height)
                return px.reshape(-1), py.reshape(-1)

            px, py, front, tx, ty = _curve_jvp(
                lambda q: _mirror_sphere_curve_xy(base, cam, mirror_tris, q,
                                                  width, height), mphi)
            cx, cy, mvalid = _mirror_sphere_ref(base, cam, mirror_tris, mphi,
                                                width, height)
            nx, ny, speed = _unit_normal(tx, ty, cx[:, :, None] - px,
                                         cy[:, :, None] - py)
            valid = front & mvalid & _on_screen(px, py, width, height)
            w = torch.where(valid, speed * (_TWO_PI / n_mirror), 0.0)
            chunks["mirror"] = (mirror_xy, w, px, py, nx, ny)

        # triangle edges seen in flat mirrors: Tm x T x 3 x n_mirror points
        if T and mirror_tris and n_mirror:
            Tm = len(mirror_tris)
            met = _strata(rng.jax_uniform(rng.jax_fold_in(key, 13),
                                          (Tm, T, 3, n_mirror)), n_mirror)

            def medge_xy(p, c, met=met):
                px, py, _ = _mirror_tri_edge_curve_xy(
                    merge_params(scene_d, p), c, mirror_tris, met, width,
                    height)
                return px.reshape(-1), py.reshape(-1)

            px, py, front, tx, ty = _curve_jvp(
                lambda q: _mirror_tri_edge_curve_xy(base, cam, mirror_tris, q,
                                                    width, height), met)
            ox, oy, mevalid = _mirror_tri_edge_ref(base, cam, mirror_tris,
                                                   met, width, height)
            nx, ny, speed = _unit_normal(tx, ty, ox[..., None] - px,
                                         oy[..., None] - py)
            valid = front & mevalid & _on_screen(px, py, width, height)
            w = torch.where(valid, speed / n_mirror, 0.0)
            chunks["medge"] = (medge_xy, w, px, py, nx, ny)

    return chunks


def boundary_grad(scene, params: Dict[str, torch.Tensor], cam_params, dL_dI,
                  width: int, height: int, seed,
                  n_sphere: int = 256, n_edge: int = 64, spp: int = 8,
                  max_bounces: int = DEFAULT_MAX_BOUNCES,
                  physical: bool = False, nee: bool = True,
                  eps_px: float = 0.05, with_camera: bool = False,
                  n_isect: int = 32, isect: Optional[bool] = None,
                  mirror_tris: tuple = (), n_mirror: int = 32):
    """Boundary term of dL/d(params) for the loss whose adjoint image is
    ``dL_dI`` ([height, width, 3], row 0 at the bottom, as ``render``).

    ``params`` is the dict the interior gradient ran on; the result matches
    its keys and shapes (zeros for fields silhouettes do not move) and lives
    where the parameters live. The work runs on ``dL_dI``'s device.
    ``n_sphere``: curve samples per sphere; ``n_edge``: per triangle edge;
    ``n_isect``: per sphere-triangle crease (``isect=None``: on while
    S*T <= 1024); ``n_mirror``: per curve seen in each of ``mirror_tris``;
    ``spp``: paired shading rays per curve point.

    ``with_camera=True`` also returns the camera boundary term, a tuple
    matching ``integrator.camera_tensors`` (rot, pos, tan(fov/2), z_near)
    on the work's device: ``(param_grads, cam_grads)``."""
    dev = dL_dI.device
    scene_d = scene.to(dev)
    cam = tuple(c.detach() for c in integrator.camera_tensors(cam_params, dev))
    base = merge_params(scene_d, _detached(params, dev))
    chunks = _curve_chunks(scene_d, base, cam, width, height, seed, n_sphere,
                           n_edge, n_isect, isect, mirror_tris, n_mirror)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _detached(params, dev).items()}
    cam_leaves = (tuple(c.clone().requires_grad_(True) for c in cam)
                  if with_camera else ())
    total = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total_cam = tuple(torch.zeros_like(c) for c in cam_leaves)
    for xy_fn, w, px, py, nx, ny in chunks.values():
        px, py, nx, ny, w = (a.reshape(-1) for a in (px, py, nx, ny, w))
        with torch.no_grad():
            jump = _shade_jump(base, cam, px, py, nx, ny, width, height, seed,
                               spp, max_bounces, physical, nee, eps_px)
            ix = torch.clamp(torch.floor(px), 0, width - 1).to(torch.int64)
            iy = torch.clamp(torch.floor(py), 0, height - 1).to(torch.int64)
            g = dL_dI[iy, ix]                                  # [M, 3]
            coef = w * torch.sum(g * jump, dim=-1)
        with torch.enable_grad():
            qx, qy = xy_fn(leaves, cam_leaves or cam)
            scalar = torch.sum(coef * (nx * qx + ny * qy))
        total, total_cam = _add_grads(scalar, leaves, total, cam_leaves,
                                      total_cam)
    out = {k: v.to(params[k].device) for k, v in total.items()}
    return (out, total_cam) if with_camera else out


def _add_grads(scalar, leaves, total, cam_leaves=(), total_cam=()):
    """total += d scalar / d leaves (and the camera leaves); a leaf the
    scalar does not reach adds nothing."""
    inputs = list(leaves.values()) + list(cam_leaves)
    if not scalar.requires_grad:
        return total, total_cam
    grads = torch.autograd.grad(scalar, inputs, allow_unused=True)
    total = {k: total[k] if g is None else total[k] + g
             for k, g in zip(leaves, grads)}
    total_cam = tuple(t if g is None else t + g
                      for t, g in zip(total_cam, grads[len(leaves):]))
    return total, total_cam


def mse_adjoint(img, target):
    """Adjoint image of ``mean((img - target)**2)``, the loss make_loss
    builds."""
    return 2.0 * (img - target) / img.numel()


# ---------------------------------------------------------------------------
# The shadow (NEE-occlusion) boundary term.
#
# For a receiver x the direct term is an integral over the light surface,
# I(x) = \int_A g(x, y) V(x, y) dA(y). The discontinuity curve of V on the
# light plane is the blocker's silhouette seen from x, projected onto the
# plane: an explicit differentiable curve y(phi; blocker, light), like the
# primary families with the camera replaced by x and the image plane by the
# light plane. Its term is \oint (g_in - g_out)(y) (n_hat . dy/dtheta) ds,
# with g evaluated analytically times a traced visibility on each side, so
# other blockers occluding the same stretch cancel the jump. Receivers are
# detached; textured receivers use the base material's diffuse colour.
# ---------------------------------------------------------------------------

def _center_biased_area_pdf(scene, tri, w0, w1, w2):
    """Area density of the reference's center-biased light sampler at
    barycentric (w0, w1, w2) of triangle ``tri``: p_simplex(w) =
    1 / (3 max(w)^3), times the 50/50 triangle pick, over the 2 A_tri
    simplex-to-area Jacobian."""
    area, _, _ = _tri_area_normal(scene, tri)
    mx = torch.maximum(torch.maximum(w0, w1), w2)
    p_simplex = 1.0 / (3.0 * torch.clamp_min(mx, 1e-6) ** 3)
    return 0.5 * p_simplex / torch.clamp_min(2.0 * area, 1e-12)


def _bary_on_tri(scene, tri, y: Vec3):
    """Barycentric coordinates of points ``y`` w.r.t. triangle ``tri``
    (projected onto its plane) and an inside test."""
    v0, v1, v2 = _tri_verts(scene, tri)
    e1 = v1 - v0
    e2 = v2 - v0
    d = y - v0
    d11 = e1.dot(e1)
    d12 = e1.dot(e2)
    d22 = e2.dot(e2)
    dp1 = d.dot(e1)
    dp2 = d.dot(e2)
    det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-12)
    w1 = (d22 * dp1 - d12 * dp2) / det
    w2 = (d11 * dp2 - d12 * dp1) / det
    w0 = 1.0 - w1 - w2
    eps = 1e-4
    inside = (w0 > -eps) & (w1 > -eps) & (w2 > -eps)
    return w0, w1, w2, inside


def _light_plane(scene, li: int, x: Vec3):
    """(unit normal of light ``li``'s plane, numerator (v0 - x) . n [P])."""
    _, n_raw, (v0, _, _) = _tri_area_normal(scene, scene.al_tri0[li])
    n_pl = n_raw.normalize(eps=1e-12)
    return n_pl, (v0 - x).dot(n_pl)


def _onto_plane(x: Vec3, d: Vec3, n_pl: Vec3, num):
    """Points x + d s on the light plane ([P, K]): (y, s, den)."""
    den = d.dot(n_pl.map(lambda q: torch.broadcast_to(q, x.x.shape)[:, None]))
    s = num[:, None] / torch.where(torch.abs(den) < 1e-6, 1e-6, den)
    return _bx(x) + d * s, s, den


def _shadow_curve_y(scene, x: Vec3, si: int, li: int, phi):
    """Silhouette curve of sphere ``si`` seen from receivers ``x`` [P],
    projected onto light ``li``'s plane: y [P, K] (differentiable in the
    sphere fields and the light's vertices), plus (t_plane, t_tangent,
    denom, n_pl)."""
    a = _row(scene.sph_center, si).map(lambda q: q[None]) - x
    d, Lc, cos_a = _cone(a, scene.sph_radius[si], phi)
    n_pl, num = _light_plane(scene, li, x)
    y, t, den = _onto_plane(x, d, n_pl, num)
    t_tan = (Lc * cos_a)[:, None]                     # blocker contact dist
    return y, t, t_tan, den, n_pl


def _tri_shadow_curve_y(scene, x: Vec3, tj: int, e: int, li: int, tt):
    """Edge ``e`` of blocker triangle ``tj`` projected from receivers ``x``
    [P] onto light ``li``'s plane: y [P, K] (differentiable in the triangle
    vertices and the light) plus (s = plane-hit parameter along
    x -> edge point, den, n_pl). Shared mesh edges self-cancel through the
    traced two-sided visibility."""
    vs = _tri_verts(scene, tj)
    va = vs[e].map(lambda q: q[None])
    vb = vs[(e + 1) % 3].map(lambda q: q[None])
    p = va.map(lambda q: q[:, None]) + (vb - va).map(lambda q: q[:, None]) * tt
    n_pl, num = _light_plane(scene, li, x)
    y, s, den = _onto_plane(x, p - _bx(x), n_pl, num)
    return y, s, den, n_pl


def _sphere_valid_from(scene, x: Vec3, si: int):
    a = _row(scene.sph_center, si).map(lambda q: q[None]) - x
    Lc = torch.sqrt(torch.clamp_min(a.norm2(), 1e-20))
    return (Lc > scene.sph_radius[si] + 1e-6) & (scene.sph_radius[si] > 0)


def _y_jvp(curve, q) -> Vec3:
    """The tangent of a Vec3-valued curve along ``q`` (ones tangent)."""
    def f(q):
        y = curve(q)[0]
        return y.x, y.y, y.z

    _, tau = torch.func.jvp(f, (q,), (torch.ones_like(q),))
    return Vec3(*tau)


def shadow_boundary_grad(scene, params: Dict[str, torch.Tensor], cam_params,
                         dL_dI, width: int, height: int, seed,
                         n_phi: int = 64, physical: bool = False,
                         eps_y: float = 2e-3, tri_blockers: bool = True,
                         mirror_chain=None) -> Dict[str, torch.Tensor]:
    """Shadow-silhouette boundary term of dL/d(params): one receiver per
    pixel (a jittered primary hit), every (blocker, area light) pair's
    projected silhouette sampled at ``n_phi`` stratified points per
    receiver. Blockers are the spheres and (``tri_blockers``) the edges of
    every triangle but the light's own. Returns a dict matching ``params``
    (zeros for non-geometry fields), where the parameters live; the work
    runs on ``dL_dI``'s device.

    ``mirror_chain``: follow pure-mirror receivers through up to two
    reflections; ``None`` decides from the concrete scene whether any
    material can act as a pure mirror."""
    if mirror_chain is None:
        mirror_chain = bool(np.any(_mirror_mask(scene.materials)))
    dev = dL_dI.device
    scene_d = scene.to(dev)
    cam = integrator.camera_tensors(cam_params, dev)
    base = merge_params(scene_d, _detached(params, dev))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _detached(params, dev).items()}
    total = {k: torch.zeros_like(v) for k, v in leaves.items()}
    S = base.num_spheres
    L = base.num_area_lights
    T = base.num_triangles
    if not L or (not S and not (tri_blockers and T)):
        return {k: v.to(params[k].device) for k, v in total.items()}

    with torch.no_grad():
        recv = _receivers(base, cam, dL_dI, width, height, seed, physical,
                          mirror_chain)
    key = rng.jax_fold_in(rng.jax_key(17, dev), seed)
    n_pix = width * height
    x = recv["x"]

    def accumulate(total, curve_fn, y, tau, n_pl, ref_inside, valid, measure,
                   g_at):
        """Orient the in-plane normal away from ``ref_inside`` (a point in
        the shadow), probe the jump with the analytic integrand and traced
        visibility, and differentiate through the curve."""
        with torch.no_grad():
            speed = torch.sqrt(torch.clamp_min(tau.norm2(), 1e-20))
            n_c = tau.cross(n_pl.map(
                lambda q: torch.broadcast_to(q, tau.x.shape)))
            n_c = n_c * (1.0 / torch.sqrt(torch.clamp_min(n_c.norm2(), 1e-20)))
            flip = torch.where((y - ref_inside).dot(n_c) < 0.0, -1.0, 1.0)
            n_c = n_c * flip
            jump = g_at(y - n_c * eps_y) - g_at(y + n_c * eps_y)
            g_pix = recv["g_pix"]
            adj = Vec3(g_pix[:, 0, None], g_pix[:, 1, None],
                       g_pix[:, 2, None])
            coef = torch.where(valid, adj.dot(jump) * speed * measure, 0.0)
        with torch.enable_grad():
            yq = curve_fn(leaves)
            scalar = torch.sum(coef * (n_c.x * yq.x + n_c.y * yq.y
                                       + n_c.z * yq.z))
        return _add_grads(scalar, leaves, total)[0]

    for si in range(S):
        for li in range(L):
            with torch.no_grad():
                phi = _strata(rng.jax_uniform(
                    rng.jax_fold_in(key, si * L + li), (n_pix, n_phi)),
                    n_phi, _TWO_PI)
                y, t, t_tan, den, n_pl = _shadow_curve_y(base, x, si, li, phi)
                tau = _y_jvp(lambda q: _shadow_curve_y(base, x, si, li, q),
                             phi)
                # inside-the-shadow reference: the ray x -> sphere center
                # met with the light plane
                c_dir = _row(base.sph_center, si).map(lambda q: q[None]) - x
                num0 = (_tri_verts(base, base.al_tri0[li])[0] - x).dot(n_pl)
                den0 = c_dir.dot(n_pl)
                t0 = num0 / torch.where(torch.abs(den0) < 1e-6, 1e-6, den0)
                c_proj = _bx(x + c_dir * t0)
                # a real silhouette, the blocker before the light plane, the
                # curve point on the light (either half)
                sph_ok = (t > 0) & (t > t_tan) & (torch.abs(den) > 1e-5)
                tri0 = base.al_tri0[li]
                _, _, _, in_a = _bary_on_tri(base, tri0, y)
                _, _, _, in_b = _bary_on_tri(base, tri0 + 1, y)
                valid = ((in_a | in_b) & sph_ok & recv["ok"][:, None]
                         & _sphere_valid_from(base, x, si)[:, None])

            def sphere_curve(p, si=si, li=li, phi=phi):
                return _shadow_curve_y(merge_params(scene_d, p), x, si, li,
                                       phi)[0]

            total = accumulate(total, sphere_curve, y, tau, n_pl, c_proj,
                               valid, _TWO_PI / n_phi,
                               _make_g_at(base, recv, li, tri0, n_pl,
                                          physical))

    if tri_blockers and T:
        # flat blockers: the cast-shadow boundary is the three projected
        # edges of every (non-light) triangle
        for tj in range(T):
            for e in range(3):
                for li in range(L):
                    with torch.no_grad():
                        kk = rng.jax_fold_in(key,
                                             10_000 + (tj * 3 + e) * L + li)
                        tt = _strata(rng.jax_uniform(kk, (n_pix, n_phi)),
                                     n_phi)
                        y, s_par, den, n_pl = _tri_shadow_curve_y(
                            base, x, tj, e, li, tt)
                        tau = _y_jvp(lambda q: _tri_shadow_curve_y(
                            base, x, tj, e, li, q), tt)
                        # inside reference: the opposite vertex projected
                        od = _tri_verts(base, tj)[(e + 2) % 3].map(
                            lambda q: q[None]) - x
                        tri0 = base.al_tri0[li]
                        num0 = (_tri_verts(base, tri0)[0] - x).dot(n_pl)
                        den0 = od.dot(n_pl)
                        s0 = num0 / torch.where(torch.abs(den0) < 1e-6, 1e-6,
                                                den0)
                        o_proj = _bx(x + od * s0)
                        _, _, _, in_a = _bary_on_tri(base, tri0, y)
                        _, _, _, in_b = _bary_on_tri(base, tri0 + 1, y)
                        # the light's own two triangles block nothing
                        not_light = (tj != tri0) & (tj != tri0 + 1)
                        valid = ((in_a | in_b) & (s_par > 1.0 + 1e-4)
                                 & (torch.abs(den) > 1e-5)
                                 & recv["ok"][:, None] & not_light)

                    def tri_curve(p, tj=tj, e=e, li=li, tt=tt):
                        return _tri_shadow_curve_y(merge_params(scene_d, p),
                                                   x, tj, e, li, tt)[0]

                    total = accumulate(total, tri_curve, y, tau, n_pl,
                                       o_proj, valid, 1.0 / n_phi,
                                       _make_g_at(base, recv, li, tri0, n_pl,
                                                  physical))
    return {k: v.to(params[k].device) for k, v in total.items()}


def _receivers(scene, cam, dL_dI, width, height, seed, physical,
               mirror_chain):
    """The shadow term's receivers: one jittered primary hit per pixel,
    pure-mirror lanes advanced through up to two reflections to their first
    non-mirror vertex (``mirror_chain``), their adjoint scaled by the
    chain's expected throughput — the Cook-Torrance mirror weight
    specular / cos per hop, times spec_avg in parity mode. Returns a dict:
    the point ``x``, its material ``m``, unit normal, ``ok`` mask, the
    adjoint per receiver ``g_pix`` and, in physical mode, the lobes."""
    n_pix = width * height
    dev = dL_dI.device
    pixel_idx = torch.arange(n_pix, dtype=torch.int64, device=dev)
    jx, jy = rng.eye_jitter(seed, pixel_idx, BOUNDARY_SAMPLE_BASE - 1)
    o, dirs = eye_rays_for_indices(cam, width, height, pixel_idx, jx, jy)
    hit = nearest_hit(o, dirs, scene)
    surfel = surfel_at(o, dirs, hit, scene)
    tp = Vec3.ones(hit.t.shape, like=hit.t)
    for _depth in range(2 if mirror_chain else 0):
        mm = lookup_materials(scene.materials, surfel.mat)
        is_mirror = (hit.hit & ((mm.flags & 0x01) != 0)
                     & (mm.roughness <= 0.0) & (mm.diff_avg <= 0.0))
        cos_pos = torch.abs((-dirs).dot(surfel.normal))
        wmir = mm.specular / torch.clamp_min(cos_pos, 1e-6)
        if not physical:
            wmir = wmir * mm.spec_avg
        d2 = reflect_signed(dirs, surfel.normal, cos_pos)
        o2 = surfel.point + surfel.normal * RAY_BUMP_EPSILON
        h2 = nearest_hit(o2, d2, scene)
        s2 = surfel_at(o2, d2, h2, scene)
        tp = vwhere(is_mirror, tp * wmir, tp)
        dirs = vwhere(is_mirror, d2, dirs)
        hit = Hit(t=torch.where(is_mirror, h2.t, hit.t),
                  prim=torch.where(is_mirror, h2.prim, hit.prim),
                  hit=torch.where(is_mirror, h2.hit, hit.hit))
        surfel = Surfel(point=vwhere(is_mirror, s2.point, surfel.point),
                        normal=vwhere(is_mirror, s2.normal, surfel.normal),
                        mat=torch.where(is_mirror, s2.mat, surfel.mat))

    m = lookup_materials(scene.materials, surfel.mat)
    n_x = surfel.normal.normalize(eps=1e-12)
    cos_eye = (-dirs).dot(n_x)
    lobe_live = m.diff_avg > 0.0
    if physical:
        # physical NEE also light-samples the glossy / Cook-Torrance lobes
        lobe_live = lobe_live | (m.spec_avg > 0.0)
    recv = dict(x=surfel.point, m=m, n_x=n_x,
                ok=hit.hit & (cos_eye > 0.0) & lobe_live,
                g_pix=dL_dI.reshape(n_pix, 3) * tp.to_array())
    if physical:
        # the receiver's lobes as the integrator's NEE builds them (incoming
        # = the eye ray), so the jump covers glossy / CT direct light too
        cos_ip, sin_t2_r, n1_r, n2_r, _ = media_and_sin_t2(m.ior, cos_eye)
        fres_r = fresnel_reflectance(cos_ip, sin_t2_r, n1_r, n2_r)
        pure_r = (m.flags & 0x01) != 0
        ct_r = (m.flags & 0x03) != 0
        p_spec_r = m.spec_avg * torch.where(pure_r, 1.0, fres_r)
        recv["gloss"] = GlossLobe(
            axis=_bx(phong_lobe_axis(
                reflect_signed(dirs, surfel.normal, cos_ip))),
            exponent=m.spec_exp[:, None],
            weight=_bx(m.specular),
            prob=torch.where(ct_r, 0.0, p_spec_r)[:, None])
        recv["ct"] = CTLobe(
            axis=_bx(phong_lobe_axis(surfel.normal)),
            roughness=m.roughness[:, None],
            weight=_bx(m.specular),
            prob=torch.where(ct_r & (m.roughness > 0.0), p_spec_r,
                             0.0)[:, None],
            d=_bx(dirs),
            normal=_bx(surfel.normal),
            nv=torch.clamp_min(torch.abs(cos_eye), 1e-6)[:, None])
    return recv


def _make_g_at(scene, recv, li, tri0, n_pl, physical):
    """The direct-light integrand g(x, y) of light ``li`` at light-plane
    points ``y`` [P, K] times the traced visibility x -> y."""
    x, m, n_x = recv["x"], recv["m"], recv["n_x"]

    def g_at(yq: Vec3) -> Vec3:
        off = yq - _bx(x)
        d2 = torch.clamp_min(off.norm2(), 1e-12)
        dist = torch.sqrt(d2)
        w_i = off * (1.0 / dist)
        cos_x = torch.clamp_min(_bx(n_x).dot(w_i), 0.0)
        cos_l = torch.abs(w_i.dot(n_pl.map(
            lambda q: torch.broadcast_to(q, w_i.x.shape))))
        origin = _bx(x + n_x * RAY_BUMP_EPSILON).map(
            lambda q: torch.broadcast_to(q, w_i.x.shape))
        shape = w_i.x.shape
        vis = ~any_hit(origin.map(lambda q: q.reshape(-1)),
                       w_i.map(lambda q: q.reshape(-1)),
                       (dist - 2.0 * RAY_BUMP_EPSILON).reshape(-1),
                       scene).reshape(shape)
        l_e = _row(scene.materials.emission, scene.tri_mat[tri0].long())
        f_d = _bx(m.diffuse) * (m.diff_avg * INV_PI)[:, None]
        if physical:
            # implied-f convention (ops/shading.py): f_lobe * cos = prob *
            # lobe_pdf(w) * weight, so the glossy / CT terms' area density
            # is weight * p_lobe * |cos_l| / d^2 with no receiver cosine
            gl, ct = recv["gloss"], recv["ct"]
            f_cos = f_d * cos_x
            p_g = gl.prob * phong_pdf(gl.axis, gl.exponent, w_i)
            f_cos = f_cos + gl.weight * p_g
            f_ct, _ = ct_lobe_terms(ct, w_i)
            f_cos = f_cos + f_ct
            g = f_cos * l_e.map(lambda q: q[None, None]) * (cos_l / d2)
        else:
            # the parity estimator's direct light is the sum of two terms
            # discontinuous in V: NEE with the reference falloff
            # power / (4 pi d^2) and the center-biased area density, and the
            # diffusely scattered emission hit, f_d Le cos_x cos_l / d^2 in
            # area measure
            pw = _row(scene.al_power, li)
            q0a, q1a, q2a, ina = _bary_on_tri(scene, tri0, yq)
            q0b, q1b, q2b, _ = _bary_on_tri(scene, tri0 + 1, yq)
            pa = _center_biased_area_pdf(scene, tri0, q0a, q1a, q2a)
            pb = _center_biased_area_pdf(scene, tri0 + 1, q0b, q1b, q2b)
            p_area = torch.where(ina, pa, pb)
            g = f_d * (pw.map(lambda q: q[None, None])
                       * (cos_x / (4.0 * math.pi * d2) * p_area)
                       + l_e.map(lambda q: q[None, None])
                       * (cos_x * cos_l / d2))
        return g.map(lambda q: q * torch.where(vis, 1.0, 0.0))

    return g_at


def make_grad_with_boundary(scene, cam_params, target,
                            field_names: Iterable[str], width: int,
                            height: int, spp: int,
                            max_bounces: int = DEFAULT_MAX_BOUNCES,
                            physical: bool = False,
                            n_sphere: int = 256, n_edge: int = 64,
                            boundary_spp: int = 8,
                            adjoint_spp: Optional[int] = None,
                            eps_px: float = 0.05,
                            engine: str = "eager",
                            shadow: bool = True, n_phi: int = 64,
                            tri_blockers=None,
                            n_isect: int = 32, isect=None,
                            mirrors=None, n_mirror: int = 32, device=None):
    """``value_and_grad(params, seed)`` of the MSE loss with the silhouette
    boundary terms folded into the geometry gradients: the interior term by
    ``make_loss(engine=...)`` (``"cuda"``: K1 + K2; ``"eager"``: autograd
    through the eager engine; ``"plain"``: autograd through the plain
    render), the boundary terms by edge sampling on the eager engine. All
    engines consume the same counter streams, so mixing them keeps one
    estimator. ``device`` is make_loss's (the card unless the engine is
    plain); the adjoint image and the boundary terms run there, and the
    gradients live where the parameters live.

    ``adjoint_spp``: samples of the adjoint image dL/dI (default ``spp``;
    the eager engine renders it on the loss's streams). ``mirrors``: the
    flat-mirror triangles of the reflected families — ``None`` detects them
    (``mirror_triangles``), ``False`` turns the families off, or a tuple of
    triangle indices. ``tri_blockers=None`` turns triangle blockers of the
    shadow term on while the scene has at most 24 triangles (with a
    warning above). The detector of unsampled reflections warns once."""
    field_names = tuple(field_names)
    loss = make_loss(scene, cam_params, target, width, height, spp,
                     max_bounces, physical=physical, engine=engine,
                     field_names=field_names, device=device)
    dev = integrator.resolve_device(
        device if device is not None
        else ("cpu" if engine == "plain" else "cuda"))
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, np.float32))
    target = target.to(device=dev, dtype=torch.float32)
    a_spp = spp if adjoint_spp is None else adjoint_spp
    if mirrors is None:
        mirror_tris = mirror_triangles(scene)
    elif mirrors is False:
        mirror_tris = ()
    else:
        mirror_tris = tuple(mirrors)

    def adjoint_image(params, seed):
        with torch.no_grad():
            s = merge_params(scene, {k: v.detach() for k, v in params.items()})
            img = integrator.render(s, cam_params, width, height, a_spp,
                                    int(seed), max_bounces=max_bounces,
                                    live_cutoff=None, physical=physical,
                                    device=dev)
            return mse_adjoint(img, target)

    # the detector of the unsampled reflected families: armed only when
    # geometry is optimized and the scene has a curved mirror or a glossy
    # reflector (host-side check); it warns once per optimization
    want_spheres = any(f.startswith("sph_") for f in field_names)
    want_tris = any(f.startswith("tri_") for f in field_names)
    mats = scene.materials
    glossy = ((mats.spec_avg.cpu().numpy() > 0.0)
              & (np.isfinite(mats.spec_exp.cpu().numpy())
                 | (mats.roughness.cpu().numpy() > 0.0)))
    has_risky_reflector = bool(np.any(_mirror_mask(mats) | glossy))
    detector_on = (want_spheres or want_tris) and has_risky_reflector
    warned = [False]

    def maybe_warn_unsampled(params, dL_dI, seed):
        if not detector_on or warned[0]:
            return
        s = merge_params(scene, {k: v.detach() for k, v in params.items()})
        frac = float(unsampled_reflection_mass(
            s, cam_params, dL_dI, width, height, seed, want_spheres,
            want_tris))
        if frac > 0.02:
            warnings.warn(
                f"silhouette boundary term: {100 * frac:.0f}% of the "
                "adjoint mass sits on pixels whose primary transport is "
                "an UNSAMPLED reflected-silhouette family (curved mirror "
                "or glossy reflector showing an optimized primitive). "
                "Geometry gradients for silhouette motion inside those "
                "reflections are missing — expect wrong-magnitude "
                "gradients if the loss depends on them "
                "(render/silhouette.py scope notes).", stacklevel=3)
            warned[0] = True

    def value_and_grad(params, seed):
        times = [] if STEP_TIMES is not None else None

        def lap():
            if times is not None:
                _sync(dev)
                times.append(time.perf_counter())

        lap()
        val, grad = _value_and_grad(loss, params, seed)
        lap()
        dL_dI = adjoint_image(params, seed)
        lap()
        maybe_warn_unsampled(params, dL_dI, seed)
        lap()
        bnd = boundary_grad(scene, params, cam_params, dL_dI, width, height,
                            seed, n_sphere=n_sphere, n_edge=n_edge,
                            spp=boundary_spp, max_bounces=max_bounces,
                            physical=physical, eps_px=eps_px,
                            n_isect=n_isect, isect=isect,
                            mirror_tris=mirror_tris, n_mirror=n_mirror)
        grad = {k: grad[k] + bnd[k] for k in grad}
        lap()
        tb = tri_blockers
        if tb is None:
            # triangle blockers cost T * 3 * L curve batches per step: on
            # by default only for small meshes
            tb = scene.num_triangles <= 24
            if not tb:
                warnings.warn(
                    f"silhouette shadow term: {scene.num_triangles} "
                    "triangles exceeds the auto threshold (24); triangle-"
                    "blocker shadow curves are OFF (sphere blockers stay "
                    "on). Pass tri_blockers=True to force.", stacklevel=2)
        if shadow and scene.num_area_lights and (
                scene.num_spheres or (tb and scene.num_triangles)):
            sbnd = shadow_boundary_grad(scene, params, cam_params, dL_dI,
                                        width, height, seed, n_phi=n_phi,
                                        physical=physical, tri_blockers=tb)
            grad = {k: grad[k] + sbnd[k] for k in grad}
        lap()
        if times is not None:
            STEP_TIMES.append({name: (b - a) * 1e3 for name, a, b in zip(
                ("interior", "adjoint", "detector", "boundary", "shadow"),
                times, times[1:])})
        return val, grad

    return value_and_grad
