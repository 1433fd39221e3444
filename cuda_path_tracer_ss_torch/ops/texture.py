"""Color and normal mapping, as plain PyTorch functions on ``[N]`` tensors.

The counterpart of the JAX package's ``ops/texture.py``, function for
function, and the behavioural spec of the kernels' texture block
(``csrc/megakernel.cuh::texture_block``) and of the plain render's
(``ops/cuda/megakernel.py::_texture_block_plain``):

* **UV source** — triangles carry per-corner UVs (``Scene.tri_uv*``),
  barycentrically interpolated; spheres use a procedural spherical
  parameterisation of the unit hit normal (``sphere_uv``).
* **Color map** — a bilinear, wrap-around sample modulates the material's
  diffuse albedo at the hit. ``diff_avg`` stays the branch probability, so
  texturing never changes which paths are traced.
* **Normal map** — the tangent-space texel ``2 c - 1`` rotated into the
  surface frame (tangent along the UV parameterisation, orthonormalised
  against the interpolated normal), rescaled to the normal's length.

``atanf`` / ``atan2f`` / ``asinf`` are the reference's branchless
polynomials, not ``torch.atan2``: both engines of the reference evaluate
them, and so do the kernels here (ROADMAP Queue 1 item 5), so sphere UVs
agree per pixel.
"""
from __future__ import annotations

import math

import torch

_PI = math.pi
_TWO_PI = 2.0 * math.pi


def atanf(x):
    """Branchless float32 arctangent (Cephes atanf coefficients, max error
    ~1e-7). The 1e-12 floor keeps the unselected branch's derivative finite
    (an inf there times a zero cotangent is NaN)."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095    # tan(3 pi / 8)
    mid = ax > 0.4142135623730950   # tan(pi / 8)
    safe_ax = torch.clamp_min(ax, 1e-12)
    t = torch.where(big, -1.0 / safe_ax,
                    torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    y0 = torch.where(big, _PI / 2, torch.where(mid, _PI / 4, 0.0))
    z = t * t
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * t + t
    return torch.sign(x) * (y0 + p)


def atan2f(y, x):
    """Four-quadrant arctangent on :func:`atanf`; |x| is floored at 1e-12
    (the uv pole of a sphere) so that the quotient stays finite."""
    ax = torch.abs(x)
    safe_x = torch.where(ax < 1e-12, torch.where(x < 0.0, -1e-12, 1e-12), x)
    a = atanf(y / safe_x)
    return torch.where(x < 0.0, a + torch.where(y >= 0.0, _PI, -_PI), a)


def asinf(x):
    """arcsin on [-1, 1] via :func:`atanf`."""
    xc = torch.clamp(x, -1.0, 1.0)
    return atanf(xc / torch.sqrt(torch.clamp_min(1.0 - xc * xc, 1e-12)))


def sphere_uv(nx, ny, nz):
    """Spherical parameterisation of a unit normal: u wraps longitude
    (atan2 around +y), v runs latitude 0 (south pole) -> 1 (north)."""
    u = 0.5 + atan2f(nz, nx) / _TWO_PI
    v = 0.5 + asinf(ny) / _PI
    return u, v


def _sphere_tangent(nx, ny, nz):
    """d(position)/du direction of ``sphere_uv`` (longitude circles) with a
    pole fallback, for a unit normal."""
    st2 = nz * nz + nx * nx
    degen = st2 < 1e-12
    inv = torch.rsqrt(torch.clamp_min(st2, 1e-20))
    return (torch.where(degen, 1.0, -nz * inv), torch.zeros_like(ny),
            torch.where(degen, 0.0, nx * inv))


def bilinear(texel, h, w, u, v):
    """Bilinear, wrap-around sample at (u, v) of one texture per lane of
    true size (h, w) (float tensors; v = 0 at the BOTTOM of the image).
    ``texel(x, y)`` returns the ``[N, 3]`` texels at integer coordinates,
    already wrapped by the caller's ``wrap``. Returns the ``[N, 3]``
    sample."""
    uu = (u - torch.floor(u)) * w - 0.5
    vv = (1.0 - (v - torch.floor(v))) * h - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0
    return (texel(x0, y0) * ((1 - fx) * (1 - fy))[:, None]
            + texel(x0 + 1, y0) * (fx * (1 - fy))[:, None]
            + texel(x0, y0 + 1) * ((1 - fx) * fy)[:, None]
            + texel(x0 + 1, y0 + 1) * (fx * fy)[:, None])


def wrap(xi, n):
    """Floor modulo of the float texel coordinate ``xi`` by the integer size
    ``n``: -1 wraps to n - 1 (C's ``%`` would give -1)."""
    return torch.remainder(xi.to(torch.int64), n)


def sample_bilinear(textures, tex_hw, tid, u, v):
    """Bilinear, wrap-around sample of the padded atlas ``textures [K, TH,
    TW, 3]`` with true sizes ``tex_hw [K, 2]``; ``tid`` [N] texture index
    (callers mask tid < 0 themselves). Returns (r, g, b) of [N]."""
    k = torch.clamp(tid.to(torch.int64), 0, textures.shape[0] - 1)
    hi = tex_hw[k, 0].to(torch.int64)
    wi = tex_hw[k, 1].to(torch.int64)

    def texel(xi, yi):
        return textures[k, wrap(yi, hi), wrap(xi, wi)]

    c = bilinear(texel, hi.to(torch.float32), wi.to(torch.float32), u, v)
    return c.unbind(-1)


def perturb_normal(nx, ny, nz, tgx, tgy, tgz, t0, t1, t2):
    """The normal map's tangent-frame perturbation of the raw normal n by
    the texel (t0, t1, t2), the tangent source tg orthonormalised against
    the unit normal; the result keeps n's length. Returns the new normal."""
    n2 = nx * nx + ny * ny + nz * nz
    inv_nl = torch.rsqrt(torch.clamp_min(n2, 1e-20))
    nux, nuy, nuz = nx * inv_nl, ny * inv_nl, nz * inv_nl
    tdn = tgx * nux + tgy * nuy + tgz * nuz
    pox = tgx - nux * tdn
    poy = tgy - nuy * tdn
    poz = tgz - nuz * tdn
    po_inv = torch.rsqrt(torch.clamp_min(pox * pox + poy * poy + poz * poz,
                                         1e-20))
    pox, poy, poz = pox * po_inv, poy * po_inv, poz * po_inv
    bx = nuy * poz - nuz * poy
    by = nuz * pox - nux * poz
    bz = nux * poy - nuy * pox
    tnx = t0 * 2.0 - 1.0
    tny = t1 * 2.0 - 1.0
    tnz = torch.clamp_min(t2 * 2.0 - 1.0, 1e-3)
    ppx = pox * tnx + bx * tny + nux * tnz
    ppy = poy * tnx + by * tny + nuy * tnz
    ppz = poz * tnx + bz * tny + nuz * tnz
    pp_inv = torch.rsqrt(torch.clamp_min(ppx * ppx + ppy * ppy + ppz * ppz,
                                         1e-20))
    s = pp_inv * torch.sqrt(torch.clamp_min(n2, 1e-20))
    return ppx * s, ppy * s, ppz * s


def triangle_uv_tangent(e1, e2, uv0, uv1, uv2):
    """UV-aligned tangent of triangles with edges e1, e2 (3-tuples of [N])
    and corner UVs (2-tuples): (e1 dv2 - e2 dv1) / det, or the unit e1
    where the UV map is degenerate."""
    du1 = uv1[0] - uv0[0]
    dv1 = uv1[1] - uv0[1]
    du2 = uv2[0] - uv0[0]
    dv2 = uv2[1] - uv0[1]
    det = du1 * dv2 - du2 * dv1
    det_bad = torch.abs(det) < 1e-12
    inv_det = torch.where(det_bad, 0.0, 1.0 / torch.where(det_bad, 1.0, det))
    tt = [(e1[c] * dv2 - e2[c] * dv1) * inv_det for c in range(3)]
    degen = det_bad | ((tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]) < 1e-16)
    e1inv = torch.rsqrt(torch.clamp_min(
        e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2], 1e-20))
    return tuple(torch.where(degen, e1[c] * e1inv, tt[c]) for c in range(3))


def apply_maps(scene, ro, rd, prim, normal, mat, diffuse):
    """Texture the per-lane material and surfel of a scene (``ro``, ``rd``,
    ``normal``, ``diffuse`` [N, 3]; ``prim``, ``mat`` [N] int): returns
    (diffuse', normal') with the diffuse albedo modulated by the color map
    and the shading normal perturbed by the normal map; lanes whose maps are
    -1 pass through. The plain render's texture block on the scene's packed
    tables; no random numbers."""
    from .cuda.megakernel import _texture_block_plain, pack_scene

    if not scene.num_textures:
        return diffuse, normal
    new_d, new_n = _texture_block_plain(
        pack_scene(scene, ro.device), *ro.unbind(-1), *rd.unbind(-1),
        prim.to(torch.int64), mat.to(torch.int64), *normal.unbind(-1),
        diffuse.unbind(-1))
    return torch.stack(new_d, -1), torch.stack(new_n, -1)
