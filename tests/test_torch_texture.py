"""Color and normal mapping in the port on the CPU, function by function,
against the JAX package: ``ops/texture.py`` (plain PyTorch), the texture block
of the CUDA kernels (``csrc/megakernel.cuh``, built for the host by
torch_port_helpers.py; needs g++) with its adjoint bundle and the backward
kernel's hand-written perturbation pullback (``csrc/megakernel_vjp.cuh``)
against ``jax.vjp`` of the reference's own functions, ``pack_scene``'s texture
bundle, and the OBJ/MTL loader.

Inputs are made from a seed with numpy. Tolerances, with their reason:
- the polynomials and the bilinear sample: the same float32 formulas in the
  same order on both sides; XLA may contract a*b+c into an FMA -> rtol 2e-6,
  atol 1e-7;
- the texture block and apply_maps: on top of that the two libraries'
  sqrt / rsqrt and a Moller-Trumbore recompute in another association order
  -> rtol 1e-5, atol 1e-6;
- derivatives: a hand-written derivative against reverse-mode autodiff of the
  same formula rounds differently along a longer chain -> rtol 1e-4 and an
  atol of 1e-6 of the largest value compared.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.models.scene import MaterialSpec as JMaterialSpec
from cuda_path_tracer_ss_tpu.models.scene import SceneBuilder as JSceneBuilder
from cuda_path_tracer_ss_tpu.ops import texture as jtex
from cuda_path_tracer_ss_tpu.ops.bsdf import lookup_materials
from cuda_path_tracer_ss_tpu.ops.intersect import nearest_hit, surfel_at
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.ops.vec import Vec3
from cuda_path_tracer_ss_tpu.utils import image as jimage
from cuda_path_tracer_ss_tpu.utils import obj as jobj
from cuda_path_tracer_ss_torch.models.scene import MaterialSpec, SceneBuilder, scene_to_numpy
from cuda_path_tracer_ss_torch.ops import texture as ttex
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.utils import obj as tobj
from torch_port_helpers import (jax_scene_to_numpy, jax_textured_quad, norm3_vjp_hostbuild,
                                perturb_normal_vjp_hostbuild, poly_hostbuild, port_scene,
                                tex_fetch_hostbuild, texture_block_hostbuild)

TOL = dict(rtol=2e-6, atol=1e-7)
TOL_BLOCK = dict(rtol=1e-5, atol=1e-6)


def _v3(v):
    """A JAX Vec3 of [N] as one [N, 3] array."""
    return jnp.stack([v.x, v.y, v.z], -1)


def _close_d(got, want, err_msg=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale, err_msg=err_msg)


def _poly_inputs():
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.uniform(-4.0, 4.0, 200), rng.standard_cauchy(100) * 10.0,
        [0.0, -0.0, 1e-13, -1e-13, 2e-12, 0.4142135, 0.4142136, 2.4142134, 2.4142137,
         -2.4142137, 1.0, -1.0, 0.999999, -0.999999, 1e6, -1e6]]).astype(np.float32)
    y = rng.uniform(-3.0, 3.0, x.size).astype(np.float32)
    y[::7] = 0.0
    return x, y


# ---- the polynomials, the UVs, the bilinear sample --------------------------------

@pytest.mark.parametrize("impl", ["torch", "host"])
def test_polynomials_match_jax(impl):
    x, y = _poly_inputs()
    xa = np.clip(x, -1.2, 1.2)          # asinf's domain is clipped to [-1, 1]
    want = [jtex.atanf(jnp.asarray(x)), jtex.atan2f(jnp.asarray(y), jnp.asarray(x)),
            jtex.asinf(jnp.asarray(xa))]
    if impl == "torch":
        got = [ttex.atanf(torch.from_numpy(x)), ttex.atan2f(torch.from_numpy(y),
                                                             torch.from_numpy(x)),
               ttex.asinf(torch.from_numpy(xa))]
        got = [g.numpy() for g in got]
    else:
        got = list(poly_hostbuild(x, y)[:2]) + [poly_hostbuild(xa, y)[2]]
    for name, g, w in zip(("atanf", "atan2f", "asinf"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)


def test_polynomial_derivatives_match_jax_grad():
    """The backward kernel's hand-written derivatives of the polynomials,
    against jax.grad of the reference's functions (its convention at the
    kinks: |x|' = +1 at 0, sign' = 0, a clamped input gets nothing)."""
    x, y = _poly_inputs()
    xa = np.clip(x, -0.99, 0.99)
    d_atan = jax.vmap(jax.grad(jtex.atanf))(jnp.asarray(x))
    d_y, d_x = jax.vmap(jax.grad(jtex.atan2f, argnums=(0, 1)))(jnp.asarray(y), jnp.asarray(x))
    d_asin = jax.vmap(jax.grad(jtex.asinf))(jnp.asarray(xa))
    got = poly_hostbuild(x, y)
    _close_d(got[3], d_atan, "atan'")
    _close_d(got[4], d_y, "d atan2 / dy")
    _close_d(got[5], d_x, "d atan2 / dx")
    _close_d(poly_hostbuild(xa, y)[6], d_asin, "asin'")


def test_sphere_uv_poles_and_seam_match_jax():
    rng = np.random.default_rng(5)
    n = rng.standard_normal((256, 3)).astype(np.float32)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    special = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [-1, 0, -0.0],
                        [-1, 0, 1e-7], [-1, 0, -1e-7], [0, 0, 1], [0, 0, -1],
                        [1e-13, 1, 1e-13]], np.float32)
    n = np.concatenate([n, special])
    ju, jv = jtex.sphere_uv(Vec3(*(jnp.asarray(n[:, k]) for k in range(3))))
    tu, tv = ttex.sphere_uv(*(torch.from_numpy(n[:, k]) for k in range(3)))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tv.numpy()[256:258], [1.0, 0.0], atol=1e-6)   # the poles
    np.testing.assert_allclose(tu.numpy()[258], 0.5, atol=1e-6)               # +x


def _atlas_case():
    """Two textures of unequal sizes in the JAX layout, plus the lanes."""
    rng = np.random.default_rng(9)
    b = JSceneBuilder()
    b.add_texture(rng.uniform(0, 1, (3, 5, 3)).astype(np.float32))
    b.add_texture(rng.uniform(0, 1, (4, 2, 3)).astype(np.float32))
    b.add_material(JMaterialSpec(diffuse=(1, 1, 1), diff_avg=0.5, texture=0))
    b.add_sphere((0, 0, -4), 1.0, 0)
    scene = b.build()
    m = 300
    u = rng.uniform(-2.5, 3.5, m).astype(np.float32)
    v = rng.uniform(-2.5, 3.5, m).astype(np.float32)
    u[:4] = [0.1, 0.5, 0.9, 0.3]        # texel centres of the 5-wide texture
    v[:4] = [5 / 6, 0.5, 1 / 6, 0.5]
    tid = rng.integers(0, 2, m).astype(np.int32)
    tid[:4] = 0
    return scene, tid, u, v


def test_sample_bilinear_matches_jax():
    """Negative and > 1 UVs (the wrap), exact texel centres; the padded-atlas
    form (torch) and the kernel's fetch from the flat atlas (host build)."""
    scene, tid, u, v = _atlas_case()
    want = np.asarray(_v3(jtex.sample_bilinear(scene.textures, scene.tex_hw,
                                               jnp.asarray(tid), jnp.asarray(u),
                                               jnp.asarray(v))))
    pscene = port_scene(scene)
    got = ttex.sample_bilinear(pscene.textures, pscene.tex_hw, torch.from_numpy(tid),
                               torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(torch.stack(got, -1).numpy(), want, **TOL)
    val = tex_fetch_hostbuild(tmk.pack_scene(pscene, "cpu"), tid.astype(np.float32), u, v)[0]
    np.testing.assert_allclose(val, want, **TOL)
    np.testing.assert_allclose(want[0], scene.textures[0, 0, 0], atol=1e-6)


def test_texel_uv_derivatives_match_jax_jvp():
    """d sample / d u and d v of the kernel's fetch, against jax.jvp of the
    reference's sample_bilinear (floor and wrap carry no derivative)."""
    scene, tid, u, v = _atlas_case()

    def f(uu, vv):
        return _v3(jtex.sample_bilinear(scene.textures, scene.tex_hw, jnp.asarray(tid),
                                        uu, vv))

    ones, zeros = jnp.ones(u.shape), jnp.zeros(u.shape)
    _, want_du = jax.jvp(f, (jnp.asarray(u), jnp.asarray(v)), (ones, zeros))
    _, want_dv = jax.jvp(f, (jnp.asarray(u), jnp.asarray(v)), (zeros, ones))
    _, _, _, du, dv = tex_fetch_hostbuild(tmk.pack_scene(port_scene(scene), "cpu"),
                                          tid.astype(np.float32), u, v)
    _close_d(du, want_du, "d/du")
    _close_d(dv, want_dv, "d/dv")


# ---- the texture block at hits -----------------------------------------------------

SCENES = {
    "color quad": lambda: jax_textured_quad(),
    "color+normal quad": lambda: jax_textured_quad(nmap=True),
    "color+normal sphere": lambda: jax_textured_quad(nmap=True, sphere=True),
    "textured preset": jpresets.textured,
}


def _hits(jscene, lanes=128, seed=3):
    """``lanes`` camera rays that hit, and the JAX engine's hits on them."""
    rng = np.random.default_rng(seed)
    cp_pos = np.asarray(JCamera().position, np.float32)
    targets = np.stack([rng.uniform(-1.4, 1.4, lanes), rng.uniform(-1.4, 1.4, lanes),
                        np.full(lanes, -4.0)], -1)
    if jscene is not None and jscene.num_triangles > 10:       # the preset: look around
        targets = np.stack([rng.uniform(-3.5, 3.5, lanes), rng.uniform(-3.9, 0.5, lanes),
                            rng.uniform(-7.5, -3.0, lanes)], -1)
    d = targets - cp_pos
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(cp_pos, d.shape).astype(np.float32)
    ro = Vec3(*(jnp.asarray(o[:, k]) for k in range(3)))
    rd = Vec3(*(jnp.asarray(d[:, k]) for k in range(3)))
    hit = nearest_hit(ro, rd, jscene)
    surf = surfel_at(ro, rd, hit, jscene)
    keep = np.asarray(hit.hit)
    nrm = np.stack([np.asarray(c) for c in (surf.normal.x, surf.normal.y, surf.normal.z)], -1)
    return (o[keep], d[keep], np.asarray(hit.prim)[keep], np.asarray(surf.mat)[keep],
            nrm[keep], (ro, rd, hit, surf))


@pytest.mark.parametrize("name", list(SCENES))
def test_apply_maps_matches_jax(name):
    """The plain render's texture block (``_texture_block_plain``) and the
    kernels' texture_block (host build), each against the reference's
    apply_maps at the same hits."""
    jscene = SCENES[name]()
    o, d, prim, mat, nrm, (ro, rd, hit, surf) = _hits(jscene)
    assert len(prim) > 40
    m = lookup_materials(jscene.materials, surf.mat)
    jm, jsurf = jtex.apply_maps(jscene, ro, rd, hit, surf, m)
    keep = np.asarray(hit.hit)
    want_d = np.asarray(_v3(jm.diffuse))[keep]
    want_n = np.asarray(_v3(jsurf.normal))[keep]
    scene = port_scene(jscene)
    packed = tmk.pack_scene(scene, "cpu")
    base_d = scene.materials.diffuse[torch.from_numpy(mat).long()]
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in
         (("o", o), ("d", d), ("n", nrm))}
    got_d, got_n = (torch.stack(c, -1) for c in tmk._texture_block_plain(
        packed, *t["o"].unbind(-1), *t["d"].unbind(-1), torch.from_numpy(prim).long(),
        torch.from_numpy(mat).long(), *t["n"].unbind(-1), base_d.unbind(-1)))
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL_BLOCK)
    np.testing.assert_allclose(got_n.numpy(), want_n, **TOL_BLOCK)
    hd, hn, _ = texture_block_hostbuild(packed, o, d, prim, mat, nrm)
    np.testing.assert_allclose(hd, want_d, **TOL_BLOCK)
    np.testing.assert_allclose(hn, want_n, **TOL_BLOCK)
    if jscene.materials.nmap_id.max() >= 0:
        assert np.abs(want_n - nrm).max() > 1e-3     # the normal map did something


def _jax_block_inputs(jscene, prim, mat, o, d, nrm):
    """The Pallas module's _texture_block fed with arrays for its refs, on
    one row of 128 lanes (lane count of its per-lane gathers)."""
    jp = jmk.pack_scene(jscene)
    lanes = 128
    pad = lanes - len(prim)
    assert pad >= 0

    def row(a, fill=0.0):
        a = np.concatenate([np.asarray(a, np.float32), np.full(pad, fill, np.float32)])
        return jnp.asarray(a[None, :])

    refs = dict(texmeta_ref=jp.tex_meta.reshape(-1), triuv_ref=jp.tex_triuv.reshape(-1),
                matids_ref=jp.tex_matids.reshape(-1), tri_ref=jp.triangles.reshape(-1))
    lane = dict(ox=row(o[:, 0]), oy=row(o[:, 1]), oz=row(o[:, 2]),
                dx=row(d[:, 0]), dy=row(d[:, 1]), dz=row(d[:, 2]),
                prim_f=row(prim, -1.0), mat_f=row(mat))
    mats = np.asarray(jp.materials)
    mf = [row(mats[mat, f]) for f in range(20)]
    return jp, refs, lane, mf, (row(nrm[:, 0]), row(nrm[:, 1]), row(nrm[:, 2]))


@pytest.mark.parametrize("name", ["color+normal quad", "color+normal sphere",
                                  "textured preset"])
def test_texture_block_adjoint_bundle_matches_jax(name):
    """What the backward kernel's replay keeps of the texture block —
    corners' flat atlas indices and weights, d texel / d(u, v), the UV
    partials (triangles: the dual basis; spheres: the polynomial UVs'
    derivatives, which the reference takes with jax.vjp) — against the
    reference kernel's own bundle (``_texture_block(want_aux=True)``)."""
    jscene = SCENES[name]()
    o, d, prim, mat, nrm, _ = _hits(jscene, lanes=128)
    jp, refs, lane, mf, (nx, ny, nz) = _jax_block_inputs(jscene, prim, mat, o, d, nrm)
    k = len(prim)
    _, aux = jmk._texture_block(jp.tex_counts, jscene.num_spheres, jscene.num_triangles,
                                (1, 128), tex_ref=jp.tex_planes, nx=nx, ny=ny, nz=nz, mf=mf,
                                want_aux=True, want_nmap_aux=True, **refs, **lane)
    has_c, _tex, c_idx, c_w, (c_du, c_dv), uvg, (has_n, n_val, n_idx, n_w, (n_du, n_dv)) = aux

    def lanes_of(x):
        return np.asarray(x)[0, :k]

    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    _, _, got_uvg = texture_block_hostbuild(packed, o, d, prim, mat, nrm)
    want_uvg = np.stack([lanes_of(g) for g in uvg], -1)
    _close_d(got_uvg, want_uvg, "uv partials")
    matids = packed.tex_matids.numpy()
    for fetch, tid_col, has, idx, w, du, dv in (
            ("color", 0, has_c, c_idx, c_w, c_du, c_dv),
            ("normal", 1, has_n, n_idx, n_w, n_du, n_dv)):
        sel = lanes_of(has).astype(bool)
        if not sel.any():
            continue
        # the host fetch at the reference's UVs is what texture_block fetched
        g_val, g_idx, g_w, g_du, g_dv = _host_fetch_at_hits(packed, jscene, prim, mat, o, d,
                                                            nrm, matids[mat, tid_col])
        np.testing.assert_array_equal(g_idx[sel], np.stack([lanes_of(i) for i in idx],
                                                           -1)[sel], err_msg=fetch)
        # weights are fractional parts of u * width: a few ulps of a
        # barycentric (XLA contracts FMAs) times the width, absolute
        np.testing.assert_allclose(g_w[sel], np.stack([lanes_of(x) for x in w], -1)[sel],
                                   err_msg=fetch, rtol=0, atol=1e-5)
        _close_d(g_du[sel], np.stack([lanes_of(x) for x in du], -1)[sel], fetch + " d/du")
        _close_d(g_dv[sel], np.stack([lanes_of(x) for x in dv], -1)[sel], fetch + " d/dv")
        if fetch == "normal":
            np.testing.assert_allclose(g_val[sel], np.stack([lanes_of(x) for x in n_val],
                                                            -1)[sel], **TOL_BLOCK)


def _host_fetch_at_hits(packed, jscene, prim, mat, o, d, nrm, tid):
    """tex_fetch of texture ``tid`` at the UVs texture_block computes for
    these hits (the port's apply_maps UV code on the same inputs)."""
    scene = port_scene(jscene)
    S = scene.num_spheres
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in
         (("o", o), ("d", d), ("n", nrm))}
    nx, ny, nz = t["n"].unbind(-1)
    inv = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-20))
    u, v = ttex.sphere_uv(nx * inv, ny * inv, nz * inv)
    if scene.num_triangles:
        is_tri = torch.from_numpy(prim) >= S
        ti = torch.clamp(torch.from_numpy(prim).long() - S, 0, scene.num_triangles - 1)
        rc = packed.triangles[ti].unbind(-1)
        uc = packed.tex_triuv[ti].unbind(-1)
        _, w1, w2, _ = tmk._triangle_t(*t["o"].unbind(-1), *t["d"].unbind(-1), rc[0:3],
                                       rc[3:6], rc[6:9])
        w0 = 1.0 - (w1 + w2)
        u = torch.where(is_tri, uc[0] * w0 + uc[2] * w1 + uc[4] * w2, u)
        v = torch.where(is_tri, uc[1] * w0 + uc[3] * w1 + uc[5] * w2, v)
    return tex_fetch_hostbuild(packed, tid, u.numpy(), v.numpy())


@pytest.mark.parametrize("name", ["color+normal quad", "color+normal sphere"])
def test_perturbation_pullback_matches_jax_vjp(name):
    """The backward kernel's hand-written pullback of the tangent-frame
    perturbation (perturb_normal_vjp) — and, on a sphere, the normal map's UV
    swim through the polynomial UVs — against jax.vjp of the reference
    kernel's _texture_block: the cotangent of the perturbed normal pulled
    into the raw normal and into the normal map's texels."""
    jscene = SCENES[name]()
    o, d, prim, mat, nrm, _ = _hits(jscene, lanes=128)
    k = len(prim)
    jp, refs, lane, mf, (nx, ny, nz) = _jax_block_inputs(jscene, prim, mat, o, d, nrm)
    rng = np.random.default_rng(17)
    g = rng.standard_normal((k, 3)).astype(np.float32)
    g_rows = [jnp.asarray(np.concatenate([g[:, c], np.zeros(128 - k, np.float32)])[None])
              for c in range(3)]

    def f(ax, ay, az, planes):
        out = jmk._texture_block(jp.tex_counts, jscene.num_spheres, jscene.num_triangles,
                                 (1, 128), tex_ref=planes, nx=ax, ny=ay, nz=az, mf=mf,
                                 **refs, **lane)
        return out[3:6]

    _, pull = jax.vjp(f, nx, ny, nz, jp.tex_planes)
    a_nx, a_ny, a_nz, a_planes = pull(tuple(g_rows))
    want_an = np.stack([np.asarray(a)[0, :k] for a in (a_nx, a_ny, a_nz)], -1)
    num_tex, rows = jp.tex_counts
    texels = int(np.asarray(jp.tex_meta)[-1, 0] + np.asarray(jp.tex_meta)[-1, 1]
                 * np.asarray(jp.tex_meta)[-1, 2])
    want_at = np.stack([np.asarray(a_planes)[c * rows:(c + 1) * rows].reshape(-1)[:texels]
                        for c in range(3)], -1)

    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    nid = packed.tex_matids.numpy()[mat, 1]
    val, idx, w, du, dv = _host_fetch_at_hits(packed, jscene, prim, mat, o, d, nrm, nid)
    an, at = perturb_normal_vjp_hostbuild(packed, prim, nrm, val, g)
    got_at = np.zeros((texels, 3), np.float32)
    for c in range(3):
        for q in range(4):
            np.add.at(got_at[:, c], idx[:, q], at[:, c] * w[:, q])
    if jscene.num_spheres:
        # the sphere's UVs move with its normal: the texels' cotangent swims
        _, _, uvg = texture_block_hostbuild(packed, o, d, prim, mat, nrm)
        a_u = (at * du).sum(-1)
        a_v = (at * dv).sum(-1)
        swim = norm3_vjp_hostbuild(nrm.T, [a_u * uvg[:, 0], a_v * uvg[:, 2],
                                           a_u * uvg[:, 1]], 1e-20).T
        an = an + swim
    _close_d(an, want_an, "raw normal")
    _close_d(got_at, want_at, "normal-map texels")
    assert np.abs(want_at).max() > 1e-3


# ---- pack_scene's texture bundle ---------------------------------------------------

@pytest.mark.parametrize("name", ["textured preset", "color+normal quad",
                                  "color+normal sphere"])
def test_pack_scene_texture_bundle_matches_jax(name):
    """tex_meta / tex_triuv / tex_matids equal the reference's; the flat
    atlas holds the texels of the reference's channel-planed one."""
    jscene = SCENES[name]()
    jp = jmk.pack_scene(jscene)
    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    num_tex, rows = jp.tex_counts
    assert packed.tex_counts[0] == num_tex
    for field in ("tex_meta", "tex_triuv", "tex_matids"):
        np.testing.assert_array_equal(getattr(packed, field).numpy(),
                                      np.asarray(getattr(jp, field)), err_msg=field)
    texels = packed.tex_counts[1]
    planes = np.asarray(jp.tex_planes)
    want = np.stack([planes[c * rows:(c + 1) * rows].reshape(-1)[:texels]
                     for c in range(3)], -1)
    np.testing.assert_array_equal(packed.tex_atlas.numpy(), want)
    assert packed.tex_nmap == bool((np.asarray(jscene.materials.nmap_id) >= 0).any())


def test_pack_scene_atlas_is_autograd_transparent():
    """A texel cotangent flows back into scene.textures; padding texels of
    the [K, TH, TW, 3] atlas get 0."""
    scene = port_scene(jpresets.textured())
    tex = scene.textures.clone().requires_grad_(True)
    packed = tmk.pack_scene(scene.replace(textures=tex), "cpu")
    cot = torch.arange(packed.tex_atlas.numel(), dtype=torch.float32).reshape(-1, 3)
    (g,) = torch.autograd.grad((packed.tex_atlas * cot).sum(), tex)
    hw = scene.tex_hw.numpy()
    off = 0
    for k, (h, w) in enumerate(hw):
        np.testing.assert_array_equal(g[k, :h, :w].reshape(-1, 3).numpy(),
                                      cot[off:off + h * w].numpy())
        assert float(g[k, h:].abs().sum() + g[k, :, w:].abs().sum()) == 0.0
        off += h * w


# ---- the OBJ / MTL loader -----------------------------------------------------------

OBJ_TEXT = """# a textured quad, a fan-triangulated pentagon and relative indices
mtllib m.mtl
v -2 -2 -4
v 2 -2 -4
v 2 2 -4
v -2 2 -4
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl skin
f 1/1/1 2/2/1 3/3/1 4/4/1
v 0 0 -5
v 1 0 -5
v 1.3 1 -5
v 0.5 1.6 -5
v -0.3 1 -5
usemtl bumpy
f -5 -4 -3 -2 -1
usemtl missing
f 5//1 6//1 7//1
"""
MTL_TEXT = """newmtl skin
Kd 1 1 1
Ks 0.2 0.2 0.2
Ns 2000
map_Kd skin.png
newmtl bumpy
Kd 0.8 0.6 0.4
d 0.5
Ni 1.4
Pr 0.3
Ke 0.1 0 0
bump -bm 1 bump.png
newmtl glassy
Tr 0.25
Kd 0.2 0.9 0.2
"""


def _write_obj(tmp_path):
    skin = np.zeros((2, 3, 3), np.uint8)
    skin[:, 0] = (255, 20, 20)
    skin[:, 1] = (20, 255, 20)
    skin[:, 2] = (20, 20, 255)
    jimage.write_png(str(tmp_path / "skin.png"), skin, bottom_up=False)
    bump = np.full((2, 2, 3), (200, 128, 230), np.uint8)
    jimage.write_png(str(tmp_path / "bump.png"), bump, bottom_up=False)
    (tmp_path / "m.mtl").write_text(MTL_TEXT)
    (tmp_path / "q.obj").write_text(OBJ_TEXT)
    return str(tmp_path / "q.obj")


def test_parse_obj_matches_jax(tmp_path):
    path = _write_obj(tmp_path)
    for got, want in zip(tobj.parse_obj_ex(OBJ_TEXT), jobj.parse_obj_ex(OBJ_TEXT)):
        if isinstance(want, list):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tobj.load_obj(path), jobj.load_obj(path)):
        np.testing.assert_array_equal(got, want)
    assert tobj._find_mtllib(OBJ_TEXT) == jobj._find_mtllib(OBJ_TEXT) == "m.mtl"


def test_parse_mtl_matches_jax():
    specs, files = tobj.parse_mtl_ex(MTL_TEXT)
    jspecs, jfiles = jobj.parse_mtl_ex(MTL_TEXT)
    assert files == jfiles
    assert list(specs) == list(jspecs) == ["skin", "bumpy", "glassy"]
    for name in specs:
        assert isinstance(specs[name], MaterialSpec)
        assert vars(specs[name]) == vars(jspecs[name]), name
    assert list(tobj.parse_mtl(MTL_TEXT)) == list(specs)


@pytest.mark.parametrize("transform", [None, "scaled"])
def test_add_obj_with_mtl_matches_jax(tmp_path, transform):
    """OBJ + MTL + PNG maps: the same scene arrays, bit for bit, color map
    and normal map bound, unknown usemtl on the fallback material."""
    path = _write_obj(tmp_path)
    t = None
    if transform:
        t = np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)
        t[:3, 3] = (0.1, -0.5, -1.0)
    scenes = []
    for builder, spec, load in ((SceneBuilder, MaterialSpec, tobj.add_obj_with_mtl),
                                (JSceneBuilder, JMaterialSpec, jobj.add_obj_with_mtl)):
        b = builder()
        fb = b.add_material(spec(diffuse=(0.5, 0.5, 0.5), diff_avg=0.5))
        count, mmap = load(b, path, fb, transform=t)
        assert count == 6 and sorted(mmap) == ["bumpy", "glassy", "skin"]
        b.add_point_light((0.0, 0.0, -1.0), (60.0, 60.0, 60.0))
        scenes.append(b.build())
    got, want = scene_to_numpy(scenes[0]), jax_scene_to_numpy(scenes[1])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert scenes[0].num_textures == 2
    np.testing.assert_array_equal(got["materials.tex_id"], [-1, 0, -1, -1])
    np.testing.assert_array_equal(got["materials.nmap_id"], [-1, -1, 1, -1])


def test_add_obj_mesh_from_text_matches_jax():
    from cuda_path_tracer_ss_torch.models.presets import _icosahedron_obj

    out = []
    for builder, add in ((SceneBuilder, tobj.add_obj_mesh), (JSceneBuilder, jobj.add_obj_mesh)):
        b = builder()
        assert add(b, _icosahedron_obj(), 0, from_text=True) == 20
        out.append(b)
    np.testing.assert_array_equal(np.asarray([t[:6] for t in out[0].triangles]),
                                  np.asarray([t[:6] for t in out[1].triangles]))
