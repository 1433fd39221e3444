"""K2's geo mode (``grad_mode="geo"``: triangle-vertex and corner-normal
gradients, and the area lights' vertices) against the reference.

- Each hand-written adjoint of the backward kernel's geo terms (host build of
  csrc/megakernel_vjp.cuh, needs g++) against ``jax.vjp`` of the reference's
  function: the Moller-Trumbore adjoint (``_triangle_t``), the UVs' vertex
  terms at a fixed hit point (the metric solve of the plane barycentrics) and
  the tangent frame's edge terms (``_texture_block`` on a constant normal
  map, where nothing else moves with the vertices). Tolerances rtol 1e-4,
  atol 1e-6 * max|g|.
- The plain version's autograd against ``jax.value_and_grad`` of the jnp
  engine, and the host build of the whole kernel against both, on the
  reference's tilted quad, on cornell (its light triangles: the NEE
  light-vertex rows) and on a color- and a normal-mapped quad, at
  tests/test_pallas_vjp.py's tolerances (loss rtol 1e-5; gradients rtol
  1e-3, atol 1e-4 * max|g|).
- One case through the TPU backward kernel itself in interpret mode.
- The layout (gradient rows, checkpoint planes) equals the reference's, and
  geo through the grid raises the reference's ValueError.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel_vjp as jvjp
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.ops.grid import build_grid
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from test_torch_texture import _hits, _jax_block_inputs
from torch_port_helpers import (assert_grads_close, jax_textured_quad, jax_tilted_quad,
                                jax_value_and_grad,
                                port_scene, port_value_and_grad, tangent_edges_vjp_hostbuild,
                                triangle_t_vjp_hostbuild, uv_vertex_vjp_hostbuild)

CP = camera_arrays(Camera())
GEO_FIELDS = ["tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
              "materials.diffuse"]


def _close(got, want, err_msg=""):
    """The per-function tolerance: rtol 1e-4, atol 1e-6 * max|want|."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale, err_msg=err_msg)


# ---- the hand-written adjoints against jax.vjp ----------------------------------

def test_triangle_t_vjp_matches_jax_vjp():
    """triangle_t_vjp (the winning triangle's t and barycentrics, pulled into
    the origin, the direction, v0 = -a_s and the edges) against jax.vjp of
    the reference's ``_triangle_t`` at interior hits."""
    rng = np.random.default_rng(21)
    n = 256
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where((np.abs((d * nrm).sum(1)) < 0.3)[:, None], -nrm, d).astype(np.float32)
    w = rng.uniform(0.05, 0.45, (n, 2)).astype(np.float32)
    p = v0 + w[:, :1] * e1 + w[:, 1:] * e2
    o = (p - rng.uniform(0.5, 4.0, (n, 1)) * d).astype(np.float32)
    cots = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]

    def f(o_, d_, v0_, e1_, e2_):
        t, w1, w2, _ = jmk._triangle_t(*o_.T, *d_.T, tuple(v0_.T), tuple(e1_.T), tuple(e2_.T))
        return t, w1, w2

    (t, _, _), pull = jax.vjp(f, *(jnp.asarray(a) for a in (o, d, v0, e1, e2)))
    a_o, a_d, a_v0, a_e1, a_e2 = pull(tuple(jnp.asarray(c) for c in cots))
    got = triangle_t_vjp_hostbuild(o - v0, d, e1, e2, np.asarray(t), *cots)
    _close(got[0], a_o, "origin")
    _close(-got[0], a_v0, "v0")
    _close(got[1], a_d, "direction")
    _close(got[2], a_e1, "e1")
    _close(got[3], a_e2, "e2")


def test_uv_vertex_terms_match_jax_vjp():
    """uv_vertex_vjp: the UVs' cotangents at a FIXED hit point pulled into the
    triangle's (v0, e1, e2) through the metric solve of the plane
    barycentrics, against jax.vjp of that solve. On the plane the solve's
    barycentrics are the reference's Moller-Trumbore ones (checked too)."""
    rng = np.random.default_rng(22)
    n = 256
    tri = np.zeros((n, tmk.T_COLS), np.float32)
    e = rng.uniform(-2, 2, (4 * n, 6))
    # well-shaped triangles: the edges at least 30 degrees apart
    sin = (np.linalg.norm(np.cross(e[:, :3], e[:, 3:]), axis=1)
           / np.linalg.norm(e[:, :3], axis=1) / np.linalg.norm(e[:, 3:], axis=1))
    tri[:, 0:3] = rng.uniform(-2, 2, (n, 3))
    tri[:, 3:9] = e[sin > 0.5][:n]
    uv = rng.uniform(0, 1, (n, 6)).astype(np.float32)
    w = rng.uniform(0.05, 0.45, (n, 2)).astype(np.float32)
    p = tri[:, 0:3] + w[:, :1] * tri[:, 3:6] + w[:, 1:] * tri[:, 6:9]
    a_u, a_v = (rng.standard_normal(n).astype(np.float32) for _ in range(2))

    def uv_at(v0, e1, e2):
        q = p - v0
        d11, d22, d12 = (e1 * e1).sum(1), (e2 * e2).sum(1), (e1 * e2).sum(1)
        det = d11 * d22 - d12 * d12
        s1, s2 = (e1 * q).sum(1), (e2 * q).sum(1)
        a = (d22 * s1 - d12 * s2) / det
        b = (d11 * s2 - d12 * s1) / det
        return (uv[:, 0] + a * (uv[:, 2] - uv[:, 0]) + b * (uv[:, 4] - uv[:, 0]),
                uv[:, 1] + a * (uv[:, 3] - uv[:, 1]) + b * (uv[:, 5] - uv[:, 1]), a, b)

    prims = [jnp.asarray(tri[:, k:k + 3]) for k in (0, 3, 6)]
    (_, _, a, b), pull = jax.vjp(uv_at, *prims)
    np.testing.assert_allclose(np.asarray(a), w[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(b), w[:, 1], rtol=1e-4, atol=1e-5)
    want = pull((jnp.asarray(a_u), jnp.asarray(a_v), jnp.zeros(n), jnp.zeros(n)))
    got = uv_vertex_vjp_hostbuild(tri, uv, p, a_u, a_v)
    for k, name in enumerate(("v0", "e1", "e2")):
        _close(got[:, 3 * k:3 * k + 3], want[k], name)


def test_tangent_edge_terms_match_jax_vjp():
    """The normal map's tangent frame follows the triangle's edges: the
    perturbation pullback's tangent cotangent through tri_uv_tangent_vjp,
    against jax.vjp of the reference kernel's ``_texture_block`` with
    respect to the triangle table, on a constant normal map (its texels do
    not move with the UVs, so the edges' cotangent is the frame's alone)."""
    jscene = jax_textured_quad(tex=False, nmap=True)
    o, d, prim, mat, nrm, _ = _hits(jscene, lanes=128)
    k = len(prim)
    assert k > 40
    jp, refs, lane, mf, (nx, ny, nz) = _jax_block_inputs(jscene, prim, mat, o, d, nrm)
    g = np.random.default_rng(23).standard_normal((k, 3)).astype(np.float32)
    g_rows = [jnp.asarray(np.concatenate([g[:, c], np.zeros(128 - k, np.float32)])[None])
              for c in range(3)]

    def f(tri_flat):
        out = jmk._texture_block(jp.tex_counts, jscene.num_spheres, jscene.num_triangles,
                                 (1, 128), tex_ref=jp.tex_planes, nx=nx, ny=ny, nz=nz, mf=mf,
                                 **dict(refs, tri_ref=tri_flat), **lane)
        return out[3:6]

    _, pull = jax.vjp(f, refs["tri_ref"])
    want = np.asarray(pull(tuple(g_rows))[0]).reshape(-1, tmk.T_COLS)
    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    tri = packed.triangles.numpy()[prim - jscene.num_spheres]
    triuv = packed.tex_triuv.numpy()[prim - jscene.num_spheres]
    texel = np.broadcast_to(np.float32([0.85, 0.5, 0.9]), (k, 3))
    per_lane = tangent_edges_vjp_hostbuild(tri, triuv, nrm, texel, g)
    got = np.zeros_like(want)
    np.add.at(got[:, 3:9], prim - jscene.num_spheres, per_lane)
    _close(got[:, 3:9], want[:, 3:9], "edges")
    np.testing.assert_allclose(want[:, :3], 0.0, atol=1e-6 * np.abs(want).max())
    assert np.abs(want[:, 3:9]).max() > 1e-3


# ---- the whole mode: plain version and host build against jax.grad -------------

GEO_CASES = {
    "tilted quad": (jax_tilted_quad, GEO_FIELDS),
    "cornell": (jpresets.cornell, GEO_FIELDS),
    "color quad": (lambda: jax_textured_quad(), GEO_FIELDS + ["textures"]),
    "normal quad": (lambda: jax_textured_quad(tex=False, nmap=True),
                    GEO_FIELDS + ["textures"]),
}


@pytest.mark.parametrize("name", list(GEO_CASES))
def test_geo_matches_jax_autodiff(name):
    """Plain autograd and the host build of K2 geo against jax.value_and_grad
    of the jnp engine on the same streams, and against each other. On
    cornell the area light's two triangles move: the NEE light-vertex rows
    reach ``tri_v*`` through pack_scene."""
    make, fields = GEO_CASES[name]
    jscene = make()
    size, spp, bounces = 8, 1, 2
    # op by op costs less than compiling, but on cornell's 14 triangles
    v_jax, g_jax = jax_value_and_grad(jscene, fields, size, size, spp, bounces, 5,
                                      jit=name == "cornell")
    got = {}
    for engine in ("plain", "host"):
        got[engine] = port_value_and_grad(port_scene(jscene), CP, fields, size, size, spp,
                                          bounces, 5, engine, "geo")
        np.testing.assert_allclose(got[engine][0], v_jax, rtol=1e-5)
        assert_grads_close(got[engine][1], g_jax, fields)
    assert_grads_close(got["host"][1], got["plain"][1], fields)
    for k in ("tri_v0", "tri_v1", "tri_v2", "tri_n0"):
        assert np.abs(g_jax[k]).max() > 0, f"no gradient flows to {k}"


def test_geo_through_the_tpu_kernel_in_interpret_mode():
    """One case through the TPU backward kernel itself (Pallas interpret
    mode), as tests/test_torch_vjp_pallas.py does for the linear mode."""
    jscene = jax_tilted_quad()
    cp = jcamera_arrays(JCamera())

    def loss(params, seed):
        s = jinverse.merge_params(jscene, params)
        img = jvjp.render_megakernel_diff(jmk.pack_scene(s), cp, seed, 8, 8, 1,
                                          max_bounces=2, interpret=True, grad_mode="geo")
        return jnp.mean(img ** 2)

    v_jax, g_jax = jax.device_get(jax.jit(jax.value_and_grad(loss))(
        jinverse.extract_params(jscene, GEO_FIELDS), 5))
    g_jax = {k: np.asarray(a) for k, a in g_jax.items()}
    for engine in ("plain", "host"):
        v, g = port_value_and_grad(port_scene(jscene), CP, GEO_FIELDS, 8, 8, 1, 2, 5, engine,
                                   "geo")
        np.testing.assert_allclose(v, float(v_jax), rtol=1e-5)
        assert_grads_close(g, g_jax, GEO_FIELDS)


# ---- layout and gates ----------------------------------------------------------

@pytest.mark.parametrize("physical", [False, True])
@pytest.mark.parametrize("tri", [False, True])
def test_grad_rows_and_planes_are_the_reference_s(tri, physical):
    """_grad_rows and the checkpoint planes of every mode equal the
    reference's _grad_rows(tri=..., physical=...) / _st_planes_for."""
    for counts in ((2, 12, 5, 0, 1), (0, 2, 1, 1, 0), (300, 5120, 4, 2, 3)):
        for texels in (0, 2304):
            want = jvjp._grad_rows(counts, True, physical, tri, (1, texels) if texels else (0, 0))
            assert tvjp._grad_rows(counts, True, texels, physical, tri) == want
    for textured in (False, True):
        for tex_grads in (False, True):
            for nmap in (False, True):
                want = jvjp._st_planes_for(True, physical, textured, tex_grads,
                                           textured and nmap)
                if textured and nmap and not tex_grads:
                    # the reference keeps 20 normal-map planes without texel
                    # gradients; the port the 12 it uses
                    want -= 8
                got = tvjp._st_planes(True, textured, tex_grads, nmap, physical)
                assert got == want, (textured, tex_grads, nmap)


def test_geo_through_the_grid_raises_the_reference_s_error():
    """Geometry moves: the grid's cell lists would go stale. The kernel has
    no geo grid instantiation; the entries and invert refuse, as the
    reference's invert does."""
    scene = tpresets.cornell()
    packed = tmk.pack_scene(scene, "cpu")
    grid = tmk.pack_grid(build_grid(scene), "cpu")
    for entry in (tvjp.render_megakernel_diff, tvjp.render_megakernel_diff_plain):
        with pytest.raises(ValueError, match="grid"):
            entry(packed, CP, 0, 8, 8, 1, grad_mode="geo", packed_grid=grid)
    with pytest.raises(ValueError, match="geometry fields"):
        tinverse.invert(scene, CP, torch.zeros(8, 8, 3), ["tri_v0"], 8, 8, steps=1,
                        engine="plain", accel="grid")
    with pytest.raises(ValueError, match="geometry fields"):
        jinverse.invert(jpresets.cornell(), jcamera_arrays(JCamera()), jnp.zeros((8, 8, 3)),
                        ["tri_v0"], 8, 8, steps=1, engine="pallas_interpret", accel="grid")


def test_unpack_routes_triangle_and_light_vertex_rows():
    """The geo rows land in the triangle table's (v0, e1, e2, n0, n1, n2)
    columns and the area-light table's vertex columns, the power rows where
    they were."""
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    rows = tvjp._grad_rows(packed.counts, True, tri=True)
    rowsum = torch.arange(rows, dtype=torch.float32)
    d, _ = tvjp._unpack_rows(rowsum, packed, True, geo=True)
    num_s, num_t, num_m, num_pl, num_al = packed.counts
    row_al0 = num_m * tvjp.P_COLS_FULL + 6 * num_pl
    row_tri0 = row_al0 + 21 * num_al + 3 + tvjp.CAM_ROWS + 4 * num_s
    assert torch.equal(d.triangles[:num_t, :18],
                       rowsum[row_tri0:row_tri0 + 18 * num_t].reshape(num_t, 18))
    assert not d.triangles[:, 18].any()
    al = rowsum[row_al0:row_al0 + 21 * num_al].reshape(num_al, 21)
    assert torch.equal(d.area_lights[:num_al, 18:21], al[:, :3])
    assert torch.equal(d.area_lights[:num_al, :18], al[:, 3:])
    d_full, _ = tvjp._unpack_rows(rowsum[:tvjp._grad_rows(packed.counts, True)], packed, True)
    assert not d_full.triangles.any() and not d_full.area_lights[:, :18].any()
    assert dataclasses.replace(d, triangles=d_full.triangles).counts == packed.counts
