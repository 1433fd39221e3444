"""K2's physical mode (``physical=True``: the exact adjoint of the unbiased
MIS estimator) against the reference.

- Each hand-written adjoint (host build of csrc/megakernel.cuh, needs g++)
  against ``jax.vjp`` of the reference's function: ``_physical_lobes``,
  ``_lobe_terms``, ``_al_light_geom``, ``_al_sample_point``, the pdf chain
  (``_physical_prev_pdf`` over lobes built from its inputs, the reference
  kernel's ``pdf_fn``) and the whole direct phase (``_physical_direct`` in the
  reference kernel's ``direct_fn`` wrapper), with and without the light
  vertices as inputs. Tolerances rtol 1e-4, atol 1e-6 * max|g|.
- The plain version's autograd against ``jax.value_and_grad`` of the jnp
  engine's physical mode, and the host build of the whole kernel against
  both, on cornell with the fields of tests/test_pallas_vjp.py's physical
  test, showcase, a color- and a normal-mapped quad and, with geo, the
  reference's tilted quad under an area light; on stress_dense (an infinite
  ior without the pure flag: the reference's render is NaN there) and
  through the grid against the plain version alone. Tolerances of
  tests/test_pallas_vjp.py (loss rtol 1e-5; gradients rtol 1e-3, atol
  1e-4 * max|g|).
- One case through the TPU backward kernel itself in interpret mode.
- The field gates: ``al_power`` has no physical gradient, ``spec_avg`` has
  one only in physical mode.
"""
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
from cuda_path_tracer_ss_torch.utils import rng as trng
from torch_port_helpers import (al_light_geom_vjp_hostbuild, al_sample_point_vjp_hostbuild,
                                assert_grads_close, direct_rows_layout, jax_textured_quad,
                                jax_tilted_quad,
                                jax_value_and_grad, lobe_terms_vjp_hostbuild,
                                physical_direct_vjp_hostbuild, physical_lobes_vjp_hostbuild,
                                physical_prev_pdf_vjp_hostbuild, port_scene,
                                port_value_and_grad)

CP = camera_arrays(Camera())
PHYS_FIELDS = ["materials.diffuse", "materials.specular", "materials.emission",
               "materials.absorption", "materials.diff_avg", "materials.spec_avg",
               "materials.ior", "sph_center", "sph_radius"]
LOBE_KEYS = ("n_unit", "gloss_axis", "ct_axis", "prob_g", "prob_ct", "nv")


def _close(got, want, err_msg=""):
    """The per-function tolerance: rtol 1e-4, atol 1e-6 * max|want|."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale, err_msg=err_msg)


def _unit(rng, n):
    v = rng.standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _materials(rng, n):
    """n random material rows [n, 20] mixing every lobe: Phong (finite and
    infinite exponents), Cook-Torrance (rough and smooth), pure mirrors,
    glass; spec_avg 0 on some."""
    m = np.zeros((n, 20), np.float32)
    m[:, 0:12] = rng.uniform(0, 1, (n, 12))
    m[:, 12] = rng.choice([np.inf, 0.0, 12.0, 250.0], n)
    m[:, 13] = rng.uniform(1.2, 2.5, n)
    m[:, 14] = rng.uniform(0, 1, n)
    m[:, 15] = np.where(rng.uniform(size=n) < 0.2, 0.0, rng.uniform(0.1, 1, n))
    m[:, 16] = rng.uniform(0, 0.5, n)
    m[:, 17] = rng.choice([0.0, 0.1, 0.4], n)
    m[:, 18] = rng.uniform(size=n) < 0.2
    m[:, 19] = rng.uniform(size=n) < 0.4
    return m


def _lobe_inputs(seed, n=256):
    rng = np.random.default_rng(seed)
    d = _unit(rng, n)
    nrm = (_unit(rng, n) * rng.uniform(0.7, 1.3, (n, 1))).astype(np.float32)
    return rng, d, nrm, _materials(rng, n)


def _lobes_flat(lb):
    """A reference lobe dict's cotangent-carrying fields in the host build's
    order: unit normal, gloss axis, ct axis, prob_g, prob_ct, nv."""
    return np.stack([np.asarray(x) for k in LOBE_KEYS
                     for x in (lb[k] if isinstance(lb[k], tuple) else (lb[k],))], -1)


# ---- the hand-written adjoints against jax.vjp ----------------------------------

def test_physical_lobes_vjp_matches_jax_vjp():
    rng, d, nrm, m = _lobe_inputs(31)
    cos_i = -(d * nrm).sum(1).astype(np.float32)
    n = len(d)
    a_flat = rng.standard_normal((n, 12)).astype(np.float32)

    def f(d_, n_, c_, m_):
        return jmk._physical_lobes(*d_.T, *n_.T, c_, tuple(m_.T))

    lb, pull = jax.vjp(f, *(jnp.asarray(a) for a in (d, nrm, cos_i, m)))
    cot = {k: (tuple(jnp.zeros(n) for _ in v) if isinstance(v, tuple) else jnp.zeros(n))
           for k, v in lb.items()}
    cols = iter(range(12))
    for k in LOBE_KEYS:
        if isinstance(lb[k], tuple):
            cot[k] = tuple(jnp.asarray(a_flat[:, next(cols)]) for _ in range(3))
        else:
            cot[k] = jnp.asarray(a_flat[:, next(cols)])
    want = pull(cot)
    got = physical_lobes_vjp_hostbuild(d, nrm, cos_i, m, a_flat)
    for name, g_, w in zip(("d", "n", "cos_i", "materials"), got, want):
        _close(g_, w, name)


def test_lobe_terms_vjp_matches_jax_vjp():
    """The lobes as inputs: a lobe's probability that its flags hold at 0
    (prob_g under Cook-Torrance, prob_ct otherwise) has a cotangent in the
    reference that nothing downstream reads; those two are not compared."""
    rng, d, nrm, m = _lobe_inputs(32)
    d = np.where(((d * nrm).sum(1) > 0)[:, None], -d, d)  # mostly outside hits
    n = len(d)
    w = _unit(rng, n)
    w = np.where(((w * nrm).sum(1) < 0)[:, None], -w, w)
    a5 = rng.standard_normal((n, 5)).astype(np.float32)
    cos_i = -(d * nrm).sum(1)
    lb0 = jmk._physical_lobes(*jnp.asarray(d).T, *jnp.asarray(nrm).T, jnp.asarray(cos_i),
                              tuple(jnp.asarray(m).T))

    def f(lb, d_, n_, w_):
        return jmk._lobe_terms(lb, *d_.T, *n_.T, *w_.T)

    _, pull = jax.vjp(f, lb0, *(jnp.asarray(a) for a in (d, nrm, w)))
    a_lb, a_d, a_n, a_w = pull(tuple(jnp.asarray(a5[:, k]) for k in range(5)))
    want_lb = _lobes_flat(a_lb)
    ct = m[:, 19] > 0.5
    want_lb[ct, 9] = 0.0      # prob_g of a Cook-Torrance material: always 0
    want_lb[~ct, 10] = 0.0    # prob_ct of any other: always 0
    got = lobe_terms_vjp_hostbuild(d, nrm, m, w, a5)
    _close(got[0], want_lb, "lobes")
    _close(got[1][:, 14], a_lb["diff_avg"], "diff_avg")
    _close(got[1][:, 12], a_lb["exponent"], "exponent")
    _close(got[1][:, 17], a_lb["roughness"], "roughness")
    for name, g_, w_ in zip(("d", "n", "w"), got[2:], (a_d, a_n, a_w)):
        _close(g_, w_, name)


def _area_lights(rng, n):
    """n random area-light rows [n, 23]: two random triangles each."""
    al = np.zeros((n, 23), np.float32)
    al[:, :18] = rng.uniform(-2, 2, (n, 18))
    return al


def test_light_geometry_vjps_match_jax_vjp():
    """al_light_geom_vjp (areas and unit normals -> the six vertices) and
    al_sample_point_vjp (the sampled point and the picked normal -> the
    vertices and the normals; the pick carries nothing) against jax.vjp of
    the reference's ``_al_light_geom`` and ``_al_sample_point``."""
    rng = np.random.default_rng(33)
    n = 256
    al = _area_lights(rng, n)
    a9 = rng.standard_normal((n, 9)).astype(np.float32)

    def geom(v18):
        return jmk._al_light_geom([v18[:, k] for k in range(18)] + [jnp.zeros(n)] * 5)

    g0, pull = jax.vjp(geom, jnp.asarray(al[:, :18]))
    cot = dict(v=[tuple(jnp.zeros(n) for _ in range(3)) for _ in range(6)],
               area0=jnp.asarray(a9[:, 0]), area1=jnp.asarray(a9[:, 1]),
               total=jnp.asarray(a9[:, 2]), n0=tuple(jnp.asarray(a9[:, 3 + c]) for c in range(3)),
               n1=tuple(jnp.asarray(a9[:, 6 + c]) for c in range(3)))
    _close(al_light_geom_vjp_hostbuild(al, a9), pull(cot)[0], "light geometry")

    u1, u2, upick = (rng.uniform(size=n).astype(np.float32) for _ in range(3))
    a_l, a_nl = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(2))
    _, pull_s = jax.vjp(lambda g: jmk._al_sample_point(g, jnp.asarray(u1), jnp.asarray(u2),
                                                       jnp.asarray(upick)), g0)
    (want,) = pull_s((tuple(jnp.asarray(a_l[:, c]) for c in range(3)),
                      tuple(jnp.asarray(a_nl[:, c]) for c in range(3))))
    a_v, a_tn = al_sample_point_vjp_hostbuild(al, u1, u2, upick, a_l, a_nl)
    _close(a_v, np.stack([np.asarray(x) for v in want["v"] for x in v], -1), "vertices")
    _close(a_tn, np.stack([np.asarray(x) for x in want["n0"] + want["n1"]], -1), "normals")
    assert not np.asarray(want["area0"]).any() and not np.asarray(want["total"]).any()


def test_physical_prev_pdf_vjp_matches_jax_vjp():
    """The pdf chain: the continuation density of the branch taken, its lobes
    built from (d, n, material) as the reference kernel's pdf_fn builds them,
    against jax.vjp of that composition (``_physical_lobes`` and
    ``_physical_prev_pdf``)."""
    rng, d, nrm, m = _lobe_inputs(34)
    n = len(d)
    d = np.where(((d * nrm).sum(1) > 0)[:, None], -d, d)
    branch = rng.choice([1, 2, 3], n)   # diffuse, Cook-Torrance, gloss
    m[:, 19] = branch == 2
    m[branch == 2, 17] = rng.uniform(0.1, 0.5, (branch == 2).sum())
    m[branch == 3, 12] = rng.choice([0.0, 12.0, 250.0], (branch == 3).sum())
    nunit = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    mirror = d - 2.0 * (d * nunit).sum(1, keepdims=True) * nunit
    # continuations about the mirror direction, their microfacets at least a
    # few degrees off the lobe axis: there the Beckmann density's tan(theta) =
    # sqrt(1 - cos^2) / cos loses its digits in float32, the reference's
    # and the port's alike
    nd = mirror + 0.6 * _unit(rng, n)
    nd = (nd / np.linalg.norm(nd, axis=1, keepdims=True)).astype(np.float32)
    h = nd - d
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    keep = (h * nunit).sum(1) < 0.99
    a_pdf = rng.standard_normal(n).astype(np.float32)

    def pdf_fn(d_, n_, nd_, m_):
        mf = tuple(m_.T)
        lb = jmk._physical_lobes(*d_.T, *n_.T, -(d_ * n_).sum(1), mf)
        return jmk._physical_prev_pdf(lb, *d_.T, *nd_.T, jnp.asarray(branch == 1),
                                      jnp.asarray(branch == 3), jnp.asarray(branch == 2))

    _, pull = jax.vjp(pdf_fn, *(jnp.asarray(a) for a in (d, nrm, nd, m)))
    want = pull(jnp.asarray(a_pdf))
    got = physical_prev_pdf_vjp_hostbuild(d, nrm, nd, m, branch, a_pdf)
    for name, g_, w in zip(("d", "n", "nd", "materials"), got, want):
        _close(g_[keep], np.asarray(w)[keep], name)
    assert keep.sum() > 200 and (np.abs(want[3])[keep & (branch == 2)] > 0).any()


@pytest.mark.parametrize("geo", [False, True])
@pytest.mark.parametrize("name", ["cornell", "point_light_spheres"])
def test_physical_direct_vjp_matches_jax_vjp(name, geo):
    """The direct phase at random hits: physical_direct_vjp's value and
    cotangents (hit point, normal, direction, t, prev_pdf, the 20 material
    columns, the point lights, the light emission and, with ``geo``, the
    light vertices) against jax.vjp of the reference kernel's direct_fn
    wrapper over ``_physical_direct``, with the same light draws and the
    occlusion the host build found."""
    jscene = getattr(jpresets, name)()
    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    num_s, num_t, num_m, num_pl, num_al = packed.counts
    tabs = [t.numpy() for t in packed.tables()]
    rng = np.random.default_rng(35)
    n = 256
    p = rng.uniform(-3.5, 3.5, (n, 3)).astype(np.float32)
    p[:, 2] -= 5.0
    nrm = (_unit(rng, n) * rng.uniform(0.8, 1.2, (n, 1))).astype(np.float32)
    d = _unit(rng, n)
    d = np.where((rng.uniform(size=n) < 0.85)[:, None] & ((d * nrm).sum(1) > 0)[:, None],
                 -d, d).astype(np.float32)
    t = rng.uniform(0.5, 5.0, n).astype(np.float32)
    pp = np.where(rng.uniform(size=n) < 0.25, 0.0, rng.uniform(0.05, 3.0, n)).astype(np.float32)
    t0 = int(tabs[4][0, 21]) + num_s
    prim = rng.choice([t0, t0 + 1, 0, num_s + 2], n).astype(np.int32)
    mat = rng.integers(0, num_m, n)
    m = tabs[2][mat].copy()
    m[:, 15] = np.where(m[:, 15] > 0, m[:, 15], rng.uniform(0, 0.5, n))
    pixel, sample = rng.integers(0, 4096, n), rng.integers(0, 64, n)
    pair0 = trng.pair_base(rng.integers(0, 4, n), num_al)
    g = rng.standard_normal((n, 3)).astype(np.float32)
    seed = 7
    got = physical_direct_vjp_hostbuild(packed, seed, pixel, sample, pair0, p, nrm, d, t, pp,
                                        m, prim, g, geo)

    occ = got["occ"].astype(bool)
    draws = []
    for i in range(num_al):
        u = [trng.uniform_pair(seed, torch.from_numpy(pixel), torch.from_numpy(sample),
                               torch.from_numpy(pair0 + 2 + 2 * i + k)) for k in (0, 1)]
        draws.append((jnp.asarray(u[0][0].numpy()), jnp.asarray(u[0][1].numpy()),
                      jnp.asarray(u[1][1].numpy())))
    al_rows = tabs[4][:num_al]
    geoms = [jmk._al_light_geom([jnp.float32(x) for x in row]) for row in al_rows]
    le_mat = [int(row[22]) for row in al_rows]

    def direct_fn(p_, n_, d_, t_, pp_, m_, pl_, le_, alv_):
        mf = tuple(m_.T)
        lb = jmk._physical_lobes(*d_.T, *n_.T, -(d_ * n_).sum(1), mf)
        gs = ([jmk._al_light_geom([alv_[i, k] for k in range(18)] + [jnp.float32(0)] * 5)
               for i in range(num_al)] if geo else geoms)
        dr = jmk._physical_direct(
            num_s, num_pl, num_al, *p_.T, *n_.T, *d_.T, t_, pp_, lb, mf,
            [jnp.zeros(n) + pl_[i, k] for i in range(num_pl) for k in range(6)],
            [jnp.zeros(n) + le_[i, c] for i in range(num_al) for c in range(3)],
            gs, draws, [jnp.asarray(occ[:, i]) for i in range(num_pl)],
            [jnp.asarray(occ[:, num_pl + i]) for i in range(num_al)],
            jnp.asarray(prim, jnp.float32), [jnp.float32(row[21]) for row in al_rows])
        return jnp.stack(dr, -1)

    prims = (p, nrm, d, t, pp, m, tabs[3][:num_pl], tabs[2][le_mat, 9:12], al_rows[:, :18])
    out, pull = jax.vjp(direct_fn, *(jnp.asarray(a) for a in prims))
    want = pull(jnp.asarray(g))
    _close(got["dir"], out, "direct radiance")
    for name_, k in (("a_p", 0), ("a_n", 1), ("a_d", 2), ("a_t", 3), ("a_pp", 4), ("a_m", 5)):
        _close(got[name_], want[k], name_)
    row_pl0, row_al0, _ = direct_rows_layout(packed.counts)
    rows = got["rows"].sum(0)
    if num_pl:
        _close(rows[row_pl0:row_al0].reshape(num_pl, 6), want[6], "point lights")
    le_want = np.zeros((num_m, 3), np.float32)
    np.add.at(le_want, le_mat, np.asarray(want[7]))
    _close(rows[:12 * num_m].reshape(num_m, 12)[:, 9:12], le_want, "light emission")
    vert = rows[row_al0:].reshape(num_al, 21)[:, 3:]
    if geo:
        _close(vert, want[8], "light vertices")
        assert np.abs(want[8]).max() > 0
    else:
        assert not vert.any()
    assert occ.any() and (~occ).any()


# ---- the whole mode: plain version and host build against jax.grad -------------

PHYS_CASES = {
    "cornell": (jpresets.cornell, PHYS_FIELDS, "full"),
    "showcase": (jpresets.showcase, ["materials.diffuse", "materials.specular",
                                     "materials.absorption", "materials.spec_avg",
                                     "materials.ior", "sph_center"], "full"),
    "color quad": (lambda: jax_textured_quad(), ["materials.diffuse", "textures", "pl_pos"],
                   "full"),
    "normal quad": (lambda: jax_textured_quad(tex=False, nmap=True),
                    ["materials.diffuse", "textures", "pl_power"], "full"),
    "tilted quad, geo": (lambda: jax_tilted_quad(area_light=True),
                         ["tri_v0", "tri_v1", "tri_v2", "tri_n0", "materials.diffuse",
                          "materials.emission", "materials.spec_avg"], "geo"),
}


@pytest.mark.parametrize("name", list(PHYS_CASES))
def test_physical_matches_jax_autodiff(name):
    """Plain autograd and the host build of K2 physical against
    jax.value_and_grad of the jnp engine's physical mode on the same
    streams, and against each other."""
    make, fields, mode = PHYS_CASES[name]
    jscene = make()
    v_jax, g_jax = jax_value_and_grad(jscene, fields, 8, 8, 1, 2, 5, physical=True,
                                      jit=name == "cornell")
    got = {}
    for engine in ("plain", "host"):
        got[engine] = port_value_and_grad(port_scene(jscene), CP, fields, 8, 8, 1, 2, 5,
                                          engine, mode, physical=True)
        np.testing.assert_allclose(got[engine][0], v_jax, rtol=1e-5)
        assert_grads_close(got[engine][1], g_jax, fields)
    assert_grads_close(got["host"][1], got["plain"][1], fields)
    assert any(np.abs(g_jax[k]).max() > 0 for k in fields)


@pytest.mark.parametrize("name", ["stress_dense", "cornell grid"])
def test_physical_kernel_math_matches_plain(name):
    """Where the reference gives no gradient (stress_dense: an infinite ior
    without the pure flag makes its physical render NaN; the port's Fresnel
    guard gives that branch probability 0) and through the grid: the host
    build of K2 physical against the plain version alone."""
    scene = tpresets.stress_dense(300) if name == "stress_dense" else tpresets.cornell()
    grid = tmk.pack_grid(build_grid(scene), "cpu") if "grid" in name else None
    fields = PHYS_FIELDS
    args = (scene, CP, fields, 12, 12, 2, 3, 5)
    v_p, g_p = port_value_and_grad(*args, "plain", "full", packed_grid=grid, physical=True)
    v_h, g_h = port_value_and_grad(*args, "host", "full", packed_grid=grid, physical=True)
    np.testing.assert_allclose(v_h, v_p, rtol=1e-5)
    assert_grads_close(g_h, g_p, fields)
    assert all(np.isfinite(g_p[k]).all() for k in fields)


def test_physical_through_the_tpu_kernel_in_interpret_mode():
    """One case through the TPU backward kernel itself (Pallas interpret
    mode, ``physical=True``) on the tilted quad under an area light."""
    jscene = jax_tilted_quad(area_light=True)
    fields = ["materials.diffuse", "materials.emission", "materials.spec_avg", "pl_pos"]
    cp = jcamera_arrays(JCamera())

    def loss(params, seed):
        s = jinverse.merge_params(jscene, params)
        img = jvjp.render_megakernel_diff(jmk.pack_scene(s), cp, seed, 8, 8, 1,
                                          max_bounces=2, interpret=True, physical=True)
        return jnp.mean(img ** 2)

    v_jax, g_jax = jax.device_get(jax.jit(jax.value_and_grad(loss))(
        jinverse.extract_params(jscene, fields), 5))
    g_jax = {k: np.asarray(a) for k, a in g_jax.items()}
    for engine in ("plain", "host"):
        v, g = port_value_and_grad(port_scene(jscene), CP, fields, 8, 8, 1, 2, 5, engine,
                                   "full", physical=True)
        np.testing.assert_allclose(v, float(v_jax), rtol=1e-5)
        assert_grads_close(g, g_jax, fields)


# ---- the field gates -------------------------------------------------------------

def test_physical_field_gates_are_the_reference_s():
    """tests/test_pallas_vjp.py::test_physical_field_guard: spec_avg trains
    on the physical estimator and not on the parity one; al_power has no
    physical gradient (the physical NEE reads the light's material
    emission)."""
    tinverse.check_engine_fields("cuda", ["materials.spec_avg"], physical=True)
    with pytest.raises(ValueError, match="no gradient.*physical=True"):
        tinverse.check_engine_fields("cuda", ["materials.spec_avg"], physical=False)
    with pytest.raises(ValueError, match="no gradient"):
        tinverse.check_engine_fields("cuda", ["al_power"], physical=True)
    assert tinverse.pallas_trainable(True) == jinverse.pallas_trainable(True)
    assert tvjp.PALLAS_TRAINABLE_FIELDS_PHYS == jvjp.PALLAS_TRAINABLE_FIELDS_PHYS
    assert tvjp.PALLAS_TRAINABLE_FIELDS_PHYS_GEO == jvjp.PALLAS_TRAINABLE_FIELDS_PHYS_GEO


def test_spec_avg_reaches_the_scene_through_pack_scene():
    """The physical rows' spec_avg column (packed materials column 15)
    carries back into ``materials.spec_avg``."""
    scene = tpresets.cornell()
    leaf = scene.materials.spec_avg.clone().requires_grad_(True)
    packed = tmk.pack_scene(tinverse.with_field(scene, "materials.spec_avg", leaf), "cpu")
    cot = torch.zeros_like(packed.materials)
    cot[:, 15] = torch.arange(cot.shape[0], dtype=torch.float32) + 1
    (grad,) = torch.autograd.grad((packed.materials * cot).sum(), leaf)
    assert torch.equal(grad, cot[:, 15])
    rows = tvjp._grad_rows(packed.counts, True, physical=True)
    d, _ = tvjp._unpack_rows(torch.arange(rows, dtype=torch.float32), packed, True,
                             physical=True)
    assert torch.equal(d.materials[:, 15],
                       torch.arange(packed.counts[2], dtype=torch.float32) * 17 + 16)
