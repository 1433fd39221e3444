"""The eager engine's ops (``cuda_path_tracer_ss_torch/ops/*``, ``utils/rng``)
against their JAX functions on the CPU, function by function: the same numpy
inputs (made from a seed) go through both, over the ``cornell``,
``showcase``, ``stress`` and ``glass`` presets and random rays.

Both sides evaluate the same float32 formulas in the same order. What may
differ is the two libraries' sqrt / exp / log (an ulp or two) and XLA's
contraction of a*b+c into FMAs inside a scan; hence rtol 1e-5 / atol 1e-6
(``TOL``). Discrete results (hit indices, visibility, branch choices, the
Threefry words) must be equal. ``TOL_PDF`` (the tolerance of
``test_torch_physical.py``) is for densities that divide by a cancelled
quantity (|d.h| of a half vector, sin of a near-axis angle, a Phong power),
where those ulps grow.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.ops import bsdf as jbsdf
from cuda_path_tracer_ss_tpu.ops import compaction as jcomp
from cuda_path_tracer_ss_tpu.ops import intersect as jint
from cuda_path_tracer_ss_tpu.ops import optics as jopt
from cuda_path_tracer_ss_tpu.ops import sampling as jsamp
from cuda_path_tracer_ss_tpu.ops import shading as jshade
from cuda_path_tracer_ss_tpu.ops import texture as jtex
from cuda_path_tracer_ss_tpu.ops import vec as jvec
from cuda_path_tracer_ss_tpu.utils import rng as jrng
from cuda_path_tracer_ss_torch.ops import bsdf as tbsdf
from cuda_path_tracer_ss_torch.ops import compaction as tcomp
from cuda_path_tracer_ss_torch.ops import intersect as tint
from cuda_path_tracer_ss_torch.ops import optics as topt
from cuda_path_tracer_ss_torch.ops import sampling as tsamp
from cuda_path_tracer_ss_torch.ops import shading as tshade
from cuda_path_tracer_ss_torch.ops import texture as ttex
from cuda_path_tracer_ss_torch.ops import vec as tvec
from cuda_path_tracer_ss_torch.utils import rng as trng
from torch_port_helpers import jax_textured_quad, port_scene

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_PDF = dict(rtol=2e-3, atol=2e-6)
SCENES = ("cornell", "showcase", "stress", "glass")
N = 1024


# ---- bridges ------------------------------------------------------------------

def jv(a):
    """numpy [3, N] or [N, 3]-less triple -> JAX Vec3."""
    return jvec.Vec3(*(jnp.asarray(np.asarray(c)) for c in a))


def tv(a):
    return tvec.Vec3(*(torch.from_numpy(np.ascontiguousarray(np.asarray(c)))
                       for c in a))


def npv(v):
    """JAX or torch Vec3 -> numpy [3, N]."""
    return np.stack([np.asarray(c.detach().numpy() if isinstance(c, torch.Tensor)
                                else c) for c in (v.x, v.y, v.z)])


def npa(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(npa(got) if not isinstance(got, (tvec.Vec3, jvec.Vec3))
                               else npv(got),
                               npa(want) if not isinstance(want, (tvec.Vec3, jvec.Vec3))
                               else npv(want), **tol)


def _unit(g, n):
    v = g.standard_normal((3, n)).astype(np.float32)
    return v / np.sqrt((v * v).sum(0))


def _rays(seed, n=N):
    """Origins in the Cornell box's volume, unit directions."""
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(-4, 4, n), g.uniform(-4, 4, n),
                  g.uniform(-9, 0, n)]).astype(np.float32)
    return o, _unit(g, n)


@pytest.fixture(scope="module", params=SCENES)
def scenes(request):
    js = jpresets.get_scene(request.param)
    return request.param, js, port_scene(js)


@pytest.fixture(scope="module")
def surfels(scenes):
    """JAX hits, surfels and material lookups on random rays of a scene
    (only the rays that hit), as numpy, plus the port's scene."""
    name, js, ts = scenes
    o, d = _rays(1)
    hit = jint.nearest_hit(jv(o), jv(d), js)
    h = np.asarray(hit.hit)
    o, d = o[:, h], d[:, h]
    hit = jint.nearest_hit(jv(o), jv(d), js)
    surf = jint.surfel_at(jv(o), jv(d), hit, js)
    return dict(name=name, js=js, ts=ts, o=o, d=d,
                prim=np.asarray(hit.prim), t=np.asarray(hit.t),
                point=npv(surf.point), normal=npv(surf.normal),
                mat=np.asarray(surf.mat))


def _j_materials(s):
    return jbsdf.lookup_materials(s["js"].materials, jnp.asarray(s["mat"]))


def _t_materials(s):
    return tbsdf.lookup_materials(s["ts"].materials, torch.from_numpy(s["mat"].copy()))


def _cos_i(s):
    d, n = s["d"], s["normal"]
    return -(d[0] * n[0] + d[1] * n[1] + d[2] * n[2])


# ---- 1. utils/rng --------------------------------------------------------------

@pytest.mark.parametrize("lights", [0, 1, 2])
def test_bounce_rows_bit_equal(lights):
    g = np.random.default_rng(lights)
    pix = g.integers(0, 1 << 20, 4096).astype(np.int32)
    sample = g.integers(0, 5000, 4096).astype(np.int32)
    for seed, b in ((0, 0), (-7, 3), (123456789, 14)):
        want = np.asarray(jrng.bounce_rows(seed, jnp.asarray(pix), jnp.asarray(sample),
                                           b, lights))
        got = trng.bounce_rows(seed, torch.from_numpy(pix), torch.from_numpy(sample),
                               b, lights).numpy()
        assert got.shape == want.shape == (3 + 4 * lights, 4096)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ---- 2. ops/vec ----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["sqrt", "rsqrt"])
def test_clamped_grad_functions(fn):
    """Forward bit-equal to torch.sqrt / torch.rsqrt; backward equal to
    jax.grad of the reference's custom JVP, the clamp included (x down to 0
    for sqrt, to 1e-12 for rsqrt: both sides of each clamp)."""
    x = np.concatenate([np.float32([0.0, 1e-12, 1e-7, 1e-6, 2e-6]) if fn == "sqrt"
                        else np.float32([1e-12, 1e-8, 1e-6, 2e-6, 1e-5]),
                        np.random.default_rng(0).uniform(1e-4, 10, 64).astype(np.float32)])
    tfn = tvec.sqrt_clamped_grad if fn == "sqrt" else tvec.rsqrt_clamped_grad
    jfn = jvec.sqrt_clamped_grad if fn == "sqrt" else jvec.rsqrt_clamped_grad
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(xt)
    plain = torch.sqrt if fn == "sqrt" else torch.rsqrt
    assert torch.equal(y.detach(), plain(torch.from_numpy(x)))
    w = np.random.default_rng(1).uniform(-1, 1, x.shape).astype(np.float32)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt)
    want = jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x))
    assert np.all(np.isfinite(g.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6)


def test_normalize_clamped_grad_and_helpers():
    """normalize_clamped_grad: the values of normalize; its gradient that of
    the reference, finite for a vector of norm 1e-6 (normalize's is not
    clamped there). where / gather as the reference's."""
    g = np.random.default_rng(2)
    v = g.standard_normal((3, 256)).astype(np.float32)
    v[:, :8] *= 1e-6
    w = g.standard_normal((3, 256)).astype(np.float32)
    vt = [torch.from_numpy(c).requires_grad_(True) for c in v]
    out = tvec.Vec3(*vt).normalize_clamped_grad(eps=1e-20)
    close(out, tvec.Vec3(*(torch.from_numpy(c) for c in v)).normalize(eps=1e-20))
    grads = torch.autograd.grad(out.dot(tv(w)).sum(), vt)

    def f(a):
        return jnp.sum(jvec.Vec3(*a).normalize_clamped_grad(eps=1e-20).dot(jv(w)))
    want = jax.grad(f)(tuple(jnp.asarray(c) for c in v))
    for gt, gj in zip(grads, want):
        assert np.all(np.isfinite(gt.numpy()))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(np.asarray(gj)).max()))
    cond = g.uniform(size=256) < 0.5
    close(tvec.where(torch.from_numpy(cond), tv(v), tv(w)),
          jvec.where(jnp.asarray(cond), jv(v), jv(w)))
    table = g.standard_normal((7, 3)).astype(np.float32)
    idx = g.integers(0, 7, 100).astype(np.int32)
    close(tvec.gather(torch.from_numpy(table), torch.from_numpy(idx)),
          jvec.gather(jvec.Vec3.from_array(jnp.asarray(table)), jnp.asarray(idx)))


# ---- 3. ops/intersect ----------------------------------------------------------

def test_nearest_hit_surfel_and_any_hit(scenes):
    """Every ray's hit and primitive index equal, t and the surfel within
    TOL; occlusion equal at three distances; the chunked sweep equals one
    chunk."""
    name, js, ts = scenes
    o, d = _rays(3)
    jh = jint.nearest_hit(jv(o), jv(d), js)
    th = tint.nearest_hit(tv(o), tv(d), ts)
    assert np.array_equal(th.hit.numpy(), np.asarray(jh.hit))
    assert np.array_equal(th.prim.numpy(), np.asarray(jh.prim))
    assert np.asarray(jh.hit).mean() > 0.3
    close(th.t, jh.t)
    # the surfel at the reference's own hits (an FMA in the scan moves a
    # grazing hit's t by a few ulp, and its sphere normal by more)
    js_ = jint.surfel_at(jv(o), jv(d), jh, js)
    ts_ = tint.surfel_at(tv(o), tv(d), tint.Hit(
        t=torch.from_numpy(np.asarray(jh.t)), prim=th.prim, hit=th.hit), ts)
    close(ts_.point, js_.point)
    close(ts_.normal, js_.normal)
    assert np.array_equal(ts_.mat.numpy(), np.asarray(js_.mat))
    for max_d in (0.5, 3.0, 50.0):
        assert np.array_equal(tint.any_hit(tv(o), tv(d), max_d, ts).numpy(),
                              np.asarray(jint.any_hit(jv(o), jv(d), max_d, js)))
    old = tint.SWEEP_BYTES
    try:
        tint.SWEEP_BYTES = 4 * N * 3      # three primitives per chunk
        small = tint.nearest_hit(tv(o), tv(d), ts)
    finally:
        tint.SWEEP_BYTES = old
    assert torch.equal(small.prim, th.prim) and torch.equal(small.t, th.t)


def test_sweep_tie_rule_later_primitive_wins():
    """Two coincident spheres and two coincident triangles: the later index
    wins the tie, as the reference's scan (t <= best)."""
    from cuda_path_tracer_ss_tpu.models.scene import MaterialSpec, SceneBuilder

    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(0.5, 0.5, 0.5), diff_avg=0.5))
    for _ in range(2):
        b.add_sphere((0.0, 0.0, -5.0), 1.0, m)
    for _ in range(2):
        b.add_triangle((-3, -3, -8), (3, -3, -8), (0, 3, -8), (0, 0, 1),
                       (0, 0, 1), (0, 0, 1), m)
    js = b.build()
    o = np.zeros((3, 64), np.float32)
    d = _unit(np.random.default_rng(4), 64)
    d[2] = -np.abs(d[2]) - 2.0
    d /= np.sqrt((d * d).sum(0))
    jh = jint.nearest_hit(jv(o), jv(d), js)
    th = tint.nearest_hit(tv(o), tv(d), port_scene(js))
    assert np.array_equal(th.prim.numpy(), np.asarray(jh.prim))
    assert set(th.prim.numpy().tolist()) <= {-1, 1, 3}
    assert {1, 3} <= set(th.prim.numpy().tolist())


def test_winner_t_carries_the_sweep_s_gradient():
    """With a graph, nearest_hit evaluates the winner's t again: bit-equal
    to the sweep's, its gradient that of jax.grad through the scan."""
    js = jpresets.get_scene("glass")
    ts = port_scene(js)
    o, d = _rays(5, 512)
    jh = jint.nearest_hit(jv(o), jv(d), js)
    mask = np.asarray(jh.hit)
    centre = ts.sph_center.clone().requires_grad_(True)
    th = tint.nearest_hit(tv(o), tv(d), ts.replace(sph_center=centre))
    plain = tint.nearest_hit(tv(o), tv(d), ts)
    assert torch.equal(th.t.detach(), plain.t)
    (g,) = torch.autograd.grad(th.t[torch.from_numpy(mask)].sum(), centre)

    def f(c):
        s = dataclasses.replace(js, sph_center=jvec.Vec3.from_array(c))
        h = jint.nearest_hit(jv(o), jv(d), s)
        return jnp.sum(jnp.where(mask, h.t, 0.0))
    want = jax.grad(f)(jnp.asarray(ts.sph_center.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))


# ---- 4. ops/optics --------------------------------------------------------------

def test_optics(surfels):
    s = surfels
    jm, tm = _j_materials(s), _t_materials(s)
    cos_i = _cos_i(s)
    jr = jopt.media_and_sin_t2(jm.ior, jnp.asarray(cos_i))
    tr = topt.media_and_sin_t2(tm.ior, torch.from_numpy(cos_i))
    for a, b in zip(tr, jr):
        close(a, b)
    close(topt.fresnel_reflectance(*tr[:4]), jopt.fresnel_reflectance(*jr[:4]))
    close(topt.reflect_signed(tv(s["d"]), tv(s["normal"]), tr[0]),
          jopt.reflect_signed(jv(s["d"]), jv(s["normal"]), jr[0]))
    close(topt.reflect_abs(tv(s["d"]), tv(s["normal"])),
          jopt.reflect_abs(jv(s["d"]), jv(s["normal"])))
    close(topt.refract(tv(s["d"]), tv(s["normal"]), tr[0], tr[1], tr[4]),
          jopt.refract(jv(s["d"]), jv(s["normal"]), jr[0], jr[1], jr[4]))


# ---- 5. ops/sampling ----------------------------------------------------------------

def test_sampling():
    g = np.random.default_rng(6)
    n = 4096
    axis = _unit(g, n) * g.uniform(0.7, 1.3, n).astype(np.float32)
    axis[:, :4] = [[0, 0, 0, 0], [-1, -1, 1, -0.9999999], [0, 0, 0, 0]]
    u1, u2 = g.uniform(size=(2, n)).astype(np.float32)
    expo = np.where(g.uniform(size=n) < 0.2, np.float32(np.inf),
                    g.uniform(1, 300, n)).astype(np.float32)
    rough = np.where(g.uniform(size=n) < 0.2, 0, g.uniform(0.02, 0.8, n)).astype(np.float32)
    ja, ta = jv(axis), tv(axis)
    smp = _unit(g, n)
    close(tsamp.rotate_y_to(ta, tv(smp)), jsamp.rotate_y_to(ja, jv(smp)))
    close(tsamp.lambert_direction(ta, torch.from_numpy(u1), torch.from_numpy(u2)),
          jsamp.lambert_direction(ja, jnp.asarray(u1), jnp.asarray(u2)))
    close(tsamp.phong_direction(ta, torch.from_numpy(expo), torch.from_numpy(u1),
                                torch.from_numpy(u2)),
          jsamp.phong_direction(ja, jnp.asarray(expo), jnp.asarray(u1), jnp.asarray(u2)),
          TOL_PDF)
    close(tsamp.beckmann_direction(ta, torch.from_numpy(rough), torch.from_numpy(u1),
                                   torch.from_numpy(u2)),
          jsamp.beckmann_direction(ja, jnp.asarray(rough), jnp.asarray(u1),
                                   jnp.asarray(u2)))
    tax, jax_ = tsamp.phong_lobe_axis(ta), jsamp.phong_lobe_axis(ja)
    close(tax, jax_)
    w = _unit(g, n)
    close(tsamp.phong_pdf(tax, torch.from_numpy(expo), tv(w)),
          jsamp.phong_pdf(jax_, jnp.asarray(expo), jv(w)), TOL_PDF)
    close(tsamp.beckmann_pdf(tax, torch.from_numpy(rough), tv(w)),
          jsamp.beckmann_pdf(jax_, jnp.asarray(rough), jv(w)), TOL_PDF)


# ---- 6. ops/bsdf ----------------------------------------------------------------

def test_bsdf(surfels):
    """lookup_materials, the scatter cascade (same branch on every ray),
    the lobe densities and the chain model on the scene's own surfels."""
    s = surfels
    jm, tm = _j_materials(s), _t_materials(s)
    for a, b in zip(tm, jm):
        close(a, b)
    n = s["d"].shape[1]
    u = np.random.default_rng(7).uniform(size=(3, n)).astype(np.float32)
    cos_i = _cos_i(s)
    args_t = (tv(s["d"]), tv(s["point"]), tv(s["normal"]), tm,
              torch.from_numpy(cos_i), *(torch.from_numpy(r) for r in u))
    args_j = (jv(s["d"]), jv(s["point"]), jv(s["normal"]), jm, jnp.asarray(cos_i),
              *(jnp.asarray(r) for r in u))
    tsc, jsc = tbsdf.scatter(*args_t), jbsdf.scatter(*args_j)
    for f in ("alive", "diffuse_branch", "gloss_branch", "ct_branch"):
        assert np.array_equal(getattr(tsc, f).numpy(), np.asarray(getattr(jsc, f))), f
    close(tsc.origin, jsc.origin)
    close(tsc.direction, jsc.direction, TOL_PDF)
    close(tsc.weight, jsc.weight, TOL_PDF)
    # densities toward random unit directions: at the sampled direction a
    # low-roughness half vector lies on the Beckmann axis, where float32
    # cannot resolve sin (ROADMAP Queue 3, "float32 near the Beckmann axis")
    w_np = _unit(np.random.default_rng(70), n)
    w, tw = jv(w_np), tv(w_np)
    for a, b in zip(tbsdf.scatter_lobe_pdfs(tv(s["d"]), tv(s["normal"]), tm,
                                            torch.from_numpy(cos_i), tw),
                    jbsdf.scatter_lobe_pdfs(jv(s["d"]), jv(s["normal"]), jm,
                                            jnp.asarray(cos_i), w)):
        close(a, b, TOL_PDF)
    for a, b in zip(tbsdf.chain_model_pdfs(tv(s["d"]), tv(s["normal"]), tm,
                                           torch.from_numpy(cos_i), tw),
                    jbsdf.chain_model_pdfs(jv(s["d"]), jv(s["normal"]), jm,
                                           jnp.asarray(cos_i), w)):
        close(a, b, TOL_PDF)
    close(tbsdf.chain_model_pdf_taken(tv(s["d"]), tv(s["normal"]), tm,
                                      torch.from_numpy(cos_i), tw, tsc),
          jbsdf.chain_model_pdf_taken(jv(s["d"]), jv(s["normal"]), jm,
                                      jnp.asarray(cos_i), w, jsc), TOL_PDF)


# ---- 7. ops/shading -------------------------------------------------------------

def test_shading(surfels):
    """shade, shade_physical with every lobe (and the bidirectional
    competitor), the light samplers, light_areas and ct_lobe_terms."""
    s = surfels
    js, ts = s["js"], s["ts"]
    jm, tm = _j_materials(s), _t_materials(s)
    n = s["d"].shape[1]
    L = js.num_area_lights
    u = np.random.default_rng(8).uniform(size=(4 * L, n)).astype(np.float32)
    pt, nt = tv(s["point"]), tv(s["normal"])
    pj, nj = jv(s["point"]), jv(s["normal"])
    close(tshade.shade(ts, pt, nt, tm.diffuse, tm.diff_avg, torch.from_numpy(u)),
          jshade.shade(js, pj, nj, jm.diffuse, jm.diff_avg, jnp.asarray(u)))
    for li in range(L):
        args = [u[4 * li + k] for k in range(4)]
        close(tshade.area_light_point(ts, li, *map(torch.from_numpy, args)),
              jshade.area_light_point(js, li, *map(jnp.asarray, args)))
        tp = tshade.area_light_sample_uniform(ts, li, *(torch.from_numpy(args[k])
                                                        for k in (0, 1, 3)))
        jp = jshade.area_light_sample_uniform(js, li, *(jnp.asarray(args[k])
                                                        for k in (0, 1, 3)))
        for a, b in zip(tp, jp):
            close(a, b)
    close(tshade.light_areas(ts), jshade.light_areas(js))

    cos_i = _cos_i(s)
    cos_i_pos = np.abs(cos_i)
    jfr = jopt.fresnel_reflectance(*jopt.media_and_sin_t2(jm.ior, jnp.asarray(cos_i))[:4])
    p_spec = np.asarray(jm.spec_avg) * np.where((np.asarray(jm.flags) & 1) != 0, 1.0,
                                                np.asarray(jfr)).astype(np.float32)
    ct = (np.asarray(jm.flags) & 3) != 0
    mirror = npv(jopt.reflect_signed(jv(s["d"]), nj, jnp.asarray(cos_i_pos)))

    def lobes(V, A, sp, m, mod):
        gl = sp.GlossLobe(axis=mod.phong_lobe_axis(V(mirror)), exponent=m.spec_exp,
                          weight=m.specular, prob=A(np.where(ct, 0, p_spec).astype(np.float32)))
        cl = sp.CTLobe(axis=mod.phong_lobe_axis(V(s["normal"])), roughness=m.roughness,
                       weight=m.specular,
                       prob=A(np.where(ct & (npa(m.roughness) > 0), p_spec, 0).astype(np.float32)),
                       d=V(s["d"]), normal=V(s["normal"]),
                       nv=A(np.maximum(cos_i_pos, 1e-6).astype(np.float32)))
        return gl, cl

    tgl, tcl = lobes(tv, torch.from_numpy, tshade, tm, tsamp)
    jgl, jcl = lobes(jv, jnp.asarray, jshade, jm, jsamp)
    w = _unit(np.random.default_rng(9), n)
    for a, b in zip(tshade.ct_lobe_terms(tcl, tv(w)), jshade.ct_lobe_terms(jcl, jv(w))):
        close(a, b, TOL_PDF)
    g = np.random.default_rng(10)
    mult = g.uniform(0, 3, n).astype(np.float32)
    pco = g.uniform(0, 1, n).astype(np.float32)
    t2 = g.uniform(0.5, 20, n).astype(np.float32)
    for primary in (True, False):
        tb = tshade.BidirNEE(mult=torch.from_numpy(mult), out_dir=-tv(s["d"]), m=tm,
                             normal=nt, prev_cos_out=torch.from_numpy(pco),
                             t2_arr=torch.from_numpy(t2), is_primary=primary)
        jb = jshade.BidirNEE(mult=jnp.asarray(mult), out_dir=-jv(s["d"]), m=jm,
                             normal=nj, prev_cos_out=jnp.asarray(pco),
                             t2_arr=jnp.asarray(t2), is_primary=jnp.asarray(primary))
        for bid in (None, (tb, jb)):
            close(tshade.shade_physical(ts, pt, nt, tm.diffuse, tm.diff_avg,
                                        torch.from_numpy(u), mis=True, gloss=tgl,
                                        ct=tcl, bidir=bid and bid[0]),
                  jshade.shade_physical(js, pj, nj, jm.diffuse, jm.diff_avg,
                                        jnp.asarray(u), mis=True, gloss=jgl, ct=jcl,
                                        bidir=bid and bid[1]), TOL_PDF)
    close(tshade.shade_physical(ts, pt, nt, tm.diffuse, tm.diff_avg, torch.from_numpy(u)),
          jshade.shade_physical(js, pj, nj, jm.diffuse, jm.diff_avg, jnp.asarray(u)))


# ---- 8. ops/compaction ----------------------------------------------------------

def test_partition_by_activity_is_stable():
    g = np.random.default_rng(11)
    active = g.uniform(size=1000) < 0.37
    vals = g.standard_normal((3, 1000)).astype(np.float32)
    ids = np.arange(1000, dtype=np.int32)
    from typing import NamedTuple

    class JS(NamedTuple):
        v: object
        ids: object
        active: object

    jstate, jlive = jcomp.partition_by_activity(JS(jv(vals), jnp.asarray(ids),
                                                   jnp.asarray(active)))
    tstate, tlive = tcomp.partition_by_activity(JS(tv(vals), torch.from_numpy(ids),
                                                   torch.from_numpy(active)))
    assert int(tlive) == int(jlive) == int(active.sum()) == int(tcomp.live_count(tstate))
    assert np.array_equal(tstate.ids.numpy(), np.asarray(jstate.ids))
    want = np.concatenate([ids[active], ids[~active]])   # stable: order kept
    assert np.array_equal(tstate.ids.numpy(), want)
    close(tstate.v, jstate.v, dict(rtol=0, atol=0))


# ---- 9. ops/texture (the Scene-level texture block) -------------------------------

@pytest.mark.parametrize("case", ["preset", "quad", "nmap_quad", "sphere"])
def test_apply_maps_eager(case):
    js = (jpresets.textured() if case == "preset" else
          jax_textured_quad(tex=True, nmap=case != "quad", sphere=case == "sphere"))
    ts = port_scene(js)
    o, d = _rays(12, 4096)
    if case != "preset":
        o = np.zeros_like(o)
        o[2] = 0.0
        d = _unit(np.random.default_rng(13), 4096)
        d[2] = -np.abs(d[2]) - 1.0
        d /= np.sqrt((d * d).sum(0))
    jh = jint.nearest_hit(jv(o), jv(d), js)
    h = np.asarray(jh.hit)
    o, d = o[:, h], d[:, h]
    jh = jint.nearest_hit(jv(o), jv(d), js)
    th = tint.nearest_hit(tv(o), tv(d), ts)
    assert np.array_equal(th.prim.numpy(), np.asarray(jh.prim))
    # at the reference's own hits (see test_nearest_hit_surfel_and_any_hit)
    th = th._replace(t=torch.from_numpy(np.asarray(jh.t)))
    js_ = jint.surfel_at(jv(o), jv(d), jh, js)
    ts_ = tint.surfel_at(tv(o), tv(d), th, ts)
    close(ts_.normal, js_.normal)
    # the texture block on the reference's own surfel (its rsqrt and the
    # port's differ by an ulp; the UV polynomials carry that ulp on)
    ts_ = tint.Surfel(point=tv(npv(js_.point)), normal=tv(npv(js_.normal)),
                      mat=ts_.mat)
    jm = jbsdf.lookup_materials(js.materials, js_.mat)
    tm = tbsdf.lookup_materials(ts.materials, ts_.mat)
    jm2, jsurf2 = jtex.apply_maps(js, jv(o), jv(d), jh, js_, jm)
    tm2, tsurf2 = ttex.apply_maps_eager(ts, tv(o), tv(d), th, ts_, tm)
    close(tm2.diffuse, jm2.diffuse)
    close(tsurf2.normal, jsurf2.normal)
