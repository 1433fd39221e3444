"""The physical (unbiased MIS) estimator of the port's megakernel module on the
CPU: each device function's plain PyTorch version against its JAX function on
random inputs, the plain render against the JAX package's jnp engine per
pixel, the two physical goldens, and the host-compiler build of the CUDA
kernel's device math (torch_port_helpers.py; needs g++) against the plain
version. The CUDA kernel itself runs only on a GPU and is held against the
plain version there by chip_smoke.py.

Inputs are made from a seed with numpy. Both sides draw the same counter-RNG
streams, so images agree per pixel up to float op-order noise.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from torch_port_helpers import (assert_per_pixel_parity, port_scene,
                                render_block_sums_hostbuild)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CP = camera_arrays(Camera())

# The same float32 formulas in the same order on both sides; what differs is
# the two libraries' sqrt/rsqrt/exp/log (a few ulp each), XLA's contraction of
# a*b+c into FMAs, and the cancellations downstream of both.
TOL = dict(rtol=1e-5, atol=2e-6)
# ... except where a density divides by a cancelled quantity (|d.h| of the
# Cook-Torrance half vector, sin of a near-axis angle): ulps grow there.
TOL_PDF = dict(rtol=2e-3, atol=2e-6)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _unit(g, n, scale=None):
    v = g.standard_normal((3, n)).astype(np.float32)
    v /= np.sqrt((v * v).sum(0))
    if scale is not None:
        v *= scale
    return v[0], v[1], v[2]


def _random_materials(g, n):
    """Per-lane material columns in pack_scene order, mixing every branch:
    Lambert, Phong (finite exponent), delta mirror (inf), Cook-Torrance, pure
    reflection, glass."""
    kind = g.integers(0, 6, n)
    col = lambda lo, hi: g.uniform(lo, hi, n).astype(np.float32)
    m = [col(0, 1) for _ in range(12)]
    spec_exp = np.where(kind % 2 == 0, np.float32(np.inf), col(5, 300)).astype(np.float32)
    ior = col(1.1, 2.5)
    pd = np.where(kind == 0, col(0.3, 0.9), col(0, 0.3)).astype(np.float32)
    ps = col(0, 0.7)
    prf = np.where(kind == 5, col(0.3, 0.9), np.float32(0)).astype(np.float32)
    rough = np.where(kind == 1, np.float32(0), col(0.05, 0.6)).astype(np.float32)
    pure = (kind == 4).astype(np.float32)
    ct = ((kind == 3) | (kind == 4) | (kind == 1)).astype(np.float32)
    return m + [spec_exp, ior, pd, ps, prf, rough, pure, ct]


def _surfels(seed, n):
    """Random (d, n, cos_i, w, materials): unit ray directions, surfel normals
    that are not unit (as triangle normals are not), unit outgoing w."""
    g = np.random.default_rng(seed)
    d = _unit(g, n)
    nrm = _unit(g, n, g.uniform(0.8, 1.2, n).astype(np.float32))
    w = _unit(g, n)
    cos_i = -(d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2])
    return g, d, nrm, cos_i, w, _random_materials(g, n)


def _assert_close(got, want, name, tol=TOL):
    got, want = got.numpy(), np.asarray(want)
    assert np.all(np.isfinite(got)), name
    np.testing.assert_allclose(got, want, err_msg=name, **tol)


# ---- (a) device functions, one against one ---------------------------------

def test_phong_and_beckmann_pdf_match():
    g = np.random.default_rng(1)
    n = 4000
    a, w = _unit(g, n), _unit(g, n)
    exponent = np.where(g.integers(0, 3, n) == 0, np.float32(np.inf),
                        g.uniform(1, 400, n)).astype(np.float32)
    rough = np.where(g.integers(0, 4, n) == 0, 0, g.uniform(0.02, 0.8, n)).astype(np.float32)
    got = tmk._phong_pdf_p(*_t(*a, exponent, *w))
    want = jmk._phong_pdf_p(*a, exponent, *w)
    _assert_close(got, want, "phong", dict(rtol=2e-4, atol=1e-6))   # cos^400
    assert float((got == 0).float().mean()) > 0.4 and float(got.max()) > 1.0
    got = tmk._beckmann_pdf_p(*_t(*a, rough, *w))
    want = jmk._beckmann_pdf_p(*a, rough, *w)
    _assert_close(got, want, "beckmann", dict(rtol=2e-4, atol=1e-6))
    assert 0.2 < float((got > 0).float().mean()) < 0.6


def test_lobe_axis_matches():
    g = np.random.default_rng(2)
    t = _unit(g, 2000, g.uniform(0.5, 3.0, 2000).astype(np.float32))
    for a, w in zip(tmk._lobe_axis(*_t(*t)), jmk._lobe_axis(*t)):
        _assert_close(a, w, "lobe_axis")


def test_physical_lobes_and_lobe_terms_match():
    _, d, nrm, cos_i, w, mats = _surfels(3, 6000)
    lb = tmk._physical_lobes(*_t(*d, *nrm, cos_i), tuple(_t(*mats)))
    jlb = jmk._physical_lobes(*d, *nrm, cos_i, tuple(mats))
    assert set(lb) == set(jlb)
    for key in ("n_unit", "gloss_axis", "ct_axis"):
        for a, b in zip(lb[key], jlb[key]):
            _assert_close(a, b, key)
    for key in ("prob_g", "prob_ct", "nv"):
        _assert_close(lb[key], jlb[key], key)
    got = tmk._lobe_terms(lb, *_t(*d, *nrm, *w))
    want = jmk._lobe_terms(jlb, *d, *nrm, *w)
    for name, a, b in zip("s_d p_g s_ct p_ct cos_s".split(), got, want):
        _assert_close(a, b, name, TOL_PDF if name in ("s_ct", "p_ct", "p_g") else TOL)
    assert all(float((a > 0).float().mean()) > 0.02 for a in got)  # every lobe exercised


def _light_rows(seed, num):
    """Area-light rows (23 values each): two triangles of a random quad,
    folded along its diagonal so that their normals differ."""
    g = np.random.default_rng(seed)
    rows = []
    for i in range(num):
        c = g.uniform(-3, 3, 3)
        e1, e2 = g.standard_normal(3) * 1.5, g.standard_normal(3) * 1.5
        fold = g.standard_normal(3) * 0.5
        v = [c, c + e1, c + e1 + e2, c, c + e1 + e2, c + e2 + fold]
        rows.append(np.concatenate(v + [g.uniform(1, 20, 3), [14 + 2 * i], [i % 3]])
                    .astype(np.float32))
    return rows


def test_al_light_geom_and_sample_point_match():
    g = np.random.default_rng(4)
    n = 3000
    u1, u2, up = (g.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    for row in _light_rows(5, 3):
        geom = tmk._al_light_geom(list(torch.from_numpy(row).unbind()))
        jgeom = jmk._al_light_geom([jnp.float32(v) for v in row])
        for key in ("area0", "area1", "total"):
            _assert_close(geom[key], jgeom[key], key)
        for key in ("n0", "n1"):
            for a, b in zip(geom[key], jgeom[key]):
                _assert_close(a, b, key)
        (p, nl), (jp, jnl) = (tmk._al_sample_point(geom, *_t(u1, u2, up)),
                              jmk._al_sample_point(jgeom, u1, u2, up))
        for a, b in zip(p + nl, jp + jnl):
            _assert_close(a, b, "sample point", dict(rtol=1e-5, atol=1e-5))
        picked = (nl[0] == geom["n0"][0]).float().mean()
        assert 0.2 < float(picked) < 0.8


def _taken_masks(g, n):
    kind = g.integers(0, 4, n)
    return kind == 0, kind == 1, kind == 2      # diff, spec, refr; kind 3: none


def test_chain_model_lobes_and_taken_match():
    g, d, nrm, cos_i, w, mats = _surfels(6, 6000)
    got = tmk._chain_model_lobes(*_t(*d, *nrm, cos_i, *w), tuple(_t(*mats)))
    want = jmk._chain_model_lobes(*d, *nrm, cos_i, *w, tuple(mats))
    for name, a, b in zip("p_diff p_gloss p_ct p_refr".split(), got, want):
        _assert_close(a, b, name, TOL_PDF)
        assert float((a > 0).float().mean()) > 0.05, name
    take_diff, take_spec, take_refr = _taken_masks(g, 6000)
    ct_m = mats[19] > 0.5
    got = tmk._chain_model_taken(*_t(*d, *nrm, cos_i, *w), tuple(_t(*mats)),
                                 *_t(take_diff, take_spec, take_refr, ct_m))
    want = jmk._chain_model_taken(*d, *nrm, cos_i, *w, tuple(mats), take_diff,
                                  take_spec, take_refr, ct_m, (True, True, True))
    _assert_close(got, want, "taken", TOL_PDF)


def test_physical_prev_pdf_matches():
    g, d, nrm, cos_i, nd, mats = _surfels(7, 6000)
    take_diff, take_spec, _ = _taken_masks(g, 6000)
    ct_m = mats[19] > 0.5
    lb = tmk._physical_lobes(*_t(*d, *nrm, cos_i), tuple(_t(*mats)))
    jlb = jmk._physical_lobes(*d, *nrm, cos_i, tuple(mats))
    got = tmk._physical_prev_pdf(lb, *_t(*d, *nd, take_diff, take_spec & ~ct_m,
                                         take_spec & ct_m))
    want = jmk._physical_prev_pdf(jlb, *d, *nd, take_diff, take_spec & ~ct_m,
                                  take_spec & ct_m)
    _assert_close(got, want, "prev_pdf", TOL_PDF)
    assert float((got > 0).float().mean()) > 0.1


@pytest.mark.parametrize("bidir", [False, True])
def test_physical_direct_matches(bidir):
    """The whole direct term on random surfels, lights, draws and occlusion
    bits; with ``bidir`` also on random carries. The reference kernel's
    formulas have no ratio clamp (its jnp engine has): the carries are drawn
    where no clamp is active."""
    n, num_spheres = 5000, 2
    g, d, nrm, cos_i, _w, mats = _surfels(8 + bidir, n)
    p = [g.uniform(-2, 2, n).astype(np.float32) for _ in range(3)]
    t_w = g.uniform(0.1, 6, n).astype(np.float32)
    pp = np.where(g.integers(0, 3, n) == 0, 0, g.uniform(0.01, 3, n)).astype(np.float32)
    rows = _light_rows(10, 2)
    pl = g.uniform(-3, 3, 12).astype(np.float32)
    pl[3:6] = g.uniform(1, 30, 3); pl[9:12] = g.uniform(1, 30, 3)
    le = g.uniform(1, 15, 6).astype(np.float32)
    draws = [tuple(g.uniform(0, 1, n).astype(np.float32) for _ in range(3))
             for _ in rows]
    occ_pl = [g.integers(0, 3, n) == 0 for _ in range(2)]
    occ_al = [g.integers(0, 3, n) == 0 for _ in rows]
    # a third of the lanes hit light 0 or 1 (first triangles 14 / 16 after 2 spheres)
    prim = g.choice([3.0, 16.0, 17.0, 18.0, 19.0, 9.0], n).astype(np.float32)
    bd = jbd = None
    if bidir:
        vals = dict(T=g.uniform(0, 50, n), pco=g.uniform(0, 1, n),
                    t2=g.uniform(0.05, 30, n))
        vals = {k: v.astype(np.float32) for k, v in vals.items()}
        is_primary = g.integers(0, 3, n) == 0
        bd = dict(nu=torch.tensor(64.0), is_primary=torch.from_numpy(is_primary),
                  **{k: torch.from_numpy(v) for k, v in vals.items()})
        jbd = dict(nu=jnp.float32(64.0), is_primary=is_primary,
                   feat=(True, True, True), **vals)

    tm = tuple(_t(*mats))
    lb = tmk._physical_lobes(*_t(*d, *nrm, cos_i), tm)
    geoms = [tmk._al_light_geom(list(torch.from_numpy(r).unbind())) for r in rows]
    got = tmk._physical_direct(
        num_spheres, 2, 2, *_t(*p, *nrm, *d, t_w, pp), lb, tm,
        list(torch.from_numpy(pl).unbind()), list(torch.from_numpy(le).unbind()),
        geoms, [tuple(_t(*dr)) for dr in draws], _t(*occ_pl), _t(*occ_al),
        torch.from_numpy(prim), [torch.tensor(r[21]) for r in rows], bd=bd)
    jlb = jmk._physical_lobes(*d, *nrm, cos_i, tuple(mats))
    jgeoms = [jmk._al_light_geom([jnp.float32(v) for v in r]) for r in rows]
    want = jmk._physical_direct(
        num_spheres, 2, 2, *p, *nrm, *d, t_w, pp, jlb, tuple(mats),
        [jnp.float32(v) for v in pl], [jnp.float32(v) for v in le], jgeoms,
        draws, occ_pl, occ_al, prim, [jnp.float32(r[21]) for r in rows], bd=jbd)
    for name, a, b in zip("rgb", got, want):
        # sums of products of densities: relative to the lane's own size
        a, b = a.numpy(), np.asarray(b)
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5 * np.abs(b).max(),
                                   err_msg=name)
        assert np.isclose(a, b, rtol=1e-4, atol=1e-6).mean() > 0.99


def test_eye_ray_camera_importance_matches_the_light_side():
    """The eye side's j_img (eye_ray) and the light side's (splat_weights) are
    one function of the angle off the optical axis."""
    cos_abs = torch.linspace(0.0, 1.0, 101)
    j = tmk._camera_j_img(torch.tensor(0.5), 40, 30, cos_abs)
    want = (40 * 30) / (1.0 * (30 / 40) * np.clip(cos_abs.numpy(), 1e-4, 1.0) ** 3)
    np.testing.assert_allclose(j.numpy(), want, rtol=1e-6)


# ---- (b) per-pixel parity with the reference's jnp engine -------------------

def _reference(jscene, w, h, spp, bounces, seed, **kw):
    return np.asarray(jrender(jscene, jcamera_arrays(JCamera()), w, h, spp,
                              jnp.int32(seed), max_bounces=bounces,
                              live_cutoff=None, physical=True, **kw))


@pytest.mark.parametrize("name", ["cornell", "showcase", "point_light_spheres",
                                  "mesh_demo"])
def test_plain_physical_per_pixel_parity_with_jax(name):
    jscene = getattr(jpresets, name)()
    want = _reference(jscene, 20, 20, 2, 5, 5)
    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    got = tmk.render_megakernel(packed, CP, 5, 20, 20, 2, 5, physical=True)
    assert tuple(got.shape) == (20, 20, 3) and got.dtype == torch.float32
    assert_per_pixel_parity(got.numpy(), want)
    default = tmk.render_megakernel(packed, CP, 5, 20, 20, 2, 5)
    assert float((default - got).abs().max()) > 1e-3    # another estimator


def test_plain_physical_parity_with_jax_megakernel_interpret():
    """Against the TPU kernel's physical variant itself, run as the
    reference's own CPU tests run it (Pallas interpret mode), at the
    smallest useful size."""
    want = np.asarray(jmk.render_fast2(jpresets.cornell(), jcamera_arrays(JCamera()),
                                       12, 12, 2, 5, max_bounces=3, interpret=True,
                                       physical=True))
    got = tmk.render_fast2(tpresets.cornell(), CP, 12, 12, 2, 5, max_bounces=3,
                           physical=True, device="cpu")
    assert_per_pixel_parity(got.numpy(), want)


# ---- (c) goldens ---------------------------------------------------------------

def _golden_far(img, name):
    want = np.load(os.path.join(GOLDEN, f"physical_{name}_32x32_8spp_4b.npy"))
    np.testing.assert_allclose(img.mean((0, 1)), want.mean((0, 1)), rtol=1e-3)
    far = ~np.isclose(img, want, rtol=1e-3, atol=1e-5).all(axis=-1)
    return {tuple(p) for p in np.argwhere(far).tolist()}


# The goldens were made by the reference's jnp engine on XLA's CPU backend,
# which contracts a*b+c into FMAs; eager PyTorch rounds after the multiply,
# and on exactly these pixels (y, x) a path takes another branch for it. The
# kernel math compiled for the host WITH contraction reproduces every pixel.
GOLDEN_FMA_PIXELS = {"cornell": set(), "glass": set()}


@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_plain_physical_golden_image(name):
    img = tmk.render_fast2(tpresets.get_scene(name), CP, 32, 32, 8, 42,
                           max_bounces=4, physical=True, device="cpu").numpy()
    assert _golden_far(img, name) <= GOLDEN_FMA_PIXELS[name]


@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_kernel_math_fma_build_matches_physical_golden(name):
    packed = tmk.pack_scene(tpresets.get_scene(name), "cpu")
    sums = render_block_sums_hostbuild(packed, CP, 42, 32, 32, 8, 4, 0, 1024,
                                       fma=True, physical=True)
    assert _golden_far(sums.numpy().reshape(32, 32, 3) / 8, name) == set()


# ---- (d) entry-point semantics --------------------------------------------------

@pytest.fixture(scope="module")
def cornell_packed():
    return tmk.pack_scene(tpresets.cornell(), "cpu")


def test_physical_sample_offset_and_tiles(cornell_packed):
    kw = dict(physical=True)
    whole = tmk.render_megakernel(cornell_packed, CP, 3, 16, 16, 8, 4, **kw)
    halves = [tmk.render_megakernel(cornell_packed, CP, 3, 16, 16, 4, 4,
                                    sample_offset=o, **kw) for o in (0, 4)]
    np.testing.assert_allclose(((halves[0] + halves[1]) / 2).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-7)
    sums = tmk.render_block_sums(cornell_packed, CP, 3, 16, 16, 8, 4, 0, 256, **kw)
    tile = tmk.render_block_sums(cornell_packed, CP, 3, 16, 16, 8, 4, 57, 100, **kw)
    np.testing.assert_array_equal(tile.numpy(), sums[57:157].numpy())


def test_physical_stats_count_the_work(cornell_packed):
    stats = {}
    tmk.render_megakernel_plain(cornell_packed, CP, 1, 12, 12, 2, 5, stats=stats,
                                physical=True)
    assert stats["paths"] == 12 * 12 * 2
    assert stats["paths"] <= stats["path_bounces"] <= 5 * stats["paths"]
    assert 0 < stats["shadow_rays_occluded"] < stats["shadow_rays"] <= stats["path_bounces"]


def test_cuda_wrapper_refuses_cpu_tables_in_every_variant(cornell_packed):
    before = list(tmk.LAUNCHES_BY_VARIANT)
    for kw in (dict(physical=True), dict(physical=True, bidir_nu=4.0)):
        with pytest.raises(ValueError, match="CUDA device"):
            tmk.render_block_sums_cuda(cornell_packed, CP, 0, 8, 8, 1, 2, 0, 64, **kw)
    assert tmk.LAUNCHES_BY_VARIANT == before


# ---- the CUDA kernel's device math, compiled for the host --------------------

@pytest.mark.parametrize("name", ["cornell", "showcase", "point_lights", "stress",
                                  "glass", "stress_dense", "mesh_dense"])
def test_physical_kernel_math_host_build_matches_plain(name):
    """csrc/megakernel.cuh's physical instantiation compiled by the host C++
    compiler (FMA contraction off) and run one pixel at a time, against the
    plain version: the criterion the GPU build is held to on the card."""
    scene = {"stress_dense": lambda: tpresets.stress_dense(300),
             "mesh_dense": lambda: tpresets.mesh_dense(1)}.get(
                 name, lambda: tpresets.get_scene(name))()
    packed = tmk.pack_scene(scene, "cpu")
    # the plain version holds [rays, primitives] tensors: the scenes of
    # hundreds of primitives are compared at a smaller size
    dense = packed.counts[0] + packed.counts[1] > 100
    w, h, spp, bounces = (32, 24, 2, 5) if dense else (40, 32, 4, 6)
    for kw in (dict(), dict(sample_offset=5, sample_clamp=1.0))[:1 if dense else 2]:
        plain = tmk.render_block_sums_plain(packed, CP, 7, w, h, spp, bounces,
                                            0, w * h, physical=True, **kw)
        host = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, bounces,
                                           0, w * h, physical=True, **kw)
        assert_per_pixel_parity(host.numpy() / spp, plain.numpy() / spp)
    tile = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, bounces, 301, 200,
                                       physical=True, **kw)
    np.testing.assert_array_equal(tile.numpy(), host[301:501].numpy())
