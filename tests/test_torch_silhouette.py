"""Silhouette (visibility-boundary) gradients on the CPU:
``cuda_path_tracer_ss_torch/render/silhouette.py`` against the JAX package's
``render/silhouette.py`` on the small scenes of tests/test_silhouette.py, at
16x16, 2-4 spp, 2 bounces (the shadow term is in
test_torch_silhouette_shadow.py).

* the JAX key stream (``utils/rng.py::jax_*``) bit-equal to ``jax.random`` on
  every key and shape the module draws;
* each curve family's points, unit normals and weights (rtol 1e-5, atol 1e-5
  of the largest value);
* ``_shade_jump`` (at least 99.5 % of the points within rtol 1e-4 / atol
  1e-5; the others are listed on failure);
* ``boundary_grad`` with and without ``with_camera`` (each field within 1e-3
  of its max|g|);
* ``unsampled_reflection_mass`` and ``mirror_triangles`` (equal);
* ``make_grad_with_boundary(engine="eager")`` against the reference's
  ``engine="jnp"``, and the port's ``"plain"`` against ``"eager"`` (loss
  rtol 1e-5; gradients atol 2e-3 max|g| / rtol 1e-2, the reference's bar);
* both warnings, ``invert(silhouette=True)`` and its gates.

Each reference result is computed once per module; the tests run on one
intra-op thread.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models import scene as jscene_mod
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_tpu.render import silhouette as jsil
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models import scene as tscene_mod
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.render import integrator
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from cuda_path_tracer_ss_torch.render import silhouette as tsil
from cuda_path_tracer_ss_torch.utils import rng
from torch_port_helpers import port_scene, silhouette_scene

W = H = 16
SPP = 4
BOUNCES = 2
SEED = 3
JSPP = 2          # boundary_spp of the direct comparisons
CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())
TCP = integrator.camera_tensors(CP, "cpu")
# curve samples per family at this size
KW = dict(n_sphere=32, n_edge=16, n_isect=8, n_mirror=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the eager engine issues thousands of small
    operations, and under the tier-1 run's parallel workers each one's
    OpenMP region waits on oversubscribed cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenes(name):
    js = silhouette_scene(name, jscene_mod)
    return js, port_scene(js)


def _np(v):
    """A reference value (Vec3 pytree or array) as a numpy array."""
    if hasattr(v, "x"):
        return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)
    return np.asarray(v)


def _close_to_scale(got, want, rel, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    assert np.isfinite(got).all(), err_msg
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=err_msg)


# ---- the JAX key stream ----------------------------------------------------------------

def _jkey(recipe, seed=SEED):
    k = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(seed, jnp.int32))
    ks = jax.random.fold_in(jax.random.PRNGKey(17), jnp.asarray(seed, jnp.int32))
    return {"phi": jax.random.split(k)[0], "edge": jax.random.split(k)[1],
            "isect": jax.random.fold_in(k, 7), "mirror": jax.random.fold_in(k, 11),
            "medge": jax.random.fold_in(k, 13), "shadow": jax.random.fold_in(ks, 1),
            "tri_shadow": jax.random.fold_in(ks, 10_000 + 5)}[recipe]


def _tkey(recipe, seed=SEED):
    k = rng.jax_fold_in(rng.jax_key(0), seed)
    ks = rng.jax_fold_in(rng.jax_key(17), seed)
    return {"phi": rng.jax_split(k)[0], "edge": rng.jax_split(k)[1],
            "isect": rng.jax_fold_in(k, 7), "mirror": rng.jax_fold_in(k, 11),
            "medge": rng.jax_fold_in(k, 13), "shadow": rng.jax_fold_in(ks, 1),
            "tri_shadow": rng.jax_fold_in(ks, 10_000 + 5)}[recipe]


@pytest.mark.parametrize("recipe,shape", [
    ("phi", (2, 256)), ("edge", (14, 3, 64)), ("isect", (2, 14, 32)),
    ("mirror", (2, 2, 32)), ("medge", (2, 14, 3, 32)), ("shadow", (256, 64)),
    ("tri_shadow", (1024, 64))])
def test_jax_key_stream_is_bit_equal(recipe, shape):
    """jax_key / jax_fold_in / jax_split / jax_uniform against jax.random on
    every key recipe and shape kind the module draws (cornell's at 16x16 and
    32x32), and once on a negative seed (taken as uint32 by fold_in)."""
    for seed in ((SEED, -7) if recipe == "phi" else (SEED,)):
        want = np.asarray(jax.random.uniform(_jkey(recipe, seed), shape))
        got = rng.jax_uniform(_tkey(recipe, seed), shape).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, want), (recipe, seed)


# ---- the curve families -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_families(scene):
    """The reference's chunks of every family ``scene`` exercises
    (render/silhouette.py:677-825), compiled at once: {family: (px, py, nx,
    ny, w) flat}."""
    js, _ = _scenes(scene)
    mt = jsil.mirror_triangles(js)
    names = [f for f, (sc, _) in FAMILIES.items() if sc == scene]
    out = jax.jit(lambda js: [_jax_family_body(f, js, KW[FAMILIES[f][1]], mt)
                              for f in names])(js)
    return {f: tuple(np.asarray(a).reshape(-1) for a in o) for f, o in zip(names, out)}


def _jax_family_body(name, js, n, mt):
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(SEED, jnp.int32))
    k_phi, k_u = jax.random.split(key)
    S, T = js.num_spheres, js.num_triangles
    o = jsil._cam_origin(JCP)
    if name == "sphere":
        phi = (jnp.arange(n)[None, :] + jax.random.uniform(k_phi, (S, n))) * (2 * jnp.pi / n)
        (px, py, front), (tx, ty, _) = jax.jvp(
            lambda q: jsil._sphere_curve_xy(js, JCP, q, W, H), (phi,), (jnp.ones_like(phi),))
        cx, cy, _ = jsil.project_dir(JCP, js.sph_center - o, W, H)
        ref = (cx[:, None] - px, cy[:, None] - py)
        valid = front & jsil._sphere_valid(js, JCP)[:, None]
        measure = 2 * jnp.pi / n
    elif name == "tri":
        tt = (jnp.arange(n)[None, None, :] + jax.random.uniform(k_u, (T, 3, n))) / n
        (px, py, front), (tx, ty, _) = jax.jvp(
            lambda q: jsil._tri_edge_xy(js, JCP, q, W, H), (tt,), (jnp.ones_like(tt),))
        ox, oy = jsil._tri_opposite_xy(js, JCP, W, H)
        ref = (ox[:, :, None] - px, oy[:, :, None] - py)
        valid = front
        measure = 1.0 / n
    elif name == "isect":
        iphi = (jnp.arange(n)[None, None, :]
                + jax.random.uniform(jax.random.fold_in(key, 7), (S, T, n))) * (2 * jnp.pi / n)
        (px, py, front), (tx, ty, _) = jax.jvp(
            lambda q: jsil._sphere_tri_curve_xy(js, JCP, q, W, H), (iphi,),
            (jnp.ones_like(iphi),))
        _, _, qc, _, _ = jsil._sphere_tri_geom(js)
        cx, cy, _ = jsil.project_dir(JCP, qc - o, W, H)
        ref = (cx[:, :, None] - px, cy[:, :, None] - py)
        valid = (front & jsil._sphere_tri_valid(js)[:, :, None]
                 & jsil._sphere_tri_inside(js, iphi))
        measure = 2 * jnp.pi / n
    elif name == "mirror":
        mphi = (jnp.arange(n)[None, None, :] + jax.random.uniform(
            jax.random.fold_in(key, 11), (len(mt), S, n))) * (2 * jnp.pi / n)
        (px, py, front), (tx, ty, _) = jax.jvp(
            lambda q: jsil._mirror_sphere_curve_xy(js, JCP, mt, q, W, H), (mphi,),
            (jnp.ones_like(mphi),))
        cx, cy, mvalid = jsil._mirror_sphere_ref(js, JCP, mt, mphi, W, H)
        ref = (cx[:, :, None] - px, cy[:, :, None] - py)
        valid = front & mvalid
        measure = 2 * jnp.pi / n
    else:
        met = (jnp.arange(n)[None, None, None, :] + jax.random.uniform(
            jax.random.fold_in(key, 13), (len(mt), T, 3, n))) / n
        (px, py, front), (tx, ty, _) = jax.jvp(
            lambda q: jsil._mirror_tri_edge_curve_xy(js, JCP, mt, q, W, H), (met,),
            (jnp.ones_like(met),))
        ox, oy, mevalid = jsil._mirror_tri_edge_ref(js, JCP, mt, met, W, H)
        ref = (ox[..., None] - px, oy[..., None] - py)
        valid = front & mevalid
        measure = 1.0 / n
    nx, ny, speed = jsil._unit_normal(tx, ty, *ref)
    valid = valid & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    w = jnp.where(valid, speed * measure, 0.0)
    return px, py, nx, ny, w


FAMILIES = {"sphere": ("buried_sphere", "n_sphere"), "tri": ("buried_sphere", "n_edge"),
            "isect": ("buried_sphere", "n_isect"), "mirror": ("mirror_tableau", "n_mirror"),
            "medge": ("mirror_tableau", "n_mirror")}


def _port_chunks(ts, seed=SEED):
    return tsil._curve_chunks(ts, ts, TCP, W, H, seed, KW["n_sphere"], KW["n_edge"],
                              KW["n_isect"], None, tsil.mirror_triangles(ts), KW["n_mirror"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_curve_family_points_normals_weights(family):
    """Every family's curve points, unit normals and weights (the tangent by
    torch.func.jvp against jax.jvp) on the scene that exercises it, with a
    non-empty set of valid points."""
    scene, _ = FAMILIES[family]
    _, ts = _scenes(scene)
    want = _jax_families(scene)[family]
    _, w, px, py, nx, ny = _port_chunks(ts)[family]
    got = tuple(a.reshape(-1).numpy() for a in (px, py, nx, ny, w))
    assert (want[4] > 0).sum() >= 4, "the family samples nothing here"
    np.testing.assert_array_equal(got[4] > 0, want[4] > 0, err_msg="valid mask")
    on = want[4] > 0
    for name, g, v in zip(("px", "py", "nx", "ny", "w"), got, want):
        np.testing.assert_allclose(g[on], v[on], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(v[on]).max()),
                                   err_msg=f"{family} {name}")


def test_mirror_triangles_and_reflection_mass_match():
    """mirror_triangles equal on four scenes; unsampled_reflection_mass
    equal (to float rounding) on the curved-mirror scene and zero on the
    flat-mirror one."""
    for name in ("mirror_tableau", "mirror_shadow", "curved_mirror"):
        js, ts = _scenes(name)
        assert tsil.mirror_triangles(ts) == jsil.mirror_triangles(js), name
    assert tsil.mirror_triangles(tpresets.cornell()) == jsil.mirror_triangles(jpresets.cornell())
    rng_ = np.random.default_rng(0)
    for name, want_spheres, want_tris in (("curved_mirror", True, False),
                                          ("mirror_tableau", True, True)):
        js, ts = _scenes(name)
        dl = rng_.normal(size=(H, W, 3)).astype(np.float32)
        want = float(jax.jit(lambda js, dl: jsil.unsampled_reflection_mass(
            js, JCP, dl, W, H, SEED, want_spheres, want_tris))(js, jnp.asarray(dl)))
        got = float(tsil.unsampled_reflection_mass(ts, CP, torch.from_numpy(dl), W, H, SEED,
                                                   want_spheres, want_tris))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        assert (want > 0.02) == (name == "curved_mirror")


# ---- the jump and the primary boundary term ----------------------------------------------

FIELDS = ("sph_radius", "sph_center", "tri_v0", "tri_v2")
SPHERE_FIELDS = ("sph_radius", "sph_center")
TARGET = np.full((H, W, 3), 0.2, np.float32)
MG = dict(max_bounces=BOUNCES, boundary_spp=JSPP, **KW)


@pytest.fixture(scope="module")
def buried():
    """The reference's boundary_grad on the sphere-through-wall scene
    (sphere silhouette, wall edges, the crease) for a fixed random adjoint
    image (the term is linear in it, so no render is compiled)."""
    js, ts = _scenes("buried_sphere")
    dl = np.random.default_rng(1).normal(size=(H, W, 3)).astype(np.float32)
    g = jsil.boundary_grad(js, jinverse.extract_params(js, FIELDS), JCP, jnp.asarray(dl), W, H,
                           SEED, spp=JSPP, max_bounces=BOUNCES, **KW)
    return dict(js=js, ts=ts, dl=dl, g_bnd={k: _np(x) for k, x in g.items()})


@pytest.fixture(scope="module")
def sphere():
    """The reference's make_grad_with_boundary(engine="jnp") on the emissive
    sphere (no area light: no shadow term), with its boundary_grad call
    recorded: the adjoint image it got and its result, taken
    with_camera=True (the parameter part is what make_grad adds). One
    compile serves the camera-term and the make_grad comparisons."""
    js, ts = _scenes("emissive_sphere")
    calls = []
    orig = jsil.boundary_grad

    def recording(*args, **kwargs):
        out = orig(*args, **dict(kwargs, with_camera=True))
        calls.append((args[3], out))
        return out[0]

    jsil.boundary_grad = recording
    try:
        vg = jsil.make_grad_with_boundary(js, JCP, jnp.asarray(TARGET), SPHERE_FIELDS, W, H,
                                          SPP, engine="jnp", **MG)
        v, g = vg(jinverse.extract_params(js, SPHERE_FIELDS), SEED)
    finally:
        jsil.boundary_grad = orig
    (dl, (g_bnd, g_cam)), = calls
    return dict(ts=ts, dl=np.array(dl), v=float(v), g={k: _np(x) for k, x in g.items()},
                g_bnd={k: _np(x) for k, x in g_bnd.items()},
                g_cam=[np.asarray(c) for c in g_cam])


def test_shade_jump_matches(buried):
    """_shade_jump on the curve points of two families per scene (the paired
    eye rays through the eager engine's trace against the jnp engine's):
    >= 99.5 % of the points within rtol 1e-4 / atol 1e-5. A paired probe
    ray can flip its hit between the two implementations (XLA contracts
    FMAs, eager PyTorch does not); such points are the ones allowed out."""
    js, ts = buried["js"], buried["ts"]
    families = ("sphere", "tri", "isect")
    chunks = _port_chunks(ts)
    x, y, nx, ny = (torch.cat([chunks[f][k].reshape(-1) for f in families])
                    for k in (2, 3, 4, 5))
    bounces = BOUNCES
    want = np.asarray(jax.jit(lambda js, *a: jsil._shade_jump(
        js, JCP, *a, W, H, SEED, JSPP, bounces, False, True, 0.05))(
            js, *(jnp.asarray(t.numpy()) for t in (x, y, nx, ny))))
    got = tsil._shade_jump(ts, TCP, x, y, nx, ny, W, H, SEED, JSPP, bounces, False, True,
                           0.05).numpy()
    assert np.abs(want).max() > 0.1, "no jump measured"
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    bad = np.nonzero(~ok)[0]
    assert ok.mean() >= 0.995, [(int(i), got[i].tolist(), want[i].tolist()) for i in bad[:10]]


def test_boundary_grad_matches(buried):
    """boundary_grad on the sphere-through-wall scene (sphere silhouette,
    wall edges, the crease): each field within 1e-3 of its max|g|, the
    result's keys and shapes those of ``params``."""
    ts = buried["ts"]
    tp = tinverse.extract_params(ts, FIELDS)
    g = tsil.boundary_grad(ts, tp, CP, torch.from_numpy(buried["dl"]), W, H, SEED, spp=JSPP,
                           max_bounces=BOUNCES, **KW)
    assert set(g) == set(FIELDS)
    for k in FIELDS:
        assert g[k].shape == tp[k].shape, k
        _close_to_scale(g[k].numpy(), buried["g_bnd"][k], 1e-3, k)
        assert np.abs(buried["g_bnd"][k]).max() > 0, k


def test_boundary_grad_with_camera_matches(sphere):
    """boundary_grad(with_camera=True) on the emissive sphere, with the
    adjoint image the reference's make_grad computed: the parameter part and
    the camera term (a tuple matching integrator.camera_tensors) each within
    1e-3 of its max|g|."""
    ts = sphere["ts"]
    tp = tinverse.extract_params(ts, SPHERE_FIELDS)
    g, g_cam = tsil.boundary_grad(ts, tp, CP, torch.from_numpy(sphere["dl"]), W, H, SEED,
                                  spp=JSPP, max_bounces=BOUNCES, with_camera=True, **KW)
    for k in SPHERE_FIELDS:
        _close_to_scale(g[k].numpy(), sphere["g_bnd"][k], 1e-3, k)
    assert abs(float(g["sph_radius"][0])) > 0.1
    for i, (c, want) in enumerate(zip(g_cam, sphere["g_cam"])):
        assert c.shape == TCP[i].shape
        _close_to_scale(c.numpy(), want, 1e-3, f"camera {i}")
    assert float(np.abs(sphere["g_cam"][1]).max()) > 0


@pytest.mark.slow  # ~30 s of XLA compile for the reference's five families
def test_boundary_grad_mirror_families_match():
    """boundary_grad on the mirror tableau (the off-frustum sphere and
    triangle seen only in the flat mirror), 3 bounces: each field within
    1e-3 of its max|g|, and non-zero."""
    js, ts = _scenes("mirror_tableau")
    fields = ("sph_center", "sph_radius", "tri_v0", "tri_v2")
    img = jrender(js, JCP, W, H, SPP, SEED, max_bounces=3, live_cutoff=None)
    dl = jsil.mse_adjoint(img, jnp.zeros((H, W, 3), jnp.float32))
    mt = jsil.mirror_triangles(js)
    want = jsil.boundary_grad(js, jinverse.extract_params(js, fields), JCP, dl, W, H, SEED,
                              spp=JSPP, max_bounces=3, mirror_tris=mt, **KW)
    got = tsil.boundary_grad(ts, tinverse.extract_params(ts, fields), CP,
                             torch.from_numpy(np.asarray(dl)), W, H, SEED, spp=JSPP,
                             max_bounces=3, mirror_tris=tsil.mirror_triangles(ts), **KW)
    for k in fields:
        w = _np(want[k])
        assert np.abs(w).max() > 1e-4, k
        _close_to_scale(got[k].numpy(), w, 1e-3, k)


def test_boundary_grad_zero_for_materials(buried):
    """A field silhouettes do not move gets exact zeros of its shape."""
    ts = buried["ts"]
    tp = tinverse.extract_params(ts, ("materials.emission", "sph_radius"))
    g = tsil.boundary_grad(ts, tp, CP, torch.from_numpy(buried["dl"]), W, H, SEED, spp=1,
                           max_bounces=BOUNCES, **KW)
    assert g["materials.emission"].shape == tp["materials.emission"].shape
    assert float(g["materials.emission"].abs().max()) == 0.0
    assert float(g["sph_radius"].abs().max()) > 0


# ---- make_grad_with_boundary ---------------------------------------------------------------

def test_make_grad_eager_matches_jnp(sphere):
    """make_grad_with_boundary(engine="eager") against the reference's
    engine="jnp" on the emissive sphere: loss rtol 1e-5, gradients atol
    2e-3 max|g| / rtol 1e-2."""
    ts = sphere["ts"]
    vt = tsil.make_grad_with_boundary(ts, CP, torch.from_numpy(TARGET), SPHERE_FIELDS, W, H,
                                      SPP, engine="eager", device="cpu", **MG)
    v, g = vt(tinverse.extract_params(ts, SPHERE_FIELDS), SEED)
    np.testing.assert_allclose(float(v), sphere["v"], rtol=1e-5)
    for k in SPHERE_FIELDS:
        a = sphere["g"][k]
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(g[k].numpy(), a, atol=2e-3 * (np.abs(a).max() + 1e-9),
                                   rtol=1e-2, err_msg=k)


def test_make_grad_plain_matches_eager():
    """The plain engine's interior gradient (autograd through the plain
    render, the CPU counterpart of K1 + K2) with the boundary terms against
    the eager engine's, on the shadow scene (every term on): the
    reference's engine comparison."""
    ts = silhouette_scene("shadow", tscene_mod)
    fields = ("sph_radius", "sph_center")
    target = torch.zeros((H, W, 3))
    params = tinverse.extract_params(ts, fields)
    kw = dict(MG, n_phi=8, device="cpu")
    v1, g1 = tsil.make_grad_with_boundary(ts, CP, target, fields, W, H, SPP, engine="eager",
                                          **kw)(params, SEED)
    v2, g2 = tsil.make_grad_with_boundary(ts, CP, target, fields, W, H, SPP, engine="plain",
                                          **kw)(params, SEED)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-5)
    for k in fields:
        a = g1[k].numpy()
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(g2[k].numpy(), a, atol=2e-3 * np.abs(a).max(), rtol=1e-2,
                                   err_msg=k)


def test_warnings():
    """The detector warns on a curved mirror showing the optimized sphere
    and stays silent without one; triangle blockers past 24 triangles are
    turned off with a warning."""
    import warnings

    kw = dict(max_bounces=3, n_sphere=8, n_edge=4, boundary_spp=1, n_phi=2, device="cpu")
    target = torch.zeros((8, 8, 3))
    for name, warns in (("curved_mirror", True), ("no_mirror", False)):
        ts = silhouette_scene(name, tscene_mod)
        vg = tsil.make_grad_with_boundary(ts, CP, target, ["sph_center"], 8, 8, 1, **kw)
        params = tinverse.extract_params(ts, ["sph_center"])
        if warns:
            with pytest.warns(UserWarning, match="UNSAMPLED"):
                vg(params, 0)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error", UserWarning)
                vg(params, 0)
    mesh = tpresets.get_scene("mesh")
    assert mesh.num_triangles > 24
    vg = tsil.make_grad_with_boundary(mesh, CP, torch.zeros((4, 4, 3)), ["sph_radius"], 4, 4,
                                      1, max_bounces=1, n_sphere=4, n_edge=1, n_isect=0,
                                      boundary_spp=1, n_phi=1, mirrors=False, device="cpu")
    with pytest.warns(UserWarning, match="auto threshold"):
        vg(tinverse.extract_params(mesh, ["sph_radius"]), 0)


def test_invert_silhouette_eager_and_gates():
    """invert(silhouette=True, engine="eager") on the emissive sphere: three
    Adam steps, the loss falls; the gates raise the reference's
    ValueErrors (plain, the light engines, accel='grid'), in the reference's
    order."""
    ts = silhouette_scene("emissive_sphere", tscene_mod)
    target = integrator.render(ts, CP, 12, 12, 2, SEED, max_bounces=BOUNCES, live_cutoff=None,
                               device="cpu")
    start = tinverse.merge_params(ts, {"sph_radius": torch.tensor([0.9])})
    _, params, losses = tinverse.invert(start, CP, target, ["sph_radius"], 12, 12, spp=2,
                                        steps=3, lr=0.1, seed=SEED, max_bounces=BOUNCES,
                                        engine="eager", silhouette=True, device="cpu")
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert float(params["sph_radius"][0]) > 0.9
    for kw, match in ((dict(engine="plain"), "silhouette=True supports engine='eager' or "
                                             "'cuda' \\(the plain"),
                      (dict(engine="lighttrace", physical=True), "silhouette=True supports"),
                      (dict(engine="eager", accel="grid"), "accel='grid' would go stale")):
        with pytest.raises(ValueError, match=match):
            tinverse.invert(ts, CP, target, ["sph_radius"], 12, 12, steps=1,
                            silhouette=True, device="cpu", **kw)
