"""Light paths on the eager engine, on the CPU: ``render/lighttrace.py``
(``project_dir``, ``camera_splat_weights``, ``lighttrace_block``,
``render_lighttrace``) and ``render/bidir.py::render_bidir`` against the JAX
package's jnp functions on the same scenes and streams, per pixel; the
bidirectional golden; block tilings of the paths; and the reference's
tier-1 light-tracing and bidirectional tests, ported.

Tolerances: geometry rtol 1e-5 / atol 1e-6; images per pixel rtol 1e-4 /
atol 1e-6 of the image's largest value (``index_add`` and XLA's scatter sum
the splats of a pixel in different orders).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.vec import Vec3 as JVec3
from cuda_path_tracer_ss_tpu.render import lighttrace as jlt
from cuda_path_tracer_ss_tpu.render.bidir import render_bidir as jrender_bidir
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.silhouette import project_dir as jproject_dir
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.models.scene import MaterialSpec, SceneBuilder, translate
from cuda_path_tracer_ss_torch.ops.vec import Vec3
from cuda_path_tracer_ss_torch.render import integrator
from cuda_path_tracer_ss_torch.render import lighttrace as tlt
from cuda_path_tracer_ss_torch.render.bidir import render_bidir
from torch_port_helpers import port_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())
TCP = integrator.camera_tensors(CP, "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the eager engine issues thousands of small
    operations, and under the tier-1 run's parallel workers each one's
    OpenMP region waits on oversubscribed cores (the emitter test below took
    179 s so, against under a second alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images_close(got, want, known=frozenset()):
    """Every pixel within rtol 1e-4 / atol 1e-6 of the largest value, but
    the named pixels (y, x)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    far = ~np.isclose(got, want, rtol=1e-4,
                      atol=1e-6 * float(np.abs(want).max())).all(axis=-1)
    assert {tuple(p) for p in np.argwhere(far).tolist()} <= known
    assert float(np.abs(want).max()) > 0


# ---- the camera connection's geometry ---------------------------------------------

def _points(n=4096, seed=0):
    """Points inside cornell_lambert's box, in front of and behind the eye."""
    g = np.random.default_rng(seed)
    return g.uniform((-5, -5, -12), (5, 5, 2), (n, 3)).astype(np.float32)


def test_project_dir_and_splat_weights_match_jax():
    p = _points()
    tp = Vec3(*(torch.from_numpy(p[:, k]) for k in range(3)))
    jp = JVec3(*(jnp.asarray(p[:, k]) for k in range(3)))
    d = tp - Vec3(*(TCP[1][k] for k in range(3)))
    d = d / torch.sqrt(d.norm2())
    jd = JVec3(jnp.asarray(d.x.numpy()), jnp.asarray(d.y.numpy()), jnp.asarray(d.z.numpy()))
    for got, want in zip(tlt.project_dir(TCP, d, 24, 16), jproject_dir(JCP, jd, 24, 16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    pix, on, dc, r2, r, j = tlt.camera_splat_weights(TCP, tp, 24, 16)
    jpix, jon, jdc, jr2, jr, jj = jlt.camera_splat_weights(JCP, jp, 24, 16)
    np.testing.assert_array_equal(on.numpy(), np.asarray(jon))
    assert 0.2 < float(on.float().mean()) < 0.9
    for got, want in ((r2, jr2), (r, jr), (j, jj), (dc.x, jdc.x), (dc.y, jdc.y),
                      (dc.z, jdc.z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the same pixel wherever the projection lies away from a pixel edge
    px, py, _ = jproject_dir(JCP, jdc, 24, 16)
    frac = np.minimum(np.abs(np.asarray(px) - np.round(np.asarray(px))),
                      np.abs(np.asarray(py) - np.round(np.asarray(py))))
    inside = np.asarray(jon) & (frac > 1e-3)
    assert inside.sum() > 1000
    np.testing.assert_array_equal(pix.numpy()[inside], np.asarray(jpix)[inside])


# ---- render_lighttrace against the jnp light tracer ------------------------------

LIGHT_CASES = [(name, nu) for name in ("cornell_lambert", "caustic", "shadowed_caustic",
                                       "textured") for nu in (None, 4.0)]


@pytest.mark.parametrize("name,nu", LIGHT_CASES,
                         ids=[f"{n}-{'bidir' if nu else 'plain'}" for n, nu in LIGHT_CASES])
def test_render_lighttrace_matches_jax(name, nu):
    """16x16, 2*W*H = 512 paths, 4 bounces, seed 7, plain and bidirectional
    weights (nu 4); the textured preset reads its maps at every vertex."""
    js = jpresets.get_scene(name)
    want = jlt.render_lighttrace(js, JCP, 16, 16, 512, 7, max_bounces=4, bidir_nu=nu)
    got = tlt.render_lighttrace(port_scene(js), CP, 16, 16, 512, 7, max_bounces=4,
                                bidir_nu=nu, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (16, 16, 3)
    _images_close(got.numpy(), want)


@pytest.mark.parametrize("nu", [None, 8.0], ids=["plain", "bidir"])
def test_blocks_of_paths_sum_to_the_batch(nu):
    """Streams key on the GLOBAL path index and dead paths are partitioned
    away with their indices, so any tiling of the paths over blocks gives
    the batch's splats: contiguous blocks and an interleaved split, summed,
    equal the whole batch to summation order."""
    scene = tpresets.caustic()
    n = 600
    whole = tlt.render_lighttrace(scene, CP, 12, 12, n, 5, max_bounces=5, bidir_nu=nu,
                                  device="cpu").reshape(-1, 3) * n
    idx = torch.arange(n)
    for blocks in ([idx[:1], idx[1:250], idx[250:]], [idx[0::2], idx[1::2]]):
        total = sum(tlt.lighttrace_block(scene, CP, 12, 12, b, 5, max_bounces=5,
                                         bidir_nu=nu) for b in blocks)
        np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(whole.abs().max()))
    # an empty block adds nothing; the batch is not a black image
    assert float(tlt.lighttrace_block(scene, CP, 12, 12, idx[:0], 5).abs().sum()) == 0.0
    assert float(whole.abs().max()) > 0


# ---- the reference's tier-1 light tests (tests/test_lighttrace.py) ---------------

def _lt(scene, batches, paths, bounces, w=24, h=24):
    acc = torch.zeros((h, w, 3))
    for k in range(batches):
        acc += tlt.render_lighttrace(scene, CP, w, h, paths, 0, max_bounces=bounces,
                                     sample_idx=k, device="cpu")
    return (acc / batches).numpy()


def test_emitter_direct_splat_matches_forward():
    """An emissive quad against black: the emitter splat reproduces the
    forward render's emitter image (pins J_img to the inverse of the
    jittered eye-ray map)."""
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(emission=(2.0, 1.0, 0.5)))
    t = translate((0.0, 0.0, -4.0))
    t[0, 0] = 2.4
    t[1, 1] = 2.4
    b.add_area_light(t, m, (1.0, 1.0, 1.0))
    b.background = np.zeros(3, np.float32)
    scene = b.build()
    fwd = integrator.render(scene, CP, 24, 24, 32, 0, max_bounces=2, live_cutoff=None,
                            physical=True, device="cpu").numpy()
    lt = _lt(scene, batches=4, paths=60_000, bounces=2)
    np.testing.assert_allclose(lt[9:15, 9:15].mean((0, 1)), fwd[9:15, 9:15].mean((0, 1)),
                               rtol=0.03)
    np.testing.assert_allclose(fwd[12, 12], (2.0, 1.0, 0.5), rtol=0.01)
    assert lt[:2].max() < 1e-3 and fwd[:2].max() < 1e-3


def test_backlit_surface_black_in_both():
    """A diffuse quad facing the camera, lit only from behind, is black in
    the forward render and must stay black under light tracing."""
    b = SceneBuilder()
    md = b.add_material(MaterialSpec(diffuse=(0.8, 0.8, 0.8), diff_avg=0.8))
    n = (0.0, 0.0, 1.0)
    b.add_triangle((-3, -3, -5), (3, -3, -5), (3, 3, -5), n, n, n, md)
    b.add_triangle((-3, -3, -5), (3, 3, -5), (-3, 3, -5), n, n, n, md)
    ml = b.add_material(MaterialSpec(emission=(5.0, 5.0, 5.0)))
    t = translate((0.0, 0.0, -7.0))
    t[0, 0] = t[1, 1] = 3.0
    b.add_area_light(t, ml, (1.0, 1.0, 1.0))
    b.background = np.zeros(3, np.float32)
    scene = b.build()
    fwd = integrator.render(scene, CP, 16, 16, 16, 0, max_bounces=3, live_cutoff=None,
                            physical=True, device="cpu").numpy()
    lt = _lt(scene, batches=2, paths=40_000, bounces=3, w=16, h=16)
    assert fwd[6:10, 6:10].max() < 1e-4, fwd[6:10, 6:10].max()
    assert lt[6:10, 6:10].max() < 1e-4, lt[6:10, 6:10].max()


def _point_light_only():
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(0.5, 0.5, 0.5), diff_avg=0.5))
    b.add_sphere((0, 0, -4), 1.0, m)
    b.add_point_light((0, 3, -4), (10.0, 10.0, 10.0))
    return b.build()


def test_light_paths_need_an_area_light_and_a_card_unless_asked():
    with pytest.raises(ValueError, match="area light"):
        tlt.render_lighttrace(_point_light_only(), CP, 8, 8, 16, 0, max_bounces=2,
                              device="cpu")
    with pytest.raises(ValueError, match="area light"):
        render_bidir(_point_light_only(), CP, 8, 8, 4, 100, 0, max_bounces=2, device="cpu")
    if not torch.cuda.is_available():   # the default device is the card: no fallback
        for fn in (lambda: tlt.render_lighttrace(tpresets.caustic(), CP, 8, 8, 16, 0),
                   lambda: render_bidir(tpresets.caustic(), CP, 8, 8, 1, 16, 0)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


# ---- render_bidir ---------------------------------------------------------------------

# cornell_lambert's pixel (3, 9) takes another path in the eye half (the
# eager engine's FMA pixels: XLA's CPU backend contracts a*b+c, eager
# PyTorch does not)
BIDIR_CASES = {"cornell_lambert": {(3, 9)}, "shadowed_caustic": set()}


@pytest.mark.parametrize("name", list(BIDIR_CASES))
def test_render_bidir_matches_jax(name):
    """16x16, 2 spp + 512 light paths (nu 256), 3 bounces, seed 3."""
    js = jpresets.get_scene(name)
    want = jrender_bidir(js, JCP, 16, 16, 2, 512, 3, max_bounces=3)
    got = render_bidir(port_scene(js), CP, 16, 16, 2, 512, 3, max_bounces=3, device="cpu")
    _images_close(got.numpy(), want, known=BIDIR_CASES[name])


def test_golden_image_bidir():
    """The reference pins bidir_shadowed_caustic_16x16_2spp_512p_3b.npy bit
    for bit (tests/test_golden.py:40-53); the eager render holds every pixel
    within rtol 1e-4 / atol 1e-6 of its largest value (no FMA pixel here)."""
    want = np.load(os.path.join(GOLDEN, "bidir_shadowed_caustic_16x16_2spp_512p_3b.npy"))
    got = render_bidir(tpresets.shadowed_caustic(), CP, 16, 16, 2, 512, 42, max_bounces=3,
                       device="cpu").numpy()
    _images_close(got, want)
    assert want.mean() > 1e-4


def test_nu_zero_limit_is_the_physical_estimator():
    """As nu -> 0 the light techniques carry no weight: the eye half with
    bidir_nu 1e-12 reproduces the physical estimator (tests/test_bidir.py:
    17-28, atol 1e-6)."""
    scene = tpresets.cornell_lambert()
    kw = dict(max_bounces=4, live_cutoff=None, physical=True, device="cpu")
    plain = integrator.render(scene, CP, 16, 16, 8, 0, **kw)
    tiny = integrator.render(scene, CP, 16, 16, 8, 0, bidir_nu=1e-12, **kw)
    np.testing.assert_allclose(tiny.numpy(), plain.numpy(), rtol=0, atol=1e-6)
