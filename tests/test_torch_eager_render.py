"""The eager engine's renders (``cuda_path_tracer_ss_torch/render/integrator.py``
and its entry points) on the CPU: against the jnp goldens on every pixel but
the named FMA pixels, against the JAX package's jnp ``render`` per pixel in
each estimator setting, against the scalar numpy oracle
(``tests/reference_tracer.py``), the live-ray cutoff and ``live_ray_stats``,
``ProgressiveRenderer(engine="eager")`` with resume, and the CLI.

Both engines draw the same Threefry streams, so only float op-order noise
separates them: the per-pixel criterion is ``assert_per_pixel_parity``'s
(>= 99.5 % of pixels within rtol 1e-4 / atol 1e-5, channel means within
1e-3). The goldens were made on a CPU by XLA, which contracts a*b+c into
FMAs; eager PyTorch rounds after the multiply, and a few chaotic paths take
another branch for it. The same pixels differ for the port's plain engine
(``test_torch_megakernel.py::test_plain_golden_image``); they are named below
and no other pixel may differ.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.models.scene import (MaterialSpec, SceneBuilder, scale,
                                                  translate)
from cuda_path_tracer_ss_tpu.ops.grid import build_grid as jbuild_grid
from cuda_path_tracer_ss_tpu.render import integrator as jint
from cuda_path_tracer_ss_tpu.render.renderer import (
    ProgressiveRenderer as JProgressiveRenderer, RenderConfig as JRenderConfig)
from cuda_path_tracer_ss_tpu.utils import rng as jrng
from cuda_path_tracer_ss_torch.cli import main
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.grid import build_grid
from cuda_path_tracer_ss_torch.render import integrator
from cuda_path_tracer_ss_torch.render.renderer import ProgressiveRenderer, RenderConfig
from cuda_path_tracer_ss_torch.utils import rng
from reference_tracer import SceneView, trace_one
from torch_port_helpers import assert_per_pixel_parity, jax_textured_quad, port_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CP = camera_arrays(Camera())
JCP = jint.camera_arrays(JCamera())

CORNELL_FMA = {(22, 14), (26, 26), (29, 2), (31, 0)}
GOLDENS = {
    "cornell_lambert": ("cornell_lambert", False, CORNELL_FMA),
    "cornell": ("cornell", False, CORNELL_FMA),
    "showcase": ("showcase", False, {(8, 25), (9, 23), (11, 1), (12, 1), (13, 3),
                                     (17, 10), (19, 15), (21, 13), (23, 17), (25, 11)}),
    "physical_cornell": ("cornell", True, set()),
    "physical_glass": ("glass", True, set()),
}


def _eager(scene, w, h, spp, seed, **kw):
    kw.setdefault("live_cutoff", None)
    return integrator.render(scene, CP, w, h, spp, seed, device="cpu", **kw).numpy()


@pytest.mark.parametrize("golden", list(GOLDENS))
def test_golden_image(golden):
    """32x32, 8 spp, 4 bounces, seed 42: every pixel within rtol 1e-4 /
    atol 1e-5 of the jnp golden but the named FMA pixels (y, x)."""
    name, physical, known = GOLDENS[golden]
    got = _eager(tpresets.get_scene(name), 32, 32, 8, 42, max_bounces=4,
                 physical=physical)
    want = np.load(os.path.join(GOLDEN, f"{golden}_32x32_8spp_4b.npy"))
    far = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert {tuple(p) for p in np.argwhere(far).tolist()} <= known
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=1e-3)


def _textured_sphere_scene():
    return jax_textured_quad(tex=True, nmap=True, sphere=True)


SETTINGS = {
    "default": (jpresets.cornell, {}),
    "physical": (jpresets.cornell, dict(physical=True)),
    "nee_false": (jpresets.cornell, dict(physical=True, nee=False)),
    "textured": (jpresets.textured, {}),
    "textured_physical": (jpresets.textured, dict(physical=True)),
    "grid": (jpresets.cornell, dict(grid=True)),
    "bidir_nu": (jpresets.caustic, dict(physical=True, bidir_nu=0.6)),
    "live_cutoff": (jpresets.cornell, dict(live_cutoff=128)),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_render_matches_jnp_render_per_pixel(setting):
    """16x16, 2 spp, 4 bounces against the reference's jnp render."""
    make, kw = SETTINGS[setting]
    js = make()
    ts = port_scene(js)
    jkw = dict(kw, live_cutoff=kw.get("live_cutoff"))
    tkw = dict(jkw)
    if kw.get("grid"):
        jkw["grid"], tkw["grid"] = jbuild_grid(js), build_grid(ts)
    want = np.asarray(jint.render(js, JCP, 16, 16, 2, 5, max_bounces=4, **jkw))
    got = _eager(ts, 16, 16, 2, 5, max_bounces=4, **tkw)
    assert_per_pixel_parity(got, want)
    assert want.max() > 0


def test_trace_with_j_img_matches_jnp_trace():
    """``trace`` with the bidirectional carries, the camera importance
    handed in as ``j_img`` (the way render_block calls it)."""
    js = jpresets.shadowed_caustic()
    ts = port_scene(js)
    n = 16 * 16
    seed, sample = 3, 1
    pix = np.arange(n, dtype=np.int32)
    jx, jy = jrng.eye_jitter(seed, jnp.asarray(pix), sample)
    jo, jd = jint.eye_rays_for_indices(JCP, 16, 16, jnp.asarray(pix), jx, jy)
    jj = jint.eye_j_img(JCP, jd, 16, 16)
    want = np.asarray(jint.trace(js, jo, jd, seed, sample, jnp.asarray(pix),
                                 max_bounces=4, physical=True, bidir_nu=0.5,
                                 j_img=jj).to_array())
    cam = integrator.camera_tensors(CP, "cpu")
    tpix = torch.from_numpy(pix).long()
    tx, ty = rng.eye_jitter(seed, tpix, sample)
    to, td = integrator.eye_rays_for_indices(cam, 16, 16, tpix, tx, ty)
    tj = integrator.eye_j_img(cam, td, 16, 16)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-5)
    got = integrator.trace(ts, to, td, seed, sample, tpix, max_bounces=4,
                           physical=True, bidir_nu=0.5, j_img=tj).to_array().numpy()
    assert_per_pixel_parity(got, want)
    with pytest.raises(ValueError, match="bidir_nu requires the scan driver"):
        integrator.trace(ts, to, td, seed, sample, tpix, max_bounces=4,
                         physical=True, bidir_nu=0.5, j_img=tj, live_cutoff=8)


def test_while_loop_matches_scan_at_high_cutoff():
    """A cutoff of 0 live rays runs every bounce: the image of the
    differentiable loop (test_integrator.py's counterpart), here bit for
    bit; a cutoff that bites changes it, per sample."""
    scene = tpresets.cornell()
    a = _eager(scene, 8, 8, 2, 4, max_bounces=4)
    b = _eager(scene, 8, 8, 2, 4, max_bounces=4, live_cutoff=0)
    np.testing.assert_array_equal(a, b)
    c = _eager(scene, 8, 8, 2, 4, max_bounces=4, live_cutoff=40)
    assert not np.array_equal(a, c)
    # the cutoff counts each sample's rays, however many samples a
    # wavefront holds
    old = integrator.WAVE_RAYS
    try:
        integrator.WAVE_RAYS = 64          # one sample per wavefront
        d = _eager(scene, 8, 8, 2, 4, max_bounces=4, live_cutoff=40)
    finally:
        integrator.WAVE_RAYS = old
    np.testing.assert_array_equal(c, d)


def test_render_sample_and_block_are_render_s_samples():
    """render_sample (the whole image) and render_block (a block of pixels)
    trace what render traces for that sample, bit for bit."""
    scene = tpresets.showcase()
    one = _eager(scene, 10, 10, 1, 6, max_bounces=4, sample_offset=3).reshape(-1, 3)
    got = integrator.render_sample(scene, CP, 10, 10, 6, 3, max_bounces=4)
    np.testing.assert_array_equal(got.to_array().numpy(), one)
    pix = torch.arange(37, 91)
    blk = integrator.render_block(scene, integrator.camera_tensors(CP, "cpu"), 10, 10,
                                  pix, 6, 3, max_bounces=4)
    np.testing.assert_array_equal(blk.to_array().numpy(), one[37:91])


def test_live_ray_stats_match_jax():
    js = jpresets.cornell()
    want = np.asarray(jint.live_ray_stats(js, JCP, 16, 16, 3, max_bounces=6))
    got = integrator.live_ray_stats(port_scene(js), CP, 16, 16, 3, max_bounces=6,
                                    device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 1.0 and np.all(np.diff(got) <= 0)


@pytest.mark.parametrize("name", ["cornell", "showcase", "point_lights"])
def test_trace_matches_scalar_oracle(name):
    """12x12, 4 bounces, the port's rays and uniform blocks through the
    scalar numpy oracle (test_integrator.py's thresholds)."""
    js = jpresets.get_scene(name)
    ts = port_scene(js)
    w = h = 12
    n = w * h
    cam = integrator.camera_tensors(CP, "cpu")
    pix = torch.arange(n)
    jx, jy = rng.eye_jitter(0, pix, 0)
    o, d = integrator.eye_rays_for_indices(cam, w, h, pix, jx, jy)
    got = integrator.trace(ts, o, d, 0, 0, pix, max_bounces=4).to_array().numpy()
    blocks = [rng.bounce_rows(0, pix, 0, b, ts.num_area_lights).numpy()
              for b in range(4)]
    origins = o.to_array().numpy().astype(np.float64)
    dirs = d.to_array().numpy().astype(np.float64)
    want = np.stack([trace_one(SceneView(js), origins[i], dirs[i], blocks, 4, i)
                     for i in range(n)])
    close = np.isclose(got, want, atol=2e-3, rtol=2e-3).all(axis=-1)
    assert close.mean() >= (0.95 if name == "showcase" else 0.97)
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=0.02, atol=5e-3)


def test_empty_scene_and_emissive_wall():
    """A scene without primitives returns the background; an emissive wall
    in front of the camera returns its emittance (test_integrator.py)."""
    b = SceneBuilder()
    b.background = np.array([0.25, 0.5, 0.75], np.float32)
    img = _eager(port_scene(b.build()), 8, 8, 2, 1, max_bounces=3)
    np.testing.assert_allclose(img, np.broadcast_to([0.25, 0.5, 0.75], (8, 8, 3)),
                               rtol=1e-6)
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(emission=(0.3, 0.6, 0.9)))
    b.add_rect(translate((0, 0, -2)) @ scale((50, 50, 1)), m)
    img = _eager(port_scene(b.build()), 8, 8, 1, 2, max_bounces=2)
    np.testing.assert_allclose(img, np.broadcast_to([0.3, 0.6, 0.9], (8, 8, 3)),
                               rtol=1e-5, atol=1e-6)


def test_no_nan_on_showcase_and_textured_sphere():
    for scene in (tpresets.showcase(), port_scene(_textured_sphere_scene())):
        img = _eager(scene, 16, 16, 2, 5, max_bounces=6, live_cutoff=128)
        assert np.all(np.isfinite(img)) and img.max() > 0


# ---- entry points --------------------------------------------------------------

def _cfg(**kw):
    base = dict(width=16, height=16, max_bounces=4, spp=8, seed=9, device="cpu",
                engine="eager")
    base.update(kw)
    return RenderConfig(**base)


def test_progressive_renderer_matches_jax_renderer(capsys):
    """ProgressiveRenderer(engine="eager") against the reference's
    jnp-engine renderer: fixed passes of 4, the live cutoff of 128, per
    pixel."""
    jr = JProgressiveRenderer(jpresets.cornell(), JCamera(),
                              JRenderConfig(width=16, height=16, spp=8, max_bounces=4,
                                            seed=9, engine="jnp"))
    jr.run()
    r = ProgressiveRenderer(tpresets.cornell(), Camera(), _cfg())
    passes = []
    r.on_pass = passes.append
    r.run()
    assert not r.config.auto_pass_growth()
    assert [m["pass_samples"] for m in passes] == [4, 4]
    assert r.config.live_cutoff == 128
    assert_per_pixel_parity(r.radiance(), jr.radiance())


@pytest.mark.parametrize("kw", [{}, dict(physical=True, accel="grid"),
                                dict(compat_int_accum=True, samples_per_pass=1, spp=3)])
def test_resume_is_bit_identical_and_engine_mismatch_raises(tmp_path, capsys, kw):
    whole = ProgressiveRenderer(tpresets.cornell(), Camera(), _cfg(**kw))
    whole.run()
    part = ProgressiveRenderer(tpresets.cornell(), Camera(), _cfg(**kw))
    part.step()
    ck = str(tmp_path / "ck.npz")
    part.checkpoint(ck)
    resumed = ProgressiveRenderer(tpresets.cornell(), Camera(), _cfg(**kw))
    resumed.restore(ck)
    resumed.run()
    np.testing.assert_array_equal(resumed.radiance(), whole.radiance())
    other = ProgressiveRenderer(tpresets.cornell(), Camera(), _cfg(engine="plain", **kw))
    with pytest.raises(ValueError, match="engine mismatch"):
        other.restore(ck)


def test_engine_names_and_device_rule():
    assert _cfg().resolved_engine() == "eager"
    with pytest.raises(ValueError, match="engine='eager'"):
        _cfg(engine="jnp").resolved_engine()
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        integrator.render(tpresets.cornell(), CP, 4, 4, 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        integrator.live_ray_stats(tpresets.cornell(), CP, 4, 4, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProgressiveRenderer(tpresets.cornell(), Camera(), _cfg(device="cuda"))


SMALL = ["--device", "cpu", "--scene", "cornell", "--width", "12", "--height", "12",
         "--bounces", "4", "--engine", "eager"]


def test_cli_render_and_benchmark(tmp_path, capsys):
    """``render --engine eager`` writes the renderer's image (with and
    without the cutoff); ``benchmark --engine eager --stats`` prints the
    live fractions of live_ray_stats."""
    out = [str(tmp_path / f"{k}.npy") for k in range(2)]
    main(["render", *SMALL, "--spp", "8", "--out", out[0]])
    main(["render", *SMALL, "--spp", "8", "--out", out[1], "--live-cutoff", "-1"])
    r = ProgressiveRenderer(tpresets.cornell(), Camera(),
                            _cfg(width=12, height=12, seed=0, live_cutoff=None))
    r.run()
    np.testing.assert_array_equal(np.load(out[1]), r.radiance())
    assert not np.array_equal(np.load(out[0]), np.load(out[1]))
    capsys.readouterr()
    main(["benchmark", *SMALL, "--spp", "2", "--repeats", "1", "--stats"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["engine"] == "eager" and got["live_cutoff"] == 128
    fr = got["live_ray_fraction_per_bounce"]
    want = integrator.live_ray_stats(tpresets.cornell(), CP, 12, 12, 0, max_bounces=4,
                                     device="cpu")
    assert fr == [round(float(f), 4) for f in want] and fr[0] == 1.0
    assert all(b <= a for a, b in zip(fr, fr[1:]))
