"""The port's frame loop (ProgressiveRenderer, tonemap, image writers) on the
CPU against the JAX package's, on the same scenes, seeds and pass splits."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops import tonemap as jtonemap
from cuda_path_tracer_ss_tpu.render.renderer import (
    ProgressiveRenderer as JProgressiveRenderer, RenderConfig as JRenderConfig)
from cuda_path_tracer_ss_tpu.utils import image as jimage
from cuda_path_tracer_ss_torch.models import presets
from cuda_path_tracer_ss_torch.models.camera import Camera
from cuda_path_tracer_ss_torch.ops import tonemap
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.render.renderer import (ProgressiveRenderer,
                                                       RenderConfig)
from cuda_path_tracer_ss_torch.utils import image
from cuda_path_tracer_ss_torch.utils.profiling import PassMeter, timed
from torch_port_helpers import assert_per_pixel_parity


def _cfg(**kw):
    base = dict(width=16, height=16, max_bounces=3, spp=4, seed=9, device="cpu")
    base.update(kw)
    return RenderConfig(**base)


def _renderer(scene=None, **kw):
    return ProgressiveRenderer(scene or presets.cornell(), Camera(), _cfg(**kw))


def test_renderer_matches_jax_renderer(capsys):
    """16x16, 4 spp in 2 passes, plain engine against the reference's jnp
    engine: same streams and pass boundaries, float op-order noise only
    (rtol 1e-4 / atol 1e-5 per pixel; see torch_port_helpers)."""
    jr = JProgressiveRenderer(
        jpresets.cornell(), JCamera(),
        JRenderConfig(width=16, height=16, spp=4, samples_per_pass=2,
                      max_bounces=3, seed=9, live_cutoff=None, engine="jnp"))
    jr.run()
    r = _renderer(samples_per_pass=2, engine="plain")
    passes = []
    r.on_pass = passes.append
    r.run()
    assert [m["pass_samples"] for m in passes] == [2, 2]
    assert passes[-1]["samples_per_pixel"] == 4
    got = r.radiance()
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    assert_per_pixel_parity(got, jr.radiance())
    u8 = r.image_u8()
    assert u8.dtype == np.uint8 and u8.shape == (16, 16, 3)
    assert np.abs(u8.astype(int) - jr.image_u8().astype(int)).max() <= 1
    np.testing.assert_array_equal(r.image(), u8.astype(np.float32) / 255.0)


def test_auto_pass_schedule_equals_jax():
    jr = JProgressiveRenderer(jpresets.cornell_empty(), JCamera(),
                              JRenderConfig(width=8, height=8, engine="jnp"))
    r = _renderer(presets.cornell_empty(), width=8, height=8)
    assert r.AUTO_PASS_CAP == jr.AUTO_PASS_CAP
    assert r.config.base_pass_size() == jr.config.base_pass_size() == 4
    for s in range(5000):
        assert r._auto_pass_size(s) == jr._auto_pass_size(s), s


def test_auto_growth_run_and_step_rules(capsys):
    r = _renderer(spp=30)
    assert r.config.resolved_engine() == "plain" and r.config.auto_pass_growth()
    passes = []
    r.on_pass = passes.append
    r.run()
    assert [m["pass_samples"] for m in passes] == [4, 8, 16, 2]
    fixed = _renderer(samples_per_pass=2)
    with pytest.raises(ValueError, match="variable pass"):
        fixed.step(3)
    with pytest.raises(ValueError, match="not reachable"):
        fixed.run(5)


def test_checkpoint_resume_bit_identical(tmp_path, capsys):
    whole = _renderer(spp=28)
    whole.run()
    first = _renderer(spp=28)
    first.run(12)
    ck = str(tmp_path / "ck.npz")
    first.checkpoint(ck)
    second = _renderer(spp=28)
    second.restore(ck)
    assert second._samples_done == 12
    second.run()
    np.testing.assert_array_equal(second.radiance(), whole.radiance())
    # the path without the suffix restores too
    third = _renderer(spp=28)
    third.restore(str(tmp_path / "ck"))
    assert third._samples_done == 12


def _edit_checkpoint(src, dst, **fields):
    data = dict(np.load(src))
    data.update(fields)
    np.savez(dst, **data)


def test_restore_mismatches_raise(tmp_path, capsys):
    r = _renderer()
    r.run()
    ck = str(tmp_path / "ck.npz")
    r.checkpoint(ck)
    with pytest.raises(ValueError, match="seed mismatch"):
        _renderer(seed=10).restore(ck)
    with pytest.raises(ValueError, match="resolution mismatch"):
        _renderer(width=8).restore(ck)
    with pytest.raises(ValueError, match="accumulation mode mismatch"):
        _renderer(compat_int_accum=True, samples_per_pass=1).restore(ck)
    with pytest.raises(ValueError, match="scene mismatch"):
        _renderer(presets.cornell_lambert()).restore(ck)
    other = str(tmp_path / "other.npz")
    _edit_checkpoint(ck, other, engine="cuda")
    with pytest.raises(ValueError, match="engine mismatch"):
        _renderer().restore(other)
    _renderer().restore(ck)  # and the matching one loads


def test_compat_int_accum_close_to_jax(capsys):
    """Reference display pipeline (clamp -> gamma -> quantize -> integer sum):
    a sample within an ulp of an 8-bit bucket edge may land one bucket apart
    — bounds of tests/test_pallas_cpu.py."""
    jr = JProgressiveRenderer(
        jpresets.cornell(), JCamera(),
        JRenderConfig(width=16, height=16, spp=4, samples_per_pass=1,
                      max_bounces=3, seed=9, live_cutoff=None, engine="jnp",
                      compat_int_accum=True))
    jr.run()
    r = _renderer(samples_per_pass=1, compat_int_accum=True)
    r.run()
    a = r._accum_numpy()
    assert a.dtype == np.uint32
    diff = np.abs(a.astype(np.int64) - np.asarray(jr._accum).astype(np.int64))
    assert diff.max() <= 4, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()
    assert np.abs(r.image_u8().astype(int) - jr.image_u8().astype(int)).max() <= 1
    assert r.radiance().shape == (16, 16, 3)
    with pytest.raises(ValueError, match="samples_per_pass=1"):
        _renderer(compat_int_accum=True, samples_per_pass=2)


def test_tonemap_functions_equal_jax():
    g = np.random.default_rng(0)
    x = g.uniform(-0.2, 1.5, (64, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    # pow differs by an ulp between the libraries
    np.testing.assert_allclose(tonemap.tonemap(t).numpy(),
                               np.asarray(jtonemap.tonemap(x)), rtol=1e-6, atol=1e-7)
    d = g.uniform(-0.1, 1.1, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(tonemap.to_uint8(torch.from_numpy(d)).numpy(),
                                  np.asarray(jtonemap.to_uint8(d)))
    tot = g.integers(0, 255 * 7, (64, 3)).astype(np.uint32)
    np.testing.assert_array_equal(
        tonemap.compat_display(torch.from_numpy(tot.astype(np.int32)), 7).numpy(),
        np.asarray(jtonemap.compat_display(jnp.asarray(tot), 7)))
    acc = tonemap.compat_accumulate(torch.from_numpy(tot.astype(np.int32)), t)
    jacc = np.asarray(jtonemap.compat_accumulate(jnp.asarray(tot), x))
    assert acc.dtype == torch.int32
    assert np.abs(acc.numpy().astype(np.int64) - jacc.astype(np.int64)).max() <= 1


def test_reset_move_camera_and_ray_trace_mode(capsys):
    r = _renderer()
    r.step()
    assert r._samples_done == 4 and float(r._accum.abs().sum()) > 0
    assert r.move_camera("z") is False and r._samples_done == 4
    assert r.move_camera("w") is True
    assert r._samples_done == 0 and float(r._accum.abs().sum()) == 0
    np.testing.assert_allclose(r.camera.position, [0, 0, -0.2], atol=1e-7)
    assert r.effective_bounces == 3
    assert r.toggle_ray_trace_mode() is True and r.effective_bounces == 1
    r.step()
    one_bounce = r.radiance()
    assert r.toggle_ray_trace_mode() is False and r._samples_done == 0
    r.step()
    assert float(r.radiance().mean()) > float(one_bounce.mean())


def test_image_writers_equal_jax_bytes(tmp_path, capsys):
    r = _renderer()
    r.run()
    u8 = r.image_u8()
    assert image.encode_png(u8) == jimage.encode_png(u8)
    for ext, jwrite in ((".png", jimage.write_png), (".tga", jimage.write_tga)):
        mine, theirs = str(tmp_path / ("a" + ext)), str(tmp_path / ("b" + ext))
        r.save(mine)
        jwrite(theirs, u8)
        with open(mine, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read()
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "a.png")), u8[::-1])
    r.save(str(tmp_path / "a.npy"))
    np.testing.assert_array_equal(np.load(str(tmp_path / "a.npy")), r.radiance())


def test_config_engine_and_unported_options():
    assert _cfg().resolved_engine() == "plain"
    assert RenderConfig().device == "cuda"
    assert RenderConfig().resolved_engine() == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _cfg(engine="cuda").resolved_engine()
    with pytest.raises(ValueError, match="unknown engine"):
        _cfg(engine="jnp").resolved_engine()
    with pytest.raises(ValueError, match="unknown accel"):
        _renderer(accel="bvh")
    # the grid is ported: the linear sweeps' image, in both accumulation
    # modes, and a resume through it is exact
    for kw in (dict(), dict(physical=True), dict(compat_int_accum=True, samples_per_pass=1)):
        images = []
        for accel in ("none", "grid"):
            r = _renderer(presets.stress(), accel=accel, spp=2, **kw)
            r.run()
            images.append(r.radiance())
        np.testing.assert_array_equal(images[0], images[1])


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    before = tmk.LAUNCH_COUNT
    with pytest.raises((RuntimeError, AssertionError)):
        ProgressiveRenderer(presets.cornell(), Camera(),
                            RenderConfig(width=8, height=8, spp=1))
    assert tmk.LAUNCH_COUNT == before


def test_pass_meter_and_timed(tmp_path):
    log = str(tmp_path / "m.jsonl")
    m = PassMeter(10, 10, jsonl_path=log)
    a = m.record(4, 0.5)
    b = m.record(4, 1.5)
    assert a["primary_rays_per_s"] == 800 and b["avg_rays_per_s"] == 400
    assert "Rays per pixel: 8" in m.console_line(b)
    assert len(open(log).read().splitlines()) == 2
    out, sec = timed(lambda: torch.ones(3).sum(), reps=2, warmup=1, device="cpu")
    assert float(out) == 3.0 and sec > 0


# ---- the physical estimator through the frame loop ---------------------------

def test_physical_renderer_matches_jax_renderer(capsys):
    """RenderConfig(physical=True), 16x16, 4 spp in 2 passes, against the
    reference's jnp engine in physical mode: per-pixel parity."""
    jr = JProgressiveRenderer(
        jpresets.cornell(), JCamera(),
        JRenderConfig(width=16, height=16, spp=4, samples_per_pass=2,
                      max_bounces=3, seed=9, live_cutoff=None, engine="jnp",
                      physical=True))
    jr.run()
    r = _renderer(samples_per_pass=2, physical=True)
    r.run()
    assert_per_pixel_parity(r.radiance(), jr.radiance())
    default = _renderer(samples_per_pass=2)
    default.run()
    assert np.abs(default.radiance() - r.radiance()).max() > 1e-3


@pytest.mark.parametrize("compat", [False, True])
def test_physical_checkpoint_resume_bit_identical(tmp_path, capsys, compat):
    kw = dict(physical=True, spp=12)
    if compat:
        kw.update(compat_int_accum=True, samples_per_pass=1, spp=5)
    whole = _renderer(**kw)
    whole.run()
    first = _renderer(**kw)
    first.run(3 if compat else 4)
    ck = str(tmp_path / "ck.npz")
    first.checkpoint(ck)
    second = _renderer(**kw)
    second.restore(ck)
    second.run()
    np.testing.assert_array_equal(second.radiance(), whole.radiance())
    assert whole.radiance().max() > 0


def test_grid_checkpoint_resume_bit_identical(tmp_path, capsys):
    """accel='grid' keeps the checkpoint / resume contract: a grid render
    stopped, checkpointed and resumed equals the linear render in one go."""
    kw = dict(spp=6, max_bounces=2)
    whole = _renderer(presets.stress(), **kw)
    whole.run()
    first = _renderer(presets.stress(), accel="grid", **kw)
    first.run(4)     # a pass boundary of the AUTO schedule (4, then 2)
    ck = str(tmp_path / "ck.npz")
    first.checkpoint(ck)
    second = _renderer(presets.stress(), accel="grid", **kw)
    second.restore(ck)
    second.run()
    np.testing.assert_array_equal(second.radiance(), whole.radiance())
