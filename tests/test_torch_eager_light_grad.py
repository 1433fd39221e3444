"""Training through light paths on the eager engine, on the CPU:
``make_loss`` / ``value_and_grad`` / ``invert`` with ``engine="lighttrace"``
and ``engine="bidir"`` against ``jax.value_and_grad`` of the JAX package's
``make_loss`` on the same scene, target and seed (loss rtol 1e-5, gradients
rtol 1e-3 / atol 1e-4 of the field's max|g|), the reference's tier-1
finite-difference probes and inversion, the gates the reference keeps, and
the command line (``lighttrace|bidir --engine eager``, ``invert --engine
lighttrace|bidir``).

``jax.value_and_grad`` of the reference's bidir loss takes about four
minutes to compile on a CPU, so the bidir engine's gradient is held against
it in a ``slow`` test; tier-1 holds its loss against JAX, its light half's
gradient under the bidirectional weights against ``jax.grad`` of the
reference's light tracer, and its whole gradient against finite differences.
The reference's gradient of ``materials.ior`` under the bidirectional weights
is NaN (on both halves, on every scene tried); the port's is finite, and the
comparison leaves that field out where the reference has no number.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.render import integrator as jint
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_tpu.render.lighttrace import render_lighttrace as jrender_lighttrace
from cuda_path_tracer_ss_torch.cli import main
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from cuda_path_tracer_ss_torch.render.bidir import render_bidir
from cuda_path_tracer_ss_torch.render.lighttrace import render_lighttrace
from torch_port_helpers import port_scene

CP = camera_arrays(Camera())
JCP = jint.camera_arrays(JCamera())
FIELDS = ["materials.emission", "materials.diffuse", "materials.ior"]
SIZE, SPP, BOUNCES, SEED = 10, 2, 3, 3
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the eager engine issues thousands of small
    operations, and under the tier-1 run's parallel workers each one's
    OpenMP region waits on oversubscribed cores
    (test_torch_eager_light.py's emitter test took 179 s so, against under a
    second alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _device(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return device


def _target(seed=0):
    return np.random.default_rng(seed).uniform(0, 0.3, (SIZE, SIZE, 3)).astype(np.float32)


def _grads_close(got, want):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].cpu().numpy()
        assert np.all(np.isfinite(g)), k
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * scale + 1e-12, err_msg=k)


def _port_value_and_grad(ts, engine, target, fields=FIELDS, device="cpu"):
    loss = tinverse.make_loss(ts, CP, torch.from_numpy(target), SIZE, SIZE, SPP,
                              max_bounces=BOUNCES, engine=engine, physical=True,
                              device=device)
    assert loss.grad_mode == "autograd"
    return tinverse.value_and_grad(loss, tinverse.extract_params(ts, fields), SEED)


# ---- autograd against jax.value_and_grad ------------------------------------------

@pytest.mark.parametrize("name", ["cornell_lambert", "shadowed_caustic"])
def test_lighttrace_value_and_grad_match_jax(name):
    """10x10, 2 spp (200 light paths), 3 bounces, seed 3, fields emission,
    diffuse and ior: the loss and every gradient against the reference's;
    the glass of shadowed_caustic gets finite gradients."""
    js = jpresets.get_scene(name)
    target = _target()
    jloss = jinverse.make_loss(js, JCP, jnp.asarray(target), SIZE, SIZE, SPP,
                               max_bounces=BOUNCES, engine="lighttrace", physical=True)
    jval, jgrad = jax.value_and_grad(jloss)(jinverse.extract_params(js, FIELDS),
                                            jnp.int32(SEED))
    val, grad = _port_value_and_grad(port_scene(js), "lighttrace", target)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    _grads_close(grad, jgrad)
    assert float(grad["materials.emission"].abs().max()) > 0


def test_bidir_loss_and_light_half_gradient_match_jax():
    """shadowed_caustic, the same sizes: the bidir loss against the
    reference's, and the gradient of the light half under the
    bidirectional weights (nu = n_paths / spp) against ``jax.grad`` of the
    reference's light tracer, on emission and diffuse; every field of the
    whole bidir gradient, ior included, is finite."""
    js = jpresets.shadowed_caustic()
    ts = port_scene(js)
    target = _target()
    jloss = jinverse.make_loss(js, JCP, jnp.asarray(target), SIZE, SIZE, SPP,
                               max_bounces=BOUNCES, engine="bidir", physical=True)
    jval = jloss(jinverse.extract_params(js, FIELDS), jnp.int32(SEED))
    val, grad = _port_value_and_grad(ts, "bidir", target)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grad.values())
    assert float(grad["materials.ior"].abs().max()) > 0

    n_paths = SPP * SIZE * SIZE
    nu = n_paths / SPP
    light_fields = FIELDS[:2]

    def jlight(params):
        img = jrender_lighttrace(jinverse.merge_params(js, params), JCP, SIZE, SIZE,
                                 n_paths, SEED, max_bounces=BOUNCES, bidir_nu=nu)
        return jnp.sum(img * jnp.asarray(target))

    jgrad = jax.grad(jlight)(jinverse.extract_params(js, light_fields))
    params = {k: v.clone().requires_grad_(True)
              for k, v in tinverse.extract_params(ts, light_fields).items()}
    img = render_lighttrace(tinverse.merge_params(ts, params), CP, SIZE, SIZE, n_paths,
                            SEED, max_bounces=BOUNCES, bidir_nu=nu, device="cpu")
    got = dict(zip(params, torch.autograd.grad((img * torch.from_numpy(target)).sum(),
                                               list(params.values()))))
    _grads_close(got, jgrad)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["cornell_lambert", "shadowed_caustic"])
def test_bidir_value_and_grad_match_jax(name):
    """The whole bidir gradient against ``jax.value_and_grad`` of the
    reference's bidir loss (about four minutes of XLA compilation per
    scene), on the fields where the reference has a finite gradient."""
    js = jpresets.get_scene(name)
    target = _target()
    jloss = jinverse.make_loss(js, JCP, jnp.asarray(target), SIZE, SIZE, SPP,
                               max_bounces=BOUNCES, engine="bidir", physical=True)
    jval, jgrad = jax.value_and_grad(jloss)(jinverse.extract_params(js, FIELDS),
                                            jnp.int32(SEED))
    val, grad = _port_value_and_grad(port_scene(js), "bidir", target)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    assert not np.isfinite(np.asarray(jgrad["materials.ior"])).all()
    _grads_close(grad, {k: v for k, v in jgrad.items() if k != "materials.ior"})
    assert bool(torch.isfinite(grad["materials.ior"]).all())


# ---- the reference's finite-difference probes and inversions ----------------------

def test_lighttrace_grad_emission_matches_fd():
    """tests/test_lighttrace.py:149-168: the gradient of the light-trace
    loss along random directions of the light's emission against central
    differences on the same streams (12x12, 2 spp, 3 bounces, eps 1e-2,
    rtol 2e-3)."""
    scene = tpresets.cornell_lambert()
    w = h = 12
    target = render_lighttrace(scene, CP, w, h, 2000, 0, max_bounces=3, device="cpu") * 0.8
    loss = tinverse.make_loss(scene, CP, target, w, h, 2, max_bounces=3,
                              engine="lighttrace", physical=True, device="cpu")
    params = tinverse.extract_params(scene, ("materials.emission",))
    ad, fd = tinverse.directional_fd_check(loss, params, 5, eps=1e-2)
    np.testing.assert_allclose(ad, fd, rtol=2e-3, atol=1e-9)


@pytest.mark.parametrize("device", DEVICES)
def test_bidir_loss_gating_and_fd_grads(device):
    """tests/test_bidir.py:173-203: physical=True required, al_power
    refused, point lights accepted; <grad, v> of the bidir loss on emission
    + diffuse against central differences (12x12, 2 spp, 3 bounces, eps
    2e-3, rtol 0.08)."""
    device = _device(device)
    scene = tpresets.cornell_lambert()
    with pytest.raises(ValueError, match="PHYSICAL"):
        tinverse.make_loss(scene, CP, torch.zeros(8, 8, 3), 8, 8, 2, max_bounces=3,
                           engine="bidir", device=device)
    with pytest.raises(ValueError, match="al_power"):
        tinverse.check_engine_fields("bidir", ["al_power"])
    tinverse.check_engine_fields("bidir", ["pl_power", "materials.emission"])
    fields = ["materials.emission", "materials.diffuse"]
    loss = tinverse.make_loss(scene, CP, torch.zeros(12, 12, 3), 12, 12, 2, max_bounces=3,
                              engine="bidir", physical=True, device=device)
    ad, fd = tinverse.directional_fd_check(loss, tinverse.extract_params(scene, fields), 0,
                                           eps=2e-3)
    np.testing.assert_allclose(ad, fd, rtol=0.08, atol=5e-7)
    assert np.abs(ad).max() > 1e-7


@pytest.mark.parametrize("device", DEVICES)
def test_lighttrace_invert_recovers_emission_scale(device):
    """tests/test_lighttrace.py:181-211: descend the light's emission toward
    a 1.5x brighter target rendered on the same fixed streams (12x12, 2 spp,
    3 bounces, 40 Adam steps, lr 5e-2): the loss falls more than 10x and the
    emission comes within 0.2."""
    device = _device(device)
    scene = tpresets.cornell_lambert()
    w = h = 12
    p = tinverse.extract_params(scene, ("materials.emission",))
    bright = tinverse.merge_params(scene, {"materials.emission":
                                           p["materials.emission"] * 1.5})
    target = render_lighttrace(bright, CP, w, h, 2 * w * h, 3, max_bounces=3, device=device)
    _, params, losses = tinverse.invert(scene, CP, target, ("materials.emission",), w, h,
                                        spp=2, steps=40, lr=5e-2, seed=3, max_bounces=3,
                                        engine="lighttrace", physical=True, device=device)
    assert losses[-1] < losses[0] / 10, (losses[0], losses[-1])
    err = (params["materials.emission"] - p["materials.emission"] * 1.5).abs().max()
    assert float(err) < 0.2


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_caustic_inversion_bidir_beats_forward(device):
    """tests/test_bidir.py:85-131: recover the emitter's emission from a
    caustic-dominated target on shadowed_caustic (24x24), bidir (4 spp +
    4*W*H light paths) against forward-only (8 spp), 250 resampled Adam
    steps at lr 0.5 each: bidir's relative error < 0.35, forward's > 0.6,
    bidir's < half the forward's."""
    device = _device(device)
    scene = tpresets.shadowed_caustic()
    w = h = 24
    target = render_bidir(scene, CP, w, h, 64, 600_000, 123, max_bounces=6, device=device)
    fields = ["materials.emission"]
    em_true = tinverse.extract_params(scene, fields)["materials.emission"]
    li = int(em_true.abs().sum(1).argmax())
    start = tinverse.with_field(scene, "materials.emission", em_true * 0.35)
    common = dict(steps=250, lr=0.5, max_bounces=6, seed=0, resample_every=1,
                  physical=True, device=device)
    _, pb, _ = tinverse.invert(start, CP, target, fields, w, h, spp=4, engine="bidir",
                               **common)
    _, pf, _ = tinverse.invert(start, CP, target, fields, w, h, spp=8, engine="eager",
                               **common)
    eb = ((pb["materials.emission"][li] - em_true[li]).abs() / em_true[li]).numpy()
    ef = ((pf["materials.emission"][li] - em_true[li]).abs() / em_true[li]).numpy()
    assert eb.max() < 0.35, (eb, ef)
    assert ef.min() > 0.6, (eb, ef)
    assert eb.max() < 0.5 * ef.min(), (eb, ef)


# ---- the gates --------------------------------------------------------------------

@pytest.mark.parametrize("engine,fields,match", [
    ("lighttrace", ["al_power"], "al_power"),
    ("lighttrace", ["pl_power", "materials.emission"], "pl_power"),
    ("lighttrace", ["pl_pos"], "pl_pos"),
    ("bidir", ["al_power", "materials.diffuse"], "al_power"),
])
def test_light_engines_refuse_fields_they_never_read(engine, fields, match):
    """tests/test_lighttrace.py:171-178 and tests/test_bidir.py:173-190:
    a field the estimator never reads raises instead of returning a silent
    zero gradient, in check_engine_fields and in invert."""
    with pytest.raises(ValueError, match=match):
        tinverse.check_engine_fields(engine, fields)
    with pytest.raises(ValueError, match=match):
        tinverse.invert(tpresets.cornell(), CP, torch.zeros(8, 8, 3), fields, 8, 8, steps=1,
                        engine=engine, physical=True, device="cpu")
    tinverse.check_engine_fields(engine, ["materials.emission", "materials.diffuse",
                                          "materials.ior", "sph_center"])


@pytest.mark.parametrize("engine", ["lighttrace", "bidir"])
def test_light_engines_keep_the_reference_s_gates(engine):
    """PHYSICAL required, no accel='grid', no silhouette (a ValueError, not
    the silhouette term's NotImplementedError), and the card by default."""
    scene = tpresets.cornell_lambert()
    zeros = torch.zeros(8, 8, 3)
    with pytest.raises(ValueError, match="PHYSICAL"):
        tinverse.make_loss(scene, CP, zeros, 8, 8, 1, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="does not take accel='grid'"):
        tinverse.make_loss(scene, CP, zeros, 8, 8, 1, engine=engine, accel="grid",
                           physical=True, device="cpu")
    with pytest.raises(ValueError, match="silhouette=True supports"):
        tinverse.invert(scene, CP, zeros, ["sph_center"], 8, 8, steps=1, engine=engine,
                        physical=True, silhouette=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinverse.make_loss(scene, CP, zeros, 8, 8, 1, engine=engine, physical=True)


# ---- the command line ---------------------------------------------------------------

LIGHT = ["--engine", "eager", "--device", "cpu", "--width", "12", "--height", "12",
         "--bounces", "3", "--paths", "600", "--batches", "2"]


@pytest.mark.parametrize("scene", ["caustic", "textured"])
@pytest.mark.parametrize("cmd", ["lighttrace", "bidir"])
def test_light_commands_on_the_eager_engine(cmd, scene, tmp_path, capsys):
    """lighttrace|bidir --engine eager on the CPU write an image, textured
    scenes too; without --engine eager a textured scene raises naming it
    (no silent switch of engine)."""
    from cuda_path_tracer_ss_torch.utils.image import read_png

    out = str(tmp_path / "x.png")
    main([cmd, *LIGHT, "--scene", scene, "--spp", "1", "--out", out])
    text = capsys.readouterr().out
    assert "batch 2/2" in text and "engine eager" in text and f"wrote {out}" in text
    img = read_png(out)
    assert img.shape == (12, 12, 3) and img.max() > 0
    if scene == "textured":
        with pytest.raises(ValueError, match="--engine eager"):
            main([cmd, *LIGHT[2:], "--scene", scene, "--spp", "1", "--out", out])


@pytest.mark.parametrize("engine", ["lighttrace", "bidir"])
def test_invert_on_the_light_engines(engine, capsys):
    """invert --engine lighttrace|bidir --physical --device cpu at 8x8 prints
    the reference CLI's JSON and its loss falls; render refuses the
    training-only engines."""
    main(["invert", "--engine", engine, "--physical", "--device", "cpu", "--scene",
          "cornell_lambert", "--fields", "materials.emission", "--width", "8", "--height",
          "8", "--spp", "2", "--bounces", "3", "--steps", "6", "--lr", "0.1"])
    out = capsys.readouterr().out.strip().splitlines()
    got = json.loads(out[-1])
    first = float(next(ln for ln in out if ln.startswith("step    0")).split()[-1])
    assert set(got) == {"final_loss", "max_abs_err"} and got["final_loss"] < first
    with pytest.raises(ValueError, match="training-only"):
        main(["render", "--engine", engine, "--device", "cpu", "--width", "8",
              "--height", "8", "--spp", "1"])
