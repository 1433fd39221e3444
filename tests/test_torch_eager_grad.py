"""Training through the eager engine on the CPU: autograd through
``render/integrator.py`` (``make_loss`` / ``value_and_grad`` / ``invert`` with
``engine="eager"``) against ``jax.value_and_grad`` of the JAX package's jnp
``make_loss`` on the same scene, target and seed (loss rtol 1e-5, gradients
rtol 1e-3 / atol 1e-4 of the field's max|g|, as the K2 criteria of PERF.md
§2), the tier-1 finite-difference probes of ``tests/test_gradients.py``, the
port's plain engine on the fields both cover, finite gradients where the
reference needed its clamped derivatives, and the engine's name.
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
from cuda_path_tracer_ss_torch.cli import main
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays, quat_from_euler
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.render import integrator
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from torch_port_helpers import jax_textured_quad, port_scene

CP = camera_arrays(Camera())
JCP = jint.camera_arrays(JCamera())


def _grads_close(got, want):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert np.all(np.isfinite(g)), k
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * scale + 1e-12,
                                   err_msg=k)


CASES = {
    "cornell_lambert": (jpresets.cornell_lambert, ["materials.diffuse", "al_power"],
                        16, False),
    "glass": (jpresets.glass_showcase, ["materials.diffuse", "materials.absorption",
                                        "materials.ior", "sph_center", "tri_v0"],
              16, False),
    "textured_quad": (lambda: jax_textured_quad(tex=True, nmap=True),
                      ["textures", "materials.diffuse"], 16, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_value_and_grad_match_jax(case):
    make, fields, size, physical = CASES[case]
    js = make()
    ts = port_scene(js)
    target = np.random.default_rng(0).uniform(0, 0.5, (size, size, 3)).astype(np.float32)
    jloss = jinverse.make_loss(js, JCP, jnp.asarray(target), size, size, 2, max_bounces=4,
                               engine="jnp", physical=physical)
    jval, jgrad = jax.value_and_grad(jloss)(jinverse.extract_params(js, fields),
                                            jnp.int32(3))
    loss = tinverse.make_loss(ts, CP, torch.from_numpy(target), size, size, 2,
                              max_bounces=4, engine="eager", physical=physical,
                              device="cpu")
    assert loss.grad_mode == "autograd"
    val, grad = tinverse.value_and_grad(loss, tinverse.extract_params(ts, fields), 3)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    _grads_close(grad, jgrad)
    assert all(float(g.abs().max()) > 0 for g in grad.values())


def _fd_check(scene, fields, rtol, eps=2e-3, seed=0):
    """tests/test_gradients.py::_check on the eager engine: 24x24, 2 spp, 4
    bounces, MSE against black."""
    loss = tinverse.make_loss(scene, CP, torch.zeros(24, 24, 3), 24, 24, 2,
                              max_bounces=4, engine="eager", device="cpu")
    ad, fd = tinverse.directional_fd_check(loss, tinverse.extract_params(scene, fields),
                                           seed, eps=eps)
    assert np.all(np.isfinite(ad)) and np.all(np.isfinite(fd))
    scale = np.maximum(np.abs(fd), np.abs(ad)).max() + 1e-8
    np.testing.assert_allclose(ad, fd, rtol=rtol, atol=0.02 * scale)


def test_grad_diffuse_albedo_matches_fd():
    _fd_check(tpresets.cornell_lambert(), ["materials.diffuse"], rtol=0.05)


def test_grad_absorption_matches_fd():
    _fd_check(tpresets.glass_showcase(), ["materials.absorption"], rtol=0.08)


@pytest.mark.parametrize("physical", [False, True])
def test_eager_matches_the_plain_engine(physical):
    """On the fields the kernel engines cover, autograd through the eager
    engine equals autograd through the plain version of the kernels."""
    scene = tpresets.cornell()
    fields = ["materials.diffuse", "materials.specular", "materials.roughness",
              "materials.ior", "sph_center", "sph_radius"]
    fields += ["materials.spec_avg"] if physical else ["al_power"]
    target = torch.rand((12, 12, 3), generator=torch.Generator().manual_seed(1))
    out = []
    for engine in ("eager", "plain"):
        loss = tinverse.make_loss(scene, CP, target, 12, 12, 2, max_bounces=4,
                                  engine=engine, physical=physical, device="cpu")
        out.append(tinverse.value_and_grad(loss, tinverse.extract_params(scene, fields), 5))
    (ve, ge), (vp, gp) = out
    np.testing.assert_allclose(float(ve), float(vp), rtol=1e-5)
    _grads_close(ge, {k: v.numpy() for k, v in gp.items()})


def test_no_nan_gradients_on_showcase_and_at_the_poles():
    """Every trainable field of showcase, and a textured, normal-mapped
    sphere's centre, radius and texels seen through its poles: finite
    gradients (the clamped sqrt / rsqrt derivatives at work)."""
    scene = tpresets.showcase()
    fields = [f for f in tinverse.TRAINABLE_FIELDS
              if f != "textures" and tinverse.get_field(scene, f).numel()]
    loss = tinverse.make_loss(scene, CP, torch.zeros(12, 12, 3), 12, 12, 2,
                              max_bounces=5, engine="eager", device="cpu")
    _, grad = tinverse.value_and_grad(loss, tinverse.extract_params(scene, fields), 1)
    for k, g in grad.items():
        assert bool(torch.isfinite(g).all()), k
    sphere = port_scene(jax_textured_quad(tex=True, nmap=True, sphere=True))
    # cameras looking straight down at the north pole and up at the south
    for y, rx in ((4.0, -90.0), (-4.0, 90.0)):
        cam = Camera(position=np.array([0.0, y, -4.0], np.float32),
                     rotation=quat_from_euler((np.radians(rx), 0.0, 0.0)))
        loss = tinverse.make_loss(sphere, camera_arrays(cam), torch.zeros(16, 16, 3),
                                  16, 16, 2, max_bounces=3, engine="eager",
                                  device="cpu")
        _, grad = tinverse.value_and_grad(
            loss, tinverse.extract_params(sphere, ["sph_center", "sph_radius",
                                                   "textures"]), 2)
        for k, g in grad.items():
            assert bool(torch.isfinite(g).all()), k
        if y > 0:      # the north pole faces the point light
            assert float(grad["sph_center"].abs().max()) > 0


def test_engine_jnp_raises_naming_eager():
    for call in (
            lambda: tinverse.make_loss(tpresets.cornell(), CP, torch.zeros(4, 4, 3), 4, 4,
                                       1, engine="jnp"),
            lambda: tinverse.invert(tpresets.cornell(), CP, torch.zeros(4, 4, 3),
                                    ["materials.diffuse"], 4, 4, steps=1, engine="jnp"),
            lambda: tinverse.check_engine_fields("jnp", ["materials.diffuse"])):
        with pytest.raises(ValueError, match="engine='eager'"):
            call()
    # the eager engine restricts no field, as the reference's jnp engine
    tinverse.check_engine_fields("eager", ["tri_v0", "materials.spec_avg", "pl_pos"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tinverse.make_loss(tpresets.cornell(), CP, torch.zeros(4, 4, 3), 4, 4, 1,
                               engine="eager")


def test_invert_reproduces_the_plain_engine_s_invert():
    """5 Adam steps on cornell's diffuse colours (the start of
    test_torch_inverse.py::test_invert_reproduces_jax_invert, which holds
    the plain engine's invert against the reference's), each engine toward
    its own render of the truth: the losses to rtol 1e-4, the parameters to
    atol 1e-4."""
    w = h = 12
    spp, bounces, steps, lr, seed = 2, 3, 5, 0.1, 7
    ts = tpresets.cornell()
    start = torch.clamp(ts.materials.diffuse + 0.3, 0.05, 1.0)
    runs = []
    for engine in ("eager", "plain"):
        if engine == "eager":
            target = integrator.render(ts, CP, w, h, spp, seed, max_bounces=bounces,
                                       live_cutoff=None, device="cpu")
        else:
            target = tmk.render_megakernel_plain(tmk.pack_scene(ts, "cpu"), CP, seed,
                                                 w, h, spp, bounces)
        runs.append(tinverse.invert(
            tinverse.with_field(ts, "materials.diffuse", start), CP, target,
            ["materials.diffuse"], w, h, spp=spp, steps=steps, lr=lr, seed=seed,
            max_bounces=bounces, engine=engine, device="cpu"))
    (_, pe, le), (_, pp, lp) = runs
    np.testing.assert_allclose(le, lp, rtol=1e-4)
    np.testing.assert_allclose(pe["materials.diffuse"].numpy(),
                               pp["materials.diffuse"].numpy(), atol=1e-4)
    assert le[-1] < le[0]


def test_cli_grad_check_and_invert_on_the_eager_engine(capsys):
    train = ["--device", "cpu", "--engine", "eager", "--width", "10", "--height", "10",
             "--spp", "2", "--bounces", "3"]
    main(["grad-check", "--scene", "cornell_lambert", *train, "--directions", "2"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["engine"] == "eager" and got["allclose"] is True
    main(["invert", "--scene", "cornell", *train, "--steps", "3",
          "--fields", "materials.diffuse,sph_center"])
    out = capsys.readouterr().out.strip().splitlines()
    got = json.loads(out[-1])
    first = float(next(ln for ln in out if ln.startswith("step    0")).split()[-1])
    assert np.isfinite(got["final_loss"]) and got["final_loss"] < first
