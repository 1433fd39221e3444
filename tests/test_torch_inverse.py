"""The port's render/inverse.py on the CPU against the reference's: field
access, the engine/field gate, pack_scene under autograd, the pick of the
backward mode, the FD check, and the training slice as a whole (``invert`` on
the plain engine against the reference's ``invert(engine="jnp")``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from cuda_path_tracer_ss_torch.utils import rng as trng
from torch_port_helpers import port_scene

CP = camera_arrays(Camera())
TRI = sorted(tvjp.TRI_FIELDS)


def test_trainable_fields_are_the_reference_s():
    assert tinverse.TRAINABLE_FIELDS == jinverse.TRAINABLE_FIELDS
    assert tinverse.pallas_trainable_linear() == jinverse.pallas_trainable_linear()
    # the reference's full set plus the triangle fields is its widest set
    assert tinverse.pallas_trainable() | tvjp.TRI_FIELDS == jinverse.pallas_trainable()


# ---- field get / set / merge ---------------------------------------------------

@pytest.mark.parametrize("name", jinverse.TRAINABLE_FIELDS)
def test_field_round_trip_matches_jax(name):
    jscene = jpresets.textured()          # has spheres, lights and textures
    scene = port_scene(jscene)
    want = np.asarray(jinverse.get_field(jscene, name))
    got = tinverse.get_field(scene, name)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    new = (want + np.random.default_rng(3).standard_normal(want.shape)).astype(np.float32)
    jscene2 = jinverse.with_field(jscene, name, jnp.asarray(new))
    scene2 = tinverse.with_field(scene, name, new)
    np.testing.assert_array_equal(tinverse.get_field(scene2, name).numpy(),
                                  np.asarray(jinverse.get_field(jscene2, name)))
    # nothing else moved, and the source scene is untouched
    other = next(n for n in jinverse.TRAINABLE_FIELDS if n != name)
    np.testing.assert_array_equal(tinverse.get_field(scene2, other).numpy(),
                                  np.asarray(jinverse.get_field(jscene2, other)))
    np.testing.assert_array_equal(tinverse.get_field(scene, name).numpy(), want)


def test_extract_and_merge_params_match_jax():
    jscene = jpresets.point_light_spheres()
    scene = port_scene(jscene)
    names = ["materials.diffuse", "pl_pos", "sph_radius", "al_power"]
    params = tinverse.extract_params(scene, names)
    jparams = jinverse.extract_params(jscene, names)
    assert list(params) == list(jparams) == names
    moved = {k: v * 0.5 + 0.1 for k, v in params.items()}
    jmoved = {k: v * 0.5 + 0.1 for k, v in jparams.items()}
    merged = tinverse.merge_params(scene, moved)
    jmerged = jinverse.merge_params(jscene, jmoved)
    for k in names:
        np.testing.assert_allclose(tinverse.get_field(merged, k).numpy(),
                                   np.asarray(jinverse.get_field(jmerged, k)), rtol=1e-7)
    assert merged.num_spheres == scene.num_spheres


# ---- the engine / field gate ---------------------------------------------------

@pytest.mark.parametrize("name", jinverse.TRAINABLE_FIELDS)
@pytest.mark.parametrize("engine", ["cuda", "plain"])
def test_check_engine_fields_agrees_with_jax(engine, name):
    """On an untextured scene and the parity estimator the port accepts and
    refuses exactly what the reference's fused engine does."""
    try:
        jinverse.check_engine_fields("pallas", [name])
        accepted = True
    except ValueError:
        accepted = False
    if accepted:
        tinverse.check_engine_fields(engine, [name])
    else:
        with pytest.raises(ValueError, match="no gradient"):
            tinverse.check_engine_fields(engine, [name])
    assert accepted == (name in tvjp.PALLAS_TRAINABLE_FIELDS_FULL)


@pytest.mark.parametrize("name", TRI)
def test_triangle_fields_raise_naming_the_roadmap(name):
    """The triangle fields train in grad mode geo, as in the reference; with
    accel='grid' invert raises the reference's ValueError."""
    jinverse.check_engine_fields("pallas", [name])          # the reference has them
    for engine in ("cuda", "plain"):
        tinverse.check_engine_fields(engine, ["materials.diffuse", name])
        tinverse.check_engine_fields(engine, ["materials.diffuse", name], physical=True)
    loss = tinverse.make_loss(tpresets.cornell(), CP, torch.zeros(8, 8, 3), 8, 8, 1,
                              engine="plain", field_names=["materials.diffuse", name])
    assert loss.grad_mode == "geo"
    with pytest.raises(ValueError, match="geometry fields"):
        tinverse.invert(tpresets.cornell(), CP, torch.zeros(8, 8, 3), [name], 8, 8, steps=1,
                        engine="plain", accel="grid")


def test_spec_avg_raises_and_never_returns_a_silent_zero():
    with pytest.raises(ValueError, match="spec_avg.*physical=True"):
        tinverse.check_engine_fields("cuda", ["materials.spec_avg"])
    with pytest.raises(ValueError, match="spec_avg"):
        tinverse.invert(tpresets.cornell(), CP, torch.zeros(8, 8, 3),
                        ["materials.spec_avg"], 8, 8, steps=1, engine="plain")


@pytest.mark.parametrize("call,item", [
    (lambda s: tinverse.check_engine_fields("cuda", ["al_power"], physical=True),
     "ValueError: no gradient"),
    (lambda s: tinverse.check_engine_fields("lighttrace", ["materials.emission"]),
     "item 8"),
    (lambda s: tinverse.check_engine_fields("bidir", ["materials.emission"]), "item 8"),
    (lambda s: tinverse.check_engine_fields("jnp", ["materials.diffuse"]),
     "ValueError: engine='eager'"),
    (lambda s: tinverse.check_engine_fields(
        "cuda", ["textures", "tri_v0"], scene=port_scene(jpresets.textured())), None),
    (lambda s: _grid_loss_equals_linear(s), None),
    (lambda s: _physical_loss_is_the_physical_render_s(s), None),
    (lambda s: tinverse.make_loss(s, CP, torch.zeros(8, 8, 3), 8, 8, 1,
                                  engine="bidir", physical=True), "item 8"),
    (lambda s: tinverse.invert(s, CP, torch.zeros(8, 8, 3), ["sph_center"], 8, 8,
                               steps=1, engine="plain", silhouette=True), "item 9"),
    (lambda s: _invert_geo_steps(s), None),
], ids=["physical", "lighttrace", "bidir", "eager", "textured", "grid",
        "loss-physical", "loss-bidir", "silhouette", "invert-geo"])
def test_unported_raise_naming_the_roadmap(call, item):
    """What is not ported raises naming the ROADMAP; what the reference
    refuses raises its ValueError; what is ported (item None) runs: triangle
    fields on a textured scene, make_loss(accel='grid') (the linear sweeps'
    loss and gradients), make_loss(physical=True) (the physical render's loss)
    and invert on triangle vertices (the loss falls)."""
    if item is None:
        call(tpresets.cornell())
        return
    if item.startswith("ValueError: "):
        with pytest.raises(ValueError, match=item[len("ValueError: "):]):
            call(tpresets.cornell())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.*" + item):
        call(tpresets.cornell())


def _physical_loss_is_the_physical_render_s(scene):
    target = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(2))
    loss = tinverse.make_loss(scene, CP, target, 8, 8, 1, 3, engine="plain", physical=True)
    img = tmk.render_megakernel_plain(tmk.pack_scene(scene, "cpu"), CP, 4, 8, 8, 1, 3,
                                      physical=True)
    assert loss.grad_mode == "full"
    assert float(loss(tinverse.extract_params(scene, []), 4)) == float(
        torch.mean((img - target) ** 2))


def _invert_geo_steps(scene):
    truth = tinverse.extract_params(scene, ["tri_v0"])["tri_v0"]
    target = tmk.render_megakernel_plain(tmk.pack_scene(scene, "cpu"), CP, 0, 8, 8, 1, 3)
    start = tinverse.with_field(scene, "tri_v0", truth + 0.05)
    _, params, losses = tinverse.invert(start, CP, target, ["tri_v0"], 8, 8, spp=1, steps=3,
                                        lr=0.02, max_bounces=3, engine="plain")
    assert losses[-1] < losses[0] and bool(torch.isfinite(params["tri_v0"]).all())


def _grid_loss_equals_linear(scene):
    target = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(1))
    fields = ["materials.diffuse", "materials.roughness"]
    params = tinverse.extract_params(scene, fields)
    got = [tinverse.value_and_grad(tinverse.make_loss(scene, CP, target, 8, 8, 1, 3,
                                                      engine="plain", accel=accel,
                                                      field_names=fields), params, 2)
           for accel in ("none", "grid")]
    assert float(got[0][0]) == float(got[1][0])
    for k in fields:
        assert torch.equal(got[0][1][k], got[1][1][k]), k


def test_unknown_engine_and_cuda_without_device():
    with pytest.raises(ValueError, match="unknown engine"):
        tinverse.check_engine_fields("pallas", ["materials.diffuse"])
    with pytest.raises(ValueError, match="CUDA device"):
        tinverse.make_loss(tpresets.cornell(), CP, torch.zeros(8, 8, 3), 8, 8, 1,
                           engine="cuda", device="cpu")


def test_default_engine_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        tinverse.make_loss(tpresets.cornell(), CP, torch.zeros(8, 8, 3), 8, 8, 1)


# ---- pack_scene under autograd --------------------------------------------------

def test_pack_scene_keeps_the_autograd_graph_and_matches_jax():
    """A scene whose fields require grad yields tables with a graph, and the
    gradient that flows back through pack_scene equals the reference's
    (incl. the area-light vertices gathered from the triangles)."""
    jscene = jpresets.point_light_spheres()
    scene = port_scene(jscene)
    names = ["materials.diffuse", "materials.ior", "materials.roughness",
             "materials.diff_avg", "sph_center", "sph_radius", "pl_pos", "pl_power",
             "al_power", "tri_v0", "tri_v1", "tri_v2", "tri_n1", "background"]
    g = np.random.default_rng(4)
    packed0 = tmk.pack_scene(scene, "cpu")
    cots = [g.standard_normal(tuple(t.shape)).astype(np.float32)
            for t in packed0.tables()]
    assert not any(t.requires_grad for t in packed0.tables())

    def jloss(params):
        p = jmk.pack_scene(jinverse.merge_params(jscene, params))
        tabs = (p.spheres, p.triangles, p.materials, p.point_lights, p.area_lights,
                p.background)
        return sum(jnp.sum(t * c) for t, c in zip(tabs, cots))

    want = jax.device_get(jax.grad(jloss)(jinverse.extract_params(
        jscene, [n for n in names if n != "background"])))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tinverse.extract_params(scene, names).items()}
    packed = tmk.pack_scene(tinverse.merge_params(scene, leaves), "cpu")
    assert all(t.requires_grad for t in packed.tables())
    total = sum((t * torch.from_numpy(c)).sum() for t, c in zip(packed.tables(), cots))
    got = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got["background"].numpy(), cots[5], rtol=1e-6)
    for a, b in zip(packed.tables(), packed0.tables()):
        np.testing.assert_array_equal(a.detach().numpy(), b.numpy())


def test_empty_field_keeps_the_graph_and_gets_an_empty_gradient():
    """cornell has no point light: ``pl_power`` is ``[0, 3]``. Its table is
    padded to one zero row; the field stays in the graph, so a loss over it
    yields an empty gradient (as ``jax.grad`` does) instead of raising."""
    scene = tpresets.cornell()
    assert scene.num_point_lights == 0
    leaf = scene.pl_power.clone().requires_grad_(True)
    packed = tmk.pack_scene(tinverse.with_field(scene, "pl_power", leaf), "cpu")
    assert packed.point_lights.shape == (1, tmk.PL_COLS)
    assert packed.point_lights.requires_grad
    assert not packed.point_lights.detach().any()
    loss = tinverse.make_loss(scene, CP, torch.zeros(8, 8, 3), 8, 8, 1, max_bounces=2,
                              engine="plain", field_names=["pl_power", "al_power"])
    _, grad = tinverse.value_and_grad(
        loss, tinverse.extract_params(scene, ["pl_power", "al_power"]), 0)
    assert grad["pl_power"].shape == (0, 3)
    assert float(grad["al_power"].abs().max()) > 0


# ---- make_loss ------------------------------------------------------------------

@pytest.mark.parametrize("fields,mode", [
    (["materials.diffuse", "al_power"], "linear"),
    (sorted(tvjp.PALLAS_TRAINABLE_FIELDS), "linear"),
    (["materials.diffuse", "materials.roughness"], "full"),
    (["pl_pos"], "full"), (["sph_radius", "background"], "full"), (None, "full")])
def test_make_loss_picks_the_backward_mode(fields, mode):
    loss = tinverse.make_loss(tpresets.cornell(), CP, torch.zeros(8, 8, 3), 8, 8, 1,
                              engine="plain", field_names=fields)
    assert loss.grad_mode == mode


def test_loss_value_matches_jax():
    jscene = jpresets.showcase()
    jcp = jcamera_arrays(JCamera())
    target = np.random.default_rng(6).uniform(0, 1, (10, 10, 3)).astype(np.float32)
    jloss = jinverse.make_loss(jscene, jcp, jnp.asarray(target), 10, 10, 2,
                               max_bounces=3, engine="jnp")
    names = ["materials.diffuse", "materials.emission"]
    want = float(jloss(jinverse.extract_params(jscene, names), jnp.int32(4)))
    scene = port_scene(jscene)
    loss = tinverse.make_loss(scene, CP, target, 10, 10, 2, max_bounces=3,
                              engine="plain", field_names=names)
    got = loss(tinverse.extract_params(scene, names), 4)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_directional_fd_check_agrees():
    """AD against central finite differences on the same streams."""
    scene = tpresets.cornell_lambert()
    loss = tinverse.make_loss(scene, CP, torch.zeros(12, 12, 3), 12, 12, 2,
                              max_bounces=3, engine="plain",
                              field_names=["materials.diffuse", "al_power"])
    params = tinverse.extract_params(scene, ["materials.diffuse", "al_power"])
    ad, fd = tinverse.directional_fd_check(loss, params, 0, eps=2e-3, num_directions=2)
    assert ad.shape == fd.shape == (2,)
    scale = np.maximum(np.abs(fd), np.abs(ad)).max() + 1e-8
    np.testing.assert_allclose(ad, fd, rtol=0.05, atol=0.02 * scale)
    # explicit generator: same directions, same numbers
    gen = torch.Generator().manual_seed(0)
    ad2, _ = tinverse.directional_fd_check(loss, params, 0, eps=2e-3, num_directions=2,
                                           generator=gen)
    np.testing.assert_array_equal(ad, ad2)


# ---- the slice as a whole --------------------------------------------------------

@pytest.mark.parametrize("resample_every", [0, 2])
def test_invert_reproduces_jax_invert(resample_every):
    """5 Adam steps on cornell's diffuse colours, plain engine, fixed seed:
    the losses equal the reference's ``invert(engine="jnp")`` losses to rtol
    1e-4 and the parameters to atol 1e-4 (torch.optim.Adam and optax.adam take
    identical steps; ``resample_every`` derives the same seeds). Each side
    renders its own target from the true scene, as ``cli invert`` does: where
    a start value coincides with the truth the residual is then exactly zero
    on both sides, and Adam — which turns any nonzero gradient, however
    small, into a full-size step — has no rounding noise to amplify."""
    w = h = 12
    spp, bounces, steps, lr, seed = 2, 3, 5, 0.1, 7
    jscene = jpresets.cornell()
    jcp = jcamera_arrays(JCamera())
    target = np.asarray(jrender(jscene, jcp, w, h, spp, jnp.int32(seed),
                                max_bounces=bounces, live_cutoff=None))
    start = np.clip(np.asarray(jinverse.get_field(jscene, "materials.diffuse")) + 0.3,
                    0.05, 1.0).astype(np.float32)
    _, jparams, jlosses = jinverse.invert(
        jinverse.with_field(jscene, "materials.diffuse", jnp.asarray(start)), jcp,
        jnp.asarray(target), ["materials.diffuse"], w, h, spp=spp, steps=steps, lr=lr,
        seed=seed, max_bounces=bounces, resample_every=resample_every, engine="jnp")
    seen = []
    scene0 = tinverse.with_field(port_scene(jscene), "materials.diffuse", start)
    own_target = tmk.render_megakernel_plain(
        tmk.pack_scene(port_scene(jscene), "cpu"), CP, seed, w, h, spp, bounces)
    np.testing.assert_allclose(own_target.numpy(), target, rtol=1e-4, atol=1e-6)
    recovered, params, losses = tinverse.invert(
        scene0, CP, own_target, ["materials.diffuse"], w, h, spp=spp, steps=steps, lr=lr,
        seed=seed, max_bounces=bounces, resample_every=resample_every, engine="plain",
        callback=lambda step, val, p: seen.append((step, val)))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(params["materials.diffuse"].numpy(),
                               np.asarray(jparams["materials.diffuse"]), atol=1e-4)
    assert losses[-1] < losses[0]
    assert [s for s, _ in seen] == list(range(steps)) and seen[-1][1] == losses[-1]
    np.testing.assert_array_equal(recovered.materials.diffuse.numpy(),
                                  params["materials.diffuse"].numpy())
    assert not scene0.materials.diffuse.requires_grad


def test_seed_for_matches_jax():
    from cuda_path_tracer_ss_tpu.utils import rng as jrng
    for base, stream in ((0, 0), (7, 3), (2 ** 31 - 1, 11), (-5, 2)):
        assert trng.seed_for(base, stream) == int(jrng.seed_for(jnp.int32(base), stream))
