"""The port's sharded entries (``parallel/sharding.py`` on the eager engine,
``render_megakernel_sharded``, ``render_megakernel_diff_sharded``,
``render_lighttrace_fast_sharded``, ``render_bidir_sharded`` and
``render_bidir_fast_sharded``) in one world of four gloo ranks on the CPU,
started once for the file (rank bodies: ``tests/torch_dist_worker.py``, no
JAX in the ranks). The parent holds the results against the port's own
single-process calls and against the JAX package at ``tests/test_sharding.py``'s
sizes (16x16, 4 spp, 3 bounces): its pixel-sharded ``shard_map`` render on
``tests/conftest.py``'s 8 virtual devices, its one-device render and its
light tracer; ``-m slow`` adds its sample / 2-D ``shard_map`` renders, its
Pallas sharded entries in interpret mode and its sharded light tracer. On
CPU tables the kernel entries reach the kernels' plain versions."""
import concurrent.futures
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as tlk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.parallel import mesh as pm
from cuda_path_tracer_ss_torch.render import bidir as tbidir
from cuda_path_tracer_ss_torch.render import integrator as tintegrator
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from cuda_path_tracer_ss_torch.render.lighttrace import render_lighttrace
from cuda_path_tracer_ss_tpu.models import presets
from cuda_path_tracer_ss_tpu.models.camera import Camera
from cuda_path_tracer_ss_tpu.parallel import mesh as mesh_lib
from cuda_path_tracer_ss_tpu.parallel import sharding
from cuda_path_tracer_ss_tpu.render import integrator
from torch_port_helpers import assert_per_pixel_parity

W, H, SPP, BOUNCES = worker.W, worker.H, worker.SPP, worker.BOUNCES
RANKS = 4
CP = integrator.camera_arrays(Camera())
KW = dict(max_bounces=BOUNCES, live_cutoff=None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's one-process references on one intra-op thread, as the
    ranks run: the bit-equality below compares sharding, not threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _World:
    """A world of ``RANKS`` ranks running ``scenarios`` in the background
    (the JAX side compiles meanwhile); ``dir`` waits for it."""

    def __init__(self, out, scenarios):
        self._out = out
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._done = self._pool.submit(pm.spawn_world, RANKS, scenarios, out,
                                       device_type="cpu")

    @property
    def dir(self):
        self._done.result()
        self._pool.shutdown()
        return self._out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _World(str(tmp_path_factory.mktemp("sharding_world")), worker.sharding_scenarios)


def _load(world, name):
    return np.load(os.path.join(world.dir, f"{name}.npy"))


def _ranks(world, name):
    return [np.load(os.path.join(world.dir, f"{name}.r{r}.npy")) for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_refs(world):
    """The JAX package's renders, compiled while the world runs: its
    pixel-sharded ``shard_map`` render on 8 virtual devices, its one-device
    render (which its own tests/test_sharding.py holds its sample and 2-D
    renders to) and its light tracer. Its sample and 2-D ``shard_map``
    renders, which psum across the 8 devices, are held in the ``slow``
    tests below."""
    from cuda_path_tracer_ss_tpu.render.lighttrace import render_lighttrace as jax_lt

    return {
        "pixel": sharding.render_pixel_sharded(
            presets.cornell(), CP, W, H, SPP, 0, mesh_lib.make_mesh(8), **KW),
        "single": integrator.render(presets.cornell(), CP, W, H, SPP, 0, **KW),
        "light": jax_lt(presets.cornell_lambert(), CP, W, H, worker.LIGHT_PATHS, 0,
                        max_bounces=BOUNCES)}


@pytest.fixture(scope="module")
def port_single():
    """The port's single-process eager render at the reference's sizes."""
    return tintegrator.render(tpresets.cornell(), worker.cam(), W, H, SPP, 0,
                              device="cpu", **KW).numpy()


def test_eager_pixel_sharded_is_the_single_render_and_holds_against_jax(
        world, jax_refs, port_single):
    ref = np.asarray(jax_refs["pixel"])
    got = _load(world, "eager_pixel")
    np.testing.assert_array_equal(got, port_single)
    np.testing.assert_array_equal(_load(world, "eager_jit_pixel"), port_single)
    assert_per_pixel_parity(got, ref)


def test_eager_pixel_sharded_physical_and_resume(world):
    single = tintegrator.render(tpresets.cornell(), worker.cam(), W, H, SPP, 0,
                                physical=True, device="cpu", **KW).numpy()
    np.testing.assert_array_equal(_load(world, "eager_pixel_physical"), single)
    # samples 2..3 over the mesh + samples 0..1 on one process = one render
    first = tintegrator.render(tpresets.cornell(), worker.cam(), W, H, SPP // 2, 0,
                               device="cpu", **KW).numpy()
    whole = tintegrator.render(tpresets.cornell(), worker.cam(), W, H, SPP, 0,
                               device="cpu", **KW).numpy()
    np.testing.assert_allclose((first + _load(world, "eager_pixel_resume")) / 2, whole,
                               rtol=0, atol=1e-5)


def test_eager_sample_sharded_matches_jax(world, jax_refs, port_single):
    ref = np.asarray(jax_refs["single"])
    got = _load(world, "eager_sample")
    np.testing.assert_allclose(got, port_single, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_eager_2d_sharded_matches_jax(world, jax_refs, port_single):
    ref = np.asarray(jax_refs["single"])
    got = _load(world, "eager_2d")
    np.testing.assert_allclose(got, port_single, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_every_rank_holds_the_same_result(world):
    for name in ("eager_pixel", "eager_sample", "eager_2d", "eager_light", "k1_9x9_default",
                 "k3_plain", "eager_grad_materials.diffuse", "eager_grad_al_power",
                 "k2_9x9_full_grad_materials", "k2_9x9_full_grad_cam_pos"):
        got = _ranks(world, name)
        for other in got[1:]:
            np.testing.assert_array_equal(other, got[0], name)




def test_eager_light_sharded_matches_single_and_jax(world, jax_refs):
    """Against the port's one-process light tracer only the splat-sum order
    differs; against the JAX light tracer the reference's bar for its own
    sharded light tracer (atol 5e-4, 99 % of values within 2e-5)."""
    ref = np.asarray(jax_refs["light"])
    got = _load(world, "eager_light")
    single = render_lighttrace(tpresets.cornell_lambert(), worker.cam(), W, H,
                               worker.LIGHT_PATHS, 0, max_bounces=BOUNCES,
                               device="cpu").numpy()
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    assert (np.abs(got - ref) < 2e-5).mean() > 0.99
    assert ref.max() > 0.01


def test_eager_bidir_sharded_matches_single(world):
    f = worker.FUSED
    single = tbidir.render_bidir(tpresets.caustic(), worker.cam(), f["width"], f["height"],
                                 f["spp"], f["n_paths"], f["seed"],
                                 max_bounces=f["max_bounces"], device="cpu").numpy()
    got = _load(world, "eager_bidir")
    np.testing.assert_allclose(got, single, rtol=2e-5, atol=2e-6 * max(single.max(), 1.0))
    assert single.max() > 0


def _single_grads(scene, fields, render, reg=0.0):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in tinverse.extract_params(scene, fields).items()}
    img = render(tinverse.merge_params(scene, params))
    loss = torch.mean(img ** 2)
    if reg:
        loss = loss + reg * (params["materials.diffuse"] ** 2).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def test_sharded_gradient_counts_the_regulariser_once(world):
    """A sharded loss with a regulariser on materials.diffuse outside the
    render gives the single-process gradient: the render's terms summed over
    the ranks once, the regulariser's not summed at all."""
    loss, grads = _single_grads(
        tpresets.cornell(), ["materials.diffuse", "al_power"],
        lambda s: tintegrator.render(s, worker.cam(), W, H, SPP, 0, device="cpu", **KW),
        reg=worker.REG)
    np.testing.assert_allclose(float(_load(world, "eager_grad_loss")), loss, rtol=1e-6)
    for k, g in grads.items():
        got = _load(world, f"eager_grad_{k}")
        np.testing.assert_allclose(got, g.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)
        assert np.abs(got).max() > 0
    # a regulariser summed over the four ranks would move this far
    assert np.abs(2 * worker.REG * 3 * tpresets.cornell().materials.diffuse.numpy()).max() > 1e-2


def test_bidir_sharded_gradient_matches_single(world):
    f = worker.FUSED
    _, grads = _single_grads(
        tpresets.caustic(), ["materials.emission", "materials.diffuse"],
        lambda s: tbidir.render_bidir(s, worker.cam(), f["width"], f["height"], f["spp"],
                                      f["n_paths"], f["seed"], max_bounces=f["max_bounces"],
                                      device="cpu"))
    for k, g in grads.items():
        got = _load(world, f"eager_bidir_grad_{k}")
        np.testing.assert_allclose(got, g.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)
    assert np.abs(_load(world, "eager_bidir_grad_materials.emission")).max() > 0


@pytest.mark.parametrize("size", worker.K_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("est", ["default", "physical"])
def test_megakernel_sharded_is_bit_equal(world, size, est):
    w, h = size
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    single = tmk.render_megakernel(packed, worker.cam(), 3, w, h, SPP, max_bounces=BOUNCES,
                                   physical=est == "physical")
    np.testing.assert_array_equal(_load(world, f"k1_{w}x{h}_{est}"), single.numpy())


@pytest.mark.parametrize("mode", worker.K2_MODES)
@pytest.mark.parametrize("size", worker.K_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_megakernel_diff_sharded_matches_single(world, size, mode):
    """Images bit-equal, gradients (materials; the camera position in full
    mode, the triangle table in geo mode; a regulariser outside the render)
    within rtol 1e-4 / atol 1e-7 of ``render_megakernel_diff`` in one
    process."""
    w, h = size
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    leaves = worker.k2_leaves(packed, mode)
    p, cp = worker.k2_inputs(packed, leaves)
    img = tvjp.render_megakernel_diff(p, cp, 7, w, h, SPP, max_bounces=BOUNCES,
                                      **worker.K2_KW[mode])
    loss = torch.mean(img ** 2) + worker.REG * (leaves["materials"] ** 2).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_array_equal(_load(world, f"k2_{w}x{h}_{mode}_img"),
                                  img.detach().numpy())
    for k, g in zip(leaves, grads):
        got = _load(world, f"k2_{w}x{h}_{mode}_grad_{k}")
        np.testing.assert_allclose(got, g.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)
        assert np.abs(got).max() > 0, k


@pytest.mark.parametrize("label,nu", [("plain", None), ("bidir", 4.0)])
def test_lighttrace_fast_sharded_matches_single(world, label, nu):
    f = worker.FUSED
    single = tlk.render_lighttrace_fast(tmk.pack_scene(tpresets.caustic(), "cpu"),
                                        worker.cam(), f["seed"], f["width"], f["height"],
                                        f["n_paths"], max_bounces=f["max_bounces"],
                                        bidir_nu=nu).numpy()
    np.testing.assert_allclose(_load(world, f"k3_{label}"), single, rtol=2e-5,
                               atol=2e-6 * max(single.max(), 1.0))
    assert single.max() > 0


def test_bidir_fast_sharded_matches_single(world):
    f = worker.FUSED
    single = tbidir.render_bidir_fast(tmk.pack_scene(tpresets.caustic(), "cpu"),
                                      worker.cam(), f["width"], f["height"], f["spp"],
                                      f["n_paths"], f["seed"],
                                      max_bounces=f["max_bounces"]).numpy()
    np.testing.assert_allclose(_load(world, "bidir_fast"), single, rtol=2e-5,
                               atol=2e-6 * max(single.max(), 1.0))


@pytest.mark.parametrize("case,match", [
    ("pixel_not_divisible", "not divisible"),
    ("sample_on_pixel_mesh", "needs a mesh with a 'samples' axis"),
    ("sample_spp_not_divisible", "not divisible"),
    ("2d_on_pixel_mesh", "'samples' axis"),
    ("light_on_pixel_mesh", "'paths' axis"),
    ("light_without_area_light", "needs at least one area light"),
    ("light_paths_not_divisible", "not divisible"),
    ("k1_on_path_mesh", "'pixels' axis"),
    ("k1_pixels_too_few", "too many devices"),
    ("k2_mesh_none", "needs a DeviceMesh"),
    ("k2_unknown_grad_mode", "grad_mode"),
    ("k3_on_pixel_mesh", "'paths' axis"),
    ("k3_without_area_light", "needs at least one area light"),
    ("k3_textured", "no texture block"),
    ("bidir_fast_without_area_light", "needs an area light"),
    ("bidir_without_area_light", "needs an area light"),
])
def test_sharded_entries_raise(world, case, match):
    for rank in range(RANKS):
        with open(os.path.join(world.dir, f"errors.r{rank}.json")) as f:
            kind, msg = json.load(f)[case]
        assert kind == "ValueError" and match in msg, (rank, kind, msg)


@pytest.mark.slow
def test_dryrun_steps_print_every_line(slow_world):
    """``parallel/dryrun.py``'s steps in four ranks: every step of the
    reference's certification run prints its line."""
    with open(os.path.join(slow_world.dir, "dryrun.txt")) as f:
        lines = f.read().splitlines()
    want = ["one sharded train step OK", "physical-mode sharded grad step OK",
            "sample-sharded grad step OK", "2-D mesh (2x2 pixels x samples) grad step OK",
            "light-trace sharded grad step OK", "sharded bidirectional render OK",
            "bidirectional sharded grad step OK",
            "checkpoint/resume across mesh reshape OK",
            "fused-engine sharded grad step OK at 128x32, 4 devices, 4 bounces",
            "fused-engine PHYSICAL sharded grad step OK",
            "NORMAL-mapped fused sharded grad step OK", "FUSED sharded bidirectional render OK"]
    assert len(lines) == len(want), lines
    for line, w in zip(lines, want):
        assert line.startswith("dryrun_multichip(4): " + w), line


# ---- the reference's slow sharded tests, against its Pallas kernels ------------

@pytest.fixture(scope="module")
def slow_world(tmp_path_factory):
    return _World(str(tmp_path_factory.mktemp("sharding_slow_world")), worker.slow_scenarios)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["sample", "2d"])
def test_eager_sample_and_2d_sharded_match_jax_shard_map(world, kind):
    """tests/test_sharding.py's sample- and 2-D-sharded ``shard_map`` renders
    on 8 virtual devices, against the port's four ranks."""
    if kind == "sample":
        ref = sharding.render_sample_sharded(
            presets.cornell(), CP, W, H, SPP, 0,
            mesh_lib.make_mesh(4, axis=mesh_lib.SAMPLE_AXIS), **KW)
    else:
        ref = sharding.render_2d_sharded(
            presets.cornell(), CP, W, H, SPP, 0,
            mesh_lib.make_mesh_2d(n_pixel=4, n_sample=2), **KW)
    np.testing.assert_allclose(_load(world, f"eager_{kind}"), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_megakernel_sharded_covers_indivisible_images_like_pallas(slow_world):
    from cuda_path_tracer_ss_tpu.ops.pallas.megakernel import pack_scene, render_megakernel

    ref = np.asarray(render_megakernel(pack_scene(presets.cornell_empty()), CP, 3, 257, 1, 1,
                                       max_bounces=2, block_rows=1, interpret=True))
    assert_per_pixel_parity(_load(slow_world, "k1_257x1"), ref)


@pytest.mark.slow
def test_megakernel_diff_sharded_matches_pallas_sharded(slow_world):
    """tests/test_sharding.py::test_megakernel_diff_sharded_trains_multi_device:
    the JAX package's sharded Pallas render on a 2-device mesh."""
    import jax

    from cuda_path_tracer_ss_tpu.ops.pallas.megakernel import PackedScene, pack_scene
    from cuda_path_tracer_ss_tpu.ops.pallas.megakernel_vjp import (
        render_megakernel_diff_sharded)

    packed = pack_scene(presets.cornell())
    mesh = mesh_lib.make_mesh(2)

    def loss(mats):
        p = PackedScene(packed.spheres, packed.triangles, mats, packed.point_lights,
                        packed.area_lights, packed.background, packed.counts)
        img = render_megakernel_diff_sharded(p, CP, 7, W, H, 2, mesh, max_bounces=3,
                                             block_rows=1, interpret=True)
        return jnp.mean(img ** 2), img

    (val, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(packed.materials)
    assert_per_pixel_parity(_load(slow_world, "k2_ref_img"), np.asarray(img))
    np.testing.assert_allclose(float(_load(slow_world, "k2_ref_loss")), float(val), rtol=1e-3)
    a, b = np.asarray(g), _load(slow_world, "k2_ref_grad")
    # the port's material table is [M, 20] like the reference's; compare the
    # columns both differentiate (the reference's tests/test_pallas_vjp.py bar)
    np.testing.assert_allclose(b[:, :12], a[:, :12], rtol=1e-3,
                               atol=1e-4 * np.abs(a[:, :12]).max())


@pytest.mark.slow
def test_lighttrace_sharded_matches_jax_sharded(slow_world):
    ref = np.asarray(sharding.render_lighttrace_sharded(
        presets.cornell_lambert(), CP, W, H, worker.LIGHT_PATHS, 0,
        mesh_lib.make_mesh(8, axis=mesh_lib.PATH_AXIS), max_bounces=BOUNCES))
    got = _load(slow_world, "light_ref")
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    assert (np.abs(got - ref) < 2e-5).mean() > 0.99


@pytest.mark.slow
def test_fused_bidir_sharded_matches_pallas_sharded(world):
    """tests/test_sharding.py::test_fused_bidir_sharded_matches_single_device's
    Pallas sharded entries against the port's."""
    from cuda_path_tracer_ss_tpu.ops.pallas.lightkernel import render_lighttrace_fast_sharded
    from cuda_path_tracer_ss_tpu.ops.pallas.megakernel import pack_scene
    from cuda_path_tracer_ss_tpu.render.bidir import render_bidir_fast_sharded

    f = worker.FUSED
    packed = pack_scene(presets.caustic())
    mesh_paths = mesh_lib.make_mesh(2, axis=mesh_lib.PATH_AXIS)
    lt = np.asarray(render_lighttrace_fast_sharded(
        packed, CP, f["seed"], f["width"], f["height"], f["n_paths"], mesh_paths,
        max_bounces=f["max_bounces"], block_rows=1, interpret=True))
    got = _load(world, "k3_plain")
    np.testing.assert_allclose(got, lt, rtol=0, atol=5e-4)
    assert (np.abs(got - lt) < 2e-5).mean() > 0.99
    bi = np.asarray(render_bidir_fast_sharded(
        packed, CP, f["width"], f["height"], f["spp"], f["n_paths"], f["seed"],
        mesh_lib.make_mesh(2), mesh_paths, max_bounces=f["max_bounces"], interpret=True,
        block_rows=1))
    assert_per_pixel_parity(_load(world, "bidir_fast"), bi)
