"""The backward CUDA kernel's own math — csrc/megakernel_vjp.cuh compiled by
the host C++ compiler (no FMA contraction; torch_port_helpers.py, needs g++) —
against the plain PyTorch version on the cases of tests/test_pallas_vjp.py and
against the reference's oracle (jax.value_and_grad over the jnp engine), at
that file's tolerances: loss rtol 1e-5; every gradient rtol 1e-3, atol
1e-4 * max|g|. The CUDA kernel itself runs only on a GPU and is held against
the plain version there by chip_smoke.py; its wrapper's rules are tested here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel_vjp as jvjp
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.ops.grid import build_grid
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from torch_port_helpers import (VJP_BOUNCES, VJP_H, VJP_SEED, VJP_SPP, VJP_W,
                                assert_grads_close, jax_preset_value_and_grad,
                                norm3_vjp_hostbuild, port_scene,
                                port_value_and_grad, render_diff_hostbuild,
                                rot_y_to_vjp_hostbuild)

CP = camera_arrays(Camera())


def _scene_fields(scene, grad_mode):
    names = (tvjp.PALLAS_TRAINABLE_FIELDS_FULL if grad_mode == "full"
             else tvjp.PALLAS_TRAINABLE_FIELDS)
    have = {"al_power": scene.num_area_lights, "pl_power": scene.num_point_lights,
            "pl_pos": scene.num_point_lights, "sph_center": scene.num_spheres,
            "sph_radius": scene.num_spheres}
    return sorted(n for n in names if have.get(n, 1))


# ---- the whole kernel: host build vs plain version, every trainable field -----

@pytest.mark.parametrize("name,grad_mode,size", [
    ("cornell", "linear", 12), ("cornell", "full", 12), ("showcase", "full", 12),
    ("point_lights", "full", 12), ("point_lights", "linear", 12),
    ("glass", "full", 16), ("stress", "full", 24), ("stress_dense", "full", 16)])
def test_kernel_math_matches_plain(name, grad_mode, size):
    """``stress`` and ``glass`` send paths through glass: inside
    hits, Beer-Lambert, refraction, and the unnormalised mirror direction of
    an inside reflection. ``stress_dense`` (300 overlapping spheres) hits
    mirrors, whose ior is infinite, from inside: the refraction formulas give
    NaN on those lanes, which are dropped and must leave the gradients
    finite."""
    scene = (tpresets.stress_dense(300) if name == "stress_dense"
             else tpresets.get_scene(name))
    fields = _scene_fields(scene, grad_mode)
    args = (scene, CP, fields, size, size, VJP_SPP, VJP_BOUNCES, VJP_SEED)
    v_p, g_p = port_value_and_grad(*args, "plain", grad_mode)
    v_h, g_h = port_value_and_grad(*args, "host", grad_mode)
    np.testing.assert_allclose(v_h, v_p, rtol=1e-5)
    assert_grads_close(g_h, g_p, fields)
    assert any(np.abs(g_p[k]).max() > 0 for k in fields)


@pytest.mark.parametrize("grad_mode", ["linear", "full"])
def test_kernel_math_matches_jax_autodiff(grad_mode):
    jscene, fields, v_jax, g_jax = jax_preset_value_and_grad("cornell", grad_mode)
    v, g = port_value_and_grad(port_scene(jscene), CP, fields, VJP_W, VJP_H,
                               VJP_SPP, VJP_BOUNCES, VJP_SEED, "host", grad_mode)
    np.testing.assert_allclose(v, v_jax, rtol=1e-5)
    assert_grads_close(g, g_jax, fields)


def test_kernel_math_camera_gradients_match_plain():
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    grads = []
    for render in (render_diff_hostbuild, tvjp.render_megakernel_diff_plain):
        cam = [torch.tensor(np.asarray(v, np.float32), requires_grad=True) for v in CP]
        img = render(packed, cam, 5, 8, 8, 1, max_bounces=3)
        grads.append(torch.autograd.grad(torch.mean(img ** 2), cam))
    names = ("rot", "pos", "tan_half")
    assert_grads_close(dict(zip(names, (g.numpy() for g in grads[0]))),
                       dict(zip(names, (g.numpy() for g in grads[1]))), names)
    assert float(grads[0][3]) == 0.0               # z_near: structurally zero
    assert all(float(g.abs().max()) > 0 for g in grads[1][:3])


def test_kernel_math_spec_exp_gradient_matches_plain():
    scene = tpresets.cornell()
    exp0 = scene.materials.spec_exp
    scene = tinverse.with_field(scene, "materials.spec_exp",
                                torch.where(torch.isinf(exp0), 40.0, exp0))
    fields = ["materials.spec_exp"]
    _, g_p = port_value_and_grad(scene, CP, fields, 8, 8, 2, 3, 5, "plain", "full")
    _, g_h = port_value_and_grad(scene, CP, fields, 8, 8, 2, 3, 5, "host", "full")
    assert np.abs(g_p["materials.spec_exp"]).max() > 1e-12
    assert_grads_close(g_h, g_p, fields)


def test_linear_mode_leaves_full_only_rows_at_zero():
    """grad_mode decides which backward runs, not what requires grad: in
    linear mode roughness / ior / spec_exp, positions, spheres and the camera
    receive exact zeros."""
    scene = tpresets.point_light_spheres()
    packed = tmk.pack_scene(scene, "cpu")
    tables = [t.clone().requires_grad_(True) for t in packed.tables()]
    cam = [torch.tensor(np.asarray(v, np.float32), requires_grad=True) for v in CP]
    img = render_diff_hostbuild(tmk.PackedScene(*tables, packed.counts), cam, 5,
                                8, 8, 2, max_bounces=3, grad_mode="linear")
    g = torch.autograd.grad(torch.mean(img ** 2), tables + cam)
    assert float(g[0].abs().max()) == 0.0 and float(g[1].abs().max()) == 0.0
    assert float(g[2][:, [12, 13, 15, 16, 17, 18, 19]].abs().max()) == 0.0
    assert float(g[3][:, 0:3].abs().max()) == 0.0
    assert all(float(c.abs().max()) == 0.0 for c in g[6:])
    assert float(g[2][:, 0:3].abs().max()) > 0 and float(g[3][:, 3:6].abs().max()) > 0


@pytest.mark.parametrize("grad_mode,physical", [("linear", False), ("full", False),
                                               ("geo", False), ("full", True)])
def test_kernel_math_on_tiles_sums_to_the_image(grad_mode, physical):
    """A rank of ``render_megakernel_diff_sharded``: ``_RenderDiff`` over a
    tile of pixels (the kernels' math from the host build) renders that
    slice of the image bit for bit, and the tiles' gradients (81 pixels in
    tiles of 21, 21, 21, 18) sum to the image's."""
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    mats = packed.materials.detach().clone().requires_grad_(True)
    p = dataclasses.replace(packed, materials=mats)
    kw = dict(max_bounces=3, grad_mode=grad_mode, physical=physical)
    img = render_diff_hostbuild(p, CP, 5, 9, 9, 2, **kw)
    want, = torch.autograd.grad(torch.mean(img ** 2), mats)
    g_img = (2 * img / img.numel()).detach().reshape(-1, 3)
    got = torch.zeros_like(want)
    for first, n_local in ((0, 21), (21, 21), (42, 21), (63, 18)):
        tile = render_diff_hostbuild(p, CP, 5, 9, 9, 2, pixel_offset=first,
                                     n_local=n_local, **kw)
        torch.testing.assert_close(tile.detach(), img.detach().reshape(-1, 3)[first:first + n_local],
                                   rtol=0, atol=0)
        got += torch.autograd.grad(tile, mats, g_img[first:first + n_local])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-7)
    assert float(want.abs().max()) > 0


# ---- function by function, against jax.vjp of the reference's helpers ---------
# rtol 1e-5 / atol 1e-6: the same float32 formulas on both sides; what differs
# is 1/sqrt against the reference's rsqrt and the order of a few additions.

def _rand3(g, n, scale=1.0):
    return [(g.standard_normal(n) * scale).astype(np.float32) for _ in range(3)]


def test_norm3_vjp_matches_jax():
    g = np.random.default_rng(21)
    v, cot = _rand3(g, 3000, 3.0), _rand3(g, 3000)
    for k in range(3):
        v[k][:4] = 1e-8                      # the eps clamp is live
    for eps in (1e-20, 1e-12):
        _, pull = jax.vjp(lambda x, y, z: jmk._normalize3(x, y, z, eps), *v)
        want = np.stack([np.asarray(a) for a in pull(tuple(cot))])
        got = norm3_vjp_hostbuild(v, cot, eps)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        want_k2 = jvjp._norm3_vjp(*v, *cot, eps)[0]
        np.testing.assert_allclose(got, np.stack([np.asarray(a) for a in want_k2]),
                                   rtol=1e-5, atol=1e-6)


def test_rot_y_to_vjp_matches_jax():
    g = np.random.default_rng(22)
    t, s, cot = _rand3(g, 3000), _rand3(g, 3000), _rand3(g, 3000)
    norm = np.sqrt(sum(c * c for c in t))
    t = [c / norm for c in t]
    t[0][:5] = 0.0; t[1][:5] = -1.0; t[2][:5] = 0.0          # target = (0, -1, 0)
    t[0][5:10] = 1e-4; t[1][5:10] = -1.0; t[2][5:10] = 2e-4  # ... and nearly so
    _, pull = jax.vjp(jmk._rotate_y_to, *t, *s)
    want = [np.asarray(a) for a in pull(tuple(cot))]
    a_t, a_s = rot_y_to_vjp_hostbuild(t, s, cot)
    # near the antipode the quaternion's norm is ~1e-4: its adjoint amplifies
    # rounding by 1/norm^2; scale the absolute tolerance with the result there
    scale = max(1.0, float(np.abs(np.stack(want[:3])[:, 5:10]).max()))
    np.testing.assert_allclose(a_t[:, 10:], np.stack(want[:3])[:, 10:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a_t[:, :10], np.stack(want[:3])[:, :10], rtol=1e-3,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(a_s, np.stack(want[3:]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a_t[:, :5], 0.0)
    np.testing.assert_array_equal(a_s[:, :5], np.stack([cot[0], -cot[1], -cot[2]])[:, :5])


# ---- layout, device rule, refusals --------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "showcase", "point_lights"])
def test_grad_rows_match_the_reference_layout(name):
    counts = tmk.pack_scene(tpresets.get_scene(name), "cpu").counts
    for full in (False, True):
        assert tvjp._grad_rows(counts, full) == jvjp._grad_rows(counts, full)
    assert tvjp.PALLAS_TRAINABLE_FIELDS == jvjp.PALLAS_TRAINABLE_FIELDS
    assert tvjp.PALLAS_TRAINABLE_FIELDS_FULL == jvjp.PALLAS_TRAINABLE_FIELDS_FULL
    assert tvjp.TRI_FIELDS == jvjp.TRI_FIELDS


def test_cpu_tables_take_the_plain_version_and_the_cuda_wrapper_refuses_them():
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    a = tvjp.render_megakernel_diff(packed, CP, 3, 8, 8, 1, max_bounces=2)
    b = tvjp.render_megakernel_diff_plain(packed, CP, 3, 8, 8, 1, max_bounces=2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    before = tvjp.LAUNCH_COUNT
    with pytest.raises(ValueError, match="CUDA device"):
        tvjp.backward_rows_cuda(packed, CP, 3, 8, 8, 1, 2, torch.zeros(8, 8, 3))
    assert tvjp.LAUNCH_COUNT == before


@pytest.mark.parametrize("kwargs,item", [
    (dict(grad_mode="geo"), "K2 geo"), (dict(physical=True), "K2 physical"),
    (dict(packed_grid="grid"), "K2 grid")])
@pytest.mark.parametrize("entry", ["render_megakernel_diff",
                                   "render_megakernel_diff_plain"])
def test_unported_modes_raise(entry, kwargs, item):
    """Every grad mode runs: geo and physical give, through either entry (CPU
    tables take the plain version), the loss and gradients of the host build
    of the CUDA kernels' math; the grid renders the linear image and gives
    the linear gradients (the same hits, so bit for bit on the plain
    engine)."""
    scene = tpresets.cornell()
    packed = tmk.pack_scene(scene, "cpu")
    if "packed_grid" not in kwargs:
        fields = ["materials.diffuse", "tri_v0"] if item == "K2 geo" else [
            "materials.diffuse", "materials.spec_avg"]
        mode = kwargs.get("grad_mode", "full")
        physical = kwargs.get("physical", False)
        got = {}
        for engine, render in (("entry", getattr(tvjp, entry)),
                               ("host", render_diff_hostbuild)):
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in tinverse.extract_params(scene, fields).items()}
            pk = tmk.pack_scene(tinverse.merge_params(scene, leaves), "cpu")
            img = render(pk, CP, 0, 8, 8, 1, max_bounces=3, grad_mode=mode,
                         physical=physical)
            val = (img ** 2).mean()
            got[engine] = (float(val.detach()), dict(zip(fields, (
                g.numpy() for g in torch.autograd.grad(val, list(leaves.values()))))))
        np.testing.assert_allclose(got["entry"][0], got["host"][0], rtol=1e-5)
        assert_grads_close(got["host"][1], got["entry"][1], fields)
        assert all(np.abs(g).max() > 0 for g in got["entry"][1].values())
        return
    grid = tmk.pack_grid(build_grid(scene), "cpu")
    out = []
    for g in (None, grid):
        diffuse = packed.materials.detach().clone().requires_grad_(True)
        img = getattr(tvjp, entry)(dataclasses.replace(packed, materials=diffuse), CP, 0,
                                   8, 8, 1, max_bounces=3, packed_grid=g)
        out.append((img.detach(), torch.autograd.grad((img ** 2).mean(), diffuse)[0]))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and float(out[0][1].abs().max()) > 0


def test_unknown_grad_mode_and_sharded_entry_raise():
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    with pytest.raises(ValueError, match="grad_mode"):
        tvjp.render_megakernel_diff(packed, CP, 0, 8, 8, 1, grad_mode="all")
    with pytest.raises(ValueError, match="grad_mode"):
        tvjp.render_megakernel_diff_sharded(packed, CP, 0, 8, 8, 1, mesh=None,
                                            grad_mode="all")
    # ported (tests/test_torch_sharding.py runs it over four ranks): no
    # mesh is a ValueError naming the mesh
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        tvjp.render_megakernel_diff_sharded(packed, CP, 0, 8, 8, 1, mesh=None)
