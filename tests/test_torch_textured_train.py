"""Textured training in the port on the CPU: the plain engine's autograd
against ``jax.grad`` of the JAX package's jnp engine, the host-compiler build
of the backward kernel's textured replay (csrc/megakernel_vjp.cuh through
torch_port_helpers.py; needs g++) against the plain engine's autograd, in grad
modes linear and full, on color-mapped and normal-mapped quads and spheres and
the ``textured`` preset; the gates, the checkpoint layout and the training
commands. The CUDA kernel itself runs only on a GPU and is held against the
plain engine there by chip_smoke.py.

Tolerances: against the jnp engine those of tests/test_texture.py (rtol 5e-4,
atol 2e-6 of the largest gradient: the same estimator on the same streams,
another engine's float order); kernel math against the plain engine those of
tests/test_pallas_vjp.py (rtol 1e-3, atol 1e-4 of the largest gradient).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel_vjp as jvjp
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_torch.cli import main
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from torch_port_helpers import (assert_grads_close, jax_textured_quad, jax_value_and_grad,
                                port_scene, port_value_and_grad, render_diff_hostbuild)

CP = camera_arrays(Camera())
W = H = 12
SPP, BOUNCES, SEED = 2, 2, 0

SCENES = {
    "color quad": lambda: jax_textured_quad(),
    "color sphere": lambda: jax_textured_quad(sphere=True),
    "normal quad": lambda: jax_textured_quad(nmap=True),
    "normal sphere": lambda: jax_textured_quad(nmap=True, sphere=True),
    "textured": jpresets.textured,
}

# (scene, fields, grad mode): the cases of tests/test_texture.py and more
CASES = [
    ("color quad", ["textures", "materials.diffuse", "pl_power"], "linear"),
    ("color quad", ["textures", "materials.roughness", "pl_pos"], "full"),
    ("color sphere", ["sph_center", "sph_radius", "textures"], "full"),
    ("normal quad", ["textures", "materials.diffuse", "pl_pos"], "full"),
]
# more scenes, the same without the texels (texel gradients off), the preset
CASES_KERNEL = CASES + [
    ("normal sphere", ["sph_center", "sph_radius", "textures"], "full"),
    ("color quad", ["materials.diffuse", "pl_power"], "linear"),
    ("color sphere", ["sph_center", "sph_radius", "materials.diffuse"], "full"),
    ("normal quad", ["materials.diffuse", "pl_power"], "linear"),
    ("normal quad", ["materials.diffuse", "pl_pos"], "full"),
    ("textured", ["textures", "materials.diffuse"], "full"),
    ("textured", ["textures", "materials.diffuse"], "linear-color-only"),
]


def _ids(cases):
    return [f"{s}-{m}-{'tex' if 'textures' in f else 'notex'}" for s, f, m in cases]


@pytest.mark.parametrize("name,fields,mode", CASES, ids=_ids(CASES))
def test_plain_autograd_matches_jax_grad(name, fields, mode):
    jscene = SCENES[name]()
    v_j, g_j = jax_value_and_grad(jscene, fields, W, H, SPP, BOUNCES, SEED)
    v_p, g_p = port_value_and_grad(port_scene(jscene), CP, fields, W, H, SPP, BOUNCES,
                                   SEED, "plain", mode)
    np.testing.assert_allclose(v_p, v_j, rtol=1e-5)
    for k in fields:
        a = g_j[k]
        np.testing.assert_allclose(g_p[k], a, rtol=5e-4, atol=2e-6 * (np.abs(a).max() + 1e-12),
                                   err_msg=k)
    assert np.abs(g_j[fields[0]]).max() > 1e-7


@pytest.mark.parametrize("name,fields,mode", CASES_KERNEL, ids=_ids(CASES_KERNEL))
def test_kernel_math_matches_plain_autograd(name, fields, mode):
    """The backward kernel's textured replay and reverse sweep (texel rows,
    the albedo split, the UV swim, the perturbation pullback), built for the
    host and run through the package's own autograd Function."""
    scene = port_scene(SCENES[name]())
    if mode == "linear-color-only":
        # the preset in linear mode: the normal-mapped panel's material keeps
        # its map id, its texels are left out of the trained atlas
        scene = scene.replace(materials=dataclasses.replace(
            scene.materials, nmap_id=torch.full_like(scene.materials.nmap_id, -1)))
        mode = "linear"
    v_p, g_p = port_value_and_grad(scene, CP, fields, W, H, SPP, BOUNCES, SEED, "plain",
                                   mode)
    v_h, g_h = port_value_and_grad(scene, CP, fields, W, H, SPP, BOUNCES, SEED, "host",
                                   mode)
    np.testing.assert_allclose(v_h, v_p, rtol=1e-6)
    assert_grads_close(g_h, g_p, fields)
    if "textures" in fields:
        assert np.abs(g_p["textures"]).max() > 1e-7


def test_linear_and_full_texel_gradients_agree_on_a_color_map():
    """A color map's texels are throughput-linear: the lean backward gives
    the full path adjoint's texel gradients."""
    scene = port_scene(SCENES["color quad"]())
    fields = ["textures", "materials.diffuse"]
    _, g_lin = port_value_and_grad(scene, CP, fields, W, H, SPP, BOUNCES, SEED, "host",
                                   "linear")
    _, g_full = port_value_and_grad(scene, CP, fields, W, H, SPP, BOUNCES, SEED, "host",
                                    "full")
    assert_grads_close(g_lin, g_full, fields)


# ---- gates -----------------------------------------------------------------------

def _packed_with_trained_atlas(name):
    scene = port_scene(SCENES[name]())
    tex = scene.textures.clone().requires_grad_(True)
    return tmk.pack_scene(scene.replace(textures=tex), "cpu")


@pytest.mark.parametrize("entry", ["render_megakernel_diff", "render_megakernel_diff_plain",
                                   "host"])
def test_linear_mode_refuses_normal_map_texels(entry):
    """The reference returns zero normal-map texel gradients in linear mode
    (ADVICE.md:3); the port raises instead, in both engines."""
    packed = _packed_with_trained_atlas("normal quad")
    render = (render_diff_hostbuild if entry == "host" else getattr(tvjp, entry))
    with pytest.raises(ValueError, match="normal map"):
        render(packed, CP, 0, 8, 8, 1, max_bounces=2, grad_mode="linear")
    # full mode takes it; linear mode takes the scene when the texels are not trained
    render(packed, CP, 0, 8, 8, 1, max_bounces=2, grad_mode="full")
    render(tmk.pack_scene(port_scene(SCENES["normal quad"]()), "cpu"), CP, 0, 8, 8, 1,
           max_bounces=2, grad_mode="linear")


def test_texel_gradients_follow_the_atlas():
    """The texel rows are computed exactly when the atlas requires grad (and
    autograd records): a loss without 'textures' pays for no texel scatter."""
    trained = _packed_with_trained_atlas("color quad")
    fixed = tmk.pack_scene(port_scene(SCENES["color quad"]()), "cpu")
    assert tvjp._tex_grads(trained, full=False) and not tvjp._tex_grads(fixed, full=True)
    with torch.no_grad():
        assert not tvjp._tex_grads(trained, full=True)
    assert tvjp._st_planes(False, True, True) > tvjp._st_planes(False, True, False)


@pytest.mark.parametrize("call,error,match", [
    (lambda s: tinverse.check_engine_fields("cuda", ["textures", "tri_v0"], scene=s),
     None, None),
    (lambda s: tinverse.check_engine_fields("cuda", ["textures", "materials.spec_avg"],
                                            physical=True, scene=s), None, None),
    (lambda s: _geo_entry_runs(s), None, None),
    (lambda s: tinverse.check_engine_fields("plain", ["textures", "materials.spec_avg"],
                                            scene=s), ValueError, "spec_avg"),
    (lambda s: tinverse.check_engine_fields("cuda", ["textures", "tex_hw"], scene=s),
     ValueError, "no gradient"),
], ids=["geo", "physical", "geo-entry", "spec_avg", "unknown"])
def test_textured_refusals(call, error, match):
    """On a textured scene the triangle fields (geo) and the physical
    estimator's fields train, as in the reference; what it refuses raises
    its ValueError."""
    if error is None:
        call(tpresets.get_scene("textured"))
        return
    with pytest.raises(error, match=match):
        call(tpresets.get_scene("textured"))


def _geo_entry_runs(scene):
    """render_megakernel_diff(grad_mode='geo') on the textured preset: the
    triangle gradients reach the vertices, the texels theirs."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tinverse.extract_params(scene, ["tri_v0", "textures"]).items()}
    packed = tmk.pack_scene(tinverse.merge_params(scene, leaves), "cpu")
    img = tvjp.render_megakernel_diff(packed, CP, 0, 8, 8, 1, max_bounces=2, grad_mode="geo")
    grads = torch.autograd.grad((img ** 2).mean(), list(leaves.values()))
    assert img.shape == (8, 8, 3) and all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0].abs().max()) > 0


def test_textured_field_sets_are_the_reference_s():
    """What the reference's fused engine trains on a textured scene, with
    either estimator, the triangle fields included."""
    scene = tpresets.get_scene("textured")
    for physical in (False, True):
        for name in jinverse.TRAINABLE_FIELDS + tuple(sorted(tvjp.TRI_FIELDS)):
            try:
                jinverse.check_engine_fields("pallas", [name], physical=physical,
                                             scene=jpresets.textured())
                accepted = True
            except ValueError:
                accepted = False
            if accepted:
                tinverse.check_engine_fields("cuda", [name], physical=physical, scene=scene)
            else:
                with pytest.raises(ValueError):
                    tinverse.check_engine_fields("cuda", [name], physical=physical,
                                                 scene=scene)
    assert tvjp.PALLAS_TRAINABLE_FIELDS_TEX == jvjp.PALLAS_TRAINABLE_FIELDS_TEX
    assert tvjp.PALLAS_TRAINABLE_FIELDS_TEX_FULL == jvjp.PALLAS_TRAINABLE_FIELDS_TEX_FULL


@pytest.mark.parametrize("name,fields,mode", [
    ("color quad", ["textures", "materials.diffuse"], "linear"),
    ("color quad", ["textures", "materials.roughness"], "full"),
    ("normal quad", ["textures"], "full"),
    ("normal quad", ["materials.diffuse", "al_power"], "linear"),
    ("textured", ["textures"], "full"),
])
def test_make_loss_picks_the_reference_s_grad_mode(name, fields, mode):
    loss = tinverse.make_loss(port_scene(SCENES[name]()), CP, torch.zeros(4, 4, 3), 4, 4, 1,
                              engine="plain", field_names=fields)
    assert loss.grad_mode == mode


def test_checkpoint_planes_are_what_the_mode_needs():
    """The reference's layout plane for plane, except that its normal-map
    block keeps 20 planes when the texels are not trained (ADVICE.md:4):
    12 here."""
    for full in (False, True):
        for tex_grads in (False, True):
            for nmap in (False, True):
                want = jvjp._st_planes_for(full, False, True, tex_grads, full and nmap)
                got = tvjp._st_planes(full, True, tex_grads, nmap)
                assert got == want - (8 if (full and nmap and not tex_grads) else 0)
        assert tvjp._st_planes(full) == jvjp._st_planes_for(full, False, False, False, False)
    counts = tmk.pack_scene(tpresets.get_scene("textured"), "cpu").counts
    assert tvjp._grad_rows(counts, True, 2304) == tvjp._grad_rows(counts, True) + 6912


# ---- the training commands ----------------------------------------------------------

def test_cli_invert_textured_texels(capsys):
    """``invert --scene textured --fields textures`` on the CPU: the texels,
    perturbed, move back toward the truth."""
    main(["invert", "--device", "cpu", "--scene", "textured", "--fields", "textures",
          "--width", "8", "--height", "8", "--spp", "2", "--bounces", "3", "--steps", "6",
          "--lr", "0.05", "--perturb", "0.2"])
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith("step")]
    got = json.loads(text.strip().splitlines()[-1])
    assert lines and set(got) == {"final_loss", "max_abs_err"}
    first = float(lines[0].split("loss")[1])
    assert got["final_loss"] < first
    assert np.isfinite(got["max_abs_err"]["textures"])


def test_cli_grad_check_textured(capsys):
    main(["grad-check", "--device", "cpu", "--scene", "textured", "--fields",
          "textures,materials.diffuse", "--width", "8", "--height", "8", "--spp", "2",
          "--bounces", "3", "--directions", "2", "--eps", "1e-2"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["engine"] == "plain" and got["allclose"] is True, got
