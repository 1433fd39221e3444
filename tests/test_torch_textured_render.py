"""The textured forward render of the port on the CPU: the plain render per
pixel against the JAX package's jnp engine (default and physical estimator)
and against its Pallas kernel in interpret mode, the host-compiler build of
the CUDA kernel's textured instantiations (torch_port_helpers.py; needs g++)
against the plain render, and the command line with ``--obj`` and the
``textured`` preset. The CUDA kernel itself runs only on a GPU and is held
against the plain version there by chip_smoke.py.

Both sides draw the same counter-RNG streams, so images agree per pixel up to
float op-order noise; the criterion is the repo's (tests/test_pallas_cpu.py:
>= 99.5 % of pixels within rtol 1e-4 / atol 1e-5, channel means rtol 1e-3).
"""
import json

import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_tpu.utils import image as jimage
from cuda_path_tracer_ss_torch.cli import main
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as tlk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.render.bidir import render_bidir_fast
from cuda_path_tracer_ss_torch.utils.image import read_png
from torch_port_helpers import (assert_per_pixel_parity, jax_textured_quad, port_scene,
                                render_block_sums_hostbuild)

CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())

SCENES = {
    "textured": jpresets.textured,
    "color+normal quad": lambda: jax_textured_quad(nmap=True),
    "color sphere": lambda: jax_textured_quad(sphere=True),
}


@pytest.mark.parametrize("physical", [False, True], ids=["default", "physical"])
@pytest.mark.parametrize("name", list(SCENES))
def test_plain_render_matches_jnp_per_pixel(name, physical):
    jscene = SCENES[name]()
    want = np.asarray(jrender(jscene, JCP, 16, 16, 2, 0, max_bounces=3, live_cutoff=None,
                              physical=physical))
    got = tmk.render_megakernel_plain(tmk.pack_scene(port_scene(jscene), "cpu"), CP, 0,
                                      16, 16, 2, 3, physical=physical).numpy()
    assert_per_pixel_parity(got, want)
    if jscene.num_textures and not physical and name != "textured":
        # the maps did something: the untextured scene renders otherwise
        plain = tmk.render_megakernel_plain(
            tmk.pack_scene(port_scene(jax_textured_quad(tex=False, sphere="sphere" in name)),
                           "cpu"), CP, 0, 16, 16, 2, 3).numpy()
        assert np.abs(got - plain).max() > 1e-2


def test_plain_render_matches_the_pallas_kernel_in_interpret_mode():
    """The reference's own textured kernel, as its CPU tests run it, on the
    color- and normal-mapped quad (12x12, the smallest useful size)."""
    jscene = SCENES["color+normal quad"]()
    want = np.asarray(jmk.render_megakernel(jmk.pack_scene(jscene), JCP, 0, 12, 12, 2,
                                            max_bounces=2, interpret=True))
    got = tmk.render_fast2(port_scene(jscene), CP, 12, 12, 2, 0, max_bounces=2,
                           device="cpu").numpy()
    assert_per_pixel_parity(got, want)


@pytest.mark.parametrize("variant", [{}, dict(physical=True),
                                     dict(physical=True, bidir_nu=64.0)],
                         ids=["default", "physical", "bidir"])
@pytest.mark.parametrize("name", ["textured", "mesh", "color+normal quad", "color sphere"])
def test_kernel_math_textured_instantiations_match_plain(name, variant):
    """The host build of the kernel's textured instantiations (all three
    estimators; the OBJ-built ``mesh`` preset takes the untextured one),
    per pixel against the plain render."""
    scene = (tpresets.get_scene(name) if name in ("textured", "mesh")
             else port_scene(SCENES[name]()))
    packed = tmk.pack_scene(scene, "cpu")
    assert packed.textured == (name != "mesh")
    w, h = 20, 16
    got = render_block_sums_hostbuild(packed, CP, 3, w, h, 2, 4, 0, w * h, **variant)
    want = tmk.render_block_sums_plain(packed, CP, 3, w, h, 2, 4, 0, w * h, **variant)
    assert_per_pixel_parity(got.numpy(), want.numpy())


def test_mesh_preset_renders_like_jnp():
    """``mesh`` (the OBJ loader's icosahedron) against the jnp engine."""
    want = np.asarray(jrender(jpresets.mesh_demo(), JCP, 16, 16, 2, 0, max_bounces=3,
                              live_cutoff=None))
    got = tmk.render_fast2(tpresets.get_scene("mesh"), CP, 16, 16, 2, 0, max_bounces=3,
                           device="cpu").numpy()
    assert_per_pixel_parity(got, want)


def test_light_paths_refuse_textured_scenes():
    """The light kernel has no texture block (nor has the reference's): light
    tracing and the bidirectional render refuse a textured scene before any
    work."""
    packed = tmk.pack_scene(tpresets.get_scene("textured"), "cpu")
    before = tmk.LAUNCH_COUNT
    with pytest.raises(ValueError, match="texture block"):
        tlk.render_lighttrace_fast(packed, CP, 0, 8, 8, 64, max_bounces=2)
    with pytest.raises(ValueError, match="texture block"):
        render_bidir_fast(packed, CP, 8, 8, 1, 64, 0, max_bounces=2)
    assert tmk.LAUNCH_COUNT == before


def _write_obj(tmp_path):
    teximg = np.zeros((2, 2, 3), np.uint8)
    teximg[:, 0] = (255, 20, 20)
    teximg[:, 1] = (20, 20, 255)
    jimage.write_png(str(tmp_path / "skin.png"), teximg, bottom_up=False)
    (tmp_path / "m.mtl").write_text("newmtl skin\nKd 1 1 1\nmap_Kd skin.png\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v -2 -2 0\nv 2 -2 0\nv 2 2 0\nv -2 2 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl skin\nf 1/1 2/2 3/3 4/4\n")
    return str(tmp_path / "q.obj")


def test_cli_render_obj_with_map_kd(tmp_path, capsys):
    """``render --obj`` on an OBJ whose MTL binds a PNG color map: the quad
    shows red on the left, blue on the right."""
    obj = _write_obj(tmp_path)
    out = str(tmp_path / "obj.npy")
    main(["render", "--device", "cpu", "--obj", obj, "--width", "16", "--height", "16",
          "--spp", "4", "--bounces", "2", "--out", out])
    text = capsys.readouterr().out
    assert "loaded" in text and "skin" in text and f"wrote {out}" in text
    img = np.load(out)
    # the quad spans columns 5-9 of rows 4-8 (row 0 at the bottom)
    left, right = img[4:9, 6].mean(0), img[4:9, 9].mean(0)
    assert left[0] > 2 * left[2] and right[2] > 2 * right[0], (left, right)


def test_cli_obj_scene_equals_the_reference_cli_s(tmp_path, capsys):
    """The port's _obj_scene builds the reference CLI's scene, array for
    array (auto-centred in the Cornell shell, --obj-scale)."""
    import argparse

    from cuda_path_tracer_ss_torch import cli as tcli
    from cuda_path_tracer_ss_torch.models.scene import scene_to_numpy
    from cuda_path_tracer_ss_tpu import cli as jcli
    from torch_port_helpers import jax_scene_to_numpy

    args = argparse.Namespace(obj=_write_obj(tmp_path), obj_scale=0.7)
    got, want = scene_to_numpy(tcli._obj_scene(args)), jax_scene_to_numpy(jcli._obj_scene(args))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cmd", ["render", "benchmark"])
def test_cli_textured_preset_runs_both_estimators(cmd, tmp_path, capsys):
    for flag in ([], ["--physical"]):
        args = [cmd, "--device", "cpu", "--scene", "textured", "--width", "12", "--height",
                "12", "--spp", "1", "--bounces", "3", *flag]
        if cmd == "render":
            out = str(tmp_path / f"t{len(flag)}.png")
            main([*args, "--out", out])
            assert read_png(out).max() > 0
        else:
            main([*args, "--repeats", "1"])
            assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
                "physical"] == bool(flag)
