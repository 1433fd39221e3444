"""The port's native.py (libptnative, built from native/*.cpp through the
build cache) against the reference: the scene builder equals the JAX
package's presets, the tonemap and the TGA writer equal the port's own
Python versions byte for byte."""
import os

import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_torch import native
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera
from cuda_path_tracer_ss_torch.models.scene import scene_to_numpy
from cuda_path_tracer_ss_torch.ops import tonemap
from cuda_path_tracer_ss_torch.render.renderer import ProgressiveRenderer, RenderConfig
from cuda_path_tracer_ss_torch.utils import compile_cache
from cuda_path_tracer_ss_torch.utils import image as image_io
from cuda_path_tracer_ss_tpu.models import presets as jpresets
from torch_port_helpers import jax_scene_to_numpy

MATERIAL_COLUMNS = ("diffuse", "specular", "absorption", "emission", "spec_exp",
                    "ior", "diff_avg", "spec_avg", "refr_avg", "roughness")


def _columns(d, names, prefix=""):
    cols = [np.asarray(d[prefix + n]) for n in names]
    return np.concatenate([c[:, None] if c.ndim == 1 else c for c in cols], -1)


@pytest.mark.parametrize("preset", ["showcase", "cornell", "cornell_empty",
                                    "glass", "point_lights"])
def test_native_scene_matches_the_reference_presets(preset):
    """The reference's tolerances (tests/test_native.py): exact, triangles
    atol 2e-6, al_area rtol 1e-6; the port's presets hold the same arrays."""
    got = native.build_scene_arrays(preset)
    for want in (jax_scene_to_numpy(jpresets.get_scene(preset)),
                 scene_to_numpy(tpresets.get_scene(preset))):
        np.testing.assert_array_equal(got["spheres"],
                                      _columns(want, ("sph_center", "sph_radius")))
        np.testing.assert_array_equal(got["sph_mat"], want["sph_mat"])
        np.testing.assert_allclose(got["triangles"], _columns(
            want, ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2")), atol=2e-6)
        np.testing.assert_array_equal(got["tri_mat"], want["tri_mat"])
        np.testing.assert_array_equal(got["materials"][:, :18],
                                      _columns(want, MATERIAL_COLUMNS, "materials."))
        np.testing.assert_array_equal(got["flags"], want["materials.flags"])
        np.testing.assert_array_equal(got["al_power"], want["al_power"])
        np.testing.assert_allclose(got["al_area"], want["al_area"], rtol=1e-6)
        np.testing.assert_array_equal(got["al_tri0"], want["al_tri0"])
        np.testing.assert_array_equal(got["point_lights"],
                                      _columns(want, ("pl_pos", "pl_power")))


def test_native_tonemap_equals_the_port_s_tonemap():
    rng = np.random.default_rng(0)
    radiance = rng.uniform(-0.2, 1.4, (32, 32, 3)).astype(np.float32)
    # the dark range, where the gamma curve is steepest
    radiance[0, :8] = rng.uniform(0, 3e-4, (8, 3)).astype(np.float32)
    want = tonemap.to_uint8(tonemap.tonemap(torch.from_numpy(radiance))).numpy()
    np.testing.assert_array_equal(native.tonemap_u8(radiance), want)


def test_native_tonemap_nan_safe():
    radiance = np.array([[[np.nan, -np.inf, np.inf]]], np.float32)
    assert native.tonemap_u8(radiance).tolist() == [[[0, 0, 255]]]


def test_native_tga_equals_the_python_writer(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
    mine, theirs = str(tmp_path / "n.tga"), str(tmp_path / "p.tga")
    assert native.write_tga(mine, img)
    image_io.write_tga(theirs, img)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    assert not native.write_tga(str(tmp_path / "no" / "such.tga"), img)


def test_the_library_comes_from_the_build_cache():
    assert native.available()
    sources = [os.path.join(native.NATIVE_DIR, s) for s in native.SOURCES]
    path = compile_cache.cached_library(native.host_compiler(), native.FLAGS,
                                        sources, "libptnative")
    assert native.load()._name == path and os.path.isfile(path + ".log")
    assert native.build_scene_arrays("stress") is None   # a Python-only preset


def test_without_a_host_compiler(monkeypatch, tmp_path):
    """No g++ / c++: available() is False, the native calls return what the
    reference's do, tonemap_u8 computes the same bytes with numpy, and the
    renderer writes .tga through the Python writer."""
    rng = np.random.default_rng(2)
    radiance = rng.uniform(-0.2, 1.4, (16, 16, 3)).astype(np.float32)
    radiance[0, 0] = np.nan
    want = native.tonemap_u8(radiance)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "host_compiler", lambda: None)
    assert not native.available() and native.build_scene_arrays("cornell") is None
    np.testing.assert_array_equal(native.tonemap_u8(radiance), want)
    img = rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    assert not native.write_tga(str(tmp_path / "n.tga"), img)
    r = ProgressiveRenderer(tpresets.get_scene("cornell_empty"), Camera(),
                            RenderConfig(width=6, height=4, max_bounces=1, spp=1,
                                         samples_per_pass=1, device="cpu"))
    r.run()
    r.save(str(tmp_path / "r.tga"))
    image_io.write_tga(str(tmp_path / "p.tga"), r.image_u8())
    with open(tmp_path / "r.tga", "rb") as f, open(tmp_path / "p.tga", "rb") as g:
        assert f.read() == g.read()
