"""The port's host data model against the JAX package's: presets, scene
round-trip, packed tables, camera, MSVC rand. Everything here is built from
the same numpy arithmetic on both sides, so equality is bitwise."""
import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas.megakernel import pack_scene as jpack_scene
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.utils.msvc_rand import MsvcRand as JMsvcRand
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.models.scene import (MaterialSpec, SceneBuilder,
                                                    scene_from_numpy,
                                                    scene_to_numpy)
from cuda_path_tracer_ss_torch.ops.cuda.megakernel import pack_scene
from cuda_path_tracer_ss_torch.utils.msvc_rand import MsvcRand
from torch_port_helpers import jax_scene_to_numpy, port_scene

PORTED = sorted(tpresets.PRESETS)


def _assert_dicts_bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _small(name, presets):
    """Presets at test size: the two dense ones take a primitive count."""
    if name == "stress_dense":
        return presets.stress_dense(200)
    if name == "mesh_dense":
        return presets.mesh_dense(1)
    return presets.PRESETS[name]()


@pytest.mark.parametrize("name", PORTED)
def test_preset_equals_jax_preset_bitwise(name):
    _assert_dicts_bitwise(scene_to_numpy(_small(name, tpresets)),
                          jax_scene_to_numpy(_small(name, jpresets)))


def test_preset_names_and_missing_presets():
    """Every preset of the JAX package is served, ``textured`` and ``mesh``
    (the OBJ loader's) included; an unknown name raises."""
    assert set(PORTED) == set(jpresets.PRESETS)
    for name in ("textured", "mesh"):
        _assert_dicts_bitwise(scene_to_numpy(tpresets.get_scene(name)),
                              jax_scene_to_numpy(jpresets.get_scene(name)))
    assert tpresets.get_scene("textured").num_textures == 3
    with pytest.raises(KeyError, match="unknown scene preset"):
        tpresets.get_scene("nope")


@pytest.mark.parametrize("name", ["cornell", "showcase", "point_lights"])
def test_scene_numpy_round_trip(name):
    scene = tpresets.get_scene(name)
    d = scene_to_numpy(scene)
    _assert_dicts_bitwise(scene_to_numpy(scene_from_numpy(d)), d)
    assert scene.num_spheres == d["sph_radius"].shape[0]
    assert scene.num_triangles == d["tri_mat"].shape[0]
    bad = dict(d)
    bad.pop("sph_mat")
    with pytest.raises(KeyError, match="sph_mat"):
        scene_from_numpy(bad)


def test_jax_built_mesh_scene_crosses_over():
    """A scene built by the JAX package reaches the port through
    scene_from_numpy, and mesh_demo so built equals the port's own."""
    js = jpresets.mesh_demo()
    _assert_dicts_bitwise(scene_to_numpy(port_scene(js)), jax_scene_to_numpy(js))
    _assert_dicts_bitwise(scene_to_numpy(port_scene(js)),
                          scene_to_numpy(tpresets.mesh_demo()))


@pytest.mark.parametrize("name", ["cornell", "showcase", "point_lights",
                                  "stress", "cornell_empty"])
def test_pack_scene_tables_equal_bitwise(name):
    got = pack_scene(tpresets.get_scene(name), "cpu")
    want = jpack_scene(jpresets.get_scene(name))
    assert got.counts == tuple(want.counts)
    for field in ("spheres", "triangles", "materials", "point_lights",
                  "area_lights", "background"):
        g = getattr(got, field)
        w = np.asarray(getattr(want, field))
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert tuple(g.shape) == w.shape, field
        assert g.numpy().tobytes() == w.tobytes(), field


def test_pack_scene_pads_empty_tables_and_refuses_textures():
    b = SceneBuilder()
    b.add_material(MaterialSpec(diffuse=(1, 1, 1), diff_avg=0.5))
    packed = pack_scene(b.build(), "cpu")
    assert packed.counts == (0, 0, 1, 0, 0)
    assert tuple(packed.spheres.shape) == (1, 5)
    assert tuple(packed.triangles.shape) == (1, 19)
    assert tuple(packed.area_lights.shape) == (1, 23)
    assert packed.tex_counts == (0, 0) and packed.tex_atlas is None
    # a texture packs: its texels, (first texel, h, w), the padded UV table,
    # the material's map ids
    b.add_texture(np.arange(18, dtype=np.float32).reshape(2, 3, 3) / 18)
    b.materials[0] = MaterialSpec(diffuse=(1, 1, 1), diff_avg=0.5, texture=0)
    packed = pack_scene(b.build(), "cpu")
    assert packed.tex_counts == (1, 6) and not packed.tex_nmap
    np.testing.assert_array_equal(packed.tex_atlas.numpy(),
                                  np.arange(18, dtype=np.float32).reshape(6, 3) / 18)
    np.testing.assert_array_equal(packed.tex_meta.numpy(), [[0, 2, 3]])
    np.testing.assert_array_equal(packed.tex_matids.numpy(), [[0, -1]])
    assert tuple(packed.tex_triuv.shape) == (1, 6)


def test_camera_moves_and_arrays_equal():
    a, b = Camera(), JCamera()
    for key in "wasdqefhgtwwfg":
        assert a.move(key) is True and b.move(key) is True
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.rotation, b.rotation)
    assert a.move("z") is False
    got, want = camera_arrays(a), jcamera_arrays(b)
    assert len(got) == 4
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_msvc_rand_sequence_equal():
    for seed in (1, 7, 11):
        a, b = MsvcRand(seed), JMsvcRand(seed)
        assert [a.rand() for _ in range(64)] == [b.rand() for _ in range(64)]
        assert [a.rnd(5.0) for _ in range(16)] == [b.rnd(5.0) for _ in range(16)]
        assert [a.rnd_int(1) for _ in range(16)] == [b.rnd_int(1) for _ in range(16)]
