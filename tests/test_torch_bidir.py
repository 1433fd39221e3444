"""The port's bidirectional render on the CPU: the plain versions of its two
halves (the physical megakernel with the bidirectional carries, the light
kernel) against the JAX package's `render_bidir`, the bidirectional golden,
the nu -> 0 limit, and the host-compiler build of the CUDA kernel's bidir
instantiation (torch_port_helpers.py; needs g++) against the plain version.
The CUDA kernels themselves run only on a GPU and are held against the plain
versions there by chip_smoke.py.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render.bidir import render_bidir as jrender_bidir
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as tlk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.render import bidir as tbidir
from cuda_path_tracer_ss_torch.utils import rng as trng
from torch_port_helpers import (assert_per_pixel_parity, light_records_hostbuild,
                                render_block_sums_hostbuild)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())


def _packed(name):
    return tmk.pack_scene(tpresets.get_scene(name), "cpu")


# ---- (a) the whole estimator against the reference ------------------------------

@pytest.mark.parametrize("name", ["cornell_lambert", "caustic"])
def test_plain_bidir_matches_jax_render_bidir(name):
    """The bars of tests/test_bidir.py::test_bidir_fast_engines_match_jnp
    (16x16, 2 spp + 2048 paths, 4 bounces): the eye half agrees per pixel, the
    image-level band is the light half's scatter-add order over 2048 splats."""
    want = np.asarray(jrender_bidir(jpresets.get_scene(name), JCP, 16, 16, 2, 2048,
                                    0, max_bounces=4))
    got = tbidir.render_bidir_fast(_packed(name), CP, 16, 16, 2, 2048, 0,
                                   max_bounces=4).numpy()
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.mean() < 2e-5 and (d < 5e-5).mean() > 0.99
    assert want.mean() > 1e-3


@pytest.mark.parametrize("name", ["cornell_lambert", "caustic", "cornell", "showcase"])
def test_plain_eye_half_per_pixel_parity_with_jax(name):
    """K1's bidir variant alone: the physical estimator with bidir_nu against
    the reference's jnp engine, the per-pixel criterion."""
    want = np.asarray(jrender(jpresets.get_scene(name), JCP, 16, 16, 2, jnp.int32(0),
                              max_bounces=4, live_cutoff=None, physical=True,
                              bidir_nu=1024.0))
    got = tmk.render_megakernel(_packed(name), CP, 0, 16, 16, 2, 4, physical=True,
                                bidir_nu=1024.0)
    assert_per_pixel_parity(got.numpy(), want)
    physical = tmk.render_megakernel(_packed(name), CP, 0, 16, 16, 2, 4, physical=True)
    assert float(physical.mean()) > float(got.mean())   # the splats own the rest


def test_plain_eye_half_parity_with_jax_megakernel_interpret():
    """Against the TPU kernel's bidir variant itself, in Pallas interpret
    mode, at the smallest useful size."""
    want = np.asarray(jmk.render_megakernel(
        jmk.pack_scene(jpresets.caustic()), JCP, 5, 12, 12, 2, max_bounces=3,
        interpret=True, physical=True, bidir_nu=256.0))
    got = tmk.render_megakernel(_packed("caustic"), CP, 5, 12, 12, 2, 3,
                                physical=True, bidir_nu=256.0)
    assert_per_pixel_parity(got.numpy(), want)


def test_nu_zero_limit_is_the_physical_estimator():
    """As n_paths / spp -> 0 the light-trace techniques carry no weight and
    the eye half reproduces the physical estimator (tests/test_bidir.py)."""
    packed = _packed("cornell_lambert")
    plain = tmk.render_megakernel(packed, CP, 0, 16, 16, 8, 4, physical=True)
    tiny = tmk.render_megakernel(packed, CP, 0, 16, 16, 8, 4, physical=True,
                                 bidir_nu=1e-12)
    np.testing.assert_allclose(tiny.numpy(), plain.numpy(), rtol=0, atol=1e-6)


# ---- (b) the golden ---------------------------------------------------------------

def _bidir_golden_far(img):
    want = np.load(os.path.join(GOLDEN, "bidir_shadowed_caustic_16x16_2spp_512p_3b.npy"))
    assert want.mean() > 1e-4       # the caustic is in frame, not a black image
    np.testing.assert_allclose(img.mean((0, 1)), want.mean((0, 1)), rtol=1e-3)
    far = ~np.isclose(img, want, rtol=1e-3, atol=1e-5).all(axis=-1)
    return {tuple(p) for p in np.argwhere(far).tolist()}


def test_plain_bidir_golden_image():
    """Golden made by the reference's jnp `render_bidir` on a CPU
    (shadowed_caustic, 16x16, 2 spp + 512 paths, seed 42, 3 bounces), every
    pixel within rtol 1e-3 / atol 1e-5."""
    img = tbidir.render_bidir_fast(_packed("shadowed_caustic"), CP, 16, 16, 2, 512,
                                   42, max_bounces=3).numpy()
    assert _bidir_golden_far(img) == set()


def test_kernel_math_fma_build_matches_bidir_golden():
    """Both kernels' device math compiled for the host WITH FMA contraction,
    as the golden's compiler had it, put together as render_bidir_fast does."""
    packed = _packed("shadowed_caustic")
    nu = 512 / 2
    eye = render_block_sums_hostbuild(packed, CP, 42, 16, 16, 2, 3, 0, 256, fma=True,
                                      physical=True, bidir_nu=nu) / 2
    records = light_records_hostbuild(packed, CP, trng.seed_for(42, 1), 16, 16, 512,
                                      3, bidir_nu=nu, fma=True)
    light = tlk.splat_records(records, 16, 16) / 512
    assert _bidir_golden_far((eye + light).numpy().reshape(16, 16, 3)) == set()


# ---- (c) gates ----------------------------------------------------------------------

def test_bidir_nu_without_physical_raises():
    packed = _packed("cornell")
    for fn in (tmk.render_megakernel, tmk.render_megakernel_plain):
        with pytest.raises(ValueError, match="physical estimator"):
            fn(packed, CP, 0, 8, 8, 1, 2, bidir_nu=4.0)
    with pytest.raises(ValueError, match="physical estimator"):
        tmk.render_block_sums(packed, CP, 0, 8, 8, 1, 2, 0, 64, bidir_nu=4.0)
    with pytest.raises(ValueError, match="positive"):
        tmk.render_megakernel(packed, CP, 0, 8, 8, 1, 2, physical=True, bidir_nu=0.0)


def test_bidir_needs_an_area_light():
    import dataclasses
    packed = _packed("cornell")
    dark = dataclasses.replace(packed, counts=packed.counts[:4] + (0,))
    with pytest.raises(ValueError, match="needs an area light"):
        tbidir.render_bidir_fast(dark, CP, 8, 8, 1, 64, 0)


@pytest.mark.parametrize("entry,item", [("render_bidir", "item 8"),
                                        ("render_bidir_sharded", "item"),
                                        ("render_bidir_fast_sharded", "item 10")])
def test_unported_entries_raise_naming_the_roadmap(entry, item):
    with pytest.raises(NotImplementedError, match="ROADMAP.*" + item):
        getattr(tbidir, entry)(None, CP, 8, 8, 1, 64, 0)


def test_batches_draw_other_samples():
    packed = _packed("caustic")
    a = tbidir.render_bidir_fast(packed, CP, 10, 10, 1, 500, 3, max_bounces=3)
    b = tbidir.render_bidir_fast(packed, CP, 10, 10, 1, 500, 3, max_bounces=3,
                                 sample_offset=1, light_sample_idx=1)
    again = tbidir.render_bidir_fast(packed, CP, 10, 10, 1, 500, 3, max_bounces=3)
    assert torch.equal(a, again) and float((a - b).abs().max()) > 0


# ---- (d) the CUDA kernel's bidir instantiation, compiled for the host -------------

@pytest.mark.parametrize("name", ["cornell", "showcase", "point_lights", "stress",
                                  "glass", "caustic", "stress_dense"])
def test_bidir_kernel_math_host_build_matches_plain(name):
    scene = (tpresets.stress_dense(300) if name == "stress_dense"
             else tpresets.get_scene(name))
    packed = tmk.pack_scene(scene, "cpu")
    # the scenes of hundreds of primitives at a smaller size (the plain
    # version holds [rays, primitives] tensors)
    dense = packed.counts[0] + packed.counts[1] > 100
    w, h, spp, bounces = (32, 24, 2, 5) if dense else (40, 32, 4, 6)
    kw = dict(physical=True, bidir_nu=64.0)
    plain = tmk.render_block_sums_plain(packed, CP, 7, w, h, spp, bounces, 0, w * h, **kw)
    host = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, bounces, 0, w * h, **kw)
    assert_per_pixel_parity(host.numpy() / spp, plain.numpy() / spp)
