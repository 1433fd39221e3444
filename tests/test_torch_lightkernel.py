"""The port's light-tracing module on the CPU: its plain PyTorch version against
the JAX package's light tracer (the jnp engine record by record and image by
image, and the TPU kernel itself in Pallas interpret mode at a tiny size), plus
the host-compiler build of the CUDA kernel's device math
(torch_port_helpers.py; needs g++) against the plain version. The CUDA kernel
itself runs only on a GPU and is held against the plain version there by
chip_smoke.py.

Both sides draw the same counter-RNG streams keyed on the global path index,
so every path leaves the same splats up to float op-order noise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import lightkernel as jlk
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.lighttrace import (lighttrace_block,
                                                       render_lighttrace)
from cuda_path_tracer_ss_tpu.utils import rng as jrng
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as tlk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.utils import rng as trng
from torch_port_helpers import light_records_hostbuild

CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())


def _per_path_images(records, n_paths, n_pixels):
    """Records [B+1, n_paths] -> one unnormalised splat image per path."""
    pix, r, g, b = (np.asarray(x) for x in records)
    path = np.broadcast_to(np.arange(n_paths)[None], pix.shape)
    vals = np.stack([r, g, b], -1)
    imgs = np.zeros((n_paths, n_pixels, 3), np.float32)
    np.add.at(imgs.reshape(-1, 3), (path * n_pixels + pix).reshape(-1),
              vals.reshape(-1, 3))
    return imgs


def _assert_same_splats(got, want, label):
    """The bar of tests/test_bidir.py::test_bidir_light_half_per_path_parity:
    values within 3e-5 of the largest, and identical splat support wherever
    a value is above rounding to zero."""
    vmax = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() < 3e-5 * vmax, label
    touched_got, touched_want = got.sum(-1) != 0.0, want.sum(-1) != 0.0
    sig = np.maximum(np.abs(got).sum(-1), np.abs(want).sum(-1))
    assert not np.any((touched_got != touched_want) & (sig > 1e-7)), label
    assert touched_want.sum() > 50, label


# ---- (a) records against the reference's jnp light tracer, path by path -------

@pytest.mark.parametrize("nu", [None, 1024.0])
@pytest.mark.parametrize("name", ["cornell_lambert", "caustic"])
def test_plain_records_match_jax_per_path(name, nu):
    """256 paths of a 2048-path batch, 16x16, 4 bounces, the light seed of a
    bidirectional render with seed 0."""
    w = h = 16
    n_local, bounces = 256, 4
    seed = trng.seed_for(0, 1)
    assert seed == int(jrng.seed_for(jnp.int32(0), 1))
    jscene = jpresets.get_scene(name)

    def one(i):
        return lighttrace_block(jscene, JCP, w, h, jnp.asarray([i], jnp.int32),
                                seed, max_bounces=bounces, sample_idx=0,
                                bidir_nu=nu)
    want = np.asarray(jax.vmap(one)(jnp.arange(n_local, dtype=jnp.int32)))
    packed = tmk.pack_scene(tpresets.get_scene(name), "cpu")
    records = tlk.light_records(packed, CP, seed, w, h, 2048, bounces, 0, n_local,
                                0, nu)
    assert records[0].dtype == torch.int32 and records[1].dtype == torch.float32
    assert all(tuple(x.shape) == (bounces + 1, n_local) for x in records)
    got = _per_path_images(records, n_local, w * h)
    _assert_same_splats(got, want.reshape(n_local, w * h, 3), (name, nu))


@pytest.mark.parametrize("nu", [None, 256.0])
def test_plain_image_matches_jax_lighttrace(nu):
    """The bars of tests/test_lighttrace.py::test_light_kernel_matches_jnp_tracer
    (cornell_lambert, 24x24, 4096 paths, seed 3, 4 bounces): the two sides can
    flip a borderline gate on an isolated path, hence a bounded handful of
    splats, not bitwise."""
    want = np.asarray(render_lighttrace(jpresets.cornell_lambert(), JCP, 24, 24,
                                        4096, 3, max_bounces=4, bidir_nu=nu))
    packed = tmk.pack_scene(tpresets.cornell_lambert(), "cpu")
    got = tlk.render_lighttrace_fast(packed, CP, 3, 24, 24, 4096, max_bounces=4,
                                     bidir_nu=nu).numpy()
    assert got.shape == (24, 24, 3)
    d = np.abs(got - want)
    assert d.mean() < 1e-5 and d.max() < 2e-3 and (d < 2e-5).mean() > 0.995
    assert want.mean() > 0.01


@pytest.mark.parametrize("nu", [64.0])
def test_plain_records_match_jax_light_kernel_interpret(nu):
    """Against the TPU kernel itself, run as the reference's own CPU tests run
    it (Pallas interpret mode), at the smallest useful size: 8x8, 128 paths,
    2 bounces."""
    w = h = 8
    n_paths, bounces = 128, 2
    jpacked = jmk.pack_scene(jpresets.caustic())
    jrec = jlk._light_records(jpacked, JCP, 4, w, h, n_paths, bounces, 1, 0,
                              n_paths, 0, nu, interpret=True)
    want = _per_path_images([np.asarray(x).reshape(bounces + 1, -1)[:, :n_paths]
                             for x in jrec], n_paths, w * h)
    packed = tmk.pack_scene(tpresets.caustic(), "cpu")
    got = _per_path_images(tlk.light_records_plain(packed, CP, 4, w, h, n_paths,
                                                   bounces, bidir_nu=nu),
                           n_paths, w * h)
    _assert_same_splats(got, want, nu)


# ---- (b) the record layout and the entry points ---------------------------------

@pytest.fixture(scope="module")
def caustic_packed():
    return tmk.pack_scene(tpresets.caustic(), "cpu")


def test_blocks_of_paths_equal_slices_of_the_batch(caustic_packed):
    """Streams key on the GLOBAL path index: any block of a batch — here of
    1000 paths, no multiple of the kernel's block size — is a slice of the
    whole; paths at or past n_paths leave zero records."""
    args = (caustic_packed, CP, 9, 12, 12, 1000, 3)
    whole = tlk.light_records(*args)
    block = tlk.light_records(*args, 333, 129)
    over = tlk.light_records(*args, 990, 25)
    for w_, b_, o_ in zip(whole, block, over):
        assert tuple(w_.shape) == (4, 1000)
        torch.testing.assert_close(b_, w_[:, 333:462], rtol=0, atol=0)
        torch.testing.assert_close(o_[:, :10], w_[:, 990:], rtol=0, atol=0)
        assert float(o_[:, 10:].abs().max()) == 0.0
    assert float(whole[1].abs().max()) > 0


def test_dead_paths_leave_zero_records(caustic_packed):
    """A slot without a splat holds zero rgb (and pixel 0); the emitter slot
    is filled for the paths whose light point the camera sees; once a path
    has left the scene every later slot is empty."""
    pix, r, g, b = tlk.light_records(caustic_packed, CP, 2, 16, 16, 2000, 5)
    empty = (r == 0) & (g == 0) & (b == 0)
    assert 0.2 < float(empty.float().mean()) < 0.95
    assert float(empty[5].float().mean()) > float(empty[1].float().mean())
    assert bool((pix >= 0).all()) and bool((pix < 256).all())
    assert bool((r >= 0).all()) and bool(torch.isfinite(r).all())
    assert float((~empty[0]).float().mean()) > 0.5
    zero_bounces = tlk.light_records(caustic_packed, CP, 2, 16, 16, 2000, 0)
    for a, b_ in zip(zero_bounces, (pix, r, g, b)):
        torch.testing.assert_close(a, b_[:1], rtol=0, atol=0)


def test_splat_records_is_a_scatter_add(caustic_packed):
    records = tlk.light_records(caustic_packed, CP, 5, 10, 10, 800, 3)
    img = tlk.splat_records(records, 10, 10)
    want = _per_path_images(records, 800, 100).astype(np.float64).sum(0)
    np.testing.assert_allclose(img.numpy(), want, rtol=1e-5, atol=1e-5)
    fast = tlk.render_lighttrace_fast(caustic_packed, CP, 5, 10, 10, 800, 3)
    np.testing.assert_allclose(fast.numpy(), (img / 800).reshape(10, 10, 3).numpy())
    other = tlk.render_lighttrace_fast(caustic_packed, CP, 5, 10, 10, 800, 3,
                                       sample_idx=1)
    assert float((fast - other).abs().max()) > 0      # another batch, other paths


def test_stats_count_the_work(caustic_packed):
    stats = {}
    tlk.light_records_plain(caustic_packed, CP, 1, 16, 16, 1500, 4, stats=stats)
    assert stats["paths"] == 1500
    assert stats["paths"] <= stats["path_bounces"] <= 4 * stats["paths"]
    assert 0 < stats["vis_rays_occluded"] < stats["vis_rays"] <= stats["path_bounces"] + 1500
    assert 0 < stats["splats"] <= stats["vis_rays"] - stats["vis_rays_occluded"]


def test_gates_raise(caustic_packed):
    dark = dataclasses.replace(caustic_packed,
                               counts=caustic_packed.counts[:4] + (0,))
    textured = dataclasses.replace(caustic_packed, tex_counts=(1, 64))
    for fn in (tlk.render_lighttrace_fast, tlk.light_records, tlk.light_records_plain):
        with pytest.raises(ValueError, match="at least one area light"):
            fn(dark, CP, 0, 8, 8, 128, 2)
        with pytest.raises(ValueError, match="textured"):
            fn(textured, CP, 0, 8, 8, 128, 2)


@pytest.mark.parametrize("bad", [dict(n_paths=0), dict(max_bounces=-1), dict(width=0),
                                 dict(seed=2 ** 31), dict(sample_idx=-1),
                                 dict(path_offset=-1), dict(bidir_nu=0.0)])
def test_bad_arguments_raise(caustic_packed, bad):
    kw = dict(seed=0, width=8, height=8, n_paths=64, max_bounces=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        tlk.light_records(caustic_packed, CP, **kw)


def test_cuda_wrapper_refuses_cpu_tables(caustic_packed):
    """The kernel's wrapper does not give way to the plain version; the
    dispatching entry takes the plain version only because the tables lie on
    the CPU."""
    before = (tlk.LAUNCH_COUNT, list(tlk.LAUNCHES_BY_VARIANT))
    with pytest.raises(ValueError, match="CUDA device"):
        tlk.light_records_cuda(caustic_packed, CP, 0, 8, 8, 64, 2)
    assert (tlk.LAUNCH_COUNT, tlk.LAUNCHES_BY_VARIANT) == before
    a = tlk.light_records(caustic_packed, CP, 0, 8, 8, 64, 2)
    b = tlk.light_records_plain(caustic_packed, CP, 0, 8, 8, 64, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- (c) the CUDA kernel's device math, compiled for the host --------------------

@pytest.mark.parametrize("nu", [None, 512.0])
@pytest.mark.parametrize("name", ["cornell_lambert", "caustic", "shadowed_caustic",
                                  "cornell", "showcase"])
def test_kernel_math_host_build_matches_plain(name, nu):
    """csrc/lightkernel.cuh compiled by the host C++ compiler (FMA contraction
    off) and run one path at a time, against the plain version, slot by slot:
    the same pixel, and values within rtol 1e-4 / atol 1e-6 of the largest, on
    at least 99.9 % of the records (a borderline gate may flip on an isolated
    path) — the criterion the GPU build is held to on the card."""
    packed = tmk.pack_scene(tpresets.get_scene(name), "cpu")
    args = (packed, CP, 3, 40, 32, 2000, 4)
    plain = tlk.light_records_plain(*args, bidir_nu=nu)
    host = light_records_hostbuild(*args, bidir_nu=nu)
    big = max(float(x.abs().max()) for x in plain[1:])
    ok = plain[0] == host[0]
    for p, h in zip(plain[1:], host[1:]):
        assert bool(torch.isfinite(h).all())
        ok &= torch.isclose(h, p, rtol=1e-4, atol=1e-6 * big)
    assert float(ok.float().mean()) >= 0.999
    assert int((plain[1] != 0).sum()) > 50
    block = light_records_hostbuild(*args, 1001, 300, bidir_nu=nu)
    assert all(torch.equal(b, h[:, 1001:1301]) for b, h in zip(block, host))
    assert int((block[1] != 0).sum()) > 5
