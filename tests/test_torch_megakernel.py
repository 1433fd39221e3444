"""The port's megakernel module on the CPU: its plain PyTorch version and the
helpers it is made of, against the JAX package (the reference) on the same
inputs; plus a test-only host-compiler build of the CUDA kernel's device math
(torch_port_helpers.py; needs g++) against the plain version. The CUDA kernel itself runs only on a GPU and is held
against the plain version there by chip_smoke.py.

Inputs are made from a seed with numpy. Both sides draw the same counter-RNG
streams, so images agree per pixel up to float op-order noise.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.grid import build_grid
from torch_port_helpers import (assert_per_pixel_parity, port_scene,
                                render_block_sums_hostbuild, round_bf16_hostbuild)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CP = camera_arrays(Camera())


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rand(seed, n, *shape_scale):
    g = np.random.default_rng(seed)
    return g, [(g.standard_normal(n) * s).astype(np.float32) for s in shape_scale]


# ---- (a) helpers, one against one -------------------------------------------
# Tolerance: the same float32 formulas in the same order on both sides; what
# differs is the two libraries' sqrt/rsqrt/sin/cos/exp/log, a few ulp each,
# the reference compiler's contraction of a*b+c into FMAs, and the
# cancellations downstream of both — rtol 1e-5 with atol 2e-6 for values that
# cancel to near zero.
TOL = dict(rtol=1e-5, atol=2e-6)


def test_normalize3_matches():
    _, (x, y, z) = _rand(1, 2000, 3.0, 3.0, 3.0)
    x[:3] = 0.0; y[:3] = 0.0; z[:3] = 0.0          # the eps guard
    for eps in (1e-20, 1e-12):
        got = tmk._normalize3(*_t(x, y, z), eps)
        want = jmk._normalize3(x, y, z, eps)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_rotate_y_to_matches():
    g, (tx, ty, tz, sx, sy, sz) = _rand(2, 2000, 1, 1, 1, 1, 1, 1)
    n = np.sqrt(tx * tx + ty * ty + tz * tz)
    tx, ty, tz = tx / n, ty / n, tz / n
    tx[:4] = 0.0; ty[:4] = -1.0; tz[:4] = 0.0      # the degenerate antipode
    got = tmk._rotate_y_to(*_t(tx, ty, tz, sx, sy, sz))
    want = jmk._rotate_y_to(tx, ty, tz, sx, sy, sz)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got[1][:4].numpy(), -sy[:4])


def test_sphere_t_matches():
    g, (ox, oy, oz, dx, dy, dz, cx, cy, cz) = _rand(3, 4000, 2, 2, 2, 1, 1, 1, 3, 3, 3)
    n = np.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx / n, dy / n, dz / n
    r = g.uniform(0.2, 3.0, 4000).astype(np.float32)
    t, valid = tmk._sphere_t(*_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r))
    jt, jvalid = jmk._sphere_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0.03 < valid.float().mean() < 0.9
    # t comes from (-b -+ sqrt(disc)) / 2: the cancellation scales with |b|
    np.testing.assert_allclose(t.numpy()[valid.numpy()],
                               np.asarray(jt)[valid.numpy()], rtol=1e-5, atol=1e-5)


def test_triangle_t_matches():
    g, (ox, oy, oz, dx, dy, dz) = _rand(4, 4000, 1, 1, 1, 1, 1, 1)
    v0, e1, e2 = (g.standard_normal((3, 4000)).astype(np.float32) for _ in range(3))
    e1[:, :5] = 0.0                                 # degenerate determinant
    args = (ox, oy, oz, dx, dy, dz)
    got = tmk._triangle_t(*_t(*args), _t(*v0), _t(*e1), _t(*e2))
    want = jmk._triangle_t(*args, tuple(v0), tuple(e1), tuple(e2))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert not got[3][:5].any() and 0.005 < got[3].float().mean() < 0.5
    for a, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _random_materials(g, n):
    """Per-lane material columns in pack_scene order, mixing every branch:
    Lambert, Phong (finite exponent), delta mirror (inf), Cook-Torrance, pure
    reflection, glass."""
    kind = g.integers(0, 6, n)
    col = lambda lo, hi: g.uniform(lo, hi, n).astype(np.float32)
    m = [col(0, 1) for _ in range(12)]
    spec_exp = np.where(kind % 2 == 0, np.float32(np.inf), col(5, 300)).astype(np.float32)
    ior = col(1.1, 2.5)
    pd = np.where(kind == 0, col(0.3, 0.9), col(0, 0.3)).astype(np.float32)
    ps = col(0, 0.7)
    prf = np.where(kind == 5, col(0.3, 0.9), np.float32(0)).astype(np.float32)
    rough = col(0.05, 0.6)
    pure = (kind == 4).astype(np.float32)
    ct = ((kind == 3) | (kind == 4)).astype(np.float32)
    return m + [spec_exp, ior, pd, ps, prf, rough, pure, ct]


def test_scatter_sample_matches():
    n = 6000
    g, (dx, dy, dz, nx, ny, nz, px, py, pz) = _rand(5, n, 1, 1, 1, 1, 1, 1, 4, 4, 4)
    dn = np.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx / dn, dy / dn, dz / dn
    nn = np.sqrt(nx * nx + ny * ny + nz * nz) * g.uniform(0.8, 1.2, n).astype(np.float32)
    nx, ny, nz = nx / nn, ny / nn, nz / nn          # triangle normals are not unit
    cos_i = -(dx * nx + dy * ny + dz * nz)
    u_branch, u_a, u_b = (g.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    mats = _random_materials(g, n)
    args = (dx, dy, dz, nx, ny, nz, px, py, pz, cos_i, u_branch, u_a, u_b)
    got = tmk._scatter_sample(*_t(*args), tuple(_t(*mats)))
    want = jmk._scatter_sample(*args, tuple(mats))
    assert len(got) == len(want) == 16
    names = ("ox oy oz dx dy dz wr wg wb alive take_diff take_spec take_refr "
             "tir ct ct_w").split()
    for name, a, w in zip(names, got, want):
        a, w = a.numpy(), np.asarray(w)
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(a, w, err_msg=name)
        elif name in ("wr", "wg", "wb", "ct_w"):
            # the Cook-Torrance weight divides by |d.h|, itself the result
            # of a cancellation at grazing angles: ulps grow to ~1e-3 there
            np.testing.assert_allclose(a, w, err_msg=name, rtol=2e-3, atol=2e-6)
        else:
            np.testing.assert_allclose(a, w, err_msg=name, **TOL)
    take = {k: got[names.index(k)].float().mean() for k in
            ("take_diff", "take_spec", "take_refr", "tir", "ct")}
    assert all(v > 0.01 for v in take.values()), take   # every branch exercised


# ---- (b) per-pixel parity with the reference's jnp engine -------------------

def _reference(jscene, w, h, spp, bounces, seed):
    return np.asarray(jrender(jscene, jcamera_arrays(JCamera()), w, h, spp,
                              jnp.int32(seed), max_bounces=bounces,
                              live_cutoff=None))


@pytest.mark.parametrize("name", ["cornell", "showcase", "point_light_spheres",
                                  "mesh_demo", "stress"])
def test_plain_per_pixel_parity_with_jax(name):
    jscene = jpresets.stress(40) if name == "stress" else getattr(jpresets, name)()
    want = _reference(jscene, 24, 24, 2, 4, 5)
    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    got = tmk.render_megakernel_plain(packed, CP, 5, 24, 24, 2, 4)
    assert tuple(got.shape) == (24, 24, 3) and got.dtype == torch.float32
    if name != "stress":
        assert_per_pixel_parity(got.numpy(), want)
        return
    # stress is 40 glass / glossy spheres: the reference's compiler contracts
    # a*b+c into FMAs and eager PyTorch does not, and a 1-ulp hit distance
    # reroutes a glass path. Exactly these 4 of 576 pixels (y, x) may differ
    # for it (99.31 %, under the 99.5 % line); the kernel math compiled for
    # the host WITH contraction differs from the reference in the first alone.
    known = {(3, 14), (16, 13), (16, 17), (18, 5)}
    far = ~np.isclose(got.numpy(), want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert {tuple(p) for p in np.argwhere(far).tolist()} <= known
    np.testing.assert_allclose(got.numpy().reshape(-1, 3).mean(0),
                               want.reshape(-1, 3).mean(0), rtol=1e-3)
    fma = render_block_sums_hostbuild(packed, CP, 5, 24, 24, 2, 4, 0, 576,
                                      fma=True).numpy().reshape(24, 24, 3) / 2
    far = ~np.isclose(fma, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert {tuple(p) for p in np.argwhere(far).tolist()} <= {(3, 14)}


def test_plain_parity_with_jax_megakernel_interpret():
    """Against the TPU kernel itself, run as the reference's own CPU tests run
    it (Pallas interpret mode), at the smallest useful size."""
    want = np.asarray(jmk.render_fast2(jpresets.cornell(), jcamera_arrays(JCamera()),
                                       16, 16, 2, 5, max_bounces=3, interpret=True))
    got = tmk.render_fast2(tpresets.cornell(), CP, 16, 16, 2, 5, max_bounces=3,
                           device="cpu")
    assert_per_pixel_parity(got.numpy(), want)


# ---- (c) golden --------------------------------------------------------------

def test_plain_golden_image():
    """Golden made by the reference's jnp engine on a CPU (cornell, seed 42),
    at the tolerance of tests/test_pallas_cpu.py (rtol 1e-3 / atol 1e-5) —
    on every pixel but four: the golden's compiler contracted a*b+c into
    FMAs, eager PyTorch rounds after the multiply, and exactly these 4 of the
    1024 pixels (y, x) take another path for it
    (test_kernel_math_fma_build_matches_golden shows that this is the whole
    difference)."""
    img = tmk.render_fast2(tpresets.cornell(), CP, 32, 32, 8, 42, max_bounces=4,
                           device="cpu").numpy()
    want = np.load(os.path.join(GOLDEN, "cornell_32x32_8spp_4b.npy"))
    known = {(22, 14), (26, 26), (29, 2), (31, 0)}
    far = ~np.isclose(img, want, rtol=1e-3, atol=1e-5).all(axis=-1)
    assert {tuple(p) for p in np.argwhere(far).tolist()} <= known
    np.testing.assert_allclose(img.mean((0, 1)), want.mean((0, 1)), rtol=1e-3)


def test_kernel_math_fma_build_matches_golden():
    """The CUDA kernel's device math, compiled for the host WITH FMA
    contraction as the golden's compiler had it, reproduces the golden on
    every pixel at the reference's own tolerance."""
    packed = tmk.pack_scene(tpresets.cornell(), "cpu")
    sums = render_block_sums_hostbuild(packed, CP, 42, 32, 32, 8, 4, 0, 1024,
                                       fma=True)
    want = np.load(os.path.join(GOLDEN, "cornell_32x32_8spp_4b.npy"))
    np.testing.assert_allclose(sums.numpy().reshape(32, 32, 3) / 8, want,
                               rtol=1e-3, atol=1e-5)


# ---- (d) entry-point semantics -----------------------------------------------

@pytest.fixture(scope="module")
def cornell_packed():
    return tmk.pack_scene(tpresets.cornell(), "cpu")


def test_sample_offset_continues_streams(cornell_packed):
    """spp=4 at offset 0 and 4 average to the spp=8 render: progressive passes
    reproduce a monolithic render (sum order differs: rtol 1e-6)."""
    whole = tmk.render_megakernel(cornell_packed, CP, 3, 16, 16, 8, 4)
    first = tmk.render_megakernel(cornell_packed, CP, 3, 16, 16, 4, 4, sample_offset=0)
    second = tmk.render_megakernel(cornell_packed, CP, 3, 16, 16, 4, 4, sample_offset=4)
    np.testing.assert_allclose(((first + second) / 2).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert float((first - second).abs().max()) > 0


def test_sample_clamp():
    packed = tmk.pack_scene(tpresets.showcase(), "cpu")
    raw = tmk.render_megakernel(packed, CP, 11, 16, 16, 4, 6)
    clamped = tmk.render_megakernel(packed, CP, 11, 16, 16, 4, 6, sample_clamp=1.0)
    assert float(raw.max()) > 1.0
    assert float(clamped.max()) <= 1.0 + 1e-6
    assert bool((clamped <= raw + 1e-5).all())


def test_max_bounces_one_matches_jax(cornell_packed):
    want = _reference(jpresets.cornell(), 16, 16, 2, 1, 9)
    got = tmk.render_megakernel_plain(cornell_packed, CP, 9, 16, 16, 2, 1)
    assert_per_pixel_parity(got.numpy(), want)
    more = tmk.render_megakernel_plain(cornell_packed, CP, 9, 16, 16, 2, 4)
    assert float(more.mean()) > float(got.mean())


def test_non_square_image_matches_jax(cornell_packed):
    want = _reference(jpresets.cornell(), 28, 12, 2, 3, 4)
    got = tmk.render_megakernel_plain(cornell_packed, CP, 4, 28, 12, 2, 3)
    assert tuple(got.shape) == (12, 28, 3)
    assert_per_pixel_parity(got.numpy(), want)


def test_pixel_tile_equals_same_pixels_of_whole(cornell_packed):
    w, h, spp = 20, 14, 3
    whole = tmk.render_block_sums(cornell_packed, CP, 6, w, h, spp, 4, 0, w * h)
    tile = tmk.render_block_sums(cornell_packed, CP, 6, w, h, spp, 4, 57, 100)
    assert tuple(tile.shape) == (100, 3)
    np.testing.assert_array_equal(tile.numpy(), whole[57:157].numpy())
    # pixels past the image render as zero sums
    over = tmk.render_block_sums(cornell_packed, CP, 6, w, h, spp, 4, w * h - 10, 25)
    np.testing.assert_array_equal(over[:10].numpy(), whole[-10:].numpy())
    assert float(over[10:].abs().max()) == 0.0


def test_plain_stats_count_the_work(cornell_packed):
    stats = {}
    tmk.render_megakernel_plain(cornell_packed, CP, 1, 12, 12, 2, 5, stats=stats)
    assert stats["paths"] == 12 * 12 * 2
    assert stats["paths"] <= stats["path_bounces"] <= 5 * stats["paths"]
    assert 0 < stats["shadow_rays_occluded"] < stats["shadow_rays"] <= stats["path_bounces"]


# ---- (e) every option renders; (f) the device rule ---------------------------

@pytest.mark.parametrize("kwargs", [dict(physical=True), dict(packed_grid="grid"),
                                    dict(state_bf16=True), dict(bidir_nu=1.0)])
def test_unported_options_raise(cornell_packed, kwargs):
    """Every option of the reference's entry renders: the physical estimator;
    the grid, to the linear sweeps' image bit for bit; the bf16 carries,
    within bf16 rounding of the float32 image (the bound of
    tests/test_pallas_cpu.py: mean gap below 2e-3 of the mean); the
    bidirectional carries need the physical estimator."""
    if kwargs.get("packed_grid") == "grid":
        kwargs = dict(packed_grid=tmk.pack_grid(build_grid(tpresets.cornell()), "cpu"))
    render = lambda **kw: tmk.render_megakernel(cornell_packed, CP, 0, 8, 8, 1, 2, **kw)
    if "bidir_nu" in kwargs:
        with pytest.raises(ValueError, match="physical estimator"):
            render(**kwargs)
        return
    img = render(**kwargs)
    assert tuple(img.shape) == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0
    if "packed_grid" in kwargs:
        assert torch.equal(img, render())
    if "state_bf16" in kwargs:
        f32 = render()
        assert not torch.equal(img, f32)
        assert float((img - f32).abs().mean()) < 2e-3 * float(f32.mean())


def test_render_fast2_unported_options_raise():
    """render_fast2 takes a UniformGrid or a PackedGrid (as the reference's
    does) and renders the linear image; physical=True renders too."""
    scene = tpresets.cornell()
    want = tmk.render_megakernel(tmk.pack_scene(scene, "cpu"), CP, 0, 8, 8, 1)
    grid = build_grid(scene)
    for g in (grid, tmk.pack_grid(grid, "cpu")):
        got = tmk.render_fast2(scene, CP, 8, 8, 1, 0, device="cpu", grid=g)
        assert torch.equal(got, want)
    got = tmk.render_fast2(scene, CP, 8, 8, 1, 0, device="cpu", physical=True)
    want = tmk.render_megakernel(tmk.pack_scene(scene, "cpu"), CP, 0, 8, 8, 1,
                                 physical=True)
    assert torch.equal(got, want)


def test_default_device_is_cuda_and_raises_without_a_card():
    """Entry points default to the GPU and do not render on the CPU instead.
    (This suite runs where there is no card.)"""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    scene = tpresets.cornell()
    with pytest.raises((RuntimeError, AssertionError)):
        tmk.pack_scene(scene)
    with pytest.raises((RuntimeError, AssertionError)):
        tmk.render_fast2(scene, CP, 8, 8, 1, 0)


def test_cuda_wrapper_refuses_cpu_tables(cornell_packed):
    before = tmk.LAUNCH_COUNT
    with pytest.raises(ValueError, match="CUDA device"):
        tmk.render_block_sums_cuda(cornell_packed, CP, 0, 8, 8, 1, 2, 0, 64)
    assert tmk.LAUNCH_COUNT == before


@pytest.mark.parametrize("bad", [dict(width=0), dict(spp=0), dict(max_bounces=-1),
                                 dict(sample_offset=-1), dict(seed=2 ** 31),
                                 dict(pixel_offset=2 ** 31)])
def test_bad_arguments_raise(cornell_packed, bad):
    kw = dict(seed=0, width=8, height=8, spp=1, max_bounces=2, pixel_offset=0,
              n_local=64, sample_offset=0)
    kw.update(bad)
    with pytest.raises(ValueError):
        tmk.render_block_sums(cornell_packed, CP, **kw)


# ---- the CUDA kernel's device math, compiled for the host --------------------

@pytest.mark.parametrize("name", ["cornell", "showcase", "point_lights", "stress",
                                  "glass", "stress_dense", "mesh_dense"])
def test_kernel_math_host_build_matches_plain(name):
    """csrc/megakernel.cuh compiled by the host C++ compiler (FMA contraction
    off) and run one pixel at a time, against the plain version: the same
    criterion the GPU build is held to on the card."""
    scene = {"stress_dense": lambda: tpresets.stress_dense(300),
             "mesh_dense": lambda: tpresets.mesh_dense(1)}.get(
                 name, lambda: tpresets.get_scene(name))()
    packed = tmk.pack_scene(scene, "cpu")
    w, h, spp, bounces = 40, 32, 4, 6
    for kw in (dict(), dict(sample_offset=5, sample_clamp=1.0)):
        plain = tmk.render_block_sums_plain(packed, CP, 7, w, h, spp, bounces,
                                            0, w * h, **kw)
        host = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, bounces,
                                           0, w * h, **kw)
        assert_per_pixel_parity(host.numpy() / spp, plain.numpy() / spp)
    tile = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, bounces, 301, 200)
    full = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, bounces, 0, w * h)
    np.testing.assert_array_equal(tile.numpy(), full[301:501].numpy())


# ---- bfloat16 carries (state_bf16) ---------------------------------------------

def test_round_bf16_matches_torch():
    """The host build's round_bf16 (the bit operation the host compiles; the
    card uses __float2bfloat16_rn) against torch's float -> bfloat16 cast,
    bit for bit: random magnitudes, exact ties both ways, zeros, infinities,
    the largest float, subnormals; NaN stays NaN."""
    g = np.random.default_rng(4)
    rand = (g.standard_normal(4000) * 10.0 ** g.integers(-30, 30, 4000)).astype(np.float32)
    ties = ((g.integers(0, 1 << 15, 2000, dtype=np.uint32) << 16) | 0x8000).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.finfo(np.float32).max, 1e-40,
                        -3e-42, np.nan], np.float32)
    x = np.concatenate([rand, ties, special])
    got = round_bf16_hostbuild(x)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


@pytest.mark.parametrize("case", ["cornell-default", "cornell-physical", "cornell-bidir",
                                  "textured-default"])
def test_kernel_math_bf16_matches_plain(case):
    """The kernel's bfloat16 stores (host build) against the plain version's,
    per pixel."""
    name, variant = case.split("-")
    kw = {"default": {}, "physical": dict(physical=True),
          "bidir": dict(physical=True, bidir_nu=64.0)}[variant]
    packed = tmk.pack_scene(tpresets.get_scene(name), "cpu")
    w, h, spp, nb = 16, 16, 2, 4
    plain = tmk.render_block_sums_plain(packed, CP, 7, w, h, spp, nb, 0, w * h,
                                        state_bf16=True, **kw)
    host = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, nb, 0, w * h,
                                       state_bf16=True, **kw)
    assert_per_pixel_parity(host.numpy() / spp, plain.numpy() / spp)
    f32 = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, nb, 0, w * h, **kw)
    assert not torch.equal(host, f32)


def test_plain_bf16_matches_the_pallas_kernel_in_interpret_mode():
    """Against the TPU kernel's state_bf16 variant, as the reference's CPU
    tests run it (cornell, 8x8, 2 spp, 3 bounces), per pixel."""
    want = np.asarray(jmk.render_megakernel(jmk.pack_scene(jpresets.cornell()),
                                            jcamera_arrays(JCamera()), 5, 8, 8, 2,
                                            max_bounces=3, interpret=True,
                                            state_bf16=True))
    got = tmk.render_megakernel(tmk.pack_scene(tpresets.cornell(), "cpu"), CP, 5, 8, 8, 2,
                                max_bounces=3, state_bf16=True)
    assert_per_pixel_parity(got.numpy(), want)


def test_bf16_approximates_f32(cornell_packed):
    """The bound of tests/test_pallas_cpu.py::test_state_bf16_runs_and_
    approximates_f32 (cornell 16x16, 4 spp, 4 bounces): every pixel within
    0.02 of the float32 image, the mean within 1 %."""
    f32 = tmk.render_megakernel(cornell_packed, CP, 0, 16, 16, 4, max_bounces=4).numpy()
    b16 = tmk.render_megakernel(cornell_packed, CP, 0, 16, 16, 4, max_bounces=4,
                                state_bf16=True).numpy()
    assert np.all(np.isfinite(b16))
    assert np.abs(f32 - b16).max() < 0.02, np.abs(f32 - b16).max()
    np.testing.assert_allclose(b16.mean(), f32.mean(), rtol=0.01)


# ---- K1's schedule: per-lane path regeneration --------------------------------

# Where a lane's path ends and the next sample's starts: one and three
# samples, the bounce cap at 1, 2 and 8, the sample clamp on the sum, a
# sample window that starts late, a pixel range that runs past the image.
REGEN_BOUNDARIES = {
    "spp1": dict(spp=1), "spp3": dict(spp=3), "nb1": dict(max_bounces=1),
    "nb2": dict(max_bounces=2), "nb8": dict(max_bounces=8),
    "clamp": dict(sample_clamp=0.5), "offset": dict(sample_offset=11),
    "past_image": dict(pixel_offset=32 * 24 - 200, n_local=330),
    "textured": dict(scene="textured"), "grid": dict(scene="stress", grid=True),
    "bf16": dict(state_bf16=True),
}
REGEN_VARIANTS = {"default": {}, "physical": dict(physical=True),
                  "bidir": dict(physical=True, bidir_nu=64.0)}


@pytest.mark.parametrize("variant", list(REGEN_VARIANTS))
@pytest.mark.parametrize("case", list(REGEN_BOUNDARIES))
def test_regenerating_schedule_matches_nested_and_plain(case, variant):
    """K1's render_pixel_t (one loop, one bounce per iteration, a lane
    starting its next sample's path in the iteration after its path ends),
    compiled for the host, gives the sums of a loop over samples around a
    loop over bounces bit for bit, also when it reads the small tables from
    the copy its blocks make in shared memory; and it holds per pixel against
    the plain version (32x24 image)."""
    kw = dict(REGEN_BOUNDARIES[case])
    scene = kw.pop("scene", "cornell")
    grid = kw.pop("grid", False)
    w, h = 32, 24
    args = dict(spp=2, max_bounces=6, pixel_offset=0, n_local=w * h)
    args.update(kw)
    args.update(REGEN_VARIANTS[variant])
    if grid:
        args["packed_grid"] = tmk.pack_grid(build_grid(tpresets.get_scene(scene)), "cpu")
    packed = tmk.pack_scene(tpresets.get_scene(scene), "cpu")
    regen = render_block_sums_hostbuild(packed, CP, 7, w, h, **args)
    for schedule in ("nested", "staged"):
        other = render_block_sums_hostbuild(packed, CP, 7, w, h, schedule=schedule, **args)
        assert np.array_equal(regen.numpy().view(np.uint32), other.numpy().view(np.uint32)), \
            schedule
    plain = tmk.render_block_sums_plain(packed, CP, 7, w, h, **args)
    inside = max(0, min(args["n_local"], w * h - args["pixel_offset"]))
    assert not bool(regen[inside:].any())
    assert_per_pixel_parity(regen[:inside].numpy() / args["spp"],
                            plain[:inside].numpy() / args["spp"])
    if "sample_clamp" in kw:
        assert float(regen.max()) <= args["spp"] * kw["sample_clamp"]


def _tally(packed, w, h, spp, nb, pixel_offset=0, n_local=None, sample_offset=0, **kw):
    stats = {}
    tmk.render_block_sums_plain(packed, CP, 3, w, h, spp, nb, pixel_offset,
                                w * h if n_local is None else n_local,
                                sample_offset, stats=stats, **kw)
    return stats


def test_lane_tally_at_one_bounce(cornell_packed):
    """With max_bounces=1 every path is one bounce: both schedules issue spp
    iterations in every warp that holds a pixel of the image (lanes count
    from the range's first pixel, so warps straddle image rows; lanes past
    the image do no work)."""
    w, h, spp = 10, 7, 3
    for off, n in ((0, 70), (5, 100), (33, 37)):
        stats = _tally(cornell_packed, w, h, spp, 1, off, n)
        warps = len({i // 32 for i in range(n) if off + i < w * h})
        assert stats["warp_iterations"] == stats["warp_iterations_nested"] == spp * warps
        assert stats["path_bounces"] == spp * min(n, w * h - off)


@pytest.mark.parametrize("kw", [dict(), dict(physical=True)])
def test_lane_tally_bounds_and_identities(cornell_packed, kw):
    """live bounces <= 32 x regenerating <= 32 x nested iterations; one
    sample gives both schedules the same count; one lane issues exactly its
    own bounces; the nested count adds up over sample windows, the
    regenerating one does not exceed the sum."""
    w, h, nb = 24, 16, 8
    stats = _tally(cornell_packed, w, h, 4, nb, **kw)
    live = stats["path_bounces"]
    assert live <= 32 * stats["warp_iterations"] <= 32 * stats["warp_iterations_nested"]
    assert stats["warp_iterations"] < stats["warp_iterations_nested"]
    one = _tally(cornell_packed, w, h, 1, nb, **kw)
    assert one["warp_iterations"] == one["warp_iterations_nested"]
    lane = _tally(cornell_packed, w, h, 4, nb, pixel_offset=100, n_local=1, **kw)
    assert lane["warp_iterations"] == lane["warp_iterations_nested"] == lane["path_bounces"]
    parts = [_tally(cornell_packed, w, h, 1, nb, sample_offset=s, **kw) for s in range(4)]
    assert sum(p["warp_iterations_nested"] for p in parts) == stats["warp_iterations_nested"]
    assert sum(p["warp_iterations"] for p in parts) >= stats["warp_iterations"]


def test_lane_tally_across_plain_chunks(cornell_packed, monkeypatch):
    """The plain version cuts a large range into pixel chunks that need not
    start on a warp boundary: the tally is that of the whole range."""
    w, h = 20, 12
    whole = _tally(cornell_packed, w, h, 3, 6, 7, 230)
    # 16 primitives: chunks of 45 pixels, five of six starting inside a warp
    monkeypatch.setattr(tmk, "_PLAIN_CHUNK_ENTRIES", 45 * 16)
    chunked = _tally(cornell_packed, w, h, 3, 6, 7, 230)
    assert chunked == whole
