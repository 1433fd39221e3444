"""The light kernel's schedule and its image sink on the CPU.

The CUDA kernel traces one light path per thread with two functions,
``start_light_path`` and ``light_bounce``, and adds every splat into the
image with atomics. Neither runs here, so the kernel's device math is
compiled for the host (``tests/torch_kernel_host.cpp``, built by
``torch_port_helpers.py``; needs g++) and held

- schedule against schedule: a loop that regenerates paths per lane over a
  given number of lanes (the schedule ``k1_turns.py`` measures as the
  kernel's alternative) writes the records of the kernel's one-path loop bit
  for bit: a path's arithmetic does not depend on which lane traces it, or
  when;
- image sink against records: the splats it adds are the records the plain
  version writes, summed by ``splat_records``, and the image the JAX
  package's TPU kernel gives in Pallas interpret mode;

and the plain version's lane tally (the bounce loop's iterations the warps
issue under either schedule) is checked against an independent count. The
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas import lightkernel as jlk
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as tlk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from torch_port_helpers import light_image_hostbuild, light_records_hostbuild

CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())
W, H = 40, 32


@pytest.fixture(scope="module")
def packed():
    return {name: tmk.pack_scene(tpresets.get_scene(name), "cpu")
            for name in ("cornell_lambert", "caustic", "shadowed_caustic", "cornell",
                         "showcase")}


# ---- (a) the regenerating schedule writes the one-path records, bit for bit ---------

@pytest.mark.parametrize("nu", [None, 512.0])
@pytest.mark.parametrize("name", ["cornell_lambert", "caustic", "shadowed_caustic",
                                  "cornell", "showcase"])
def test_regenerating_schedule_writes_the_one_path_records(packed, name, nu):
    """2000 paths, 4 bounces, over 1, 7 and 64 lanes (a lane then takes
    2000, 286 and 32 paths); and a block of 1200 paths from index 1001 of the
    batch, 199 of them past its end, which leave zero records."""
    args = (packed[name], CP, 3, W, H, 2000, 4)
    one = light_records_hostbuild(*args, bidir_nu=nu)
    assert int((one[1] != 0).sum()) > 50
    for n_lanes in (1, 7, 64):
        regen = light_records_hostbuild(*args, bidir_nu=nu, schedule="regenerating",
                                        n_lanes=n_lanes)
        assert all(torch.equal(a, b) for a, b in zip(regen, one)), n_lanes
    block = light_records_hostbuild(*args, 1001, 1200, bidir_nu=nu, schedule="regenerating",
                                    n_lanes=64)
    assert all(torch.equal(b[:, :999], o[:, 1001:]) for b, o in zip(block, one))
    assert all(float(b[:, 999:].abs().max()) == 0.0 for b in block)


# ---- (b) the image sink against the records and against the TPU kernel --------------

@pytest.mark.parametrize("nu", [None, 512.0])
@pytest.mark.parametrize("name", ["caustic", "showcase"])
def test_image_sink_is_the_sum_of_the_records(packed, name, nu):
    """The host image sink (regenerating over 64 lanes, serial float adds)
    against its own records summed by ``splat_records`` at rtol 1e-4 / atol
    1e-6 of the largest value (another summation order), and against the
    plain version's records summed so, where the one-path host records agree
    with the plain ones: at most 0.1 % of records may flip a borderline gate
    (the bar the card's kernel is held to), and the pixels they touch are
    left out."""
    args = (packed[name], CP, 3, W, H, 2000, 6)
    img = light_image_hostbuild(*args, bidir_nu=nu, schedule="regenerating", n_lanes=64)
    host = light_records_hostbuild(*args, bidir_nu=nu)
    plain = tlk.light_records_plain(*args, bidir_nu=nu)
    want = tlk.splat_records(plain, W, H)
    top = float(want.abs().max())
    assert top > 0 and bool(torch.isfinite(img).all())
    torch.testing.assert_close(img, tlk.splat_records(host, W, H), rtol=1e-4,
                               atol=1e-6 * top)
    big = max(float(x.abs().max()) for x in plain[1:])
    same = host[0] == plain[0]
    for h, p in zip(host[1:], plain[1:]):
        same &= torch.isclose(h, p, rtol=1e-4, atol=1e-6 * big)
    assert float(same.float().mean()) >= 0.999
    touched = torch.zeros(W * H, dtype=torch.bool)
    touched[host[0][~same].long()] = True
    touched[plain[0][~same].long()] = True
    close = torch.isclose(img, want, rtol=1e-4, atol=1e-6 * top).all(-1)
    assert bool((close | touched).all())
    assert float(touched.float().mean()) < 0.01


def test_image_sink_matches_jax_light_kernel_interpret():
    """Against the TPU kernel and its scatter-add, run as the reference's own
    CPU tests run them (Pallas interpret mode; one block of 8 x 128 lanes):
    cornell_lambert 16x16, 1024 paths, 3 bounces, under the bars of
    tests/test_lighttrace.py::test_light_kernel_matches_jnp_tracer."""
    want = np.asarray(jlk.render_lighttrace_fast(jmk.pack_scene(jpresets.cornell_lambert()),
                                                 JCP, 5, 16, 16, 1024, max_bounces=3,
                                                 block_rows=8, interpret=True))
    packed = tmk.pack_scene(tpresets.cornell_lambert(), "cpu")
    got = (light_image_hostbuild(packed, CP, 5, 16, 16, 1024, 3) / 1024).reshape(16, 16, 3)
    d = np.abs(got.numpy() - want)
    assert d.mean() < 1e-5 and d.max() < 2e-3 and (d < 2e-5).mean() > 0.995
    assert want.mean() > 0.01


# ---- (c) the lane tally ----------------------------------------------------------------

def test_lane_tally_counts_the_longest_path_of_each_warp(packed):
    """warp_iterations_nested (one path per lane) is the sum over warps of
    32 paths of the warp's longest path. Recounted here from tallies alone:
    a warp's paths run as a block of their own at every bounce cap k, and
    the warp iterates at bounce k exactly when raising the cap from k to
    k + 1 adds bounces. The regenerating schedule issues no more."""
    p, bounces, n = packed["caustic"], 8, 512
    stats = {}
    tlk.light_records_plain(p, CP, 1, W, H, n, bounces, stats=stats, n_lanes=64)
    longest = 0
    for w in range(n // 32):
        tally = []
        for k in range(bounces + 1):
            st = {}
            tlk.light_records_plain(p, CP, 1, W, H, n, k, 32 * w, 32, stats=st)
            tally.append(st.get("path_bounces", 0))
        longest += sum(b > a for a, b in zip(tally, tally[1:]))
    assert stats["warp_iterations_nested"] == longest
    assert stats["path_bounces"] <= 32 * stats["warp_iterations"]
    assert stats["warp_iterations"] <= stats["warp_iterations_nested"]
    one = {}
    tlk.light_records_plain(p, CP, 1, W, H, n, bounces, stats=one, n_lanes=n)
    assert one["warp_iterations"] == one["warp_iterations_nested"] == longest


def test_lane_efficiency_of_both_schedules_on_caustic(packed):
    """Light paths are short (caustic: about 2 bounces, a few up to the cap of
    8), so one path per lane keeps about a third of the warps' lane slots
    busy; regenerating over 128 lanes (31 paths each) keeps far more."""
    stats = {}
    tlk.light_records_plain(packed["caustic"], CP, 1, W, H, 4000, 8, stats=stats,
                            n_lanes=128)
    nested = stats["path_bounces"] / (32 * stats["warp_iterations_nested"])
    regen = stats["path_bounces"] / (32 * stats["warp_iterations"])
    assert 0.25 <= nested <= 0.40
    assert regen > 2 * nested
    assert 1.7 < stats["path_bounces"] / stats["paths"] < 2.3


# ---- (d) routing -----------------------------------------------------------------------

def test_cpu_tables_take_the_plain_records(packed):
    """On CPU tables render_lighttrace_fast is the plain version's records
    summed by splat_records (one call), and no kernel is launched."""
    p = packed["caustic"]
    before = (tlk.LAUNCH_COUNT, list(tlk.LAUNCHES_BY_VARIANT), tlk.SPLAT_CALLS)
    for nu in (None, 256.0):
        got = tlk.render_lighttrace_fast(p, CP, 4, 12, 10, 900, 3, sample_idx=2, bidir_nu=nu)
        want = tlk.splat_records(tlk.light_records_plain(p, CP, 4, 12, 10, 900, 3,
                                                         sample_idx=2, bidir_nu=nu), 12, 10)
        assert torch.equal(got, (want / 900).reshape(10, 12, 3))
    assert tlk.SPLAT_CALLS == before[2] + 4
    assert (tlk.LAUNCH_COUNT, tlk.LAUNCHES_BY_VARIANT) == before[:2]


def test_image_wrapper_refuses_cpu_tables(packed):
    """light_image_cuda does not give way to the plain version: it refuses
    CPU tables as light_records_cuda does, and counts nothing. The launch
    counts are kept per instantiation <SPLAT, BIDIR>."""
    p = packed["caustic"]
    assert len(tlk.LAUNCHES_BY_VARIANT) == 4
    before = (tlk.LAUNCH_COUNT, list(tlk.LAUNCHES_BY_VARIANT), tlk.SPLAT_CALLS)
    for fn in (tlk.light_image_cuda, tlk.light_records_cuda):
        for nu in (None, 64.0):
            with pytest.raises(ValueError, match="CUDA device"):
                fn(p, CP, 0, 8, 8, 64, 2, bidir_nu=nu)
    assert (tlk.LAUNCH_COUNT, tlk.LAUNCHES_BY_VARIANT, tlk.SPLAT_CALLS) == before
