"""The backward kernel's schedule: two flat passes with per-lane path
regeneration (csrc/megakernel_vjp.cuh: backward_pixel) against the nested
loops it replaced (tests/torch_kernel_host.cpp: backward_pixel_nested, a
loop over samples around a replay loop and a reverse loop on the same
per-path functions), both from the host build of the kernel's math (g++, no
FMA contraction; torch_port_helpers.py).

Both schedules must send the same contributions: the multiset of (row,
value) pairs, every nonzero value compared bit for bit; only their order
differs. Held in every grad mode on untextured, color-mapped and
normal-mapped scenes with texel gradients and through the grid, at the
boundaries of the schedule (one sample, bounce caps 1 / 2 / 8, paths that
miss at their first and at a later bounce, a sample offset, a pixel range
past the image, stacks small enough for several rounds). Also: the stack's sizing, and the plain version's tally
of the backward kernel's warp iterations against a count by hand.

The kernel's split schedule (every pixel's replay in one launch, every
pixel's reverse sweep in a second, the stack and each lane's slots in use
kept between them) must send the flat schedule's contributions too: held in
physical mode, through the linear sweeps and the grid, at the same
boundaries; and the wrapper's route rule that picks it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.ops.grid import build_grid
from torch_port_helpers import (backward_rows_hostbuild, jax_textured_quad,
                                port_scene, slot_floats_hostbuild)

CP = camera_arrays(Camera())
MODES = {"linear": {}, "full": dict(full=True), "geo": dict(geo=True),
         "physical": dict(physical=True),
         "physical-geo": dict(physical=True, geo=True)}


def _scene(name):
    """(packed CPU tables, packed grid or None) of a test scene.
    ``shadowed_caustic`` gets a background so that a miss, at the eye ray
    or later, starts the reverse sweep from g * background."""
    if name == "color quad":
        scene = port_scene(jax_textured_quad(tex=True, nmap=False))
    elif name == "cornell grid":
        scene = tpresets.cornell()
    else:
        scene = tpresets.get_scene(name)
    packed = tmk.pack_scene(scene, "cpu")
    if name == "shadowed_caustic":
        packed = dataclasses.replace(packed,
                                     background=torch.tensor([0.3, 0.5, 0.7]))
    grid = tmk.pack_grid(build_grid(scene), "cpu") if name == "cornell grid" else None
    return packed, grid


def _contributions(packed, mode, size=8, spp=3, bounces=8, **kw):
    """{schedule: sorted (rows, value bits)} of one pixel range: the flat
    schedule on the wrapper's stack, the nested one, and the flat one on a
    stack of one path (a round per path), of one path and a slot, and of two
    paths."""
    grid = kw.pop("packed_grid", None)
    g = torch.rand(size * size * 3, generator=torch.Generator().manual_seed(7))
    span = max(bounces, 1)
    n_local = kw.get("n_local")
    if n_local is not None:
        g = g[:3 * n_local]
    tex_grads = packed.textured and not (packed.tex_nmap and not mode)
    runs = {}
    for label, sched, capacity in (
            ("flat", "flat", None), ("nested", "nested", span),
            ("one path per round", "flat", span),
            ("one path and a slot", "flat", span + 1),
            ("two paths per round", "flat", 2 * span)):
        _, rows, vals = backward_rows_hostbuild(
            packed, CP, 5, size, size, spp, bounces, g, tex_grads=tex_grads,
            packed_grid=grid, schedule=sched, capacity=capacity,
            record=True, **MODES[mode], **kw)
        bits = vals.view(np.int32)
        order = np.lexsort((bits, rows))
        runs[label] = (rows[order], bits[order])
    return runs


def _assert_same_multiset(runs):
    want_rows, want_bits = runs["nested"]
    assert want_rows.size > 0
    for label, (rows, bits) in runs.items():
        assert rows.size == want_rows.size, (label, rows.size, want_rows.size)
        assert np.array_equal(rows, want_rows), label
        assert np.array_equal(bits, want_bits), label


@pytest.mark.parametrize("name,mode", [
    (name, mode) for name in ("cornell", "shadowed_caustic", "color quad", "textured",
                              "cornell grid")
    for mode in MODES if not (name == "cornell grid" and "geo" in mode)])
def test_flat_schedule_sends_the_nested_contributions(name, mode):
    """Every scene kind in every grad mode (geo takes no grid): ``textured``
    carries a color and a normal map, both with texel gradients outside
    linear mode (which refuses normal-map texels)."""
    packed, grid = _scene(name)
    _assert_same_multiset(_contributions(packed, mode, packed_grid=grid))


@pytest.mark.parametrize("mode", ["full", "physical"])
@pytest.mark.parametrize("case", [
    dict(spp=1, bounces=1), dict(spp=1, bounces=2), dict(spp=3, bounces=1),
    dict(spp=3, bounces=2), dict(spp=1, bounces=8), dict(sample_offset=9),
    dict(pixel_offset=58, n_local=12), dict(size=12, spp=2)])
def test_flat_schedule_boundaries(mode, case):
    """On ``shadowed_caustic`` with a background (eye rays that miss, paths
    that miss later, glass): one sample, bounce caps 1 / 2 / 8, a sample
    offset, a pixel range that runs past the 8x8 image (its last 8 pixels
    add nothing), a 12x12 image."""
    packed, _ = _scene("shadowed_caustic")
    _assert_same_multiset(_contributions(packed, mode, **case))


def test_boundary_scene_misses_at_the_eye_and_later():
    """``shadowed_caustic`` has both kinds of miss at 8x8: eye rays that
    store nothing and paths that end in a miss after a bounce."""
    packed, _ = _scene("shadowed_caustic")
    first, later = {}, {}
    tmk.render_block_sums_plain(packed, CP, 5, 8, 8, 3, 1, 0, 64, stats=first)
    tmk.render_block_sums_plain(packed, CP, 5, 8, 8, 3, 8, 0, 64, stats=later)
    eye_misses = first["paths"] - first["stored_bounces"]
    assert 0 < eye_misses < first["paths"]
    assert later["path_bounces"] - later["stored_bounces"] > eye_misses


def test_a_pixel_range_past_the_image_adds_nothing():
    packed, _ = _scene("shadowed_caustic")
    g = torch.rand(3 * 8, generator=torch.Generator().manual_seed(3))
    rows, r, _ = backward_rows_hostbuild(packed, CP, 5, 8, 8, 3, 8, g, full=True,
                                         pixel_offset=64, n_local=8, record=True)
    assert r.size == 0 and not rows.any()


def test_slot_floats_match_the_kernel():
    for full in (False, True):
        for physical, geo in ((False, False), (True, False), (False, True), (True, True)):
            if (physical or geo) and not full:
                continue
            for textured, grads, nmap in ((False, False, False), (True, False, False),
                                          (True, True, False), (True, False, True),
                                          (True, True, True)):
                planes = tvjp._st_planes(full, textured, grads, nmap, physical)
                got = tvjp._slot_floats(planes)
                assert got == slot_floats_hostbuild(full, physical, geo, textured, grads,
                                                    nmap)
                assert got % 4 == 0 and planes + tvjp.META_PLANES <= got < planes + 6


def test_stack_slots():
    """One round at cornell 256x256 x 16 spp x 8 bounces in every grad mode
    but linear, which holds LINEAR_PATHS_PER_ROUND paths; within the budget
    and never below one path elsewhere."""
    n = 256 * 256
    for full, physical in ((False, False), (True, False), (True, True)):
        slot = tvjp._slot_floats(tvjp._st_planes(full, physical=physical))
        capacity = tvjp._stack_slots(16, 8, n, slot, full)
        assert capacity == (16 if full else tvjp.LINEAR_PATHS_PER_ROUND) * 8
        assert capacity * slot * 4 * n <= tvjp.SCRATCH_BUDGET
    assert tvjp._stack_slots(4000, 8, n, 40, True) == 8 * (tvjp.SCRATCH_BUDGET
                                                           // (8 * 40 * 4 * n))
    assert tvjp._stack_slots(16, 0, 4, 20, True) == 16
    assert tvjp._stack_slots(16, 0, 4, 20, False) == tvjp.LINEAR_PATHS_PER_ROUND
    assert tvjp._stack_slots(16, 8, 10 ** 9, 84, True) == 8


def test_k2_lane_tally_counts_by_hand():
    """Two warps (40 lanes), two samples, bounce cap 2, a stack of 3 slots:
    a lane holds one path per round whenever its stack keeps fewer than 2
    slots free. Lane 0 stores 2 + 2 bounces (two rounds), lane 1 1 + 0 (an
    eye miss: 1 sweep, nothing stored), lane 33 2 + 1, the rest 1 + 1."""
    tally = tmk._LaneTally(40, 2, 2, 3, "cpu")
    f = [torch.ones(40, dtype=torch.int64) for _ in range(2)]
    r = [torch.ones(40, dtype=torch.int64) for _ in range(2)]
    f[0][0], r[0][0], f[1][0], r[1][0] = 2, 2, 2, 2
    f[1][1], r[1][1] = 1, 0
    f[0][33], r[0][33], f[1][33], r[1][33] = 2, 2, 2, 1
    for s in range(2):
        tally.add(s, 0, f[s], r[s])
    got = tally.counts()
    # K1: regenerating, warp 0's busiest lane makes 4 sweeps, warp 1's 4;
    # nested, per sample the longest path: 2 + 2 and 2 + 2
    assert got["warp_iterations"] == 4 + 4
    assert got["warp_iterations_nested"] == 4 + 4
    assert got["stored_bounces"] == 2 + 2 + 1 + 2 + 1 + 37 * 2
    # K2 nested: per sample and warp the longest replay plus the longest
    # reverse sweep: warp 0 (2 + 2) + (2 + 2), warp 1 (2 + 2) + (2 + 1)
    assert got["k2_warp_iterations_nested"] == 8 + 7
    # K2 flat: warp 0 runs two rounds (lane 0's stack of 3 takes one path of
    # 2 bounces, then has 1 slot free): round 1 lane 0 replays 2 and reverses
    # 2, the others 2 and 2 (1 + 1 each, both samples); round 2 lane 0 2 + 2.
    # Warp 1: lane 33 stores 2, then 1 free slot: a second round of 2 + 1
    assert got["k2_warp_iterations"] == (2 + 2) + (2 + 2) + (2 + 2) + (2 + 1)


def test_k2_lane_tally_of_a_render():
    """The plain render's tally: the identities that hold for any paths."""
    packed, _ = _scene("shadowed_caustic")
    stats = {}
    tmk.render_block_sums_plain(packed, CP, 5, 12, 12, 4, 8, 0, 144, stats=stats)
    work = stats["path_bounces"] + stats["stored_bounces"]
    assert stats["stored_bounces"] <= stats["path_bounces"]
    # one round: no warp takes longer than its nested loops, nor less than
    # its busiest lane's replays and reverse sweeps
    assert stats["warp_iterations"] < stats["k2_warp_iterations"]
    assert stats["k2_warp_iterations"] <= stats["k2_warp_iterations_nested"]
    assert work <= 32 * stats["k2_warp_iterations"]
    # a stack of one path on cornell (every eye ray hits, so every path takes
    # a slot): a round per sample, the nested loops' count
    one = {}
    tmk.render_block_sums_plain(tmk.pack_scene(tpresets.cornell(), "cpu"), CP, 5, 12, 12,
                                4, 8, 0, 144, stats=one, k2_capacity=8)
    assert one["k2_warp_iterations"] == one["k2_warp_iterations_nested"]


def _split_and_flat(packed, size=8, spp=3, bounces=8, **kw):
    """{schedule: sorted (rows, value bits)} of one pixel range in physical
    mode: the flat schedule and the split one, both on a stack of one
    round."""
    grid = kw.pop("packed_grid", None)
    g = torch.rand(size * size * 3, generator=torch.Generator().manual_seed(11))
    n_local = kw.get("n_local")
    if n_local is not None:
        g = g[:3 * n_local]
    runs = {}
    for sched in ("flat", "split"):
        _, rows, vals = backward_rows_hostbuild(
            packed, CP, 5, size, size, spp, bounces, g, physical=True, packed_grid=grid,
            schedule=sched, capacity=max(bounces, 1) * spp, record=True, **kw)
        bits = vals.view(np.int32)
        order = np.lexsort((bits, rows))
        runs[sched] = (rows[order], bits[order])
    return runs


@pytest.mark.parametrize("name", ["cornell", "cornell grid", "shadowed_caustic"])
@pytest.mark.parametrize("case", [
    dict(bounces=1), dict(bounces=2), dict(bounces=8), dict(spp=1, bounces=8),
    dict(sample_offset=9), dict(pixel_offset=58, n_local=12)])
def test_split_schedule_sends_the_flat_contributions(name, case):
    """Physical mode through the linear sweeps and through the grid (``cornell
    grid``): bounce caps 1 / 2 / 8, one sample, a sample offset, a pixel range
    that runs past the 8x8 image; ``shadowed_caustic`` has eye rays that miss
    and paths that miss later. The same multiset of (row, value), every
    nonzero value bit for bit."""
    packed, grid = _scene(name)
    runs = _split_and_flat(packed, packed_grid=grid, **case)
    want_rows, want_bits = runs["flat"]
    rows, bits = runs["split"]
    assert want_rows.size > 0
    assert np.array_equal(rows, want_rows)
    assert np.array_equal(bits, want_bits)


def test_split_schedule_needs_a_stack_of_one_round():
    packed, _ = _scene("cornell")
    g = torch.rand(4 * 4 * 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(AssertionError):
        backward_rows_hostbuild(packed, CP, 5, 4, 4, 3, 8, g, physical=True,
                                schedule="split", capacity=8 * 3 - 1)


@pytest.mark.parametrize("physical,geo,textured,spp,bounces,capacity,split", [
    (True, False, False, 16, 8, 128, True),     # the fit cell: one round
    (True, False, False, 16, 0, 16, True),      # bounce cap 0: a slot a path
    (True, False, False, 2000, 8, 8 * 5, False),  # 800x800: several rounds
    (True, True, False, 16, 8, 128, False),     # physical + geo
    (True, False, True, 16, 8, 128, False),     # textured physical
    (False, False, False, 16, 8, 128, False),   # full
    (False, True, False, 16, 8, 128, False),    # geo
    (False, False, False, 4, 8, 32, False),     # linear, one round
])
def test_split_route_rule(physical, geo, textured, spp, bounces, capacity, split):
    assert tvjp._split_schedule(physical, geo, textured, capacity, spp, bounces) is split


def test_split_route_at_the_wrapper_sizes():
    """Physical mode takes the split at cornell 256x256 x 16 spp x 8 b (one
    round of the wrapper's own stack), and keeps the fused launch at
    800x800 x 2000 spp, where 2 GiB holds a few paths a pixel."""
    slot = tvjp._slot_floats(tvjp._st_planes(True, physical=True))
    for (w, spp, split) in ((256, 16, True), (800, 2000, False)):
        capacity = tvjp._stack_slots(spp, 8, w * w, slot, True)
        assert tvjp._split_schedule(True, False, False, capacity, spp, 8) is split
