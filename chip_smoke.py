#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; without them it exits non-zero and
prints no result. It

1. prints the device and its power limit,
2. builds the CUDA kernels from ``cuda_path_tracer_ss_torch/csrc`` (the
   default ``-fmad=false`` build and the ``-fmad=true`` build, in parallel)
   through the build cache (``utils/compile_cache.py``), then shows the
   cache at work (``[build cache]``): a fresh process loads the four
   libraries with no compiler run, and two fresh processes on one empty
   cache build each library once between them, under the lock,
3. holds the kernel's random numbers bit-equal to ``utils/rng.py``,
4. holds the kernel against its plain PyTorch version on seven scenes, from
   16 primitives to 3000,
5. holds it against goldens made by an independent implementation on a CPU,
6. drives the main path at full size — Cornell box, 800x800, 8 bounces,
   2000 spp through ``ProgressiveRenderer`` — counts the kernel's launches,
   and times the single-launch form beside its registers, resident blocks
   per SM, where its tables live and the lane efficiency of its
   regenerating schedule and of the nested one it replaced,
7. checks that checkpoint / resume is bit-identical,
8. holds the backward kernel's gradients against its plain PyTorch version
   (autograd through the plain render) on five scenes, in grad modes linear
   and full, and runs the same step twice,
9. drives the training path at full size — ``invert`` on Cornell, 256x256,
   16 spp, 8 bounces, 30 Adam steps, once per grad mode — and counts the
   launches of both kernels,
10. times a gradient step and both kernels apart at that size, and prints
    the backward kernel's lane efficiency in its two flat passes and in the
    nested loops they replaced at 16 and 64 spp (``[k2 lanes]``),
11. holds the forward kernel's physical (unbiased MIS) and bidirectional
    instantiations against their plain versions on the seven scenes and
    against goldens, and the light-tracing kernel, with and without the
    bidirectional weights, against its plain version on six scenes: its
    record sink record by record, its image sink against the plain records
    summed,
12. drives the unbiased paths at full size — Cornell 800x800, 8 bounces,
    2000 spp through ``ProgressiveRenderer(physical=True)``;
    ``render_bidir_fast`` on the caustic scene, 512x512, 256 spp + 2,097,152
    light paths, 8 bounces; ``render_lighttrace_fast`` at that path count —
    counts each instantiation's launches (one light-kernel launch of the
    image sink per call, no ``index_add_``) and times them apart: the image
    sink beside the records + ``index_add_`` of all records and of the
    non-empty ones, with the light kernel's registers and the lane
    efficiency of its bounce loop (one path per lane) and of a schedule that
    regenerates paths over the card's resident lanes,
13. the textured path: holds the forward kernel's textured instantiations
    (default, physical, bidir) against their plain versions on four textured
    scenes, drives ``ProgressiveRenderer`` on the ``textured`` preset at
    800x800, 8 bounces, 2000 spp and times single launches, holds the
    backward kernel's textured replay against the plain engine's autograd
    (color- and normal-mapped, linear and full, with and without texel
    gradients), times gradient steps in the reference's textured
    configurations and trains the ``textured`` preset's texels from a grey
    atlas with ``invert``,
14. the accelerated path: holds the forward kernel's grid instantiations
    (default, physical, bidir; untextured and textured) against their plain
    grid versions and against the linear kernel on five scenes and against
    two goldens, the backward kernel through the grid against the plain
    engine and the linear kernel, drives ``ProgressiveRenderer(accel="grid")``
    on Cornell 800x800, 8 bounces, 2000 spp (and the physical and textured
    grid instantiations at 256 spp), times the 10k-primitive matrix (linear
    against grid, ``stress_dense(10000)`` and ``mesh_dense(4)`` at 400x400, 16
    spp, 1 and 8 bounces), trains through the grid, and renders with the
    bfloat16 carries (``state_bf16``) against the float32 image,
15. K2's geo and physical modes: holds them against the plain engine's
    autograd on textured quads, through the grid and on ``stress_dense``
    at 32x32, and at the training step's size (Cornell 256x256, 16 spp, 8
    bounces: geo, physical, both, physical through the grid; a textured
    quad at 128x128), runs each step twice, times gradient steps (forward
    kernel, backward kernel, the rest), runs geo on ``mesh_dense(4)``
    (5,120 triangles: the global-atomics route), fits a textured quad's
    vertices (``[geo train]``, 250 Adam steps) and trains Cornell through
    the physical estimator (``[physical train]``, 30 Adam steps), and
    prints the scratch the backward kernel's checkpoint stacks take on
    every training configuration (``[k2 scratch]``),
16. the eager engine (``render/integrator.py``, the JAX package's jnp
    engine in PyTorch; it launches no kernel): ``ProgressiveRenderer(engine=
    "eager")`` on Cornell 800x800, 8 bounces, 16 spp with and without the
    live-ray cutoff, and 4 spp physical, each held against K1 on the same
    samples (``[eager main path]``); ``live_ray_stats`` and ``cli benchmark
    --engine eager --stats`` (``[eager stats]``); the textured preset against
    textured K1 (``[eager textured]``); the grid walk on ``mesh_dense(4)``
    against the linear sweeps (``[eager grid]``); and autograd through it
    against K2 at the training step's size, with times and peak memory
    (``[eager grad bench]``),
17. light paths on the eager engine (``render/lighttrace.py``,
    ``render_bidir``; no kernel launch): ``render_lighttrace`` on K3's
    configuration with plain and bidirectional weights against K3's image
    sink on the same streams, and on ``textured`` against the CPU (``[eager
    light]``); ``render_bidir`` against ``render_bidir_fast`` and the
    bidirectional golden (``[eager bidir]``); the light-path loss engines'
    steps with their peak memory, the reference's FD probes and emission
    inversion, and the caustic inversion demo where its step times allow
    (``[eager light train]``); ``utils/profiling.trace`` around an eager eye
    bounce, an eager light bounce and one K1 launch, with their kernels,
    device-busy time, idle share and top operations, and ``checked_render``
    (``[trace]``),
17. the silhouette terms (``render/silhouette.py``; the boundary terms launch
    no kernel): ``make_grad_with_boundary`` with K1 + K2's interior gradient
    against the all-eager one (``[silhouette vs eager]``), the reference's
    FD probes on the card (``[silhouette fd]``), ``invert(silhouette=True)``
    on Cornell 256x256, 16 spp, 8 bounces with the step's parts, peak memory
    and one K1 and one K2 launch per step (``[silhouette main path]``), the
    mirror inversion and ``cli invert --silhouette`` (``[silhouette
    invert]``),
18. the multi-device path (``parallel/``, the sharded entries): the main
    paths' configurations — K1 at Cornell 800x800 x 2000 spp (default and
    physical), K2's step at 256x256 x 16 spp (full and physical), K3 and
    ``render_bidir_fast`` at the caustic configuration, the eager engine at
    256x256 x 4 spp — through their sharded entries over a world of one rank
    on NCCL in this process (``[sharded nccl]``) and over four ranks sharing
    the card on gloo (``[sharded x4]``: pixel, path, sample and 2-D meshes),
    each held against its unsharded call (K1's and K2's images bit-equal)
    with both times, its launches counted and the all_reduce timed alone;
    then ``python -m cuda_path_tracer_ss_torch.parallel.dryrun 4 --backend
    gloo``, the reference's certification run (``[dryrun]``, 12 lines),
19. the rest of the shell: ``native.py``'s library built on this machine,
    its five scenes against ``models/presets.py``, its TGA writer and
    tonemap against the Python writer and the device's ``image_u8``
    (``[native]``); ``cli render`` at the main path's configuration as a
    process, its image bit-equal to the main path's, its seconds split
    (``[cli]``); the same render SIGKILLed after its first snapshot and
    resumed to the same bits (``[kill resume]``); ``cli interact`` at
    800x800 fed key lines (``[interact]``); ``cli view``'s server driven
    over HTTP, with passes per second and each pass's parts (``[view]``),
20. prints one JSON line describing every kernel (with the sharded path's
    launches and times beside K1, K2 and K3), then the result line.

Any failed phase raises: the exit code is then non-zero and the result line
is not printed. ``--out-dir DIR`` keeps the rendered PNG and a JSON report.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores (an FMA counted as two operations), and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Float32 operations of the kernel's pieces, counted from
# csrc/megakernel.cuh with every add, multiply, compare, select, sqrt and
# divide as one operation (integer RNG work not counted).
SPHERE_TEST_FLOPS = 32
TRIANGLE_TEST_FLOPS = 60
PER_PATH_FLOPS = 40        # eye ray
PER_BOUNCE_FLOPS = 150     # hit point, cosine, radiance update, scatter
PER_LIGHT_SAMPLE_FLOPS = 60

# The physical estimator, counted the same way: per bounce the lobe
# description, the emission weight and the continuation density on top of
# PER_BOUNCE_FLOPS; per light sample whose lobe terms are non-zero the light's
# geometry, the sampled point, the diffuse lobe terms, the three MIS weights
# and the contribution (a glossy or Cook-Torrance lobe adds 25 / 60 more and
# is not counted). One chain-model evaluation (Fresnel, unit normal, the
# diffuse and one specular label); the bidirectional carries evaluate it
# twice per bounce and once per light sample.
PHYSICAL_BOUNCE_FLOPS = 75
PHYSICAL_LIGHT_SAMPLE_FLOPS = 165
CHAIN_MODEL_FLOPS = 60
BIDIR_CARRY_FLOPS = 25     # per bounce, either side

# The light kernel, counted from csrc/lightkernel.cuh: per path the emission
# vertex (light geometry, point, cosine direction, emitter splat weights);
# per bounce the camera connection (projection, importance, gates, record)
# on top of the sweep and PER_BOUNCE_FLOPS.
EMISSION_VERTEX_FLOPS = 145
CAMERA_CONNECTION_FLOPS = 90

# The reverse sweep of the backward kernel, counted from
# csrc/megakernel_vjp.cuh the same way, per stored bounce: the recurrence and
# its material rows (both modes); in full mode the scatter chain (between 120
# operations on the diffuse branch and 350 on the Cook-Torrance one) and the
# hit chain (90 on a sphere, 150 on a triangle); per visible light sample the
# NEE partials; per path the eye-ray VJP (full mode).
REVERSE_BOUNCE_FLOPS = {"linear": 45, "full": 45 + 150 + 130}
NEE_PARTIAL_FLOPS = {"linear": 40, "full": 75}
EYE_VJP_FLOPS = {"linear": 0, "full": 70}

FULL = dict(width=800, height=800, max_bounces=8, spp=2000)
PLAIN_SPP = 16             # the plain version's share of the full-size work

# The training path: the gradient-bench configuration of the reference.
TRAIN = dict(width=256, height=256, max_bounces=8, spp=16)
TRAIN_FIELDS = {
    "linear": ["materials.diffuse", "al_power"],
    "full": ["materials.diffuse", "al_power", "materials.roughness",
             "materials.ior"],
}
TRAIN_PLAIN_CHUNK = 2      # samples per autograd graph of the plain training step

# The unbiased paths: the physical configuration at the default one's size,
# and the bidirectional configuration of the reference's own measurements.
PHYSICAL_PLAIN_SPP = 8     # the plain version's share of the physical work
BIDIR = dict(scene="caustic", width=512, height=512, max_bounces=8, spp=256,
             n_paths=2_097_152)
BIDIR_PLAIN_SPP = 4        # the plain version's share of the eye half
# The default instantiation's 2000-spp launch and registers before K1 ran
# per-lane path regeneration, with a loop over samples around a loop over
# bounces (PERF.md; NVIDIA H100 80GB HBM3, 700 W)
NESTED_DEFAULT_RANGE_MS = (1195.2, 1211.2)
NESTED_DEFAULT_REGISTERS = 87

# The texture block, counted from csrc/megakernel.cuh the same way: per hit of
# a textured scene the unit normal, the UVs and the tangent (a sphere: the
# polynomial atan2 / asin; a triangle: the barycentric recompute and the UV
# tangent); per bilinear fetch its weights and the 3-channel sum, plus the
# albedo product (color map) or the tangent-frame perturbation (normal map).
TEX_SPHERE_HIT_FLOPS = 75
TEX_TRIANGLE_HIT_FLOPS = 95
COLOR_FETCH_FLOPS = 45
NORMAL_FETCH_FLOPS = 115
# The textured backward kernel adds per stored bounce the albedo split (and
# in full mode the UV swim, 30) and per normal-map hit in full mode the
# perturbation pullback (170).
TEX_REVERSE_FLOPS = {"linear": 15, "full": 45}
NMAP_PULLBACK_FLOPS = 170

# The textured path: the forward at the default one's size; the texture
# scenes of the reference's tests; its textured gradient configurations.
TEX_PLAIN_SPP = 8
TEX_GRAD_BENCH = [  # (scene, size, spp, bounces, fields): docs/PERF.md of the reference
    ("color quad", 64, 8, 2, ["textures", "materials.diffuse"]),
    ("color quad", 128, 8, 2, ["textures", "materials.diffuse"]),
    ("color quad", 192, 8, 2, ["textures", "materials.diffuse"]),
    ("color+normal quad", 128, 16, 4, ["textures", "materials.diffuse", "pl_pos"]),
    ("color+normal quad", 256, 32, 4, ["textures", "materials.diffuse", "pl_pos"]),
]
TEX_TRAIN = dict(width=96, height=96, spp=8, max_bounces=4, steps=40)

# The supercell grid's sweeps, counted from csrc/megakernel.cuh the same way:
# per grid sweep the guarded inverse direction (three safe_inv); per box gate
# (a non-empty box a live ray reaches) the slab test; the primitive tests are
# the plain grid version's tally (grid_sphere_tests / grid_triangle_tests).
GRID_SWEEP_FLOPS = 15
SLAB_TEST_FLOPS = 43
# bfloat16 stores of the six carries per bounce (a rounding and a widening each)
BF16_BOUNCE_FLOPS = 12
# The 10k-primitive matrix (docs/PERF.md of the reference, "10k-primitive
# regime"), uncut: scene, 400x400, 16 spp, bounce caps 1 and 8, linear and grid.
GRID_BENCH = dict(width=400, height=400, spp=16, bounces=(1, 8))
GRID_TALLY = dict(width=64, height=64)   # the plain grid version's share of it
GRID_TRAIN_STEPS = 10

# K2's geo and physical modes (csrc/megakernel_vjp.cuh, the adjoints of
# csrc/megakernel.cuh), counted the same way. Geo adds per triangle hit in
# the reverse sweep the Moller-Trumbore adjoint's edge terms and the 18 rows
# (80), on a textured scene the UVs' vertex terms (60) and per normal-map hit
# the tangent's edge terms (30), and per visible parity light sample the
# light-vertex rows (30). Physical adds per bounce the lobes with both axes
# and their adjoint (the Fresnel term's included, 110) and the pdf chain
# (the continuation density's adjoint and its lobes', 150); per light sample
# the direct phase's adjoint (the contribution, the MIS weights, the diffuse
# lobe's terms and the light direction, 100; the glossy / Cook-Torrance
# lobes' adjoints, 40 / 150, are not counted), and under geo the light
# geometry's adjoint (90).
GEO_TRI_HIT_FLOPS = 80
GEO_UV_VERTEX_FLOPS = 60
GEO_TANGENT_EDGE_FLOPS = 30
GEO_LIGHT_VERTEX_FLOPS = 30
PHYS_REVERSE_BOUNCE_FLOPS = 110 + 150
PHYS_LIGHT_VJP_FLOPS = 100
PHYS_GEO_LIGHT_FLOPS = 90
# The new modes' main paths: their field sets (the reference's tests), the
# mesh the global-atomics route runs on, and the two training demonstrations.
GEO_FIELDS = ["tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
              "materials.diffuse"]
PHYS_FIELDS = ["materials.diffuse", "materials.specular", "materials.emission",
               "materials.absorption", "materials.diff_avg", "materials.spec_avg",
               "materials.ior", "sph_center", "sph_radius"]
GEO_TRAIN = dict(width=128, height=128, spp=4, max_bounces=2, steps=250, lr=0.01,
                 shift=0.45)
PHYS_TRAIN_STEPS = 30

# The eager engine (render/integrator.py): its main path at the default
# configuration's size with spp cut from 2000 to 16 for the script's time
# (passes of 4), the physical estimator at 4 spp, the textured preset, the
# grid walk on a 5,120-triangle mesh, and the training configuration's step.
EAGER = dict(width=800, height=800, max_bounces=8, spp=16, pass_spp=4,
             physical_spp=4)
EAGER_TEX = dict(width=256, height=256, max_bounces=8, spp=4)
EAGER_GRID = dict(width=128, height=128, max_bounces=4, spp=1)
EAGER_CLI_SIZE = 64
# The eager light tracer (render/lighttrace.py; it launches no kernel): K3's
# configuration of [light bench]; textured against the CPU; the eager
# render_bidir at BIDIR's width with spp cut from 256 to 16 for time (nu kept
# at 8192); the light-path training step; the reference's FD probe and
# inversion settings (tests/test_lighttrace.py:149-211, tests/test_bidir.py:
# 85-203); the traced bounces and K1 launch.
EAGER_LIGHT_TEX = dict(width=128, height=128, n_paths=65_536)
EAGER_BIDIR = dict(spp=16, n_paths=131_072)
LIGHT_TRAIN = dict(scene="shadowed_caustic", width=128, height=128, spp=4,
                   max_bounces=6, fields=["materials.emission", "materials.diffuse"])
LIGHT_TRAIN_BIG = dict(width=256, height=256, spp=16, max_bounces=8)
DEMO = dict(width=24, height=24, steps=250, max_bounces=6, limit_s=60.0)
TRACE_K1_SPP = 64
TRACE_BOUNCE = 3
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The silhouette terms (render/silhouette.py): the reference's engine
# comparison and FD probes at their size (tests/test_silhouette.py: 32x32, 96
# spp, 2 bounces, seed 3), the training step at the gradient bench's
# configuration with the reference's boundary defaults, its mirror inversion,
# and cli invert --silhouette.
SIL = dict(width=32, height=32, spp=96, max_bounces=2, seed=3)
SIL_MAIN = dict(width=256, height=256, spp=16, max_bounces=8, steps=3, lr=0.01, shift=0.05,
                fields=["sph_center", "sph_radius", "tri_v0"], step_limit_s=60.0,
                cut=(128, 128))
SIL_INVERT = dict(steps=25, lr=0.05, shift=0.45, max_bounces=3)
SIL_CLI_SIZE = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def match_stats(a: torch.Tensor, b: torch.Tensor):
    """(share of pixels with all channels within rtol 1e-4 / atol 1e-5,
    largest relative gap of the channel means, largest absolute error)."""
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1)
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    mean_gap = float(((ma - mb).abs() / mb.abs().clamp_min(1e-12)).max())
    return float(close.float().mean()), mean_gap, float((a - b).abs().max())


def time_launches(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for k in range(reps):
        fn(k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sweep_flops(counts):
    """(operations of one full sweep, of the cheapest single test)."""
    num_s, num_t = counts[0], counts[1]
    sweep = num_s * SPHERE_TEST_FLOPS + num_t * TRIANGLE_TEST_FLOPS
    one_test = min(SPHERE_TEST_FLOPS if num_s else TRIANGLE_TEST_FLOPS,
                   TRIANGLE_TEST_FLOPS if num_t else SPHERE_TEST_FLOPS)
    return sweep, one_test


def flop_count(counts, stats, scale: float = 1.0, physical: bool = False,
               bidir: bool = False, grid: bool = False) -> float:
    """Least float32 work for the eye paths ``stats`` describes: one full
    sweep per path-bounce, one per unoccluded shadow ray, a single primitive
    test per occluded one, plus the per-path / per-bounce / per-light math of
    the estimator (reference-parity, physical, physical with the
    bidirectional carries). Through the ``grid`` the sweeps are the tests the
    plain grid version tallied, one slab test per box gate and the
    per-sweep setup."""
    per_bounce = PER_BOUNCE_FLOPS + (PHYSICAL_BOUNCE_FLOPS if physical else 0)
    per_light = PHYSICAL_LIGHT_SAMPLE_FLOPS if physical else PER_LIGHT_SAMPLE_FLOPS
    if bidir:
        per_bounce += 2 * CHAIN_MODEL_FLOPS + BIDIR_CARRY_FLOPS
        per_light += CHAIN_MODEL_FLOPS
    if grid:
        sweeps = ((stats["path_bounces"] + stats["shadow_rays"]) * GRID_SWEEP_FLOPS
                  + stats.get("grid_sphere_tests", 0) * SPHERE_TEST_FLOPS
                  + stats.get("grid_triangle_tests", 0) * TRIANGLE_TEST_FLOPS
                  + stats.get("grid_slab_tests", 0) * SLAB_TEST_FLOPS)
    else:
        sweep, one_test = sweep_flops(counts)
        occluded = stats["shadow_rays_occluded"]
        clear = stats["shadow_rays"] - occluded
        sweeps = (stats["path_bounces"] + clear) * sweep + occluded * one_test
    flops = (stats["paths"] * PER_PATH_FLOPS + stats["path_bounces"] * per_bounce
             + stats["shadow_rays"] * per_light + sweeps)
    return flops * scale


def light_flop_count(counts, stats, bidir: bool = False) -> float:
    """Least float32 work for the light paths ``stats`` describes: per path
    the emission vertex, per path-bounce one full sweep, the camera
    connection and the scatter, per visibility ray a full sweep (clear) or a
    single test (occluded)."""
    sweep, one_test = sweep_flops(counts)
    occluded = stats["vis_rays_occluded"]
    clear = stats["vis_rays"] - occluded
    per_bounce = PER_BOUNCE_FLOPS + CAMERA_CONNECTION_FLOPS
    if bidir:
        per_bounce += 2 * CHAIN_MODEL_FLOPS + BIDIR_CARRY_FLOPS
    return (stats["paths"] * EMISSION_VERTEX_FLOPS
            + stats["path_bounces"] * (sweep + per_bounce)
            + clear * sweep + occluded * one_test)


def bound_of(flops: float, moved: float):
    """(bound_ms, 'operations' or 'bytes', ops_ms, bytes_ms) at the card's
    published peaks."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            ops_ms, bytes_ms)


def least_bound(counts, stats, scale: float, moved: float, idx_bytes: float,
                extra_flops: float = 0.0, **kw):
    """(bound, bound of the grid's own work) of a render through the grid.
    The image is the same function whether it sweeps linearly or through
    the grid, so its bound is the smaller of the two ways' bounds: linear
    sweeps over ``moved`` bytes, or the grid's tallied work over ``moved``
    plus its ``idx_bytes``. ``extra_flops`` (already scaled) is work both
    ways do (textures, the backward kernel's reverse sweep)."""
    lin = bound_of(flop_count(counts, stats, scale, **kw) + extra_flops, moved)
    grd = bound_of(flop_count(counts, stats, scale, grid=True, **kw) + extra_flops,
                   moved + idx_bytes)
    return min(lin, grd, key=lambda b: b[0]), grd


def record_match(got, want):
    """Two sets of splat records slot by slot: (share of records with the
    same pixel and every value within rtol 1e-4 / atol 1e-6 of the largest,
    share with the same pixel, largest absolute error among the agreeing
    pixels, the largest value)."""
    big = max(float(x.abs().max()) for x in want[1:])
    same_pix = got[0] == want[0]
    ok = same_pix.clone()
    err = 0.0
    for g, w in zip(got[1:], want[1:]):
        ok &= torch.isclose(g, w, rtol=1e-4, atol=1e-6 * big)
        err = max(err, float(((g - w).abs() * same_pix).max()))
    return float(ok.float().mean()), float(same_pix.float().mean()), err, big


def light_images_agree(got: torch.Tensor, want: torch.Tensor, share: float, n_records: int,
                       big: float, n_paths: int) -> bool:
    """Two light-traced images (divided by ``n_paths``) under the bars of
    tests/test_lighttrace.py:274-277 — mean gap < 1e-5, 99.5 % of pixels
    below 2e-5, largest gap < 2e-3 — where a record whose gate flipped (the
    ``1 - share`` of ``n_records`` that disagree) may move its pixel by its
    own value (at most ``big`` / ``n_paths``)."""
    d = (got - want).abs()
    flipped = round((1.0 - share) * n_records)
    return (bool(torch.isfinite(got).all()) and float(d.mean()) < 1e-5
            and float(d.max()) < 2e-3 + flipped * big / n_paths
            and float((d < 2e-5).float().mean()) > 0.995)


def golden_check(name: str, got: np.ndarray, want: np.ndarray, corr_min=None):
    """A render against a golden made by an independent implementation on a
    CPU: >= 98 % of pixels within rtol 0.02 / atol 2e-3, channel means within
    2 %, and (where asked) the correlation of the agreeing pixels."""
    check(bool(np.isfinite(got).all()), f"golden {name}: non-finite")
    close = np.isclose(got, want, rtol=0.02, atol=2e-3).all(axis=-1)
    mean_ok = np.allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    corr = float(np.corrcoef(got[close].ravel(), want[close].ravel())[0, 1])
    log(f"[golden] {name:20s} {close.mean():.4%} of pixels within "
        f"rtol 0.02 / atol 2e-3, corr {corr:.6f}")
    check(close.mean() >= 0.98, f"golden {name}: {close.mean():.4%} match")
    check(mean_ok, f"golden {name}: channel means off by more than 2 %")
    if corr_min is not None:
        check(corr > corr_min, f"golden {name}: correlation {corr}")


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` single calls of ``fn`` in ms (CUDA events,
    synchronised), after one warm-up call."""
    fn()
    times = [time_launches(lambda k: fn(), 1) for _ in range(reps)]
    return float(np.median(times))


def grad_gap(got: dict, want: dict):
    """Over the fields of two gradient dicts: (worst field, its largest
    error relative to that field's max|g|, largest absolute error, whether
    every field is within rtol 1e-3 / atol 1e-4 * max|g|)."""
    worst, worst_rel, worst_abs, ok = "", 0.0, 0.0, True
    for k, w in want.items():
        g = got[k].to(w.device)
        scale = float(w.abs().max()) + 1e-12
        err = float((g - w).abs().max())
        ok = ok and bool(torch.isfinite(g).all()) and bool(
            ((g - w).abs() <= 1e-4 * scale + 1e-3 * w.abs()).all())
        worst_abs = max(worst_abs, err)
        if err / scale >= worst_rel:
            worst, worst_rel = k, err / scale
    return worst, worst_rel, worst_abs, ok


def texture_flops(stats) -> float:
    """The texture block's float32 work in the paths ``stats`` describes."""
    return (stats.get("tex_sphere_hits", 0) * TEX_SPHERE_HIT_FLOPS
            + stats.get("tex_triangle_hits", 0) * TEX_TRIANGLE_HIT_FLOPS
            + stats.get("color_fetches", 0) * COLOR_FETCH_FLOPS
            + stats.get("normal_fetches", 0) * NORMAL_FETCH_FLOPS)


def eager_phases(dev, cp, mk, inverse, start, target_train) -> dict:
    """The eager engine on the card: its main path (no kernel launch) held
    against K1 on the same samples, the live-ray statistics, the textured
    preset against textured K1, the grid walk against the linear sweeps, and
    autograd through it against K2 at the training step's size."""
    from cuda_path_tracer_ss_torch.models import presets
    from cuda_path_tracer_ss_torch.models.camera import Camera
    from cuda_path_tracer_ss_torch.ops.grid import build_grid
    from cuda_path_tracer_ss_torch.render import integrator
    from cuda_path_tracer_ss_torch.render.renderer import (ProgressiveRenderer,
                                                           RenderConfig)

    out = {}
    w, h, nb = EAGER["width"], EAGER["height"], EAGER["max_bounces"]
    cornell = presets.cornell()
    packed = mk.pack_scene(cornell, dev)

    # ---- [eager main path]: ProgressiveRenderer(engine="eager") ---------------
    def run_renderer(spp, cutoff, physical=False):
        passes = []
        mk.LAUNCH_COUNT = 0   # the count to 0 just before the path ...
        r = ProgressiveRenderer(
            cornell, Camera(),
            RenderConfig(width=w, height=h, max_bounces=nb, spp=spp,
                         samples_per_pass=EAGER["pass_spp"], engine="eager",
                         live_cutoff=cutoff, physical=physical),
            on_pass=passes.append)
        # each bounce step timed between two synchronizations (one pass is one
        # wavefront: 4 samples of 800x800 fit in integrator.WAVE_RAYS)
        integrator.BOUNCE_TIMES = steps = []
        t0 = time.time()
        try:
            r.run()
        finally:
            integrator.BOUNCE_TIMES = None
        total_s = time.time() - t0
        launches = mk.LAUNCH_COUNT   # ... read just after: the eager engine launches none
        img = torch.from_numpy(r.radiance()).to(dev)
        check(launches == 0, f"eager main path launched K1 {launches} times")
        check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(img).all())
              and float(img.min()) >= 0.0, "eager main path: a bad image")
        ms = [p["pass_time_s"] * 1e3 for p in passes]
        steady = float(np.median(ms[1:] if len(ms) > 1 else ms))
        waves = []
        for b, rays, t in steps:
            if b == 0:
                waves.append([])
            waves[-1].append((rays, t))
        check(len(waves) == len(passes), "one wavefront per eager pass")
        waves = waves[1:] if len(waves) > 1 else waves
        per_bounce = []
        for b in range(max(len(wv) for wv in waves)):
            seen = [wv[b] for wv in waves if len(wv) > b]
            per_bounce.append(dict(bounce=b, live_share=seen[0][0] / waves[0][0][0],
                                   ms=float(np.median([t for _, t in seen]))))
        return img, dict(total_s=total_s, pass_ms=ms, ms_per_pass=steady,
                         per_bounce=per_bounce,
                         mrays_per_s=w * h * EAGER["pass_spp"] / steady / 1e3)

    def bounce_text(m):
        return ", ".join(f"b{x['bounce']} {x['live_share']:.3f} {x['ms']:.2f} ms"
                         for x in m["per_bounce"])

    spp = EAGER["spp"]
    for cutoff in (128, None):
        img, m = run_renderer(spp, cutoff)
        out[f"main_cutoff_{cutoff}"] = m
        log(f"[eager main path] cornell {w}x{h} {nb} bounces {spp} spp (cut from 2000 "
            f"for time) in passes of {EAGER['pass_spp']}, live_cutoff={cutoff}: "
            f"{m['mrays_per_s']:.2f} M primary rays/s, {m['ms_per_pass']:.1f} ms per "
            f"pass (median of the passes after the first; all: "
            f"{', '.join(f'{x:.1f}' for x in m['pass_ms'])}), {m['total_s']:.2f} s in "
            f"all; 0 kernel launches. Each bounce of the {EAGER['pass_spp']}-sample "
            f"wavefront (live share entering it, ms, median of the passes after the "
            f"first): {bounce_text(m)}")
    k1 = mk.render_megakernel(packed, cp, 0, w, h, spp, max_bounces=nb)
    rate, gap, err = match_stats(img, k1)
    log(f"[eager main path] live_cutoff=None against K1 on the same samples: "
        f"{rate:.4%} of pixels within rtol 1e-4 / atol 1e-5, channel means "
        f"{gap:.2e} apart, max abs err {err:.2e}")
    check(rate >= 0.995 and gap <= 1e-3, f"eager vs K1: {rate:.4%}, {gap:.2e}")
    out["main_vs_k1"] = dict(match_rate=rate, mean_gap=gap, max_abs_err=err)
    pspp = EAGER["physical_spp"]
    img, m = run_renderer(pspp, None, physical=True)
    k1 = mk.render_megakernel(packed, cp, 0, w, h, pspp, max_bounces=nb, physical=True)
    rate, gap, err = match_stats(img, k1)
    out["physical"] = dict(m, match_rate=rate, mean_gap=gap, max_abs_err=err)
    log(f"[eager main path] physical=True {w}x{h} {nb} bounces {pspp} spp: "
        f"{m['mrays_per_s']:.2f} M primary rays/s, {m['ms_per_pass']:.1f} ms per pass "
        f"(each bounce: {bounce_text(m)}); against K1 physical: {rate:.4%} of pixels, "
        f"means {gap:.2e} apart, max abs err {err:.2e}")
    check(rate >= 0.995 and gap <= 1e-3, f"eager physical vs K1: {rate:.4%}, {gap:.2e}")

    # ---- [eager stats] ------------------------------------------------------------
    fr = integrator.live_ray_stats(cornell, cp, w, h, 0, max_bounces=nb,
                                   device=dev).cpu().numpy()
    log(f"[eager stats] cornell {w}x{h} {nb} bounces, live share entering each "
        f"bounce: {', '.join(f'{f:.4f}' for f in fr)}")
    check(fr[0] == 1.0 and bool(np.all(np.diff(fr) <= 0)), "live fractions")
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_path_tracer_ss_torch.cli", "benchmark",
         "--engine", "eager", "--stats", "--scene", "cornell", "--width",
         str(EAGER_CLI_SIZE), "--height", str(EAGER_CLI_SIZE), "--spp", "4",
         "--bounces", str(nb), "--repeats", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, "cli benchmark --engine eager --stats: " + proc.stderr[-2000:])
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    cli_fr = line["live_ray_fraction_per_bounce"]
    log(f"[eager stats] cli benchmark --engine eager --stats at {EAGER_CLI_SIZE}^2: "
        f"{line['primary_rays_per_s'] / 1e6:.3f} M primary rays/s on {line['device']}, "
        f"fractions {cli_fr}")
    check(line["engine"] == "eager" and cli_fr[0] == 1.0 and line["device"] != "cpu"
          and all(b <= a for a, b in zip(cli_fr, cli_fr[1:])), "cli --stats line")
    out["stats"] = dict(fractions=fr.tolist(), cli=line)

    # ---- [eager textured] ------------------------------------------------------------
    tw_, th_, tnb_, tspp_ = (EAGER_TEX[k] for k in ("width", "height", "max_bounces", "spp"))
    textured = presets.textured()
    tex_dev = textured.to(dev)
    with torch.no_grad():
        eager_t = lambda: integrator.render(tex_dev, cp, tw_, th_, tspp_, 0,  # noqa: E731
                                            max_bounces=tnb_, live_cutoff=None, device=dev)
        img = eager_t()
        ms_e = median_ms(eager_t, reps=3)
    packed_t = mk.pack_scene(textured, dev)
    k1 = mk.render_megakernel(packed_t, cp, 0, tw_, th_, tspp_, max_bounces=tnb_)
    ms_k = median_ms(lambda: mk.render_megakernel(packed_t, cp, 0, tw_, th_, tspp_,
                                                  max_bounces=tnb_), reps=3)
    rate, gap, err = match_stats(img, k1)
    out["textured"] = dict(ms=ms_e, k1_ms=ms_k, match_rate=rate, mean_gap=gap,
                           max_abs_err=err)
    log(f"[eager textured] textured {tw_}x{th_} {tspp_} spp {tnb_} bounces: eager "
        f"{ms_e:.1f} ms, textured K1 {ms_k:.2f} ms; {rate:.4%} of pixels within rtol 1e-4 "
        f"/ atol 1e-5, means {gap:.2e} apart, max abs err {err:.2e}")
    check(rate >= 0.995 and gap <= 1e-3, f"eager textured vs K1: {rate:.4%}, {gap:.2e}")

    # ---- [eager grid] -------------------------------------------------------------
    gw, gh, gnb, gspp = (EAGER_GRID[k] for k in ("width", "height", "max_bounces", "spp"))
    mesh = presets.mesh_dense(4)
    mesh_dev = mesh.to(dev)
    grid = build_grid(mesh).to(dev)
    imgs, times = {}, {}
    # both bounce loops: the scan (live_cutoff=None) and the live cutoff's
    for label, g, cutoff in (("linear", None, None), ("grid", grid, None),
                             ("grid, live_cutoff=0", grid, 0),
                             ("linear, live_cutoff=0", None, 0)):
        with torch.no_grad():
            fn = lambda: integrator.render(mesh_dev, cp, gw, gh, gspp, 0,  # noqa: E731
                                           max_bounces=gnb, live_cutoff=cutoff, grid=g,
                                           device=dev)
            imgs[label] = fn()
            times[label] = median_ms(fn, reps=3)
    same = all(torch.equal(v, imgs["linear"]) for v in imgs.values())
    log(f"[eager grid] mesh_dense(4) ({mesh.num_triangles} triangles, grid "
        f"{grid.res}) {gw}x{gh} {gspp} spp {gnb} bounces: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items())
        + f"; images identical: {same}")
    check(same, "eager grid images differ from the linear one")
    out["grid"] = dict(ms=times, identical=same)

    # ---- [eager grad bench]: autograd through the eager engine against K2 -------------
    tw, th, tnb, tspp = TRAIN["width"], TRAIN["height"], TRAIN["max_bounces"], TRAIN["spp"]
    out["grad"] = {}
    for mode, fields in TRAIN_FIELDS.items():
        params = inverse.extract_params(start, fields)
        res = {}
        for engine in ("eager", "cuda"):
            loss = inverse.make_loss(start, cp, target_train, tw, th, tspp, tnb,
                                     engine=engine, field_names=fields, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            val, grad = inverse.value_and_grad(loss, params, 0)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            ms = median_ms(lambda: inverse.value_and_grad(loss, params, 0))
            res[engine] = dict(val=float(val), grad=grad, ms=ms, peak_bytes=peak)
        e, c = res["eager"], res["cuda"]
        worst, rel, abs_err, ok = grad_gap(e["grad"], c["grad"])
        loss_rel = abs(e["val"] - c["val"]) / abs(c["val"])
        out["grad"][mode] = dict(eager_ms=e["ms"], cuda_ms=c["ms"],
                                 eager_peak_bytes=e["peak_bytes"],
                                 cuda_peak_bytes=c["peak_bytes"], loss_rel=loss_rel,
                                 worst_field=worst, worst_rel=rel, max_abs_err=abs_err)
        log(f"[eager grad bench] cornell {tw}x{th} {tspp} spp {tnb} bounces, {mode} "
            f"({', '.join(fields)}): eager autograd {e['ms']:.1f} ms per value_and_grad "
            f"step (median of 5), peak {e['peak_bytes'] / 1e9:.3f} GB; cuda engine "
            f"(K1 + K2) {c['ms']:.2f} ms, peak {c['peak_bytes'] / 1e9:.3f} GB; "
            f"{e['ms'] / c['ms']:.1f}x. Eager against K2: loss {loss_rel:.2e} apart, "
            f"worst field {worst} {rel:.2e} of its max|g| (abs {abs_err:.2e})")
        check(loss_rel <= 1e-5, f"eager vs cuda loss {mode}: {loss_rel:.2e}")
        check(ok, f"eager autograd vs K2 {mode}: {worst} {rel:.2e}")
    return out


def trace_summary(path: str, window=None, top: int = 5) -> dict:
    """What a ``utils/profiling.trace`` Chrome trace shows on the device:
    the CUDA kernels, the device-busy ms (the union of the device events'
    intervals), the wall ms and the ``top`` operations by device time (a
    device event is named by the aten op that launched it). ``window`` names
    a CPU range (``record_function``): only the device work launched inside
    it counts, and its duration is the wall time."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_EVENT_CATS]
    wall_ms = None
    if window is not None:
        rng_ev = next(e for e in events
                      if e.get("cat") == "user_annotation" and e["name"] == window)
        t0, t1 = rng_ev["ts"], rng_ev["ts"] + rng_ev["dur"]
        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}
        device = [e for e in device if e.get("args", {}).get("correlation") in launched]
        wall_ms = rng_ev["dur"] / 1e3
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    busy, end = 0.0, -1.0
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_op = {}
    for e in device:
        name = ops.get(e.get("args", {}).get("External id"), e["name"][:60])
        by_op[name] = by_op.get(name, 0.0) + e["dur"] / 1e3
    return dict(kernels=sum(e.get("cat") == "kernel" for e in device),
                device_events=len(device), busy_ms=busy / 1e3, wall_ms=wall_ms,
                top=sorted(by_op.items(), key=lambda kv: -kv[1])[:top])


def peak_of(fn, dev):
    """(result, bytes allocated above the start at the peak) of one call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(dev) - base


def eager_light_phases(dev, cp, mk, lk, inverse) -> dict:
    """Light paths on the eager engine (render/lighttrace.py,
    render_bidir; no kernel launch): against K3's image sink and
    render_bidir_fast on the same streams, textured against the CPU, the
    bidirectional golden, the light-path loss engines' steps, FD probes and
    inversion, then the [trace] profiles and checked_render."""
    from cuda_path_tracer_ss_torch.models import presets
    from cuda_path_tracer_ss_torch.render import integrator
    from cuda_path_tracer_ss_torch.render.bidir import render_bidir, render_bidir_fast
    from cuda_path_tracer_ss_torch.render.lighttrace import render_lighttrace
    from cuda_path_tracer_ss_torch.utils import rng

    out = {}
    bw, bh, bnb, n_paths = (BIDIR[k] for k in ("width", "height", "max_bounces", "n_paths"))
    light_seed = rng.seed_for(0, 1)
    caustic = presets.get_scene(BIDIR["scene"])
    caustic_dev = caustic.to(dev)
    packed = mk.pack_scene(caustic, dev)

    def no_launches(fn):
        mk.LAUNCH_COUNT = 0   # the counts to 0 just before the path ...
        lk.LAUNCH_COUNT = 0
        res = fn()
        torch.cuda.synchronize()
        counts = (mk.LAUNCH_COUNT, lk.LAUNCH_COUNT)   # ... read just after
        check(counts == (0, 0), f"the eager light path launched kernels {counts}")
        return res

    # ---- [eager light]: eager render_lighttrace against K3's image sink -----------------
    out["light"] = {}
    for nu in (None, n_paths / BIDIR["spp"]):
        with torch.no_grad():
            def eager():
                return render_lighttrace(caustic_dev, cp, bw, bh, n_paths, light_seed,
                                         max_bounces=bnb, bidir_nu=nu, device=dev)
            img, peak = peak_of(lambda: no_launches(eager), dev)
            ms = median_ms(eager, reps=3)
        k3 = lambda: lk.render_lighttrace_fast(packed, cp, light_seed, bw, bh,  # noqa: E731
                                               n_paths, max_bounces=bnb, bidir_nu=nu)
        want = k3()
        k3_ms = median_ms(k3)
        d = (img - want).abs()
        px_share = float((d.amax(-1) < 2e-5).float().mean())
        ok = (bool(torch.isfinite(img).all()) and float(d.mean()) < 1e-5
              and px_share > 0.995)
        out["light"][str(nu)] = dict(ms=ms, k3_ms=k3_ms, peak_bytes=peak,
                                     mean_gap=float(d.mean()), max_gap=float(d.max()),
                                     share_2e5=px_share)
        log(f"[eager light] {BIDIR['scene']} {bw}x{bh} {bnb} bounces {n_paths} paths, "
            f"nu={nu}: eager render_lighttrace {ms:.1f} ms (median of 3) = "
            f"{n_paths / ms / 1e3:.2f} M paths/s, peak {peak / 1e9:.3f} GB, 0 kernel "
            f"launches; K3's image sink {k3_ms:.3f} ms: {ms / k3_ms:.0f}x. Against K3 on the "
            f"same streams: mean gap {float(d.mean()):.2e}, {px_share:.4%} of pixels "
            f"< 2e-5, max {float(d.max()):.2e} (float atomics on both sides: neither "
            f"image is bit-stable)")
        check(ok, f"eager light nu={nu} against K3: {float(d.mean()):.2e}, {px_share:.4%}")
    tw, th, tn = (EAGER_LIGHT_TEX[k] for k in ("width", "height", "n_paths"))
    textured = presets.textured()
    with torch.no_grad():
        t0 = time.time()
        img = no_launches(lambda: render_lighttrace(textured, cp, tw, th, tn, 0,
                                                    max_bounces=bnb, device=dev))
        card_s = time.time() - t0
        t0 = time.time()
        on_cpu = render_lighttrace(textured, cp, tw, th, tn, 0, max_bounces=bnb,
                                   device="cpu")
        cpu_s = time.time() - t0
    rate, gap, err = match_stats(img.cpu(), on_cpu)
    out["light_textured"] = dict(card_s=card_s, cpu_s=cpu_s, match_rate=rate, mean_gap=gap,
                                 max_abs_err=err)
    log(f"[eager light] textured {tw}x{th} {tn} paths {bnb} bounces (no kernel traces a "
        f"textured scene): card {card_s * 1e3:.1f} ms (first call), CPU {cpu_s:.2f} s; "
        f"{rate:.4%} of pixels within rtol 1e-4 / atol 1e-5, means {gap:.2e} apart, max "
        f"abs err {err:.2e}")
    check(rate >= 0.995 and gap <= 1e-3, f"eager textured light, card vs CPU: {rate:.4%}")

    # ---- [eager bidir]: eager render_bidir against render_bidir_fast -------------------
    espp, en = EAGER_BIDIR["spp"], EAGER_BIDIR["n_paths"]
    nu = en / espp
    with torch.no_grad():
        eager_b = lambda: render_bidir(caustic_dev, cp, bw, bh, espp, en, 0,  # noqa: E731
                                       max_bounces=bnb, device=dev)
        img, peak = peak_of(lambda: no_launches(eager_b), dev)
        eye_ms = median_ms(lambda: integrator.render(
            caustic_dev, cp, bw, bh, espp, 0, max_bounces=bnb, live_cutoff=None,
            physical=True, bidir_nu=nu, device=dev), reps=3)
        light_ms = median_ms(lambda: render_lighttrace(
            caustic_dev, cp, bw, bh, en, light_seed, max_bounces=bnb, bidir_nu=nu,
            device=dev), reps=3)
    fast = lambda: render_bidir_fast(packed, cp, bw, bh, espp, en, 0,  # noqa: E731
                                     max_bounces=bnb)
    want = fast()
    fast_ms = median_ms(fast)
    rate, gap, err = match_stats(img, want)
    out["bidir"] = dict(eye_ms=eye_ms, light_ms=light_ms, fast_ms=fast_ms, peak_bytes=peak,
                        match_rate=rate, mean_gap=gap, max_abs_err=err)
    log(f"[eager bidir] {BIDIR['scene']} {bw}x{bh} {bnb} bounces, {espp} spp (cut from "
        f"{BIDIR['spp']} for time) + {en} light paths (nu {nu:g}, the bench's): eager eye "
        f"half {eye_ms:.1f} ms + light half {light_ms:.1f} ms (medians of 3), peak "
        f"{peak / 1e9:.3f} GB, 0 kernel launches; render_bidir_fast {fast_ms:.2f} ms: "
        f"{(eye_ms + light_ms) / fast_ms:.0f}x. Against it: {rate:.4%} of pixels within "
        f"rtol 1e-4 / atol 1e-5, means {gap:.2e} apart, max abs err {err:.2e}")
    check(rate >= 0.995 and gap <= 1e-3, f"eager bidir vs render_bidir_fast: {rate:.4%}")
    want = torch.from_numpy(np.load(os.path.join(
        GOLDEN, "bidir_shadowed_caustic_16x16_2spp_512p_3b.npy")))
    with torch.no_grad():
        got = render_bidir(presets.shadowed_caustic(), cp, 16, 16, 2, 512, 42,
                           max_bounces=3, device=dev).cpu()
    rate, gap, err = match_stats(got, want)
    log(f"[eager bidir] golden bidir_shadowed_caustic_16x16_2spp_512p_3b: {rate:.4%} of "
        f"pixels within rtol 1e-4 / atol 1e-5, means {gap:.2e} apart, max abs err "
        f"{err:.2e}, {float((got == want).all(-1).float().mean()):.2%} bit-equal")
    check(rate >= 0.995 and gap <= 1e-3, "eager bidir golden on the card")
    out["bidir_golden"] = dict(match_rate=rate, mean_gap=gap, max_abs_err=err)

    # ---- [eager light train] ------------------------------------------------------------
    lt = LIGHT_TRAIN
    lw, lh, lspp, lnb, fields = (lt[k] for k in ("width", "height", "spp", "max_bounces",
                                                 "fields"))
    scene_t = presets.get_scene(lt["scene"])
    params = inverse.extract_params(scene_t, fields)
    brighter = inverse.merge_params(scene_t, {"materials.emission":
                                              params["materials.emission"] * 1.2})
    out["train"] = {}
    for engine in ("lighttrace", "bidir"):
        with torch.no_grad():
            target = (render_lighttrace(brighter, cp, lw, lh, lspp * lw * lh, 1,
                                        max_bounces=lnb, device=dev)
                      if engine == "lighttrace" else
                      render_bidir(brighter, cp, lw, lh, lspp, lspp * lw * lh, 1,
                                   max_bounces=lnb, device=dev))
        loss = inverse.make_loss(scene_t, cp, target, lw, lh, lspp, lnb, engine=engine,
                                 physical=True, device=dev)
        (val, grad), peak = peak_of(lambda: no_launches(
            lambda: inverse.value_and_grad(loss, params, 0)), dev)
        ms = median_ms(lambda: inverse.value_and_grad(loss, params, 0))
        finite = all(bool(torch.isfinite(g).all()) for g in grad.values())
        out["train"][engine] = dict(ms=ms, peak_bytes=peak, loss=float(val))
        log(f"[eager light train] {lt['scene']} {lw}x{lh} {lspp} spp ({lspp * lw * lh} light "
            f"paths) {lnb} bounces, engine={engine}, fields {', '.join(fields)}: "
            f"{ms:.1f} ms per value_and_grad step (median of 5), peak {peak / 1e9:.3f} GB "
            f"(one graph), loss {float(val):.4e}, gradients finite: {finite}")
        check(finite and float(grad["materials.emission"].abs().max()) > 0,
              f"{engine} gradients")
    bw2, bh2, bspp2, bnb2 = (LIGHT_TRAIN_BIG[k] for k in ("width", "height", "spp",
                                                          "max_bounces"))
    loss = inverse.make_loss(scene_t, cp, torch.zeros(bh2, bw2, 3), bw2, bh2, bspp2, bnb2,
                             engine="lighttrace", physical=True, device=dev)
    t0 = time.time()
    (_, grad), peak = peak_of(lambda: inverse.value_and_grad(loss, params, 0), dev)
    big_s = time.time() - t0
    out["train"]["lighttrace_big"] = dict(s=big_s, peak_bytes=peak)
    log(f"[eager light train] lighttrace at {bw2}x{bh2} x {bspp2} spp ({bspp2 * bw2 * bh2} "
        f"light paths) x {bnb2} bounces: one step {big_s * 1e3:.0f} ms (first call), peak "
        f"{peak / 1e9:.3f} GB of the card's 80: one graph per step fits")
    check(all(bool(torch.isfinite(g).all()) for g in grad.values()), "big step gradients")

    lam = presets.cornell_lambert()
    fd_target = render_lighttrace(lam, cp, 12, 12, 2000, 0, max_bounces=3, device=dev) * 0.8
    loss = inverse.make_loss(lam, cp, fd_target, 12, 12, 2, max_bounces=3,
                             engine="lighttrace", physical=True, device=dev)
    ad, fd = inverse.directional_fd_check(
        loss, inverse.extract_params(lam, ("materials.emission",)), 5, eps=1e-2)
    rel = float(np.max(np.abs(ad - fd) / np.abs(fd)))
    log(f"[eager light train] FD probe of tests/test_lighttrace.py:149-168 on the card: "
        f"ad {ad.tolist()}, fd {fd.tolist()}, largest relative gap {rel:.2e} (rtol 2e-3)")
    check(bool(np.allclose(ad, fd, rtol=2e-3, atol=1e-9)), "lighttrace FD probe")
    bfields = ["materials.emission", "materials.diffuse"]
    loss = inverse.make_loss(lam, cp, torch.zeros(12, 12, 3), 12, 12, 2, max_bounces=3,
                             engine="bidir", physical=True, device=dev)
    ad, fd = inverse.directional_fd_check(loss, inverse.extract_params(lam, bfields), 0,
                                          eps=2e-3)
    rel_b = float(np.max(np.abs(ad - fd) / np.abs(fd)))
    log(f"[eager light train] FD probe of tests/test_bidir.py:173-203 on the card: ad "
        f"{ad.tolist()}, fd {fd.tolist()}, largest relative gap {rel_b:.2e} (rtol 0.08)")
    check(bool(np.allclose(ad, fd, rtol=0.08, atol=5e-7)) and np.abs(ad).max() > 1e-7,
          "bidir FD probe")
    p = inverse.extract_params(lam, ("materials.emission",))
    bright = inverse.merge_params(lam, {"materials.emission": p["materials.emission"] * 1.5})
    target = render_lighttrace(bright, cp, 12, 12, 288, 3, max_bounces=3, device=dev)
    t0 = time.time()
    _, got, losses = inverse.invert(lam, cp, target, ("materials.emission",), 12, 12,
                                    spp=2, steps=40, lr=5e-2, seed=3, max_bounces=3,
                                    engine="lighttrace", physical=True, device=dev)
    inv_s = time.time() - t0
    em_err = float((got["materials.emission"] - p["materials.emission"] * 1.5).abs().max())
    log(f"[eager light train] invert(engine='lighttrace') of tests/test_lighttrace.py:"
        f"181-211 (12x12, 2 spp, 3 bounces, 40 Adam steps): loss {losses[0]:.3e} -> "
        f"{losses[-1]:.3e} ({losses[0] / losses[-1]:.0f}x), emission error {em_err:.3f}, "
        f"{inv_s:.2f} s")
    check(losses[-1] < losses[0] / 10 and em_err < 0.2, "lighttrace emission inversion")
    out["invert"] = dict(s=inv_s, loss_ratio=losses[0] / losses[-1], emission_err=em_err,
                         fd_rel=rel, fd_rel_bidir=rel_b)

    # the caustic inversion demo runs here only if its step times allow it
    dw, dh, dnb = DEMO["width"], DEMO["height"], DEMO["max_bounces"]
    sc = presets.shadowed_caustic()
    em = inverse.extract_params(sc, ["materials.emission"])
    with torch.no_grad():
        demo_target = render_bidir(sc, cp, dw, dh, 64, 600_000, 123, max_bounces=dnb,
                                   device=dev)
    step_ms = {}
    for engine, spp in (("bidir", 4), ("eager", 8)):
        loss = inverse.make_loss(sc, cp, demo_target, dw, dh, spp, dnb, engine=engine,
                                 physical=True, device=dev)
        step_ms[engine] = median_ms(lambda: inverse.value_and_grad(loss, em, 0))
    projected = DEMO["steps"] * (step_ms["bidir"] + step_ms["eager"]) / 1e3
    out["demo"] = dict(step_ms=step_ms, projected_s=projected)
    log(f"[eager light train] caustic inversion demo (tests/test_bidir.py:85-131, 2 x "
        f"{DEMO['steps']} steps at {dw}x{dh}): a step takes bidir {step_ms['bidir']:.1f} "
        f"ms, forward {step_ms['eager']:.1f} ms; projected {projected:.1f} s "
        + ("(under the limit: runs now)" if projected < DEMO["limit_s"] else
           f"(over {DEMO['limit_s']:.0f} s: stays a slow test, tests/"
           "test_torch_eager_light_grad.py::test_caustic_inversion_bidir_beats_forward)"))
    if projected < DEMO["limit_s"]:
        em_true = em["materials.emission"]
        li = int(em_true.abs().sum(1).argmax())
        start = inverse.with_field(sc, "materials.emission", em_true * 0.35)
        errs = {}
        t0 = time.time()
        for engine, spp in (("bidir", 4), ("eager", 8)):
            _, pe, _ = inverse.invert(start, cp, demo_target, ["materials.emission"], dw, dh,
                                      spp=spp, steps=DEMO["steps"], lr=0.5,
                                      max_bounces=dnb, seed=0, resample_every=1,
                                      engine=engine, physical=True, device=dev)
            errs[engine] = ((pe["materials.emission"][li] - em_true[li]).abs()
                            / em_true[li]).cpu().numpy()
        eb, ef = errs["bidir"], errs["eager"]
        log(f"[eager light train] demo in {time.time() - t0:.1f} s: relative emission "
            f"error bidir {eb.tolist()}, forward {ef.tolist()}")
        check(eb.max() < 0.35 and ef.min() > 0.6 and eb.max() < 0.5 * ef.min(),
              "caustic inversion demo")
        out["demo"]["errors"] = dict(bidir=eb.tolist(), eager=ef.tolist())
    return out


def trace_phases(dev, cp, mk) -> dict:
    """[trace]: utils/profiling.trace around one eager eye bounce, one eager
    light bounce and one K1 launch; CUDA kernels, device-busy ms against the
    wall, the idle share and the top device operations of each. Traces go
    to chiprun_out/traces/. Then checked_render on the card."""
    from cuda_path_tracer_ss_torch.models import presets
    from cuda_path_tracer_ss_torch.render import integrator
    from cuda_path_tracer_ss_torch.render.lighttrace import render_lighttrace
    from cuda_path_tracer_ss_torch.utils import debug, profiling, rng

    out = {}
    trace_root = os.path.join(ROOT, "chiprun_out", "traces")
    cornell = presets.cornell()
    cornell_dev = cornell.to(dev)
    caustic_dev = presets.get_scene(BIDIR["scene"]).to(dev)
    w, h, nb, pspp = EAGER["width"], EAGER["height"], EAGER["max_bounces"], EAGER["pass_spp"]
    bw, bh, bnb, n_paths = (BIDIR[k] for k in ("width", "height", "max_bounces", "n_paths"))
    b = TRACE_BOUNCE

    def eye():
        return integrator.render(cornell_dev, cp, w, h, pspp, 0, max_bounces=nb,
                                 live_cutoff=None, device=dev)

    def light():
        return render_lighttrace(caustic_dev, cp, bw, bh, n_paths, rng.seed_for(0, 1),
                                 max_bounces=bnb, device=dev)

    packed = mk.pack_scene(cornell, dev)

    def k1():
        return mk.render_megakernel(packed, cp, 0, w, h, TRACE_K1_SPP, max_bounces=nb)

    cases = (("eager eye bounce", eye, f"eye bounce {b}",
              f"cornell {w}x{h}, the {pspp}-spp wavefront, bounce {b}"),
             ("eager light bounce", light, f"light bounce {b}",
              f"{BIDIR['scene']} {bw}x{bh}, {n_paths} paths, bounce {b}"),
             ("K1 launch", k1, None, f"cornell {w}x{h} x {nb} b x {TRACE_K1_SPP} spp"))
    for label, fn, window, what in cases:
        with torch.no_grad():
            fn()                                   # warm, unprofiled
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            log_dir = os.path.join(trace_root, label.replace(" ", "_"))
            with profiling.trace(log_dir):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
        summ = trace_summary(os.path.join(log_dir, profiling.TRACE_FILE), window)
        wall = summ["wall_ms"] if window is not None else traced_ms
        idle = 1.0 - summ["busy_ms"] / wall if wall else float("nan")
        summ.update(call_ms=plain_ms, traced_call_ms=traced_ms, wall_ms=wall, idle_share=idle)
        out[label] = summ
        top = "; ".join(f"{name} {ms:.3f} ms" for name, ms in summ["top"])
        log(f"[trace] {label} ({what}): {summ['kernels']} CUDA kernels "
            f"({summ['device_events']} device events), device busy {summ['busy_ms']:.3f} ms "
            f"of {wall:.3f} ms wall under the profiler: idle share {idle:.1%}; the whole "
            f"call {plain_ms:.1f} ms unprofiled, {traced_ms:.1f} ms profiled. Top device "
            f"operations: {top}")
        check(summ["kernels"] > 0, f"[trace] {label}: no CUDA kernel in the trace")

    torch.cuda.synchronize()
    t0 = time.time()
    img = debug.checked_render(cornell, cp, 64, 64, 1, 0, max_bounces=nb, device=dev)
    torch.cuda.synchronize()
    chk_s = time.time() - t0
    debug.assert_finite({"image": img}, name="checked_render")
    log(f"[trace] checked_render cornell 64x64 x 1 spp x {nb} bounces on the card: no NaN "
        f"in any operation's output, {chk_s:.2f} s")
    out["checked_render_s"] = chk_s
    return out


def silhouette_phases(dev, cp, mk, vjp, inverse) -> dict:
    """The silhouette slice (render/silhouette.py): make_grad_with_boundary
    with K1 + K2's interior gradient against the all-eager one, the
    reference's FD probes on the card, the training step on cornell with
    its four parts, peak memory and launches, the mirror inversion and cli
    invert --silhouette."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_helpers import silhouette_scene
    from cuda_path_tracer_ss_torch.models import presets
    from cuda_path_tracer_ss_torch.models import scene as scene_mod
    from cuda_path_tracer_ss_torch.render import integrator, silhouette

    out = {}
    sw, sh, sspp, snb, seed = (SIL[k] for k in ("width", "height", "spp", "max_bounces",
                                                "seed"))

    def setup(scene, fields, engine="cuda", w=sw, h=sh, fd_spp=sspp, **kw):
        """(value_and_grad, FD loss, params) of the reference's _setup."""
        target = torch.zeros((h, w, 3))
        args = dict(max_bounces=snb, n_sphere=512, n_edge=128, boundary_spp=4)
        args.update(kw)
        vg = silhouette.make_grad_with_boundary(scene, cp, target, fields, w, h, sspp,
                                                engine=engine, device=dev, **args)
        loss = inverse.make_loss(scene, cp, target, w, h, fd_spp, args["max_bounces"],
                                 engine=engine, field_names=fields,
                                 physical=args.get("physical", False), device=dev)
        return vg, loss, inverse.extract_params(scene, fields)

    def fd(loss, params, name, idx, eps):
        p1 = {k: v.clone() for k, v in params.items()}
        p2 = {k: v.clone() for k, v in params.items()}
        p1[name][idx] += eps
        p2[name][idx] -= eps
        with torch.no_grad():
            return (float(loss(p1, seed)) - float(loss(p2, seed))) / (2 * eps)

    def close(a, b, rtol, atol=0.0):
        return abs(a - b) <= atol + rtol * abs(b)

    # ---- [silhouette vs eager] ------------------------------------------------------
    t0 = time.time()
    sphere = silhouette_scene("emissive_sphere", scene_mod)
    fields = ("sph_radius", "sph_center")
    params = inverse.extract_params(sphere, fields)
    kw = dict(max_bounces=snb, n_sphere=256, boundary_spp=4, device=dev)
    vg_k = silhouette.make_grad_with_boundary(sphere, cp, torch.zeros((sh, sw, 3)), fields,
                                              sw, sh, sspp, engine="cuda", **kw)
    vg_e = silhouette.make_grad_with_boundary(sphere, cp, torch.zeros((sh, sw, 3)), fields,
                                              sw, sh, sspp, engine="eager", **kw)
    mk.LAUNCH_COUNT = 0   # every count to 0 just before the path ...
    vjp.LAUNCH_COUNT = 0
    v_k, g_k = vg_k(params, seed)
    torch.cuda.synchronize()
    k_launches = (mk.LAUNCH_COUNT, vjp.LAUNCH_COUNT)   # ... read just after
    v_e, g_e = vg_e(params, seed)
    loss_gap = abs(float(v_k) - float(v_e)) / abs(float(v_e))
    gaps = {}
    for k in fields:
        a, b = g_e[k].cpu().numpy(), g_k[k].cpu().numpy()
        gaps[k] = float(np.max(np.abs(b - a) / (2e-3 * (np.abs(a).max() + 1e-9)
                                                + 1e-2 * np.abs(a))))
    out["vs_eager"] = dict(loss_gap=loss_gap, gaps=gaps, launches=k_launches,
                           g_radius=float(g_k["sph_radius"][0]), s=time.time() - t0)
    log(f"[silhouette vs eager] emissive sphere {sw}x{sh} {sspp} spp {snb} bounces, fields "
        f"{', '.join(fields)}: engine='cuda' (K1 + K2 interior) against engine='eager': loss "
        f"gap {loss_gap:.1e} (rtol 1e-5); gradient gaps in units of the bar (atol 2e-3 "
        f"max|g| + rtol 1e-2; <= 1 passes) {gaps}; d/d radius {float(g_k['sph_radius'][0]):.4f}"
        f"; K1 / K2 launches {k_launches}; {out['vs_eager']['s']:.1f} s")
    check(loss_gap <= 1e-5, f"silhouette vs eager: loss gap {loss_gap:.2e}")
    check(all(v <= 1.0 for v in gaps.values()), f"silhouette vs eager: gradients {gaps}")
    check(k_launches == (1, 1), f"silhouette vs eager: K1 / K2 launches {k_launches}")

    # ---- [silhouette fd]: the reference's FD probes on the card -----------------------
    t0 = time.time()
    probes = []

    def probe(label, got, want, rtol, atol=0.0):
        ok = close(got, want, rtol, atol)
        probes.append(dict(label=label, grad=got, fd=want, rtol=rtol, atol=atol, ok=ok))
        log(f"[silhouette fd] {label}: gradient {got:.5f}, FD {want:.5f} (rtol {rtol}, atol "
            f"{atol:.2e}): {'ok' if ok else 'FAIL'}")

    vg, loss, params = setup(sphere, fields)
    _, g = vg(params, seed)
    g_r = float(g["sph_radius"][0])
    g_c = g["sph_center"].cpu().numpy().reshape(3)
    check(g_r > 0.5, f"sphere radius gradient {g_r}")
    probe("sphere radius (tests/test_silhouette.py:53-73)", g_r,
          fd(loss, params, "sph_radius", 0, 0.03), 0.12)
    probe("sphere depth", float(g_c[2]), fd(loss, params, "sph_center", (0, 2), 0.04), 0.15,
          0.05 * abs(g_r))
    check(abs(g_c[0]) < 0.05 * abs(g_r), f"lateral sphere gradient {g_c[0]}")

    tri = silhouette_scene("triangle", scene_mod)
    vg, loss, params = setup(tri, ("tri_v0", "tri_v1"))
    _, g = vg(params, seed)
    g0, g1 = (g[k].cpu().numpy().reshape(3) for k in ("tri_v0", "tri_v1"))
    scale = max(np.abs(g0).max(), np.abs(g1).max())
    for name, grad in (("tri_v0", g0), ("tri_v1", g1)):
        for axis in (0, 1):
            probe(f"triangle edge {name}[{axis}] (:76-102)", float(grad[axis]),
                  fd(loss, params, name, (0, axis), 0.04), 0.2, 0.06 * scale)

    shadow = silhouette_scene("shadow", scene_mod)
    for physical in (True, False):
        vg, loss, params = setup(shadow, ("sph_center", "sph_radius"), n_sphere=256,
                                 n_phi=128, physical=physical, fd_spp=256)
        _, g = vg(params, seed)
        fd_r = fd(loss, params, "sph_radius", 0, 0.04)
        fd_x = fd(loss, params, "sph_center", (0, 0), 0.05)
        check(abs(fd_r) > 1e-4, f"shadow FD {fd_r}")
        label = "physical" if physical else "parity"
        probe(f"shadow radius, {label} (:199-233)", float(g["sph_radius"][0]), fd_r,
              0.2 if physical else 0.3, 0.1 * abs(fd_r))
        probe(f"shadow lateral, {label}", float(g["sph_center"][0, 0]), fd_x, 0.3,
              0.15 * abs(fd_r))

    mirror = silhouette_scene("mirror_sphere", scene_mod)
    check(silhouette.mirror_triangles(mirror) == (0, 1), "mirror triangles")
    vg, loss, params = setup(mirror, fields, max_bounces=3, n_mirror=256)
    _, g = vg(params, seed)
    g_r = float(g["sph_radius"][0])
    check(g_r > 0.02, f"mirror radius gradient {g_r}")
    fd_r = fd(loss, params, "sph_radius", 0, 0.05)
    probe("mirror-reflected radius (:473-510)", g_r, fd_r, 0.2)
    probe("mirror-reflected lateral", float(g["sph_center"][0, 0]),
          fd(loss, params, "sph_center", (0, 0), 0.06), 0.25, 0.06 * abs(g_r))
    vg_off, _, _ = setup(mirror, fields, max_bounces=3, mirrors=False)
    _, g_off = vg_off(params, seed)
    off = abs(float(g_off["sph_radius"][0]))
    log(f"[silhouette fd] without the mirror families |d/d radius| {off:.5f} (< 0.25 |FD| = "
        f"{0.25 * abs(fd_r):.5f})")
    check(off < 0.25 * abs(fd_r), "mirror counterfactual")
    out["fd"] = dict(probes=probes, s=time.time() - t0)
    log(f"[silhouette fd] {sum(p['ok'] for p in probes)} of {len(probes)} probes within the "
        f"reference's tolerances, {out['fd']['s']:.1f} s")
    check(all(p["ok"] for p in probes), "silhouette FD probes")

    # ---- [silhouette main path]: invert(silhouette=True) on cornell ---------------------
    sm = SIL_MAIN
    cornell = presets.cornell()
    truth = inverse.extract_params(cornell, sm["fields"])
    # the spheres moved off the truth; the triangles' first corners start there
    start = inverse.merge_params(cornell, {k: v + sm["shift"] for k, v in truth.items()
                                           if k.startswith("sph_")})

    class SlowStep(Exception):
        pass

    def main_path(w, h):
        target = mk.render_megakernel(mk.pack_scene(cornell, dev), cp, 0, w, h, sm["spp"],
                                      sm["max_bounces"])
        stamps = []

        def cb(step, val, p):
            torch.cuda.synchronize()
            stamps.append(time.time())
            if step == 0 and stamps[0] - t_start > sm["step_limit_s"] and w > sm["cut"][0]:
                raise SlowStep

        silhouette.STEP_TIMES = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        mk.LAUNCH_COUNT = 0   # every count to 0 just before the path ...
        vjp.LAUNCH_COUNT = 0
        vjp.LAUNCHES_BY_MODE.clear()
        t_start = time.time()
        _, p_out, losses = inverse.invert(
            start, cp, target, sm["fields"], w, h, spp=sm["spp"], steps=sm["steps"],
            lr=sm["lr"], seed=0, max_bounces=sm["max_bounces"], engine="cuda",
            silhouette=True, device=dev, callback=cb)
        torch.cuda.synchronize()
        launches = (mk.LAUNCH_COUNT, vjp.LAUNCH_COUNT, dict(vjp.LAUNCHES_BY_MODE))  # ... after
        peak = torch.cuda.max_memory_allocated(dev) - base
        parts = silhouette.STEP_TIMES
        silhouette.STEP_TIMES = None
        return dict(stamps=[t_start] + stamps, losses=losses, parts=parts, peak=peak,
                    launches=launches, target=target, params=p_out)

    t0 = time.time()
    mw, mh = sm["width"], sm["height"]
    try:
        r = main_path(mw, mh)
    except SlowStep:
        silhouette.STEP_TIMES = None
        log(f"[silhouette main path] the first step at {mw}x{mh} took over "
            f"{sm['step_limit_s']:.0f} s: cut to {sm['cut'][0]}x{sm['cut'][1]}")
        mw, mh = sm["cut"]
        r = main_path(mw, mh)
    n = sm["steps"]
    step_s = np.diff(r["stamps"])
    later = step_s[1:]
    names = ("interior", "adjoint", "detector", "boundary", "shadow")
    med = {k: float(np.median([p[k] for p in r["parts"][1:]])) for k in names}
    first = r["parts"][0]
    k1, k2, by_mode = r["launches"]
    # the boundary terms alone at the last parameters: total - interior
    vg = silhouette.make_grad_with_boundary(start, cp, r["target"], sm["fields"], mw, mh,
                                            sm["spp"], max_bounces=sm["max_bounces"],
                                            engine="cuda", device=dev)
    loss = inverse.make_loss(start, cp, r["target"], mw, mh, sm["spp"], sm["max_bounces"],
                             engine="cuda", field_names=sm["fields"], device=dev)
    _, g_tot = vg(r["params"], 0)
    _, g_int = inverse.value_and_grad(loss, r["params"], 0)
    bnd_r = (g_tot["sph_radius"] - g_int["sph_radius"]).cpu().numpy()
    finite = all(bool(torch.isfinite(g).all()) for g in g_tot.values())
    out["main"] = dict(size=(mw, mh), step_s=step_s.tolist(), median_later_ms=float(
        np.median(later)) * 1e3, parts_median_ms=med, parts_first_ms=first,
        peak_bytes=r["peak"], k1_per_step=k1 / n, k2_per_step=k2 / n, k2_modes=str(by_mode),
        losses=r["losses"], boundary_radius=bnd_r.tolist(), s=time.time() - t0)
    log(f"[silhouette main path] invert(silhouette=True, engine='cuda') cornell {mw}x{mh} "
        f"{sm['spp']} spp {sm['max_bounces']} bounces, fields {', '.join(sm['fields'])} + "
        f"{sm['shift']} (sphere fields), {n} Adam steps (boundary defaults: n_sphere 256, n_edge 64, "
        f"boundary_spp 8, n_phi 64, n_isect 32, n_mirror 32): steps {[f'{t:.2f}' for t in step_s]}"
        f" s; median of the later steps {out['main']['median_later_ms']:.0f} ms = interior "
        f"{med['interior']:.1f} + adjoint image {med['adjoint']:.1f} + detector "
        f"{med['detector']:.1f} + boundary_grad {med['boundary']:.1f} + shadow term "
        f"{med['shadow']:.1f} ms (first step: "
        + ", ".join(f"{k} {v:.0f}" for k, v in first.items())
        + f" ms); peak {r['peak'] / 1e9:.3f} GB; K1 / K2 launches per step {k1 / n:g} / "
        f"{k2 / n:g} ({by_mode}); loss {r['losses'][0]:.4e} -> {r['losses'][-1]:.4e}; boundary"
        f" d/d radius {bnd_r.tolist()}")
    check(k1 == n and k2 == n, f"silhouette main path: K1 / K2 launches {k1} / {k2} for {n} "
          "steps")
    check(by_mode == {("geo", False, False): n}, f"silhouette main path: K2 modes {by_mode}")
    check(finite and all(np.isfinite(r["losses"])), "silhouette main path: non-finite")
    check(bool(np.all(np.isfinite(bnd_r))) and float(np.abs(bnd_r).max()) > 0,
          f"silhouette main path: boundary d/d radius {bnd_r}")

    # ---- [silhouette invert]: the README's mirror inversion, and the CLI -------------
    t0 = time.time()
    si = SIL_INVERT
    target = mk.render_megakernel(mk.pack_scene(mirror, dev), cp, seed, sw, sh, sspp,
                                  si["max_bounces"])
    p0 = inverse.extract_params(mirror, ("sph_center",))
    shifted = p0["sph_center"].clone()
    shifted[0, 0] += si["shift"]
    scene0 = inverse.merge_params(mirror, {"sph_center": shifted})
    _, p_inv, losses = inverse.invert(scene0, cp, target, ("sph_center",), sw, sh, spp=sspp,
                                      steps=si["steps"], lr=si["lr"], seed=seed,
                                      max_bounces=si["max_bounces"], silhouette=True,
                                      engine="cuda", device=dev)
    err = float((p_inv["sph_center"] - p0["sph_center"]).abs().max())
    inv_s = time.time() - t0
    log(f"[silhouette invert] sphere seen only in the mirror (tests/test_silhouette.py:574-599)"
        f", {sw}x{sh} {sspp} spp {si['max_bounces']} bounces, sph_center x + {si['shift']}, "
        f"{si['steps']} Adam steps on engine='cuda': loss {losses[0]:.4e} -> {losses[-1]:.4e} "
        f"({losses[-1] / losses[0]:.3f} of the first, < 0.25), centre error {err:.4f} "
        f"(< 0.12); {inv_s:.1f} s")
    check(losses[-1] < 0.25 * losses[0] and err < 0.12, "silhouette mirror inversion")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_path_tracer_ss_torch.cli", "invert", "--silhouette",
         "--scene", "cornell", "--fields", "sph_radius,sph_center", "--width",
         str(SIL_CLI_SIZE), "--height", str(SIL_CLI_SIZE), "--spp", "8", "--bounces", "4",
         "--steps", "3", "--perturb", "0.05"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    cli_s = time.time() - t0
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"[silhouette invert] cli invert --silhouette cornell {SIL_CLI_SIZE}^2 8 spp 4 bounces,"
        f" 3 steps, as a process on the card: exit {proc.returncode}, {cli_s:.1f} s, last line "
        f"{tail}")
    check(proc.returncode == 0, "cli invert --silhouette: " + proc.stderr[-2000:])
    check(np.isfinite(json.loads(tail)["final_loss"]), "cli invert --silhouette: final loss")
    out["invert"] = dict(losses=(losses[0], losses[-1]), err=err, s=inv_s, cli_s=cli_s)
    return out


# The multi-device path (parallel/ and the sharded entries), at the main
# path's configurations: K1 at FULL (default and physical), K2's step at TRAIN
# (full and physical), K3 and render_bidir_fast at BIDIR, the eager engine at
# 256x256 x 4 spp, each beside its unsharded call. [sharded nccl]: a world of
# one rank over NCCL in this process; [sharded x4]: four ranks sharing the
# card over gloo (NCCL does not put two ranks on one GPU), which measures the
# collective's overhead, not scaling; [dryrun]: the certification run on four
# ranks over gloo.
SHARD_EAGER = dict(width=256, height=256, spp=4, max_bounces=8)
SHARD_RANKS = 4
SHARD_REPS = 3
# kernels-line entry -> the sharded case that runs it
SHARDED_KERNEL_CASES = {
    "render_megakernel": "k1 default", "render_megakernel[physical]": "k1 physical",
    "render_megakernel[bidir]": "bidir fast", "backward_megakernel[full]": "k2 full",
    "backward_megakernel[physical]": "k2 physical",
    "light_image[plain weights]": "k3 plain", "light_image[bidir]": "k3 bidir"}
KERNEL_OF = {"render_megakernel": "K1", "backward_megakernel": "K2", "light_image": "K3"}
DRYRUN_TIMEOUT_S = 600
DRYRUN_LINES = 12


def shard_inputs(dev, cp) -> dict:
    """The sharded phases' scenes and tables, made alike in every process."""
    from cuda_path_tracer_ss_torch.models import presets
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
    from cuda_path_tracer_ss_torch.render import inverse

    cornell = presets.cornell()
    packed = mk.pack_scene(cornell, dev)
    t = TRAIN
    return dict(cornell=cornell, packed=packed,
                caustic=mk.pack_scene(presets.caustic(), dev),
                start=inverse.with_field(cornell, "materials.diffuse",
                                         cornell.materials.diffuse + 0.2),
                target=mk.render_megakernel(packed, cp, 0, t["width"], t["height"],
                                            t["spp"], t["max_bounces"]))


def shard_cases(inp, cp, dev, meshes=None) -> dict:
    """name -> (launches of (K1, K2, K3) one call makes, the call). With
    ``meshes`` (``pixels``, ``paths``, ``samples``, ``2d``) the sharded
    entries, without them the unsharded calls they are held against."""
    from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as lk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as vjp
    from cuda_path_tracer_ss_torch.parallel import sharding
    from cuda_path_tracer_ss_torch.render import bidir, integrator, inverse

    f, t, b, e = FULL, TRAIN, BIDIR, SHARD_EAGER
    nu = b["n_paths"] / b["spp"]
    sharded = meshes is not None
    m = meshes or {}

    def k1(physical):
        if sharded:
            return mk.render_megakernel_sharded(inp["packed"], cp, 0, f["width"], f["height"],
                                                f["spp"], m["pixels"],
                                                max_bounces=f["max_bounces"],
                                                physical=physical)
        return mk.render_megakernel(inp["packed"], cp, 0, f["width"], f["height"], f["spp"],
                                    f["max_bounces"], physical=physical)

    def k2(mode):
        # full mode trains the camera position too: a host tensor beside
        # tables on the card
        fields = TRAIN_FIELDS["full"] if mode == "full" else PHYS_FIELDS
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in inverse.extract_params(inp["start"], fields).items()}
        packed = mk.pack_scene(inverse.merge_params(inp["start"], leaves), dev)
        cam = [torch.as_tensor(np.asarray(v, np.float32)) for v in cp]
        kw = dict(physical=True)
        if mode == "full":
            kw = dict(grad_mode="full")
            leaves["camera position"] = cam[1] = cam[1].clone().requires_grad_(True)
        if sharded:
            img = vjp.render_megakernel_diff_sharded(packed, cam, 0, t["width"], t["height"],
                                                     t["spp"], m["pixels"],
                                                     max_bounces=t["max_bounces"], **kw)
        else:
            img = vjp.render_megakernel_diff(packed, cam, 0, t["width"], t["height"],
                                             t["spp"], max_bounces=t["max_bounces"], **kw)
        loss = torch.mean((img - inp["target"]) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return img.detach(), dict(zip(leaves, grads))

    def k3(bidir_nu):
        args = (inp["caustic"], cp, 0, b["width"], b["height"], b["n_paths"])
        if sharded:
            return lk.render_lighttrace_fast_sharded(*args, m["paths"],
                                                     max_bounces=b["max_bounces"],
                                                     bidir_nu=bidir_nu)
        return lk.render_lighttrace_fast(*args, max_bounces=b["max_bounces"],
                                         bidir_nu=bidir_nu)

    def bidir_fast():
        args = (inp["caustic"], cp, b["width"], b["height"], b["spp"], b["n_paths"], 0)
        if sharded:
            return bidir.render_bidir_fast_sharded(*args, m["pixels"], m["paths"],
                                                   max_bounces=b["max_bounces"])
        return bidir.render_bidir_fast(*args, max_bounces=b["max_bounces"])

    def eager(kind):
        args = (inp["cornell"], cp, e["width"], e["height"], e["spp"], 0)
        kw = dict(max_bounces=e["max_bounces"], live_cutoff=None)
        if not sharded:
            return integrator.render(*args, device=dev, **kw)
        entry = {"pixels": sharding.render_pixel_sharded,
                 "samples": sharding.render_sample_sharded,
                 "2d": sharding.render_2d_sharded}[kind]
        return entry(*args, m[kind], **kw)

    cases = {
        "k1 default": ((1, 0, 0), lambda: k1(False)),
        "k1 physical": ((1, 0, 0), lambda: k1(True)),
        "k2 full": ((1, 1, 0), lambda: k2("full")),
        "k2 physical": ((1, 1, 0), lambda: k2("physical")),
        "k3 plain": ((0, 0, 1), lambda: k3(None)),
        "k3 bidir": ((0, 0, 1), lambda: k3(nu)),
        "bidir fast": ((1, 0, 1), bidir_fast),
        "eager pixels": ((0, 0, 0), lambda: eager("pixels")),
    }
    if not sharded or "samples" in m:
        cases["eager samples"] = ((0, 0, 0), lambda: eager("samples"))
        cases["eager 2d"] = ((0, 0, 0), lambda: eager("2d"))
    return cases


def _launch_counts():
    from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as lk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as vjp

    return mk.LAUNCH_COUNT, vjp.LAUNCH_COUNT, lk.LAUNCH_COUNT


def _zero_launch_counts():
    from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as lk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as vjp

    mk.LAUNCH_COUNT = vjp.LAUNCH_COUNT = lk.LAUNCH_COUNT = 0


def _to_host(x):
    if isinstance(x, tuple):
        return tuple(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x.detach().cpu()


def run_shard_cases(cases, barrier=None) -> dict:
    """Every case once with its launch counts checked (every count to 0 just
    before the call, read just after), then ``SHARD_REPS`` timed calls
    (synchronised; ``barrier`` lines the ranks up before each): name ->
    (result on the host, median ms, launches)."""
    out = {}
    for name, (want, fn) in cases.items():
        _zero_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        got = _launch_counts()
        check(got == want, f"{name}: launches (K1, K2, K3) {got}, expected {want}")
        times = []
        for _ in range(SHARD_REPS):
            if barrier:
                barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = (_to_host(res), float(np.median(times)), got)
    return out


def psum_ms(mesh, axis, dev) -> float:
    """The all_reduce's own time (median of ``SHARD_REPS``) on a zero image
    of K1's main-path size."""
    from cuda_path_tracer_ss_torch.parallel import mesh as pm

    x = torch.zeros((FULL["width"] * FULL["height"], 3), device=dev)
    pm.psum(x, mesh, axis)
    times = []
    for _ in range(SHARD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm.psum(x, mesh, axis)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _x4_rank(rank, out, cp):
    """A rank of [sharded x4]: the sharded cases on four meshes over the four
    ranks sharing the card; rank 0 saves what it got."""
    import torch.distributed as dist
    from cuda_path_tracer_ss_torch.parallel import mesh as pm

    dev = pm.rank_device("cuda")
    inp = shard_inputs(dev, cp)
    meshes = {"pixels": pm.make_mesh(SHARD_RANKS), "paths": pm.make_mesh(
        SHARD_RANKS, axis=pm.PATH_AXIS), "samples": pm.make_mesh(
        SHARD_RANKS, axis=pm.SAMPLE_AXIS), "2d": pm.make_mesh_2d(2, 2)}
    res = run_shard_cases(shard_cases(inp, cp, dev, meshes), barrier=dist.barrier)
    ar = psum_ms(meshes["pixels"], pm.PIXEL_AXIS, dev)
    if rank == 0:
        torch.save({"cases": res, "psum_ms": ar,
                    "backend": dist.get_backend(), "device": str(dev)},
                   os.path.join(out, "x4.pt"))


def compare_shard(name, got, want) -> str:
    """Hold a sharded result against the unsharded one; returns how."""
    if name.startswith("k1") or name == "eager pixels":
        check(torch.equal(got, want), f"{name}: not bit-equal to the unsharded call "
              f"(max abs diff {float((got - want).abs().max()):.3e})")
        return "bit-equal"
    if name.startswith("k2"):
        check(torch.equal(got[0], want[0]), f"{name}: image not bit-equal")
        worst = 0.0
        for k, g in want[1].items():
            ok = bool(((got[1][k] - g).abs() <= 1e-7 + 1e-4 * g.abs()).all())
            worst = max(worst, float(((got[1][k] - g).abs() / (1e-7 + 1e-4 * g.abs())).max()))
            check(ok, f"{name}: gradient {k} outside rtol 1e-4 / atol 1e-7")
        return f"image bit-equal, gradients within rtol 1e-4 / atol 1e-7 (worst at {worst:.3f} of the bar)"
    if name.startswith("k3") or name == "bidir fast":
        d = (got - want).abs()
        check(light_images_agree(got, want, 1.0, 0, 0.0, BIDIR["n_paths"]),
              f"{name}: outside the light bars (mean {float(d.mean()):.2e}, max "
              f"{float(d.max()):.2e})")
        return f"within the light bars (max abs diff {float(d.max()):.2e})"
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
          f"{name}: outside rtol 1e-5 / atol 1e-6 (max abs diff "
          f"{float((got - want).abs().max()):.2e})")
    return f"within rtol 1e-5 / atol 1e-6 (max abs diff {float((got - want).abs().max()):.2e})"


def sharded_phases(dev, cp, smi) -> dict:
    """[sharded nccl], [sharded x4] and [dryrun]."""
    import torch.distributed as dist
    from cuda_path_tracer_ss_torch.parallel import mesh as pm

    report = {"card": smi}
    t_all = time.time()
    inp = shard_inputs(dev, cp)
    ref = run_shard_cases(shard_cases(inp, cp, dev))

    # ---- [sharded nccl]: a world of one rank, this process ----
    t0 = time.time()
    with tempfile.TemporaryDirectory() as rdv:
        pm.initialize_distributed("file://" + os.path.join(rdv, "rendezvous"), 1, 0,
                                  backend="nccl")
        try:
            meshes = {"pixels": pm.make_mesh(1), "paths": pm.make_mesh(1, axis=pm.PATH_AXIS),
                      "samples": pm.make_mesh(1, axis=pm.SAMPLE_AXIS),
                      "2d": pm.make_mesh_2d(1, 1)}
            check(dist.get_backend() == "nccl", "the one-rank world is not on NCCL")
            got = run_shard_cases(shard_cases(inp, cp, dev, meshes))
            ar = psum_ms(meshes["pixels"], pm.PIXEL_AXIS, dev)
        finally:
            dist.destroy_process_group()
    report["nccl"] = {"psum_ms": ar, "s": time.time() - t0, "cases": {}}
    for name, (res, ms, launches) in got.items():
        how = compare_shard(name, res, ref[name][0])
        log(f"[sharded nccl] {name:14s} {ms:9.3f} ms sharded (1 rank) vs {ref[name][1]:9.3f} "
            f"ms unsharded, launches (K1, K2, K3) {launches}: {how}")
        report["nccl"]["cases"][name] = dict(ms=ms, unsharded_ms=ref[name][1],
                                             launches=launches, check=how)
    log(f"[sharded nccl] all_reduce of the {FULL['width']}x{FULL['height']}x3 image over "
        f"one NCCL rank: {ar:.3f} ms; phase {report['nccl']['s']:.1f} s ({smi})")

    # ---- [sharded x4]: four ranks sharing the card, over gloo ----
    t0 = time.time()
    log(f"[sharded x4] {SHARD_RANKS} ranks on cuda:0 over gloo, asked for by name: NCCL "
        "does not put two ranks on one GPU; ranks sharing one card measure the "
        "collective's overhead, not scaling")
    with tempfile.TemporaryDirectory() as out:
        pm.spawn_world(SHARD_RANKS, _x4_rank, out, cp, device_type="cuda", backend="gloo")
        x4 = torch.load(os.path.join(out, "x4.pt"))
    check(x4["backend"] == "gloo", f"[sharded x4] ran over {x4['backend']}")
    report["x4"] = {"psum_ms": x4["psum_ms"], "s": time.time() - t0, "cases": {}}
    for name, (res, ms, launches) in x4["cases"].items():
        how = compare_shard(name, res, ref[name][0])
        log(f"[sharded x4] {name:14s} {ms:9.3f} ms over 4 ranks vs {ref[name][1]:9.3f} ms "
            f"unsharded, rank 0's launches (K1, K2, K3) {launches}: {how}")
        report["x4"]["cases"][name] = dict(ms=ms, unsharded_ms=ref[name][1],
                                           launches=launches, check=how)
    log(f"[sharded x4] all_reduce of the {FULL['width']}x{FULL['height']}x3 image over 4 "
        f"gloo ranks (through the host): {x4['psum_ms']:.3f} ms; phase "
        f"{report['x4']['s']:.1f} s ({smi})")

    # ---- [dryrun]: the certification run, four ranks over gloo ----
    t0 = time.time()
    cmd = [sys.executable, "-m", "cuda_path_tracer_ss_torch.parallel.dryrun",
           str(SHARD_RANKS), "--backend", "gloo"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise
    lines = [ln for ln in stdout.splitlines() if ln.startswith("dryrun_multichip(")]
    for ln in lines:
        log(f"[dryrun] {ln}")
    check(proc.returncode == 0, f"[dryrun] exit {proc.returncode}: {stderr[-2000:]}")
    check(len(lines) == DRYRUN_LINES, f"[dryrun] {len(lines)} lines of {DRYRUN_LINES}")
    report["dryrun"] = {"lines": lines, "s": time.time() - t0}
    report["s"] = time.time() - t_all
    log(f"[dryrun] {len(lines)} steps in {report['dryrun']['s']:.1f} s; the sharded "
        f"phases took {report['s']:.1f} s in all ({smi})")
    return report


# ---- the rest of the shell: the build cache, native.py, the CLI as a process,
# interact and the viewer ----------------------------------------------------------
SHELL_ARGS = ["--scene", "cornell", "--width", str(FULL["width"]), "--height",
              str(FULL["height"]), "--bounces", str(FULL["max_bounces"])]
NATIVE_PRESETS = ("showcase", "cornell", "cornell_empty", "glass", "point_lights")
COLD_BUILD_LIMIT_S = 120.0  # [build] slower than this: no second cold build
PROCESS_TIMEOUT_S = 300
VIEW_WINDOW_S = 5.0
INTERACT_KEYS = "\nw\np\n0\nx\n"
INTERACT_SPP = [4, 8, 4, 4, 8]  # the pass before each key line: w and p reset
TONEMAP_OFF_BY_ONE_SHARE = 1e-5  # host tonemap against the card's, bytes one level off

# a fresh process: import the port, load the libraries named in argv[1] side
# by side (one thread each, as [build] does), print its seconds
_LOAD_ALL = r"""
import json, sys, threading, time
t0 = time.perf_counter()
import cuda_path_tracer_ss_torch
from cuda_path_tracer_ss_torch.utils import build
t1 = time.perf_counter()
errors = []
def one(name, fmad):
    try:
        build.load_kernels(name, fmad=fmad)
    except BaseException as e:
        errors.append(repr(e))
threads = [threading.Thread(target=one, args=tuple(b)) for b in json.loads(sys.argv[1])]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"import_s": t1 - t0, "load_s": time.perf_counter() - t1,
                  "errors": errors}))
sys.exit(1 if errors else 0)
"""


def run_port(args, env=None):
    """(stdout, wall seconds) of ``python args`` from the repository root;
    a non-zero exit fails the phase, a hung process is killed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=PROCESS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"python {' '.join(args[:3])} ... exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout, wall


def build_cache_phase(build, builds, build_s: float, smi: str):
    """[build cache], started right after [build]: a fresh process loads the
    four libraries from the warm cache and no compiler runs; then two fresh
    processes start on an empty cache, to be finished by ``finish_cold_build``
    after the GPU phases (their nvcc runs share the host's cores with those
    phases; the kernels' times are CUDA events)."""
    from cuda_path_tracer_ss_torch.utils import compile_cache

    cache = compile_cache.cache_dir()
    libs = [build._library_path(name, fmad) for name, fmad in builds]
    mtimes = {p: os.stat(p).st_mtime_ns for p in libs}
    logs = {n for n in os.listdir(cache) if n.endswith(".log")}
    spec = json.dumps([list(b) for b in builds])
    out, wall = run_port(["-c", _LOAD_ALL, spec])
    warm = json.loads(out.strip().splitlines()[-1])
    check(all(os.stat(p).st_mtime_ns == t for p, t in mtimes.items()),
          "[build cache] the warm process rewrote a library")
    new_logs = {n for n in os.listdir(cache) if n.endswith(".log")} - logs
    check(not new_logs, f"[build cache] the warm process compiled: {sorted(new_logs)}")
    log(f"[build cache] warm: a fresh process imported the port in {warm['import_s']:.2f} s "
        f"and loaded the four libraries from the cache in {warm['load_s']:.3f} s ({wall:.2f} s "
        f"as a process); no compiler ran (mtimes unchanged, no new log); [build] cold "
        f"{build_s:.1f} s ({smi})")
    report = {"warm": dict(warm, wall_s=wall), "cold_build_s": build_s}
    if build_s > COLD_BUILD_LIMIT_S:
        log(f"[build cache] cold run skipped: [build] took {build_s:.1f} s, over "
            f"{COLD_BUILD_LIMIT_S:.0f} s")
        return report, None
    # two processes on one empty cache, each asking for the four libraries side
    # by side; a stand-in nvcc counts the compiles and runs the real one
    tmp = tempfile.TemporaryDirectory()
    bin_dir = os.path.join(tmp.name, "cuda", "bin")
    os.makedirs(bin_dir)
    count = os.path.join(tmp.name, "compiles")
    nvcc = os.path.join(bin_dir, "nvcc")
    with open(nvcc, "w") as f:
        f.write(f'#!/bin/sh\nif [ "$1" != "--version" ]; then echo compile >> "{count}"; '
                f'fi\nexec "{build.find_nvcc()}" "$@"\n')
    os.chmod(nvcc, 0o755)
    env = dict(os.environ, CUDA_HOME=os.path.dirname(bin_dir),
               **{compile_cache.ENV_DIR: os.path.join(tmp.name, "cache")})
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_ALL, spec], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    atexit.register(_stop, procs)  # should a phase fail before they are read
    return report, (tmp, count, env[compile_cache.ENV_DIR], procs)


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_cold_build(report: dict, pending, smi: str) -> None:
    """The second half of [build cache]: wait for the two cold processes."""
    tmp, count, cache, procs = pending
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=PROCESS_TIMEOUT_S)
            check(p.returncode == 0, f"[build cache] cold process exit {p.returncode}: "
                  f"{stderr[-2000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        _stop(procs)
    waited = time.perf_counter() - t0
    with open(count) as f:
        compiles = len(f.read().splitlines())
    libs = sorted(n for n in os.listdir(cache) if n.endswith(".so"))
    tmp.cleanup()
    check(compiles == 4 and len(libs) == 4,
          f"[build cache] cold: {compiles} compiles and {len(libs)} libraries for 4")
    log(f"[build cache] cold: two fresh processes on one empty CPT_TORCH_BUILD_DIR, each "
        f"asking for the four libraries side by side: {compiles} nvcc runs in all (one per "
        f"library, the other process waited on the lock), import + load "
        f"{outs[0]['import_s']:.2f} + {outs[0]['load_s']:.1f} s and {outs[1]['import_s']:.2f} "
        f"+ {outs[1]['load_s']:.1f} s, beside phases 3-17b of this script (then waited "
        f"{waited:.1f} s for them); [build] {report['cold_build_s']:.1f} s ({smi})")
    report["cold"] = {"processes": outs, "compiles": compiles, "waited_s": waited}


def native_phase(presets, main_rad: np.ndarray, main_u8: np.ndarray, smi: str) -> dict:
    """[native]: libptnative built here, its scenes, tonemap and TGA writer."""
    from cuda_path_tracer_ss_torch import native
    from cuda_path_tracer_ss_torch.models.scene import scene_to_numpy
    from cuda_path_tracer_ss_torch.utils import image as image_io

    t0 = time.perf_counter()
    check(native.available(), "[native] no host C++ compiler on this machine")
    load_s = time.perf_counter() - t0

    def cols(d, names, prefix=""):
        c = [np.asarray(d[prefix + n]) for n in names]
        return np.concatenate([a[:, None] if a.ndim == 1 else a for a in c], -1)

    mats = ("diffuse", "specular", "absorption", "emission", "spec_exp", "ior", "diff_avg",
            "spec_avg", "refr_avg", "roughness")
    for preset in NATIVE_PRESETS:
        got, want = native.build_scene_arrays(preset), scene_to_numpy(presets.get_scene(preset))
        exact = [
            (got["spheres"], cols(want, ("sph_center", "sph_radius"))),
            (got["sph_mat"], want["sph_mat"]), (got["tri_mat"], want["tri_mat"]),
            (got["materials"][:, :18], cols(want, mats, "materials.")),
            (got["flags"], want["materials.flags"]), (got["al_power"], want["al_power"]),
            (got["al_tri0"], want["al_tri0"]),
            (got["point_lights"], cols(want, ("pl_pos", "pl_power")))]
        tri_err = float(np.abs(got["triangles"] - cols(
            want, ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2"))).max(initial=0))
        area_err = float((np.abs(got["al_area"] - want["al_area"])
                          / np.abs(want["al_area"])).max(initial=0))
        check(all(a.shape == b.shape and np.array_equal(a, b) for a, b in exact)
              and tri_err <= 2e-6 and area_err <= 1e-6,
              f"[native] {preset}: the native scene differs from models/presets.py")
        log(f"[native] {preset:13s} {len(got['spheres'])} spheres, {len(got['triangles'])} "
            f"triangles, {len(got['materials'])} materials: equal to models/presets.py "
            f"(triangles max abs err {tri_err:.1e}, al_area max rel err {area_err:.1e})")
    t1 = time.perf_counter()
    host = native.tonemap_u8(main_rad)
    host_ms = (time.perf_counter() - t1) * 1e3
    diff = host.astype(np.int16) - main_u8.astype(np.int16)
    n_diff = int(np.count_nonzero(diff))
    where = [(tuple(int(i) for i in ix), float(main_rad[tuple(ix)]))
             for ix in np.argwhere(diff)[:4]]
    log(f"[native] tonemap_u8 of the [main path] radiance ({host_ms:.1f} ms on the host) "
        f"against the device image_u8: {n_diff} of {diff.size} bytes differ, by at most "
        f"{int(np.abs(diff).max())} (pixel, channel: radiance {where})")
    # the host's powf and the card's differ by an ulp now and then, which moves a
    # value sitting on a rounding boundary by one level
    check(int(np.abs(diff).max()) <= 1 and n_diff <= TONEMAP_OFF_BY_ONE_SHARE * diff.size,
          f"[native] tonemap_u8 differs from image_u8 in {n_diff} bytes")
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "native.tga"), os.path.join(tmp, "python.tga")
        check(native.write_tga(a, main_u8), "[native] write_tga failed")
        image_io.write_tga(b, main_u8)
        with open(a, "rb") as f, open(b, "rb") as g:
            check(f.read() == g.read(), "[native] write_tga differs from utils/image.write_tga")
    log(f"[native] libptnative built here and loaded in {load_s:.2f} s; write_tga of the "
        f"[main path] image byte-equal to utils/image.write_tga ({smi})")
    return {"load_s": load_s, "tonemap_host_ms": host_ms, "tonemap_bytes_differing": n_diff}


def cli_phases(main_rad: np.ndarray, main_s: float, warm: dict, smi: str) -> dict:
    """[cli]: ``cli render`` at the main path's configuration as a process;
    [kill resume]: the same render SIGKILLed after its first snapshot and
    relaunched with --resume until it exits 0."""
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.npy")
        render = ["-m", "cuda_path_tracer_ss_torch.cli", "render", *SHELL_ARGS,
                  "--spp", str(FULL["spp"])]
        stdout, wall = run_port(render + ["--out", out])
        pass_ms = [float(x) for x in re.findall(r"Time per pass: ([0-9.]+) ms", stdout)]
        render_s = sum(pass_ms) / 1e3
        got = np.load(out)
        check(got.shape == main_rad.shape and np.array_equal(got, main_rad),
              "[cli] the CLI's image differs from [main path]'s")
        rest = wall - warm["import_s"] - render_s
        log(f"[cli] python -m cuda_path_tracer_ss_torch.cli render {' '.join(SHELL_ARGS)} "
            f"--spp {FULL['spp']}: {wall:.2f} s as a process, warm cache = import "
            f"~{warm['import_s']:.2f} s ([build cache]'s warm process) + render {render_s:.2f} "
            f"s ({len(pass_ms)} passes, the process's own lines) + the rest {rest:.2f} s "
            f"(CUDA context, library load ~{warm['load_s']:.3f} s for all four, scene, save, "
            f"exit); in process [main path] {main_s:.2f} s; .npy bit-equal ({smi})")
        report["cli"] = {"wall_s": wall, "render_s": render_s, "passes": len(pass_ms),
                         "rest_s": rest, "main_path_s": main_s}

        ck, killed = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "killed.npy")
        argv = [sys.executable, *render, "--out", killed, "--checkpoint", ck,
                "--checkpoint-every", "1"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            while (not os.path.exists(ck) and proc.poll() is None
                   and time.perf_counter() - t0 < PROCESS_TIMEOUT_S):
                time.sleep(0.005)
            snapshot_s = time.perf_counter() - t0
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        killed_rc = proc.returncode
        check(os.path.exists(ck), "[kill resume] no snapshot was written")
        with np.load(ck) as data:
            at = int(data["samples_done"])
        runs = 0
        for runs in range(1, 5):
            done = subprocess.run(argv + ["--resume", ck], cwd=ROOT, capture_output=True,
                                  timeout=PROCESS_TIMEOUT_S).returncode == 0
            if done:
                break
        check(done, "[kill resume] the render never completed")
        whole = time.perf_counter() - t0
        check(np.array_equal(np.load(killed), got),
              "[kill resume] the resumed image differs from the uninterrupted one")
        log(f"[kill resume] the same render with --checkpoint-every 1: SIGKILLed {snapshot_s:.2f}"
            f" s in, after its first snapshot ({at} spp done, exit {killed_rc}), then {runs} "
            f"--resume run(s) to exit 0: {whole:.2f} s in all; .npy bit-equal to the "
            f"uninterrupted [cli] run ({smi})")
        report["kill_resume"] = {"killed_after_s": snapshot_s, "samples_at_kill": at,
                                 "resume_runs": runs, "total_s": whole}
    return report


def interact_phase(mk, smi: str) -> dict:
    """[interact]: ``cli interact`` at 800x800 fed key lines on stdin."""
    import contextlib
    import io

    import cuda_path_tracer_ss_torch.cli as cli
    from cuda_path_tracer_ss_torch.models.camera import Camera

    built = []
    real_build, real_stdin, cwd = cli._build, sys.stdin, os.getcwd()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        cli._build = lambda a: built.append(real_build(a)) or built[0]
        sys.stdin = io.StringIO(INTERACT_KEYS)
        try:
            mk.LAUNCH_COUNT = 0  # every count to 0 just before ...
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(["interact", *SHELL_ARGS, "--spp", str(FULL["spp"]),
                          "--out", "interact.png"])
            s = time.perf_counter() - t0
            launches = mk.LAUNCH_COUNT  # ... and read just after
        finally:
            cli._build, sys.stdin = real_build, real_stdin
            os.chdir(cwd)
        files = sorted(os.listdir(tmp))
    text = buf.getvalue()
    spp = [int(x) for x in re.findall(r"spp=(\d+) ", text)]
    for line in ("camera moved (w); accumulation reset", "ray-trace mode", "wrote interact.png"):
        check(line in text, f"[interact] no line {line!r} in {text!r}")
    check(spp == INTERACT_SPP, f"[interact] passes at spp {spp}, expected {INTERACT_SPP}")
    check(launches == len(spp), f"[interact] {launches} K1 launches for {len(spp)} passes")
    check(len(files) == 2 and "interact.png" in files
          and re.fullmatch(r"render\d{4}-\d\d-\d\d-\d{6}\.png", files[1 - files.index(
              "interact.png")]) is not None, f"[interact] files written: {files}")
    moved = Camera()
    moved.move("w")
    cam = built[0].camera
    check(np.array_equal(cam.position, moved.position)
          and np.array_equal(cam.rotation, moved.rotation),
          "[interact] the camera after w differs from Camera().move('w')")
    log(f"[interact] cli interact {' '.join(SHELL_ARGS)} fed {INTERACT_KEYS!r}: passes at "
        f"spp {spp}, {launches} K1 launches, the expected lines, the screenshot and --out "
        f"written, camera after w = Camera().move('w'); {s:.2f} s in process ({smi})")
    return {"s": s, "launches": launches, "spp": spp}


def view_phase(mk, smi: str) -> dict:
    """[view]: ``cli view``'s serve at cornell 800x800 x 8 bounces on a free
    port, driven over HTTP; passes per second and the pass's parts."""
    import socket
    import urllib.request

    import cuda_path_tracer_ss_torch.cli as cli
    from cuda_path_tracer_ss_torch import viewer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.read()

    def stats():
        return json.loads(get("/stats"))

    def wait(cond, timeout=60.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if errors:
                raise errors[0]  # the viewer's thread failed
            try:
                st = stats()
                if cond(st["spp"]):
                    return st
            except OSError:
                pass  # the server is not up yet
            time.sleep(0.02)
        raise RuntimeError("chip_smoke check failed: [view] the viewer never got there")

    holder, errors = {}, []
    real_serve = viewer.serve
    viewer.serve = lambda r, port: real_serve(r, port=port, state_out=holder)

    def run():
        try:
            cli.main(["view", *SHELL_ARGS, "--port", str(port)])
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    mk.LAUNCH_COUNT = 0  # every count to 0 just before ...
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        wait(lambda spp: spp >= 1)
        page = get("/")
        check(b"progressive view" in page and b"PyTorch/CUDA (cuda" in page,
              "[view] the page does not name the port")
        check(get("/frame.png")[:8] == b"\x89PNG\r\n\x1a\n", "[view] /frame.png is no PNG")
        state = holder["state"]
        with state.lock:
            n0, t0 = len(state.pass_seconds), time.perf_counter()
        time.sleep(VIEW_WINDOW_S)
        with state.lock:
            n1, t1 = len(state.pass_seconds), time.perf_counter()
        rate = (n1 - n0) / (t1 - t0)
        before = stats()["spp"]
        check(get("/key?k=w") == b"ok", "[view] /key did not answer ok")
        after = wait(lambda spp: spp < before, timeout=30.0)["spp"]
    finally:
        if "state" in holder:
            holder["state"].stop = True
        thread.join(timeout=60)
        viewer.serve = real_serve
    check(not thread.is_alive(), "[view] the render loop did not stop")
    if errors:
        raise errors[0]
    launches = mk.LAUNCH_COUNT  # ... and read just after
    parts = np.asarray(state.pass_seconds)[1:] * 1e3  # the first pass warms up
    check(len(parts) + 1 < viewer.TIMING_WINDOW, "[view] more passes than the window holds")
    check(launches == len(parts) + 1, f"[view] {launches} K1 launches for {len(parts) + 1} "
          "passes")
    med = np.median(parts, axis=0)
    log(f"[view] cli view's serve on port {port}: /, /stats, /frame.png served; w reset the "
        f"accumulation ({before} -> {after} spp); {rate:.2f} passes/s over "
        f"{VIEW_WINDOW_S:.0f} s; median per pass {med[0]:.2f} ms K1 pass (step, 4 spp) + "
        f"{med[1]:.2f} ms image_u8 (tonemap + copy) + {med[2]:.2f} ms encode_png; "
        f"{launches} K1 launches for {launches} passes; stopped cleanly ({smi})")
    return {"passes_per_s": rate, "median_ms": {"step": med[0], "image_u8": med[1],
                                                 "encode_png": med[2]},
            "passes": launches, "reset": [before, after]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="keep the rendered PNG and a JSON report here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the GPU and does not run "
              "without one", file=sys.stderr)
        return 1

    from cuda_path_tracer_ss_torch.models import presets
    from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
    from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as lk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as vjp
    from cuda_path_tracer_ss_torch.render import inverse
    from cuda_path_tracer_ss_torch.render.bidir import render_bidir_fast
    from cuda_path_tracer_ss_torch.render.renderer import (ProgressiveRenderer,
                                                           RenderConfig)
    from cuda_path_tracer_ss_torch.utils import build, rng

    t_start = time.time()
    report = {}
    dev = torch.device("cuda", 0)
    cp = camera_arrays(Camera())

    # ---- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device 0: {kind}")
    log(smi)
    report["device"] = {"kind": kind, "nvidia_smi": smi}

    # ---- 2. build (one nvcc per source and variant, all started together) ----
    t0 = time.time()
    errors = []

    def build_one(name, fmad):
        try:
            build.load_kernels(name, fmad=fmad)
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    builds = (("megakernel", False), ("megakernel", True),
              ("megakernel_vjp", False), ("lightkernel", False))
    threads = [threading.Thread(target=build_one, args=a) for a in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    build_s = time.time() - t0
    log(f"[build] nvcc sm_90a: forward kernel (-fmad=false and -fmad=true), "
        f"backward kernel and light kernel (-fmad=false), four builds side by "
        f"side: {build_s:.1f} s")
    report["build_s"] = build_s
    report["ptxas"] = {}
    for name, fmad in builds:
        for k in build.ptxas_report(name, fmad):
            # a template's bool arguments read Lb0E / Lb1E in the mangled name
            fn = next(f for f in ("render_kernel", "backward_kernel", "light_kernel",
                                  "uniform_pairs_kernel") if f in k["kernel"])
            bools = re.findall(r"Lb([01])E", k["kernel"].split(fn)[1].split("Ev")[0])
            label = f"{fn}<{','.join(bools)}>" if bools else fn
            log(f"[build] {name}{' -fmad=true' if fmad else ''}: {label}: "
                f"{k['registers']} registers, {k['stack']} B stack, spills "
                f"{k['spill_stores']} B stored / {k['spill_loads']} B loaded")
            report["ptxas"][f"{name}{'_fmad' if fmad else ''}/{label}"] = k
            check(k["spill_stores"] == 0 and k["spill_loads"] == 0,
                  f"{label} spills registers")

    # ---- 2b. the build cache: warm in a fresh process; cold beside phases 3-17b ----
    cache_report, cold = build_cache_phase(build, builds, build_s, smi)

    # ---- 3. rng: the kernel's uniform_pair, bit-equal to utils/rng.py --------
    g = np.random.default_rng(0)
    n = 1 << 16
    words = [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                              .astype(np.int32)).to(dev) for _ in range(4)]
    words[3][: n // 2] = torch.arange(n // 2, dtype=torch.int32, device=dev) % 64
    k0, k1 = mk.uniform_pairs_cuda(*words)
    p0, p1 = rng.uniform_pair(*words)
    torch.cuda.synchronize()
    check(torch.equal(k0, p0) and torch.equal(k1, p1),
          "kernel uniform_pair differs from utils/rng.py")
    check(float(k0.min()) >= 0.0 and float(k0.max()) < 1.0, "uniforms outside [0,1)")
    log(f"[rng] {n} (seed, pixel, sample, pair) words incl. negatives: bit-equal")

    # ---- 4. kernel vs plain ---------------------------------------------------
    # the last two scenes hold thousands of primitives (spheres, then triangles)
    scenes = {
        "cornell": (presets.cornell, 16), "showcase": (presets.showcase, 16),
        "point_lights": (presets.point_light_spheres, 16),
        "stress": (presets.stress, 16), "glass": (presets.glass_showcase, 16),
        "stress_dense": (lambda: presets.stress_dense(3000), 4),
        "mesh_dense": (lambda: presets.mesh_dense(3), 4),
    }
    W = H = 64
    report["kernel_vs_plain"] = {}
    for name, (make, n_spp) in scenes.items():
        packed = mk.pack_scene(make(), dev)
        variants = [("base", dict(pixel_offset=0, n_local=W * H))]
        if name in ("cornell", "showcase"):
            variants += [
                ("sample_offset=37", dict(pixel_offset=0, n_local=W * H, sample_offset=37)),
                ("sample_clamp=1", dict(pixel_offset=0, n_local=W * H, sample_clamp=1.0)),
                ("tile 1000+1500", dict(pixel_offset=1000, n_local=1500)),
            ]
        for label, kw in variants:
            plain = mk.render_block_sums_plain(packed, cp, 7, W, H, n_spp, 6, **kw) / n_spp
            rates = {}
            for fmad in (True, False):
                got = mk.render_block_sums_cuda(packed, cp, 7, W, H, n_spp, 6,
                                                fmad=fmad, **kw) / n_spp
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite")
                rates[fmad] = match_stats(got, plain)
            rate, gap, err = rates[False]
            log(f"[kernel vs plain] {name:12s} {label:16s} fmad=false: "
                f"{rate:.4%} of pixels, mean gap {gap:.2e}, max abs err {err:.2e}"
                f" | fmad=true: {rates[True][0]:.4%}, mean gap {rates[True][1]:.2e}")
            check(rate >= 0.995, f"{name} {label}: only {rate:.4%} of pixels match")
            check(gap <= 1e-3, f"{name} {label}: channel means differ by {gap:.2e}")
            if label == "sample_clamp=1":
                check(float(got.max()) <= 1.0 + 1e-6, "clamped render above 1")
            report["kernel_vs_plain"][f"{name}/{label}"] = {
                "fmad_false": rates[False], "fmad_true": rates[True]}

    # ---- 5. goldens made by an independent implementation on a CPU -----------
    for name, make, spp, bounces in (
            ("cornell", presets.cornell, 16, 6),
            ("showcase", presets.showcase, 16, 8),
            ("point_light_spheres", presets.point_light_spheres, 16, 6),
            ("stress", presets.stress, 8, 6)):
        want = np.load(os.path.join(GOLDEN, f"tpu_{name}_64x64_{spp}spp_{bounces}b.npy"))
        got = mk.render_fast2(make(), cp, 64, 64, spp, 7, max_bounces=bounces,
                              device=dev).cpu().numpy()
        golden_check(name, got, want, corr_min=0.999)

    # ---- 6. main path at full size ----------------------------------------------
    w, h, nb, spp = FULL["width"], FULL["height"], FULL["max_bounces"], FULL["spp"]
    out_dir_ctx = tempfile.TemporaryDirectory()
    work_dir = out_dir_ctx.name
    passes = []
    mk.LAUNCH_COUNT = 0  # every count to 0 just before the main path
    r = ProgressiveRenderer(
        presets.cornell(), Camera(),
        RenderConfig(width=w, height=h, max_bounces=nb, spp=spp, engine="cuda"),
        on_pass=passes.append)
    t0 = time.time()
    r.run()
    main_s = time.time() - t0
    png = os.path.join(work_dir, "cornell_800.png")
    r.save(png)
    launches = mk.LAUNCH_COUNT  # ... and read just after
    main_rad, main_u8 = r.radiance(), r.image_u8()
    main_img = torch.from_numpy(main_rad).to(dev)
    check(os.path.getsize(png) > 1000, "PNG not written")
    check(launches == len(passes) and launches > 0,
          f"{launches} kernel launches for {len(passes)} passes")
    check(tuple(main_img.shape) == (h, w, 3), "wrong image shape")
    check(bool(torch.isfinite(main_img).all()) and float(main_img.min()) >= 0.0,
          "main-path image not finite and non-negative")
    rays = w * h * spp
    log(f"[main path] ProgressiveRenderer cornell {w}x{h} {nb} bounces {spp} spp: "
        f"{len(passes)} passes {[m['pass_samples'] for m in passes]}, "
        f"{launches} kernel launches, {main_s:.2f} s, "
        f"{rays / main_s / 1e6:.1f} M primary rays/s")

    # plain version at the same width, another sample window
    packed = mk.pack_scene(presets.cornell(), dev)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.time()
    plain = mk.render_megakernel_plain(packed, cp, 0, w, h, PLAIN_SPP, nb,
                                       sample_offset=spp, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    same = mk.render_megakernel(packed, cp, 0, w, h, PLAIN_SPP, nb, sample_offset=spp)
    same_fmad = (mk.render_block_sums_cuda(packed, cp, 0, w, h, PLAIN_SPP, nb, 0, w * h,
                                           sample_offset=spp, fmad=True)
                 / PLAIN_SPP).reshape(h, w, 3)
    torch.cuda.synchronize()
    rate, gap, max_abs_err = match_stats(same, plain)
    rate_f, gap_f, err_f = match_stats(same_fmad, plain)
    _, main_gap, _ = match_stats(main_img, plain)
    bounces_per_path = stats["path_bounces"] / stats["paths"]
    log(f"[main path] kernel vs plain at {w}x{h} {PLAIN_SPP} spp (same samples): "
        f"fmad=false {rate:.4%} of pixels, max abs err {max_abs_err:.2e}; "
        f"fmad=true {rate_f:.4%}, max abs err {err_f:.2e}")
    log(f"[main path] 2000-spp means vs plain {PLAIN_SPP}-spp means: gap {main_gap:.3%}; "
        f"plain version {plain_ms:.0f} ms; {bounces_per_path:.3f} bounces per path, "
        f"{stats['shadow_rays'] / stats['paths']:.3f} shadow rays per path "
        f"({stats['shadow_rays_occluded'] / max(stats['shadow_rays'], 1):.1%} occluded)")
    check(rate >= 0.995 and gap <= 1e-3, "kernel disagrees with plain at full width")
    check(main_gap <= 0.02, f"main-path means {main_gap:.3%} from the plain version's")

    # bench form: pack once, ONE launch, warm-up + 2 timed repeats
    def launch(fmad, n_spp):
        def fn(k):
            mk.render_block_sums_cuda(packed, cp, 0, w, h, n_spp, nb, 0, w * h,
                                      sample_offset=(k + 1) * n_spp, fmad=fmad)
        return fn

    bench_spp = spp
    warm_ms = time_launches(launch(False, bench_spp), 1)
    note = ""
    if warm_ms > 60e3:
        bench_spp = 256
        note = " (one 2000-spp launch exceeded 60 s: timed 256 spp instead)"
        time_launches(launch(False, bench_spp), 1)
    ms = time_launches(launch(False, bench_spp), 2)
    time_launches(launch(True, bench_spp), 1)
    ms_fmad = time_launches(launch(True, bench_spp), 2)
    ms_plain_shape = time_launches(launch(False, PLAIN_SPP), 3)
    bench_rays = w * h * bench_spp
    log(f"[bench] cornell {w}x{h} {nb} bounces {bench_spp} spp, one launch{note}: "
        f"fmad=false {ms:.1f} ms = {bench_rays / ms / 1e3:.1f} M primary rays/s; "
        f"fmad=true {ms_fmad:.1f} ms = {bench_rays / ms_fmad / 1e3:.1f} M primary rays/s; "
        f"{PLAIN_SPP}-spp launch {ms_plain_shape:.2f} ms")
    # what the launch got, and the lane efficiency (live bounces over 32 x
    # the warps' loop iterations) of K1's regenerating schedule and of the
    # nested one it replaced, on the plain version's tally at PLAIN_SPP
    occ = mk.render_occupancy(packed)
    eff = {k: stats["path_bounces"] / (32 * stats[k])
           for k in ("warp_iterations", "warp_iterations_nested")}
    log(f"[bench] default instantiation: {ms:.1f} ms, {occ['registers']} registers, "
        f"{occ['blocks_per_sm']} resident blocks of 128 per SM, small tables "
        + (f"in shared memory ({occ['smem_bytes']} B per block)" if occ["smem_bytes"]
           else "in global memory")
        + f"; lane efficiency at {PLAIN_SPP} spp: regenerating "
        f"{eff['warp_iterations']:.3f}, nested {eff['warp_iterations_nested']:.3f} "
        f"({stats['warp_iterations_nested'] / stats['warp_iterations']:.2f}x the warp "
        f"iterations); before per-lane regeneration {NESTED_DEFAULT_RANGE_MS[0]:.1f}-"
        f"{NESTED_DEFAULT_RANGE_MS[1]:.1f} ms and {NESTED_DEFAULT_REGISTERS} registers "
        f"(PERF.md): {ms / NESTED_DEFAULT_RANGE_MS[1]:.3f}-{ms / NESTED_DEFAULT_RANGE_MS[0]:.3f}"
        " of it")
    report["bench_default"] = {"ms": ms, **occ, "lane_efficiency": eff}

    # bound: this run's operation count (the plain version's tally over
    # PLAIN_SPP samples, scaled to the timed sample count) over the FP32 peak,
    # against the bytes moved (tables in, 12 bytes per pixel out)
    flops = flop_count(packed.counts, stats, bench_spp / PLAIN_SPP)
    moved = packed.table_bytes + 12 * w * h
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"[bound] {flops:.3e} float32 operations -> {ops_ms:.2f} ms at "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s; {moved} bytes -> {bytes_ms:.4f} ms; "
        f"kernel at {bound_ms / ms:.1%} of its bound")

    # ---- 7. resume ---------------------------------------------------------------
    def small(total):
        rr = ProgressiveRenderer(presets.cornell(), Camera(),
                                 RenderConfig(width=64, height=64, max_bounces=6,
                                              spp=total, seed=3, engine="cuda"))
        return rr

    whole = small(28)
    whole.run()
    first = small(28)
    first.run(12)
    ck = os.path.join(work_dir, "resume.npz")
    first.checkpoint(ck)
    second = small(28)
    second.restore(ck)
    second.run()
    check(second._samples_done == 28, "resume did not reach 28 spp")
    check(np.array_equal(whole.radiance(), second.radiance()),
          "checkpoint/resume is not bit-identical")
    log("[resume] 64x64: 12 spp + checkpoint + restore + 16 spp == 28 spp, bit-identical")

    # ---- 8. backward kernel vs its plain version ---------------------------------
    def scene_fields(scene, mode):
        names = (vjp.PALLAS_TRAINABLE_FIELDS_FULL if mode == "full"
                 else vjp.PALLAS_TRAINABLE_FIELDS)
        have = {"al_power": scene.num_area_lights, "pl_power": scene.num_point_lights,
                "pl_pos": scene.num_point_lights, "sph_center": scene.num_spheres,
                "sph_radius": scene.num_spheres}
        return sorted(n for n in names if have.get(n, 1))

    def both_engines(scene, fields, target, w, h, n_spp, nb, seed, accel="none",
                     physical=False):
        out = []
        for engine in ("cuda", "plain"):
            loss = inverse.make_loss(scene, cp, target, w, h, n_spp, nb, engine=engine,
                                     field_names=fields, device=dev, accel=accel,
                                     physical=physical)
            out.append(inverse.value_and_grad(loss, inverse.extract_params(scene, fields),
                                              seed))
        return out

    gw = gh = 32
    g = torch.Generator().manual_seed(11)
    # a random target makes the loss's cotangent 2 (img - target) / N a random image
    rand_target = torch.rand((gh, gw, 3), generator=g)
    report["vjp_kernel_vs_plain"] = {}
    # stress_dense: 4 rows per sphere exceed a block's shared-memory rows, so its
    # full mode takes the backward kernel's global-atomics route
    for name, make in (("cornell", presets.cornell), ("showcase", presets.showcase),
                       ("point_light_spheres", presets.point_light_spheres),
                       ("stress", presets.stress),
                       ("stress_dense", lambda: presets.stress_dense(3000))):
        scene = make()
        for mode in ("linear", "full"):
            fields = scene_fields(scene, mode)
            (v_k, g_k), (v_p, g_p) = both_engines(scene, fields, rand_target, gw, gh, 2, 4, 5)
            torch.cuda.synchronize()
            worst, rel, _, ok = grad_gap(g_k, g_p)
            loss_gap = abs(float(v_k) - float(v_p)) / abs(float(v_p))
            log(f"[vjp kernel vs plain] {name:20s} {mode:6s} {len(fields):2d} fields: loss gap "
                f"{loss_gap:.1e}; worst field {worst} at {rel:.2e} of its max|g|")
            check(loss_gap <= 1e-5, f"vjp {name} {mode}: loss differs by {loss_gap:.2e}")
            check(ok, f"vjp {name} {mode}: {worst} off by {rel:.2e} of max|g|")
            report["vjp_kernel_vs_plain"][f"{name}/{mode}"] = {"worst": worst, "rel": rel}

    # the camera's gradients (full mode), straight through render_megakernel_diff
    cam_grads = []
    cot = torch.rand((gh, gw, 3), generator=g).to(dev)
    packed_small = mk.pack_scene(presets.cornell(), dev)
    for render in (vjp.render_megakernel_diff, vjp.render_megakernel_diff_plain):
        cam_t = [torch.tensor(np.asarray(v, np.float32), device=dev, requires_grad=True)
                 for v in cp]
        img = render(packed_small, cam_t, 5, gw, gh, 2, 4)
        cam_grads.append(dict(zip(("rot", "pos", "tan_half", "z_near"),
                                  torch.autograd.grad((img * cot).sum(), cam_t,
                                                      allow_unused=True))))
    cam_grads[1]["z_near"] = torch.zeros_like(cam_grads[0]["z_near"])  # structurally ~0
    worst, rel, _, ok = grad_gap(*cam_grads)
    log(f"[vjp kernel vs plain] cornell camera (rot, pos, tan_half): worst {worst} at "
        f"{rel:.2e} of its max|g|")
    check(ok, f"vjp camera: {worst} off by {rel:.2e} of max|g|")

    # ---- 8b. the same step twice ------------------------------------------------
    tw, th, tnb, tspp = TRAIN["width"], TRAIN["height"], TRAIN["max_bounces"], TRAIN["spp"]
    cornell = presets.cornell()
    packed_train = mk.pack_scene(cornell, dev)
    target_train = mk.render_megakernel(packed_train, cp, 0, tw, th, tspp, tnb)
    truth = cornell.materials.diffuse
    start = inverse.with_field(cornell, "materials.diffuse", truth + 0.2)
    determinism = {}
    for mode, fields in TRAIN_FIELDS.items():
        loss = inverse.make_loss(start, cp, target_train, tw, th, tspp, tnb, engine="cuda",
                                 field_names=fields)
        check(loss.grad_mode == mode, f"make_loss picked {loss.grad_mode} for {fields}")
        params = inverse.extract_params(start, fields)
        (v1, g1), (v2, g2) = (inverse.value_and_grad(loss, params, 0) for _ in range(2))
        torch.cuda.synchronize()
        _, rel, _, _ = grad_gap(g1, g2)
        determinism[mode] = rel
        check(float(v1) == float(v2), "the forward render differs between two runs")
        check(rel <= 1e-4, f"two runs of one {mode} step differ by {rel:.2e} of max|g|")
    log(f"[vjp determinism] cornell {tw}x{th} {tspp} spp {tnb} bounces, the same step twice: "
        f"largest difference {determinism['linear']:.2e} (linear), "
        f"{determinism['full']:.2e} (full) of a field's max|g|; losses bit-equal")

    # ---- 9. the training path at full size -----------------------------------------
    train = {}
    lit = cornell.materials.diff_avg > 0   # materials whose diffuse colour is ever used
    for mode, fields in TRAIN_FIELDS.items():
        stamps = []           # host time after each step (the step reads its loss: a sync)
        mk.LAUNCH_COUNT = 0   # every count to 0 just before the path ...
        vjp.LAUNCH_COUNT = 0
        t0 = time.time()
        _, params, losses = inverse.invert(
            start, cp, target_train, fields, tw, th, spp=tspp, steps=30, lr=0.02, seed=0,
            max_bounces=tnb, engine="cuda",
            callback=lambda step, val, p: stamps.append(time.time()))
        torch.cuda.synchronize()
        train[mode] = dict(k1=mk.LAUNCH_COUNT, k2=vjp.LAUNCH_COUNT,  # ... read just after
                           first_step_s=stamps[0] - t0,
                           ms_per_step=(stamps[-1] - stamps[0]) / 29 * 1e3)
        err = (params["materials.diffuse"] - truth).abs()[lit].max()
        log(f"[train] invert cornell {tw}x{th} {tspp} spp {tnb} bounces, {mode} "
            f"({', '.join(fields)}), diffuse + 0.2, 30 Adam steps: loss {losses[0]:.3e} -> "
            f"{losses[-1]:.3e} ({losses[-1] / losses[0]:.3f} of the first), max|diffuse - "
            f"truth| 0.2 -> {float(err):.4f} on the diffusely scattering materials; first "
            f"step {train[mode]['first_step_s']:.2f} s (the optimizer's first use included), "
            f"then {train[mode]['ms_per_step']:.2f} ms per step; {train[mode]['k1']} forward "
            f"and {train[mode]['k2']} backward launches")
        check(all(np.isfinite(losses)), f"train {mode}: non-finite loss")
        check(losses[-1] < 0.1 * losses[0], f"train {mode}: loss only fell to "
              f"{losses[-1] / losses[0]:.3f} of its first value")
        check(float(err) < 0.2, f"train {mode}: max|diffuse - truth| did not shrink")
        check(train[mode]["k1"] == 30 and train[mode]["k2"] == 30,
              f"train {mode}: {train[mode]['k1']} forward and {train[mode]['k2']} backward "
              "launches for 30 steps")
        check(all(bool(torch.isfinite(v).all()) for v in params.values()),
              f"train {mode}: non-finite parameters")

    # ---- 10. a gradient step, and both kernels apart --------------------------------
    bench = {}
    g_img = torch.rand((th, tw, 3), generator=g).to(dev)
    n_train = tw * th
    ms_k1 = median_ms(lambda: mk.render_block_sums_cuda(packed_train, cp, 0, tw, th, tspp,
                                                        tnb, 0, n_train))
    for mode, fields in TRAIN_FIELDS.items():
        full = mode == "full"
        loss = inverse.make_loss(start, cp, target_train, tw, th, tspp, tnb, engine="cuda",
                                 field_names=fields)
        params = inverse.extract_params(start, fields)
        ms_step = median_ms(lambda: inverse.value_and_grad(loss, params, 0))
        ms_k2 = median_ms(lambda: vjp.backward_rows_cuda(packed_train, cp, 0, tw, th, tspp,
                                                         tnb, g_img, full=full))
        # the stacks this launch allocated (megakernel_vjp.py: LAST_STACK)
        bench[mode] = dict(ms_step=ms_step, ms=ms_k2, loss=loss,
                           scratch_bytes=4 * vjp.LAST_STACK[1])
        rays = n_train * tspp
        log(f"[grad bench] cornell {tw}x{th} {tspp} spp {tnb} bounces, {mode} "
            f"({len(fields)} fields): value_and_grad step {ms_step:.2f} ms = "
            f"{rays / ms_step / 1e3:.1f} M primary rays/s (forward + backward); forward "
            f"kernel {ms_k1:.2f} ms, backward kernel {ms_k2:.2f} ms, the rest (pack, host, "
            f"loss, autograd) {ms_step - ms_k1 - ms_k2:.2f} ms")

    def plain_step_in_chunks(fields, packed_grid=None, scene=None, target=None,
                             physical=False, dims=None):
        """``value_and_grad`` of the plain engine's loss on the training step's
        inputs (or ``scene`` / ``target`` at ``dims`` = (width, height, spp,
        bounces)), all samples, taken TRAIN_PLAIN_CHUNK at a time so that
        autograd holds one chunk's graph at once: the first pass renders the
        image, the second sends the loss's cotangent through every chunk
        (through ``packed_grid``'s sweeps when given; ``physical`` the
        unbiased estimator; triangle fields in grad mode geo)."""
        scene = start if scene is None else scene
        target = target_train if target is None else target
        c_w, c_h, c_spp, c_nb = (tw, th, tspp, tnb) if dims is None else dims
        grad_mode = "geo" if set(fields) & vjp.TRI_FIELDS else "full"
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in inverse.extract_params(scene, fields).items()}
        offsets = range(0, c_spp, TRAIN_PLAIN_CHUNK)

        def chunk_image(offset):
            packed = mk.pack_scene(inverse.merge_params(scene, leaves), dev)
            return vjp.render_megakernel_diff_plain(packed, cp, 0, c_w, c_h,
                                                    TRAIN_PLAIN_CHUNK, c_nb,
                                                    sample_offset=offset,
                                                    grad_mode=grad_mode,
                                                    packed_grid=packed_grid,
                                                    physical=physical)

        with torch.no_grad():
            img = sum(chunk_image(o) for o in offsets) / len(offsets)
        residual = img - target
        cot = 2.0 * residual / residual.numel() / len(offsets)
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        for o in offsets:
            got = torch.autograd.grad((chunk_image(o) * cot).sum(), list(leaves.values()))
            for k, d in zip(grads, got):
                grads[k] += d
        return torch.mean(residual ** 2), grads

    # the plain version on the training step's own inputs: its time, and the
    # kernels' loss and gradients against it
    stats_t = {}
    mk.render_megakernel_plain(packed_train, cp, 0, tw, th, tspp, tnb, stats=stats_t)
    for mode, fields in TRAIN_FIELDS.items():
        v_k, g_k = inverse.value_and_grad(bench[mode].pop("loss"),
                                          inverse.extract_params(start, fields), 0)
        torch.cuda.synchronize()
        t0 = time.time()
        v_p, g_p = plain_step_in_chunks(fields)
        torch.cuda.synchronize()
        worst, rel, abs_err, ok = grad_gap(g_k, g_p)
        bench[mode].update(plain_ms=(time.time() - t0) * 1e3, max_abs_err=abs_err)
        log(f"[grad bench] kernels vs plain at {tw}x{th} {tspp} spp, {mode}: worst "
            f"field {worst} at {rel:.2e} of its max|g| (max abs err {abs_err:.2e}); plain "
            f"value_and_grad step, {TRAIN_PLAIN_CHUNK} samples at a time, "
            f"{bench[mode]['plain_ms']:.0f} ms")
        check(ok, f"grad bench {mode}: {worst} off by {rel:.2e} of max|g| at full size")
        check(abs(float(v_k) - float(v_p)) <= 1e-5 * abs(float(v_p)),
              f"grad bench {mode}: losses differ ({float(v_k)} vs {float(v_p)})")

        # bound: the replay is one forward render; the reverse sweep adds per stored
        # bounce (the plain version's tally of the sweeps that hit), per
        # visible light sample and per path. Bytes the function must move:
        # tables and cotangent in, rows out. The checkpoints (written once,
        # read once) are this kernel's own traffic: their time at the memory
        # rate is printed apart and is no part of the bound.
        visible = stats_t["shadow_rays"] - stats_t["shadow_rays_occluded"]
        flops = (flop_count(packed_train.counts, stats_t)
                 + stats_t["stored_bounces"] * REVERSE_BOUNCE_FLOPS[mode]
                 + visible * NEE_PARTIAL_FLOPS[mode]
                 + stats_t["paths"] * EYE_VJP_FLOPS[mode])
        planes = vjp.ST_PLANES_FULL if mode == "full" else vjp.ST_PLANES
        rows = vjp._grad_rows(packed_train.counts, mode == "full")
        moved = packed_train.table_bytes + 12 * n_train + 4 * rows
        scratch = 2 * 4 * planes * stats_t["stored_bounces"]
        k2_ops_ms = flops / PEAK_FP32_FLOPS * 1e3
        k2_bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
        bench[mode].update(bound_ms=max(k2_ops_ms, k2_bytes_ms),
                           bound_by="operations" if k2_ops_ms >= k2_bytes_ms else "bytes",
                           scratch_bytes_ms=scratch / PEAK_BYTES_PER_S * 1e3)
        log(f"[bound] backward kernel, {mode}: {flops:.3e} float32 operations -> "
            f"{k2_ops_ms:.3f} ms at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s; {moved} bytes "
            f"in and out -> {k2_bytes_ms:.4f} ms; kernel at "
            f"{bench[mode]['bound_ms'] / bench[mode]['ms']:.1%} of its bound. Its "
            f"checkpoints ({planes * 4} B per stored bounce, written and read once: "
            f"{scratch:.3e} bytes) would take {bench[mode]['scratch_bytes_ms']:.3f} ms "
            "at the memory rate")

    # K2's lane efficiency (live bounces of both passes over 32 x the warps'
    # loop iterations) in its two flat passes and in the nested loops they
    # replaced, on the plain version's tally of the training step's paths, with
    # the stack the wrapper gives full mode at 16 and at 64 spp
    k2_lanes = {}
    full_slot = vjp._slot_floats(vjp.ST_PLANES_FULL)
    for n_spp in (tspp, 4 * tspp):
        capacity = vjp._stack_slots(n_spp, tnb, n_train, full_slot, True)
        st = stats_t
        if n_spp != tspp:
            st = {}
            mk.render_block_sums_plain(packed_train, cp, 0, tw, th, n_spp, tnb, 0, n_train,
                                       stats=st, k2_capacity=capacity)
        work = st["path_bounces"] + st["stored_bounces"]
        k2_eff = {k: work / (32 * st[k]) for k in ("k2_warp_iterations",
                                                   "k2_warp_iterations_nested")}
        k2_lanes[n_spp] = dict(k2_eff, capacity=capacity)
        log(f"[k2 lanes] cornell {tw}x{th} {n_spp} spp {tnb} bounces, stack of {capacity} "
            f"slots: {st['path_bounces'] / st['paths']:.3f} sweeps and "
            f"{st['stored_bounces'] / st['paths']:.3f} stored bounces per path; lane "
            f"efficiency two flat passes {k2_eff['k2_warp_iterations']:.3f}, nested "
            f"{k2_eff['k2_warp_iterations_nested']:.3f} "
            f"({st['k2_warp_iterations_nested'] / st['k2_warp_iterations']:.2f}x the warp "
            "iterations)")
    report["k2_lanes"] = k2_lanes

    # ---- 11. the unbiased instantiations against their plain versions ----------------
    VARIANTS = {"physical": dict(physical=True),
                "bidir": dict(physical=True, bidir_nu=64.0)}
    report["variant_vs_plain"] = {}
    for name, (make, n_spp) in scenes.items():
        packed_s = mk.pack_scene(make(), dev)
        for label, kw in VARIANTS.items():
            plain_v = mk.render_block_sums_plain(packed_s, cp, 7, W, H, n_spp, 6, 0, W * H,
                                                 **kw) / n_spp
            got = mk.render_block_sums_cuda(packed_s, cp, 7, W, H, n_spp, 6, 0, W * H,
                                            **kw) / n_spp
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{label} {name}: non-finite")
            rate_v, gap_v, err_v = match_stats(got, plain_v)
            log(f"[{label} kernel vs plain] {name:12s}: {rate_v:.4%} of pixels, mean gap "
                f"{gap_v:.2e}, max abs err {err_v:.2e}")
            check(rate_v >= 0.995, f"{label} {name}: only {rate_v:.4%} of pixels match")
            check(gap_v <= 1e-3, f"{label} {name}: channel means differ by {gap_v:.2e}")
            report["variant_vs_plain"][f"{name}/{label}"] = (rate_v, gap_v, err_v)

    golden_check("physical cornell",
                 mk.render_fast2(presets.cornell(), cp, 64, 64, 16, 7, max_bounces=6,
                                 physical=True, device=dev).cpu().numpy(),
                 np.load(os.path.join(GOLDEN, "tpu_physical_cornell_64x64_16spp_6b.npy")),
                 corr_min=0.999)
    golden_check("bidir shadowed_caustic",
                 render_bidir_fast(mk.pack_scene(presets.shadowed_caustic(), dev), cp,
                                   16, 16, 2, 512, 42, max_bounces=3).cpu().numpy(),
                 np.load(os.path.join(GOLDEN,
                                      "bidir_shadowed_caustic_16x16_2spp_512p_3b.npy")))

    # the light kernel's records, slot by slot, then the image they sum to
    LW = LH = 64
    L_PATHS = 100_000
    report["light_vs_plain"] = {}
    for name in ("cornell_lambert", "caustic", "shadowed_caustic", "cornell", "showcase",
                 "point_lights"):
        packed_s = mk.pack_scene(presets.get_scene(name), dev)
        for nu in (None, 512.0):
            want = lk.light_records_plain(packed_s, cp, 3, LW, LH, L_PATHS, 6, bidir_nu=nu)
            got = lk.light_records_cuda(packed_s, cp, 3, LW, LH, L_PATHS, 6, bidir_nu=nu)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(x).all()) for x in got[1:]),
                  f"light {name} nu={nu}: non-finite records")
            share, same_pix, err_l, big = record_match(got, want)
            img_k = lk.splat_records(got, LW, LH) / L_PATHS
            img_p = lk.splat_records(want, LW, LH) / L_PATHS
            d = (img_k - img_p).abs()
            log(f"[light kernel vs plain] {name:16s} nu={nu}: {share:.4%} of {got[0].numel()} "
                f"records (same pixel {same_pix:.4%}), max abs err {err_l:.2e} of values up "
                f"to {big:.3g}; image gap mean {float(d.mean()):.2e}, max "
                f"{float(d.max()):.2e}, {float((d < 2e-5).float().mean()):.4%} below 2e-5")
            check(share >= 0.999, f"light {name} nu={nu}: only {share:.4%} of records match")
            check(light_images_agree(img_k, img_p, share, got[0].numel(), big, L_PATHS),
                  f"light {name} nu={nu}: images differ")
            # the image sink: the same splats, added by the kernel itself
            img_i = lk.light_image_cuda(packed_s, cp, 3, LW, LH, L_PATHS, 6,
                                        bidir_nu=nu) / L_PATHS
            torch.cuda.synchronize()
            d_i = (img_i - img_p).abs()
            log(f"[light kernel vs plain] {name:16s} nu={nu}: image sink against the plain "
                f"records summed: gap mean {float(d_i.mean()):.2e}, max {float(d_i.max()):.2e}, "
                f"{float((d_i < 2e-5).float().mean()):.4%} below 2e-5")
            check(light_images_agree(img_i, img_p, share, got[0].numel(), big, L_PATHS),
                  f"light image sink {name} nu={nu}: image differs from the plain records'")
            report["light_vs_plain"][f"{name}/{nu}"] = (share, same_pix, err_l,
                                                        float(d_i.max()))
    no_light = mk.pack_scene(presets.cornell(), dev)
    no_light = type(no_light)(*no_light.tables(), no_light.counts[:4] + (0,))
    try:
        lk.render_lighttrace_fast(no_light, cp, 0, 8, 8, 64)
    except ValueError:
        log("[light kernel vs plain] a scene without an area light is refused")
    else:
        check(False, "light tracing accepted a scene without an area light")

    # ---- 12a. the physical main path at full size -------------------------------------
    passes_p = []
    mk.LAUNCH_COUNT = 0            # every count to 0 just before the path ...
    mk.LAUNCHES_BY_VARIANT[:] = [0, 0, 0]
    r = ProgressiveRenderer(
        presets.cornell(), Camera(),
        RenderConfig(width=w, height=h, max_bounces=nb, spp=spp, engine="cuda",
                     physical=True),
        on_pass=passes_p.append)
    t0 = time.time()
    r.run()
    phys_main_s = time.time() - t0
    png_p = os.path.join(work_dir, "cornell_800_physical.png")
    r.save(png_p)
    launches_p = list(mk.LAUNCHES_BY_VARIANT)   # ... and read just after
    phys_img = torch.from_numpy(r.radiance()).to(dev)
    check(launches_p == [0, len(passes_p), 0] and launches_p[1] > 0,
          f"launches per instantiation {launches_p} for {len(passes_p)} physical passes")
    check(tuple(phys_img.shape) == (h, w, 3) and bool(torch.isfinite(phys_img).all())
          and float(phys_img.min()) >= 0.0, "physical main-path image wrong")
    log(f"[physical main path] ProgressiveRenderer(physical=True) cornell {w}x{h} {nb} "
        f"bounces {spp} spp: {len(passes_p)} passes, {launches_p[1]} launches of the "
        f"physical instantiation, {phys_main_s:.2f} s, "
        f"{w * h * spp / phys_main_s / 1e6:.1f} M primary rays/s")

    stats_p = {}
    torch.cuda.synchronize()
    t0 = time.time()
    plain_p = mk.render_megakernel_plain(packed, cp, 0, w, h, PHYSICAL_PLAIN_SPP, nb,
                                         sample_offset=spp, stats=stats_p, physical=True)
    torch.cuda.synchronize()
    phys_plain_ms = (time.time() - t0) * 1e3
    same_p = mk.render_megakernel(packed, cp, 0, w, h, PHYSICAL_PLAIN_SPP, nb,
                                  sample_offset=spp, physical=True)
    torch.cuda.synchronize()
    phys_rate, phys_gap, phys_err = match_stats(same_p, plain_p)
    _, phys_main_gap, _ = match_stats(phys_img, plain_p)
    _, est_gap, _ = match_stats(phys_img, main_img)
    log(f"[physical main path] kernel vs plain at {w}x{h} {PHYSICAL_PLAIN_SPP} spp (same "
        f"samples): {phys_rate:.4%} of pixels, max abs err {phys_err:.2e}; plain version "
        f"{phys_plain_ms:.0f} ms; 2000-spp means vs plain means: gap {phys_main_gap:.3%}; "
        f"vs the default estimator's 2000-spp means: {est_gap:.3%} (another estimator)")
    check(phys_rate >= 0.995 and phys_gap <= 1e-3,
          "physical kernel disagrees with plain at full width")
    check(phys_main_gap <= 0.03, f"physical main-path means {phys_main_gap:.3%} from plain")

    def launch_v(n_spp, **kw):
        def fn(k):
            mk.render_block_sums_cuda(packed, cp, 0, w, h, n_spp, nb, 0, w * h,
                                      sample_offset=(k + 1) * n_spp, **kw)
        return fn

    time_launches(launch_v(PHYSICAL_PLAIN_SPP, physical=True), 1)
    phys_ms = time_launches(launch_v(spp, physical=True), 2)
    phys_ms_plain_shape = time_launches(launch_v(PHYSICAL_PLAIN_SPP, physical=True), 3)
    phys_flops = flop_count(packed.counts, stats_p, spp / PHYSICAL_PLAIN_SPP, physical=True)
    phys_bound = bound_of(phys_flops, packed.table_bytes + 12 * w * h)
    log(f"[physical bench] cornell {w}x{h} {nb} bounces {spp} spp, one launch of the "
        f"physical instantiation: {phys_ms:.1f} ms = {w * h * spp / phys_ms / 1e3:.1f} M "
        f"primary rays/s ({phys_ms / ms:.2f}x the default estimator's {ms:.1f} ms); "
        f"{PHYSICAL_PLAIN_SPP}-spp launch {phys_ms_plain_shape:.2f} ms; "
        f"{stats_p['path_bounces'] / stats_p['paths']:.3f} bounces and "
        f"{stats_p['shadow_rays'] / stats_p['paths']:.3f} shadow rays per path "
        f"({stats_p['shadow_rays_occluded'] / max(stats_p['shadow_rays'], 1):.1%} occluded)")
    occ_p = mk.render_occupancy(packed, physical=True)
    log(f"[physical bench] physical instantiation: {occ_p['registers']} registers, "
        f"{occ_p['blocks_per_sm']} resident blocks per SM, small tables in "
        f"{'shared' if occ_p['smem_bytes'] else 'global'} memory; lane efficiency at "
        f"{PHYSICAL_PLAIN_SPP} spp: regenerating "
        f"{stats_p['path_bounces'] / (32 * stats_p['warp_iterations']):.3f}, nested "
        f"{stats_p['path_bounces'] / (32 * stats_p['warp_iterations_nested']):.3f}")
    log(f"[bound] physical instantiation: {phys_flops:.3e} float32 operations -> "
        f"{phys_bound[2]:.2f} ms; bytes -> {phys_bound[3]:.4f} ms; kernel at "
        f"{phys_bound[0] / phys_ms:.1%} of its bound")

    # ---- 12b. the bidirectional main path at full size, and light tracing alone --------
    bw, bh, bnb = BIDIR["width"], BIDIR["height"], BIDIR["max_bounces"]
    bspp, n_paths = BIDIR["spp"], BIDIR["n_paths"]
    nu_main = n_paths / bspp
    light_seed = rng.seed_for(0, 1)
    packed_b = mk.pack_scene(presets.get_scene(BIDIR["scene"]), dev)
    mk.LAUNCH_COUNT = 0            # every count to 0 just before the path ...
    mk.LAUNCHES_BY_VARIANT[:] = [0, 0, 0]
    lk.LAUNCH_COUNT = 0
    lk.LAUNCHES_BY_VARIANT[:] = [0, 0, 0, 0]
    lk.SPLAT_CALLS = 0
    torch.cuda.synchronize()
    t0 = time.time()
    bidir_img = render_bidir_fast(packed_b, cp, bw, bh, bspp, n_paths, 0, max_bounces=bnb)
    torch.cuda.synchronize()
    bidir_main_s = time.time() - t0
    launches_b = (list(mk.LAUNCHES_BY_VARIANT), list(lk.LAUNCHES_BY_VARIANT),
                  lk.SPLAT_CALLS)   # ... and read just after
    check(launches_b == ([0, 0, 1], [0, 0, 0, 1], 0),
          f"bidir main path launched {launches_b}, not one eye-half kernel, one light "
          "kernel of the image sink and no index_add_")
    check(tuple(bidir_img.shape) == (bh, bw, 3) and bool(torch.isfinite(bidir_img).all())
          and float(bidir_img.min()) >= 0.0, "bidir main-path image wrong")
    lk.LAUNCHES_BY_VARIANT[:] = [0, 0, 0, 0]
    lk.SPLAT_CALLS = 0
    lt_img = lk.render_lighttrace_fast(packed_b, cp, light_seed, bw, bh, n_paths,
                                       max_bounces=bnb)
    lt_again = lk.render_lighttrace_fast(packed_b, cp, light_seed, bw, bh, n_paths,
                                         max_bounces=bnb)
    torch.cuda.synchronize()
    launches_lt = list(lk.LAUNCHES_BY_VARIANT)
    check(launches_lt == [0, 0, 2, 0] and lk.SPLAT_CALLS == 0,
          f"light tracing alone launched {launches_lt}, {lk.SPLAT_CALLS} index_add_")
    two_runs_gap = float((lt_img - lt_again).abs().max())
    check(two_runs_gap <= 1e-5 * float(lt_img.max()),
          f"two runs of the light image differ by {two_runs_gap:.2e}")
    from cuda_path_tracer_ss_torch.utils.image import write_png
    png_b = os.path.join(work_dir, "caustic_512_bidir.png")
    write_png(png_b, np.clip(bidir_img.cpu().numpy(), 0, 1) ** (1 / 2.2))
    # the glass sphere is black without an eye-side subpath and lit with one
    lit_b = float((bidir_img.sum(-1) > 1e-4).float().mean())
    lit_lt = float((lt_img.sum(-1) > 1e-4).float().mean())
    log(f"[bidir main path] render_bidir_fast {BIDIR['scene']} {bw}x{bh} {bnb} bounces "
        f"{bspp} spp + {n_paths} light paths: launches {launches_b[0]} (eye half by "
        f"instantiation), {launches_b[1]} (light kernel by <image sink, bidir>), "
        f"{launches_b[2]} index_add_; "
        f"{bidir_main_s:.3f} s; lit pixels {lit_b:.1%} (light tracing alone {lit_lt:.1%}: "
        f"no glass); two runs of the light image differ by {two_runs_gap:.2e} at most "
        f"(values up to {float(lt_img.max()):.3g})")
    check(lit_b > lit_lt, "the bidirectional image lights no more pixels than light tracing")

    # both halves against their plain versions at this size
    stats_e = {}
    torch.cuda.synchronize()
    t0 = time.time()
    plain_e = mk.render_megakernel_plain(packed_b, cp, 0, bw, bh, BIDIR_PLAIN_SPP, bnb,
                                         stats=stats_e, physical=True, bidir_nu=nu_main)
    torch.cuda.synchronize()
    eye_plain_ms = (time.time() - t0) * 1e3
    same_e = mk.render_megakernel(packed_b, cp, 0, bw, bh, BIDIR_PLAIN_SPP, bnb,
                                  physical=True, bidir_nu=nu_main)
    torch.cuda.synchronize()
    eye_rate, eye_gap, eye_err = match_stats(same_e, plain_e)
    check(eye_rate >= 0.995 and eye_gap <= 1e-3,
          "bidir instantiation disagrees with plain at full width")
    light = {}
    for label, nu in (("light", None), ("light_bidir", nu_main)):
        bidir = nu is not None
        occ_i = lk.light_occupancy(bidir, splat=True)
        occ_r = lk.light_occupancy(bidir, splat=False)
        stats_l = {}
        torch.cuda.synchronize()
        t0 = time.time()
        want = lk.light_records_plain(packed_b, cp, light_seed, bw, bh, n_paths, bnb,
                                      bidir_nu=nu, stats=stats_l,
                                      n_lanes=occ_i["resident_lanes"])
        want_img = lk.splat_records(want, bw, bh)
        torch.cuda.synchronize()
        l_plain_ms = (time.time() - t0) * 1e3
        got = lk.light_records_cuda(packed_b, cp, light_seed, bw, bh, n_paths, bnb,
                                    bidir_nu=nu)
        torch.cuda.synchronize()
        share, same_pix, err_l, big = record_match(got, want)
        check(share >= 0.999, f"{label}: only {share:.4%} of records match at full size")
        del want
        # the image sink against the plain records summed
        img_k = lk.light_image_cuda(packed_b, cp, light_seed, bw, bh, n_paths, bnb,
                                    bidir_nu=nu) / n_paths
        check(light_images_agree(img_k, want_img / n_paths, share, got[0].numel(), big,
                                 n_paths),
              f"{label}: the image sink differs from the plain records summed")
        img_err = float((img_k - want_img / n_paths).abs().max())
        keep = (got[1] != 0) | (got[2] != 0) | (got[3] != 0)
        hottest = int(torch.bincount(got[0][keep].long(), minlength=bw * bh).max())
        n_kept = int(keep.sum())
        del want_img, img_k, keep

        def image():
            return lk.light_image_cuda(packed_b, cp, light_seed, bw, bh, n_paths, bnb,
                                       bidir_nu=nu)

        def records():
            return lk.light_records_cuda(packed_b, cp, light_seed, bw, bh, n_paths, bnb,
                                         bidir_nu=nu)

        def masked_add(recs):
            # the nearest library route: index_add_ of the non-empty records only
            pix, r, g, b = recs
            nonzero = (r != 0) | (g != 0) | (b != 0)
            rgb = torch.stack([r[nonzero], g[nonzero], b[nonzero]], -1)
            return torch.zeros((bw * bh, 3), dtype=torch.float32,
                               device=dev).index_add_(0, pix[nonzero], rgb)

        i_ms = median_ms(image)                                      # (a)
        l_ms = median_ms(records)
        splat_ms = median_ms(lambda: lk.splat_records(got, bw, bh))
        route_b_ms = median_ms(lambda: lk.splat_records(records(), bw, bh))   # (b)
        masked_ms = median_ms(lambda: masked_add(got))
        route_c_ms = median_ms(lambda: masked_add(records()))        # (c)
        record_bytes = 16 * (bnb + 1) * n_paths
        l_flops = light_flop_count(packed_b.counts, stats_l, bidir=bidir)
        l_bound = bound_of(l_flops, packed_b.table_bytes + record_bytes)
        i_bound = bound_of(l_flops, packed_b.table_bytes + 12 * bw * bh)
        eff = {k: stats_l["path_bounces"] / (32 * stats_l[k])
               for k in ("warp_iterations", "warp_iterations_nested")}
        light[label] = dict(ms=l_ms, image_ms=i_ms, plain_ms=l_plain_ms, splat_ms=splat_ms,
                            route_b_ms=route_b_ms, route_c_ms=route_c_ms,
                            masked_splat_ms=masked_ms, share=share, max_abs_err=err_l,
                            image_max_abs_err=img_err, bound=l_bound, image_bound=i_bound,
                            stats=stats_l, lane_efficiency=eff, hottest_pixel_splats=hottest,
                            nonempty_records=n_kept, occupancy_image=occ_i,
                            occupancy_records=occ_r,
                            record_bytes_ms=record_bytes / PEAK_BYTES_PER_S * 1e3)
        log(f"[light bench] {BIDIR['scene']} {bw}x{bh} {bnb} bounces {n_paths} paths, "
            f"nu={nu} (medians of 5): (a) image sink {i_ms:.3f} ms = "
            f"{n_paths / i_ms / 1e3:.1f} M paths/s; (b) record sink {l_ms:.3f} ms + "
            f"index_add_ of all {got[0].numel()} records {splat_ms:.3f} ms, together "
            f"{route_b_ms:.3f} ms; (c) record sink + index_add_ of the {n_kept} non-empty "
            f"records (masked first; the add alone {masked_ms:.3f} ms) {route_c_ms:.3f} ms; "
            f"(a) is {route_c_ms / i_ms:.2f}x faster than (c), {route_b_ms / i_ms:.2f}x than "
            f"(b); plain version {l_plain_ms:.0f} ms")
        log(f"[light bench] nu={nu}: records {share:.4%} of {got[0].numel()} match plain "
            f"(same pixel {same_pix:.4%}), max abs err {err_l:.2e} of values up to {big:.3g}; "
            f"image sink vs the plain records summed: max abs err {img_err:.2e}; "
            f"{stats_l['path_bounces'] / stats_l['paths']:.3f} bounces, "
            f"{stats_l['vis_rays'] / stats_l['paths']:.3f} visibility rays "
            f"({stats_l['vis_rays_occluded'] / max(stats_l['vis_rays'], 1):.1%} occluded) and "
            f"{stats_l['splats'] / stats_l['paths']:.3f} splats per path; hottest pixel "
            f"{hottest} splats")
        log(f"[light bench] nu={nu}: image sink {occ_i['registers']} registers, "
            f"{occ_i['blocks_per_sm']} blocks of {occ_i['threads_per_block']} per SM; record "
            f"sink {occ_r['registers']} registers, {occ_r['blocks_per_sm']} blocks per SM; "
            f"lane efficiency of the bounce loop: one path per lane (the kernel) "
            f"{eff['warp_iterations_nested']:.3f}, regenerating over the "
            f"{occ_i['resident_lanes']} resident lanes (measured slower, PERF.md) "
            f"{eff['warp_iterations']:.3f}")
        log(f"[bound] light kernel, nu={nu}: {l_flops:.3e} float32 operations -> "
            f"{l_bound[2]:.3f} ms; image sink: tables in, image out ({12 * bw * bh} B) -> "
            f"{i_bound[3]:.4f} ms, at {i_bound[0] / i_ms:.1%} of its bound ({i_bound[1]}); "
            f"record sink: tables in and records out ({record_bytes:.3e} B) -> "
            f"{l_bound[3]:.3f} ms, at {l_bound[0] / l_ms:.1%} of its bound ({l_bound[1]})")
        del got
    eye_ms = median_ms(lambda: mk.render_block_sums_cuda(
        packed_b, cp, 0, bw, bh, bspp, bnb, 0, bw * bh, physical=True, bidir_nu=nu_main))
    eye_ms_plain_shape = median_ms(lambda: mk.render_block_sums_cuda(
        packed_b, cp, 0, bw, bh, BIDIR_PLAIN_SPP, bnb, 0, bw * bh, physical=True,
        bidir_nu=nu_main))
    bidir_ms = median_ms(lambda: render_bidir_fast(packed_b, cp, bw, bh, bspp, n_paths, 0,
                                                   max_bounces=bnb))
    eye_flops = flop_count(packed_b.counts, stats_e, bspp / BIDIR_PLAIN_SPP, physical=True,
                           bidir=True)
    eye_bound = bound_of(eye_flops, packed_b.table_bytes + 12 * bw * bh)
    light_half_ms = light["light_bidir"]["image_ms"]
    log(f"[bidir bench] {BIDIR['scene']} {bw}x{bh} {bnb} bounces: render_bidir_fast "
        f"{bidir_ms:.2f} ms = eye half ({bspp} spp, bidir instantiation) {eye_ms:.2f} ms "
        f"({bw * bh * bspp / eye_ms / 1e3:.1f} M primary rays/s) + light half (image sink) "
        f"{light_half_ms:.3f} ms + the rest {bidir_ms - eye_ms - light_half_ms:.3f} ms "
        f"(medians of 5; the light half's records + index_add_ would take "
        f"{light['light_bidir']['route_b_ms']:.3f} ms). Eye half vs plain at "
        f"{BIDIR_PLAIN_SPP} spp: {eye_rate:.4%} of pixels, max abs err {eye_err:.2e}; plain "
        f"version {eye_plain_ms:.0f} ms")
    log(f"[bound] bidir instantiation: {eye_flops:.3e} float32 operations -> "
        f"{eye_bound[2]:.2f} ms; bytes -> {eye_bound[3]:.4f} ms; kernel at "
        f"{eye_bound[0] / eye_ms:.1%} of its bound")

    # ---- 13a. the textured instantiations against their plain versions -----------------
    tex_scenes = {"textured": presets.textured, "mesh": presets.mesh_demo,
                  "color+normal quad": lambda: presets.textured_quad(nmap=True),
                  "color sphere": lambda: presets.textured_quad(sphere=True)}
    report["texture_vs_plain"] = {}
    for name, make in tex_scenes.items():
        packed_s = mk.pack_scene(make(), dev)
        for label, kw in (("default", {}),) + tuple(VARIANTS.items()):
            plain_v = mk.render_block_sums_plain(packed_s, cp, 7, W, H, 8, 6, 0, W * H,
                                                 **kw) / 8
            got = mk.render_block_sums_cuda(packed_s, cp, 7, W, H, 8, 6, 0, W * H, **kw) / 8
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"texture {label} {name}: non-finite")
            rate_v, gap_v, err_v = match_stats(got, plain_v)
            log(f"[texture kernel vs plain] {name:18s} {label:8s} "
                f"({'textured' if packed_s.textured else 'untextured'} instantiation): "
                f"{rate_v:.4%} of pixels, mean gap {gap_v:.2e}, max abs err {err_v:.2e}")
            check(rate_v >= 0.995, f"texture {label} {name}: only {rate_v:.4%} of pixels match")
            check(gap_v <= 1e-3, f"texture {label} {name}: channel means differ by {gap_v:.2e}")
            report["texture_vs_plain"][f"{name}/{label}"] = (rate_v, gap_v, err_v)

    # ---- 13b. the textured main path at full size ---------------------------------------
    passes_t = []
    mk.LAUNCH_COUNT = 0            # every count to 0 just before the path ...
    mk.LAUNCHES_BY_VARIANT[:] = [0, 0, 0]
    mk.LAUNCHES_TEXTURED[:] = [0, 0, 0]
    r = ProgressiveRenderer(
        presets.textured(), Camera(),
        RenderConfig(width=w, height=h, max_bounces=nb, spp=spp, engine="cuda"),
        on_pass=passes_t.append)
    t0 = time.time()
    r.run()
    tex_main_s = time.time() - t0
    png_t = os.path.join(work_dir, "textured_800.png")
    r.save(png_t)
    launches_t = list(mk.LAUNCHES_TEXTURED)   # ... and read just after
    tex_img = torch.from_numpy(r.radiance()).to(dev)
    check(launches_t == [len(passes_t), 0, 0] and launches_t[0] > 0,
          f"textured launches {launches_t} for {len(passes_t)} passes")
    check(tuple(tex_img.shape) == (h, w, 3) and bool(torch.isfinite(tex_img).all())
          and float(tex_img.min()) >= 0.0, "textured main-path image wrong")
    log(f"[textured main path] ProgressiveRenderer textured {w}x{h} {nb} bounces {spp} spp: "
        f"{len(passes_t)} passes, {launches_t[0]} launches of the textured default "
        f"instantiation, {tex_main_s:.2f} s, {w * h * spp / tex_main_s / 1e6:.1f} M primary "
        f"rays/s")

    # the same with the physical estimator, sample count cut to 256
    mk.LAUNCHES_TEXTURED[:] = [0, 0, 0]   # every count to 0 just before the path ...
    r = ProgressiveRenderer(
        presets.textured(), Camera(),
        RenderConfig(width=w, height=h, max_bounces=nb, spp=256, engine="cuda",
                     physical=True))
    t0 = time.time()
    r.run()
    tex_phys_s = time.time() - t0
    launches_tp = list(mk.LAUNCHES_TEXTURED)  # ... and read just after
    check(launches_tp[1] > 0 and launches_tp[0] == launches_tp[2] == 0
          and bool(np.isfinite(r.radiance()).all()), f"textured physical {launches_tp}")
    log(f"[textured main path] ProgressiveRenderer(physical=True) textured {w}x{h} {nb} "
        f"bounces 256 spp: {launches_tp[1]} launches of the textured physical instantiation, "
        f"{tex_phys_s:.2f} s, {w * h * 256 / tex_phys_s / 1e6:.1f} M primary rays/s")

    packed_t = mk.pack_scene(presets.textured(), dev)
    tex_bench = {}
    for label, kw in (("default", {}), ("physical", dict(physical=True))):
        stats_x = {}
        torch.cuda.synchronize()
        t0 = time.time()
        plain_x = mk.render_megakernel_plain(packed_t, cp, 0, w, h, TEX_PLAIN_SPP, nb,
                                             sample_offset=spp, stats=stats_x, **kw)
        torch.cuda.synchronize()
        x_plain_ms = (time.time() - t0) * 1e3
        same_x = mk.render_megakernel(packed_t, cp, 0, w, h, TEX_PLAIN_SPP, nb,
                                      sample_offset=spp, **kw)
        torch.cuda.synchronize()
        x_rate, x_gap, x_err = match_stats(same_x, plain_x)
        check(x_rate >= 0.995 and x_gap <= 1e-3,
              f"textured {label} kernel disagrees with plain at full width")
        def launch_x(k, kw=kw):
            mk.render_block_sums_cuda(packed_t, cp, 0, w, h, spp, nb, 0, w * h,
                                      sample_offset=(k + 1) * spp, **kw)

        time_launches(launch_x, 1)
        x_ms = time_launches(launch_x, 2)
        x_flops = (flop_count(packed_t.counts, stats_x, spp / TEX_PLAIN_SPP,
                              physical=bool(kw))
                   + texture_flops(stats_x) * spp / TEX_PLAIN_SPP)
        x_bound = bound_of(x_flops, packed_t.table_bytes + 12 * w * h)
        regs = report["ptxas"][f"megakernel/render_kernel<{int(bool(kw))},0,1,0,0>"]["registers"]
        tex_bench[label] = dict(ms=x_ms, plain_ms=x_plain_ms, max_abs_err=x_err,
                                match_rate=x_rate, bound=x_bound, registers=regs)
        log(f"[textured bench] textured {w}x{h} {nb} bounces {spp} spp, one launch of the "
            f"textured {label} instantiation ({regs} registers): {x_ms:.1f} ms = "
            f"{w * h * spp / x_ms / 1e3:.1f} M primary rays/s; vs plain at {TEX_PLAIN_SPP} spp "
            f"(same samples): {x_rate:.4%} of pixels, max abs err {x_err:.2e}, plain version "
            f"{x_plain_ms:.0f} ms; per path {stats_x['path_bounces'] / stats_x['paths']:.3f} "
            f"bounces, {stats_x['color_fetches'] / stats_x['paths']:.3f} color and "
            f"{stats_x['normal_fetches'] / stats_x['paths']:.3f} normal-map fetches")
        log(f"[bound] textured {label} instantiation: {x_flops:.3e} float32 operations -> "
            f"{x_bound[2]:.2f} ms; {packed_t.table_bytes + 12 * w * h} bytes -> "
            f"{x_bound[3]:.4f} ms; kernel at {x_bound[0] / x_ms:.1%} of its bound")

    # the textured bidir instantiation: the eye half's entry on a textured scene
    # (render_bidir_fast refuses one: the light kernel has no texture block)
    mk.LAUNCHES_TEXTURED[:] = [0, 0, 0]   # every count to 0 just before the path ...
    nu_t = n_paths / bspp
    eye_t = mk.render_megakernel(packed_t, cp, 0, bw, bh, bspp, bnb, physical=True,
                                 bidir_nu=nu_t)
    torch.cuda.synchronize()
    launches_tb = list(mk.LAUNCHES_TEXTURED)  # ... and read just after
    check(launches_tb == [0, 0, 1] and bool(torch.isfinite(eye_t).all()),
          f"textured eye half launched {launches_tb}")
    stats_tb = {}
    torch.cuda.synchronize()
    t0 = time.time()
    plain_tb = mk.render_megakernel_plain(packed_t, cp, 0, bw, bh, BIDIR_PLAIN_SPP, bnb,
                                          stats=stats_tb, physical=True, bidir_nu=nu_t)
    torch.cuda.synchronize()
    tb_plain_ms = (time.time() - t0) * 1e3
    tb_rate, tb_gap, tb_err = match_stats(
        mk.render_megakernel(packed_t, cp, 0, bw, bh, BIDIR_PLAIN_SPP, bnb, physical=True,
                             bidir_nu=nu_t), plain_tb)
    check(tb_rate >= 0.995 and tb_gap <= 1e-3, "textured bidir disagrees with plain")
    tb_ms = median_ms(lambda: mk.render_block_sums_cuda(
        packed_t, cp, 0, bw, bh, bspp, bnb, 0, bw * bh, physical=True, bidir_nu=nu_t))
    tb_flops = (flop_count(packed_t.counts, stats_tb, bspp / BIDIR_PLAIN_SPP, physical=True,
                           bidir=True) + texture_flops(stats_tb) * bspp / BIDIR_PLAIN_SPP)
    tb_bound = bound_of(tb_flops, packed_t.table_bytes + 12 * bw * bh)
    log(f"[textured bench] textured {bw}x{bh} {bnb} bounces {bspp} spp, nu {nu_t:g}, the "
        f"textured bidir instantiation ({report['ptxas']['megakernel/render_kernel<1,1,1,0,0>']['registers']} "
        f"registers): {tb_ms:.2f} ms (median of 5); vs plain at {BIDIR_PLAIN_SPP} spp "
        f"{tb_rate:.4%} of pixels, plain version {tb_plain_ms:.0f} ms; bound "
        f"{tb_bound[0]:.3f} ms ({tb_bound[1]}), kernel at {tb_bound[0] / tb_ms:.1%} of it")

    # ---- 13c. the textured backward kernel against the plain engine's autograd -------------
    report["textured_vjp_vs_plain"] = {}
    tex_vjp_cases = [
        ("color quad", lambda: presets.textured_quad(), ["textures", "materials.diffuse"]),
        ("color quad", lambda: presets.textured_quad(),
         ["textures", "materials.roughness", "pl_pos"]),
        ("color sphere", lambda: presets.textured_quad(sphere=True),
         ["sph_center", "sph_radius", "textures"]),
        ("color+normal quad", lambda: presets.textured_quad(nmap=True),
         ["textures", "materials.diffuse", "pl_pos"]),
        ("textured", presets.textured, ["textures", "materials.diffuse"]),
    ]
    for name, make, fields_t in tex_vjp_cases:
        scene = make()
        for with_tex in (True, False):
            fields = fields_t if with_tex else [f for f in fields_t if f != "textures"]
            (v_k, g_k), (v_p, g_p) = both_engines(scene, fields, rand_target, gw, gh, 2, 4, 5)
            torch.cuda.synchronize()
            route = vjp.LAST_ROUTE
            mode = inverse.make_loss(scene, cp, rand_target, gw, gh, 2, 4, engine="plain",
                                     field_names=fields).grad_mode
            worst, rel, _, ok = grad_gap(g_k, g_p)
            loss_gap = abs(float(v_k) - float(v_p)) / abs(float(v_p))
            log(f"[textured vjp vs plain] {name:18s} {mode:6s} {','.join(fields)}: loss gap "
                f"{loss_gap:.1e}; worst field {worst} at {rel:.2e} of its max|g|; rows "
                f"{route} route")
            check(loss_gap <= 1e-5, f"textured vjp {name} {fields}: loss differs by {loss_gap}")
            check(ok, f"textured vjp {name} {fields}: {worst} off by {rel:.2e} of max|g|")
            report["textured_vjp_vs_plain"][f"{name}/{','.join(fields)}"] = (mode, worst, rel,
                                                                           route)

    scene = presets.textured()
    fields = ["textures", "materials.diffuse"]
    loss = inverse.make_loss(scene, cp, rand_target, gw, gh, 2, 4, engine="cuda",
                             field_names=fields)
    (v1, g1), (v2, g2) = (inverse.value_and_grad(loss, inverse.extract_params(scene, fields),
                                                 5) for _ in range(2))
    torch.cuda.synchronize()
    _, tex_det, _, _ = grad_gap(g1, g2)
    check(float(v1) == float(v2) and tex_det <= 1e-4,
          f"two runs of one textured step differ by {tex_det:.2e} of max|g|")
    log(f"[vjp determinism] textured {gw}x{gh} {loss.grad_mode}, the same step twice: "
        f"largest difference {tex_det:.2e} of a field's max|g|; losses bit-equal")

    # ---- 13d. textured gradient steps in the reference's configurations -------------------
    tex_grad_bench = []
    for name, size, b_spp, b_nb, fields in TEX_GRAD_BENCH:
        scene = presets.textured_quad(nmap="normal" in name)
        packed_g = mk.pack_scene(scene, dev)
        target_g = mk.render_megakernel(packed_g, cp, 0, size, size, b_spp, b_nb)
        loss = inverse.make_loss(scene, cp, target_g, size, size, b_spp, b_nb, engine="cuda",
                                 field_names=fields)
        full = loss.grad_mode == "full"
        params = inverse.extract_params(scene, fields)
        mk.LAUNCHES_TEXTURED[:] = [0, 0, 0]   # every count to 0 just before the path ...
        vjp.LAUNCH_COUNT = 0
        ms_step = median_ms(lambda: inverse.value_and_grad(loss, params, 1))
        k_launches = (mk.LAUNCHES_TEXTURED[0], vjp.LAUNCH_COUNT)   # ... read just after
        check(k_launches == (6, 6), f"textured grad bench: launches {k_launches} for 6 steps")
        g_img = torch.rand((size, size, 3), generator=g).to(dev)
        n_g = size * size
        ms_k1g = median_ms(lambda: mk.render_block_sums_cuda(packed_g, cp, 1, size, size, b_spp,
                                                             b_nb, 0, n_g))
        ms_k2g = median_ms(lambda: vjp.backward_rows_cuda(packed_g, cp, 1, size, size, b_spp,
                                                          b_nb, g_img, full=full,
                                                          tex_grads=True))
        stats_g = {}
        mk.render_megakernel_plain(packed_g, cp, 1, size, size, b_spp, b_nb, stats=stats_g)
        visible = stats_g["shadow_rays"] - stats_g["shadow_rays_occluded"]
        mode = loss.grad_mode
        k2_flops = (flop_count(packed_g.counts, stats_g) + texture_flops(stats_g)
                    + stats_g["stored_bounces"] * (REVERSE_BOUNCE_FLOPS[mode]
                                                   + TEX_REVERSE_FLOPS[mode])
                    + (stats_g["normal_fetches"] * NMAP_PULLBACK_FLOPS if full else 0)
                    + visible * NEE_PARTIAL_FLOPS[mode] + stats_g["paths"] * EYE_VJP_FLOPS[mode])
        texels = packed_g.tex_counts[1]
        rows = vjp._grad_rows(packed_g.counts, full, texels)
        k2_bound = bound_of(k2_flops, packed_g.table_bytes + 12 * n_g + 4 * rows)
        entry = dict(name=name, size=size, spp=b_spp, bounces=b_nb, mode=mode,
                     fields=fields, ms_step=ms_step, ms_k1=ms_k1g, ms_k2=ms_k2g,
                     bound=k2_bound, route=vjp.LAST_ROUTE, packed=packed_g, g_img=g_img,
                     launches=k_launches[1])
        tex_grad_bench.append(entry)
        log(f"[textured grad bench] {name} {size}x{size} {b_spp} spp {b_nb} bounces, {mode} "
            f"({', '.join(fields)}): value_and_grad step {ms_step:.2f} ms = forward kernel "
            f"{ms_k1g:.2f} + backward kernel {ms_k2g:.2f} + the rest {ms_step - ms_k1g - ms_k2g:.2f}"
            f" (medians of 5); backward kernel's bound {k2_bound[0]:.4f} ms ({k2_bound[1]}), "
            f"kernel at {k2_bound[0] / ms_k2g:.1%} of it; rows {vjp.LAST_ROUTE} route")

    # the plain engine on two of these steps' inputs: its time and the kernel's error
    tex_k2 = {}
    for entry in (tex_grad_bench[1], tex_grad_bench[3]):
        size, b_spp, b_nb = entry["size"], entry["spp"], entry["bounces"]
        packed_g, g_img = entry["packed"], entry["g_img"]
        full = entry["mode"] == "full"
        rows_k = vjp.backward_rows_cuda(packed_g, cp, 1, size, size, b_spp, b_nb, g_img,
                                        full=full, tex_grads=True)
        d_k, _ = vjp._unpack_rows(rows_k, packed_g, full, True)
        torch.cuda.synchronize()
        t0 = time.time()
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (packed_g.materials, packed_g.point_lights, packed_g.tex_atlas)]
        pk = dataclasses.replace(packed_g, materials=leaves[0], point_lights=leaves[1],
                                 tex_atlas=leaves[2])
        img_p = vjp.render_megakernel_diff_plain(pk, cp, 1, size, size, b_spp, b_nb,
                                                 grad_mode=entry["mode"])
        d_p = torch.autograd.grad((img_p * g_img).sum(), leaves)
        torch.cuda.synchronize()
        plain_ms_t = (time.time() - t0) * 1e3
        # linear mode leaves the full-only columns at zero: compare what it computes
        cols = (slice(None) if full else [*range(12), 14], slice(None) if full else slice(3, 6))
        got_k = {"materials": d_k.materials[:, cols[0]],
                 "point_lights": d_k.point_lights[:, cols[1]], "textures": d_k.tex_atlas}
        want_p = {"materials": d_p[0][:, cols[0]], "point_lights": d_p[1][:, cols[1]],
                  "textures": d_p[2]}
        worst, rel, err, ok = grad_gap(got_k, want_p)
        check(ok, f"textured grad bench {entry['name']}: {worst} off by {rel:.2e} of max|g|")
        tex_k2[entry["mode"]] = dict(entry, plain_ms=plain_ms_t, max_abs_err=err)
        log(f"[textured grad bench] kernels vs plain engine at {entry['name']} {size}x{size} "
            f"{b_spp} spp {b_nb} bounces ({entry['mode']}): worst {worst} at {rel:.2e} of its "
            f"max|g| (max abs err {err:.2e}); plain version's forward + backward "
            f"{plain_ms_t:.0f} ms")

    # ---- 13e. textured training: paint the textured preset's texels from grey ------------
    tt = TEX_TRAIN
    scene_true = presets.textured()
    target_tt = mk.render_megakernel(mk.pack_scene(scene_true, dev), cp, 0, tt["width"],
                                     tt["height"], tt["spp"], tt["max_bounces"])
    start_tt = scene_true.replace(textures=torch.full_like(scene_true.textures, 0.5))
    stamps = []
    mk.LAUNCH_COUNT = 0             # every count to 0 just before the path ...
    mk.LAUNCHES_TEXTURED[:] = [0, 0, 0]
    vjp.LAUNCH_COUNT = 0
    t0 = time.time()
    _, params_tt, losses_tt = inverse.invert(
        start_tt, cp, target_tt, ["textures"], tt["width"], tt["height"], spp=tt["spp"],
        steps=tt["steps"], lr=0.05, seed=0, max_bounces=tt["max_bounces"], engine="cuda",
        callback=lambda step, val, p: stamps.append(time.time()))
    torch.cuda.synchronize()
    train_t = dict(k1=mk.LAUNCHES_TEXTURED[0], k2=vjp.LAUNCH_COUNT,   # ... read just after
                   first_step_s=stamps[0] - t0,
                   ms_per_step=(stamps[-1] - stamps[0]) / (tt["steps"] - 1) * 1e3)
    log(f"[textured train] invert textured {tt['width']}x{tt['height']} {tt['spp']} spp "
        f"{tt['max_bounces']} bounces, fields textures from a grey atlas, {tt['steps']} Adam "
        f"steps: loss {losses_tt[0]:.3e} -> {losses_tt[-1]:.3e} "
        f"({losses_tt[-1] / losses_tt[0]:.3f} of the first); {train_t['ms_per_step']:.2f} ms "
        f"per step after a {train_t['first_step_s']:.2f} s first step; {train_t['k1']} forward "
        f"and {train_t['k2']} backward launches")
    check(all(np.isfinite(losses_tt)) and losses_tt[-1] < losses_tt[0],
          "textured train: the loss did not fall")
    check(train_t["k1"] == tt["steps"] and train_t["k2"] == tt["steps"],
          f"textured train: {train_t['k1']} / {train_t['k2']} launches")

    # ---- 14. the accelerated path: the supercell grid, and the bf16 carries ----------
    from cuda_path_tracer_ss_torch.ops.grid import build_grid

    def grid_of(scene):
        return mk.pack_grid(build_grid(scene), dev)

    # registers per instantiation, keyed by its (physical, bidir, textured, grid, bf16) flags
    regs = {tuple(int(c) for c in k.split("<")[1][:-1].split(",")): v["registers"]
            for k, v in report["ptxas"].items() if k.startswith("megakernel/render_kernel")}
    log("[build] grid instantiations beside the linear ones (registers): "
        + ", ".join(f"<{k[0]},{k[1]},{k[2]}> {regs[k[:3] + (0, 0)]} -> {regs[k]}"
                    for k in sorted(regs) if k[3:] == (1, 0))
        + f"; the bf16 ones beside the float32 ones: "
        + ", ".join(f"<{k[0]},{k[1]},{k[2]},{k[3]}> {regs[k[:4] + (0,)]} -> {regs[k]}"
                    for k in sorted(regs) if k[4])
        + f"; the linear float32 default keeps {regs[(0, 0, 0, 0, 0)]} "
        f"({NESTED_DEFAULT_REGISTERS} before per-lane regeneration). A grid instantiation is "
        "what a runtime "
        "branch on the grid pointer alone would build: it holds both sweeps")

    # 14a. every grid instantiation against its plain version and against linear
    grid_scenes = {"cornell": presets.cornell, "stress": presets.stress,
                   "stress_dense": lambda: presets.stress_dense(3000),
                   "mesh_dense": lambda: presets.mesh_dense(3), "textured": presets.textured}
    report["grid_vs_plain"] = {}
    for name, make in grid_scenes.items():
        scene = make()
        t0 = time.time()
        pg = grid_of(scene)
        grid_build_s = time.time() - t0
        packed_s = mk.pack_scene(scene, dev)
        for label, kw in (("default", {}),) + tuple(VARIANTS.items()):
            plain_g = mk.render_block_sums_plain(packed_s, cp, 7, W, H, 4, 6, 0, W * H,
                                                 packed_grid=pg, **kw) / 4
            got = mk.render_block_sums_cuda(packed_s, cp, 7, W, H, 4, 6, 0, W * H,
                                            packed_grid=pg, **kw) / 4
            lin = mk.render_block_sums_cuda(packed_s, cp, 7, W, H, 4, 6, 0, W * H, **kw) / 4
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"grid {label} {name}: non-finite")
            rate_p, gap_p, err_p = match_stats(got, plain_g)
            rate_l, gap_l, err_l = match_stats(got, lin)
            log(f"[grid kernel vs plain] {name:12s} {label:8s} "
                f"({'textured' if packed_s.textured else 'untextured'}, grid {pg.meta[:3]}, "
                f"built and packed in {grid_build_s:.2f} s): vs plain grid {rate_p:.4%} of "
                f"pixels, max abs err {err_p:.2e}; vs the linear kernel {rate_l:.4%}, max abs "
                f"err {err_l:.2e}")
            for rate, gap, what in ((rate_p, gap_p, "plain"), (rate_l, gap_l, "linear")):
                check(rate >= 0.995 and gap <= 1e-3,
                      f"grid {label} {name}: {rate:.4%} of pixels match {what}")
            report["grid_vs_plain"][f"{name}/{label}"] = (rate_p, err_p, rate_l, err_l)
    for name, make, g_spp, g_nb in (("stress", presets.stress, 8, 6),
                                    ("mesh_demo", presets.mesh_demo, 16, 6)):
        scene = make()
        want = np.load(os.path.join(GOLDEN, f"tpu_{name}_64x64_{g_spp}spp_{g_nb}b.npy"))
        got = mk.render_fast2(scene, cp, 64, 64, g_spp, 7, max_bounces=g_nb,
                              grid=build_grid(scene), device=dev).cpu().numpy()
        golden_check(f"{name} grid", got, want, corr_min=0.999)

    # 14b. the backward kernel through the grid
    report["grid_vjp_vs_plain"] = {}
    for name, make in (("cornell", presets.cornell), ("stress", presets.stress),
                       ("color+normal quad", lambda: presets.textured_quad(nmap=True))):
        scene = make()
        for mode in ("linear", "full"):
            fields = scene_fields(scene, mode)
            if scene.num_textures:
                fields = (["materials.diffuse", "pl_power"] if mode == "linear"
                          else ["textures", "materials.diffuse", "pl_pos"])
            (v_k, g_k), (v_p, g_p) = both_engines(scene, fields, rand_target, gw, gh, 2, 4, 5,
                                                  accel="grid")
            v_l, g_l = inverse.value_and_grad(
                inverse.make_loss(scene, cp, rand_target, gw, gh, 2, 4, engine="cuda",
                                  field_names=fields), inverse.extract_params(scene, fields), 5)
            torch.cuda.synchronize()
            worst, rel, _, ok = grad_gap(g_k, g_p)
            worst_l, rel_l, _, ok_l = grad_gap(g_k, g_l)
            loss_gap = abs(float(v_k) - float(v_p)) / abs(float(v_p))
            log(f"[grid vjp vs plain] {name:18s} {mode:6s}: loss gap {loss_gap:.1e}; vs the "
                f"plain engine's autograd worst {worst} at {rel:.2e} of its max|g|; vs the "
                f"linear backward kernel worst {worst_l} at {rel_l:.2e}")
            check(loss_gap <= 1e-5 and float(v_k) == float(v_l),
                  f"grid vjp {name} {mode}: loss gap {loss_gap:.2e}")
            check(ok and ok_l, f"grid vjp {name} {mode}: {worst} {rel:.2e} / {worst_l} "
                  f"{rel_l:.2e} of max|g|")
            report["grid_vjp_vs_plain"][f"{name}/{mode}"] = (worst, rel, worst_l, rel_l)

    # 14c. the grid main path at full size, beside the linear one (section 6)
    passes_g = []
    mk.LAUNCH_COUNT = 0            # every count to 0 just before the path ...
    mk.LAUNCHES_GRID[:] = [0, 0, 0]
    r = ProgressiveRenderer(
        presets.cornell(), Camera(),
        RenderConfig(width=w, height=h, max_bounces=nb, spp=spp, engine="cuda",
                     accel="grid"),
        on_pass=passes_g.append)
    t0 = time.time()
    r.run()
    grid_main_s = time.time() - t0
    launches_g = list(mk.LAUNCHES_GRID)   # ... and read just after
    grid_img = torch.from_numpy(r.radiance()).to(dev)
    check(launches_g == [len(passes_g), 0, 0] and mk.LAUNCH_COUNT == len(passes_g),
          f"grid main path: grid launches {launches_g} for {len(passes_g)} passes")
    rate_gm, _, err_gm = match_stats(grid_img, main_img)
    check(rate_gm >= 0.995, f"grid main path: {rate_gm:.4%} of pixels match the linear one")
    log(f"[grid main path] ProgressiveRenderer(accel='grid') cornell {w}x{h} {nb} bounces "
        f"{spp} spp: {len(passes_g)} passes, {launches_g[0]} launches of the grid "
        f"instantiation, {grid_main_s:.2f} s ({w * h * spp / grid_main_s / 1e6:.1f} M primary "
        f"rays/s) beside the linear run's {main_s:.2f} s; {rate_gm:.4%} of pixels equal the "
        f"linear image within rtol 1e-4 / atol 1e-5 (max abs err {err_gm:.2e})")
    pg_c = grid_of(presets.cornell())
    stats_gc = {}
    torch.cuda.synchronize()
    t0 = time.time()
    plain_gc = mk.render_megakernel_plain(packed, cp, 0, w, h, PHYSICAL_PLAIN_SPP, nb,
                                          sample_offset=spp, stats=stats_gc,
                                          packed_grid=pg_c)
    torch.cuda.synchronize()
    grid_plain_ms = (time.time() - t0) * 1e3
    same_gc = mk.render_megakernel(packed, cp, 0, w, h, PHYSICAL_PLAIN_SPP, nb,
                                   sample_offset=spp, packed_grid=pg_c)
    rate_gc, gap_gc, err_gc = match_stats(same_gc, plain_gc)
    check(rate_gc >= 0.995 and gap_gc <= 1e-3, "grid kernel disagrees with plain at full width")

    def launch_g(n_spp, **kw):
        def fn(k):
            mk.render_block_sums_cuda(packed, cp, 0, w, h, n_spp, nb, 0, w * h,
                                      sample_offset=(k + 1) * n_spp, **kw)
        return fn

    time_launches(launch_g(spp, packed_grid=pg_c), 1)
    grid_ms = time_launches(launch_g(spp, packed_grid=pg_c), 2)
    ms_again = time_launches(launch_g(spp), 2)
    grid_bound, grid_work = least_bound(packed.counts, stats_gc, spp / PHYSICAL_PLAIN_SPP,
                                        packed.table_bytes + 12 * w * h, 4 * pg_c.idx.numel())
    log(f"[grid main path] one launch, cornell {w}x{h} {nb} bounces {spp} spp: grid "
        f"{grid_ms:.1f} ms, linear {ms_again:.1f} ms (and {ms:.1f} ms in [bench]; "
        f"{NESTED_DEFAULT_RANGE_MS[0]}-{NESTED_DEFAULT_RANGE_MS[1]} ms before per-lane "
        f"regeneration); grid vs plain at "
        f"{PHYSICAL_PLAIN_SPP} spp (same samples) {rate_gc:.4%} of pixels, max abs err "
        f"{err_gc:.2e}, plain grid version {grid_plain_ms:.0f} ms; per path "
        f"{stats_gc['grid_slab_tests'] / stats_gc['paths']:.1f} box gates, "
        f"{(stats_gc.get('grid_sphere_tests', 0) + stats_gc.get('grid_triangle_tests', 0)) / stats_gc['paths']:.1f}"
        f" primitive tests; bound {grid_bound[0]:.2f} ms ({grid_bound[1]}; the grid's own "
        f"work {grid_work[0]:.2f} ms), kernel at {grid_bound[0] / grid_ms:.1%} of it")

    # the physical and the textured grid instantiations through the renderer
    grid_more = {}
    for label, scene_make, kw, idx, m_spp in (
            ("physical", presets.cornell, dict(physical=True), 1, PHYSICAL_PLAIN_SPP),
            ("textured", presets.textured, {}, 0, TEX_PLAIN_SPP)):
        scene = scene_make()
        mk.LAUNCHES_GRID[:] = [0, 0, 0]       # every count to 0 just before the path ...
        mk.LAUNCHES_TEXTURED[:] = [0, 0, 0]
        r = ProgressiveRenderer(scene, Camera(),
                                RenderConfig(width=w, height=h, max_bounces=nb, spp=256,
                                             engine="cuda", accel="grid", **kw))
        t0 = time.time()
        r.run()
        more_s = time.time() - t0
        launched = list(mk.LAUNCHES_GRID)      # ... and read just after
        check(launched[idx] > 0 and sum(launched) == launched[idx]
              and (label != "textured" or mk.LAUNCHES_TEXTURED[0] == launched[0])
              and bool(np.isfinite(r.radiance()).all()), f"grid {label} main path {launched}")
        packed_m, pg_m = mk.pack_scene(scene, dev), grid_of(scene)
        # the plain grid version at the path's width, another sample window
        stats_m = {}
        torch.cuda.synchronize()
        t0 = time.time()
        plain_m = mk.render_megakernel_plain(packed_m, cp, 0, w, h, m_spp, nb, stats=stats_m,
                                             sample_offset=256, packed_grid=pg_m, **kw)
        torch.cuda.synchronize()
        m_plain_ms = (time.time() - t0) * 1e3
        m_rate, m_gap, m_err = match_stats(
            mk.render_megakernel(packed_m, cp, 0, w, h, m_spp, nb, sample_offset=256,
                                 packed_grid=pg_m, **kw), plain_m)
        check(m_rate >= 0.995 and m_gap <= 1e-3, f"grid {label} disagrees with plain")
        m_ms = median_ms(lambda: mk.render_block_sums_cuda(packed_m, cp, 0, w, h, 256, nb, 0,
                                                           w * h, packed_grid=pg_m, **kw))
        m_bound, m_work = least_bound(packed_m.counts, stats_m, 256 / m_spp,
                                      packed_m.table_bytes + 12 * w * h, 4 * pg_m.idx.numel(),
                                      texture_flops(stats_m) * 256 / m_spp, physical=bool(kw))
        grid_more[label] = dict(launches=launched[idx], ms=m_ms, plain_ms=m_plain_ms,
                                max_abs_err=m_err, bound=m_bound, grid_work=m_work,
                                match_rate=m_rate, plain_spp=m_spp)
        log(f"[grid main path] ProgressiveRenderer(accel='grid'{', physical=True' if kw else ''}"
            f") {'textured' if label == 'textured' else 'cornell'} {w}x{h} {nb} bounces 256 spp:"
            f" {launched[idx]} launches, {more_s:.2f} s; one launch {m_ms:.1f} ms (median of "
            f"5); vs plain at {w}x{h} {m_spp} spp (same samples) {m_rate:.4%} of pixels, max abs "
            f"err {m_err:.2e}, plain version {m_plain_ms:.0f} ms; bound {m_bound[0]:.2f} ms "
            f"({m_bound[1]}; the grid's own work {m_work[0]:.2f} ms), kernel at "
            f"{m_bound[0] / m_ms:.1%} of it")

    # 14d. the 10k-primitive matrix: linear against grid
    gbw, gbh, gb_spp = GRID_BENCH["width"], GRID_BENCH["height"], GRID_BENCH["spp"]
    tw_, th_ = GRID_TALLY["width"], GRID_TALLY["height"]
    report["grid_bench"] = []
    for name, make in (("stress_dense(10000)", lambda: presets.stress_dense(10000)),
                       ("mesh_dense(4)", lambda: presets.mesh_dense(4))):
        scene = make()
        packed_b10 = mk.pack_scene(scene, dev)
        t0 = time.time()
        pg_b = grid_of(scene)
        b_build_s = time.time() - t0
        for b_nb in GRID_BENCH["bounces"]:
            stats_b = {}
            mk.render_megakernel_plain(packed_b10, cp, 0, tw_, th_, gb_spp, b_nb,
                                       stats=stats_b, packed_grid=pg_b)
            scale = gbw * gbh / (tw_ * th_)
            # one image either way: one bound for both, the smaller work's
            bnd, work_g = least_bound(packed_b10.counts, stats_b, scale,
                                      packed_b10.table_bytes + 12 * gbw * gbh,
                                      4 * pg_b.idx.numel())
            work_l = bound_of(flop_count(packed_b10.counts, stats_b, scale),
                              packed_b10.table_bytes + 12 * gbw * gbh)
            row = dict(scene=name, bounces=b_nb, grid_res=pg_b.meta[:3],
                       build_s=b_build_s, bound_ms=bnd[0], bound_by=bnd[1])
            for accel, kw in (("linear", {}), ("grid", dict(packed_grid=pg_b))):
                b_ms = median_ms(lambda: mk.render_block_sums_cuda(
                    packed_b10, cp, 0, gbw, gbh, gb_spp, b_nb, 0, gbw * gbh, **kw))
                if accel == "grid":
                    work = work_g
                    tests = (stats_b.get("grid_sphere_tests", 0)
                             + stats_b.get("grid_triangle_tests", 0))
                else:
                    work = work_l
                    sweep_prims = packed_b10.counts[0] + packed_b10.counts[1]
                    clear = stats_b["shadow_rays"] - stats_b["shadow_rays_occluded"]
                    tests = ((stats_b["path_bounces"] + clear) * sweep_prims
                             + stats_b["shadow_rays_occluded"])
                row[accel] = dict(ms=b_ms, mrays=gbw * gbh * gb_spp / b_ms / 1e3,
                                  tests_per_path=tests / stats_b["paths"],
                                  work_bound_ms=work[0])
            torch.cuda.synchronize()
            report["grid_bench"].append(row)
            lin, grd = row["linear"], row["grid"]
            log(f"[grid bench] {name} {gbw}x{gbh} {gb_spp} spp b={b_nb} (grid {pg_b.meta[:3]}, "
                f"{pg_b.meta[6]} + {pg_b.meta[8]} global primitives, built in {b_build_s:.2f} s):"
                f" linear {lin['ms']:.1f} ms = {lin['mrays']:.1f} M primary rays/s, "
                f"{lin['tests_per_path']:.0f} primitive tests per path, its work "
                f"{lin['work_bound_ms']:.2f} ms; grid {grd['ms']:.1f} ms = {grd['mrays']:.1f} M "
                f"primary rays/s, {grd['tests_per_path']:.0f} primitive tests per path, its work "
                f"{grd['work_bound_ms']:.3f} ms; bound {row['bound_ms']:.3f} ms ({row['bound_by']}"
                f"); grid / linear time {grd['ms'] / lin['ms']:.3f} "
                f"(tallies from the plain grid version at {tw_}x{th_} {gb_spp} spp)")

    # 14e. training through the grid
    grid_train = {}
    g_train = torch.rand((th, tw, 3), generator=g).to(dev)
    stats_tg = {}
    mk.render_megakernel_plain(packed_train, cp, 0, tw, th, tspp, tnb, stats=stats_tg,
                               packed_grid=grid_of(cornell))
    for mode, fields in TRAIN_FIELDS.items():
        stamps = []
        mk.LAUNCHES_GRID[:] = [0, 0, 0]   # every count to 0 just before the path ...
        vjp.LAUNCHES_BY_MODE.clear()
        t0 = time.time()
        _, params, losses = inverse.invert(
            start, cp, target_train, fields, tw, th, spp=tspp, steps=GRID_TRAIN_STEPS,
            lr=0.02, seed=0, max_bounces=tnb, engine="cuda", accel="grid",
            callback=lambda step, val, p: stamps.append(time.time()))
        torch.cuda.synchronize()
        k1g, k2g = mk.LAUNCHES_GRID[0], vjp.LAUNCHES_BY_MODE[(mode, False, True)]  # ... after
        check(k1g == GRID_TRAIN_STEPS and k2g == GRID_TRAIN_STEPS,
              f"grid train {mode}: {k1g} / {k2g} grid launches")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"grid train {mode}: the loss did not fall")
        pg_t = grid_of(cornell)
        k2_ms = median_ms(lambda: vjp.backward_rows_cuda(packed_train, cp, 0, tw, th, tspp,
                                                         tnb, g_train, full=mode == "full",
                                                         packed_grid=pg_t))
        # the kernels against the plain engine on the training step's own
        # inputs, as [grad bench] holds the linear ones
        loss_k = inverse.make_loss(start, cp, target_train, tw, th, tspp, tnb, engine="cuda",
                                   field_names=fields, accel="grid")
        v_kk, g_kk = inverse.value_and_grad(loss_k, inverse.extract_params(start, fields), 0)
        torch.cuda.synchronize()
        t0 = time.time()
        v_pp, g_pp = plain_step_in_chunks(fields, pg_t)
        torch.cuda.synchronize()
        p_ms = (time.time() - t0) * 1e3
        worst_t, rel_t, err_t, ok_t = grad_gap(g_kk, g_pp)
        check(ok_t, f"grid train {mode}: kernels vs plain at full size: {worst_t} off by "
              f"{rel_t:.2e} of max|g|")
        check(abs(float(v_kk) - float(v_pp)) <= 1e-5 * abs(float(v_pp)),
              f"grid train {mode}: losses differ ({float(v_kk)} vs {float(v_pp)})")
        visible = stats_tg["shadow_rays"] - stats_tg["shadow_rays_occluded"]
        rows = vjp._grad_rows(packed_train.counts, mode == "full")
        k2_bound, k2_work = least_bound(
            packed_train.counts, stats_tg, 1.0, packed_train.table_bytes + 12 * tw * th
            + 4 * rows, 4 * pg_t.idx.numel(),
            stats_tg["stored_bounces"] * REVERSE_BOUNCE_FLOPS[mode]
            + visible * NEE_PARTIAL_FLOPS[mode] + stats_tg["paths"] * EYE_VJP_FLOPS[mode])
        grid_train[mode] = dict(k1=k1g, k2=k2g, ms=k2_ms, plain_ms=p_ms, max_abs_err=err_t,
                                bound=k2_bound, grid_work=k2_work,
                                ms_per_step=(stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3)
        log(f"[grid train] invert(accel='grid') cornell {tw}x{th} {tspp} spp {tnb} bounces, "
            f"{mode}, {GRID_TRAIN_STEPS} Adam steps: loss {losses[0]:.3e} -> {losses[-1]:.3e}; "
            f"{grid_train[mode]['ms_per_step']:.2f} ms per step (linear: "
            f"{train[mode]['ms_per_step']:.2f} ms in [train]); {k1g} forward and {k2g} backward "
            f"grid launches; backward kernel through the grid {k2_ms:.2f} ms (linear "
            f"{bench[mode]['ms']:.2f} ms in [grad bench]), bound {k2_bound[0]:.3f} ms (the grid's "
            f"own work {k2_work[0]:.3f} ms); vs the plain engine at {tw}x{th} {tspp} spp worst "
            f"{worst_t} at {rel_t:.2e} of its max|g| (max abs err {err_t:.2e}), plain "
            f"value_and_grad step through the grid, {TRAIN_PLAIN_CHUNK} samples at a time, "
            f"{p_ms:.0f} ms")

    # 14f. the bf16 carries
    mk.LAUNCHES_BF16[:] = [0, 0, 0]   # every count to 0 just before the path ...
    torch.cuda.synchronize()
    t0 = time.time()
    bf_img = mk.render_megakernel(packed, cp, 0, w, h, spp, nb, state_bf16=True)
    torch.cuda.synchronize()
    bf_main_s = time.time() - t0
    launches_bf = list(mk.LAUNCHES_BF16)   # ... and read just after
    check(launches_bf == [1, 0, 0] and bool(torch.isfinite(bf_img).all()),
          f"bf16 main path launched {launches_bf}")
    bf_gap = (bf_img - main_img).abs()
    stats_bf = {}
    torch.cuda.synchronize()
    t0 = time.time()
    plain_bf = mk.render_megakernel_plain(packed, cp, 0, w, h, PHYSICAL_PLAIN_SPP, nb,
                                          sample_offset=spp, stats=stats_bf, state_bf16=True)
    torch.cuda.synchronize()
    bf_plain_ms = (time.time() - t0) * 1e3
    bf_rate, bf_mgap, bf_err = match_stats(
        mk.render_megakernel(packed, cp, 0, w, h, PHYSICAL_PLAIN_SPP, nb, sample_offset=spp,
                             state_bf16=True), plain_bf)
    check(bf_rate >= 0.995 and bf_mgap <= 1e-3, "bf16 kernel disagrees with plain")
    time_launches(launch_g(spp, state_bf16=True), 1)
    bf_ms = time_launches(launch_g(spp, state_bf16=True), 2)
    bf_flops = (flop_count(packed.counts, stats_bf, spp / PHYSICAL_PLAIN_SPP)
                + stats_bf["path_bounces"] * BF16_BOUNCE_FLOPS * spp / PHYSICAL_PLAIN_SPP)
    bf_bound = bound_of(bf_flops, packed.table_bytes + 12 * w * h)
    # the same samples in both images: what differs is the storage rounding
    # alone (2^-9 relative per store); the reference's bound (0.02 on a
    # 16x16 image, tests/test_pallas_cpu.py) taken relative above 1, where
    # the light's own pixels are
    bf_scaled = float((bf_gap / main_img.clamp_min(1.0)).max())
    bf_mean_gap = abs(float(bf_img.mean()) / float(main_img.mean()) - 1)
    log(f"[bf16] render_megakernel(state_bf16=True) cornell {w}x{h} {nb} bounces {spp} spp: "
        f"{launches_bf[0]} launch, {bf_main_s:.2f} s; vs the float32 2000-spp image (same "
        f"samples) max gap {float(bf_gap.max()):.2e} (at values up to "
        f"{float(main_img.max()):.3g}; {bf_scaled:.2e} relative above 1), mean gap "
        f"{float(bf_gap.mean()):.2e}, image means {bf_mean_gap:.2e} apart; vs plain bf16 at "
        f"{PHYSICAL_PLAIN_SPP} spp {bf_rate:.4%} of pixels, max abs err {bf_err:.2e}, plain "
        f"version {bf_plain_ms:.0f} ms; one launch {bf_ms:.1f} ms beside float32 "
        f"{ms_again:.1f} ms; bound {bf_bound[0]:.2f} ms")
    check(bf_scaled < 0.02 and bf_mean_gap < 0.01, "bf16 image too far from the float32 one")

    # ---- 15. K2's geo and physical modes ---------------------------------------------
    def k2_flops(counts, stats, mode, physical, geo, textured=False):
        """The backward kernel's float32 work in the paths ``stats`` describes
        (replay = one forward render of the estimator; the reverse sweep per
        stored bounce; per visible light sample; per path)."""
        visible = stats["shadow_rays"] - stats["shadow_rays_occluded"]
        flops = (flop_count(counts, stats, physical=physical)
                 + stats["stored_bounces"] * REVERSE_BOUNCE_FLOPS[mode]
                 + visible * NEE_PARTIAL_FLOPS[mode] + stats["paths"] * EYE_VJP_FLOPS[mode])
        if textured:
            flops += (texture_flops(stats) + stats["stored_bounces"] * TEX_REVERSE_FLOPS[mode]
                      + stats["normal_fetches"] * NMAP_PULLBACK_FLOPS)
        if physical:
            flops += (stats["stored_bounces"] * PHYS_REVERSE_BOUNCE_FLOPS
                      + stats["shadow_rays"] * (PHYS_LIGHT_VJP_FLOPS
                                                + (PHYS_GEO_LIGHT_FLOPS if geo else 0)))
        if geo:
            flops += stats["triangle_hits"] * GEO_TRI_HIT_FLOPS
            if textured:
                flops += (stats.get("tex_triangle_hits", 0) * GEO_UV_VERTEX_FLOPS
                          + stats["normal_fetches"] * GEO_TANGENT_EDGE_FLOPS)
            if not physical:
                flops += visible * GEO_LIGHT_VERTEX_FLOPS
        return flops

    def k2_registers(shared, textured, grid, physical, geo):
        """ptxas's registers of the backward kernel with these flags."""
        key = (f"megakernel_vjp/backward_kernel<1,{int(shared)},{int(textured)},{int(grid)},"
               f"{int(physical)},{int(geo)}>")
        return report["ptxas"][key]["registers"]

    new_k2 = {}   # the kernels line's entries of the new instantiations

    def new_mode_bench(label, scene, fields, dims, physical, accel="none", plain=True,
                       launches_from=None):
        """One gradient step of K2 in a new mode at ``dims`` = (w, h, spp,
        bounces): the value_and_grad step, the forward and backward kernels
        apart (medians of 5, launches counted over those six steps), registers,
        bound and, with ``plain``, the kernel's loss and gradients against
        the plain engine on the same inputs (2 samples per autograd graph)."""
        b_w, b_h, b_spp, b_nb = dims
        geo = bool(set(fields) & vjp.TRI_FIELDS)
        textured = scene.num_textures > 0
        grid = grid_of(scene) if accel == "grid" else None
        packed_b = mk.pack_scene(scene, dev)
        target_b = mk.render_megakernel(packed_b, cp, 1, b_w, b_h, b_spp, b_nb,
                                        physical=physical, packed_grid=grid)
        loss = inverse.make_loss(scene, cp, target_b * 0.5, b_w, b_h, b_spp, b_nb,
                                 engine="cuda", field_names=fields, accel=accel,
                                 physical=physical)
        check(loss.grad_mode == ("geo" if geo else "full"),
              f"{label}: make_loss picked {loss.grad_mode}")
        params = inverse.extract_params(scene, fields)
        vjp.LAUNCHES_BY_MODE.clear()   # every count to 0 just before the path ...
        ms_step = median_ms(lambda: inverse.value_and_grad(loss, params, 0))
        launched = dict(vjp.LAUNCHES_BY_MODE)   # ... and read just after
        key = (vjp._mode_name(True, physical, geo), textured, grid is not None)
        check(launched == {key: 6}, f"{label}: backward launches {launched} for 6 steps")
        n_b = b_w * b_h
        g_img = torch.rand((b_h, b_w, 3), generator=g).to(dev)
        ms_k1 = median_ms(lambda: mk.render_block_sums_cuda(packed_b, cp, 0, b_w, b_h, b_spp,
                                                            b_nb, 0, n_b, physical=physical,
                                                            packed_grid=grid))
        ms_k2 = median_ms(lambda: vjp.backward_rows_cuda(
            packed_b, cp, 0, b_w, b_h, b_spp, b_nb, g_img, full=True, physical=physical,
            geo=geo, tex_grads="textures" in fields, packed_grid=grid))
        route, scratch_bytes = vjp.LAST_ROUTE, 4 * vjp.LAST_STACK[1]
        # the paths' tally from the plain version, on up to 4 of the samples
        stats_b, s_spp = {}, min(b_spp, 4)
        mk.render_megakernel_plain(packed_b, cp, 0, b_w, b_h, s_spp, b_nb, stats=stats_b,
                                   physical=physical, packed_grid=grid)
        stats_b = {k: v * b_spp / s_spp for k, v in stats_b.items()}
        mode = "full"
        flops = k2_flops(packed_b.counts, stats_b, mode, physical, geo, textured)
        texels = packed_b.tex_counts[1] if "textures" in fields else 0
        rows = vjp._grad_rows(packed_b.counts, True, texels, physical, geo)
        planes = vjp._st_planes(True, textured, "textures" in fields, packed_b.tex_nmap,
                                physical)
        bound = bound_of(flops, packed_b.table_bytes + 12 * n_b + 4 * rows)
        entry = dict(label=label, dims=dims, ms_step=ms_step, ms_k1=ms_k1, ms=ms_k2,
                     bound=bound, route=route, rows=rows, launches=launched[key],
                     registers=k2_registers(route == "shared", textured, grid is not None,
                                            physical, geo),
                     scratch_bytes_ms=2 * 4 * planes * stats_b["stored_bounces"]
                     / PEAK_BYTES_PER_S * 1e3, scratch_bytes=scratch_bytes, plain_ms=None,
                     max_abs_err=None)
        if plain:
            v_k, g_k = inverse.value_and_grad(loss, params, 0)
            torch.cuda.synchronize()
            t0 = time.time()
            v_p, g_p = plain_step_in_chunks(fields, grid, scene=scene, target=target_b * 0.5,
                                            physical=physical, dims=dims)
            torch.cuda.synchronize()
            entry["plain_ms"] = (time.time() - t0) * 1e3
            worst, rel, err, ok = grad_gap(g_k, g_p)
            entry.update(max_abs_err=err, worst=worst, rel=rel)
            loss_gap = abs(float(v_k) - float(v_p)) / abs(float(v_p))
            log(f"[{'geo' if geo and not physical else 'physical'} vjp vs plain] {label} "
                f"{b_w}x{b_h} {b_spp} spp {b_nb} bounces ({len(fields)} fields, "
                f"{TRAIN_PLAIN_CHUNK} samples per autograd graph): loss gap {loss_gap:.1e}; "
                f"worst field {worst} at {rel:.2e} of its max|g| (max abs err {err:.2e}); "
                f"plain value_and_grad step {entry['plain_ms']:.0f} ms")
            check(loss_gap <= 1e-5, f"{label}: loss differs by {loss_gap:.2e}")
            check(ok, f"{label}: {worst} off by {rel:.2e} of max|g| at full size")
        if launches_from is not None:
            entry["launches_on"] = launches_from
        log(f"[{'geo' if geo and not physical else 'physical'} grad bench] {label} {b_w}x{b_h} "
            f"{b_spp} spp {b_nb} bounces ({', '.join(fields)}): value_and_grad step "
            f"{ms_step:.2f} ms = forward kernel {ms_k1:.2f} + backward kernel {ms_k2:.2f} + the "
            f"rest {ms_step - ms_k1 - ms_k2:.2f} (medians of 5); backward kernel "
            f"{entry['registers']} registers, {rows} gradient rows ({route} route), bound "
            f"{bound[0]:.4f} ms ({bound[1]}; {flops:.3e} float32 operations), kernel at "
            f"{bound[0] / ms_k2:.1%} of it; its checkpoints ({planes} planes per stored bounce) "
            f"{entry['scratch_bytes_ms']:.3f} ms at the memory rate; {launched[key]} backward "
            "launches over the six steps")
        return entry

    # 15a. the new modes against the plain engine on small inputs
    report["new_modes_vs_plain"] = {}
    small_cases = [
        ("color quad", lambda: presets.textured_quad(), GEO_FIELDS + ["textures"], False, "none"),
        ("color+normal quad", lambda: presets.textured_quad(nmap=True), GEO_FIELDS + ["textures"],
         False, "none"),
        ("color quad", lambda: presets.textured_quad(), ["materials.diffuse", "textures", "pl_pos"],
         True, "none"),
        ("color+normal quad", lambda: presets.textured_quad(nmap=True),
         ["materials.diffuse", "textures", "tri_v0", "tri_v1"], True, "none"),
        ("cornell", presets.cornell, PHYS_FIELDS, True, "grid"),
        ("stress_dense", lambda: presets.stress_dense(3000), PHYS_FIELDS, True, "none"),
    ]
    for name, make, fields, physical, accel in small_cases:
        scene = make()
        (v_k, g_k), (v_p, g_p) = both_engines(scene, fields, rand_target, gw, gh, 2, 4, 5,
                                              accel=accel, physical=physical)
        torch.cuda.synchronize()
        worst, rel, _, ok = grad_gap(g_k, g_p)
        loss_gap = abs(float(v_k) - float(v_p)) / abs(float(v_p))
        tag = "physical" if physical else "geo"
        log(f"[{tag} vjp vs plain] {name:18s} {gw}x{gh} {'through the grid ' if accel == 'grid' else ''}"
            f"{','.join(fields)}: loss gap {loss_gap:.1e}; worst field {worst} at {rel:.2e} "
            f"of its max|g|; rows {vjp.LAST_ROUTE} route")
        check(loss_gap <= 1e-5, f"{tag} vjp {name}: loss differs by {loss_gap:.2e}")
        check(ok, f"{tag} vjp {name}: {worst} off by {rel:.2e} of max|g|")
        report["new_modes_vs_plain"][f"{tag}/{name}/{accel}"] = (worst, rel)

    # 15b. each mode's gradient step at the training step's size, against the
    # plain engine there, and the same step twice
    train_dims = (tw, th, tspp, tnb)
    new_k2["geo"] = new_mode_bench("cornell", start, GEO_FIELDS, train_dims, False)
    new_k2["physical"] = new_mode_bench("cornell", start, PHYS_FIELDS, train_dims, True)
    new_k2["physical, geo"] = new_mode_bench(
        "cornell", start, PHYS_FIELDS + ["tri_v0", "tri_v1", "tri_v2"], train_dims, True)
    new_k2["physical, grid"] = new_mode_bench("cornell", start, PHYS_FIELDS, train_dims, True,
                                              accel="grid")
    new_k2["physical, textured"] = new_mode_bench(
        "color+normal quad", presets.textured_quad(nmap=True),
        ["materials.diffuse", "textures", "pl_pos"], (128, 128, 16, 4), True)
    for mode, fields, physical in (("geo", GEO_FIELDS, False), ("physical", PHYS_FIELDS, True)):
        loss = inverse.make_loss(start, cp, target_train, tw, th, tspp, tnb, engine="cuda",
                                 field_names=fields, physical=physical)
        params = inverse.extract_params(start, fields)
        (v1, g1), (v2, g2) = (inverse.value_and_grad(loss, params, 0) for _ in range(2))
        torch.cuda.synchronize()
        _, rel, _, _ = grad_gap(g1, g2)
        new_k2[mode]["two_runs_rel_diff"] = rel
        log(f"[{mode} vjp determinism] cornell {tw}x{th} {tspp} spp {tnb} bounces, the same "
            f"{loss.grad_mode} step twice: largest difference {rel:.2e} of a field's max|g|; "
            f"losses {'bit-equal' if float(v1) == float(v2) else 'differ'}")
        check(float(v1) == float(v2), f"{mode}: the forward render differs between two runs")
        check(rel <= 1e-4, f"two runs of one {mode} step differ by {rel:.2e} of max|g|")

    # 15c. the global-atomics route: geo rows of a 5,120-triangle mesh
    mesh = presets.mesh_dense(4)
    mesh_rows = vjp._grad_rows(mk.pack_scene(mesh, "cpu").counts, True, tri=True)
    # the plain engine's autograd graph at this size: the reckoning of its memory
    # from a 32x32 x 2 spp probe (the graph grows with pixels x samples)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    both_engines(mesh, GEO_FIELDS, rand_target, gw, gh, 2, tnb, 5)
    torch.cuda.synchronize()
    per_sample_px = (torch.cuda.max_memory_allocated() - base) / (gw * gh * 2)
    free = torch.cuda.mem_get_info()[0]
    fits = int(0.5 * free / per_sample_px)   # pixel-samples whose graph fits in half the free memory
    chunk_fits = fits >= tw * th * TRAIN_PLAIN_CHUNK
    shared_max = vjp._kernel_fn()[0].cpt_backward_shared_rows_max()
    log(f"[geo mesh] mesh_dense(4): {mesh.num_triangles} triangles, {mesh_rows} gradient rows "
        f"(a block's shared memory holds {shared_max}: global atomics); the plain engine's graph "
        f"takes {per_sample_px / 1e3:.1f} kB per pixel-sample (a {gw}x{gh} x 2 spp probe), "
        f"half the free {free / 1e9:.1f} GB holds {fits} pixel-samples: "
        f"{'one 2-sample chunk of the full step fits, so the plain engine runs the whole step' if chunk_fits else 'the full step does not fit'}")
    mesh_dims = train_dims if chunk_fits else (64, 64, 2, tnb)
    new_k2["geo, mesh"] = new_mode_bench("mesh_dense(4)", mesh, GEO_FIELDS, train_dims, False,
                                         plain=mesh_dims == train_dims)
    if mesh_dims != train_dims:
        # the largest share that fits: the kernel against the plain engine there
        e = new_mode_bench("mesh_dense(4) share", mesh, GEO_FIELDS, mesh_dims, False)
        new_k2["geo, mesh"].update(plain_ms=e["plain_ms"], max_abs_err=e["max_abs_err"],
                                   plain_shape=f"{mesh_dims}")
    check(new_k2["geo, mesh"]["route"] == "global", "geo mesh: rows took the shared route")

    # 15d. geo training: fit a mesh's vertices through a texture
    def meshfit_quad(shift):
        """A quad that fills the view, its random 16x16 texture the only
        image signal; ``shift`` moves its vertices along x."""
        from cuda_path_tracer_ss_torch.models.scene import MaterialSpec, SceneBuilder

        b = SceneBuilder()
        tex = np.random.default_rng(3).uniform(0.05, 1.0, (16, 16, 3)).astype(np.float32)
        m = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.9,
                                        texture=b.add_texture(tex)))
        s, n = 6.0, (0, 0, 1)
        v = [(-s + shift, -s, -4.0), (s + shift, -s, -4.0), (s + shift, s, -4.0),
             (-s + shift, s, -4.0)]
        uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
        b.add_triangle(v[0], v[1], v[2], n, n, n, m, uv=(uv[0], uv[1], uv[2]))
        b.add_triangle(v[0], v[2], v[3], n, n, n, m, uv=(uv[0], uv[2], uv[3]))
        b.add_point_light((0.0, 0.0, -0.5), (40.0, 40.0, 40.0))
        b.background = np.zeros(3, np.float32)
        return b.build()

    gt = GEO_TRAIN
    mf_truth, mf_start = meshfit_quad(0.0), meshfit_quad(gt["shift"])
    mf_fields = ["tri_v0", "tri_v1", "tri_v2"]
    mf_target = mk.render_megakernel(mk.pack_scene(mf_truth, dev), cp, 0, gt["width"],
                                     gt["height"], gt["spp"], gt["max_bounces"])
    want_v = inverse.extract_params(mf_truth, mf_fields)
    stamps = []
    vjp.LAUNCHES_BY_MODE.clear()   # every count to 0 just before the path ...
    t0 = time.time()
    _, mf_params, mf_losses = inverse.invert(
        mf_start, cp, mf_target, mf_fields, gt["width"], gt["height"], spp=gt["spp"],
        steps=gt["steps"], lr=gt["lr"], seed=0, max_bounces=gt["max_bounces"], engine="cuda",
        callback=lambda step, val, p: stamps.append(time.time()))
    torch.cuda.synchronize()
    mf_launches = dict(vjp.LAUNCHES_BY_MODE)   # ... and read just after
    err0 = max(float((inverse.get_field(mf_start, k) - want_v[k]).abs().max()) for k in mf_fields)
    err1 = max(float((mf_params[k] - want_v[k]).abs().max()) for k in mf_fields)
    geo_train = dict(ms_per_step=(stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3,
                     first_step_s=stamps[0] - t0, err0=err0, err1=err1,
                     launches=mf_launches.get(("geo", True, False), 0),
                     losses=(mf_losses[0], mf_losses[-1]))
    log(f"[geo train] invert a random-texture quad filling the view, {gt['width']}x"
        f"{gt['height']} {gt['spp']} spp {gt['max_bounces']} bounces, fields "
        f"{', '.join(mf_fields)} shifted {gt['shift']} along x, {gt['steps']} Adam steps (lr "
        f"{gt['lr']}): max vertex error {err0:.4f} -> {err1:.4f} ({err0 / err1:.1f}x), loss "
        f"{mf_losses[0]:.3e} -> {mf_losses[-1]:.3e}; {geo_train['ms_per_step']:.2f} ms per step "
        f"after a first step of {geo_train['first_step_s']:.2f} s; backward launches "
        f"{mf_launches}")
    check(all(np.isfinite(mf_losses)), "geo train: non-finite loss")
    check(err1 <= 0.1 * err0, f"geo train: the vertex error only fell {err0 / err1:.1f}x")
    check(mf_launches == {("geo", True, False): gt["steps"]},
          f"geo train: backward launches {mf_launches}")
    e = new_mode_bench("meshfit quad", mf_start, mf_fields, (gt["width"], gt["height"],
                                                             gt["spp"], gt["max_bounces"]),
                       False)
    new_k2["geo, textured"] = dict(e, launches=geo_train["launches"],
                                   launches_on=f"[geo train], {gt['steps']} Adam steps")

    # 15e. physical training: cornell's diffuse colours through the unbiased estimator
    phys_target = mk.render_megakernel(packed_train, cp, 0, tw, th, tspp, tnb, physical=True)
    phys_fields = ["materials.diffuse", "materials.spec_avg"]
    stamps = []
    vjp.LAUNCHES_BY_MODE.clear()   # every count to 0 just before the path ...
    mk.LAUNCHES_BY_VARIANT[:] = [0, 0, 0]
    t0 = time.time()
    _, pt_params, pt_losses = inverse.invert(
        start, cp, phys_target, phys_fields, tw, th, spp=tspp, steps=PHYS_TRAIN_STEPS, lr=0.02,
        seed=0, max_bounces=tnb, engine="cuda", physical=True,
        callback=lambda step, val, p: stamps.append(time.time()))
    torch.cuda.synchronize()
    pt_launches = (list(mk.LAUNCHES_BY_VARIANT), dict(vjp.LAUNCHES_BY_MODE))   # ... read after
    pt_err = float((pt_params["materials.diffuse"] - truth).abs()[lit].max())
    phys_train = dict(ms_per_step=(stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3,
                      first_step_s=stamps[0] - t0, losses=(pt_losses[0], pt_losses[-1]),
                      launches=pt_launches[1].get(("physical", False, False), 0))
    log(f"[physical train] invert(physical=True) cornell {tw}x{th} {tspp} spp {tnb} bounces, "
        f"fields {', '.join(phys_fields)}, diffuse + 0.2, {PHYS_TRAIN_STEPS} Adam steps: loss "
        f"{pt_losses[0]:.3e} -> {pt_losses[-1]:.3e} ({pt_losses[-1] / pt_losses[0]:.3f} of the "
        f"first), max|diffuse - truth| 0.2 -> {pt_err:.4f}; {phys_train['ms_per_step']:.2f} ms "
        f"per step; forward launches per variant {pt_launches[0]}, backward {pt_launches[1]}")
    check(all(np.isfinite(pt_losses)), "physical train: non-finite loss")
    check(pt_losses[-1] < 0.1 * pt_losses[0], f"physical train: loss only fell to "
          f"{pt_losses[-1] / pt_losses[0]:.3f} of its first value")
    check(pt_launches[0] == [0, PHYS_TRAIN_STEPS, 0]
          and pt_launches[1] == {("physical", False, False): PHYS_TRAIN_STEPS},
          f"physical train: launches {pt_launches}")
    new_k2["physical"].update(launches=phys_train["launches"],
                              launches_on=f"[physical train], {PHYS_TRAIN_STEPS} Adam steps")
    report.update(geo_train=geo_train, phys_train=phys_train,
                  new_k2={k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                          for k, v in new_k2.items()})

    # 15f. K2's checkpoint stacks: the scratch the wrapper allocates
    # (megakernel_vjp.py: capacity x slot floats x pixels) on every training
    # configuration above
    def k2_scratch(scene, dims, full, physical=False, tex_grads=False):
        s_w, s_h, s_spp, s_nb = dims
        packed_s = mk.pack_scene(scene, "cpu")
        slot = vjp._slot_floats(vjp._st_planes(full or physical, packed_s.textured,
                                               tex_grads, packed_s.tex_nmap, physical))
        capacity = vjp._stack_slots(s_spp, s_nb, s_w * s_h, slot, full or physical)
        return capacity * slot * s_w * s_h * 4, capacity, slot

    quads = {"color quad": presets.textured_quad(), "color+normal quad": presets.textured_quad(nmap=True)}
    scratch_cfgs = {f"cornell {m}": (start, train_dims, m != "linear", "physical" in m)
                    for m in ("linear", "full", "geo", "physical", "physical-geo")}
    scratch_cfgs.update({
        f"{name} {size}x{size} {b_spp} spp {b_nb} b": (
            quads[name], (size, size, b_spp, b_nb), "pl_pos" in fields, False, True)
        for name, size, b_spp, b_nb, fields in TEX_GRAD_BENCH})
    scratch_cfgs.update({
        "textured painting": (presets.textured(), (tt["width"], tt["height"], tt["spp"],
                                                   tt["max_bounces"]), True, False, True),
        "color+normal quad physical": (quads["color+normal quad"], (128, 128, 16, 4), True,
                                       True, True),
        "mesh_dense(4) geo": (mesh, train_dims, True),
        "mesh-fit quad geo": (mf_start, (gt["width"], gt["height"], gt["spp"],
                                         gt["max_bounces"]), True)})
    scratch = {k: k2_scratch(*v) for k, v in scratch_cfgs.items()}
    largest = max(scratch, key=lambda k: scratch[k][0])
    log("[k2 scratch] checkpoint stacks (bytes, slots per pixel, floats per slot): "
        + "; ".join(f"{k} {v[0] / 1e9:.3f} GB, {v[1]}, {v[2]}" for k, v in scratch.items())
        + f"; largest: {largest}, {scratch[largest][0] / 1e9:.3f} GB (budget "
        f"{vjp.SCRATCH_BUDGET / 1e9:.3f} GB)")
    check(scratch[largest][0] <= vjp.SCRATCH_BUDGET, "K2's scratch exceeds its budget")
    for mode in bench:
        check(scratch[f"cornell {mode}"][0] == bench[mode]["scratch_bytes"],
              f"[k2 scratch] cornell {mode}: {scratch[f'cornell {mode}'][0]} bytes, the "
              f"launch allocated {bench[mode]['scratch_bytes']}")
    report["k2_scratch"] = scratch

    # ---- 16. the eager engine -----------------------------------------------------
    t0 = time.time()
    eager = eager_phases(dev, cp, mk, inverse, start, target_train)
    eager["phases_s"] = time.time() - t0
    log(f"[eager] the five eager phases took {eager['phases_s']:.1f} s")
    report["eager"] = eager

    # ---- 16b. light paths on the eager engine, and the profiles -------------------
    t0 = time.time()
    eager_light = eager_light_phases(dev, cp, mk, lk, inverse)
    eager_light["phases_s"] = time.time() - t0
    t0 = time.time()
    eager_light["trace"] = trace_phases(dev, cp, mk)
    eager_light["trace_s"] = time.time() - t0
    log(f"[eager] the light-path phases took {eager_light['phases_s']:.1f} s, [trace] "
        f"{eager_light['trace_s']:.1f} s")
    report["eager_light"] = eager_light

    # ---- 17. the silhouette terms ----------------------------------------------------
    t0 = time.time()
    sil = silhouette_phases(dev, cp, mk, vjp, inverse)
    sil["phases_s"] = time.time() - t0
    log(f"[silhouette] the four silhouette phases took {sil['phases_s']:.1f} s")
    report["silhouette"] = sil
    new_k2["geo"]["launches_silhouette_step"] = sil["main"]["k2_per_step"]

    # ---- 17b. the multi-device path ---------------------------------------------------
    shard = sharded_phases(dev, cp, smi)
    report["sharded"] = shard

    # ---- 17c. the rest of the shell -------------------------------------------------
    if cold is not None:
        finish_cold_build(cache_report, cold, smi)
    t0 = time.time()
    shell = {"build_cache": cache_report,
             "native": native_phase(presets, main_rad, main_u8, smi),
             **cli_phases(main_rad, main_s, cache_report["warm"], smi),
             "interact": interact_phase(mk, smi), "view": view_phase(mk, smi)}
    shell["phases_s"] = time.time() - t0
    log(f"[shell] [native], [cli], [kill resume], [interact] and [view] took "
        f"{shell['phases_s']:.1f} s")
    report["shell"] = shell

    # ---- 18. report ----------------------------------------------------------------
    k1_common = {
        "route": "cuda",
        "source": "cuda_path_tracer_ss_torch/csrc/megakernel.cu",
        "replaces": "cuda_path_tracer_ss_tpu/ops/pallas/megakernel.py:1666",
        "library_ms": None,
    }
    k3_common = {
        "route": "cuda",
        "source": "cuda_path_tracer_ss_torch/csrc/lightkernel.cu",
        "replaces": "cuda_path_tracer_ss_tpu/ops/pallas/lightkernel.py:48",
    }
    variants = [{
        **k1_common,
        "name": "render_megakernel[physical]",
        "launches": launches_p[1],
        "max_abs_err": phys_err,
        "ms": phys_ms,
        "plain_ms": phys_plain_ms,
        "bound_ms": phys_bound[0],
        "bound_by": phys_bound[1],
        "shape": f"cornell {w}x{h}, {nb} bounces, {spp} spp, one launch",
        "plain_shape": f"cornell {w}x{h}, {nb} bounces, {PHYSICAL_PLAIN_SPP} spp",
        "ms_at_plain_shape": phys_ms_plain_shape,
        "match_rate": phys_rate,
        "share_of_bound": phys_bound[0] / phys_ms,
    }, {
        **k1_common,
        "name": "render_megakernel[bidir]",
        "launches": launches_b[0][2],
        "max_abs_err": eye_err,
        "ms": eye_ms,
        "plain_ms": eye_plain_ms,
        "bound_ms": eye_bound[0],
        "bound_by": eye_bound[1],
        "shape": f"{BIDIR['scene']} {bw}x{bh}, {bnb} bounces, {bspp} spp, nu {nu_main:g}, "
                 "one launch",
        "plain_shape": f"{BIDIR['scene']} {bw}x{bh}, {bnb} bounces, {BIDIR_PLAIN_SPP} spp",
        "ms_at_plain_shape": eye_ms_plain_shape,
        "match_rate": eye_rate,
        "share_of_bound": eye_bound[0] / eye_ms,
    }] + [{
        **k3_common,
        "name": f"light_{sink}[{'bidir' if label == 'light_bidir' else 'plain weights'}]",
        # main path: the image sink, once per render_bidir_fast (bidir) and per
        # render_lighttrace_fast (plain weights); the record sink is on no path
        "launches": ((launches_b[1][3] if label == "light_bidir" else launches_lt[2])
                     if sink == "image" else
                     (launches_b[1][1] if label == "light_bidir" else launches_lt[0])),
        "max_abs_err": v["image_max_abs_err"] if sink == "image" else v["max_abs_err"],
        "ms": v["image_ms"] if sink == "image" else v["ms"],
        "plain_ms": v["plain_ms"],
        "bound_ms": (v["image_bound"] if sink == "image" else v["bound"])[0],
        "bound_by": (v["image_bound"] if sink == "image" else v["bound"])[1],
        # the image's nearest library route: the record sink + index_add_ of
        # the non-empty records; no PyTorch call writes the records
        "library_ms": v["route_c_ms"] if sink == "image" else None,
        "shape": f"{BIDIR['scene']} {bw}x{bh}, {bnb} bounces, {n_paths} paths, one launch",
        "plain_shape": ("the same, plain records summed by index_add_" if sink == "image"
                        else "the same"),
        "registers": v[f"occupancy_{'image' if sink == 'image' else 'records'}"]["registers"],
        "lane_efficiency": v["lane_efficiency"]["warp_iterations_nested"],
        "lane_efficiency_regenerating": v["lane_efficiency"]["warp_iterations"],
        "match_rate": v["share"],
        "route_b_ms": v["route_b_ms"],
        "splat_ms": v["splat_ms"],
        "record_bytes_ms": v["record_bytes_ms"],
        "hottest_pixel_splats": v["hottest_pixel_splats"],
        "share_of_bound": ((v["image_bound"][0] / v["image_ms"]) if sink == "image"
                           else v["bound"][0] / v["ms"]),
    } for sink in ("records", "image") for label, v in light.items()]
    kernels = {"kernels": [{
        "name": "render_megakernel",
        "route": "cuda",
        "source": "cuda_path_tracer_ss_torch/csrc/megakernel.cu",
        "replaces": "cuda_path_tracer_ss_tpu/ops/pallas/megakernel.py:1666",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": f"cornell {w}x{h}, {nb} bounces, {bench_spp} spp, one launch",
        "plain_shape": f"cornell {w}x{h}, {nb} bounces, {PLAIN_SPP} spp",
        "ms_at_plain_shape": ms_plain_shape,
        "ms_fmad_true": ms_fmad,
        "match_rate": rate,
        "match_rate_fmad_true": rate_f,
        "bounces_per_path": bounces_per_path,
        "launches_training_path": {m: t["k1"] for m, t in train.items()},
        "launches_silhouette_step": sil["main"]["k1_per_step"],
        "ms_training_shape": ms_k1,
        "share_of_bound": bound_ms / ms,
        "registers": occ["registers"],
        "blocks_per_sm": occ["blocks_per_sm"],
        "tables_smem_bytes": occ["smem_bytes"],
        "lane_efficiency": eff,
    }] + variants + [{
        "name": f"backward_megakernel[{mode}]",
        "route": "cuda",
        "source": "cuda_path_tracer_ss_torch/csrc/megakernel_vjp.cu",
        "replaces": "cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py:269",
        "launches": train[mode]["k2"],
        "max_abs_err": b["max_abs_err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
        "shape": f"cornell {tw}x{th}, {tnb} bounces, {tspp} spp, one launch",
        "plain_shape": (f"the same, value_and_grad step of the plain engine, "
                        f"{TRAIN_PLAIN_CHUNK} samples at a time"),
        "ms_value_and_grad_step": b["ms_step"],
        "ms_per_training_step": train[mode]["ms_per_step"],
        "scratch_bytes_ms": b["scratch_bytes_ms"],
        "scratch_bytes": b["scratch_bytes"],
        "lane_efficiency": {k: v for k, v in k2_lanes[tspp].items() if k != "capacity"},
        "two_runs_rel_diff": determinism[mode],
        "share_of_bound": b["bound_ms"] / b["ms"],
    } for mode, b in bench.items()] + [{
        **k1_common,
        "name": f"render_megakernel[{label}, textured]",
        "launches": launches_t[0] if label == "default" else launches_tp[1],
        "max_abs_err": v["max_abs_err"],
        "ms": v["ms"],
        "plain_ms": v["plain_ms"],
        "bound_ms": v["bound"][0],
        "bound_by": v["bound"][1],
        "shape": f"textured {w}x{h}, {nb} bounces, {spp} spp, one launch",
        "plain_shape": f"textured {w}x{h}, {nb} bounces, {TEX_PLAIN_SPP} spp",
        "registers": v["registers"],
        "match_rate": v["match_rate"],
        "share_of_bound": v["bound"][0] / v["ms"],
    } for label, v in tex_bench.items()] + [{
        **k1_common,
        "name": "render_megakernel[bidir, textured]",
        "launches": launches_tb[2],
        "max_abs_err": tb_err,
        "ms": tb_ms,
        "plain_ms": tb_plain_ms,
        "bound_ms": tb_bound[0],
        "bound_by": tb_bound[1],
        "shape": f"textured {bw}x{bh}, {bnb} bounces, {bspp} spp, nu {nu_t:g}, one launch",
        "plain_shape": f"textured {bw}x{bh}, {bnb} bounces, {BIDIR_PLAIN_SPP} spp",
        "match_rate": tb_rate,
        "share_of_bound": tb_bound[0] / tb_ms,
    }] + [{
        "name": f"backward_megakernel[{mode}, textured]",
        "route": "cuda",
        "source": "cuda_path_tracer_ss_torch/csrc/megakernel_vjp.cu",
        "replaces": "cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py:269",
        "launches": b["launches"] if mode == "linear" else train_t["k2"],
        "max_abs_err": b["max_abs_err"],
        "ms": b["ms_k2"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound"][0],
        "bound_by": b["bound"][1],
        "library_ms": None,
        "shape": f"{b['name']} {b['size']}x{b['size']}, {b['bounces']} bounces, "
                 f"{b['spp']} spp, texel gradients on, one launch",
        "plain_shape": "the same, the plain engine's forward + backward",
        "launches_on": ("the textured grad bench's value_and_grad steps" if mode == "linear"
                        else "invert on the textured preset, fields textures"),
        "ms_value_and_grad_step": b["ms_step"],
        "rows_route": b["route"],
        "share_of_bound": b["bound"][0] / b["ms_k2"],
    } for mode, b in tex_k2.items()] + [{
        **k1_common,
        "name": "render_megakernel[grid]",
        "launches": launches_g[0],
        "max_abs_err": err_gc,
        "ms": grid_ms,
        "plain_ms": grid_plain_ms,
        "bound_ms": grid_bound[0],
        "bound_by": grid_bound[1],
        "shape": f"cornell {w}x{h}, {nb} bounces, {spp} spp, one launch, grid {pg_c.meta[:3]}",
        "plain_shape": f"cornell {w}x{h}, {nb} bounces, {PHYSICAL_PLAIN_SPP} spp",
        "registers": regs[(0, 0, 0, 1, 0)],
        "grid_work_bound_ms": grid_work[0],
        "match_rate": rate_gc,
        "share_of_bound": grid_bound[0] / grid_ms,
    }] + [{
        **k1_common,
        "name": f"render_megakernel[grid, {label}]",
        "launches": v["launches"],
        "max_abs_err": v["max_abs_err"],
        "ms": v["ms"],
        "plain_ms": v["plain_ms"],
        "bound_ms": v["bound"][0],
        "bound_by": v["bound"][1],
        "shape": f"{'textured' if label == 'textured' else 'cornell'} {w}x{h}, {nb} bounces, "
                 "256 spp, one launch",
        "plain_shape": f"the same scene at {w}x{h}, {nb} bounces, {v['plain_spp']} spp",
        "grid_work_bound_ms": v["grid_work"][0],
        "match_rate": v["match_rate"],
        "share_of_bound": v["bound"][0] / v["ms"],
    } for label, v in grid_more.items()] + [{
        **k1_common,
        "name": "render_megakernel[bf16]",
        "launches": launches_bf[0],
        "max_abs_err": bf_err,
        "ms": bf_ms,
        "plain_ms": bf_plain_ms,
        "bound_ms": bf_bound[0],
        "bound_by": bf_bound[1],
        "shape": f"cornell {w}x{h}, {nb} bounces, {spp} spp, one launch, state_bf16",
        "plain_shape": f"cornell {w}x{h}, {nb} bounces, {PHYSICAL_PLAIN_SPP} spp",
        "max_gap_to_float32": float(bf_gap.max()),
        "mean_gap_to_float32": float(bf_gap.mean()),
        "match_rate": bf_rate,
        "share_of_bound": bf_bound[0] / bf_ms,
    }] + [{
        "name": f"backward_megakernel[{mode}, grid]",
        "route": "cuda",
        "source": "cuda_path_tracer_ss_torch/csrc/megakernel_vjp.cu",
        "replaces": "cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py:269",
        "launches": v["k2"],
        "max_abs_err": v["max_abs_err"],
        "ms": v["ms"],
        "plain_ms": v["plain_ms"],
        "bound_ms": v["bound"][0],
        "bound_by": v["bound"][1],
        "library_ms": None,
        "shape": f"cornell {tw}x{th}, {tnb} bounces, {tspp} spp, one launch, grid",
        "plain_shape": (f"the same, value_and_grad step of the plain engine through the grid, "
                        f"{TRAIN_PLAIN_CHUNK} samples at a time"),
        "ms_per_training_step": v["ms_per_step"],
        "grid_work_bound_ms": v["grid_work"][0],
        "share_of_bound": v["bound"][0] / v["ms"],
    } for mode, v in grid_train.items()] + [{
        "name": f"backward_megakernel[{label}]",
        "route": "cuda",
        "source": "cuda_path_tracer_ss_torch/csrc/megakernel_vjp.cu",
        "replaces": "cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py:269",
        "launches": v["launches"],
        "max_abs_err": v["max_abs_err"],
        "ms": v["ms"],
        "plain_ms": v["plain_ms"],
        "bound_ms": v["bound"][0],
        "bound_by": v["bound"][1],
        "library_ms": None,
        "shape": f"{v['label']} {v['dims'][0]}x{v['dims'][1]}, {v['dims'][3]} bounces, "
                 f"{v['dims'][2]} spp, one launch",
        "plain_shape": v.get("plain_shape", (f"the same, value_and_grad step of the plain "
                                             f"engine, {TRAIN_PLAIN_CHUNK} samples at a time")),
        "launches_on": v.get("launches_on", "six value_and_grad steps at that shape"),
        **({"launches_silhouette_step": v["launches_silhouette_step"]}
           if "launches_silhouette_step" in v else {}),
        "ms_value_and_grad_step": v["ms_step"],
        "registers": v["registers"],
        "rows": v["rows"],
        "rows_route": v["route"],
        "scratch_bytes_ms": v["scratch_bytes_ms"],
        "scratch_bytes": v["scratch_bytes"],
        "share_of_bound": v["bound"][0] / v["ms"],
    } for label, v in new_k2.items()]}
    # the sharded path's launches and times beside each kernel it runs
    for entry in kernels["kernels"]:
        case = SHARDED_KERNEL_CASES.get(entry["name"])
        if case:
            one, four = shard["nccl"]["cases"][case], shard["x4"]["cases"][case]
            k = ("K1", "K2", "K3").index(KERNEL_OF[entry["name"].split("[")[0]])
            entry["sharded"] = {
                "case": case, "launches_1_rank_nccl": one["launches"][k],
                "launches_per_rank_4_gloo": four["launches"][k], "ms_1_rank_nccl": one["ms"],
                "ms_4_ranks_gloo": four["ms"], "ms_unsharded": one["unsharded_ms"]}
    report.update(grid_main_path_s=grid_main_s, grid_train={
        m: {k: v for k, v in t.items() if k != "bound"} for m, t in grid_train.items()},
        bf16_main_path_s=bf_main_s)
    report.update(textured_main_path_s=tex_main_s, textured_train=train_t,
                  textured_grad_bench=[{k: v for k, v in e.items()
                                        if k not in ("packed", "g_img")}
                                       for e in tex_grad_bench],
                  textured_train_losses=(losses_tt[0], losses_tt[-1]))
    report.update(kernels=kernels["kernels"], main_path_s=main_s, train=train,
                  physical_main_path_s=phys_main_s, bidir_main_path_s=bidir_main_s,
                  render_bidir_fast_ms=bidir_ms, light_two_runs_gap=two_runs_gap,
                  light_bench=light,
                  main_path_passes=[m["pass_samples"] for m in passes],
                  total_s=time.time() - t_start)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for path in (png, png_p, png_b, png_t):
            with open(path, "rb") as src, \
                    open(os.path.join(args.out_dir, os.path.basename(path)), "wb") as dst:
                dst.write(src.read())
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            # numpy / torch scalars (float32 sums of the phases) as numbers
            json.dump(report, f, indent=1, default=lambda o: o.item())
    out_dir_ctx.cleanup()
    log(f"[done] {time.time() - t_start:.0f} s")
    log(smi)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}),  # device 0 alone is driven
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
