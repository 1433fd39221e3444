#!/usr/bin/env python3
"""K1, K2 and K3 (the port's forward-render, replay-VJP and light-tracing
kernels, ``csrc/megakernel.cu``, ``csrc/megakernel_vjp.cu`` and
``csrc/lightkernel.cu``) on one CUDA device, in turns: against the kernels of
another tree, and against patched copies of this tree that build their
alternatives.

Run from the repository root, with the other tree (a commit taken with
``git archive`` into a git-ignored directory) as ``--parent``::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 k1_turns.py --parent build/parent [--kernels k1|k2|k3|both|all]

Every kernel is launched through its own tree's package: the other tree's
``cuda_path_tracer_ss_torch/`` and the patched copies of this one are copied
under ``build/k1_turns/<label>/cpt_<label>/`` and imported under that name,
so each builds its library into its own ``build/`` with its own
``utils/build.py``. The copies of this tree differ from it in the edits of
``PATCHES``, which carry the code of each alternative:

- ``bounds6`` / ``bounds8``: ``__launch_bounds__(THREADS_PER_BLOCK, n)`` on
  ``render_kernel``;
- ``global_tables``: ``MAX_STAGED_BYTES = 0``, the small tables read from
  global memory in every scene;
- ``strided``: K2's checkpoint slots strided over the lanes,
  ``[slot][plane][thread]``, moved one float at a time, in place of each
  lane's own slots;
- ``camera_atomics``: K2's camera rows added with shared-memory (or global)
  atomics as every other row, in place of the per-thread columns;
- ``stack1`` / ``stack2`` / ``stack4``: K2's stacks sized by the wrapper for
  at most 1 / 2 / 4 paths per round (``_stack_slots``);
- ``k2_bounds5``: ``__launch_bounds__(THREADS_PER_BLOCK, 5)`` on
  ``backward_kernel`` (at most 96 registers);
- ``k3_regenerating``: K3 on a persistent grid (resident blocks per SM x
  SMs, at most a block per 128 paths) whose lanes regenerate paths — lane
  ``l`` traces paths ``l, l + n_lanes, ...``, one bounce per iteration,
  opening its next path as soon as one ends — in place of one path per
  lane;
- ``k3_float4``: K3's image sink adds a splat with one ``float4`` atomic
  into a ``[width * height, 4]`` image (the wrapper returns its first three
  columns), in place of three ``float`` atomics into ``[width * height, 3]``.

K1's phases (``--kernels k1`` or ``both``), each printed as it ends and kept
in ``--out`` (JSON):

1. ``[build]`` the five libraries side by side; registers and spills of
   every instantiation, and resident blocks per SM and staged table bytes of
   the default and physical instantiations on cornell and of the default on
   ``textured``. ``[staging rule]`` where this tree's kernel stops staging
   the tables as a scene grows: ``stress_dense(n)`` over a range of n.
2. ``[bit identity]`` cornell 800x800, 64 spp, 8 bounces: the sums of both
   trees' kernels, compared bit for bit, in the default, physical and
   bidirectional instantiations, on ``textured`` and through the grid.
3. ``[turns tree]`` other tree, this tree, this tree, other tree (medians of
   5 single launches each): cornell 800x800 x 2000 spp x 8 bounces, default
   and physical; the training forward, cornell 256x256 x 16 spp x 8 bounces;
   the 10k-primitive matrix, ``stress_dense(10000)`` and ``mesh_dense(4)`` at
   400x400 x 16 spp, bounce caps 1 and 8, linear and through the grid.
4. ``[turns bounds]`` the default and physical instantiations at 2000 spp
   with no launch bound and with ``bounds6`` / ``bounds8``, in turns (A B C
   C B A).
5. ``[turns tables]`` the small tables in shared memory (this tree) against
   global memory (``global_tables``): cornell default and physical and
   ``textured`` default at 2000 spp, ``PAIRS`` pairs, the side that runs
   first alternating; each side of a pair is the median of 3 launches. Per
   case: each side's median and quartiles, the pairs shared memory wins, and
   whether that is a gain (wins in at least 9 of 10 pairs, and the medians
   differ by more than the global side's interquartile range).
6. ``[lanes]`` the lane efficiency of K1's regenerating schedule and of the
   nested one (live bounces over 32 x the warps' loop iterations, the plain
   version's tally) on a band of 32 rows across the middle of the 800x800
   image, 8 bounces, 16 / 64 / 256 spp (cornell default and physical,
   ``textured`` default).

K2's phases (``--kernels k2`` or ``both``), on the cases of ``K2_CASES``:
cornell 256x256 x 16 spp x 8 bounces in grad modes linear, full, geo,
physical, physical + geo and physical through the grid; the color+normal
quad, physical with texel gradients, 128x128 x 16 spp x 4 bounces; the
mesh-fit quad, geo, 128x128 x 4 spp x 2 bounces; and, once,
``mesh_dense(4)`` geo at 256x256 (global atomics):

7. ``[k2 build]`` the four K2 libraries side by side; registers and spills
   of all 32 instantiations, other tree -> this tree, and of the patched
   copies.
8. ``[k2 rows]`` each case's gradient rows from both trees and the patched
   copies, for the same cotangent: the largest difference over the largest
   row (the bound: 1e-4); ``stress_dense(3000)`` at 32x32 for the
   global-atomics route of full and physical mode. ``[k2 camera rows]``
   there, the 13 camera rows alone, each difference over its own row: this
   tree against the other, each tree run twice, and (with g++ on the
   machine) each tree against the host build's float64 sums of the same
   contributions, also over the sum of their magnitudes.
9. ``[k2 turns tree]`` other tree, this tree, this tree, other tree, medians
   of 5 launches (10 calls each below 5 ms); ``mesh_dense(4)`` one turn each.
10. ``[k2 turns layout]`` each lane's own slots (this tree) against the
    strided slots (``strided``): cornell linear, full and physical, ``PAIRS``
    pairs each, scored as in phase 5 (the sum of the pairs won decides).
11. ``[k2 turns camera]`` camera columns (this tree) against camera atomics
    (``camera_atomics``): cornell full, ``PAIRS`` pairs, scored as in phase 5.
12. ``[k2 turns stack]`` this tree against ``stack1`` / ``stack2`` /
    ``stack4`` in cornell linear, full and physical, and against
    ``k2_bounds5`` in cornell linear: ``PAIRS`` pairs each, scored as in
    phase 5 with the copy as the side that must win.

K3's phases (``--kernels k3`` or ``all``), on caustic 512x512, 8 bounces,
2,097,152 light paths, with plain weights and with the bidirectional ones
(nu = 2,097,152 / 256):

13. ``[k3 build]`` the light-kernel libraries of both trees and of the two
    copies side by side; registers and spills of every instantiation (the
    other tree: <bidir>; this tree: <bidir, image sink>).
14. ``[k3 image]`` ``render_lighttrace_fast`` of both trees — the other
    tree's record kernel + ``index_add_``, this tree's image sink — their
    images compared (largest difference over the largest value), and in
    turns other, this, this, other (medians of 5).
    ``[k3 bidir]`` ``render_bidir_fast`` at 256 spp the same way.
15. ``[k3 lanes]`` the lane efficiency of K3's bounce loop one path per
    lane (this tree) and regenerating over the lanes the card holds at once,
    the plain version's tally; and the image sink of both schedules timed on
    the emission vertex alone (``max_bounces`` 0) and whole.
16. ``[k3 turns schedule]`` the regenerating schedule (``k3_regenerating``)
    against one path per lane (this tree), image sink, ``PAIRS`` pairs in
    each weight mode, each side the median of 3 launches of 5 calls; it
    replaces one path per lane only if it wins at least 9 of 10 pairs in each
    mode and the medians differ by more than this tree's interquartile range.
17. ``[k3 turns splat]`` ``k3_float4`` against this tree's three ``float``
    atomics, the same way.

K2's split schedule (``--kernels k2split``: phase 18 alone):

18. ``[k2 split build]`` registers and spills of K2 physical's untextured
    instantiations (fused, replay, reverse) in this tree, the other tree
    and two copies: ``k2_fused_bounds4`` (the fused kernel, never split,
    under ``__launch_bounds__(THREADS_PER_BLOCK, 4)``) and ``k2_split_free``
    (the split without a bound); ``[k2 split occupancy]`` resident blocks per
    SM of each; ``[k2 split rows]`` the rows of cornell physical and physical
    through the grid at 256x256 x 16 spp x 8 b from all four against the
    other tree's, with each call's schedule and resident-grid count;
    ``[k2 split turns]`` the four in turns, a b c d d c b a thrice (a the
    other tree, b ``k2_fused_bounds4``, c ``k2_split_free``, d this tree),
    medians of 5 launches; ``[k2 fused turns]`` the cases that keep the
    fused launch (cornell linear, full, geo, physical + geo, linear and full
    through the grid, the color+normal quad physical, the mesh-fit quad
    geo), other tree against this tree in turns.

Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "cuda_path_tracer_ss_torch"

FULL = dict(width=800, height=800, max_bounces=8, spp=2000)
TRAIN = dict(width=256, height=256, max_bounces=8, spp=16)
MATRIX = dict(width=400, height=400, spp=16, bounces=(1, 8))
BITS_SPP = 64
LANE_SPP = (16, 64, 256)
PAIRS = 10
STAGING_SPHERES = (1000, 2000, 2200, 2300, 2400)

# K2's cases: label -> (scene, (width, height, spp, bounces), backward_rows_cuda
# flags); the scenes are built by each tree's own modules (Tree.scene)
K2_TRAIN = (256, 256, 16, 8)
K2_CASES = {
    "cornell linear": ("cornell", K2_TRAIN, {}),
    "cornell full": ("cornell", K2_TRAIN, dict(full=True)),
    "cornell geo": ("cornell", K2_TRAIN, dict(geo=True)),
    "cornell physical": ("cornell", K2_TRAIN, dict(physical=True)),
    "cornell physical+geo": ("cornell", K2_TRAIN, dict(physical=True, geo=True)),
    "cornell physical grid": ("cornell", K2_TRAIN, dict(physical=True, grid=True)),
    "color+normal quad physical": ("color+normal quad", (128, 128, 16, 4),
                                   dict(physical=True, tex_grads=True)),
    "mesh-fit quad geo": ("mesh-fit quad", (128, 128, 4, 2), dict(geo=True)),
}
K2_ONCE = {"mesh_dense(4) geo": ("mesh_dense(4)", K2_TRAIN, dict(geo=True))}
K2_GLOBAL = {  # the global-atomics route of full and physical mode, rows only
    "stress_dense(3000) full": ("stress_dense(3000)", (32, 32, 2, 4), dict(full=True)),
    "stress_dense(3000) physical": ("stress_dense(3000)", (32, 32, 2, 4),
                                    dict(physical=True)),
}
K2_ROWS_BOUND = 1e-4

# K3's cases: caustic 512x512, 8 bounces, 2,097,152 light paths, plain weights
# and the bidirectional ones of render_bidir_fast at 256 spp
K3 = dict(scene="caustic", width=512, height=512, max_bounces=8, n_paths=2_097_152, spp=256)
K3_NU = {"plain weights": None, "bidir": K3["n_paths"] / K3["spp"]}
K3_SEED = 1  # any fixed light seed

# label -> the edits of its copy: (file under the package, its text, the
# replacement), each text occurring once
KERNEL = "__global__ void render_kernel("
K2_KERNEL = "__global__ void backward_kernel("
K2_SPLIT_KERNEL = ("__global__ void __launch_bounds__(THREADS_PER_BLOCK, SPLIT_MIN_BLOCKS)\n"
                   "    backward_kernel(")
K2_SPLIT_RULE = ("    return (physical and not geo and not textured\n"
                 "            and capacity == max(max_bounces, 1) * spp)")
STACK_PATHS = "    paths = min(spp, max(1, SCRATCH_BUDGET // (span * slot_floats * 4 * n)))"
# K3's regenerating schedule: its lane step, its kernel body and its grid
K3_KERNEL = "template <bool BIDIR, bool SPLAT>\n__global__ void light_kernel("
K3_LANE_STEP = """// A lane's current path (local index) and that path's carries.
struct LightLane {
    cpt::LightPathState st;
    int local;
    bool fresh;  // the lane opens its path in its next step
};

// One bounce of the lane's path, opened first when its last path ended;
// false once the lane has no path left.
template <bool BIDIR, class Sink>
__device__ __forceinline__ bool light_lane_step(const cpt::SceneTables& sc,
                                                const cpt::LightParams& p, int n_lanes,
                                                LightLane& ln, const Sink& sink) {
    while (ln.local < p.n_local) {
        if (ln.fresh) {
            ln.fresh = false;
            if (!cpt::start_light_path<BIDIR>(sc, p, ln.local, ln.st, sink)) {
                ln.fresh = true;
                ln.local += n_lanes;
                continue;
            }
        }
        if (!cpt::light_bounce<BIDIR>(sc, p, ln.local, ln.st, sink)) {
            ln.fresh = true;
            ln.local += n_lanes;
        }
        return true;
    }
    return false;
}

"""
K3_ONE_PATH = """    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n_local) return;
    // the JAX light kernel takes no grid: linear sweeps, folded at compile time
    const cpt::SceneTables tables = cpt::grid_tables<false>(sc);
    if constexpr (SPLAT) {
        cpt::light_path<BIDIR>(tables, p, i, ImageSink{img});
    } else {
        cpt::light_path<BIDIR>(tables, p, i, records);
    }"""
K3_REGENERATING = """    const cpt::SceneTables tables = cpt::grid_tables<false>(sc);
    const int n_lanes = gridDim.x * blockDim.x;
    LightLane ln;
    ln.local = blockIdx.x * blockDim.x + threadIdx.x;
    ln.fresh = true;
    if constexpr (SPLAT) {
        const ImageSink sink{img};
        while (light_lane_step<BIDIR>(tables, p, n_lanes, ln, sink)) {
        }
    } else {
        while (light_lane_step<BIDIR>(tables, p, n_lanes, ln, records)) {
        }
    }"""
K3_GRID = ("    const long long blocks = ((long long)n_local + THREADS_PER_BLOCK - 1) / "
           "THREADS_PER_BLOCK;")
K3_PERSISTENT_GRID = """    int blocks_per_sm = 0, sms = 0;
    const cudaError_t err = residency(light_kernel_of(bidir, splat), blocks_per_sm, sms);
    if (err != cudaSuccess) return (int)err;
    const long long needed = ((long long)n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    const long long resident = (long long)blocks_per_sm * sms;
    const long long blocks = needed < resident ? needed : resident;"""
PATCHES = {
    "bounds6": [("csrc/megakernel.cu", KERNEL,
                 "__global__ void __launch_bounds__(THREADS_PER_BLOCK, 6) render_kernel(")],
    "bounds8": [("csrc/megakernel.cu", KERNEL,
                 "__global__ void __launch_bounds__(THREADS_PER_BLOCK, 8) render_kernel(")],
    "global_tables": [("csrc/megakernel.cu", "constexpr int MAX_STAGED_BYTES = 48 * 1024;",
                       "constexpr int MAX_STAGED_BYTES = 0;")],
    # K2's checkpoint slots strided over the launch's threads, [slot][plane][thread],
    # moved one float at a time
    "strided": [
        ("csrc/megakernel_vjp.cuh",
         "    CPT_HD float* at(int k, int q) const { return base + (size_t)k * slot_floats + q; }",
         "    size_t stride;\n    CPT_HD float* at(int k, int q) const {\n"
         "        return base + ((size_t)k * slot_floats + q) * stride;\n    }"),
        ("csrc/megakernel_vjp.cuh", "#if defined(__CUDACC__)\n        const float4 v",
         "#if 0\n        const float4 v"),
        ("csrc/megakernel_vjp.cuh", "#if defined(__CUDACC__)\n        *reinterpret_cast<float4*>",
         "#if 0\n        *reinterpret_cast<float4*>"),
        ("csrc/megakernel_vjp.cu",
         "        st.base = scratch + (size_t)i * capacity * T.slot_floats;",
         "        st.base = scratch + (size_t)i;\n        st.stride = (size_t)p.n_local;")],
    # K2's camera rows added with atomics, as every other row
    "camera_atomics": [
        ("csrc/megakernel_vjp.cu", "    constexpr bool COLUMNS = FULL && PHASE != PHASE_REPLAY;",
         "    constexpr bool COLUMNS = false;"),
        ("csrc/megakernel_vjp.cu",
         "(any_full && phase != PHASE_REPLAY ? (size_t)cpt::CAM_ROWS * CAM_PITCH : 0)", "0")],
    # K2's stack sized for at most 1 / 2 / 4 paths per round
    **{f"stack{k}": [("ops/cuda/megakernel_vjp.py", STACK_PATHS,
                      STACK_PATHS.replace("min(spp, ", f"min(spp, {k}, "))] for k in (1, 2, 4)},
    # K2's fused launch held to 5 resident blocks of 128 threads per SM (at
    # most 96 registers)
    "k2_bounds5": [("csrc/megakernel_vjp.cu", K2_KERNEL,
                    "__global__ void __launch_bounds__(THREADS_PER_BLOCK, 5) backward_kernel(")],
    # (b) K2 physical fused, never split, under the split launches' bound of
    # 4 resident blocks per SM (at most 128 registers)
    "k2_fused_bounds4": [
        ("csrc/megakernel_vjp.cu", K2_KERNEL,
         "__global__ void __launch_bounds__(THREADS_PER_BLOCK, "
         "PHYSICAL && !GEO && !TEXTURED ? SPLIT_MIN_BLOCKS : 1) backward_kernel("),
        ("ops/cuda/megakernel_vjp.py", K2_SPLIT_RULE, "    return False")],
    # (c) K2 physical split, its two launches without a launch bound
    "k2_split_free": [("csrc/megakernel_vjp.cu", K2_SPLIT_KERNEL,
                       "__global__ void backward_kernel(")],
    # K3 on a persistent grid whose lanes regenerate paths
    "k3_regenerating": [
        ("csrc/lightkernel.cu", K3_KERNEL, K3_LANE_STEP + K3_KERNEL),
        ("csrc/lightkernel.cu", K3_ONE_PATH, K3_REGENERATING),
        ("csrc/lightkernel.cu", K3_GRID, K3_PERSISTENT_GRID)],
    # K3's image sink with one float4 atomic per splat into [width * height][4]
    "k3_float4": [
        ("csrc/lightkernel.cu",
         "        float* px = img + 3 * (size_t)pixel;\n"
         "        atomicAdd(px, r);\n        atomicAdd(px + 1, g);\n        atomicAdd(px + 2, b);",
         "        atomicAdd(reinterpret_cast<float4*>(img) + pixel, make_float4(r, g, b, 0.0f));"),
        ("ops/cuda/lightkernel.py",
         "            out = torch.zeros((width * height, 3), dtype=torch.float32,\n"
         "                              device=packed.device)\n"
         "            err = lib.cpt_light_image(*args, out.data_ptr(), stream)",
         "            out = torch.zeros((width * height, 4), dtype=torch.float32,\n"
         "                              device=packed.device)\n"
         "            err = lib.cpt_light_image(*args, out.data_ptr(), stream)\n"
         "            out = out[:, :3]")],
}
K1_COPIES = ("bounds6", "bounds8", "global_tables")
K2_COPIES = ("strided", "camera_atomics", "stack1", "stack2", "stack4", "k2_bounds5")
K2_SPLIT_COPIES = ("k2_fused_bounds4", "k2_split_free")
# The split schedule's cases, and the cases that keep the fused launch
K2_SPLIT_CASES = ("cornell physical", "cornell physical grid")
K2_FUSED_CASES = {**{c: K2_CASES[c] for c in (
    "cornell linear", "cornell full", "cornell geo", "cornell physical+geo",
    "color+normal quad physical", "mesh-fit quad geo")},
    "cornell linear grid": ("cornell", K2_TRAIN, dict(grid=True)),
    "cornell full grid": ("cornell", K2_TRAIN, dict(full=True, grid=True))}
K3_COPIES = ("k3_regenerating", "k3_float4")


def log(msg: str) -> None:
    print(msg, flush=True)


def launch_ms(fn, reps: int = 5, inner: int = 1) -> list:
    """The time in ms (CUDA events) of each of ``reps`` runs of ``inner``
    calls of ``fn``, per call."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def median_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median of ``launch_ms`` after one warm-up call."""
    fn()
    return float(np.median(launch_ms(fn, reps, inner)))


def copy_package(src_root: str, label: str, patch=None):
    """The package of tree ``src_root`` copied to
    ``build/k1_turns/<label>/cpt_<label>/`` (its files edited as ``patch``
    says) and imported under that name."""
    base = os.path.join(ROOT, "build", "k1_turns", label)
    dst = os.path.join(base, f"cpt_{label}")
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(os.path.join(src_root, PACKAGE), dst,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for source, old, new in patch or ():
        path = os.path.join(dst, source)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{label}: {old!r} occurs {text.count(old)} times in {path}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    sys.path.insert(0, base)
    return importlib.import_module(f"cpt_{label}")


class Tree:
    """One tree's package, with its scenes packed by its own ``pack_scene``."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.mk = importlib.import_module(pkg.__name__ + ".ops.cuda.megakernel")
        self.vjp = importlib.import_module(pkg.__name__ + ".ops.cuda.megakernel_vjp")
        self.presets = importlib.import_module(pkg.__name__ + ".models.presets")
        self.scenes = importlib.import_module(pkg.__name__ + ".models.scene")
        self.grid = importlib.import_module(pkg.__name__ + ".ops.grid")
        self.lk = importlib.import_module(pkg.__name__ + ".ops.cuda.lightkernel")
        self.bidir = importlib.import_module(pkg.__name__ + ".render.bidir")
        self.build = importlib.import_module(pkg.__name__ + ".utils.build")
        camera = importlib.import_module(pkg.__name__ + ".models.camera")
        self.cp = camera.camera_arrays(camera.Camera())
        self._packed = {}

    def scene(self, name: str):
        """A preset, ``stress_dense(n)`` / ``mesh_dense(n)``, or one of
        chip_smoke.py's quads, built by this tree's own modules."""
        if name.endswith(")"):
            fn, arg = name[:-1].split("(")
            return getattr(self.presets, fn)(int(arg))
        if name in ("color+normal quad", "mesh-fit quad"):
            b = self.scenes.SceneBuilder()
            spec = self.scenes.MaterialSpec
            n = (0, 0, 1)
            uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
            if name == "color+normal quad":
                checker = np.zeros((2, 2, 3), np.float32)
                checker[:, 0] = (1.0, 0.1, 0.1)
                checker[:, 1] = (0.1, 0.1, 1.0)
                nm = np.zeros((2, 2, 3), np.float32)
                nm[..., 0], nm[..., 1], nm[..., 2] = 0.85, 0.5, 0.9
                m = b.add_material(spec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.8,
                                        texture=b.add_texture(checker),
                                        normal_map=b.add_texture(nm)))
                s, z, light = 2.0, -4.0, ((0.0, 0.0, -1.0), (60.0, 60.0, 60.0))
            else:
                tex = np.random.default_rng(3).uniform(0.05, 1.0, (16, 16, 3)).astype(np.float32)
                m = b.add_material(spec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.9,
                                        texture=b.add_texture(tex)))
                s, z, light = 6.0, -4.0, ((0.0, 0.0, -0.5), (40.0, 40.0, 40.0))
            x = 0.45 if name == "mesh-fit quad" else 0.0   # the fit's starting shift
            v = [(-s + x, -s, z), (s + x, -s, z), (s + x, s, z), (-s + x, s, z)]
            b.add_triangle(v[0], v[1], v[2], n, n, n, m, uv=(uv[0], uv[1], uv[2]))
            b.add_triangle(v[0], v[2], v[3], n, n, n, m, uv=(uv[0], uv[2], uv[3]))
            b.add_point_light(*light)
            b.background = np.zeros(3, np.float32)
            return b.build()
        return getattr(self.presets, name)()

    def packed(self, name: str, grid: bool = False):
        key = (name, grid)
        if key not in self._packed:
            scene = self.scene(name)
            self._packed[key] = (self.mk.pack_grid(self.grid.build_grid(scene), "cuda") if grid
                                 else self.mk.pack_scene(scene, "cuda"))
        return self._packed[key]

    def launcher(self, scene, w, h, spp, nb, grid=False, **kw):
        packed = self.packed(scene)
        packed_grid = self.packed(scene, grid=True) if grid else None

        def fn():
            return self.mk.render_block_sums_cuda(packed, self.cp, 0, w, h, spp, nb, 0, w * h,
                                                  packed_grid=packed_grid, **kw)
        return fn

    def k3_launcher(self, nu, entry="render_lighttrace_fast", max_bounces=K3["max_bounces"]):
        """One batch of K3's case through ``entry``: this tree's
        ``render_lighttrace_fast`` or ``light_image_cuda`` (the image sink),
        or ``render_bidir_fast`` (which takes its nu from the counts)."""
        packed = self.packed(K3["scene"])
        w, h, nb, n = K3["width"], K3["height"], max_bounces, K3["n_paths"]
        if entry == "render_bidir_fast":
            def fn():
                return self.bidir.render_bidir_fast(packed, self.cp, w, h, K3["spp"], n, 0,
                                                    max_bounces=nb)
            return fn
        call = getattr(self.lk, entry)

        def fn():
            return call(packed, self.cp, K3_SEED, w, h, n, nb, bidir_nu=nu)
        return fn

    def k2_launcher(self, case):
        """K2's launch of ``case`` = (scene, dims, flags) for a fixed random
        cotangent."""
        scene, (w, h, spp, nb), flags = case
        flags = dict(flags)
        packed = self.packed(scene)
        packed_grid = self.packed(scene, grid=True) if flags.pop("grid", False) else None
        g_img = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(2)).cuda()

        def fn():
            return self.vjp.backward_rows_cuda(packed, self.cp, 0, w, h, spp, nb, g_img,
                                               packed_grid=packed_grid, **flags)
        return fn


def quartiles(xs) -> list:
    return [float(q) for q in np.percentile(xs, [25, 50, 75])]


def build_side_by_side(trees, library: str) -> float:
    """Build ``library`` in every tree at once (one nvcc each); seconds."""
    errors = []

    def build_one(tree):
        try:
            tree.build.load_kernels(library)
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=build_one, args=(t,)) for t in trees]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.time() - t0


PHASE_NAMES = {"0": "", "1": "/replay", "2": "/reverse"}


def ptxas(tree, library: str, kernel: str) -> dict:
    """{template bools (and K2's schedule phase, when not the fused one):
    (registers, spill bytes stored, spill bytes loaded)} of ``kernel``'s
    instantiations in ``library``."""
    out = {}
    for k in tree.build.ptxas_report(library):
        if kernel in k["kernel"]:
            args = k["kernel"].split(kernel)[1].split("Ev")[0]
            key = "".join(re.findall(r"Lb([01])E", args))
            ints = re.findall(r"Li(\d+)E", args)
            key += PHASE_NAMES[ints[0]] if ints else ""
            out[key] = (k["registers"], k["spill_stores"], k["spill_loads"])
    return out


def tpl(key: str) -> str:
    """A ``ptxas`` key as ``<b,b,...>`` with its schedule phase, if any."""
    bools, _, phase = key.partition("/")
    return f"<{','.join(bools)}>" + (f"/{phase}" if phase else "")


def in_pairs(fns, reps: int = 3, inner: int = 1):
    """``PAIRS`` pairs of the two launch functions ``fns`` ({label: fn}), the
    side that runs first alternating, each side the median of ``reps``
    launches: {label: [ms per pair]}."""
    a, b = fns
    for fn in fns.values():
        fn()
    runs = {lab: [] for lab in fns}
    for k in range(PAIRS):
        for lab in ((a, b) if k % 2 == 0 else (b, a)):
            runs[lab].append(float(np.median(launch_ms(fns[lab], reps, inner))))
    return runs


def score(runs, mine: str, other: str) -> dict:
    """Pairs ``mine`` wins, both sides' quartiles, and whether that is a gain:
    at least 9 of 10 pairs, and the medians apart by more than the other
    side's interquartile range."""
    wins = sum(x < y for x, y in zip(runs[mine], runs[other]))
    q_m, q_o = quartiles(runs[mine]), quartiles(runs[other])
    gain = wins >= 0.9 * PAIRS and q_o[1] - q_m[1] > q_o[2] - q_o[0]
    return {"runs": runs, f"quartiles_{mine}": q_m, f"quartiles_{other}": q_o,
            "wins": wins, "gain": gain}


def k1_phases(trees, report) -> None:
    """Phases 1-6: K1 against the other tree and its patched copies."""
    labels = ["parent", "change", *K1_COPIES]
    log(f"[build] {len(labels)} libraries side by side: "
        f"{build_side_by_side([trees[lab] for lab in labels], 'megakernel'):.1f} s")
    report["build"] = {}
    for label in labels:
        tree = trees[label]
        regs = ptxas(tree, "megakernel", "render_kernel")
        entry = {"ptxas": regs}
        if hasattr(tree.mk, "render_occupancy"):
            for name, scene, kw in (("default", "cornell", {}),
                                    ("physical", "cornell", dict(physical=True)),
                                    ("textured", "textured", {})):
                entry[name] = tree.mk.render_occupancy(tree.packed(scene), **kw)
        report["build"][label] = entry
        log(f"[build] {label}: default {regs.get('00000')} physical {regs.get('10000')} "
            f"(registers, spill bytes stored / loaded); occupancy "
            f"{ {k: v for k, v in entry.items() if k != 'ptxas'} }; "
            f"spilling instantiations {sorted(k for k, v in regs.items() if v[1] or v[2])}")

    before, after = report["build"]["parent"]["ptxas"], report["build"]["change"]["ptxas"]
    log("[build] registers of every instantiation <physical, bidir, textured, grid, bf16>, "
        "other tree -> this tree: "
        + ", ".join(f"<{','.join(k)}> {before[k][0]} -> {after[k][0]}" for k in sorted(after)))

    change = trees["change"]
    report["staging_rule"] = {}
    for n in STAGING_SPHERES:
        packed = change.mk.pack_scene(change.presets.stress_dense(n), "cuda")
        row = {name: change.mk.render_occupancy(packed, **kw)
               for name, kw in (("default", {}), ("physical", dict(physical=True)))}
        report["staging_rule"][n] = row
        log(f"[staging rule] stress_dense({n}): "
            + "; ".join(f"{name} {r['smem_bytes']} B staged, {r['blocks_per_sm']} blocks per SM"
                        for name, r in row.items()))

    # ---- 2. bit identity with the other tree -------------------------------------
    w, h, nb = FULL["width"], FULL["height"], FULL["max_bounces"]
    report["bit_identity"] = {}
    for name, scene, kw in (
            ("default", "cornell", {}), ("physical", "cornell", dict(physical=True)),
            ("bidir", "cornell", dict(physical=True, bidir_nu=8192.0)),
            ("textured", "textured", {}), ("grid", "cornell", dict(grid=True))):
        a = trees["parent"].launcher(scene, w, h, BITS_SPP, nb, **kw)()
        b = change.launcher(scene, w, h, BITS_SPP, nb, **kw)()
        torch.cuda.synchronize()
        same = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
        differ = int((a != b).any(dim=1).sum())
        report["bit_identity"][name] = {"identical": same, "pixels_differing": differ,
                                        "max_abs_diff": float((a - b).abs().max())}
        log(f"[bit identity] {name:8s} {w}x{h} {BITS_SPP} spp {nb} b: "
            f"{'bit-identical' if same else f'{differ} pixels differ'} "
            f"(max abs diff {float((a - b).abs().max()):.3e})")

    def in_turns(labels, case, reps=5, inner=1):
        """{label: [median ms of each turn]} over the turn order ``labels``;
        ``case(tree)`` gives the launch function."""
        times = {}
        for label in labels:
            times.setdefault(label, []).append(median_ms(case(trees[label]), reps, inner))
        return times

    # ---- 3. the other tree and this one, in turns -----------------------------------
    order = ["parent", "change", "change", "parent"]
    report["turns_tree"] = {}
    cases = [("cornell default 2000 spp", FULL, {}),
             ("cornell physical 2000 spp", FULL, dict(physical=True)),
             ("training forward 256x256 16 spp", TRAIN, {})]
    for case, size, kw in cases:
        t = in_turns(order, lambda tr: tr.launcher("cornell", size["width"], size["height"],
                                                   size["spp"], size["max_bounces"], **kw),
                     inner=10 if size is TRAIN else 1)
        report["turns_tree"][case] = t
        log(f"[turns tree] {case}: parent {t['parent']} ms, change {t['change']} ms")
    for scene, title in (("stress_dense(10000)", "stress_dense(10000)"),
                         ("mesh_dense(4)", "mesh_dense(4)")):
        for b in MATRIX["bounces"]:
            for grid in (False, True):
                case = (f"{title} {MATRIX['width']}x{MATRIX['height']} b={b} "
                        f"{'grid' if grid else 'linear'}")
                t = in_turns(order, lambda tr: tr.launcher(scene, MATRIX["width"],
                                                           MATRIX["height"], MATRIX["spp"], b,
                                                           grid=grid))
                report["turns_tree"][case] = t
                log(f"[turns tree] {case}: parent {t['parent']} ms, change {t['change']} ms")

    # ---- 4. launch bounds, in turns ----------------------------------------------------
    labels = ["change", "bounds6", "bounds8"]
    report["turns_bounds"] = {}
    for case, kw in (("default", {}), ("physical", dict(physical=True))):
        t = in_turns(labels + labels[::-1],
                     lambda tr: tr.launcher("cornell", w, h, FULL["spp"], nb, **kw))
        report["turns_bounds"][case] = t
        log(f"[turns bounds] cornell {case} 2000 spp: "
            + "; ".join(f"{lab}: {t[lab]} ms" for lab in labels))

    # ---- 5. tables in shared memory against global memory, in pairs -------------------------
    report["turns_tables"] = {}
    for case, scene, kw in (("cornell default", "cornell", {}),
                            ("cornell physical", "cornell", dict(physical=True)),
                            ("textured default", "textured", {})):
        runs = in_pairs({lab: trees[lab].launcher(scene, w, h, FULL["spp"], nb, **kw)
                         for lab in ("change", "global_tables")})
        sc = score(runs, "change", "global_tables")
        report["turns_tables"][case] = sc
        q_s, q_g = sc["quartiles_change"], sc["quartiles_global_tables"]
        log(f"[turns tables] {case} 2000 spp, {PAIRS} pairs: shared quartiles "
            f"{q_s} ms, global {q_g} ms; shared faster in {sc['wins']} of {PAIRS} pairs; "
            f"{'a gain' if sc['gain'] else 'no gain'} (rule: >= 9 of 10 and the medians apart "
            f"by more than global's interquartile range {q_g[2] - q_g[0]:.3f} ms); "
            f"runs shared {runs['change']} global {runs['global_tables']}")

    # ---- 6. lane efficiency of both schedules (counts) ---------------------------------
    report["lanes"] = {}
    band = (h // 2 - 16) * w, 32 * w
    for case, scene, kw in (("cornell default", "cornell", {}),
                            ("cornell physical", "cornell", dict(physical=True)),
                            ("textured default", "textured", {})):
        for n_spp in LANE_SPP:
            stats = {}
            change.mk.render_block_sums_plain(change.packed(scene), change.cp, 0, w, h, n_spp,
                                              nb, *band, stats=stats, **kw)
            eff = {k: stats["path_bounces"] / (32 * stats[k])
                   for k in ("warp_iterations", "warp_iterations_nested")}
            report["lanes"][f"{case} {n_spp} spp"] = {**stats, "lane_efficiency": eff}
            log(f"[lanes] {case} {n_spp:3d} spp, rows {band[0] // w}-{band[0] // w + 31}: "
                f"{stats['path_bounces'] / stats['paths']:.3f} bounces per path; lane "
                f"efficiency regenerating {eff['warp_iterations']:.3f}, nested "
                f"{eff['warp_iterations_nested']:.3f} "
                f"({stats['warp_iterations_nested'] / stats['warp_iterations']:.2f}x the warp "
                "iterations)")


def k2_phases(trees, report) -> None:
    """Phases 7-11: K2 against the other tree and its patched copies."""
    labels = ["parent", "change", *K2_COPIES]
    log(f"[k2 build] {len(labels)} libraries side by side: "
        f"{build_side_by_side([trees[lab] for lab in labels], 'megakernel_vjp'):.1f} s")
    # <FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO>
    regs = {lab: ptxas(trees[lab], "megakernel_vjp", "backward_kernel") for lab in labels}
    report["k2_build"] = regs
    before, after = regs["parent"], regs["change"]
    log("[k2 build] registers (spill bytes stored / loaded) of every instantiation "
        "<full, shared, textured, grid, physical, geo>, other tree -> this tree: "
        + ", ".join(f"{tpl(k)} {before[k][0]} ({before[k][1]}/{before[k][2]}) -> "
                    f"{after[k][0]} ({after[k][1]}/{after[k][2]})"
                    for k in sorted(after) if k in before))
    for lab in K2_COPIES:
        log(f"[k2 build] {lab}: " + ", ".join(f"{tpl(k)} {v[0]} ({v[1]}/{v[2]})"
                                             for k, v in sorted(regs[lab].items())))

    # ---- 8. rows of both trees and of the copies -----------------------------------------
    report["k2_rows"] = {}
    for case, spec in {**K2_CASES, **K2_ONCE, **K2_GLOBAL}.items():
        rows = {lab: trees[lab].k2_launcher(spec)().double() for lab in labels}
        again = trees["change"].k2_launcher(spec)().double()
        torch.cuda.synchronize()
        top = float(rows["parent"].abs().max())
        gaps = {lab: float((r - rows["parent"]).abs().max()) / top for lab, r in rows.items()
                if lab != "parent"}
        gaps["change twice"] = float((again - rows["change"]).abs().max()) / top
        route = trees["change"].vjp.LAST_ROUTE
        report["k2_rows"][case] = dict(gaps, route=route, max_abs_row=top)
        log(f"[k2 rows] {case} ({route} rows): largest difference over the largest row "
            f"({top:.4g}), against the other tree: "
            + ", ".join(f"{lab} {v:.2e}" for lab, v in gaps.items())
            + f" (bound {K2_ROWS_BOUND:g})")

    # ---- 8b. the camera rows alone, on the global route ----------------------------------
    report["k2_camera_rows"] = {label: camera_rows(trees, spec)
                                for label, spec in K2_GLOBAL.items()}

    # ---- 9. the other tree and this one, in turns -----------------------------------------
    report["k2_turns_tree"] = {}
    for case, spec in {**K2_CASES, **K2_ONCE}.items():
        once = case in K2_ONCE
        order = ["parent", "change"] if once else ["parent", "change", "change", "parent"]
        probe = median_ms(trees["change"].k2_launcher(spec), reps=1)
        inner = 10 if probe < 5.0 else 1
        t = {}
        for label in order:
            t.setdefault(label, []).append(median_ms(trees[label].k2_launcher(spec),
                                                     reps=1 if once else 5, inner=inner))
        report["k2_turns_tree"][case] = t
        log(f"[k2 turns tree] {case} {spec[1][0]}x{spec[1][1]} {spec[1][2]} spp "
            f"{spec[1][3]} b: parent {t['parent']} ms, change {t['change']} ms "
            f"({np.median(t['parent']) / np.median(t['change']):.2f}x)")

    # ---- 10. the checkpoint layout, in pairs ---------------------------------------------
    report["k2_turns_layout"] = {}
    won = 0
    for case in ("cornell linear", "cornell full", "cornell physical"):
        runs = in_pairs({lab: trees[lab].k2_launcher(K2_CASES[case])
                         for lab in ("change", "strided")}, inner=5)
        sc = score(runs, "change", "strided")
        won += sc["wins"]
        report["k2_turns_layout"][case] = sc
        log(f"[k2 turns layout] {case}, {PAIRS} pairs: lane slots quartiles "
            f"{sc['quartiles_change']} ms, strided {sc['quartiles_strided']} ms; lane slots "
            f"faster in {sc['wins']} of {PAIRS}; runs lane {runs['change']} strided "
            f"{runs['strided']}")
    report["k2_turns_layout"]["lane_slots_wins"] = won
    log(f"[k2 turns layout] lane slots won {won} of {3 * PAIRS} pairs (kept by the rule "
        f"in PERF.md at >= {2 * PAIRS})")

    # ---- 11. the camera rows, in pairs ------------------------------------------------------
    runs = in_pairs({lab: trees[lab].k2_launcher(K2_CASES["cornell full"])
                     for lab in ("change", "camera_atomics")}, inner=5)
    sc = score(runs, "change", "camera_atomics")
    report["k2_turns_camera"] = sc
    q_c, q_a = sc["quartiles_change"], sc["quartiles_camera_atomics"]
    log(f"[k2 turns camera] cornell full, {PAIRS} pairs: camera columns quartiles {q_c} ms, "
        f"atomics {q_a} ms; columns faster in {sc['wins']} of {PAIRS}; "
        f"{'a gain' if sc['gain'] else 'no gain'} (rule: >= 9 of 10 and the medians apart by "
        f"more than the atomics' interquartile range {q_a[2] - q_a[0]:.3f} ms); runs "
        f"columns {runs['change']} atomics {runs['camera_atomics']}")

    # ---- 12. smaller stacks and a register cap, in pairs --------------------------------
    report["k2_turns_stack"] = {}
    for case in ("cornell linear", "cornell full", "cornell physical"):
        for lab in ("stack1", "stack2", "stack4", "k2_bounds5"):
            if lab == "k2_bounds5" and case != "cornell linear":
                continue
            runs = in_pairs({lb: trees[lb].k2_launcher(K2_CASES[case])
                             for lb in (lab, "change")}, inner=5)
            sc = score(runs, lab, "change")
            stack = trees[lab].vjp.LAST_STACK
            report["k2_turns_stack"][f"{case}, {lab}"] = dict(sc, stack=stack)
            q_l, q_c = sc[f"quartiles_{lab}"], sc["quartiles_change"]
            log(f"[k2 turns stack] {case}, {lab} (slots per pixel, scratch floats {stack}; this "
                f"tree {trees['change'].vjp.LAST_STACK}), {PAIRS} pairs: quartiles {q_l} ms "
                f"against this tree's {q_c} ms; {lab} faster in {sc['wins']} of {PAIRS}; "
                f"{'a gain' if sc['gain'] else 'no gain'} (rule: >= 9 of 10 and the medians "
                f"apart by more than this tree's interquartile range {q_c[2] - q_c[0]:.3f} ms)")


def k2_split_phases(trees, report) -> None:
    """Phase 18: K2 physical's split schedule (this tree, variant d) against
    the other tree (a), the fused kernel under the same launch bound
    (``k2_fused_bounds4``, b) and the split without a bound
    (``k2_split_free``, c); and the cases that keep the fused launch against
    the other tree."""
    labels = ["parent", "change", *K2_SPLIT_COPIES]
    log(f"[k2 split build] {len(labels)} libraries side by side: "
        f"{build_side_by_side([trees[lab] for lab in labels], 'megakernel_vjp'):.1f} s")
    # <FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO>: physical, untextured, no geo
    regs = {lab: {k: v for k, v in ptxas(trees[lab], "megakernel_vjp",
                                         "backward_kernel").items()
                  if k[2] == "0" and k[4:6] == "10"} for lab in labels}
    report["k2_split_build"] = regs
    for lab in labels:
        log(f"[k2 split build] {lab}: registers (spill bytes stored / loaded) "
            + ", ".join(f"{tpl(k)} {v[0]} ({v[1]}/{v[2]})" for k, v in sorted(regs[lab].items())))
    cornell = trees["change"].packed("cornell")
    rows = trees["change"].vjp._grad_rows(cornell.counts, physical=True)
    occ = {}
    for lab in ("change", *K2_SPLIT_COPIES):
        vjp = trees[lab].vjp
        for grid in (False, True):
            for phase in (vjp.PHASE_FUSED, vjp.PHASE_REPLAY, vjp.PHASE_REVERSE):
                o = vjp.backward_occupancy(physical=True, grid=grid, rows=rows, phase=phase)
                occ[f"{lab} grid={int(grid)} phase={phase}"] = o
    report["k2_split_occupancy"] = occ
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[k2 split occupancy] cornell physical ({rows} rows, {sms} SMs; phase 0 fused, "
        f"1 replay, 2 reverse): " + "; ".join(f"{k}: {v}" for k, v in occ.items()))

    report["k2_split_rows"] = {}
    for case in K2_SPLIT_CASES:
        spec = K2_CASES[case]
        got = {}
        for lab in labels:
            before = trees[lab].vjp.RESIDENT_LAUNCHES if lab != "parent" else 0
            got[lab] = trees[lab].k2_launcher(spec)().double()
            torch.cuda.synchronize()
            sched = getattr(trees[lab].vjp, "LAST_SCHEDULE", None)
            resident = (trees[lab].vjp.RESIDENT_LAUNCHES - before) if lab != "parent" else None
            got[lab + " schedule"] = (sched, resident)
        top = float(got["parent"].abs().max())
        gaps = {lab: float((got[lab] - got["parent"]).abs().max()) / top
                for lab in labels if lab != "parent"}
        report["k2_split_rows"][case] = dict(
            gaps, schedules={lab: got[lab + " schedule"] for lab in labels})
        log(f"[k2 split rows] {case}: largest difference over the largest row ({top:.4g}) "
            f"against the other tree: " + ", ".join(f"{lab} {v:.2e}" for lab, v in gaps.items())
            + f" (bound {K2_ROWS_BOUND:g}); (schedule, resident calls): "
            + ", ".join(f"{lab} {got[lab + ' schedule']}" for lab in labels))

    report["k2_split_turns"] = {}
    order = ["parent", "k2_fused_bounds4", "k2_split_free", "change"]
    for case in K2_SPLIT_CASES:
        spec = K2_CASES[case]
        fns = {lab: trees[lab].k2_launcher(spec) for lab in labels}
        for fn in fns.values():
            fn()
        t = {lab: [] for lab in labels}
        for rnd in range(3):
            for lab in order + order[::-1]:
                t[lab].append(float(np.median(launch_ms(fns[lab], 5))))
        report["k2_split_turns"][case] = t
        med = {lab: float(np.median(v)) for lab, v in t.items()}
        log(f"[k2 split turns] {case} 256x256 16 spp 8 b, medians of 5 launches, 6 turns "
            f"each (a b c d d c b a, thrice): "
            + "; ".join(f"{lab} {med[lab]:.3f} ms (min {min(t[lab]):.3f}, max "
                        f"{max(t[lab]):.3f})" for lab in order)
            + f"; parent / change {med['parent'] / med['change']:.3f}x, "
            f"(b) / (d) {med['k2_fused_bounds4'] / med['change']:.3f}x")

    report["k2_fused_turns"] = {}
    for case, spec in K2_FUSED_CASES.items():
        fns = {lab: trees[lab].k2_launcher(spec) for lab in ("parent", "change")}
        inner = 10 if median_ms(fns["change"], reps=1) < 5.0 else 1
        t = {"parent": [], "change": []}
        for rnd in range(2):
            for lab in ("parent", "change", "change", "parent"):
                t[lab].append(median_ms(fns[lab], reps=5, inner=inner))
        report["k2_fused_turns"][case] = dict(t, schedule=trees["change"].vjp.LAST_SCHEDULE)
        med = {lab: float(np.median(v)) for lab, v in t.items()}
        log(f"[k2 fused turns] {case} ({trees['change'].vjp.LAST_SCHEDULE}): parent "
            f"{[round(x, 4) for x in t['parent']]} ms, change "
            f"{[round(x, 4) for x in t['change']]} ms (change / parent "
            f"{med['change'] / med['parent']:.3f})")


def k3_phases(trees, report) -> None:
    """Phases 13-17: K3 against the other tree and its patched copies."""
    labels = ["parent", "change", *K3_COPIES]
    log(f"[k3 build] {len(labels)} light-kernel libraries side by side: "
        f"{build_side_by_side([trees[lab] for lab in labels], 'lightkernel'):.1f} s; "
        f"forward kernels of both trees: "
        f"{build_side_by_side([trees['parent'], trees['change']], 'megakernel'):.1f} s")
    regs = {lab: ptxas(trees[lab], "lightkernel", "light_kernel") for lab in labels}
    report["k3_build"] = regs
    for lab in labels:
        log(f"[k3 build] {lab}: registers (spill bytes stored / loaded) of "
            f"<{'bidir' if lab == 'parent' else 'bidir, image sink'}>: "
            + ", ".join(f"<{','.join(k)}> {v[0]} ({v[1]}/{v[2]})"
                        for k, v in sorted(regs[lab].items())))
    change = trees["change"]
    w, h, n = K3["width"], K3["height"], K3["n_paths"]

    # ---- 14. both trees' images, in turns ----------------------------------------
    order = ["parent", "change", "change", "parent"]
    report["k3_image"] = {}
    for mode, nu in K3_NU.items():
        imgs = {lab: trees[lab].k3_launcher(nu)() for lab in ("parent", "change")}
        torch.cuda.synchronize()
        top = float(imgs["parent"].abs().max())
        gap = float((imgs["change"] - imgs["parent"]).abs().max()) / top
        t = {}
        for label in order:
            t.setdefault(label, []).append(median_ms(trees[label].k3_launcher(nu)))
        report["k3_image"][mode] = {"turns": t, "gap_over_max": gap}
        log(f"[k3 image] render_lighttrace_fast {mode}: images differ by {gap:.2e} of the "
            f"largest value; parent (records + index_add_) {t['parent']} ms, change (image "
            f"sink) {t['change']} ms ({np.median(t['parent']) / np.median(t['change']):.1f}x)")
    imgs = {lab: trees[lab].k3_launcher(None, "render_bidir_fast")()
            for lab in ("parent", "change")}
    torch.cuda.synchronize()
    gap = float((imgs["change"] - imgs["parent"]).abs().max()) / float(imgs["parent"].abs().max())
    t = {}
    for label in order:
        t.setdefault(label, []).append(median_ms(trees[label].k3_launcher(None,
                                                                         "render_bidir_fast")))
    report["k3_bidir"] = {"turns": t, "gap_over_max": gap}
    log(f"[k3 bidir] render_bidir_fast {K3['scene']} {w}x{h} {K3['spp']} spp + {n} paths: "
        f"images differ by {gap:.2e} of the largest value; parent {t['parent']} ms, change "
        f"{t['change']} ms ({np.median(t['parent']) / np.median(t['change']):.2f}x)")

    # ---- 15. lane efficiency of both schedules (counts), and the emission's share ----------
    report["k3_lanes"] = {}
    for mode, nu in K3_NU.items():
        occ = change.lk.light_occupancy(nu is not None, splat=True)
        stats = {}
        change.lk.light_records_plain(change.packed(K3["scene"]), change.cp, K3_SEED, w, h, n,
                                      K3["max_bounces"], bidir_nu=nu, stats=stats,
                                      n_lanes=occ["resident_lanes"])
        eff = {k: stats["path_bounces"] / (32 * stats[k])
               for k in ("warp_iterations", "warp_iterations_nested")}
        ms = {f"{lab} b={nb}": median_ms(trees[lab].k3_launcher(nu, "light_image_cuda", nb),
                                         inner=5)
              for lab in ("change", "k3_regenerating") for nb in (0, K3["max_bounces"])}
        report["k3_lanes"][mode] = {**stats, "lane_efficiency": eff, "occupancy": occ,
                                    "image_ms": ms}
        log(f"[k3 lanes] {mode}: {stats['path_bounces'] / stats['paths']:.3f} bounces per "
            f"path; lane efficiency one path per lane (this tree) "
            f"{eff['warp_iterations_nested']:.3f}, regenerating over the "
            f"{occ['resident_lanes']} resident lanes ({occ['registers']} registers, "
            f"{occ['blocks_per_sm']} blocks per SM) {eff['warp_iterations']:.3f}; image sink "
            "(median of 5 launches of 5 calls) with the emission vertex alone (b=0) and "
            "whole: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))

    # ---- 16 / 17. the schedule and the splat route, in pairs: the copy must win ------------
    for phase, copy in (("k3_turns_schedule", "k3_regenerating"),
                        ("k3_turns_splat", "k3_float4")):
        report[phase] = {}
        for mode, nu in K3_NU.items():
            a = change.k3_launcher(nu, "light_image_cuda")()
            b = trees[copy].k3_launcher(nu, "light_image_cuda")()
            torch.cuda.synchronize()
            gap = float((a - b).abs().max()) / float(a.abs().max())
            runs = in_pairs({lab: trees[lab].k3_launcher(nu, "light_image_cuda")
                             for lab in (copy, "change")}, inner=5)
            sc = score(runs, copy, "change")
            report[phase][mode] = dict(sc, gap_over_max=gap)
            q_c, q_t = sc[f"quartiles_{copy}"], sc["quartiles_change"]
            log(f"[{phase.replace('_', ' ')}] {mode}, {PAIRS} pairs: {copy} quartiles {q_c} "
                f"ms, this tree {q_t} ms; {copy} faster in {sc['wins']} of {PAIRS}; "
                f"{'a gain' if sc['gain'] else 'no gain'} (rule: >= 9 of 10 and the medians "
                f"apart by more than this tree's interquartile range {q_t[2] - q_t[0]:.4f} "
                f"ms); images differ by {gap:.2e} of the largest value")


def camera_rows(trees, spec) -> dict:
    """The 13 camera rows of ``spec`` (a K2_GLOBAL case) row by row, each
    difference over that row's own magnitude: this tree against the other,
    each tree against a second run of itself and, where g++ can build the
    host build of the kernel's math (``tests/torch_kernel_host.cpp``), each
    tree against its float64 sums of the same float32 contributions, also
    over the sum of the contributions' magnitudes (how far float32 sums of
    cancelling terms can stray)."""
    scene, (w, h, spp, nb), flags = spec
    change = trees["change"]
    num_spheres, num_tris = change.packed(scene).counts[:2]
    physical, geo = flags.get("physical", False), flags.get("geo", False)
    end = (change.vjp._grad_rows(change.packed(scene).counts, True, 0, physical, geo)
           - 4 * num_spheres - (change.vjp.TRI_ROWS * num_tris if geo else 0))
    cam = slice(end - change.vjp.CAM_ROWS, end)
    runs = {lab: [trees[lab].k2_launcher(spec)()[cam].double().cpu() for _ in range(2)]
            for lab in ("parent", "change")}

    def own(a, b):
        return ((a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)).tolist()

    out = {"change vs parent": own(runs["change"][0], runs["parent"][0]),
           "parent twice": own(*runs["parent"]), "change twice": own(*runs["change"])}
    try:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        helpers = importlib.import_module("torch_port_helpers")
        g_img = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(2))
        host, rec_rows, rec_vals = helpers.backward_rows_hostbuild(
            change.mk.pack_scene(change.scene(scene), "cpu"), change.cp, 0, w, h, spp, nb,
            g_img, record=True, **flags)
    except (AssertionError, ImportError, OSError) as e:
        log(f"[k2 camera rows] no host build ({str(e).splitlines()[0] if str(e) else e!r})")
        host = None
    if host is not None:
        mass = torch.from_numpy(np.bincount(rec_rows, np.abs(rec_vals.astype(np.float64)),
                                            minlength=host.numel()))[cam]
        for lab in ("parent", "change"):
            gap = (runs[lab][0] - host[cam]).abs()
            out[f"{lab} vs host float64"] = (gap / host[cam].abs().clamp_min(1e-30)).tolist()
            out[f"{lab} vs host over sum |c|"] = (gap / mass.clamp_min(1e-30)).tolist()
        out["host over sum |c|"] = (host[cam].abs() / mass.clamp_min(1e-30)).tolist()
    out["rows"] = {lab: r[0].tolist() for lab, r in runs.items()}
    for key, v in out.items():
        if key != "rows":
            log(f"[k2 camera rows] {scene} {flags}: {key}, per row: "
                + " ".join(f"{x:.1e}" for x in v) + f" (largest {max(v):.2e})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help=f"root of the other tree (holds {PACKAGE}/)")
    ap.add_argument("--kernels", choices=("k1", "k2", "k3", "k2split", "both", "all"),
                    default="both",
                    help="whose phases to run (both: k1 and k2; all: k1, k2 and k3; "
                         "k2split: phase 18 alone)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "k1_turns.json"),
                    help="JSON report (default: the git-ignored build/)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_turns: no CUDA device", file=sys.stderr)
        return 1

    report = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    report["device"] = smi

    sys.path.insert(0, ROOT)
    trees = {"parent": Tree(copy_package(os.path.abspath(args.parent), "parent")),
             "change": Tree(importlib.import_module(PACKAGE))}
    kernels = {"both": ("k1", "k2"), "all": ("k1", "k2", "k3")}.get(args.kernels,
                                                                  (args.kernels,))
    copies = {"k1": K1_COPIES, "k2": K2_COPIES, "k3": K3_COPIES, "k2split": K2_SPLIT_COPIES}
    for label in (c for k in kernels for c in copies[k]):
        trees[label] = Tree(copy_package(ROOT, label, PATCHES[label]))
    phases = {"k1": k1_phases, "k2": k2_phases, "k3": k3_phases, "k2split": k2_split_phases}
    for k in kernels:
        phases[k](trees, report)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] report in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
