#!/usr/bin/env python3
"""K1 (the port's forward-render kernel, ``csrc/megakernel.cu``) on one CUDA
device, in turns: against the kernel of another tree, and against patched
copies of this tree that build its alternatives.

Run from the repository root, with the other tree (a commit taken with
``git archive`` into a git-ignored directory) as ``--parent``::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 k1_turns.py --parent build/parent

Every kernel is launched through its own tree's package: the other tree's
``cuda_path_tracer_ss_torch/`` and the patched copies of this one are copied
under ``build/k1_turns/<label>/cpt_<label>/`` and imported under that name,
so each builds its library into its own ``build/`` with its own
``utils/build.py``. The copies of this tree differ from it in one line of
``csrc/megakernel.cu`` each:

- ``bounds6`` / ``bounds8``: ``__launch_bounds__(THREADS_PER_BLOCK, n)`` on
  ``render_kernel``;
- ``global_tables``: ``MAX_STAGED_BYTES = 0``, the small tables read from
  global memory in every scene.

Phases, each printed as it ends and kept in ``--out`` (JSON):

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
   ``textured`` default at 2000 spp, ``TABLE_PAIRS`` pairs, the side that
   runs first alternating; each side of a pair is the median of 3 launches.
   Per case: each side's median and quartiles, the pairs shared memory
   wins, and whether that is a gain (wins in at least 9 of 10 pairs, and the
   medians differ by more than the global side's interquartile range).
6. ``[lanes]`` the lane efficiency of K1's regenerating schedule and of the
   nested one (live bounces over 32 x the warps' loop iterations, the plain
   version's tally) on a band of 32 rows across the middle of the 800x800
   image, 8 bounces, 16 / 64 / 256 spp (cornell default and physical,
   ``textured`` default).

Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
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
TABLE_PAIRS = 10
STAGING_SPHERES = (1000, 2000, 2200, 2300, 2400)

# label -> (text of csrc/megakernel.cu, its replacement); each occurs once
KERNEL = "__global__ void render_kernel("
PATCHES = {
    "bounds6": (KERNEL, "__global__ void __launch_bounds__(THREADS_PER_BLOCK, 6) render_kernel("),
    "bounds8": (KERNEL, "__global__ void __launch_bounds__(THREADS_PER_BLOCK, 8) render_kernel("),
    "global_tables": ("constexpr int MAX_STAGED_BYTES = 48 * 1024;",
                      "constexpr int MAX_STAGED_BYTES = 0;"),
}


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
    ``build/k1_turns/<label>/cpt_<label>/`` (its csrc patched with ``patch``)
    and imported under that name."""
    base = os.path.join(ROOT, "build", "k1_turns", label)
    dst = os.path.join(base, f"cpt_{label}")
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(os.path.join(src_root, PACKAGE), dst,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    if patch is not None:
        path = os.path.join(dst, "csrc", "megakernel.cu")
        with open(path) as f:
            text = f.read()
        old, new = patch
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
        self.presets = importlib.import_module(pkg.__name__ + ".models.presets")
        self.grid = importlib.import_module(pkg.__name__ + ".ops.grid")
        self.build = importlib.import_module(pkg.__name__ + ".utils.build")
        camera = importlib.import_module(pkg.__name__ + ".models.camera")
        self.cp = camera.camera_arrays(camera.Camera())
        self._packed = {}

    def packed(self, name: str, grid: bool = False):
        key = (name, grid)
        if key not in self._packed:
            scene = getattr(self.presets, name)()
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


def quartiles(xs) -> list:
    return [float(q) for q in np.percentile(xs, [25, 50, 75])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help=f"root of the other tree (holds {PACKAGE}/)")
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

    # ---- 1. builds, side by side ------------------------------------------------
    sys.path.insert(0, ROOT)
    trees = {"parent": Tree(copy_package(os.path.abspath(args.parent), "parent")),
             "change": Tree(importlib.import_module(PACKAGE))}
    for label, patch in PATCHES.items():
        trees[label] = Tree(copy_package(ROOT, label, patch))
    errors = []

    def build_one(tree):
        try:
            tree.build.load_kernels("megakernel")
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=build_one, args=(t,)) for t in trees.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log(f"[build] {len(threads)} libraries side by side: {time.time() - t0:.1f} s")

    def ptxas(tree):
        out = {}
        for k in tree.build.ptxas_report("megakernel"):
            if "render_kernel" in k["kernel"]:
                bools = "".join(c for c in k["kernel"].split("render_kernel")[1]
                                .split("Ev")[0] if c in "01")
                out[bools] = (k["registers"], k["spill_stores"], k["spill_loads"])
        return out

    report["build"] = {}
    for label, tree in trees.items():
        regs = ptxas(tree)
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
    for scene, title in (("stress_dense", "stress_dense(10000)"), ("mesh_dense", "mesh_dense(4)")):
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
        fns = {lab: trees[lab].launcher(scene, w, h, FULL["spp"], nb, **kw)
               for lab in ("change", "global_tables")}
        for fn in fns.values():
            fn()
        runs = {lab: [] for lab in fns}
        for k in range(TABLE_PAIRS):
            sides = ("change", "global_tables") if k % 2 == 0 else ("global_tables", "change")
            for lab in sides:
                runs[lab].append(float(np.median(launch_ms(fns[lab], reps=3))))
        wins = sum(s < g for s, g in zip(runs["change"], runs["global_tables"]))
        q_s, q_g = quartiles(runs["change"]), quartiles(runs["global_tables"])
        gain = wins >= 0.9 * TABLE_PAIRS and q_g[1] - q_s[1] > q_g[2] - q_g[0]
        report["turns_tables"][case] = {"runs": runs, "quartiles_shared": q_s,
                                        "quartiles_global": q_g, "shared_wins": wins,
                                        "gain": gain}
        log(f"[turns tables] {case} 2000 spp, {TABLE_PAIRS} pairs: shared quartiles "
            f"{q_s} ms, global {q_g} ms; shared faster in {wins} of {TABLE_PAIRS} pairs; "
            f"{'a gain' if gain else 'no gain'} (rule: >= 9 of 10 and the medians apart by "
            f"more than global's interquartile range {q_g[2] - q_g[0]:.3f} ms); "
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

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] report in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
