#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; without them it exits non-zero and
prints no result. It

1. prints the device and its power limit,
2. builds the CUDA kernels from ``cuda_path_tracer_ss_torch/csrc`` (the
   default ``-fmad=false`` build and the ``-fmad=true`` build, in parallel),
3. holds the kernel's random numbers bit-equal to ``utils/rng.py``,
4. holds the kernel against its plain PyTorch version on seven scenes, from
   16 primitives to 3000,
5. holds it against goldens made by an independent implementation on a CPU,
6. drives the main path at full size — Cornell box, 800x800, 8 bounces,
   2000 spp through ``ProgressiveRenderer`` — counts the kernel's launches,
   and times the single-launch form,
7. checks that checkpoint / resume is bit-identical,
8. prints one JSON line describing every kernel, then the result line.

Any failed phase raises: the exit code is then non-zero and the result line
is not printed. ``--out-dir DIR`` keeps the rendered PNG and a JSON report.
"""
from __future__ import annotations

import argparse
import json
import os
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

FULL = dict(width=800, height=800, max_bounces=8, spp=2000)
PLAIN_SPP = 32             # the plain version's share of the full-size work


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


def flop_count(counts, stats, scale: float = 1.0) -> float:
    """Least float32 work for the paths ``stats`` describes: one full sweep
    per path-bounce, one per unoccluded shadow ray, a single primitive test
    per occluded one, plus the per-path / per-bounce / per-light math."""
    num_s, num_t = counts[0], counts[1]
    sweep = num_s * SPHERE_TEST_FLOPS + num_t * TRIANGLE_TEST_FLOPS
    one_test = min(SPHERE_TEST_FLOPS if num_s else TRIANGLE_TEST_FLOPS,
                   TRIANGLE_TEST_FLOPS if num_t else SPHERE_TEST_FLOPS)
    occluded = stats["shadow_rays_occluded"]
    clear = stats["shadow_rays"] - occluded
    flops = (stats["paths"] * PER_PATH_FLOPS
             + stats["path_bounces"] * (sweep + PER_BOUNCE_FLOPS)
             + stats["shadow_rays"] * PER_LIGHT_SAMPLE_FLOPS
             + clear * sweep + occluded * one_test)
    return flops * scale


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
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
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

    # ---- 2. build (one nvcc per build variant, both started together) -------
    t0 = time.time()
    errors = []

    def build_one(fmad):
        try:
            build.load_kernels(fmad=fmad)
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=build_one, args=(f,)) for f in (False, True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    build_s = time.time() - t0
    log(f"[build] nvcc sm_90a, -fmad=false and -fmad=true builds: {build_s:.1f} s")
    report["build_s"] = build_s

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
        check(bool(np.isfinite(got).all()), f"golden {name}: non-finite")
        close = np.isclose(got, want, rtol=0.02, atol=2e-3).all(axis=-1)
        mean_ok = np.allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
        corr = float(np.corrcoef(got[close].ravel(), want[close].ravel())[0, 1])
        log(f"[golden] {name:20s} {close.mean():.4%} of pixels within "
            f"rtol 0.02 / atol 2e-3, corr {corr:.6f}")
        check(close.mean() >= 0.98, f"golden {name}: {close.mean():.4%} match")
        check(mean_ok, f"golden {name}: channel means off by more than 2 %")
        check(corr > 0.999, f"golden {name}: correlation {corr}")

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
    main_img = torch.from_numpy(r.radiance()).to(dev)
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

    # bound: this run's operation count (the plain version's tally over
    # PLAIN_SPP samples, scaled to the timed sample count) over the FP32 peak,
    # against the bytes moved (tables in, 12 bytes per pixel out)
    flops = flop_count(packed.counts, stats, bench_spp / PLAIN_SPP)
    moved = packed.table_bytes + 12 * w * h
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
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

    # ---- 8. report -----------------------------------------------------------------
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
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "shape": f"cornell {w}x{h}, {nb} bounces, {bench_spp} spp, one launch",
        "plain_shape": f"cornell {w}x{h}, {nb} bounces, {PLAIN_SPP} spp",
        "ms_at_plain_shape": ms_plain_shape,
        "ms_fmad_true": ms_fmad,
        "match_rate": rate,
        "match_rate_fmad_true": rate_f,
        "bounces_per_path": bounces_per_path,
    }]}
    report.update(kernels=kernels["kernels"], main_path_s=main_s,
                  main_path_passes=[m["pass_samples"] for m in passes],
                  total_s=time.time() - t_start)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(png, "rb") as src, open(os.path.join(args.out_dir, "cornell_800.png"), "wb") as dst:
            dst.write(src.read())
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
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
