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
8. holds the backward kernel's gradients against its plain PyTorch version
   (autograd through the plain render) on four scenes, in grad modes linear
   and full, and runs the same step twice,
9. drives the training path at full size — ``invert`` on Cornell, 256x256,
   16 spp, 8 bounces, 30 Adam steps, once per grad mode — and counts the
   launches of both kernels,
10. times a gradient step and both kernels apart at that size,
11. prints one JSON line describing every kernel, then the result line.

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
PLAIN_SPP = 32             # the plain version's share of the full-size work

# The training path: the gradient-bench configuration of the reference.
TRAIN = dict(width=256, height=256, max_bounces=8, spp=16)
TRAIN_FIELDS = {
    "linear": ["materials.diffuse", "al_power"],
    "full": ["materials.diffuse", "al_power", "materials.roughness",
             "materials.ior"],
}
TRAIN_PLAIN_CHUNK = 2      # samples per autograd graph of the plain training step


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
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as vjp
    from cuda_path_tracer_ss_torch.render import inverse
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

    threads = [threading.Thread(target=build_one, args=a)
               for a in (("megakernel", False), ("megakernel", True),
                         ("megakernel_vjp", False))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    build_s = time.time() - t0
    log(f"[build] nvcc sm_90a: forward kernel (-fmad=false and -fmad=true) and "
        f"backward kernel (-fmad=false), three builds side by side: {build_s:.1f} s")
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

    def both_engines(scene, fields, target, w, h, n_spp, nb, seed):
        out = []
        for engine in ("cuda", "plain"):
            loss = inverse.make_loss(scene, cp, target, w, h, n_spp, nb, engine=engine,
                                     field_names=fields, device=dev)
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
        bench[mode] = dict(ms_step=ms_step, ms=ms_k2, loss=loss)
        rays = n_train * tspp
        log(f"[grad bench] cornell {tw}x{th} {tspp} spp {tnb} bounces, {mode} "
            f"({len(fields)} fields): value_and_grad step {ms_step:.2f} ms = "
            f"{rays / ms_step / 1e3:.1f} M primary rays/s (forward + backward); forward "
            f"kernel {ms_k1:.2f} ms, backward kernel {ms_k2:.2f} ms, the rest (pack, host, "
            f"loss, autograd) {ms_step - ms_k1 - ms_k2:.2f} ms")

    def plain_step_in_chunks(fields):
        """``value_and_grad`` of the plain engine's loss on the training step's
        inputs, all ``tspp`` samples, taken TRAIN_PLAIN_CHUNK at a time so
        that autograd holds one chunk's graph at once: the first pass renders
        the image, the second sends the loss's cotangent through every chunk."""
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in inverse.extract_params(start, fields).items()}
        offsets = range(0, tspp, TRAIN_PLAIN_CHUNK)

        def chunk_image(offset):
            packed = mk.pack_scene(inverse.merge_params(start, leaves), dev)
            return vjp.render_megakernel_diff_plain(packed, cp, 0, tw, th, TRAIN_PLAIN_CHUNK,
                                                    tnb, sample_offset=offset)

        with torch.no_grad():
            img = sum(chunk_image(o) for o in offsets) / len(offsets)
        residual = img - target_train
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
        # bounce (cornell is a closed box: every sweep of a path hits, so the
        # plain version's tally of sweeps counts the stored bounces), per
        # visible light sample and per path. Bytes the function must move:
        # tables and cotangent in, rows out. The checkpoints (written once,
        # read once) are this kernel's own traffic: their time at the memory
        # rate is printed apart and is no part of the bound.
        visible = stats_t["shadow_rays"] - stats_t["shadow_rays_occluded"]
        flops = (flop_count(packed_train.counts, stats_t)
                 + stats_t["path_bounces"] * REVERSE_BOUNCE_FLOPS[mode]
                 + visible * NEE_PARTIAL_FLOPS[mode]
                 + stats_t["paths"] * EYE_VJP_FLOPS[mode])
        planes = vjp.ST_PLANES_FULL if mode == "full" else vjp.ST_PLANES
        rows = vjp._grad_rows(packed_train.counts, mode == "full")
        moved = packed_train.table_bytes + 12 * n_train + 4 * rows
        scratch = 2 * 4 * planes * stats_t["path_bounces"]
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

    # ---- 11. report ----------------------------------------------------------------
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
        "ms_training_shape": ms_k1,
    }] + [{
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
        "two_runs_rel_diff": determinism[mode],
    } for mode, b in bench.items()]}
    report.update(kernels=kernels["kernels"], main_path_s=main_s, train=train,
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
