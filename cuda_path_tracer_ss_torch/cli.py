"""Command-line app shell of the PyTorch/CUDA package.

Replaces the reference's GLUT window + keyboard loop (``CudaTracer.cu:649-786``,
``CudaUtils.h:27-188``) with file-output commands:

  render     progressive render of a scene preset -> PNG/TGA/NPY
  benchmark  primary rays/s of the chosen engine on the chosen device
  lighttrace adjoint render: light paths splatted through the camera
  bidir      bidirectional render: MIS-weighted eye paths + light paths
  grad-check AD-vs-finite-difference report for chosen scene fields
  invert     inverse-rendering demo: recover perturbed scene fields

All run on ``--device cuda`` unless told otherwise; without a card they
fail instead of rendering somewhere else. Runtime-configurable everything the
reference hardcoded: resolution, spp, bounces, scene preset, seed, early-exit
cutoff.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _common(p: argparse.ArgumentParser):
    p.add_argument("--scene", default="cornell", help="scene preset name")
    p.add_argument("--obj", default=None, metavar="FILE",
                   help="render a Wavefront OBJ instead of a preset: the "
                        "mesh (with its mtllib materials and their map_Kd / "
                        "bump textures, if any) is auto-centered in the "
                        "Cornell shell")
    p.add_argument("--obj-scale", type=float, default=1.0,
                   help="size multiplier for --obj (1.0 fits the mesh's "
                        "largest extent to 4 units)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--bounces", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--live-cutoff", type=int, default=128,
                   help="the eager engine's early exit: a sample's bounce "
                        "loop stops once at most this many of its rays are "
                        "live; a negative value traces every bounce")
    p.add_argument("--samples-per-pass", type=int, default=None,
                   help="samples accumulated per progressive pass; default "
                        "AUTO — 'render' grows passes 4 -> 1024 to amortize "
                        "launch overhead (spp is a runtime kernel argument)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; 'cpu' "
                        "runs the plain PyTorch version, or the eager "
                        "engine with --engine eager)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "plain", "eager", "lighttrace",
                            "bidir"],
                   help="cuda = the hand-written CUDA megakernel, plain = "
                        "the plain PyTorch version of the same function "
                        "(slow; the yardstick of correctness), eager = the "
                        "JAX package's jnp engine in PyTorch (full autograd "
                        "for grad-check / invert; light paths for "
                        "lighttrace / bidir), auto = cuda on a CUDA device, "
                        "plain on --device cpu. 'lighttrace' and 'bidir' "
                        "are training-only estimator engines (grad-check / "
                        "invert; both need --physical): render with the "
                        "lighttrace / bidir subcommands")
    p.add_argument("--accel", default="none", choices=["none", "grid"],
                   help="spatial acceleration: grid = the supercell grid's "
                        "culled sweeps (ops/grid.py; the same image; faster "
                        "on scenes of thousands of primitives, slower on "
                        "small ones — see PERF.md), none = linear sweeps")
    p.add_argument("--physical", action="store_true",
                   help="unbiased estimator mode: correct-measure light "
                        "sampling with power-heuristic MIS instead of the "
                        "reference's NEE (every command; grad-check / "
                        "invert with --engine lighttrace|bidir need it)")


def _cutoff(args):
    return None if args.live_cutoff < 0 else args.live_cutoff


def _config(args):
    from .render.renderer import RenderConfig

    if args.engine in ("lighttrace", "bidir"):
        raise ValueError(f"--engine {args.engine} is a training-only "
                         "estimator engine (grad-check / invert); render "
                         f"with the '{args.engine}' subcommand instead")
    return RenderConfig(width=args.width, height=args.height,
                        max_bounces=args.bounces, spp=args.spp,
                        seed=args.seed, live_cutoff=_cutoff(args),
                        samples_per_pass=args.samples_per_pass,
                        engine=args.engine, accel=args.accel,
                        physical=args.physical, device=args.device)


def _obj_scene(args):
    """User OBJ (+ its .mtl library) auto-centered inside the Cornell shell."""
    import numpy as np

    from .models.presets import add_cornell_box
    from .models.scene import MaterialSpec, SceneBuilder
    from .utils.obj import add_obj_with_mtl, load_obj

    b = SceneBuilder()
    fallback = b.add_material(MaterialSpec(diffuse=(0.7, 0.6, 0.5),
                                           diff_avg=0.75))
    v, _, _ = load_obj(args.obj)
    center = (v.min(0) + v.max(0)) / 2
    extent = float((v.max(0) - v.min(0)).max())
    s = args.obj_scale * 4.0 / max(extent, 1e-9)
    t = np.diag([s, s, s, 1.0]).astype(np.float32)
    t[:3, 3] = np.asarray([0.0, -1.0, -5.5], np.float32) - s * center
    n, mmap = add_obj_with_mtl(b, args.obj, fallback, transform=t)
    add_cornell_box(b, 10.0)
    print(f"loaded {args.obj}: {n} triangles, "
          f"materials: {sorted(mmap) if mmap else '(fallback)'}")
    return b.build()


def _scene(args):
    """The scene of a command: ``--obj`` if given, else preset ``--scene``."""
    from .models.presets import get_scene

    return _obj_scene(args) if args.obj else get_scene(args.scene)


def _build(args):
    from .models.camera import Camera
    from .render.renderer import ProgressiveRenderer

    return ProgressiveRenderer(_scene(args), Camera(), _config(args))


def _checkpoint_paths(path: str):
    """(final, tmp): np.savez appends .npz to any other suffix, so the tmp
    name must already carry it for the rename source to exist."""
    final = path if path.endswith(".npz") else path + ".npz"
    return final, final[:-len(".npz")] + ".tmp.npz"


def cmd_render(args):
    r = _build(args)
    if args.resume:
        r.restore(args.resume)
    if args.checkpoint:
        final, tmp = _checkpoint_paths(args.checkpoint)
    if args.checkpoint and args.checkpoint_every > 0:
        # periodic snapshot -> any crash/preemption restarts from the last
        # completed pass (atomic: write aside, then rename)
        every = args.checkpoint_every
        passes = [0]

        def snap(metrics):
            passes[0] += 1
            if passes[0] % every == 0:
                r.checkpoint(tmp)
                os.replace(tmp, final)

        r.on_pass = snap
    r.run()
    r.save(args.out)
    if args.checkpoint:
        # atomic like the periodic snapshots: a kill mid-write must never
        # leave a corrupt resume file
        r.checkpoint(tmp)
        os.replace(tmp, final)
    print(f"wrote {args.out}")


def cmd_benchmark(args):
    import torch

    from .models.camera import Camera, camera_arrays
    from .ops.cuda.megakernel import (pack_grid, pack_scene, render_megakernel,
                                      render_megakernel_plain)
    from .ops.grid import build_grid
    from .render import integrator
    from .utils.profiling import sync, timed

    cfg = _config(args)
    engine = cfg.resolved_engine()
    cfg.check_ported()
    device = torch.device(args.device)
    cp = camera_arrays(Camera())
    # pack once: per-repeat packing would be counted in the timing
    scene = _scene(args)
    window = [0]
    if engine == "eager":
        # the scene (and grid) moved to the device once, like the packing
        scene_dev = scene.to(integrator.resolve_device(device))
        grid = (build_grid(scene).to(device) if args.accel == "grid"
                else None)

        def run():
            window[0] += 1
            with torch.no_grad():
                return integrator.render(
                    scene_dev, cp, args.width, args.height, args.spp,
                    args.seed, args.bounces, live_cutoff=_cutoff(args),
                    sample_offset=(window[0] - 1) * args.spp, grid=grid,
                    physical=args.physical, device=device)
    else:
        packed = pack_scene(scene, device)
        grid = (pack_grid(build_grid(scene), device) if args.accel == "grid"
                else None)
        render = (render_megakernel if engine == "cuda"
                  else render_megakernel_plain)

        def run():
            # distinct sample window per call: timing reflects fresh work
            window[0] += 1
            return render(packed, cp, args.seed, args.width, args.height,
                          args.spp, args.bounces,
                          sample_offset=(window[0] - 1) * args.spp,
                          physical=args.physical, packed_grid=grid)

    t0 = time.perf_counter()
    run()
    sync(device)
    first_call_s = time.perf_counter() - t0  # kernel build + first launch
    img, per_call_s = timed(run, reps=args.repeats, warmup=0, device=device)
    rays = args.width * args.height * args.spp
    out = {
        "scene": args.scene, "width": args.width, "height": args.height,
        "spp": args.spp, "bounces": args.bounces,
        "first_call_s": round(first_call_s, 2),
        "wall_s": round(per_call_s * args.repeats, 4),
        "primary_rays_per_s": round(rays / per_call_s, 1),
        "engine": engine,
        "physical": bool(args.physical),
        "accel": args.accel,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "checksum": float(img.sum()),
    }
    if engine == "eager":
        out["live_cutoff"] = _cutoff(args)
    if args.stats:
        fracs = integrator.live_ray_stats(scene, cp, args.width, args.height,
                                          args.seed, max_bounces=args.bounces,
                                          device=device)
        out["live_ray_fraction_per_bounce"] = [round(float(f), 4)
                                               for f in fracs]
    print(json.dumps(out))


def _light_setup(args):
    """(scene, cam_params, engine) of the two commands that trace light
    paths; the scene is packed for the kernel engines. ``--engine eager``
    traces them on the eager engine on either device; otherwise the engine
    follows the device: the kernels on a CUDA device, the plain versions on
    the CPU. The kernels have no texture block: a textured scene needs
    ``--engine eager`` (no silent switch)."""
    import torch

    from .models.camera import Camera, camera_arrays
    from .ops.cuda.megakernel import pack_scene
    from .render import integrator

    cp = camera_arrays(Camera())
    scene = _scene(args)
    if args.engine == "eager":
        return scene.to(integrator.resolve_device(args.device)), cp, "eager"
    device = torch.device(args.device)
    engine = _config(args).resolved_engine()
    if engine != ("cuda" if device.type == "cuda" else "plain"):
        raise ValueError(f"'{args.cmd}' picks its engine by the device; "
                         f"--engine {engine} needs --device "
                         f"{'cuda' if engine == 'cuda' else 'cpu'}")
    if scene.num_textures:
        raise ValueError(f"'{args.cmd}' on a textured scene needs --engine "
                         "eager: the light kernel and its plain version have "
                         "no texture block")
    return pack_scene(scene, device), cp, engine


def _write_display(path: str, acc, batches: int):
    import numpy as np

    from .utils.image import write_png

    arr = np.clip(acc / batches, 0, 1) ** (1 / 2.2)
    write_png(path, arr.astype(np.float32))
    print(f"wrote {path}")


def cmd_lighttrace(args):
    import numpy as np
    import torch

    from .ops.cuda.lightkernel import render_lighttrace_fast
    from .render.lighttrace import render_lighttrace

    scene, cp, engine = _light_setup(args)
    acc = np.zeros((args.height, args.width, 3), np.float64)
    t0 = time.time()
    for k in range(args.batches):
        # one path count for every batch: the kernel takes it at run time
        if engine == "eager":
            with torch.no_grad():
                img = render_lighttrace(scene, cp, args.width, args.height,
                                        args.paths, args.seed,
                                        max_bounces=args.bounces,
                                        sample_idx=k, device=args.device)
        else:
            img = render_lighttrace_fast(scene, cp, args.seed, args.width,
                                         args.height, args.paths,
                                         max_bounces=args.bounces,
                                         sample_idx=k)
        acc += img.cpu().numpy()    # the copy waits for the device
        print(f"batch {k + 1}/{args.batches}  "
              f"({(k + 1) * args.paths / (time.time() - t0) / 1e6:.2f} M "
              f"paths/s, engine {engine})")
    _write_display(args.out, acc, args.batches)


def cmd_bidir(args):
    import numpy as np
    import torch

    from .render.bidir import render_bidir, render_bidir_fast

    scene, cp, engine = _light_setup(args)
    acc = np.zeros((args.height, args.width, 3), np.float64)
    t0 = time.time()
    for k in range(args.batches):
        if engine == "eager":
            with torch.no_grad():
                img = render_bidir(scene, cp, args.width, args.height,
                                   args.spp, args.paths, args.seed,
                                   max_bounces=args.bounces,
                                   sample_offset=k * args.spp,
                                   light_sample_idx=k, device=args.device)
        else:
            img = render_bidir_fast(scene, cp, args.width, args.height,
                                    args.spp, args.paths, args.seed,
                                    max_bounces=args.bounces,
                                    sample_offset=k * args.spp,
                                    light_sample_idx=k)
        acc += img.cpu().numpy()    # the copy waits for the device
        done = (k + 1) * (args.spp * args.width * args.height + args.paths)
        print(f"batch {k + 1}/{args.batches}  "
              f"({done / (time.time() - t0) / 1e6:.2f} M path starts/s, "
              f"eye samples + light paths, engine {engine})")
    _write_display(args.out, acc, args.batches)


def _training_setup(args):
    """(scene, cam_params, engine, fields) of the two training commands; the
    options whose slice has not landed are refused here, before any work."""
    from .models.camera import Camera, camera_arrays
    from .render import inverse

    if args.engine in inverse.LIGHT_ENGINES:
        engine = args.engine    # the eager engine's light paths, on --device
    else:
        cfg = _config(args)
        engine = cfg.resolved_engine()
        cfg.check_ported()
    scene = _scene(args)
    fields = args.fields.split(",")
    inverse.check_engine_fields(engine, fields, physical=args.physical,
                                scene=scene)
    return scene, camera_arrays(Camera()), engine, fields


def cmd_grad_check(args):
    import torch

    from .render import inverse

    scene, cp, engine, fields = _training_setup(args)
    target = torch.zeros((args.height, args.width, 3))
    loss = inverse.make_loss(scene, cp, target, args.width, args.height,
                             args.spp, max_bounces=args.bounces,
                             engine=engine, accel=args.accel,
                             field_names=fields, physical=args.physical,
                             device=args.device)
    params = inverse.extract_params(scene, fields)
    ad, fd = inverse.directional_fd_check(loss, params, args.seed,
                                          eps=args.eps,
                                          num_directions=args.directions)
    rel = abs(ad - fd) / (abs(fd) + 1e-12)
    print(json.dumps({
        "fields": fields,
        "engine": engine,
        "ad": ad.tolist(), "fd": fd.tolist(),
        "max_rel_err": float(rel.max()),
        "allclose": bool((rel < args.tol).all()),
    }))


def cmd_invert(args):
    import numpy as np
    import torch

    from .ops.cuda.megakernel import (pack_scene, render_megakernel,
                                      render_megakernel_plain)
    from .render import integrator, inverse
    from .utils.image import write_png

    if args.silhouette and args.engine == "auto" and args.device == "cpu":
        # the boundary term trains on the eager engine or the kernels: on
        # the CPU, the eager engine (the plain one is refused)
        args.engine = "eager"
    scene_true, cp, engine, fields = _training_setup(args)
    render = render_megakernel if engine == "cuda" else render_megakernel_plain

    def image(scene):
        # each engine trains toward its own render of the truth; the light
        # engines, as the reference's, toward the eager forward estimator's
        if engine in ("eager",) + inverse.LIGHT_ENGINES:
            with torch.no_grad():
                return integrator.render(scene, cp, args.width, args.height,
                                         args.spp, args.seed, args.bounces,
                                         live_cutoff=None,
                                         physical=args.physical,
                                         device=args.device)
        return render(pack_scene(scene, args.device), cp, args.seed,
                      args.width, args.height, args.spp, args.bounces,
                      physical=args.physical)

    target = image(scene_true)

    # perturb the truth, then recover it
    params0 = inverse.extract_params(scene_true, fields)
    perturbed = {k: v + args.perturb for k, v in params0.items()}
    scene0 = inverse.merge_params(scene_true, perturbed)

    def cb(step, val, params):
        if step % 20 == 0:
            print(f"step {step:4d}  loss {val:.3e}")

    recovered, params, losses = inverse.invert(
        scene0, cp, target, fields, args.width, args.height, spp=args.spp,
        steps=args.steps, lr=args.lr, seed=args.seed,
        max_bounces=args.bounces, callback=cb, engine=engine,
        accel=args.accel, physical=args.physical,
        silhouette=args.silhouette, device=args.device)
    err = {k: float((params[k] - params0[k]).abs().max()) for k in params}
    print(json.dumps({"final_loss": losses[-1], "max_abs_err": err}))
    if args.out:
        img = image(recovered).cpu().numpy()
        write_png(args.out, np.clip(img, 0, 1) ** (1 / 2.2))
        print(f"wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cuda_path_tracer_ss_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a preset to an image file")
    _common(p)
    p.add_argument("--out", default="render.png")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also snapshot the accumulator every N passes "
                        "(atomic rename) so a killed render resumes from "
                        "the last completed pass via --resume")
    p.add_argument("--resume", default=None)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("benchmark", help="measure primary rays/s")
    _common(p)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--stats", action="store_true",
                   help="add the eager engine's live-ray fraction entering "
                        "each bounce (live_ray_stats, sample 0)")
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("grad-check", help="AD vs finite differences")
    _common(p)
    p.add_argument("--fields", default="materials.diffuse,al_power")
    p.add_argument("--eps", type=float, default=2e-3)
    p.add_argument("--directions", type=int, default=3)
    p.add_argument("--tol", type=float, default=0.05)
    p.set_defaults(fn=cmd_grad_check)

    p = sub.add_parser("lighttrace",
                       help="adjoint render: light paths splatted through "
                            "the camera (ops/cuda/lightkernel.py)")
    _common(p)
    p.add_argument("--paths", type=int, default=200_000,
                   help="light paths per batch")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--out", default="lighttrace.png")
    p.set_defaults(fn=cmd_lighttrace)

    p = sub.add_parser("bidir",
                       help="bidirectional render: MIS-weighted eye paths + "
                            "light-traced splats (render/bidir.py) — "
                            "caustics AND camera-visible specular in one "
                            "image")
    _common(p)
    p.add_argument("--paths", type=int, default=200_000,
                   help="light paths per batch (eye samples come from "
                        "--spp)")
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--out", default="bidir.png")
    p.set_defaults(fn=cmd_bidir)

    p = sub.add_parser("invert", help="inverse rendering demo")
    _common(p)
    p.add_argument("--fields", default="materials.diffuse")
    p.add_argument("--perturb", type=float, default=0.3)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--out", default=None)
    p.add_argument("--silhouette", action="store_true",
                   help="add the edge-sampled visibility-boundary term to "
                        "geometry gradients (render/silhouette.py); with "
                        "--device cpu the engine defaults to eager")
    p.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
