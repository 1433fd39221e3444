"""The multi-device certification run: the counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``.

``dryrun_multichip(n)`` spawns a world of ``n`` ranks (``mesh.spawn_world``)
and runs the reference's steps on tiny shapes, each rank on its own device,
rank 0 printing one line per step as the reference does:

1. an Adam training step through the pixel-sharded eager render;
2. a gradient step through the physical estimator, pixel-sharded;
3. a sample-sharded gradient step;
4. a 2-D (pixels x samples) gradient step, when ``n`` is even and >= 4;
5. a light-tracing gradient step over a path mesh (emission trains);
6. a sharded bidirectional render (pixel mesh + path mesh);
7. a bidirectional gradient step;
8. resume across a mesh reshape: half the samples sharded, the other half
   through the single-device ``integrator.render`` with ``sample_offset``,
   against one render of all of them (within 1e-5);
9. fused-engine gradient steps through ``render_megakernel_diff_sharded``
   (K1 forward, K2 backward per tile) in full mode, in physical mode and on
   a textured, normal-mapped quad (texel gradients);
10. a fused bidirectional render (``render_bidir_fast_sharded``: K1 + K3).

The reference runs some of the fused steps on a 2-device sub-mesh; here a
mesh spans the whole world, so they run on all ``n`` ranks. On CPU tables
the fused steps reach the kernels' plain versions. Any failed step raises
in its rank, which fails the run.

Run: ``python -m cuda_path_tracer_ss_torch.parallel.dryrun N [--device cpu]
[--backend gloo]`` (several ranks sharing one card need ``--backend
gloo``: NCCL does not put two ranks on one GPU).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from ..models import presets
from ..models.camera import Camera, camera_arrays
from ..ops.cuda import megakernel as mk
from ..ops.cuda.megakernel_vjp import render_megakernel_diff_sharded
from ..render import integrator, inverse
from ..render.bidir import render_bidir_fast_sharded, render_bidir_sharded
from . import mesh as mesh_lib
from .sharding import (render_2d_sharded, render_lighttrace_sharded,
                       render_pixel_sharded, render_sample_sharded)

WIDTH = HEIGHT = 16
SPP, BOUNCES = 2, 3
LIGHT_PATHS_PER_RANK = 64
# the fused step: every rank owns 1024 pixels of a 128-wide image, 4 bounces
FUSED_WIDTH, FUSED_ROWS_PER_RANK, FUSED_BOUNCES = 128, 8, 4


def _finite(name, *tensors):
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"dryrun: non-finite {name}")


def _grad_step(label, fields, scene, render):
    """value_and_grad of the MSE to black over ``fields``: returns the loss
    and the gradients after checking them finite."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.extract_params(scene, fields).items()}
    img = render(inverse.merge_params(scene, params))
    loss = torch.mean(img ** 2)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _finite(f"{label} loss", loss)
    _finite(f"{label} gradient", *grads.values())
    return float(loss.detach()), grads


def _say(rank, n, msg):
    if rank == 0:
        print(f"dryrun_multichip({n}): {msg}", flush=True)


def _rank_steps(rank: int, n: int, device_type: str) -> None:
    dev = mesh_lib.rank_device(device_type)
    if device_type == "cpu":
        torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(n, device_type=device_type)
    scene = presets.cornell()
    cp = camera_arrays(Camera())
    seed = 0
    kw = dict(max_bounces=BOUNCES, live_cutoff=None)

    # ---- 1. one Adam step through the pixel-sharded render ----
    fields = ("materials.diffuse", "materials.roughness", "al_power")
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.extract_params(scene, fields).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    img = render_pixel_sharded(inverse.merge_params(scene, params), cp, WIDTH,
                               HEIGHT, SPP, seed, mesh, **kw)
    loss = torch.mean(img ** 2)
    opt.zero_grad()
    loss.backward()
    opt.step()
    _finite("training-step loss", loss)
    _finite("update", *params.values())
    _say(rank, n, f"one sharded train step OK, loss={float(loss.detach()):.6f}")

    # ---- 2. the physical estimator's gradient, pixel-sharded ----
    val, _ = _grad_step("physical", fields, scene, lambda s: render_pixel_sharded(
        s, cp, WIDTH, HEIGHT, SPP, seed, mesh, physical=True, **kw))
    _say(rank, n, f"physical-mode sharded grad step OK, loss={val:.6f}")

    # ---- 3. sample-sharded gradient step ----
    smesh = mesh_lib.make_mesh(n, axis=mesh_lib.SAMPLE_AXIS, device_type=device_type)
    val, _ = _grad_step("sample-sharded", fields, scene, lambda s:
                        render_sample_sharded(s, cp, WIDTH, HEIGHT, n * SPP, seed,
                                              smesh, **kw))
    _say(rank, n, f"sample-sharded grad step OK, loss={val:.6f}")

    # ---- 4. 2-D mesh (pixels x samples) gradient step ----
    if n >= 4 and n % 2 == 0:
        mesh2 = mesh_lib.make_mesh_2d(n // 2, 2, device_type=device_type)
        val, _ = _grad_step("2-D", fields, scene, lambda s: render_2d_sharded(
            s, cp, WIDTH, HEIGHT, 2 * SPP, seed, mesh2, **kw))
        _say(rank, n, f"2-D mesh ({n // 2}x2 pixels x samples) grad step OK, "
                      f"loss={val:.6f}")

    # ---- 5. light tracing over a path mesh, emission trains ----
    lmesh = mesh_lib.make_mesh(n, axis=mesh_lib.PATH_AXIS, device_type=device_type)
    n_paths = n * LIGHT_PATHS_PER_RANK
    val, g = _grad_step("light-trace", ("materials.emission",), scene, lambda s:
                        render_lighttrace_sharded(s, cp, WIDTH, HEIGHT, n_paths, seed,
                                                  lmesh, max_bounces=BOUNCES))
    if not float(g["materials.emission"].abs().max()) > 0:
        raise RuntimeError("dryrun: light-trace emission gradients are zero")
    _say(rank, n, f"light-trace sharded grad step OK, loss={val:.6f}")

    # ---- 6. the bidirectional render over two meshes ----
    img_b = render_bidir_sharded(scene, cp, WIDTH, HEIGHT, SPP, n_paths, seed, mesh,
                                 lmesh, max_bounces=BOUNCES)
    _finite("bidirectional image", img_b)
    if not float(img_b.max()) > 0:
        raise RuntimeError("dryrun: the bidirectional image is black")
    _say(rank, n, f"sharded bidirectional render OK, mean={float(img_b.mean()):.6f}")

    # ---- 7. the bidirectional gradient step ----
    val, g = _grad_step("bidir", ("materials.emission", "materials.diffuse"),
                        scene, lambda s: render_bidir_sharded(
                            s, cp, WIDTH, HEIGHT, SPP, n_paths, seed, mesh, lmesh,
                            max_bounces=BOUNCES))
    if not float(g["materials.emission"].abs().max()) > 0:
        raise RuntimeError("dryrun: bidir emission gradients are zero")
    _say(rank, n, f"bidirectional sharded grad step OK, loss={val:.6f}")

    # ---- 8. resume across a mesh reshape: samples 0..SPP-1 over the mesh,
    # SPP..2 SPP-1 on one device, against one render of all of them ----
    with torch.no_grad():
        a = render_pixel_sharded(scene, cp, WIDTH, HEIGHT, SPP, seed, mesh, **kw)
        b = integrator.render(scene, cp, WIDTH, HEIGHT, SPP, seed, sample_offset=SPP,
                              device=dev, **kw)
        whole = integrator.render(scene, cp, WIDTH, HEIGHT, 2 * SPP, seed, device=dev,
                                  **kw)
    err = float(((a + b) / 2.0 - whole).abs().max())
    if not err < 1e-5:
        raise RuntimeError(f"dryrun: mesh-reshape resume diverged: {err}")
    _say(rank, n, f"checkpoint/resume across mesh reshape OK (max|diff|={err:.2e})")

    # ---- 9. the fused engines' sharded gradient steps (K1 + K2) ----
    packed = mk.pack_scene(scene, dev)
    fh = FUSED_ROWS_PER_RANK * n
    for label, size, bounces, extra in (
            ("full", (FUSED_WIDTH, fh), FUSED_BOUNCES, {}),
            ("physical", (WIDTH, HEIGHT), 2, dict(physical=True))):
        mats = packed.materials.detach().clone().requires_grad_(True)
        img = render_megakernel_diff_sharded(
            dataclasses.replace(packed, materials=mats), cp, seed, *size, 1, mesh,
            max_bounces=bounces, **extra)
        loss = torch.mean(img ** 2)
        g, = torch.autograd.grad(loss, mats)
        _finite(f"fused {label} step", loss, g)
        if not float(g.abs().max()) > 0:
            raise RuntimeError(f"dryrun: fused {label} gradients are zero")
        if label == "full":
            _say(rank, n, f"fused-engine sharded grad step OK at {size[0]}x{size[1]}, {n} "
                          f"devices, {bounces} bounces, loss={float(loss.detach()):.6f}")
        else:
            _say(rank, n, f"fused-engine PHYSICAL sharded grad step OK, "
                          f"loss={float(loss.detach()):.6f}")
    nm = mk.pack_scene(presets.textured_quad(nmap=True), dev)
    atlas = nm.tex_atlas.detach().clone().requires_grad_(True)
    img = render_megakernel_diff_sharded(dataclasses.replace(nm, tex_atlas=atlas), cp,
                                         seed, WIDTH, HEIGHT, 1, mesh, max_bounces=2,
                                         grad_mode="full")
    loss = torch.mean(img ** 2)
    g, = torch.autograd.grad(loss, atlas)
    _finite("normal-mapped step", loss, g)
    if not float(g.abs().max()) > 0:
        raise RuntimeError("dryrun: normal-map texel gradients are zero")
    _say(rank, n, "NORMAL-mapped fused sharded grad step OK (perturbation pullback + "
                  f"texel scatter), loss={float(loss.detach()):.6f}")

    # ---- 10. the fused bidirectional render (K1 bidir + K3) ----
    img_fb = render_bidir_fast_sharded(packed, cp, WIDTH, HEIGHT, 1, 256, seed, mesh,
                                       lmesh, max_bounces=2)
    _finite("fused bidirectional image", img_fb)
    if not float(img_fb.max()) > 0:
        raise RuntimeError("dryrun: the fused bidirectional image is black")
    _say(rank, n, f"FUSED sharded bidirectional render OK, mean={float(img_fb.mean()):.6f}")


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     backend: Optional[str] = None) -> None:
    """Spawn ``n_devices`` ranks (``backend`` defaults to
    ``mesh.default_backend(device_type)``) and run the steps above in
    them; raises if a step fails in any rank."""
    mesh_lib.spawn_world(n_devices, _rank_steps, n_devices, device_type,
                         device_type=device_type, backend=backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The multi-device certification run.")
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
