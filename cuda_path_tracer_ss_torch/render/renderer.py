"""Progressive renderer: the frame-loop equivalent.

Behavioral spec: ``generateFrame`` + the GL display/accumulation loop
(``CudaTracer/CudaTracer.cu:587-647``, ``CudaUtils.h:145-159``,
``writeToPixelsKernel`` CudaTracer.cu:63-104). Instead of a live GL window,
the renderer accumulates float radiance progressively on the rendering
device, exposes per-pass metrics (the analog of the reference's "Rays per
pixel / Time per pass" console line, CudaTracer.cu:645), writes image files,
and can checkpoint / resume exactly (the threefry RNG is counter-based, so
resuming at sample k reproduces the run bit-for-bit).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import DEFAULT_MAX_BOUNCES
from ..models.camera import Camera, camera_arrays
from ..models.scene import scene_to_numpy
from ..ops import tonemap
from ..ops.cuda import megakernel
from ..ops.grid import build_grid
from ..utils import image as image_io
from ..utils.profiling import PassMeter, sync

ENGINES = ("auto", "cuda", "plain")


@dataclasses.dataclass
class RenderConfig:
    """Runtime config — the reference's compile-time constants made runtime."""

    width: int = 512
    height: int = 512
    max_bounces: int = DEFAULT_MAX_BOUNCES
    spp: int = 64
    seed: int = 0
    # Samples accumulated per progressive pass. None = AUTO: interactive
    # steps stay small (4 spp) for responsiveness, but ``run()`` GROWS
    # passes 4 -> 8 -> ... -> AUTO_PASS_CAP — the megakernel takes spp as a
    # runtime argument, so one kernel build serves every pass size.
    samples_per_pass: Optional[int] = None
    gamma: float = 1.0 / 2.2
    # "cuda": the hand-written CUDA megakernel (needs a CUDA device);
    # "plain": the plain PyTorch version of the same function (any device;
    #   the yardstick of correctness, slow);
    # "auto": cuda on a CUDA device, plain on device="cpu".
    # Both consume identical counter-based RNG streams (utils/rng.py), so
    # they produce the same image per pixel up to float op-order noise.
    engine: str = "auto"
    # Reference-quirk display pipeline: per-sample clamp -> gamma -> 8-bit
    # quantize -> integer accumulation (writeToPixelsKernel,
    # CudaTracer.cu:63-104). Forces samples_per_pass == 1.
    compat_int_accum: bool = False
    # Spatial acceleration: "none" = linear primitive sweeps (the reference's
    # behaviour); "grid" = the supercell grid's sweeps (ops/grid.py, built
    # once per scene; the same image). See PERF.md for where each is faster.
    accel: str = "none"
    # optional structured per-pass log (see utils/profiling.PassMeter)
    metrics_jsonl: Optional[str] = None
    # Unbiased estimator mode: uniform-area light sampling in the correct
    # measure with power-heuristic MIS (the megakernel's physical variant)
    # instead of the reference's NEE. Both engines.
    physical: bool = False
    # Where the render runs. The CPU is used only when asked for; on "cuda"
    # without a card the renderer raises.
    device: str = "cuda"

    def resolved_engine(self) -> str:
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; use one of "
                             f"{ENGINES}")
        on_cuda = torch.device(self.device).type == "cuda"
        if self.engine == "auto":
            return "cuda" if on_cuda else "plain"
        if self.engine == "cuda" and not on_cuda:
            raise ValueError(f"engine='cuda' needs a CUDA device, got "
                             f"device={self.device!r}")
        return self.engine

    def check_ported(self) -> None:
        """Raise for an option the port does not know."""
        if self.accel not in ("none", "grid"):
            raise ValueError(f"unknown accel {self.accel!r}; "
                             "use 'none' or 'grid'")

    def base_pass_size(self) -> int:
        """Per-step pass size: the explicit setting, or the AUTO base (1 in
        compat mode — it quantizes per sample — else 4)."""
        if self.samples_per_pass is not None:
            return self.samples_per_pass
        return 1 if self.compat_int_accum else 4

    def auto_pass_growth(self) -> bool:
        """True when ``run()`` may grow pass sizes beyond the base: AUTO
        mode outside compat accumulation (both engines take spp at run
        time)."""
        return self.samples_per_pass is None and not self.compat_int_accum


class ProgressiveRenderer:
    """Accumulates samples pass by pass; supports reset (camera moved),
    checkpoint, and resume."""

    def __init__(self, scene, camera: Camera, config: RenderConfig,
                 on_pass: Optional[Callable] = None):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.on_pass = on_pass
        if config.compat_int_accum and config.base_pass_size() != 1:
            raise ValueError("compat_int_accum quantizes per sample; "
                             "set samples_per_pass=1")
        config.check_ported()
        self._engine = config.resolved_engine()
        self._device = torch.device(config.device)
        # pack ONCE: the tables (and the grid, built once per scene) live on
        # the rendering device for the renderer's lifetime
        self._packed = megakernel.pack_scene(scene, self._device)
        self._grid = (megakernel.pack_grid(build_grid(scene), self._device)
                      if config.accel == "grid" else None)
        self._seed = int(config.seed)
        # Space-key mode switch (CudaTracer.cu:760-765): ray-trace mode caps
        # paths at 1 bounce (usePathTracer=false ran 1 iteration).
        self._ray_trace_mode = False
        self.reset()

    def _render_pass(self, cam_params, first_sample: int, bounces: int,
                     pass_spp: int) -> torch.Tensor:
        """Mean radiance [n, 3] of global samples
        [first_sample, first_sample + pass_spp) — the SAME streams whichever
        engine or pass split, so resume and engine switch reproduce."""
        cfg = self.config
        render = (megakernel.render_megakernel if self._engine == "cuda"
                  else megakernel.render_megakernel_plain)
        img = render(self._packed, cam_params, self._seed, cfg.width,
                     cfg.height, pass_spp, max_bounces=bounces,
                     sample_offset=first_sample, physical=cfg.physical,
                     packed_grid=self._grid)
        return img.reshape(-1, 3)

    # -- control --------------------------------------------------------------
    def reset(self):
        """Restart accumulation (the reference's resetTicksThisFrame path,
        CudaTracer.cu:602-608) — call after moving the camera."""
        cfg = self.config
        dtype = torch.int32 if cfg.compat_int_accum else torch.float32
        self._accum = torch.zeros((cfg.width * cfg.height, 3), dtype=dtype,
                                  device=self._device)
        self._samples_done = 0
        self._meter = PassMeter(cfg.width, cfg.height,
                                jsonl_path=cfg.metrics_jsonl)

    def move_camera(self, key: str) -> bool:
        moved = self.camera.move(key)
        if moved:
            self.reset()
        return moved

    def toggle_ray_trace_mode(self) -> bool:
        """Space-key behavior (CudaTracer.cu:760-765): flip between path
        tracing and 1-bounce ray tracing; accumulation resets. Returns the
        new mode (True = ray-trace)."""
        self._ray_trace_mode = not self._ray_trace_mode
        self.reset()
        return self._ray_trace_mode

    @property
    def effective_bounces(self) -> int:
        return 1 if self._ray_trace_mode else self.config.max_bounces

    def step(self, pass_spp: Optional[int] = None) -> dict:
        """One progressive pass (default: the base pass size — 4 spp in
        AUTO mode, keeping interactive use responsive). ``run()`` passes
        larger ``pass_spp`` to amortize launch overhead (same kernel build —
        spp is a runtime argument)."""
        cfg = self.config
        n = pass_spp if pass_spp is not None else cfg.base_pass_size()
        if n != cfg.base_pass_size() and not cfg.auto_pass_growth():
            raise ValueError(
                f"pass_spp={n} differs from the configured "
                f"samples_per_pass={cfg.base_pass_size()}; variable pass "
                "sizes need AUTO mode (samples_per_pass=None)")
        cam_params = camera_arrays(self.camera)
        sync(self._device)
        t0 = time.perf_counter()
        img = self._render_pass(cam_params, self._samples_done,
                                self.effective_bounces, n)
        if cfg.compat_int_accum:
            # compat forces one sample per pass: the mean IS the sample
            self._accum = tonemap.compat_accumulate(self._accum, img,
                                                    cfg.gamma)
        else:
            self._accum = self._accum + img * float(n)
        sync(self._device)
        dt = time.perf_counter() - t0
        self._samples_done += n
        metrics = self._meter.record(n, dt)
        if self.on_pass:
            self.on_pass(metrics)
        return metrics

    # AUTO pass schedule: first pass small (fast feedback), then double up
    # to this cap, which keeps checkpoint cadence and progress lines
    # meaningful on long renders.
    AUTO_PASS_CAP = 1024

    def _auto_pass_size(self, s: int) -> int:
        """Size of the scheduled pass covering global sample ``s`` — a pure
        function of s (4, 8, 16, ... doubling to the cap), NOT of restart
        history, so a checkpoint/resume replays the exact pass boundaries
        and the float accumulation order (bit-identical resume)."""
        b, n = 0, self.config.base_pass_size()
        while b + n <= s:
            b += n
            n = min(n * 2, self.AUTO_PASS_CAP)
        return b + n - s  # completes the scheduled pass s sits in

    def run(self, total_spp: Optional[int] = None) -> np.ndarray:
        total = total_spp if total_spp is not None else self.config.spp
        base = self.config.base_pass_size()
        if self.config.auto_pass_growth():
            while self._samples_done < total:
                n = min(self._auto_pass_size(self._samples_done),
                        total - self._samples_done)
                m = self.step(n)
                print(self._meter.console_line(m), end="\r", flush=True)
        else:
            remaining = total - self._samples_done
            if remaining > 0 and remaining % base:
                raise ValueError(
                    f"requested {total} spp is not reachable in whole "
                    f"passes of {base} from {self._samples_done}")
            while self._samples_done < total:
                m = self.step()
                print(self._meter.console_line(m), end="\r", flush=True)
        print()
        return self.image()

    # -- output ---------------------------------------------------------------
    def _accum_numpy(self) -> np.ndarray:
        a = self._accum.detach().cpu().numpy()
        return a.astype(np.uint32) if self.config.compat_int_accum else a

    def radiance(self) -> np.ndarray:
        """Mean radiance [H,W,3] float32 (row 0 = bottom). In compat mode the
        stored quantity is already display-space; this inverts gamma back to
        an approximate radiance."""
        cfg = self.config
        denom = max(self._samples_done, 1)
        acc = self._accum_numpy().reshape(cfg.height, cfg.width, 3)
        if cfg.compat_int_accum:
            disp = acc.astype(np.float32) / (255.0 * denom)
            return disp ** (1.0 / cfg.gamma)
        return acc / denom

    def image_u8(self) -> np.ndarray:
        """Display image as uint8 [H,W,3]."""
        cfg = self.config
        denom = max(self._samples_done, 1)
        if cfg.compat_int_accum:
            u8 = tonemap.compat_display(self._accum, denom)
        else:
            u8 = tonemap.to_uint8(tonemap.tonemap(self._accum / denom,
                                                  cfg.gamma))
        return u8.cpu().numpy().reshape(cfg.height, cfg.width, 3)

    def image(self) -> np.ndarray:
        return self.image_u8().astype(np.float32) / 255.0

    def save(self, path: str):
        if path.endswith(".npy"):
            image_io.write_npy(path, self.radiance())
        elif path.endswith(".tga"):
            image_io.write_tga(path, self.image_u8())
        else:
            image_io.write_png(path, self.image_u8())

    # -- checkpoint / resume --------------------------------------------------
    def _scene_hash(self) -> str:
        """Content hash of the scene the accumulator was averaged over —
        restore refuses to blend two different scenes' samples."""
        h = hashlib.sha256()
        for _, leaf in sorted(scene_to_numpy(self.scene).items()):
            h.update(np.ascontiguousarray(leaf).tobytes())
        return h.hexdigest()[:16]

    def checkpoint(self, path: str):
        np.savez(
            path,
            accum=self._accum_numpy(),
            samples_done=self._samples_done,
            seed=self.config.seed,
            camera_position=self.camera.position,
            camera_rotation=self.camera.rotation,
            scene_hash=self._scene_hash(),
            engine=self._engine,
            ray_trace_mode=self._ray_trace_mode,
        )

    def restore(self, path: str):
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        if int(data["seed"]) != self.config.seed:
            raise ValueError("checkpoint seed mismatch — resume would not be exact")
        want_shape = (self.config.width * self.config.height, 3)
        want_dtype = np.uint32 if self.config.compat_int_accum else np.float32
        if data["accum"].shape != want_shape:
            raise ValueError(
                f"checkpoint resolution mismatch: accumulator {data['accum'].shape} "
                f"vs configured {want_shape}")
        if data["accum"].dtype != want_dtype:
            raise ValueError(
                f"checkpoint accumulation mode mismatch: {data['accum'].dtype} "
                f"vs configured {want_dtype.__name__}")
        if str(data["scene_hash"]) != self._scene_hash():
            raise ValueError(
                "checkpoint scene mismatch: the accumulator was rendered "
                "from a different scene — resuming would silently blend "
                "two images")
        if str(data["engine"]) != self._engine:
            raise ValueError(
                f"checkpoint engine mismatch: saved {data['engine']!r} vs "
                f"configured {self._engine!r} — RNG streams "
                "are shared but float op order differs; resume with the "
                "same engine for an exact continuation")
        accum = data["accum"]
        if self.config.compat_int_accum:
            accum = accum.astype(np.int32)
        self._accum = torch.from_numpy(np.array(accum)).to(self._device)
        self._samples_done = int(data["samples_done"])
        self.camera.position = data["camera_position"].astype(np.float32)
        self.camera.rotation = data["camera_rotation"].astype(np.float32)
        self._ray_trace_mode = bool(data["ray_trace_mode"])
