"""Converged renders back to back, one client in a closed loop: each render
a new ``ProgressiveRenderer`` with its own seed, run to the configuration's
spp under the AUTO pass schedule, its display image read back to the host
(``run()``, as ``cli render`` does before it saves).

Traffic parameters: ``spp`` per render; ``checked_renders`` (the first, one
drawn from the seed among the next few, the last); ``checked_pixels`` per
checked render; ``tally_paths`` (the reference's share of the traced
renders' paths); ``trace_units`` = [first render traced, renders traced].
"""
from __future__ import annotations

import contextlib
import io
import time

import numpy as np

from cptbench import checks, faults, inputs, roofline
from cptbench.reference import camera as ref_camera
from cptbench.reference import pathtracer

# (config overrides, traffic overrides) that make a run of this job kind take
# seconds on the CPU, for the harness's tests
TINY = (dict(width=16, height=16),
        dict(spp=20, checked_pixels=16, tally_paths=512))


def plant(kind, stack):
    """Break this job kind's timed path as ``kind`` says
    (``cptbench/faults.py``): K1's samples, the renderer's accumulation,
    the display."""
    dict(control=faults.k1_control, unchanged=faults.renderer_unchanged,
         half=faults.k1_half, altered=faults.display_altered)[kind](stack)


class _Discard(io.TextIOBase):
    def write(self, s):
        return len(s)


class Job:
    def __init__(self, run):
        self.run = run
        c, t = run.config, run.traffic
        self.width, self.height = c["width"], c["height"]
        self.bounces, self.physical = c["max_bounces"], c["physical"]
        self.spp = t["spp"]
        self.arrays = inputs.scene_arrays(c)
        self.seeds = inputs.stream(run.seed, 1)
        self.kept = {}
        self.results = []
        self.slice_seeds = []

    def _render(self, seed: int):
        from cuda_path_tracer_ss_torch.models.camera import Camera
        from cuda_path_tracer_ss_torch.render.renderer import (
            ProgressiveRenderer, RenderConfig)

        cam = self.run.config["camera"]
        r = ProgressiveRenderer(
            self.scene,
            Camera(position=np.asarray(cam["position"], np.float32),
                   rotation=np.asarray(cam["rotation"], np.float32),
                   z_near=cam["z_near"], fov=cam["fov"]),
            RenderConfig(width=self.width, height=self.height,
                         max_bounces=self.bounces, spp=self.spp, seed=seed,
                         physical=self.physical, device=self.run.device))
        with contextlib.redirect_stdout(_Discard()):
            img = r.run()
        return r, img

    def _next_seed(self) -> int:
        return int(self.seeds.integers(0, 2 ** 31 - 1))

    def setup(self):
        from cuda_path_tracer_ss_torch.models.scene import scene_from_numpy

        self.scene = scene_from_numpy(self.arrays)
        self._render(inputs.int32_seeds(self.run.seed, 0, 1)[0])
        k = self.run.traffic["checked_renders"]
        self.keep = {0} | set(int(x) for x in inputs.stream(self.run.seed, 2)
                              .integers(1, 8, max(k - 2, 0)))

    def window(self, seconds, slicer):
        from cuda_path_tracer_ss_torch.ops.cuda import megakernel

        first, n_traced = self.run.traffic["trace_units"]
        launches = megakernel.LAUNCH_COUNT
        unit_s = []
        t0 = time.perf_counter()
        i = 0
        while True:
            if i == first:
                slicer.begin()
            seed = self._next_seed()
            t = time.perf_counter()
            r, img = self._render(seed)
            unit_s.append(time.perf_counter() - t)
            if slicer.active:
                self.slice_seeds.append(seed)
            if i + 1 == first + n_traced:
                slicer.end()
            if i in self.keep:
                self.kept[i] = (seed, r, img)
            self.last = (seed, r, img)
            i += 1
            if time.perf_counter() - t0 >= seconds and not slicer.active:
                break
        window_s = time.perf_counter() - t0
        self.kept[i - 1] = self.last
        return dict(seconds=window_s, units=i, unit_seconds=unit_s,
                    work={"primary_rays": i * self.width * self.height * self.spp},
                    counters={"k1_launches": megakernel.LAUNCH_COUNT - launches})

    def release(self):
        """The compared values to the host; the renderers go."""
        n = self.width * self.height
        for idx, (seed, r, img) in sorted(self.kept.items()):
            pix = inputs.stream(self.run.seed, 3, idx).choice(
                n, self.run.traffic["checked_pixels"], replace=False)
            u8 = np.rint(np.asarray(img, np.float64) * 255.0).astype(np.uint8)
            self.results.append(dict(
                seed=seed, pixels=pix, samples=self.spp,
                radiance=r.radiance().reshape(n, 3)[pix],
                u8=u8.reshape(n, 3)[pix]))
        self.kept = self.last = None

    def _tables_cam(self):
        dev = self.run.device
        tb = pathtracer.pack(inputs.scene_tensors(self.arrays), dev)
        return tb, ref_camera.Camera.from_config(self.run.config["camera"]).arrays()

    def check(self):
        tb, cam = self._tables_cam()
        refs = [checks.pixel_means(tb, cam, e["seed"], self.width, self.height,
                                   e["pixels"], e["samples"], self.bounces,
                                   self.physical, self.run.device)
                for e in self.results]
        return dict(
            radiance_gap_p50=checks.radiance_gap_p50(
                [e["radiance"] for e in self.results], refs),
            display_off_share=checks.display_off_share(
                [e["u8"] for e in self.results], refs))

    def slice_units(self) -> int:
        return len(self.slice_seeds)

    def slice_work(self, symbol):
        if symbol != roofline.K1_SYMBOL or not self.slice_seeds:
            return None
        tb, cam = self._tables_cam()
        per = self.run.traffic["tally_paths"] // len(self.slice_seeds)
        gen = inputs.stream(self.run.seed, 4)
        tal = checks.add_tallies([
            checks.tally(tb, cam, s, self.width, self.height, per, self.spp,
                         self.bounces, self.physical, self.run.device, gen)
            for s in self.slice_seeds])
        launches = self.run.window["counters"]["k1_launches"] / self.run.window["units"]
        moved = (checks.table_bytes(tb) + 12 * self.width * self.height) \
            * launches * len(self.slice_seeds)
        return roofline.k1_flops(tb.counts, tal, self.physical), moved
