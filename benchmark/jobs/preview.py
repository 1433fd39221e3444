"""The interactive loop of ``cli interact`` / ``cli view`` without the
terminal and the image encoding, one user in a closed loop: each iteration
one base pass (``step()``) and the display image read back to the host
(``image_u8()``); every ``key_every``-th iteration first applies a camera
key, which resets accumulation.

Keys come in pairs: a key drawn from the seed among ``keys``, then, a key
later, the key that undoes it, so that the camera stays within one step of
its start. The drawn keys come in rounds that take each of ``keys`` once,
in an order drawn from the seed, so that every seed asks the same work of
the renderer (the same views, as often), in another order.

Traffic parameters: ``pass_spp`` (the base pass; AUTO's 4), ``key_every``,
``keys``; ``checked_displays`` (displays compared: drawn from the seed among
the first ``check_span`` passes, and the last), ``checked_pixels``;
``tally_paths``; ``trace_units`` = [first pass traced, passes traced].
"""
from __future__ import annotations

import time

import numpy as np

from cptbench import checks, faults, inputs, roofline
from cptbench.reference import camera as ref_camera
from cptbench.reference import pathtracer

# (config overrides, traffic overrides) that make a run of this job kind take
# seconds on the CPU, for the harness's tests
TINY = (dict(width=16, height=16),
        dict(checked_pixels=16, check_span=10, tally_paths=512, key_every=3))


def plant(kind, stack):
    """Break this job kind's timed path as ``kind`` says
    (``cptbench/faults.py``): K1's samples, the renderer's accumulation,
    the display."""
    dict(control=faults.k1_control, unchanged=faults.renderer_unchanged,
         half=faults.k1_half, altered=faults.display_altered)[kind](stack)


class Job:
    def __init__(self, run):
        self.run = run
        c, t = run.config, run.traffic
        self.width, self.height = c["width"], c["height"]
        self.bounces, self.physical = c["max_bounces"], c["physical"]
        self.pass_spp = t["pass_spp"]
        self.arrays = inputs.scene_arrays(c)
        self._keys = inputs.stream(run.seed, 5)
        self._round = []        # keys left of this round, drawn from the end
        self.key_log = []       # keys applied, in order
        self.results = []
        self.slice_passes = []  # (keys applied, first sample, samples)

    def _renderer(self, seed: int):
        from cuda_path_tracer_ss_torch.models.camera import Camera
        from cuda_path_tracer_ss_torch.render.renderer import (
            ProgressiveRenderer, RenderConfig)

        cam = self.run.config["camera"]
        return ProgressiveRenderer(
            self.scene,
            Camera(position=np.asarray(cam["position"], np.float32),
                   rotation=np.asarray(cam["rotation"], np.float32),
                   z_near=cam["z_near"], fov=cam["fov"]),
            RenderConfig(width=self.width, height=self.height,
                         max_bounces=self.bounces, seed=seed,
                         physical=self.physical, device=self.run.device))

    def setup(self):
        from cuda_path_tracer_ss_torch.models.scene import scene_from_numpy

        self.scene = scene_from_numpy(self.arrays)
        r = self._renderer(inputs.int32_seeds(self.run.seed, 0, 1)[0])
        for key in ("w", None, "s", None):
            if key:
                r.move_camera(key)
            r.step()
            r.image_u8()
        t = self.run.traffic
        self.session_seed = inputs.int32_seeds(self.run.seed, 1, 1)[0]
        self.keep = set(int(x) for x in inputs.stream(self.run.seed, 2).choice(
            t["check_span"], t["checked_displays"] - 1, replace=False))

    def _key(self) -> str:
        if len(self.key_log) % 2:
            return ref_camera.INVERSE_KEY[self.key_log[-1]]
        if not self._round:
            self._round = [str(k) for k in
                           self._keys.permutation(list(self.run.traffic["keys"]))]
        return self._round.pop()

    def window(self, seconds, slicer):
        from cuda_path_tracer_ss_torch.ops.cuda import megakernel

        t = self.run.traffic
        first, n_traced = t["trace_units"]
        every = t["key_every"]
        launches = megakernel.LAUNCH_COUNT
        r = self._renderer(self.session_seed)
        unit_s = []
        kept = {}
        done = 0
        t0 = time.perf_counter()
        i = 0
        while True:
            if i == first:
                slicer.begin()
            key = self._key() if i and i % every == 0 else None
            ts = time.perf_counter()
            if key:
                r.move_camera(key)
            m = r.step(self.pass_spp)
            u8 = r.image_u8()
            unit_s.append(time.perf_counter() - ts)
            if key:
                self.key_log.append(key)
            done = m["samples_per_pixel"]
            if slicer.active:
                self.slice_passes.append((len(self.key_log), done - self.pass_spp,
                                          self.pass_spp))
            if i + 1 == first + n_traced:
                slicer.end()
            if i in self.keep:
                kept[i] = (len(self.key_log), done, u8, None)
            i += 1
            if time.perf_counter() - t0 >= seconds and not slicer.active:
                break
        window_s = time.perf_counter() - t0
        kept[i - 1] = (len(self.key_log), done, u8, r)
        self._kept = kept
        return dict(seconds=window_s, units=i, unit_seconds=unit_s,
                    work={"primary_rays": i * self.width * self.height * self.pass_spp},
                    counters={"k1_launches": megakernel.LAUNCH_COUNT - launches})

    def release(self):
        n = self.width * self.height
        for idx, (n_keys, samples, u8, r) in sorted(self._kept.items()):
            pix = inputs.stream(self.run.seed, 3, idx).choice(
                n, self.run.traffic["checked_pixels"], replace=False)
            self.results.append(dict(
                keys=n_keys, samples=samples, pixels=pix,
                u8=np.asarray(u8).reshape(n, 3)[pix],
                radiance=None if r is None else r.radiance().reshape(n, 3)[pix]))
        self._kept = None

    def _camera(self, n_keys: int):
        cam = ref_camera.Camera.from_config(self.run.config["camera"])
        for key in self.key_log[:n_keys]:
            cam.move(key)
        return cam.arrays()

    def check(self):
        tb = pathtracer.pack(inputs.scene_tensors(self.arrays), self.run.device)
        refs = [checks.pixel_means(tb, self._camera(e["keys"]), self.session_seed,
                                   self.width, self.height, e["pixels"],
                                   e["samples"], self.bounces, self.physical,
                                   self.run.device)
                for e in self.results]
        with_rad = [(e["radiance"], ref) for e, ref in zip(self.results, refs)
                    if e["radiance"] is not None]
        return dict(
            radiance_gap_p50=checks.radiance_gap_p50(
                [p for p, _ in with_rad], [q for _, q in with_rad]),
            display_off_share=checks.display_off_share(
                [e["u8"] for e in self.results], refs))

    def slice_units(self) -> int:
        return len(self.slice_passes)

    def slice_work(self, symbol):
        if symbol != roofline.K1_SYMBOL or not self.slice_passes:
            return None
        tb = pathtracer.pack(inputs.scene_tensors(self.arrays), self.run.device)
        per = max(1, self.run.traffic["tally_paths"] // len(self.slice_passes))
        gen = inputs.stream(self.run.seed, 4)
        tal = checks.add_tallies([
            checks.tally(tb, self._camera(k), self.session_seed, self.width,
                         self.height, per, spp, self.bounces, self.physical,
                         self.run.device, gen, sample_offset=s0)
            for k, s0, spp in self.slice_passes])
        moved = ((checks.table_bytes(tb) + 12 * self.width * self.height)
                 * len(self.slice_passes))
        return roofline.k1_flops(tb.counts, tal, self.physical), moved
