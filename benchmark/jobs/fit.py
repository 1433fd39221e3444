"""Inversion jobs back to back, one client in a closed loop: each job
``invert(engine="cuda")`` for ``steps`` Adam steps from a new seeded start
with a new seed, toward one target image, as ``cli invert`` runs it. Every
step ends in ``invert``'s own read of the loss, a synchronisation.

The target is the reference's render of the true scene (from a seeded
stream), made in set-up and handed to both sides. A job's start is the true
scene with the configuration's perturbed field moved by a seeded uniform
draw. The first ``checked_steps`` steps of every job are captured from
``invert``'s callback (loss, the gradient the optimizer got, the parameters
after the update); after the window the reference follows one job drawn from
the seed through those steps.

Traffic parameters: ``steps`` per job, ``fields``, ``physical``;
``checked_steps``; ``tally_paths``; ``trace_units`` = [first step traced,
steps traced] in the first job.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from cptbench import checks, faults, inputs, roofline
from cptbench.reference import camera as ref_camera
from cptbench.reference import fit, pathtracer, rng

# (config overrides, traffic overrides) that make a run of this job kind take
# seconds on the CPU, for the harness's tests
TINY = (dict(width=8, height=8, spp=2), dict(steps=4, tally_paths=256))


def plant(kind, stack):
    """Break this job kind's timed path as ``kind`` says
    (``cptbench/faults.py``): Adam's update, the samples and the image of
    ``render_megakernel_diff`` (K1 forward, K2 backward). The control is
    ``control_line``."""
    dict(unchanged=faults.adam_unchanged, half=faults.k2_half,
         altered=faults.k2_altered)[kind](stack)


def control_line(cell: dict, seed: int) -> dict:
    """The control, with no window: the reference with bfloat16 carries put
    in the program's place for the first steps of job 0 of ``seed``, held
    against the float32 reference."""
    from cptbench import runner

    run = runner.Run(cell, seed, 0.0, False, "cuda")
    job = Job(run)
    job.setup()
    arrays, job_seed = job._start(0)
    start = {k: torch.from_numpy(arrays[k].copy()) for k in job.fields}
    args = (inputs.scene_tensors(job.arrays), start, job.cam, job_seed,
            cell["traffic"]["checked_steps"], job.lr, job.resample, job.width,
            job.height, job.spp, job.bounces, job.target, job.physical, "cuda")
    numbers, _ = checks.training_numbers(fit.follow(*args, state_bf16=True),
                                         fit.follow(*args), start)
    ok, compared, _ = runner.compare(numbers, cell["limits"])
    return dict(correct=ok, checks=compared)


class Job:
    def __init__(self, run):
        self.run = run
        c, t = run.config, run.traffic
        self.width, self.height = c["width"], c["height"]
        self.spp, self.bounces = c["spp"], c["max_bounces"]
        self.lr, self.resample = c["lr"], c["resample_every"]
        self.fields = list(t["fields"])
        self.physical = bool(t["physical"])
        self.arrays = inputs.scene_arrays(c)
        self.cam = ref_camera.Camera.from_config(c["camera"]).arrays()
        self.captured = []      # per job: (start, seed, [step captures])
        self.slice_steps = []   # (step seed, parameters it rendered with)

    def _start(self, key: int):
        """(scene arrays, job seed) of job ``key``."""
        p = self.run.config["start_perturbation"]
        gen = inputs.stream(self.run.seed, 6, key)
        arrays = dict(self.arrays)
        a = arrays[p["field"]]
        arrays[p["field"]] = np.clip(
            a + gen.uniform(-p["max_abs"], p["max_abs"], a.shape),
            *p["clip"]).astype(np.float32)
        return arrays, int(gen.integers(0, 2 ** 31 - 1))

    def _invert(self, arrays, seed: int, steps: int, callback=None):
        from cuda_path_tracer_ss_torch.models.scene import scene_from_numpy
        from cuda_path_tracer_ss_torch.render.inverse import invert

        engine = "cuda" if torch.device(self.run.device).type == "cuda" else "plain"
        return invert(scene_from_numpy(arrays), self.cam, self.target,
                      self.fields, self.width, self.height, spp=self.spp,
                      steps=steps, lr=self.lr, seed=seed,
                      max_bounces=self.bounces, resample_every=self.resample,
                      callback=callback, engine=engine, physical=self.physical,
                      device=self.run.device)

    def setup(self):
        dev = self.run.device
        tgt_seed = inputs.int32_seeds(self.run.seed, 7, 1)[0]
        self.target = fit.render_image(
            inputs.scene_tensors(self.arrays), self.cam, tgt_seed, self.width,
            self.height, self.spp, self.bounces, self.physical, dev
        ).reshape(self.height, self.width, 3)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        arrays, seed = self._start(1 << 30)
        self._invert(arrays, seed, 2)

    def window(self, seconds, slicer):
        from cuda_path_tracer_ss_torch.ops.cuda import megakernel, megakernel_vjp

        t = self.run.traffic
        first, n_traced = t["trace_units"]
        n_check = t["checked_steps"]
        k1, k2 = megakernel.LAUNCH_COUNT, megakernel_vjp.LAUNCH_COUNT
        steps = 0
        unit_s = []
        t0 = time.perf_counter()
        job = 0
        while True:
            arrays, seed = self._start(job)
            caps = []

            def callback(step, loss, params, job=job, seed=seed):
                if step < n_check:
                    caps.append(dict(
                        loss=float(loss),
                        grad={k: p.grad.detach().clone() for k, p in params.items()},
                        params={k: p.detach().clone() for k, p in params.items()}))
                if job == 0 and first - 1 <= step < first + n_traced - 1:
                    if step == first - 1:
                        slicer.begin()
                    if slicer.active:
                        s = (rng.seed_for(seed, (step + 1) // self.resample)
                             if self.resample else seed)
                        self.slice_steps.append(
                            (s, {k: p.detach().clone() for k, p in params.items()}))
                if job == 0 and step == first + n_traced - 1:
                    slicer.end()

            ts = time.perf_counter()
            self._invert(arrays, seed, t["steps"], callback)
            unit_s.append(time.perf_counter() - ts)
            start = {k: torch.from_numpy(np.array(arrays[k])) for k in self.fields}
            self.captured.append((start, seed, caps))
            steps += t["steps"]
            job += 1
            if time.perf_counter() - t0 >= seconds and not slicer.active:
                break
        window_s = time.perf_counter() - t0
        return dict(seconds=window_s, units=steps, unit_seconds=unit_s,
                    work={"jobs": job},
                    counters={"k1_launches": megakernel.LAUNCH_COUNT - k1,
                              "k2_launches": megakernel_vjp.LAUNCH_COUNT - k2})

    def release(self):
        pick = int(inputs.stream(self.run.seed, 8).integers(0, len(self.captured)))
        self.checked = self.captured[pick]
        self.captured = None

    def check(self):
        start, seed, caps = self.checked
        ref = fit.follow(inputs.scene_tensors(self.arrays), start, self.cam, seed,
                         len(caps), self.lr, self.resample, self.width,
                         self.height, self.spp, self.bounces, self.target,
                         self.physical, self.run.device)
        numbers, kept = checks.training_numbers(caps, ref, start)
        print("fit check: leaves compared " + ", ".join(kept), file=sys.stderr)
        return numbers

    def slice_units(self) -> int:
        return len(self.slice_steps)

    def slice_work(self, symbol):
        if symbol not in (roofline.K1_SYMBOL, roofline.K2_SYMBOL) or not self.slice_steps:
            return None
        dev = self.run.device
        scene = inputs.scene_tensors(self.arrays)
        per = max(1, self.run.traffic["tally_paths"] // len(self.slice_steps))
        gen = inputs.stream(self.run.seed, 4)
        parts = []
        for s, params in self.slice_steps:
            tb = pathtracer.pack({**scene, **params}, dev)
            parts.append(checks.tally(tb, self.cam, s, self.width, self.height,
                                      per, self.spp, self.bounces,
                                      self.physical, dev, gen))
        tal = checks.add_tallies(parts)
        n = self.width * self.height
        moved = (checks.table_bytes(tb) + 12 * n) * len(self.slice_steps)
        flops = (roofline.k1_flops(tb.counts, tal, self.physical)
                 if symbol == roofline.K1_SYMBOL else
                 roofline.k2_flops(tb.counts, tal, self.physical))
        return flops, moved
