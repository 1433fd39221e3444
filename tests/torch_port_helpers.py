"""Shared helpers of the tests/test_torch_*.py files: the bridge from the JAX
package (the reference) to the PyTorch/CUDA package (the port). Only test code
imports both packages; data crosses as numpy arrays.

Also the test-only host build of the CUDA kernel's device math
(``csrc/megakernel.cuh`` through ``tests/torch_kernel_host.cpp``): the only way
to exercise the CUDA source on a machine without a GPU. It needs ``g++`` (or
``c++``) on the PATH and, for the FMA variant, an x86-64 CPU with FMA3; where
one is missing the tests that use it fail with that message."""
import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from cuda_path_tracer_ss_torch.models.scene import scene_from_numpy
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.utils.build import CSRC_DIR

_HOST_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_kernel_host.cpp")


def jax_scene_to_numpy(scene):
    """Flatten a JAX-package Scene into the port's dict layout: field names
    as keys (``materials.<name>`` nested), Vec3 fields as ``[N, 3]``."""
    def arr(v):
        if hasattr(v, "x"):
            return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)
        return np.asarray(v)

    d = {}
    for f in dataclasses.fields(scene):
        if f.name == "materials":
            for g in dataclasses.fields(scene.materials):
                d["materials." + g.name] = arr(getattr(scene.materials, g.name))
        else:
            d[f.name] = arr(getattr(scene, f.name))
    return d


def port_scene(jax_scene):
    """The port's Scene holding the same arrays as a JAX-package Scene."""
    return scene_from_numpy(jax_scene_to_numpy(jax_scene))


def assert_per_pixel_parity(got, want):
    """The repo's per-pixel criterion (tests/test_pallas_cpu.py): same random
    streams on both sides, so only float op-order noise remains — all
    channels of >= 99.5 % of pixels within rtol 1e-4 / atol 1e-5 (a few
    chaotic paths may flip a branch on a 1-ulp difference) and channel means
    within rtol 1e-3."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(got.reshape(-1, 3).mean(0),
                               want.reshape(-1, 3).mean(0), rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _host_build_dir():
    return tempfile.TemporaryDirectory(prefix="cpt_host_kernel_")


@functools.lru_cache(maxsize=None)
def _host_kernel(fma):
    """The kernel math compiled for the host into a temporary directory that
    goes with the process. ``fma=True`` lets the compiler contract ``a*b+c``
    as ``nvcc -fmad=true`` and XLA's CPU backend do."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "the host build of the kernel math needs g++ or c++ on the PATH"
    flags = ["-std=c++17", "-O2", "-shared", "-fPIC", "-I", CSRC_DIR]
    if fma:
        with open("/proc/cpuinfo") as f:
            assert " fma " in f.read(), "the FMA host build needs an x86-64 CPU with FMA3"
        flags += ["-ffp-contract=fast", "-mfma"]
    else:
        flags += ["-ffp-contract=off"]
    out = os.path.join(_host_build_dir().name, f"libcpt_host_{int(fma)}.so")
    proc = subprocess.run([compiler, *flags, "-o", out, _HOST_SOURCE],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(out).cpt_render_megakernel_host
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, ci, vp, ci, vp, ci, vp, ci, vp,
                   ctypes.POINTER(ctypes.c_float),
                   ci, ci, ci, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def render_block_sums_hostbuild(packed, cam_params, seed, width, height, spp,
                                max_bounces, pixel_offset, n_local,
                                sample_offset=0, sample_clamp=0.0, fma=False):
    """``render_block_sums`` computed by the host build of the kernel math,
    one pixel at a time, on CPU tables."""
    fn = _host_kernel(fma)
    cam = tmk._cam_table(cam_params, sample_clamp)
    cam_c = (ctypes.c_float * tmk.CAM_FLOATS)(*cam.tolist())
    tables = [t.contiguous() for t in packed.tables()]
    out = torch.empty((n_local, 3), dtype=torch.float32)
    counts = packed.counts
    fn(tables[0].data_ptr(), counts[0], tables[1].data_ptr(), counts[1],
       tables[2].data_ptr(), counts[2], tables[3].data_ptr(), counts[3],
       tables[4].data_ptr(), counts[4], tables[5].data_ptr(), cam_c,
       int(seed), int(pixel_offset), int(n_local), int(sample_offset),
       int(spp), int(max_bounces), int(width), int(height), out.data_ptr())
    return out
