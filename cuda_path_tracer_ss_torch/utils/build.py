"""Builds and loads the package's hand-written kernels.

At first use a CUDA source under ``csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface and
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds, and
the kernels' builds can run side by side (one ``nvcc`` each). The library
comes from ``utils/compile_cache.py``: named by a hash of the compiler's
version, the flags, the source and every header of ``csrc/``, built once
under a lock and reused by every later process (the package's git-ignored
``build/``, or ``$CPT_TORCH_BUILD_DIR``). What ``ptxas -v`` says of each
kernel (registers, spills) is kept beside the library and read by
``ptxas_report``.

A failed build raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
from typing import Dict, List

from . import compile_cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

# kernel library name -> its source; every library may include every header
# of csrc/, and every one is in its key
CUDA_SOURCES = {"megakernel": "megakernel.cu",
                "megakernel_vjp": "megakernel_vjp.cu",
                "lightkernel": "lightkernel.cu"}

# FMA contraction stays off in the default build: the plain PyTorch version
# rounds after every multiply, and a 1-ulp change in a hit distance can
# reroute a glass path. Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, the PATH, then /usr/local/cuda."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc") or "")
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, the PATH "
                       "and /usr/local/cuda/bin): the CUDA kernels cannot "
                       "be built on this machine")


def _library_path(name: str, fmad: bool) -> str:
    flags = NVCC_FLAGS + (("-fmad=true",) if fmad else ("-fmad=false",))
    key = name + ("_fmad" if fmad else "")
    return compile_cache.cached_library(
        find_nvcc(), flags, [os.path.join(CSRC_DIR, CUDA_SOURCES[name])],
        "libcpt_" + key)


def load_kernels(name: str, fmad: bool = False) -> ctypes.CDLL:
    """The library of kernel ``name`` (a key of ``CUDA_SOURCES``), built on
    first use. ``fmad=True`` is a second build that lets ``nvcc`` contract
    ``a*b+c`` into FMAs; it exists to be measured against the default
    build."""
    key = name + ("_fmad" if fmad else "")
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(_library_path(name, fmad))
    return _loaded[key]


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_REGISTERS = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str, fmad: bool = False) -> List[Dict[str, object]]:
    """What ``ptxas -v`` said of each ``__global__`` function of library
    ``name`` when it was built: ``kernel`` (the mangled name; a template's
    bool arguments read ``Lb0E`` / ``Lb1E``), ``registers``, ``stack``,
    ``spill_stores``, ``spill_loads`` (bytes)."""
    with open(_library_path(name, fmad) + ".log") as f:
        text = f.read()
    kernels: List[Dict[str, object]] = []
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            kernels.append({"kernel": m.group(1)})
        elif kernels and (m := _SPILLS.search(line)):
            kernels[-1].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        elif kernels and (m := _REGISTERS.search(line)):
            kernels[-1]["registers"] = int(m.group(1))
    return kernels
