"""ctypes binding to the native C++ runtime (``libptnative``).

The reference's host-side work is C++ (scene assembly Scene.cpp:17-371,
screenshot encoding CudaTracer.cu:795-813); the repository keeps those
components native too, in ``native/scene_builder.cpp`` and
``native/image_io.cpp`` (a plain C ABI). This module builds them with the
host C++ compiler (``g++``, else ``c++``) through ``utils/compile_cache.py``
at first use and binds them with the reference's argument types and array
layouts. ``available()`` is False only where no host compiler exists; a
build that fails raises.

The renderer writes ``.tga`` files through ``write_tga``. Its display image
stays tonemapped on the rendering device (``ProgressiveRenderer.image_u8``);
``tonemap_u8`` is the host's version of the same bytes.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from .utils import compile_cache

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
SOURCES = ("scene_builder.cpp", "image_io.cpp")
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def host_compiler() -> Optional[str]:
    """Path of the host C++ compiler (``g++``, else ``c++``), or None."""
    return shutil.which("g++") or shutil.which("c++")


def load() -> Optional[ctypes.CDLL]:
    """The native library, built at first use and memoized; None where no
    host compiler exists."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        compiler = host_compiler()
        if compiler is None:
            return None
        lib = ctypes.CDLL(compile_cache.cached_library(
            compiler, FLAGS, [os.path.join(NATIVE_DIR, s) for s in SOURCES],
            "libptnative"))
        lib.ptn_build_scene.restype = ctypes.c_void_p
        lib.ptn_build_scene.argtypes = [ctypes.c_char_p]
        lib.ptn_free_scene.restype = None
        lib.ptn_free_scene.argtypes = [ctypes.c_void_p]
        for fn in ("ptn_num_spheres", "ptn_num_triangles", "ptn_num_materials",
                   "ptn_num_area_lights", "ptn_num_point_lights"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        for fn, args in (("ptn_get_spheres", [f32p, i32p]),
                         ("ptn_get_triangles", [f32p, i32p]),
                         ("ptn_get_materials", [f32p, i32p]),
                         ("ptn_get_area_lights", [f32p, f32p, i32p]),
                         ("ptn_get_point_lights", [f32p])):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [ctypes.c_void_p] + args
        lib.ptn_tonemap_u8.restype = None
        lib.ptn_tonemap_u8.argtypes = [f32p, ctypes.c_int, ctypes.c_float, u8p]
        lib.ptn_write_tga.restype = ctypes.c_int
        lib.ptn_write_tga.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def available() -> bool:
    """True where the library can be built (a host compiler exists)."""
    return load() is not None


def build_scene_arrays(preset: str):
    """Native scene build -> dict of numpy arrays: ``spheres`` [S,4] (centre,
    radius), ``sph_mat`` [S], ``triangles`` [T,18] (three vertices, three
    normals), ``tri_mat`` [T], ``materials`` [M,21], ``flags`` [M],
    ``al_power`` [La,3], ``al_area`` [La], ``al_tri0`` [La],
    ``point_lights`` [Lp,6] (position, power). None where the library is
    unavailable or the preset is not built natively."""
    lib = load()
    if lib is None:
        return None
    h = lib.ptn_build_scene(preset.encode())
    if not h:
        return None
    try:
        S = lib.ptn_num_spheres(h)
        T = lib.ptn_num_triangles(h)
        M = lib.ptn_num_materials(h)
        La = lib.ptn_num_area_lights(h)
        Lp = lib.ptn_num_point_lights(h)
        out = {
            "spheres": np.zeros((S, 4), np.float32), "sph_mat": np.zeros(S, np.int32),
            "triangles": np.zeros((T, 18), np.float32), "tri_mat": np.zeros(T, np.int32),
            "materials": np.zeros((M, 21), np.float32), "flags": np.zeros(M, np.int32),
            "al_power": np.zeros((La, 3), np.float32),
            "al_area": np.zeros(La, np.float32), "al_tri0": np.zeros(La, np.int32),
            "point_lights": np.zeros((Lp, 6), np.float32),
        }
        if S:
            lib.ptn_get_spheres(h, out["spheres"], out["sph_mat"])
        if T:
            lib.ptn_get_triangles(h, out["triangles"], out["tri_mat"])
        if M:
            lib.ptn_get_materials(h, out["materials"], out["flags"])
        if La:
            lib.ptn_get_area_lights(h, out["al_power"], out["al_area"], out["al_tri0"])
        if Lp:
            lib.ptn_get_point_lights(h, out["point_lights"])
        return out
    finally:
        lib.ptn_free_scene(h)


def tonemap_u8(radiance: np.ndarray, gamma: float = 1.0 / 2.2) -> np.ndarray:
    """Clamp + gamma + quantize of radiance [H,W,3] -> uint8 [H,W,3]; NaN
    and negatives give 0. Without a host compiler, numpy computes it."""
    lib = load()
    radiance = np.ascontiguousarray(radiance, np.float32)
    h, w = radiance.shape[:2]
    if lib is None:
        disp = np.clip(np.nan_to_num(radiance, nan=0.0), 0.0, 1.0) ** gamma
        return np.clip(255.0 * disp + 0.5, 0, 255).astype(np.uint8)
    out = np.zeros((h, w, 3), np.uint8)
    lib.ptn_tonemap_u8(radiance.reshape(-1), h * w, gamma, out.reshape(-1))
    return out


def write_tga(path: str, rgb_u8: np.ndarray) -> bool:
    """Write [H,W,3] uint8 RGB (row 0 at the bottom) in the reference's TGA
    byte layout. False where the library is unavailable or the file could
    not be written."""
    lib = load()
    if lib is None:
        return False
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = rgb_u8.shape[:2]
    return lib.ptn_write_tga(os.fsencode(path), rgb_u8.reshape(-1), w, h) == 0
