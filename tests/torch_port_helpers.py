"""Shared helpers of the tests/test_torch_*.py files: the bridge from the JAX
package (the reference) to the PyTorch/CUDA package (the port). Only test code
imports both packages; data crosses as numpy arrays.

Also the test-only host build of the CUDA kernels' device math
(``csrc/megakernel.cuh``, ``csrc/megakernel_vjp.cuh`` and
``csrc/lightkernel.cuh`` through ``tests/torch_kernel_host.cpp``): the only
way to exercise the CUDA source on a machine without a GPU. It is built once
for all test processes, in the package's build cache. It needs ``g++`` (or
``c++``) on the PATH and, for the FMA variant, an x86-64 CPU with FMA3; where
one is missing the tests that use it fail with that message."""
import ctypes
import dataclasses
import functools
import os
import shutil

import numpy as np
import torch

from cuda_path_tracer_ss_torch.models.scene import scene_from_numpy
from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as tlk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.utils import compile_cache
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


def jax_textured_quad(tex=True, nmap=False, sphere=False):
    """The JAX package's test scene of tests/test_texture.py::_quad_scene: a
    2x2 red/blue checker color map and / or a constant tilted normal map on a
    UV-mapped quad (or a sphere with procedural UVs) lit by a point light."""
    from cuda_path_tracer_ss_tpu.models.scene import MaterialSpec, SceneBuilder

    b = SceneBuilder()
    checker = np.zeros((2, 2, 3), np.float32)
    checker[:, 0] = (1.0, 0.1, 0.1)
    checker[:, 1] = (0.1, 0.1, 1.0)
    tid = b.add_texture(checker) if tex else -1
    nid = -1
    if nmap:
        nm = np.zeros((2, 2, 3), np.float32)
        nm[..., 0] = 0.85
        nm[..., 1] = 0.5
        nm[..., 2] = 0.9
        nid = b.add_texture(nm)
    m = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.8,
                                    texture=tid, normal_map=nid))
    if sphere:
        b.add_sphere((0.0, 0.0, -4.0), 1.6, m)
    else:
        v = [(-2, -2, -4), (2, -2, -4), (2, 2, -4), (-2, 2, -4)]
        uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
        n = (0, 0, 1)
        b.add_triangle(v[0], v[1], v[2], n, n, n, m, uv=(uv[0], uv[1], uv[2]))
        b.add_triangle(v[0], v[2], v[3], n, n, n, m, uv=(uv[0], uv[2], uv[3]))
    b.add_point_light((0.0, 0.0, -1.0), (60.0, 60.0, 60.0))
    b.background = np.zeros(3, np.float32)
    return b.build()


def jax_tilted_quad(area_light=False):
    """tests/test_pallas_vjp.py::test_vjp_triangle_geometry_gradients_match_jnp's
    scene: a tilted quad with unequal corner normals under a point light (and,
    with ``area_light``, an area light above it)."""
    from cuda_path_tracer_ss_tpu.models.scene import MaterialSpec, SceneBuilder

    b = SceneBuilder()
    md = b.add_material(MaterialSpec(diffuse=(0.6, 0.4, 0.3), diff_avg=0.8))
    n0, n1 = (0.1, 0.2, 0.97), (-0.15, 0.1, 0.98)
    b.add_triangle((-1.5, -1.2, -4.0), (1.4, -1.0, -4.4), (0.0, 1.3, -3.8),
                   n0, n1, (0.0, 0.0, 1.0), md)
    b.add_triangle((1.4, -1.0, -4.4), (1.8, 1.2, -4.1), (0.0, 1.3, -3.8),
                   n1, (0.05, -0.1, 0.99), (0.0, 0.0, 1.0), md)
    b.add_point_light((0.5, 2.5, -1.0), (60.0, 55.0, 50.0))
    if area_light:
        from cuda_path_tracer_ss_tpu.models.scene import rotate_deg, scale, translate

        ml = b.add_material(MaterialSpec(emission=(4.0, 4.0, 3.5)))
        b.add_area_light(translate((0.0, 2.0, -3.0)) @ rotate_deg(90.0, (1, 0, 0))
                         @ scale((1.5, 1.5, 1.5)), ml, (4.0, 4.0, 3.5))
    b.background = np.zeros(3, np.float32)
    return b.build()


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
def _host_kernel(fma):
    """The kernel math compiled for the host through the package's build
    cache (``utils/compile_cache.py``): one compile per flag set for all the
    test processes, under the cache's lock. ``fma=True`` lets the compiler
    contract ``a*b+c`` as ``nvcc -fmad=true`` and XLA's CPU backend do."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "the host build of the kernel math needs g++ or c++ on the PATH"
    flags = ["-std=c++17", "-O2", "-shared", "-fPIC", "-I", CSRC_DIR]
    if fma:
        with open("/proc/cpuinfo") as f:
            assert " fma " in f.read(), "the FMA host build needs an x86-64 CPU with FMA3"
        flags += ["-ffp-contract=fast", "-mfma"]
    else:
        flags += ["-ffp-contract=off"]
    out = compile_cache.cached_library(compiler, flags, [_HOST_SOURCE],
                                       f"libcpt_host_{int(fma)}")
    lib = ctypes.CDLL(out)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    scene_args = [vp, ci, vp, ci, vp, ci, vp, ci, vp, ci, vp,
                  vp, vp, vp, vp, ci,
                  vp, vp, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_float),
                  ci, ci, ci, ci, ci, ci, ci, ci]
    lib.cpt_render_megakernel_host.argtypes = scene_args + [ci, ci, ci, vp]
    lib.cpt_render_megakernel_host.restype = ci
    lib.cpt_backward_megakernel_host.argtypes = (
        scene_args + [ci] * 6 + [vp, vp] + [ci] * 2
        + [ctypes.c_longlong, vp, vp, ctypes.POINTER(ctypes.c_longlong)])
    lib.cpt_backward_megakernel_host.restype = ci
    lib.cpt_slot_floats_host.argtypes = [ci] * 6
    lib.cpt_slot_floats_host.restype = ci
    lib.cpt_light_records_host.argtypes = (
        [vp, ci] * 5 + [ctypes.POINTER(ctypes.c_float)] + [ci] * 11 + [vp] * 4)
    lib.cpt_light_records_host.restype = ci
    lib.cpt_light_image_host.argtypes = (
        [vp, ci] * 5 + [ctypes.POINTER(ctypes.c_float)] + [ci] * 11 + [vp])
    lib.cpt_light_image_host.restype = ci
    lib.cpt_sweeps_host.argtypes = [vp, ci, vp, ci, vp, vp,
                                    ctypes.POINTER(ctypes.c_int)] + [ci] + [vp] * 6
    lib.cpt_sweeps_host.restype = None
    lib.cpt_round_bf16_host.argtypes = [ci, vp, vp]
    lib.cpt_round_bf16_host.restype = None
    lib.cpt_norm3_vjp_host.argtypes = [ci, vp, vp, ctypes.c_float, vp]
    lib.cpt_norm3_vjp_host.restype = None
    lib.cpt_rot_y_to_vjp_host.argtypes = [ci, vp, vp, vp, vp, vp]
    lib.cpt_rot_y_to_vjp_host.restype = None
    lib.cpt_poly_host.argtypes = [ci, vp, vp, vp]
    lib.cpt_poly_host.restype = None
    lib.cpt_tex_fetch_host.argtypes = [vp, vp, ci, ci] + [vp] * 8
    lib.cpt_tex_fetch_host.restype = None
    lib.cpt_texture_block_host.argtypes = [vp, ci, vp, ci, vp, ci, vp, vp, vp, vp,
                                           ci, ci] + [vp] * 8
    lib.cpt_texture_block_host.restype = ci
    lib.cpt_perturb_normal_vjp_host.argtypes = [vp, ci, vp, ci] + [vp] * 6
    lib.cpt_perturb_normal_vjp_host.restype = None
    for name, nargs in (("triangle_t_vjp", 12), ("uv_vertex_vjp", 6),
                        ("tangent_edges_vjp", 6), ("physical_lobes_vjp", 9),
                        ("lobe_terms_vjp", 10), ("al_light_geom_vjp", 3),
                        ("al_sample_point_vjp", 8), ("physical_prev_pdf_vjp", 10)):
        fn = getattr(lib, f"cpt_{name}_host")
        fn.argtypes = [ci] + [vp] * nargs
        fn.restype = None
    lib.cpt_physical_direct_vjp_host.argtypes = (
        [vp, ci] * 5 + [ci, ci] + [vp] * 11 + [ci] * 7 + [vp] * 9)
    lib.cpt_physical_direct_vjp_host.restype = None
    return lib


def _scene_args(packed, cam_params, seed, width, height, spp, max_bounces,
                pixel_offset, n_local, sample_offset, sample_clamp,
                bidir_nu=None, packed_grid=None):
    """The leading arguments the host entries share, and the tables they
    point into (to be kept alive over the call)."""
    cam = tmk._cam_table(cam_params, sample_clamp, bidir_nu)
    cam_c = (ctypes.c_float * tmk.CAM_FLOATS)(*cam.tolist())
    tables = [t.detach().contiguous() for t in packed.tables()]
    tmk._check_grid(packed, packed_grid)
    args = []
    for t, count in zip(tables[:5], packed.counts):
        args += [t.data_ptr(), count]
    args += [tables[5].data_ptr(), *tmk.tex_args(packed),
             *tmk.grid_args(packed_grid), cam_c, int(seed),
             int(pixel_offset),
             int(n_local), int(sample_offset), int(spp), int(max_bounces),
             int(width), int(height)]
    return args, tables


def render_block_sums_hostbuild(packed, cam_params, seed, width, height, spp,
                                max_bounces, pixel_offset, n_local,
                                sample_offset=0, sample_clamp=0.0, fma=False,
                                physical=False, bidir_nu=None, packed_grid=None,
                                state_bf16=False, schedule="regenerating"):
    """``render_block_sums`` computed by the host build of the kernel math,
    one pixel at a time, on CPU tables (and a CPU grid). ``schedule``:
    "regenerating" (K1's render_pixel_t), "nested" (a loop over samples
    around a loop over bounces on the same per-path functions) or "staged"
    (render_pixel_t on the copy of the small tables K1's blocks make in
    shared memory)."""
    args, _tables = _scene_args(packed, cam_params, seed, width, height, spp,
                                max_bounces, pixel_offset, n_local,
                                sample_offset, sample_clamp, bidir_nu,
                                packed_grid)
    variant = tmk._check_variant(physical, bidir_nu)
    code = ("regenerating", "nested", "staged").index(schedule)
    out = torch.empty((n_local, 3), dtype=torch.float32)
    _host_kernel(fma).cpt_render_megakernel_host(*args, variant, int(state_bf16),
                                                 code, out.data_ptr())
    return out


def sweeps_hostbuild(packed, o, d, max_d, packed_grid=None):
    """The kernels' two scene sweeps from the host build on n rays (``o``,
    ``d`` [n, 3], ``max_d`` [n] numpy): (t [n], prim [n], occluded [n] bool)
    through the grid when one is given, else linear."""
    o, d = _runs(o), _runs(d)
    max_d = np.ascontiguousarray(max_d, np.float32)
    n = max_d.size
    t = np.empty(n, np.float32)
    prim, occ = np.empty(n, np.int32), np.empty(n, np.int32)
    tmk._check_grid(packed, packed_grid)
    sph, tri = (x.detach().contiguous() for x in (packed.spheres, packed.triangles))
    _host_kernel(False).cpt_sweeps_host(
        sph.data_ptr(), packed.counts[0], tri.data_ptr(), packed.counts[1],
        *tmk.grid_args(packed_grid), n, _ptr(o), _ptr(d), _ptr(max_d), _ptr(t),
        _ptr(prim), _ptr(occ))
    return t, prim, occ.astype(bool)


def round_bf16_hostbuild(x):
    """``csrc round_bf16`` elementwise on a float32 numpy array."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    _host_kernel(False).cpt_round_bf16_host(x.size, _ptr(x), _ptr(y))
    return y


def _light_args(packed, cam_params, seed, width, height, n_paths,
                max_bounces, path_offset, n_local, sample_idx, bidir_nu,
                schedule, n_lanes):
    """The arguments the host light entries share before their outputs, and
    the tables they point into (to be kept alive over the call)."""
    cam = tmk._cam_table(cam_params, 0.0, bidir_nu)
    cam_c = (ctypes.c_float * tmk.CAM_FLOATS)(*cam.tolist())
    tables = [t.detach().contiguous() for t in packed.tables()[:5]]
    args = []
    for t, count in zip(tables, packed.counts):
        args += [t.data_ptr(), count]
    args += [cam_c, int(seed), int(path_offset), int(n_local),
             int(sample_idx), int(n_paths), int(max_bounces), int(width),
             int(height), int(bidir_nu is not None),
             ("one_path", "regenerating").index(schedule), int(n_lanes or 1)]
    return args, tables


def light_records_hostbuild(packed, cam_params, seed, width, height, n_paths,
                            max_bounces, path_offset=0, n_local=None,
                            sample_idx=0, bidir_nu=None, fma=False,
                            schedule="one_path", n_lanes=None):
    """``light_records`` computed by the host build of the light kernel's
    math, on CPU tables. ``schedule``: "one_path" (each path traced to its
    end, one after the other) or "regenerating" (the kernel's schedule over
    ``n_lanes`` lanes, stepped lanes in order, one bounce per iteration)."""
    n_local = n_paths - path_offset if n_local is None else n_local
    args, _tables = _light_args(packed, cam_params, seed, width, height,
                                n_paths, max_bounces, path_offset, n_local,
                                sample_idx, bidir_nu, schedule, n_lanes)
    shape = (max_bounces + 1, n_local)
    pix = torch.zeros(shape, dtype=torch.int32)
    r, g, b = (torch.zeros(shape, dtype=torch.float32) for _ in range(3))
    _host_kernel(fma).cpt_light_records_host(
        *args, pix.data_ptr(), r.data_ptr(), g.data_ptr(), b.data_ptr())
    return pix, r, g, b


def light_image_hostbuild(packed, cam_params, seed, width, height, n_paths,
                          max_bounces, path_offset=0, n_local=None,
                          sample_idx=0, bidir_nu=None,
                          schedule="one_path", n_lanes=None):
    """``light_image`` (unnormalised, ``[width * height, 3]``) computed by
    the host build of the light kernel's image sink: every splat added by a
    serial float add, in the order of ``schedule`` (as for
    ``light_records_hostbuild``)."""
    n_local = n_paths - path_offset if n_local is None else n_local
    args, _tables = _light_args(packed, cam_params, seed, width, height,
                                n_paths, max_bounces, path_offset, n_local,
                                sample_idx, bidir_nu, schedule, n_lanes)
    img = torch.zeros((width * height, 3), dtype=torch.float32)
    _host_kernel(False).cpt_light_image_host(*args, img.data_ptr())
    return img


def backward_rows_hostbuild(packed, cam_params, seed, width, height, spp,
                            max_bounces, g_img, sample_offset=0, full=False,
                            tex_grads=False, packed_grid=None, physical=False,
                            geo=False, pixel_offset=0, n_local=None,
                            schedule="flat", capacity=None, record=False):
    """``backward_rows_cuda`` computed by the host build of the backward
    kernel's math (no FMA contraction), one pixel at a time, on CPU tables:
    the gradient rows (float64 sums) of the pixel range. ``schedule``:
    "flat" (the kernel's two passes, backward_pixel) or "nested" (a loop over
    samples around a replay and a reverse loop); ``capacity``: slots per
    pixel's stack (default: what the CUDA wrapper derives). With ``record``
    also the nonzero contributions in the order they were made: (rows, int32
    row indices, float32 values)."""
    n = width * height if n_local is None else n_local
    args, _tables = _scene_args(packed, cam_params, seed, width, height, spp,
                                max_bounces, pixel_offset, n, sample_offset,
                                0.0, packed_grid=packed_grid)
    g = (g_img.detach().reshape(n, 3).to(torch.float32) / spp).contiguous()
    tex_grads = bool(tex_grads) and packed.textured
    full = full or physical or geo
    texels = packed.tex_counts[1]
    rows = torch.zeros(tvjp._grad_rows(packed.counts, full,
                                       texels if tex_grads else 0, physical, geo),
                       dtype=torch.float64)
    if capacity is None:
        slot = tvjp._slot_floats(tvjp._st_planes(full, packed.textured, tex_grads,
                                                 packed.tex_nmap, physical))
        capacity = tvjp._stack_slots(spp, max_bounces, n, slot, full)
    lib = _host_kernel(False)
    cap = 0
    while True:
        rec_rows = np.empty(cap, np.int32)
        rec_vals = np.empty(cap, np.float32)
        count = ctypes.c_longlong(0)
        got = lib.cpt_backward_megakernel_host(
            *args, int(full), int(physical), int(geo), texels, int(tex_grads),
            int(packed.tex_nmap), g.data_ptr(), rows.data_ptr(),
            ("flat", "nested").index(schedule), int(capacity),
            cap,
            _ptr(rec_rows) if record else None, _ptr(rec_vals) if record else None,
            ctypes.byref(count))
        assert got == rows.numel(), (got, rows.numel())
        if not record:
            return rows
        if count.value <= cap:
            return rows, rec_rows[:count.value], rec_vals[:count.value]
        cap = count.value


def slot_floats_hostbuild(full, physical, geo, textured, tex_grads, nmap):
    """The backward kernel's floats per checkpoint slot (csrc: tex_layout)."""
    return _host_kernel(False).cpt_slot_floats_host(
        int(full), int(physical), int(geo), int(textured), int(tex_grads), int(nmap))


def backward_grads_hostbuild(packed, cam_params, seed, width, height, spp,
                             max_bounces, g_img, sample_offset=0, full=False,
                             tex_grads=False, packed_grid=None, physical=False,
                             geo=False, pixel_offset=0, n_local=None):
    """``backward_grads_cuda`` computed by the host build of the backward
    kernel's math (no FMA contraction), one pixel at a time, on CPU tables:
    (PackedScene cotangent, camera cotangent), unpacked from the gradient
    rows by the port's own ``_unpack_rows``."""
    rows = backward_rows_hostbuild(packed, cam_params, seed, width, height, spp,
                                   max_bounces, g_img, sample_offset, full,
                                   tex_grads, packed_grid, physical, geo,
                                   pixel_offset, n_local)
    tex_grads = bool(tex_grads) and packed.textured
    return tvjp._unpack_rows(rows, packed, full, tex_grads, physical, geo)


def _three_runs(*arrays):
    return [np.ascontiguousarray(np.stack(a), np.float32) for a in arrays]


def norm3_vjp_hostbuild(v, g, eps):
    """``csrc norm3_vjp`` over n inputs; v, g: three arrays of n each."""
    v, g = _three_runs(v, g)
    out = np.empty_like(v)
    _host_kernel(False).cpt_norm3_vjp_host(
        v.shape[1], v.ctypes.data, g.ctypes.data, eps, out.ctypes.data)
    return out


def rot_y_to_vjp_hostbuild(t, s, g):
    """``csrc rot_y_to_vjp`` over n inputs -> (A_target, A_sample)."""
    t, s, g = _three_runs(t, s, g)
    a_t, a_s = np.empty_like(t), np.empty_like(t)
    _host_kernel(False).cpt_rot_y_to_vjp_host(
        t.shape[1], t.ctypes.data, s.ctypes.data, g.ctypes.data,
        a_t.ctypes.data, a_s.ctypes.data)
    return a_t, a_s


def _runs(a, dtype=np.float32):
    """[n] or [n, k] -> k contiguous runs of n values (the host entries' layout)."""
    a = np.asarray(a, dtype)
    return np.ascontiguousarray(a.T if a.ndim == 2 else a)


def _ptr(a):
    return a.ctypes.data


def poly_hostbuild(x, y):
    """``csrc`` poly_atan(x), poly_atan2(y, x), poly_asin(x) and their
    derivatives atan'(x), d atan2/dy, d atan2/dx, asin'(x): [7, n]."""
    x, y = _runs(x), _runs(y)
    out = np.empty((7, x.size), np.float32)
    _host_kernel(False).cpt_poly_host(x.size, _ptr(x), _ptr(y), _ptr(out))
    return out


def tex_fetch_hostbuild(packed, tid, u, v):
    """``csrc tex_fetch<true>`` per lane: (val [n, 3], idx [n, 4], w [n, 4],
    du [n, 3], dv [n, 3])."""
    tid, u, v = _runs(tid), _runs(u), _runs(v)
    n = tid.size
    val, du, dv = (np.empty((3, n), np.float32) for _ in range(3))
    idx = np.empty((4, n), np.int32)
    w = np.empty((4, n), np.float32)
    atlas, meta = (t.detach().contiguous() for t in packed.tex_tables()[:2])
    _host_kernel(False).cpt_tex_fetch_host(
        atlas.data_ptr(), meta.data_ptr(), packed.tex_counts[0], n, _ptr(tid),
        _ptr(u), _ptr(v), _ptr(val), _ptr(idx), _ptr(w), _ptr(du), _ptr(dv))
    return val.T, idx.T, w.T, du.T, dv.T


def texture_block_hostbuild(packed, o, d, prim, mat, nrm):
    """``csrc texture_block<true, true>`` at n hits: (diffuse' [n, 3], normal'
    [n, 3], UV partials [n, 6])."""
    o, d, nrm = _runs(o), _runs(d), _runs(nrm)
    prim, mat = _runs(prim, np.int32), _runs(mat, np.int32)
    n = prim.size
    diffuse, nrm_out = np.empty((3, n), np.float32), np.empty((3, n), np.float32)
    uvg = np.empty((6, n), np.float32)
    tabs = [t.detach().contiguous() for t in
            (packed.spheres, packed.triangles, packed.materials)
            + packed.tex_tables()]
    c = packed.counts
    _host_kernel(False).cpt_texture_block_host(
        tabs[0].data_ptr(), c[0], tabs[1].data_ptr(), c[1], tabs[2].data_ptr(), c[2],
        *(t.data_ptr() for t in tabs[3:]), packed.tex_counts[0], n, _ptr(o), _ptr(d),
        _ptr(prim), _ptr(mat), _ptr(nrm), _ptr(diffuse), _ptr(nrm_out), _ptr(uvg))
    return diffuse.T, nrm_out.T, uvg.T


def perturb_normal_vjp_hostbuild(packed, prim, raw, t, g):
    """``csrc perturb_normal_vjp`` at n hits, the tangent source taken as the
    backward kernel takes it: (A_raw_normal [n, 3], A_texel [n, 3])."""
    prim = _runs(prim, np.int32)
    raw, t, g = _runs(raw), _runs(t), _runs(g)
    n = prim.size
    an, at = np.empty((3, n), np.float32), np.empty((3, n), np.float32)
    tri, triuv = (x.detach().contiguous() for x in (packed.triangles, packed.tex_triuv))
    _host_kernel(False).cpt_perturb_normal_vjp_host(
        tri.data_ptr(), packed.counts[0], triuv.data_ptr(), n, _ptr(prim), _ptr(raw),
        _ptr(t), _ptr(g), _ptr(an), _ptr(at))
    return an.T, at.T


# ---- gradients: the reference's oracle and the port's engines ------------------

# The cases of tests/test_pallas_vjp.py: its size, its seed, its fields.
VJP_W = VJP_H = 12
VJP_SPP = 2
VJP_BOUNCES = 4
VJP_SEED = 5
VJP_FIELDS = ["materials.diffuse", "materials.specular", "materials.emission",
              "materials.absorption", "materials.diff_avg",
              "materials.roughness", "materials.ior", "al_power"]
VJP_FULL_ONLY = {"materials.roughness", "materials.ior", "materials.spec_exp",
                 "pl_pos"}


def vjp_case_fields(jscene, grad_mode):
    """The fields tests/test_pallas_vjp.py::_engine_pair differentiates."""
    fields = [f for f in VJP_FIELDS
              if f != "al_power" or jscene.num_area_lights]
    if grad_mode == "linear":
        fields = [f for f in fields if f not in VJP_FULL_ONLY]
    if jscene.num_point_lights:
        fields = fields + ["pl_power"]
        if grad_mode == "full":
            fields = fields + ["pl_pos"]
    return fields


def jax_value_and_grad(jscene, fields, width, height, spp, bounces, seed,
                       physical=False, jit=True):
    """The oracle: ``jax.value_and_grad`` of the MSE-to-zero loss over the
    reference's jnp engine (``render(..., live_cutoff=None)``, ``physical``
    its unbiased estimator) with respect to the named scene fields -> (loss,
    {field: numpy gradient}). ``jit=False`` runs it op by op: at a few
    pixels that costs less than compiling it."""
    import jax
    import jax.numpy as jnp
    from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
    from cuda_path_tracer_ss_tpu.render import inverse as jinverse
    from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays, render

    cp = camera_arrays(JCamera())
    params = jinverse.extract_params(jscene, fields)

    def loss(params, seed):
        s = jinverse.merge_params(jscene, params)
        img = render(s, cp, width, height, spp, seed, max_bounces=bounces,
                     live_cutoff=None, physical=physical)
        return jnp.mean(img ** 2)

    if jit:
        v, g = jax.device_get(jax.jit(jax.value_and_grad(loss))(params, seed))
    else:
        with jax.disable_jit():
            v, g = jax.device_get(jax.value_and_grad(loss)(params, seed))
    return float(v), {k: np.asarray(a) for k, a in g.items()}


@functools.lru_cache(maxsize=None)
def jax_preset_value_and_grad(name, grad_mode):
    """The oracle on preset ``name`` at the VJP_* size, cached per process."""
    from cuda_path_tracer_ss_tpu.models import presets as jpresets

    jscene = getattr(jpresets, name)()
    fields = vjp_case_fields(jscene, grad_mode)
    v, g = jax_value_and_grad(jscene, fields, VJP_W, VJP_H, VJP_SPP,
                              VJP_BOUNCES, VJP_SEED)
    return jscene, fields, v, g


def render_diff_hostbuild(packed, cam_params, seed, width, height, spp,
                          max_bounces=8, grad_mode="full", packed_grid=None,
                          physical=False, pixel_offset=0, n_local=None):
    """``render_megakernel_diff`` as the CUDA kernels would compute it, on CPU
    tables: the package's own ``torch.autograd.Function`` with both launches
    replaced by the host build of their device math (forward =
    csrc/megakernel.cuh, backward = csrc/megakernel_vjp.cuh). With
    ``n_local``, the tile ``[pixel_offset, pixel_offset + n_local)`` alone,
    ``[n_local, 3]``, as a rank of ``render_megakernel_diff_sharded`` runs it."""
    full = tvjp._check_grad_mode(grad_mode, physical)
    tvjp._check_geo_grid(grad_mode, packed_grid)
    tex_grads = tvjp._tex_grads(packed, full)
    cam = tuple(torch.as_tensor(v, dtype=torch.float32) for v in cam_params)
    tile = n_local is not None
    img = tvjp._RenderDiff.apply(
        *packed.tables(), packed.tex_atlas, *cam, packed, int(seed), width,
        height, spp, max_bounces, 0, pixel_offset,
        n_local if tile else width * height, full, tex_grads, packed_grid,
        bool(physical), grad_mode == "geo",
        (render_block_sums_hostbuild, backward_grads_hostbuild))
    return img if tile else img.reshape(height, width, 3)


def port_value_and_grad(scene, cam_params, fields, width, height, spp, bounces,
                        seed, engine, grad_mode, packed_grid=None, physical=False):
    """(loss, {field: numpy gradient}) of the MSE-to-zero loss on the port:
    ``engine`` "plain" (autograd through the plain render) or "host" (the
    kernels' math from the host build); ``packed_grid`` sweeps through the
    grid; ``physical`` renders and differentiates the physical estimator."""
    from cuda_path_tracer_ss_torch.render import inverse as tinverse

    render = {"plain": tvjp.render_megakernel_diff_plain,
              "host": render_diff_hostbuild}[engine]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tinverse.extract_params(scene, fields).items()}
    packed = tmk.pack_scene(tinverse.merge_params(scene, leaves), "cpu")
    img = render(packed, cam_params, seed, width, height, spp,
                 max_bounces=bounces, grad_mode=grad_mode, packed_grid=packed_grid,
                 physical=physical)
    val = torch.mean(img ** 2)
    grads = torch.autograd.grad(val, list(leaves.values()))
    return float(val.detach()), {k: g.numpy() for k, g in zip(leaves, grads)}


def assert_grads_close(got, want, fields):
    """The tolerances of tests/test_pallas_vjp.py: every gradient within
    rtol 1e-3 and atol 1e-4 * max|g_want|. Both sides evaluate the same
    estimator on the same streams, so what remains is float op-order noise
    through cancellations."""
    for k in fields:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert np.all(np.isfinite(b)), k
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=k)


# ---- the hand-written adjoints of the geo and physical modes, lane by lane -----

def _lanes(*arrays):
    """[n] / [n, k] arrays -> their run layouts (and keep-alive list)."""
    return [_runs(a) for a in arrays]


def _out(n, k=None, dtype=np.float32):
    return np.zeros((n,) if k is None else (k, n), dtype)


def triangle_t_vjp_hostbuild(s, d, e1, e2, t, at, aw1, aw2):
    """``csrc triangle_t_vjp<true>``: (a_s, a_d, a_e1, a_e2), each [n, 3]."""
    ins = _lanes(s, d, e1, e2, t, at, aw1, aw2)
    n = ins[4].size
    outs = [_out(n, 3) for _ in range(4)]
    _host_kernel(False).cpt_triangle_t_vjp_host(n, *map(_ptr, ins), *map(_ptr, outs))
    return [o.T for o in outs]


def uv_vertex_vjp_hostbuild(tri, triuv, p, a_u, a_v):
    """``csrc uv_vertex_vjp`` on triangle rows [n, 19], UVs [n, 6]: [n, 9]."""
    tri = np.ascontiguousarray(tri, np.float32)
    triuv = np.ascontiguousarray(triuv, np.float32)
    p, a_u, a_v = _lanes(p, a_u, a_v)
    n = a_u.size
    out = _out(n, 9)
    _host_kernel(False).cpt_uv_vertex_vjp_host(n, _ptr(tri), _ptr(triuv), _ptr(p), _ptr(a_u),
                                               _ptr(a_v), _ptr(out))
    return out.T


def tangent_edges_vjp_hostbuild(tri, triuv, raw, t, g):
    """The tangent frame's edge terms (perturb_normal_vjp's tangent cotangent
    through tri_uv_tangent_vjp) on triangle rows [n, 19]: [n, 6] (e1, e2)."""
    tri = np.ascontiguousarray(tri, np.float32)
    triuv = np.ascontiguousarray(triuv, np.float32)
    raw, t, g = _lanes(raw, t, g)
    n = raw.shape[1]
    out = _out(n, 6)
    _host_kernel(False).cpt_tangent_edges_vjp_host(n, _ptr(tri), _ptr(triuv), _ptr(raw),
                                                   _ptr(t), _ptr(g), _ptr(out))
    return out.T


def physical_lobes_vjp_hostbuild(d, nrm, cos_i, m, a_lb):
    """``csrc physical_lobes_vjp``: (a_d [n, 3], a_n [n, 3], a_cos [n],
    a_m [n, 20]); a_lb [n, 12] = (nu, gloss axis, ct axis, prob_g, prob_ct,
    nv)."""
    d, nrm, cos_i, m, a_lb = _lanes(d, nrm, cos_i, m, a_lb)
    n = cos_i.size
    a_d, a_n, a_m = _out(n, 3), _out(n, 3), _out(n, 20)
    a_cos = _out(n)
    _host_kernel(False).cpt_physical_lobes_vjp_host(
        n, _ptr(d), _ptr(nrm), _ptr(cos_i), _ptr(m), _ptr(a_lb), _ptr(a_d), _ptr(a_n),
        _ptr(a_cos), _ptr(a_m))
    return a_d.T, a_n.T, a_cos, a_m.T


def lobe_terms_vjp_hostbuild(d, nrm, m, w, a5):
    """``csrc lobe_terms_vjp`` with the lobes of (d, n, m): (a_lb [n, 12],
    a_m [n, 20], a_d, a_n, a_w [n, 3])."""
    d, nrm, m, w, a5 = _lanes(d, nrm, m, w, a5)
    n = d.shape[1]
    a_lb, a_m = _out(n, 12), _out(n, 20)
    a_d, a_n, a_w = _out(n, 3), _out(n, 3), _out(n, 3)
    _host_kernel(False).cpt_lobe_terms_vjp_host(
        n, _ptr(d), _ptr(nrm), _ptr(m), _ptr(w), _ptr(a5), _ptr(a_lb), _ptr(a_m), _ptr(a_d),
        _ptr(a_n), _ptr(a_w))
    return a_lb.T, a_m.T, a_d.T, a_n.T, a_w.T


def al_light_geom_vjp_hostbuild(al, a9):
    """``csrc al_light_geom_vjp`` on area-light rows [n, 23]: [n, 18]."""
    al = np.ascontiguousarray(al, np.float32)
    (a9,) = _lanes(a9)
    n = al.shape[0]
    out = _out(n, 18)
    _host_kernel(False).cpt_al_light_geom_vjp_host(n, _ptr(al), _ptr(a9), _ptr(out))
    return out.T


def al_sample_point_vjp_hostbuild(al, u1, u2, upick, a_l, a_nl):
    """``csrc al_sample_point_vjp``: (a_v [n, 18], a_tn [n, 6] the two
    triangles' normal cotangents)."""
    al = np.ascontiguousarray(al, np.float32)
    u1, u2, upick, a_l, a_nl = _lanes(u1, u2, upick, a_l, a_nl)
    n = u1.size
    a_v, a_tn = _out(n, 18), _out(n, 6)
    _host_kernel(False).cpt_al_sample_point_vjp_host(
        n, _ptr(al), _ptr(u1), _ptr(u2), _ptr(upick), _ptr(a_l), _ptr(a_nl), _ptr(a_v),
        _ptr(a_tn))
    return a_v.T, a_tn.T


def physical_prev_pdf_vjp_hostbuild(d, nrm, nd, m, branch, a_pdf):
    """``csrc physical_prev_pdf_vjp``: (a_d, a_n, a_nd [n, 3], a_m [n, 20])."""
    d, nrm, nd, m, a_pdf = _lanes(d, nrm, nd, m, a_pdf)
    (branch,) = _lanes(branch)
    branch = np.ascontiguousarray(branch, np.int32)
    n = a_pdf.size
    a_d, a_n, a_nd, a_m = _out(n, 3), _out(n, 3), _out(n, 3), _out(n, 20)
    _host_kernel(False).cpt_physical_prev_pdf_vjp_host(
        n, _ptr(d), _ptr(nrm), _ptr(nd), _ptr(m), _ptr(branch), _ptr(a_pdf), _ptr(a_d),
        _ptr(a_n), _ptr(a_nd), _ptr(a_m))
    return a_d.T, a_n.T, a_nd.T, a_m.T


# Rows physical_direct_vjp_hostbuild lays out per lane: per material 12 (its
# emission at +9), per point light 6, per area light 21 (its vertices at +3).
def direct_rows_layout(counts):
    num_mats, num_pls, num_als = counts[2], counts[3], counts[4]
    row_pl0 = 12 * num_mats
    row_al0 = row_pl0 + 6 * num_pls
    return row_pl0, row_al0, row_al0 + 21 * num_als


def physical_direct_vjp_hostbuild(packed, seed, pixel, sample, pair0, p, nrm, d, t, pp, m,
                                  prim, g, geo):
    """``csrc physical_direct_vjp<geo>`` at n hits: dict of dir, a_p, a_n, a_d
    [n, 3], a_t, a_pp [n], a_m [n, 20], rows [n, R] (direct_rows_layout) and
    occ [n, Lp + La] (1: the shadow ray ran and was occluded)."""
    tables = [x.detach().contiguous() for x in packed.tables()[:5]]
    args = []
    for x, count in zip(tables, packed.counts):
        args += [x.data_ptr(), count]
    ints = [np.ascontiguousarray(a, np.int32) for a in (pixel, sample, pair0, prim)]
    p, nrm, d, t, pp, m, g = _lanes(p, nrm, d, t, pp, m, g)
    n = t.size
    row_pl0, row_al0, nrows = direct_rows_layout(packed.counts)
    out = dict(dir=_out(n, 3), a_p=_out(n, 3), a_n=_out(n, 3), a_d=_out(n, 3), a_t=_out(n),
               a_pp=_out(n), a_m=_out(n, 20))
    rows = np.zeros((n, nrows), np.float64)
    occ = np.zeros((n, packed.counts[3] + packed.counts[4]), np.int32)
    _host_kernel(False).cpt_physical_direct_vjp_host(
        *args, int(seed), n, _ptr(ints[0]), _ptr(ints[1]), _ptr(ints[2]), _ptr(p), _ptr(nrm),
        _ptr(d), _ptr(t), _ptr(pp), _ptr(m), _ptr(ints[3]), _ptr(g), int(geo), row_pl0, 6, 12,
        row_al0, 21, nrows, *(_ptr(out[k]) for k in ("dir", "a_p", "a_n", "a_d", "a_t", "a_pp",
                                                     "a_m")),
        _ptr(rows), _ptr(occ))
    out = {k: (v.T if v.ndim == 2 else v) for k, v in out.items()}
    out.update(rows=rows, occ=occ)
    return out


# ---- the small scenes of tests/test_silhouette.py, in either package ------------

def silhouette_scene(name, scene_mod):
    """Scene ``name`` of the JAX package's tests/test_silhouette.py, built
    with ``scene_mod`` (``cuda_path_tracer_ss_tpu.models.scene`` or
    ``cuda_path_tracer_ss_torch.models.scene``): the same arrays either way.
    "mirror_tableau" is the reflected-sphere scene with the reflected-edge
    scene's off-frustum triangle added (both mirror families at once)."""
    m = scene_mod
    b = m.SceneBuilder()
    rot_down = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                         [0, 0, 0, 1]], np.float32)
    mirror = m.MaterialSpec(diffuse=(0.0, 0.0, 0.0), diff_avg=0.0,
                            specular=(1.0, 1.0, 1.0), spec_exp=float("inf"),
                            spec_avg=1.0, flags=m.MAT_FLAG_PURE_REFLECTION)
    if name == "emissive_sphere":
        e = b.add_material(m.MaterialSpec(emission=(3.0, 3.0, 3.0)))
        b.add_sphere((0.0, 0.0, -4.0), 1.2, e)
    elif name == "triangle":
        e = b.add_material(m.MaterialSpec(emission=(3.0, 3.0, 3.0)))
        n = (0.0, 0.0, 1.0)
        b.add_triangle((-1.0, -0.8, -4.0), (1.2, -0.6, -4.0), (0.1, 1.1, -4.0),
                       n, n, n, e)
    elif name in ("shadow", "tri_blocker", "glossy_shadow"):
        glossy = name == "glossy_shadow"
        md = b.add_material(
            m.MaterialSpec(diffuse=(0.15, 0.15, 0.15), diff_avg=0.1,
                           specular=(1.0, 1.0, 1.0), spec_avg=0.7, spec_exp=40.0,
                           ior=8.0) if glossy
            else m.MaterialSpec(diffuse=(0.9, 0.9, 0.9), diff_avg=0.8))
        if glossy:   # a glossy wall at z=-5 facing the camera
            n = (0.0, 0.0, 1.0)
            b.add_triangle((-3, -3, -5), (3, -3, -5), (3, 3, -5), n, n, n, md)
            b.add_triangle((-3, -3, -5), (3, 3, -5), (-3, 3, -5), n, n, n, md)
        else:        # a floor at y=-2 facing up
            n = (0.0, 1.0, 0.0)
            b.add_triangle((-4, -2, -8), (4, -2, -8), (4, -2, -1), n, n, n, md)
            b.add_triangle((-4, -2, -8), (4, -2, -1), (-4, -2, -1), n, n, n, md)
        mb = b.add_material(m.MaterialSpec(diffuse=(0.0, 0.0, 0.0), diff_avg=0.0))
        if name == "shadow":
            b.add_sphere((0.0, 0.5, -4.0), 0.8, mb)
        elif name == "glossy_shadow":
            b.add_sphere((0.0, 2.4, -3.5), 0.5, mb)
        else:
            nb = (0.0, 1.0, 0.0)
            b.add_triangle((-1.2, 0.5, -4.9), (1.2, 0.5, -4.6), (0.0, 0.5, -3.0),
                           nb, nb, nb, mb)
        ml = b.add_material(m.MaterialSpec(emission=(4.0, 4.0, 4.0)))
        t = (m.translate((0.0, 3.0, -2.0)) @ np.diag([1.2, 1.2, 1.2, 1.0]) if glossy
             else m.translate((0.0, 3.0, -4.0)) @ np.diag([1.5, 1.5, 1.5, 1.0]))
        b.add_area_light(t @ rot_down, ml, (1.0, 1.0, 1.0))
    elif name == "buried_sphere":
        mq = b.add_material(m.MaterialSpec(emission=(1.0, 1.0, 1.0)))
        ms = b.add_material(m.MaterialSpec(emission=(4.0, 4.0, 4.0)))
        n = (0.0, 0.0, 1.0)
        b.add_triangle((-6.0, -6.0, -4.0), (6.0, -6.0, -4.0), (6.0, 6.0, -4.0),
                       n, n, n, mq)
        b.add_triangle((-6.0, -6.0, -4.0), (6.0, 6.0, -4.0), (-6.0, 6.0, -4.0),
                       n, n, n, mq)
        b.add_sphere((0.0, 0.0, -4.55), 1.0, ms)
    elif name in ("mirror_sphere", "mirror_edge", "mirror_tableau"):
        mm = b.add_material(mirror)
        ms = b.add_material(m.MaterialSpec(emission=(3.0, 3.0, 3.0)))
        A = (-0.8485282, -1.2, -2.1514718)
        B = (0.8485282, -1.2, -3.8485282)
        C = (0.8485282, 1.2, -3.8485282)
        D = (-0.8485282, 1.2, -2.1514718)
        n = (0.70710678, 0.0, 0.70710678)
        b.add_triangle(A, B, C, n, n, n, mm)
        b.add_triangle(A, C, D, n, n, n, mm)
        if name != "mirror_sphere":
            nx = (-1.0, 0.0, 0.0)
            b.add_triangle((6.0, -1.5, -1.9), (6.0, -1.5, -4.1), (6.0, 1.5, -3.0),
                           nx, nx, nx, ms)
        if name != "mirror_edge":
            b.add_sphere((6.0, 0.0, -3.0), 1.5, ms)
    elif name == "mirror_shadow":
        mm = b.add_material(mirror)
        A = (-1.2727922, -1.8, -1.7272078)
        B = (1.2727922, -1.8, -4.2727922)
        C = (1.2727922, 1.8, -4.2727922)
        D = (-1.2727922, 1.8, -1.7272078)
        n = (0.70710678, 0.0, 0.70710678)
        b.add_triangle(A, B, C, n, n, n, mm)
        b.add_triangle(A, C, D, n, n, n, mm)
        md = b.add_material(m.MaterialSpec(diffuse=(0.9, 0.9, 0.9), diff_avg=0.8))
        ny = (0.0, 1.0, 0.0)
        b.add_triangle((5.0, -4.0, -4.5), (8.0, -4.0, -4.5), (8.0, -4.0, -1.5),
                       ny, ny, ny, md)
        b.add_triangle((5.0, -4.0, -4.5), (8.0, -4.0, -1.5), (5.0, -4.0, -1.5),
                       ny, ny, ny, md)
        mb = b.add_material(m.MaterialSpec(diffuse=(0.0, 0.0, 0.0), diff_avg=0.0))
        b.add_sphere((6.5, -1.5, -3.0), 0.8, mb)
        ml = b.add_material(m.MaterialSpec(emission=(12.0, 12.0, 12.0)))
        t = m.translate((6.5, 1.0, -3.0)) @ np.diag([2.0, 2.0, 2.0, 1.0])
        b.add_area_light(t @ rot_down, ml, (3.0, 3.0, 3.0))
    elif name in ("curved_mirror", "no_mirror"):
        ml = b.add_material(m.MaterialSpec(emission=(8.0, 8.0, 8.0)))
        md = m.MaterialSpec(diffuse=(0.9, 0.4, 0.2), diff_avg=0.8,
                            emission=(6.0, 6.0, 6.0) if name == "curved_mirror"
                            else (0.0, 0.0, 0.0))
        if name == "curved_mirror":
            # a big curved mirror fills the view; a glowing sphere behind the
            # camera dominates its reflection
            b.add_sphere((0.0, 0.0, -4.0), 1.8, b.add_material(mirror))
            b.add_sphere((0.0, 0.0, 7.0), 6.0, b.add_material(md))
            b.add_area_light(m.translate((0.0, 5.5, -3.0)) @ m.rotate_deg(90, (1, 0, 0))
                             @ m.scale((2.0,) * 3), ml, (30.0, 30.0, 30.0))
        else:
            b.add_sphere((0.0, 0.0, -4.0), 1.0, b.add_material(md))
            b.add_area_light(m.translate((0.0, 3.0, -3.0)) @ m.rotate_deg(90, (1, 0, 0))
                             @ m.scale((2.0,) * 3), ml, (30.0, 30.0, 30.0))
    else:
        raise KeyError(name)
    b.background = np.zeros(3, np.float32)
    return b.build()
