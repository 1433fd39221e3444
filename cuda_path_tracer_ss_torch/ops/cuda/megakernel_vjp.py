"""Differentiable megakernel render: the fast engine trains.

``render_megakernel_diff`` renders with the forward CUDA megakernel and
back-propagates with a SECOND hand-written CUDA kernel
(``csrc/megakernel_vjp.cu``, device math in ``csrc/megakernel_vjp.cuh``) that
*replays* every path from the shared counter-based RNG (``utils/rng.py``:
uniforms are pure functions of (seed, pixel, sample, pair), so the replay is
exact), checkpoints each bounce, and runs the adjoint recurrence

    A_mid(b) = A_after(b) * w(b) + g * direct(b);   A_in(b) = A_mid(b) * beer(b)

summing parameter cotangents into gradient rows. It replaces the TPU kernel
``cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py::_make_backward_kernel``
(launched by ``_backward_grads``) in every grad mode, on untextured and
textured scenes, replaying through linear sweeps or through the supercell
grid (``packed_grid``: the forward kernel's own grid sweeps; the grid gets no
gradient). Discrete decisions (which primitive is hit,
visibility, the scatter branch) are detached; continuous factors are
differentiated.

``grad_mode="linear"`` covers the throughput-linear fields
(``PALLAS_TRAINABLE_FIELDS``). ``grad_mode="full"`` (the default) also carries
dL/d(origin, direction) through every scatter step and hit and into the eye
ray: roughness, ior, spec_exp, point-light positions, sphere centres and radii
and the camera (rotation, position, tan_half_fov) receive gradients.
``grad_mode="geo"`` adds the triangle geometry (``TRI_FIELDS``): rows for
every triangle's packed (v0, e1, e2, n0, n1, n2) — the Moller-Trumbore adjoint
of the winning triangle, its corner normals' barycentric weights — and for
every area light's six vertices, which ``pack_scene``'s autograd carries back
into ``tri_v*`` / ``tri_n*``. ``physical=True`` differentiates the physical
(unbiased MIS) estimator exactly (the hand-written adjoint of its direct
phase and of the emission-MIS pdf chain, ``csrc/megakernel.cuh``): the field
set ``PALLAS_TRAINABLE_FIELDS_PHYS`` (``materials.spec_avg`` in, ``al_power``
out), with geo ``PALLAS_TRAINABLE_FIELDS_PHYS_GEO``. Both build on the full
path adjoint; geo takes no grid (its ``ValueError``: the cell lists would go
stale as the vertices move).

On a textured scene the replay re-runs the forward's texture block, and
the texel rows are computed when the atlas requires grad: ``textures`` trains
in both modes on a color-mapped scene. The effective
albedo's cotangent is split into material rows (times the texel) and texel
rows (times the material's diffuse, one ``atomicAdd`` per bilinear corner and
channel). Full mode adds the UV swim (the texel factor moves with the hit) and,
on a normal-mapped scene, the hand-written pullback of the tangent-frame
perturbation into the raw normal and the normal map's texels (geo: and into
the triangle's edges, which the tangent frame follows; and the UVs' vertex
terms at a fixed hit point). Linear mode cannot reach normal-map texels:
training them in linear mode raises ``ValueError`` rather than returning
zeros.

The schedule is per-lane path regeneration in two flat passes: a thread
replays every path of its pixel in one loop, one bounce per iteration,
starting its next sample's eye ray as soon as a path ends and pushing every
stored bounce onto its own checkpoint stack; a second loop pops the stack,
one reverse bounce per iteration (the eye ray's VJP after a path's bounce 0).
No lane of a warp waits for the warp's longest path of a sample. A stack
holds ``capacity`` slots of ``_slot_floats`` floats (the checkpoint planes
and two that say where a path ended, padded to four), and a lane starts no
path while fewer than ``max(max_bounces, 1)`` are free, so the passes
alternate in rounds when it fills. The wrapper derives the capacity, no
caller sets it (``_stack_slots``)::

    span     = max(max_bounces, 1)
    paths    = min(spp, max(1, SCRATCH_BUDGET // (span * slot_floats * 4 * n)))
    paths    = min(paths, LINEAR_PATHS_PER_ROUND)  # linear mode only
    capacity = span * paths                        # slots per pixel
    scratch  = capacity * slot_floats * n floats   # n pixels of the launch

with ``SCRATCH_BUDGET`` 2 GiB: in full, geo and physical mode one round
whenever ``spp`` paths of ``max_bounces`` bounces fit in it, as at cornell
256x256 x 16 spp x 8 bounces (capacity 128; 1.21 GB full and geo, 1.34 GB
physical). Linear mode's reverse sweep is cheap, and there stacks of 1, 2
or 4 paths per round ran 8-10 % faster on an H100 than one round of 16
paths, whose stacks leave L2 (``k1_turns.py``); it keeps 4 paths per round
(capacity 32 at 8 bounces, 0.17 GB at cornell 256x256), the most of the
three, so that its lanes still start new paths within a round, while full
and physical mode ran 1.2-2.0x slower on those stacks. The largest of
``chip_smoke.py``'s training
configurations is the color+normal quad at 256x256 x 32 spp x 4 bounces,
full mode with texel gradients: slot 84 floats, capacity 96, 2.11 GB. The
checkpoint bytes written and read are those of the stored bounces alone;
the footprint is the whole stack.

What bounds the kernel on an H100: the replay is one forward render's FP32
work, the reverse sweep adds work per stored bounce, and the checkpoints
(``planes * 4`` bytes per stored bounce, 16 planes in linear mode, 33 in
full and geo mode, 38 in physical mode, plus the textured blocks of
``_st_planes``) are written and read once; on a small scene those bytes over
the memory rate come out just above the operations over the FP32 rate, and
the kernel runs far from both (divergent paths, dependent ``sqrt`` / ``div``
chains). What the design does about it: one thread per pixel branches on its
own path — a miss ends the replay, only the adjoint of the scatter branch
that was drawn is evaluated, material and primitive rows are read and written
by direct index; a lane's slots lie together, so its checkpoints move as
whole sectors (``float4``) whatever the stack depths of the other lanes.
Cross-block accumulation never depends on block order: each block sums its
rows in shared memory with ``atomicAdd`` and writes them once to a ``[blocks,
rows]`` buffer that ``torch.sum(0)`` reduces; scenes whose rows do not fit
shared memory (4 rows per sphere, 18 per triangle in geo mode) add into
``[rows]`` with global atomics. The 13 camera rows that every path of the
full modes adds to are summed per thread in shared memory and reduced once
per block. Float additions therefore happen in an order that changes from
run to run: two runs agree to rounding, not to the bit.

Device rule: tables on a CUDA device go to the kernels, or the call raises;
the plain version (``render_megakernel_diff_plain``: autograd through the
plain forward render) runs only for tables on the CPU, or when called by name.

``render_megakernel_diff_sharded`` trains over several ranks
(``parallel.mesh``): each rank runs the forward kernel and, in the backward
pass, the replay kernel on its own tile of pixels with the tile's slice of
the image cotangent; the tiles merge with one psum, and the gradients of the
replicated tables and camera are summed over the ranks by
``parallel.mesh.replicate``.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import torch

from ...parallel.mesh import (PIXEL_AXIS, axis_index, axis_size, check_device,
                              in_full_image, psum, replicate, tile_range)
from ...utils.profiling import span
from . import megakernel as mk
from .megakernel import PackedScene

# Material gradient rows per material, in row order: diffuse(3) specular(3)
# absorption(3) emission(3) diff_avg(1); full mode adds roughness, ior,
# spec_exp; physical mode spec_avg.
P_COLS = 13
P_COLS_FULL = 16
P_COLS_PHYS = 17
# Geo mode: rows per triangle (v0, e1, e2, n0, n1, n2) and per area light
# (power 3, then its six vertices 18).
TRI_ROWS = 18
AL_ROWS_GEO = 21
# Camera rows appended after the background in full mode: rotation 9
# (row-major), position 3, tan_half_fov. z_near has a structurally zero
# gradient (the eye direction is normalize(z_near * v)).
CAM_ROWS = 13
# Checkpoint planes per bounce; a textured scene adds the color block (6, 14
# with texel gradients), in full mode the UV-swim block (12) and, on a
# normal-mapped scene, the normal-map block (12, 20 with texel gradients)
# (csrc: tex_layout).
ST_PLANES = 16
ST_PLANES_FULL = 33
ST_PLANES_PHYS = 38   # + the direct phase's d, t and prev_pdf cotangents
TEX_PLANES, TEX_PLANES_GRADS = 6, 14
UVG_PLANES = 12
NMAP_PLANES, NMAP_PLANES_GRADS = 12, 20
# A checkpoint slot: the planes, then the sample and the end of the path it
# closes (csrc: QM_SAMPLE, QM_END), padded to four floats.
META_PLANES = 2
# Bytes the backward kernel's checkpoint stacks may take (see _stack_slots).
SCRATCH_BUDGET = 2 << 30
# Paths per round of linear mode's stacks (see _stack_slots).
LINEAR_PATHS_PER_ROUND = 4

# Fields render_megakernel_diff differentiates in grad_mode="linear" ...
PALLAS_TRAINABLE_FIELDS = frozenset({
    "materials.diffuse", "materials.specular", "materials.emission",
    "materials.absorption", "materials.diff_avg",
    "al_power", "pl_power", "background",
})
# ... and in grad_mode="full".
PALLAS_TRAINABLE_FIELDS_FULL = PALLAS_TRAINABLE_FIELDS | frozenset({
    "materials.roughness", "materials.ior", "materials.spec_exp", "pl_pos",
    "sph_center", "sph_radius",
})
# ... with physical=True (al_power drops out: the physical NEE reads the
# light's material emission; spec_avg comes in) ...
PALLAS_TRAINABLE_FIELDS_PHYS = (PALLAS_TRAINABLE_FIELDS_FULL
                                | frozenset({"materials.spec_avg"})) - \
    frozenset({"al_power"})
PALLAS_TRAINABLE_FIELDS_TEX = PALLAS_TRAINABLE_FIELDS | frozenset({"textures"})
PALLAS_TRAINABLE_FIELDS_TEX_FULL = PALLAS_TRAINABLE_FIELDS_FULL | frozenset(
    {"textures"})
# ... on a textured scene; and grad_mode="geo" adds the triangle geometry.
TRI_FIELDS = frozenset({"tri_v0", "tri_v1", "tri_v2",
                        "tri_n0", "tri_n1", "tri_n2"})
PALLAS_TRAINABLE_FIELDS_GEO = PALLAS_TRAINABLE_FIELDS_FULL | TRI_FIELDS
PALLAS_TRAINABLE_FIELDS_PHYS_GEO = PALLAS_TRAINABLE_FIELDS_PHYS | TRI_FIELDS

# Launches of the backward CUDA kernel made by this module's wrapper (and
# nowhere else) ...
LAUNCH_COUNT = 0
# ... and per instantiation: (mode, textured, grid) with mode one of "linear",
# "full", "geo", "physical", "physical-geo".
LAUNCHES_BY_MODE = collections.Counter()


def _grad_rows(counts, full: bool = False, texels: int = 0,
               physical: bool = False, tri: bool = False) -> int:
    """Total gradient rows of the backward kernel (csrc: ``grad_layout``);
    ``texels`` atlas texels with gradient rows (3 each, last). ``physical``
    and ``tri`` (geo) imply the full path adjoint."""
    num_spheres, num_tris, num_mats, num_pls, num_als = counts
    if physical or tri:
        full = True
    if not full:
        return num_mats * P_COLS + 3 * num_pls + 3 * num_als + 3 + 3 * texels
    pcols = P_COLS_PHYS if physical else P_COLS_FULL
    al_stride = AL_ROWS_GEO if tri else 3
    return (num_mats * pcols + 6 * num_pls + al_stride * num_als + 3
            + CAM_ROWS + 4 * num_spheres + (TRI_ROWS * num_tris if tri else 0)
            + 3 * texels)


def _st_planes(full: bool, textured: bool = False, tex_grads: bool = False,
               nmap: bool = False, physical: bool = False) -> int:
    """Checkpoint planes per bounce (csrc: ``tex_layout``): only the blocks
    the mode needs — the normal-map block only in full mode on a
    normal-mapped scene, its corner planes only with texel gradients.
    ``full`` is true for the geo and physical modes as well."""
    planes = (ST_PLANES_PHYS if physical
              else ST_PLANES_FULL if full else ST_PLANES)
    if textured:
        planes += TEX_PLANES_GRADS if tex_grads else TEX_PLANES
        if full:
            planes += UVG_PLANES
            if nmap:
                planes += NMAP_PLANES_GRADS if tex_grads else NMAP_PLANES
    return planes


def _slot_floats(planes: int) -> int:
    """Floats per checkpoint slot (csrc: ``tex_layout(...).slot_floats``)."""
    return (planes + META_PLANES + 3) // 4 * 4


def _stack_slots(spp: int, max_bounces: int, n: int, slot_floats: int,
                 full: bool) -> int:
    """Slots of each pixel's checkpoint stack: room for as many paths of
    ``max(max_bounces, 1)`` bounces as ``SCRATCH_BUDGET`` holds over ``n``
    pixels, at least one and at most ``spp`` (one round); linear mode
    (``full`` false) at most ``LINEAR_PATHS_PER_ROUND``."""
    span = max(max_bounces, 1)
    paths = min(spp, max(1, SCRATCH_BUDGET // (span * slot_floats * 4 * n)))
    if not full:
        paths = min(paths, LINEAR_PATHS_PER_ROUND)
    return span * paths


def _tex_grads(packed: PackedScene, full: bool) -> bool:
    """Whether the texel rows are computed: when the atlas requires grad.
    Refuses a silent zero gradient: texel gradients in linear mode on a
    normal-mapped scene (the normal map's texels need the full mode's
    perturbation pullback)."""
    atlas = packed.tex_atlas
    tex_grads = (atlas is not None and atlas.requires_grad
                 and torch.is_grad_enabled())
    if tex_grads and not full and packed.tex_nmap:
        raise ValueError(
            "grad_mode='linear' has no gradient for the texels of a normal "
            "map (they need the full path adjoint's perturbation pullback); "
            "use grad_mode='full', or leave 'textures' out of the fields")
    return tex_grads


def _check_grad_mode(grad_mode: str, physical: bool = False) -> bool:
    """Validate ``grad_mode``; returns True for the full path adjoint (which
    geo and physical build on)."""
    if grad_mode not in ("full", "linear", "geo"):
        raise ValueError(f"grad_mode must be 'full', 'linear' or 'geo', "
                         f"got {grad_mode!r}")
    return grad_mode != "linear" or physical


def _check_geo_grid(grad_mode: str, packed_grid) -> None:
    if grad_mode == "geo" and packed_grid is not None:
        raise ValueError("grad_mode='geo' takes no grid: the cell lists would "
                         "go stale as the vertices move; use packed_grid=None")


def _unpack_rows(rowsum: torch.Tensor, packed: PackedScene, full: bool,
                 tex_grads: bool = False, physical: bool = False,
                 geo: bool = False):
    """Gradient rows ``[rows]`` -> (PackedScene cotangent, camera cotangent
    (rot [3,3], pos [3], tan_half [], z_near [])), all on ``rowsum``'s
    device. Columns that the kernel does not differentiate (flags, refr_avg,
    spec_avg outside physical mode, triangles and area-light vertices outside
    geo mode, the texture meta, UV and map-id tables) are zero; so is the
    atlas without ``tex_grads``."""
    counts = packed.counts
    num_spheres, num_tris, num_mats, num_pls, num_als = counts
    full = full or physical or geo
    pcols = P_COLS_PHYS if physical else P_COLS_FULL if full else P_COLS
    pl_stride = 6 if full else 3
    al_stride = AL_ROWS_GEO if geo else 3
    texels = packed.tex_counts[1] if tex_grads else 0
    rows = _grad_rows(counts, full, texels, physical, geo)
    rowsum = rowsum.to(torch.float32)
    if rowsum.shape != (rows,):
        raise ValueError(f"expected {rows} gradient rows, "
                         f"got {tuple(rowsum.shape)}")

    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=rowsum.device)

    m = rowsum[:num_mats * pcols].reshape(num_mats, pcols)
    d_mats = zeros(packed.materials)
    d_mats[:, 0:12] = m[:, 0:12]     # diffuse, specular, absorption, emission
    d_mats[:, 14] = m[:, 12]         # diff_avg
    if full:
        d_mats[:, 17] = m[:, 13]     # roughness
        d_mats[:, 13] = m[:, 14]     # ior
        d_mats[:, 12] = m[:, 15]     # spec_exp
    if physical:
        d_mats[:, 15] = m[:, 16]     # spec_avg

    row_pl0 = num_mats * pcols
    row_al0 = row_pl0 + pl_stride * num_pls
    row_bg0 = row_al0 + al_stride * num_als
    d_pls = zeros(packed.point_lights)
    if num_pls:
        block = rowsum[row_pl0:row_al0].reshape(num_pls, pl_stride)
        if full:
            d_pls[:num_pls] = block                 # position, power
        else:
            d_pls[:num_pls, 3:6] = block            # power
    d_als = zeros(packed.area_lights)
    if num_als:
        block = rowsum[row_al0:row_bg0].reshape(num_als, al_stride)
        d_als[:num_als, 18:21] = block[:, 0:3]   # power
        if geo:
            d_als[:num_als, 0:18] = block[:, 3:]  # the six vertices
    d_bg = rowsum[row_bg0:row_bg0 + 3].clone()

    d_sph = zeros(packed.spheres)
    d_tri = zeros(packed.triangles)
    tex = {}
    if packed.textured:
        tex = dict(zip(("tex_atlas", "tex_meta", "tex_triuv", "tex_matids"),
                       (zeros(t) for t in packed.tex_tables())))
        if texels:
            tex["tex_atlas"] = rowsum[rows - 3 * texels:].reshape(texels, 3)
    d_cam = (torch.zeros((3, 3), device=rowsum.device),
             torch.zeros((3,), device=rowsum.device),
             torch.zeros((), device=rowsum.device),
             torch.zeros((), device=rowsum.device))
    if full:
        cam = rowsum[row_bg0 + 3:row_bg0 + 3 + CAM_ROWS]
        d_cam = (cam[0:9].reshape(3, 3).clone(), cam[9:12].clone(),
                 cam[12].clone(), d_cam[3])
        row_geo0 = row_bg0 + 3 + CAM_ROWS
        if num_spheres:
            d_sph[:num_spheres, 0:4] = rowsum[
                row_geo0:row_geo0 + 4 * num_spheres].reshape(num_spheres, 4)
        if geo and num_tris:
            # packed v0, e1, e2, n0, n1, n2
            row_tri0 = row_geo0 + 4 * num_spheres
            d_tri[:num_tris, 0:18] = rowsum[
                row_tri0:row_tri0 + TRI_ROWS * num_tris].reshape(num_tris, 18)
    d_packed = dataclasses.replace(
        packed, spheres=d_sph, triangles=d_tri,
        materials=d_mats, point_lights=d_pls, area_lights=d_als,
        background=d_bg, **tex)
    return d_packed, d_cam


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def _detach_undifferentiated(packed: PackedScene, geo: bool) -> PackedScene:
    """What the kernel gives no gradient: the texture meta, UV and map-id
    tables, and outside geo mode the triangles and the area lights' vertex
    columns."""
    tex = {}
    if packed.textured:
        tex = dict(tex_meta=packed.tex_meta.detach(),
                   tex_triuv=packed.tex_triuv.detach(),
                   tex_matids=packed.tex_matids.detach())
    if geo:
        return dataclasses.replace(packed, **tex)
    als = packed.area_lights
    als = torch.cat([als[:, :18].detach(), als[:, 18:]], -1)
    return dataclasses.replace(packed, triangles=packed.triangles.detach(),
                               area_lights=als, **tex)


def render_megakernel_diff_plain(packed: PackedScene, cam_params, seed: int,
                                 width: int, height: int, spp: int,
                                 max_bounces: int = 8, sample_offset: int = 0,
                                 grad_mode: str = "full",
                                 packed_grid=None,
                                 physical: bool = False,
                                 pixel_offset: int = 0,
                                 n_local=None) -> torch.Tensor:
    """The plain PyTorch version of the differentiable render: autograd
    through the plain forward render (``render_megakernel_plain``, physical
    too), with the packed tables and the camera as differentiable tensors.
    With ``n_local`` it renders the tile ``[pixel_offset, pixel_offset +
    n_local)`` of flat pixels alone: mean radiance ``[n_local, 3]``.
    It shares no adjoint formula with the kernel: it is the yardstick of the
    kernel's gradients, and what ``engine="plain"`` trains with.

    Outside ``grad_mode="geo"`` the kernel gives the triangle table and the
    area lights' vertex columns no gradient; this version DETACHES those
    columns, so the two agree table by table in full mode. In linear mode
    the kernel leaves the full-only columns and the camera at zero while
    autograd fills them: compare the linear fields only. Texel gradients are
    refused where the kernel refuses them, and so is geo through a grid.
    ``packed_grid`` sweeps through the grid (the same hits, so the same
    gradients)."""
    full = _check_grad_mode(grad_mode, physical)
    _check_geo_grid(grad_mode, packed_grid)
    _tex_grads(packed, full)
    packed = _detach_undifferentiated(packed, grad_mode == "geo")
    if n_local is None:
        return mk.render_megakernel_plain(
            packed, cam_params, seed, width, height, spp, max_bounces,
            sample_offset=sample_offset, packed_grid=packed_grid,
            physical=physical)
    return mk.render_block_sums_plain(
        packed, cam_params, seed, width, height, spp, max_bounces,
        pixel_offset, n_local, sample_offset, physical=physical,
        packed_grid=packed_grid) / spp


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _kernel_fn():
    """(library, launch function) of the built backward-kernel library."""
    from ...utils.build import load_kernels

    lib = load_kernels("megakernel_vjp")
    fn = lib.cpt_backward_megakernel
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, ci, vp, ci, vp, ci, vp, ci, vp,   # tables
                   vp, vp, vp, vp, ci, ci,                       # textures, texels
                   vp, vp, ctypes.POINTER(ctypes.c_int),         # grid
                   ctypes.POINTER(ctypes.c_float),               # camera
                   ci, ci, ci, ci, ci, ci, ci, ci,               # scalars
                   ci, ci, ci, ci, ci, ci,  # full, physical, geo, tex_grads,
                                            # tex_nmap, shared
                   ci,                                # capacity
                   vp, vp, vp, vp]                   # g, scratch, out, stream
    fn.restype = ci
    for const in (lib.cpt_backward_threads_per_block,
                  lib.cpt_backward_shared_rows_max):
        const.argtypes = []
        const.restype = ci
    lib.cpt_error_string.argtypes = [ci]
    lib.cpt_error_string.restype = ctypes.c_char_p
    return lib, fn


# Which accumulation route the last launch took: "shared" (per-block rows in
# shared memory) or "global" (global atomics, rows above the shared limit).
LAST_ROUTE = None
# The last launch's checkpoint stacks: (slots per pixel, scratch floats).
LAST_STACK = None


def _mode_name(full: bool, physical: bool, geo: bool) -> str:
    if physical:
        return "physical-geo" if geo else "physical"
    return "geo" if geo else ("full" if full else "linear")


def backward_rows_cuda(packed: PackedScene, cam_params, seed: int, width: int,
                       height: int, spp: int, max_bounces: int,
                       g_img: torch.Tensor, sample_offset: int = 0,
                       full: bool = False, pixel_offset: int = 0,
                       n_local=None, tex_grads: bool = False,
                       packed_grid=None, physical: bool = False,
                       geo: bool = False) -> torch.Tensor:
    """Launch the backward CUDA kernel: the gradient rows ``[rows]`` (float32,
    on the tables' device) of the MEAN radiance over ``spp`` of the pixel
    range ``[pixel_offset, pixel_offset + n_local)`` (default: the whole
    image) for the cotangent ``g_img`` (``n_local * 3`` values); with
    ``tex_grads`` (a textured scene) 3 texel rows per atlas texel come last;
    ``packed_grid`` replays through the grid. ``physical`` differentiates the
    physical estimator, ``geo`` adds the triangle and light-vertex rows (both
    imply ``full``; geo takes no grid). Launches on the current stream of the
    tables' device and does not synchronise; raises if the kernel does not
    build or the launch is refused."""
    global LAUNCH_COUNT, LAST_ROUTE, LAST_STACK
    with span("k2.launch"):
        n = width * height if n_local is None else n_local
        mk._check_render_args(packed, width, height, spp, max_bounces,
                              pixel_offset, n, sample_offset, seed)
        mk._check_tables(packed)
        mk._check_grid(packed, packed_grid)
        device = packed.device
        if g_img.device != device or g_img.numel() != 3 * n:
            raise ValueError(f"g_img: need {3 * n} values on {device}, got "
                             f"{g_img.numel()} on {g_img.device}")
        if geo and packed_grid is not None:
            raise ValueError("grad_mode='geo' has no grid instantiation")
        full = full or physical or geo
        lib, fn = _kernel_fn()
        # per-sample cotangent: the forward returned the MEAN over spp
        g = (g_img.detach().reshape(n, 3).to(torch.float32) / spp).contiguous()
        cam = mk._cam_table(cam_params, 0.0)
        cam_c = (ctypes.c_float * mk.CAM_FLOATS)(*cam.tolist())
        tex_grads = bool(tex_grads) and packed.textured
        if tex_grads and not full and packed.tex_nmap:
            raise ValueError("texel gradients of a normal-mapped scene need "
                             "full=True (the perturbation pullback)")
        texels = packed.tex_counts[1]
        rows = _grad_rows(packed.counts, full, texels if tex_grads else 0,
                          physical, geo)
        slot = _slot_floats(_st_planes(full, packed.textured, tex_grads,
                                       packed.tex_nmap, physical))
        capacity = _stack_slots(spp, max_bounces, n, slot, full)
        threads = lib.cpt_backward_threads_per_block()
        shared = rows <= lib.cpt_backward_shared_rows_max()
        num_s, num_t, num_m, num_pl, num_al = packed.counts
        tables = [t.detach() for t in packed.tables()]
        with torch.cuda.device(device):
            scratch = torch.empty(capacity * slot * n, dtype=torch.float32,
                                  device=device)
            if shared:
                out = torch.empty(((n + threads - 1) // threads, rows),
                                  dtype=torch.float32, device=device)
            else:
                out = torch.zeros((1, rows), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(tables[0].data_ptr(), num_s, tables[1].data_ptr(), num_t,
                     tables[2].data_ptr(), num_m, tables[3].data_ptr(), num_pl,
                     tables[4].data_ptr(), num_al, tables[5].data_ptr(),
                     *mk.tex_args(packed), texels, *mk.grid_args(packed_grid), cam_c,
                     int(seed), int(pixel_offset), int(n), int(sample_offset),
                     int(spp), int(max_bounces), int(width), int(height),
                     int(full), int(physical), int(geo), int(tex_grads),
                     int(packed.tex_nmap), int(shared), int(capacity),
                     g.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("backward megakernel launch failed: CUDA error "
                               f"{err} ({lib.cpt_error_string(err).decode()})")
        LAUNCH_COUNT += 1
        LAUNCHES_BY_MODE[(_mode_name(full, physical, geo), packed.textured,
                          packed_grid is not None)] += 1
        LAST_ROUTE = "shared" if shared else "global"
        LAST_STACK = (capacity, scratch.numel())
        return out.sum(0)


def backward_grads_cuda(packed: PackedScene, cam_params, seed: int,
                        width: int, height: int, spp: int, max_bounces: int,
                        g_img: torch.Tensor, sample_offset: int = 0,
                        full: bool = False, tex_grads: bool = False,
                        pixel_offset: int = 0, n_local=None, packed_grid=None,
                        physical: bool = False, geo: bool = False):
    """Run the backward kernel; returns (PackedScene cotangent, camera
    cotangent). The camera cotangent is zeros in linear mode."""
    rows = backward_rows_cuda(packed, cam_params, seed, width, height, spp,
                              max_bounces, g_img, sample_offset, full,
                              pixel_offset, n_local, tex_grads, packed_grid,
                              physical, geo)
    return _unpack_rows(rows, packed, full, tex_grads, physical, geo)


class _RenderDiff(torch.autograd.Function):
    """Forward: one launch of the forward megakernel on the flat pixels
    ``[pixel_offset, pixel_offset + n_local)``, whose mean radiance
    ``[n_local, 3]`` it returns. Backward: one launch of the replay-VJP
    kernel on the same pixels. Inputs: the six tables, the texel atlas (None
    without textures), the four camera tensors, then the non-differentiable
    arguments (``layout``: the packed scene whose texture tables and counts
    the tensors above belong to; ``packed_grid``: the grid both kernels sweep
    through, or None; ``physical`` / ``geo``: the estimator and the geometry
    rows). ``launch`` is the pair (forward sums, backward grads)
    of kernel wrappers: ``render_megakernel_diff`` passes the CUDA ones; the
    tests pass the host build of the same math."""

    @staticmethod
    def forward(ctx, spheres, triangles, materials, point_lights, area_lights,
                background, tex_atlas, rot, pos, tan_half, z_near, layout,
                seed, width, height, spp, max_bounces, sample_offset,
                pixel_offset, n_local, full, tex_grads, packed_grid, physical,
                geo, launch):
        packed = dataclasses.replace(
            layout, spheres=spheres, triangles=triangles, materials=materials,
            point_lights=point_lights, area_lights=area_lights,
            background=background, tex_atlas=tex_atlas)
        cam = (rot, pos, tan_half, z_near)
        sums = launch[0](packed, cam, seed, width, height, spp, max_bounces,
                         pixel_offset, n_local, sample_offset,
                         packed_grid=packed_grid, physical=physical)
        ctx.save_for_backward(*packed.tables(), *cam)
        ctx.packed = packed
        ctx.args = (seed, width, height, spp, max_bounces, sample_offset,
                    pixel_offset, n_local, full, tex_grads, packed_grid,
                    physical, geo, launch[1])
        return sums / spp

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        (seed, width, height, spp, max_bounces, sample_offset, pixel_offset,
         n_local, full, tex_grads, packed_grid, physical, geo,
         backward_grads) = ctx.args
        packed = dataclasses.replace(ctx.packed, **dict(zip(
            ("spheres", "triangles", "materials", "point_lights",
             "area_lights", "background"), saved[:6])))
        cam = saved[6:]
        d_packed, d_cam = backward_grads(
            packed, cam, seed, width, height, spp, max_bounces, g,
            sample_offset, full, tex_grads, pixel_offset=pixel_offset,
            n_local=n_local, packed_grid=packed_grid, physical=physical,
            geo=geo)
        # a camera tensor may live on another device than the tables
        d_cam = tuple(d.reshape(c.shape).to(c.device) if need else None
                      for d, c, need in zip(d_cam, cam,
                                            ctx.needs_input_grad[7:11]))
        d_atlas = d_packed.tex_atlas if ctx.needs_input_grad[6] else None
        # the grid is discrete structure: no gradient
        return (*d_packed.tables(), d_atlas, *d_cam) + (None,) * 15


def render_megakernel_diff(packed: PackedScene, cam_params, seed: int,
                           width: int, height: int, spp: int,
                           max_bounces: int = 8, sample_offset: int = 0,
                           grad_mode: str = "full", packed_grid=None,
                           physical: bool = False) -> torch.Tensor:
    """Differentiable megakernel render — mean radiance ``[H, W, 3]`` on the
    packed tables' device, whose backward pass is the replay-VJP kernel (see
    the module docstring for the fields each ``grad_mode`` differentiates).
    ``packed`` comes from ``pack_scene`` of a scene whose fields may require
    grad; ``cam_params`` holds numpy values or tensors (tensors that require
    grad receive gradients in full mode). ``grad_mode`` alone decides which
    backward kernel runs. ``max_bounces`` is a runtime argument. On a
    textured scene the texel gradients are computed when the atlas requires
    grad. ``packed_grid`` (``pack_grid`` on the tables' device) makes both
    kernels sweep through the supercell grid; it gets no gradient (geo mode
    takes none). ``physical=True`` renders with the physical estimator (K1
    physical) and differentiates it."""
    return _render_diff_tile(packed, cam_params, seed, width, height, spp,
                             max_bounces, sample_offset, grad_mode, packed_grid,
                             physical, 0, width * height).reshape(height, width, 3)


def _render_diff_tile(packed: PackedScene, cam_params, seed, width, height,
                      spp, max_bounces, sample_offset, grad_mode, packed_grid,
                      physical, first, n_local) -> torch.Tensor:
    """Differentiable mean radiance ``[n_local, 3]`` of the flat pixels
    ``[first, first + n_local)``: K1 forward and K2 backward on CUDA tables,
    the plain version on CPU tables."""
    full = _check_grad_mode(grad_mode, physical)
    _check_geo_grid(grad_mode, packed_grid)
    if packed.device.type != "cuda":
        return render_megakernel_diff_plain(packed, cam_params, seed, width,
                                            height, spp, max_bounces,
                                            sample_offset, grad_mode,
                                            packed_grid, physical, first,
                                            n_local)
    tex_grads = _tex_grads(packed, full)
    mk._check_grid(packed, packed_grid)
    cam = tuple(torch.as_tensor(v, dtype=torch.float32) for v in cam_params)
    return _RenderDiff.apply(*packed.tables(), packed.tex_atlas, *cam, packed,
                             int(seed), width, height, spp, max_bounces,
                             int(sample_offset), first, n_local, full,
                             tex_grads, packed_grid, bool(physical),
                             grad_mode == "geo",
                             (mk.render_block_sums_cuda, backward_grads_cuda))


def render_megakernel_diff_sharded(packed: PackedScene, cam_params, seed: int,
                                   width: int, height: int, spp: int, mesh,
                                   max_bounces: int = 8, sample_offset: int = 0,
                                   grad_mode: str = "full", packed_grid=None,
                                   physical: bool = False) -> torch.Tensor:
    """``render_megakernel_diff`` over ``mesh``'s pixel axis
    (``parallel.mesh``), in every grad mode it takes: each rank renders
    its tile of flat pixels (ceil(W*H / ranks) each, the last rank the
    remainder) with the forward kernel and, in the backward pass, runs the
    replay kernel on that tile with the tile's slice of the image cotangent
    (CPU tables: the plain version on the tile). The tiles merge with one
    psum over the pixel axis — the image is bit-equal to
    ``render_megakernel_diff``'s, on every rank — and the gradients of the
    tables, the atlas and the camera tensors are summed over the ranks once
    (``parallel.mesh.replicate``, applied here). The tables must be on the
    mesh's device type."""
    _check_grad_mode(grad_mode, physical)
    n = width * height
    n_dev = axis_size(mesh, PIXEL_AXIS, "render_megakernel_diff_sharded")
    check_device(mesh, packed.device, "render_megakernel_diff_sharded")
    _check_geo_grid(grad_mode, packed_grid)
    first, n_local = tile_range(n, n_dev, axis_index(mesh, PIXEL_AXIS))
    cam = [torch.as_tensor(v, dtype=torch.float32) for v in cam_params]
    names = ("spheres", "triangles", "materials", "point_lights",
             "area_lights", "background", "tex_atlas")
    tensors = [getattr(packed, k) for k in names] + cam
    grad = [i for i, t in enumerate(tensors)
            if t is not None and t.requires_grad]
    keep = replicate([tensors[i] for i in grad], mesh)
    for i, k in zip(grad, keep):
        tensors[i] = k
    packed = dataclasses.replace(packed, **dict(zip(names, tensors)))
    tile = _render_diff_tile(packed, tensors[len(names):], seed, width, height,
                             spp, max_bounces, sample_offset, grad_mode,
                             packed_grid, physical, first, n_local)
    return psum(in_full_image(tile, first, n), mesh, PIXEL_AXIS,
                keep).reshape(height, width, 3)
