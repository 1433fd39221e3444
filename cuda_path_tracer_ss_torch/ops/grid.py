"""Uniform-grid spatial acceleration: the host-side build.

The reference sweeps every primitive per ray and leaves acceleration as its
own TODO (``CudaTracer/CudaTracer.cu:437``). ``build_grid`` bins the scene's
primitives into one uniform grid over the scene's bounding box: padded dense
per-cell lists of sphere and triangle ids, conservative (a primitive lands in
every cell its box overlaps; a sphere only in the cells its ball touches).
``ops/cuda/megakernel.py::pack_grid`` turns it into the kernels' supercell
lists. Both are bit-equal to the JAX package's ``ops/grid.py::build_grid`` and
``ops/pallas/megakernel.py::pack_grid`` (``tests/test_torch_grid.py``).

The build is discrete and runs once per scene on the host (numpy), outside
autograd: a field that moves geometry across cells needs a rebuild.

The eager engine walks the grid cell by cell: ``nearest_hit_grid`` /
``any_hit_grid`` are the JAX package's Amanatides-Woo DDA (``_dda_setup``,
``_march``), each step testing the current cell's padded lists against all
rays at once. The march runs without a graph; where a gradient is wanted
``nearest_hit_grid`` evaluates the winner's ``t`` again with one, as the
linear sweep does (``ops/intersect.py``). The march stops once every walk is
done, tested every ``MARCH_CHECK_EVERY`` steps. The reference's
``differentiable=`` switch has no counterpart: JAX walks the fixed step bound
under ``differentiable=True`` only because a ``while_loop`` cannot be
reverse-differentiated, and here the gradient never passes through the march.

Hit semantics through the grid equal the linear sweep's, including its tie
rule (a later primitive index wins an exactly equal ``t``), because the sweeps
apply that rule explicitly: ``(t < best) | ((t == best) & (idx >= best_idx))``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .intersect import Hit, SWEEP_BYTES, _needs_graph, _winner_t, sphere_t, triangle_t
from .vec import Vec3

# Build-time density: target ~LAMBDA cells per primitive along the scene
# volume (classic teapot-in-a-stadium heuristic).
LAMBDA = 3.0
MAX_RES = 16          # per-axis cap
PAD = 1e-3            # AABB slack so boundary primitives land inside


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """Uniform grid with padded dense cell lists (CPU tensors). Cells are
    numbered ``(iz * ry + iy) * rx + ix``."""

    origin: torch.Tensor      # [3] float32 grid min corner
    inv_cell: torch.Tensor    # [3] float32 1 / cell_size
    cell_size: torch.Tensor   # [3] float32
    res: Tuple[int, int, int]
    sph_list: torch.Tensor    # [C, Ks] int32 sphere ids, -1 padded
    tri_list: torch.Tensor    # [C, Kt] int32 triangle ids, -1 padded
    sph_count: torch.Tensor   # [C] int32
    tri_count: torch.Tensor   # [C] int32

    @property
    def num_cells(self) -> int:
        return self.res[0] * self.res[1] * self.res[2]

    def to(self, device) -> "UniformGrid":
        """The same grid with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "res"})


def _as_np(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy()


def build_grid(scene, max_res: int = MAX_RES) -> UniformGrid:
    """Bin the scene's primitive boxes into a grid of about LAMBDA cells per
    primitive (at most ``max_res`` per axis). Same float operations, in the
    same types, as the reference's build."""
    S, T = scene.num_spheres, scene.num_triangles
    boxes = []
    if S:
        c = _as_np(scene.sph_center).astype(np.float32)
        r = _as_np(scene.sph_radius).astype(np.float32)[:, None]
        boxes.append((c - r, c + r))
    if T:
        tv = np.stack([_as_np(v).astype(np.float32)
                       for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)], 0)
        boxes.append((tv.min(0), tv.max(0)))
    if not boxes:
        raise ValueError("empty scene has nothing to grid")

    lo = np.min([b[0].min(0) for b in boxes], 0) - PAD
    hi = np.max([b[1].max(0) for b in boxes], 0) + PAD
    extent = np.maximum(hi - lo, 1e-6)
    k = (LAMBDA * (S + T) / float(extent.prod())) ** (1.0 / 3.0)
    res = np.clip(np.floor(extent * k).astype(int), 1, max_res)
    rx, ry, rz = int(res[0]), int(res[1]), int(res[2])
    cell = extent / res                      # float64, as the reference's

    def bin_boxes(bmin, bmax, centers=None, radii=None):
        """Box binning; for spheres the exact box-ball overlap test drops the
        cells of the box that the ball does not touch."""
        i0 = np.clip(((bmin - lo) / cell).astype(int), 0, res - 1)
        i1 = np.clip(((bmax - lo) / cell).astype(int), 0, res - 1)
        per_cell = [[] for _ in range(rx * ry * rz)]
        for p in range(bmin.shape[0]):
            iz, iy, ix = np.meshgrid(np.arange(i0[p, 2], i1[p, 2] + 1),
                                     np.arange(i0[p, 1], i1[p, 1] + 1),
                                     np.arange(i0[p, 0], i1[p, 0] + 1),
                                     indexing="ij")
            iz, iy, ix = iz.ravel(), iy.ravel(), ix.ravel()
            if centers is not None:
                cmin = lo + cell * np.stack([ix, iy, iz], -1)
                q = np.clip(centers[p], cmin, cmin + cell) - centers[p]
                far = (q[:, 0] ** 2 + q[:, 1] ** 2) + q[:, 2] ** 2 > radii[p] ** 2
                iz, iy, ix = iz[~far], iy[~far], ix[~far]
            for flat in ((iz * ry + iy) * rx + ix).tolist():
                per_cell[flat].append(p)
        return per_cell

    def pad_lists(per_cell):
        kmax = max(1, max(len(l) for l in per_cell))
        out = np.full((len(per_cell), kmax), -1, np.int32)
        cnt = np.zeros(len(per_cell), np.int32)
        for ci, l in enumerate(per_cell):
            out[ci, :len(l)] = l
            cnt[ci] = len(l)
        return out, cnt

    empty = [[] for _ in range(rx * ry * rz)]
    sph_cells = bin_boxes(*boxes[0], centers=c, radii=r[:, 0]) if S else empty
    tri_cells = bin_boxes(*boxes[-1]) if T else empty
    sph_list, sph_count = pad_lists(sph_cells)
    tri_list, tri_count = pad_lists(tri_cells)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return UniformGrid(origin=f32(lo), inv_cell=f32(1.0 / cell),
                       cell_size=f32(cell), res=(rx, ry, rz),
                       sph_list=torch.from_numpy(sph_list),
                       tri_list=torch.from_numpy(tri_list),
                       sph_count=torch.from_numpy(sph_count),
                       tri_count=torch.from_numpy(tri_count))


def max_steps(grid: UniformGrid) -> int:
    """Longest cell walk through the grid (its Manhattan diagonal): the step
    bound of a 3-D DDA over it."""
    return grid.res[0] + grid.res[1] + grid.res[2] + 1


# Steps of the early-stopping march between two tests of "every walk done"
# (each test waits for the device).
MARCH_CHECK_EVERY = 4


def _tie_min(best_t, best_i, t, valid, idx):
    """Reference tie rule, order-independent: strictly closer wins; on an
    exact tie the LARGER primitive index wins (later-in-sweep semantics)."""
    t = torch.where(valid, t, torch.inf)
    closer = valid & ((t < best_t) | ((t == best_t) & (idx >= best_i)))
    return torch.where(closer, t, best_t), torch.where(closer, idx, best_i)


def _fold_tie(best_t, best_i, t, valid, idx):
    """``_tie_min`` of every column of ``[N, K]`` candidates in turn: the
    rule is a total order on (t ascending, index descending), so the
    columns' own winner folded once is the same."""
    tm = torch.where(valid, t, torch.inf)
    cmin = tm.min(dim=1).values
    cand = torch.where(valid & (tm == cmin[:, None]), idx, -1).max(dim=1).values
    return _tie_min(best_t, best_i, cmin, cand >= 0, cand)


def _safe_inv(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-20,
                             torch.where(d < 0, -1e-20, 1e-20), d)


def _dda_setup(grid: UniformGrid, ro: Vec3, rd: Vec3):
    """Entry state of the Amanatides-Woo walk for every ray."""
    t0 = torch.zeros_like(ro.x)
    t1 = torch.full_like(ro.x, torch.inf)
    axes_o = (ro.x, ro.y, ro.z)
    axes_d = (rd.x, rd.y, rd.z)
    for a in range(3):
        inv = _safe_inv(axes_d[a])
        ta = (grid.origin[a] - axes_o[a]) * inv
        tb = (grid.origin[a] + grid.cell_size[a] * float(grid.res[a])
              - axes_o[a]) * inv
        t0 = torch.maximum(t0, torch.minimum(ta, tb))
        t1 = torch.minimum(t1, torch.maximum(ta, tb))
    inside = t0 <= t1
    t_enter = torch.clamp_min(t0, 0.0)

    cells, tmaxs, tdeltas, steps = [], [], [], []
    for a in range(3):
        d, o = axes_d[a], axes_o[a]
        p = o + d * (t_enter + 1e-5)
        ci = torch.clamp(torch.floor((p - grid.origin[a]) * grid.inv_cell[a]),
                         0, grid.res[a] - 1).to(torch.int64)
        step = torch.where(d > 0, 1, torch.where(d < 0, -1, 0))
        inv = _safe_inv(d)
        next_bound = grid.origin[a] + (ci + torch.clamp_min(step, 0)
                                       ).to(torch.float32) * grid.cell_size[a]
        tmax = torch.where(step == 0, torch.inf, (next_bound - o) * inv)
        tdelta = torch.where(step == 0, torch.inf,
                             grid.cell_size[a] * torch.abs(inv))
        cells.append(ci)
        tmaxs.append(tmax)
        tdeltas.append(tdelta)
        steps.append(step)
    return inside, t_enter, t1, cells, tmaxs, tdeltas, steps


def _march(grid: UniformGrid, ro: Vec3, rd: Vec3, test_cell, carry0,
           stop_t_of):
    """Shared DDA loop: ``test_cell(carry, flat_cell, alive)`` per step;
    ``stop_t_of(carry)`` is the distance past which a walk may stop."""
    rx, ry, rz = grid.res
    inside, t_enter, t_exit, cells, tmaxs, tdeltas, steps = _dda_setup(
        grid, ro, rd)
    carry = carry0
    ix, iy, iz = cells
    tmx, tmy, tmz = tmaxs
    alive = inside & (t_enter <= stop_t_of(carry0))
    cap = max_steps(grid)
    for s in range(cap):
        if s % MARCH_CHECK_EVERY == 0 and not bool(alive.any()):
            break
        flat = (iz * ry + iy) * rx + ix
        carry = test_cell(carry, flat, alive)
        # advance to the next cell along the smallest tMax
        pick_x = (tmx <= tmy) & (tmx <= tmz)
        pick_y = (~pick_x) & (tmy <= tmz)
        pick_z = (~pick_x) & (~pick_y)
        t_next = torch.where(pick_x, tmx, torch.where(pick_y, tmy, tmz))
        ix = torch.where(pick_x, ix + steps[0], ix)
        iy = torch.where(pick_y, iy + steps[1], iy)
        iz = torch.where(pick_z, iz + steps[2], iz)
        tmx = torch.where(pick_x, tmx + tdeltas[0], tmx)
        tmy = torch.where(pick_y, tmy + tdeltas[1], tmy)
        tmz = torch.where(pick_z, tmz + tdeltas[2], tmz)
        oob = ((ix < 0) | (ix >= rx) | (iy < 0) | (iy >= ry)
               | (iz < 0) | (iz >= rz))
        # stop out of the grid, past the exit point, or where the next cell
        # begins strictly beyond anything that could still matter (<= keeps
        # exact-tie candidates reachable)
        alive = alive & (~oob) & (t_next <= t_exit + 1e-6) & (
            t_next <= stop_t_of(carry) + 1e-6)
    return carry


def _cell_candidates(ro: Vec3, rd: Vec3, scene, grid: UniformGrid, flat, ok):
    """(kind, t [N, C], valid [N, C], primitive index [N, C]) per chunk of
    the cell lists of ``flat``: the spheres, then the triangles (offset by
    the sphere count); ``ok`` [N] gates the rays."""
    S, T = scene.num_spheres, scene.num_triangles
    roc = ro.map(lambda a: a[:, None])
    rdc = rd.map(lambda a: a[:, None])
    flat = torch.clamp(flat, 0, grid.num_cells - 1)
    step = max(1, SWEEP_BYTES // (4 * max(ro.x.shape[0], 1)))
    if S:
        ids = grid.sph_list.long()[flat]
        for c0 in range(0, ids.shape[1], step):
            sid = ids[:, c0:c0 + step]
            si = torch.clamp(sid, 0, S - 1)
            c = scene.sph_center[si]
            t, valid = sphere_t(roc, rdc, c[..., 0], c[..., 1], c[..., 2],
                                scene.sph_radius[si])
            yield t, valid & ok[:, None] & (sid >= 0), si
    if T:
        ids = grid.tri_list.long()[flat]
        for c0 in range(0, ids.shape[1], step):
            tid = ids[:, c0:c0 + step]
            ti = torch.clamp(tid, 0, T - 1)
            v0, v1, v2 = (Vec3.from_array(scene.tri_v0[ti]),
                          Vec3.from_array(scene.tri_v1[ti]),
                          Vec3.from_array(scene.tri_v2[ti]))
            t, _, _, valid = triangle_t(roc, rdc, v0, v1, v2)
            yield t, valid & ok[:, None] & (tid >= 0), ti + S


def nearest_hit_grid(ro: Vec3, rd: Vec3, scene, grid: UniformGrid) -> Hit:
    """Grid-walked nearest hit: the same hits as ``intersect.nearest_hit``,
    tie rule included."""
    def test_cell(carry, flat, alive):
        best_t, best_i = carry
        for t, valid, idx in _cell_candidates(ro, rd, scene, grid, flat, alive):
            best_t, best_i = _fold_tie(best_t, best_i, t, valid, idx)
        return best_t, best_i

    with torch.no_grad():
        carry0 = (torch.full_like(ro.x, torch.inf),
                  torch.full(ro.x.shape, -1, dtype=torch.int64,
                             device=ro.x.device))
        best_t, best_i = _march(grid, ro, rd, test_cell, carry0,
                                stop_t_of=lambda c: c[0])
        hit = torch.isfinite(best_t)
    if _needs_graph(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, scene.sph_center,
                    scene.sph_radius, scene.tri_v0, scene.tri_v1,
                    scene.tri_v2):
        best_t = _winner_t(ro, rd, scene, best_i, hit)
    return Hit(t=best_t, prim=best_i, hit=hit)


def any_hit_grid(ro: Vec3, rd: Vec3, max_dist, scene,
                 grid: UniformGrid) -> torch.Tensor:
    """Grid-walked occlusion; the same answers as ``intersect.any_hit`` (a
    hit exactly at ``max_dist`` occludes)."""
    with torch.no_grad():
        md = (max_dist.detach() if isinstance(max_dist, torch.Tensor)
              else torch.full_like(ro.x, max_dist))

        def test_cell(occ, flat, alive):
            for t, valid, _ in _cell_candidates(ro, rd, scene, grid, flat,
                                                alive & ~occ):
                occ = occ | (valid & (t <= md[:, None])).any(dim=1)
            return occ

        occ0 = torch.zeros(ro.x.shape, dtype=torch.bool, device=ro.x.device)
        # an occluded ray stops marching (stop_t -> -big); the others walk
        # to the light distance
        return _march(grid, ro, rd, test_cell, occ0,
                      stop_t_of=lambda occ: torch.where(occ, -1e30, md))
