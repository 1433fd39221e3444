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

Hit semantics through the grid equal the linear sweep's, including its tie
rule (a later primitive index wins an exactly equal ``t``), because the sweeps
apply that rule explicitly: ``(t < best) | ((t == best) & (idx >= best_idx))``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

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
