"""The comparisons that decide ``correct``, and the reference's tally of a
slice's work, shared by the job drivers. Every number here is computed from
the program's outputs and the reference's own results: the reference reads
the program's outputs only to judge them."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import roofline
from .reference import display, pathtracer

# paths per wavefront of the reference
CHUNK_PATHS = 1 << 20
# a radiance below this is compared by its absolute gap
RADIANCE_FLOOR = 1e-3
# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone and is left out of the training numbers
NEGLIGIBLE_LEAF = 1e-3


def pixel_means(tables, cam, seed: int, width: int, height: int,
                pixels: np.ndarray, n_samples: int, max_bounces: int,
                physical: bool, device, state_bf16: bool = False) -> np.ndarray:
    """The reference's mean radiance ``[P, 3]`` (float32, summed in float64)
    of samples ``[0, n_samples)`` of the given flat pixels."""
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=device)
    c = pathtracer.cam_tensor(cam, device)
    acc = torch.zeros((pix.numel(), 3), dtype=torch.float64, device=device)
    per = max(1, CHUNK_PATHS // max(pix.numel(), 1))
    slot = torch.arange(pix.numel(), device=device)
    with torch.no_grad():
        for s0 in range(0, n_samples, per):
            k = min(per, n_samples - s0)
            smp = torch.arange(s0, s0 + k, device=device).repeat_interleave(
                pix.numel())
            r = pathtracer.radiance(tables, c, seed, width, height,
                                    pix.repeat(k), smp, max_bounces, physical,
                                    state_bf16)
            acc.index_add_(0, slot.repeat(k), r.double())
    return (acc / n_samples).float().cpu().numpy()


def radiance_gap_p50(prog: Sequence[np.ndarray], ref: Sequence[np.ndarray]) -> float:
    """Median, over every channel of every compared pixel, of the program's
    gap to the reference's mean radiance, relative to the reference's
    (absolute under RADIANCE_FLOOR)."""
    p = np.concatenate([np.asarray(a, np.float64).ravel() for a in prog])
    r = np.concatenate([np.asarray(a, np.float64).ravel() for a in ref])
    return float(np.median(np.abs(p - r) / np.maximum(np.abs(r), RADIANCE_FLOOR)))


def display_off_share(prog_u8: Sequence[np.ndarray],
                      ref_means: Sequence[np.ndarray]) -> float:
    """Share of compared pixels whose displayed value, in some channel, is
    more than one 8-bit level from the reference's display of its mean."""
    off = []
    for u8, mean in zip(prog_u8, ref_means):
        want = display.to_u8(torch.from_numpy(np.asarray(mean))).numpy()
        gap = np.abs(np.asarray(u8, np.int32) - want.astype(np.int32))
        off.append(gap.max(axis=-1) > 1)
    return float(np.concatenate(off).mean())


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _worst_leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                    keep: List[str]) -> float:
    """Largest gap between the program's and the reference's norm of a leaf,
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    pn, rn = _norms(prog), _norms(ref)
    med = float(np.median([rn[k] for k in keep]))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep)


def training_numbers(prog_steps: List[dict], ref_steps: List[dict],
                     start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the worst leaf's gap of the first gradient's norm;
    ``change_gap``: the worst leaf's gap of the norm of the parameters'
    change over the steps. Leaves whose reference gradient is negligible
    (NEGLIGIBLE_LEAF) are left out of the last two. Returns the numbers
    and the leaves compared."""
    loss_gap = max(abs(p["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30)
                   for p, r in zip(prog_steps, ref_steps))
    g_ref = ref_steps[0]["grad"]
    rn = _norms(g_ref)
    med = float(np.median(list(rn.values())))
    keep = [k for k in g_ref if rn[k] >= NEGLIGIBLE_LEAF * med]
    grad_gap = _worst_leaf_gap(prog_steps[0]["grad"], g_ref, keep)
    last = len(ref_steps) - 1
    d_prog = {k: prog_steps[last]["params"][k].double() - start[k].double() for k in keep}
    d_ref = {k: ref_steps[last]["params"][k].double() - start[k].double() for k in keep}
    change_gap = _worst_leaf_gap(d_prog, d_ref, keep)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap,
                change_gap=change_gap), keep


def tally(tables, cam, seed: int, width: int, height: int, n_paths: int,
          samples: int, max_bounces: int, physical: bool, device,
          gen: np.random.Generator, sample_offset: int = 0) -> Dict[str, float]:
    """The reference's work tally on ``n_paths`` paths drawn with ``gen``
    from a render of ``width * height`` pixels and samples
    ``[sample_offset, sample_offset + samples)``, scaled to all of them."""
    pix = torch.as_tensor(gen.integers(0, width * height, n_paths), device=device)
    smp = torch.as_tensor(sample_offset + gen.integers(0, samples, n_paths),
                          device=device)
    counts: Dict[str, int] = {}
    with torch.no_grad():
        pathtracer.radiance(tables, pathtracer.cam_tensor(cam, device), seed,
                            width, height, pix, smp, max_bounces, physical,
                            tally=counts)
    scale = width * height * samples / n_paths
    return {k: counts.get(k, 0) * scale for k in roofline.TALLY_KEYS}


def table_bytes(tables) -> int:
    return 4 * sum(int(t.numel()) for t in (
        tables.spheres, tables.triangles, tables.materials,
        tables.point_lights, tables.area_lights, tables.background))


def add_tallies(parts: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: sum(p[k] for p in parts) for k in roofline.TALLY_KEYS}
