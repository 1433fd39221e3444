"""The yardstick of the kernels' roofline shares: the least time the card
needs for the work of a launch's paths.

The operation counts are frozen from the port's smoke script
(``chip_smoke.py``: ``flop_count`` and its constants, K2's reverse-sweep
terms), counted from the kernels' CUDA sources with every float32 add,
multiply, compare, select, sqrt and divide as one operation (integer RNG
work not counted). They are fed the tally of the benchmark's own reference
(``reference.pathtracer.radiance(tally=...)``) on a seeded share of the
launch's paths, scaled to all of them. They count a linear primitive sweep:
a kernel that learns to skip primitive tests (a BVH, culling) makes them
count too much, and a benchmark change has to correct them.

Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
outside the tensor cores, an FMA counted as two operations, and HBM3.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

K1_SYMBOL = "render_kernel"
K2_SYMBOL = "backward_kernel"

SPHERE_TEST_FLOPS = 32
TRIANGLE_TEST_FLOPS = 60
PER_PATH_FLOPS = 40        # eye ray
PER_BOUNCE_FLOPS = 150     # hit point, cosine, radiance update, scatter
PER_LIGHT_SAMPLE_FLOPS = 60
PHYSICAL_BOUNCE_FLOPS = 75
PHYSICAL_LIGHT_SAMPLE_FLOPS = 165
# K2's reverse sweep per stored bounce, per visible light sample and per path
# (full path adjoint; the physical estimator adds its own terms)
REVERSE_BOUNCE_FLOPS = {"linear": 45, "full": 45 + 150 + 130}
NEE_PARTIAL_FLOPS = {"linear": 40, "full": 75}
EYE_VJP_FLOPS = {"linear": 0, "full": 70}
PHYS_REVERSE_BOUNCE_FLOPS = 110 + 150
PHYS_LIGHT_VJP_FLOPS = 100

TALLY_KEYS = ("paths", "path_bounces", "stored_bounces", "shadow_rays",
              "shadow_rays_occluded")


def k1_flops(counts, tally: Dict[str, float], physical: bool) -> float:
    """Least float32 work of K1 on the paths ``tally`` describes: a full
    sweep per path-bounce and per unoccluded shadow ray, one primitive test
    per occluded one, and the estimator's per-path, per-bounce and
    per-light-sample math."""
    num_s, num_t = counts[0], counts[1]
    sweep = num_s * SPHERE_TEST_FLOPS + num_t * TRIANGLE_TEST_FLOPS
    one_test = min(SPHERE_TEST_FLOPS if num_s else TRIANGLE_TEST_FLOPS,
                   TRIANGLE_TEST_FLOPS if num_t else SPHERE_TEST_FLOPS)
    per_bounce = PER_BOUNCE_FLOPS + (PHYSICAL_BOUNCE_FLOPS if physical else 0)
    per_light = (PHYSICAL_LIGHT_SAMPLE_FLOPS if physical
                 else PER_LIGHT_SAMPLE_FLOPS)
    occluded = tally["shadow_rays_occluded"]
    clear = tally["shadow_rays"] - occluded
    sweeps = (tally["path_bounces"] + clear) * sweep + occluded * one_test
    return (tally["paths"] * PER_PATH_FLOPS
            + tally["path_bounces"] * per_bounce
            + tally["shadow_rays"] * per_light + sweeps)


def k2_flops(counts, tally: Dict[str, float], physical: bool,
             mode: str = "full") -> float:
    """Least float32 work of K2: the replay (one K1 render of the same
    paths) plus the reverse sweep."""
    visible = tally["shadow_rays"] - tally["shadow_rays_occluded"]
    flops = (k1_flops(counts, tally, physical)
             + tally["stored_bounces"] * REVERSE_BOUNCE_FLOPS[mode]
             + visible * NEE_PARTIAL_FLOPS[mode]
             + tally["paths"] * EYE_VJP_FLOPS[mode])
    if physical:
        flops += (tally["stored_bounces"] * PHYS_REVERSE_BOUNCE_FLOPS
                  + tally["shadow_rays"] * PHYS_LIGHT_VJP_FLOPS)
    return flops


def least_seconds(flops: float, moved_bytes: float) -> Tuple[float, str]:
    """(least seconds, 'operations' or 'bytes': which bound it)."""
    ops_s = flops / PEAK_FP32_FLOPS
    bytes_s = moved_bytes / PEAK_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def share_pct(flops: float, moved_bytes: float, kernel_s: float):
    """The kernel's share of its roofline in %, or None without kernel time."""
    if not kernel_s > 0.0:
        return None
    return 100.0 * least_seconds(flops, moved_bytes)[0] / kernel_s
