"""Accumulation and tonemapping.

Behavioral spec: ``writeToPixelsKernel`` / ``clearPixels``
(``CudaTracer/CudaTracer.cu:31-49, 63-104``). The reference clamps each
sample's radiance to [0,1], gamma-corrects (1/2.2), quantizes to 8-bit and
accumulates the *quantized integers*, displaying their running mean.

The primary path here is float32 radiance accumulation with gamma at display
time. The reference's integer pipeline is kept behind
``compat_accumulate``/``compat_display`` for quirk-level parity. Plain tensor
functions; they run on whatever device their arguments are on. The integer
running total is an int32 tensor (PyTorch has no uint32 arithmetic).
"""
from __future__ import annotations

import torch

from ..constants import GAMMA_CORRECTION


def tonemap(mean_radiance: torch.Tensor, gamma: float = GAMMA_CORRECTION):
    """Float radiance image -> [0,1] display image (clamp + gamma)."""
    return torch.clamp(mean_radiance, 0.0, 1.0) ** gamma


def to_uint8(display: torch.Tensor):
    """[0,1] float -> uint8 with the reference's +0.5 rounding
    (CudaTracer.cu:83-85)."""
    return torch.clamp(255.0 * display + 0.5, 0.0, 255.0).to(torch.uint8)


def compat_accumulate(total_int: torch.Tensor, sample_radiance: torch.Tensor,
                      gamma: float = GAMMA_CORRECTION):
    """One reference-style accumulation step: quantize the sample post-gamma
    and add it into the integer running total (CudaTracer.cu:83-100)."""
    q = to_uint8(tonemap(sample_radiance, gamma)).to(total_int.dtype)
    return total_int + q


def compat_display(total_int: torch.Tensor, num_samples: int):
    """Integer-mean display: total * (1/ticks) + 0.5 -> uint8
    (CudaTracer.cu:94-98)."""
    inv = 1.0 / num_samples
    return torch.clamp(total_int.to(torch.float32) * inv + 0.5, 0.0,
                       255.0).to(torch.uint8)
