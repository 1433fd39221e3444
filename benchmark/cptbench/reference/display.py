"""The reference's display pipeline (the reference's
``writeToPixelsKernel``, ``CudaTracer.cu:63-104``, in its float form): mean
radiance clamped to [0, 1], gamma 1/2.2, 8-bit with +0.5 rounding."""
from __future__ import annotations

import torch

GAMMA = 1.0 / 2.2


def to_u8(mean_radiance: torch.Tensor) -> torch.Tensor:
    """Float32 mean radiance -> uint8 display values, elementwise."""
    disp = torch.clamp(mean_radiance.to(torch.float32), 0.0, 1.0) ** GAMMA
    return torch.clamp(255.0 * disp + 0.5, 0.0, 255.0).to(torch.uint8)
