"""Deterministic reproduction of the reference's scene randomness.

The reference places its "random" spheres with the C runtime's unseeded
``rand()`` (``CudaTracer/Scene.cpp:3`` ``#define rnd(x) (x * rand() / RAND_MAX)``,
used at ``Scene.cpp:155-166, 213-224``). Because the stream is unseeded it is
the MSVC LCG starting from seed 1, so the "random" scenes are a fixed, exactly
reproducible geometry. This module replays that stream bit-for-bit so the
presets land their spheres where the reference renders them.
"""
from __future__ import annotations

import numpy as np

_MSVC_RAND_MAX = 32767


class MsvcRand:
    """MSVC CRT ``rand()``: state = state*214013 + 2531011 (mod 2^32)."""

    def __init__(self, seed: int = 1):
        self.state = np.uint32(seed)

    def rand(self) -> int:
        self.state = np.uint32(
            (np.uint64(self.state) * np.uint64(214013) + np.uint64(2531011))
            & np.uint64(0xFFFFFFFF)
        )
        return int((int(self.state) >> 16) & 0x7FFF)

    def rnd(self, x: float) -> np.float32:
        """``x * rand() / RAND_MAX`` in float32, as the C macro evaluates."""
        return np.float32(np.float32(x) * np.float32(self.rand()) / np.float32(_MSVC_RAND_MAX))

    def rnd_int(self, x: int) -> int:
        """The macro with an int argument (``rnd(1)``) — integer division."""
        return (x * self.rand()) // _MSVC_RAND_MAX
