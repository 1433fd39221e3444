"""Inputs the benchmark makes from ``--seed`` and hands to both sides: the
scene arrays of a configuration, and seeded streams of numbers."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

INT_FIELDS = ("sph_mat", "tri_mat", "tex_hw", "al_tri0", "materials.flags",
              "materials.tex_id", "materials.nmap_id")


def scene_arrays(config: dict) -> Dict[str, np.ndarray]:
    """The configuration's scene as numpy arrays (float32; indices and
    flags int32). The file writes an infinity as the string ``"inf"``."""
    out = {}
    for k, v in config["scene"].items():
        a = np.array(v, dtype=object)
        a = np.vectorize(float, otypes=[np.float64])(a) if a.size else \
            np.zeros(a.shape)
        out[k] = a.astype(np.int32 if k in INT_FIELDS else np.float32)
    for k, shape in config.get("empty", {}).items():
        out[k] = np.zeros(shape, np.int32 if k in INT_FIELDS else np.float32)
    return out


def scene_tensors(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def stream(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one purpose of one run: the seed (any whole number,
    also above 32 bits) and the purpose's keys."""
    seed = int(seed)
    return np.random.default_rng(np.random.SeedSequence(
        [abs(seed), int(seed < 0)] + [int(k) for k in keys]))


def int32_seeds(seed: int, key: int, n: int):
    """``n`` render seeds in [0, 2**31) for the stream ``key``."""
    return [int(x) for x in stream(seed, key).integers(0, 2 ** 31 - 1, n)]
