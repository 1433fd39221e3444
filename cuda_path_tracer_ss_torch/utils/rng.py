"""Counter-based PRNG shared bit-exactly by the plain PyTorch renderer and
the CUDA megakernel (``csrc/megakernel.cuh::uniform_pair``).

Threefry-2x32, 13 rounds (the BigCrush-passing minimum per Salmon et al.
SC'11; ``rounds=20`` is the canonical count). Every uniform is a pure
function of four 32-bit counters::

    key     = (seed, flat_pixel_index)
    counter = (sample_index, pair_index)

so draws are stateless, replayable, engine-invariant (the plain version and
the kernel consume identical streams — per-pixel image parity) and
tile-invariant (a pixel's stream depends only on its flat index and global
sample index).

The words are 32-bit with wrap-around adds and a LOGICAL right shift in the
rotation. PyTorch's ``>>`` on int32 is arithmetic and it has little uint32
arithmetic, so the tensor code carries each word in an int64 as its unsigned
value in ``[0, 2**32)`` and masks after every add and shift; results are
returned as int32 (two's complement of the same bits).

Pair-index layout (one threefry call yields two uniforms)::

    pair 0                      eye-ray jitter (x, y)
    per bounce b, base = 1 + b * (2 + 2 * num_area_lights):
      base + 0                  (branch select, dir sample a)
      base + 1                  (dir sample b, unused)
      base + 2+2i / base + 3+2i area light i: (u1, u2) / (u3, pick)
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_GOLD = 0x1BD11BDA  # Threefry key-schedule parity constant
_M24 = 0x00FFFFFF
_INV24 = 1.0 / 16777216.0

PAIR_EYE = 0

# Rounds for the renderer's draws; the kernel hard-codes the same count.
ROUNDS = 13

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)  # rotation schedule, period 8


def pairs_per_bounce(num_area_lights: int) -> int:
    return 2 + 2 * num_area_lights


def pair_base(bounce_idx, num_area_lights: int):
    """First pair index of bounce ``bounce_idx`` (int or integer tensor)."""
    return 1 + bounce_idx * pairs_per_bounce(num_area_lights)


def _word(v, device=None) -> torch.Tensor:
    """Any int / integer tensor -> int64 tensor holding the unsigned 32-bit
    value of its low word."""
    t = torch.as_tensor(v, device=device)
    if t.is_floating_point():
        raise TypeError("threefry operands must be integers")
    return t.to(torch.int64) & _MASK32


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit value in an int64 -> the int32 with the same bits."""
    return torch.where(x >= 0x80000000, x - 0x100000000, x).to(torch.int32)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(k0, k1, x0, x1, rounds: int = ROUNDS):
    """Threefry-2x32, Random123 round structure: initial key injection, then
    key+counter injection after every 4th mix round. All four operands
    broadcast elementwise; returns two int32 blocks."""
    device = next((v.device for v in (k0, k1, x0, x1)
                   if isinstance(v, torch.Tensor)), None)
    k0, k1, x0, x1 = (_word(v, device) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _GOLD)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(rounds):
        x0 = (x0 + x1) & _MASK32
        x1 = _rotl(x1, _ROT[i % 8])
        x1 = x1 ^ x0
        if (i + 1) % 4 == 0:
            blk = (i + 1) // 4
            x0 = (x0 + ks[blk % 3]) & _MASK32
            x1 = (x1 + ks[(blk + 1) % 3] + blk) & _MASK32
    return _to_int32(x0), _to_int32(x1)


def _u24(bits: torch.Tensor) -> torch.Tensor:
    # 24 mantissa-bit uniform in [0, 1): MASK (not shift) the low 24 bits.
    return (bits & _M24).to(torch.float32) * _INV24


def uniform_pair(seed, pixel, sample, pair):
    """Two U[0,1) streams for (seed, pixel, sample, pair); elementwise over
    any broadcastable operand shapes."""
    o0, o1 = threefry2x32(seed, pixel, sample, pair)
    return _u24(o0), _u24(o1)


def eye_jitter(seed, pixel_idx, sample_idx):
    """Sub-pixel AA jitter (x, y) for each pixel."""
    return uniform_pair(seed, pixel_idx, sample_idx, PAIR_EYE)


def bounce_rows(seed, pixel_idx, sample_idx, bounce_idx, num_area_lights: int):
    """The ``[3 + 4 * num_area_lights, N]`` uniform block one bounce
    consumes, rows in the eager engine's layout: (branch, dir_a, dir_b) then
    4 rows per area light (u1, u2, u3, pick)."""
    base = pair_base(bounce_idx, num_area_lights)
    b0, b1 = uniform_pair(seed, pixel_idx, sample_idx, base)
    b2, _ = uniform_pair(seed, pixel_idx, sample_idx, base + 1)
    rows = [b0, b1, b2]
    for i in range(num_area_lights):
        u1, u2 = uniform_pair(seed, pixel_idx, sample_idx, base + 2 + 2 * i)
        u3, up = uniform_pair(seed, pixel_idx, sample_idx, base + 3 + 2 * i)
        rows += [u1, u2, u3, up]
    return torch.stack(rows)


def seed_for(base_seed: int, stream: int) -> int:
    """Derive an unrelated int32 seed (distinct threefry key word) for an
    auxiliary stream; int32 wrap-around arithmetic."""
    v = (int(base_seed) * 1000003 + int(stream)) & _MASK32
    return v - 0x100000000 if v >= 0x80000000 else v


# ---- the JAX PRNG key stream ---------------------------------------------------
#
# The JAX package draws the silhouette module's curve-stratum jitter from
# ``jax.random`` (default Threefry implementation, partitionable layout), not
# from the counter streams above. These four functions reproduce
# ``PRNGKey`` / ``fold_in`` / ``split`` / ``uniform`` bit for bit so that the
# two packages sample the same curve points. A key is a pair of int32 tensors
# (its two 32-bit words).

JAX_ROUNDS = 20  # jax.random's Threefry-2x32 round count


def jax_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed)."""
    return (torch.zeros((), dtype=torch.int32, device=device),
            _to_int32(_word(seed, device)))


def jax_fold_in(key, data):
    """``jax.random.fold_in(key, data)``; ``data`` is taken as uint32."""
    return threefry2x32(key[0], key[1], 0, _word(data, key[0].device),
                        rounds=JAX_ROUNDS)


def jax_split(key, n: int = 2):
    """``jax.random.split(key, n)`` as a tuple of ``n`` keys."""
    i = torch.arange(n, dtype=torch.int64, device=key[0].device)
    o0, o1 = threefry2x32(key[0], key[1], 0, i, rounds=JAX_ROUNDS)
    return tuple((o0[j], o1[j]) for j in range(n))


def jax_uniform(key, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), each element
    from the Threefry block of its flat index (hi, lo words), the two output
    words XORed, the top 23 bits as the mantissa of a float in [1, 2)."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=key[0].device)
    b0, b1 = threefry2x32(key[0], key[1], i >> 32, i & _MASK32,
                          rounds=JAX_ROUNDS)
    bits = (b0 ^ b1).to(torch.int64) & _MASK32
    one_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (one_two - 1.0).reshape(tuple(shape))
