"""The port's counter RNG (cuda_path_tracer_ss_torch/utils/rng.py) against the
JAX package's: integers, so every comparison is exact."""
import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_tpu.utils import rng as jrng
from cuda_path_tracer_ss_torch.utils import rng as trng


def _words(seed, n=4096):
    g = np.random.default_rng(seed)
    w = [g.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
         for _ in range(4)]
    # edge words in the first lanes: extremes, -1, 0
    for k in range(4):
        w[k][:4] = np.array([-2 ** 31, 2 ** 31 - 1, -1, 0], np.int32)[(np.arange(4) + k) % 4]
    return w


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_bit_equal(rounds):
    w = _words(rounds)
    got = trng.threefry2x32(*[torch.from_numpy(v) for v in w], rounds=rounds)
    want = jrng.threefry2x32(*w, rounds=rounds)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_threefry_rounds20_is_jax_threefry():
    """At 20 rounds the port reproduces jax's own generator, not just the JAX
    package's copy of it."""
    from jax._src import prng as jprng
    import jax.numpy as jnp

    w = _words(3, 256)
    key = jnp.stack([jnp.asarray(w[0][0]), jnp.asarray(w[1][0])]).astype(jnp.uint32)
    want = jprng.threefry_2x32(key, jnp.concatenate(
        [jnp.asarray(w[2]), jnp.asarray(w[3])]).astype(jnp.uint32))
    got = trng.threefry2x32(int(w[0][0]), int(w[1][0]), torch.from_numpy(w[2]),
                            torch.from_numpy(w[3]), rounds=20)
    want = np.asarray(want).astype(np.uint32)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want[:256])
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), want[256:])


def test_uniform_pair_equal_and_broadcasts():
    w = _words(5)
    got = trng.uniform_pair(-7, torch.from_numpy(w[1]), torch.from_numpy(w[2]), 3)
    want = jrng.uniform_pair(np.int32(-7), w[1], w[2], np.int32(3))
    for g, x in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        assert float(g.min()) >= 0.0 and float(g.max()) < 1.0
    ej = trng.eye_jitter(11, torch.from_numpy(w[1]), 5)
    ej_want = jrng.eye_jitter(np.int32(11), w[1], np.int32(5))
    np.testing.assert_array_equal(ej[0].numpy(), np.asarray(ej_want[0]))


def test_pair_layout_equal():
    for la in range(4):
        assert trng.pairs_per_bounce(la) == jrng.pairs_per_bounce(la)
        for b in range(6):
            assert trng.pair_base(b, la) == jrng.pair_base(b, la)
    b = torch.arange(5)
    np.testing.assert_array_equal(trng.pair_base(b, 2).numpy(),
                                  np.asarray(jrng.pair_base(np.arange(5), 2)))
    assert trng.PAIR_EYE == jrng.PAIR_EYE and trng.ROUNDS == jrng.ROUNDS


@pytest.mark.parametrize("base,stream", [(0, 0), (123456789, 7), (-3, 2),
                                         (2 ** 31 - 1, 99), (-2 ** 31, 1)])
def test_seed_for_equal(base, stream):
    assert trng.seed_for(base, stream) == int(jrng.seed_for(base, stream))


def test_float_operands_rejected():
    with pytest.raises(TypeError):
        trng.threefry2x32(torch.tensor([1.0]), 0, 0, 0)
