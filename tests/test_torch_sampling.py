"""The port's sampling against ``jax.random`` and the JAX ``_sample_token``.

Keys, threefry bits and uniform floats must be bit-exact for 200 seeds
(negative int32 seeds included); sampled tokens must equal JAX's for the
same logits over grids of temperature, top-k and top-p. Gumbel noise goes
through ``log`` twice, whose last bit the two libraries may round apart,
so it is held to 1e-6 relative; the tokens drawn with it are held exact.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models.generate import _sample_token
from client_tpu_torch.models import sampling

N_SEEDS = 200
rng = np.random.default_rng(0)
SEEDS = np.concatenate([
    [0, 1, -1, 42, 2**31 - 1, -2**31],
    rng.integers(-2**31, 2**31, N_SEEDS - 6)]).astype(np.int32)
CTX = rng.integers(0, 4096, N_SEEDS).astype(np.int32)


def _jax_keys():
    return jax.vmap(lambda s, c: jax.random.fold_in(
        jax.random.PRNGKey(s), c))(jnp.asarray(SEEDS), jnp.asarray(CTX))


def _port_keys():
    return sampling.fold_in(sampling.prng_key(torch.from_numpy(SEEDS)),
                            torch.from_numpy(CTX))


def test_prng_key_matches():
    want = np.stack([np.asarray(jax.random.PRNGKey(int(s)))
                     for s in SEEDS[:8]])
    k1, k2 = sampling.prng_key(torch.from_numpy(SEEDS[:8]))
    np.testing.assert_array_equal(torch.stack([k1, k2], 1).numpy(),
                                  want.astype(np.int64))


def test_fold_in_matches():
    k1, k2 = _port_keys()
    np.testing.assert_array_equal(torch.stack([k1, k2], 1).numpy(),
                                  np.asarray(_jax_keys()).astype(np.int64))


@pytest.mark.parametrize("n", [1, 37, 512])
def test_random_bits_match(n):
    want = jax.vmap(lambda k: jax.random.bits(k, (n,)))(_jax_keys())
    got = sampling.random_bits(_port_keys(), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
        np.int64))


@pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny)])
def test_uniform_matches(minval):
    want = jax.vmap(lambda k: jax.random.uniform(
        k, (128,), minval=minval))(_jax_keys())
    got = sampling.uniform(_port_keys(), 128, minval=minval)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_matches():
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (128,)))(_jax_keys()))
    got = sampling.gumbel(_port_keys(), 128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


TEMPS = [0.0, 0.5, 1.0, 1.7]
TOP_KS = [0, 1, 5, 24]
TOP_PS = [0.3, 0.9, 1.0]


@pytest.mark.parametrize("vocab", [128, 512])
def test_sampled_tokens_match_jax_over_the_grid(vocab):
    grid = list(itertools.product(TEMPS, TOP_KS, TOP_PS))
    n = len(grid) * 3  # three seeds per setting
    temps = np.array([g[0] for g in grid] * 3, np.float32)
    top_ks = np.array([g[1] for g in grid] * 3, np.int32)
    top_ps = np.array([g[2] for g in grid] * 3, np.float32)
    r = np.random.default_rng(vocab)
    logits = (r.standard_normal((n, vocab)) * 2).astype(np.float32)
    seeds, ctx = SEEDS[:n], CTX[:n]
    want = jax.vmap(_sample_token)(*(jnp.asarray(x) for x in (
        logits, seeds, ctx, temps, top_ks, top_ps)))
    got = sampling.sample_tokens(*(torch.from_numpy(x) for x in (
        logits, seeds, ctx, temps, top_ks, top_ps)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_takes_the_first_of_tied_maxima():
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, 5.0, 5.0, 5.0]])
    zeros = torch.zeros(2, dtype=torch.int32)
    got = sampling.sample_tokens(logits, zeros, zeros, torch.zeros(2),
                                 zeros, torch.ones(2))
    assert got.tolist() == [1, 0]


def test_top_k_one_is_greedy_at_any_temperature():
    r = np.random.default_rng(3)
    logits = torch.from_numpy(r.standard_normal((16, 64)).astype(np.float32))
    seeds = torch.arange(16, dtype=torch.int32)
    got = sampling.sample_tokens(logits, seeds, seeds, torch.full((16,), 2.0),
                                 torch.ones(16, dtype=torch.int32),
                                 torch.ones(16))
    assert got.tolist() == torch.argmax(logits, -1).tolist()
