"""Per-stream token sampling with the JAX package's PRNG contract, in torch.

The port's own copy of ``_sample_token`` (``client_tpu/models/generate.py``)
and of the parts of ``jax.random`` it uses, batched over lanes:

- ``PRNGKey(seed)`` is the threefry key ``(0, seed mod 2**32)`` of an
  int32 seed; ``fold_in(key, n)`` is ``threefry2x32(key, (0, n))``;
- random bits for ``V`` draws are ``threefry2x32(key, (0, i))`` XOR-ed
  halves for ``i < V`` (``jax_threefry_partitionable=True``, JAX's
  default); ``uniform`` puts 23 of them in the mantissa of a float in
  ``[1, 2)``; ``gumbel`` is ``-log(-log(u))`` with ``u`` in
  ``[tiny, 1)``; ``categorical`` is the argmax of logits plus gumbel noise.

uint32 arithmetic runs in int64 tensors masked to 32 bits, so the bits,
keys and uniform floats equal JAX's bit for bit, on any device.

The determinism contract is ``fold_in(PRNGKey(seed), ctx_len)``: a pure
function of the request's seed and the context length at sampling time,
never of the batch, so a stream sampled in a shared wave equals the same
stream sampled alone.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``: int64 tensors holding uint32 values, which
    broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey`` of int32 seeds: the key ``(0, seed mod
    2**32)`` per lane, as an int64 pair."""
    lo = seeds.long() & _MASK
    return torch.zeros_like(lo), lo


def fold_in(key: tuple[torch.Tensor, torch.Tensor],
            data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in`` per lane: hash ``(0, data mod 2**32)``."""
    d = data.long() & _MASK
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key: tuple[torch.Tensor, torch.Tensor],
                n: int) -> torch.Tensor:
    """``n`` uint32 draws per lane (``[B, n]`` int64) from keys ``[B]``."""
    counts = torch.arange(n, device=key[0].device, dtype=torch.int64)
    b1, b2 = threefry2x32(key[0][:, None], key[1][:, None],
                          torch.zeros_like(counts), counts)
    return b1 ^ b2


def uniform(key: tuple[torch.Tensor, torch.Tensor], n: int,
            minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over [minval, 1), ``[B, n]``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled with
    JAX's float32 operation order."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # The bounds as float32 values held in Python floats: a tensor made
    # from them on the card would be a blocking host-to-device copy.
    lo = float(np.float32(minval))
    span = float(np.float32(1.0) - np.float32(minval))
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (its default, low-range mode), ``[B, n]``."""
    return -torch.log(-torch.log(uniform(key, n, minval=_TINY)))


def categorical(key: tuple[torch.Tensor, torch.Tensor],
                logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``[B, V]``
    logits: the Gumbel-max draw."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def sample_tokens(logits: torch.Tensor, seeds: torch.Tensor,
                  ctx_len: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """``_sample_token`` for a batch of lanes: ``[B, V]`` fp32 logits and
    ``[B]`` per-lane parameters -> ``[B]`` int32 tokens.

    ``temp <= 0`` is greedy argmax (first index on ties). Otherwise the
    logits are divided by the temperature, sorted descending (stable, as
    ``jnp.argsort(-x)`` is), cut to the ``top_k`` best (``0`` keeps all)
    and to the nucleus whose mass before each token is below ``top_p``
    (the first token is always kept), and drawn from with the key
    ``fold_in(PRNGKey(seed), ctx_len)``."""
    greedy = torch.argmax(logits, dim=-1)
    key = fold_in(prng_key(seeds), ctx_len)
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    order = torch.sort(-scaled, dim=-1, stable=True).indices
    sl = torch.gather(scaled, -1, order)
    probs = torch.softmax(sl, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    idx = torch.arange(sl.shape[-1], device=sl.device)
    keep = ((cum - probs) < top_ps[:, None]) & torch.where(
        top_ks[:, None] > 0, idx[None, :] < top_ks[:, None], True)
    keep[:, 0] = True
    choice = categorical(key, torch.where(keep, sl, -torch.inf))
    sampled = torch.gather(order, -1, choice[:, None])[:, 0]
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)
