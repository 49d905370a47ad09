"""The arithmetic of K1's fp32 kernel above head dim 64, against the JAX
package, on the CPU.

Above head dim 64 the port's fp32 flash attention runs on the tensor cores
in TF32 (``wgmma``) with each fp32 operand split as big + small, both TF32,
and each product taken as small x big + big x small + big x big
(``client_tpu_torch/csrc/flash_attention.cu``, ``flash_fwd_tf32_kernel``).
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here a model of its numerics, written in this file
only, runs on the CPU: TF32 rounding done with bit operations (to nearest
on the low 13 bits, ties away from zero), the products of TF32 values
summed in fp32, S's big x big chain and its two correction products in
separate accumulators joined by one add, and each key tile's P.V started
from zero and joined to O in one add, at the kernel's key tiles (32 keys at
the 128 instantiation, 16 at 256). It is held against the Pallas kernel in
interpret mode (as ``tests/test_ops.py`` runs it) and against attention in
float64; dropping a term, or plain TF32, misses the float64 bound, so the
bound can fail. The pre-pass's plain version (``split_kv_plain``), which
the kernel's pre-pass equals bit for bit on the card, is held here too.

Tolerances: 2e-5 against the Pallas kernel (both fp32; the split loses
about 2^-22 of each product, and sums run in another order); 2e-3 against
float64 with inputs x8 (scores up to a few hundred, outputs up to ~30: the
fp32 plain version itself misses by ~1e-3 there).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.ops.flash_attention import flash_attention as jax_flash
from client_tpu_torch.ops import flash_attention as fa

TILE_KEYS = {128: 32, 256: 16}  # keys a stage: tf32::Config128 / Config256
F64_ATOL = 2e-3
PALLAS_ATOL = 2e-5
S_TERMS = ("small_big", "big_small")  # S's correction products
PV_TERMS = ("small_big", "big_small")  # P.V's


def _qkv(b, s, h, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, h, d)) * scale).astype(np.float32)
            for _ in range(3)]


def _bias(b, s):
    bias = np.zeros((b, s), np.float32)
    bias[0, s - 37:] = -1e9  # BERT's padding mask
    bias[1, 5::9] = -np.inf
    return bias


def _split(x):
    return fa.tf32_split(x) if x is not None else (None, None)


def _model(q, k, v, bias, causal, s_terms=S_TERMS, pv_terms=PV_TERMS):
    """The kernel's numerics in torch fp32 on the CPU, for numpy [B, S, H,
    D] q/k/v: zero-padded to the instantiation's head dim, scaled by
    1/sqrt(D) of the real D; s_terms / pv_terms name the correction
    products kept (both kept: the kernel; none: plain TF32)."""
    b, s, h, d = q.shape
    width = fa.kernel_head_dim(d)
    block = TILE_KEYS[width]
    q, k, v = (fa.pad_head_dim(torch.from_numpy(x), width).transpose(1, 2)
               for x in (q, k, v))
    (qb, qs), (kb, ks), (vb, vs) = _split(q), _split(k), _split(v)
    scale = 1.0 / math.sqrt(d)
    neg = -1e30
    bias = (torch.zeros(b, s) if bias is None
            else torch.from_numpy(bias))[:, None, None, :]
    m = torch.full((b, h, s, 1), neg)
    denom = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, width)
    rows = torch.arange(s)[:, None]
    for key0 in range(0, s, block):
        keys = slice(key0, min(key0 + block, s))
        s_main = qb @ kb[:, :, keys].transpose(-1, -2)
        s_corr = torch.zeros_like(s_main)
        if "small_big" in s_terms:
            s_corr = s_corr + qs @ kb[:, :, keys].transpose(-1, -2)
        if "big_small" in s_terms:
            s_corr = s_corr + qb @ ks[:, :, keys].transpose(-1, -2)
        sc = (s_main + s_corr) * scale + bias[..., keys]
        if causal:
            sc = sc.masked_fill(torch.arange(s)[keys] > rows, neg)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        safe = torch.where(m_new <= neg, torch.zeros_like(m_new), m_new)
        corr = torch.where(m <= neg, torch.zeros_like(m), torch.exp(m - safe))
        p = torch.exp(sc - safe)
        denom = denom * corr + p.sum(-1, keepdim=True)
        pb, ps = _split(p)
        pv = pb @ vb[:, :, keys]  # from zero, each tile
        if "small_big" in pv_terms:
            pv = pv + ps @ vb[:, :, keys]
        if "big_small" in pv_terms:
            pv = pv + pb @ vs[:, :, keys]
        o = o * corr + pv
        m = m_new
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return (o / denom).transpose(1, 2)[..., :d].numpy()


def _float64(q, k, v, causal):
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool).tril()
        scores = scores.masked_fill(~keep, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1),
                        v).numpy()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [80, 128, 256])
def test_model_matches_pallas(d, causal):
    """The model at S 256, H 2 against the Pallas kernel in interpret mode,
    with BERT's padding mask and -inf keys in the bias."""
    q, k, v = _qkv(2, 256, 2, d, seed=d)
    bias = _bias(2, 256)
    want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias),
                     causal=causal, block_q=128, block_k=128, interpret=True)
    got = _model(q, k, v, bias, causal)
    np.testing.assert_allclose(got, np.asarray(want), atol=PALLAS_ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [80, 128, 256])
def test_model_keeps_fp32_accuracy(d, causal):
    """Inputs x8 make the scores ~64x larger, so each product's rounding
    shows in the softmax: the model stays within 2e-3 of float64."""
    q, k, v = _qkv(2, 256, 2, d, seed=d + 1, scale=8.0)
    err = np.abs(_model(q, k, v, None, causal)
                 - _float64(q, k, v, causal)).max()
    assert err <= F64_ATOL, err


@pytest.mark.parametrize("variant", ["no_small_big", "plain_tf32"])
@pytest.mark.parametrize("d", [128, 256])
def test_a_dropped_term_misses_the_float64_bound(d, variant):
    """The same inputs without S's small x big product, or in plain TF32
    (big x big alone, in S and in P.V), miss the bound by far: the bound
    tells the split from what it replaces."""
    q, k, v = _qkv(2, 256, 2, d, seed=d + 1, scale=8.0)
    if variant == "no_small_big":
        kw = dict(s_terms=("big_small",))
    else:
        kw = dict(s_terms=(), pv_terms=())
    err = np.abs(_model(q, k, v, None, True, **kw)
                 - _float64(q, k, v, True)).max()
    assert err > 10 * F64_ATOL, err


def test_tf32_round_is_rna_on_13_bits():
    """tf32_round against the rule in float64: the nearest value with 10
    mantissa bits, ties away from zero (both signs); big + small rebuilds
    x to 2^-22 relative, both halves with their low 13 bits zero."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-20, 20, 4096)).astype(np.float32)
    # Exact ties (bit 12 set, bits 0-11 clear) of both signs, and one below.
    ties = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.0 + 2.0 ** -10,
                     1.0 + 2.0 ** -11 - 2.0 ** -23], np.float32)
    x = np.concatenate([x, ties])
    got = fa.tf32_round(torch.from_numpy(x)).numpy().astype(np.float64)
    xd = x.astype(np.float64)
    exp = np.floor(np.log2(np.abs(xd)))
    ulp = 2.0 ** (exp - 10)
    want = np.sign(xd) * np.floor(np.abs(xd) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(got, want)
    assert got[-4] == 1.0 + 2.0 ** -10 and got[-3] == -(1.0 + 2.0 ** -10)
    assert got[-1] == 1.0
    big, small = fa.tf32_split(torch.from_numpy(x))
    for half in (big, small):
        assert bool(((half.view(torch.int32) & 0x1FFF) == 0).all())
    rebuilt = big.double() + small.double()
    rel = ((rebuilt - torch.from_numpy(xd)).abs()
           / torch.from_numpy(np.abs(xd))).max()
    assert float(rel) <= 2.0 ** -22


def test_permuted_keys_match_the_accumulator_order():
    """Positions t and t + 4 of each 8-key group hold keys 2t and 2t + 1:
    a thread holds P(row, 2t) and P(row, 2t + 1) of each 8-key slice of S,
    and the P.V product reads them as its A columns t and t + 4."""
    perm = fa.permuted_keys(64)
    assert sorted(perm.tolist()) == list(range(64))
    for group in range(8):
        for t in range(4):
            assert perm[8 * group + t] == 8 * group + 2 * t
            assert perm[8 * group + t + 4] == 8 * group + 2 * t + 1


@pytest.mark.parametrize("d", [68, 80, 128, 160, 256])
def test_split_kv_plain_halves_and_layout(d):
    """The pre-pass's plain version: kh holds K's halves [2, B, H, S_pad,
    W], vt V's transposed with permuted keys [2, B, H, W, S_pad]; big +
    small rebuilds each value to 2^-22, and the columns past D and the keys
    past S are zeros. The CPU wrapper is the plain version."""
    k, v = (torch.from_numpy(x) for x in _qkv(2, 75, 3, d, seed=d)[:2])
    width = fa.kernel_head_dim(d)
    kh, vt = fa.split_kv(k, v, width)
    s_pad = 96
    assert kh.shape == (2, 2, 3, s_pad, width)
    assert vt.shape == (2, 2, 3, width, s_pad)
    for got, want in ((kh[0] + kh[1], k.transpose(1, 2)),
                      ((vt[0] + vt[1])[..., torch.argsort(
                          fa.permuted_keys(s_pad))].transpose(-1, -2),
                       v.transpose(1, 2))):
        assert float((got[:, :, :75, :d].double() - want.double()).abs().max()
                     / want.abs().max()) <= 2.0 ** -22
        assert not got[:, :, 75:].any() and not got[..., d:].any()
    assert torch.equal(vt[:, 0, 1, 3, :8],
                       torch.stack(fa.tf32_split(v[0, [0, 2, 4, 6, 1, 3, 5,
                                                       7], 1, 3])))
