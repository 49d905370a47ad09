"""The port's kernels across the head dims and shard counts the reference
kernels take, against the JAX package, on the CPU.

The Pallas kernels read the head dim from the shape (``flash_attention``,
``decode_wave_attention``) and the ring all-reduce takes any axis size; the
port's kernels take head dims 1 to 256 (K1 instantiated at 32, 64, 128 and
256, K2 at 8 to 256, any other head dim run by the next larger one) and 2
to 64 shards. Here the same numpy inputs, made from a seed, go through the
JAX function (Pallas in interpret mode, as ``tests/test_ops.py`` runs it)
and the port's CPU wrapper, which is the kernel's plain version; the
kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s ``headdims`` phase).

Tolerances: flash attention 1e-5 in fp32 (as ``tests/test_ops.py`` holds
JAX's kernel; the same math in another summation order) and 2e-2 in bf16
(both round P to bf16 before P.V, under maxima taken per block in the
Pallas kernel); the decode wave 2e-5 on the output and the arena (the
scatter is exact); greedy streams token for token.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models.generate import TinyGptBackend as JaxGpt
from client_tpu.ops.decode_kernel import decode_wave_attention as jax_decode
from client_tpu.ops.flash_attention import flash_attention as jax_flash
from client_tpu_torch.models import generate as gen
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.parallel import kv_shard as ks


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _tail_bias(b, s):
    bias = np.zeros((b, s), np.float32)
    bias[0, s - 9:] = -1e9  # BERT's padding mask
    bias[1, 3::7] = -np.inf
    return bias


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 80, 96, 128, 256])
def test_flash_attention_matches_pallas_at_head_dim(d, dtype, causal):
    """K1's function at head dims on both sides of its instantiations."""
    q, k, v = _qkv(2, 64, 2, d, seed=d)
    bias = _tail_bias(2, 64)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_flash(*[jnp.asarray(x).astype(jdt) for x in (q, k, v)],
                     jnp.asarray(bias), causal=causal, block_q=32,
                     block_k=32, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    args = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    before = (fa.launches, fa.launches_fp32)
    got = fa.flash_attention(*args, torch.from_numpy(bias), causal=causal)
    assert (fa.launches, fa.launches_fp32) == before  # CPU: no kernel
    assert got.shape == (2, 64, 2, d) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5 if dtype == "fp32" else 2e-2,
                               rtol=0)


@pytest.mark.parametrize("d", [1, 12, 33, 80, 100, 128, 200, 256])
def test_padding_rule_equals_the_unpadded_plain_version(d):
    """What the kernel does for a head dim between its instantiations, in
    plain PyTorch: zero-padded to the next instantiation, scaled by the
    real 1/sqrt(D), the first D columns kept. It equals the unpadded plain
    version, and the padded columns never reach the output: they come
    out exactly zero (zeros of v) and are dropped."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 40, 3, d, seed=d + 1))
    bias = torch.from_numpy(_tail_bias(2, 40))
    width = fa.kernel_head_dim(d)
    assert width == min(w for w in fa.KERNEL_HEAD_DIMS if w >= d)
    for causal in (False, True):
        want = fa.flash_attention_plain(q, k, v, bias, causal)
        got = fa.flash_attention_padded_plain(q, k, v, bias, causal)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)
        padded = fa.flash_attention_plain(
            *(fa.pad_head_dim(t, width) for t in (q, k, v)), bias, causal,
            sm_scale=1.0 / math.sqrt(d))
        assert torch.equal(padded[..., d:], torch.zeros_like(padded[..., d:]))


@pytest.mark.parametrize("d", [0, 257, 272])
def test_head_dims_outside_the_range_are_refused(d):
    for kernel_head_dim in (fa.kernel_head_dim, da.kernel_head_dim):
        with pytest.raises(ValueError, match="head dims 1 to 256"):
            kernel_head_dim(d)


@pytest.mark.parametrize("d", [12, 80, 128, 256])
def test_decode_wave_matches_pallas_at_head_dim(d):
    """K2's function at head dims the kernel runs at its own instantiation
    (128, 256) or at the next larger one with the real head dim (12, 80):
    output and arena within 2e-5 of the Pallas kernel's."""
    L, R, S, H = 2, 5, 64, 2
    rows, lens = [0, 2, 1, R - 1], [7, 62, 33, 0]
    rng = np.random.default_rng(d)
    k_a, v_a = (rng.standard_normal((L, R, S, H, d)).astype(np.float32)
                for _ in range(2))
    q, kn, vn = (rng.standard_normal((4, H, d)).astype(np.float32)
                 for _ in range(3))
    jargs = [jnp.asarray(x) for x in (k_a, v_a, q, kn, vn)] + [
        jnp.asarray(rows, jnp.int32), jnp.asarray(lens, jnp.int32)]
    jk, jv, jo = jax_decode(*jargs, layer=1, block_s=16, interpret=True)
    k_t, v_t = torch.from_numpy(k_a.copy()), torch.from_numpy(v_a.copy())
    o = da.decode_wave_attention(k_t, v_t, torch.from_numpy(q),
                                 torch.from_numpy(kn), torch.from_numpy(vn),
                                 da.WaveIndex(rows, lens, R, S), layer=1)
    real = np.asarray(rows) != R - 1
    np.testing.assert_allclose(o.numpy()[real], np.asarray(jo)[real],
                               atol=2e-5, rtol=0)
    for got, want in ((k_t, jk), (v_t, jv)):
        np.testing.assert_allclose(got.numpy()[:, :R - 1],
                                   np.asarray(want)[:, :R - 1], atol=2e-5,
                                   rtol=0)


# (d_model, n_heads): head dim 16 (``tests/test_generative.py``'s flash
# prefill widths), 80 and 128.
GPT_WIDTHS = {16: (64, 4), 80: (160, 2), 128: (256, 2)}


def _gpt_kw(head_dim):
    d_model, n_heads = GPT_WIDTHS[head_dim]
    return dict(n_layers=2, d_model=d_model, n_heads=n_heads,
                d_ff=2 * d_model, vocab=128, max_seq_len=64, max_streams=4)


def _jax_stream(jb, prompt, n):
    _, params = jb.make_apply_params()
    greedy = (np.zeros(1, np.int32), np.zeros(1, np.float32),
              np.zeros(1, np.int32), np.ones(1, np.float32))
    rows = np.zeros(1, np.int32)
    ids = np.asarray([prompt], np.int32)
    arena, tok = jax.jit(jb.prefill_fn(), static_argnums=(9,))(
        params, jb.init_arena(jb.max_streams), rows, ids,
        np.asarray([len(prompt)], np.int32), *greedy, False)
    tokens = [int(tok[0])]
    decode = jax.jit(jb.decode_fn(), static_argnums=(8,))
    for i in range(n - 1):
        arena, tok = decode(params, arena, rows,
                            np.asarray([len(prompt) + i], np.int32), *greedy,
                            False)
        tokens.append(int(tok[0]))
    return tokens


def _port_stream(tb, prompt, n):
    arena = tb.init_arena(tb.max_streams)
    free, _ = tb.arena_rows()
    lanes = tb.lane_params([0], [0.0], [0], [1.0])
    ids = torch.tensor([prompt], dtype=torch.int32)
    tokens = [int(tb.prefill(arena, tb.wave_index(arena, [free[0]],
                                                  [len(prompt)]),
                             ids, lanes, sample=False)[0])]
    for i in range(n - 1):
        index = tb.wave_index(arena, [free[0]], [len(prompt) + i])
        tokens.append(int(tb.decode(arena, index, lanes, sample=False)[0]))
    return tokens


@pytest.mark.parametrize("head_dim", sorted(GPT_WIDTHS))
def test_tiny_gpt_greedy_stream_matches_jax_at_head_dim(head_dim):
    """A two-layer ``TinyGptBackend`` with the flash prefill (K1's
    function) and the fused decode (K2's), the JAX package's weights
    carried across with ``params_from_jax``: the greedy stream equals
    JAX's (Pallas in interpret mode) token for token."""
    kw = _gpt_kw(head_dim)
    jb = JaxGpt(name="hd", attention_impl="flash", attn_impl="fused", **kw)
    jb.flash_blocks = (32, 32)
    tb = gen.TinyGptBackend(name="hd", attention_impl="flash",
                            attn_impl="fused", device="cpu", **kw)
    tb.load_state_dict(gen.params_from_jax(jb._init_params()))
    assert tb.head_dim == head_dim
    prompt = np.random.default_rng(head_dim).integers(0, 128, 21).tolist()
    assert _port_stream(tb, prompt, 8) == _jax_stream(jb, prompt, 8)


def test_kv_shards_16_stream_equals_unsharded():
    """``kv_shards=16`` (above the old cap of 8) on 16 CPU shards, K3's
    function combining the 16 partial outputs, against the port's
    unsharded path: the same greedy stream token for token. The JAX
    suite's conftest gives this process 8 virtual devices, so n = 16
    cannot be held against JAX's ``shard_map`` here; the unsharded port is
    itself held against JAX above and in ``tests/test_torch_generate.py``."""
    kw = dict(_gpt_kw(80), max_streams=16)
    prompt = np.random.default_rng(16).integers(0, 128, 13).tolist()
    streams = []
    for shards in (1, 16):
        tb = gen.TinyGptBackend(name="kv", attention_impl="flash",
                                attn_impl="fused", kv_shards=shards,
                                device="cpu", **kw)
        if shards > 1:
            tb._kv_mesh = ks.kv_mesh(shards, ["cpu"] * shards)
        streams.append(_port_stream(tb, prompt, 8))
    assert streams[0] == streams[1]


@pytest.mark.parametrize("n", [9, 16, 64])
def test_ring_plain_takes_up_to_64_shards(n):
    """The ring's sums for shard counts above the old cap of 8: shard i
    adds x_i, x_{i-1}, ... in that order, bit for bit the same order in
    numpy."""
    rng = np.random.default_rng(n)
    parts = [rng.standard_normal(37).astype(np.float32) * 4 for _ in range(n)]
    got = ks.ring_all_reduce([torch.from_numpy(p) for p in parts])
    for i, g in enumerate(got):
        want = parts[i].copy()
        for j in range(1, n):
            want = want + parts[(i - j) % n]
        np.testing.assert_array_equal(g.numpy(), want)


def test_register_backend_takes_a_custom_width_gpt():
    """The port's ``ModelRepository.register_backend``, as the JAX
    package's tests register a custom-width backend: the load serves the
    backend as it was built (head dim 80 here), under its config's name."""
    from client_tpu_torch.engine.repository import ModelRepository

    tb = gen.TinyGptBackend(name="gpt_hd80", attention_impl="flash",
                            attn_impl="fused", device="cpu", **_gpt_kw(80))
    repo = ModelRepository()
    repo.register_backend(tb)
    assert repo.names() == ["gpt_hd80"]
    model = repo.load("gpt_hd80", "cpu")
    assert model.backend is tb and repo.is_ready("gpt_hd80")
    prompt = np.random.default_rng(80).integers(0, 128, 9).tolist()
    assert _port_stream(model.backend, prompt, 4) == _port_stream(
        tb, prompt, 4)
