"""The port's ``TinyGptBackend`` against the JAX package's, on the CPU.

At ``TestFusedDecode.KW``'s sizes (2 layers, d_model 64, 2 heads, vocab
128, max_seq 32, 4 streams): seeded weights equal JAX's bit for bit; the
full-context logits agree within 1e-4 for the einsum and the flash
prefill (JAX's Pallas kernel in interpret mode with 32 x 32 blocks);
``prefill`` / ``decode`` / ``decode_chunk`` tokens equal JAX's
``prefill_fn`` / ``decode_fn`` / ``decode_chunk_fn`` and the arena rows
agree within 1e-5 (fp32 GEMMs of two libraries, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models.generate import TinyGptBackend as JaxGpt
from client_tpu_torch.models import generate as gen
from client_tpu_torch.ops import decode_attention as da

KW = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
          max_seq_len=32, max_streams=4)
CAP, LANE = KW["max_streams"], KW["max_streams"]
DUMMY = CAP


def _pair(attention_impl="einsum", attn_impl="reference"):
    jb = JaxGpt(name="tg", attention_impl=attention_impl,
                attn_impl=attn_impl, **KW)
    jb.flash_blocks = (32, 32)
    tb = gen.TinyGptBackend(name="tg", attention_impl=attention_impl,
                            attn_impl=attn_impl, device="cpu", **KW)
    return jb, tb


def test_seeded_weights_equal_jax_init():
    jb, tb = _pair()
    tree = jb._init_params()
    np.testing.assert_array_equal(tb.embed.numpy(), tree["embed"])
    np.testing.assert_array_equal(tb.pos.numpy(), tree["pos"])
    np.testing.assert_array_equal(tb.head.weight.T.numpy(), tree["head"])
    for lp, jl in zip(tb.layers, tree["layers"]):
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            np.testing.assert_array_equal(
                getattr(lp, key).weight.T.numpy(), jl[key])
        np.testing.assert_array_equal(lp.ln1.weight.numpy(), jl["ln1g"])


def test_params_from_jax_round_trips():
    _, tb = _pair()
    rng = np.random.default_rng(5)
    tree = gen.TinyGptBackend(name="x", seed=3, device="cpu",
                              **KW)._init_params()
    tree["lnfb"] = rng.standard_normal(KW["d_model"]).astype(np.float32)
    tb.load_jax_params(tree)
    state = gen.params_from_jax(tree)
    for name, value in tb.state_dict().items():
        assert torch.equal(value, state[name]), name
    np.testing.assert_array_equal(tb.lnf.bias.numpy(), tree["lnfb"])
    np.testing.assert_array_equal(tb.layers[1].w2.weight.T.numpy(),
                                  tree["layers"][1]["w2"])


@pytest.mark.parametrize("attention_impl", ["einsum", "flash"])
def test_forward_full_logits_match(attention_impl):
    jb, tb = _pair(attention_impl)
    ids = np.random.default_rng(1).integers(0, 128, 32).astype(np.int32)
    apply, params = jb.make_apply_params()
    want = np.asarray(jax.jit(apply)(params, {"INPUT_IDS": ids})["logits"])
    got = tb.forward_full(torch.from_numpy(ids)).numpy()
    assert got.shape == (32, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    batched = tb({"INPUT_IDS": torch.from_numpy(ids[None])})["logits"]
    np.testing.assert_allclose(batched[0].numpy(), got, atol=1e-6, rtol=0)


def _lanes(sampled):
    """Two real lanes and two padded ones; lane 1 sampled when asked."""
    seeds = np.array([3, -7, 0, 0], np.int32)
    temps = np.array([0.0, 0.8 if sampled else 0.0, 0.0, 0.0], np.float32)
    top_ks = np.array([0, 24, 0, 0], np.int32)
    top_ps = np.array([1.0, 0.9, 1.0, 1.0], np.float32)
    return seeds, temps, top_ks, top_ps


def _prefill_both(jb, tb, sampled):
    rng = np.random.default_rng(2)
    bucket = 16
    lens = np.array([11, 5, 1, 1], np.int32)
    ids = np.zeros((LANE, bucket), np.int32)
    for i in range(2):
        ids[i, :lens[i]] = rng.integers(0, 128, lens[i])
    rows = np.array([2, 0, DUMMY, DUMMY], np.int32)
    lanes = _lanes(sampled)
    _, params = jb.make_apply_params()
    j_arena, j_tok = jax.jit(jb.prefill_fn(), static_argnums=(9,))(
        params, jb.init_arena(CAP), rows, ids, lens, *lanes, sampled)
    arena = tb.init_arena(CAP)
    t_tok = tb.prefill(arena, tb.wave_index(arena, rows, lens),
                       torch.from_numpy(ids), tb.lane_params(*lanes),
                       sampled)
    return params, j_arena, np.asarray(j_tok), arena, t_tok.numpy(), rows, lens


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("attention_impl", ["einsum", "flash"])
def test_prefill_matches(attention_impl, sampled):
    jb, tb = _pair(attention_impl)
    _, j_arena, j_tok, arena, t_tok, rows, lens = _prefill_both(
        jb, tb, sampled)
    np.testing.assert_array_equal(t_tok[:2], j_tok[:2])
    for i in range(2):
        r, n = rows[i], lens[i]
        for side in ("k", "v"):
            np.testing.assert_allclose(
                getattr(arena, side)[:, r, :n].numpy(),
                np.asarray(j_arena[side])[:, r, :n], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(arena.tok[rows[:2]].numpy(), t_tok[:2])


def _arena_from_jax(j_arena):
    return gen.KvArena(k=torch.from_numpy(np.array(j_arena["k"])),
                       v=torch.from_numpy(np.array(j_arena["v"])),
                       tok=torch.from_numpy(np.array(j_arena["tok"])))


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("attn_impl", ["reference", "fused"])
def test_decode_and_decode_chunk_match(attn_impl, sampled):
    """From one prefilled arena (JAX's, copied into the port), a wave and a
    3-wave chunk give JAX's tokens on both decode paths."""
    jb, tb = _pair(attn_impl=attn_impl)
    params, j_arena, j_tok, _, _, rows, lens = _prefill_both(jb, tb, sampled)
    lanes = _lanes(sampled)
    arena = _arena_from_jax(j_arena)
    wave_lens = np.where(rows == DUMMY, 0, lens).astype(np.int32)
    before = da.launches
    j_arena2, j_nxt = jax.jit(jb.decode_fn(), static_argnums=(8,))(
        params, j_arena, rows, wave_lens, *lanes, sampled)
    t_nxt = tb.decode(arena, tb.wave_index(arena, rows, wave_lens),
                      tb.lane_params(*lanes), sampled)
    assert da.launches == before  # the CPU path launches no kernel
    np.testing.assert_array_equal(t_nxt.numpy()[:2], np.asarray(j_nxt)[:2])
    np.testing.assert_allclose(arena.k[:, :DUMMY].numpy(),
                               np.asarray(j_arena2["k"])[:, :DUMMY],
                               atol=1e-5, rtol=0)
    chunk_lens = np.where(rows == DUMMY, 0, lens + 1).astype(np.int32)
    _, j_toks = jax.jit(jb.decode_chunk_fn(), static_argnums=(8, 9))(
        params, j_arena2, rows, chunk_lens, *lanes, sampled, 3)
    t_toks = tb.decode_chunk(arena, tb.wave_index(arena, rows, chunk_lens),
                             tb.lane_params(*lanes), sampled, 3)
    assert t_toks.shape == (3, LANE)
    np.testing.assert_array_equal(t_toks.numpy()[:, :2],
                                  np.asarray(j_toks)[:, :2])


def test_invalid_configs_raise():
    with pytest.raises(ValueError, match="attention_impl"):
        gen.TinyGptBackend(attention_impl="ring", device="cpu", **KW)
    with pytest.raises(ValueError, match="attn_impl"):
        gen.TinyGptBackend(attn_impl="xla", device="cpu", **KW)
    # kv_shards: the three checks of the JAX constructor, in its words.
    with pytest.raises(ValueError, match=">= 1"):
        gen.TinyGptBackend(kv_shards=0, device="cpu", **KW)
    with pytest.raises(ValueError, match="fused"):
        gen.TinyGptBackend(attn_impl="reference", kv_shards=2, device="cpu",
                           **KW)
    with pytest.raises(ValueError, match="divisible"):
        gen.TinyGptBackend(attn_impl="fused", kv_shards=3, device="cpu",
                           **{**KW, "max_streams": 4})


def test_backend_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen.TinyGptBackend(**KW)


@pytest.mark.parametrize("name", ["tiny_gpt", "tiny_gpt_long"])
def test_registered_configs_match_the_jax_zoo(name):
    from client_tpu.models import _REGISTRY as jax_registry
    from client_tpu_torch.models import build_repository

    want = jax_registry[name]()
    got = build_repository([name])._builders[name](torch.device("cpu"))
    for attr in ("n_layers", "d_model", "n_heads", "d_ff", "vocab",
                 "max_seq_len", "max_streams", "attention_impl",
                 "default_max_tokens"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.attn_impl == "fused"
    assert got.config.decoupled and want.config.decoupled
    for side in ("input", "output"):
        assert [(t.name, t.data_type, t.dims) for t in getattr(got.config, side)] \
            == [(t.name, t.data_type, t.dims) for t in getattr(want.config, side)]
    np.testing.assert_array_equal(got.embed.numpy(),
                                  want._init_params()["embed"])
