"""Tests of the port that need the card; each skips without one.

Run on a machine with an NVIDIA GPU (no JAX needed there, hence no
conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the bf16 flash kernel against its plain version at 2e-2 (bf16
output; the kernel rounds P to bf16 under a running tile max and sums in
another order); the fp32 flash kernel at 1e-4 and the decode-wave kernel at
2e-5 (fp32 throughout, sums in another order, outputs of magnitude ~1); the
ring all-reduce bit for bit (it adds in the plain version's order). The fp32
flash kernel's accuracy case against float64 states its own.
"""

import math

import numpy as np
import pytest
import torch

from client_tpu_torch.engine.model import Model
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.models.generate import KvArena, TinyGptBackend
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.parallel import kv_shard as ks

pytestmark = pytest.mark.cuda

SMALL = dict(seq_len=200, hidden=256, n_layers=2, n_heads=4, ffn=512,
             vocab=512, max_batch_size=4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _fused_qkv(b, s, h, seed=0):
    fused = torch.randn(b, s, 3, h, 64, generator=torch.Generator()
                        .manual_seed(seed)).to(torch.bfloat16).cuda()
    return fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_matches_plain(card, causal):
    q, k, v = _fused_qkv(2, 200, 12)
    bias = torch.zeros(2, 200, device=card)
    bias[0, 150:] = -1e9
    bias[1, :] = -math.inf
    before = fa.launches
    out = fa.flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, bias, causal=causal)
    assert (out[1] == 0).all()
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2


def test_kernel_refuses_what_it_was_not_built_for(card):
    q = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)


def test_bert_flash_serves_through_the_kernel(card):
    backend = BertBackend(name="b", attention_impl="flash", device=card,
                          **SMALL)
    model = Model(backend, device=card)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (3, 200)).astype(np.int32)
    mask = np.ones((3, 200), np.int32)
    mask[1, 120:] = 0
    before = fa.launches
    out, phases = model.execute_timed(
        {"input_ids": ids, "attention_mask": mask}, batch_size=3)
    assert fa.launches == before + SMALL["n_layers"]
    assert phases.start <= phases.input_end <= phases.infer_end \
        <= phases.output_end
    with torch.inference_mode():
        ref = backend.encode({"input_ids": torch.from_numpy(ids).cuda(),
                              "attention_mask": torch.from_numpy(mask).cuda()},
                             fa.flash_attention_plain)
    for name in ("logits", "pooled_output"):
        assert out[name].shape == (3, *ref[name].shape[1:])
        np.testing.assert_allclose(out[name], ref[name].cpu().numpy(),
                                   atol=6e-2, rtol=0)


@pytest.mark.parametrize("s", [2048, 200])
def test_fp32_causal_kernel_matches_plain(card, s):
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(8 if s == 2048 else 3, s, 4, 64, device=card,
                           generator=gen) for _ in range(3))
    before = fa.launches_fp32
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches_fp32 == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=True)
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [1, 63, 127, 128, 129, 191, 192, 193, 200,
                               2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernel_tile_edges(card, dtype, s, causal, with_bias):
    """Both kernels against the plain version at the edges of their tiles
    (bf16: 192 query rows a CTA, 128 keys a stage; fp32: 64 and 64), on
    strided slices of one fused [B, S, 3, H, 64] tensor as BERT hands them
    over. With a bias, batch row 1 masks every key and must be exactly 0."""
    gen = torch.Generator(device=card).manual_seed(s)
    fused = torch.randn(2, s, 3, 3, 64, device=card, generator=gen).to(dtype)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    bias = None
    if with_bias:
        bias = torch.zeros(2, s, device=card)
        bias[0, s * 3 // 4:] = -1e9
        bias[1] = -math.inf
    counts = (fa.launches, fa.launches_fp32)
    out = fa.flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (fa.launches, fa.launches_fp32) == (counts[0] + bf16,
                                               counts[1] + (not bf16))
    ref = fa.flash_attention_plain(q, k, v, bias, causal=causal)
    assert out.shape == q.shape and out.dtype == dtype
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= (2e-2 if bf16 else 1e-4), err
    if with_bias:
        assert bool((out[1] == 0).all())


def _attention_float64(q, k, v, causal):
    """Attention computed in float64 throughout, no masking tricks."""
    q, k, v = q.double(), k.double(), v.double()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fp32_kernel_keeps_fp32_accuracy(card, causal):
    """Inputs scaled x8 make the scores ~64x larger (up to a few hundred),
    so the rounding of each product shows in the softmax. Tolerance 2e-3
    against float64, outputs reaching ~35: on an H100 the fp32 plain
    version (cuBLAS, TF32 off) lands 5.6e-4 to 5.8e-4 away and the kernel
    6.8e-4 to 7.2e-4, while plain TF32 products (10-bit mantissas) miss by
    0.53 to 0.63, as would a split that lost a term (chip_smoke.py prints
    all four for these inputs)."""
    gen = torch.Generator(device=card).manual_seed(7)
    fused = torch.randn(2, 512, 3, 2, 64, device=card, generator=gen) * 8
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = _attention_float64(q, k, v, causal)
    assert float((out.double() - ref).abs().max()) <= 2e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_refused_launch_raises(card, dtype):
    """A grid the card cannot launch (65,536 query tiles in the grid's
    second dimension, whose limit is 65,535) is refused by the runtime:
    the wrapper raises with the runtime's message, counts no launch and
    does not fall back to the plain version."""
    rows = 192 if dtype == torch.bfloat16 else 64  # query rows a CTA
    q = torch.zeros(1, 65535 * rows + 1, 1, 64, dtype=dtype, device=card)
    counts = (fa.launches, fa.launches_fp32)
    with pytest.raises(RuntimeError, match="launch failed: invalid config"):
        fa.flash_attention(q, q, q)
    assert (fa.launches, fa.launches_fp32) == counts


def _tiny_gpt_long_arena(card, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    shape = (4, 17, 2048, 4, 64)  # tiny_gpt_long: L, 16 rows + dummy, S, H, D
    return (torch.randn(shape, device=card, generator=gen),
            torch.randn(shape, device=card, generator=gen), gen)


def test_decode_wave_kernel_matches_plain(card):
    k_a, v_a, gen = _tiny_gpt_long_arena(card)
    rows = np.array([3, 0, 7, 12, 5, 9, 16, 16], np.int32)  # two padded
    lens = np.array([0, 1, 2047, 100, 1023, 1500, 0, 0], np.int32)
    real = slice(0, 6)
    q, kn, vn = (torch.randn(8, 4, 64, device=card, generator=gen)
                 for _ in range(3))
    index = da.WaveIndex(rows, lens, 17, 2048, card)
    k_ref, v_ref = k_a.clone(), v_a.clone()
    before = da.launches
    o = da.decode_wave_attention(k_a, v_a, q, kn, vn, index, layer=2)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    o_ref = da.decode_wave_attention_plain(k_ref, v_ref, q, kn, vn, index,
                                           layer=2)
    assert float((o[real] - o_ref[real]).abs().max()) <= 2e-5
    assert torch.equal(o[0], vn[0])  # lens 0: exactly v_new
    # Every arena element but the dummy row equals the plain version's
    # (the scattered slots included, bit for bit).
    assert torch.equal(k_a[:, :16], k_ref[:, :16])
    assert torch.equal(v_a[:, :16], v_ref[:, :16])
    r = torch.from_numpy(rows[real]).long()
    n = torch.from_numpy(lens[real]).long()
    assert torch.equal(k_a[2, r, n], kn[real])
    assert torch.equal(v_a[2, r, n], vn[real])


def _decode_against_plain(k_a, v_a, gen, rows, lens, layer, n_rows):
    """One kernel call against the plain version on clones of the arena:
    output within 2e-5 on the real lanes, exactly v_new where lens is 0,
    every row but the last (the dummy or junk row) bit-identical, one
    launch. Returns the kernel's output and the call's inputs."""
    b = len(rows)
    rows, lens = np.asarray(rows, np.int32), np.asarray(lens, np.int32)
    real = rows != n_rows - 1
    q, kn, vn = (torch.randn(b, 4, 64, device=k_a.device, generator=gen)
                 for _ in range(3))
    index = da.WaveIndex(rows, lens, n_rows, k_a.shape[2], k_a.device)
    k_ref, v_ref = k_a.clone(), v_a.clone()
    before = da.launches
    o = da.decode_wave_attention(k_a, v_a, q, kn, vn, index, layer=layer)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    o_ref = da.decode_wave_attention_plain(k_ref, v_ref, q, kn, vn, index,
                                           layer=layer)
    assert float((o[real] - o_ref[real]).abs().max()) <= 2e-5
    for i in np.flatnonzero(real & (lens == 0)):
        assert torch.equal(o[i], vn[i])
    assert torch.equal(k_a[:, :-1], k_ref[:, :-1])
    assert torch.equal(v_a[:, :-1], v_ref[:, :-1])
    return o, (q, kn, vn, index)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257, 511, 512, 513,
                               1791, 1792, 1793, 2047])
def test_decode_wave_split_edges(card, n):
    """Prefix lengths at the kernel's 32-key tile edges and the split
    plan's 256-key steps (n_split 1 to 8), beside a padded lane."""
    k_a, v_a, gen = _tiny_gpt_long_arena(card, seed=n)
    _decode_against_plain(k_a, v_a, gen, [7, 16], [n, 0], 1, 17)
    assert da.split_plan([n, 0]) == min(8, -(-n // 256))


def test_decode_wave_every_lane_at_2047(card):
    k_a, v_a, gen = _tiny_gpt_long_arena(card, seed=1)
    _decode_against_plain(k_a, v_a, gen, list(range(16)), [2047] * 16, 3, 17)


def test_decode_wave_mixes_padded_lanes_and_lens_zero(card):
    k_a, v_a, gen = _tiny_gpt_long_arena(card, seed=2)
    _decode_against_plain(k_a, v_a, gen, [0, 16, 4, 16, 9, 16, 2],
                          [0, 0, 1500, 0, 0, 0, 300], 0, 17)


def test_decode_wave_on_a_shard_local_index(card):
    """Each shard's K2 call of a sharded wave (owned lanes at their
    lengths, the others on the shard's junk row at length 0) against the
    plain version."""
    total, free, _dummy = ks.arena_row_layout(16, 2)
    gen = torch.Generator(device=card).manual_seed(3)
    arena = ks.shard_arena(
        KvArena(k=torch.randn(2, total, 512, 4, 64, device=card,
                              generator=gen),
                v=torch.randn(2, total, 512, 4, 64, device=card,
                              generator=gen),
                tok=torch.zeros(total, dtype=torch.int32, device=card)),
        ks.kv_mesh(2, [card] * 2))
    rows = [free[0], free[9], free[3], free[15]]
    index = ks.ShardedWaveIndex(da.WaveIndex(rows, [511, 40, 0, 300], total,
                                             512, card),
                                ks.kv_mesh(2, [card] * 2))
    for k_sh, v_sh, local in zip(arena.k, arena.v, index.shards):
        _decode_against_plain(k_sh, v_sh, gen, local.rows_host,
                              local.lens_host, 1, local.n_rows)


def test_decode_wave_repeats_bit_for_bit(card):
    """The cluster merges its CTAs' partials in rank order, so two
    identical calls give the same bits."""
    k_a, v_a, gen = _tiny_gpt_long_arena(card, seed=4)
    o, (q, kn, vn, index) = _decode_against_plain(
        k_a, v_a, gen, list(range(8)), [2047, 1000, 513, 7, 0, 1, 256, 1800],
        2, 17)
    again = da.decode_wave_attention(k_a, v_a, q, kn, vn, index, layer=2)
    assert torch.equal(again, o)


def test_decode_wave_refused_cluster_raises(card):
    """A cluster of 16 CTAs (above the portable 8, not opted in) is refused
    by the runtime: the wrapper raises with its message, counts no launch
    and does not fall back to the plain version."""
    k_a, v_a, gen = _tiny_gpt_long_arena(card)
    q = torch.randn(1, 4, 64, device=card, generator=gen)
    index = da.WaveIndex([0], [2047], 17, 2048, card)
    index.n_split = 16
    before = da.launches
    with pytest.raises(RuntimeError, match="decode wave kernel launch failed"):
        da.decode_wave_attention(k_a, v_a, q, q, q, index, layer=0)
    assert da.launches == before


def test_decode_wave_refuses_what_it_was_not_built_for(card):
    k_a = torch.zeros(1, 3, 8, 2, 32, device=card)
    q = torch.zeros(1, 2, 32, device=card)
    index = da.WaveIndex([0], [1], 3, 8, card)
    with pytest.raises(ValueError, match="head dim"):
        da.decode_wave_attention(k_a, k_a, q, q, q, index, layer=0)


def test_tiny_gpt_long_fused_stream_equals_reference(card):
    """One greedy stream of tiny_gpt_long, prefill through the fp32 flash
    kernel and every wave through the decode kernel, equals the plain
    path (einsum prefill, reference decode) token for token."""
    prompt = np.random.default_rng(0).integers(0, 512, 300).astype(np.int32)

    def stream(attention_impl, attn_impl, n=24):
        backend = TinyGptBackend(name="t", max_seq_len=2048, max_streams=16,
                                 attention_impl=attention_impl,
                                 attn_impl=attn_impl, device=card)
        arena = backend.init_arena(16)
        lanes = backend.lane_params([0], [0.0], [0], [1.0])
        ids = torch.from_numpy(prompt[None]).to(card)
        tokens = [int(backend.prefill(
            arena, backend.wave_index(arena, [0], [len(prompt)]), ids,
            lanes, sample=False)[0])]
        for i in range(n - 1):
            index = backend.wave_index(arena, [0], [len(prompt) + i])
            tokens.append(int(backend.decode(arena, index, lanes,
                                             sample=False)[0]))
        return tokens

    f0, d0 = fa.launches_fp32, da.launches
    fused = stream("flash", "fused")
    assert fa.launches_fp32 - f0 == 4 and da.launches - d0 == 4 * 23
    assert fused == stream("einsum", "reference")


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(1, 4, 64), (3, 4, 64), (16, 4, 64), (5,)])
def test_ring_all_reduce_equals_plain_bit_for_bit(card, n, shape):
    gen = torch.Generator(device=card).manual_seed(n)
    parts = [torch.randn(shape, device=card, generator=gen) * 4
             for _ in range(n)]
    before = ks.launches
    got = ks.ring_all_reduce(parts)
    torch.cuda.synchronize()
    assert ks.launches == before + 1
    for g, w in zip(got, ks.ring_all_reduce_plain(parts)):
        assert torch.equal(g, w)


def test_ring_all_reduce_refuses_what_it_was_not_built_for(card):
    x = torch.zeros(4, device=card)
    with pytest.raises(ValueError, match="float32"):
        ks.ring_all_reduce([x.half(), x.half()])
    with pytest.raises(ValueError, match="at most 8"):
        ks.ring_all_reduce([x] * 9)
    with pytest.raises(ValueError, match="one card"):
        ks.ring_all_reduce([x, x.cpu()])


def test_tiny_gpt_long_sharded_stream_equals_unsharded(card):
    """One greedy and one sampled stream of tiny_gpt_long over 2 shards on
    the card (K2 per shard, K3 per layer) equal the unsharded fused path
    token for token, in rows on both shards."""
    prompt = np.random.default_rng(1).integers(0, 512, 300).astype(np.int32)

    def stream(shards, row_pick, temp, n=16):
        backend = TinyGptBackend(name="t", max_seq_len=2048, max_streams=16,
                                 attention_impl="flash", attn_impl="fused",
                                 kv_shards=shards, device=card)
        if shards > 1:
            backend._kv_mesh = ks.kv_mesh(shards, [card] * shards)
        free, _dummy = backend.arena_rows()
        row = free[row_pick]
        arena = backend.init_arena(16)
        lanes = backend.lane_params([5], [temp], [24], [0.9])
        ids = torch.from_numpy(prompt[None]).to(card)
        tokens = [int(backend.prefill(
            arena, backend.wave_index(arena, [row], [len(prompt)]), ids,
            lanes, sample=temp > 0)[0])]
        for i in range(n - 1):
            index = backend.wave_index(arena, [row], [len(prompt) + i])
            tokens.append(int(backend.decode(arena, index, lanes,
                                             sample=temp > 0)[0]))
        return tokens

    for temp in (0.0, 0.8):
        want = stream(1, 0, temp)
        for row_pick in (0, 15):  # the first row of shard 0, last of shard 1
            k3, k2 = ks.launches, da.launches
            assert stream(2, row_pick, temp) == want
            assert ks.launches - k3 == 4 * 15
            assert da.launches - k2 == 2 * 4 * 15
