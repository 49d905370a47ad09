"""Tests of the port that need the card; each skips without one.

Run on a machine with an NVIDIA GPU (no JAX needed there, hence no
conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the bf16 flash kernel against its plain version at 2e-2 (bf16
output; the kernel rounds P to bf16 under a running tile max and sums in
another order); the fp32 flash kernel at 1e-4 and the decode-wave kernel at
2e-5 (fp32 throughout, sums in another order, outputs of magnitude ~1); the
ring all-reduce bit for bit (it adds in the plain version's order). The fp32
flash kernel's accuracy case against float64 states its own. The image
models run cuDNN and cuBLAS (no hand-written kernel): each fp32 route on
the card against its CPU run with TF32 off, at 1e-4 relative; the batched
NMS against its CPU run on identical inputs, decisions exactly; SSD at
batch 1 bit for bit from call to call. Device regions (in-process
shared memory on the card): each request's outputs bit for bit against
the same rows run through the host path at the same bucket. The roofline
capture: each kernel's FLOPs and bytes exactly by its formula, and a
BERT bucket's FLOPs on the card within 1% of its CPU count.
"""

import concurrent.futures
import math

import numpy as np
import pytest
import torch

from client_tpu_torch.engine import InferRequest, OutputRequest, TorchEngine
from client_tpu_torch.engine.model import Model
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models import ssd
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.models.dlrm import DlrmBackend
from client_tpu_torch.models.simple import SequenceAccumulateBackend
from client_tpu_torch.models.generate import KvArena, TinyGptBackend
from client_tpu_torch.models.ssd import SsdMobileNetV2Backend
from client_tpu_torch.models.vision import DenseNet121Backend, ResNet50Backend
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.parallel import emb_shard as es
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
    b, (heads, dim) = len(rows), k_a.shape[3:]
    rows, lens = np.asarray(rows, np.int32), np.asarray(lens, np.int32)
    real = rows != n_rows - 1
    q, kn, vn = (torch.randn(b, heads, dim, device=k_a.device, generator=gen)
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


def _mc_arena(card, heads, seed=0, shape=(4, 65, 128)):
    """An arena at head dim 32: tiny_gpt_mc's [4, 65, 128, H, 32] (64 stream
    rows + the dummy row 64) by default; H = 8 unsharded, 1 on a tp8
    shard."""
    gen = torch.Generator(device=card).manual_seed(seed)
    full = (*shape, heads, 32)
    return (torch.randn(full, device=card, generator=gen),
            torch.randn(full, device=card, generator=gen), gen)


@pytest.mark.parametrize("heads", [8, 1], ids=["tiny_gpt_mc", "tp8_shard"])
def test_decode_wave_head_dim_32_matches_plain(card, heads):
    """K2's head-dim-32 instantiation at tiny_gpt_mc's arena, B=16 with
    padded lanes and lens 0, and on a tp8 shard's one head."""
    k_a, v_a, gen = _mc_arena(card, heads)
    rows = list(range(0, 24, 2)) + [64] * 4
    lens = [0, 1, 127, 31, 32, 33, 64, 100, 5, 0, 126, 77] + [0] * 4
    _decode_against_plain(k_a, v_a, gen, rows, lens, 3, 65)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257, 511, 512, 513,
                               1791, 1792, 1793, 2047])
def test_decode_wave_head_dim_32_split_edges(card, n):
    """Head dim 32 at the 32-key tile and 256-key split edges, one head."""
    k_a, v_a, gen = _mc_arena(card, 1, seed=n, shape=(2, 5, 2048))
    _decode_against_plain(k_a, v_a, gen, [2, 4], [n, 0], 1, 5)


def test_decode_wave_head_dim_32_repeats_bit_for_bit(card):
    k_a, v_a, gen = _mc_arena(card, 8, seed=4)
    o, (q, kn, vn, index) = _decode_against_plain(
        k_a, v_a, gen, list(range(8)), [127, 100, 33, 7, 0, 1, 64, 90], 2, 65)
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
    # Built for head dims 32 and 64 only.
    k_a = torch.zeros(1, 3, 8, 2, 48, device=card)
    q = torch.zeros(1, 2, 48, device=card)
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
@pytest.mark.parametrize("shape", [(1, 4, 64), (3, 4, 64), (16, 4, 64), (5,),
                                   (832, 128)])
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


def test_tiny_gpt_streams_over_grpc_equal_the_plain_path(card):
    """A small tiny_gpt on the card (prefill through the fp32 flash kernel,
    waves through the decode kernel) behind a local GrpcInferenceServer:
    two greedy streams and a sampled one, multiplexed on one
    ModelStreamInfer RPC (one with response_coalesce), each token for
    token against the same weights on the plain path run directly."""
    import grpc

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.protocol import grpc_codec, grpc_stub
    from client_tpu_torch.protocol import grpc_service_pb2 as pb
    from client_tpu_torch.server import GrpcInferenceServer

    cfg = dict(name="tg", n_layers=2, d_model=128, n_heads=2, d_ff=256,
               vocab=256, max_seq_len=256, max_streams=4)
    rng = np.random.default_rng(2)
    streams = [(rng.integers(0, 256, n).tolist(), params) for n, params in (
        (5, {}), (90, {"response_coalesce": True}),
        (40, {"temperature": 0.8, "top_k": 24, "top_p": 0.9, "seed": 11}))]
    n_tok = 20
    repo = ModelRepository()
    repo.register("tg", lambda device: TinyGptBackend(
        attention_impl="flash", attn_impl="fused", device=device, **cfg))
    engine = TorchEngine(repo, device=card)
    server = GrpcInferenceServer(engine, port=0).start()
    f0, d0 = fa.launches_fp32, da.launches
    try:
        requests = []
        for i, (prompt, params) in enumerate(streams):
            req = pb.ModelInferRequest(model_name="tg", id=f"s{i}")
            req.inputs.add(name="INPUT_IDS", datatype="INT32",
                           shape=[len(prompt)])
            req.raw_input_contents.append(
                np.asarray(prompt, np.int32).tobytes())
            for k, v in {"max_tokens": n_tok, **params}.items():
                grpc_codec.set_param(req.parameters, k, v)
            requests.append(req)
        got = {f"s{i}": [] for i in range(len(streams))}
        with grpc.insecure_channel(server.url) as channel:
            stub = grpc_stub.GRPCInferenceServiceStub(channel)
            for msg in stub.ModelStreamInfer(iter(requests), timeout=300):
                assert not msg.error_message, msg.error_message
                r = msg.infer_response
                for t, raw in zip(r.outputs, r.raw_output_contents):
                    if t.name == "TOKEN":
                        got[r.id] += np.frombuffer(raw, np.int32).tolist()
    finally:
        server.stop()
        engine.shutdown()
    assert fa.launches_fp32 > f0 and da.launches - d0 >= 2 * (n_tok - 1)

    oracle = TinyGptBackend(attention_impl="einsum", attn_impl="reference",
                            device=card, **cfg)
    arena = oracle.init_arena(1)
    for i, (prompt, params) in enumerate(streams):
        lanes = oracle.lane_params([params.get("seed", 0)],
                                   [params.get("temperature", 0.0)],
                                   [params.get("top_k", 0)],
                                   [params.get("top_p", 1.0)])
        sample = params.get("temperature", 0.0) > 0
        ids = torch.tensor([prompt], dtype=torch.int32, device=card)
        want = [int(oracle.prefill(
            arena, oracle.wave_index(arena, [0], [len(prompt)]), ids, lanes,
            sample)[0])]
        for j in range(n_tok - 1):
            index = oracle.wave_index(arena, [0], [len(prompt) + j])
            want.append(int(oracle.decode(arena, index, lanes, sample)[0]))
        assert got[f"s{i}"] == want, (i, params)


# -- image models: cuDNN and cuBLAS, no hand-written kernel ----------------

CLASSIFIERS = {
    "resnet": lambda device: ResNet50Backend(
        name="r", image_size=64, stages=((1, 16), (2, 32)), device=device),
    "densenet": lambda device: DenseNet121Backend(
        name="d", image_size=64, blocks=(2, 3), growth=8, device=device),
}


@pytest.fixture
def no_tf32():
    """fp32 convolutions and matmuls in full fp32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _nms_inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    enc = torch.randn(3, 1917, 4, generator=gen)
    scores = torch.rand(3, 1917, 91, generator=gen)
    scores[1] *= 0.06  # most under the score threshold
    scores[2, 100:600, 7] = 0.99  # ties: the first index wins
    return enc, scores


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_on_cuda_picks_what_cpu_picks(card, seed):
    """Identical fp32 inputs: the same picks (scores and classes exactly;
    boxes to 1e-6, since ``exp`` may differ by an ulp between the two)."""
    enc, scores = _nms_inputs(seed)
    anchors = torch.from_numpy(ssd.make_anchors())
    cpu = ssd.decode_and_nms(enc, scores, anchors)
    gpu = ssd.decode_and_nms(enc.to(card), scores.to(card), anchors.to(card))
    for name, c, g in zip(("boxes", "classes", "scores", "count"), cpu, gpu):
        g = g.cpu()
        assert g.shape == c.shape and g.dtype == c.dtype, name
        if name == "boxes":
            assert float((g - c).abs().max()) <= 1e-6
        else:
            assert torch.equal(g, c), name


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_classifier_on_cuda_matches_its_cpu_fp32_run(card, no_tf32, name):
    """fp32 route on both: logits within 1e-4 x max|logit| (another
    summation order in cuDNN)."""
    cpu = CLASSIFIERS[name]("cpu").float()
    gpu = CLASSIFIERS[name](card).float()
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = cpu({"INPUT": x})["OUTPUT"]
        got = gpu({"INPUT": x.to(card)})["OUTPUT"].cpu()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_ssd_heads_on_cuda_match_their_cpu_fp32_run(card, no_tf32):
    """fp32 route on both: box encodings within 1e-4 x max|enc|, class
    scores within 1e-4, as against JAX on the CPU."""
    cpu = SsdMobileNetV2Backend(device="cpu").float()
    gpu = SsdMobileNetV2Backend(device=card).float()
    img = torch.randint(0, 256, (2, 300, 300, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want_b, want_s = cpu.head_outputs(img)
        got_b, got_s = (t.cpu() for t in gpu.head_outputs(img.to(card)))
    assert float((got_b - want_b).abs().max()) \
        <= 1e-4 * float(want_b.abs().max())
    assert float((got_s - want_s).abs().max()) <= 1e-4


def test_ssd_batch1_repeats_bit_for_bit(card):
    """bf16 at batch 1, directly and through the model's stream: every
    output equal bit for bit, call after call."""
    backend = SsdMobileNetV2Backend(device=card)
    model = Model(backend, device=card)
    img = np.random.default_rng(3).integers(0, 256, (1, 300, 300, 3)).astype(
        np.uint8)
    runs = [model.execute_timed({"normalized_input_image_tensor": img},
                                batch_size=1)[0] for _ in range(3)]
    with torch.inference_mode():
        direct = backend({"normalized_input_image_tensor":
                          torch.from_numpy(img).to(card)})
    for name, want in runs[0].items():
        assert want.shape[0] == 1
        for run in runs[1:]:
            assert run[name].tobytes() == want.tobytes(), name
        assert direct[name].cpu().numpy().tobytes() == want.tobytes(), name


# -- DLRM and the sequence arena (the stateful phase's path) ------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bag_sum_ring_equals_psum_and_cpu(card, n):
    """The pooled [832, 128] of 26 tables at max_batch_size 32: ring (K3)
    and psum on the card equal the CPU oracle bit for bit (quantized
    table: every sum exact whatever the order of index_add_'s atomics)."""
    rng = np.random.default_rng(n)
    table = es.quantize_table(rng.standard_normal((4096, 128)) * 0.5)
    rows = torch.from_numpy(rng.integers(0, 4096, 4096).astype(np.int32))
    seg = torch.from_numpy(rng.integers(0, 840, 4096).astype(np.int32))
    want = es.bag_sum_oracle(torch.from_numpy(table), rows, seg, 832)
    mesh = es.emb_mesh(n, [card] * n)
    shards = es.shard_table(table, mesh)
    before = ks.launches
    ring = es.sharded_bag_sum(mesh, shards, rows.to(card), seg.to(card), 832,
                              combine="ring")
    psum = es.sharded_bag_sum(mesh, shards, rows.to(card), seg.to(card), 832,
                              combine="psum")
    torch.cuda.synchronize()
    assert ks.launches == before + 1
    assert torch.equal(ring.cpu(), want) and torch.equal(psum.cpu(), want)
    one = es.bag_sum_oracle(torch.from_numpy(table).to(card), rows.to(card),
                            seg.to(card), 832)
    assert torch.equal(one.cpu(), want)


@pytest.mark.parametrize("host_tables", [False, True])
def test_small_dlrm_served_equals_direct(card, host_tables):
    """Concurrent CSR requests through the ragged scheduler on the card,
    each equal bit for bit to the same request run alone (rows always pad
    to max_batch_size, so the products have one shape); sharded over 2
    shards with the ring combine, K3 launched once per execution."""
    kw = (dict(host_tables=True, cache_budget_bytes=4096) if host_tables
          else dict(emb_shards=2, combine="ring", emb_devices=[card] * 2))
    repo = ModelRepository()
    repo.register("d", lambda device: DlrmBackend(name="d", device=device,
                                                  **kw))
    eng = TorchEngine(repo, device=card)
    try:
        rng = np.random.default_rng(3)
        reqs = []
        for _ in range(12):
            b = int(rng.integers(1, 4))
            counts = rng.integers(0, 6, size=b * 4)
            reqs.append({
                "DENSE": rng.standard_normal((b, 8)).astype(np.float32),
                "INDICES": rng.integers(0, 64, int(counts.sum())).astype(
                    np.int32),
                "OFFSETS": np.concatenate([[0], np.cumsum(counts)]).astype(
                    np.int32)})
        before = ks.launches
        with concurrent.futures.ThreadPoolExecutor(12) as pool:
            served = list(pool.map(lambda x: eng.infer(InferRequest(
                model_name="d", inputs=x), timeout_s=120).outputs["OUTPUT0"],
                reqs))
        execs = eng.model_statistics("d")["model_stats"][0]["execution_count"]
        assert ks.launches - before == (0 if host_tables else execs)
        model = eng.repository.get("d")
        for x, got in zip(reqs, served):
            want, _ = model.execute_timed(dict(x), batch_size=int(
                x["INDICES"].shape[0]))
            assert got.tobytes() == want["OUTPUT0"][:len(got)].tobytes()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("strategy", ["direct", "oldest"])
def test_sequence_arena_on_card_equals_cpu(card, strategy):
    """32 sequences of 6 steps side by side on the card and on the CPU:
    the same running sums; the oldest arena's rows equal after each run."""
    def run(device):
        backend = SequenceAccumulateBackend(name="s", strategy=strategy)
        backend.config.sequence_batching.max_queue_delay_microseconds = 20_000
        repo = ModelRepository()
        repo.register("s", lambda d: backend)
        eng = TorchEngine(repo, device=device)
        out = {}

        def seq(sid):
            sums = []
            for i in range(6):
                resp = eng.infer(InferRequest(
                    model_name="s", inputs={"INPUT": np.array(
                        [sid * 7 + i], np.int32)}, sequence_id=sid,
                    sequence_start=i == 0, sequence_end=i == 5),
                    timeout_s=120)
                sums.append(int(resp.outputs["OUTPUT"][0]))
            return sums

        try:
            with concurrent.futures.ThreadPoolExecutor(32) as pool:
                for sid, sums in zip(range(1, 33),
                                     pool.map(seq, range(1, 33))):
                    out[sid] = sums
            stats = eng.model_statistics("s")["model_stats"][0]
        finally:
            eng.shutdown()
        return out, stats

    on_card, stats = run(card)
    on_cpu, _ = run("cpu")
    assert on_card == on_cpu
    assert all(s == list(np.cumsum([sid * 7 + i for i in range(6)]))
               for sid, s in on_card.items())
    if strategy == "oldest":
        assert stats["execution_count"] < 32 * 6


# -- device regions: in-process shared memory on the card ----------------------

def _region_engine(card):
    repo = ModelRepository()
    repo.register("b", lambda device: BertBackend(
        name="b", device=device, attention_impl="flash", **SMALL))
    return TorchEngine(repo, device=card)


def _bert_feeds(n, seed=0):
    rng = np.random.default_rng(seed)
    feeds = []
    for k in range(n):
        mask = np.ones((1, 200), np.int32)
        mask[0, 150 + 10 * k:] = 0
        feeds.append({"input_ids": rng.integers(0, 512, (1, 200)).astype(
            np.int32), "attention_mask": mask})
    return feeds


def _region_requests(eng, feeds, tag="r"):
    """Each input registered as a device region of a tensor on the card,
    each request reading its regions and keeping its outputs there."""
    reqs = []
    for k, feed in enumerate(feeds):
        inputs = {}
        for name, arr in feed.items():
            region = f"{tag}_{name}_{k}"
            eng.cuda_shm.register_device_tensor(
                region, torch.from_numpy(arr).to(eng.device))
            inputs[name] = eng.read_shm_tensor(region, 0, arr.nbytes,
                                               "INT32", arr.shape)
        reqs.append(InferRequest(
            model_name="b", inputs=inputs,
            outputs=[OutputRequest(name="logits"),
                     OutputRequest(name="pooled_output")],
            keep_outputs_on_device=True))
    return reqs


def _one_batch(eng, reqs):
    """``reqs`` as one batch of the scheduler, as its worker runs one."""
    out = [None] * len(reqs)
    for i, r in enumerate(reqs):
        r.response_callback = lambda resp, i=i: out.__setitem__(i, resp)
    eng._schedulers["b"]._execute_batch(reqs)
    assert all(r is not None and r.error is None for r in out), out
    return out


def _host_rows(eng, feeds):
    """The same rows through the host path at the same bucket (3 rows and
    the first repeated, as the device concat pads them)."""
    host = {name: np.concatenate([f[name] for f in feeds] + [feeds[0][name]])
            for name in feeds[0]}
    out, _ = eng.repository.get("b").execute_timed(host, batch_size=4)
    return out


def test_device_region_outputs_are_views_of_the_batch_output(card):
    eng = _region_engine(card)
    try:
        feeds = _bert_feeds(3)
        resps = _one_batch(eng, _region_requests(eng, feeds))
        want = _host_rows(eng, feeds)
        for k, resp in enumerate(resps):
            for name in ("logits", "pooled_output"):
                got = resp.outputs[name]
                region = f"out_{name}_{k}"
                eng.cuda_shm.register_device_tensor(
                    region, torch.zeros_like(got))
                assert eng.write_shm_tensor(region, 0, 0, got) == got.nbytes
                back = eng.cuda_shm.read_back(region)
                assert back.device.type == "cuda"
                assert back.untyped_storage().data_ptr() == \
                    resps[0].outputs[name].untyped_storage().data_ptr()
                assert back.cpu().numpy().tobytes() == \
                    want[name][k:k + 1].tobytes()
    finally:
        eng.shutdown()


def test_device_region_path_copies_nothing_between_host_and_card(card):
    """A profiler window around three requests whose inputs and outputs
    are device regions holds kernels (K1 among them) and no memcpy."""
    from torch.profiler import ProfilerActivity, profile

    eng = _region_engine(card)
    try:
        feeds = _bert_feeds(3)
        _one_batch(eng, _region_requests(eng, feeds, "warm"))
        reqs = _region_requests(eng, feeds)
        for k in range(3):
            for name in ("logits", "pooled_output"):
                eng.cuda_shm.register_device_tensor(
                    f"out_{name}_{k}", torch.zeros(
                        (1, 2) if name == "logits" else (1, 256),
                        device=card))
        torch.cuda.synchronize()
        before = fa.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            resps = _one_batch(eng, reqs)
            for k, resp in enumerate(resps):
                for name, t in resp.outputs.items():
                    eng.write_shm_tensor(f"out_{name}_{k}", 0, 0, t)
            torch.cuda.synchronize()
        assert fa.launches - before == SMALL["n_layers"]
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any("flash" in n for n in names), names
        assert not [n for n in names if "Memcpy HtoD" in n
                    or "Memcpy DtoH" in n], names
    finally:
        eng.shutdown()


def test_device_region_filled_on_a_side_stream_is_waited_for(card):
    """A region filled on a side stream behind a long sleep and registered
    there: the batch reads the filled rows, not the zeros before them."""
    eng = _region_engine(card)
    try:
        feeds = _bert_feeds(3, seed=4)
        want = _host_rows(eng, feeds)
        side = torch.cuda.Stream(device=card)
        reqs = []
        for k, feed in enumerate(feeds):
            inputs = {}
            for name, arr in feed.items():
                t = torch.zeros(arr.shape, dtype=torch.int32, device=card)
                src = torch.from_numpy(arr).to(card)
                torch.cuda.synchronize()
                with torch.cuda.stream(side):
                    torch.cuda._sleep(20_000_000)  # ~10 ms at H100 clocks
                    t.copy_(src)
                    eng.cuda_shm.register_device_tensor(f"s_{name}_{k}", t)
                inputs[name] = eng.read_shm_tensor(
                    f"s_{name}_{k}", 0, arr.nbytes, "INT32", arr.shape)
            reqs.append(InferRequest(
                model_name="b", inputs=inputs,
                outputs=[OutputRequest(name="logits")],
                keep_outputs_on_device=True))
        resps = _one_batch(eng, reqs)
        for k, resp in enumerate(resps):
            assert resp.outputs["logits"].cpu().numpy().tobytes() == \
                want["logits"][k:k + 1].tobytes()
    finally:
        eng.shutdown()


def test_device_region_offsets_and_device_ids_are_refused(card):
    """Offsets on a device region and a device_id past the visible cards
    answer 400 with the JAX engine's words."""
    from client_tpu_torch.engine import EngineError
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    eng = _region_engine(card)
    n = torch.cuda.device_count()
    h = cudashm.create_shared_memory_region("far", 64, device_id=n)
    try:
        eng.cuda_shm.register_device_tensor(
            "d", torch.zeros(1, 16, dtype=torch.int32, device=card),
            device_id=n)
        eng.cuda_shm.register_handle("far", cudashm.get_raw_handle(h), n, 64)
        for fn, words in (
                (lambda: eng.read_shm_tensor("d", 64, 64, "INT32", [1, 16]),
                 "region 'd': offsets unsupported for device regions"),
                (lambda: eng.write_shm_tensor(
                    "d", 64, 64, torch.zeros(1, 16, device=card)),
                 "region 'd': offsets unsupported for device regions"),
                (lambda: eng.write_shm_tensor(
                    "d", 0, 64, np.zeros((1, 16), np.int32)),
                 f"device_id {n} out of range ({n} devices)"),
                (lambda: eng.read_shm_tensor("far", 0, 64, "INT32", [1, 16]),
                 f"device_id {n} out of range ({n} devices)")):
            with pytest.raises(EngineError) as exc:
                fn()
            assert exc.value.status == 400 and str(exc.value) == words
    finally:
        eng.shutdown()
        cudashm.destroy_shared_memory_region(h)


# -- unload on the card ------------------------------------------------------------

UNLOAD_KINDS = ["dynamic", "ragged", "sequence_direct", "sequence_oldest",
                "generative", "decoupled", "ensemble"]


def _unload_case(kind: str, card):
    """(repository, the model to unload, its request's keyword arguments)
    for one scheduler kind, with weights or state on the card."""
    from client_tpu_torch.engine.config import (
        EnsembleStep,
        ModelConfig,
        TensorConfig,
    )
    from client_tpu_torch.engine.repository import ConfigOnlyBackend
    from client_tpu_torch.models.simple import RepeatBackend

    repo = ModelRepository()
    rng = np.random.default_rng(6)
    bert_kw = dict(inputs={
        "input_ids": rng.integers(0, 512, (1, 200)).astype(np.int32),
        "attention_mask": np.ones((1, 200), np.int32)})
    if kind in ("dynamic", "ensemble"):
        repo.register("b", lambda device: BertBackend(
            name="b", attention_impl="flash", device=device, **SMALL))
        if kind == "dynamic":
            return repo, "b", bert_kw
        cfg = ModelConfig(
            name="e", platform="ensemble", max_batch_size=4,
            input=[TensorConfig("input_ids", "INT32", [200]),
                   TensorConfig("attention_mask", "INT32", [200])],
            output=[TensorConfig("logits", "FP32", [2])],
            ensemble_scheduling=[EnsembleStep(
                "b", input_map={"input_ids": "input_ids",
                                "attention_mask": "attention_mask"},
                output_map={"logits": "logits"})])
        repo.register("e", lambda device: ConfigOnlyBackend(cfg))
        return repo, "e", bert_kw
    if kind == "ragged":
        repo.register("d", lambda device: DlrmBackend(
            name="d", table_rows=4096, emb_shards=2, combine="ring",
            emb_devices=[card] * 2, device=device))
        counts = np.array([1, 2, 3, 1])
        return repo, "d", dict(inputs={
            "DENSE": np.ones((1, 8), np.float32),
            "INDICES": np.arange(7, dtype=np.int32),
            "OFFSETS": np.concatenate([[0], np.cumsum(counts)]).astype(
                np.int32)})
    if kind.startswith("sequence"):
        strategy = kind.split("_")[1]
        repo.register("s", lambda device: SequenceAccumulateBackend(
            name="s", strategy=strategy))
        return repo, "s", dict(inputs={"INPUT": np.array([3], np.int32)},
                               sequence_id=5)
    if kind == "generative":
        repo.register("tg", lambda device: TinyGptBackend(
            name="tg", n_layers=2, d_model=128, n_heads=2, d_ff=256,
            vocab=256, max_seq_len=256, max_streams=4,
            attention_impl="flash", attn_impl="fused", device=device))
        return repo, "tg", dict(
            inputs={"INPUT_IDS": np.array([1, 2, 3], np.int32)},
            parameters={"max_tokens": 240})
    repo.register("r", lambda device: RepeatBackend(name="r"))
    return repo, "r", dict(inputs={"IN": np.arange(8, dtype=np.int32),
                                   "DELAY": np.full(8, 20_000, np.uint32)})


def _allocated(card) -> int:
    """``memory_allocated`` once nothing refers to the dropped tensors.
    It counts cuBLAS's workspaces too: a worker makes its own when it
    starts (``worker_stream``), so serving adds none between readings."""
    import gc

    gc.collect()
    torch.cuda.synchronize(card)
    return torch.cuda.memory_allocated(card)


@pytest.mark.parametrize("kind", UNLOAD_KINDS)
def test_unload_with_a_request_in_flight_gives_the_card_memory_back(card,
                                                                    kind):
    """Four requests in flight when their model unloads: each is answered
    within 10 s (served, or 503), nothing keeps the backend alive, and
    ``memory_allocated`` falls by at least 90% of the weights' bytes; a
    stateful model's slots or arena go with it (the decoupled model is
    host-side: nothing of it is on the card, and nothing stays)."""
    import threading
    import weakref

    repo, name, kw = _unload_case(kind, card)
    eng = TorchEngine(repo, device=card)
    try:
        model = eng.repository.get(name)
        # The ensemble's composing model unloads with it.
        models = {id(m): m for m in (model, eng.repository.get("b"))
                  if m is not None}
        held = sum(t.numel() * t.element_size() for m in models.values()
                   for t in (*m.backend.parameters(), *m.backend.buffers()))
        del models
        backend = weakref.ref(model.backend)
        del model
        if kind.startswith("sequence"):
            # A live sequence: its state is on the card when it unloads.
            eng.infer(InferRequest(model_name=name, sequence_start=True,
                                   **kw), timeout_s=60)
        pending = []
        for _ in range(4):
            done, got = threading.Event(), []

            def cb(resp, done=done, got=got):
                got.append(resp)
                if resp.error is not None or resp.final:
                    done.set()

            eng.async_infer(InferRequest(model_name=name, **kw), cb)
            pending.append((done, got))
        before = _allocated(card)
        eng.unload_model(name, unload_dependents=True)
        for done, got in pending:
            assert done.wait(10), f"{kind}: a caller left waiting"
            err = got[-1].error
            assert err is None or err.status in (400, 503), str(err)
        del pending, done, got, err
        after = _allocated(card)
        assert backend() is None, f"{kind}: the backend lives on"
        if held:
            assert before - after >= 0.9 * held, (kind, before, after, held)
        elif kind == "decoupled":
            assert after <= before, (before, after)
        else:
            assert after < before, (kind, before, after)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# The roofline capture and /metrics on the card
# ---------------------------------------------------------------------------


def _captured(fn):
    from client_tpu_torch.observability.roofline import CostCapture

    with CostCapture() as cap:
        fn()
    torch.cuda.synchronize()
    return cap


@pytest.mark.parametrize("causal,dtype", [(False, torch.bfloat16),
                                          (True, torch.float32)])
def test_capture_counts_the_flash_kernel_by_its_formula(card, causal, dtype):
    """K1 runs through ctypes, where the FLOP counter sees nothing: its
    wrapper reports 4 B H D x (pairs attended) FLOPs and the q, k, v,
    output and bias bytes, and the capture holds exactly those."""
    b, s, h = 2, 256, 4
    q, k, v = (t.to(dtype) for t in _fused_qkv(b, s, h))
    bias = torch.zeros(b, s, device=card)
    cap = _captured(lambda: fa.flash_attention(q, k, v, bias, causal=causal))
    pairs = s * (s + 1) / 2 if causal else s * s
    res = cap.result()
    assert res["flops"] == cap.kernel_flops == 4.0 * b * h * 64 * pairs
    assert res["bytes_accessed"] == cap.kernel_bytes \
        == 4 * b * s * h * 64 * q.element_size() + b * s * 4


def test_capture_counts_the_decode_kernel_by_its_formula(card):
    """K2: 4 H D (sum of lens + B) FLOPs, and the valid K/V prefix, the
    lanes, the scattered slots, rows and lens as bytes."""
    L, R, S, H, D = 2, 5, 512, 4, 64
    g = torch.Generator().manual_seed(3)
    k_arena = torch.randn(L, R, S, H, D, generator=g).cuda()
    v_arena = torch.randn(L, R, S, H, D, generator=g).cuda()
    lens = [300, 7, 0, 511]
    index = da.WaveIndex([0, 2, 3, 4], lens, R, S, card)
    q, kn, vn = (torch.randn(4, H, D, generator=g).cuda() for _ in range(3))
    cap = _captured(lambda: da.decode_wave_attention(
        k_arena, v_arena, q, kn, vn, index, layer=1))
    lane = H * D * 4
    assert cap.kernel_flops == 4.0 * H * D * (sum(lens) + 4)
    assert cap.kernel_bytes == 2 * sum(lens) * lane + 6 * 4 * lane + 2 * 4 * 4
    assert cap.result()["flops"] == cap.kernel_flops


@pytest.mark.parametrize("n", [2, 4])
def test_capture_counts_the_ring_kernel_by_its_formula(card, n):
    """K3: (n - 1) n numel additions; each partial read and each sum
    written once (n x numel x 4 bytes each way)."""
    parts = [torch.full((16, 4, 64), float(i), device=card)
             for i in range(n)]
    cap = _captured(lambda: ks.ring_all_reduce(parts))
    numel = 16 * 4 * 64
    assert cap.kernel_flops == (n - 1) * n * numel
    assert cap.kernel_bytes == 2 * n * numel * 4


def test_a_flash_bert_bucket_counts_equal_flops_on_the_card_and_cpu(card):
    """The whole forward: the FLOPs captured for one bucket on the card
    (counter plus K1's report) equal the CPU's (counter over the plain
    version) within 1%."""
    from client_tpu_torch.observability.roofline import CostCapture

    flops = {}
    for device in ("cpu", "cuda"):
        backend = BertBackend(name="b", attention_impl="flash",
                              device=device, **SMALL)
        ids = torch.randint(0, SMALL["vocab"], (2, SMALL["seq_len"]),
                            generator=torch.Generator().manual_seed(0))
        inputs = {"input_ids": ids.to(device),
                  "attention_mask": torch.ones_like(ids).to(device)}
        with torch.inference_mode(), CostCapture(backend) as cap:
            backend(inputs)
        flops[device] = cap.result()["flops"]
    assert flops["cuda"] == pytest.approx(flops["cpu"], rel=0.01)


def test_metrics_render_on_the_card_with_its_memory_in_use(card):
    """``/metrics`` of an engine on the card: the card's bytes in use are
    not 0, its capacity is the card's, and the legacy block counts the
    request."""
    repo = ModelRepository()
    repo.register("b", lambda device: BertBackend(name="b", device=device,
                                                  **SMALL))
    engine = TorchEngine(repo)
    try:
        ids = np.zeros((1, SMALL["seq_len"]), np.int32)
        engine.infer(InferRequest(model_name="b", inputs={
            "input_ids": ids, "attention_mask": np.ones_like(ids)}))
        text = engine.prometheus_metrics()
    finally:
        engine.shutdown()
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            values[name] = float(value)
    assert values['tpu_device_hbm_bytes_in_use{device="0"}'] > 0
    assert values['tpu_hbm_limit_bytes{device="0"}'] \
        == torch.cuda.get_device_properties(0).total_memory
    assert values['tpu_inference_request_success{model="b",version="1"}'] \
        == 1
    assert values['tpu_xla_compilations_total{model="b",version="1",'
                  'bucket="1"}'] == 1


# -- checkpoints --------------------------------------------------------------

def test_jax_written_fixture_restores_and_serves_on_the_card(card):
    """The checkpoint JAX's save_params wrote (orbax's zstd frames),
    restored with no JAX: every leaf's SHA-256 on the card is the one JAX
    recorded, and the engine's greedy streams through K1 fp32 and K2 are
    JAX's token for token."""
    import hashlib
    import json
    import pathlib
    import threading

    from client_tpu_torch.engine.checkpoint import flatten
    from client_tpu_torch.engine.model import restoring

    here = pathlib.Path(__file__).resolve().parent / "torch_data"
    expect = json.loads((here / "jax_gpt_ckpt" / "expect.json").read_text())
    name = expect["name"]
    repo = ModelRepository()

    def build(device):
        with restoring(str(here / "jax_gpt_ckpt" / "ckpt")):
            return TinyGptBackend(name=name, device=device,
                                  **expect["model"])

    repo.register(name, build)
    engine = TorchEngine(repo)
    try:
        backend = engine.repository.get(name).backend
        assert backend.embed.device.type == "cuda"
        for path, _, leaf in flatten(backend.params_to_jax()):
            digest = hashlib.sha256(
                leaf.detach().contiguous().cpu().numpy().tobytes())
            assert digest.hexdigest() == expect["leaves"][
                ".".join(path)]["sha256"], path
        k1, k2 = fa.launches_fp32, da.launches
        streams = []
        for prompt in expect["prompts"]:
            toks, done = [], threading.Event()

            def on_response(resp, toks=toks, done=done):
                if resp.error is not None or resp.final:
                    toks.append(resp.error)
                    done.set()
                else:
                    toks.append(int(resp.outputs["TOKEN"][0]))

            engine.async_infer(InferRequest(
                model_name=name,
                inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
                parameters={"max_tokens": expect["max_tokens"]}), on_response)
            assert done.wait(300)
            assert toks.pop() is None, toks  # the stream's error, if any
            streams.append(toks)
        assert streams == expect["greedy_tokens"]
        assert fa.launches_fp32 > k1 and da.launches > k2
    finally:
        engine.shutdown()
