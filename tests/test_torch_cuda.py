"""Tests of the port that need the card; each skips without one.

Run on a machine with an NVIDIA GPU (no JAX needed there, hence no
conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the bf16 flash kernel against its plain version at 2e-2 (bf16
output; the kernel rounds P to bf16 under a running tile max and sums in
another order); the fp32 flash kernel at 1e-4 and the decode-wave kernel at
2e-5 (fp32 throughout, sums in another order, outputs of magnitude ~1).
"""

import math

import numpy as np
import pytest
import torch

from client_tpu_torch.engine.model import Model
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.models.generate import TinyGptBackend
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.ops import flash_attention as fa

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
