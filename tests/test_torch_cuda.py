"""Tests of the port that need the card; each skips without one.

Run on a machine with an NVIDIA GPU (no JAX needed there, hence no
conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernel is held against its plain version at 2e-2 (bf16 output; the
kernel rounds P to bf16 under a running tile max and sums in another
order).
"""

import math

import numpy as np
import pytest
import torch

from client_tpu_torch.engine.model import Model
from client_tpu_torch.models.bert import BertBackend
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
