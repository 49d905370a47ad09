"""BERT-base encoder (`bert_base`, `bert_long`) as an ``nn.Module``.

Counterpart of ``client_tpu/models/bert.py``, with the same numerics:

- bf16 weights and matmuls; layer norm takes fp32 statistics with
  population variance and eps 1e-12, and casts its output to bf16;
- the embedding sum is bf16; the additive attention bias is
  ``(mask - 1) * 1e9`` in fp32;
- fused QKV is qkv-major, ``[b, s, 3, heads, head_dim]``;
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- the einsum attention rounds scores to bf16, then scales, biases and
  softmaxes in fp32 and rounds the probabilities to bf16; the flash path
  is the hand-written kernel in ``client_tpu_torch/ops``;
- the pooler and classifier run in fp32.

Inputs ``input_ids`` INT32[S] and ``attention_mask`` INT32[S]; outputs
``pooled_output`` FP32[hidden] and ``logits`` FP32[num_labels]. Weights are
random from a fixed seed unless the JAX package's are carried across with
:meth:`BertBackend.load_jax_params`, or restored from its checkpoint
(``engine.model.restoring``); :meth:`BertBackend.params_to_jax` gives
them back as its pytree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.checkpoint import leaf_tensor
from client_tpu_torch.engine.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorConfig,
)
from client_tpu_torch.engine.model import ModelBackend
from client_tpu_torch.models import register_model
from client_tpu_torch.ops import flash_attention as _flash

VOCAB_SIZE = 30522  # BERT wordpiece vocabulary size
_SEED = 768


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias2d: torch.Tensor) -> torch.Tensor:
    """O(S^2)-memory attention over ``[B, S, H, D]`` bf16 q/k/v, as the
    JAX package's einsum path computes it."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(q.shape[-1]) + bias2d[:, None, None, :].float()
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def split_qkv(qkv: torch.Tensor, heads: int, head_dim: int,
              head_major: bool = False):
    """q, k, v ``[B, S, heads, head_dim]`` of a fused projection ``[B, S,
    3 * heads * head_dim]``: qkv-major ``(3, heads, head_dim)`` columns, the
    default, or head-major ``(heads, 3, head_dim)``, the layout a tp split
    of the columns cuts into whole heads (``parallel/serving.py``)."""
    b, s, _ = qkv.shape
    if head_major:
        qkv = qkv.view(b, s, heads, 3, head_dim)
        return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    qkv = qkv.view(b, s, 3, heads, head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def head_major_perm(hidden: int, n_heads: int) -> torch.Tensor:
    """The fused QKV's column permutation from qkv-major to head-major:
    head-major column ``i`` is qkv-major column ``perm[i]``."""
    hd = hidden // n_heads
    i = torch.arange(3 * hidden)
    head, rem = i // (3 * hd), i % (3 * hd)
    which, d = rem // hd, rem % hd
    return which * hidden + head * hd + d


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's own
    default is the erf form)."""
    return F.gelu(x, approximate="tanh")


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(torch.bfloat16)


class BertLayer(nn.Module):
    def __init__(self, hidden: int, ffn: int):
        super().__init__()
        bf16 = torch.bfloat16
        self.wqkv = nn.Linear(hidden, 3 * hidden, dtype=bf16)
        self.wo = nn.Linear(hidden, hidden, dtype=bf16)
        self.ln1 = nn.LayerNorm(hidden, eps=1e-12)
        self.w1 = nn.Linear(hidden, ffn, dtype=bf16)
        self.w2 = nn.Linear(ffn, hidden, dtype=bf16)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-12)


class BertBackend(ModelBackend):
    """BERT encoder; by default BERT-base: 12 layers, hidden 768, 12 heads,
    FFN 3072. ``attention_impl`` is ``"einsum"`` or ``"flash"``."""

    def __init__(self, name: str = "bert_base", seq_len: int = 128,
                 hidden: int = 768, n_layers: int = 12, n_heads: int = 12,
                 ffn: int = 3072, num_labels: int = 2,
                 vocab: int = VOCAB_SIZE, max_batch_size: int = 16,
                 attention_impl: str = "einsum",
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        if attention_impl not in ("einsum", "flash"):
            raise ValueError(f"unknown attention_impl '{attention_impl}'")
        self.attention_impl = attention_impl
        self.attend = (_flash.flash_attention if attention_impl == "flash"
                       else einsum_attention)
        self.n_heads = n_heads
        self.head_dim = hidden // n_heads
        self.config = ModelConfig(
            name=name,
            max_batch_size=max_batch_size,
            input=[TensorConfig("input_ids", "INT32", [seq_len]),
                   TensorConfig("attention_mask", "INT32", [seq_len])],
            output=[TensorConfig("pooled_output", "FP32", [hidden]),
                    TensorConfig("logits", "FP32", [num_labels])],
            dynamic_batching=DynamicBatchingConfig(
                preferred_batch_size=[max(1, max_batch_size // 2),
                                      max_batch_size],
                max_queue_delay_microseconds=500),
            instance_count=2,
        )
        bf16 = torch.bfloat16
        # Built without storage, then filled once from the seeded generator.
        with torch.device("meta"):
            self.tok_embed = nn.Parameter(torch.empty(vocab, hidden, dtype=bf16))
            self.pos_embed = nn.Parameter(torch.empty(seq_len, hidden, dtype=bf16))
            self.embed_ln = nn.LayerNorm(hidden, eps=1e-12)
            self.layers = nn.ModuleList(BertLayer(hidden, ffn)
                                        for _ in range(n_layers))
            self.pooler = nn.Linear(hidden, hidden, dtype=bf16)
            self.classifier = nn.Linear(hidden, num_labels, dtype=bf16)
        self.load_or_init_params(
            lambda: self._init_params(torch.Generator().manual_seed(_SEED)))
        self.requires_grad_(False)
        self.to(device)
        if attention_impl == "flash" and device.type == "cuda":
            _flash.load_kernel()  # build now, not inside the first request

    @torch.no_grad()
    def _init_params(self, gen: torch.Generator) -> None:
        """Random init with the JAX backend's stds: N(0, 1/fan_in) dense
        weights, N(0, 0.02) embeddings, zero biases, unit LN scales."""
        def normal(p: nn.Parameter, std: float) -> None:
            p.copy_(torch.randn(p.shape, generator=gen) * std)

        normal(self.tok_embed, 0.02)
        normal(self.pos_embed, 0.02)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal(mod.weight, math.sqrt(1.0 / mod.in_features))
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return self.encode(inputs, self.attend)

    def encode(self, inputs: dict[str, torch.Tensor],
               attend) -> dict[str, torch.Tensor]:
        """The forward pass with the attention primitive given:
        ``attend(q, k, v, bias2d)`` over ``[B, S, H, D]`` -> ``[B, S, H, D]``."""
        ids = inputs["input_ids"]
        mask = inputs["attention_mask"].float()
        bias2d = (mask - 1.0) * 1e9  # 0 where attended, -1e9 where masked
        x = F.embedding(ids, self.tok_embed) + self.pos_embed[None]
        x = _layer_norm(x, self.embed_ln)
        for lp in self.layers:
            x = _layer_norm(x + self._attention(x, bias2d, lp, attend), lp.ln1)
            x = _layer_norm(x + self._ffn(x, lp), lp.ln2)
        cls = x[:, 0, :].float()
        pooled = torch.tanh(F.linear(cls, self.pooler.weight.float(),
                                     self.pooler.bias.float()))
        logits = F.linear(pooled, self.classifier.weight.float(),
                          self.classifier.bias.float())
        return {"pooled_output": pooled, "logits": logits}

    def _attention(self, x, bias2d, lp: BertLayer, attend) -> torch.Tensor:
        b, s, h = x.shape
        q, k, v = split_qkv(lp.wqkv(x), self.n_heads, self.head_dim)
        return lp.wo(attend(q, k, v, bias2d).reshape(b, s, h))

    def _ffn(self, x, lp: BertLayer) -> torch.Tensor:
        return lp.w2(gelu(lp.w1(x)))

    def load_jax_params(self, tree) -> None:
        """Take the JAX ``BertBackend``'s params (``make_apply_params()[1]``,
        leaves as numpy arrays or tensors) as this module's weights."""
        self.load_state_dict(params_from_jax(tree))

    def params_to_jax(self) -> dict:
        """This module's weights as the JAX ``BertBackend``'s params
        pytree, in its dtypes and shapes (the inverse of
        :func:`params_from_jax`)."""
        def dense(lin: nn.Linear) -> dict:
            return {"w": lin.weight.detach().T, "b": lin.bias.detach()}

        def ln(norm: nn.LayerNorm) -> dict:
            return {"scale": norm.weight.detach(), "bias": norm.bias.detach()}

        return {
            "tok_embed": self.tok_embed.detach(),
            "pos_embed": self.pos_embed.detach(),
            "embed_ln": ln(self.embed_ln),
            "layers": [{"wqkv": dense(lp.wqkv), "wo": dense(lp.wo),
                        "ln1": ln(lp.ln1), "w1": dense(lp.w1),
                        "w2": dense(lp.w2), "ln2": ln(lp.ln2)}
                       for lp in self.layers],
            "pooler": dense(self.pooler),
            "classifier": dense(self.classifier),
        }


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX BERT params pytree as this module's ``state_dict``. JAX dense
    layers compute ``x @ w`` with ``w: [in, out]``; ``nn.Linear`` keeps
    ``[out, in]``, so weights are transposed. LN ``scale`` is ``weight``."""
    t = leaf_tensor

    out = {"tok_embed": t(tree["tok_embed"]), "pos_embed": t(tree["pos_embed"])}

    def dense(prefix: str, p) -> None:
        out[f"{prefix}.weight"] = t(p["w"]).T.contiguous()
        out[f"{prefix}.bias"] = t(p["b"])

    def ln(prefix: str, p) -> None:
        out[f"{prefix}.weight"] = t(p["scale"])
        out[f"{prefix}.bias"] = t(p["bias"])

    ln("embed_ln", tree["embed_ln"])
    for i, lp in enumerate(tree["layers"]):
        for key in ("wqkv", "wo", "w1", "w2"):
            dense(f"layers.{i}.{key}", lp[key])
        ln(f"layers.{i}.ln1", lp["ln1"])
        ln(f"layers.{i}.ln2", lp["ln2"])
    dense("pooler", tree["pooler"])
    dense("classifier", tree["classifier"])
    return out


register_model("bert_base")(lambda device: BertBackend(device=device))
# Long-context variant: seq 2048, attention through the flash kernel so the
# [B, H, S, S] scores never reach device memory. Loaded by name only.
register_model("bert_long", default=False)(
    lambda device: BertBackend(name="bert_long", seq_len=2048,
                               max_batch_size=4, attention_impl="flash",
                               device=device))
