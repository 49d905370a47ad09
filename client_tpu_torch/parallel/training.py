"""The compact transformer LM of the sharded training step: its forward.

Counterpart of the forward pieces of ``client_tpu/parallel/training.py``
(the train step and its dry run are not ported yet): RMS norm, causal
multi-head attention, the seeded init, the tp partition specs and the
forward over a ``("dp", "sp", "tp")`` mesh. Products are ``x @ w`` with
``w: [in, out]``, fp32, tanh GELU, as in JAX.

A layer's weights are tensors, or :class:`~client_tpu_torch.parallel.mesh
.Shards` placed by :func:`_param_specs`: then attention runs per ``tp``
shard on that shard's heads (``wq`` / ``wk`` / ``wv`` split by columns)
and the row-split ``wo`` partials are summed in shard order, as GSPMD
partitions the JAX forward; the FFN likewise over its hidden dim. The
JAX forward's sharding constraints (``constrain``) change no element, so
the port's forwards take the mesh itself in their place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from client_tpu_torch.parallel.mesh import Shards, dp_map, sum_in_order

_NEG_INF = -1e30


def tp_parts(leaf) -> list[torch.Tensor]:
    """A weight's shards along ``tp``, in order ([leaf] for a tensor)."""
    return leaf.along("tp") if isinstance(leaf, Shards) else [leaf]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _init_params(gen: torch.Generator, vocab, d_model, d_ff, n_layers):
    """N(0, 0.02) weights from ``gen``, drawn in the JAX init's key order."""
    scale = 0.02

    def norm(*shape):
        return torch.randn(shape, generator=gen) * scale

    params = {"embed": norm(vocab, d_model), "unembed": norm(d_model, vocab),
              "layers": []}
    for _ in range(n_layers):
        params["layers"].append({
            "wq": norm(d_model, d_model), "wk": norm(d_model, d_model),
            "wv": norm(d_model, d_model), "wo": norm(d_model, d_model),
            "w1": norm(d_model, d_ff), "w2": norm(d_ff, d_model),
        })
    return params


def _param_specs(P, n_layers):
    layer = {
        # attention projections: split heads (output features) over tp
        "wq": P(None, "tp"),
        "wk": P(None, "tp"),
        "wv": P(None, "tp"),
        "wo": P("tp", None),
        # FFN: hidden dimension over tp (column then row split)
        "w1": P(None, "tp"),
        "w2": P("tp", None),
    }
    return {
        "embed": P(None, "tp"),
        "unembed": P("tp", None),
        "layers": [dict(layer) for _ in range(n_layers)],
    }


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True)
                                 + 1e-6))


def _attention(lp, x, n_heads, mask):
    """Causal multi-head attention sublayer (pre-norm, residual applied by
    the caller): returns attn(x_normed) @ wo. ``mask`` is a bool ``[S,
    S]``. With ``tp``-placed weights each shard attends over its own heads
    and the ``wo`` partials are summed."""
    b, s, d = x.shape
    head_dim = d // n_heads
    h = _rms_norm(x)
    shards = [tp_parts(lp[k]) for k in ("wq", "wk", "wv", "wo")]
    if shards[0][0].shape[1] % head_dim:
        # A column split that cuts a head: the shards are gathered whole
        # (GSPMD reshards the same way).
        shards = [[_gathered(lp[k], "tp", dim)] for k, dim in
                  (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0))]
    partials = []
    for wq, wk, wv, wo in zip(*shards):
        q = (h @ wq).reshape(b, s, -1, head_dim)
        k = (h @ wk).reshape(b, s, -1, head_dim)
        v = (h @ wv).reshape(b, s, -1, head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim)
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        partials.append(attn.reshape(b, s, -1) @ wo)
    return sum_in_order(partials)


def _ffn(lp, x):
    """gelu(rms(x) @ w1) @ w2, per ``tp`` shard of the hidden dim."""
    h = _rms_norm(x)
    return sum_in_order([gelu(h @ w1) @ w2 for w1, w2 in
                         zip(tp_parts(lp["w1"]), tp_parts(lp["w2"]))])


def _gathered(leaf, axis: str, dim: int) -> torch.Tensor:
    """A leaf whole again: its shards along ``axis`` joined on ``dim``."""
    if not isinstance(leaf, Shards):
        return leaf
    return torch.cat(leaf.along(axis), dim=dim)


def _forward(params, tokens, n_heads, mesh):
    """Logits ``[B, S, V]`` for int ``tokens`` ``[B, S]``; the batch runs
    per ``dp`` shard of ``mesh`` (when it has one; None: no mesh)."""

    # The embedding is split by its columns over tp: a lookup reads every
    # shard's columns of the row, which is the row.
    embed = _gathered(params["embed"], "tp", 1)
    unembed = tp_parts(params["unembed"])

    def shard(toks):
        x = embed[toks.long()]
        s = x.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        for lp in params["layers"]:
            x = x + _attention(lp, x, n_heads, mask)
            x = x + _ffn(lp, x)
        x = _rms_norm(x)
        d_t = x.shape[-1] // len(unembed)
        return sum_in_order([x[..., t * d_t:(t + 1) * d_t] @ u
                             for t, u in enumerate(unembed)])

    return dp_map(mesh, shard, tokens)
