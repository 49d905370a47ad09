"""Mixture-of-experts with expert parallelism over the ``ep`` mesh axis.

Counterpart of the forward of ``client_tpu/parallel/moe.py`` (the train
step is not ported yet): Switch-style top-1 routing with a fixed
per-expert capacity, as one-hot dispatch/combine einsums over static
shapes. Tokens flatten in row order, so a padded row queues behind the
real tokens before it; a token past its expert's capacity is dropped and
rides the residual path.

The expert stacks ``w1`` ``[E, D, F]`` / ``w2`` ``[E, F, D]`` may be
tensors or :class:`~client_tpu_torch.parallel.mesh.Shards` placed by
:func:`_moe_specs` (experts over ``ep``, hidden over ``tp``): each
``(ep, tp)`` shard then runs its experts' FFN on its hidden slice, the
``tp`` partials are summed in shard order, and the ``ep`` shards' expert
outputs are joined, which is what GSPMD's resharding of the JAX einsums
computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from client_tpu_torch.parallel.mesh import Shards, dp_map, sum_in_order
from client_tpu_torch.parallel.training import _attention, _rms_norm, gelu


def _expert_parts(w1, w2) -> list[list[tuple[torch.Tensor, torch.Tensor]]]:
    """``[ep][tp]`` pairs of (w1, w2) shards (one pair for tensors)."""
    if not isinstance(w1, Shards):
        return [[(w1, w2)]]
    return [list(zip(w1.along("tp", ep=e), w2.along("tp", ep=e)))
            for e in range(len(w1.along("ep")))]


def moe_groups(flat, router_w, w1, w2, capacity: int):
    """Top-1 routed expert FFN over ``G`` independent token groups.

    flat: [G, T, D]; router_w: [D, E]; w1: [E, D, F]; w2: [E, F, D].
    Each group routes and queues alone, with ``capacity`` slots per
    expert. Returns (y [G, T, D], aux [G])."""
    e = router_w.shape[1]
    logits = flat @ router_w                                  # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    gate = torch.amax(probs, dim=-1)                          # [G, T]
    expert = torch.argmax(probs, dim=-1)  # the first maximal, as jnp's
    onehot = F.one_hot(expert, e).to(flat.dtype)              # [G, T, E]

    # position of each token within its expert's queue; overflow is dropped
    pos = (torch.cumsum(onehot, dim=1) - 1.0) * onehot        # [G, T, E]
    keep = torch.where(pos < capacity, onehot, torch.zeros_like(onehot))
    slot = torch.sum(pos * keep, dim=-1).to(torch.int64)      # [G, T]
    slot_oh = F.one_hot(slot, capacity).to(flat.dtype)        # [G, T, C]
    dispatch = keep[..., None] * slot_oh[:, :, None, :]       # [G, T, E, C]

    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, flat)  # [G, E, C, D]
    outs = []
    shards = _expert_parts(w1, w2)
    e_loc = e // len(shards)
    for i, row in enumerate(shards):
        xin = expert_in[:, i * e_loc:(i + 1) * e_loc]
        outs.append(sum_in_order([
            torch.einsum("gecf,efd->gecd",
                         gelu(torch.einsum("gecd,edf->gecf", xin, a)), b)
            for a, b in row]))
    expert_out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    combine = dispatch * gate[..., None, None]                 # [G, T, E, C]
    y = torch.einsum("gtec,gecd->gtd", combine, expert_out)
    # Switch load-balancing auxiliary: E * sum_e fraction_e * mean_prob_e
    aux = e * torch.sum(torch.mean(onehot, dim=1) * torch.mean(probs, dim=1),
                        dim=-1)
    return y, aux


def moe_ffn(x, router_w, w1, w2, capacity):
    """Top-1 routed expert FFN.

    x: [B, S, D]; router_w: [D, E]; w1: [E, D, F]; w2: [E, F, D].
    Returns (y [B, S, D], aux_loss scalar). Tokens queue in row order
    over the whole ``[B * S]``."""
    b, s, d = x.shape
    y, aux = moe_groups(x.reshape(1, b * s, d), router_w, w1, w2, capacity)
    return y.reshape(b, s, d), aux[0]


def default_n_experts(mesh) -> int:
    """Shared train/serve policy: one expert shard per ep row (min 2)."""
    return max(2, int(mesh.shape.get("ep", 1)))


def _init_moe_params(gen: torch.Generator, vocab, d_model, d_ff, n_layers,
                     n_experts):
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
            "router": norm(d_model, n_experts),
            "w1e": norm(n_experts, d_model, d_ff),
            "w2e": norm(n_experts, d_ff, d_model),
        })
    return params


def _moe_specs(P, n_layers):
    layer = {
        "wq": P(None, "tp"), "wk": P(None, "tp"), "wv": P(None, "tp"),
        "wo": P("tp", None),
        "router": P(None, None),
        "w1e": P("ep", None, "tp"),
        "w2e": P("ep", "tp", None),
    }
    return {
        "embed": P(None, None),
        "unembed": P(None, None),
        "layers": [dict(layer) for _ in range(n_layers)],
    }


def _whole(leaf) -> torch.Tensor:
    return leaf.part() if isinstance(leaf, Shards) else leaf


def _moe_forward(params, tokens, n_heads, capacity, mesh):
    """(logits [B, S, V], aux) for int ``tokens`` ``[B, S]``. Attention runs
    per ``dp`` shard of ``mesh``'s batch (heads over ``tp``; None: no
    mesh); the experts route every token of the batch together, as the JAX
    forward's global dispatch does."""
    x = _whole(params["embed"])[tokens.long()]               # [B, S, D]
    s = x.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    aux_total = 0.0
    for lp in params["layers"]:
        x = x + dp_map(mesh, lambda xs, lp=lp: _attention(
            lp, xs, n_heads, mask), x)
        y, aux = moe_ffn(_rms_norm(x), _whole(lp["router"]), lp["w1e"],
                         lp["w2e"], capacity)
        aux_total = aux_total + aux
        x = x + y
    x = _rms_norm(x)
    return x @ _whole(params["unembed"]), aux_total
