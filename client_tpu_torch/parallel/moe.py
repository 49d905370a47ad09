"""Mixture-of-experts with expert parallelism over the ``ep`` mesh axis.

Counterpart of ``client_tpu/parallel/moe.py``: Switch-style top-1 routing
with a fixed per-expert capacity, as one-hot dispatch/combine einsums over
static shapes, the MoE LM's forward, :func:`make_moe_train_step` and
:func:`dryrun_moe_step`. Tokens flatten in row order, so a padded row
queues behind the real tokens before it; a token past its expert's
capacity is dropped and rides the residual path.

The expert stacks ``w1`` ``[E, D, F]`` / ``w2`` ``[E, F, D]`` may be
tensors or :class:`~client_tpu_torch.parallel.mesh.Shards` placed by
:func:`_moe_specs` (experts over ``ep``, hidden over ``tp``): each
``(ep, tp)`` shard then runs its experts' FFN on its hidden slice, the
``tp`` partials are summed in shard order, and the ``ep`` shards' expert
outputs are joined, which is what GSPMD's resharding of the JAX einsums
computes. When ``ep`` spans processes, each process runs its own experts
on the dispatched tokens (the dispatch: ``mesh.vary``, whose backward sums
the processes' cotangents) and the expert outputs are all-gathered (the
combine), so routing, attention and the loss are the same in every
process. The router's gradient comes through ``gate`` alone: ``argmax``
carries none, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch.parallel.mesh import (
    P,
    Shards,
    all_gather,
    dp_map,
    place_with_specs,
    sum_in_order,
    vary,
)
from client_tpu_torch.parallel.training import (
    _attention,
    _mesh_on,
    _rms_norm,
    adamw_init,
    gelu,
    next_token_nll,
    train_step_of,
    tree_map,
)


def _expert_parts(w1, w2) -> list[tuple[int, list[tuple]]]:
    """(ep index, its tp pairs of (w1, w2) shards) for each ep shard this
    process holds; one pair at index 0 for tensors."""
    if not isinstance(w1, Shards):
        return [(0, [(w1, w2)])]
    return [(e, list(zip(w1.along("tp", ep=e), w2.along("tp", ep=e))))
            for e in w1.mesh.local("ep")]


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
    mesh = w1.mesh if isinstance(w1, Shards) else None
    if mesh is not None:
        # Each ep shard reads its experts' slots (across processes: its own).
        expert_in = vary(mesh, expert_in, "ep")
    outs = []
    e_loc = e // (mesh.axis_size("ep") if mesh is not None else 1)
    for i, row in _expert_parts(w1, w2):
        xin = expert_in[:, i * e_loc:(i + 1) * e_loc]
        outs.append(sum_in_order([
            torch.einsum("gecf,efd->gecd",
                         gelu(torch.einsum("gecd,edf->gecf", xin, a)), b)
            for a, b in row]))
    expert_out = (all_gather(mesh, outs, "ep", dim=1) if mesh is not None
                  else outs[0])

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


def make_moe_train_step(mesh, vocab=256, d_model=64, d_ff=128, n_layers=2,
                        n_heads=4, n_experts=None, capacity_factor=1.25,
                        batch=8, seq=16, lr=1e-3, aux_weight=1e-2,
                        params=None, weight_decay=1e-4):
    """Returns (params, opt_state, train_step, data_spec) for an MoE LM over
    a ``("dp", "ep", "tp")`` mesh. n_experts defaults to the ep axis size
    (one expert shard per device row); the expert capacity comes from
    ``batch`` and ``seq``, as in JAX, not from the tokens' shape. The loss
    is the next-token NLL plus ``aux_weight`` times the Switch auxiliary.
    ``params`` starts the run (a JAX-layout tree); by default the init
    seeded with 0. ``ep`` may span processes."""
    mesh.check_crossing(("ep",), "the MoE train step")
    if n_experts is None:
        n_experts = default_n_experts(mesh)
    tokens_total = batch * (seq - 1)
    capacity = int(np.ceil(tokens_total / n_experts * capacity_factor))
    device = mesh.device
    if params is None:
        params = _init_moe_params(torch.Generator().manual_seed(0), vocab,
                                  d_model, d_ff, n_layers, n_experts)
    params = tree_map(lambda x: x.detach().to(device, torch.float32),
                      params)
    specs = _moe_specs(P, n_layers)
    opt_state = adamw_init(params)

    def loss_fn(leaves, tokens):
        # The expert stacks are read per ep shard: each process's own.
        used = dict(leaves, layers=[
            {k: vary(mesh, v, "ep") if k in ("w1e", "w2e") else v
             for k, v in lp.items()} for lp in leaves["layers"]])
        logits, aux = _moe_forward(place_with_specs(mesh, used, specs),
                                   tokens[:, :-1], n_heads, capacity, mesh)
        return next_token_nll(logits, tokens[:, 1:]) + aux_weight * aux

    return (params, opt_state, train_step_of(loss_fn, lr, weight_decay,
                                             device), P("dp", None))


def dryrun_moe_case(n_devices: int, batch=8, seq=16, device=None):
    """The dry run's ``(params, opt, train_step, tokens)``: a ``("dp",
    "ep", "tp")`` mesh (``n_devices`` shards repeating ``device``, None:
    the card), the MoE train step and seeded tokens ``[batch, seq]``."""
    mesh = _mesh_on(n_devices, ("dp", "ep", "tp"), device)
    params, opt, step, _ = make_moe_train_step(mesh, batch=batch, seq=seq)
    tokens = np.random.default_rng(0).integers(0, 256, size=(batch, seq))
    return params, opt, step, tokens


def dryrun_moe_step(n_devices: int, batch=8, seq=16,
                    device=None) -> float:
    """Run ONE MoE train step of :func:`dryrun_moe_case`, return its loss
    (finite)."""
    params, opt, step, tokens = dryrun_moe_case(n_devices, batch, seq,
                                                device)
    params, opt, loss = step(params, opt, tokens)
    loss = float(loss)
    assert np.isfinite(loss), "MoE step produced non-finite loss"
    return loss
