"""The compact transformer LM of the sharded training step, its AdamW and
its train step.

Counterpart of ``client_tpu/parallel/training.py``: RMS norm, causal
multi-head attention, the seeded init, the tp partition specs, the forward
over a ``("dp", "sp", "tp")`` mesh, :func:`make_train_step` and
:func:`dryrun_training_step`. Products are ``x @ w`` with ``w: [in,
out]``, fp32, tanh GELU, as in JAX.

A layer's weights are tensors, or :class:`~client_tpu_torch.parallel.mesh
.Shards` placed by :func:`_param_specs`: then attention runs per ``tp``
shard on that shard's heads (``wq`` / ``wk`` / ``wv`` split by columns)
and the row-split ``wo`` partials are summed in shard order, as GSPMD
partitions the JAX forward; the FFN likewise over its hidden dim. The
JAX forward's sharding constraints (``constrain``) change no element, so
the port's forwards take the mesh itself in their place.

The train steps (this module's, ``pipeline.make_pipeline_train_step`` and
``moe.make_moe_train_step``) keep their parameters as whole fp32 tensors
on the mesh's device, one set per process: each step places views of
them, differentiates the loss with autograd (through the mesh's
exchanges when an axis spans processes), and updates them with
:func:`adamw_update`, optax's ``adamw`` with its defaults (b1 0.9, b2
0.999, eps 1e-8, weight decay 1e-4 on every leaf). Every process ends a
step with the same whole parameters. The optimizer state starts at zero,
as optax's does, so a run from weights carried over from JAX
(:func:`params_from_jax`) takes the JAX run's steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    Shards,
    dp_map,
    make_mesh,
    place_with_specs,
    sum_in_order,
    vary,
)

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


# -- the train step -----------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts and lists (the JAX pytrees of
    the train steps), the structure kept."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def params_from_jax(tree, device=None) -> dict:
    """A train step's params pytree of the JAX package (numpy or tensor
    leaves; ``_init_params``, ``_init_moe_params``, ``_init_stacked_params``)
    as the port's: fp32 tensors on ``device`` (None: cuda), the same
    structure and layout."""
    device = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(
        np.asarray(x, dtype=np.float32)).to(device), tree)


def adamw_init(params) -> dict:
    """optax's ``adamw`` state: the step count and the two moments, zero."""
    return {"count": 0, "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


@torch.no_grad()
def adamw_update(params, grads, opt: dict, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
    """One step of optax's ``adamw(lr)``, in its order of operations:
    moments ``(1 - b) g^k + b m``, bias correction in fp32, ``m / (sqrt(v)
    + eps)``, plus ``weight_decay * p`` on every leaf, times ``-lr``, added
    to ``p``. Returns (new params, new state)."""
    count = opt["count"] + 1

    def correction(b, like):
        return 1.0 - torch.tensor(b, dtype=torch.float32,
                                  device=like.device) ** count

    mu = tree_map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, opt["mu"])
    nu = tree_map(lambda g, v: (1.0 - b2) * (g * g) + b2 * v, grads,
                  opt["nu"])

    def step(p, m, v):
        m_hat = m / correction(b1, m)
        v_hat = v / correction(b2, v)
        u = m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p
        return p + (-lr) * u

    return (tree_map(step, params, mu, nu),
            {"count": count, "mu": mu, "nu": nu})


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """The mean of ``-log softmax(logits)[target]``, as the JAX loss."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, targets.long()[..., None],
                                 dim=-1).mean()


def grad_step(params, loss_fn, opt: dict, lr: float,
              weight_decay: float = 1e-4):
    """``(params, opt, loss)`` after one AdamW step on ``loss_fn(leaves)``
    (which places the leaves itself), with every leaf's gradient. Returns
    also the gradients (for the tests and the chip check)."""
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                    allow_unused=True)
    flat = iter(grads)
    grads = tree_map(lambda x: next(flat), leaves)
    grads = tree_map(lambda g, x: torch.zeros_like(x) if g is None else g,
                     grads, leaves)
    new, opt = adamw_update(tree_map(torch.Tensor.detach, leaves), grads,
                            opt, lr, weight_decay=weight_decay)
    return new, opt, loss.detach(), grads


def train_step_of(loss_fn, lr: float, weight_decay: float, device=None):
    """``train_step(params, opt, tokens)`` -> ``(params, opt, loss)``: one
    AdamW step (:func:`grad_step`) on ``loss_fn(leaves, tokens)``, keeping
    the gradients it applied in ``train_step.last_grads``. With a
    ``device`` the tokens (numpy or torch) become int64 there first."""

    def train_step(p, opt, tokens):
        if device is not None:
            tokens = torch.as_tensor(np.asarray(tokens.cpu() if isinstance(
                tokens, torch.Tensor) else tokens), dtype=torch.int64).to(
                    device)
        p, opt, loss, grads = grad_step(
            p, lambda leaves: loss_fn(leaves, tokens), opt, lr,
            weight_decay)
        train_step.last_grads = grads
        return p, opt, loss

    return train_step


def _mesh_on(n_devices: int, axes, device) -> Mesh:
    """A mesh of ``n_devices`` shards that repeat ``device`` (None: the
    card)."""
    device = resolve_device(device)
    return make_mesh(n_devices, axes=axes, devices=[device] * n_devices)


def make_train_step(mesh: Mesh, vocab=256, d_model=128, d_ff=256,
                    n_layers=2, n_heads=4, lr=1e-3, params=None,
                    weight_decay=1e-4):
    """Returns (params, opt_state, train_step, data_spec) for the LM over a
    ``("dp", "sp", "tp")`` mesh. ``params`` starts the run (a JAX-layout
    tree, :func:`params_from_jax`); by default the init seeded with 0.

    ``train_step(params, opt, tokens)`` takes int tokens ``[B, S + 1]``
    (the whole batch, in every process), returns ``(params, opt, loss)``
    and keeps the gradients it applied in ``train_step.last_grads``.
    ``dp`` may span processes: each runs its own rows' forward, the
    logits are gathered, and the parameters, replicated over ``dp``, take
    the sum of the processes' gradients (``mesh.vary``)."""
    mesh.check_crossing(("dp",), "the dp x sp x tp train step")
    device = mesh.device
    if params is None:
        params = _init_params(torch.Generator().manual_seed(0), vocab,
                              d_model, d_ff, n_layers)
    params = tree_map(lambda x: x.detach().to(device, torch.float32),
                      params)
    specs = _param_specs(P, n_layers)
    opt_state = adamw_init(params)

    def loss_fn(leaves, tokens):
        used = tree_map(lambda x: vary(mesh, x, "dp"), leaves)
        logits = _forward(place_with_specs(mesh, used, specs),
                          tokens[:, :-1], n_heads, mesh)
        return next_token_nll(logits, tokens[:, 1:])

    return (params, opt_state, train_step_of(loss_fn, lr, weight_decay,
                                             device), P("dp", None))


def dryrun_training_case(n_devices: int, batch=8, seq=32, mesh=None,
                         device=None):
    """The dry run's ``(params, opt, train_step, tokens)``: the mesh
    (``n_devices`` shards repeating ``device``, None: the card), the
    default train step and seeded tokens ``[batch, seq]``.

    ``mesh`` overrides the auto-built one — the multihost test passes a
    global mesh spanning several processes' devices."""
    if mesh is None:
        mesh = _mesh_on(n_devices, ("dp", "sp", "tp"), device)
    params, opt_state, train_step, _ = make_train_step(mesh)
    tokens = np.random.default_rng(0).integers(0, 256, size=(batch, seq))
    return params, opt_state, train_step, tokens


def dryrun_training_step(n_devices: int, batch=8, seq=32, mesh=None,
                         device=None) -> float:
    """Run ONE train step of :func:`dryrun_training_case`, return its loss
    (finite)."""
    params, opt_state, train_step, tokens = dryrun_training_case(
        n_devices, batch, seq, mesh, device)
    params, opt_state, loss = train_step(params, opt_state, tokens)
    loss = float(loss)
    assert np.isfinite(loss), "training step produced non-finite loss"
    return loss
