"""Pipeline parallelism: GPipe-style microbatched stages over the ``pp`` axis.

Counterpart of ``client_tpu/parallel/pipeline.py``. Transformer blocks are
stacked on a leading layer axis split over ``pp`` (:func:`_stacked_specs`),
so each stage holds ``n_layers / pp`` consecutive blocks on its device.
:func:`pipeline_apply` runs the GPipe tick schedule: ``M + pp - 1`` ticks;
at tick ``t`` stage ``s`` applies its blocks to microbatch ``t - s`` and
hands the result to stage ``s + 1`` with ``mesh.ppermute``; the last stage
collects the outputs, and every stage gets them. The batch
inside each microbatch stays split over ``dp``.

Within a process the port skips a stage with no microbatch in flight,
which leaves every output as it is. When ``pp`` spans processes every
stage computes on every tick and the bubbles are masked out
(``torch.where``), as JAX does: the schedule is then one graph whose
shape does not depend on the stage, so every process runs the ring's
exchanges, forward and backward, in the same order, and autograd
differentiates through them (:func:`make_pipeline_train_step`).
"""

from __future__ import annotations

import numpy as np
import torch

from client_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    Shards,
    all_gather,
    place,
    place_with_specs,
    ppermute,
    split,
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

BLOCK_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def _init_stacked_params(gen: torch.Generator, vocab, d_model, d_ff,
                         n_layers):
    """N(0, 0.02) weights from ``gen``, drawn in the JAX init's key order."""
    scale = 0.02

    def norm(*shape):
        return torch.randn(shape, generator=gen) * scale

    return {
        "embed": norm(vocab, d_model),
        "unembed": norm(d_model, vocab),
        # blocks stacked on a leading layer axis — split over pp
        "wq": norm(n_layers, d_model, d_model),
        "wk": norm(n_layers, d_model, d_model),
        "wv": norm(n_layers, d_model, d_model),
        "wo": norm(n_layers, d_model, d_model),
        "w1": norm(n_layers, d_model, d_ff),
        "w2": norm(n_layers, d_ff, d_model),
    }


def _stacked_specs(P):
    stage = P("pp", None, None)
    return {
        "embed": P(None, None),
        "unembed": P(None, None),
        "wq": stage, "wk": stage, "wv": stage, "wo": stage,
        "w1": stage, "w2": stage,
    }


def _block(lp, x, n_heads, mask):
    """One pre-norm transformer block. lp holds unstacked [D,D]/[D,F] mats."""
    x = x + _attention(lp, x, n_heads, mask)
    h = _rms_norm(x)
    return x + gelu(h @ lp["w1"]) @ lp["w2"]


def _stage_fn(stacked, x, n_heads, mask):
    """Apply this stage's local slice of blocks, in layer order."""
    for i in range(stacked["wq"].shape[0]):
        x = _block({k: stacked[k][i] for k in BLOCK_KEYS}, x, n_heads, mask)
    return x


def pipeline_apply(mesh: Mesh, stacked, x_mb, n_heads, mask):
    """Run ``[M, mb, S, D]`` microbatches through pp-split stages.

    ``stacked`` maps the block keys to ``[n_layers, ...]`` tensors, or to
    :class:`Shards` already placed over ``pp``. At tick ``t`` stage ``s``
    holds microbatch ``t - s`` (when ``0 <= t - s < M``): stage 0 reads
    ``x_mb[t]``, every other stage what its predecessor sent it last tick,
    and the last stage's results are the outputs. Within a process a stage
    with no microbatch in flight is skipped; when ``pp`` spans processes
    every stage computes on every tick, the bubbles masked out, and the
    last stage's outputs are gathered from the process that holds it."""
    n_stages = mesh.shape["pp"]
    placed = {k: v if isinstance(v, Shards) else place(mesh, v, ("pp",))
              for k, v in stacked.items()}
    mine = list(mesh.local("pp"))
    stages = [{k: v.part(pp=s) for k, v in placed.items()} for s in mine]
    masked = mesh.crosses("pp")
    if masked:
        # Stage 0 alone reads the input.
        x_mb = vary(mesh, x_mb, "pp")
        first = [torch.tensor(s == 0, device=x_mb.device) for s in mine]
    outs = []
    for x_local in split(mesh, x_mb, 1, "dp"):   # [M, mb / dp, S, D]
        m_count = x_local.shape[0]
        state = [torch.zeros_like(x_local[0]) for _ in mine]
        outputs = [[] for _ in mine]
        for t in range(m_count + n_stages - 1):
            if masked:
                x_t = x_local[min(t, m_count - 1)]
                ys = [_stage_fn(stage, torch.where(f, x_t, st), n_heads,
                                mask)
                      for stage, f, st in zip(stages, first, state)]
            else:
                ys = [_stage_fn(stage, x_local[t] if s == 0 else st,
                                n_heads, mask)
                      if 0 <= t - s < m_count else st  # a bubble
                      for s, stage, st in zip(mine, stages, state)]
            if t >= n_stages - 1:
                for out, y in zip(outputs, ys):
                    out.append(y)
            state = ppermute(mesh, ys, "pp")
        outputs = [torch.stack(out) for out in outputs]
        if masked:  # the last stage's outputs, from the process holding it
            outs.append(all_gather(mesh, [o[None] for o in outputs],
                                   "pp")[n_stages - 1])
        else:
            outs.append(outputs[-1])
    return all_gather(mesh, outs, "dp", dim=1)


def reference_forward(params, x_mb, n_heads, mask):
    """Sequential (unpipelined) oracle: apply every block in order."""
    x = x_mb
    for i in range(params["wq"].shape[0]):
        x = _block({k: params[k][i] for k in BLOCK_KEYS}, x, n_heads, mask)
    return x


def make_pipeline_train_step(mesh: Mesh, vocab=256, d_model=64, d_ff=128,
                             n_layers=4, n_heads=4, lr=1e-3, params=None,
                             weight_decay=1e-4):
    """Returns (params, opt_state, train_step, shard_fn) for LM training
    with pp-split blocks; embed/unembed replicated outside the pipeline.
    ``params`` starts the run (a JAX-layout tree); by default the init
    seeded with 0.

    ``train_step(params, opt, tokens)`` expects tokens ``[M, mb, S+1]``
    from ``shard_fn`` — the microbatch count M and size mb come from the
    tokens' shape (mb must divide by the dp axis) — and returns ``(params,
    opt, loss)``; ``pp`` may span processes (autograd runs through the
    ppermute ring's exchanges)."""
    mesh.check_crossing(("pp",), "the pipeline train step")
    n_stages = mesh.shape["pp"]
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by pp={n_stages}")
    device = mesh.device
    if params is None:
        params = _init_stacked_params(torch.Generator().manual_seed(0),
                                      vocab, d_model, d_ff, n_layers)
    params = tree_map(lambda x: x.detach().to(device, torch.float32),
                      params)
    specs = _stacked_specs(P)
    opt_state = adamw_init(params)

    def loss_fn(leaves, tokens):
        # Each process updates the blocks of every stage: its own stages'
        # gradients, and zeros for the others', summed over the processes.
        used = {k: vary(mesh, v, "pp") if k in BLOCK_KEYS else v
                for k, v in leaves.items()}
        placed = place_with_specs(mesh, used, specs)
        inp, tgt = tokens[..., :-1], tokens[..., 1:]
        seq = inp.shape[-1]
        mask = torch.ones(seq, seq, dtype=torch.bool, device=device).tril()
        x = placed["embed"].part()[inp]                     # [M, mb, S, D]
        x = pipeline_apply(mesh, {k: placed[k] for k in BLOCK_KEYS}, x,
                           n_heads, mask)
        logits = _rms_norm(x) @ placed["unembed"].part()
        return next_token_nll(logits, tgt)

    def shard_fn(tokens):
        dp = mesh.axis_size("dp")
        if tokens.shape[1] % dp:
            raise ValueError(
                f"microbatch size {tokens.shape[1]} must divide by dp ({dp})")
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(
            device)

    return (params, opt_state, train_step_of(loss_fn, lr, weight_decay),
            shard_fn)


def dryrun_pipeline_case(n_devices: int, microbatches=4, seq=16,
                         device=None):
    """The dry run's ``(params, opt, train_step, tokens)``: a ``("dp",
    "pp")`` mesh (``n_devices`` shards repeating ``device``, None: the
    card), the pipelined train step and seeded tokens ``[microbatches,
    2 * dp, seq + 1]``."""
    mesh = _mesh_on(n_devices, ("dp", "pp"), device)
    n_stages = mesh.shape["pp"]
    mb = 2 * mesh.axis_size("dp")  # microbatch rows must divide by dp
    params, opt, step, shard_fn = make_pipeline_train_step(
        mesh, n_layers=n_stages * max(1, 4 // n_stages))
    tokens = shard_fn(np.random.default_rng(0).integers(
        0, 256, size=(microbatches, mb, seq + 1)))
    return params, opt, step, tokens


def dryrun_pipeline_step(n_devices: int, microbatches=4, seq=16,
                         device=None) -> float:
    """Run ONE pipelined train step of :func:`dryrun_pipeline_case`,
    return its loss (finite)."""
    params, opt, step, tokens = dryrun_pipeline_case(
        n_devices, microbatches, seq, device)
    params, opt, loss = step(params, opt, tokens)
    loss = float(loss)
    assert np.isfinite(loss), "pipeline step produced non-finite loss"
    return loss
