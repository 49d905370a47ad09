"""Pipeline parallelism: GPipe-style microbatched stages over the ``pp`` axis.

Counterpart of the forward of ``client_tpu/parallel/pipeline.py`` (the
train step is not ported yet). Transformer blocks are stacked on a leading
layer axis split over ``pp`` (:func:`_stacked_specs`), so each stage holds
``n_layers / pp`` consecutive blocks on its device. :func:`pipeline_apply`
runs the GPipe tick schedule: ``M + pp - 1`` ticks; at tick ``t`` stage
``s`` applies its blocks to microbatch ``t - s`` and hands the result to
stage ``s + 1`` with ``mesh.ppermute``; the last stage collects the
outputs. The batch inside each microbatch stays split over ``dp``.

JAX computes every stage on every tick and masks the bubbles out; the port
skips a stage with no microbatch in flight, which leaves every output as
it is.
"""

from __future__ import annotations

import torch

from client_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    all_gather,
    place,
    ppermute,
    split,
)
from client_tpu_torch.parallel.training import _attention, _rms_norm, gelu

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
    and the last stage's results are the outputs."""
    n_stages = mesh.shape["pp"]
    placed = {k: v if isinstance(v, Shards) else place(mesh, v, ("pp",))
              for k, v in stacked.items()}
    stages = [{k: v.part(pp=s) for k, v in placed.items()}
              for s in range(n_stages)]
    outs = []
    for x_local in split(mesh, x_mb, 1, "dp"):   # [M, mb / dp, S, D]
        m_count = x_local.shape[0]
        state = [torch.zeros_like(x_local[0])] * n_stages
        outputs = [None] * m_count
        for t in range(m_count + n_stages - 1):
            ys = []
            for s in range(n_stages):
                if 0 <= t - s < m_count:
                    x_in = x_local[t] if s == 0 else state[s]
                    ys.append(_stage_fn(stages[s], x_in, n_heads, mask))
                else:  # a bubble: nothing in flight on this stage
                    ys.append(state[s])
            idx = t - (n_stages - 1)
            if 0 <= idx < m_count:
                outputs[idx] = ys[-1]
            state = ppermute(mesh, ys, "pp")
        outs.append(torch.stack(outputs))
    return all_gather(mesh, outs, "dp", dim=1)


def reference_forward(params, x_mb, n_heads, mask):
    """Sequential (unpipelined) oracle: apply every block in order."""
    x = x_mb
    for i in range(params["wq"].shape[0]):
        x = _block({k: params[k][i] for k in BLOCK_KEYS}, x, n_heads, mask)
    return x
