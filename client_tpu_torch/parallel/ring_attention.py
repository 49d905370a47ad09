"""Ring attention: exact attention over a sequence-sharded mesh axis.

Counterpart of ``client_tpu/parallel/ring_attention.py``. Each ``sp``
shard keeps its Q; the K/V (and key mask) blocks rotate one hop right
around the ring per step (``mesh.ppermute``) while every shard folds the
visiting block into a flash-style online softmax ``(m, l, acc)`` in fp32,
with the JAX version's ``-1e30`` guards. At step ``i`` shard ``j`` holds
block ``(j - i) mod n``; the fold order is JAX's, so the float rounding
is too. The full ``[S, S]`` score matrix never exists.

Plain PyTorch, as the JAX version is ``jnp`` under ``shard_map`` and no
Pallas kernel. The port drives the shards in turn from the calling thread
(``parallel/mesh.py``).
"""

from __future__ import annotations

import math

import torch

from client_tpu_torch.parallel.mesh import Mesh, all_gather, ppermute, split

_NEG_INF = -1e30


def _block_attend(q, k, v, bias, m, l, acc, scale):
    """Fold one visiting K/V block into the online-softmax state.

    q: [B, Sq, H, D]; k/v: [B, Sk, H, D]; bias: [B, Sk];
    m/l: [B, Sq, H, 1]; acc: [B, Sq, H, D] fp32.
    """
    s = torch.einsum("bqhd,bkhd->bqhk", q, k).float() * scale
    s = s + bias[:, None, None, :].float()

    m_cur = torch.amax(s, dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    safe_m = torch.where(m_new <= _NEG_INF, torch.zeros_like(m_new), m_new)
    p = torch.exp(torch.where(s <= _NEG_INF, torch.full_like(s, -math.inf),
                              s) - safe_m)
    corr = torch.where(m <= _NEG_INF, torch.zeros_like(m),
                       torch.exp(m - safe_m))
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum(
        "bqhk,bkhd->bqhd", p.to(v.dtype), v).float()
    return m_new, l_new, acc_new


def ring_attention(mesh: Mesh, q: list, k: list, v: list, bias: list,
                   axis_name: str) -> list[torch.Tensor]:
    """Exact attention with the sequence axis sharded over ``axis_name``.

    q/k/v are the shards' local blocks ``[B, S_local, H, D]`` and bias
    their additive key masks ``[B, S_local]``, one per shard in shard
    order. Returns each shard's output block."""
    n = len(q)
    scale = 1.0 / math.sqrt(q[0].shape[-1])
    state = []
    for qj in q:
        b, sq, h, d = qj.shape
        state.append((
            torch.full((b, sq, h, 1), _NEG_INF, dtype=torch.float32,
                       device=qj.device),
            torch.zeros((b, sq, h, 1), dtype=torch.float32, device=qj.device),
            torch.zeros((b, sq, h, d), dtype=torch.float32, device=qj.device)))
    k_blk, v_blk, bias_blk = list(k), list(v), list(bias)
    for i in range(n):
        state = [_block_attend(q[j], k_blk[j], v_blk[j], bias_blk[j], *state[j],
                               scale) for j in range(n)]
        if i + 1 < n:  # the last fold needs no send
            k_blk = ppermute(mesh, k_blk, axis_name)
            v_blk = ppermute(mesh, v_blk, axis_name)
            bias_blk = ppermute(mesh, bias_blk, axis_name)
    out = []
    for qj, (_m, l, acc) in zip(q, state):
        denom = torch.where(l == 0.0, torch.ones_like(l), l)
        out.append((acc / denom).to(qj.dtype))
    return out


def sequence_parallel_attention(mesh: Mesh, q, k, v, bias,
                                axis_name: str = "sp") -> torch.Tensor:
    """Global ``[B, S, H, D]`` q/k/v with S split over ``axis_name``, bias
    ``[B, S]``; returns the global output. The batch stays split over
    ``dp`` when the mesh has it: each ``dp`` shard runs its own ring."""
    outs = []
    for qb, kb, vb, bb in zip(*(split(mesh, t, 0, "dp")
                                for t in (q, k, v, bias))):
        parts = ring_attention(
            mesh, split(mesh, qb, 1, axis_name), split(mesh, kb, 1, axis_name),
            split(mesh, vb, 1, axis_name), split(mesh, bb, 1, axis_name),
            axis_name)
        outs.append(all_gather(mesh, parts, axis_name, dim=1))
    return all_gather(mesh, outs, "dp", dim=0)
