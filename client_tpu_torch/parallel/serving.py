"""Zoo models sharded over a mesh and served through the ordinary engine.

Counterpart of ``client_tpu/parallel/serving.py``: the six ``*_mc``
families, each a backend the port's ``TorchEngine`` serves unchanged.

- ``bert_base_mc`` (:class:`ShardedBertBackend`): BERT-base megatron-style
  over ``tp`` (column-parallel fused QKV and ``w1``, row-parallel ``wo``
  and ``w2`` whose partials are summed in shard order), batch over ``dp``.
  The fused QKV's columns are kept head-major, so a tp split holds whole
  heads.
- ``bert_long_mc`` (:class:`LongContextBertBackend`): seq 2048, attention
  as ring attention over ``sp`` (``parallel/ring_attention.py``), batch
  over ``dp``, weights replicated. No flash kernel, as in JAX.
- ``tiny_gpt_mc`` (:class:`ShardedTinyGptBackend`): the generative decoder
  over ``tp`` with a head-sharded KV arena. Each decode wave runs kernel K2
  (``ops/decode_attention.py``) once per tp shard and layer on that
  shard's heads, at head dim 32.
- ``moe_gpt_mc`` (:class:`MoeGptBackend`): the same decode with a dropless
  top-1 MoE FFN (``parallel/moe.py``), experts over ``ep``, expert hidden
  over ``tp``.
- ``moe_lm_mc`` (:class:`MoeLmBackend`): the Switch-MoE LM forward over
  ``dp x ep x tp``.
- ``pipelined_lm_mc`` (:class:`PipelinedLmBackend`): the LM forward with
  its blocks pipeline-parallel over ``pp`` (``parallel/pipeline.py``),
  batch over ``dp``.

Every mesh is a :class:`~client_tpu_torch.parallel.mesh.Mesh` of torch
devices: by default every CUDA device (one on a one-card machine, a
degree-1 mesh), or, for a backend on ``device="cpu"``, the CPU. The CPU
tests use ``["cpu"] * 8``, one card can hold every shard, and a mesh over
distinct cards raises ``NotImplementedError``. A mesh may span processes
(``parallel/multihost.py``) along ``dp`` for ``bert_base_mc`` and along
``ep`` for ``moe_gpt_mc``; the other families raise
``NotImplementedError`` for it. Weights stay in the module's
parameters; the per-shard tensors are views of them, split by the JAX
package's partition specs (:func:`place_with_specs`). Dynamic batches pad
to buckets that are ``dp`` multiples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
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
from client_tpu_torch.models.bert import (
    BertBackend,
    gelu,
    head_major_perm,
    params_from_jax,
    split_qkv,
)
from client_tpu_torch.models.generate import KvArena, TinyGptBackend
from client_tpu_torch.models.generate import (
    params_from_jax as gpt_params_from_jax,
)
from client_tpu_torch.ops import decode_attention as _decode
from client_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    all_gather,
    make_mesh,
    place_with_specs,
    psum,
    split,
)
from client_tpu_torch.parallel.moe import (
    _init_moe_params,
    _moe_forward,
    _moe_specs,
    default_n_experts,
    moe_groups,
)
from client_tpu_torch.parallel.pipeline import (
    BLOCK_KEYS,
    _init_stacked_params,
    _stacked_specs,
    pipeline_apply,
)
from client_tpu_torch.parallel.ring_attention import (
    sequence_parallel_attention,
)
from client_tpu_torch.parallel.training import _rms_norm


def dp_batch_buckets(dp: int, max_batch_size: int) -> tuple[int, list[int]]:
    """(rounded max batch, bucket series): every bucket a dp multiple so
    dynamic batches scatter evenly over the mesh, doubling up to the top."""
    top = ((max_batch_size + dp - 1) // dp) * dp
    buckets, b = [top], dp
    while b < top:
        buckets.append(b)
        b *= 2
    return top, sorted(set(buckets))


def _set_ladder(config: ModelConfig, dp: int, max_batch_size: int) -> None:
    """``max_batch_size`` rounded up to ``dp`` and the dp-multiple ladder.
    On a dp-1 mesh the ladder is the default one, and ``batch_buckets``
    stays None (so the config round-trips through its JSON)."""
    top, buckets = dp_batch_buckets(dp, max_batch_size)
    config.max_batch_size = top
    config.batch_buckets = None
    if config.effective_buckets() != buckets:
        config.batch_buckets = buckets


def _served_lm_config(mesh: Mesh, name, seq_len, vocab,
                      max_batch_size) -> ModelConfig:
    """The ModelConfig of the token-in/logits-out served LM families (MoE,
    pipelined): INPUT_IDS INT32 [seq] -> LOGITS FP32 [seq, vocab],
    dp-multiple batch buckets. (The JAX function also returns the input
    shardings; here each forward splits its batch over ``dp`` itself.)"""
    top, _ = dp_batch_buckets(mesh.axis_size("dp"), max_batch_size)
    config = ModelConfig(
        name=name,
        max_batch_size=top,
        input=[TensorConfig("INPUT_IDS", "INT32", [seq_len])],
        output=[TensorConfig("LOGITS", "FP32", [seq_len, vocab])],
        dynamic_batching=DynamicBatchingConfig(
            preferred_batch_size=[max(1, top // 2), top],
            max_queue_delay_microseconds=500),
        instance_count=1,
    )
    _set_ladder(config, mesh.axis_size("dp"), max_batch_size)
    return config


def _mesh_for(mesh: Mesh | None, axes: tuple[str, ...],
              device) -> tuple[Mesh, torch.device]:
    """(mesh, device) of a backend on ``device`` (None: cuda, which raises
    without a card): the default mesh is every CUDA device, or the CPU on
    ``device="cpu"``; a given mesh must be on the backend's device
    (ValueError)."""
    device = resolve_device(device)
    if mesh is None:
        return make_mesh(axes=axes, devices=None if device.type == "cuda"
                         else [device]), device
    if mesh.device != device:
        raise ValueError(f"the mesh is on {mesh.device}, the backend on "
                         f"{device}")
    return mesh, device


class _PlacedCache:
    """A placed tree of views of a module's weights, rebuilt when the
    weights' storage moves (``Module.to`` to another device)."""

    def __init__(self):
        self._key, self._tree = None, None

    def get(self, key, build):
        if key != self._key:
            self._tree, self._key = build(), key
        return self._tree


class ParamTree(nn.Module):
    """A params pytree of the JAX package as a module: dict keys are
    submodules or parameters, lists are ``nn.ModuleList``s; the leaves keep
    the JAX layout (``x @ w``, ``w: [in, out]``)."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                setattr(self, key, ParamTree(value))
            elif isinstance(value, list):
                setattr(self, key, nn.ModuleList(ParamTree(v) for v in value))
            else:
                setattr(self, key, nn.Parameter(
                    torch.empty(value.shape, dtype=value.dtype),
                    requires_grad=False))

    def tree(self) -> dict:
        out = {}
        for key in self._keys:
            value = getattr(self, key)
            if isinstance(value, nn.ModuleList):
                out[key] = [m.tree() for m in value]
            elif isinstance(value, ParamTree):
                out[key] = value.tree()
            else:
                out[key] = value.detach()
        return out



def tree_state(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A params pytree (numpy or tensor leaves) as the ``state_dict`` of
    its :class:`ParamTree` under ``prefix``."""
    flat = {}

    def walk(pre, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{pre}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{pre}{i}.", v)
        else:
            flat[pre[:-1]] = leaf_tensor(node)

    walk(prefix, tree)
    return flat


# -- BERT ---------------------------------------------------------------------


def bert_param_specs(P, n_layers: int):
    """Partition specs matching BERT's params pytree.

    Embeddings and layer-norms replicate (small); attention and FFN weights
    split megatron-style over ``tp``: column-parallel into the head/hidden
    dimension, row-parallel back out, so each matmul pair needs exactly one
    sum of partials.
    """
    def dense_col():  # [in, out] split on out
        return {"w": P(None, "tp"), "b": P("tp")}

    def dense_row():  # [in, out] split on in; output needs the psum
        return {"w": P("tp", None), "b": P()}

    def ln():
        return {"scale": P(), "bias": P()}

    layer = {
        # Fused QKV is column-parallel over its 3h output; the head-major
        # (b, s, heads, 3, hd) layout means each tp shard holds complete
        # q/k/v triples for its heads.
        "wqkv": dense_col(),
        "wo": dense_row(),
        "ln1": ln(),
        "w1": dense_col(), "w2": dense_row(),
        "ln2": ln(),
    }
    return {
        "tok_embed": P(),
        "pos_embed": P(),
        "embed_ln": ln(),
        "layers": [dict(layer) for _ in range(n_layers)],
        "pooler": {"w": P(), "b": P()},
        "classifier": {"w": P(), "b": P()},
    }


def _split_batch(mesh: Mesh, inputs: dict) -> list[dict]:
    """The batch's ``dp`` shards this process holds, each a dict of
    per-shard inputs."""
    parts = {k: split(mesh, v, 0, "dp") for k, v in inputs.items()}
    return [dict(zip(parts, vals)) for vals in zip(*parts.values())]


def _join_batch(mesh: Mesh, outs: list[dict]) -> dict:
    """The ``dp`` shards' outputs joined in shard order (gathered from
    every process when ``dp`` spans them)."""
    return {k: all_gather(mesh, [o[k] for o in outs], "dp") for k in outs[0]}


class ShardedBertBackend(BertBackend):
    """BERT-base partitioned over a ``("dp", "tp")`` mesh for serving.

    ``mesh`` defaults to every CUDA device (the CPU for ``device="cpu"``).
    Batch buckets are multiples of the dp degree. The module keeps the
    fused QKV's columns head-major (:func:`head_major_perm`);
    :meth:`params_to_jax` and :meth:`load_jax_params` speak the canonical
    qkv-major layout, so both modes are one function of one checkpoint.
    ``n_heads`` and ``ffn`` must divide by tp (whole heads per shard).

    ``dp`` may span processes (``multihost.global_mesh``): each process's
    engine runs its own dp shards of the whole batch and gathers the
    others' outputs, so every process answers the whole request. Every
    process must then dispatch the same executions in the same order: one
    request at a time, the same in each.
    """

    def __init__(self, mesh: Mesh | None = None, name: str = "bert_base_mc",
                 max_batch_size: int = 16, device=None, **kw):
        mesh, device = _mesh_for(mesh, ("dp", "tp"), device)
        mesh.check_crossing(("dp",), "ShardedBertBackend")
        tp = mesh.axis_size("tp")
        n_heads, ffn = kw.get("n_heads", 12), kw.get("ffn", 3072)
        if n_heads % tp or ffn % tp:
            raise ValueError(f"n_heads ({n_heads}) and ffn ({ffn}) must "
                             f"divide by tp ({tp})")
        super().__init__(name=name, max_batch_size=max_batch_size,
                         device=device, **kw)
        self.mesh = mesh
        _set_ladder(self.config, mesh.axis_size("dp"), max_batch_size)
        self._placed = _PlacedCache()

    def _perm(self) -> torch.Tensor:
        return head_major_perm(self.tok_embed.shape[1], self.n_heads)

    @torch.no_grad()
    def _init_params(self, gen: torch.Generator) -> None:
        super()._init_params(gen)
        perm = self._perm()
        for lp in self.layers:
            lp.wqkv.weight.copy_(lp.wqkv.weight[perm])
            lp.wqkv.bias.copy_(lp.wqkv.bias[perm])

    def params_from_jax(self, tree) -> dict[str, torch.Tensor]:
        """The JAX BERT's params pytree (qkv-major) as this module's
        ``state_dict``, the fused QKV permuted head-major."""
        state = params_from_jax(tree)
        perm = self._perm()
        for i in range(len(self.layers)):
            for key in (f"layers.{i}.wqkv.weight", f"layers.{i}.wqkv.bias"):
                state[key] = state[key][perm]
        return state

    def load_jax_params(self, tree) -> None:
        self.load_state_dict(self.params_from_jax(tree))

    def params_to_jax(self) -> dict:
        tree = super().params_to_jax()
        inv = torch.argsort(self._perm())
        for lp in tree["layers"]:
            lp["wqkv"] = {"w": lp["wqkv"]["w"][:, inv],
                          "b": lp["wqkv"]["b"][inv]}
        return tree

    def placed(self) -> dict:
        """Each layer's split weights, keyed by the layer's ``id``: the
        matrices split by :func:`bert_param_specs` (views of the
        parameters, JAX layout); the row-parallel biases and the layer
        norms, replicated, stay on the layer."""
        def build():
            tree = [{"wqkv": {"w": lp.wqkv.weight.T, "b": lp.wqkv.bias},
                     "wo": {"w": lp.wo.weight.T}, "w1": {"w": lp.w1.weight.T,
                                                         "b": lp.w1.bias},
                     "w2": {"w": lp.w2.weight.T}} for lp in self.layers]
            layer = bert_param_specs(P, 1)["layers"][0]
            specs = [{k: {n: layer[k][n] for n in tree[0][k]}
                      for k in tree[0]}] * len(tree)
            return dict(zip(map(id, self.layers),
                            place_with_specs(self.mesh, tree, specs)))

        return self._placed.get(self.tok_embed.data_ptr(), build)

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict:
        return _join_batch(self.mesh, [
            self.encode(part, self.attend)
            for part in _split_batch(self.mesh, inputs)])

    def _tp(self) -> range:
        return range(self.mesh.axis_size("tp"))

    def _attention(self, x, bias2d, lp, attend) -> torch.Tensor:
        sh = self.placed()[id(lp)]
        b, s, _ = x.shape
        heads = self.n_heads // self.mesh.axis_size("tp")
        parts = []
        for t in self._tp():
            qkv = F.linear(x, sh["wqkv"]["w"].part(tp=t).T,
                           sh["wqkv"]["b"].part(tp=t))
            q, k, v = split_qkv(qkv, heads, self.head_dim, head_major=True)
            ctx = attend(q, k, v, bias2d).reshape(b, s, -1)
            parts.append(F.linear(ctx, sh["wo"]["w"].part(tp=t).T))
        return psum(self.mesh, parts, "tp") + lp.wo.bias

    def _ffn(self, x, lp) -> torch.Tensor:
        sh = self.placed()[id(lp)]
        parts = [F.linear(gelu(F.linear(x, sh["w1"]["w"].part(tp=t).T,
                                        sh["w1"]["b"].part(tp=t))),
                          sh["w2"]["w"].part(tp=t).T) for t in self._tp()]
        return psum(self.mesh, parts, "tp") + lp.w2.bias


# Opt-in (default=False): a default load-all server should not pay a
# second full BERT-base load; reach it by name (`--zoo bert_base_mc`).
register_model("bert_base_mc", default=False)(
    lambda device: ShardedBertBackend(device=device))


class LongContextBertBackend(BertBackend):
    """Long-context BERT served sequence-parallel over a ``("dp", "sp")``
    mesh: attention is exact ring attention over ``sp``
    (``parallel/ring_attention.py``), each ``dp`` shard of the batch its
    own ring; no shard ever holds a ``[S, S]`` score tensor. Parameters
    replicate. ``seq_len`` must divide by sp."""

    def __init__(self, mesh: Mesh | None = None, name: str = "bert_long_mc",
                 seq_len: int = 2048, max_batch_size: int = 4, device=None,
                 **kw):
        mesh, device = _mesh_for(mesh, ("dp", "sp"), device)
        mesh.check_crossing((), "LongContextBertBackend")
        sp = mesh.axis_size("sp")
        if seq_len % sp:
            raise ValueError(
                f"seq_len {seq_len} must be a multiple of the sp mesh "
                f"axis ({sp})")
        super().__init__(name=name, seq_len=seq_len,
                         max_batch_size=max_batch_size, device=device, **kw)
        self.mesh = mesh
        _set_ladder(self.config, mesh.axis_size("dp"), max_batch_size)

    def ring_attend(self, q, k, v, bias2d) -> torch.Tensor:
        return sequence_parallel_attention(self.mesh, q, k, v, bias2d,
                                           axis_name="sp")

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict:
        return self.encode(inputs, self.ring_attend)


register_model("bert_long_mc", default=False)(
    lambda device: LongContextBertBackend(device=device))


# -- the generative families ----------------------------------------------------


@dataclass
class HeadShardedKvArena:
    """The generative KV cache split by heads over ``tp``, updated in
    place: shard ``t`` holds heads ``[t * H / tp, (t + 1) * H / tp)`` of
    every row, contiguous, as kernel K2 reads them."""

    k: list[torch.Tensor]  # per tp shard [L, R, S, H / tp, D] fp32
    v: list[torch.Tensor]
    tok: torch.Tensor      # [R] int32, once


def _place_arena_heads_sharded(mesh: Mesh, arena: KvArena
                               ) -> HeadShardedKvArena:
    """The arena's k / v split on their heads axis over ``tp`` (one shard
    when the mesh has no tp); the per-row token slots stay once."""
    return HeadShardedKvArena(
        k=[t.contiguous() for t in split(mesh, arena.k, 3, "tp")],
        v=[t.contiguous() for t in split(mesh, arena.v, 3, "tp")],
        tok=arena.tok)


class ShardedTinyGptBackend(TinyGptBackend):
    """tiny_gpt tensor-parallel over a ``tp`` mesh axis for generative
    serving: ``wq`` / ``wk`` / ``wv`` / ``w1`` column-split, ``wo`` / ``w2``
    row-split with their partials summed in shard order, and the KV arena
    split on its heads axis (:class:`HeadShardedKvArena`). Each decode
    wave's layer runs K2 once per tp shard on that shard's heads
    (``attn_impl="fused"``, the default; ``"reference"`` runs K2's plain
    version). The arena's rows are not sharded (``kv_shards`` is 1).
    Requires ``n_heads`` and ``d_ff`` divisible by tp."""

    _default_axes: tuple[str, ...] = ("tp",)
    _crossing: tuple[str, ...] = ()  # the axes that may span processes

    def __init__(self, mesh: Mesh | None = None, name: str = "tiny_gpt_mc",
                 n_heads: int = 8, device=None, **kw):
        mesh, device = _mesh_for(mesh, self._default_axes, device)
        mesh.check_crossing(self._crossing, type(self).__name__)
        tp = mesh.axis_size("tp")
        if n_heads % tp:
            raise ValueError(
                f"n_heads ({n_heads}) must divide by tp ({tp})")
        if kw.get("d_ff", 1024) % tp:
            raise ValueError(f"d_ff ({kw.get('d_ff', 1024)}) must divide "
                             f"by tp ({tp})")
        if kw.get("kv_shards", 1) != 1:
            raise ValueError("the head-sharded arena keeps kv_shards=1")
        self.mesh = mesh
        super().__init__(name=name, n_heads=n_heads, device=device, **kw)
        self._placed = _PlacedCache()

    def params_from_jax(self, tree) -> dict[str, torch.Tensor]:
        """The JAX params pytree as this module's ``state_dict``
        (``models.generate.params_from_jax``: the layout is tiny_gpt's)."""
        return gpt_params_from_jax(tree)

    def _param_specs(self, P):
        layer = {
            "ln1g": P(), "ln1b": P(),
            "wq": P(None, "tp"), "wk": P(None, "tp"), "wv": P(None, "tp"),
            "wo": P("tp", None),
            "ln2g": P(), "ln2b": P(),
            "w1": P(None, "tp"), "w2": P("tp", None),
        }
        return {
            "embed": P(), "pos": P(),
            "layers": [dict(layer) for _ in range(self.n_layers)],
            "lnfg": P(), "lnfb": P(), "head": P(),
        }

    def placed(self) -> list[dict]:
        """Each layer's weights split by :meth:`_param_specs` (views of the
        parameters, JAX layout)."""
        def build():
            tree = self.params_to_jax()
            layer = self._param_specs(P)["layers"][0]
            specs = [{k: layer[k] for k in lp} for lp in tree["layers"]]
            return place_with_specs(self.mesh, tree["layers"], specs)

        return self._placed.get(self.embed.data_ptr(), build)

    def _tp(self) -> range:
        return range(self.mesh.axis_size("tp"))

    def _shard_qkv(self, sh, h, shape, t):
        return tuple((h @ sh[k].part(tp=t)).view(*shape, -1, self.head_dim)
                     for k in ("wq", "wk", "wv"))

    def _ffn_sharded(self, lp, sh, x) -> torch.Tensor:
        h2 = lp.ln2(x)
        return psum(self.mesh, [
            F.gelu(h2 @ sh["w1"].part(tp=t), approximate="tanh")
            @ sh["w2"].part(tp=t) for t in self._tp()], "tp")

    def _stack(self, x: torch.Tensor, on_kv=None) -> torch.Tensor:
        """The full-context causal stack over ``[B, n, d]``, per tp shard;
        ``on_kv(li, ks, vs)`` sees each layer's per-shard K/V."""
        b, n, _ = x.shape
        for li, (lp, sh) in enumerate(zip(self.layers, self.placed())):
            h = lp.ln1(x)
            qkv = [self._shard_qkv(sh, h, (b, n), t) for t in self._tp()]
            if on_kv is not None:
                on_kv(li, [k for _, k, _ in qkv], [v for _, _, v in qkv])
            x = x + psum(self.mesh, [
                self._attend_causal(q, k, v).reshape(b, n, -1)
                @ sh["wo"].part(tp=t) for t, (q, k, v) in enumerate(qkv)],
                "tp")
            x = x + self._ffn_sharded(lp, sh, x)
        return x

    def init_arena(self, capacity: int) -> HeadShardedKvArena:
        """k / v ``[L, R, S, H / tp, D]`` zeros per tp shard and ``tok``
        ``[R]``."""
        return _place_arena_heads_sharded(self.mesh,
                                          super().init_arena(capacity))

    def _kv_writer(self, arena: HeadShardedKvArena, index, n: int):
        rows = index.rows.long()

        def on_kv(li, ks, vs):
            for t, (k, v) in enumerate(zip(ks, vs)):
                arena.k[t][li, rows, :n] = k
                arena.v[t][li, rows, :n] = v

        return on_kv

    @torch.inference_mode()
    def decode(self, arena: HeadShardedKvArena, index, lanes,
               sample: bool = True) -> torch.Tensor:
        """One decode wave over the head-sharded arena: per layer, K2 once
        per tp shard on its heads, then the ``wo`` partials summed."""
        rows, lens = index.rows.long(), index.lens.long()
        b = rows.shape[0]
        wave = (_decode.decode_wave_attention if self.attn_impl == "fused"
                else _decode.decode_wave_attention_plain)
        x = self.embed[arena.tok[rows].long()] + self.pos[lens]
        for li, (lp, sh) in enumerate(zip(self.layers, self.placed())):
            h = lp.ln1(x)
            parts = []
            for t in self._tp():
                q, k, v = self._shard_qkv(sh, h, (b,), t)
                o = wave(arena.k[t], arena.v[t], q, k, v, index, layer=li)
                parts.append(o.reshape(b, -1) @ sh["wo"].part(tp=t))
            x = x + psum(self.mesh, parts, "tp")
            x = x + self._ffn_sharded(lp, sh, x)
        logits = self.head(self.lnf(x))
        nxt = self._sample(logits, lanes, lens + 1, sample)
        arena.tok[rows] = nxt
        return nxt


register_model("tiny_gpt_mc", default=False)(
    lambda device: ShardedTinyGptBackend(device=device))


class MoeGptLayer(nn.Module):
    """A decoder layer whose FFN is the routed expert stack: ``router``
    ``[d, E]``, ``w1e`` ``[E, d, f]``, ``w2e`` ``[E, f, d]`` in the JAX
    layout; attention as :class:`~client_tpu_torch.models.generate
    .GptLayer`'s."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-5)
        self.wq = nn.Linear(d_model, d_model, bias=False)
        self.wk = nn.Linear(d_model, d_model, bias=False)
        self.wv = nn.Linear(d_model, d_model, bias=False)
        self.wo = nn.Linear(d_model, d_model, bias=False)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-5)
        self.router = nn.Parameter(torch.empty(d_model, n_experts))
        self.w1e = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.w2e = nn.Parameter(torch.empty(n_experts, d_ff, d_model))

    def ffn(self, x: torch.Tensor, w1e=None, w2e=None) -> torch.Tensor:
        """Dropless ``moe_ffn(ln2(x))``, each row of a ``[B, n, d]`` its
        own token group (a ``[B, d]`` wave is one). ``w1e`` / ``w2e``: the
        stacks placed over ``ep`` x ``tp``; the layer's own by default."""
        return _moe_rows(self.ln2(x), self.router,
                         self.w1e if w1e is None else w1e,
                         self.w2e if w2e is None else w2e)


def _moe_rows(h: torch.Tensor, router, w1e, w2e) -> torch.Tensor:
    """The dropless top-1 FFN on normed rows: ``[T, d]`` (a decode wave)
    routes as one group, ``[B, n, d]`` as B groups (prefill's per-row
    stacks), each with capacity equal to its token count, so every
    token's queue position is below capacity and nothing drops."""
    flat = h if h.dim() == 3 else h[None]
    y, _aux = moe_groups(flat, router, w1e, w2e, capacity=flat.shape[1])
    return y if h.dim() == 3 else y[0]


class MoeGptBackend(ShardedTinyGptBackend):
    """Expert-parallel generative decode: a Switch-MoE decoder LM in the
    continuous-batching arena over an ``("ep", "tp")`` mesh.

    Every decode wave routes its B tokens top-1 through an expert FFN stack
    split over ``ep`` (expert hidden over ``tp``; attention heads over
    ``tp`` and the head-sharded arena as :class:`ShardedTinyGptBackend`).
    Routing is dropless: per-expert capacity equals the token count, so
    each token's output is a function of its own features and decode is
    batch-invariant, bit-identical to solo decode.

    The seeded weights equal the JAX package's bit for bit: the base init
    draws (and drops) the dense ``w1`` / ``w2``, then
    ``default_rng(seed + 1)`` draws each layer's ``router``, ``w1e`` and
    ``w2e``.

    ``ep`` may span processes (``multihost.global_mesh``): each process runs
    attention (K2 on its tp shards) for every lane and its own experts,
    and the expert outputs are gathered across the processes. Every
    process must then dispatch the same executions in the same order: one
    stream with a fixed token budget and greedy decoding (or one request
    at a time), the same in each, as the JAX multihost test serves it."""

    _default_axes = ("ep", "tp")
    _crossing = ("ep",)

    def __init__(self, mesh: Mesh | None = None, name: str = "moe_gpt_mc",
                 n_layers: int = 2, d_model: int = 128, n_heads: int = 4,
                 d_ff: int = 256, vocab: int = 256, max_seq_len: int = 64,
                 max_streams: int = 32, n_experts: int | None = None,
                 device=None, **kw):
        mesh, device = _mesh_for(mesh, self._default_axes, device)
        self.n_experts = n_experts or default_n_experts(mesh)
        ep, tp = mesh.axis_size("ep"), mesh.axis_size("tp")
        if self.n_experts % ep:
            raise ValueError(
                f"n_experts ({self.n_experts}) must divide by ep ({ep})")
        if n_heads % tp:
            raise ValueError(
                f"n_heads ({n_heads}) must divide by tp ({tp})")
        if d_ff % tp:
            raise ValueError(f"d_ff ({d_ff}) must divide by tp ({tp})")
        super().__init__(mesh=mesh, name=name, n_layers=n_layers,
                         d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                         vocab=vocab, max_seq_len=max_seq_len,
                         max_streams=max_streams, device=device, **kw)

    def _make_layer(self, d_model: int, d_ff: int) -> nn.Module:
        return MoeGptLayer(d_model, d_ff, self.n_experts)

    def _init_params(self) -> dict:
        """Base init with each layer's dense FFN pair swapped for the
        routed expert stacks (same scale conventions: 1/sqrt(fan_in))."""
        params = super()._init_params()
        rng = np.random.default_rng(self._seed + 1)
        d, f, e = self.d_model, self.d_ff, self.n_experts

        def w(*shape, scale):
            return (rng.standard_normal(shape) * scale).astype(np.float32)

        for lp in params["layers"]:
            del lp["w1"], lp["w2"]
            lp["router"] = w(d, e, scale=0.02)
            lp["w1e"] = w(e, d, f, scale=1.0 / math.sqrt(d))
            lp["w2e"] = w(e, f, d, scale=1.0 / math.sqrt(f))
        return params

    def params_from_jax(self, tree) -> dict[str, torch.Tensor]:
        """The JAX ``MoeGptBackend``'s params pytree as this module's
        ``state_dict``: dense weights transposed, as ``nn.Linear`` keeps
        them, and the router and expert stacks in the JAX layout."""
        t = leaf_tensor
        state = {"embed": t(tree["embed"]), "pos": t(tree["pos"]),
                 "lnf.weight": t(tree["lnfg"]), "lnf.bias": t(tree["lnfb"]),
                 "head.weight": t(tree["head"]).T.contiguous()}
        for i, lp in enumerate(tree["layers"]):
            pre = f"layers.{i}."
            for ln in ("ln1", "ln2"):
                state[pre + ln + ".weight"] = t(lp[ln + "g"])
                state[pre + ln + ".bias"] = t(lp[ln + "b"])
            for key in ("wq", "wk", "wv", "wo"):
                state[pre + key + ".weight"] = t(lp[key]).T.contiguous()
            for key in ("router", "w1e", "w2e"):
                state[pre + key] = t(lp[key])
        return state

    def load_jax_params(self, tree) -> None:
        self.load_state_dict(self.params_from_jax(tree))

    def params_to_jax(self) -> dict:
        layers = []
        for lp in self.layers:
            layer = {"ln1g": lp.ln1.weight, "ln1b": lp.ln1.bias,
                     "ln2g": lp.ln2.weight, "ln2b": lp.ln2.bias,
                     "router": lp.router, "w1e": lp.w1e, "w2e": lp.w2e}
            for key in ("wq", "wk", "wv", "wo"):
                layer[key] = getattr(lp, key).weight.T
            layers.append({k: v.detach() for k, v in layer.items()})
        return {"embed": self.embed.detach(), "pos": self.pos.detach(),
                "layers": layers, "lnfg": self.lnf.weight.detach(),
                "lnfb": self.lnf.bias.detach(),
                "head": self.head.weight.detach().T}

    def _param_specs(self, P):
        layer = {
            "ln1g": P(), "ln1b": P(),
            "wq": P(None, "tp"), "wk": P(None, "tp"), "wv": P(None, "tp"),
            "wo": P("tp", None),
            "ln2g": P(), "ln2b": P(),
            "router": P(),
            "w1e": P("ep", None, "tp"),
            "w2e": P("ep", "tp", None),
        }
        return {
            "embed": P(), "pos": P(),
            "layers": [dict(layer) for _ in range(self.n_layers)],
            "lnfg": P(), "lnfb": P(), "head": P(),
        }

    def _ffn_sharded(self, lp, sh, x) -> torch.Tensor:
        return lp.ffn(x, sh["w1e"], sh["w2e"])


register_model("moe_gpt_mc", default=False)(
    lambda device: MoeGptBackend(device=device))


# -- the served LM forwards ----------------------------------------------------


class _ServedLm(ModelBackend):
    """A token-in/logits-out LM whose params are the JAX package's pytree
    (:class:`ParamTree`), seeded from a ``torch.Generator`` with the JAX
    init's scales, or restored (``engine.model.restoring``)."""

    def _build(self, init: dict, device: torch.device) -> None:
        with torch.device("meta"):
            self.params = ParamTree(init)
        self.load_or_init_params(lambda: self.load_jax_params(init))
        self.requires_grad_(False)
        self.to(device)
        self._placed = _PlacedCache()

    def params_from_jax(self, tree) -> dict[str, torch.Tensor]:
        """The JAX backend's params pytree as this module's ``state_dict``
        (the JAX layout throughout)."""
        return tree_state(tree, "params.")

    def load_jax_params(self, tree) -> None:
        self.load_state_dict(self.params_from_jax(tree))

    def params_to_jax(self) -> dict:
        return self.params.tree()

    def placed(self) -> dict:
        return self._placed.get(
            self.params.embed.data_ptr(),
            lambda: place_with_specs(self.mesh, self.params.tree(),
                                     self._specs()))


class MoeLmBackend(_ServedLm):
    """Switch-MoE language model served over a ``("dp", "ep", "tp")`` mesh.

    Per-token next-token logits from the MoE transformer forward
    (``parallel/moe.py``): expert FFN stacks split over ``ep`` (hidden
    over ``tp``), attention heads over ``tp``, batch over ``dp``. Expert
    capacity is derived from the padded bucket's token count
    (``ceil(tokens / E * capacity_factor)``), so overflow drops are
    per-batch — standard Switch semantics: a token past its expert's queue
    rides the residual path.

    NOT batch-invariant, unlike every other served family: which tokens
    overflow depends on the co-batched tokens ahead of them in the
    dispatch queue and on the bucket the dynamic batcher picks, so a
    request's logits can differ between solo and co-batched service.
    This is inherent to capacity-based MoE routing; serve with
    ``dynamic_batching=None`` if per-request determinism matters more
    than throughput.
    """

    def __init__(self, mesh: Mesh | None = None, name: str = "moe_lm_mc",
                 seq_len: int = 32, d_model: int = 64, d_ff: int = 128,
                 n_layers: int = 2, n_heads: int = 4,
                 n_experts: int | None = None, capacity_factor: float = 1.25,
                 vocab: int = 256, max_batch_size: int = 8, seed: int = 0,
                 device=None):
        super().__init__()
        mesh, device = _mesh_for(mesh, ("dp", "ep", "tp"), device)
        mesh.check_crossing((), "MoeLmBackend")
        self.mesh = mesh
        self.seq_len, self.d_model, self.d_ff = seq_len, d_model, d_ff
        self.n_layers, self.n_heads = n_layers, n_heads
        self.n_experts = n_experts or default_n_experts(mesh)
        ep = mesh.axis_size("ep")
        if self.n_experts % ep:
            raise ValueError(
                f"n_experts ({self.n_experts}) must divide by ep ({ep})")
        tp = mesh.axis_size("tp")
        if d_ff % tp:
            raise ValueError(f"d_ff ({d_ff}) must divide by tp ({tp})")
        if d_model % n_heads:
            raise ValueError(
                f"d_model ({d_model}) must divide by n_heads ({n_heads})")
        self.capacity_factor = capacity_factor
        self.vocab = vocab
        self.config = _served_lm_config(mesh, name, seq_len, vocab,
                                        max_batch_size)
        self._build(_init_moe_params(torch.Generator().manual_seed(seed),
                                     vocab, d_model, d_ff, n_layers,
                                     self.n_experts), device)

    def _specs(self) -> dict:
        return _moe_specs(P, self.n_layers)

    def capacity(self, batch: int) -> int:
        """Expert slots for a bucket of ``batch`` rows."""
        return int(np.ceil(batch * self.seq_len / self.n_experts
                           * self.capacity_factor))

    @torch.inference_mode()
    def forward(self, inputs: dict[str, torch.Tensor]) -> dict:
        tokens = inputs["INPUT_IDS"]
        logits, _aux = _moe_forward(self.placed(), tokens, self.n_heads,
                                    self.capacity(tokens.shape[0]),
                                    self.mesh)
        return {"LOGITS": logits.float()}


register_model("moe_lm_mc", default=False)(
    lambda device: MoeLmBackend(device=device))


class PipelinedLmBackend(_ServedLm):
    """Transformer LM served with its blocks pipeline-parallel over ``pp``.

    Each stage holds a contiguous slice of layers; a served batch flows
    through the stages as one microbatch (``pipeline_apply`` with M = 1),
    its rows split over ``dp``. Embed/unembed replicate. ``n_layers``
    defaults to ``pp * max(1, 4 // pp)``. Raises without a ``pp`` axis.
    """

    def __init__(self, mesh: Mesh | None = None,
                 name: str = "pipelined_lm_mc", seq_len: int = 32,
                 d_model: int = 64, d_ff: int = 128,
                 n_layers: int | None = None, n_heads: int = 4,
                 vocab: int = 256, max_batch_size: int = 8, seed: int = 0,
                 device=None):
        super().__init__()
        mesh, device = _mesh_for(mesh, ("dp", "pp"), device)
        mesh.check_crossing((), "PipelinedLmBackend")
        if "pp" not in mesh.shape:
            raise ValueError(
                "PipelinedLmBackend requires a mesh with a 'pp' axis; got "
                f"axes {tuple(mesh.shape)}")
        self.mesh = mesh
        pp = mesh.axis_size("pp")
        if n_layers is None:
            n_layers = pp * max(1, 4 // pp)
        if n_layers % pp:
            raise ValueError(
                f"n_layers ({n_layers}) must divide by pp ({pp})")
        if d_model % n_heads:
            raise ValueError(
                f"d_model ({d_model}) must divide by n_heads ({n_heads})")
        self.seq_len, self.d_model, self.d_ff = seq_len, d_model, d_ff
        self.n_layers, self.n_heads, self.vocab = n_layers, n_heads, vocab
        self.config = _served_lm_config(mesh, name, seq_len, vocab,
                                        max_batch_size)
        self._build(_init_stacked_params(torch.Generator().manual_seed(seed),
                                         vocab, d_model, d_ff, n_layers),
                    device)

    def _specs(self) -> dict:
        return _stacked_specs(P)

    @torch.inference_mode()
    def forward(self, inputs: dict[str, torch.Tensor]) -> dict:
        placed = self.placed()
        tokens = inputs["INPUT_IDS"].long()
        seq = tokens.shape[-1]
        mask = torch.ones(seq, seq, dtype=torch.bool,
                          device=tokens.device).tril()
        x = placed["embed"].part()[tokens][None]       # [M=1, B, S, D]
        x = pipeline_apply(self.mesh, {k: placed[k] for k in BLOCK_KEYS},
                           x, self.n_heads, mask)[0]
        logits = _rms_norm(x) @ placed["unembed"].part()
        return {"LOGITS": logits.float()}


register_model("pipelined_lm_mc", default=False)(
    lambda device: PipelinedLmBackend(device=device))
