"""Autoregressive decoder LM (``tiny_gpt``, ``tiny_gpt_long``) for
generative serving, as an ``nn.Module``.

Counterpart of ``client_tpu/models/generate.py``, with the same numerics in
fp32: pre-LN blocks (eps 1e-5), tanh GELU, learned positions, ``x @ w``
products, causal attention. Served token by token through the
continuous-batching ``GenerativeScheduler`` (``engine/generative.py``) over
a KV arena ``[n_layers, capacity + 1, max_seq_len, heads, head_dim]`` on
the device: the +1 dummy row absorbs padded lanes. The arena also keeps
each row's latest token, so consecutive decode waves chain on the device.
With ``kv_shards = n > 1`` the arena's rows are split over a ``"kv"`` mesh
of ``n`` shards, one junk row per shard (``parallel/kv_shard.py``).

- ``prefill`` runs a batch of prompts (padded to one lane count and one
  prompt bucket) through the full causal stack, writes each prompt's K/V
  into its arena row and samples its first token. Under
  ``attention_impl="flash"`` the prefill attention is kernel K1 in fp32
  (``ops/flash_attention.py``); causality hides the padded tail.
- ``decode`` advances every lane of a wave one token. Under
  ``attn_impl="fused"`` (the port's default) each layer's scatter and
  attention is one launch of kernel K2 (``ops/decode_attention.py``);
  ``"reference"`` runs K2's plain version, the oracle. Streams are
  token-identical either way, up to fp32 summation order. Over a sharded
  arena each layer runs K2 once per shard and sums the partial outputs
  with kernel K3, the ring all-reduce (``kv_combine = "ring"``).
- ``decode_chunk`` runs K waves back to back with no host sync.

Weights are random from ``np.random.default_rng(seed)`` in the JAX
backend's draw order, so they equal the JAX package's bit for bit;
:func:`params_from_jax` carries any JAX params pytree across, a
checkpoint restores one (``engine.model.restoring``), and
:meth:`TinyGptBackend.params_to_jax` gives the pytree back. The arena is
updated in place (the JAX version donates it into every call).
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
from client_tpu_torch.engine.config import ModelConfig, TensorConfig
from client_tpu_torch.engine.model import ModelBackend
from client_tpu_torch.models import register_model
from client_tpu_torch.models.sampling import sample_tokens
from client_tpu_torch.ops import decode_attention as _decode
from client_tpu_torch.ops import flash_attention as _flash
from client_tpu_torch.ops.decode_attention import WaveIndex, stage
from client_tpu_torch.parallel import kv_shard

_NEG_INF = -1e30


@dataclass
class KvArena:
    """The generative KV cache on the device, updated in place."""

    k: torch.Tensor    # [L, R, S, H, D] fp32
    v: torch.Tensor    # [L, R, S, H, D] fp32
    tok: torch.Tensor  # [R] int32: each row's latest token


class LaneParams:
    """The per-lane sampling parameters of one dispatch (``seeds`` int32,
    ``temps`` fp32, ``top_ks`` int32, ``top_ps`` fp32, each ``[B]``),
    staged to the device in two copies. The pinned host tensors stay
    referenced here while the copies may still read them."""

    def __init__(self, seeds, temps, top_ks, top_ps,
                 device: torch.device | str = "cpu"):
        device = torch.device(device)
        self._pinned_i, ints = stage(
            np.stack([np.asarray(seeds, np.int32),
                      np.asarray(top_ks, np.int32)]), device)
        self._pinned_f, floats = stage(
            np.stack([np.asarray(temps, np.float32),
                      np.asarray(top_ps, np.float32)]), device)
        self.seeds, self.top_ks = ints[0], ints[1]
        self.temps, self.top_ps = floats[0], floats[1]


class GptLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-5)
        self.wq = nn.Linear(d_model, d_model, bias=False)
        self.wk = nn.Linear(d_model, d_model, bias=False)
        self.wv = nn.Linear(d_model, d_model, bias=False)
        self.wo = nn.Linear(d_model, d_model, bias=False)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-5)
        self.w1 = nn.Linear(d_model, d_ff, bias=False)
        self.w2 = nn.Linear(d_ff, d_model, bias=False)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.gelu(self.w1(self.ln2(x)), approximate="tanh"))


class TinyGptBackend(ModelBackend):
    """Decoder-only LM: ``INPUT_IDS`` INT32[-1] -> streamed (``TOKEN``
    INT32[1], ``INDEX`` UINT32[1]) responses, the last flagged final.

    ``attention_impl`` ("einsum" | "flash") picks the prefill attention,
    ``attn_impl`` ("fused" | "reference") the decode-wave attention.
    ``kv_shards > 1`` splits the arena's rows over a ``"kv"`` mesh (fused
    decode only; ``max_streams`` must divide evenly): by default the first
    ``kv_shards`` CUDA devices, or, on the CPU, the CPU repeated. A caller
    may set ``_kv_mesh`` (``parallel.kv_mesh``) before the first arena, for
    example to put every shard on one card. The ``max_tokens`` request
    parameter bounds a stream (default 16)."""

    generative = True

    def __init__(self, name: str = "tiny_gpt", n_layers: int = 4,
                 d_model: int = 256, n_heads: int = 4, d_ff: int = 1024,
                 vocab: int = 512, max_seq_len: int = 128,
                 max_streams: int = 64, seed: int = 0,
                 attention_impl: str = "einsum", attn_impl: str = "fused",
                 kv_shards: int = 1,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        if attention_impl not in ("einsum", "flash"):
            raise ValueError(f"attention_impl must be 'einsum' or 'flash', "
                             f"got {attention_impl!r}")
        if attn_impl not in ("reference", "fused"):
            raise ValueError(f"attn_impl must be 'reference' or 'fused', "
                             f"got {attn_impl!r}")
        self.kv_shards = int(kv_shards)
        if self.kv_shards < 1:
            raise ValueError(f"kv_shards must be >= 1, got {kv_shards}")
        if self.kv_shards > 1:
            if attn_impl != "fused":
                raise ValueError(
                    "kv_shards > 1 requires attn_impl='fused' (the sharded "
                    "arena is served by the per-shard fused kernel)")
            if max_streams % self.kv_shards:
                raise ValueError(
                    f"max_streams ({max_streams}) must be divisible by "
                    f"kv_shards ({self.kv_shards})")
        # The cross-shard sum: "ring" (K3) or "psum" (a plain sum).
        self.kv_combine = "ring"
        self._kv_mesh = None
        self.attention_impl, self.attn_impl = attention_impl, attn_impl
        self.n_layers, self.d_model = n_layers, d_model
        self.n_heads, self.d_ff = n_heads, d_ff
        self.head_dim = d_model // n_heads
        self.vocab, self.max_seq_len = vocab, max_seq_len
        self.max_streams = max_streams
        self.default_max_tokens = 16
        self._seed = seed
        self.config = ModelConfig(
            name=name,
            max_batch_size=0,
            input=[TensorConfig("INPUT_IDS", "INT32", [-1])],
            output=[TensorConfig("TOKEN", "INT32", [1]),
                    TensorConfig("INDEX", "UINT32", [1])],
            decoupled=True,
        )
        # Built without storage, then filled once from the seeded draw.
        with torch.device("meta"):
            self.embed = nn.Parameter(torch.empty(vocab, d_model))
            self.pos = nn.Parameter(torch.empty(max_seq_len, d_model))
            self.layers = nn.ModuleList(GptLayer(d_model, d_ff)
                                        for _ in range(n_layers))
            self.lnf = nn.LayerNorm(d_model, eps=1e-5)
            self.head = nn.Linear(d_model, vocab, bias=False)
        self.load_or_init_params(
            lambda: self.load_jax_params(self._init_params()))
        self.requires_grad_(False)
        self.to(device)
        if device.type == "cuda":  # build now, not inside the first request
            if attention_impl == "flash":
                _flash.load_kernel()
            if attn_impl == "fused":
                _decode.load_kernel()
            if self.kv_shards > 1:
                kv_shard.load_kernel()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params ---------------------------------------------------------------

    def _init_params(self) -> dict:
        """The JAX backend's params pytree, drawn in its order."""
        rng = np.random.default_rng(self._seed)
        d, f, v = self.d_model, self.d_ff, self.vocab

        def w(*shape, scale=None):
            scale = scale or 1.0 / math.sqrt(shape[0])
            return (rng.standard_normal(shape) * scale).astype(np.float32)

        layers = []
        for _ in range(self.n_layers):
            layers.append({
                "ln1g": np.ones(d, np.float32), "ln1b": np.zeros(d, np.float32),
                "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
                "ln2g": np.ones(d, np.float32), "ln2b": np.zeros(d, np.float32),
                "w1": w(d, f), "w2": w(f, d),
            })
        return {
            "embed": w(v, d, scale=0.02),
            "pos": w(self.max_seq_len, d, scale=0.02),
            "layers": layers,
            "lnfg": np.ones(d, np.float32), "lnfb": np.zeros(d, np.float32),
            "head": w(d, v),
        }

    def load_jax_params(self, tree) -> None:
        """Take the JAX ``TinyGptBackend``'s params pytree (numpy or
        tensor leaves) as this module's weights."""
        self.load_state_dict(params_from_jax(tree))

    def params_to_jax(self) -> dict:
        """This module's weights as the JAX ``TinyGptBackend``'s params
        pytree (the inverse of :func:`params_from_jax`)."""
        layers = []
        for lp in self.layers:
            layer = {"ln1g": lp.ln1.weight, "ln1b": lp.ln1.bias,
                     "ln2g": lp.ln2.weight, "ln2b": lp.ln2.bias}
            for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
                layer[key] = getattr(lp, key).weight.T
            layers.append({k: v.detach() for k, v in layer.items()})
        return {"embed": self.embed.detach(), "pos": self.pos.detach(),
                "layers": layers, "lnfg": self.lnf.weight.detach(),
                "lnfb": self.lnf.bias.detach(),
                "head": self.head.weight.detach().T}

    # -- shared blocks ----------------------------------------------------------

    def _attend_causal(self, q, k, v) -> torch.Tensor:
        """Causal attention over ``[B, n, H, D]``."""
        if self.attention_impl == "flash":
            return _flash.flash_attention(q, k, v, causal=True)
        n = q.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.head_dim)
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)

    def _stack(self, x: torch.Tensor, on_kv=None) -> torch.Tensor:
        """The full-context causal stack over ``[B, n, d]``; ``on_kv(li, k,
        v)`` sees each layer's K/V (``[B, n, H, D]``)."""
        b, n, _ = x.shape
        shape = (b, n, self.n_heads, self.head_dim)
        for li, lp in enumerate(self.layers):
            h = lp.ln1(x)
            q, k, v = (lp.wq(h).view(shape), lp.wk(h).view(shape),
                       lp.wv(h).view(shape))
            if on_kv is not None:
                on_kv(li, k, v)
            o = self._attend_causal(q, k, v)
            x = x + lp.wo(o.reshape(b, n, self.d_model))
            x = x + lp.ffn(x)
        return x

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed[ids.long()] + self.pos[:ids.shape[-1]]

    def _sample(self, logits, lanes: LaneParams, ctx_len, sample: bool):
        if sample:
            return sample_tokens(logits, lanes.seeds, ctx_len, lanes.temps,
                                 lanes.top_ks, lanes.top_ps)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The full-context forward (no cache): logits at every position of
        ``INPUT_IDS`` ``[n]`` or ``[B, n]``."""
        return {"logits": self.forward_full(inputs["INPUT_IDS"])}

    @torch.inference_mode()
    def forward_full(self, ids: torch.Tensor) -> torch.Tensor:
        squeeze = ids.dim() == 1
        x = self._stack(self._embed(ids[None] if squeeze else ids))
        logits = self.head(self.lnf(x))
        return logits[0] if squeeze else logits

    # -- generative interface (GenerativeScheduler) ----------------------------

    def arena_rows(self, capacity: int | None = None) -> tuple[list[int], int]:
        """(free_rows, dummy_row) of the arena :meth:`init_arena` builds.
        Sharded, the free rows skip each shard's junk row: the scheduler
        must not assume ``row == lane``."""
        cap = self.max_streams if capacity is None else int(capacity)
        _total, free, dummy = kv_shard.arena_row_layout(cap, self.kv_shards)
        return free, dummy

    def _mesh(self) -> kv_shard.KvMesh:
        if self._kv_mesh is None:
            devices = ([self.device] * self.kv_shards
                       if self.device.type == "cpu" else None)
            self._kv_mesh = kv_shard.kv_mesh(self.kv_shards, devices)
        mesh = self._kv_mesh
        if mesh.size != self.kv_shards or mesh.devices[0] != self.device:
            raise ValueError(
                f"the kv mesh {[str(d) for d in mesh.devices]} must have "
                f"{self.kv_shards} shards, the first on {self.device}")
        return mesh

    def init_arena(self, capacity: int) -> KvArena | kv_shard.ShardedKvArena:
        """The arena on the device: k / v ``[L, R, S, H, D]`` zeros and
        ``tok`` ``[R]``; with ``kv_shards > 1`` split by rows over the mesh
        (``tok`` stays on this backend's device)."""
        total, _free, _dummy = kv_shard.arena_row_layout(capacity,
                                                         self.kv_shards)
        shape = (self.n_layers, total, self.max_seq_len, self.n_heads,
                 self.head_dim)
        arena = KvArena(k=torch.zeros(shape, device=self.device),
                        v=torch.zeros(shape, device=self.device),
                        tok=torch.zeros(total, dtype=torch.int32,
                                        device=self.device))
        if self.kv_shards > 1:
            return kv_shard.shard_arena(arena, self._mesh())
        return arena

    def wave_index(self, arena, rows, lens
                   ) -> WaveIndex | kv_shard.ShardedWaveIndex:
        """Check ``rows`` / ``lens`` (host arrays) against ``arena`` and
        stage them to the device; sharded, with each shard's local index."""
        index = WaveIndex(rows, lens, arena.tok.shape[0], self.max_seq_len,
                          self.device)
        if self.kv_shards > 1:
            return kv_shard.ShardedWaveIndex(index, self._mesh())
        return index

    def lane_params(self, seeds, temps, top_ks, top_ps) -> LaneParams:
        """Stage one dispatch's per-lane sampling parameters (host
        arrays) to the device."""
        return LaneParams(seeds, temps, top_ks, top_ps, self.device)

    @torch.inference_mode()
    def prefill(self, arena: KvArena, index: WaveIndex, ids: torch.Tensor,
                lanes: LaneParams, sample: bool = True) -> torch.Tensor:
        """Batched prefill: ``ids`` ``[B, n]`` (prompts padded to the
        bucket ``n``), ``index`` rows and prompt lengths. Writes each
        prompt's K/V into ``arena[:, rows, :n]`` and its first token into
        ``arena.tok``; returns the first tokens ``[B]`` int32, sampled with
        ``ctx_len = lens``."""
        rows = index.rows.long()
        n = ids.shape[1]

        def on_kv(li, k, v):
            if self.kv_shards == 1:
                arena.k[li, rows, :n] = k
                arena.v[li, rows, :n] = v
                return
            # Every shard takes every lane; the lanes it does not own land
            # on its junk row, which is never read.
            for k_sh, v_sh, local in zip(arena.k, arena.v, index.shards):
                loc = local.rows.long()
                k_sh[li, loc, :n] = k.to(k_sh.device)
                v_sh[li, loc, :n] = v.to(v_sh.device)

        x = self._stack(self._embed(ids), on_kv)
        lens = index.lens.long()
        last = x[torch.arange(x.shape[0], device=x.device), lens - 1]
        logits = self.head(self.lnf(last))
        tokens = self._sample(logits, lanes, lens, sample)
        arena.tok[rows] = tokens
        return tokens

    @torch.inference_mode()
    def decode(self, arena: KvArena, index: WaveIndex, lanes: LaneParams,
               sample: bool = True) -> torch.Tensor:
        """One decode wave: each lane's input token comes from
        ``arena.tok[rows]``; its K/V lands at ``(rows, lens)``; the next
        token, sampled with ``ctx_len = lens + 1``, goes back to
        ``arena.tok``. Returns it, ``[B]`` int32."""
        rows, lens = index.rows.long(), index.lens.long()
        b = rows.shape[0]
        shape = (b, self.n_heads, self.head_dim)
        if self.kv_shards > 1:
            mesh = self._mesh()

            def attend(q, k, v, layer):
                return kv_shard.sharded_decode_attention(
                    mesh, arena, q, k, v, index, layer=layer,
                    combine=self.kv_combine)
        else:
            wave = (_decode.decode_wave_attention if self.attn_impl == "fused"
                    else _decode.decode_wave_attention_plain)

            def attend(q, k, v, layer):
                return wave(arena.k, arena.v, q, k, v, index, layer=layer)
        x = self.embed[arena.tok[rows].long()] + self.pos[lens]
        for li, lp in enumerate(self.layers):
            h = lp.ln1(x)
            q, k, v = (lp.wq(h).view(shape), lp.wk(h).view(shape),
                       lp.wv(h).view(shape))
            o = attend(q, k, v, li)
            x = x + lp.wo(o.reshape(b, self.d_model))
            x = x + lp.ffn(x)
        logits = self.head(self.lnf(x))
        nxt = self._sample(logits, lanes, lens + 1, sample)
        arena.tok[rows] = nxt
        return nxt

    @torch.inference_mode()
    def decode_chunk(self, arena: KvArena, index: WaveIndex,
                     lanes: LaneParams, sample: bool = True,
                     k: int = 2) -> torch.Tensor:
        """``k`` decode waves chained on the device with no host sync; each
        step reads the tokens the previous one wrote. Returns ``[k, B]``."""
        steps = [self.decode(arena, index.shifted(i) if i else index, lanes,
                             sample) for i in range(k)]
        return torch.stack(steps)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX ``TinyGptBackend`` params pytree as this module's
    ``state_dict``. JAX computes ``x @ w`` with ``w: [in, out]``;
    ``nn.Linear`` keeps ``[out, in]``, so dense weights are transposed."""
    t = leaf_tensor
    out = {"embed": t(tree["embed"]), "pos": t(tree["pos"]),
           "lnf.weight": t(tree["lnfg"]), "lnf.bias": t(tree["lnfb"]),
           "head.weight": t(tree["head"]).T.contiguous()}
    for i, lp in enumerate(tree["layers"]):
        pre = f"layers.{i}."
        for ln in ("ln1", "ln2"):
            out[pre + ln + ".weight"] = t(lp[ln + "g"])
            out[pre + ln + ".bias"] = t(lp[ln + "b"])
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            out[pre + key + ".weight"] = t(lp[key]).T.contiguous()
    return out


register_model("tiny_gpt")(lambda device: TinyGptBackend(device=device))
# Long-context generation: seq 2048, prefill through the fp32 flash kernel
# so the [B, H, S, S] scores never reach device memory. Loaded by name only.
register_model("tiny_gpt_long", default=False)(
    lambda device: TinyGptBackend(name="tiny_gpt_long", max_seq_len=2048,
                                  max_streams=16, attention_impl="flash",
                                  device=device))
