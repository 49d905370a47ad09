"""DLRM: ragged CSR embedding-bag lookups, a bottom and a top MLP.

Counterpart of ``client_tpu/models/dlrm.py``. Per request, each of
``num_tables`` sparse features brings a bag of embedding-row ids of any
length; the model sums each bag, crosses the pooled vectors with the
bottom MLP's dense feature through pairwise dot products and scores the
result with the top MLP. Its cost follows the total lookups, not the
rows, so the model pads along ``padding_axis="lookups"`` and the
``RaggedScheduler`` (``engine/ragged.py``) batches it.

Wire format, both frontends:

- ``DENSE``   FP32 ``[dense_dim]``, batched to ``[B, dense_dim]``;
- ``INDICES`` INT32 ragged ``[total_nnz]``, every bag's ids concatenated
  row-major over the ``[B, num_tables]`` bags;
- ``OFFSETS`` INT32 ragged ``[B * num_tables + 1]``, the CSR bag starts
  (``OFFSETS[0] == 0``, the last element ``== total_nnz``);
- ``OUTPUT0`` FP32 ``[B, 1]``, the score.

``pre_stage`` turns CSR into fixed shapes: lookups pad to the bucket with
row 0 and the sentinel segment id ``max_batch_size * num_tables`` (masked,
never scattered), rows pad to ``max_batch_size``. The stacked table
``[num_tables * table_rows, emb_dim]`` lives in one of three modes:

- on the device (default): a buffer on the model's device; the bag sums
  are ``parallel.emb_shard.bag_sum_oracle`` (``index_select`` and
  ``index_add_``, plain XLA in the JAX package too);
- row-sharded (``emb_shards=N``): split over an ``"emb"`` mesh, summed by
  ``sharded_bag_sum``; with ``combine="ring"`` the partials are combined
  by kernel K3, once per execution;
- on the host (``host_tables=True``): ``pre_stage`` resolves the lookups
  through the ``RowCache`` and the device only pools the vectors.

Weights come from ``numpy.random.default_rng(seed)`` in the JAX package's
order, so both packages build the same model; the table is quantized to
1/256 steps (``emb_shard.quantize_table``), which makes every mode's bag
sums exact.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorConfig,
)
from client_tpu_torch.engine.model import ModelBackend
from client_tpu_torch.engine.rowcache import RowCache
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.models import register_model
from client_tpu_torch.observability.memory import hbm_census
from client_tpu_torch.parallel.emb_shard import (
    bag_sum_oracle,
    emb_mesh,
    quantize_table,
    shard_table,
    sharded_bag_sum,
)


def _init_mlp(rng, units: list[int]) -> nn.ModuleList:
    """One ``nn.Linear`` per layer from the JAX package's ``(w, b)`` init:
    ``w [in, out]`` standard normal over sqrt(in), ``b`` zeros."""
    layers = nn.ModuleList()
    for d_in, d_out in zip(units, units[1:]):
        w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
            np.float32)
        lin = nn.Linear(d_in, d_out, device="meta")
        lin.weight = nn.Parameter(torch.from_numpy(w.T.copy()),
                                  requires_grad=False)
        lin.bias = nn.Parameter(torch.zeros(d_out), requires_grad=False)
        layers.append(lin)
    return layers


def _mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class DlrmBackend(ModelBackend):
    """An EmbeddingBag DLRM (see the module docstring). ``emb_devices``
    places the ``emb_shards`` shards (it may repeat one device); by
    default they are the first ``emb_shards`` CUDA devices, or ``cpu``
    repeated on ``device="cpu"``."""

    indices_name = "INDICES"
    offsets_name = "OFFSETS"

    def __init__(self, name: str = "dlrm", num_tables: int = 4,
                 table_rows: int = 64, emb_dim: int = 8, dense_dim: int = 8,
                 max_batch_size: int = 8, max_lookups: int = 128,
                 emb_shards: int = 0, combine: str = "psum",
                 host_tables: bool = False, cache_budget_bytes: int = 0,
                 bottom_units: tuple = (16,), top_units: tuple = (16,),
                 seed: int = 0, max_queue_delay_us: int = 200,
                 device: str | torch.device | None = None,
                 emb_devices=None):
        super().__init__()
        self.device = resolve_device(device)
        if combine not in ("ring", "psum"):
            raise ValueError(f"combine must be 'ring' or 'psum', "
                             f"got {combine!r}")
        self.num_tables = int(num_tables)
        self.table_rows = int(table_rows)
        self.emb_dim = int(emb_dim)
        self.dense_dim = int(dense_dim)
        self.emb_shards = int(emb_shards)
        self.combine = combine
        self.host_tables = bool(host_tables)
        self.cache_budget_bytes = int(cache_budget_bytes)
        self.config = ModelConfig(
            name=name,
            max_batch_size=int(max_batch_size),
            padding_axis="lookups",
            max_lookups=int(max_lookups),
            input=[TensorConfig("DENSE", "FP32", [self.dense_dim]),
                   TensorConfig("INDICES", "INT32", [-1], ragged=True),
                   TensorConfig("OFFSETS", "INT32", [-1], ragged=True)],
            output=[TensorConfig("OUTPUT0", "FP32", [1])],
            dynamic_batching=DynamicBatchingConfig(
                max_queue_delay_microseconds=int(max_queue_delay_us)),
            instance_count=1,
        )
        rng = np.random.default_rng(seed)
        stacked_rows = self.num_tables * self.table_rows
        if self.emb_shards > 1 and stacked_rows % self.emb_shards:
            # Zero rows (never indexed) up to an even row partition.
            stacked_rows += self.emb_shards - stacked_rows % self.emb_shards
        table = np.zeros((stacked_rows, self.emb_dim), np.float32)
        table[: self.num_tables * self.table_rows] = quantize_table(
            rng.standard_normal(
                (self.num_tables * self.table_rows, self.emb_dim)) * 0.5)
        self.table_host = table
        self.bottom = _init_mlp(
            rng, [self.dense_dim, *bottom_units, self.emb_dim])
        n_pairs = (self.num_tables + 1) * self.num_tables // 2
        self.top = _init_mlp(rng, [self.emb_dim + n_pairs, *top_units, 1])
        iu, ju = np.triu_indices(self.num_tables + 1, k=1)
        self.register_buffer("pair_i", torch.from_numpy(iu), persistent=False)
        self.register_buffer("pair_j", torch.from_numpy(ju), persistent=False)
        self.row_cache = None
        self.mesh = None
        self.n_shards = 0
        if self.host_tables:
            self.row_cache = RowCache(self.table_host,
                                      self.cache_budget_bytes)
        elif self.emb_shards > 1:
            if emb_devices is None and self.device.type == "cpu":
                emb_devices = [self.device] * self.emb_shards
            self.mesh = emb_mesh(self.emb_shards, emb_devices)
            if self.mesh.devices[0] != self.device:
                raise ValueError(
                    f"the emb mesh {[str(d) for d in self.mesh.devices]} "
                    f"must start on {self.device}")
            for i, part in enumerate(shard_table(table, self.mesh)):
                self.register_buffer(f"table_shard{i}", part)
            self.n_shards = self.emb_shards
        else:
            self.register_buffer("table", torch.from_numpy(table).to(
                self.device))
        self.to(self.device)
        if not self.host_tables:
            # The tables in the HBM census as `embedding`; the model's
            # generic `weights` pass leaves them so.
            hbm_census().tag(name, "embedding",
                             self.shards() if self.n_shards else [self.table])

    def hbm_reservation_bytes(self) -> int:
        """The card memory the model should be charged: the tables' bytes
        on the device, or the host-table mode's cache budget (the census
        holds it against the actual ``embedding`` rows)."""
        if self.host_tables:
            return self.cache_budget_bytes
        return int(self.table_host.nbytes)

    def shards(self) -> list[torch.Tensor]:
        return [getattr(self, f"table_shard{i}")
                for i in range(self.n_shards)]

    # -- ragged validation (the Model.validate_inputs hook) -------------------

    def validate_ragged(self, inputs: dict, batch: int) -> None:
        cfg = self.config
        idx = inputs.get("INDICES")
        off = inputs.get("OFFSETS")
        if idx is None or off is None:
            return  # the generic loop raises for a missing input
        idx = np.asarray(idx)
        off = np.asarray(off)
        want = batch * self.num_tables + 1
        if off.shape[0] != want:
            raise EngineError(
                f"OFFSETS length {off.shape[0]} != batch({batch}) * "
                f"num_tables({self.num_tables}) + 1 = {want}", 400)
        if off.shape[0] and off[0] != 0:
            raise EngineError("OFFSETS[0] must be 0", 400)
        if np.any(np.diff(off) < 0):
            raise EngineError("OFFSETS must be non-decreasing", 400)
        if off[-1] != idx.shape[0]:
            raise EngineError(
                f"OFFSETS[-1] ({int(off[-1])}) != len(INDICES) "
                f"({idx.shape[0]})", 400)
        if idx.shape[0] > cfg.max_lookups:
            # One request past the largest lookup bucket cannot be split
            # (the interaction couples its bags).
            raise EngineError(
                f"request carries {idx.shape[0]} lookups, exceeding "
                f"max_lookups {cfg.max_lookups} for '{cfg.name}'", 400)
        if idx.size and (idx.min() < 0 or idx.max() >= self.table_rows):
            raise EngineError(
                f"INDICES out of range [0, {self.table_rows})", 400)

    # -- staging (the Model.execute_timed hook) -------------------------------

    def pre_stage(self, inputs: dict, pad_to: int | None) -> dict:
        """CSR to the fixed layout: lookups pad to ``pad_to`` with row 0
        and the sentinel segment id ``max_batch_size * num_tables``, rows
        to ``max_batch_size``. Host tables: the real lookups (never the
        padding) resolve through the row cache into ``VECTORS``."""
        dense = np.asarray(inputs["DENSE"], np.float32)
        idx = np.asarray(inputs["INDICES"], np.int64)
        off = np.asarray(inputs["OFFSETS"], np.int64)
        b_max = self.config.max_batch_size
        t = self.num_tables
        nnz = int(idx.shape[0])
        lookups = int(pad_to) if pad_to else nnz
        # Each lookup's bag (b * T + t, row-major) from the offsets.
        seg = np.repeat(np.arange(off.shape[0] - 1, dtype=np.int32),
                        np.diff(off).astype(np.int64))
        # The stacked table's row: a bag's table is its bag id mod T.
        rows = (idx + (seg % t).astype(np.int64)
                * self.table_rows).astype(np.int32)
        if lookups > nnz:
            rows = np.concatenate([rows, np.zeros(lookups - nnz, np.int32)])
            seg = np.concatenate(
                [seg, np.full(lookups - nnz, b_max * t, np.int32)])
        if dense.shape[0] < b_max:
            dense = np.pad(dense, [(0, b_max - dense.shape[0]), (0, 0)])
        if self.row_cache is not None:
            vectors, _hits = self.row_cache.lookup_counted(rows[:nnz])
            if lookups > nnz:
                vectors = np.concatenate([vectors, np.zeros(
                    (lookups - nnz, self.emb_dim), vectors.dtype)])
            return {"DENSE": dense, "VECTORS": vectors, "SEG_IDS": seg}
        return {"DENSE": dense, "INDICES": rows, "SEG_IDS": seg}

    def synthetic_inputs(self, lookups: int) -> dict:
        """A zero CSR request of one row with exactly ``lookups`` lookups,
        the bags split evenly (warm-up at a lookup bucket)."""
        lookups = max(1, int(lookups))
        t = self.num_tables
        counts = np.full(t, lookups // t, np.int64)
        counts[: lookups % t] += 1
        off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts)]).astype(np.int32)
        return {"DENSE": np.zeros((1, self.dense_dim), np.float32),
                "INDICES": np.zeros(lookups, np.int32),
                "OFFSETS": off}

    # -- execution ------------------------------------------------------------

    def pooled(self, inputs: dict[str, torch.Tensor]) -> torch.Tensor:
        """The bag sums ``[max_batch_size * num_tables, emb_dim]`` of a
        staged batch, by the backend's table mode."""
        num_seg = self.config.max_batch_size * self.num_tables
        seg = inputs["SEG_IDS"].long()
        if self.row_cache is not None:
            vecs = inputs["VECTORS"]
            valid = seg < num_seg
            vecs = torch.where(valid[:, None], vecs, 0.0)
            out = torch.zeros((num_seg, self.emb_dim), dtype=vecs.dtype,
                              device=vecs.device)
            return out.index_add_(0, torch.where(valid, seg, 0), vecs)
        if self.mesh is not None:
            return sharded_bag_sum(self.mesh, self.shards(),
                                   inputs["INDICES"], seg, num_seg,
                                   combine=self.combine)
        return bag_sum_oracle(self.table, inputs["INDICES"], seg, num_seg)

    def forward(self, inputs: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        b_max = self.config.max_batch_size
        pooled = self.pooled(inputs).reshape(b_max, self.num_tables,
                                             self.emb_dim)
        bottom = _mlp(self.bottom, inputs["DENSE"])  # [Bmax, D]
        feats = torch.cat([bottom[:, None, :], pooled], dim=1)
        z = torch.bmm(feats, feats.transpose(1, 2))
        inter = z[:, self.pair_i, self.pair_j]  # the upper triangle
        out = _mlp(self.top, torch.cat([bottom, inter], dim=-1))
        return {"OUTPUT0": out}


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX backend's params (``make_apply_params()[1]``: ``bottom`` and
    ``top`` as ``[(w, b)]`` with ``w: [in, out]``, and ``table`` unless the
    tables are on the host) as this module's ``state_dict`` entries. The
    table becomes ``table``; a sharded one is split with
    :func:`shard_table` by the caller."""
    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())

    out = {}
    for key in ("bottom", "top"):
        for i, (w, b) in enumerate(params[key]):
            out[f"{key}.{i}.weight"] = t(w).T.contiguous()
            out[f"{key}.{i}.bias"] = t(b)
    if "table" in params:
        out["table"] = t(params["table"])
    return out


register_model("dlrm")(lambda device: DlrmBackend(device=device))
# Host tables behind the hot-row cache: a budget that holds the hot set of
# a Zipf workload, far smaller than the table. Loaded by name only.
register_model("dlrm_cached", default=False)(
    lambda device: DlrmBackend(name="dlrm_cached", host_tables=True,
                               cache_budget_bytes=4096, device=device))
