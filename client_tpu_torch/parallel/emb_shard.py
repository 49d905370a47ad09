"""Row-sharded embedding tables: shard-local gather and segment sum, then
a combine across the shards.

Counterpart of ``client_tpu/parallel/emb_shard.py``. A DLRM backend's
stacked table (every table concatenated row-wise,
``[num_tables * rows_per_table, dim]``) is split by rows over the ``n``
shards of an ``"emb"`` mesh, and the ragged bag lookup runs on every
shard:

- each shard gathers the lookups whose global row falls in its row range
  (an unowned lookup reads local row 0 and is masked to zero, so every
  shard gathers the same number of rows);
- each shard sums its owned vectors into the per-bag pooled matrix
  (``num_segments = max_batch_size * num_tables`` bags) with
  ``index_add_``;
- the per-shard partials are summed, since one bag's lookups may span
  shards: ``combine="ring"`` through :func:`kv_shard.ring_all_reduce`,
  kernel K3 on the card, or ``combine="psum"``, a plain sum, the
  counterpart of ``jax.lax.psum``.

As in ``kv_shard``, the port drives every shard from the one process and
stream that calls it, and a mesh may repeat one device (:func:`emb_mesh`);
a mesh over distinct cards is not built yet.

Exactness rests on :func:`quantize_table`. ``index_add_`` on a CUDA tensor
adds with atomics in no fixed order, and the combine adds the shards in
another order than one device would; the sums are still exact, and so
sharded and unsharded (and the port and the JAX package) agree bit for
bit, because every table value is a multiple of 2^-8 and every sum stays
under 2^15 in magnitude.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from client_tpu_torch.parallel.kv_shard import (
    KvMesh,
    kv_mesh,
    ring_all_reduce,
)


def emb_mesh(n_shards: int,
             devices: Sequence[torch.device | str] | None = None) -> KvMesh:
    """A 1-D ``"emb"`` mesh of ``n_shards``: the first ``n_shards`` CUDA
    devices by default (ValueError when there are fewer), else ``devices``,
    which may repeat one device. NotImplementedError for distinct
    devices."""
    return kv_mesh(n_shards, devices, axis="emb")


def quantize_table(table) -> np.ndarray:
    """Snap table values to 1/256 steps: integer multiples of 2^-8 add
    exactly in fp32 until |sum| reaches 2^15, so no order of additions
    can change a sum."""
    return (np.round(np.asarray(table, np.float32) * 256.0) / 256.0).astype(
        np.float32)


def shard_table(table, mesh: KvMesh) -> list[torch.Tensor]:
    """The stacked table split by rows over the mesh: shard ``i`` holds
    rows ``[i * r, (i + 1) * r)`` on its device, contiguous. The row count
    must divide evenly (pad with zero rows first; they are never
    indexed)."""
    t = torch.as_tensor(table)
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(
            f"stacked table rows ({t.shape[0]}) must divide evenly "
            f"over emb_shards ({n})")
    return [part.to(device=dev, memory_format=torch.contiguous_format,
                    copy=True)
            for part, dev in zip(torch.tensor_split(t, n, dim=0),
                                 mesh.devices)]


def _pool(table: torch.Tensor, local_rows: torch.Tensor,
          take: torch.Tensor, seg_ids: torch.Tensor,
          num_segments: int) -> torch.Tensor:
    """Gather ``local_rows`` of ``table`` and sum the rows where ``take``
    holds into their segments; the other lookups add nothing (masked, never
    scattered out of bounds)."""
    vecs = table.index_select(0, torch.where(take, local_rows, 0))
    vecs = torch.where(take[:, None], vecs, 0.0)
    out = torch.zeros((num_segments, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return out.index_add_(0, torch.where(take, seg_ids, 0), vecs)


def bag_sum_oracle(table: torch.Tensor, rows: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """One device: gather ``rows`` from the stacked table and sum them into
    ``num_segments`` bags. A lookup whose segment id is not below
    ``num_segments`` is padding and adds nothing."""
    rows, seg_ids = rows.long(), seg_ids.long()
    return _pool(table, rows, seg_ids < num_segments, seg_ids, num_segments)


def sharded_bag_sum(mesh: KvMesh, shards: Sequence[torch.Tensor],
                    rows: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, *, combine: str = "psum"
                    ) -> torch.Tensor:
    """The sharded bag lookup: the result of :func:`bag_sum_oracle` on the
    whole table, from ``shards`` (:func:`shard_table`) over ``mesh``.
    ``rows`` and ``seg_ids`` go to every shard (a lookup bucket long, tiny
    next to the table). Returns the pooled ``[num_segments, dim]`` on the
    mesh's first device."""
    if combine not in ("ring", "psum"):
        raise ValueError(f"combine must be 'ring' or 'psum', "
                         f"got {combine!r}")
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} table shards on a mesh of "
                         f"{mesh.size}")
    r_loc = shards[0].shape[0]
    parts = []
    for i, (tbl, dev) in enumerate(zip(shards, mesh.devices)):
        r = rows.to(dev).long()
        seg = seg_ids.to(dev).long()
        lo = i * r_loc
        owned = (seg < num_segments) & (r >= lo) & (r < lo + r_loc)
        parts.append(_pool(tbl, r - lo, owned, seg, num_segments))
    if combine == "ring":
        return ring_all_reduce(parts)[0]
    first = mesh.devices[0]
    return torch.stack([p.to(first) for p in parts]).sum(0)
