"""Ragged batching: gather DLRM requests by their summed lookups.

Counterpart of ``client_tpu/engine/ragged.py``. A CSR request's device
cost follows its lookups (the length of its indices), not its rows, so
:class:`RaggedScheduler` gathers requests until their summed lookups reach
the preferred lookup bucket (``ModelConfig.max_lookups``,
``padding_axis="lookups"``), rows still capped at ``max_batch_size``. A
request that would overflow either ceiling goes back to the head of the
queue, with everything behind it, and starts the next batch: split, never
dropped.

Downstream it is the ordinary bucket machinery along the lookups axis:
``Model.pick_bucket`` snaps the summed lookups to the ladder and the
backend's ``pre_stage`` pads indices and segment ids to the bucket and rows
to ``max_batch_size``. Outputs are row-shaped, so each request's rows are
windowed by row offset. An execution's device time is split across its
requests' tenants by lookups, the padded axis. Priority levels, the
queue policies and QoS lanes with preemption work as in the dynamic
batcher.
"""

from __future__ import annotations

import queue

import numpy as np

from client_tpu_torch.engine.model import Model
from client_tpu_torch.engine.scheduler import (
    _SHUTDOWN,
    DefaultScheduler,
    _batch_deadline,
)
from client_tpu_torch.engine.stats import ModelStats
from client_tpu_torch.engine.types import InferRequest, now_ns


def request_nnz(req: InferRequest, indices_name: str) -> int:
    """The lookups a request brings: the length of its indices."""
    arr = req.inputs.get(indices_name)
    return int(arr.shape[0]) if arr is not None else 0


class RaggedScheduler(DefaultScheduler):
    """Dynamic batching over summed lookups (see the module docstring).
    The backend names its CSR tensors ``indices_name`` and
    ``offsets_name`` (``INDICES`` and ``OFFSETS`` by default); every
    other input is row-shaped and concatenates along axis 0."""

    def __init__(self, model: Model, stats: ModelStats, qos=None):
        self._indices = getattr(model.backend, "indices_name", "INDICES")
        self._offsets = getattr(model.backend, "offsets_name", "OFFSETS")
        # Rows come from a row-shaped input, never from a ragged one.
        self._row_input = next(t.name for t in model.config.input
                               if not t.ragged)
        super().__init__(model, stats, qos=qos)

    def _rows(self, req: InferRequest) -> int:
        return int(req.inputs[self._row_input].shape[0])

    def _gather(self, first: InferRequest, dyn
                ) -> tuple[list[InferRequest], bool]:
        cfg = self.model.config
        max_lookups = cfg.max_lookups
        max_rows = cfg.max_batch_size
        prefer = min(max(dyn.preferred_batch_size)
                     if dyn.preferred_batch_size else max_lookups,
                     max_lookups)
        deadline_ns = now_ns() + dyn.max_queue_delay_microseconds * 1000
        batch = [first]
        nnz = request_nnz(first, self._indices)
        rows = self._rows(first)
        preemptable = (self.qos is not None
                       and not self.qos.is_preempt(first.qos_class))
        while nnz < prefer:
            if preemptable:
                pending = self.queue.preempt_pending()
                if pending is not None:
                    self.qos.note_preemption(cfg.name, pending)
                    break
            timeout = max((deadline_ns - now_ns()) / 1e9, 0.0)
            try:
                # Lookups per request vary widely, so the slab is bounded
                # by the rows still allowed.
                items = self.queue.get_many(max(1, max_rows - rows),
                                            timeout=timeout)
            except queue.Empty:
                break
            for idx, item in enumerate(items):
                if item is _SHUTDOWN:
                    for later in items[idx + 1:]:
                        self._requeue(later)
                    return batch, True
                if self._check_timeout(item) or self._check_cancelled(item) \
                        or self._check_deadline(item) \
                        or self._check_dequeue_fault(item):
                    continue
                if nnz >= prefer \
                        or nnz + request_nnz(item, self._indices) \
                        > max_lookups \
                        or rows + self._rows(item) > max_rows:
                    # A ceiling would overflow: this request and everything
                    # behind it start the next batch, in order (one whose
                    # deadline passed fails here instead).
                    for later in reversed(items[idx:]):
                        if later is _SHUTDOWN \
                                or not self._check_deadline(later):
                            self._requeue(later)
                    return batch, False
                batch.append(item)
                nnz += request_nnz(item, self._indices)
                rows += self._rows(item)
        return batch, False

    def _execute_batch(self, batch: list[InferRequest]) -> None:
        start = now_ns()
        for r in batch:
            r.times.compute_start = start
        row_sizes = [self._rows(r) for r in batch]
        nnz = [request_nnz(r, self._indices) for r in batch]
        total_nnz = sum(nnz)
        merged: dict[str, np.ndarray] = {}
        for name in batch[0].inputs:
            if name == self._offsets:
                # Each request's offsets restart at 0: the merged offsets
                # are the running sum of every bag's count after one 0.
                counts = [np.diff(np.asarray(r.inputs[name], np.int64))
                          for r in batch]
                merged[name] = np.concatenate(
                    [np.zeros(1, np.int64)] + counts).cumsum().astype(
                        batch[0].inputs[name].dtype)
            else:
                merged[name] = (batch[0].inputs[name] if len(batch) == 1
                                else np.concatenate(
                                    [np.asarray(r.inputs[name])
                                     for r in batch], axis=0))
        # batch_size counts lookups: pick_bucket snaps it to the ladder.
        outputs, phases = self.model.execute_timed(
            merged, batch_size=total_nnz, deadline_ns=_batch_deadline(batch))
        # The statistics keep rows, as every other scheduler's do.
        self.stats.record_execution(
            sum(row_sizes), compute_ns=phases.infer_end - phases.input_end)
        offset = 0
        for r, sz in zip(batch, row_sizes):
            per = {k: v[offset:offset + sz] for k, v in outputs.items()}
            offset += sz
            self._finish(r, per, phases)
        self._charge(batch, nnz, phases, start,
                     self.model.pick_bucket(total_nnz) - total_nnz)
