"""Sequence batching: stateful models scheduled by correlation id.

Counterpart of ``client_tpu/engine/sequence.py``. A request carries
``sequence_id`` and the ``sequence_start`` / ``sequence_end`` flags; every
request of a live sequence reaches the same state, in order. A stateful
backend defines ``initial_state()`` (one tensor) and ``step(state,
inputs) -> (state, outputs)``; the state stays on the model's device
between requests.

Two strategies, as Triton has:

- ``direct`` (:class:`SequenceScheduler`): each live sequence owns a slot
  with its state and a lock, so a sequence runs one step at a time; one
  execution per step.
- ``oldest`` (:class:`OldestSequenceScheduler`): the states of up to
  ``max_candidate_sequences`` live sequences are rows of one arena tensor
  on the card, plus one dummy row that takes the padded lanes. A wave
  batches one step of each of several sequences: gather their rows, reset
  the restarted ones to ``initial_state`` by ``where``, run the step
  batched (``torch.func.vmap``), write the new states back in place
  (``index_copy_``). Waves go out on the scheduler's CUDA stream, in
  order, and their outputs are copied to the host behind them; at most
  ``CLIENT_TPU_SEQ_PIPELINE`` waves are in flight, and no output is read
  before its wave's event. A wave never holds two steps of one sequence.

Idle sequences are evicted after ``max_sequence_idle_microseconds``,
never one with a step queued (``_PendingGuard``) or running.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import queue
import threading

import numpy as np
import torch

from client_tpu_torch.config import env_int
from client_tpu_torch.engine.scheduler import (
    _SHUTDOWN,
    Scheduler,
    power_buckets,
)
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
    now_ns,
)
from client_tpu_torch.utils import lockdep

_log = logging.getLogger("client_tpu_torch")


def _initial_state(model) -> torch.Tensor:
    return torch.as_tensor(model.backend.initial_state()).to(model.device)


def _zero_id_error(model) -> EngineError:
    return EngineError(
        f"model '{model.config.name}' uses sequence batching; requests "
        "must carry a non-zero sequence id", 400)


def _inactive_error(sid: int) -> EngineError:
    return EngineError(f"sequence {sid}: request without start flag for "
                       "an inactive sequence", 400)


class _SequenceSlot:
    __slots__ = ("state", "lock", "last_used_ns", "inflight")

    def __init__(self, state):
        self.state = state
        self.lock = lockdep.Lock("sequence.slot")
        self.last_used_ns = now_ns()
        # Executions holding this slot now: last_used_ns is written only
        # after a step, so a step that outlasts the idle window would look
        # idle by its timestamp alone.
        self.inflight = 0


class _PendingGuard:
    """Queued requests per sequence id (a mixin). A request queued longer
    than the idle window has no execution in flight yet, so the idle GC
    must also skip a sequence with requests pending. The host class
    supplies the lock (``_pending_lock``) and sets ``self._pending = {}``.
    """

    _pending: dict[int, int]

    def _pending_lock(self) -> threading.Lock:
        raise NotImplementedError

    def _pend_locked(self, sid: int) -> None:
        """The caller holds ``_pending_lock()``."""
        self._pending[sid] = self._pending.get(sid, 0) + 1

    def _unpend(self, sid: int) -> None:
        if not sid:
            return
        with self._pending_lock():
            n = self._pending.get(sid, 0) - 1
            if n > 0:
                self._pending[sid] = n
            else:
                self._pending.pop(sid, None)


def _respond_outputs(req: InferRequest, outputs: dict) -> dict:
    if req.outputs:
        requested = {o.name for o in req.outputs}
        return {k: v for k, v in outputs.items() if k in requested}
    return outputs


class SequenceScheduler(_PendingGuard, Scheduler):
    """The direct strategy: a slot per sequence, one execution per step."""

    def __init__(self, model, stats):
        self._slots: dict[int, _SequenceSlot] = {}
        self._slots_lock = lockdep.Lock("sequence.slots")
        self._pending: dict[int, int] = {}
        super().__init__(model, stats)

    def _pending_lock(self):
        return self._slots_lock

    def submit(self, req: InferRequest) -> None:
        # Arrival is a use: a request waiting in the queue must not watch
        # its sequence be evicted as idle.
        if req.sequence_id:
            with self._slots_lock:
                slot = self._slots.get(req.sequence_id)
                if slot is not None:
                    slot.last_used_ns = now_ns()
                self._pend_locked(req.sequence_id)
        try:
            super().submit(req)
        except Exception:
            self._unpend(req.sequence_id)  # refused at enqueue
            raise

    def _worker_loop(self) -> None:
        while True:
            req = self.queue.get_many(1)[0]
            if req is _SHUTDOWN:
                return
            # Unpend after the step, not at dequeue: in between, a
            # sibling worker's GC would see no pending, no inflight and a
            # stale timestamp.
            try:
                if self._check_timeout(req) or self._check_cancelled(req):
                    continue
                try:
                    self._run_one(req)
                except Exception as exc:  # noqa: BLE001 — the worker lives
                    self._fail(req, exc)
            finally:
                self._unpend(req.sequence_id)

    def _get_slot(self, req: InferRequest) -> _SequenceSlot:
        sid = req.sequence_id
        with self._slots_lock:
            slot = self._slots.get(sid)
            if req.sequence_start or slot is None:
                if slot is None and not req.sequence_start:
                    raise _inactive_error(sid)
                slot = _SequenceSlot(_initial_state(self.model))
                self._slots[sid] = slot
            # Claimed before the GC runs, so neither this slot nor any with
            # a step in flight is evicted.
            slot.inflight += 1
            self._gc_idle_locked()
            return slot

    def _put_slot(self, slot: _SequenceSlot) -> None:
        with self._slots_lock:
            slot.inflight -= 1
            slot.last_used_ns = now_ns()

    def _gc_idle_locked(self) -> None:
        sb = self.model.config.sequence_batching
        cutoff = now_ns() - sb.max_sequence_idle_microseconds * 1000
        dead = [sid for sid, s in self._slots.items()
                if s.last_used_ns < cutoff and s.inflight == 0
                and self._pending.get(sid, 0) == 0]
        for sid in dead:
            del self._slots[sid]

    def _run_one(self, req: InferRequest) -> None:
        if req.sequence_id == 0:
            raise _zero_id_error(self.model)
        slot = self._get_slot(req)
        start = now_ns()
        req.times.compute_start = start
        try:
            # One step of a sequence at a time, in order: the step is this
            # lock's critical section by design, so blocking under it (the
            # model.execute latency fault's sleep) is reviewed.
            with slot.lock, lockdep.allow_blocking():
                slot.state, outputs = self.model.execute_stateful(
                    slot.state, req.inputs)
        finally:
            self._put_slot(slot)
        if req.sequence_end:
            with self._slots_lock:
                self._slots.pop(req.sequence_id, None)
        req.times.compute_input_end = start
        req.times.compute_infer_end = now_ns()
        req.times.compute_output_end = req.times.compute_infer_end
        self.stats.record_execution(
            1, compute_ns=req.times.compute_infer_end - start)
        self.stats.record_request(req.times, success=True)
        self._respond(req, InferResponse(
            model_name=req.model_name,
            model_version=req.model_version or str(self.model.config.version),
            request_id=req.request_id,
            outputs=_respond_outputs(req, outputs), times=req.times))

    def active_sequences(self) -> int:
        with self._slots_lock:
            return len(self._slots)

    def _release(self) -> None:
        with self._slots_lock:
            self._slots.clear()


class OldestSequenceScheduler(_PendingGuard, Scheduler):
    """The oldest strategy over a state arena on the card (see the module
    docstring). One worker owns the arena."""

    single_instance = True

    def __init__(self, model, stats):
        sb = model.config.sequence_batching
        self._cap = max(1, sb.max_candidate_sequences)
        self._delay_ns = sb.max_queue_delay_microseconds * 1000
        self._init = _initial_state(model)
        self._arena = torch.zeros((self._cap + 1, *self._init.shape),
                                  dtype=self._init.dtype, device=model.device)
        self._vstep = torch.func.vmap(model.backend.step)
        self._step = self._arena_step
        self._buckets = power_buckets(self._cap)
        self._free = list(range(self._cap))
        self._rows: dict[int, int] = {}       # sequence_id -> arena row
        self._last_used: dict[int, int] = {}  # sequence_id -> ns
        self._pending: dict[int, int] = {}
        self._arena_lock = lockdep.Lock("sequence.arena")
        # (live requests, host outputs, done event or None, t_stacked)
        self._inflight_waves: collections.deque = collections.deque()
        # Depth 2: one wave running while the next assembles; deeper
        # pipelines fragment the waves (the worker dispatches whatever
        # trickled in instead of letting the queue fill).
        self._depth = max(1, env_int("CLIENT_TPU_SEQ_PIPELINE"))
        super().__init__(model, stats)

    # -- the device step ------------------------------------------------------

    def _arena_step(self, arena: torch.Tensor, rows: torch.Tensor,
                    reset: torch.Tensor, inputs: dict[str, torch.Tensor]):
        """gather -> reset by ``where`` -> batched step -> scatter in
        place; returns ``(arena, outputs)``."""
        state = arena.index_select(0, rows)
        r = reset.reshape((-1,) + (1,) * (state.ndim - 1))
        state = torch.where(r, self._init.expand_as(state), state)
        new_state, outputs = self._vstep(state, inputs)
        arena.index_copy_(0, rows, new_state.to(arena.dtype))
        return arena, outputs

    # -- rows -----------------------------------------------------------------

    def _acquire_row(self, req: InferRequest,
                     protect: set[int] | None = None) -> tuple[int, bool]:
        """(arena row, reset?) for the request's sequence. ``protect``
        holds the sequence ids of the wave being assembled: the idle GC
        must not evict them, whatever their timestamps say."""
        sid = req.sequence_id
        if sid == 0:
            raise _zero_id_error(self.model)
        with self._arena_lock:
            row = self._rows.get(sid)
            if row is None:
                if not req.sequence_start:
                    raise _inactive_error(sid)
                self._gc_idle_locked(protect)
                if not self._free:
                    raise EngineError(
                        f"max candidate sequences ({self._cap}) exceeded",
                        429)
                row = self._free.pop()
                self._rows[sid] = row
            self._last_used[sid] = now_ns()
            return row, bool(req.sequence_start)

    def _release_row(self, sid: int) -> None:
        with self._arena_lock:
            row = self._rows.pop(sid, None)
            self._last_used.pop(sid, None)
            if row is not None:
                self._free.append(row)

    def _gc_idle_locked(self, protect: set[int] | None = None) -> None:
        sb = self.model.config.sequence_batching
        cutoff = now_ns() - sb.max_sequence_idle_microseconds * 1000
        dead = [sid for sid, ts in self._last_used.items()
                if ts < cutoff and (protect is None or sid not in protect)
                and self._pending.get(sid, 0) == 0]
        for sid in dead:
            row = self._rows.pop(sid, None)
            self._last_used.pop(sid, None)
            if row is not None:
                self._free.append(row)

    # -- scheduling -----------------------------------------------------------

    def _pending_lock(self):
        return self._arena_lock

    def submit(self, req: InferRequest) -> None:
        if req.sequence_id:
            with self._arena_lock:
                if req.sequence_id in self._last_used:
                    self._last_used[req.sequence_id] = now_ns()
                self._pend_locked(req.sequence_id)
        try:
            super().submit(req)
        except Exception:
            self._unpend(req.sequence_id)  # refused at enqueue
            raise

    def _worker_loop(self) -> None:
        while True:
            # At depth, block on the oldest wave before gathering more: its
            # responses release the clients' next steps, so the queue fills
            # meanwhile and the next wave stays large.
            self._drain_waves(force=len(self._inflight_waves) >= self._depth)
            try:
                # With waves in flight, never park for long: the queue may
                # be empty because every client waits on those waves.
                item = self.queue.get_many(
                    1, timeout=0.002 if self._inflight_waves else None)[0]
            except queue.Empty:
                if self._inflight_waves:
                    self._drain_waves(force=True)
                continue
            if item is _SHUTDOWN:
                self._drain_waves(flush=True)
                return
            self._unpend(item.sequence_id)
            if self._check_timeout(item) or self._check_cancelled(item):
                continue
            batch = self._gather_candidates(item)
            try:
                self._dispatch_wave(batch)
            except Exception as exc:  # noqa: BLE001 — the worker lives
                for r in batch:
                    self._fail(r, exc)

    def _gather_candidates(self, first: InferRequest) -> list[InferRequest]:
        """One queued request per distinct sequence; a second request of a
        sequence already in the wave goes back to the head of the queue
        (a sequence's order is its steps' order)."""
        deadline = now_ns() + self._delay_ns
        batch = [first]
        seen = {first.sequence_id}
        pushback: list[InferRequest] = []
        tail: list = []  # a shutdown marker and what came after it
        while len(batch) < self._cap:
            timeout = max((deadline - now_ns()) / 1e9, 0.0)
            try:
                items = self.queue.get_many(self._cap - len(batch),
                                            timeout=timeout)
            except queue.Empty:
                break
            stop = False
            for i, item in enumerate(items):
                if item is _SHUTDOWN:
                    tail = items[i:]
                    stop = True
                    break
                self._unpend(item.sequence_id)
                if self._check_timeout(item) or self._check_cancelled(item):
                    continue
                if item.sequence_id in seen \
                        or not _same_signature(first, item):
                    pushback.append(item)
                    continue
                seen.add(item.sequence_id)
                batch.append(item)
            if stop:
                break
        for later in tail:
            self._requeue(later)
        for later in reversed(pushback):
            # Back in the queue: pending again until the next gather.
            if later.sequence_id:
                with self._arena_lock:
                    self._pend_locked(later.sequence_id)
            self._requeue(later)
        return batch

    def _dispatch_wave(self, batch: list[InferRequest]) -> None:
        """Issue one wave without waiting for it; its responses go out in
        :meth:`_drain_waves` once its event has passed."""
        start = now_ns()
        rows, resets, live = [], [], []
        wave_sids = {r.sequence_id for r in batch}
        for r in batch:
            r.times.compute_start = start
            try:
                row, reset = self._acquire_row(r, protect=wave_sids)
            except EngineError as exc:
                self._fail(r, exc)
                continue
            rows.append(row)
            resets.append(reset)
            live.append(r)
        if not live:
            return
        bucket = next(b for b in self._buckets if b >= len(live))
        pad = bucket - len(live)
        rows += [self._cap] * pad  # the dummy row takes the padded lanes
        resets += [True] * pad
        inputs = {}
        for name in live[0].inputs:
            arrs = [r.inputs[name] for r in live]
            arrs += [np.zeros_like(arrs[0])] * pad
            inputs[name] = np.stack(arrs)
        t_stacked = now_ns()
        model = self.model
        cuda = model.device.type == "cuda"
        stream = model._stream() if cuda else None
        try:
            with (torch.cuda.stream(stream) if cuda
                  else contextlib.nullcontext()), torch.inference_mode():
                def stage(arr):
                    t = torch.from_numpy(np.ascontiguousarray(arr))
                    if cuda:
                        t = t.pin_memory().to(model.device, non_blocking=True)
                    return t

                self._arena, outputs = self._step(
                    self._arena, stage(np.asarray(rows, np.int64)),
                    stage(np.asarray(resets)),
                    {k: stage(v) for k, v in inputs.items()})
                host = {}
                for name, val in outputs.items():
                    if cuda:
                        buf = torch.empty(val.shape, dtype=val.dtype,
                                          pin_memory=True)
                        host[name] = buf.copy_(val, non_blocking=True)
                    else:
                        host[name] = val
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(stream)
        except Exception:
            # Waves issued before this one ran before it on the stream:
            # deliver them, then rebuild the arena.
            try:
                self._drain_waves(flush=True)
            except Exception:  # noqa: BLE001 — the flush is best effort
                pass
            self._reset_arena_state()
            raise
        self._inflight_waves.append((live, host, done, t_stacked))

    def _drain_waves(self, force: bool = False, flush: bool = False) -> None:
        """Respond for finished waves in dispatch order. ``force`` waits on
        the oldest wave; ``flush`` on every one."""
        while self._inflight_waves:
            live, host, done, t_stacked = self._inflight_waves[0]
            if done is not None and not (force or flush) \
                    and not done.query():
                return
            force = False
            self._inflight_waves.popleft()
            try:
                if done is not None:
                    done.synchronize()
                outs_np = {name: val.numpy() for name, val in host.items()}
            except Exception as exc:  # noqa: BLE001 — the wave failed
                self._reset_arena_state()
                failed = [live] + [w[0] for w in self._inflight_waves]
                self._inflight_waves.clear()
                for wave in failed:
                    for r in wave:
                        self._fail(r, EngineError(
                            f"sequence step failed: {exc}", 500))
                return
            t_done = now_ns()
            self.stats.record_execution(len(live),
                                        compute_ns=t_done - t_stacked)
            # Delivery is a use: a stall on the server's side must not
            # evict clients that were never idle.
            with self._arena_lock:
                for r in live:
                    if r.sequence_id in self._last_used:
                        self._last_used[r.sequence_id] = t_done
            for i, r in enumerate(live):
                if r.sequence_end:
                    self._release_row(r.sequence_id)
                outs = {k: v[i] for k, v in outs_np.items()}
                r.times.compute_input_end = t_stacked
                r.times.compute_infer_end = t_done
                r.times.compute_output_end = now_ns()
                self.stats.record_request(r.times, success=True)
                self._respond(r, InferResponse(
                    model_name=r.model_name,
                    model_version=r.model_version
                    or str(self.model.config.version),
                    request_id=r.request_id,
                    outputs=_respond_outputs(r, outs), times=r.times))

    def _reset_arena_state(self) -> None:
        """After a failed wave: zero the arena and drop every live
        sequence (its next request without a start flag gets a 400)."""
        _log.exception(
            "model '%s': oldest-batch step failed; resetting the sequence "
            "arena (%d live sequences dropped)", self.model.config.name,
            len(self._rows))
        with self._arena_lock:
            self._arena = torch.zeros_like(self._arena)
            self._rows.clear()
            self._last_used.clear()
            self._free = list(range(self._cap))

    def active_sequences(self) -> int:
        with self._arena_lock:
            return len(self._rows)

    def _release(self) -> None:
        with self._arena_lock:
            self._rows.clear()
            self._last_used.clear()
            self._free = list(range(self._cap))
            self._arena = None


def _same_signature(a: InferRequest, b: InferRequest) -> bool:
    """Steppable in one wave: the same input names, shapes and dtypes."""
    if a.inputs.keys() != b.inputs.keys():
        return False
    return all(a.inputs[n].shape == b.inputs[n].shape
               and a.inputs[n].dtype == b.inputs[n].dtype for n in a.inputs)


def make_sequence_scheduler(model, stats) -> Scheduler:
    """The strategy's scheduler: the arena batcher for ``oldest`` when the
    step can run batched on the device (no host-side backend, no BYTES
    tensor), else the direct one."""
    sb = model.config.sequence_batching
    has_bytes = any(t.data_type == "BYTES"
                    for t in model.config.input + model.config.output)
    if sb is not None and sb.strategy == "oldest":
        if not model.backend.host_side and not has_bytes:
            return OldestSequenceScheduler(model, stats)
        _log.warning(
            "model '%s': sequence strategy 'oldest' requested but the step "
            "is not arena-batchable (%s); falling back to the direct "
            "scheduler", model.config.name,
            "BYTES tensors" if has_bytes else "host-side backend")
    return SequenceScheduler(model, stats)
