"""Request scheduling: a per-model queue, worker threads, dynamic batching.

Counterpart of ``Scheduler`` / ``DefaultScheduler`` / ``make_scheduler`` in
``client_tpu/engine/scheduler.py``. For NONE and DYNAMIC models each of
the model's ``instance_count`` workers pops a request, gathers compatible
requests within the queue-delay window up to the preferred batch size,
concatenates them (on the host, or on the card when every request's input
is a tensor from a device region) and runs one execution for the batch;
when every request keeps its outputs on the device, each gets its rows of
the batch's output tensors as a slice.
Decoupled generative models get the continuous-batching
``GenerativeScheduler`` (``engine/generative.py``), other decoupled models
the :class:`DecoupledScheduler`, stateful models the sequence batcher
(``engine/sequence.py``), lookups-axis models the ``RaggedScheduler``
(``engine/ragged.py``) and ensembles the ``EnsembleScheduler``
(``engine/ensemble.py``). Two fault sites fire here as in the JAX
package: ``scheduler.enqueue`` in every scheduler's submit (the error
goes back to the caller), ``scheduler.dequeue`` where the dynamic,
ragged and decoupled workers pop a request (it fails alone). A request
whose end-to-end deadline has passed fails with 504 where it is popped
(stage ``queue``) or just before its batch runs (stage ``execute``, and
``Model.execute_timed``'s own check for the whole batch), counted on
``tpu_deadline_expirations_total{stage}``. Each execution's device time
(the profiler's CUDA-event interval) is split across its requests'
tenants on the cost ledger, and each request's queue wait charged at
dequeue. Priority levels, queue policies, QoS lanes, dispatch overrides
and preemption are not ported yet.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time

import numpy as np
import torch

from client_tpu_torch import faults
from client_tpu_torch.engine.model import Model, np_dtype_of, worker_stream
from client_tpu_torch.engine.shm import wait_for_writer
from client_tpu_torch.engine.stats import ModelStats
from client_tpu_torch.engine.types import (
    DeadlineExpired,
    EngineError,
    InferRequest,
    InferResponse,
    now_ns,
)
from client_tpu_torch.observability.costs import ledger

_SHUTDOWN = object()

_log = logging.getLogger("client_tpu_torch")


class _ReqQueue:
    """FIFO with front-pushback: a request that does not fit the batch being
    gathered returns to the head, so mixed shapes keep arrival order.
    ``get_many`` blocks like ``queue.Queue.get`` and raises ``queue.Empty``
    on timeout."""

    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()

    def put(self, item) -> None:
        with self._cv:
            self._q.append(item)
            self._cv.notify()

    def qsize(self) -> int:
        """Requests waiting (the tpu_queue_depth gauge)."""
        with self._cv:
            return len(self._q)

    def put_front(self, item) -> None:
        with self._cv:
            self._q.appendleft(item)
            self._cv.notify()

    def get_many(self, max_items: int, timeout: float | None = None) -> list:
        """Pop up to ``max_items`` under one lock acquisition; blocks
        (bounded by ``timeout``) for the first item only."""
        with self._cv:
            if not self._cv.wait_for(lambda: len(self._q) > 0,
                                     timeout=timeout):
                raise queue.Empty
            out = []
            while self._q and len(out) < max_items:
                out.append(self._q.popleft())
            return out


def _backpressured(req: InferRequest) -> bool:
    """True while the request's frontend reports a backlogged response
    path (``InferRequest.backpressure``). Fail-open: a probe that raises
    throttles nothing; the frontend's slow-consumer cancel stays the
    backstop."""
    bp = req.backpressure
    if bp is None:
        return False
    try:
        return bool(bp())
    except Exception:  # noqa: BLE001 — fail open, see above
        return False


def _wait_while_backpressured(req: InferRequest, poll_s: float = 0.001,
                              max_wait_s: float = 60.0) -> None:
    """Writer-paced production for a decoupled emit loop: park while the
    frontend is backlogged, until the request is cancelled or
    ``max_wait_s`` passes (then production resumes and the frontend's
    slow-consumer shed owns the outcome)."""
    deadline = time.monotonic() + max_wait_s
    while (_backpressured(req) and not req.cancelled
           and time.monotonic() < deadline):
        time.sleep(poll_s)


def power_buckets(n: int) -> list[int]:
    """Power-of-two sizes up to and including ``n``: the generative
    scheduler's prompt and wave bucket ladders."""
    out, b = [], 1
    while b < n:
        out.append(b)
        b *= 2
    out.append(n)
    return out


def _batch_deadline(batch: list[InferRequest]) -> int:
    """The batch's deadline for ``Model.execute_timed``: 0 (none) when any
    member has none, since the batch must run for that member; else the
    latest member's (an earlier one would fail members with time left)."""
    if any(r.deadline_ns == 0 for r in batch):
        return 0
    return max(r.deadline_ns for r in batch)


def _request_batch(req: InferRequest) -> int:
    for arr in req.inputs.values():
        return int(arr.shape[0])
    return 1


def _compatible(a: InferRequest, b: InferRequest) -> bool:
    """Batchable together: same inputs, same non-batch dims and dtypes."""
    if a.inputs.keys() != b.inputs.keys():
        return False
    return all(tuple(a.inputs[n].shape[1:]) == tuple(b.inputs[n].shape[1:])
               and np_dtype_of(a.inputs[n]) == np_dtype_of(b.inputs[n])
               for n in a.inputs)


def _concat_batch(arrs: list, model: Model):
    """Concatenate request tensors along the batch axis.

    Tensors from device regions of one shape and dtype are joined on their
    device (``Model.concat_rows``), never through the host. When the
    padding divides evenly, the first operand is repeated up to the
    model's bucket, as in the JAX package (whose concat then compiles once
    per bucket); request windows start at row 0 and never reach the
    repeated rows. Host arrays, and mixed inputs, are joined in numpy, a
    device tensor fetched to the host first."""
    if len(arrs) == 1:
        return arrs[0]
    if all(isinstance(a, torch.Tensor) for a in arrs) and \
            len({(tuple(a.shape), a.dtype, a.device) for a in arrs}) == 1:
        per = int(arrs[0].shape[0]) if arrs[0].dim() else 1
        total = per * len(arrs)
        if model.config.max_batch_size > 0 and per > 0:
            extra = model.pick_bucket(total) - total
            if extra > 0 and extra % per == 0:
                arrs = list(arrs) + [arrs[0]] * (extra // per)
        return model.concat_rows(arrs)
    return np.concatenate([_host(a) for a in arrs], axis=0)


def _host(a):
    """A device tensor's values on the host, after the write that filled
    it; a host array as it is."""
    if not isinstance(a, torch.Tensor):
        return a
    wait_for_writer(a)
    return a.cpu().numpy()


class Scheduler:
    """Base scheduler: the request queue, the worker threads, submit, stop
    and the response path. Subclasses set their state up before calling
    ``super().__init__``, which starts the workers."""

    # A scheduler that owns exclusive mutable state (the generative KV
    # arena) runs one worker whatever the instance count.
    single_instance = False

    def __init__(self, model: Model, stats: ModelStats):
        self.model = model
        self.stats = stats
        self.queue = _ReqQueue()
        # Batches executing now (the tpu_inflight_batches gauge).
        self.active_batches = 0
        self._active_lock = threading.Lock()
        # Set by stop(): a long-running worker loop (a generation wave, a
        # decoupled stream) checks it to end what it holds.
        self._stopping = False
        self.workers: list[threading.Thread] = []
        n = 1 if self.single_instance else max(1, model.config.instance_count)
        started = threading.Barrier(n + 1)
        errors: list[BaseException] = []
        for i in range(n):
            t = threading.Thread(target=self._start_worker,
                                 args=(started, errors),
                                 name=f"sched-{model.config.name}-{i}",
                                 daemon=True)
            t.start()
            self.workers.append(t)
        started.wait()
        if errors:
            self.stop()
            raise errors[0]

    def submit(self, req: InferRequest) -> None:
        try:
            faults.fire("scheduler.enqueue")
        except faults.FaultInjected as exc:
            raise EngineError(str(exc), exc.status or 503) from None
        req.times.queue_start = now_ns()
        self.queue.put(req)
        # The arrival joins the model's tenant mix (the queue_wait
        # interference split at dequeue).
        ledger().note_queued(self.model.config.name, req.tenant)
        if self._stopping and not any(t.is_alive() for t in self.workers):
            # Submit raced stop() and the workers are gone: nothing would
            # ever pop this request.
            self._fail_queued()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Let the workers finish what is queued ahead of the shutdown
        markers, then fail anything left with 503; ``timeout_s`` bounds
        the total wait. Once every worker has exited, the device state the
        scheduler holds (an arena, sequence states) is released."""
        self._stopping = True
        deadline = time.monotonic() + max(0.0, timeout_s)
        for _ in self.workers:
            self.queue.put(_SHUTDOWN)
        for t in self.workers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._fail_queued()
        if not any(t.is_alive() for t in self.workers):
            self._release()

    def _fail_queued(self) -> None:
        """Fail every queued request with 503. Shutdown markers drained
        here go back, for a worker that outlived stop()'s wait."""
        markers = 0
        while True:
            try:
                items = self.queue.get_many(64, timeout=0)
            except queue.Empty:
                break
            for item in items:
                if item is _SHUTDOWN:
                    markers += 1
                elif isinstance(item, InferRequest):
                    self._fail(item, EngineError(
                        "model unloaded before the request was processed",
                        503))
        for _ in range(markers):
            self.queue.put(_SHUTDOWN)

    def _release(self) -> None:
        """Drop the device state this scheduler holds; called once its
        workers have exited."""

    def _start_worker(self, started: threading.Barrier,
                      errors: list) -> None:
        """The worker's stream and cuBLAS's workspaces on it are made
        before the load returns, not by the first request."""
        model = self.model
        try:
            if (model.device.type == "cuda" and not model.backend.host_side
                    and model.config.scheduler_kind() != "ENSEMBLE"):
                worker_stream(model.device)
        except Exception as exc:  # noqa: BLE001 — the load raises it
            errors.append(exc)
        started.wait()
        if not errors:
            self._worker_loop()

    def _worker_loop(self) -> None:
        raise NotImplementedError

    def _fail(self, req: InferRequest, exc: Exception) -> None:
        # The response carries the error, not the frames it was raised in:
        # those hold this scheduler, and with it the model's weights, for
        # as long as a caller keeps the response.
        exc.__traceback__ = None
        req.times.compute_output_end = now_ns()
        self.stats.record_request(req.times, success=False,
                                  trace_id=self._trace_id(req))
        self._respond(req, InferResponse.make_error(req, exc))

    def _check_cancelled(self, req: InferRequest) -> bool:
        """Fail a client-abandoned request with 499 before it costs device
        time."""
        if req.cancelled:
            self._fail(req, EngineError("request cancelled", 499))
            return True
        return False

    def _check_deadline(self, req: InferRequest, stage: str = "queue") -> bool:
        """Fail a request whose end-to-end deadline has passed with 504
        before it costs device time; ``stage`` (queue | execute) labels
        where on tpu_deadline_expirations_total."""
        if req.deadline_expired():
            waited_ms = (now_ns() - req.times.queue_start) / 1e6
            self.stats.record_deadline_expired(
                stage, trace_id=self._trace_id(req))
            self._fail(req, DeadlineExpired(
                f"end-to-end deadline expired before {stage} "
                f"(waited {waited_ms:.1f}ms in queue)"))
            return True
        return False

    def _check_dequeue_fault(self, req: InferRequest) -> bool:
        """The ``scheduler.dequeue`` fault site: a popped request that an
        injected error fails before any batching."""
        try:
            faults.fire("scheduler.dequeue")
        except faults.FaultInjected as exc:
            self._fail(req, EngineError(str(exc), exc.status or 503))
            return True
        return False

    def _busy(self, delta: int) -> None:
        with self._active_lock:
            self.active_batches += delta

    @staticmethod
    def _trace_id(req: InferRequest) -> str | None:
        return req.trace.trace_id if req.trace is not None else None

    def _respond(self, req: InferRequest, resp: InferResponse) -> None:
        if req.response_callback is None:
            return
        try:
            req.response_callback(resp)
        except Exception:  # noqa: BLE001 — one caller's broken callback
            # must not fail the batch it shares (or kill a sole worker)
            _log.exception("response callback raised (model '%s')",
                           self.model.config.name)


class DefaultScheduler(Scheduler):
    """NONE and DYNAMIC scheduling over one model's worker threads."""

    def _worker_loop(self) -> None:
        cfg = self.model.config
        dyn = cfg.dynamic_batching
        while True:
            item = self.queue.get_many(1)[0]
            if item is _SHUTDOWN:
                return
            if self._check_deadline(item) or self._check_dequeue_fault(item):
                continue
            batch = [item]
            if cfg.scheduler_kind() == "DYNAMIC" and cfg.max_batch_size > 0:
                batch, stop = self._gather(item, dyn)
            else:
                stop = False
            # The gather may have used the delay window: a member popped
            # with time left may have expired since.
            batch = [r for r in batch
                     if not self._check_deadline(r, stage="execute")]
            if not batch:
                if stop:
                    return
                continue
            self._busy(1)
            try:
                self._execute_batch(batch)
            except DeadlineExpired as exc:
                # Model.execute_timed's check: the whole batch's budget
                # lapsed between the filter above and the launch.
                for r in batch:
                    self.stats.record_deadline_expired(
                        "execute", trace_id=self._trace_id(r))
                    self._fail(r, exc)
            except EngineError as exc:  # an answer (an injected fault, a
                for r in batch:         # bad input), not a crash
                    self._fail(r, exc)
            except Exception as exc:  # noqa: BLE001 — the worker must live
                _log.exception("model '%s': batch of %d failed",
                               cfg.name, len(batch))
                for r in batch:
                    self._fail(r, exc)
            finally:
                self._busy(-1)
            if stop:
                return

    def _gather(self, first: InferRequest, dyn
                ) -> tuple[list[InferRequest], bool]:
        """Requests to run with ``first``, and whether a shutdown marker
        was reached. Within the delay window this waits for arrivals; past
        it, it only drains what is already queued."""
        max_batch = self.model.config.max_batch_size
        prefer = (max(dyn.preferred_batch_size) if dyn.preferred_batch_size
                  else max_batch)
        deadline_ns = now_ns() + dyn.max_queue_delay_microseconds * 1000
        batch = [first]
        total = _request_batch(first)
        while total < prefer:
            timeout = max((deadline_ns - now_ns()) / 1e9, 0.0)
            try:
                items = self.queue.get_many(prefer - total, timeout=timeout)
            except queue.Empty:
                break
            for idx, item in enumerate(items):
                if item is _SHUTDOWN:
                    for later in reversed(items[idx + 1:]):
                        self.queue.put_front(later)
                    return batch, True
                if self._check_deadline(item) \
                        or self._check_dequeue_fault(item):
                    continue
                if total >= prefer \
                        or total + _request_batch(item) > max_batch \
                        or not _compatible(first, item):
                    # Full, or doesn't fit: it and everything behind it go
                    # back to the head, in order, to lead the next gather;
                    # one whose deadline passed fails here instead.
                    for later in reversed(items[idx:]):
                        if later is _SHUTDOWN \
                                or not self._check_deadline(later):
                            self.queue.put_front(later)
                    return batch, False
                batch.append(item)
                total += _request_batch(item)
        return batch, False

    def _execute_batch(self, batch: list[InferRequest]) -> None:
        cfg = self.model.config
        start = now_ns()
        for r in batch:
            r.times.compute_start = start
        deadline_ns = _batch_deadline(batch)
        if cfg.max_batch_size > 0:
            sizes = [_request_batch(r) for r in batch]
            merged = {name: _concat_batch([r.inputs[name] for r in batch],
                                          self.model)
                      for name in batch[0].inputs}
            # Every request keeps every output on the device: no fetch, and
            # each gets its rows of the untrimmed outputs as a slice (a
            # view: nothing launches per request).
            outputs, phases = self.model.execute_timed(
                merged, batch_size=sum(sizes),
                fetch_outputs=not all(r.keep_outputs_on_device
                                      for r in batch),
                deadline_ns=deadline_ns)
        else:
            sizes = [None]
            outputs, phases = self.model.execute_timed(
                batch[0].inputs, deadline_ns=deadline_ns)
        self.stats.record_execution(
            sum(sizes) if cfg.max_batch_size > 0 else 1,
            compute_ns=phases.infer_end - phases.input_end)
        offset = 0
        for r, sz in zip(batch, sizes):
            if sz is None:
                per = outputs
            else:
                per = {k: v[offset:offset + sz] for k, v in outputs.items()}
                offset += sz
            self._finish(r, per, phases)
        if cfg.max_batch_size > 0:
            self._charge(batch, sizes, phases, start,
                         self.model.pick_bucket(sum(sizes)) - sum(sizes))
        else:
            self._charge(batch, [1], phases, start)

    def _charge(self, batch: list[InferRequest], weights: list[int],
                phases, start: int, padded: int = 0) -> None:
        """Split one execution's device time (the profiler's interval, a
        cold first execution left out as the profiler leaves it) across
        its requests' tenants by ``weights``; the rest of the batch's wall
        time since ``start`` is its host time. Charged after the responses
        went out, so the host leg includes their scatter."""
        if phases.compile_ns:
            return
        cfg = self.model.config
        ledger().charge_batch(
            cfg.name, str(cfg.version),
            [(r.tenant, w, self._trace_id(r)) for r, w in zip(batch, weights)],
            phases.device_ns / 1e9, padded=max(0, padded),
            host_s=max(0, now_ns() - start - phases.device_ns) / 1e9)

    def _finish(self, req: InferRequest, outputs: dict, phases) -> None:
        req.times.compute_input_end = phases.input_end
        req.times.compute_infer_end = phases.infer_end
        req.times.compute_output_end = now_ns()
        # Every member of a batch that ran its bucket's cold first
        # execution carries it (the whole batch waited on it).
        req.times.compile_ns = phases.compile_ns
        if req.outputs:
            requested = {o.name for o in req.outputs}
            outputs = {k: v for k, v in outputs.items() if k in requested}
        cfg = self.model.config
        ledger().charge_queue(cfg.name, str(cfg.version), req.tenant,
                              req.times.queue_ns / 1e9,
                              trace_id=self._trace_id(req))
        self.stats.record_request(req.times, success=True,
                                  trace_id=self._trace_id(req),
                                  tenant=req.tenant)
        self._respond(req, InferResponse(
            model_name=req.model_name,
            model_version=req.model_version or str(self.model.config.version),
            request_id=req.request_id, outputs=outputs, times=req.times))


class DecoupledScheduler(Scheduler):
    """Decoupled (streaming) models that are not generative: one request,
    any number of responses. A worker drives the backend's ``generate``
    iterator and emits one response per item, then an empty response
    flagged final (``triton_final_response``), as Triton's decoupled
    backends end a stream. Emits are writer-paced: a backlogged frontend
    (``req.backpressure``) holds the next one, for at most
    ``BACKPRESSURE_TIMEOUT_S``; a cancelled request stops with 499."""

    # How long one emit may wait on a backlogged frontend. Short, because
    # the wait holds one of the model's few workers and every request
    # queued behind it; past it, a stalled consumer is the frontend's
    # slow-consumer shed's to handle.
    BACKPRESSURE_TIMEOUT_S = 5.0

    def _worker_loop(self) -> None:
        while True:
            req = self.queue.get_many(1)[0]
            if req is _SHUTDOWN:
                return
            if self._check_cancelled(req) or self._check_deadline(req) \
                    or self._check_dequeue_fault(req):
                continue
            req.times.compute_start = now_ns()
            self._busy(1)
            try:
                self._stream(req)
            except Exception as exc:  # noqa: BLE001 — the worker must live
                self._fail(req, exc)
            finally:
                self._busy(-1)

    def _stream(self, req: InferRequest) -> None:
        gen = self.model.backend.generate(req.inputs, req.parameters)
        count = 0
        for outputs in gen:
            _wait_while_backpressured(
                req, max_wait_s=self.BACKPRESSURE_TIMEOUT_S)
            if req.cancelled:
                gen.close()
                raise EngineError("request cancelled", 499)
            if self._stopping:  # unloaded mid-stream: end it
                gen.close()
                raise EngineError("server shutting down", 503)
            self._emit(req, outputs, final=False)
            count += 1
        req.times.compute_input_end = req.times.compute_start
        req.times.compute_infer_end = now_ns()
        req.times.compute_output_end = req.times.compute_infer_end
        self.stats.record_execution(max(1, count),
                                    compute_ns=req.times.compute_infer_ns)
        # A decoupled backend runs on the host: only the queue wait is
        # charged (device seconds invented here would break conservation
        # against the profiler).
        cfg = self.model.config
        ledger().charge_queue(cfg.name, str(cfg.version), req.tenant,
                              req.times.queue_ns / 1e9,
                              trace_id=self._trace_id(req))
        self.stats.record_request(req.times, success=True,
                                  trace_id=self._trace_id(req),
                                  tenant=req.tenant)
        self._emit(req, {}, final=True)

    def _emit(self, req: InferRequest, outputs: dict, final: bool) -> None:
        self._respond(req, InferResponse(
            model_name=req.model_name,
            model_version=req.model_version or str(self.model.config.version),
            request_id=req.request_id, outputs=dict(outputs),
            parameters={"triton_final_response": final}, final=final,
            times=req.times))


def make_scheduler(model: Model, stats: ModelStats,
                   engine=None) -> Scheduler:
    """The scheduler for ``model``: the ``EnsembleScheduler`` for an
    ensemble (it calls back into ``engine``), the sequence batcher for a
    stateful model (its strategy picked by ``make_sequence_scheduler``),
    the continuous-batching ``GenerativeScheduler`` for a decoupled
    generative backend, :class:`DecoupledScheduler` for any other
    decoupled one, the ``RaggedScheduler`` for a lookups-axis model, else
    :class:`DefaultScheduler` (NONE and DYNAMIC)."""
    kind = model.config.scheduler_kind()
    if kind == "ENSEMBLE":
        from client_tpu_torch.engine.ensemble import EnsembleScheduler

        return EnsembleScheduler(model, stats, engine)
    if kind == "SEQUENCE":
        from client_tpu_torch.engine.sequence import make_sequence_scheduler

        return make_sequence_scheduler(model, stats)
    if model.config.decoupled:
        if getattr(model.backend, "generative", False):
            from client_tpu_torch.engine.generative import GenerativeScheduler

            return GenerativeScheduler(model, stats)
        return DecoupledScheduler(model, stats)
    if model.config.padding_axis == "lookups":
        from client_tpu_torch.engine.ragged import RaggedScheduler

        return RaggedScheduler(model, stats)
    return DefaultScheduler(model, stats)
