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
dequeue.

Priority and fairness, as in the JAX package: the queue is a heap over
Triton's priority levels (lower first, arrival order within a level; a
level may bound its depth with its queue policy's ``max_queue_size``,
checked under the queue's lock, and a request that waited past its
policy's timeout is rejected with 504 or, with the DELAY action, run
anyway). With a QoS controller (``admission/qos.py``) the batching
schedulers queue by class instead, in a weighted fair queue (deficit
round robin over one lane per class), and a batch-class gather splits
when a preempting class's request is waiting. ``preserve_ordering``
releases the responses of the dynamic batcher in arrival order. The
bucket ladder and the gather window are swappable at run time: the
autotuner's ``swap_ladder`` and self-drive's ``set_dispatch_override``
(which only ever tightens the config). ``warmup`` is the scheduler's own
warm-up beside the model's (the generative scheduler's prefill and
decode shapes).
"""

from __future__ import annotations

import heapq
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
from client_tpu_torch.utils import lockdep

_SHUTDOWN = object()
# Shutdown markers sort behind every queued request, whatever its level.
_SHUTDOWN_LEVEL = 1 << 30

_log = logging.getLogger("client_tpu_torch")


def _level_of(item, level: int) -> int:
    return _SHUTDOWN_LEVEL if item is _SHUTDOWN else level


class _ReqQueue:
    """Priority-ordered queue, FIFO within a level, with front-pushback:
    a request that does not fit the batch being gathered returns to the
    head of its level, so mixed shapes keep arrival order. A shutdown
    marker always queues behind every request. ``get_many`` blocks like
    ``queue.Queue.get`` and raises ``queue.Empty`` on timeout."""

    def __init__(self):
        self._h: list = []  # (level, seq, item)
        self._cv = lockdep.Condition("scheduler.queue")
        self._seq = 0        # arrival order within a level
        self._front_seq = 0  # decreasing: pushback lands ahead of arrivals
        self._level_counts: dict[int, int] = {}

    def put(self, item, level: int = 0, max_level_size: int = 0) -> bool:
        """Enqueue; with ``max_level_size`` > 0 the level's depth is
        checked under the queue's lock (Triton's per-level
        ``max_queue_size``). Returns False when the level is full."""
        level = _level_of(item, level)
        with self._cv:
            if max_level_size > 0 and \
                    self._level_counts.get(level, 0) >= max_level_size:
                return False
            self._seq += 1
            heapq.heappush(self._h, (level, self._seq, item))
            self._level_counts[level] = self._level_counts.get(level, 0) + 1
            self._cv.notify()
            return True

    def put_front(self, item, level: int = 0) -> None:
        level = _level_of(item, level)
        with self._cv:
            self._front_seq -= 1
            heapq.heappush(self._h, (level, self._front_seq, item))
            self._level_counts[level] = self._level_counts.get(level, 0) + 1
            self._cv.notify()

    def get_many(self, max_items: int, timeout: float | None = None) -> list:
        """Pop up to ``max_items`` in priority and arrival order under one
        lock acquisition; blocks (bounded by ``timeout``) for the first
        item only."""
        with self._cv:
            if not self._cv.wait_for(lambda: len(self._h) > 0,
                                     timeout=timeout):
                raise queue.Empty
            out = []
            while self._h and len(out) < max_items:
                level, _seq, item = heapq.heappop(self._h)
                self._level_counts[level] = \
                    self._level_counts.get(level, 1) - 1
                out.append(item)
            return out

    def qsize(self) -> int:
        """Requests waiting (the tpu_queue_depth gauge)."""
        with self._cv:
            return len(self._h)

    def depth(self) -> int:
        """:meth:`qsize` without the queue's lock, for a reader that must
        not wait on a batch being gathered (the load report): one read of
        the heap's length."""
        return len(self._h)

    def level_qsize(self, level: int) -> int:
        with self._cv:
            return self._level_counts.get(level, 0)


class _WfqLane:
    """One QoS class's lane in :class:`_WfqQueue`: a (level, seq) heap as
    in :class:`_ReqQueue`, and its deficit-round-robin credit."""

    __slots__ = ("name", "weight", "preempt", "h", "deficit")

    def __init__(self, name: str, weight: float, preempt: bool):
        self.name = name
        self.weight = max(1e-6, float(weight))
        self.preempt = preempt
        self.h: list = []  # (level, seq, item)
        self.deficit = 0.0


class _WfqQueue:
    """Weighted fair queue across QoS classes: deficit round robin over
    one lane per class, each lane's quantum proportional to its weight.

    The same surface as :class:`_ReqQueue`, so every check, the shutdown
    markers and the pushback paths are unchanged. The differences:

    * **Pop order**: each class has a lane (priority and arrival order
      within it) and ``get_many`` serves lanes by DRR: a lane earns
      ``quantum x weight`` credit per turn and pops one request per
      credit, so under saturation the served mix converges to the weight
      ratio whichever class floods the queue.
    * **Preemption**: an arrival in a ``preempt`` class restarts the
      rotation at its lane (the next wave leads with it) and shows in
      :meth:`preempt_pending`, which lets a gathering dynamic batcher
      split a batch-class batch instead of making it wait.
    * **Shutdown**: markers ride a control lane served only once every
      class lane is empty, so real work still drains first.
    """

    def __init__(self, qos):
        self._qos = qos
        self._cv = lockdep.Condition("scheduler.queue")
        self._seq = 0
        self._front_seq = 0
        self._level_counts: dict[int, int] = {}
        self._lanes: dict[str, _WfqLane] = {}
        for name in qos.class_names():
            self._lanes[name] = _WfqLane(
                name, qos.weight(name), qos.is_preempt(name))
        self._default = qos.config.default_class
        self._order = list(self._lanes)
        self._rr = 0
        self._control: list = []  # shutdown markers, control items
        self._size = 0
        # One rotation gives the lightest lane at least one credit, so
        # every round makes progress.
        min_w = min(lane.weight for lane in self._lanes.values())
        self._quantum = 1.0 / min_w

    def _lane_for(self, item) -> _WfqLane | None:
        if item is _SHUTDOWN or not isinstance(item, InferRequest):
            return None  # the control lane
        name = item.qos_class or self._default
        lane = self._lanes.get(name)
        return lane if lane is not None else self._lanes[self._default]

    def put(self, item, level: int = 0, max_level_size: int = 0) -> bool:
        level = _level_of(item, level)
        with self._cv:
            if max_level_size > 0 and \
                    self._level_counts.get(level, 0) >= max_level_size:
                return False
            lane = self._lane_for(item)
            if lane is None:
                self._control.append((level, item))
            else:
                self._seq += 1
                heapq.heappush(lane.h, (level, self._seq, item))
                if lane.preempt:
                    # The next rotation leads with this lane; the deficits
                    # still bound its share, so this moves latency, not
                    # throughput fairness.
                    self._rr = self._order.index(lane.name)
            self._level_counts[level] = self._level_counts.get(level, 0) + 1
            self._size += 1
            self._cv.notify()
            return True

    def put_front(self, item, level: int = 0) -> None:
        level = _level_of(item, level)
        with self._cv:
            lane = self._lane_for(item)
            if lane is None:
                self._control.append((level, item))
            else:
                self._front_seq -= 1
                heapq.heappush(lane.h, (level, self._front_seq, item))
            self._level_counts[level] = self._level_counts.get(level, 0) + 1
            self._size += 1
            self._cv.notify()

    def get_many(self, max_items: int, timeout: float | None = None) -> list:
        with self._cv:
            if not self._cv.wait_for(lambda: self._size > 0,
                                     timeout=timeout):
                raise queue.Empty
            out: list = []
            n = len(self._order)
            while len(out) < max_items and \
                    self._size > len(self._control):
                progressed = False
                for k in range(n):
                    i = (self._rr + k) % n
                    lane = self._lanes[self._order[i]]
                    if not lane.h:
                        lane.deficit = 0.0
                        continue
                    # Credit only at the start of a lane's turn: a turn cut
                    # short by max_items resumes on its leftover deficit.
                    if lane.deficit < 1.0:
                        lane.deficit += self._quantum * lane.weight
                    while lane.h and lane.deficit >= 1.0 \
                            and len(out) < max_items:
                        self._pop_lane(lane, out)
                        lane.deficit -= 1.0
                        progressed = True
                    if not lane.h:
                        lane.deficit = 0.0
                    if len(out) >= max_items:
                        # Cut mid-turn with credit left: the lane keeps the
                        # floor; an exhausted turn passes it on.
                        self._rr = i if lane.h and lane.deficit >= 1.0 \
                            else (i + 1) % n
                        break
                if not progressed:
                    break
            # Control items only once every class lane has drained.
            while len(out) < max_items and self._control \
                    and self._size == len(self._control):
                level, item = self._control.pop(0)
                out.append(item)
                self._size -= 1
                self._level_counts[level] = \
                    self._level_counts.get(level, 1) - 1
            return out

    def _pop_lane(self, lane: _WfqLane, out: list) -> None:
        level, _seq, item = heapq.heappop(lane.h)
        self._level_counts[level] = self._level_counts.get(level, 1) - 1
        self._size -= 1
        out.append(item)

    def preempt_pending(self) -> str | None:
        """The name of a preempting class with a request queued (None when
        no interactive request waits)."""
        with self._cv:
            for lane in self._lanes.values():
                if lane.preempt and lane.h:
                    return lane.name
        return None

    def qsize(self) -> int:
        with self._cv:
            return self._size

    def depth(self) -> int:
        """:meth:`qsize` without the queue's lock (see
        :meth:`_ReqQueue.depth`)."""
        return self._size

    def class_qsize(self, name: str) -> int:
        lane = self._lanes.get(name)
        if lane is None:
            return 0
        with self._cv:
            return len(lane.h)

    def level_qsize(self, level: int) -> int:
        with self._cv:
            return self._level_counts.get(level, 0)


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

    # preserve_ordering is the dynamic batcher's (one response per
    # request); streams and sequence slots keep their own order.
    supports_preserve_ordering = False
    # A scheduler that owns exclusive mutable state (the generative KV
    # arena) runs one worker whatever the instance count.
    single_instance = False

    def __init__(self, model: Model, stats: ModelStats, qos=None):
        self.model = model
        self.stats = stats
        # With an enabled QoS controller the queue is the weighted fair
        # queue over its classes; else the priority heap.
        self.qos = qos if qos is not None and \
            getattr(qos, "enabled", False) else None
        self.queue = _WfqQueue(self.qos) if self.qos is not None \
            else _ReqQueue()
        dyn = model.config.dynamic_batching
        self._preserve_ordering = bool(
            dyn and dyn.preserve_ordering and self.supports_preserve_ordering
            and not model.config.decoupled)
        if self._preserve_ordering and dyn.priority_levels > 0:
            # Arrival-order release and priority overtaking contradict each
            # other (a held high-priority response would wait on every
            # older low-priority request); Triton refuses it too.
            raise EngineError(
                f"model '{model.config.name}': preserve_ordering cannot be "
                "combined with priority_levels", 400)
        # The run-time dispatch override (self-drive's actuator): one dict
        # swapped whole, read once per gather; None runs the config.
        self._dispatch_override: dict | None = None
        self._order_lock = lockdep.Lock("scheduler.order")
        self._arrival_seq = 0        # assigned at submit
        self._release_seq = 0        # the next arrival allowed to answer
        self._held: dict[int, tuple] = {}  # seq -> (req, resp)
        self._draining = False       # one thread flushes at a time
        # Batches executing now (the tpu_inflight_batches gauge).
        self.active_batches = 0
        self._active_lock = lockdep.Lock("scheduler.active")
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

    def _priority_level(self, req: InferRequest) -> int:
        """Triton's semantics: a priority <= 0 takes the model's default
        level, one beyond ``priority_levels`` the lowest level."""
        dyn = self.model.config.dynamic_batching
        if dyn is None or dyn.priority_levels <= 0:
            return 0
        level = int(req.priority)
        if level <= 0:
            level = int(dyn.default_priority_level) or \
                (dyn.priority_levels + 1) // 2
        return max(1, min(level, dyn.priority_levels))

    # -- the bucket ladder (the autotuner's surface) --------------------------

    def bucket_ladder(self) -> list[int]:
        """The model's bucket ladder along its padding axis ([] when
        unbatched)."""
        if self.model.config.axis_capacity() <= 0:
            return []
        return self.model.config.effective_buckets()

    def swap_ladder(self, buckets: list[int]) -> list[int]:
        """Replace the ladder (the autotuner's promotion and retirement).
        Safe beside enqueue and dequeue: queueing does not depend on the
        buckets and padding happens inside ``execute_timed``, so queued
        requests land on the new ladder and a batch in flight finishes on
        the bucket it picked. Returns the ladder applied."""
        return self.model.swap_buckets(buckets)

    # -- dispatch overrides (self-drive's surface) ----------------------------

    def set_dispatch_override(self, *, max_queue_delay_us: int | None = None,
                              max_batch: int | None = None) -> None:
        """Override the gather window and/or the batch cap at run time. An
        override only tightens (the gather takes the min against the
        config), so a stale one cannot relax the operator's limits; both
        None clears it."""
        if max_queue_delay_us is None and max_batch is None:
            self._dispatch_override = None
            return
        ovr: dict = {}
        if max_queue_delay_us is not None:
            ovr["max_queue_delay_us"] = max(0, int(max_queue_delay_us))
        if max_batch is not None:
            ovr["max_batch"] = max(1, int(max_batch))
        self._dispatch_override = ovr

    def dispatch_overrides(self) -> dict:
        """The override in force ({} when running as configured)."""
        ovr = self._dispatch_override
        return dict(ovr) if ovr else {}

    def submit(self, req: InferRequest) -> None:
        try:
            faults.fire("scheduler.enqueue")
        except faults.FaultInjected as exc:
            raise EngineError(str(exc), exc.status or 503) from None
        level = self._priority_level(req)
        dyn = self.model.config.dynamic_batching
        policy = dyn.policy_for(level) if dyn is not None else None
        max_size = policy.max_queue_size if policy is not None else 0
        req.times.queue_start = now_ns()
        if self._preserve_ordering:
            with self._order_lock:
                req.arrival_seq = self._arrival_seq
                self._arrival_seq += 1
        if not self.queue.put(req, level, max_level_size=max_size):
            self.stats.record_rejection()
            if self._preserve_ordering:
                # The refused request's slot must not hold the release
                # order back: mark it done with a hole.
                self._release_in_order(req.arrival_seq, (None, None))
            depth = self.queue.level_qsize(level)
            raise EngineError(
                f"model '{self.model.config.name}' rejected request at "
                f"priority level {level}: current queue depth {depth} "
                f"exceeds maximum queue size ({max_size}) for that level",
                429)
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
            self.queue.put(_SHUTDOWN, _SHUTDOWN_LEVEL)
        for t in self.workers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._fail_queued()
        if not any(t.is_alive() for t in self.workers):
            self._release()

    def _fail_queued(self) -> None:
        """Fail every queued request with 503. Shutdown markers drained
        here go back, for a worker that outlived stop()'s wait; a queued
        control item (a warm-up) gets the error and its waiter is
        woken."""
        markers = 0
        why = "model unloaded before the request was processed"
        while True:
            try:
                items = self.queue.get_many(64, timeout=0)
            except queue.Empty:
                break
            for item in items:
                if item is _SHUTDOWN:
                    markers += 1
                elif isinstance(item, InferRequest):
                    self._fail(item, EngineError(why, 503))
                else:
                    item.error = EngineError(why, 503)
                    item.done.set()
        for _ in range(markers):
            self.queue.put(_SHUTDOWN, _SHUTDOWN_LEVEL)

    def warmup(self) -> None:
        """The scheduler's own warm-up beside the model's buckets; nothing
        by default (the generative scheduler warms its prefill and decode
        shapes)."""

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

    def _check_timeout(self, req: InferRequest) -> bool:
        """The queue policy's wait bound (Triton's ``schedule_policy``): a
        request that waited past its timeout (its own ``timeout_us`` where
        the policy allows the override, else the policy's default) fails
        with 504 and counts as a rejection, or runs anyway under the DELAY
        action."""
        dyn = self.model.config.dynamic_batching
        policy = (dyn.policy_for(self._priority_level(req))
                  if dyn is not None else None)
        timeout_us = req.timeout_us
        if policy is not None:
            if timeout_us <= 0 or not policy.allow_timeout_override:
                timeout_us = policy.default_timeout_microseconds
        if timeout_us > 0:
            waited_us = (now_ns() - req.times.queue_start) // 1000
            if waited_us > timeout_us:
                if policy is not None and policy.timeout_action == "DELAY":
                    return False
                self.stats.record_rejection()
                self._fail(req, EngineError("request timed out in queue", 504))
                return True
        return False

    def _requeue(self, item) -> None:
        """Back to the head of its level (a shutdown marker behind every
        request)."""
        self.queue.put_front(item, 0 if item is _SHUTDOWN
                             else self._priority_level(item))

    def _busy(self, delta: int) -> None:
        with self._active_lock:
            self.active_batches += delta

    @staticmethod
    def _trace_id(req: InferRequest) -> str | None:
        return req.trace.trace_id if req.trace is not None else None

    def _release_in_order(self, seq: int, entry: tuple) -> None:
        """Park (req, resp) under its arrival slot and deliver the run of
        responses it unblocks. One thread drains at a time, one slot per
        lock acquisition and each callback outside the lock: deliveries
        are ordered, a callback that submits again cannot deadlock, and a
        raising callback does not drop the rest of the run."""
        with self._order_lock:
            self._held[seq] = entry
            if self._draining:
                return  # the drainer picks this up
            self._draining = True
        while True:
            with self._order_lock:
                if self._release_seq not in self._held:
                    self._draining = False
                    return
                r, rp = self._held.pop(self._release_seq)
                self._release_seq += 1
            if r is not None:
                self._callback(r, rp)

    def _respond(self, req: InferRequest, resp: InferResponse) -> None:
        if self._preserve_ordering and req.arrival_seq is not None:
            self._release_in_order(req.arrival_seq, (req, resp))
            return
        self._callback(req, resp)

    def _callback(self, req: InferRequest, resp: InferResponse) -> None:
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

    supports_preserve_ordering = True

    def _worker_loop(self) -> None:
        cfg = self.model.config
        dyn = cfg.dynamic_batching
        while True:
            item = self.queue.get_many(1)[0]
            if item is _SHUTDOWN:
                return
            if self._check_timeout(item) or self._check_deadline(item) \
                    or self._check_dequeue_fault(item):
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
        it, it only drains what is already queued. A dispatch override
        tightens the window and the batch cap; a batch-class gather stops
        early when a preempting class's request waits (the partial batch
        runs now, the waiting request leads the next pop)."""
        max_batch = self.model.config.max_batch_size
        prefer = (max(dyn.preferred_batch_size) if dyn.preferred_batch_size
                  else max_batch)
        delay_us = dyn.max_queue_delay_microseconds
        ovr = self._dispatch_override
        if ovr is not None:
            if "max_batch" in ovr:
                max_batch = min(max_batch, ovr["max_batch"])
                prefer = min(prefer, max_batch)
            if "max_queue_delay_us" in ovr:
                delay_us = min(delay_us, ovr["max_queue_delay_us"])
        deadline_ns = now_ns() + delay_us * 1000
        batch = [first]
        total = _request_batch(first)
        preemptable = (self.qos is not None
                       and not self.qos.is_preempt(first.qos_class))
        while total < prefer:
            if preemptable:
                pending = self.queue.preempt_pending()
                if pending is not None:
                    self.qos.note_preemption(self.model.config.name, pending)
                    break
            timeout = max((deadline_ns - now_ns()) / 1e9, 0.0)
            try:
                items = self.queue.get_many(prefer - total, timeout=timeout)
            except queue.Empty:
                break
            for idx, item in enumerate(items):
                if item is _SHUTDOWN:
                    for later in items[idx + 1:]:
                        self._requeue(later)
                    return batch, True
                if self._check_timeout(item) or self._check_deadline(item) \
                        or self._check_dequeue_fault(item):
                    continue
                if total >= prefer \
                        or total + _request_batch(item) > max_batch \
                        or not _compatible(first, item):
                    # Full, or doesn't fit: it and everything behind it go
                    # back to the head of their levels, in order, to lead
                    # the next gather; one whose deadline passed fails here
                    # instead.
                    for later in reversed(items[idx:]):
                        if later is _SHUTDOWN \
                                or not self._check_deadline(later):
                            self._requeue(later)
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
            if self._check_timeout(req) or self._check_cancelled(req) \
                    or self._check_deadline(req) \
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
                   engine=None, qos=None) -> Scheduler:
    """The scheduler for ``model``: the ``EnsembleScheduler`` for an
    ensemble (it calls back into ``engine``), the sequence batcher for a
    stateful model (its strategy picked by ``make_sequence_scheduler``),
    the continuous-batching ``GenerativeScheduler`` for a decoupled
    generative backend, :class:`DecoupledScheduler` for any other
    decoupled one, the ``RaggedScheduler`` for a lookups-axis model, else
    :class:`DefaultScheduler` (NONE and DYNAMIC). The last two queue by
    the ``qos`` controller's classes when one is enabled."""
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

        return RaggedScheduler(model, stats, qos=qos)
    return DefaultScheduler(model, stats, qos=qos)
