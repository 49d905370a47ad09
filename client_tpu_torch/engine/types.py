"""Engine request/response types and the server-side phase timing.

The port's own copy of ``client_tpu/engine/types.py``, trimmed to what
the port serves: sequence routing, cancellation, the streaming
backpressure probe, shared-memory placement, the trace context, the
end-to-end deadline, the cost-ledger tenant, the QoS class and the queue
policy's wait bound are in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


class EngineError(Exception):
    """Engine-level failure; carries an HTTP status for the frontends."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


class DeadlineExpired(EngineError):
    """The request's end-to-end deadline passed before its work ran: 504,
    which the HTTP frontend answers as Gateway Timeout and the gRPC one
    as DEADLINE_EXCEEDED. A type of its own, so the schedulers count the
    stage it expired at on tpu_deadline_expirations_total."""

    def __init__(self, message: str):
        super().__init__(message, 504)


def now_ns() -> int:
    return time.monotonic_ns()


@dataclass
class RequestTimes:
    """Nanosecond stamps of one request's server-side lifecycle."""

    received: int = 0             # the engine took the request
    queue_start: int = 0
    compute_start: int = 0        # batch assembled; input staging begins
    compute_input_end: int = 0    # inputs enqueued to the device
    compute_infer_end: int = 0    # the forward pass finished on the device
    compute_output_end: int = 0   # outputs on the host for the frontend
    # The ns of a bucket's cold first execution paid inside compute_infer
    # (0 on warm requests): the frontends mark the response cold with it
    # (the Server-Timing `compile` entry, the `server_compile_us`
    # parameter).
    compile_ns: int = 0

    @property
    def queue_ns(self) -> int:
        return max(0, self.compute_start - self.queue_start)

    @property
    def compute_input_ns(self) -> int:
        return max(0, self.compute_input_end - self.compute_start)

    @property
    def compute_infer_ns(self) -> int:
        return max(0, self.compute_infer_end - self.compute_input_end)

    @property
    def compute_output_ns(self) -> int:
        return max(0, self.compute_output_end - self.compute_infer_end)


@dataclass
class OutputRequest:
    """What the client asked for one output: its name, its encoding, for
    the classification extension the number of top classes (0: raw
    values), and the shared-memory region (with offset and byte size) the
    output is written into instead of the response body."""

    name: str
    binary: bool = False
    classification_count: int = 0
    shm_region: str | None = None
    shm_offset: int = 0
    shm_byte_size: int = 0


@dataclass
class InferRequest:
    model_name: str
    inputs: dict[str, np.ndarray]
    model_version: str = ""
    request_id: str = ""
    outputs: list[OutputRequest] = field(default_factory=list)
    parameters: dict[str, Any] = field(default_factory=dict)
    # Stateful-model sequence routing (the ``sequence_id``,
    # ``sequence_start`` and ``sequence_end`` request parameters).
    sequence_id: int = 0
    sequence_start: bool = False
    sequence_end: bool = False
    # Triton's request priority: the model's priority level (lower is
    # served first; 0 means the model's default level), and the admission
    # shadow class at or above ``shadow_priority``.
    priority: int = 0
    # The cost-ledger tenant: the `X-Tpu-Tenant` header or the `tenant`
    # parameter. Empty means untagged: the engine resolves it to "shadow"
    # (the admission shadow class) or "default" at submit.
    tenant: str = ""
    # The QoS class (``admission/qos.py``), stamped by the engine from the
    # tenant and priority; the scheduler's weighted fair queue lanes
    # requests by it. Empty while QoS is off.
    qos_class: str = ""
    # The arrival index, set by a scheduler that preserves ordering.
    arrival_seq: int | None = None
    # The queue policy's wait bound in microseconds (the request's
    # `timeout` parameter; 0 = the policy's default), not the end-to-end
    # deadline below.
    timeout_us: int = 0
    # End-to-end deadline (absolute now_ns(); 0 = none), from the client's
    # budget: the `timeout-ms` header or `timeout_ms` parameter, or the gRPC
    # deadline. Past it the request fails with 504 at admission, at dequeue
    # or before its batch executes, and costs the card nothing.
    deadline_ns: int = 0
    times: RequestTimes = field(default_factory=RequestTimes)
    # Called with each response; a decoupled model calls it once per
    # streamed response and last with ``final=True``.
    response_callback: Callable[["InferResponse"], None] | None = None
    # Cooperative cancellation: a frontend sets this when its client goes
    # away; the generative scheduler drops the stream at the next wave and
    # fails it with 499. A plain bool: a stale read delays the cancel by
    # one wave.
    cancelled: bool = False
    # Streaming flow control: a frontend with a bounded response path sets
    # a zero-argument probe that returns True while it is backlogged; the
    # generative scheduler then skips this stream's waves until it drains,
    # and the decoupled scheduler holds its next emit.
    backpressure: Callable[[], bool] | None = None
    # Set by an in-process caller whose every requested output goes into a
    # device region: the batch executor then skips the D2H fetch and each
    # response carries its window of the batch's output tensors on the
    # device (a basic slice, a view; the region stores it as it is).
    keep_outputs_on_device: bool = False
    # The W3C trace context (observability.tracing.TraceContext) the
    # frontends set from the `traceparent` header or gRPC metadata; None
    # for an untraced in-process caller.
    trace: Any = None

    def cancel(self) -> None:
        self.cancelled = True

    def set_deadline_from_timeout_ms(self, timeout_ms: float) -> None:
        """Arm the deadline from a client budget in ms (a budget that is
        not positive leaves the request without one)."""
        if timeout_ms > 0:
            self.deadline_ns = now_ns() + int(timeout_ms * 1_000_000)

    def deadline_expired(self, now: int | None = None) -> bool:
        return self.deadline_ns > 0 and \
            (now if now is not None else now_ns()) >= self.deadline_ns

    def deadline_remaining_s(self) -> float | None:
        """Seconds until the deadline (None without one)."""
        if self.deadline_ns <= 0:
            return None
        return (self.deadline_ns - now_ns()) / 1e9


@dataclass
class InferResponse:
    model_name: str
    model_version: str
    request_id: str = ""
    outputs: dict[str, np.ndarray] = field(default_factory=dict)
    parameters: dict[str, Any] = field(default_factory=dict)
    error: EngineError | None = None
    final: bool = True  # False for the non-terminal responses of a stream
    times: RequestTimes | None = None

    @classmethod
    def make_error(cls, req: InferRequest, exc: Exception) -> "InferResponse":
        err = exc if isinstance(exc, EngineError) else EngineError(str(exc), 500)
        return cls(model_name=req.model_name,
                   model_version=req.model_version or "1",
                   request_id=req.request_id, error=err, times=req.times)
