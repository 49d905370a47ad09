"""Engine request/response types and the server-side phase timing.

The port's own copy of ``client_tpu/engine/types.py``, trimmed to what
the port serves: sequence routing, cancellation, the streaming
backpressure probe, shared-memory placement and the trace context are
in; no deadline, tenant or QoS fields yet.
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
