"""Engine request/response types and the server-side phase timing.

The port's own copy of ``client_tpu/engine/types.py``, trimmed to this
slice: no sequence, deadline, tenant, QoS, shm or tracing fields yet.
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

    queue_start: int = 0
    compute_start: int = 0        # batch assembled; input staging begins
    compute_input_end: int = 0    # inputs enqueued to the device
    compute_infer_end: int = 0    # the forward pass finished on the device
    compute_output_end: int = 0   # outputs on the host for the frontend

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
    """What the client asked for one output: its name and its encoding."""

    name: str
    binary: bool = False


@dataclass
class InferRequest:
    model_name: str
    inputs: dict[str, np.ndarray]
    model_version: str = ""
    request_id: str = ""
    outputs: list[OutputRequest] = field(default_factory=list)
    parameters: dict[str, Any] = field(default_factory=dict)
    times: RequestTimes = field(default_factory=RequestTimes)
    # Called once with the final response (the engine's async surface).
    response_callback: Callable[["InferResponse"], None] | None = None


@dataclass
class InferResponse:
    model_name: str
    model_version: str
    request_id: str = ""
    outputs: dict[str, np.ndarray] = field(default_factory=dict)
    error: EngineError | None = None
    times: RequestTimes | None = None

    @classmethod
    def make_error(cls, req: InferRequest, exc: Exception) -> "InferResponse":
        err = exc if isinstance(exc, EngineError) else EngineError(str(exc), 500)
        return cls(model_name=req.model_name,
                   model_version=req.model_version or "1",
                   request_id=req.request_id, error=err, times=req.times)
