"""Per-model server-side statistics in the v2 statistics JSON shape.

The port's own copy of ``client_tpu/engine/stats.py``, trimmed to the
counts ``/v2/models/<m>/stats`` reports: the queue / compute_input /
compute_infer / compute_output phase sums and the executions per batch
size. When the engine attaches :class:`ModelInstruments` (the metrics
plane), every recorded request and execution also feeds the histograms
of ``/metrics``: sums here, distributions there, from one call site.
Every finally answered request also scores the SLO tracker (``slo``),
and a request whose deadline expired is counted by stage and journalled
(``events``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from client_tpu_torch.engine.types import RequestTimes


@dataclass
class _DurationStat:
    count: int = 0
    ns: int = 0

    def add(self, ns: int) -> None:
        self.count += 1
        self.ns += ns

    def record_deadline_expired(self, stage: str = "queue",
                                trace_id: str | None = None) -> None:
        """An end-to-end deadline passed before ``stage`` ran (admission,
        queue or execute): tpu_deadline_expirations_total{stage} and a
        ``deadline.expired`` event."""
        with self._lock:
            self.deadline_expired_count += 1
        if self.instruments is not None:
            self.instruments.record_deadline_expired(stage)
        if self.events is not None:
            self.events.emit(
                "deadline", "expired", severity="WARNING",
                model=self.model_name, version=self.model_version,
                trace_id=trace_id, stage=stage)

    def to_dict(self) -> dict:
        return {"count": self.count, "ns": self.ns}


@dataclass
class ModelStats:
    model_name: str
    model_version: str = "1"
    success: _DurationStat = field(default_factory=_DurationStat)
    fail: _DurationStat = field(default_factory=_DurationStat)
    queue: _DurationStat = field(default_factory=_DurationStat)
    compute_input: _DurationStat = field(default_factory=_DurationStat)
    compute_infer: _DurationStat = field(default_factory=_DurationStat)
    compute_output: _DurationStat = field(default_factory=_DurationStat)
    inference_count: int = 0
    execution_count: int = 0
    last_inference_ms: int = 0  # wall-clock ms of the latest success
    # End-to-end deadline expirations caught before the card ran them.
    deadline_expired_count: int = 0
    # Requests refused by a full priority level or timed out in the queue.
    rejection_count: int = 0
    # batch_size -> [executions, cumulative compute-infer ns]
    batch_hist: dict[int, list[int]] = field(default_factory=dict)
    # observability.metrics.ModelInstruments, or None outside an engine.
    instruments: object | None = field(default=None, repr=False)
    # observability.slo.SloTracker, scored by every finally answered
    # request; None outside an engine.
    slo: object | None = field(default=None, repr=False)
    # observability.events.EventJournal, for deadline.expired.
    events: object | None = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_request(self, times: RequestTimes, success: bool,
                       trace_id: str | None = None,
                       tenant: str = "") -> None:
        total = max(0, times.compute_output_end - times.queue_start)
        with self._lock:
            if success:
                self.success.add(total)
                self.queue.add(times.queue_ns)
                self.compute_input.add(times.compute_input_ns)
                self.compute_infer.add(times.compute_infer_ns)
                self.compute_output.add(times.compute_output_ns)
                self.inference_count += 1
                self.last_inference_ms = int(time.time() * 1000)
            else:
                self.fail.add(total)
        if success and self.instruments is not None:
            self.instruments.observe_request(total, times, trace_id=trace_id,
                                             tenant=tenant)
        if self.slo is not None:
            self.slo.record(self.model_name, success,
                            duration_us=total / 1e3)

    def record_execution(self, batch_size: int, compute_ns: int = 0) -> None:
        """One device execution of ``batch_size`` rows that took
        ``compute_ns`` in the forward pass (0 where it is not measured: a
        generative dispatch is counted before it runs)."""
        with self._lock:
            self.execution_count += 1
            entry = self.batch_hist.setdefault(batch_size, [0, 0])
            entry[0] += 1
            entry[1] += max(0, compute_ns)
        if self.instruments is not None:
            self.instruments.observe_execution(batch_size)

    def record_rejection(self) -> None:
        """A queue policy refused the request: its level was full, or it
        waited past its timeout (tpu_queue_rejections_total)."""
        with self._lock:
            self.rejection_count += 1
        if self.instruments is not None:
            self.instruments.record_rejection()

    def record_deadline_expired(self, stage: str = "queue",
                                trace_id: str | None = None) -> None:
        """An end-to-end deadline passed before ``stage`` ran (admission,
        queue or execute): tpu_deadline_expirations_total{stage} and a
        ``deadline.expired`` event."""
        with self._lock:
            self.deadline_expired_count += 1
        if self.instruments is not None:
            self.instruments.record_deadline_expired(stage)
        if self.events is not None:
            self.events.emit(
                "deadline", "expired", severity="WARNING",
                model=self.model_name, version=self.model_version,
                trace_id=trace_id, stage=stage)

    def to_dict(self) -> dict:
        """v2 ``GET /v2/models/<m>/stats`` entry."""
        with self._lock:
            return {
                "name": self.model_name,
                "version": self.model_version,
                "last_inference": self.last_inference_ms,
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "inference_stats": {
                    "success": self.success.to_dict(),
                    "fail": self.fail.to_dict(),
                    "queue": self.queue.to_dict(),
                    "compute_input": self.compute_input.to_dict(),
                    "compute_infer": self.compute_infer.to_dict(),
                    "compute_output": self.compute_output.to_dict(),
                },
                "batch_stats": [
                    {"batch_size": bs, "compute_infer": {"count": n, "ns": ns}}
                    for bs, (n, ns) in sorted(self.batch_hist.items())
                ],
            }
