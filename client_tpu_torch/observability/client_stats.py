"""Client-side per-request statistics (the InferStat equivalent).

The port's copy of ``client_tpu/observability/client_stats.py``.

The reference's C++ client keeps an ``InferStat`` (completed request count
and cumulative request/send/receive time) that perf_analyzer differences
per window. Our clients accumulate the same shape, extended with the
server-side phase breakdown surfaced by trace propagation: the HTTP client
reads it from the ``Server-Timing`` response header, the gRPC client from
``server_*_us`` response parameters.
"""

from __future__ import annotations

from client_tpu_torch.utils import lockdep


class InferStat:
    """Thread-safe cumulative client-side stats; snapshot via get()."""

    _PHASES = ("queue", "compute_input", "compute_infer", "compute_output")

    def __init__(self):
        self._lock = lockdep.Lock("client_stats")
        self.completed_request_count = 0
        self.cumulative_total_request_time_us = 0.0
        # Server-phase cumulative sums; requests whose response carried no
        # phase timings contribute to the round-trip sum only.
        self.reported_request_count = 0
        self.cumulative_server_queue_us = 0.0
        self.cumulative_server_compute_input_us = 0.0
        self.cumulative_server_compute_infer_us = 0.0
        self.cumulative_server_compute_output_us = 0.0
        # Resilience events: how often the client retried, replayed
        # a stale pooled socket, or was rejected locally by an open
        # circuit breaker. Zero unless the corresponding feature is on.
        self.retry_count = 0
        self.stale_socket_retry_count = 0
        self.breaker_rejected_count = 0
        # trace_id of the most recent completed request (empty until one
        # carries a trace) — the handle for jumping from client stats to
        # the server's /v2/events and /v2/trace/requests timelines.
        self.last_trace_id = ""
        # Cold-start attribution: requests whose Server-Timing carried a
        # `compile` entry (server_compile_us over gRPC) paid a compile —
        # their latency outlier is compile, not queueing.
        self.cold_start_count = 0
        self.last_compile_s = 0.0

    def record(self, round_trip_us: float,
               server_timing: dict | None = None,
               trace_id: str | None = None) -> None:
        with self._lock:
            self.completed_request_count += 1
            self.cumulative_total_request_time_us += round_trip_us
            if trace_id:
                self.last_trace_id = trace_id
            if server_timing:
                self.reported_request_count += 1
                self.cumulative_server_queue_us += \
                    server_timing.get("queue", 0.0)
                self.cumulative_server_compute_input_us += \
                    server_timing.get("compute_input", 0.0)
                self.cumulative_server_compute_infer_us += \
                    server_timing.get("compute_infer", 0.0)
                self.cumulative_server_compute_output_us += \
                    server_timing.get("compute_output", 0.0)
                compile_us = server_timing.get("compile", 0.0)
                if compile_us > 0:
                    self.cold_start_count += 1
                    self.last_compile_s = compile_us / 1e6

    def record_retry(self) -> None:
        with self._lock:
            self.retry_count += 1

    def record_stale_socket_retry(self) -> None:
        with self._lock:
            self.stale_socket_retry_count += 1

    def record_breaker_rejection(self) -> None:
        with self._lock:
            self.breaker_rejected_count += 1

    def get(self) -> dict:
        with self._lock:
            return {
                "completed_request_count": self.completed_request_count,
                "cumulative_total_request_time_us":
                    round(self.cumulative_total_request_time_us, 1),
                "reported_request_count": self.reported_request_count,
                "cumulative_server_queue_us":
                    round(self.cumulative_server_queue_us, 1),
                "cumulative_server_compute_input_us":
                    round(self.cumulative_server_compute_input_us, 1),
                "cumulative_server_compute_infer_us":
                    round(self.cumulative_server_compute_infer_us, 1),
                "cumulative_server_compute_output_us":
                    round(self.cumulative_server_compute_output_us, 1),
                "retry_count": self.retry_count,
                "stale_socket_retry_count": self.stale_socket_retry_count,
                "breaker_rejected_count": self.breaker_rejected_count,
                "last_trace_id": self.last_trace_id,
                "cold_start_count": self.cold_start_count,
                "last_compile_s": round(self.last_compile_s, 6),
            }
