"""Per-request tracing: W3C trace context, a bounded span store and
``Server-Timing``.

The port's copy of ``client_tpu/observability/tracing.py``, used by both
sides. A client stamps each request with a ``traceparent`` and reads the
server's phase timings back from ``Server-Timing``
(:func:`parse_server_timing`). The server adopts the caller's trace id
(or starts a trace), carries it on ``InferRequest.trace`` and, when the
final response lands, snapshots the request's phase stamps (queue /
compute_input / compute_infer / compute_output) into a
:class:`RequestTrace` in a ring buffer, exported as Chrome trace-event
JSON by ``GET /v2/trace/requests`` (open it in ``chrome://tracing`` or
Perfetto); :func:`server_timing_header` writes the same phases into the
response. :class:`SpanStore` is the router's counterpart of the store:
one group of free-form :class:`NamedSpan` s (select, one proxy span per
attempt, shed, the request root) per routed request, which the fleet
stitcher merges with the replicas' own traces.

Standard library only: the port's clients import this module and load no
framework.
"""

from __future__ import annotations

import re
import secrets
import time
from collections import deque
from dataclasses import dataclass, field

from client_tpu_torch.utils import lockdep

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# Decoupled streams can run to thousands of chunks; cap the per-request
# instant events so one long generation can't dominate the ring buffer.
MAX_CHUNK_EVENTS = 128

PHASES = ("queue", "compute_input", "compute_infer", "compute_output")


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


@dataclass
class TraceContext:
    """Parsed W3C trace context (https://www.w3.org/TR/trace-context/)."""

    trace_id: str
    span_id: str
    parent_span_id: str = ""
    flags: int = 1

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(trace_id=new_trace_id(), span_id=new_span_id())

    @classmethod
    def from_traceparent(cls, header: str | None) -> "TraceContext":
        """Adopt the caller's trace id (a fresh server span id becomes the
        child of the caller's span); invalid/absent headers start a new
        trace — never an error, per the spec's restart semantics."""
        if header:
            m = _TRACEPARENT_RE.match(header.strip().lower())
            if m and m.group(2) != "0" * 32 and m.group(3) != "0" * 16:
                return cls(trace_id=m.group(2), span_id=new_span_id(),
                           parent_span_id=m.group(3),
                           flags=int(m.group(4), 16))
        return cls.new()

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags & 0xFF:02x}"

    def child(self) -> "TraceContext":
        """The same trace, a new span parented on this one (the router's
        context for one forwarding attempt)."""
        return TraceContext(trace_id=self.trace_id, span_id=new_span_id(),
                            parent_span_id=self.span_id, flags=self.flags)


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class RequestTrace:
    trace_id: str
    span_id: str
    parent_span_id: str
    model_name: str
    request_id: str
    ok: bool
    spans: list[Span] = field(default_factory=list)
    chunk_ts_ns: list[int] = field(default_factory=list)
    error: str = ""
    wall_time_ms: int = 0
    # The cold first execution's ns paid inside compute_infer (0 on warm
    # requests); the cold/warm flag rides the request span's args in the
    # Chrome export.
    compile_ns: int = 0


def build_request_trace(ctx: TraceContext, model_name: str, request_id: str,
                        times, ok: bool, chunks=(),
                        error: str = "") -> RequestTrace:
    """Snapshot a finished request's phase timestamps into spans.

    ``times`` is the engine's RequestTimes; phases whose boundaries were
    never stamped (early rejects) are omitted rather than emitted as
    zero-width lies.
    """
    spans: list[Span] = []
    start = times.received or times.queue_start
    end = times.compute_output_end or times.compute_infer_end or start
    if start and end >= start:
        spans.append(Span("request", start, end))
    if times.queue_start and times.compute_start >= times.queue_start:
        spans.append(Span("queue", times.queue_start, times.compute_start))
    bounds = (
        ("compute_input", times.compute_start, times.compute_input_end),
        ("compute_infer", times.compute_input_end, times.compute_infer_end),
        ("compute_output", times.compute_infer_end,
         times.compute_output_end),
    )
    for name, s, e in bounds:
        if s and e >= s:
            spans.append(Span(name, s, e))
    return RequestTrace(
        trace_id=ctx.trace_id, span_id=ctx.span_id,
        parent_span_id=ctx.parent_span_id, model_name=model_name,
        request_id=request_id, ok=ok, spans=spans,
        chunk_ts_ns=list(chunks)[:MAX_CHUNK_EVENTS], error=error,
        wall_time_ms=int(time.time() * 1000),
        compile_ns=getattr(times, "compile_ns", 0))


class TraceStore:
    """Bounded ring buffer of finished request traces."""

    def __init__(self, capacity: int = 512):
        self._buf: deque[RequestTrace] = deque(maxlen=max(1, capacity))
        self._lock = lockdep.Lock("tracing.store")

    def add(self, trace: RequestTrace) -> None:
        with self._lock:
            self._buf.append(trace)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self, trace_id: str | None = None) -> list[RequestTrace]:
        with self._lock:
            traces = list(self._buf)
        if trace_id:
            traces = [t for t in traces if t.trace_id == trace_id]
        return traces

    def to_chrome_trace(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON (``ph:"X"`` complete events, µs units);
        one tid per request so parallel requests stack as lanes."""
        events = []
        for tid, t in enumerate(self.snapshot(trace_id), start=1):
            args = {"trace_id": t.trace_id, "span_id": t.span_id,
                    "model": t.model_name, "request_id": t.request_id,
                    "ok": t.ok, "cold_start": t.compile_ns > 0}
            if t.compile_ns:
                args["compile_ms"] = round(t.compile_ns / 1e6, 3)
            if t.parent_span_id:
                args["parent_span_id"] = t.parent_span_id
            if t.error:
                args["error"] = t.error
            for span in t.spans:
                events.append({
                    "name": f"{t.model_name}:{span.name}"
                            if span.name == "request" else span.name,
                    "cat": "request",
                    "ph": "X",
                    "ts": span.start_ns / 1e3,
                    "dur": max(0.0, (span.end_ns - span.start_ns) / 1e3),
                    "pid": 1,
                    "tid": tid,
                    "args": args,
                })
            for ts in t.chunk_ts_ns:
                events.append({
                    "name": "chunk", "cat": "stream", "ph": "i", "s": "t",
                    "ts": ts / 1e3, "pid": 1, "tid": tid,
                    "args": {"trace_id": t.trace_id},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


@dataclass
class NamedSpan:
    """One free-form span: an interval with a name, an optional span
    identity and Chrome-trace ``args``. An intermediary (the router's
    select, proxy and shed spans) records these; the engine's phase
    :class:`Span` has a fixed vocabulary."""

    name: str
    start_ns: int
    end_ns: int
    span_id: str = ""
    parent_span_id: str = ""
    args: dict = field(default_factory=dict)


@dataclass
class SpanGroup:
    """All spans one component recorded for one trace id (one request's
    timeline on the router)."""

    trace_id: str
    spans: list[NamedSpan]
    wall_time_ms: int = 0


class SpanStore:
    """Bounded ring buffer of :class:`SpanGroup` s, the router's
    counterpart of :class:`TraceStore`: one ``add`` per routed request,
    exported as Chrome trace events."""

    def __init__(self, capacity: int = 512):
        self._buf: deque[SpanGroup] = deque(maxlen=max(1, capacity))
        self._lock = lockdep.Lock("tracing.spanstore")

    def add(self, trace_id: str, spans: list[NamedSpan]) -> None:
        if not spans:
            return
        with self._lock:
            self._buf.append(SpanGroup(
                trace_id=trace_id, spans=list(spans),
                wall_time_ms=int(time.time() * 1000)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self, trace_id: str | None = None) -> list[SpanGroup]:
        with self._lock:
            groups = list(self._buf)
        if trace_id:
            groups = [g for g in groups if g.trace_id == trace_id]
        return groups

    def to_chrome_events(self, trace_id: str | None = None,
                         pid: int = 1) -> list[dict]:
        """Chrome ``ph:"X"`` events; one tid per group, so concurrent
        requests stack as lanes on the component's track."""
        events = []
        for tid, g in enumerate(self.snapshot(trace_id), start=1):
            for span in g.spans:
                events.append({
                    "name": span.name,
                    "cat": "router",
                    "ph": "X",
                    "ts": span.start_ns / 1e3,
                    "dur": max(0.0, (span.end_ns - span.start_ns) / 1e3),
                    "pid": pid,
                    "tid": tid,
                    "args": span_args(g.trace_id, span),
                })
        return events


def span_args(trace_id: str, span: NamedSpan) -> dict:
    """A named span's Chrome ``args``: its trace and span identity, then
    its own args."""
    args = {"trace_id": trace_id}
    if span.span_id:
        args["span_id"] = span.span_id
    if span.parent_span_id:
        args["parent_span_id"] = span.parent_span_id
    args.update(span.args)
    return args


def server_timing_header(times) -> str:
    """``Server-Timing`` response header (durations in ms per the spec).
    A request that ran a bucket's cold first execution carries an extra
    ``compile`` entry, so clients can attribute the outlier (InferStat's
    cold starts)."""
    parts = []
    for phase, ns in (("queue", times.queue_ns),
                      ("compute_input", times.compute_input_ns),
                      ("compute_infer", times.compute_infer_ns),
                      ("compute_output", times.compute_output_ns)):
        parts.append(f"{phase};dur={ns / 1e6:.3f}")
    compile_ns = getattr(times, "compile_ns", 0)
    if compile_ns > 0:
        parts.append(f"compile;dur={compile_ns / 1e6:.3f}")
    return ", ".join(parts)


def parse_server_timing(header: str | None) -> dict[str, float]:
    """Parse a Server-Timing header into {phase: duration_us}."""
    out: dict[str, float] = {}
    if not header:
        return out
    for entry in header.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, rest = entry.partition(";")
        for attr in rest.split(";"):
            k, _, v = attr.strip().partition("=")
            if k == "dur":
                try:
                    out[name.strip()] = float(v) * 1e3  # ms -> us
                except ValueError:
                    pass
    return out
