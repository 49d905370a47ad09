"""W3C trace context and ``Server-Timing`` parsing: what the clients use.

The port's trimmed copy of ``client_tpu/observability/tracing.py``. A
client stamps each request with a ``traceparent`` (a new trace per request
unless the caller passed one) and reads the server's phase timings back
from the ``Server-Timing`` header. The span store, its Chrome-trace export
and the server-side header are not ported yet.
"""

from __future__ import annotations

import re
import secrets
from dataclasses import dataclass

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


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
        """Adopt the caller's trace id (a fresh span id becomes the child
        of the caller's span); an invalid or absent header starts a new
        trace, never an error, per the spec's restart semantics."""
        if header:
            m = _TRACEPARENT_RE.match(header.strip().lower())
            if m and m.group(2) != "0" * 32 and m.group(3) != "0" * 16:
                return cls(trace_id=m.group(2), span_id=new_span_id(),
                           parent_span_id=m.group(3),
                           flags=int(m.group(4), 16))
        return cls.new()

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags & 0xFF:02x}"


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
