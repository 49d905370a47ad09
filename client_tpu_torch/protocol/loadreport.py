"""Per-replica load report: the router's steady-state routing signal.

The port's copy of ``client_tpu/protocol/loadreport.py``, byte for byte
on the wire. One replica summarises its instantaneous load as a tiny flat
record (health state, in-flight count, queue depth, active batches, the
EWMA queue-wait estimate, SLO fast burn), served two ways by both
frontends:

* pull: ``GET /v2/load`` (JSON, :meth:`LoadReport.to_json_dict`) for
  bootstrap, background refresh and people;
* piggyback: the ``X-Tpu-Load`` response header (HTTP) and the
  ``x-tpu-load`` trailing metadata (gRPC) on every inference response
  (:func:`encode_header`), so a router that forwards traffic learns each
  replica's load at no extra request.

The header form is ``key=value`` pairs, not JSON: it must keep to
header-value characters, stay short (~60 bytes) and parse cheaply on the
router's hot path. The router and the HTTP client's multi-URL mode
decode it with :func:`decode_header`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["LOAD_HEADER", "LOAD_METADATA_KEY", "LoadReport",
           "encode_header", "decode_header"]

LOAD_HEADER = "X-Tpu-Load"
LOAD_METADATA_KEY = "x-tpu-load"

_STATES = ("READY", "DEGRADED", "DRAINING")


@dataclass
class LoadReport:
    """Snapshot of one replica's load. ``wait_s`` is the engine's queue
    wait estimate (queue depth x EWMA service time / instances, summed
    over models), the signal admission control sheds on."""

    state: str = "READY"
    inflight: int = 0
    queue_depth: int = 0
    active_batches: int = 0
    wait_s: float = 0.0
    slo_fast_burn: bool = False
    models: tuple = ()
    ts: float = field(default_factory=time.time)

    @property
    def draining(self) -> bool:
        return self.state == "DRAINING"

    def score(self) -> float:
        """Routing cost, smaller is better: in-flight and queued work plus
        the wait estimate, scaled so 1 ms of predicted queueing outweighs
        a tie but never a whole queued request."""
        return (self.inflight + self.queue_depth
                + min(self.wait_s, 30.0) * 0.9)

    def to_json_dict(self) -> dict:
        return {
            "state": self.state,
            "inflight": self.inflight,
            "queue_depth": self.queue_depth,
            "active_batches": self.active_batches,
            "wait_s": round(self.wait_s, 6),
            "slo_fast_burn": self.slo_fast_burn,
            "models": list(self.models),
            "ts": self.ts,
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "LoadReport":
        return cls(
            state=str(d.get("state", "READY")),
            inflight=int(d.get("inflight", 0)),
            queue_depth=int(d.get("queue_depth", 0)),
            active_batches=int(d.get("active_batches", 0)),
            wait_s=float(d.get("wait_s", 0.0)),
            slo_fast_burn=bool(d.get("slo_fast_burn", False)),
            models=tuple(d.get("models", ()) or ()),
            ts=float(d.get("ts", 0.0) or 0.0),
        )


def encode_header(report: LoadReport) -> str:
    """The header form, ``s=READY;i=3;q=1;b=1;w=0.0040;f=0``. The model
    list stays out (its length is unbounded); a router that needs it
    pulls ``/v2/load``."""
    return (f"s={report.state};i={report.inflight};q={report.queue_depth};"
            f"b={report.active_batches};w={report.wait_s:.4f};"
            f"f={int(report.slo_fast_burn)}")


def decode_header(raw) -> LoadReport | None:
    """Parse the header form; None on absent or malformed input (a
    router or client must never fail a request over a bad telemetry
    header)."""
    if not raw:
        return None
    fields: dict[str, str] = {}
    for part in str(raw).split(";"):
        k, sep, v = part.partition("=")
        if sep:
            fields[k.strip()] = v.strip()
    # The state key is mandatory: without it any stray string would
    # decode to a default READY report.
    state = fields.get("s")
    if state not in _STATES:
        return None
    try:
        return LoadReport(
            state=state,
            inflight=int(fields.get("i", 0)),
            queue_depth=int(fields.get("q", 0)),
            active_batches=int(fields.get("b", 0)),
            wait_s=max(0.0, float(fields.get("w", 0.0))),
            slo_fast_burn=fields.get("f", "0") not in ("0", "", "false"),
        )
    except (TypeError, ValueError):
        return None
