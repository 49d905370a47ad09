"""Per-replica load report: what a multi-URL client reads.

The port's trimmed copy of ``client_tpu/protocol/loadreport.py``. A
server may piggyback its load on every inference response as the
``X-Tpu-Load`` header (``s=READY;i=3;q=1;b=1;w=0.004;f=0``); the HTTP
client's multi-URL mode decodes it to rank its targets. The port's
servers do not send it yet, so every target's report stays None and the
client ranks on its own outstanding counts alone, as the JAX client does
when the header is absent.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LOAD_HEADER", "LoadReport", "decode_header"]

LOAD_HEADER = "X-Tpu-Load"

_STATES = ("READY", "DEGRADED", "DRAINING")


@dataclass
class LoadReport:
    """Snapshot of one replica's load; ``wait_s`` is its queue-wait
    estimate."""

    state: str = "READY"
    inflight: int = 0
    queue_depth: int = 0
    active_batches: int = 0
    wait_s: float = 0.0
    slo_fast_burn: bool = False

    @property
    def draining(self) -> bool:
        return self.state == "DRAINING"

    def score(self) -> float:
        """Routing cost, smaller is better: in-flight and queued work plus
        the wait estimate, scaled so 1 ms of predicted queueing outweighs
        a tie but never a whole queued request."""
        return (self.inflight + self.queue_depth
                + min(self.wait_s, 30.0) * 0.9)


def decode_header(raw) -> LoadReport | None:
    """Parse the header form; None on absent or malformed input (a
    client must never fail a request over a bad telemetry header)."""
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
