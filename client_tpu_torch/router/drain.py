"""Coordinated rolling drain: walk replicas through graceful drain one at
a time, gated on the fleet's readiness.

The port's copy of ``client_tpu/router/drain.py``. Each replica drains
itself on SIGTERM (``client_tpu_torch.admission.drain``: readiness turns
to DRAINING, new work gets pushback, work in flight finishes). The fleet
adds coordination: one replica at a time, no step unless the rest of
the fleet can take the traffic, and the router stops routing to a
replica BEFORE telling it to drain, so no request the router sends lands
on a draining replica.

One step of the walk:

1. **readiness gate**: at least one *other* replica answers
   ``/v2/health/ready`` 200 (a live probe, not the cached load view);
   otherwise the step is ``skipped`` and the walk stops.
2. **quiesce**: the router stops selecting the replica, then waits for
   its own outstanding requests to it to reach zero.
3. **trigger**: ``SIGTERM`` to the replica's pid, or a caller's callable
   (an in-process replica passes a closure over its drain).
4. **observe**: poll the replica until it reports DRAINING and then stops
   answering (its process exited), within ``deadline_s``.

The walk is sequential on purpose: a rolling drain exists to keep
serving capacity up.
"""

from __future__ import annotations

import os
import signal
import time

__all__ = ["rolling_drain"]


def _default_trigger(replica):
    """SIGTERM the replica's process — the same signal its orchestrator
    would send — relying on the server's installed drain handler."""
    if replica.pid is None:
        raise ValueError(f"replica {replica.id} has no pid and no "
                         "explicit drain trigger")
    os.kill(replica.pid, signal.SIGTERM)


def rolling_drain(router, replica_ids=None, *, triggers=None,
                  deadline_s: float = 30.0, poll_s: float = 0.05,
                  gate_timeout_s: float = 10.0) -> list[dict]:
    """Walk ``replica_ids`` (default: every replica, in registration
    order) through graceful drain. ``triggers`` maps replica id -> a
    zero-arg callable that starts that replica's drain; replicas absent
    from the map fall back to SIGTERM-by-pid. Returns one report per
    replica: ``{"replica", "outcome", "step_s", ...}`` with outcome
    ``clean`` (observed DRAINING, then gone), ``timeout`` (still
    answering at the deadline), or ``skipped`` (readiness gate failed —
    the walk stops so the fleet never loses its last server)."""
    triggers = triggers or {}
    ids = list(replica_ids) if replica_ids is not None else [
        r.id for r in router.replicas]
    reports: list[dict] = []
    for rid in ids:
        replica = router.replica(rid)
        t0 = time.monotonic()
        # 1. readiness gate: someone else must be ready to take traffic.
        gate_deadline = t0 + gate_timeout_s
        gated = False
        while time.monotonic() < gate_deadline and not gated:
            for other in router.replicas:
                if other.id == rid:
                    continue
                try:
                    ready, _ = other.probe_ready(timeout_s=2.0)
                except Exception:  # noqa: BLE001 — probe failure = not ready
                    ready = False
                if ready:
                    gated = True
                    break
            if not gated:
                time.sleep(poll_s)
        if not gated:
            router.metrics.drain_steps.inc(replica=rid, outcome="skipped")
            router.events.emit("router", "drain_skipped", severity="ERROR",
                               replica=rid,
                               reason="no other replica ready")
            reports.append({"replica": rid, "outcome": "skipped",
                            "step_s": round(time.monotonic() - t0, 3)})
            break
        # 2. quiesce, and let router-sent in-flight requests finish.
        router.quiesce(rid)
        step_deadline = time.monotonic() + deadline_s
        while replica.outstanding > 0 and time.monotonic() < step_deadline:
            time.sleep(poll_s)
        # 3. trigger the replica's own graceful drain.
        router.events.emit("router", "drain_step", replica=rid)
        trigger = triggers.get(rid, None)
        try:
            if trigger is not None:
                trigger()
            else:
                _default_trigger(replica)
        except Exception as exc:  # noqa: BLE001
            router.metrics.drain_steps.inc(replica=rid, outcome="skipped")
            router.events.emit("router", "drain_skipped", severity="ERROR",
                               replica=rid, reason=repr(exc))
            reports.append({"replica": rid, "outcome": "skipped",
                            "error": repr(exc),
                            "step_s": round(time.monotonic() - t0, 3)})
            router.unquiesce(rid)
            continue
        # 4. observe DRAINING, then gone.
        saw_draining = False
        outcome = "timeout"
        while time.monotonic() < step_deadline:
            try:
                ready, state = replica.probe_ready(timeout_s=2.0)
            except Exception:  # noqa: BLE001 — frontends stopped: drained
                outcome = "clean" if saw_draining else "gone"
                break
            if not ready and state == "DRAINING":
                saw_draining = True
            time.sleep(poll_s)
        router.metrics.drain_steps.inc(replica=rid, outcome=outcome)
        router.events.emit(
            "router", "drain_done",
            severity="INFO" if outcome in ("clean", "gone") else "WARNING",
            replica=rid, outcome=outcome)
        reports.append({"replica": rid, "outcome": outcome,
                        "saw_draining": saw_draining,
                        "step_s": round(time.monotonic() - t0, 3)})
    return reports
