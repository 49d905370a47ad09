"""Drift-triggered re-placement: the fleet loop of self-drive.

The port's copy of ``client_tpu/router/selfdrive.py``. The
:class:`~client_tpu_torch.router.fleet.FleetMonitor` is a sensor; a
:class:`FleetRebalancer` on its ``on_drift`` hook is the actuator, which
turns the placement plan (:mod:`client_tpu_torch.router.placement`) into
an executed rolling move, damped as every other loop:

- **cooldown**: at most one rebalance per ``rebalance_cooldown_s``;
- **move budget**: at most ``max_moves_per_window`` load/unload steps per
  ``rebalance_window_s`` (a dropped load cancels its unloads);
- **journal edges**: ``fleet.rebalance`` when the loop fires and
  ``fleet.rebalance_done`` when its moves complete.

Unloads roll: the router quiesces the source replica, waits for its own
requests to it to finish, unloads, then unquiesces. With
``drain_after_moves`` a replica the plan emptied is then walked through
:func:`~client_tpu_torch.router.drain.rolling_drain`.
"""

from __future__ import annotations

import json
import logging
import time

from client_tpu_torch.observability.events import journal
from client_tpu_torch.router import placement as _placement
from client_tpu_torch.router.drain import rolling_drain
from client_tpu_torch.utils import lockdep

__all__ = ["fleet_plan", "FleetRebalancer"]

_log = logging.getLogger("client_tpu_torch.router.selfdrive")


def fleet_plan(router, federator=None):
    """Fetch every eligible replica's ``/v2/profile``, fold in the
    federated cost ledger's interference attribution when a federator is
    given, and run LPT. Returns ``(costs, current, plan, profiles)`` —
    the same tuple the router's placement handlers serve, shared here so
    the drift loop and the HTTP surface plan from identical logic."""
    profiles, current = {}, {}
    for r in router.eligible():
        try:
            status, _, data = r.send("GET", "/v2/profile", timeout_s=10)
            if status == 200:
                profiles[r.id] = json.loads(data)
        except Exception:  # noqa: BLE001 — plan over who answers
            continue
        current[r.id] = set(r.load.models)
    ledger_costs = None
    if federator is not None:
        try:
            ledger_costs = federator.costs()
        except Exception:  # noqa: BLE001 — plan without the ledger
            ledger_costs = None
    costs = _placement.model_costs(profiles, costs=ledger_costs)
    if not costs:
        # Nothing has executed yet: place whatever the fleet hosts.
        for models in current.values():
            for m in models:
                costs.setdefault(m, 1e-6)
    plan = _placement.plan_placement(
        costs, sorted(profiles) or sorted(current), current=current)
    return costs, current, plan, profiles


def _truncate_steps(steps: list[dict], budget: int
                    ) -> tuple[list[dict], int]:
    """Keep at most ``budget`` steps without ever breaking the
    load-before-unload invariant: a load that falls past the budget
    cancels every unload of the same model (capacity must not shrink
    when the add never happened); an unload past the budget is simply
    deferred to the next window (extra copies are harmless)."""
    loads = [s for s in steps if s["action"] == "load"]
    unloads = [s for s in steps if s["action"] == "unload"]
    kept = loads[:budget]
    dropped = {s["model"] for s in loads[budget:]}
    remaining = budget - len(kept)
    for s in unloads:
        if remaining <= 0:
            break
        if s["model"] in dropped:
            continue
        kept.append(s)
        remaining -= 1
    return kept, len(steps) - len(kept)


class FleetRebalancer:
    """Promotes ``fleet.drift`` into an executed, damped re-placement.

    Passive by design: the monitor's tick calls :meth:`on_drift`; all
    damping (cooldown, move budget) lives here so the sensor stays
    loop-free. ``clock`` is injectable for fake-clock hysteresis tests.
    """

    def __init__(self, router, config, federator=None,
                 clock=time.monotonic):
        self.router = router
        self.config = config
        self.federator = federator
        self.events = journal()
        self._clock = clock
        self._lock = lockdep.Lock("router.rebalance")
        self._last_attempt: float | None = None
        self._moves: list[float] = []   # executed-step stamps in window
        self.rebalance_count = 0
        self._last: dict = {}

    # -- trigger -------------------------------------------------------------

    def on_drift(self, report: dict) -> dict | None:
        """Monitor callback — runs on the fleet-monitor thread."""
        return self.maybe_rebalance(report)

    def maybe_rebalance(self, report: dict | None) -> dict | None:
        """One pass of the loop: if drift is flagged, the cooldown has
        lapsed, and the window has move budget, plan + execute. Returns
        the rebalance record, or ``None`` when damped/idle."""
        flagged = (report or {}).get("flagged") or {}
        if not flagged:
            return None
        cfg = self.config
        now = self._clock()
        with self._lock:
            if (self._last_attempt is not None
                    and now - self._last_attempt < cfg.rebalance_cooldown_s):
                return None
            self._moves = [t for t in self._moves
                           if now - t < cfg.rebalance_window_s]
            budget = cfg.max_moves_per_window - len(self._moves)
            if budget <= 0:
                return None
            # Stamp before executing so a slow apply can't double-fire.
            self._last_attempt = now
        try:
            record = self._rebalance(flagged, budget, now)
        except Exception:  # noqa: BLE001 — actuator failure is journaled
            _log.exception("fleet rebalance failed")
            self.events.emit("fleet", "rebalance_done", severity="ERROR",
                             outcome="error", moves=0)
            return None
        with self._lock:
            self._last = record
        return record

    # -- act -----------------------------------------------------------------

    def _rebalance(self, flagged: dict, budget: int, now: float) -> dict:
        costs, current, plan, profiles = fleet_plan(self.router,
                                                    self.federator)
        steps = _placement.placement_moves(plan, current)
        rejected: list[dict] = []
        if profiles:
            steps, rejected = _placement.budget_guard(
                steps, profiles, events=self.events)
        steps, truncated = _truncate_steps(steps, budget)
        record = {"ts": now, "flagged": sorted(flagged),
                  "plan": plan, "moves": len(steps),
                  "truncated": truncated, "rejected": len(rejected),
                  "applied": []}
        if not steps:
            # Drift without a better placement (plan == current, or the
            # guard rejected everything): nothing to actuate. The
            # cooldown stamp stays so the loop doesn't replan every
            # tick while the same replica drifts.
            record["outcome"] = "stable"
            return record
        self.events.emit(
            "fleet", "rebalance", severity="WARNING",
            replicas=sorted(flagged), moves=len(steps),
            truncated=truncated,
            plan={rid: ms for rid, ms in plan.items()})
        results = self._execute(steps)
        record["applied"] = results
        ok = all(r.get("ok") for r in results)
        record["outcome"] = "ok" if ok else "partial"
        with self._lock:
            self._moves.extend(self._clock() for _ in results)
            self.rebalance_count += 1
        drained = []
        if self.config.drain_after_moves and ok:
            drained = self._drain_evacuated(plan)
            record["drained"] = drained
        self.events.emit(
            "fleet", "rebalance_done",
            severity="INFO" if ok else "WARNING",
            outcome=record["outcome"], moves=len(results),
            failed=sum(1 for r in results if not r.get("ok")),
            drained=drained)
        return record

    def _execute(self, steps: list[dict]) -> list[dict]:
        """Issue loads fleet-wide first (adding capacity never disturbs
        traffic), then roll the unloads replica by replica under
        quiesce, so in-flight work to the source finishes before its
        copy disappears. A failed load aborts all unloads — the same
        never-remove-after-a-failed-add invariant as
        :func:`~client_tpu_torch.router.placement.apply_placement`."""
        results = []
        loads = [s for s in steps if s["action"] == "load"]
        unloads = [s for s in steps if s["action"] == "unload"]
        for step in loads:
            res = self._post_step(step)
            results.append(res)
            if not res["ok"]:
                return results
        by_replica: dict[str, list[dict]] = {}
        for step in unloads:
            by_replica.setdefault(step["replica"], []).append(step)
        for rid in sorted(by_replica):
            replica = self.router.replica(rid)
            self.router.quiesce(rid)
            try:
                deadline = time.monotonic() + self.config.quiesce_wait_s
                while (replica.outstanding > 0
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                for step in by_replica[rid]:
                    results.append(self._post_step(step))
            finally:
                self.router.unquiesce(rid)
        return results

    def _post_step(self, step: dict) -> dict:
        replica = self.router.replica(step["replica"])
        path = f"/v2/repository/models/{step['model']}/{step['action']}"
        try:
            status, _, data = replica.send(
                "POST", path, headers={"Content-Type": "application/json"},
                body=b"{}", timeout_s=120.0)
            ok = status == 200
            err = None if ok else json.loads(data or b"{}").get(
                "error", f"HTTP {status}")
        except Exception as exc:  # noqa: BLE001
            ok, err = False, repr(exc)
        res = {**step, "ok": ok, **({"error": err} if err else {})}
        self.router.events.emit("router", "placement_step",
                                severity="INFO" if ok else "ERROR", **res)
        return res

    def _drain_evacuated(self, plan: dict) -> list[dict]:
        """Walk replicas the plan left empty through a proper rolling
        drain — the plan said the fleet no longer needs them."""
        empty = [rid for rid, models in plan.items() if not models]
        if not empty:
            return []
        return rolling_drain(self.router, empty,
                             deadline_s=self.config.quiesce_wait_s)

    # -- observe -------------------------------------------------------------

    def snapshot(self) -> dict:
        cfg = self.config
        now = self._clock()
        with self._lock:
            window = [t for t in self._moves
                      if now - t < cfg.rebalance_window_s]
            cooldown = (max(0.0, cfg.rebalance_cooldown_s
                            - (now - self._last_attempt))
                        if self._last_attempt is not None else 0.0)
            return {
                "rebalances": self.rebalance_count,
                "window_moves": len(window),
                "window_budget": cfg.max_moves_per_window,
                "cooldown_remaining_s": round(cooldown, 3),
                "last": dict(self._last),
            }
