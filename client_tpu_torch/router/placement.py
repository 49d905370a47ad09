"""Contention-aware model-to-replica placement from ``/v2/profile``.

The port's copy of ``client_tpu/router/placement.py``. Two hot models on
one replica fight for one device, so each model's measured
device-seconds (the replicas' efficiency profilers) is its contention
cost, plus an HBM term for its reservation and the cost ledger's
interference seconds; placement is the longest-processing-time greedy,
the heaviest model first onto the replica with the least accumulated
cost (within 4/3 of the optimal makespan, deterministic, explainable).

A plan is a control-plane action (``GET``/``POST /v2/router/placement``
or the self-drive rebalancer), never something the data path does on its
own: moving a model means load/unload churn and cold buckets.
"""

from __future__ import annotations

import json

__all__ = ["model_costs", "interference_costs", "model_hbm_bytes",
           "plan_placement", "placement_moves", "budget_guard",
           "apply_placement"]


HBM_WEIGHT_S_PER_GB = 10.0
# Interference device-seconds (co-batch + queue-wait legs of the cost
# ledger's attribution) count this much extra contention cost. >1
# because interference a model *already* suffered predicts it will fight
# whatever it is co-located with next.
INTERFERENCE_WEIGHT = 2.0


def interference_costs(costs: dict | None) -> dict[str, float]:
    """Per-model interference device-seconds from a (federated)
    ``/v2/costs`` snapshot: the ledger's co-batch and queue-wait legs
    summed across tenants and versions. These are the seconds a model
    spent fighting its co-residents — the empirical contention signal
    the placement cost folds in."""
    out: dict[str, float] = {}
    for tenant in ((costs or {}).get("tenants") or {}).values():
        for mkey, row in (tenant.get("models") or {}).items():
            name = mkey.rsplit(":", 1)[0]
            inter = row.get("interference") or {}
            out[name] = out.get(name, 0.0) \
                + float(inter.get("co_batch_s", 0.0) or 0.0) \
                + float(inter.get("queue_wait_s", 0.0) or 0.0)
    return out


def model_costs(profiles: dict[str, dict],
                hbm_weight_s_per_gb: float = HBM_WEIGHT_S_PER_GB,
                costs: dict | None = None,
                interference_weight: float = INTERFERENCE_WEIGHT,
                ) -> dict[str, float]:
    """Fleet-wide per-model contention cost from ``/v2/profile`` bodies:
    device-seconds summed across replicas and versions (device time is
    the resource replicas contend on), plus an HBM term — each model's
    reported ``hbm_bytes`` reservation (embedding tables, KV arenas)
    weighted at ``hbm_weight_s_per_gb`` device-seconds per GiB. Memory is
    a *capacity*, not a rate: one copy's reservation is taken (max across
    replicas, not summed), so LPT spreads two table-heavy models onto
    different replicas even when both are idle. Models that have never
    executed and reserve nothing cost a nominal epsilon so they still
    get spread out.

    ``costs`` (a federated ``/v2/costs`` snapshot) adds the cost
    ledger's interference attribution: a model that measurably co-batched
    or queued behind its co-residents gets
    ``interference_weight x`` those device-seconds on top, so LPT
    separates the DLRM/generative/vision kind of mix that looks cheap by
    device time alone but pathological when co-located."""
    device_s: dict[str, float] = {}
    hbm_bytes: dict[str, float] = {}
    for prof in profiles.values():
        for entry in (prof.get("models") or {}).values():
            name = entry.get("model")
            if not name:
                continue
            device_s[name] = device_s.get(name, 0.0) + float(
                entry.get("device_s", 0.0) or 0.0)
            hbm_bytes[name] = max(hbm_bytes.get(name, 0.0), float(
                entry.get("hbm_bytes", 0) or 0))
    inter = interference_costs(costs)
    return {m: (c + hbm_bytes[m] / (1 << 30) * hbm_weight_s_per_gb
                + interference_weight * inter.get(m, 0.0)
                if c + hbm_bytes[m] + inter.get(m, 0.0) > 0 else 1e-6)
            for m, c in device_s.items()}


def plan_placement(costs: dict[str, float], replica_ids: list[str],
                   current: dict[str, set] | None = None,
                   min_replicas_per_model: int = 1) -> dict[str, list[str]]:
    """LPT greedy: heaviest model first onto the least-loaded replica.

    ``current`` (replica id -> models hosted now) breaks ties toward the
    replica already hosting the model, so a balanced fleet replans to
    itself and nothing churns. Returns replica id -> sorted model list;
    every model lands on at least ``min_replicas_per_model`` replicas
    (capped at the fleet size).
    """
    if not replica_ids:
        raise ValueError("no replicas to place onto")
    current = current or {}
    copies = min(max(1, min_replicas_per_model), len(replica_ids))
    accumulated = {rid: 0.0 for rid in replica_ids}
    plan: dict[str, list[str]] = {rid: [] for rid in replica_ids}
    for model, cost in sorted(costs.items(),
                              key=lambda kv: (-kv[1], kv[0])):
        placed: set[str] = set()
        for _ in range(copies):
            rid = min(
                (r for r in replica_ids if r not in placed),
                key=lambda r: (accumulated[r],
                               model not in current.get(r, ()), r))
            plan[rid].append(model)
            accumulated[rid] += cost / copies
            placed.add(rid)
    return {rid: sorted(models) for rid, models in plan.items()}


def placement_moves(plan: dict[str, list[str]],
                    current: dict[str, set]) -> list[dict]:
    """Diff a plan against current hosting into explicit load/unload
    steps. Loads come first across the whole fleet so capacity is added
    before it is removed (no model ever has zero live copies mid-apply)."""
    loads, unloads = [], []
    for rid, models in plan.items():
        have = set(current.get(rid, ()))
        want = set(models)
        loads += [{"replica": rid, "action": "load", "model": m}
                  for m in sorted(want - have)]
        unloads += [{"replica": rid, "action": "unload", "model": m}
                    for m in sorted(have - want)]
    return loads + unloads


def model_hbm_bytes(profiles: dict[str, dict]) -> dict[str, float]:
    """Per-model HBM reservation (max across replicas) from the
    profiles' per-model ``hbm_bytes`` annotations."""
    out: dict[str, float] = {}
    for prof in profiles.values():
        for entry in (prof.get("models") or {}).values():
            name = entry.get("model")
            if name:
                out[name] = max(out.get(name, 0.0),
                                float(entry.get("hbm_bytes", 0) or 0))
    return out


def budget_guard(steps: list[dict], profiles: dict[str, dict],
                 headroom: float = 0.95,
                 events=None) -> tuple[list[dict], list[dict]]:
    """Apply-path HBM guard: drop load steps whose target replica lacks
    census-reported free HBM (``memory.bytes_limit x headroom`` minus
    ``memory.committed_bytes``, from the replica's own profile) for the
    model's reservation, *before* any step is issued — rejecting up
    front beats failing mid-apply with capacity already removed. A
    rejected load also cancels every unload of the same model this
    apply (the copy count must not shrink because the add never
    happened). Replicas that report no limit (CPU dev, tests without a
    device) are not guarded. Returns (admitted, rejected); each
    rejection is journaled as ``placement.rejected_budget``."""
    sizes = model_hbm_bytes(profiles)
    free: dict[str, float] = {}
    for rid, prof in profiles.items():
        mem = prof.get("memory") or {}
        limit = float(mem.get("bytes_limit", 0) or 0)
        if limit > 0:
            free[rid] = limit * headroom - float(
                mem.get("committed_bytes", 0) or 0)
    admitted, rejected, cancelled_models = [], [], set()
    for step in steps:
        if step["action"] != "load":
            continue
        rid, model = step["replica"], step["model"]
        need = sizes.get(model, 0.0)
        if rid in free and need > free[rid]:
            rejected.append({**step, "ok": False,
                             "error": "rejected_budget",
                             "need_bytes": int(need),
                             "free_bytes": int(max(0, free[rid]))})
            cancelled_models.add(model)
            if events is not None:
                events.emit("placement", "rejected_budget",
                            severity="WARNING", model=model,
                            replica=rid, need_bytes=int(need),
                            free_bytes=int(max(0, free[rid])))
        else:
            if rid in free:
                free[rid] -= need
            admitted.append(step)
    for step in steps:
        if step["action"] != "unload":
            continue
        if step["model"] in cancelled_models:
            rejected.append({**step, "ok": False,
                             "error": "cancelled_with_rejected_load"})
        else:
            admitted.append(step)
    return admitted, rejected


def apply_placement(router, plan: dict[str, list[str]],
                    profiles: dict[str, dict] | None = None) -> list[dict]:
    """Issue the load/unload steps against the replicas through their
    repository control plane. Returns the step list with per-step
    ``ok``/``error`` annotations; a failed load aborts before any unload
    runs (capacity is never removed after an add failed). With
    ``profiles`` (the same ``/v2/profile`` bodies the plan came from),
    :func:`budget_guard` vets each load against the target replica's
    census-reported free HBM first."""
    current = {r.id: set(r.load.models) for r in router.replicas}
    steps = placement_moves(plan, current)
    results = []
    if profiles:
        steps, rejected = budget_guard(steps, profiles,
                                       events=router.events)
        results.extend(rejected)
    for step in steps:
        replica = router.replica(step["replica"])
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
        results.append({**step, "ok": ok, **({"error": err} if err else {})})
        router.events.emit("router", "placement_step",
                           severity="INFO" if ok else "ERROR", **results[-1])
        if not ok and step["action"] == "load":
            break
    return results
