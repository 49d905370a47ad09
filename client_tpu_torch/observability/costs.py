"""Per-request cost ledger: who bought the device seconds?

The port's copy of ``client_tpu/observability/costs.py``. The profiler
answers *where* card time goes, per model and bucket; this ledger answers
*who* caused it. Every request carries a **tenant tag** (the
``X-Tpu-Tenant`` HTTP header or the ``tenant`` request parameter) and the
serving layers charge measured resources to it:

- **Device-seconds** — at batch completion the scheduler splits the
  batch's device time (the same CUDA-event interval the profiler
  records) across its requests by real rows, or lookups for DLRM; the
  padded remainder goes to the batch's dominant tenant under component
  ``padding``. Decode waves split per live stream (component ``wave``).
- **Host-seconds** — the rest of a dense batch's wall time (assembly,
  dispatch, response scatter), split by the same weights.
- **Queue-seconds** — each request's measured queue wait, at dequeue.
- **HBM-byte-seconds** — the KV arena's rows held × row bytes × wall
  time, charged when a stream releases its row.
- **Interference** — ``co_batch`` dilution from foreign-tenant rows in
  one batch, ``queue_wait`` behind foreign-tenant arrivals, and
  admission sheds (a count).

Conservation is the design invariant: the sum over tenants of device
seconds (batch + wave + padding) equals the profiler's device time for
the same executions, because both are fed the same measured interval;
the ledger only splits it, never measures again.

Tenant names are bounded: ``default``, ``shadow``, names pre-registered
through ``CLIENT_TPU_COSTS`` ``{"tenants": [...]}``, and the first
``max_tenants`` names seen; the rest fold to ``other``. The ledger is
process-global (:func:`ledger`): schedulers charge from below the engine,
engines bind their metric registries from above. ``GET /v2/costs`` and
the ``Costs`` RPC render :meth:`CostLedger.snapshot`; a tenant whose
share of the rolling device-time window crosses the threshold emits a
``cost.top_talker`` event. Importing this module loads no torch.
"""

from __future__ import annotations

import json
import time
import weakref
from collections import deque
from dataclasses import dataclass

from client_tpu_torch.config import env_text
from client_tpu_torch.utils import lockdep

ENV_VAR = "CLIENT_TPU_COSTS"

# The well-known tenants that always resolve to themselves: untagged
# traffic lands on "default"; the admission controller's shadow class
# (replay fleets) lands on "shadow"; dynamic overflow folds to "other".
TENANT_DEFAULT = "default"
TENANT_SHADOW = "shadow"
TENANT_OTHER = "other"

# Device-second components (the `component` label): scheduler batch
# executions, generative decode waves, and the padded remainder.
COMPONENTS = ("batch", "wave", "padding")
# Interference causes (the `cause` label on interference seconds);
# `admission` is a shed *count*, reported in the snapshot only.
INTERFERENCE_CAUSES = ("co_batch", "queue_wait")


@dataclass(frozen=True)
class CostsConfig:
    """Knobs behind ``CLIENT_TPU_COSTS`` (unset/``1``/``on`` = defaults,
    ``0``/``off`` disables charging, else inline JSON or ``@/path.json``)."""

    enabled: bool = True
    window_s: float = 60.0          # top-talker rolling window
    top_talker_fraction: float = 0.5
    # Ignore dominance verdicts until the window holds this much device
    # time — a single 2 ms warmup batch is not a top talker.
    top_talker_min_device_s: float = 0.05
    max_tenants: int = 32           # dynamic names before folding to other
    tenants: tuple[str, ...] = ()   # pre-registered tenant names

    @classmethod
    def from_env(cls, environ=None) -> "CostsConfig":
        text = env_text(ENV_VAR, environ)
        low = text.lower()
        if low in ("0", "off", "false"):
            return cls(enabled=False)
        if low in ("", "1", "on", "true"):
            return cls()
        if text.startswith("@"):
            with open(text[1:], encoding="utf-8") as fh:
                text = fh.read()
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError(
                f"{ENV_VAR} expects a JSON object, got {type(data).__name__}")
        return cls(
            enabled=bool(data.get("enabled", True)),
            window_s=max(1.0, float(data.get("window_s", 60.0))),
            top_talker_fraction=min(1.0, max(0.0, float(
                data.get("top_talker_fraction", 0.5)))),
            top_talker_min_device_s=max(0.0, float(
                data.get("top_talker_min_device_s", 0.05))),
            max_tenants=max(0, int(data.get("max_tenants", 32))),
            tenants=tuple(str(t) for t in data.get("tenants", ())),
        )


@dataclass
class _TenantCost:
    """Accumulated charges for one (tenant, model, version)."""

    device_s: float = 0.0       # batch + wave splits (no padding)
    padding_s: float = 0.0      # padded-row device time this tenant caused
    host_s: float = 0.0         # non-device batch wall (assembly/scatter)
    queue_s: float = 0.0
    hbm_byte_s: float = 0.0
    requests: int = 0
    co_batch_s: float = 0.0     # diluted by foreign-tenant rows
    queue_wait_s: float = 0.0   # waited behind foreign-tenant occupancy
    admission_sheds: int = 0


class _Bound:
    """One engine registry's cost-counter handles (see bind_metrics)."""

    __slots__ = ("registry_ref", "device_seconds", "host_seconds",
                 "queue_seconds", "hbm_byte_seconds",
                 "interference_seconds")

    def __init__(self, registry):
        self.registry_ref = weakref.ref(registry)
        self.device_seconds = registry.counter(
            "tpu_cost_device_seconds_total",
            "Device-seconds charged to a tenant (component: batch = "
            "real-row share of scheduler executions, wave = live-stream "
            "share of decode waves, padding = padded-row waste charged "
            "to the batch's dominant tenant)",
            ("tenant", "model", "component"))
        self.host_seconds = registry.counter(
            "tpu_cost_host_seconds_total",
            "Host-side batch seconds charged to a tenant: the non-device "
            "remainder of batch wall time (input assembly, dispatch "
            "overhead, response scatter), split by the same row weights "
            "as the device bill",
            ("tenant", "model"))
        self.queue_seconds = registry.counter(
            "tpu_cost_queue_seconds_total",
            "Scheduler queue-wait seconds charged to a tenant at dequeue",
            ("tenant", "model"))
        self.hbm_byte_seconds = registry.counter(
            "tpu_cost_hbm_byte_seconds_total",
            "KV-arena HBM residency charged to a tenant (row bytes x "
            "seconds held, charged when the stream releases its row)",
            ("tenant", "model"))
        self.interference_seconds = registry.counter(
            "tpu_cost_interference_seconds_total",
            "Seconds a tenant's requests lost to other tenants, by cause "
            "(co_batch = device dilution from foreign rows in the same "
            "batch, queue_wait = wait behind foreign queue occupancy)",
            ("tenant", "model", "cause"))


class CostLedger:
    """Tenant-tagged resource accounting; see module docstring."""

    def __init__(self, config: CostsConfig | None = None,
                 now=time.monotonic_ns):
        self.config = config or CostsConfig.from_env()
        self._now = now
        self._lock = lockdep.Lock("observability.costs")
        # (tenant, model, version) -> _TenantCost
        self._costs: dict[tuple[str, str, str], _TenantCost] = {}
        # Dynamically admitted tenant names (on top of the well-known
        # and pre-registered sets), capped at config.max_tenants.
        self._dynamic: set[str] = set()
        # Rolling device-time window for top-talker detection:
        # (mono_ns, tenant, device_s) per charge.
        self._window: deque[tuple[int, str, float]] = deque()
        # Rolling per-model arrival mix: {model: deque[(mono_ns, tenant)]}
        # — feeds the queue_wait interference split at dequeue. A mix
        # window (rather than live occupancy counting) survives requests
        # that dequeue without charging (timeouts, cancels, sheds).
        self._queue_mix: dict[str, deque[tuple[int, str]]] = {}
        self._top_latched: str | None = None
        self._bound: dict[int, _Bound] = {}

    # -- tenant identity -----------------------------------------------------

    def canonical_tenant(self, tenant: str | None) -> str:
        """Fold a wire-supplied tenant tag into the bounded label space:
        empty -> ``default``; well-known and pre-registered names pass;
        the first ``max_tenants`` novel names are admitted; the rest
        fold to ``other``."""
        t = str(tenant or "").strip()[:64]
        if not t:
            return TENANT_DEFAULT
        if t in (TENANT_DEFAULT, TENANT_SHADOW, TENANT_OTHER) \
                or t in self.config.tenants:
            return t
        with self._lock:
            if t in self._dynamic:
                return t
            if len(self._dynamic) < self.config.max_tenants:
                self._dynamic.add(t)
                return t
        return TENANT_OTHER

    # -- metric binding ------------------------------------------------------

    def bind_metrics(self, registry) -> None:
        """Declare the ``tpu_cost_*`` families on an engine's
        MetricRegistry and mirror later charges into it. Idempotent per
        registry; dead registries are pruned on the next charge."""
        b = _Bound(registry)
        with self._lock:
            self._bound[id(registry)] = b

    def _bindings(self) -> list[_Bound]:
        with self._lock:
            out = []
            for rid, b in list(self._bound.items()):
                if b.registry_ref() is None:
                    del self._bound[rid]
                else:
                    out.append(b)
            return out

    # -- charging (called from the schedulers) --------------------------------

    def _cost(self, tenant: str, model: str, version) -> _TenantCost:
        key = (tenant, str(model), str(version))
        c = self._costs.get(key)
        if c is None:
            c = self._costs[key] = _TenantCost()
        return c

    def charge_batch(self, model: str, version,
                     members: list[tuple[str, int, str | None]],
                     device_s: float, padded: int = 0,
                     component: str = "batch",
                     host_s: float = 0.0) -> None:
        """Split one batch's measured device time across its members.

        ``members`` is ``[(tenant, weight, trace_id), ...]`` where weight
        is the member's real rows (or summed lookups for ragged models,
        or 1 per live stream for decode waves); ``padded`` is the zero
        rows added to reach the bucket. Each member is charged
        ``device_s * weight / (total_weight + padded)``; the padded
        remainder is charged to the dominant tenant (most weight) under
        the ``padding`` component — the batch would not have run at that
        bucket without it. ``host_s`` (the batch's wall time net of the
        device interval) splits the same way, padded remainder to the
        dominant tenant, into the separate host-seconds meter. Members
        co-batched with foreign-tenant rows additionally record
        ``co_batch`` interference: their own share scaled by the foreign
        weight fraction — the slice of their device bill attributable to
        sharing the executable with someone else."""
        host_s = max(0.0, float(host_s))
        if not self.config.enabled or not members \
                or (device_s <= 0 and host_s <= 0):
            return
        device_s = max(0.0, float(device_s))
        members = [(self.canonical_tenant(t), max(0, int(w)), tr)
                   for t, w, tr in members]
        total_w = sum(w for _, w, _ in members)
        denom = total_w + max(0, int(padded))
        if denom <= 0:
            return
        per_tenant_w: dict[str, int] = {}
        for t, w, _ in members:
            per_tenant_w[t] = per_tenant_w.get(t, 0) + w
        dominant = max(per_tenant_w, key=lambda t: per_tenant_w[t])
        padding_s = device_s * max(0, int(padded)) / denom
        end = self._now()
        charges: list[tuple[str, str, float, str | None]] = []
        host_charges: list[tuple[str, float, str | None]] = []
        with self._lock:
            for t, w, tr in members:
                share = device_s * w / denom
                hshare = host_s * w / denom
                c = self._cost(t, model, version)
                c.device_s += share
                c.host_s += hshare
                c.requests += 1
                charges.append((t, component, share, tr))
                if hshare > 0:
                    host_charges.append((t, hshare, tr))
                foreign_w = total_w - per_tenant_w[t]
                if foreign_w > 0 and total_w > 0:
                    c.co_batch_s += share * foreign_w / total_w
            host_pad = host_s * max(0, int(padded)) / denom
            if padding_s > 0 or host_pad > 0:
                dom = self._cost(dominant, model, version)
                dom.padding_s += padding_s
                dom.host_s += host_pad
                if padding_s > 0:
                    charges.append((dominant, "padding", padding_s, None))
                if host_pad > 0:
                    host_charges.append((dominant, host_pad, None))
            self._window.append((end, dominant, device_s))
            self._prune_window_locked(end)
        for b in self._bindings():
            for t, comp, share, tr in charges:
                if share > 0:
                    b.device_seconds.inc(share, exemplar=tr, tenant=t,
                                         model=str(model), component=comp)
            for t, hshare, tr in host_charges:
                b.host_seconds.inc(hshare, exemplar=tr, tenant=t,
                                   model=str(model))
            for t, w, tr in members:
                foreign_w = total_w - per_tenant_w[t]
                if foreign_w > 0 and total_w > 0 and w > 0:
                    b.interference_seconds.inc(
                        (device_s * w / denom) * foreign_w / total_w,
                        exemplar=tr, tenant=t, model=str(model),
                        cause="co_batch")
        self._maybe_top_talker(end)

    def note_queued(self, model: str, tenant: str | None) -> None:
        """One request entered the scheduler queue — recorded into the
        model's rolling arrival mix so :meth:`charge_queue` can split
        each wait into own-tenant vs behind-foreign-tenant shares."""
        if not self.config.enabled:
            return
        t = self.canonical_tenant(tenant)
        now = self._now()
        with self._lock:
            mix = self._queue_mix.get(str(model))
            if mix is None:
                mix = self._queue_mix[str(model)] = deque(maxlen=4096)
            mix.append((now, t))

    def charge_queue(self, model: str, version, tenant: str | None,
                     queue_s: float, trace_id: str | None = None) -> None:
        """Charge one request's measured queue wait at dequeue. The
        ``queue_wait`` interference share is the wait scaled by the
        foreign-tenant fraction of the model's recent arrival mix — an
        approximation of who the request actually sat behind, but one
        that converges on sustained mixes, which is when interference
        matters (and it cannot leak: requests that dequeue without
        charging simply age out of the mix window)."""
        if not self.config.enabled:
            return
        t = self.canonical_tenant(tenant)
        queue_s = max(0.0, float(queue_s))
        horizon = self._now() - int(self.config.window_s * 1e9)
        with self._lock:
            mix = self._queue_mix.get(str(model))
            total = foreign = 0
            if mix:
                while mix and mix[0][0] < horizon:
                    mix.popleft()
                for _, mt in mix:
                    total += 1
                    if mt != t:
                        foreign += 1
            c = self._cost(t, model, version)
            c.queue_s += queue_s
            wait_behind = queue_s * foreign / total if total > 0 else 0.0
            c.queue_wait_s += wait_behind
        for b in self._bindings():
            if queue_s > 0:
                b.queue_seconds.inc(queue_s, exemplar=trace_id,
                                    tenant=t, model=str(model))
            if wait_behind > 0:
                b.interference_seconds.inc(wait_behind, exemplar=trace_id,
                                           tenant=t, model=str(model),
                                           cause="queue_wait")

    def charge_hbm(self, model: str, version, tenant: str | None,
                   byte_s: float, trace_id: str | None = None) -> None:
        """Charge KV-arena residency: row bytes x seconds held, called
        when a generative stream releases its arena row."""
        if not self.config.enabled:
            return
        t = self.canonical_tenant(tenant)
        byte_s = max(0.0, float(byte_s))
        if byte_s <= 0:
            return
        with self._lock:
            self._cost(t, model, version).hbm_byte_s += byte_s
        for b in self._bindings():
            b.hbm_byte_seconds.inc(byte_s, exemplar=trace_id,
                                   tenant=t, model=str(model))

    def note_shed(self, model: str, version, tenant: str | None,
                  reason: str) -> None:
        """One admission shed attributed to a tenant (the ``admission``
        leg of the interference taxonomy — a count, not seconds: the
        request never ran, so it has no measurable duration here)."""
        if not self.config.enabled:
            return
        t = self.canonical_tenant(tenant)
        with self._lock:
            self._cost(t, model, version).admission_sheds += 1

    # -- top-talker detection --------------------------------------------------

    def _prune_window_locked(self, now: int) -> None:
        horizon = now - int(self.config.window_s * 1e9)
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()

    def _maybe_top_talker(self, now: int) -> None:
        """Edge-latched dominance check over the rolling device-time
        window: emits one ``cost.top_talker`` journal event when a tenant
        first crosses ``top_talker_fraction`` of the window (and again
        only after the crown changes hands or is vacated)."""
        with self._lock:
            self._prune_window_locked(now)
            totals: dict[str, float] = {}
            for _, t, s in self._window:
                totals[t] = totals.get(t, 0.0) + s
            window_s = sum(totals.values())
            top = max(totals, key=lambda t: totals[t]) if totals else None
            share = totals[top] / window_s if top and window_s > 0 else 0.0
            if window_s < self.config.top_talker_min_device_s \
                    or share < self.config.top_talker_fraction:
                self._top_latched = None
                return
            if top == self._top_latched:
                return
            self._top_latched = top
        # Lazy: importing the ledger must not pull in the journal's
        # environment wiring.
        from client_tpu_torch.observability.events import journal

        journal().emit(
            "cost", "top_talker", severity="WARNING", tenant=top,
            share=round(share, 4),
            window_device_s=round(window_s, 6),
            window_s=self.config.window_s)

    # -- report ---------------------------------------------------------------

    def snapshot(self, model: str | None = None) -> dict:
        """The ``GET /v2/costs`` body: per-tenant totals with a
        per-model breakdown and the interference taxonomy."""
        with self._lock:
            items = sorted(self._costs.items())
            self._prune_window_locked(self._now())
            win_totals: dict[str, float] = {}
            for _, t, s in self._window:
                win_totals[t] = win_totals.get(t, 0.0) + s
        tenants: dict[str, dict] = {}
        totals = {"device_s": 0.0, "padding_s": 0.0, "host_s": 0.0,
                  "queue_s": 0.0, "hbm_byte_s": 0.0, "requests": 0}
        for (tenant, mname, version), c in items:
            if model and mname != model:
                continue
            entry = tenants.get(tenant)
            if entry is None:
                entry = tenants[tenant] = {
                    "device_s": 0.0, "padding_s": 0.0, "host_s": 0.0,
                    "queue_s": 0.0, "hbm_byte_s": 0.0, "requests": 0,
                    "interference": {"co_batch_s": 0.0, "queue_wait_s": 0.0,
                                     "admission_sheds": 0},
                    "models": {},
                }
            row = {
                "model": mname, "version": version,
                "device_s": round(c.device_s, 6),
                "padding_s": round(c.padding_s, 6),
                "host_s": round(c.host_s, 6),
                "queue_s": round(c.queue_s, 6),
                "hbm_byte_s": round(c.hbm_byte_s, 3),
                "requests": c.requests,
                "interference": {
                    "co_batch_s": round(c.co_batch_s, 6),
                    "queue_wait_s": round(c.queue_wait_s, 6),
                    "admission_sheds": c.admission_sheds,
                },
            }
            entry["models"][f"{mname}:{version}"] = row
            entry["device_s"] += c.device_s
            entry["padding_s"] += c.padding_s
            entry["host_s"] += c.host_s
            entry["queue_s"] += c.queue_s
            entry["hbm_byte_s"] += c.hbm_byte_s
            entry["requests"] += c.requests
            entry["interference"]["co_batch_s"] += c.co_batch_s
            entry["interference"]["queue_wait_s"] += c.queue_wait_s
            entry["interference"]["admission_sheds"] += c.admission_sheds
            totals["device_s"] += c.device_s + c.padding_s
            totals["padding_s"] += c.padding_s
            totals["host_s"] += c.host_s
            totals["queue_s"] += c.queue_s
            totals["hbm_byte_s"] += c.hbm_byte_s
            totals["requests"] += c.requests
        for entry in tenants.values():
            for k in ("device_s", "padding_s", "host_s", "queue_s"):
                entry[k] = round(entry[k], 6)
            entry["hbm_byte_s"] = round(entry["hbm_byte_s"], 3)
            inter = entry["interference"]
            inter["co_batch_s"] = round(inter["co_batch_s"], 6)
            inter["queue_wait_s"] = round(inter["queue_wait_s"], 6)
        for k in ("device_s", "padding_s", "host_s", "queue_s"):
            totals[k] = round(totals[k], 6)
        totals["hbm_byte_s"] = round(totals["hbm_byte_s"], 3)
        window_total = sum(win_totals.values())
        top = max(win_totals, key=lambda t: win_totals[t]) \
            if win_totals else None
        return {
            "enabled": self.config.enabled,
            "window_s": self.config.window_s,
            "tenants": tenants,
            "totals": totals,
            "top_talker": {
                "tenant": top,
                "share": round(win_totals[top] / window_total, 4)
                if window_total > 0 else 0.0,
                "window_device_s": round(window_total, 6),
            } if top is not None else None,
        }

    def reset(self) -> None:
        """Drop accumulated charges (tests); metric bindings survive."""
        with self._lock:
            self._costs.clear()
            self._window.clear()
            self._queue_mix.clear()
            self._dynamic.clear()
            self._top_latched = None


# -- process-global default ledger --------------------------------------------

_default: CostLedger | None = None
_default_lock = lockdep.Lock("observability.costs.default")


def ledger() -> CostLedger:
    """The process-global cost ledger (double-checked, like
    :func:`client_tpu_torch.observability.profiler.profiler`): schedulers
    charge into it from below the engine; engines bind their metric
    registries to it from above."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = CostLedger()
    return _default


def reset_ledger() -> None:
    """Drop the global ledger (tests); the next ledger() recreates it
    with current env settings."""
    global _default
    with _default_lock:
        _default = None
