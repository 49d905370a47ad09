"""Tenant QoS: named classes, WFQ weights, quotas, preemption, governor.

The port's copy of ``client_tpu/admission/qos.py``:

* **Named classes**: ``CLIENT_TPU_QOS`` (inline JSON or ``@/path``)
  declares classes such as ``interactive`` / ``batch`` / ``shadow``, each
  with a WFQ ``weight``, an optional token-bucket quota
  (``tokens_per_s`` + ``burst``), per-class ``max_inflight`` /
  ``max_queue_depth`` caps, and a ``priority_level`` a class implies
  when a request carries no priority.
* **Tenant to class**: the ``tenants`` table maps the request's tenant
  tag (``X-Tpu-Tenant``, the gRPC ``tenant`` parameter) onto a class; an
  unmapped tenant falls back on a class's ``min_priority`` band, then on
  ``default_class``.
* **Weighted fair queueing**: the dynamic and ragged schedulers swap
  their priority heap for a deficit-round-robin queue over one lane per
  class (``engine/scheduler.py`` ``_WfqQueue``); this module only carries
  the weights.
* **Preemption**: a ``"preempt": true`` class (interactive) splits a
  batch-class batch being gathered instead of waiting behind a full
  wave; counted on ``tpu_qos_preemptions_total``.
* **Class-aware pushback**: a shed capped tenant gets a ``Retry-After``
  from its own bucket's refill time.
* **SLO-burn governor**: while the SLO tracker's fast-burn alarm fires,
  the governor tightens the bucket of the non-protected class with the
  largest cost-ledger occupancy growth over the last tick, and walks it
  back once the alarm stays clear; journalled as edge-triggered
  ``qos.throttle`` / ``qos.restore`` and exported as
  ``tpu_qos_throttle_ratio{qos_class}``.

With ``CLIENT_TPU_QOS`` unset the controller is disabled: schedulers keep
their priority heap and admission runs only the shared gates.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

from client_tpu_torch.admission import (
    MIN_RETRY_AFTER_S,
    AdmissionError,
    TokenBucket,
)
from client_tpu_torch.config import env_text
from client_tpu_torch.utils import lockdep

__all__ = [
    "ENV_VAR",
    "DEFAULT_CLASS",
    "QosClassConfig",
    "QosConfig",
    "QosController",
]

ENV_VAR = "CLIENT_TPU_QOS"

# The implicit class for unmapped tenants when the config names none.
DEFAULT_CLASS = "default"

# Governor defaults: halve the offending class's rate per tighten step,
# never below this fraction of the configured rate, and restore (double
# back up) only after the burn alarm has stayed clear for a hold.
_THROTTLE_FACTOR = 0.5
_MIN_RATE_RATIO = 0.1
_RESTORE_HOLD_S = 5.0
_GOVERNOR_INTERVAL_S = 1.0


@dataclass
class QosClassConfig:
    """One named tenant class. Zeroed limits are disabled, like
    :class:`~client_tpu_torch.admission.AdmissionConfig`."""

    name: str = ""
    # WFQ share: deficit-round-robin quantum is proportional to this.
    weight: float = 1.0
    # Scheduler priority stamped on requests that arrive with
    # priority <= 0 (0 keeps the model's default level).
    priority_level: int = 0
    # Requests with priority >= min_priority classify here when their
    # tenant is unmapped (generalizes shadow_priority; 0 = no band).
    min_priority: int = 0
    # Token-bucket quota (requests/s); burst defaults to the rate.
    tokens_per_s: float = 0.0
    burst: float = 0.0
    # Per-class concurrency / backlog caps.
    max_inflight: int = 0
    max_queue_depth: int = 0
    # Arrivals of this class split an in-assembly batch of other lanes.
    preempt: bool = False
    # The governor never throttles a protected class.
    protect: bool = False

    _FIELDS = ("weight", "priority_level", "min_priority", "tokens_per_s",
               "burst", "max_inflight", "max_queue_depth", "preempt",
               "protect")

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "QosClassConfig":
        d = dict(d or {})
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            raise ValueError(
                f"unknown qos class keys for '{name}': {sorted(unknown)}")
        out = cls(name=name, **d)
        if out.weight <= 0:
            raise ValueError(f"qos class '{name}': weight must be > 0")
        return out


@dataclass
class QosConfig:
    """The ``CLIENT_TPU_QOS`` grammar::

        {"classes": {"interactive": {"weight": 8, "preempt": true,
                                     "protect": true},
                     "batch":       {"weight": 2, "priority_level": 4},
                     "shadow":      {"weight": 1, "priority_level": 8,
                                     "min_priority": 8,
                                     "tokens_per_s": 50, "burst": 10,
                                     "max_inflight": 4,
                                     "max_queue_depth": 16}},
         "tenants": {"shadow": "shadow", "etl": "batch"},
         "default_class": "interactive"}

    Unknown keys fail fast (a typo must not silently disable a cap).
    """

    classes: dict[str, QosClassConfig] = field(default_factory=dict)
    tenants: dict[str, str] = field(default_factory=dict)
    default_class: str = ""
    throttle_factor: float = _THROTTLE_FACTOR
    min_rate_ratio: float = _MIN_RATE_RATIO
    restore_hold_s: float = _RESTORE_HOLD_S
    governor_interval_s: float = _GOVERNOR_INTERVAL_S

    _FIELDS = ("classes", "tenants", "default_class", "throttle_factor",
               "min_rate_ratio", "restore_hold_s", "governor_interval_s")

    @property
    def enabled(self) -> bool:
        return bool(self.classes)

    @classmethod
    def from_dict(cls, d: dict) -> "QosConfig":
        d = dict(d or {})
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            raise ValueError(f"unknown qos config keys: {sorted(unknown)}")
        classes = {
            str(name): QosClassConfig.from_dict(str(name), spec)
            for name, spec in (d.pop("classes", {}) or {}).items()
        }
        tenants = {str(t): str(c)
                   for t, c in (d.pop("tenants", {}) or {}).items()}
        cfg = cls(classes=classes, tenants=tenants, **d)
        for tenant, cname in cfg.tenants.items():
            if cname not in cfg.classes:
                raise ValueError(
                    f"qos tenant '{tenant}' maps to undeclared class "
                    f"'{cname}'")
        if cfg.default_class and cfg.default_class not in cfg.classes:
            raise ValueError(
                f"qos default_class '{cfg.default_class}' is not declared")
        if not cfg.default_class and cfg.classes:
            # Deterministic fallback: a declared class named "default",
            # else the highest-weight class (ties break by name).
            if DEFAULT_CLASS in cfg.classes:
                cfg.default_class = DEFAULT_CLASS
            else:
                cfg.default_class = max(
                    cfg.classes,
                    key=lambda n: (cfg.classes[n].weight, n))
        return cfg

    @classmethod
    def from_env(cls, environ=os.environ) -> "QosConfig":
        raw = env_text(ENV_VAR, environ)
        if not raw:
            return cls()
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        return cls.from_dict(json.loads(raw))


class _ClassState:
    """Runtime state for one class: quota bucket, in-flight count,
    governor throttle ratio, shed/preempt tallies."""

    __slots__ = ("cfg", "bucket", "inflight", "throttle_ratio",
                 "sheds", "preemptions", "throttles")

    def __init__(self, cfg: QosClassConfig, clock):
        self.cfg = cfg
        self.bucket = None
        if cfg.tokens_per_s > 0:
            self.bucket = TokenBucket(
                cfg.tokens_per_s, cfg.burst or cfg.tokens_per_s,
                clock=clock)
        self.inflight = 0
        self.throttle_ratio = 1.0
        self.sheds = 0
        self.preemptions = 0
        self.throttles = 0


class QosController:
    """Classify, gate, and govern tenant classes for one engine.

    The engine stamps ``req.qos_class`` via :meth:`classify`, the
    admission controller calls :meth:`admit` ahead of its shared gates,
    the scheduler's WFQ queue reads :meth:`weight` / :meth:`is_preempt`
    and reports batch splits through :meth:`note_preemption`, and the
    governor thread (:meth:`start_governor`) closes the SLO-burn →
    token-bucket feedback loop.
    """

    def __init__(self, config: QosConfig | None = None, metrics=None,
                 clock=time.monotonic):
        self.config = config or QosConfig()
        self._metrics = metrics  # EngineMetrics | None
        self._clock = clock
        self._lock = lockdep.Lock("qos.controller")
        self._classes: dict[str, _ClassState] = {
            name: _ClassState(cfg, clock)
            for name, cfg in self.config.classes.items()
        }
        # Governor state: last burn sighting, last occupancy totals.
        self._governor: threading.Thread | None = None
        self._governor_stop = threading.Event()
        self._last_burn_ts = 0.0
        self._last_occupancy: dict[str, float] = {}

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    @classmethod
    def from_env(cls, metrics=None, environ=os.environ) -> "QosController":
        return cls(QosConfig.from_env(environ), metrics=metrics)

    # -- classification -------------------------------------------------------

    def classify(self, tenant: str = "", priority: int = 0) -> str:
        """Tenant table first, then the widest matching ``min_priority``
        band, then ``default_class``."""
        if not self.enabled:
            return ""
        cname = self.config.tenants.get(tenant or "")
        if cname:
            return cname
        if priority > 0:
            banded = [c for c in self.config.classes.values()
                      if 0 < c.min_priority <= priority]
            if banded:
                # The tightest band wins: highest min_priority at/below
                # the request's priority.
                return max(banded, key=lambda c: c.min_priority).name
        return self.config.default_class

    def priority_level(self, cls_name: str) -> int:
        cfg = self.config.classes.get(cls_name)
        return cfg.priority_level if cfg is not None else 0

    def weight(self, cls_name: str) -> float:
        cfg = self.config.classes.get(cls_name)
        return cfg.weight if cfg is not None else 1.0

    def is_preempt(self, cls_name: str) -> bool:
        cfg = self.config.classes.get(cls_name)
        return bool(cfg is not None and cfg.preempt)

    def class_names(self) -> list[str]:
        return list(self.config.classes)

    # -- admission gates ------------------------------------------------------

    def admit(self, model: str, cls_name: str, *,
              class_queue_depth: int = 0) -> None:
        """Per-class gates ahead of the shared admission checks; raises
        :class:`AdmissionError` (reason ``qos_inflight`` / ``qos_queue``
        / ``qos_throttled``) on shed. Pushback is **class-aware**: when
        the class carries a bucket, every shed advertises that bucket's
        refill time — honest long pushback for rate-capped batch/shadow
        tenants instead of the shared EWMA estimate."""
        state = self._classes.get(cls_name)
        if state is None:
            return
        cfg = state.cfg
        if cfg.max_inflight > 0 and state.inflight >= cfg.max_inflight:
            self._shed(model, state, "qos_inflight", AdmissionError(
                f"qos class '{cls_name}' is at its concurrency cap "
                f"({state.inflight}/{cfg.max_inflight} in flight)",
                retry_after_s=self._class_pushback(state),
                reason="qos_inflight"))
        if cfg.max_queue_depth > 0 \
                and class_queue_depth >= cfg.max_queue_depth:
            self._shed(model, state, "qos_queue", AdmissionError(
                f"qos class '{cls_name}' queue depth {class_queue_depth} "
                f"is at its cap ({cfg.max_queue_depth})",
                retry_after_s=self._class_pushback(state),
                reason="qos_queue"))
        if state.bucket is not None and not state.bucket.try_acquire():
            self._shed(model, state, "qos_throttled", AdmissionError(
                f"qos class '{cls_name}' request rate exceeds "
                f"{state.bucket.rate:g}/s (burst {state.bucket.burst:g}"
                f"{', throttled' if state.throttle_ratio < 1.0 else ''})",
                retry_after_s=state.bucket.retry_after_s(),
                reason="qos_throttled"))

    @staticmethod
    def _class_pushback(state: _ClassState) -> float:
        """Class-aware Retry-After: the class bucket's refill time when
        one is configured (a capped tenant cannot usefully retry before
        a token exists), else the floor."""
        if state.bucket is not None:
            return state.bucket.retry_after_s()
        return MIN_RETRY_AFTER_S

    def _shed(self, model: str, state: _ClassState, reason: str,
              exc: AdmissionError):
        with self._lock:
            state.sheds += 1
        if self._metrics is not None:
            self._metrics.qos_sheds.inc(
                qos_class=state.cfg.name, reason=reason)
        raise exc

    # -- lifetime accounting --------------------------------------------------

    def on_request_start(self, cls_name: str) -> None:
        state = self._classes.get(cls_name)
        if state is None:
            return
        with self._lock:
            state.inflight += 1
            inflight = state.inflight
        if self._metrics is not None:
            self._metrics.qos_inflight.set(inflight, qos_class=cls_name)

    def on_request_end(self, cls_name: str) -> None:
        state = self._classes.get(cls_name)
        if state is None:
            return
        with self._lock:
            state.inflight = max(0, state.inflight - 1)
            inflight = state.inflight
        if self._metrics is not None:
            self._metrics.qos_inflight.set(inflight, qos_class=cls_name)

    def note_preemption(self, model: str, cls_name: str) -> None:
        """A WFQ batch split in ``cls_name``'s favor (scheduler hook)."""
        state = self._classes.get(cls_name)
        if state is not None:
            with self._lock:
                state.preemptions += 1
        if self._metrics is not None:
            self._metrics.qos_preemptions.inc(model=model)

    # -- the SLO-burn governor ------------------------------------------------

    def throttle(self, cls_name: str, reason: str = "slo_burn") -> bool:
        """Tighten one class's bucket by ``throttle_factor`` (floored at
        ``min_rate_ratio`` x configured rate). Returns True when the
        rate actually moved. The unthrottled→throttled edge lands in
        the journal as ``qos.throttle``."""
        state = self._classes.get(cls_name)
        if state is None or state.bucket is None or state.cfg.protect:
            return False
        with self._lock:
            new_ratio = max(self.config.min_rate_ratio,
                            state.throttle_ratio
                            * self.config.throttle_factor)
            if new_ratio >= state.throttle_ratio:
                return False
            entered = state.throttle_ratio >= 1.0
            state.throttle_ratio = new_ratio
            state.bucket.set_rate(state.cfg.tokens_per_s * new_ratio)
            state.throttles += 1
        self._export_ratio(cls_name, new_ratio)
        if entered:
            self._journal().emit(
                "qos", "throttle", severity="WARNING",
                qos_class=cls_name, reason=reason,
                ratio=round(new_ratio, 4),
                rate=round(state.cfg.tokens_per_s * new_ratio, 3))
        return True

    def restore(self, cls_name: str) -> bool:
        """Walk one class's bucket back up one step (inverse of
        :meth:`throttle`); the throttled→restored edge (ratio back at
        1.0) journals as ``qos.restore``."""
        state = self._classes.get(cls_name)
        if state is None or state.bucket is None:
            return False
        with self._lock:
            if state.throttle_ratio >= 1.0:
                return False
            new_ratio = min(1.0, state.throttle_ratio
                            / self.config.throttle_factor)
            state.throttle_ratio = new_ratio
            state.bucket.set_rate(state.cfg.tokens_per_s * new_ratio)
            restored = new_ratio >= 1.0
        self._export_ratio(cls_name, new_ratio)
        if restored:
            self._journal().emit(
                "qos", "restore", qos_class=cls_name,
                rate=round(state.cfg.tokens_per_s, 3))
        return True

    def _export_ratio(self, cls_name: str, ratio: float) -> None:
        if self._metrics is not None:
            self._metrics.qos_throttle_ratio.set(ratio, qos_class=cls_name)

    def throttled_classes(self) -> list[str]:
        with self._lock:
            return [n for n, s in self._classes.items()
                    if s.throttle_ratio < 1.0]

    def start_governor(self, slo, costs,
                       interval_s: float | None = None) -> None:
        """Close the feedback loop: while ``slo.fast_burn()`` reports
        burning models, tighten the non-protected class with the
        highest cost-ledger occupancy growth (device + host seconds per
        tick, tenants mapped through :meth:`classify`); once the alarm
        stays clear for ``restore_hold_s``, walk rates back up."""
        if not self.enabled or self._governor is not None:
            return
        if not any(s.bucket is not None and not s.cfg.protect
                   for s in self._classes.values()):
            return  # nothing the governor could actuate
        interval = interval_s or self.config.governor_interval_s
        self._governor_stop.clear()

        def _loop():
            while not self._governor_stop.wait(interval):
                try:
                    self.governor_tick(slo, costs)
                except Exception:  # noqa: BLE001 — the governor is advisory:
                    pass           # a bad tick must not end its thread

        self._governor = threading.Thread(
            target=_loop, name="qos-governor", daemon=True)
        self._governor.start()

    def stop_governor(self) -> None:
        self._governor_stop.set()
        t = self._governor
        if t is not None:
            t.join(timeout=2.0)
        self._governor = None

    def governor_tick(self, slo, costs) -> str | None:
        """One feedback step (exposed for fake-clock tests). Returns the
        class throttled/restored this tick, if any."""
        burning = slo.fast_burn() if slo is not None else []
        now = self._clock()
        if burning:
            self._last_burn_ts = now
            victim = self._pick_victim(costs)
            if victim is not None and self.throttle(victim):
                return victim
            return None
        if self._last_burn_ts and \
                now - self._last_burn_ts >= self.config.restore_hold_s:
            for name in self.throttled_classes():
                if self.restore(name):
                    return name
        return None

    def _pick_victim(self, costs) -> str | None:
        """The non-protected, bucket-carrying class with the largest
        occupancy growth (device + host seconds) since the last tick."""
        occupancy: dict[str, float] = {}
        if costs is not None:
            try:
                snap = costs.snapshot()
            except Exception:  # noqa: BLE001 — occupancy is only a hint
                snap = {}
            for tenant, entry in (snap.get("tenants") or {}).items():
                cname = self.classify(tenant)
                occupancy[cname] = occupancy.get(cname, 0.0) + \
                    float(entry.get("device_s", 0.0)) + \
                    float(entry.get("host_s", 0.0)) + \
                    float(entry.get("padding_s", 0.0))
        deltas = {n: occupancy.get(n, 0.0) - self._last_occupancy.get(n, 0.0)
                  for n in self._classes}
        self._last_occupancy = occupancy
        candidates = [
            (deltas.get(n, 0.0), occupancy.get(n, 0.0), n)
            for n, s in self._classes.items()
            if s.bucket is not None and not s.cfg.protect
        ]
        if not candidates:
            return None
        # Highest growth wins; cumulative occupancy then name break ties
        # (a flat tick still needs a deterministic victim).
        candidates.sort(reverse=True)
        return candidates[0][2]

    # -- report ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """The controller half of ``GET /v2/qos`` (the engine layers
        per-model class queue depths on top)."""
        classes = {}
        with self._lock:
            for name, s in self._classes.items():
                cfg = s.cfg
                classes[name] = {
                    "weight": cfg.weight,
                    "priority_level": cfg.priority_level,
                    "min_priority": cfg.min_priority,
                    "preempt": cfg.preempt,
                    "protect": cfg.protect,
                    "tokens_per_s": cfg.tokens_per_s,
                    "burst": cfg.burst or cfg.tokens_per_s,
                    "throttle_ratio": round(s.throttle_ratio, 4),
                    "effective_rate": round(
                        cfg.tokens_per_s * s.throttle_ratio, 3),
                    "max_inflight": cfg.max_inflight,
                    "max_queue_depth": cfg.max_queue_depth,
                    "inflight": s.inflight,
                    "sheds": s.sheds,
                    "preemptions": s.preemptions,
                    "throttles": s.throttles,
                    "tenants": sorted(
                        t for t, c in self.config.tenants.items()
                        if c == name),
                }
        return {
            "enabled": self.enabled,
            "default_class": self.config.default_class,
            "governor": {
                "running": self._governor is not None,
                "throttle_factor": self.config.throttle_factor,
                "min_rate_ratio": self.config.min_rate_ratio,
                "restore_hold_s": self.config.restore_hold_s,
                "throttled": self.throttled_classes(),
            },
            "classes": classes,
        }

    def _journal(self):
        from client_tpu_torch.observability.events import journal

        return journal()
