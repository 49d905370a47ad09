"""Per-model sliding-window SLO tracking with multi-window burn rates.

The port's copy of ``client_tpu/observability/slo.py``: the engine
scores itself against configured objectives and shows the result live
(``GET /v2/slo``, the ``SloStatus`` RPC, ``tpu_slo_*`` gauges, and
DEGRADED on ``/v2/health/ready`` under fast burn).

Two objectives per model:

* **availability** — the fraction of requests that must succeed (errors
  are scheduler-level failures: injected 5xx, execution errors, deadline
  expiry). Admission sheds (429) are load management, not SLO
  violations, and do not count.
* **latency** — the fraction of *successful* requests that must finish
  under ``latency_threshold_us`` (0 disables it).

Burn rate follows the SRE workbook: the rate the error budget is spent,
normalised so that 1.0 is exactly on budget, ``bad_fraction / (1 -
target)``. Fast burn needs BOTH the short (5 m) and long (1 h) windows at
or over ``fast_burn_threshold`` (default 14.4), so a blip cannot flip
health but a sustained failure does within minutes.

``CLIENT_TPU_SLO`` holds inline JSON or ``@/path/to/slo.json``::

    CLIENT_TPU_SLO='{"availability": 0.999,
        "latency_threshold_us": 50000, "latency_target": 0.99,
        "models": {"bert_base": {"availability": 0.99}}}'

Unset, tracking is off: recording does nothing and health is unaffected.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

from client_tpu_torch.config import env_text
from client_tpu_torch.utils import lockdep

__all__ = [
    "ENV_VAR",
    "WINDOWS",
    "SloConfig",
    "SloTracker",
]

ENV_VAR = "CLIENT_TPU_SLO"

# Multi-window pair from the SRE workbook's fast-burn alert: the long
# window proves the burn is sustained, the short window makes the alert
# reset quickly once the problem stops.
WINDOWS = (("5m", 300), ("1h", 3600))
_LONG_WINDOW_S = max(s for _, s in WINDOWS)


@dataclass
class SloConfig:
    """Objectives; per-model overrides under ``models``."""

    # Target success fraction in (0, 1).
    availability: float = 0.999
    # Latency objective: `latency_target` of successful requests must
    # complete under this many microseconds; 0 disables the objective.
    latency_threshold_us: float = 0.0
    latency_target: float = 0.99
    # Both windows must burn at/above this to flip health to DEGRADED.
    fast_burn_threshold: float = 14.4
    models: dict[str, dict] = field(default_factory=dict)
    # False when CLIENT_TPU_SLO is unset: record() is a no-op and
    # fast_burn() never fires.
    enabled: bool = True

    _FIELDS = ("availability", "latency_threshold_us", "latency_target",
               "fast_burn_threshold")

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError("availability target must be in (0, 1)")
        if not 0.0 < self.latency_target < 1.0:
            raise ValueError("latency_target must be in (0, 1)")
        if self.latency_threshold_us < 0:
            raise ValueError("latency_threshold_us must be >= 0")
        if self.fast_burn_threshold <= 0:
            raise ValueError("fast_burn_threshold must be > 0")

    @classmethod
    def from_dict(cls, d: dict) -> "SloConfig":
        d = dict(d or {})
        models = d.pop("models", {}) or {}
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            raise ValueError(f"unknown SLO config keys: {sorted(unknown)}")
        for name, override in models.items():
            bad = set(override) - set(cls._FIELDS)
            if bad:
                raise ValueError(
                    f"unknown SLO config keys for model '{name}': "
                    f"{sorted(bad)}")
        return cls(models=models, **d)

    @classmethod
    def from_env(cls, environ=os.environ) -> "SloConfig":
        raw = env_text(ENV_VAR, environ)
        if not raw:
            return cls(enabled=False)
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        return cls.from_dict(json.loads(raw))

    def for_model(self, name: str) -> "SloConfig":
        override = self.models.get(name)
        if not override:
            return self
        merged = {f: getattr(self, f) for f in self._FIELDS}
        merged.update(override)
        return SloConfig(enabled=self.enabled, **merged)


class _SecondRing:
    """Per-second (total, errors, slow) counters over the last hour.
    Fixed array indexed by ``second % size``; a slot whose stored second
    is stale is reset on write and skipped on read — O(1) record, O(size)
    window sum with plain ints."""

    __slots__ = ("size", "seconds", "total", "errors", "slow")

    def __init__(self, size: int = _LONG_WINDOW_S + 1):
        self.size = size
        self.seconds = [-1] * size
        self.total = [0] * size
        self.errors = [0] * size
        self.slow = [0] * size

    def record(self, sec: int, error: bool, slow: bool) -> None:
        i = sec % self.size
        if self.seconds[i] != sec:
            self.seconds[i] = sec
            self.total[i] = 0
            self.errors[i] = 0
            self.slow[i] = 0
        self.total[i] += 1
        if error:
            self.errors[i] += 1
        if slow:
            self.slow[i] += 1

    def window(self, now_sec: int, window_s: int) -> tuple[int, int, int]:
        lo = now_sec - window_s
        total = errors = slow = 0
        for i in range(self.size):
            s = self.seconds[i]
            if lo < s <= now_sec:
                total += self.total[i]
                errors += self.errors[i]
                slow += self.slow[i]
        return total, errors, slow


class _ModelSlo:
    __slots__ = ("cfg", "ring", "lock")

    def __init__(self, cfg: SloConfig):
        self.cfg = cfg
        self.ring = _SecondRing()
        self.lock = lockdep.Lock("observability.slo.model")


def _burn(bad: int, total: int, target: float) -> float:
    if total <= 0:
        return 0.0
    return (bad / total) / (1.0 - target)


class SloTracker:
    """Records request outcomes per model and scores the two windows.

    The engine calls :meth:`record` from the stats funnel (one call per
    finally-responded request), the health check calls :meth:`fast_burn`,
    and both ``GET /v2/slo`` and the metrics render call
    :meth:`snapshot` (which also refreshes the ``tpu_slo_*`` gauges).
    """

    def __init__(self, config: SloConfig | None = None, registry=None,
                 clock=time.monotonic):
        self.config = config or SloConfig(enabled=False)
        self._clock = clock
        self._lock = lockdep.Lock("observability.slo")
        self._models: dict[str, _ModelSlo] = {}
        self._burn_gauge = None
        self._fast_gauge = None
        self._target_gauge = None
        if registry is not None:
            self.bind_metrics(registry)

    @classmethod
    def from_env(cls, registry=None, environ=os.environ) -> "SloTracker":
        return cls(SloConfig.from_env(environ), registry=registry)

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def bind_metrics(self, registry) -> None:
        self._burn_gauge = registry.gauge(
            "tpu_slo_burn_rate",
            "SLO error-budget burn rate per model, objective "
            "(availability|latency) and window (1.0 = exactly on budget)",
            ("model", "objective", "window"))
        self._fast_gauge = registry.gauge(
            "tpu_slo_fast_burn",
            "1 while the model burns budget above fast_burn_threshold in "
            "BOTH windows (health reports DEGRADED)",
            ("model",))
        self._target_gauge = registry.gauge(
            "tpu_slo_objective_target",
            "Configured SLO target per model and objective",
            ("model", "objective"))

    # -- write path ----------------------------------------------------------

    def _model(self, name: str) -> _ModelSlo:
        m = self._models.get(name)
        if m is None:
            with self._lock:
                m = self._models.setdefault(
                    name, _ModelSlo(self.config.for_model(name)))
        return m

    def record(self, model: str, success: bool,
               duration_us: float | None = None) -> None:
        """One finally-responded request. ``duration_us`` feeds the
        latency objective (successes only; failures already count against
        availability)."""
        if not self.config.enabled:
            return
        m = self._model(model)
        slow = bool(
            success and m.cfg.latency_threshold_us > 0
            and duration_us is not None
            and duration_us > m.cfg.latency_threshold_us)
        sec = int(self._clock())
        with m.lock:
            m.ring.record(sec, error=not success, slow=slow)

    # -- read path -----------------------------------------------------------

    def _model_report(self, name: str, m: _ModelSlo, now_sec: int) -> dict:
        cfg = m.cfg
        windows = {}
        fast = {"availability": True,
                "latency": cfg.latency_threshold_us > 0}
        with m.lock:
            counts = {label: m.ring.window(now_sec, secs)
                      for label, secs in WINDOWS}
        for label, (total, errors, slow) in counts.items():
            avail_burn = _burn(errors, total, cfg.availability)
            lat_burn = (_burn(slow, total, cfg.latency_target)
                        if cfg.latency_threshold_us > 0 else 0.0)
            if avail_burn < cfg.fast_burn_threshold:
                fast["availability"] = False
            if lat_burn < cfg.fast_burn_threshold:
                fast["latency"] = False
            windows[label] = {
                "requests": total,
                "errors": errors,
                "slow": slow,
                "availability_burn_rate": round(avail_burn, 4),
                "latency_burn_rate": round(lat_burn, 4),
            }
        fast_burn = fast["availability"] or fast["latency"]
        return {
            "objectives": {
                "availability": cfg.availability,
                "latency_threshold_us": cfg.latency_threshold_us,
                "latency_target": cfg.latency_target,
                "fast_burn_threshold": cfg.fast_burn_threshold,
            },
            "windows": windows,
            "fast_burn": fast_burn,
        }

    def snapshot(self) -> dict:
        """The ``GET /v2/slo`` response; refreshes the gauges as a side
        effect so a scrape after a quiet period still reads current
        burn rates."""
        now_sec = int(self._clock())
        with self._lock:
            models = sorted(self._models.items())
        out_models = {}
        for name, m in models:
            report = self._model_report(name, m, now_sec)
            out_models[name] = report
            self._update_gauges(name, m, report)
        return {
            "enabled": self.config.enabled,
            "windows": {label: secs for label, secs in WINDOWS},
            "models": out_models,
        }

    def _update_gauges(self, name: str, m: _ModelSlo, report: dict) -> None:
        if self._burn_gauge is None:
            return
        for label, w in report["windows"].items():
            self._burn_gauge.set(w["availability_burn_rate"], model=name,
                                 objective="availability", window=label)
            if m.cfg.latency_threshold_us > 0:
                self._burn_gauge.set(w["latency_burn_rate"], model=name,
                                     objective="latency", window=label)
        self._fast_gauge.set(1 if report["fast_burn"] else 0, model=name)
        self._target_gauge.set(m.cfg.availability, model=name,
                               objective="availability")
        if m.cfg.latency_threshold_us > 0:
            self._target_gauge.set(m.cfg.latency_target, model=name,
                                   objective="latency")

    def fast_burn(self) -> list[str]:
        """Models currently fast-burning (both windows over threshold);
        empty when tracking is disabled or everything is on budget."""
        if not self.config.enabled:
            return []
        now_sec = int(self._clock())
        with self._lock:
            models = sorted(self._models.items())
        return [name for name, m in models
                if self._model_report(name, m, now_sec)["fast_burn"]]
