"""Self-drive governor: the engine's closed loops.

The port's copy of ``client_tpu/engine/selfdrive.py``. Every sensor it
reads exists already (the efficiency profiler's duty cycle and fill, the
admission controller's queue and service-time load, the SLO tracker's
fast burn); ``CLIENT_TPU_SELFDRIVE`` wires them to actuators, with
hysteresis and flap damping on every loop:

- **dispatch retune** (:class:`client_tpu_torch.engine.autotune.
  DispatchTuner`): fill, duty and queue wait drive the dispatch
  deadline, a per-model batch cap and nudges of the admission
  concurrency cap;
- **SLO-burn admission tightening**: a model in fast burn has its
  admitted rate cut step by step (:meth:`AdmissionController.
  tighten_model`), restored step by step on quiet windows; journal edges
  ``admission.tighten`` / ``admission.restore``.

The router's drift re-placement loop
(:class:`client_tpu_torch.router.selfdrive.FleetRebalancer`) reads its
five keys from the same config, so every loop's damping reads from one
grammar.

Unset, there is no governor thread and no state. ``tick()`` is public
and the clock injectable: every loop's hysteresis is provable on a fake
clock without a thread or a sleep.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, fields

from client_tpu_torch.config import env_text
from client_tpu_torch.engine.autotune import DispatchTuner
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.observability.events import journal

_log = logging.getLogger("client_tpu_torch")

ENV_VAR = "CLIENT_TPU_SELFDRIVE"

__all__ = ["ENV_VAR", "SelfDriveConfig", "SelfDriveGovernor"]


@dataclass
class SelfDriveConfig:
    """``CLIENT_TPU_SELFDRIVE`` knobs, all optional. One config feeds the
    engine governor (dispatch and admission loops) and the router's
    rebalancer (placement loop)."""

    interval_s: float = 2.0           # governor wake period
    # -- dispatch retune loop (DispatchTuner) --
    fill_low: float = 0.5             # tighten below this batch fill
    wait_high_s: float = 0.5          # backlog threshold (est. queue wait)
    duty_high: float = 0.85           # device-bound threshold
    min_deadline_us: int = 100        # dispatch-deadline floor
    deadline_factor: float = 0.5      # per-step deadline cut
    min_calls: int = 8                # executions before fill is trusted
    cooldown_s: float = 30.0          # per-(model,action) spacing
    restore_hold_s: float = 30.0      # quiet window per restore step
    concurrency_floor: int = 2        # never nudge the cap below this
    # -- SLO-burn admission tightening --
    burn_factor: float = 0.5          # per-step rate-ratio cut
    burn_min_ratio: float = 0.1       # tightening floor
    burn_restore_step: float = 2.0    # per-quiet-window ratio regrowth
    burn_restore_hold_s: float = 10.0  # quiet window before a restore step
    burn_cooldown_s: float = 10.0     # spacing between cuts per model
    # -- drift re-placement loop (router/selfdrive.py) --
    rebalance_cooldown_s: float = 60.0   # spacing between rebalances
    max_moves_per_window: int = 4        # placement-move budget ...
    rebalance_window_s: float = 300.0    # ... per this window
    quiesce_wait_s: float = 5.0          # rolling-unload in-flight wait
    drain_after_moves: bool = False      # rolling-drain emptied replicas

    @classmethod
    def from_dict(cls, data: dict) -> "SelfDriveConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise EngineError(
                f"{ENV_VAR}: unknown key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}", 400)
        cfg = cls()
        for f in fields(cls):
            if f.name not in data:
                continue
            raw = data[f.name]
            try:
                if f.name == "drain_after_moves":
                    setattr(cfg, f.name, bool(raw))
                elif f.name in ("min_deadline_us", "min_calls",
                                "concurrency_floor", "max_moves_per_window"):
                    setattr(cfg, f.name, int(raw))
                else:
                    setattr(cfg, f.name, float(raw))
            except (TypeError, ValueError):
                raise EngineError(
                    f"{ENV_VAR}: key '{f.name}' expects a number, "
                    f"got {raw!r}", 400) from None
        if cfg.interval_s <= 0:
            raise EngineError(f"{ENV_VAR}: interval_s must be > 0", 400)
        if not 0 < cfg.burn_min_ratio <= 1:
            raise EngineError(
                f"{ENV_VAR}: burn_min_ratio must be in (0, 1]", 400)
        return cfg

    @classmethod
    def from_env(cls, env_var: str = ENV_VAR) -> "SelfDriveConfig | None":
        """None when unset/disabled; ``1``/``true``/``on`` → defaults;
        otherwise inline JSON or ``@/path/to/file.json``."""
        raw = env_text(env_var)
        if not raw or raw.lower() in ("0", "false", "off"):
            return None
        if raw.lower() in ("1", "true", "on"):
            return cls()
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as f:
                    raw = f.read()
            except OSError as exc:
                raise EngineError(
                    f"{env_var}: cannot read '{raw[1:]}': {exc}", 400) \
                    from None
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise EngineError(
                f"{env_var}: invalid JSON ({exc})", 400) from None
        if not isinstance(data, dict):
            raise EngineError(f"{env_var}: expected a JSON object", 400)
        return cls.from_dict(data)

    def summary(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class SelfDriveGovernor:
    """One per engine: a daemon thread that ticks the dispatch tuner and
    the SLO-burn admission loop every ``interval_s``. Tests call
    :meth:`tick` directly with a fake clock."""

    def __init__(self, engine, config: SelfDriveConfig,
                 clock=time.monotonic):
        self.engine = engine
        self.config = config
        self._clock = clock
        self.tuner = DispatchTuner(
            engine, fill_low=config.fill_low,
            wait_high_s=config.wait_high_s, duty_high=config.duty_high,
            min_deadline_us=config.min_deadline_us,
            deadline_factor=config.deadline_factor,
            min_calls=config.min_calls, cooldown_s=config.cooldown_s,
            restore_hold_s=config.restore_hold_s,
            concurrency_floor=config.concurrency_floor, clock=clock)
        # model -> last tighten/restore stamp (the quiet-window clock)
        # and -> next-allowed-cut deadline (the per-model cooldown).
        self._last_touch: dict[str, float] = {}
        self._cut_cooldown: dict[str, float] = {}
        self.burn_action_count = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="selfdrive", daemon=True)
        self._thread.start()
        self._journal("enabled", interval_s=self.config.interval_s)

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the governor must never
                _log.exception("selfdrive: tick failed")  # end serving

    def _journal(self, name: str, severity: str = "INFO",
                 **detail) -> None:
        journal().emit("selfdrive", name, severity=severity, **detail)

    # -- one governor pass -----------------------------------------------------

    def tick(self) -> dict:
        """Run both engine-side loops once; returns what they decided
        (``{"dispatch": [...], "admission": [...]}``)."""
        out = {"dispatch": self.tuner.tick(), "admission": []}
        out["admission"] = self._burn_pass()
        return out

    def _burn_pass(self) -> list[dict]:
        """SLO fast-burn -> progressive admission tightening; stepwise
        restore after ``burn_restore_hold_s`` of quiet. Per-model
        cooldowns space repeated cuts; the tighten/restore journal edges
        come from the admission controller itself."""
        slo = getattr(self.engine, "slo", None)
        if slo is None or not getattr(slo, "enabled", False):
            return []
        adm = self.engine.admission
        cfg = self.config
        now = self._clock()
        out: list[dict] = []
        burning = set(slo.fast_burn())
        for model in sorted(burning):
            self._last_touch[model] = now
            if now < self._cut_cooldown.get(model, 0.0):
                continue
            if adm.tighten_model(model, factor=cfg.burn_factor,
                                 min_ratio=cfg.burn_min_ratio):
                self._cut_cooldown[model] = now + cfg.burn_cooldown_s
                self.burn_action_count += 1
                out.append({"action": "tighten", "model": model,
                            "ratio": adm.tightened_models().get(model)})
        for model in sorted(adm.tightened_models()):
            if model in burning:
                continue
            if now - self._last_touch.get(model, 0.0) \
                    < cfg.burn_restore_hold_s:
                continue
            if adm.restore_model(model, step=cfg.burn_restore_step):
                self._last_touch[model] = now
                self.burn_action_count += 1
                out.append({"action": "restore", "model": model,
                            "ratio": adm.tightened_models().get(
                                model, 1.0)})
        return out

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``selfdrive`` section of ``/v2/profile``: loop config,
        dispatch-tuner state, and the admission loop's current
        tightenings."""
        return {
            "enabled": True,
            "config": self.config.summary(),
            "dispatch": self.tuner.snapshot(),
            "admission": {
                "tightened": self.engine.admission.tightened_models(),
                "action_count": self.burn_action_count,
            },
        }
