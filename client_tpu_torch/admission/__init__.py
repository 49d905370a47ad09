"""Server-side admission control: load shedding, throttling, pushback.

The port's copy of ``client_tpu/admission/__init__.py``. Under sustained
overload an unprotected queue grows until every request times out; the
remedy is to shed early and tell the client when to come back:

* **Load shedder** — reject when the scheduler queue is at
  ``max_queue_depth``, or when the *estimated wait* (queue depth x EWMA
  service time / instances) exceeds ``max_estimated_wait_s``.
* **Per-model token buckets** — ``tokens_per_s`` + ``burst`` rate caps
  and a ``max_inflight`` concurrency cap, so one model cannot starve the
  rest of the repository.
* **Retry-After pushback** — every rejection is an
  :class:`AdmissionError` (HTTP 429 / gRPC RESOURCE_EXHAUSTED) carrying
  ``retry_after_s``, clipped to [0.01, 30] s: the frontends send it as a
  ``Retry-After`` header / ``retry-after`` and ``retry-pushback-ms``
  trailers, and the clients' ``RetryPolicy`` waits that long.
* **Shadow admission class** — requests whose ``priority`` is at or above
  ``shadow_priority`` (higher number = less urgent) are *shadow* traffic
  with stricter gates (``shadow_max_inflight``,
  ``shadow_max_queue_depth``) checked first, so it sheds before live
  traffic does.
* **DEGRADED health** — for ``degraded_hold_s`` after a shed,
  ``TorchEngine.health_state()`` reports DEGRADED.

Configuration is programmatic (``AdmissionController(AdmissionConfig(...))``)
or the ``CLIENT_TPU_ADMISSION`` environment variable holding JSON::

    CLIENT_TPU_ADMISSION='{"max_queue_depth": 256,
        "max_estimated_wait_s": 2.0,
        "models": {"bert_base": {"tokens_per_s": 100, "burst": 20,
                                 "max_inflight": 64}}}'

Every limit defaults to off (0), so an unconfigured engine admits
everything; the controller then only counts requests in flight for the
drain (:mod:`client_tpu_torch.admission.drain`). Rejections are counted
on ``tpu_admission_rejections_total{model,version,reason,tenant}``, on
the cost ledger and in the event journal. A QoS controller
(:mod:`client_tpu_torch.admission.qos`, ``attach_qos``) adds per-class
gates ahead of the shared ones; self-drive tightens a model's rate
(``tighten_model``) and its concurrency cap (``set_concurrency_cap``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

from client_tpu_torch.config import env_text
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.utils import lockdep

__all__ = [
    "ENV_VAR",
    "AdmissionConfig",
    "AdmissionError",
    "AdmissionController",
    "TokenBucket",
]

ENV_VAR = "CLIENT_TPU_ADMISSION"

# Pushback floor: never tell a client to come back in less than this
# (a 0-second Retry-After degenerates into a tight retry loop).
MIN_RETRY_AFTER_S = 0.01
# Pushback ceiling: under pathological estimates, cap the advertised wait
# so clients re-probe within a bounded window.
MAX_RETRY_AFTER_S = 30.0

# EWMA smoothing for the per-model service-time estimate: ~86% of the
# weight within the last 12 observations — reactive enough to follow a
# load shift, smooth enough to ignore one slow compile.
_EWMA_ALPHA = 0.15


class AdmissionError(EngineError):
    """A request shed at admission. ``retry_after_s`` is the server's
    pushback: how long the client should wait before retrying (surfaced
    as the HTTP ``Retry-After`` header / gRPC retry-pushback trailing
    metadata). ``reason`` matches the metric label."""

    def __init__(self, message: str, retry_after_s: float,
                 reason: str = "shed", status: int = 429):
        super().__init__(message, status)
        self.retry_after_s = max(MIN_RETRY_AFTER_S,
                                 min(float(retry_after_s), MAX_RETRY_AFTER_S))
        self.reason = reason


def _clip_retry_after(s: float) -> float:
    return max(MIN_RETRY_AFTER_S, min(float(s), MAX_RETRY_AFTER_S))


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``
    capacity. ``try_acquire`` never blocks; a failed acquire pairs with
    :meth:`retry_after_s` — the refill time until the request would fit —
    which becomes the rejection's pushback."""

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError("TokenBucket rate must be > 0")
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._stamp = clock()
        self._lock = lockdep.Lock("admission.bucket")

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._stamp) * self.rate)
        self._stamp = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after_s(self, n: float = 1.0) -> float:
        with self._lock:
            self._refill_locked()
            deficit = n - self._tokens
        if deficit <= 0:
            return MIN_RETRY_AFTER_S
        return deficit / self.rate

    def available(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def set_rate(self, rate: float) -> None:
        """Retarget the refill rate (the tightening actuator). Tokens
        accrued at the old rate are banked first, so a rate cut
        never claws back credit already earned."""
        with self._lock:
            self._refill_locked()
            self.rate = max(1e-9, float(rate))


@dataclass
class AdmissionConfig:
    """Per-model (or default) admission limits; 0 disables each check."""

    # Shed when the model's scheduler queue is at/over this depth.
    max_queue_depth: int = 0
    # Shed when queue_depth x EWMA service time / instances exceeds this.
    max_estimated_wait_s: float = 0.0
    # Token-bucket rate cap (requests/s); burst defaults to the rate.
    tokens_per_s: float = 0.0
    burst: float = 0.0
    # Concurrency cap: requests admitted but not yet finally responded.
    max_inflight: int = 0
    # How long after the last shed the engine stays DEGRADED.
    degraded_hold_s: float = 5.0
    # Shadow class: requests with priority >= shadow_priority (0 = no
    # shadow class) pass these stricter gates before the shared ones.
    shadow_priority: int = 0
    shadow_max_inflight: int = 0
    shadow_max_queue_depth: int = 0
    # Per-model overrides, keyed by model name (dicts of the fields above).
    models: dict[str, dict] = field(default_factory=dict)

    _FIELDS = ("max_queue_depth", "max_estimated_wait_s", "tokens_per_s",
               "burst", "max_inflight", "degraded_hold_s",
               "shadow_priority", "shadow_max_inflight",
               "shadow_max_queue_depth")

    @classmethod
    def from_dict(cls, d: dict) -> "AdmissionConfig":
        d = dict(d or {})
        models = d.pop("models", {}) or {}
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            raise ValueError(
                f"unknown admission config keys: {sorted(unknown)}")
        for name, override in models.items():
            bad = set(override) - set(cls._FIELDS)
            if bad:
                raise ValueError(
                    f"unknown admission config keys for model "
                    f"'{name}': {sorted(bad)}")
        return cls(models=models, **d)

    @classmethod
    def from_env(cls, environ=os.environ) -> "AdmissionConfig":
        raw = env_text(ENV_VAR, environ)
        if not raw:
            return cls()
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        return cls.from_dict(json.loads(raw))

    def for_model(self, name: str) -> "AdmissionConfig":
        """Effective limits for one model: defaults + per-model override."""
        override = self.models.get(name)
        if not override:
            return self
        merged = {f: getattr(self, f) for f in self._FIELDS}
        merged.update(override)
        return AdmissionConfig(**merged)


class _ModelGate:
    """Per-model admission state: bucket, in-flight count, service EWMA."""

    __slots__ = ("cfg", "bucket", "inflight", "shadow_inflight",
                 "ewma_service_s", "rate_ratio", "dyn_bucket",
                 "dyn_base_rate", "dyn_max_inflight")

    def __init__(self, cfg: AdmissionConfig, clock=time.monotonic):
        self.cfg = cfg
        self.bucket = None
        if cfg.tokens_per_s > 0:
            self.bucket = TokenBucket(
                cfg.tokens_per_s, cfg.burst or cfg.tokens_per_s, clock=clock)
        self.inflight = 0
        self.shadow_inflight = 0
        self.ewma_service_s = 0.0
        # Self-drive's actuators (tighten_model / set_concurrency_cap):
        # the fraction of the configured rate admitted now, a synthesized
        # bucket for a model with no configured rate cap, and a dynamic
        # concurrency cap (0 = none). All only ever *tighten* relative to
        # cfg.
        self.rate_ratio = 1.0
        self.dyn_bucket = None
        self.dyn_base_rate = 0.0
        self.dyn_max_inflight = 0


class AdmissionController:
    """Admission decisions + in-flight accounting for one engine.

    The engine calls :meth:`admit` before every scheduler submit and the
    start/end hooks around each request's lifetime; the drain coordinator
    reads :meth:`total_inflight` to know when the server is empty.
    Thread-safe; the hot path is one lock acquisition.
    """

    def __init__(self, config: AdmissionConfig | None = None,
                 metrics=None, clock=time.monotonic):
        self.config = config or AdmissionConfig()
        self._metrics = metrics  # EngineMetrics | None
        self._clock = clock
        self._lock = lockdep.Lock("admission.controller")
        self._gates: dict[str, _ModelGate] = {}
        # The QoS controller (admission/qos.py), when one is attached:
        # its per-class gates run ahead of the shared ones.
        self.qos = None
        self._last_shed = 0.0
        # True between the first shed and the hold-window expiry observed
        # by degraded(); drives degraded_enter/degraded_exit events.
        self._degraded_state = False
        self.rejection_count = 0

    @classmethod
    def from_env(cls, metrics=None, environ=os.environ
                 ) -> "AdmissionController":
        return cls(AdmissionConfig.from_env(environ), metrics=metrics)

    def _gate(self, model: str) -> _ModelGate:
        gate = self._gates.get(model)
        if gate is None:
            with self._lock:
                gate = self._gates.setdefault(
                    model, _ModelGate(self.config.for_model(model),
                                      self._clock))
        return gate

    # -- the admission decision ---------------------------------------------

    def is_shadow(self, model: str, priority: int = 0) -> bool:
        """True when ``priority`` puts the request in the model's shadow
        class (``shadow_priority`` configured and priority at/above it)."""
        cfg = self._gate(model).cfg
        return cfg.shadow_priority > 0 and priority >= cfg.shadow_priority

    def attach_qos(self, qos) -> None:
        """Bind a :class:`~client_tpu_torch.admission.qos.QosController`
        (an enabled one; else detach): its per-class gates run first in
        :meth:`admit`, and its sheds count on the same rejection counter,
        journal and ledger as the shared ones."""
        self.qos = qos if qos is not None and \
            getattr(qos, "enabled", False) else None

    def admit(self, model: str, version: str = "",
              queue_depth: int = 0, instances: int = 1,
              trace_id: str | None = None, priority: int = 0,
              tenant: str = "", qos_class: str = "",
              class_queue_depth: int = 0) -> None:
        """Admit or shed one request; raises :class:`AdmissionError` on
        shed. ``queue_depth`` is the model's current scheduler backlog and
        ``instances`` its worker count (for the estimated-wait check).
        ``trace_id`` correlates a shed with the rejected request's trace
        in the event journal. ``priority`` selects the admission class:
        at/above ``shadow_priority`` the stricter shadow gates apply
        first, so shadow traffic sheds before it can queue behind live.
        ``tenant`` attributes a shed on the metrics/ledger side. With a
        QoS controller attached, ``qos_class`` and ``class_queue_depth``
        drive the per-class gates (quota, class in-flight and queue caps),
        whose pushback is the class bucket's refill time."""
        gate = self._gate(model)
        cfg = gate.cfg
        if self.qos is not None and qos_class:
            try:
                self.qos.admit(model, qos_class,
                               class_queue_depth=class_queue_depth)
            except AdmissionError as exc:
                self._count_shed(model, version, exc.reason,
                                 retry_after_s=exc.retry_after_s,
                                 trace_id=trace_id, tenant=tenant)
                raise
        if cfg.shadow_priority > 0 and priority >= cfg.shadow_priority:
            if cfg.shadow_max_inflight > 0 \
                    and gate.shadow_inflight >= cfg.shadow_max_inflight:
                self._reject(model, version, "shadow", AdmissionError(
                    f"model '{model}' shadow class is at its concurrency "
                    f"cap ({gate.shadow_inflight}/"
                    f"{cfg.shadow_max_inflight} in flight)",
                    retry_after_s=gate.ewma_service_s or MIN_RETRY_AFTER_S,
                    reason="shadow"), trace_id=trace_id, tenant=tenant)
            if cfg.shadow_max_queue_depth > 0 \
                    and queue_depth >= cfg.shadow_max_queue_depth:
                est = self._estimated_wait_s(gate, queue_depth, instances)
                self._reject(model, version, "shadow", AdmissionError(
                    f"model '{model}' queue depth {queue_depth} is at "
                    f"the shadow shed limit "
                    f"({cfg.shadow_max_queue_depth})",
                    retry_after_s=est, reason="shadow"),
                    trace_id=trace_id, tenant=tenant)
        # The configured cap, tightened (never relaxed) by self-drive's
        # dynamic one.
        inflight_cap = cfg.max_inflight
        if gate.dyn_max_inflight > 0:
            inflight_cap = min(inflight_cap, gate.dyn_max_inflight) \
                if inflight_cap > 0 else gate.dyn_max_inflight
        if inflight_cap > 0 and gate.inflight >= inflight_cap:
            # Pushback ~ one service interval: a slot frees when the
            # oldest in-flight request completes.
            self._reject(model, version, "concurrency", AdmissionError(
                f"model '{model}' is at its concurrency cap "
                f"({gate.inflight}/{inflight_cap} in flight)",
                retry_after_s=gate.ewma_service_s or MIN_RETRY_AFTER_S,
                reason="concurrency"), trace_id=trace_id, tenant=tenant)
        if gate.bucket is not None and not gate.bucket.try_acquire():
            self._reject(model, version, "throttled", AdmissionError(
                f"model '{model}' request rate exceeds "
                f"{cfg.tokens_per_s:g}/s (burst {gate.bucket.burst:g})",
                retry_after_s=gate.bucket.retry_after_s(),
                reason="throttled"), trace_id=trace_id, tenant=tenant)
        if gate.dyn_bucket is not None \
                and not gate.dyn_bucket.try_acquire():
            # A model with no configured rate cap, tightened under SLO
            # burn: shed on the synthesized bucket.
            self._reject(model, version, "tightened", AdmissionError(
                f"model '{model}' admission tightened to "
                f"{gate.rate_ratio:g}x of observed capacity under SLO "
                "burn", retry_after_s=gate.dyn_bucket.retry_after_s(),
                reason="tightened"), trace_id=trace_id, tenant=tenant)
        if cfg.max_queue_depth > 0 and queue_depth >= cfg.max_queue_depth:
            est = self._estimated_wait_s(gate, queue_depth, instances)
            self._reject(model, version, "queue_depth", AdmissionError(
                f"model '{model}' queue depth {queue_depth} is at the "
                f"shed limit ({cfg.max_queue_depth}); estimated wait "
                f"{est:.3f}s", retry_after_s=est, reason="queue_depth"),
                trace_id=trace_id, tenant=tenant)
        if cfg.max_estimated_wait_s > 0:
            est = self._estimated_wait_s(gate, queue_depth, instances)
            if est > cfg.max_estimated_wait_s:
                self._reject(model, version, "estimated_wait",
                             AdmissionError(
                                 f"model '{model}' estimated queue wait "
                                 f"{est:.3f}s exceeds the shed limit "
                                 f"({cfg.max_estimated_wait_s:g}s)",
                                 retry_after_s=est - cfg.max_estimated_wait_s
                                 + MIN_RETRY_AFTER_S,
                                 reason="estimated_wait"),
                             trace_id=trace_id, tenant=tenant)

    @staticmethod
    def _estimated_wait_s(gate: _ModelGate, queue_depth: int,
                          instances: int) -> float:
        service = gate.ewma_service_s or MIN_RETRY_AFTER_S
        return queue_depth * service / max(1, instances)

    def _reject(self, model: str, version: str, reason: str,
                exc: AdmissionError, trace_id: str | None = None,
                tenant: str = ""):
        self._count_shed(model, version, reason,
                         retry_after_s=exc.retry_after_s,
                         trace_id=trace_id, tenant=tenant)
        raise exc

    def record_rejection(self, model: str, version: str = "",
                         reason: str = "draining",
                         trace_id: str | None = None,
                         tenant: str = "") -> None:
        """Count a shed decided outside :meth:`admit` (e.g. the engine's
        drain gate) on the same counter and DEGRADED clock."""
        self._count_shed(model, version, reason, trace_id=trace_id,
                         tenant=tenant)

    def _count_shed(self, model: str, version: str, reason: str,
                    retry_after_s: float | None = None,
                    trace_id: str | None = None,
                    tenant: str = "") -> None:
        with self._lock:
            self.rejection_count += 1
            self._last_shed = self._clock()
            entered = not self._degraded_state
            self._degraded_state = True
        tenant = tenant or "default"
        if self._metrics is not None:
            self._metrics.admission_rejections.inc(
                model=model, version=str(version or "latest"),
                reason=reason, tenant=tenant, exemplar=trace_id)
        # Lazy, like _journal(): count the shed on the cost ledger's
        # interference taxonomy (the `admission` leg).
        from client_tpu_torch.observability.costs import ledger

        ledger().note_shed(model, version or "latest", tenant, reason)
        jour = self._journal()
        if jour is not None:
            detail = {"reason": reason, "tenant": tenant}
            if retry_after_s is not None:
                detail["retry_after_s"] = round(retry_after_s, 4)
            jour.emit("admission", "shed", severity="WARNING",
                      model=model, version=version or None,
                      trace_id=trace_id, **detail)
            if entered:
                jour.emit("admission", "degraded_enter",
                          severity="WARNING", model=model,
                          version=version or None, trace_id=trace_id,
                          hold_s=self.config.degraded_hold_s)

    def _journal(self):
        """The process-global event journal (lazy: admission is imported
        by engine.types consumers that never serve)."""
        from client_tpu_torch.observability.events import journal

        return journal()

    # -- lifetime accounting -------------------------------------------------

    def on_request_start(self, model: str, shadow: bool = False) -> None:
        gate = self._gate(model)
        with self._lock:
            gate.inflight += 1
            if shadow:
                gate.shadow_inflight += 1

    def on_request_end(self, model: str, service_s: float | None = None,
                       shadow: bool = False) -> None:
        gate = self._gate(model)
        with self._lock:
            gate.inflight = max(0, gate.inflight - 1)
            if shadow:
                gate.shadow_inflight = max(0, gate.shadow_inflight - 1)
            if service_s is not None and service_s > 0:
                if gate.ewma_service_s <= 0:
                    gate.ewma_service_s = service_s
                else:
                    gate.ewma_service_s += _EWMA_ALPHA * (
                        service_s - gate.ewma_service_s)

    def inflight(self, model: str) -> int:
        gate = self._gates.get(model)
        return gate.inflight if gate is not None else 0

    def total_inflight(self) -> int:
        with self._lock:
            return sum(g.inflight for g in self._gates.values())

    def estimated_service_s(self, model: str) -> float:
        gate = self._gates.get(model)
        return gate.ewma_service_s if gate is not None else 0.0

    def load_snapshot(self) -> dict[str, dict]:
        """Per-model load: the in-flight counts and the service EWMA, in
        one lock acquisition (self-drive's dispatch tuner reads it)."""
        with self._lock:
            return {m: {"inflight": g.inflight,
                        "shadow_inflight": g.shadow_inflight,
                        "ewma_service_s": g.ewma_service_s}
                    for m, g in self._gates.items()}

    # -- self-drive's actuators (SLO-burn tightening, concurrency nudges) ----

    def tighten_model(self, model: str, version: str = "", *,
                      factor: float = 0.5, min_ratio: float = 0.1,
                      reason: str = "slo_burn") -> bool:
        """Progressively lower the model's admitted rate (an SLO-burn
        loop's actuator). Each call multiplies the current rate ratio by
        ``factor``, floored at ``min_ratio``. With a configured token
        bucket the cut retargets its refill rate; without one a bucket is
        synthesized from the observed service capacity (1/EWMA), so even
        an uncapped model can be shed under burn. Returns True when the
        ratio actually moved. Journals ``admission.tighten`` only on the
        untightened->tightened edge, so a sustained burn logs one edge,
        not one per tick."""
        gate = self._gate(model)
        cfg = gate.cfg
        with self._lock:
            old = gate.rate_ratio
            new = max(min_ratio, old * factor)
            if new >= old:
                return False
            gate.rate_ratio = new
            entered = old >= 1.0
            if gate.bucket is None and gate.dyn_bucket is None:
                # Capacity estimate for the synthesized cap; 1ms floor
                # keeps a cold EWMA from minting an absurd rate.
                gate.dyn_base_rate = 1.0 / max(gate.ewma_service_s, 1e-3)
        if gate.bucket is not None:
            gate.bucket.set_rate(cfg.tokens_per_s * new)
        elif gate.dyn_bucket is None:
            rate = max(1e-9, gate.dyn_base_rate * new)
            gate.dyn_bucket = TokenBucket(rate, max(1.0, rate),
                                          clock=self._clock)
        else:
            gate.dyn_bucket.set_rate(gate.dyn_base_rate * new)
        if entered:
            jour = self._journal()
            if jour is not None:
                jour.emit("admission", "tighten", severity="WARNING",
                          model=model, version=version or None,
                          ratio=round(new, 4), reason=reason)
        return True

    def restore_model(self, model: str, version: str = "", *,
                      step: float = 2.0) -> bool:
        """Walk one tightened model's rate ratio back up by ``step``
        (multiplicative, capped at 1.0), one step per quiet window.
        Journals ``admission.restore`` only when the ratio reaches 1.0
        (the cleared edge). Returns True when the ratio moved."""
        gate = self._gate(model)
        cfg = gate.cfg
        with self._lock:
            old = gate.rate_ratio
            if old >= 1.0:
                return False
            new = min(1.0, old * max(1.0 + 1e-9, step))
            gate.rate_ratio = new
            cleared = new >= 1.0
        if gate.bucket is not None:
            gate.bucket.set_rate(cfg.tokens_per_s * new)
        elif gate.dyn_bucket is not None:
            if cleared:
                gate.dyn_bucket = None
            else:
                gate.dyn_bucket.set_rate(gate.dyn_base_rate * new)
        if cleared:
            jour = self._journal()
            if jour is not None:
                jour.emit("admission", "restore", model=model,
                          version=version or None, ratio=1.0)
        return True

    def tightened_models(self) -> dict[str, float]:
        """{model: rate_ratio} for every model tightened below 1.0."""
        with self._lock:
            return {m: g.rate_ratio for m, g in self._gates.items()
                    if g.rate_ratio < 1.0}

    def set_concurrency_cap(self, model: str, cap: int | None) -> int:
        """Set (None: clear) the model's dynamic concurrency cap, the
        dispatch tuner's nudge; :meth:`admit` enforces min(configured,
        dynamic), so it only tightens. Returns the dynamic cap in force
        (0 = none)."""
        gate = self._gate(model)
        with self._lock:
            gate.dyn_max_inflight = 0 if cap is None else max(1, int(cap))
            return gate.dyn_max_inflight

    def concurrency_cap(self, model: str) -> int:
        """The model's effective concurrency cap (0 = uncapped)."""
        gate = self._gate(model)
        with self._lock:
            cfg_cap, dyn = gate.cfg.max_inflight, gate.dyn_max_inflight
        if dyn > 0:
            return min(cfg_cap, dyn) if cfg_cap > 0 else dyn
        return cfg_cap

    # -- health --------------------------------------------------------------

    def degraded(self) -> bool:
        """True while the controller shed recently (within
        ``degraded_hold_s``): the engine reports DEGRADED so balancers
        deprioritize the instance while it is actively overloaded. The
        enter/exit edges land in the event journal as
        ``admission.degraded_enter`` / ``admission.degraded_exit``."""
        with self._lock:
            last = self._last_shed
            now_degraded = bool(last) and (
                self._clock() - last < self.config.degraded_hold_s)
            exited = self._degraded_state and not now_degraded
            self._degraded_state = now_degraded
        if exited:
            jour = self._journal()
            if jour is not None:
                jour.emit("admission", "degraded_exit",
                          hold_s=self.config.degraded_hold_s)
        return now_degraded
