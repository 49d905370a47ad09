"""Deterministic server-side fault injection.

The port's copy of ``client_tpu/faults/__init__.py``: a process-global
registry of named injection sites, each at one chokepoint of the serving
stack:

* ``http.pre_read``      — HTTP frontend, before the request body is read
* ``grpc.pre_infer``     — gRPC frontend, on ``ModelInfer`` entry
* ``scheduler.enqueue``  — scheduler admission, before the queue put
* ``scheduler.dequeue``  — scheduler worker, after a request is popped
* ``model.execute``      — model execution, before the device work
* ``shmring.doorbell``   — the shm slot ring's doorbell and each reaper
  sweep of a ring

Each site can add latency, answer a protocol error with a chosen status,
or drop the connection, gated by a seeded Bernoulli draw: one
``random.Random(seed)`` per armed site, so a given (seed, probability)
injects on the same calls on every run, in this package as in the JAX
package.

Configuration is programmatic (``faults.configure({...})``) or the
``CLIENT_TPU_FAULTS`` environment variable, inline JSON or
``@/path/to/profile.json``::

    CLIENT_TPU_FAULTS='{"model.execute":
        {"probability": 0.5, "seed": 7, "error_status": 503}}'

Injections count on ``tpu_fault_injections_total{site,kind}`` of every
bound metric registry (each engine binds its own) and are journalled as
``fault.injected``.
"""

from __future__ import annotations

import json
import os
import random
import time
import weakref

from client_tpu_torch.config import env_text
from client_tpu_torch.utils import lockdep

SITES = ("http.pre_read", "grpc.pre_infer", "scheduler.enqueue",
         "scheduler.dequeue", "model.execute", "shmring.doorbell")

ENV_VAR = "CLIENT_TPU_FAULTS"


class FaultInjected(Exception):
    """Raised at a site whose draw triggered an error or a drop; the layer
    hosting the site turns it into its own protocol error."""

    def __init__(self, site: str, kind: str, status: int | None = None):
        super().__init__(f"injected fault at {site} ({kind}"
                         + (f", status {status}" if status else "") + ")")
        self.site = site
        self.kind = kind  # "error" | "drop"
        self.status = status


class FaultSpec:
    """One site's injection: latency, then at most one terminal action
    (an error or a drop), so an injected 503 still pays the delay."""

    def __init__(self, site: str, probability: float = 1.0, seed: int = 0,
                 latency_ms: float = 0.0, error_status: int | None = None,
                 drop: bool = False, max_injections: int | None = None):
        if site not in SITES:
            raise ValueError(
                f"unknown fault site '{site}' (valid: {', '.join(SITES)})")
        if not 0.0 <= probability <= 1.0:
            raise ValueError("probability must be within [0, 1]")
        if drop and error_status is not None:
            raise ValueError("a fault is either an error or a drop, not both")
        self.site = site
        self.probability = float(probability)
        self.seed = int(seed)
        self.latency_ms = float(latency_ms)
        self.error_status = (int(error_status)
                             if error_status is not None else None)
        self.drop = bool(drop)
        self.max_injections = (int(max_injections)
                               if max_injections is not None else None)

    @classmethod
    def from_dict(cls, site: str, d: dict) -> "FaultSpec":
        unknown = set(d) - {"probability", "seed", "latency_ms",
                            "error_status", "drop", "max_injections"}
        if unknown:
            raise ValueError(
                f"unknown fault spec keys for '{site}': {sorted(unknown)}")
        return cls(site, **d)


class _ActiveFault:
    """A spec armed with its own seeded generator and injection budget."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.remaining = spec.max_injections
        self.lock = lockdep.Lock("faults.active")

    def draw(self) -> bool:
        with self.lock:
            if self.remaining == 0:
                return False
            if self.rng.random() >= self.spec.probability:
                return False
            if self.remaining is not None:
                self.remaining -= 1
            return True


class FaultRegistry:
    """Named injection sites, their seeded draws and injection counts."""

    def __init__(self):
        self._lock = lockdep.Lock("faults.registry")
        self._active: dict[str, _ActiveFault] = {}
        self._counts: dict[tuple[str, str], int] = {}
        # id(MetricRegistry) -> weak reference to its counter: rebinding
        # replaces, and a dead engine's counter is pruned, not fed.
        self._metric_counters: dict[int, weakref.ref] = {}

    def configure(self, config: dict) -> None:
        """Replace every armed site: {site: spec dict}."""
        active = {site: _ActiveFault(FaultSpec.from_dict(site, dict(d)))
                  for site, d in (config or {}).items()}
        with self._lock:
            self._active = active

    def install(self, spec: FaultSpec) -> None:
        with self._lock:
            self._active[spec.site] = _ActiveFault(spec)

    def clear(self) -> None:
        with self._lock:
            self._active = {}

    def configure_from_env(self, environ=os.environ) -> None:
        raw = env_text(ENV_VAR, environ)
        if not raw:
            return
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        self.configure(json.loads(raw))

    def bind_metrics(self, metric_registry) -> None:
        """Count injections on ``tpu_fault_injections_total{site,kind}`` of
        ``metric_registry``. Idempotent per registry; several engines may
        bind."""
        counter = metric_registry.counter(
            "tpu_fault_injections_total",
            "Injected faults by site and kind (chaos subsystem)",
            ("site", "kind"))
        with self._lock:
            self._metric_counters[id(metric_registry)] = weakref.ref(counter)

    def _count(self, site: str, kind: str) -> None:
        with self._lock:
            key = (site, kind)
            self._counts[key] = self._counts.get(key, 0) + 1
            counters = []
            for rid, ref in list(self._metric_counters.items()):
                c = ref()
                if c is None:
                    del self._metric_counters[rid]
                else:
                    counters.append(c)
        for c in counters:
            c.inc(site=site, kind=kind)
        from client_tpu_torch.observability.events import journal

        journal().emit("fault", "injected", site=site, kind=kind)

    def counts(self) -> dict:
        with self._lock:
            return {f"{site}:{kind}": n
                    for (site, kind), n in sorted(self._counts.items())}

    def fire(self, site: str, sleep=time.sleep) -> None:
        """Evaluate the site: nothing when it is unarmed or the draw misses;
        else the latency inline, then FaultInjected for an error or a
        drop (the caller translates it)."""
        active = self._active.get(site)
        if active is None or not active.draw():
            return
        spec = active.spec
        if spec.latency_ms > 0:
            self._count(site, "latency")
            sleep(spec.latency_ms / 1000.0)
        if spec.drop:
            self._count(site, "drop")
            raise FaultInjected(site, "drop")
        if spec.error_status is not None:
            self._count(site, "error")
            raise FaultInjected(site, "error", spec.error_status)


_default: FaultRegistry | None = None
_default_lock = lockdep.Lock("faults.default")


def registry() -> FaultRegistry:
    """The process-global registry; ``CLIENT_TPU_FAULTS`` is applied on
    first access."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                r = FaultRegistry()
                r.configure_from_env()
                _default = r
    return _default


def configure(config: dict) -> None:
    registry().configure(config)


def fire(site: str) -> None:
    registry().fire(site)


def reset() -> None:
    """Disarm every site (counts and metric bindings are kept)."""
    registry().clear()
