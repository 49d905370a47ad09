"""Fleet-coordinated incident capture: one incident id, every replica.

The port's copy of ``client_tpu/router/blackbox.py``, the router half of
the incident blackbox (:mod:`client_tpu_torch.observability.blackbox` is
the replica half). On a trigger (the ``fleet.rebalance`` journal edge,
or ``POST /v2/debug/capture`` on the router) :class:`FleetBlackbox` mints
one incident id and fans ``POST /v2/debug/capture`` out to every replica
with it, then writes a *router bundle* beside them: the federated
``/v2/fleet/*`` views, the replica table, the stitched fleet trace and
the router's fingerprint. A dead replica degrades the capture, never
fails it: its error rides inline in the ``replicas`` map.

The fan-out forwards an automatic trigger's name, which each replica
checks against its own debounce and cooldown, so a replica that already
captured the same edge answers ``{"deduped": true}`` with its bundle's
id. Router bundles live in a ``router/`` ring of their own under the
bundle directory, served by ``GET /v2/debug/bundles[/{id}]`` on the
router, whose index inlines each replica's own listing.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid

from client_tpu_torch.observability.blackbox import (
    DEFAULT_TRIGGERS,
    BlackboxConfig,
    BundleStore,
    _next_seq,
    fingerprint,
    match_trigger,
)
from client_tpu_torch.observability.events import journal
from client_tpu_torch.utils import lockdep

__all__ = ["FleetBlackbox"]

_log = logging.getLogger("client_tpu_torch")


class FleetBlackbox:
    """Router-side incident coordinator over one fleet.

    Subscribes to the (router-process) journal for the fleet trigger
    edges in ``config.triggers``; capture runs on a short-lived worker
    thread so the emitting thread (fleet monitor, rebalancer) is never
    blocked on replica round-trips. ``close()`` unsubscribes and joins
    the worker."""

    def __init__(self, router, federator, monitor=None,
                 config: BlackboxConfig | None = None, *,
                 clock=time.time, mono=time.monotonic):
        self.router = router
        self.federator = federator
        self.monitor = monitor
        self.config = config or BlackboxConfig()
        self._clock = clock
        self._mono = mono
        self.store = BundleStore(
            os.path.join(self.config.resolved_dir(), "router"),
            max_bundles=self.config.max_bundles,
            max_total_bytes=self.config.max_total_bytes)
        self._lock = lockdep.Lock("observability.blackbox")
        self._last_capture = float("-inf")      # mono, automatic only
        self._cooldowns: dict[str, float] = {}
        self._worker: threading.Thread | None = None
        self._closed = False
        self.captures = 0
        self.suppressed = 0
        self.last_capture_ms: float | None = None
        r = router.metrics.registry
        self._captures_total = r.counter(
            "tpu_blackbox_captures_total",
            "Incident bundles captured, by trigger edge",
            ("trigger",))
        self._bundle_bytes = r.gauge(
            "tpu_blackbox_bundle_bytes",
            "Total bytes of incident bundles currently retained on disk")

    # -- lifecycle ------------------------------------------------------------

    def install(self) -> "FleetBlackbox":
        if self.config.enabled:
            journal().add_sink(self._on_event)
        return self

    def close(self) -> None:
        """Stop triggering and wait for an in-flight capture."""
        self._closed = True
        journal().remove_sink(self._on_event)
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=10)
        self._worker = None

    # -- trigger path ---------------------------------------------------------

    def _on_event(self, event) -> None:
        """Journal sink (emitting thread): match fleet edges, debounce,
        hand off to a worker. Storm triggers are a replica-side concept;
        the router reacts to single edges only."""
        if self._closed or event.category == "blackbox":
            return
        trigger = match_trigger(event.category, event.name, event.detail)
        if trigger is None or trigger not in self.config.triggers:
            return
        now = self._mono()
        with self._lock:
            if now - self._last_capture < self.config.debounce_s:
                self.suppressed += 1
                return
            last = self._cooldowns.get(trigger)
            if last is not None \
                    and now - last < self.config.cooldown_s:
                self.suppressed += 1
                return
            self._last_capture = now
            self._cooldowns[trigger] = now
            if self._worker is not None and self._worker.is_alive():
                self.suppressed += 1
                return
            self._worker = threading.Thread(
                target=self._capture_guarded, args=(trigger,),
                name="fleet-blackbox-capture", daemon=True)
            self._worker.start()

    def _capture_guarded(self, trigger: str) -> None:
        try:
            self.capture(trigger)
        except Exception:  # noqa: BLE001 — capture must not wedge
            _log.exception("fleet blackbox capture failed")

    # -- capture --------------------------------------------------------------

    def capture(self, trigger: str = "manual", *,
                incident: str | None = None,
                note: str | None = None) -> dict:
        """Coordinate one fleet capture now. Returns ``{"incident",
        "bundle": <router bundle meta>, "replicas": {id: meta |
        {"error"} | {"deduped"}}}``."""
        t0 = time.perf_counter()
        incident = incident or f"inc-{uuid.uuid4().hex[:12]}"
        # Forward automatic trigger names verbatim (each replica's own
        # cooldown dedupes against its local capture of the same edge);
        # anything else fans out as the always-capturing "fleet".
        fwd = trigger if trigger in DEFAULT_TRIGGERS else "fleet"
        payload = json.dumps({
            "trigger": fwd, "incident": incident,
            "note": note or f"fleet capture via router ({trigger})",
        }).encode("utf-8")
        replicas: dict[str, dict] = {}
        for r in self.router.replicas:
            try:
                status, _, data = r.send(
                    "POST", "/v2/debug/capture",
                    headers={"Content-Type": "application/json"},
                    body=payload, timeout_s=self.federator.timeout_s)
                obj = json.loads(data) if data else {}
                if status != 200:
                    replicas[r.id] = {"error": obj.get(
                        "error", f"/v2/debug/capture returned {status}")}
                else:
                    replicas[r.id] = obj
            except Exception as exc:  # noqa: BLE001 — inline, never fatal
                replicas[r.id] = {
                    "error": f"{type(exc).__name__}: {exc}"}
        meta = self._router_bundle(trigger, incident, note, replicas)
        capture_ms = round((time.perf_counter() - t0) * 1e3, 3)
        meta["capture_ms"] = capture_ms
        with self._lock:
            self.captures += 1
            self.last_capture_ms = capture_ms
        self._captures_total.inc(trigger=trigger)
        self._bundle_bytes.set(self.store.total_bytes())
        journal().emit(
            "blackbox", "captured", severity="INFO",
            trigger=trigger, bundle=meta["id"], incident=incident,
            replicas=len(replicas),
            errors=sum(1 for v in replicas.values() if "error" in v))
        return {"incident": incident, "bundle": meta,
                "replicas": replicas}

    def _router_bundle(self, trigger: str, incident: str,
                       note: str | None, replicas: dict) -> dict:
        """The router's own bundle: federated fleet views + stitching —
        every section independently best-effort."""
        from client_tpu_torch.router.fleet import stitched_trace

        cfg = self.config
        wall = self._clock()
        bundle_id = (f"bb-{os.getpid()}-{_next_seq():04d}-router-"
                     + trigger.replace(".", "-"))
        sections: dict = {}

        def section(name, fn):
            try:
                sections[name] = fn()
            except Exception as exc:  # noqa: BLE001 — partial bundles
                sections[name] = {"error": f"{type(exc).__name__}: {exc}"}

        drift = (self.monitor.drift_report()
                 if self.monitor is not None else None)
        section("router_status", self.router.status)
        section("journal", lambda: journal().export(
            limit=cfg.journal_tail))
        section("fleet_events", lambda: self.federator.events(
            limit=cfg.journal_tail))
        section("fleet_profile", lambda: self.federator.profile(
            drift=drift))
        section("fleet_slo", self.federator.slo)
        section("fleet_costs", self.federator.costs)
        section("fleet_timeseries", lambda: self.federator.timeseries())
        section("stitched_trace", lambda: stitched_trace(
            self.router, self.federator))
        section("fingerprint", fingerprint)

        bundle = {
            "schema": 1,
            "id": bundle_id,
            "incident": incident,
            "trigger": trigger,
            "router": True,
            "note": note or "",
            "ts_wall": wall,
            "replicas": {rid: {k: v for k, v in obj.items()
                               if k in ("id", "error", "deduped",
                                        "bundle", "bytes")}
                         for rid, obj in replicas.items()},
            "truncated": [],
            "sections": sections,
        }
        payload = json.dumps(bundle).encode("utf-8")
        if len(payload) > cfg.max_bundle_bytes:
            # Stitched traces dominate router-bundle size; drop the
            # heavy sections wholesale until under the cap.
            for name in ("stitched_trace", "fleet_timeseries",
                         "fleet_events", "journal"):
                bundle["sections"][name] = "truncated"
                bundle["truncated"].append(name)
                payload = json.dumps(bundle).encode("utf-8")
                if len(payload) <= cfg.max_bundle_bytes:
                    break
        return self.store.write(bundle_id, payload, {
            "incident": incident,
            "trigger": trigger,
            "router": True,
            "ts_wall": wall,
            "note": note or "",
            "truncated": bundle["truncated"],
        })

    # -- read surface ---------------------------------------------------------

    def bundles(self, bundle_id: str | None = None) -> dict:
        """Router ``GET /v2/debug/bundles[/{id}]`` body. The index
        carries the router's own ring plus each replica's bundle
        listing (inline errors for dead replicas); by-id lookups serve
        router bundles (replica bundles live on their replicas)."""
        if bundle_id:
            return self.store.load(bundle_id)
        results, errors = self.federator._fan_out(
            "/v2/debug/bundles", "bundles")
        with self._lock:
            stats = {"captures": self.captures,
                     "suppressed": self.suppressed,
                     "last_capture_ms": self.last_capture_ms}
        return {
            "enabled": self.config.enabled,
            "dir": self.store.directory,
            "router": True,
            "bundles": self.store.list(),
            "total_bytes": self.store.total_bytes(),
            "replicas": results,
            "errors": errors,
            **stats,
        }
