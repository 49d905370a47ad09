"""The router's fleet plane: the federation fetcher, trace stitching and
the background drift monitor.

The port's copy of ``client_tpu/router/fleet.py``. The merges and the
drift math live in :mod:`client_tpu_torch.observability.fleet`; this
module is the half that talks to the replicas through the router's
:class:`~client_tpu_torch.router.core.Replica` connection pools:

- :class:`FleetFederator`: one surface fetched from every replica
  (``/v2/events``, ``/v2/profile``, ``/v2/slo``, ``/v2/costs``,
  ``/v2/timeseries``, ``/metrics``, ``/v2/trace/requests``), each
  failure kept per replica and counted in
  ``tpu_fleet_fetch_failures_total``: a dead replica degrades the
  aggregate, never fails it.
- :func:`stitched_trace`: one Chrome trace of the router's own span ring
  and every replica's request traces, the router as pid 1 and each
  replica on a pid of its own. The router's per-attempt ``router:proxy``
  spans are drawn on the *attempted* replica's track, so a failover reads
  left to right.
- :class:`FleetMonitor`: a thread that compares each replica's duty
  cycle, batch fill, decode wave p50, MFU and queue wait with the fleet's
  medians; it sets ``tpu_fleet_drift_score{replica,signal}``, journals
  ``fleet.drift`` / ``fleet.drift_cleared`` on each edge and keeps the
  last report for ``/v2/fleet/profile`` and placement
  (``CLIENT_TPU_FLEET_MONITOR``).
"""

from __future__ import annotations

import json
import logging
import threading
import time

from client_tpu_torch.observability.events import journal
from client_tpu_torch.observability.fleet import (
    FleetMonitorConfig,
    drift_scores,
    fleet_median,
    merge_costs,
    merge_events,
    merge_expositions,
    merge_profiles,
    merge_slo,
    merge_timeseries,
    profile_signals,
    timeseries_signals,
)
from client_tpu_torch.observability.tracing import span_args
from client_tpu_torch.utils import lockdep

_log = logging.getLogger("client_tpu_torch")

__all__ = ["FleetFederator", "FleetMonitor", "stitched_trace"]


class FleetFederator:
    """Fan-out fetches of per-replica surfaces through the router's
    replica handles (reusing their keep-alive pools and timeouts)."""

    def __init__(self, router, timeout_s: float = 10.0):
        self.router = router
        self.timeout_s = timeout_s

    # -- one replica ---------------------------------------------------------

    def _fetch(self, replica, path: str, surface: str):
        """-> (body bytes | None, error | None); failures are metered,
        never raised."""
        try:
            status, _, data = replica.send("GET", path,
                                           timeout_s=self.timeout_s)
            if status != 200:
                raise OSError(f"{path} returned {status}")
            return data, None
        except Exception as exc:  # noqa: BLE001 — inline error reporting
            self.router.metrics.fleet_fetch_failures.inc(
                replica=replica.id, surface=surface)
            return None, f"{type(exc).__name__}: {exc}"

    def _fetch_json(self, replica, path: str, surface: str):
        data, err = self._fetch(replica, path, surface)
        if err is not None:
            return None, err
        try:
            return json.loads(data), None
        except ValueError as exc:
            self.router.metrics.fleet_fetch_failures.inc(
                replica=replica.id, surface=surface)
            return None, f"invalid JSON: {exc}"

    def _fan_out(self, path: str, surface: str):
        """-> ({replica: parsed}, {replica: error}) across ALL replicas
        (not just eligible ones — a drained replica's telemetry is still
        telemetry)."""
        results: dict[str, dict] = {}
        errors: dict[str, str] = {}
        for r in self.router.replicas:
            obj, err = self._fetch_json(r, path, surface)
            if err is not None:
                errors[r.id] = err
            else:
                results[r.id] = obj
        return results, errors

    # -- surfaces ------------------------------------------------------------

    def events(self, query: str = "", limit: int | None = None) -> dict:
        path = "/v2/events" + (f"?{query}" if query else "")
        exports, errors = self._fan_out(path, "events")
        return merge_events(exports, errors, limit=limit)

    def profiles(self):
        return self._fan_out("/v2/profile", "profile")

    def profile(self, drift: dict | None = None) -> dict:
        profiles, errors = self.profiles()
        return merge_profiles(profiles, errors, drift=drift)

    def slo(self) -> dict:
        exports, errors = self._fan_out("/v2/slo", "slo")
        return merge_slo(exports, errors)

    def costs(self) -> dict:
        exports, errors = self._fan_out("/v2/costs", "costs")
        return merge_costs(exports, errors)

    def timeseries_raw(self, query: str = ""):
        path = "/v2/timeseries" + (f"?{query}" if query else "")
        return self._fan_out(path, "timeseries")

    def timeseries(self, query: str = "",
                   limit: int | None = None) -> dict:
        exports, errors = self.timeseries_raw(query)
        return merge_timeseries(exports, errors, limit=limit)

    def metrics_text(self) -> str:
        """One classic-dialect exposition for the whole fleet; fetch
        failures ride along as comment lines (comments are valid
        exposition — the aggregate never 500s on a dead replica)."""
        exposures: dict[str, str] = {}
        errors: dict[str, str] = {}
        for r in self.router.replicas:
            data, err = self._fetch(r, "/metrics", "metrics")
            if err is not None:
                errors[r.id] = err
            else:
                exposures[r.id] = data.decode("utf-8", "replace")
        lines = [f"# fleet replicas={len(self.router.replicas)} "
                 f"merged={len(exposures)} errors={len(errors)}"]
        for rid in sorted(errors):
            lines.append(f"# fleet-fetch-error {rid}: {errors[rid]}")
        return "\n".join(lines) + "\n" + merge_expositions(exposures)

    def replica_traces(self, trace_id: str | None = None):
        """-> ({replica: chrome-trace dict}, {replica: error})."""
        path = "/v2/trace/requests"
        if trace_id:
            path += f"?trace_id={trace_id}"
        return self._fan_out(path, "trace")

    def loads(self) -> dict[str, dict]:
        """The router's current (piggyback/polled) load view per replica
        — no network round-trip; staleness is visible via load_age."""
        return {r.id: r.load.to_json_dict() for r in self.router.replicas}


def stitched_trace(router, federator: FleetFederator,
                   trace_id: str | None = None) -> dict:
    """One Chrome trace for the fleet: router spans (pid 1) + every
    replica's request traces, each replica on its own pid/track.

    The router's per-attempt ``router:proxy`` spans are re-homed onto
    the attempted replica's track (tid 0, above that replica's request
    lanes) so cross-process causality is visible without span-id
    archaeology: the attempt span and the replica phases it caused
    share a row group. All stores stamp monotonic ns from the same
    clock only when router and replicas share a host; across hosts the
    tracks keep relative (per-process) time, which Perfetto handles.
    """
    pid_map = {r.id: i for i, r in enumerate(
        sorted(router.replicas, key=lambda r: r.id), start=2)}
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "router"}}]
    for rid, pid in pid_map.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"replica {rid}"}})
    for tid, group in enumerate(router.spans.snapshot(trace_id), start=1):
        for span in group.spans:
            args = span_args(group.trace_id, span)
            pid, row = 1, tid
            if span.name == "router:proxy" and \
                    span.args.get("replica") in pid_map:
                pid, row = pid_map[span.args["replica"]], 0
            events.append({
                "name": span.name, "cat": "router", "ph": "X",
                "ts": span.start_ns / 1e3,
                "dur": max(0.0, (span.end_ns - span.start_ns) / 1e3),
                "pid": pid, "tid": row, "args": args,
            })
    traces, errors = federator.replica_traces(trace_id)
    for rid, trace in traces.items():
        pid = pid_map.get(rid)
        if pid is None:
            continue
        for evt in trace.get("traceEvents", ()):
            evt = dict(evt)
            evt["pid"] = pid
            events.append(evt)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "trace_id": trace_id,
        "replicas": sorted(pid_map),
        "errors": errors,
    }


class FleetMonitor:
    """Background drift detector over the router's fleet (see module
    doc). One instance per router frontend; tick() is also callable
    directly (tests, one-shot CLI)."""

    def __init__(self, router, config: FleetMonitorConfig,
                 federator: FleetFederator | None = None):
        self.router = router
        self.config = config
        self.federator = federator or FleetFederator(router)
        self.events = journal()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = lockdep.Lock("router.fleet")
        self._flagged: dict[str, dict[str, float]] = {}
        self._report: dict = {"ticks": 0}
        self._ticks = 0
        # Queue wait comes from the router's instantaneous load view —
        # unlike the flight-recorder signals it has no windowed median
        # of its own, and one wait spike at one tick must not flag a
        # replica. Damp it here over the same window the recorder
        # signals use (one sample per monitor tick).
        self._wait_ticks = max(1, int(round(config.window_s
                                            / config.interval_s)))
        self._wait_hist: dict[str, list[float]] = {}
        # Optional drift actuator (router/selfdrive.FleetRebalancer):
        # called with the fresh report on every tick that has flagged
        # replicas. The callee owns its own damping (cooldown, move
        # budget); the monitor stays a pure sensor.
        self.on_drift = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetMonitor":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-monitor", daemon=True)
        self._thread.start()
        self.events.emit("fleet", "monitor_start",
                         **self.config.summary())
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — monitor must not die
                _log.exception("fleet monitor tick failed")

    # -- the tick ------------------------------------------------------------

    def collect_signals(self) -> tuple[dict, dict]:
        """-> ({replica: {signal: value}}, {replica: fetch error}).

        Prefers the flight recorder: duty/fill/wave come as medians over
        the last ``config.window_s`` of each replica's 1 Hz ring, so one
        GC pause or compile stall no longer flags a replica the way a
        single ``/v2/profile`` scrape did. Replicas without a usable
        ring (older build, recorder disabled) fall back per replica to
        the instantaneous profile signals; queue wait always comes from
        the router's own load view."""
        exports, ts_errors = self.federator.timeseries_raw()
        loads = self.federator.loads()
        profiles: dict = {}
        prof_errors: dict = {}
        signals = {}
        for r in self.router.replicas:
            sig = timeseries_signals(exports.get(r.id),
                                     window_s=self.config.window_s)
            if not sig:
                if not profiles and not prof_errors:
                    profiles, prof_errors = self.federator.profiles()
                sig = profile_signals(profiles.get(r.id))
            wait = (loads.get(r.id) or {}).get("wait_s")
            if wait is not None:
                hist = self._wait_hist.setdefault(r.id, [])
                hist.append(float(wait))
                del hist[:-self._wait_ticks]
                sig["wait_s"] = fleet_median(hist)
            signals[r.id] = sig
        errors = dict(ts_errors)
        errors.update(prof_errors)
        return signals, errors

    def tick(self, signals: dict | None = None,
             errors: dict | None = None) -> dict:
        """One evaluation: compute drift scores, publish gauges, emit
        edge-triggered journal events, refresh the report. ``signals``
        may be injected (tests / offline evaluation)."""
        if signals is None:
            if len(self.router.replicas) < self.config.min_replicas:
                with self._lock:
                    self._report = {"ticks": self._ticks,
                                    "skipped": "fleet too small"}
                    return dict(self._report)
            signals, errors = self.collect_signals()
        scores, medians = drift_scores(signals)
        threshold = self.config.threshold
        flagged: dict[str, dict[str, float]] = {}
        for rid, per_signal in scores.items():
            for signal, score in per_signal.items():
                self.router.metrics.fleet_drift_score.set(
                    score, replica=rid, signal=signal)
                if score > threshold:
                    flagged.setdefault(rid, {})[signal] = round(score, 4)
        with self._lock:
            previous = self._flagged
            self._flagged = flagged
            self._ticks += 1
            ticks = self._ticks
        for rid, sigs in flagged.items():
            if rid not in previous:
                self.events.emit(
                    "fleet", "drift", severity="WARNING", replica=rid,
                    signals=sigs, threshold=threshold,
                    medians={k: round(v, 6) for k, v in medians.items()
                             if k in sigs})
        for rid in previous:
            if rid not in flagged:
                self.events.emit("fleet", "drift_cleared", replica=rid)
        report = {
            "ticks": ticks,
            "ts_wall": time.time(),
            "threshold": threshold,
            "signals": signals,
            "medians": medians,
            "scores": {r: {s: round(v, 4) for s, v in per.items()}
                       for r, per in scores.items()},
            "flagged": flagged,
            "errors": dict(errors or {}),
        }
        with self._lock:
            self._report = report
        if flagged and callable(self.on_drift):
            try:
                self.on_drift(report)
            except Exception:  # noqa: BLE001 — actuator must not kill the sensor
                _log.exception("fleet drift actuator failed")
        return report

    def drift_report(self) -> dict:
        with self._lock:
            return dict(self._report)
