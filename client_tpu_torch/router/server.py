"""The router's frontend: a thin HTTP/1.1 reverse proxy over
:class:`client_tpu_torch.router.core.Router`.

The port's copy of ``client_tpu/router/server.py``, with the same routes.
The router's own endpoints (never proxied):

* ``GET /v2/health/live``: the router process is up.
* ``GET /v2/health/ready``: 200 while at least one replica is eligible,
  503 (and ``X-Health-State: DRAINING``) when none is.
* ``GET /v2/load`` and ``GET /v2/router/status``: every replica's last
  load report with its age, breaker state and outstanding count (status
  adds the rebalancer's state when self-drive runs).
* ``GET /metrics``: the router's OWN ``tpu_router_*`` registry (classic
  or OpenMetrics by ``Accept``), not the replicas' metrics.
* ``GET /v2/router/placement``: a placement *plan* from the replicas'
  ``/v2/profile``; ``POST`` applies it.
* ``POST /v2/router/drain``: a rolling drain (body ``{"replicas": [...],
  "deadline_s": ...}``; SIGTERM by each replica's pid).
* ``GET /v2/trace/requests``: the *stitched* fleet trace
  (``?trace_id=`` narrows it to one request end to end).
* ``GET /v2/fleet/{events,profile,slo,costs,timeseries,metrics}``: the
  replicas' surfaces federated; a replica that fails to answer is
  reported inline and never fails the aggregate.
* ``POST /v2/debug/capture`` and ``GET /v2/debug/bundles[/{id}]``: the
  fleet-coordinated incident capture (:mod:`client_tpu_torch.router.blackbox`).

Everything else under ``/v2`` is forwarded through the selection policy;
``/generate_stream`` answers pass through chunk by chunk. The sequence id
for affinity comes from the ``X-Sequence-Id`` request header or, failing
that, the JSON request head (header first, so the hot path parses no
body it need not).
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from client_tpu_torch.config import env_text
from client_tpu_torch.observability.fleet import FleetMonitorConfig
from client_tpu_torch.router.core import Router
from client_tpu_torch.router.drain import rolling_drain
from client_tpu_torch.router.fleet import (
    FleetFederator,
    FleetMonitor,
    stitched_trace,
)
from client_tpu_torch.router import placement as _placement
from client_tpu_torch.router.selfdrive import fleet_plan

_log = logging.getLogger("client_tpu_torch")

SEQUENCE_ID_HEADER = "X-Sequence-Id"

_STREAM_PATH = re.compile(
    r"^/v2/models/[^/]+(?:/versions/[^/]+)?/generate_stream$")
_INFER_PATH = re.compile(
    r"^/v2/models/[^/]+(?:/versions/[^/]+)?/(?:infer|generate|"
    r"generate_stream)$")


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    wbufsize = 64 * 1024
    router: Router = None  # patched on by RouterHttpServer
    federator: FleetFederator = None
    monitor: FleetMonitor | None = None
    rebalancer = None  # FleetRebalancer when CLIENT_TPU_SELFDRIVE is set
    blackbox = None    # FleetBlackbox unless CLIENT_TPU_BLACKBOX=off
    verbose = False

    def log_message(self, fmt, *args):  # noqa: A003
        if self.verbose:
            super().log_message(fmt, *args)

    # -- plumbing -----------------------------------------------------------

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def _dispatch(self, method: str) -> None:
        try:
            body = self.rfile.read(
                int(self.headers.get("Content-Length", 0) or 0)
            ) if method == "POST" else b""
            path = self.path.split("?")[0]
            own = getattr(self, f"h_{method.lower()}_" +
                          path.strip("/").replace("/", "_").replace(".", "_"),
                          None)
            if own is not None:
                own(body)
                return
            # Bundle-by-id carries the id as a path segment, which the
            # exact-name handler lookup above cannot express — route it
            # before the catch-all proxy would forward it to an
            # arbitrary replica.
            if method == "GET" and path.startswith("/v2/debug/bundles/"):
                self._h_debug_bundle_by_id(
                    path[len("/v2/debug/bundles/"):])
                return
            if path.startswith("/v2"):
                self._proxy(method, body)
                return
            self._send_json({"error": f"no route for {method} {path}"}, 404)
        except BrokenPipeError:
            pass
        except Exception as exc:  # noqa: BLE001
            _log.exception("router handler error")
            try:
                self._send_json({"error": f"router error: {exc}"}, 500)
            except Exception:  # noqa: BLE001
                pass

    def _send(self, status: int, body: bytes, headers=None) -> None:
        self.send_response(status)
        sent = set()
        for k, v in (headers or []):
            self.send_header(k, v)
            sent.add(k.lower())
        if "content-type" not in sent:
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json(self, obj, status: int = 200, headers=None) -> None:
        self._send(status, json.dumps(obj).encode("utf-8"), headers)

    # -- router-owned endpoints ---------------------------------------------

    def h_get_v2_health_live(self, body):
        self._send(200, b"")

    def h_get_v2_health_ready(self, body):
        eligible = self.router.eligible()
        state = "READY" if eligible else "DRAINING"
        self._send_json({"state": state,
                         "eligible": [r.id for r in eligible]},
                        200 if eligible else 503,
                        headers=[("X-Health-State", state)])

    def h_get_v2_load(self, body):
        self._send_json(self.router.status())

    def h_get_v2_router_status(self, body):
        status = self.router.status()
        if self.rebalancer is not None:
            status["selfdrive"] = self.rebalancer.snapshot()
        self._send_json(status)

    def h_get_metrics(self, body):
        accept = self.headers.get("Accept", "") or ""
        om = "application/openmetrics-text" in accept
        text = self.router.metrics.render(openmetrics=om)
        ctype = ("application/openmetrics-text; version=1.0.0; charset=utf-8"
                 if om else "text/plain; version=0.0.4")
        self._send(200, text.encode("utf-8"),
                   headers=[("Content-Type", ctype)])

    def _placement_plan(self):
        # Shared with the drift-triggered rebalancer: the HTTP surface
        # and the closed loop plan from identical logic (including the
        # cost ledger's interference attribution).
        return fleet_plan(self.router, self.federator)

    def h_get_v2_router_placement(self, body):
        costs, current, plan, _profiles = self._placement_plan()
        # Placement plans carry the fleet's observed drift so continuous
        # re-placement (ROADMAP item 2) has evidence, not just costs.
        drift = (self.monitor.drift_report() if self.monitor is not None
                 else None)
        self._send_json({
            "costs_device_s": {m: round(c, 6) for m, c in costs.items()},
            "current": {rid: sorted(ms) for rid, ms in current.items()},
            "plan": plan,
            "moves": _placement.placement_moves(plan, current),
            "drift": drift,
        })

    def h_post_v2_router_placement(self, body):
        _, current, plan, profiles = self._placement_plan()
        results = _placement.apply_placement(self.router, plan,
                                             profiles=profiles)
        self._send_json({"plan": plan, "applied": results})

    def h_post_v2_router_drain(self, body):
        opts = json.loads(body or b"{}")
        reports = rolling_drain(
            self.router, opts.get("replicas"),
            deadline_s=float(opts.get("deadline_s", 30.0)))
        ok = all(r["outcome"] in ("clean", "gone") for r in reports)
        self._send_json({"reports": reports}, 200 if ok else 500)

    # -- fleet observability -------------------------------------------------

    def _query(self) -> dict[str, str]:
        return {k: v[-1] for k, v in
                parse_qs(urlsplit(self.path).query).items()}

    def h_get_v2_trace_requests(self, body):
        # Router-owned (never proxied): the stitched fleet trace.
        # Per-replica raw traces stay reachable on the replicas directly.
        q = self._query()
        self._send_json(stitched_trace(self.router, self.federator,
                                       trace_id=q.get("trace_id")))

    def h_get_v2_fleet_events(self, body):
        q = self._query()
        limit = None
        if "limit" in q:
            try:
                limit = int(q.pop("limit"))
            except ValueError:
                self._send_json({"error": "limit must be an integer"}, 400)
                return
        query = "&".join(f"{k}={v}" for k, v in q.items())
        self._send_json(self.federator.events(query, limit=limit))

    def h_get_v2_fleet_profile(self, body):
        drift = (self.monitor.drift_report() if self.monitor is not None
                 else None)
        self._send_json(self.federator.profile(drift=drift))

    def h_get_v2_fleet_slo(self, body):
        self._send_json(self.federator.slo())

    def h_get_v2_fleet_costs(self, body):
        self._send_json(self.federator.costs())

    def h_get_v2_fleet_timeseries(self, body):
        q = self._query()
        limit = None
        if "limit" in q:
            try:
                limit = int(q.pop("limit"))
            except ValueError:
                self._send_json({"error": "limit must be an integer"}, 400)
                return
        query = "&".join(f"{k}={v}" for k, v in q.items())
        self._send_json(self.federator.timeseries(query, limit=limit))

    # -- fleet-coordinated incident blackbox ---------------------------------

    def h_get_v2_debug_bundles(self, body):
        if self.blackbox is None:
            self._send_json(
                {"error": "blackbox disabled (CLIENT_TPU_BLACKBOX=off)"},
                400)
            return
        self._send_json(self.blackbox.bundles())

    def _h_debug_bundle_by_id(self, bundle_id):
        if self.blackbox is None:
            self._send_json(
                {"error": "blackbox disabled (CLIENT_TPU_BLACKBOX=off)"},
                400)
            return
        try:
            self._send_json(self.blackbox.bundles(bundle_id))
        except KeyError:
            self._send_json(
                {"error": f"unknown bundle {bundle_id!r} (replica "
                          "bundles are served by their replicas)"}, 404)
        except ValueError as exc:
            self._send_json({"error": str(exc)}, 400)

    def h_post_v2_debug_capture(self, body):
        if self.blackbox is None:
            self._send_json(
                {"error": "blackbox disabled (CLIENT_TPU_BLACKBOX=off)"},
                400)
            return
        try:
            opts = json.loads(body or b"{}")
            if not isinstance(opts, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as exc:
            self._send_json({"error": str(exc)}, 400)
            return
        self._send_json(self.blackbox.capture(
            str(opts.get("trigger") or "manual"),
            incident=opts.get("incident") or None,
            note=opts.get("note") or None))

    def h_get_v2_fleet_metrics(self, body):
        text = self.federator.metrics_text()
        self._send(200, text.encode("utf-8"),
                   headers=[("Content-Type", "text/plain; version=0.0.4")])

    # -- the proxy path ------------------------------------------------------

    def _sequence_id(self, path: str, body: bytes) -> int:
        raw = self.headers.get(SEQUENCE_ID_HEADER)
        if raw is not None:
            try:
                return int(raw)
            except ValueError:
                return 0
        # Fall back to the JSON head only when it plausibly names one and
        # arrived uncompressed (compressed callers use the header).
        if (not _INFER_PATH.match(path) or b'"sequence_id"' not in body
                or self.headers.get("Content-Encoding")):
            return 0
        header_len = self.headers.get("Inference-Header-Content-Length")
        head = body[:int(header_len)] if header_len else body
        try:
            params = json.loads(head).get("parameters") or {}
            return int(params.get("sequence_id", 0))
        except (ValueError, TypeError, AttributeError):
            return 0

    def _proxy(self, method: str, body: bytes) -> None:
        path = self.path.split("?")[0]
        stream = bool(_STREAM_PATH.match(path))
        # forward() adopts the caller's traceparent (or mints one),
        # stamps a child context downstream per attempt, and echoes
        # X-Tpu-Trace-Id on every response.
        out = self.router.forward(
            method, self.path, headers=dict(self.headers.items()),
            body=body, sequence_id=self._sequence_id(path, body),
            stream=stream)
        if out.stream is None:
            self._send(out.status, out.body, headers=out.headers)
            return
        # Streaming (SSE) pass-through: chunked transfer toward the
        # client, re-framed from the upstream read loop.
        self.send_response(out.status)
        for k, v in out.headers:
            self.send_header(k, v)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.wfile.flush()
        try:
            for piece in out.stream:
                self.wfile.write(f"{len(piece):X}\r\n".encode()
                                 + piece + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            out.stream.close()  # dead client: stop pulling upstream


class RouterHttpServer:
    """Threaded standalone router frontend over a :class:`Router`."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 8080, verbose: bool = False,
                 monitor_config: FleetMonitorConfig | None = None):
        self.router = router
        self.federator = FleetFederator(router)
        if monitor_config is None:
            monitor_config = FleetMonitorConfig.from_env()
        self.monitor = (FleetMonitor(router, monitor_config,
                                     self.federator)
                        if monitor_config is not None else None)
        # CLIENT_TPU_SELFDRIVE closes the drift loop: the monitor's
        # fleet.drift edge drives a damped, budgeted re-placement.
        self.rebalancer = None
        if self.monitor is not None and env_text(
                "CLIENT_TPU_SELFDRIVE").lower() not in ("", "0", "false",
                                                        "off"):
            # The engine package's config parser, imported only when
            # self-drive is asked for: that package loads torch.
            from client_tpu_torch.engine.selfdrive import SelfDriveConfig
            from client_tpu_torch.router.selfdrive import FleetRebalancer
            sd_cfg = SelfDriveConfig.from_env()
            if sd_cfg is not None:
                self.rebalancer = FleetRebalancer(
                    router, sd_cfg, federator=self.federator)
                self.monitor.on_drift = self.rebalancer.on_drift
        # Fleet-coordinated incident blackbox (CLIENT_TPU_BLACKBOX,
        # default ON): fleet.rebalance edges — and manual POSTs — fan
        # one incident id out to every replica plus a router bundle.
        from client_tpu_torch.observability.blackbox import BlackboxConfig
        from client_tpu_torch.router.blackbox import FleetBlackbox

        self.blackbox = None
        _bb_cfg = BlackboxConfig.from_env()
        if _bb_cfg.enabled:
            self.blackbox = FleetBlackbox(
                router, self.federator, monitor=self.monitor,
                config=_bb_cfg).install()
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"router": router, "federator": self.federator,
                        "monitor": self.monitor,
                        "rebalancer": self.rebalancer,
                        "blackbox": self.blackbox, "verbose": verbose})
        server_cls = type("_RouterHttpd", (ThreadingHTTPServer,),
                          {"request_queue_size": 128})
        self.httpd = server_cls((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"{self.httpd.server_address[0]}:{self.port}"

    def start(self) -> "RouterHttpServer":
        self.router.start()
        if self.monitor is not None:
            self.monitor.start()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="router-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self.blackbox is not None:
            self.blackbox.close()
        if self.monitor is not None:
            self.monitor.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.router.stop()
