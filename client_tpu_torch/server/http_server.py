"""HTTP/REST frontend: the KServe v2 routes this slice serves.

Counterpart of ``client_tpu/server/http_server.py``: health, server and
model metadata, model ready/config/stats, and
``POST /v2/models/<m>[/versions/<v>]/infer`` with JSON tensors and the
binary-tensor extension (head and tail split by
``Inference-Header-Content-Length``), and the generate extension:
``POST .../generate`` collects a (decoupled) model's responses into one
JSON body, ``POST .../generate_stream`` sends each as a server-sent event.
A stateful model's requests carry the ``sequence_id``, ``sequence_start``
and ``sequence_end`` parameters; a ragged input (DLRM's CSR tensors) is
sent with its own shape, no batch dimension.
An output may ask for its top-K classes (the classification extension,
``"classification": K`` in its parameters) as BYTES ``"score:index"``
strings. A malformed body or input answers 400, an unknown model 404.
The shared-memory extensions: ``/v2/{system,cuda,tpu}sharedmemory``
``[/region/<name>]/{status,register,unregister}`` (the cuda and tpu
routes both reach the engine's device regions, as in the JAX server); an
input may be read from a region and an output written into one (its
response entry then carries the ``shared_memory_*`` parameters and no
data); a region that is not registered answers 400.
A stream request with the ``response_coalesce`` parameter may get its
backlogged tokens merged into one event (``server/coalesce.py``).
``POST /v2/repository/index`` lists the repository's models, one row per
loaded version, and ``POST /v2/repository/models/<m>/{load,unload}``
loads (re-polling the repository) and unloads one (``unload_dependents``
in the body's parameters takes an ensemble's composing models with it);
``/v2/models/<m>/versions/<v>/...`` reaches each loaded version.
The observability routes: ``GET /metrics`` (OpenMetrics 1.0 when the
scraper's ``Accept`` asks for it, else the text format 0.0.4), ``GET``
and ``POST /v2/trace/setting`` (the device trace), ``GET
/v2/trace/requests[?trace_id=]`` (Chrome trace events of finished
requests), ``GET /v2/events`` (the journal, with its filters) and ``GET
/v2/profile[?model=]``. Every inference adopts the caller's
``traceparent`` (or starts a trace) and answers with it and a
``Server-Timing`` header. The ``http.pre_read`` fault site fires before
the body is read: a drop closes the connection with no answer, an error
drains the body first. The census and ledger routes: ``GET /v2/memory``
(the HBM census), ``/v2/slo``, ``/v2/costs[?model=]`` and
``/v2/timeseries`` (the flight recorder, with the events route's
filters and ``signal``).

Overload protection: a request's end-to-end deadline comes from the
``timeout-ms`` header or the ``timeout_ms`` parameter (the header wins)
and its cost-ledger tenant from ``X-Tpu-Tenant`` or the ``tenant``
parameter; ``priority`` may put it in the admission shadow class. A shed
answers 429 (503 while draining) with ``Retry-After`` and
``X-Health-State``, an expired deadline 504. ``/v2/health/ready``
answers 200 with ``{"state": ...}`` while READY or DEGRADED, 503 while
DRAINING, and the state in ``X-Health-State``; once the engine is not
ready each connection closes after its response, so that pooled clients
stop reaching a drained server. ``GET /v2/qos[?model=]`` answers the QoS
class table and each model's lane depths.

Compression, as in the JAX server: a request body sent with
``Content-Encoding: gzip`` or ``deflate`` is decoded before any route
reads it (another encoding answers 415), and an answer is gzipped or
deflated at level 1 when the client's ``Accept-Encoding`` names one. A
request sent with ``Expect: 100-continue`` gets its ``100 Continue`` at
once, flushed out of the write buffer, before the body is read.

The shm slot ring and staged datasets: ``/v2/shm/ring[/<name>]/status``,
``POST /v2/shm/ring/<name>/{register,doorbell}`` and
``/v2/shm/ring[/<name>]/unregister`` (a register body's ``spec`` makes a
reaped ring; a doorbell admits a span of filled slots, whose answers land
in the slots), and ``/v2/shm/dataset[/<name>]/{status,unregister}`` and
``POST /v2/shm/dataset/<name>/register``. The incident blackbox: ``GET
/v2/debug/bundles[/<id>]`` and ``POST /v2/debug/capture`` (body keys
``trigger``, ``incident``, ``note``). The load report: ``GET /v2/load``
(JSON, with the header form in ``X-Tpu-Load``), and ``X-Tpu-Load`` on
every successful inference answer, which the router and the multi-URL
client read.

A stdlib ThreadingHTTPServer: each connection gets a thread that only
frames; the engine's per-model schedulers batch and run the work.
"""

from __future__ import annotations

import gzip
import json
import logging
import queue
import re
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from urllib.parse import parse_qs, urlparse

from client_tpu_torch.config import env_float, env_int
from client_tpu_torch.engine.engine import TorchEngine
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
    OutputRequest,
)
from client_tpu_torch.faults import FaultInjected
from client_tpu_torch.observability.tracing import (
    TraceContext,
    server_timing_header,
)
from client_tpu_torch.protocol import rest
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.protocol.loadreport import LOAD_HEADER, encode_header
from client_tpu_torch.protocol.pushback import (
    RETRY_AFTER_HEADER,
    format_retry_after_s,
)
from client_tpu_torch.server.classification import (
    classify_output,
    output_labels,
)
from client_tpu_torch.server.coalesce import drain_run

_log = logging.getLogger("client_tpu_torch")

_MODEL = r"^/v2/models/([^/]+)(?:/versions/([^/]+))?"
_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("GET", re.compile(r"^/v2/health/live$"), "health_live"),
    ("GET", re.compile(r"^/v2/health/ready$"), "health_ready"),
    ("GET", re.compile(r"^/v2/?$"), "server_metadata"),
    ("GET", re.compile(r"^/v2/models/stats$"), "all_stats"),
    ("GET", re.compile(_MODEL + r"/ready$"), "model_ready"),
    ("GET", re.compile(_MODEL + r"/config$"), "model_config"),
    ("GET", re.compile(_MODEL + r"/stats$"), "model_stats"),
    ("GET", re.compile(_MODEL + r"$"), "model_metadata"),
    ("POST", re.compile(_MODEL + r"/infer$"), "infer"),
    ("POST", re.compile(_MODEL + r"/generate$"), "generate"),
    ("POST", re.compile(_MODEL + r"/generate_stream$"), "generate_stream"),
    ("POST", re.compile(r"^/v2/repository/index$"), "repo_index"),
    ("POST", re.compile(r"^/v2/repository/models/([^/]+)/load$"),
     "repo_load"),
    ("POST", re.compile(r"^/v2/repository/models/([^/]+)/unload$"),
     "repo_unload"),
    ("GET", re.compile(r"^/v2/(systemsharedmemory|cudasharedmemory|"
                       r"tpusharedmemory)(?:/region/([^/]+))?/status$"),
     "shm_status"),
    ("POST", re.compile(r"^/v2/(systemsharedmemory|cudasharedmemory|"
                        r"tpusharedmemory)/region/([^/]+)/register$"),
     "shm_register"),
    ("POST", re.compile(r"^/v2/(systemsharedmemory|cudasharedmemory|"
                        r"tpusharedmemory)(?:/region/([^/]+))?/unregister$"),
     "shm_unregister"),
    ("GET", re.compile(r"^/v2/shm/ring(?:/([^/]+))?/status$"), "ring_status"),
    ("POST", re.compile(r"^/v2/shm/ring/([^/]+)/register$"), "ring_register"),
    ("POST", re.compile(r"^/v2/shm/ring(?:/([^/]+))?/unregister$"),
     "ring_unregister"),
    ("POST", re.compile(r"^/v2/shm/ring/([^/]+)/doorbell$"), "ring_doorbell"),
    ("GET", re.compile(r"^/v2/shm/dataset(?:/([^/]+))?/status$"),
     "dataset_status"),
    ("POST", re.compile(r"^/v2/shm/dataset/([^/]+)/register$"),
     "dataset_register"),
    ("POST", re.compile(r"^/v2/shm/dataset(?:/([^/]+))?/unregister$"),
     "dataset_unregister"),
    ("GET", re.compile(r"^/v2/trace/setting$"), "trace_setting"),
    ("POST", re.compile(r"^/v2/trace/setting$"), "trace_update"),
    ("GET", re.compile(r"^/v2/trace/requests$"), "trace_requests"),
    ("GET", re.compile(r"^/v2/events$"), "events"),
    ("GET", re.compile(r"^/v2/profile$"), "profile"),
    ("GET", re.compile(r"^/v2/slo$"), "slo"),
    ("GET", re.compile(r"^/v2/costs$"), "costs"),
    ("GET", re.compile(r"^/v2/timeseries$"), "timeseries"),
    ("GET", re.compile(r"^/v2/memory$"), "memory"),
    ("GET", re.compile(r"^/v2/qos$"), "qos"),
    ("GET", re.compile(r"^/v2/load$"), "load"),
    ("GET", re.compile(r"^/v2/debug/bundles$"), "debug_bundles"),
    ("GET", re.compile(r"^/v2/debug/bundles/([^/]+)$"), "debug_bundle"),
    ("POST", re.compile(r"^/v2/debug/capture$"), "debug_capture"),
    ("GET", re.compile(r"^/metrics$"), "metrics"),
]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Nagle against the client's delayed ACK stalls each response ~40 ms.
    disable_nagle_algorithm = True
    wbufsize = 64 * 1024  # header and body leave in one segment
    engine: TorchEngine = None  # set on the subclass by HttpInferenceServer
    verbose = False

    def handle_expect_100(self):
        # The interim answer would sit in the buffered wfile while the
        # handler blocks reading the body the client holds back for it.
        result = super().handle_expect_100()
        self.wfile.flush()
        return result

    def log_message(self, fmt, *args):  # noqa: A003
        if self.verbose:
            super().log_message(fmt, *args)

    def _dispatch(self, method: str) -> None:
        try:
            # The fault site before any byte past the headers is read. A
            # drop closes the keep-alive socket with no answer, as a
            # server's idle timeout does; an error still drains the body,
            # whose unread bytes would prefix the next request line.
            try:
                self.engine.faults.fire("http.pre_read")
            except FaultInjected as exc:
                if exc.kind == "drop":
                    self.close_connection = True
                    return
                try:
                    if method == "POST":
                        self.rfile.read(
                            int(self.headers.get("Content-Length", 0) or 0))
                except (OSError, ValueError):
                    self.close_connection = True
                self._send_error(exc.status or 503, str(exc))
                return
            # Read the whole body first: unread bytes would prefix the next
            # request line on this keep-alive connection.
            length = int(self.headers.get("Content-Length", 0) or 0)
            self._raw_body = (self._read_body(self.rfile.read(length))
                              if method == "POST" else b"")
            path = self.path.split("?")[0]
            for m, pat, name in _ROUTES:
                match = pat.match(path) if m == method else None
                if match:
                    getattr(self, "h_" + name)(*match.groups())
                    return
            self._send_error(404, f"no route for {method} {self.path}")
        except EngineError as exc:
            self._send_error(exc.status, str(exc),
                             retry_after_s=getattr(exc, "retry_after_s",
                                                   None))
        except (ValueError, KeyError, TypeError, zlib.error,
                gzip.BadGzipFile) as exc:
            # json.JSONDecodeError and UnicodeDecodeError are ValueErrors;
            # a corrupt compressed body raises zlib's or gzip's error.
            self._send_error(400, f"malformed request: {exc!r}")
        except BrokenPipeError:
            pass
        except Exception as exc:  # noqa: BLE001 — the frontend must answer
            _log.exception("HTTP %s %s failed", method, self.path)
            self._send_error(500, f"internal error: {exc}")
        finally:
            # A drained server sheds its keep-alive connections: its
            # accept loop has stopped, and a pooled client would otherwise
            # keep reaching it through the connection it holds.
            if not self.engine.is_ready():
                self.close_connection = True

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def _read_body(self, body: bytes) -> bytes:
        """The request body decoded by its ``Content-Encoding``."""
        encoding = (self.headers.get("Content-Encoding") or "").lower()
        if encoding == "deflate":
            return zlib.decompress(body)
        if encoding == "gzip":
            return gzip.decompress(body)
        if encoding:
            raise EngineError(f"unsupported Content-Encoding '{encoding}'",
                              415)
        return body

    def _send(self, status: int, body: bytes,
              content_type: str = "application/json",
              extra_headers: dict | None = None) -> None:
        accept = (self.headers.get("Accept-Encoding") or "").lower()
        headers = dict(extra_headers or {})
        if body and "gzip" in accept:
            body = gzip.compress(body, compresslevel=1)
            headers["Content-Encoding"] = "gzip"
        elif body and "deflate" in accept:
            body = zlib.compress(body, level=1)
            headers["Content-Encoding"] = "deflate"
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json(self, obj, status: int = 200) -> None:
        self._send(status, json.dumps(obj).encode("utf-8"))

    def _send_error(self, status: int, msg: str,
                    retry_after_s: float | None = None) -> None:
        # A shed carries the server's pushback (fractional seconds, the
        # gRPC trailer's text) and names the health state it came from, so
        # that a router tells a draining server from an overloaded one.
        headers = {}
        if retry_after_s is not None:
            headers[RETRY_AFTER_HEADER] = format_retry_after_s(retry_after_s)
        if status in (429, 503):
            headers["X-Health-State"] = self.engine.health_state()
        try:
            self._send(status, json.dumps({"error": msg}).encode("utf-8"),
                       extra_headers=headers)
        except OSError:
            pass  # the peer went away

    # -- handlers -----------------------------------------------------------

    def h_health_live(self):
        self._send(200 if self.engine.is_live() else 400, b"")

    def h_health_ready(self):
        # 200 while serving (READY or DEGRADED still take work), 503 while
        # DRAINING; the state in the body and a header, for probes that
        # read no body.
        state = self.engine.health_state()
        self._send(200 if self.engine.is_ready() else 503,
                   json.dumps({"state": state}).encode("utf-8"),
                   extra_headers={"X-Health-State": state})

    def h_server_metadata(self):
        md = self.engine.server_metadata()
        # /v2/trace/setting is a route of this frontend, so only it
        # advertises the trace extension.
        md["extensions"] = list(md["extensions"]) + ["trace"]
        self._send_json(md)

    def h_model_ready(self, name, version=None):
        ready = self.engine.model_is_ready(name, version or "")
        self._send(200 if ready else 400, b"")

    def h_model_metadata(self, name, version=None):
        self._send_json(self.engine.model_metadata(name, version or ""))

    def h_model_config(self, name, version=None):
        self._send_json(self.engine.model_config(name, version or ""))

    def h_model_stats(self, name, version=None):
        self._send_json(self.engine.model_statistics(name, version or ""))

    def h_all_stats(self):
        self._send_json(self.engine.model_statistics())

    def h_repo_index(self):
        self._send_json(self.engine.repository_index())

    def _repo_parameters(self, what: str) -> dict:
        if not self._raw_body:
            return {}
        try:
            return json.loads(self._raw_body).get("parameters", {}) or {}
        except (ValueError, AttributeError):
            raise EngineError(f"malformed {what} request body", 400) from None

    def h_repo_load(self, name):
        if self._repo_parameters("load"):
            # As the gRPC frontend: a config or file override is refused,
            # never ignored in favour of the repository's own config.
            raise EngineError(
                "load parameters (config/file overrides) are not supported",
                400)
        self.engine.load_model(name)
        self._send_json({})

    def h_repo_unload(self, name):
        params = self._repo_parameters("unload")
        self.engine.unload_model(
            name, unload_dependents=bool(params.get("unload_dependents",
                                                    False)))
        self._send_json({})

    def h_infer(self, name, version=None):
        req = self._parse_infer_request(name, version)
        resp = self.engine.infer(req)
        self._send_infer_response(req, resp)

    # -- observability ----------------------------------------------------------

    OPENMETRICS_CT = ("application/openmetrics-text; version=1.0.0; "
                      "charset=utf-8")

    def _query(self) -> dict:
        return parse_qs(urlparse(self.path).query)

    def _query_readers(self):
        """(one, num): a query parameter's text, and its value cast with
        a malformed one answered 400."""
        q = self._query()

        def one(key):
            return (q.get(key) or [None])[0]

        def num(key, cast):
            raw = one(key)
            if raw is None:
                return None
            try:
                return cast(raw)
            except ValueError:
                raise EngineError(f"malformed {key!r} parameter",
                                  400) from None

        return one, num

    def h_metrics(self):
        # A scraper that accepts application/openmetrics-text gets
        # OpenMetrics 1.0 (exemplars, # EOF); any other the 0.0.4 text.
        om = "application/openmetrics-text" in (
            self.headers.get("Accept", "") or "")
        body = self.engine.prometheus_metrics(openmetrics=om)
        self._send(200, body.encode("utf-8"),
                   content_type=(self.OPENMETRICS_CT if om
                                 else "text/plain; version=0.0.4"))

    def h_events(self):
        """The journal: ``?model=`` exact, ``?severity=`` minimum,
        ``?category=``, ``?since=<seq>`` exclusive cursor (the previous
        answer's ``next_seq``), ``?since_wall=`` / ``?until_wall=`` an
        epoch-seconds window (``since_ts`` the older name of the lower
        bound), ``?limit=<n>`` the newest n."""
        one, num = self._query_readers()
        since_wall = num("since_wall", float)
        if since_wall is None:
            since_wall = num("since_ts", float)
        try:
            self._send_json(self.engine.events_export(
                model=one("model"), severity=one("severity"),
                category=one("category"), since_seq=num("since", int),
                since_ts=since_wall, until_ts=num("until_wall", float),
                limit=num("limit", int)))
        except ValueError as exc:  # an unknown severity name
            raise EngineError(str(exc), 400) from None

    def h_profile(self):
        self._send_json(self.engine.profile_snapshot(
            model=(self._query().get("model") or [None])[0]))

    def h_slo(self):
        self._send_json(self.engine.slo_snapshot())

    def h_costs(self):
        self._send_json(self.engine.costs_snapshot(
            model=(self._query().get("model") or [None])[0]))

    def h_memory(self):
        self._send_json(self.engine.memory_census())

    def h_load(self):
        """The load report (``/v2/load``), the pull form of the
        ``X-Tpu-Load`` piggyback: routers start from it and then read the
        header."""
        report = self.engine.load_report()
        self._send(200, json.dumps(report.to_json_dict()).encode("utf-8"),
                   extra_headers={LOAD_HEADER: encode_header(report)})

    def h_qos(self):
        self._send_json(self.engine.qos_snapshot(
            model=(self._query().get("model") or [None])[0]))

    def h_timeseries(self):
        """The flight recorder's ring: ``?signal=`` one signal,
        ``?model=`` narrows per-model maps, ``?since=<seq>`` exclusive
        cursor, ``?since_wall=`` / ``?until_wall=`` an epoch-seconds
        window, ``?limit=<n>`` the newest n."""
        one, num = self._query_readers()
        try:
            self._send_json(self.engine.timeseries_export(
                signal=one("signal"), model=one("model"),
                since_seq=num("since", int),
                since_wall=num("since_wall", float),
                until_wall=num("until_wall", float),
                limit=num("limit", int)))
        except ValueError as exc:  # an unknown signal name
            raise EngineError(str(exc), 400) from None

    def h_trace_setting(self):
        self._send_json(self.engine.trace_setting())

    def h_trace_update(self):
        self._send_json(self.engine.update_trace_setting(
            json.loads(self._raw_body or b"{}")))

    def h_trace_requests(self):
        self._send_json(self.engine.request_trace_export(
            (self._query().get("trace_id") or [None])[0]))

    # -- shared-memory control plane ------------------------------------------

    def _shm_manager(self, kind: str):
        return (self.engine.system_shm if kind == "systemsharedmemory"
                else self.engine.cuda_shm)

    def h_shm_status(self, kind, region=None):
        self._send_json(self._shm_manager(kind).status(region))

    def h_shm_register(self, kind, region):
        body = json.loads(self._raw_body or b"{}")
        self._shm_manager(kind).register_from_json(region, body)
        self._send_json({})

    def h_shm_unregister(self, kind, region=None):
        self._shm_manager(kind).unregister(region)
        self._send_json({})

    # -- the shm slot ring and staged datasets ---------------------------------

    def h_ring_status(self, name=None):
        self._send_json(self.engine.ring_shm.status(name))

    def h_ring_register(self, name):
        self.engine.ring_shm.register_from_json(
            name, json.loads(self._raw_body or b"{}"))
        self._send_json({})

    def h_ring_unregister(self, name=None):
        self.engine.ring_shm.unregister(name)
        self._send_json({})

    def h_ring_doorbell(self, name):
        """One POST admits a span of FILLED slots; the answers land in
        the slots, not in this response."""
        self._send_json(self.engine.ring_doorbell(
            name, json.loads(self._raw_body or b"{}")))

    def h_dataset_status(self, name=None):
        self._send_json(self.engine.staged_shm.status(name))

    def h_dataset_register(self, name):
        self.engine.staged_shm.register_from_json(
            name, json.loads(self._raw_body or b"{}"))
        self._send_json({})

    def h_dataset_unregister(self, name=None):
        self.engine.staged_shm.unregister(name)
        self._send_json({})

    # -- the incident blackbox -------------------------------------------------

    def h_debug_bundles(self):
        self._send_json(self.engine.blackbox_bundles())

    def h_debug_bundle(self, bundle_id):
        """One whole bundle (what ``tools/blackbox_report.py`` renders);
        404 for an unknown id, 400 for a malformed id or a corrupt
        file."""
        self._send_json(self.engine.blackbox_bundles(bundle_id))

    def h_debug_capture(self):
        body = json.loads(self._raw_body or b"{}")
        if not isinstance(body, dict):
            raise EngineError("request body must be a JSON object", 400)
        self._send_json(self.engine.blackbox_capture(
            str(body.get("trigger") or "manual"),
            incident=body.get("incident") or None,
            note=body.get("note") or None))

    # Stall guard of the generate routes: how long to wait for the next
    # response of a stream before cancelling it.
    GENERATE_STALL_TIMEOUT_S = 300.0

    def h_generate(self, name, version=None):
        """Non-streaming generate: every response of the request as one
        JSON array (the curl-friendly collector of the streaming route)."""
        req = self._parse_generate_request(name, version)
        out = []
        for resp in self._stream_responses(req):
            if resp.error is not None:
                raise resp.error
            if resp.final and not resp.outputs:
                continue
            out.append(self._json_response_dict(resp))
        self._send_json({"model_name": name, "responses": out})

    def h_generate_stream(self, name, version=None):
        """Server-sent events: one ``data: <v2 response JSON>`` event per
        response, in chunked transfer, ended by the final-flag response. A
        dead client cancels the request (the generative scheduler then
        frees its arena row)."""
        req = self._parse_generate_request(name, version)
        responses = self._stream_responses(req)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        self.wfile.flush()  # time to first header, not to first token

        def chunk(payload: bytes) -> None:
            self.wfile.write(f"{len(payload):X}\r\n".encode() + payload
                             + b"\r\n")
            self.wfile.flush()

        # Headers are out: every outcome stays inside the chunked body (a
        # second status line would desync the stream), and an abandoned
        # request must stop generating.
        try:
            for resp in responses:
                if resp.error is not None:
                    chunk(b"data: " + json.dumps(
                        {"error": str(resp.error)}).encode() + b"\n\n")
                    break
                if resp.outputs or not resp.final:
                    chunk(b"data: " + json.dumps(
                        self._json_response_dict(resp),
                        separators=(",", ":")).encode() + b"\n\n")
            chunk(b"")  # terminal chunk
        except (BrokenPipeError, ConnectionResetError):
            req.cancel()  # dead client: stop generating for it
        except Exception as exc:  # noqa: BLE001 — mid-stream failure
            req.cancel()
            try:
                chunk(b"data: " + json.dumps(
                    {"error": str(exc)}).encode() + b"\n\n")
                chunk(b"")
            except OSError:
                pass

    def _parse_generate_request(self, name, version) -> InferRequest:
        req = self._parse_infer_request(name, version)
        for o in req.outputs:
            if o.shm_region or o.classification_count > 0 or o.binary:
                raise EngineError(
                    "generate endpoints return JSON tensors only; output "
                    "parameters (shared memory, classification, "
                    "binary_data) are not supported", 400)
        return req

    def _stream_responses(self, req: InferRequest):
        """Submit and yield responses until the final one. A stall cancels
        the request and raises 504. A backlog past the pending limit
        (``CLIENT_TPU_STREAM_PENDING_LIMIT``) with a reader that stopped
        draining cancels it too (logged)."""
        out_q: queue.Queue = queue.Queue()
        choked = [False]
        limit = max(1, env_int("CLIENT_TPU_STREAM_PENDING_LIMIT"))
        # Progress-gated cancel: the pipelined decoder legitimately
        # delivers the waves already in flight when backpressure paused it,
        # so crossing the mark only arms the cancel; it fires when a later
        # enqueue finds the writer advanced nothing for the grace window,
        # or at 8x the mark (a memory bound if a producer ignores the
        # probe).
        progress = [0]   # responses handed to the writer
        armed = [None]   # (progress, monotonic) at the backlog crossing

        def enqueue(resp):
            out_q.put(resp)
            if choked[0]:
                return
            size = out_q.qsize()
            if size < limit:
                armed[0] = None
                return
            if size < 8 * limit:
                now = time.monotonic()
                if armed[0] is None or armed[0][0] != progress[0]:
                    armed[0] = (progress[0], now)
                    return
                if now - armed[0][1] < 0.25:
                    return
            choked[0] = True
            _log.warning(
                "generate stream backlog at %d pending responses (mark %d) "
                "with a stalled reader; cancelling request (slow consumer)",
                size, limit)
            req.cancel()

        # Flow control: decode waves pause for this stream at half the
        # cancel mark, so a slow but live reader is writer-paced (TCP
        # backpressure reaches here through the blocking chunk write) and
        # never reaches the cancel.
        bp_mark = max(1, limit // 2)
        req.backpressure = lambda: out_q.qsize() >= bp_mark
        self.engine.async_infer(req, enqueue)

        def get_nowait():
            try:
                return out_q.get_nowait()
            except queue.Empty:
                return None

        # With `response_coalesce` set, rows already backlogged behind a
        # slow chunk write merge into one [k]-row event, as on the gRPC
        # stream; off backlog every response ships alone.
        delay_s = env_float("CLIENT_TPU_STREAM_WRITER_DELAY_MS") / 1e3
        while True:
            try:
                resp = out_q.get(timeout=self.GENERATE_STALL_TIMEOUT_S)
            except queue.Empty:
                req.cancel()
                raise EngineError("generation stalled", 504) from None
            merged, leftover = drain_run(resp, get_nowait, req)
            for resp in ((merged,) if leftover is None
                         else (merged, leftover)):
                yield resp
                progress[0] += 1  # the writer took an event
                if delay_s:
                    time.sleep(delay_s)
                if resp.error is not None or resp.final:
                    return

    def _json_response_dict(self, resp: InferResponse) -> dict:
        """A v2 response head with every tensor as JSON data (SSE events
        and the collected array are text)."""
        head: dict = {"model_name": resp.model_name,
                      "model_version": str(resp.model_version)}
        if resp.request_id:
            head["id"] = resp.request_id
        if resp.parameters:
            head["parameters"] = dict(resp.parameters)
        head["outputs"] = [
            rest.build_tensor_json(out_name, arr, np_to_wire_dtype(arr.dtype),
                                   arr.shape, binary=False)[0]
            for out_name, arr in resp.outputs.items()]
        return head

    def _parse_infer_request(self, name, version) -> InferRequest:
        header_len = self.headers.get(rest.HEADER_INFERENCE_CONTENT_LENGTH)
        head, tail = rest.split_body(
            self._raw_body, int(header_len) if header_len is not None else None)
        inputs: dict[str, np.ndarray] = {}
        for wire in rest.parse_tensors(head.get("inputs", []), tail):
            p = wire.parameters
            if p.get("shared_memory_region") is not None:
                inputs[wire.name] = self.engine.read_shm_tensor(
                    p["shared_memory_region"],
                    int(p.get("shared_memory_offset", 0)),
                    int(p.get("shared_memory_byte_size", 0)),
                    wire.datatype, wire.shape)
            else:
                inputs[wire.name] = wire.to_numpy()
        params = head.get("parameters") or {}
        binary_all = bool(params.get("binary_data_output", False))
        outputs = []
        for o in head.get("outputs") or []:
            p = o.get("parameters") or {}
            outputs.append(OutputRequest(
                name=o["name"], binary=bool(p.get("binary_data", binary_all)),
                classification_count=int(p.get("classification", 0)),
                shm_region=p.get("shared_memory_region"),
                shm_offset=int(p.get("shared_memory_offset", 0)),
                shm_byte_size=int(p.get("shared_memory_byte_size", 0))))
        req = InferRequest(
            model_name=name, model_version=version or "",
            request_id=str(head.get("id", "")), inputs=inputs,
            outputs=outputs, parameters=params,
            sequence_id=int(params.get("sequence_id", 0)),
            sequence_start=bool(params.get("sequence_start", False)),
            sequence_end=bool(params.get("sequence_end", False)),
            priority=int(params.get("priority", 0)),
            # The queue policy's wait bound (the schedule_policy
            # extension's `timeout`, microseconds).
            timeout_us=int(params.get("timeout", 0)),
            # The header (transport-level, set by the clients) or the
            # parameter (survives a proxy that strips unknown headers);
            # the header wins, as timeout-ms's does below.
            tenant=str(self.headers.get("x-tpu-tenant")
                       or params.get("tenant", "") or ""),
            # Every HTTP inference is traced: the caller's W3C context is
            # adopted, or a trace starts here.
            trace=TraceContext.from_traceparent(
                self.headers.get("traceparent")))
        # The end-to-end deadline: the header holds the budget left when
        # the client sent it, so it wins over the parameter.
        timeout_ms = self.headers.get("timeout-ms") \
            or params.get("timeout_ms")
        if timeout_ms is not None:
            try:
                req.set_deadline_from_timeout_ms(float(timeout_ms))
            except (TypeError, ValueError):
                raise EngineError(
                    f"invalid timeout-ms value {timeout_ms!r}", 400) from None
        return req

    def _send_infer_response(self, req: InferRequest,
                             resp: InferResponse) -> None:
        # Binary output is opt-in per output (`binary_data`) or for every
        # unlisted output (`binary_data_output`), as in the v2 extension.
        out_req = {o.name: o for o in req.outputs}
        binary_all = bool(req.parameters.get("binary_data_output", False))
        entries = []
        for out_name, arr in resp.outputs.items():
            o = out_req.get(out_name)
            if o is not None and o.classification_count > 0:
                arr = classify_output(
                    arr, o.classification_count,
                    output_labels(self.engine, req, out_name))
            elif o is not None and o.shm_region:
                written = self.engine.write_shm_tensor(
                    o.shm_region, o.shm_offset, o.shm_byte_size, arr)
                entries.append(({
                    "name": out_name,
                    "datatype": np_to_wire_dtype(arr.dtype),
                    "shape": list(arr.shape),
                    "parameters": {
                        "shared_memory_region": o.shm_region,
                        "shared_memory_offset": o.shm_offset,
                        "shared_memory_byte_size": written}}, None))
                continue
            entries.append(rest.build_tensor_json(
                out_name, arr, np_to_wire_dtype(arr.dtype), arr.shape,
                binary=o.binary if o is not None else binary_all))
        body, jlen = rest.build_infer_response_body(
            entries, model_name=resp.model_name,
            model_version=resp.model_version, request_id=resp.request_id)
        headers = {}
        ctype = "application/json"
        if any(raw is not None for _, raw in entries):
            headers[rest.HEADER_INFERENCE_CONTENT_LENGTH] = str(jlen)
            ctype = "application/octet-stream"
        # The trace id goes back (clients look it up in
        # /v2/trace/requests) with the server's phases.
        if req.trace is not None:
            headers["traceparent"] = req.trace.to_traceparent()
        if resp.times is not None:
            headers["Server-Timing"] = server_timing_header(resp.times)
        # The load-report piggyback: each answer refreshes the caller's
        # view of this replica's load (the report is cached in the
        # engine). Telemetry never fails an inference that succeeded.
        try:
            headers[LOAD_HEADER] = encode_header(self.engine.load_report())
        except Exception:  # noqa: BLE001
            _log.debug("load report failed", exc_info=True)
        self._send(200, body, content_type=ctype, extra_headers=headers)


class HttpInferenceServer:
    """Threaded v2 REST server over a :class:`TorchEngine`."""

    def __init__(self, engine: TorchEngine, host: str = "127.0.0.1",
                 port: int = 8000, verbose: bool = False):
        handler = type("BoundHandler", (_Handler,),
                       {"engine": engine, "verbose": verbose})
        self.engine = engine
        # The default accept backlog (5) drops connections under bursts.
        server_cls = type("_Httpd", (ThreadingHTTPServer,),
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

    def start(self) -> "HttpInferenceServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
