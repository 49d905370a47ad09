"""The port's request tracing held against the JAX package's.

The span building, the Chrome trace-event export and ``Server-Timing``
equal the JAX package's for the same stamps (exact: they copy and format
integers). ``/v2/trace/setting`` answers GET and POST, errors included,
with the same status and body on both servers. ``/v2/trace/requests``
has the same event names, phases and argument keys per request, cold
and warm, and a ``traceparent`` comes back with its trace id on both
frontends of both servers.
"""

import http.client
import json
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from client_tpu.engine.types import RequestTimes as JaxTimes
from client_tpu.observability import tracing as jax_tracing
from client_tpu_torch.engine.types import RequestTimes as PortTimes
from client_tpu_torch.observability import tracing as port_tracing
from client_tpu_torch.protocol import grpc_codec, grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb

TIMEOUT = 60  # seconds, every wait
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = "00f067aa0ba902b7"

STAMPS = [
    {},  # rejected before anything was stamped
    {"received": 10, "queue_start": 12},
    {"received": 10, "queue_start": 12, "compute_start": 40,
     "compute_input_end": 55, "compute_infer_end": 900,
     "compute_output_end": 930},
    {"queue_start": 5, "compute_start": 5, "compute_input_end": 5,
     "compute_infer_end": 5_000_000, "compute_output_end": 5_000_100,
     "compile_ns": 4_999_000},
    {"received": 1, "queue_start": 2, "compute_start": 3,
     "compute_input_end": 2, "compute_infer_end": 9,
     "compute_output_end": 8},
]


def _ctx(mod):
    return mod.TraceContext(trace_id=TRACE, span_id="a" * 16,
                            parent_span_id=PARENT, flags=1)


def _trace(mod, times_cls, stamps, ok=True, chunks=(), error=""):
    t = mod.build_request_trace(_ctx(mod), "bert", "r7",
                                times_cls(**stamps), ok, chunks=chunks,
                                error=error)
    t.wall_time_ms = 0
    return t


@pytest.mark.parametrize("stamps", STAMPS, ids=range(len(STAMPS)))
@pytest.mark.parametrize("ok,error", [(True, ""), (False, "boom")])
def test_request_trace_and_chrome_export_equal_jax(stamps, ok, error):
    chunks = list(range(100, 100 + 300, 2))  # past MAX_CHUNK_EVENTS
    port = _trace(port_tracing, PortTimes, stamps, ok, chunks, error)
    ref = _trace(jax_tracing, JaxTimes, stamps, ok, chunks, error)
    assert port.__dict__.keys() == ref.__dict__.keys()
    assert [vars(s) for s in port.spans] == [vars(s) for s in ref.spans]
    assert (port.chunk_ts_ns, port.compile_ns, port.error) \
        == (ref.chunk_ts_ns, ref.compile_ns, ref.error)
    stores = []
    for mod, t in ((port_tracing, port), (jax_tracing, ref)):
        store = mod.TraceStore(capacity=2)
        for _ in range(3):
            store.add(t)
        stores.append((len(store), store.to_chrome_trace(),
                       store.to_chrome_trace("0" * 32),
                       store.to_chrome_trace(TRACE)))
    assert stores[0] == stores[1]


@pytest.mark.parametrize("stamps", STAMPS, ids=range(len(STAMPS)))
def test_server_timing_header_equals_jax(stamps):
    port = port_tracing.server_timing_header(PortTimes(**stamps))
    assert port == jax_tracing.server_timing_header(JaxTimes(**stamps))
    assert port_tracing.parse_server_timing(port) \
        == jax_tracing.parse_server_timing(port)


# ---------------------------------------------------------------------------
# Both servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    """Each package's engine (``simple``) behind its HTTP and gRPC servers
    on port 0."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    sides = {}
    for name, engine, http_cls, grpc_cls in (
            ("port", TorchEngine(build_repository(["simple"]), device="cpu"),
             HttpInferenceServer, GrpcInferenceServer),
            ("jax", TpuEngine(jax_build(["simple"])), JaxHttp, JaxGrpc)):
        grpc_server = grpc_cls(engine, port=0).start()
        channel = grpc.insecure_channel(grpc_server.url)
        sides[name] = SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_server, channel=channel,
            stub=grpc_stub.GRPCInferenceServiceStub(channel))
    yield sides
    for side in sides.values():
        side.engine.update_trace_setting({"trace_level": ["OFF"]})
        side.channel.close()
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _request(side, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), (
            json.loads(data) if data else None)
    finally:
        conn.close()


def _infer_body(rows):
    a = np.arange(16 * rows, dtype=np.int32).reshape(rows, 16)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [rows, 16],
         "data": a.ravel().tolist()} for n in ("INPUT0", "INPUT1")]})


def _traceparent(trace_id, span=PARENT):
    return f"00-{trace_id}-{span}-01"


def test_trace_extension_is_advertised_over_http_as_in_jax(servers):
    for side in servers.values():
        assert "trace" in _request(side, "GET", "/v2")[2]["extensions"]


def test_trace_setting_get_post_and_errors_equal_jax(servers, tmp_path):
    """The same sequence of settings on both servers: the same status and
    body at each step (one log directory for both, as each writes its own
    files)."""
    log_dir = str(tmp_path / "traces")
    other = str(tmp_path / "other")
    steps = [
        ("GET", None),
        ("POST", {"trace_level": ["TIMESTAMPS"]}),        # no log_dir: 400
        ("POST", {"trace_level": "OFF"}),                 # already off
        ("POST", {"log_dir": log_dir}),
        ("GET", None),
        ("POST", {"trace_level": ["TIMESTAMPS"]}),
        ("POST", {"log_dir": other}),                     # active: 400
        ("POST", {"trace_file": other}),                  # the alias: 400
        ("GET", None),
        ("POST", {"trace_level": ["OFF"], "log_dir": other}),
        ("POST", {}),
        ("POST", {"trace_level": ["off", ""]}),
    ]
    answers = {}
    for name, side in servers.items():
        got = []
        for method, body in steps:
            status, _, data = _request(
                side, method, "/v2/trace/setting",
                None if body is None else json.dumps(body))
            got.append((status, data))
        answers[name] = got
    assert answers["port"] == answers["jax"]
    assert [s for s, _ in answers["port"]] == [
        200, 400, 200, 200, 200, 200, 400, 400, 200, 200, 200, 200]
    assert answers["port"][1][1] == {
        "error": "trace activation requires a log_dir"}
    assert answers["port"][6][1] == {
        "error": "cannot change log_dir while a trace is active"}
    # The port's session wrote its Chrome trace where it was started.
    written = [json.loads(p.read_text())
               for p in (tmp_path / "traces").glob("trace_*.json")]
    assert len(written) == 1 and "traceEvents" in written[0]


def _events(side, trace_id):
    status, _, data = _request(
        side, "GET", f"/v2/trace/requests?trace_id={trace_id}")
    assert status == 200
    return [(e["name"], e["cat"], e["ph"], sorted(e["args"]))
            for e in data["traceEvents"]]


# Each a new bucket on both ladders (the JAX package's ``simple`` pads to
# [1, 8, 64], the port's to powers of two).
@pytest.mark.parametrize("rows", [3, 16])
def test_request_spans_equal_jax_cold_then_warm(servers, rows):
    """A request's spans: names, phases and argument keys, on a bucket's
    first (cold) execution and on a warm one."""
    got = {}
    for name, side in servers.items():
        per = []
        for i in range(2):
            trace_id = f"{rows:02d}{i:02d}" + "f" * 28
            status, headers, _ = _request(
                side, "POST", "/v2/models/simple/infer", _infer_body(rows),
                {"traceparent": _traceparent(trace_id)})
            assert status == 200
            assert headers["traceparent"].split("-")[1] == trace_id
            per.append((_events(side, trace_id),
                        sorted(port_tracing.parse_server_timing(
                            headers["Server-Timing"]))))
        got[name] = per
    assert got["port"] == got["jax"]
    cold, warm = got["port"][0][0], got["port"][1][0]
    assert [e[0] for e in warm] == ["simple:request", "queue",
                                    "compute_input", "compute_infer",
                                    "compute_output"]
    assert "compile_ms" in cold[0][3] and "compile_ms" not in warm[0][3]


def test_unknown_trace_id_and_no_filter_answer_as_jax(servers):
    for side in servers.values():
        assert _events(side, "0" * 32) == []
        status, _, data = _request(side, "GET", "/v2/trace/requests")
        assert status == 200 and data["displayTimeUnit"] == "ms"


def _grpc_request(trace=None):
    req = pb.ModelInferRequest(model_name="simple", id="g1")
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    for n in ("INPUT0", "INPUT1"):
        req.inputs.add(name=n, datatype="INT32", shape=[1, 16])
        req.raw_input_contents.append(grpc_codec.ndarray_to_raw(a, "INT32"))
    if trace:
        grpc_codec.set_param(req.parameters, "traceparent", trace)
    return req


@pytest.mark.parametrize("how", ["parameter", "metadata", "none"])
def test_grpc_traceparent_round_trip_equals_jax(servers, how):
    got = {}
    for name, side in servers.items():
        trace_id = {"parameter": "ab", "metadata": "cd", "none": "ef"}[how] \
            + name.encode().hex().ljust(30, "0")
        tp = _traceparent(trace_id)
        resp = side.stub.ModelInfer(
            _grpc_request(tp if how == "parameter" else None),
            metadata=(("traceparent", tp),) if how == "metadata" else (),
            timeout=TIMEOUT)
        params = grpc_codec.params_to_dict(resp.parameters)
        echoed = params.pop("traceparent", None)
        if how == "none":
            assert echoed is None
        else:
            assert echoed.split("-")[1] == trace_id
            assert echoed.split("-")[3] == "01"
            assert len(_events(side, trace_id)) == 5
        got[name] = sorted(params)
    assert got["port"] == got["jax"]
    if how != "none":
        assert {"server_queue_us", "server_compute_infer_us"} \
            <= set(got["port"])


def test_grpc_stream_carries_the_trace_on_the_final_response(servers):
    """On ``ModelStreamInfer`` the trace context rides as a parameter
    and comes back on the request's final response, on both servers."""
    got = {}
    for name, side in servers.items():
        trace_id = "99" + name.encode().hex().ljust(30, "0")
        req = _grpc_request(_traceparent(trace_id))
        resps = list(side.stub.ModelStreamInfer(iter([req]),
                                                timeout=TIMEOUT))
        assert len(resps) == 1 and not resps[0].error_message
        params = grpc_codec.params_to_dict(
            resps[0].infer_response.parameters)
        assert params["traceparent"].split("-")[1] == trace_id
        got[name] = sorted(params)
    assert got["port"] == got["jax"]
