"""The port's load report against the JAX package's.

* ``encode_header``, ``decode_header``, ``to_json_dict`` and
  ``from_json_dict`` give the same bytes and the same reports as JAX's,
  over reports drawn by hypothesis and over malformed headers.
* ``TorchEngine.load_report()`` equals ``TpuEngine.load_report()`` (all
  but the wall stamp) when both serve ``simple`` idle, and again with
  every worker held on a gate around ``Model.execute_timed`` and N
  requests queued behind them; its 50 ms cache answers the same object.
* Both servers answer ``GET /v2/load`` with the report and its header
  form in ``X-Tpu-Load``, put ``X-Tpu-Load`` on every successful
  inference answer and the ``x-tpu-load`` trailer on ``ModelInfer``.
"""

import concurrent.futures
import http.client
import json
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from client_tpu.protocol import loadreport as jax_lr
from client_tpu_torch.protocol import grpc_codec
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol import grpc_stub
from client_tpu_torch.protocol import loadreport as port_lr

TIMEOUT = 60  # seconds, every wait

REPORT_FIELDS = dict(
    state=st.sampled_from(("READY", "DEGRADED", "DRAINING")),
    inflight=st.integers(0, 10_000),
    queue_depth=st.integers(0, 10_000),
    active_batches=st.integers(0, 64),
    wait_s=st.floats(0.0, 1e4, allow_nan=False),
    slo_fast_burn=st.booleans(),
    models=st.lists(st.text("abcdefgh_", min_size=1, max_size=12),
                    max_size=4).map(tuple),
    ts=st.floats(0.0, 2e9, allow_nan=False))


@settings(max_examples=300, deadline=None)
@given(**REPORT_FIELDS)
def test_encodings_equal_jax(**kw):
    port, jax = port_lr.LoadReport(**kw), jax_lr.LoadReport(**kw)
    assert port_lr.encode_header(port) == jax_lr.encode_header(jax)
    assert json.dumps(port.to_json_dict()) == json.dumps(jax.to_json_dict())
    assert port.score() == jax.score()
    assert port.draining == jax.draining
    header = jax_lr.encode_header(jax)
    got = port_lr.decode_header(header)
    want = jax_lr.decode_header(header)
    assert (vars(got) | {"ts": 0}) == (vars(want) | {"ts": 0})
    back = port_lr.LoadReport.from_json_dict(jax.to_json_dict())
    assert vars(back) == vars(jax_lr.LoadReport.from_json_dict(
        jax.to_json_dict()))


@pytest.mark.parametrize("raw", [
    None, "", "garbage", "s=UP;i=1", "i=3;q=1", "s=READY;i=x",
    "s=READY;w=-2", "s=DRAINING;f=false", "s=DEGRADED;f=1;i=2;q=;b=1",
    "s=READY;i=1;q=2;b=3;w=0.5;f=0;extra=9", " s = READY ; i = 4 "])
def test_malformed_headers_decode_as_jax(raw):
    got, want = port_lr.decode_header(raw), jax_lr.decode_header(raw)
    assert (got is None) == (want is None)
    if got is not None:
        assert (vars(got) | {"ts": 0}) == (vars(want) | {"ts": 0})


def test_the_wire_names_equal_jax():
    assert port_lr.LOAD_HEADER == jax_lr.LOAD_HEADER == "X-Tpu-Load"
    assert port_lr.LOAD_METADATA_KEY == jax_lr.LOAD_METADATA_KEY
    assert port_lr.__all__ == jax_lr.__all__


# -- engines and servers --------------------------------------------------------


@pytest.fixture
def servers():
    """``simple`` behind each package's HTTP and gRPC servers, fresh per
    test (no request has finished, so neither EWMA has a sample)."""
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
            model=engine.repository.get("simple"),
            stub=grpc_stub.GRPCInferenceServiceStub(channel))
    yield sides
    for side in sides.values():
        side.channel.close()
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _body() -> str:
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": a.ravel().tolist()} for n in ("INPUT0", "INPUT1")]})


def _request(side, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request(method, path, body,
                     {"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _report(side) -> dict:
    d = side.engine.load_report(max_age_s=0).to_json_dict()
    d.pop("ts")
    return d


class _Gate:
    """Holds every call of one model's ``execute_timed`` until opened."""

    def __init__(self, side):
        self.side, self.orig = side, side.model.execute_timed
        self.open = threading.Event()
        self.entered = 0
        self.lock = threading.Lock()
        side.model.execute_timed = self

    def __call__(self, inputs, **kw):
        with self.lock:
            self.entered += 1
        self.open.wait(TIMEOUT)
        return self.orig(inputs, **kw)

    def restore(self):
        self.open.set()
        del self.side.model.execute_timed


def _wait(cond, what: str) -> None:
    end = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.005)


def test_idle_reports_equal_jax(servers):
    got = {name: _report(side) for name, side in servers.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["state"] == "READY"
    assert got["port"]["models"] == ["simple"]
    assert got["port"]["inflight"] == got["port"]["queue_depth"] == 0


@pytest.mark.parametrize("queued", [1, 5])
def test_held_and_queued_reports_equal_jax(servers, queued):
    got = {}
    for name, side in servers.items():
        gate = _Gate(side)
        workers = side.model.config.instance_count
        pool = concurrent.futures.ThreadPoolExecutor(workers + queued)
        try:
            futs = []
            # One request per worker, each taken alone, then the queue.
            for k in range(workers):
                futs.append(pool.submit(_request, side, "POST",
                                        "/v2/models/simple/infer", _body()))
                _wait(lambda k=k: gate.entered == k + 1, f"worker {k + 1}")
            for _ in range(queued):
                futs.append(pool.submit(_request, side, "POST",
                                        "/v2/models/simple/infer", _body()))
            sched = side.engine.scheduler_for("simple")
            _wait(lambda: sched.queue.qsize() == queued, "the queue")
            got[name] = _report(side)
        finally:
            gate.restore()
            statuses = [f.result(TIMEOUT)[0] for f in futs]
            pool.shutdown()
        assert statuses == [200] * (workers + queued)
    assert got["port"] == got["jax"]
    assert got["port"]["queue_depth"] == queued
    assert got["port"]["inflight"] == \
        servers["port"].model.config.instance_count + queued
    assert got["port"]["active_batches"] == \
        servers["port"].model.config.instance_count


def test_the_report_is_cached_for_its_ttl(servers):
    engine = servers["port"].engine
    assert engine.LOAD_REPORT_TTL_S == \
        servers["jax"].engine.LOAD_REPORT_TTL_S == 0.05
    first = engine.load_report(max_age_s=0)
    assert engine.load_report(max_age_s=60) is first
    assert engine.load_report(max_age_s=0) is not first


def test_the_load_route_answers_as_jax(servers):
    got = {}
    for name, side in servers.items():
        status, headers, data = _request(side, "GET", "/v2/load")
        assert status == 200
        body = json.loads(data)
        report = port_lr.decode_header(headers["X-Tpu-Load"])
        assert report is not None and report.state == body["state"]
        assert port_lr.encode_header(port_lr.LoadReport.from_json_dict(
            body)) == headers["X-Tpu-Load"]
        body.pop("ts")
        got[name] = (body, headers["X-Tpu-Load"])
    assert got["port"] == got["jax"]


def test_every_inference_answer_carries_the_header(servers):
    got = {}
    for name, side in servers.items():
        headers = [_request(side, "POST", "/v2/models/simple/infer",
                            _body())[1] for _ in range(3)]
        decoded = [port_lr.decode_header(h.get("X-Tpu-Load"))
                   for h in headers]
        assert all(r is not None and r.state == "READY" for r in decoded)
        # The counts depend on when the cached report was built (before or
        # after the request's own accounting ended), so not compared.
        got[name] = [(r.state, r.queue_depth, r.slo_fast_burn)
                     for r in decoded]
        # A failed inference carries no report, on either server.
        status, bad, _ = _request(side, "POST", "/v2/models/nope/infer",
                                  _body())
        assert status != 200 and "X-Tpu-Load" not in bad
    assert got["port"] == got["jax"]


def test_model_infer_carries_the_trailer(servers):
    got = {}
    for name, side in servers.items():
        req = pb.ModelInferRequest(model_name="simple")
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        for n in ("INPUT0", "INPUT1"):
            req.inputs.add(name=n, datatype="INT32", shape=[1, 16])
            req.raw_input_contents.append(grpc_codec.ndarray_to_raw(
                a, "INT32"))
        _, call = side.stub.ModelInfer.with_call(req, timeout=TIMEOUT)
        trailers = dict(call.trailing_metadata() or ())
        got[name] = trailers.get(port_lr.LOAD_METADATA_KEY)
        assert port_lr.decode_header(got[name]) is not None
    assert got["port"] == got["jax"]
