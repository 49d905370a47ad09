"""End-to-end deadlines on the port held against the JAX package.

A request's budget (the ``timeout-ms`` header or ``timeout_ms`` parameter
over HTTP, the parameter or the RPC deadline over gRPC) becomes its
deadline. Past it the request fails with 504 / DEADLINE_EXCEEDED at the
stage that caught it, with the same words on both packages' servers:
at admission, in the queue (the workers held on a gate, so the request
waits there while its budget runs out), and at the backstop in
``Model.execute_timed`` (the batch's budget lapses after the dispatch
filter), each counted on ``tpu_deadline_expirations_total{stage}`` and
journalled as ``deadline.expired``. An expired batch runs no forward.
"""

import http.client
import json
import re
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from client_tpu.engine import types as jax_types
from client_tpu_torch.engine import types as port_types
from client_tpu_torch.protocol import grpc_codec, grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb

TIMEOUT = 60  # seconds, every wait


@pytest.mark.parametrize("timeout_ms", [-5, 0, 0.5, 250, 1e6])
def test_request_deadline_fields_equal_jax(timeout_ms):
    def run(mod):
        req = mod.InferRequest(model_name="m", inputs={})
        before = req.deadline_remaining_s()
        req.set_deadline_from_timeout_ms(timeout_ms)
        armed = req.deadline_ns > 0
        late = req.deadline_ns + 1 if armed else 1 << 62
        return (before, armed, req.deadline_expired(now=0),
                req.deadline_expired(now=late),
                (req.deadline_remaining_s() or 0) <= timeout_ms / 1e3)

    assert run(port_types) == run(jax_types)


def test_deadline_expired_error_equals_jax():
    a = port_types.DeadlineExpired("late")
    b = jax_types.DeadlineExpired("late")
    assert (str(a), a.status, isinstance(a, port_types.EngineError)) \
        == (str(b), b.status, isinstance(b, jax_types.EngineError))


# ---------------------------------------------------------------------------
# Both servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
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
    for name, engine, http_cls, grpc_cls, types in (
            ("port", TorchEngine(build_repository(["simple"]), device="cpu"),
             HttpInferenceServer, GrpcInferenceServer, port_types),
            ("jax", TpuEngine(jax_build(["simple"])), JaxHttp, JaxGrpc,
             jax_types)):
        grpc_server = grpc_cls(engine, port=0).start()
        channel = grpc.insecure_channel(grpc_server.url)
        sides[name] = SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_server, channel=channel, types=types,
            model=engine.repository.get("simple"),
            sched=engine.scheduler_for("simple"),
            stub=grpc_stub.GRPCInferenceServiceStub(channel))
    yield sides
    for side in sides.values():
        side.channel.close()
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _body(params=None):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": a.ravel().tolist()} for n in ("INPUT0", "INPUT1")],
        "parameters": params or {}})


def _http(side, headers=None, params=None):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request("POST", "/v2/models/simple/infer", _body(params),
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _grpc(side, params=None, timeout=TIMEOUT):
    req = pb.ModelInferRequest(model_name="simple")
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    for n in ("INPUT0", "INPUT1"):
        req.inputs.add(name=n, datatype="INT32", shape=[1, 16])
        req.raw_input_contents.append(grpc_codec.ndarray_to_raw(a, "INT32"))
    for k, v in (params or {}).items():
        grpc_codec.set_param(req.parameters, k, v)
    try:
        side.stub.ModelInfer(req, timeout=timeout)
        return ("OK",)
    except grpc.RpcError as exc:
        return (exc.code().name, exc.details())


def _masked(outcome):
    """A queue expiry names how long it waited: mask the milliseconds."""
    return json.loads(re.sub(r"waited [0-9.]+ms", "waited <t>ms",
                             json.dumps(outcome)))


def _stage_counts(side) -> dict:
    out = {}
    for line in side.engine.prometheus_metrics().splitlines():
        if line.startswith("tpu_deadline_expirations_total{"):
            stage = re.search(r'stage="([a-z]+)"', line).group(1)
            out[stage] = out.get(stage, 0) + float(line.rsplit(" ", 1)[1])
    return out


def _expired_events(side, cursor: int) -> list:
    snap = side.engine.events_export(category="deadline", since_seq=cursor)
    return [(e["name"], e["detail"]["stage"]) for e in snap["events"]]


def _cursor(side) -> int:
    return side.engine.events_export(category="deadline")["next_seq"]


def test_expired_at_admission_answers_as_jax(servers):
    got = {}
    for name, side in servers.items():
        before, cursor = _stage_counts(side), _cursor(side)
        got[name] = (_http(side, {"timeout-ms": "0.000001"}),
                     _http(side, params={"timeout_ms": 1e-6}),
                     _grpc(side, {"timeout_ms": 1e-6}),
                     _http(side, {"timeout-ms": "soon"}))
        after = _stage_counts(side)
        assert after.get("admission", 0) - before.get("admission", 0) == 3
        assert _expired_events(side, cursor) == [("expired", "admission")] * 3
    assert got["port"] == got["jax"]
    assert got["port"][0] == (504, {
        "error": "end-to-end deadline expired before admission"})
    assert got["port"][2][0] == "DEADLINE_EXCEEDED"
    assert got["port"][3] == (400, {
        "error": "invalid timeout-ms value 'soon'"})


class _Gate:
    """Wraps one model's ``execute_timed``: every call blocks until the
    gate opens (``hold``), or first waits out its batch's deadline
    (``lapse``)."""

    def __init__(self, side, mode: str):
        self.side, self.mode = side, mode
        self.orig = side.model.execute_timed
        self.open = threading.Event()
        self.entered = 0
        self.lock = threading.Lock()
        side.model.execute_timed = self

    def __call__(self, inputs, **kw):
        with self.lock:
            self.entered += 1
        if self.mode == "hold":
            self.open.wait(TIMEOUT)
        else:
            deadline = kw.get("deadline_ns", 0)
            while deadline and self.side.types.now_ns() < deadline:
                time.sleep(0.001)
        return self.orig(inputs, **kw)

    def restore(self):
        self.open.set()
        del self.side.model.execute_timed  # the class's method again


def _wait(cond, what):
    end = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < end, what
        time.sleep(0.002)


def test_expired_in_the_queue_answers_as_jax(servers):
    """Every worker of ``simple`` held at the gate, a request with a 300 ms
    budget waits in the queue past it; released, a worker pops it and
    fails it with 504 before it runs."""
    got = {}
    for name, side in servers.items():
        workers = len(side.sched.workers)
        before, cursor = _stage_counts(side), _cursor(side)
        gate = _Gate(side, "hold")
        try:
            held = []
            for i in range(workers):
                t = threading.Thread(target=lambda: held.append(_http(side)))
                t.start()
                held.append(t)
                _wait(lambda: gate.entered == i + 1, f"{name}: worker {i}")
            results = {}
            late = [threading.Thread(target=lambda: results.update(
                        http=_http(side, {"timeout-ms": "300"}))),
                    threading.Thread(target=lambda: results.update(
                        grpc=_grpc(side, {"timeout_ms": 300})))]
            for t in late:
                t.start()
            _wait(lambda: side.sched.queue.qsize() == 2,
                  f"{name}: the late requests queued")
            time.sleep(0.4)  # their budgets run out while they wait
            gate.open.set()
            for t in late + [t for t in held if isinstance(t, threading.Thread)]:
                t.join(TIMEOUT)
        finally:
            gate.restore()
        assert sorted(r[0] for r in held if isinstance(r, tuple)) \
            == [200] * workers
        after = _stage_counts(side)
        assert after.get("queue", 0) - before.get("queue", 0) == 2, name
        assert _expired_events(side, cursor) == [("expired", "queue")] * 2
        got[name] = _masked([results["http"], results["grpc"]])
    assert got["port"] == got["jax"]
    assert got["port"][0] == [504, {
        "error": "end-to-end deadline expired before queue (waited <t>ms "
                 "in queue)"}]
    assert got["port"][1][0] == "DEADLINE_EXCEEDED"


def test_expired_at_the_backstop_answers_as_jax(servers):
    """The batch's budget lapses after the dispatch filter: the check in
    ``Model.execute_timed`` fails it before anything is staged, and the
    port's backend runs no forward."""
    port_backend = servers["port"].model.backend
    forwards = []
    orig_forward = port_backend.forward
    port_backend.forward = lambda *a, **k: forwards.append(1) or \
        orig_forward(*a, **k)
    got = {}
    try:
        for name, side in servers.items():
            before, cursor = _stage_counts(side), _cursor(side)
            gate = _Gate(side, "lapse")
            try:
                # Budget enough to pass the dequeue and dispatch checks
                # of a loaded machine; the gate then waits it out.
                got[name] = (_http(side, {"timeout-ms": "300"}),
                             _grpc(side, {"timeout_ms": 300}))
            finally:
                gate.restore()
            after = _stage_counts(side)
            assert after.get("execute", 0) - before.get("execute", 0) == 2
            assert _expired_events(side, cursor) == [("expired",
                                                      "execute")] * 2
        expired_forwards = list(forwards)
        # A request with budget to spare runs.
        assert _http(servers["port"], {"timeout-ms": "60000"})[0] == 200
    finally:
        port_backend.forward = orig_forward
    assert got["port"] == got["jax"]
    assert got["port"][0] == (504, {
        "error": "end-to-end deadline expired before execution of model "
                 "'simple'"})
    assert got["port"][1] == ("DEADLINE_EXCEEDED", "end-to-end deadline "
                              "expired before execution of model 'simple'")
    assert expired_forwards == [] and forwards == [1]


def test_the_rpc_deadline_becomes_the_request_deadline(servers):
    """Over gRPC the RPC's own deadline is the budget: a generous one
    runs; the parameter wins over it."""
    for side in servers.values():
        assert _grpc(side, timeout=30) == ("OK",)
        assert _grpc(side, {"timeout_ms": 1e-6}, timeout=30)[0] \
            == "DEADLINE_EXCEEDED"


def test_model_backstop_in_process_equals_jax(servers):
    """``execute_timed`` with a deadline already past raises the same
    ``DeadlineExpired`` on both, and runs nothing."""
    inputs = {n: np.arange(16, dtype=np.int32).reshape(1, 16)
              for n in ("INPUT0", "INPUT1")}
    got = {}
    for name, side in servers.items():
        past = side.types.now_ns() - 1
        try:
            side.model.execute_timed(inputs, batch_size=1, deadline_ns=past)
            got[name] = None
        except side.types.DeadlineExpired as exc:
            got[name] = (str(exc), exc.status)
    assert got["port"] == got["jax"] == (
        "end-to-end deadline expired before execution of model 'simple'",
        504)


@pytest.mark.parametrize("remaining", [None, 30.0, 0.0, -0.5])
def test_the_rpc_deadline_arms_the_request(servers, remaining):
    """``context.time_remaining()`` becomes the deadline as the JAX
    server makes it; where it has already run out the port expires the
    request (JAX serves it as if it had none)."""
    from client_tpu.server import grpc_server as jax_grpc
    from client_tpu_torch.server import grpc_server as port_grpc

    context = SimpleNamespace(time_remaining=lambda: remaining)
    request = pb.ModelInferRequest(model_name="simple")
    got = {}
    for name, mod in (("port", port_grpc), ("jax", jax_grpc)):
        req = mod._proto_to_request(servers[name].engine, request, context)
        got[name] = (req.deadline_ns > 0, req.deadline_expired())
    if remaining is None or remaining > 0:
        assert got["port"] == got["jax"] == (remaining is not None, False)
    else:
        assert got == {"port": (True, True), "jax": (False, False)}
