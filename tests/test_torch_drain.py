"""Graceful drain on the port held against the JAX package.

Each package's engine (``simple``) behind its HTTP and gRPC servers, an
idle gRPC connection open and one request held in flight on a gate:
``drain()`` turns readiness off, a request on a kept-alive connection
gets the same 503, ``Retry-After``, ``X-Health-State: DRAINING`` and
words on both, ``/v2/health/ready`` answers 503 with the state, the
request in flight finishes, and the report is clean with nothing
pending, well inside the deadline (the gRPC stop is re-armed after the
engine's shutdown, so the idle connection does not hold it). Greedy
streams of a narrow ``tiny_gpt`` past their first token when a drain
begins finish token for token as the JAX package's, and a request during
the drain is refused alike. Then one in-process SIGTERM drains the
port's server with a request in flight and drops nothing.
"""

import http.client
import json
import os
import signal
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from client_tpu.admission import drain as jax_drain
from client_tpu_torch.admission import drain as port_drain
from client_tpu_torch.protocol import grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb

TIMEOUT = 60  # seconds, every wait
DEADLINE_S = 20.0


def _sides():
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
    for name, engine, http_cls, grpc_cls, drain in (
            ("port", TorchEngine(build_repository(["simple"]), device="cpu"),
             HttpInferenceServer, GrpcInferenceServer, port_drain),
            ("jax", TpuEngine(jax_build(["simple"])), JaxHttp, JaxGrpc,
             jax_drain)):
        grpc_server = grpc_cls(engine, port=0).start()
        channel = grpc.insecure_channel(grpc_server.url)
        sides[name] = SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_server, channel=channel, drain=drain,
            model=engine.repository.get("simple"),
            stub=grpc_stub.GRPCInferenceServiceStub(channel))
    return sides


def _body():
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": a.ravel().tolist()} for n in ("INPUT0", "INPUT1")]})


def _send(conn, method="POST", path="/v2/models/simple/infer"):
    conn.request(method, path, _body() if method == "POST" else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return (resp.status, resp.getheader("Retry-After"),
            resp.getheader("X-Health-State"), json.loads(resp.read() or b"{}"))


class _Hold:
    """Holds ``simple``'s executions on an event."""

    def __init__(self, model):
        self.model = model
        self.orig = model.execute_timed
        self.entered = threading.Event()
        self.release = threading.Event()
        model.execute_timed = self

    def __call__(self, inputs, **kw):
        self.entered.set()
        self.release.wait(TIMEOUT)
        return self.orig(inputs, **kw)

    def restore(self):
        self.release.set()
        del self.model.execute_timed


def _wait(cond, what):
    end = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < end, what
        time.sleep(0.005)


def _drain_with_one_in_flight(side) -> dict:
    # An idle HTTP/2 connection: one answered RPC on the channel.
    ready, call = side.stub.ServerReady.with_call(pb.ServerReadyRequest(),
                                                  timeout=TIMEOUT)
    before = (ready.ready, dict(call.trailing_metadata())["x-health-state"])
    conns = [http.client.HTTPConnection("127.0.0.1", side.http.port,
                                        timeout=TIMEOUT) for _ in range(3)]
    for c in conns:  # kept alive across the drain
        assert _send(c, "GET", "/v2/health/live")[0] == 200
    hold = _Hold(side.model)
    held, report = [], []
    try:
        t_req = threading.Thread(target=lambda: held.append(_send(conns[0])))
        t_req.start()
        assert hold.entered.wait(TIMEOUT)
        t_drain = threading.Thread(target=lambda: report.append(
            side.drain.drain(side.engine, [side.http], [side.grpc],
                             deadline_s=DEADLINE_S)))
        t_drain.start()
        _wait(lambda: not side.engine.is_ready(), "the drain began")
        shed = _send(conns[1])
        health = _send(conns[2], "GET", "/v2/health/ready")
        hold.release.set()
        t_req.join(TIMEOUT)
        t_drain.join(TIMEOUT)
    finally:
        hold.restore()
        for c in conns:
            c.close()
    return {"before": before, "held": held, "shed": shed, "health": health,
            "report": report[0]}


def test_drain_answers_as_jax_and_drops_nothing():
    sides = _sides()
    try:
        got = {name: _drain_with_one_in_flight(side)
               for name, side in sides.items()}
    finally:
        for side in sides.values():
            side.channel.close()
            side.grpc.stop(0)
            side.http.httpd.server_close()
            side.engine.shutdown()
    for name, g in got.items():
        assert g["before"] == (True, "READY"), name
        assert g["held"][0][0] == 200, name
        report = g["report"]
        assert report["clean"] and report["pending"] == 0, name
        # The gRPC stop's re-arm: the idle connection does not hold the
        # drain to its deadline.
        assert report["drain_s"] < DEADLINE_S / 4, (name, report)
    for key in ("shed", "health"):
        assert got["port"][key] == got["jax"][key]
    assert got["port"]["shed"] == (503, "1.000", "DRAINING", {
        "error": "server is draining; retry against another replica"})
    assert got["port"]["health"] == (503, None, "DRAINING",
                                     {"state": "DRAINING"})


def test_a_sigterm_drains_in_process_and_drops_nothing():
    """The handler installs from the main thread (pytest runs tests
    there); SIGTERM to this process drains the port's servers while a
    request is in flight, which finishes."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    assert threading.current_thread() is threading.main_thread()
    engine = TorchEngine(build_repository(["simple"]), device="cpu")
    http_srv = HttpInferenceServer(engine, port=0).start()
    grpc_srv = GrpcInferenceServer(engine, port=0).start()
    previous = signal.getsignal(signal.SIGTERM)
    reports = []
    hold = _Hold(engine.repository.get("simple"))
    held = []
    conn = http.client.HTTPConnection("127.0.0.1", http_srv.port,
                                      timeout=TIMEOUT)
    try:
        done = port_drain.install_sigterm_handler(
            engine, [http_srv], [grpc_srv], deadline_s=DEADLINE_S,
            on_done=reports.append)
        t_req = threading.Thread(target=lambda: held.append(_send(conn)))
        t_req.start()
        assert hold.entered.wait(TIMEOUT)
        os.kill(os.getpid(), signal.SIGTERM)
        _wait(lambda: not engine.is_ready(), "SIGTERM began the drain")
        hold.release.set()
        assert done.wait(TIMEOUT)
        t_req.join(TIMEOUT)
    finally:
        signal.signal(signal.SIGTERM, previous)
        hold.restore()
        conn.close()
        engine.shutdown()
    assert held[0][0] == 200
    assert reports[0]["clean"] and reports[0]["pending"] == 0
    assert not engine.is_live() and engine.health_state() == "DRAINING"
    events = engine.events_export(category="drain")["events"]
    assert [e["name"] for e in events][-2:] == ["begin", "end"]
    gauge = [line for line in engine.prometheus_metrics().splitlines()
             if line.startswith("tpu_drain_duration_seconds ")]
    assert float(gauge[0].split()[1]) == pytest.approx(reports[0]["drain_s"])


@pytest.mark.parametrize("argv,want", [
    (["--drain-deadline", "x"], 2), (["--no-http", "--no-grpc"], 2)])
def test_server_flags_refused(argv, want):
    from client_tpu_torch.server.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(argv + ["--device", "cpu"])
    assert exc.value.code == want


GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=64, max_streams=4)


def _streams_through_a_drain(name: str) -> tuple:
    """Three greedy streams of a narrow ``tiny_gpt`` started, each past its
    first token when the drain begins; a request during the drain is
    refused; returns the streams' tokens, the refusal and the report."""
    if name == "port":
        from client_tpu_torch.engine import InferRequest, TorchEngine
        from client_tpu_torch.engine.repository import ModelRepository
        from client_tpu_torch.models.generate import TinyGptBackend

        repo = ModelRepository()
        repo.register("tg", lambda device: TinyGptBackend(
            name="tg", attn_impl="fused", device=device, **GPT))
        engine, drain = TorchEngine(repo, device="cpu"), port_drain
    else:
        from client_tpu.engine import InferRequest, TpuEngine
        from client_tpu.engine.repository import ModelRepository
        from client_tpu.models.generate import TinyGptBackend

        repo = ModelRepository()
        repo.register_backend(TinyGptBackend(name="tg", attn_impl="fused",
                                             **GPT))
        engine, drain = TpuEngine(repo), jax_drain
    streams = []
    for prompt in ([1, 2, 3], [7] * 9, [5]):
        toks, done = [], threading.Event()

        def cb(resp, toks=toks, done=done):
            if resp.error is not None or resp.final:
                done.set()
            else:
                toks.append(int(resp.outputs["TOKEN"][0]))

        engine.async_infer(InferRequest(
            model_name="tg", inputs={"INPUT_IDS": np.asarray(prompt,
                                                             np.int32)},
            parameters={"max_tokens": 40}), cb)
        streams.append((toks, done))
    _wait(lambda: all(toks for toks, _ in streams), "first tokens")
    reports = []
    t = threading.Thread(target=lambda: reports.append(
        drain.drain(engine, deadline_s=DEADLINE_S)))
    t.start()
    _wait(lambda: not engine.is_ready(), "the drain began")
    try:
        engine.async_infer(InferRequest(
            model_name="tg", inputs={"INPUT_IDS": np.asarray([4], np.int32)},
            parameters={"max_tokens": 2}), lambda resp: None)
        refused = None
    except Exception as exc:  # noqa: BLE001 — compared below
        refused = (type(exc).__name__, str(exc), exc.status,
                   exc.retry_after_s)
    t.join(TIMEOUT)
    assert all(done.is_set() for _, done in streams)
    return [toks for toks, _ in streams], refused, reports[0]


def test_streams_in_flight_finish_through_a_drain_as_jax():
    port = _streams_through_a_drain("port")
    jax = _streams_through_a_drain("jax")
    assert port[0] == jax[0] and all(len(t) == 40 for t in port[0])
    assert port[1] == jax[1] == (
        "AdmissionError", "server is draining; retry against another "
        "replica", 503, 1.0)
    for report in (port[2], jax[2]):
        assert report["clean"] and report["pending"] == 0
