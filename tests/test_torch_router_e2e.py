"""The port's router in front of port replica processes, end to end.

One module-scoped fleet: two ``python -m client_tpu_torch.server --device
cpu --zoo simple,simple_sequence`` processes behind the port's
``RouterHttpServer``. On it, in this order:

* the end-to-end cases of ``tests/test_fleet_obs.py`` (stitched traces,
  the failover stitch, the ``/v2/fleet/*`` endpoints), the reference's
  methods with their globals bound to the port's names, across process
  boundaries;
* a mixed fleet in both directions: the JAX router in front of the port's
  replicas, and the port's router in front of a JAX replica, each
  answering as the other's does (the same bodies, the router's headers,
  each replica's ``X-Tpu-Load``);
* sequences pinned to one replica by ``X-Sequence-Id`` affinity;
* the failover case of ``tests/test_router_e2e.py`` (a third replica
  process SIGKILLed under traffic: zero client errors, its breaker open);
* its rolling-drain case on the fleet's first replica (zero dropped, the
  process exits 0), then a drain of the last replica, refused.

The port's HTTP client drives every case.
"""

import json
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import client_tpu.router as jax_router
import client_tpu_torch.http as port_http
import test_router_e2e as ref_e2e
from client_tpu_torch import router as port_router
from client_tpu_torch.protocol import loadreport as port_lr
from client_tpu_torch.resilience import CircuitBreaker
from test_torch_fleet import FLEET_CASES, FLEET_ENV

REPO = Path(__file__).resolve().parents[1]
BOOT_TIMEOUT_S = 120.0
E2E_CLASSES = ("TestStitchedTraceE2E", "TestFailoverStitchE2E",
               "TestFleetEndpointsE2E")
E2E_CASES = [c for c in FLEET_CASES if c[0] in E2E_CLASSES]


class _PortReplica:
    """One ``python -m client_tpu_torch.server`` process on the CPU and
    its announced HTTP address."""

    def __init__(self, drain_deadline: float = 10.0):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "client_tpu_torch.server", "--zoo",
             "simple,simple_sequence", "--device", "cpu", "--http-port", "0",
             "--no-grpc", "--drain-deadline", str(drain_deadline)],
            cwd=REPO, stderr=subprocess.PIPE, text=True)
        self.url = None
        self.lines: list[str] = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append(line)
            if line.startswith("serving http at "):
                self.url = line.split("serving http at ", 1)[1].strip()

    def wait_up(self) -> "_PortReplica":
        end = time.monotonic() + BOOT_TIMEOUT_S
        while self.url is None:
            if self.proc.poll() is not None or time.monotonic() > end:
                self.kill()
                raise RuntimeError("replica did not start:\n"
                                   + "".join(self.lines))
            time.sleep(0.05)
        return self

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


@pytest.fixture(scope="module")
def fleet():
    procs = [_PortReplica(), _PortReplica()]
    for p in procs:
        p.wait_up()
    router = port_router.Router(
        [port_router.Replica(p.url, pid=p.proc.pid) for p in procs],
        breaker=CircuitBreaker(failure_threshold=3, cooldown_s=1.0),
        poll_interval_s=0.5, seed=42)
    srv = port_router.RouterHttpServer(router, port=0).start()
    yield {"procs": procs, "router": router, "srv": srv, "url": srv.url,
           "front": srv, "servers": [types.SimpleNamespace(url=p.url)
                                     for p in procs]}
    srv.stop()
    for p in procs:
        p.kill()


def _e2e(fn):
    """A test_router_e2e function on the port's client and router."""
    env = {**fn.__globals__, "httpclient": port_http,
           "Replica": port_router.Replica, "Router": port_router.Router,
           "RouterHttpServer": port_router.RouterHttpServer,
           "rolling_drain": port_router.rolling_drain,
           "CircuitBreaker": CircuitBreaker}
    for helper in ("_inputs", "_status", "_count_ok"):
        h = getattr(ref_e2e, helper)
        env[helper] = types.FunctionType(h.__code__, env, h.__name__,
                                         h.__defaults__)
    return types.FunctionType(fn.__code__, env, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def test_the_references_have_their_cases():
    assert len(E2E_CASES) == 12


@pytest.mark.parametrize("cls_name,name", E2E_CASES,
                         ids=[f"{c}.{n}" for c, n in E2E_CASES])
def test_fleet_case_across_processes(fleet, cls_name, name):
    cls = FLEET_ENV[cls_name]
    vars(cls)[name](cls(), fleet)


def _simple(url: str) -> dict:
    """One ``simple`` request with the port's client: its outputs."""
    client = port_http.InferenceServerClient(url)
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    inputs = [port_http.InferInput(n, [1, 16], "INT32") for n in
              ("INPUT0", "INPUT1")]
    for i in inputs:
        i.set_data_from_numpy(a)
    try:
        result = client.infer("simple", inputs)
        return {n: result.as_numpy(n).tolist() for n in ("OUTPUT0", "OUTPUT1")}
    finally:
        client.close()


def _raw(url: str, seq: int = 0):
    body = json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": list(range(16))} for n in ("INPUT0", "INPUT1")]}).encode()
    headers = {"Content-Type": "application/json"}
    if seq:
        headers["X-Sequence-Id"] = str(seq)
    req = urllib.request.Request(f"http://{url}/v2/models/simple/infer",
                                 data=body, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def test_the_port_client_through_the_router(fleet):
    outs = {json.dumps(_simple(fleet["url"])) for _ in range(6)}
    a = np.arange(16)
    assert outs == {json.dumps({"OUTPUT0": [(a + a).tolist()],
                                "OUTPUT1": [(a - a).tolist()]})}


@pytest.fixture(scope="module")
def jax_replica():
    """``simple`` on a JAX engine behind the JAX HTTP server."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository
    from client_tpu.server import HttpInferenceServer

    engine = TpuEngine(build_repository(["simple"]))
    server = HttpInferenceServer(engine, port=0).start()
    yield server.url
    server.stop()
    engine.shutdown()


def _front(pkg, urls):
    router = pkg.Router([pkg.Replica(u) for u in urls], seed=9,
                        poll_interval_s=3600.0)
    return pkg.RouterHttpServer(router, port=0).start()


def test_mixed_fleets_answer_alike(fleet, jax_replica):
    """JAX router over port replicas, port router over a JAX replica: each
    answers as the same-package pair does."""
    fronts = {
        "port/port": _front(port_router, [p.url for p in fleet["procs"]]),
        "jax/port": _front(jax_router, [p.url for p in fleet["procs"]]),
        "port/jax": _front(port_router, [jax_replica]),
        "jax/jax": _front(jax_router, [jax_replica]),
    }
    try:
        got = {}
        for name, front in fronts.items():
            answers = [_raw(front.url) for _ in range(4)]
            for status, headers, body in answers:
                assert status == 200, name
                assert headers["X-Tpu-Replica"] in \
                    [r.id for r in front.router.replicas], name
                assert len(headers["X-Tpu-Trace-Id"]) == 32, name
                assert port_lr.decode_header(headers["X-Tpu-Load"]), name
            got[name] = [body for _, _, body in answers]
            status = json.loads(urllib.request.urlopen(
                f"http://{front.url}/v2/router/status", timeout=30).read())
            got[name + " status"] = (sorted(status), {
                k: sorted(v) for k, v in status["replicas"].items()})
        assert got["port/port"] == got["jax/port"]
        assert got["port/jax"] == got["jax/jax"]
        assert got["port/port"] == got["port/jax"]
        assert got["port/port status"] == got["jax/port status"]
    finally:
        for front in fronts.values():
            front.stop()


def test_a_sequence_keeps_to_one_replica(fleet):
    for seq in (7, 99, 12345):
        served = {_raw(fleet["url"], seq)[1]["X-Tpu-Replica"]
                  for _ in range(6)}
        assert len(served) == 1, (seq, served)
        ids = sorted(r.id for r in fleet["router"].eligible())
        assert served == {port_router.rendezvous_pick(ids, seq)}


def test_failover_zero_client_errors(fleet):
    """The reference's failover case: a third replica process SIGKILLed
    under traffic beside the fleet's second."""
    victim = _PortReplica().wait_up()
    survivor = fleet["procs"][1]
    router = port_router.Router(
        [port_router.Replica(victim.url, pid=victim.proc.pid),
         port_router.Replica(survivor.url, pid=survivor.proc.pid)],
        breaker=CircuitBreaker(failure_threshold=3, cooldown_s=1.0),
        poll_interval_s=0.5, seed=42)
    srv = port_router.RouterHttpServer(router, port=0).start()
    try:
        _e2e(ref_e2e.test_failover_zero_client_errors)(
            {"procs": [victim, survivor], "router": router, "srv": srv,
             "url": srv.url})
    finally:
        srv.stop()
        victim.kill()


def test_rolling_drain_zero_dropped(fleet):
    """The reference's rolling-drain case on the fleet's first replica."""
    _e2e(ref_e2e.test_rolling_drain_zero_dropped)(fleet)
    assert any(line.startswith("drained") for line in
               fleet["procs"][0].lines)


def test_a_drain_of_the_last_replica_is_refused(fleet):
    last = fleet["router"].replicas[1].id
    req = urllib.request.Request(
        f"http://{fleet['url']}/v2/router/drain",
        data=json.dumps({"replicas": [last], "deadline_s": 5}).encode(),
        method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 500
    (report,) = json.loads(err.value.read())["reports"]
    assert report["outcome"] == "skipped"
    assert fleet["procs"][1].proc.poll() is None  # still serving
    assert _raw(fleet["url"])[0] == 200
