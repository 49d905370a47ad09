"""The port's fault registry held against the JAX package's.

Spec parsing and its error words are equal; for the same spec and seed,
N ``fire`` calls inject on the same calls with the same kinds and
statuses (both draw from ``random.Random(seed)``, so this is exact), and
the counts render alike on each package's metric registry. On live
servers (each package's engine behind its HTTP and gRPC frontends,
serving ``simple``), every site answers with the same status and words,
and a seeded ``model.execute`` fault fails exactly the requests the
seed's draws predict, on both.
"""

import http.client
import json
import random
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from client_tpu import faults as jax_faults
from client_tpu.observability.metrics import MetricRegistry as JaxRegistry
from client_tpu_torch import faults as port_faults
from client_tpu_torch.observability.metrics import (
    MetricRegistry as PortRegistry,
)
from client_tpu_torch.protocol import grpc_codec, grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb

TIMEOUT = 60  # seconds, every wait


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared below
        return ("error", type(exc).__name__, str(exc))


GOOD_SPECS = [
    ("http.pre_read", {}),
    ("grpc.pre_infer", {"probability": 0.25, "seed": 3, "error_status": 500}),
    ("scheduler.enqueue", {"latency_ms": 1.5, "drop": True}),
    ("scheduler.dequeue", {"probability": 0, "max_injections": 2}),
    ("model.execute", {"probability": 1, "seed": -4, "error_status": "503"}),
    ("shmring.doorbell", {"max_injections": 0, "latency_ms": 0}),
]
BAD_SPECS = [
    ("http.postread", {}),
    ("", {"probability": 0.5}),
    ("model.execute", {"probability": 1.5}),
    ("model.execute", {"probability": -0.01}),
    ("model.execute", {"drop": True, "error_status": 503}),
    ("model.execute", {"latency": 3}),
    ("model.execute", {"seed": 1, "kind": "error", "status": 1}),
    ("model.execute", {"probability": "x"}),
]


@pytest.mark.parametrize("site,spec", GOOD_SPECS + BAD_SPECS,
                         ids=lambda v: json.dumps(v))
def test_spec_parsing_and_words_equal_jax(site, spec):
    def parse(mod):
        s = mod.FaultSpec.from_dict(site, dict(spec))
        return (s.site, s.probability, s.seed, s.latency_ms, s.error_status,
                s.drop, s.max_injections)

    assert _outcome(lambda: parse(port_faults)) \
        == _outcome(lambda: parse(jax_faults))


def _fires(mod, spec: dict, n: int):
    reg = mod.FaultRegistry()
    reg.configure({"model.execute": spec})
    slept = []
    out = []
    for _ in range(n):
        try:
            reg.fire("model.execute", sleep=slept.append)
            out.append(None)
        except mod.FaultInjected as exc:
            out.append((exc.site, exc.kind, exc.status, str(exc)))
    return out, slept, reg.counts()


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2**31 + 5])
@pytest.mark.parametrize("spec", [
    {"probability": 0.5, "error_status": 503},
    {"probability": 0.1, "drop": True},
    {"probability": 0.9, "latency_ms": 2.0, "error_status": 500},
    {"probability": 0.3, "latency_ms": 1.0},
    {"probability": 0.7, "error_status": 429, "max_injections": 5},
], ids=lambda s: json.dumps(s))
def test_seeded_draws_inject_on_the_same_calls_as_jax(seed, spec):
    spec = dict(spec, seed=seed)
    port = _fires(port_faults, spec, 64)
    assert port == _fires(jax_faults, spec, 64)
    # And they are the seed's Bernoulli draws.
    rng = random.Random(seed)
    budget = spec.get("max_injections")
    want = []
    for _ in range(64):
        hit = budget != 0 and rng.random() < spec["probability"]
        if hit and budget is not None:
            budget -= 1
        want.append(hit)
    terminal = "error_status" in spec or spec.get("drop")
    assert [o is not None for o in port[0]] == (
        want if terminal else [False] * 64)


def test_unarmed_site_and_reset_equal_jax():
    def run(mod):
        reg = mod.FaultRegistry()
        reg.fire("http.pre_read")
        reg.install(mod.FaultSpec("http.pre_read", error_status=503))
        first = _outcome(lambda: reg.fire("http.pre_read"))
        reg.clear()
        return first, _outcome(lambda: reg.fire("http.pre_read")), \
            reg.counts()

    assert run(port_faults) == run(jax_faults)


@pytest.mark.parametrize("raw", [
    None, "", '{"http.pre_read": {"drop": true}}',
    '{"model.execute": {"probability": 0.5, "seed": 9}}',
    '{"bogus.site": {}}', "{not json", "@FILE", "@/no/such/profile.json",
])
def test_profile_from_the_environment_equals_jax(tmp_path, raw):
    profile = tmp_path / "profile.json"
    profile.write_text('{"grpc.pre_infer": {"error_status": 500}}')
    env = {} if raw is None else {
        "CLIENT_TPU_FAULTS": raw.replace("@FILE", f"@{profile}")}

    def run(mod):
        reg = mod.FaultRegistry()
        reg.configure_from_env(env)
        return sorted((site, vars(a.spec)) for site, a in reg._active.items())

    got = _outcome(lambda: run(port_faults))
    want = _outcome(lambda: run(jax_faults))
    if want[0] == "error" and want[1] == "JSONDecodeError":
        assert got[:2] == want[:2]
    else:
        assert got == want


def test_injection_counts_render_alike_on_both_registries():
    """``tpu_fault_injections_total{site,kind}`` after the same fires, in
    both exposition formats, byte for byte."""
    renders = []
    for mod, registry_cls in ((port_faults, PortRegistry),
                              (jax_faults, JaxRegistry)):
        metrics = registry_cls()
        reg = mod.FaultRegistry()
        reg.bind_metrics(metrics)
        reg.configure({
            "http.pre_read": {"probability": 0.5, "seed": 2, "drop": True},
            "model.execute": {"probability": 0.5, "seed": 3,
                              "latency_ms": 1, "error_status": 503}})
        for site in ("http.pre_read", "model.execute") * 20:
            try:
                reg.fire(site, sleep=lambda s: None)
            except mod.FaultInjected:
                pass
        renders.append((metrics.render(), metrics.render(openmetrics=True)))
    assert renders[0] == renders[1]
    assert "tpu_fault_injections_total{site=" in renders[0][0]


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
    for name, engine, http_cls, grpc_cls, mod in (
            ("port", TorchEngine(build_repository(["simple"]), device="cpu"),
             HttpInferenceServer, GrpcInferenceServer, port_faults),
            ("jax", TpuEngine(jax_build(["simple"])), JaxHttp, JaxGrpc,
             jax_faults)):
        grpc_server = grpc_cls(engine, port=0).start()
        channel = grpc.insecure_channel(grpc_server.url)
        sides[name] = SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_server, channel=channel, faults=mod,
            stub=grpc_stub.GRPCInferenceServiceStub(channel))
    yield sides
    for side in sides.values():
        side.faults.reset()
        side.channel.close()
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


@pytest.fixture
def disarm(servers):
    yield
    for side in servers.values():
        side.faults.reset()


def _arm(servers, config):
    for side in servers.values():
        side.faults.configure(config)


def _body(rows=1):
    a = np.arange(16 * rows, dtype=np.int32).reshape(rows, 16)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [rows, 16],
         "data": a.ravel().tolist()} for n in ("INPUT0", "INPUT1")]})


def _http(side, method="POST", path="/v2/models/simple/infer", body=None):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request(method, path, _body() if body is None else body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    except (http.client.HTTPException, ConnectionError) as exc:
        return ("closed", type(exc).__name__)
    finally:
        conn.close()


def _grpc(side):
    req = pb.ModelInferRequest(model_name="simple")
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    for n in ("INPUT0", "INPUT1"):
        req.inputs.add(name=n, datatype="INT32", shape=[1, 16])
        req.raw_input_contents.append(grpc_codec.ndarray_to_raw(a, "INT32"))
    try:
        resp = side.stub.ModelInfer(req, timeout=TIMEOUT)
        return ("ok", len(resp.raw_output_contents))
    except grpc.RpcError as exc:
        return (exc.code().name, exc.details())


SITE_CASES = [
    ("http.pre_read", {"error_status": 503}),
    ("http.pre_read", {"error_status": 500, "latency_ms": 1}),
    ("http.pre_read", {"drop": True}),
    ("grpc.pre_infer", {"error_status": 503}),
    ("grpc.pre_infer", {"error_status": 429}),
    ("grpc.pre_infer", {"drop": True}),
    ("scheduler.enqueue", {"error_status": 503}),
    ("scheduler.enqueue", {"error_status": 500}),
    ("scheduler.dequeue", {"error_status": 503}),
    ("scheduler.dequeue", {"error_status": 504}),
    ("model.execute", {"error_status": 503}),
    ("model.execute", {"error_status": 500}),
]


@pytest.mark.parametrize("site,spec", SITE_CASES,
                         ids=lambda v: json.dumps(v))
def test_each_site_answers_as_jax_over_both_frontends(servers, disarm,
                                                      site, spec):
    _arm(servers, {site: spec})
    got = {name: (_http(side), _grpc(side), _http(side, "GET", "/v2"))
           for name, side in servers.items()}
    _arm(servers, {})
    assert got["port"][:2] == got["jax"][:2]
    # The metadata route answers alike once a pre_read fault is gone.
    port_md, jax_md = got["port"][2], got["jax"][2]
    if site == "http.pre_read":
        assert port_md == jax_md
    else:
        assert port_md[0] == jax_md[0] == 200
    # And the socket the drop closed is not reused: the next request
    # answers.
    assert _http(servers["port"])[0] == _http(servers["jax"])[0] == 200


def test_a_seeded_fault_fails_the_requests_the_seed_predicts(servers,
                                                            disarm):
    """``model.execute`` at probability 0.5 over 16 sequential requests:
    the failures are the draws of ``random.Random(seed)`` on both
    servers, counted on ``tpu_fault_injections_total`` and journalled."""
    from client_tpu.observability import scrape

    seed, n = 11, 16
    rng = random.Random(seed)
    want = [rng.random() < 0.5 for _ in range(n)]
    for name, side in servers.items():
        events = _http(side, "GET", "/v2/events?category=fault")[1]
        cursor = events["next_seq"]
        metrics = side.engine.prometheus_metrics()
        before = sum(v for m, lab, v in scrape.parse_samples(metrics)
                     if m == "tpu_fault_injections_total"
                     and lab == {"site": "model.execute", "kind": "error"})
        side.faults.configure({"model.execute": {
            "probability": 0.5, "seed": seed, "error_status": 503}})
        got = [_http(side) for _ in range(n)]
        side.faults.reset()
        failed = [g[0] == 503 for g in got]
        assert failed == want, name
        assert all(g[1]["error"] == "injected fault at model.execute "
                   "(error, status 503)" for g in got if g[0] == 503)
        after = sum(v for m, lab, v in scrape.parse_samples(
            side.engine.prometheus_metrics())
            if m == "tpu_fault_injections_total"
            and lab == {"site": "model.execute", "kind": "error"})
        assert after - before == sum(want), name
        new = _http(side, "GET",
                    f"/v2/events?category=fault&since={cursor}")[1]
        assert len(new["events"]) == sum(want), name
        assert all(e["name"] == "injected" and e["detail"] == {
            "site": "model.execute", "kind": "error"} for e in new["events"])
