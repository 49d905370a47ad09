"""The port's admission plane held against the JAX package's.

``TokenBucket``, ``AdmissionConfig`` and ``AdmissionController`` decide
exactly alike under the same config and the same injected clock: every
admit's outcome (admitted, or the reason, ``retry_after_s`` and words),
the DEGRADED hold, the tightening walk, the journal's ``admission.*``
events, the cost ledger's shed counts and
``tpu_admission_rejections_total``. On live servers (each package's
engine behind its HTTP and gRPC frontends, serving ``simple``) a shed
answers with the same status, ``Retry-After``, ``X-Health-State`` and
words, and over gRPC the same code, details and pushback trailers; the
port's own clients with a ``RetryPolicy`` see every request succeed, and
a narrow BERT's answers under pushback (its JAX weights carried across)
stay within ``SERVED_ATOL`` of the JAX package's.
The breaker's transitions land in the journal as the JAX package's do,
and the pushback formatters write the same text.
"""

import concurrent.futures
import http.client
import json
import subprocess
import sys
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

import client_tpu.admission as jax_adm
import client_tpu.resilience as jax_res
from client_tpu.observability import costs as jax_costs
from client_tpu.observability import events as jax_events
from client_tpu.observability.metrics import EngineMetrics as JaxMetrics
from client_tpu.protocol import pushback as jax_pushback
import client_tpu_torch.admission as port_adm
import client_tpu_torch.resilience as port_res
from client_tpu_torch.observability import costs as port_costs
from client_tpu_torch.observability import events as port_events
from client_tpu_torch.observability.metrics import EngineMetrics as PortMetrics
from client_tpu_torch.protocol import grpc_codec, grpc_stub, pushback
from client_tpu_torch.protocol import grpc_service_pb2 as pb

TIMEOUT = 60  # seconds, every wait
PACKAGES = {"port": (port_adm, port_events, port_costs, PortMetrics),
            "jax": (jax_adm, jax_events, jax_costs, JaxMetrics)}


class Clock:
    """An injected monotonic clock the test advances by hand."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared below
        return ("error", type(exc).__name__, str(exc),
                getattr(exc, "status", None),
                getattr(exc, "retry_after_s", None),
                getattr(exc, "reason", None))


# -- TokenBucket ------------------------------------------------------------

BUCKET_SCRIPTS = [
    [("acquire", 1)] * 4 + [("retry", 1), ("advance", 0.25),
                            ("acquire", 1), ("available",)],
    [("acquire", 2.5), ("retry", 3), ("advance", 10), ("available",),
     ("set_rate", 0.5), ("acquire", 3), ("retry", 2), ("advance", 1),
     ("retry", 2), ("acquire", 0.5)],
    [("advance", 0.001), ("acquire", 1)] * 6 + [("set_rate", 0),
                                                ("retry", 1)],
]


@pytest.mark.parametrize("rate,burst", [(4.0, 2.0), (0.5, 0.2), (100, 30)])
@pytest.mark.parametrize("script", range(len(BUCKET_SCRIPTS)))
def test_token_bucket_equals_jax(rate, burst, script):
    def run(mod):
        clock = Clock()
        b = mod.TokenBucket(rate, burst, clock=clock)
        out = [b.burst]
        for op, *arg in BUCKET_SCRIPTS[script]:
            if op == "advance":
                clock.t += arg[0]
            elif op == "acquire":
                out.append(b.try_acquire(arg[0]))
            elif op == "retry":
                out.append(b.retry_after_s(arg[0]))
            elif op == "available":
                out.append(b.available())
            else:
                b.set_rate(arg[0])
                out.append(b.rate)
        return out

    assert run(port_adm) == run(jax_adm)


@pytest.mark.parametrize("rate", [0, -1])
def test_token_bucket_refusal_equals_jax(rate):
    assert _outcome(lambda: port_adm.TokenBucket(rate, 1)) \
        == _outcome(lambda: jax_adm.TokenBucket(rate, 1))


# -- AdmissionConfig -----------------------------------------------------------

CONFIGS = [
    {},
    {"max_queue_depth": 4, "max_estimated_wait_s": 0.02},
    {"tokens_per_s": 3, "burst": 2, "max_inflight": 2,
     "degraded_hold_s": 0.5},
    {"shadow_priority": 8, "shadow_max_inflight": 1,
     "shadow_max_queue_depth": 2, "models": {"b": {"tokens_per_s": 1}}},
    {"models": {"a": {"max_inflight": 1, "max_queue_depth": 3},
                "b": {"max_estimated_wait_s": 0.01, "burst": 4}}},
]
BAD_CONFIGS = [
    {"max_queue": 3},
    {"models": {"a": {"tokens": 1}}},
    {"models": {"a": {"max_inflight": 1}}, "qos": True},
]


@pytest.mark.parametrize("cfg", CONFIGS + BAD_CONFIGS,
                         ids=lambda c: json.dumps(c))
def test_config_parsing_equals_jax(cfg):
    def parse(mod):
        c = mod.AdmissionConfig.from_dict(json.loads(json.dumps(cfg)))
        return [vars(c)] + [vars(c.for_model(m)) for m in ("a", "b", "z")]

    assert _outcome(lambda: parse(port_adm)) \
        == _outcome(lambda: parse(jax_adm))


@pytest.mark.parametrize("raw", [None, "", '{"max_inflight": 3}', "@FILE",
                                 '{"bogus": 1}', "{not json"])
def test_config_from_the_environment_equals_jax(tmp_path, raw):
    path = tmp_path / "admission.json"
    path.write_text('{"tokens_per_s": 7, "models": {"m": {"burst": 2}}}')
    env = {} if raw is None else {
        "CLIENT_TPU_ADMISSION": raw.replace("@FILE", f"@{path}")}

    def parse(mod):
        return vars(mod.AdmissionConfig.from_env(env))

    got, want = (_outcome(lambda: parse(port_adm)),
                 _outcome(lambda: parse(jax_adm)))
    if want[0] == "error" and want[1] == "JSONDecodeError":
        assert got[:2] == want[:2]
    else:
        assert got == want


# -- AdmissionController -------------------------------------------------------


def _script(seed: int, n: int = 120) -> list:
    """A seeded stream of admits, completions and clock advances over two
    models, live and shadow priorities, growing and draining queues."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            ops.append(("admit", str(rng.choice(["a", "b"])),
                        int(rng.integers(0, 6)), int(rng.integers(1, 3)),
                        int(rng.choice([0, 0, 3, 8, 9])),
                        str(rng.choice(["", "t1", "t2"]))))
        elif r < 0.75:
            ops.append(("end", float(rng.choice([0.0, 0.004, 0.03, 0.2]))))
        elif r < 0.9:
            ops.append(("advance", float(rng.choice([0.01, 0.1, 0.4, 2.0]))))
        elif r < 0.95:
            ops.append(("tighten", str(rng.choice(["a", "b"]))))
        else:
            ops.append(("restore", str(rng.choice(["a", "b"]))))
    return ops


def _run_controller(name: str, cfg: dict, ops: list) -> dict:
    mod, events, costs, metrics_cls = PACKAGES[name]
    events.journal().clear()
    costs.reset_ledger()
    clock = Clock()
    metrics = metrics_cls()
    ctl = mod.AdmissionController(mod.AdmissionConfig.from_dict(
        json.loads(json.dumps(cfg))), metrics=metrics, clock=clock)
    for model in ("a", "b"):
        # The JAX package's gates make their buckets on the real clock
        # (the port's on the controller's): put both on the script's.
        gate = ctl._gate(model)
        if gate.bucket is not None and gate.bucket._clock is not clock:
            gate.bucket = mod.TokenBucket(gate.bucket.rate,
                                          gate.bucket.burst, clock=clock)
    open_reqs: list[tuple[str, bool]] = []
    out = []
    for op in ops:
        if op[0] == "admit":
            _, model, depth, inst, prio, tenant = op
            got = _outcome(lambda: ctl.admit(
                model, "1", queue_depth=depth, instances=inst,
                trace_id="ab" * 16, priority=prio, tenant=tenant))
            out.append(got)
            if got[0] == "ok":
                shadow = ctl.is_shadow(model, prio)
                ctl.on_request_start(model, shadow=shadow)
                open_reqs.append((model, shadow))
        elif op[0] == "end":
            if open_reqs:
                model, shadow = open_reqs.pop(0)
                ctl.on_request_end(model, op[1] or None, shadow=shadow)
        elif op[0] == "advance":
            clock.t += op[1]
        elif op[0] == "tighten":
            out.append(ctl.tighten_model(op[1], "1"))
        else:
            out.append(ctl.restore_model(op[1], "1"))
        out.append((ctl.degraded(), ctl.total_inflight(),
                    ctl.inflight("a"), ctl.estimated_service_s("b")))
    journal = [(e["category"], e["name"], e["severity"], e.get("model"),
                e.get("version"), e.get("trace_id"), e.get("detail"))
               for e in events.journal().export()["events"]]
    sheds = {t: row["interference"]["admission_sheds"] for t, row in
             costs.ledger().snapshot()["tenants"].items()}
    rendered = [line for line in metrics.render().splitlines()
                if line.startswith("tpu_admission_rejections_total")]
    return {"out": out, "count": ctl.rejection_count, "journal": journal,
            "sheds": sheds, "metrics": rendered}


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: json.dumps(c))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_decides_as_jax(cfg, seed):
    ops = _script(seed)
    port = _run_controller("port", cfg, ops)
    jax = _run_controller("jax", cfg, ops)
    assert port == jax
    if cfg:
        assert port["count"] > 0  # the script reached the gates


@pytest.mark.parametrize("cap", [0.0, 1e-9, 15.0, 45.0, float("inf")])
def test_retry_after_clip_equals_jax(cap):
    def make(mod):
        exc = mod.AdmissionError("x", retry_after_s=cap)
        return exc.retry_after_s, exc.status, exc.reason

    assert make(port_adm) == make(jax_adm)
    assert port_adm.MIN_RETRY_AFTER_S <= make(port_adm)[0] \
        <= port_adm.MAX_RETRY_AFTER_S


# -- pushback formatting --------------------------------------------------------


@pytest.mark.parametrize("seconds", [-1, 0, 0.0004, 0.0005, 0.01, 0.0125,
                                     1.23456, 30.0])
def test_pushback_formatting_equals_jax(seconds):
    assert pushback.format_retry_after_s(seconds) \
        == jax_pushback.format_retry_after_s(seconds)
    assert pushback.format_retry_pushback_ms(seconds) \
        == jax_pushback.format_retry_pushback_ms(seconds)


# -- the breaker's journal ------------------------------------------------------


def test_breaker_transitions_are_journalled_as_jax():
    def walk(res, events):
        events.journal().clear()
        clock = Clock()
        br = res.CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                                clock=clock)
        for _ in range(2):
            br.record_failure("h:1", trace_id="cd" * 16)
        clock.t += 1.5
        br.check("h:1", trace_id="ef" * 16)
        br.record_failure("h:1")
        clock.t += 1.5
        br.check("h:1")
        br.record_success("h:1")
        return [(e["category"], e["name"], e["severity"], e.get("trace_id"),
                 e.get("detail"))
                for e in events.journal().export()["events"]]

    got = walk(port_res, port_events)
    assert got == walk(jax_res, jax_events)
    assert [e[1] for e in got] == ["open", "half_open", "open",
                                   "half_open", "closed"]


def test_the_new_modules_load_no_torch():
    """The clients' ops messages and the planes a client-side tool may
    read load no framework."""
    code = (
        "import sys\n"
        "import client_tpu_torch.protocol.ops_pb2\n"
        "import client_tpu_torch.protocol.grpc_stub\n"
        "import client_tpu_torch.observability.costs\n"
        "import client_tpu_torch.observability.slo\n"
        "import client_tpu_torch.observability.timeseries\n"
        "import client_tpu_torch.observability.memory\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'client_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# Both servers
# ---------------------------------------------------------------------------

# `simple` admits one request, then sheds for ~1,000 s (clipped to 30).
SERVER_ADMISSION = {"models": {"simple": {"tokens_per_s": 0.001,
                                          "burst": 1}},
                    "shadow_priority": 8}


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

    def admission(mod):
        return mod.AdmissionController(
            mod.AdmissionConfig.from_dict(json.loads(json.dumps(
                SERVER_ADMISSION))))

    sides = {}
    for name, engine, http_cls, grpc_cls in (
            ("port", TorchEngine(build_repository(["simple"]), device="cpu",
                                 admission=admission(port_adm)),
             HttpInferenceServer, GrpcInferenceServer),
            ("jax", TpuEngine(jax_build(["simple"]),
                              admission=admission(jax_adm)),
             JaxHttp, JaxGrpc)):
        grpc_server = grpc_cls(engine, port=0).start()
        channel = grpc.insecure_channel(grpc_server.url)
        sides[name] = SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_server, channel=channel,
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


def _http(side, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request("POST", "/v2/models/simple/infer", body,
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Retry-After"),
                resp.getheader("X-Health-State"), json.loads(resp.read()))
    finally:
        conn.close()


def _grpc(side, params=None):
    req = pb.ModelInferRequest(model_name="simple")
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    for n in ("INPUT0", "INPUT1"):
        req.inputs.add(name=n, datatype="INT32", shape=[1, 16])
        req.raw_input_contents.append(grpc_codec.ndarray_to_raw(a, "INT32"))
    for k, v in (params or {}).items():
        grpc_codec.set_param(req.parameters, k, v)
    try:
        side.stub.ModelInfer(req, timeout=TIMEOUT)
        return ("OK",)
    except grpc.RpcError as exc:
        trailers = dict(exc.trailing_metadata() or ())
        return (exc.code().name, exc.details(), trailers.get("retry-after"),
                trailers.get("retry-pushback-ms"))


def test_a_shed_answers_as_jax_on_both_frontends(servers):
    got = {}
    for name, side in servers.items():
        first = _http(side, _body())
        shed = _http(side, _body(), {"X-Tpu-Tenant": "alice"})
        got[name] = (first[0], shed, _grpc(side),
                     _grpc(side, {"tenant": "bob", "priority": 9}))
    assert got["port"] == got["jax"]
    _, shed, rpc, shadow = got["port"]
    assert shed == (429, "30.000", "DEGRADED", {
        "error": "model 'simple' request rate exceeds 0.001/s (burst 1)"})
    assert rpc[0] == "RESOURCE_EXHAUSTED" and rpc[2:] == ("30.000", "30000")
    assert shadow == rpc
    # The shed's tenants and reasons on each /metrics.
    for name, side in servers.items():
        lines = {line.split(" ")[0] for line in
                 side.engine.prometheus_metrics().splitlines()
                 if line.startswith("tpu_admission_rejections_total{")}
        assert {'tpu_admission_rejections_total{model="simple",version='
                f'"latest",reason="throttled",tenant="{t}"}}'
                for t in ("alice", "default", "bob")} <= lines, name


def test_health_reads_degraded_after_a_shed_on_both(servers):
    for side in servers.values():
        _http(side, _body())  # shed (the bucket is empty)
    states = {}
    for name, side in servers.items():
        conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/v2/health/ready")
        resp = conn.getresponse()
        states[name] = (resp.status, resp.getheader("X-Health-State"),
                        json.loads(resp.read()))
        conn.close()
        resp, call = side.stub.ServerReady.with_call(pb.ServerReadyRequest(),
                                                     timeout=TIMEOUT)
        states[name] += (resp.ready,
                         dict(call.trailing_metadata())["x-health-state"])
    assert states["port"] == states["jax"] == (
        200, "DEGRADED", {"state": "DEGRADED"}, True, "DEGRADED")


# -- the port's clients ride out the pushback ----------------------------------


@pytest.fixture
def throttled():
    """The port on the CPU behind both frontends, ``simple`` admitted at
    5 requests/s with a burst of 1: a request following another within
    200 ms is shed."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    engine = TorchEngine(build_repository(["simple"]), device="cpu",
                         admission=port_adm.AdmissionController(
                             port_adm.AdmissionConfig(models={"simple": {
                                 "tokens_per_s": 5, "burst": 1}})))
    http_srv = HttpInferenceServer(engine, port=0).start()
    grpc_srv = GrpcInferenceServer(engine, port=0).start()
    yield SimpleNamespace(engine=engine, http=http_srv, grpc=grpc_srv)
    grpc_srv.stop()
    http_srv.stop()
    engine.shutdown()


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_the_port_clients_ride_out_the_pushback(throttled, wire):
    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.http as httpclient

    mod = httpclient if wire == "http" else grpcclient
    url = (throttled.http.url if wire == "http" else throttled.grpc.url)
    client = mod.InferenceServerClient(
        url, retry_policy=port_res.RetryPolicy(max_attempts=20, seed=1))
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    try:
        for _ in range(4):
            inputs = [mod.InferInput(n, [1, 16], "INT32")
                      for n in ("INPUT0", "INPUT1")]
            for i in inputs:
                i.set_data_from_numpy(a)
            result = client.infer("simple", inputs)
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + a)
        retries = client.get_infer_stat()["retry_count"]
    finally:
        client.close()
    sheds = throttled.engine.admission.rejection_count
    assert sheds > 0 and retries == sheds


# -- a computing model under pushback, on both packages -----------------------

BERT = dict(seq_len=32, hidden=64, n_layers=2, n_heads=2, ffn=128,
            vocab=256, max_batch_size=4)
# Served BERT outputs, the port's against the JAX package's: the
# tolerance chip_smoke.py holds served BERT answers to (SERVED_ATOL). The
# two packages batch the concurrent requests into other bucket shapes
# (JAX's ladder is [1, 8, ...], the port's powers of two), so each row's
# bf16 GEMMs round differently; tests/test_torch_bert.py's 2e-2 is for
# one fixed batch.
SERVED_ATOL = 6e-2


@pytest.fixture(scope="module")
def bert_servers():
    """A 2-layer narrow BERT on each package (the JAX weights carried to
    the port), admitted at 40 requests/s with a burst of 1, behind both
    frontends."""
    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepo
    from client_tpu.models.bert import BertBackend as JaxBert
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models.bert import BertBackend
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    cfg = {"models": {"bert_a": {"tokens_per_s": 40, "burst": 1}}}
    jr = JaxRepo()
    jr.register("bert_a", lambda: JaxBert(name="bert_a", **BERT))
    jax_engine = TpuEngine(jr, admission=jax_adm.AdmissionController(
        jax_adm.AdmissionConfig.from_dict(json.loads(json.dumps(cfg)))))
    tree = jax_engine.repository.get("bert_a")._params

    def bert(device):
        b = BertBackend(name="bert_a", device=device, **BERT)
        b.load_jax_params(tree)
        return b

    pr = ModelRepository()
    pr.register("bert_a", bert)
    port_engine = TorchEngine(pr, device="cpu",
                              admission=port_adm.AdmissionController(
                                  port_adm.AdmissionConfig.from_dict(
                                      json.loads(json.dumps(cfg)))))
    sides = {}
    for name, engine, http_cls, grpc_cls in (
            ("port", port_engine, HttpInferenceServer, GrpcInferenceServer),
            ("jax", jax_engine, JaxHttp, JaxGrpc)):
        sides[name] = SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_cls(engine, port=0).start())
    yield sides
    for side in sides.values():
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_pushed_back_answers_equal_jax(bert_servers, wire):
    """Six requests at once per package through the port's client with a
    ``RetryPolicy``: every one answered after the pushback, and the
    port's answers within ``SERVED_ATOL`` of the JAX package's."""
    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.http as httpclient

    mod = httpclient if wire == "http" else grpcclient
    rng = np.random.default_rng(9)
    feeds = []
    for _ in range(6):
        ids = rng.integers(0, BERT["vocab"], (1, BERT["seq_len"])
                           ).astype(np.int32)
        mask = np.ones_like(ids)
        mask[0, rng.integers(4, BERT["seq_len"]):] = 0
        feeds.append((ids, mask))
    got = {}
    for name, side in bert_servers.items():
        server = side.http if wire == "http" else side.grpc
        kwargs = {"concurrency": 6} if wire == "http" else {}
        client = mod.InferenceServerClient(
            server.url, retry_policy=port_res.RetryPolicy(
                max_attempts=40, seed=2), **kwargs)
        sheds = side.engine.admission.rejection_count

        def one(feed, client=client):
            inputs = [mod.InferInput("input_ids", [1, BERT["seq_len"]],
                                     "INT32"),
                      mod.InferInput("attention_mask", [1, BERT["seq_len"]],
                                     "INT32")]
            inputs[0].set_data_from_numpy(feed[0])
            inputs[1].set_data_from_numpy(feed[1])
            result = client.infer("bert_a", inputs)
            return {n: result.as_numpy(n) for n in ("pooled_output",
                                                     "logits")}

        try:
            with concurrent.futures.ThreadPoolExecutor(6) as pool:
                got[name] = list(pool.map(one, feeds))
        finally:
            client.close()
        assert side.engine.admission.rejection_count > sheds, name
    for port_out, jax_out in zip(got["port"], got["jax"]):
        for n in ("pooled_output", "logits"):
            np.testing.assert_allclose(port_out[n], jax_out[n],
                                       atol=SERVED_ATOL, rtol=0)
