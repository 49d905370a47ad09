"""Model control on the port: load, unload and reload, held against the
JAX package.

Each case runs the same calls on a port engine (``device="cpu"``) and a
JAX engine, directly or behind each package's HTTP and gRPC servers, and
compares codes and words: load, unload and reload (``tests/test_engine.py``
``test_load_unload``, ``tests/test_http_e2e.py`` and
``tests/test_grpc_e2e.py``'s repository cases), statistics across a
reload, ``unload_dependents`` with a composing model two ensembles share,
a request that races an unload (503, never stranded:
``test_request_racing_unload_gets_503_not_stranded``, here for every
scheduler kind), generation streams open when their model unloads, the
row cache on reload (``tests/test_dlrm.py``), and the load-parameter and
malformed-body errors. The port alone: after an unload nothing keeps the
model's backend alive (a weak reference to it dies), for every scheduler
kind, which on the card means its memory is given back. Every wait has
its own time limit.
"""

import gc
import http.client
import json
import threading
import weakref
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.protocol import grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb

TIMEOUT = 60  # seconds, every request
WAIT_S = 10   # seconds a caller may wait for its answer around an unload
GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=32, max_streams=4)
A = np.arange(16, dtype=np.int32).reshape(1, 16)
B = np.full((1, 16), 3, np.int32)


# -- building both sides ----------------------------------------------------------

def _ensemble_configs(mod, steps_of: dict):
    """``name -> ModelConfig`` of ensembles over ``simple``-shaped models,
    in ``mod`` (either package's ``engine.config``)."""
    out = {}
    for name, steps in steps_of.items():
        out[name] = mod.ModelConfig(
            name=name, platform="ensemble", max_batch_size=8,
            input=[mod.TensorConfig("A", "INT32", [16]),
                   mod.TensorConfig("B", "INT32", [16])],
            output=[mod.TensorConfig("S", "INT32", [16])],
            ensemble_scheduling=[mod.EnsembleStep(
                model_name=m, input_map=dict(i), output_map=dict(o))
                for m, i, o in steps])
    return out


# ens_a and ens_b both run simple, then simple_b on its outputs: S = 2 * A.
ENSEMBLES = {
    "ens_a": [("simple", {"INPUT0": "A", "INPUT1": "B"},
               {"OUTPUT0": "_s", "OUTPUT1": "_d"}),
              ("simple_b", {"INPUT0": "_s", "INPUT1": "_d"},
               {"OUTPUT0": "S"})],
    "ens_b": [("simple", {"INPUT0": "A", "INPUT1": "B"},
               {"OUTPUT0": "_s2", "OUTPUT1": "_d2"}),
              ("simple_b", {"INPUT0": "_s2", "INPUT1": "_d2"},
               {"OUTPUT0": "S"})],
}


def _port_repo(names, ensembles=()):
    from client_tpu_torch.engine import config as torch_config
    from client_tpu_torch.engine.repository import ConfigOnlyBackend
    from client_tpu_torch.models import _REGISTRY, _import_all
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.models.simple import AddSubBackend

    _import_all()
    repo = ModelRepository()
    for name in names:
        if name == "tg":
            repo.register("tg", lambda device: TinyGptBackend(
                name="tg", device=device, **GPT))
        elif name == "simple_b":
            repo.register("simple_b", lambda device: AddSubBackend(
                name="simple_b"))
        else:
            repo.register(name, _REGISTRY[name])
    for name, cfg in _ensemble_configs(
            torch_config, {n: ENSEMBLES[n] for n in ensembles}).items():
        repo.register(name, lambda device, cfg=cfg: ConfigOnlyBackend(cfg))
    return repo


def _jax_repo(names, ensembles=()):
    from client_tpu.engine import config as jax_config
    from client_tpu.engine.repository import ConfigOnlyBackend
    from client_tpu.models import _REGISTRY, _import_all
    from client_tpu.models.generate import TinyGptBackend
    from client_tpu.models.simple import AddSubBackend

    _import_all()
    repo = JaxRepository()
    for name in names:
        if name == "tg":
            repo.register("tg", lambda: TinyGptBackend(name="tg", **GPT))
        elif name == "simple_b":
            repo.register("simple_b", lambda: AddSubBackend(name="simple_b"))
        else:
            repo.register(name, _REGISTRY[name])
    for name, cfg in _ensemble_configs(
            jax_config, {n: ENSEMBLES[n] for n in ensembles}).items():
        repo.register(name, lambda cfg=cfg: ConfigOnlyBackend(cfg))
    return repo


class Both:
    def __init__(self, names, ensembles=()):
        self.port = TorchEngine(_port_repo(names, ensembles), device="cpu")
        self.jax = TpuEngine(_jax_repo(names, ensembles))
        self.sides = ((self.port, InferRequest), (self.jax, JaxRequest))

    def each(self, fn):
        """``fn(engine, request_cls)`` on each side: [port's, JAX's]."""
        return [_call(fn, engine, req_cls) for engine, req_cls in self.sides]

    def close(self):
        self.port.shutdown()
        self.jax.shutdown()


@pytest.fixture
def both():
    made = []

    def make(*args, **kw):
        made.append(Both(*args, **kw))
        return made[-1]

    yield make
    for b in made:
        b.close()


def _call(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 — either package's EngineError
        return ("error", getattr(exc, "status", None), str(exc))


def _infer(engine, req_cls, name, inputs, **kw):
    resp = engine.infer(req_cls(model_name=name, inputs=dict(inputs), **kw),
                        timeout_s=TIMEOUT)
    return {k: np.asarray(v).tolist() for k, v in sorted(resp.outputs.items())}


# -- the engine -----------------------------------------------------------------

def test_load_unload(both):
    b = both(["simple"])

    def run(engine, req_cls):
        engine.unload_model("simple")
        seen = [engine.model_is_ready("simple")]
        engine.load_model("simple")
        seen.append(engine.model_is_ready("simple"))
        seen.append(_infer(engine, req_cls, "simple",
                           {"INPUT0": A, "INPUT1": B}))
        engine.unload_model("simple")
        seen.append(engine.model_is_ready("simple"))
        seen.append(_call(_infer, engine, req_cls, "simple",
                          {"INPUT0": A, "INPUT1": B}))
        seen.append(engine.repository_index())
        engine.load_model("simple")
        seen.append(_infer(engine, req_cls, "simple",
                           {"INPUT0": A, "INPUT1": B}))
        return seen

    port, ref = b.each(run)
    assert port == ref
    seen = port[1]
    assert seen[:2] == [False, True] and seen[3] is False
    assert seen[4] == ("error", 400, "model 'simple' is not ready")
    assert seen[5] == [{"name": "simple", "version": "1",
                        "state": "UNAVAILABLE", "reason": "unloaded"}]


def test_statistics_across_a_reload(both):
    """One entry per version, kept across an unload and a reload, as the
    JAX engine keeps it."""
    b = both(["simple"])

    def run(engine, req_cls):
        for _ in range(2):
            _infer(engine, req_cls, "simple", {"INPUT0": A, "INPUT1": B})
        engine.unload_model("simple")
        gone = _call(engine.model_statistics, "simple")
        engine.load_model("simple")
        _infer(engine, req_cls, "simple", {"INPUT0": A, "INPUT1": B},
               model_version="1")
        stats = engine.model_statistics("simple")["model_stats"]
        every = engine.model_statistics()["model_stats"]
        return (gone, [(s["name"], s["version"], s["inference_count"])
                       for s in stats],
                [(s["name"], s["version"]) for s in every])

    port, ref = b.each(run)
    assert port == ref
    assert port[1][1] == [("simple", "1", 3)]
    assert port[1][0][:2] == ("error", 400)


def test_unload_dependents_keeps_a_shared_component(both):
    """``ens_a`` and ``ens_b`` both run ``simple`` then ``simple_b``:
    unloading ``ens_a`` with its dependents leaves both (``ens_b`` still
    names them); unloading ``ens_b`` then takes them. Without
    ``unload_dependents`` nothing else goes."""
    b = both(["simple", "simple_b"], ensembles=("ens_a", "ens_b"))

    def run(engine, req_cls):
        states = []

        def snap():
            states.append({e["name"]: e["state"]
                           for e in engine.repository_index()})

        out = _infer(engine, req_cls, "ens_b", {"A": A, "B": B})
        engine.unload_model("ens_a", unload_dependents=True)
        snap()
        out2 = _infer(engine, req_cls, "ens_b", {"A": A, "B": B})
        engine.load_model("ens_a")
        engine.unload_model("ens_a")
        snap()
        engine.unload_model("ens_b", unload_dependents=True)
        snap()
        return out, out2, states

    port, ref = b.each(run)
    assert port == ref
    out, out2, states = port[1]
    assert out == out2 == {"S": (2 * A).tolist()}
    ready = {"simple": "READY", "simple_b": "READY"}
    assert states == [
        {"ens_a": "UNAVAILABLE", "ens_b": "READY", **ready},
        {"ens_a": "UNAVAILABLE", "ens_b": "READY", **ready},
        {n: "UNAVAILABLE" for n in ("ens_a", "ens_b", "simple",
                                    "simple_b")}]


def test_a_worker_that_cannot_start_fails_the_load(monkeypatch):
    """A card worker makes its stream (``worker_stream``) before the load
    returns: when that fails, the load raises it and no worker is left."""
    import torch

    from client_tpu_torch.engine import scheduler as sched
    from client_tpu_torch.engine.model import Model
    from client_tpu_torch.engine.stats import ModelStats
    from client_tpu_torch.models.simple import AddSubBackend

    def broken(device):
        raise RuntimeError("no stream")

    monkeypatch.setattr(sched, "worker_stream", broken)
    model = Model(AddSubBackend(name="no_start"), "cpu")
    model.device = torch.device("cuda")  # only the start reads it
    with pytest.raises(RuntimeError, match="no stream"):
        sched.make_scheduler(model, ModelStats("no_start"))
    assert [t for t in threading.enumerate()
            if t.name.startswith("sched-no_start-")] == []


def test_the_engine_loads_the_rest_when_one_model_fails():
    """As the JAX engine's ``load_all``: the failure stays in the index,
    every other model serves."""
    from client_tpu.engine.types import EngineError as JaxError
    from client_tpu_torch.engine import EngineError

    def boom_port(device):
        raise EngineError("the build failed", 400)

    def boom_jax():
        raise JaxError("the build failed", 400)

    port_repo, jax_repo = _port_repo(["simple"]), _jax_repo(["simple"])
    port_repo.register("a_boom", boom_port)
    jax_repo.register("a_boom", boom_jax)
    port, ref = TorchEngine(port_repo, device="cpu"), TpuEngine(jax_repo)
    try:
        assert port.repository_index() == ref.repository_index() == [
            {"name": "a_boom", "version": "1", "state": "UNAVAILABLE",
             "reason": "the build failed"},
            {"name": "simple", "version": "1", "state": "READY"}]
        assert _infer(port, InferRequest, "simple",
                      {"INPUT0": A, "INPUT1": B}) == _infer(
            ref, JaxRequest, "simple", {"INPUT0": A, "INPUT1": B})
    finally:
        port.shutdown()
        ref.shutdown()


# -- every scheduler kind around an unload ------------------------------------------

def _csr():
    counts = np.array([1, 2, 0, 3])
    return {"DENSE": np.linspace(-1, 1, 8, dtype=np.float32)[None],
            "INDICES": np.arange(counts.sum(), dtype=np.int32),
            "OFFSETS": np.concatenate([[0], np.cumsum(counts)])
            .astype(np.int32)}


# name -> (the models to register, the request's keyword arguments)
KINDS = {
    "dynamic": ("simple", dict(inputs={"INPUT0": A, "INPUT1": B})),
    "ragged": ("dlrm", dict(inputs=_csr())),
    "sequence_direct": ("simple_sequence", dict(
        inputs={"INPUT": np.array([5], np.int32)}, sequence_id=7,
        sequence_start=True)),
    "sequence_oldest": ("simple_sequence_oldest", dict(
        inputs={"INPUT": np.array([5], np.int32)}, sequence_id=7,
        sequence_start=True)),
    "decoupled": ("simple_repeat", dict(
        inputs={"IN": np.array([4, 5], np.int32)})),
    "generative": ("tg", dict(
        inputs={"INPUT_IDS": np.array([1, 2, 3], np.int32)},
        parameters={"max_tokens": 4})),
    "ensemble": ("ens_b", dict(inputs={"A": A, "B": B})),
}


def _models_of(kind):
    name = KINDS[kind][0]
    if kind == "ensemble":
        return ["simple", "simple_b"], ("ens_b",)
    return [name], ()


def _submit(target, req) -> tuple[threading.Event, list]:
    """Submit ``req`` to a scheduler or an engine; returns the event set on
    its final (or error) response, and the responses."""
    got, done = [], threading.Event()

    def cb(resp):
        got.append(resp)
        if resp.error is not None or resp.final:
            done.set()

    req.response_callback = cb
    if hasattr(target, "async_infer"):
        target.async_infer(req)
    else:
        target.submit(req)
    return done, got


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_request_racing_unload_gets_503_not_stranded(both, kind):
    """A request submitted to a scheduler after its stop (the reload path
    retires schedulers while a caller holds one) is answered 503, within
    ``WAIT_S``, in the JAX engine's words."""
    names, ensembles = _models_of(kind)
    b = both(names, ensembles)
    name, kw = KINDS[kind]
    answers = []
    for engine, req_cls in b.sides:
        sched = engine.scheduler_for(name)
        sched.stop()
        done, got = _submit(sched, req_cls(model_name=name, **kw))
        assert done.wait(WAIT_S), f"{kind}: request stranded in a dead queue"
        answers.append((got[-1].error.status, str(got[-1].error)))
    assert answers[0] == answers[1] == (
        503, "model unloaded before the request was processed")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_unload_with_requests_in_flight_frees_the_model(kind):
    """Requests in flight when their model unloads are each answered
    within ``WAIT_S`` (served, or 503), and then nothing keeps the backend
    alive: no worker, alias, statistics, closure or cache."""
    names, ensembles = _models_of(kind)
    engine = TorchEngine(_port_repo(names, ensembles), device="cpu")
    try:
        name, kw = KINDS[kind]
        backend = weakref.ref(engine.repository.get(name).backend)
        pending = [_submit(engine, InferRequest(model_name=name, **kw))
                   for _ in range(4)]
        engine.unload_model(name, unload_dependents=True)
        for done, got in pending:
            assert done.wait(WAIT_S), f"{kind}: a caller left waiting"
            err = got[-1].error
            assert err is None or err.status in (400, 503), str(err)
        del pending, done, got, err
        gc.collect()
        assert backend() is None, f"{kind}: the unloaded backend lives on"
        assert not engine.model_is_ready(name)
        for model in names + list(ensembles):
            engine.load_model(model)
        done, got = _submit(engine, InferRequest(model_name=name, **kw))
        assert done.wait(WAIT_S) and got[-1].error is None
    finally:
        engine.shutdown()


def _stream(engine, req_cls, tokens: list, block: threading.Event):
    """Open one greedy ``tg`` stream whose frontend backlogs (holding the
    stream open) once ``block`` is set."""
    done, errs = threading.Event(), []

    def cb(resp):
        if resp.error is not None:
            errs.append(resp.error)
            done.set()
        elif resp.final:
            done.set()
        else:
            tokens.append(int(np.asarray(resp.outputs["TOKEN"]).ravel()[0]))
            block.set()

    req = req_cls(model_name="tg",
                  inputs={"INPUT_IDS": np.array([1, 2, 3], np.int32)},
                  parameters={"max_tokens": 24})
    req.backpressure = block.is_set
    engine.async_infer(req, cb)
    return done, errs


def test_streams_open_at_unload_end_with_an_error(both):
    """4 generation streams held open (their frontends backlogged after the
    first token) when ``tg`` unloads: each ends with an error within
    ``WAIT_S``, in the JAX engine's words."""
    b = both(["tg"])
    answers = []
    for engine, req_cls in b.sides:
        opened = [_stream(engine, req_cls, [], threading.Event())
                  for _ in range(4)]
        sched = engine.scheduler_for("tg")
        engine.unload_model("tg")
        words = set()
        for done, errs in opened:
            assert done.wait(WAIT_S), "a stream was left open"
            assert errs, "a stream ended without an error"
            words.add((errs[0].status, str(errs[0])))
        assert not any(t.is_alive() for t in sched.workers)
        answers.append(sorted(words))
    assert answers[0] == answers[1] == [(503, "server shutting down")]


def test_cached_variant_invalidates_on_reload(both):
    """``dlrm_cached``: hits after repeated requests, and a reload clears
    the row cache (one invalidation more, no resident row; the first load
    cleared it once), as in JAX."""
    b = both(["dlrm_cached"])
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 6, 8)
    inputs = {"DENSE": rng.standard_normal((2, 8)).astype(np.float32),
              "INDICES": rng.integers(0, 64, counts.sum()).astype(np.int32),
              "OFFSETS": np.concatenate([[0], np.cumsum(counts)])
              .astype(np.int32)}

    def run(engine, req_cls):
        for _ in range(3):
            _infer(engine, req_cls, "dlrm_cached", inputs)
        cache = engine.repository.get("dlrm_cached").backend.row_cache
        before = (cache.hits > 0, cache.hit_rate() > 0, cache.invalidations)
        engine.load_model("dlrm_cached")
        cache2 = engine.repository.get("dlrm_cached").backend.row_cache
        after = (cache2 is cache, cache2.invalidations,
                 cache2.snapshot()["resident_rows"])
        return before, after

    port, ref = b.each(run)
    assert port == ref
    assert port[1] == ((True, True, 1), (True, 2, 0))


# -- over the wire ------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    """Each package: one engine with ``simple``, ``simple_b``,
    ``simple_identity`` and the two ensembles, behind HTTP and gRPC."""
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    names = ["simple", "simple_b", "simple_identity"]
    out = []
    for engine, http_cls, grpc_cls in (
            (TorchEngine(_port_repo(names, ("ens_a", "ens_b")),
                         device="cpu"),
             HttpInferenceServer, GrpcInferenceServer),
            (TpuEngine(_jax_repo(names, ("ens_a", "ens_b"))), JaxHttp,
             JaxGrpc)):
        grpc_server = grpc_cls(engine, port=0).start()
        channel = grpc.insecure_channel(grpc_server.url)
        out.append(SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_server, channel=channel,
            stub=grpc_stub.GRPCInferenceServiceStub(channel)))
    yield SimpleNamespace(port=out[0], jax=out[1])
    for side in out:
        side.channel.close()
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _http(server, method, path, body=None):
    host, port = server.url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    try:
        data = json.loads(data) if data else None
    except ValueError:
        pass
    return resp.status, data


def _identity_body():
    return json.dumps({"inputs": [{"name": "INPUT0", "datatype": "BYTES",
                                   "shape": [1, 2], "data": ["a", "bc"]}]})


HTTP_STEPS = [
    ("POST", "/v2/repository/models/simple_identity/unload", None),
    ("GET", "/v2/models/simple_identity/ready", None),
    ("POST", "/v2/models/simple_identity/infer", _identity_body()),
    ("GET", "/v2/models/simple_identity", None),
    ("POST", "/v2/repository/models/simple_identity/load",
     json.dumps({"parameters": {"config": "{}"}})),
    ("POST", "/v2/repository/models/simple_identity/load", "{"),
    ("POST", "/v2/repository/models/simple_identity/unload", "[1]"),
    ("POST", "/v2/repository/models/no_such_model/load", None),
    ("POST", "/v2/repository/models/no_such_model/unload", None),
    ("POST", "/v2/repository/index", None),
    ("POST", "/v2/repository/models/simple_identity/load", ""),
    ("GET", "/v2/models/simple_identity/ready", None),
    ("POST", "/v2/models/simple_identity/infer", _identity_body()),
    ("POST", "/v2/repository/models/simple_identity/load",
     json.dumps({"parameters": {}})),
    ("POST", "/v2/repository/models/ens_a/unload",
     json.dumps({"parameters": {"unload_dependents": True}})),
    ("POST", "/v2/repository/index", None),
    ("POST", "/v2/repository/models/ens_b/unload",
     json.dumps({"parameters": {"unload_dependents": True}})),
    ("POST", "/v2/repository/index", None),
    ("POST", "/v2/repository/models/simple/load", None),
    ("POST", "/v2/repository/models/simple_b/load", None),
    ("POST", "/v2/repository/models/ens_a/load", None),
    ("POST", "/v2/repository/models/ens_b/load", None),
    ("POST", "/v2/models/ens_a/infer", json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": list(range(16))} for n in ("A", "B")]})),
]


def test_http_load_unload_answers_as_jax(servers):
    answers = [[_http(side.http, *step) for step in HTTP_STEPS]
               for side in (servers.port, servers.jax)]
    assert answers[0] == answers[1]
    codes = [a[0] for a in answers[0]]
    assert codes == [200, 400, 400, 400, 400, 400, 400, 404, 404, 200, 200,
                     200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200,
                     200]
    words = [a[1]["error"] for a in answers[0][4:7]]
    assert words == [
        "load parameters (config/file overrides) are not supported",
        "malformed load request body", "malformed unload request body"]
    states = {e["name"]: e["state"] for e in answers[0][15][1]}
    assert states["simple"] == states["simple_b"] == "READY"
    states = {e["name"]: e["state"] for e in answers[0][17][1]}
    assert states["simple"] == states["simple_b"] == "UNAVAILABLE"


def _answer(stub, rpc, request):
    try:
        return ("ok", getattr(stub, rpc)(request, timeout=TIMEOUT)
                .SerializeToString(deterministic=True))
    except grpc.RpcError as exc:
        return ("error", exc.code(), exc.details())


def test_grpc_load_unload_answers_as_jax(servers):
    """``unload_dependents`` as a ``bool_param``, a load with parameters
    (UNIMPLEMENTED), an unknown model (NOT_FOUND), and the index."""
    dependents = pb.RepositoryModelUnloadRequest(model_name="ens_a")
    dependents.parameters["unload_dependents"].bool_param = True
    with_params = pb.RepositoryModelLoadRequest(model_name="simple")
    with_params.parameters["config"].string_param = "{}"
    steps = [
        ("RepositoryModelUnload",
         pb.RepositoryModelUnloadRequest(model_name="simple_identity")),
        ("ModelReady", pb.ModelReadyRequest(name="simple_identity")),
        ("RepositoryModelLoad", with_params),
        ("RepositoryModelLoad",
         pb.RepositoryModelLoadRequest(model_name="no_such_model")),
        ("RepositoryModelUnload",
         pb.RepositoryModelUnloadRequest(model_name="no_such_model")),
        ("RepositoryModelLoad",
         pb.RepositoryModelLoadRequest(model_name="simple_identity")),
        ("ModelReady", pb.ModelReadyRequest(name="simple_identity")),
        ("RepositoryModelUnload", dependents),
        ("RepositoryIndex", pb.RepositoryIndexRequest()),
        ("RepositoryModelLoad",
         pb.RepositoryModelLoadRequest(model_name="ens_a")),
        ("RepositoryIndex", pb.RepositoryIndexRequest()),
    ]
    answers = [[_answer(side.stub, *step) for step in steps]
               for side in (servers.port, servers.jax)]
    assert answers[0] == answers[1]
    assert [a[0] for a in answers[0]] == [
        "ok", "ok", "error", "error", "error", "ok", "ok", "ok", "ok", "ok",
        "ok"]
    assert [a[1] for a in answers[0][2:5]] == [
        grpc.StatusCode.UNIMPLEMENTED, grpc.StatusCode.NOT_FOUND,
        grpc.StatusCode.NOT_FOUND]
    ready = pb.ModelReadyResponse.FromString
    assert (ready(answers[0][1][1]).ready, ready(answers[0][6][1]).ready) \
        == (False, True)
    index = pb.RepositoryIndexResponse.FromString(answers[0][8][1])
    assert {m.name: m.state for m in index.models}["ens_a"] == "UNAVAILABLE"


def test_a_stream_rpc_open_at_unload_ends_with_an_error():
    """A ``ModelStreamInfer`` RPC carrying two long decoupled requests
    (``simple_repeat``, 40 responses 50 ms apart) when the model unloads:
    each request ends with an error message within ``WAIT_S``, and the
    RPC ends."""
    import time

    from client_tpu_torch.protocol import grpc_codec
    from client_tpu_torch.server import GrpcInferenceServer

    engine = TorchEngine(_port_repo(["simple_repeat"]), device="cpu")
    server = GrpcInferenceServer(engine, port=0).start()
    channel = grpc.insecure_channel(server.url)
    try:
        stub = grpc_stub.GRPCInferenceServiceStub(channel)
        requests = []
        for rid in ("a", "b"):
            req = pb.ModelInferRequest(model_name="simple_repeat", id=rid)
            for name, arr in (("IN", np.arange(40, dtype=np.int32)),
                              ("DELAY", np.full(40, 50_000, np.uint32))):
                req.inputs.add(name=name, shape=[40], datatype=(
                    "INT32" if arr.dtype == np.int32 else "UINT32"))
                req.raw_input_contents.append(
                    grpc_codec.ndarray_to_raw(arr, req.inputs[-1].datatype))
            requests.append(req)
        errors, first = {}, threading.Event()

        def read():
            for msg in stub.ModelStreamInfer(iter(requests),
                                             timeout=TIMEOUT):
                if msg.error_message:
                    errors[msg.infer_response.id or len(errors)] = \
                        msg.error_message
                else:
                    first.set()

        reader = threading.Thread(target=read)
        reader.start()
        assert first.wait(WAIT_S), "no response before the unload"
        t0 = time.monotonic()
        engine.unload_model("simple_repeat")
        reader.join(WAIT_S)
        assert not reader.is_alive(), "the stream RPC was left open"
        assert time.monotonic() - t0 <= WAIT_S
        # The running one is cut; the queued one is cut at its first
        # response or failed in the queue.
        assert len(errors) == 2 and set(errors.values()) <= {
            "server shutting down",
            "model unloaded before the request was processed"}
    finally:
        channel.close()
        server.stop()
        engine.shutdown()
