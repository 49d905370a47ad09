"""Warm-up on the port held against the JAX package's.

``TorchEngine(warmup=True)`` runs every bucket of each model it loads
once on zeros (``Model.warmup``) and the scheduler's own shapes (the
generative prefill per prompt bucket and decode per wave bucket), as
``TpuEngine(warmup=True)`` compiles them. Each zoo family, small, is
warmed by both engines on the CPU: every bucket of each model's ladder
shows one cold execution (its "compile") and no traffic in
``/v2/profile`` on both, and a request that follows is warm on both (no
compile on its times, no cold execution added). The JAX ``simple`` pads
to its [1, 8, 64] ladder and the port's to powers of two, so buckets are
held against each engine's own ladder. The image family is a small
DenseNet (the JAX SSD's init alone takes ~26 s here, and a ResNet's
compiles ~10 s).

Also: ``Model.execute_timed(synthetic=True)`` keeps a warm execution out
of the traffic statistics; ``warm_bucket`` answers as the JAX package's
for BYTES inputs and out-of-range buckets; ``CLIENT_TPU_WARMUP`` turns
warm-up on; a warm execution that fails on a device model raises on the
card but not on the CPU; and a load whose warm-up raised serves nothing.
"""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

from client_tpu.engine.types import EngineError as JaxEngineError
from client_tpu.engine.types import InferRequest as JaxRequest
from client_tpu_torch.engine.types import EngineError, InferRequest

jax_profiler = importlib.import_module("client_tpu.observability.profiler")

TIMEOUT = 60  # seconds, every wait
BERT = dict(seq_len=32, hidden=32, n_layers=1, n_heads=2, ffn=64,
            vocab=128, max_batch_size=2)
GPT = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=64,
           max_seq_len=16, max_streams=2)
DENSENET = dict(blocks=(1,), growth=8, num_classes=10, max_batch_size=1)


def _jax_repo(family):
    from client_tpu.engine.repository import ModelRepository as JaxRepo
    from client_tpu.models import build_repository as jax_build

    if family in ("simple", "dlrm"):
        return jax_build(FAMILIES[family])
    from client_tpu.models import bert, ensembles, generate, vision

    repo = JaxRepo()
    backends = {
        "bert": lambda: [bert.BertBackend(name="bert_base", **BERT),
                         ensembles.BertPreprocessBackend(),
                         ensembles.BertPostprocessBackend(),
                         ensembles.EnsembleBertBackend()],
        "gpt": lambda: [generate.TinyGptBackend(
            name="tiny_gpt", attn_impl="reference", **GPT)],
        "vision": lambda: [
            vision.DenseNet121Backend(name="densenet_onnx", **DENSENET)],
    }[family]()
    for b in backends:
        repo.register_backend(b)
    return repo


def _port_repo(family):
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import build_repository

    if family in ("simple", "dlrm"):
        return build_repository(FAMILIES[family])
    from client_tpu_torch.models import bert, generate, vision

    repo = build_repository(
        ["bert_preprocess", "bert_postprocess"] if family == "bert" else [])
    if family == "bert":
        repo.register("bert_base",
                      lambda device: bert.BertBackend(device=device, **BERT))
        repo = _with_zoo(repo, ["ensemble_bert"])
    elif family == "gpt":
        repo.register("tiny_gpt", lambda device: generate.TinyGptBackend(
            name="tiny_gpt", attn_impl="fused", device=device, **GPT))
    else:
        repo.register("densenet_onnx",
                      lambda device: vision.DenseNet121Backend(
                          device=device, **DENSENET))
    return repo


def _with_zoo(repo, names):
    from client_tpu_torch.models import _REGISTRY

    for name in names:
        repo.register(name, _REGISTRY[name])
    return repo


FAMILIES = {
    "simple": ["simple", "simple_int8", "simple_string", "simple_identity",
               "simple_sequence", "simple_sequence_oldest", "simple_repeat"],
    "dlrm": ["dlrm", "dlrm_cached"],
    "bert": None, "gpt": None, "vision": None,
}


def _buckets(engine) -> dict:
    """{model: {bucket: (compilations, cold executions, executions)}}."""
    return {e["model"]: {b["bucket"]: (b["compilations"],
                                       b["cold_executions"],
                                       b["executions"])
                         for b in e["buckets"]}
            for e in engine.profile_snapshot()["models"].values()}


def _ladder(engine, name) -> list:
    cfg = engine.repository.get(name).config
    return cfg.effective_buckets() if cfg.axis_capacity() > 0 else [0]


@pytest.fixture(scope="module", params=list(FAMILIES))
def warmed(request):
    """Both engines warmed on one family, each profiler fresh."""
    from client_tpu.engine import TpuEngine
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.observability import profiler as port_profiler

    family = request.param
    jax_profiler.reset_profiler()
    port_profiler.reset_profiler()
    jax_engine = TpuEngine(_jax_repo(family), warmup=True)
    engine = TorchEngine(_port_repo(family), device="cpu", warmup=True)
    yield SimpleNamespace(family=family, port=engine, jax=jax_engine)
    engine.shutdown()
    jax_engine.shutdown()


def test_every_bucket_is_warmed_as_the_jax_engine_warms_it(warmed):
    sides = {"port": warmed.port, "jax": warmed.jax}
    tables = {name: _buckets(engine) for name, engine in sides.items()}
    assert set(tables["port"]) == set(tables["jax"])
    for name, engine in sides.items():
        for model, buckets in tables[name].items():
            assert sorted(buckets) == _ladder(engine, model), (name, model)
            # One cold execution per bucket, none of it traffic.
            assert set(buckets.values()) == {(1, 0, 0)}, (name, model)
    index = {e["name"]: e["state"] for e in warmed.port.repository_index()}
    assert index == {e["name"]: e["state"]
                     for e in warmed.jax.repository_index()}
    assert set(index.values()) == {"READY"}


def _request(family, model, rows):
    rng = np.random.default_rng(rows)
    if model in ("simple", "simple_int8"):
        dt = np.int32 if model == "simple" else np.int8
        return {n: rng.integers(-9, 9, (rows, 16)).astype(dt)
                for n in ("INPUT0", "INPUT1")}
    if model == "bert_base":
        return {"input_ids": rng.integers(0, BERT["vocab"],
                                          (rows, BERT["seq_len"]))
                .astype(np.int32),
                "attention_mask": np.ones((rows, BERT["seq_len"]),
                                          np.int32)}
    if model == "densenet_onnx":
        return {"INPUT": rng.standard_normal((rows, 224, 224, 3))
                .astype(np.float32)}
    return None


def test_a_request_after_warmup_is_warm_on_both(warmed):
    """A request at each batched model's largest bucket: no compile on
    its times, and no cold execution added to the table; a generation's
    decode dispatches are all warm."""
    before = {"port": _buckets(warmed.port), "jax": _buckets(warmed.jax)}
    sent = 0
    for model, buckets in before["port"].items():
        rows = max(buckets)
        inputs = _request(warmed.family, model, rows)
        if inputs is None:
            continue
        for name, engine, cls in (("port", warmed.port, InferRequest),
                                  ("jax", warmed.jax, JaxRequest)):
            resp = engine.infer(cls(model_name=model, inputs=dict(inputs)),
                                timeout_s=TIMEOUT)
            assert resp.times.compile_ns == 0, (name, model)
            after = _buckets(engine)[model][rows]
            assert after == (1, 0, 1), (name, model, after)
        sent += 1
    if warmed.family == "gpt":
        _generate_warm(warmed)
    elif warmed.family != "dlrm":
        assert sent >= 1


def _generate_warm(warmed):
    """The port's decode dispatches: each (wave bucket, chunk) shape was
    counted at warm-up, so a stream's dispatches are all warm."""
    from client_tpu_torch.observability.profiler import profiler

    for engine, cls in ((warmed.port, InferRequest),
                        (warmed.jax, JaxRequest)):
        tokens = []
        done = []

        def cb(resp, tokens=tokens, done=done):
            assert resp.error is None, resp.error
            if resp.final:
                done.append(True)
            else:
                tokens.append(int(resp.outputs["TOKEN"][0]))

        engine.async_infer(cls(
            model_name="tiny_gpt",
            inputs={"INPUT_IDS": np.array([3, 5, 7], np.int32)},
            parameters={"max_tokens": 4}), cb)
        deadline = time.monotonic() + TIMEOUT
        while not done and time.monotonic() < deadline:
            time.sleep(0.01)
        assert done and len(tokens) == 4
    waves = [w for k, w in profiler()._waves.items() if k[0] == "tiny_gpt"]
    assert waves and sum(w.dispatches for w in waves) >= 3
    assert sum(w.cold_dispatches for w in waves) == 0


# -- the model's surface --------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """The ``simple`` and ``simple_string`` models of both packages, each
    loaded alone (no engine, no scheduler)."""
    from client_tpu.engine.model import Model as JaxModel
    from client_tpu.models import simple as jax_simple
    from client_tpu_torch.engine.model import Model
    from client_tpu_torch.models import simple

    return SimpleNamespace(
        port=Model(simple.AddSubBackend(), device="cpu"),
        jax=JaxModel(jax_simple.AddSubBackend()),
        port_str=Model(simple.StringAddSubBackend(), device="cpu"),
        jax_str=JaxModel(jax_simple.StringAddSubBackend()))


def test_a_synthetic_execution_is_no_traffic(models):
    """``synthetic=True`` records the bucket's cold execution as its
    compile and nothing else; ``pad_to`` runs a bucket outside the
    ladder."""
    from client_tpu_torch.observability import profiler as port_profiler

    rows = {}
    for name, model, mod in (("port", models.port, port_profiler),
                             ("jax", models.jax, jax_profiler)):
        mod.reset_profiler()
        a = np.ones((3, 16), np.int32)
        out, phases = model.execute_timed({"INPUT0": a, "INPUT1": a},
                                          batch_size=3, pad_to=3,
                                          synthetic=True)
        assert out["OUTPUT0"].shape == (3, 16)
        assert phases.compile_ns > 0
        snap = mod.profiler().snapshot()["models"]["simple:1"]
        rows[name] = [(b["bucket"], b["compilations"], b["executions"],
                       b["rows"]) for b in snap["buckets"]]
    assert rows["port"] == rows["jax"] == [(3, 1, 0, 0)]


def test_warm_bucket_answers_as_the_jax_package(models):
    assert models.port.warm_bucket(5) > 0
    assert models.port.warm_bucket(5) == 0.0  # warm already
    assert models.port_str.warm_bucket(2) == models.jax_str.warm_bucket(2) \
        == 0.0  # BYTES inputs
    for bucket in (0, 65):
        with pytest.raises(EngineError) as port_exc:
            models.port.warm_bucket(bucket)
        with pytest.raises(JaxEngineError) as jax_exc:
            models.jax.warm_bucket(bucket)
        assert str(port_exc.value) == str(jax_exc.value)
        assert port_exc.value.status == jax_exc.value.status == 400


def test_the_environment_turns_warmup_on(monkeypatch):
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.observability import profiler as port_profiler

    port_profiler.reset_profiler()
    monkeypatch.setenv("CLIENT_TPU_WARMUP", "1")
    engine = TorchEngine(build_repository(["simple"]), device="cpu")
    try:
        table = _buckets(engine)["simple"]
        assert sorted(table) == _ladder(engine, "simple")
        assert set(table.values()) == {(1, 0, 0)}
    finally:
        engine.shutdown()
    port_profiler.reset_profiler()
    monkeypatch.setenv("CLIENT_TPU_WARMUP", "0")
    engine = TorchEngine(build_repository(["simple"]), device="cpu")
    try:
        assert "simple:1" not in engine.profile_snapshot()["models"]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("device,raises", [("cpu", False), ("cuda", True)])
def test_a_failed_warm_execution_raises_on_the_card_only(models, monkeypatch,
                                                         device, raises):
    """On the CPU (as in the JAX package) warm-up is best effort for a
    model that rejects zeros; on the card a device model's failed warm
    execution is a kernel's failure and fails the load."""
    model = models.port

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(model, "execute_timed", broken)
    monkeypatch.setattr(model, "device", SimpleNamespace(type=device))
    if raises:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            model.warmup()
    else:
        model.warmup()


def test_a_warmup_that_raises_leaves_the_model_unserved(monkeypatch):
    """A load whose warm-up raised leaves no version serving: the model
    is UNAVAILABLE in the index with the error as its reason, and a
    request for it is refused as for any model that is not ready."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.model import Model
    from client_tpu_torch.models import build_repository

    def broken(self):
        raise EngineError("warm execution failed", 500)

    monkeypatch.setattr(Model, "warmup", broken)
    engine = TorchEngine(build_repository(["simple"]), device="cpu",
                         warmup=True)
    try:
        (entry,) = engine.repository_index()
        assert (entry["state"], entry["reason"]) == (
            "UNAVAILABLE", "warmup failed: warm execution failed")
        assert engine.scheduler_for("simple") is None
        assert not engine.model_is_ready("simple")
        a = np.zeros((1, 16), np.int32)
        with pytest.raises(EngineError, match="not ready"):
            engine.infer(InferRequest(model_name="simple", inputs={
                "INPUT0": a, "INPUT1": a}), timeout_s=TIMEOUT)
        with pytest.raises(EngineError, match="warm execution failed"):
            engine.load_model("simple")
        assert engine.scheduler_for("simple") is None
    finally:
        engine.shutdown()


# -- the profile's per-model annotations and the row cache's metrics ------------


def _csr(rng, rows):
    counts = rng.integers(0, 5, size=rows * 4)
    idx = ((rng.zipf(1.3, size=int(counts.sum())) - 1) % 64).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return {"DENSE": rng.standard_normal((rows, 8)).astype(np.float32),
            "INDICES": idx, "OFFSETS": off}


def test_profile_memory_hbm_bytes_row_cache_and_emb_metrics_as_jax():
    """``dlrm_cached`` served by both engines: ``/v2/profile`` carries
    the same ``hbm_bytes`` and ``row_cache`` per model and a ``memory``
    section with the same keys, and ``/metrics`` the same ``tpu_emb_*``
    samples."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.observability import scrape
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.observability import profiler as port_profiler

    jax_profiler.reset_profiler()
    port_profiler.reset_profiler()
    sides = {"port": (TorchEngine(build_repository(["dlrm_cached"]),
                                  device="cpu"), InferRequest),
             "jax": (TpuEngine(jax_build(["dlrm_cached"])), JaxRequest)}
    got = {}
    try:
        for name, (engine, cls) in sides.items():
            rng = np.random.default_rng(5)
            for rows in (1, 3, 2, 1):
                engine.infer(cls(model_name="dlrm_cached",
                                 inputs=_csr(rng, rows)), timeout_s=TIMEOUT)
            snap = engine.profile_snapshot()
            entry = snap["models"]["dlrm_cached:1"]
            emb = {(n, tuple(sorted(lab.items()))): v
                   for n, lab, v in scrape.parse_samples(
                       engine.prometheus_metrics())
                   if n.startswith("tpu_emb_")}
            got[name] = (entry["hbm_bytes"], entry["row_cache"],
                         sorted(snap["memory"]), sorted(snap), emb)
    finally:
        for engine, _ in sides.values():
            engine.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"][1]["lookups"] > 0 and got["port"][4]
