"""The bucket autotuner and its planning arena on the port, held against
the JAX package.

``ArenaAllocator`` gives the same layouts, refusals and words for one
seeded reserve/release trace; ``AutotuneConfig`` parses alike; on one
stub profiler snapshot both ``Autotuner``s take the same decisions and
annotate the snapshot alike; ``Model.swap_buckets`` and the scheduler's
``swap_ladder`` clamp alike. On live engines with ``CLIENT_TPU_AUTOTUNE``
set, traffic that half fills a bucket makes both tuners promote the same
bucket through ``warm_bucket``; the promoted bucket then runs warm, the
census's ``/v2/memory`` rows hold the arena's plan as ``autotune_warm``
with the same actual bytes and drift on both packages (both arenas only
plan), and the flight recorder's ``hbm_reserved`` is the arena's
``reserved_bytes``.
"""

import importlib
from dataclasses import astuple
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from client_tpu.engine import arena as jax_arena
from client_tpu.engine import autotune as jax_tune
from client_tpu.engine import config as jax_config
from client_tpu.engine.types import InferRequest as JaxRequest
from client_tpu_torch.engine import arena as port_arena
from client_tpu_torch.engine import autotune as port_tune
from client_tpu_torch.engine import config as port_config
from client_tpu_torch.engine.types import InferRequest

jax_profiler = importlib.import_module("client_tpu.observability.profiler")
TIMEOUT = 60  # seconds, every wait


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — either package's errors
        return ("error", type(exc).__name__, str(exc),
                getattr(exc, "status", None))


# -- the arena ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_arena_layouts_as_jax(seed):
    """A seeded trace of reserves (some sharded, some too big, some
    repeated names), releases and prefix releases on a 64 KiB arena."""
    runs = []
    for mod in (port_arena, jax_arena):
        rng = np.random.default_rng(seed)
        arena = mod.ArenaAllocator(64 * 1024, label="hbm:0")
        out = []
        names = [f"bucket:m{i % 3}:1:{i}" for i in range(12)]
        for _ in range(40):
            op = rng.integers(0, 5)
            name = str(rng.choice(names))
            if op < 2:
                out.append(_outcome(lambda: astuple(arena.reserve(
                    name, int(rng.integers(1, 20_000))))))
            elif op == 2:
                out.append(_outcome(lambda: astuple(arena.reserve_sharded(
                    name, int(rng.integers(1, 40_000)),
                    int(rng.integers(1, 4))))))
            elif op == 3:
                out.append(arena.release(name))
            else:
                out.append(arena.release_prefix(
                    f"bucket:m{int(rng.integers(0, 3))}:"))
            out.append(arena.snapshot())
        out.append((arena.reserved_bytes(), arena.free_bytes()))
        runs.append(out)
    assert runs[0] == runs[1]


def test_arena_refuses_a_bad_budget_as_jax():
    assert _outcome(lambda: port_arena.ArenaAllocator(0)) \
        == _outcome(lambda: jax_arena.ArenaAllocator(0))


def test_the_budget_reads_the_card_or_falls_back():
    """Without a card the fallback, as the JAX package's CPU reading."""
    if torch.cuda.is_available():
        pytest.skip("the CPU's fallback")  # the card's: test_torch_cuda_tuning
    assert port_arena.device_hbm_budget(0.9, fallback_bytes=123) \
        == jax_arena.device_hbm_budget(0.9, fallback_bytes=123) == 123


# -- the config -----------------------------------------------------------------


@pytest.mark.parametrize("raw", [
    None, "", "0", "off", "1", "true", '{"min_calls": 4, "max_fill": 0.7}',
    '{"interval_s": 0}', '{"hbm_fraction": 1.5}', '{"min_calls": "x"}',
    '{"bogus": 1}', "[1]", "{not json"])
def test_autotune_config_parses_as_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("CLIENT_TPU_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("CLIENT_TPU_AUTOTUNE", raw)

    def parse(mod):
        cfg = mod.AutotuneConfig.from_env()
        return None if cfg is None else cfg.summary()

    got = _outcome(lambda: parse(port_tune))
    want = _outcome(lambda: parse(jax_tune))
    if got[0] == "error":
        # The JSON parser's position text is the same library's.
        assert got[:2] == want[:2] and got[3] == want[3] == 400
    else:
        assert got == want


# -- the tuner's decisions on one snapshot --------------------------------------


class _Sched:
    def __init__(self, model):
        self.model = model

    def bucket_ladder(self):
        return self.model.config.effective_buckets()

    def swap_ladder(self, buckets):
        return self.model.swap_buckets(buckets)


def _snapshot():
    """A profiler snapshot: ``a`` runs half-full batches in bucket 8 (an
    add_bucket at 4), ``b`` has a cold bucket 2 (a retire), ``c``'s
    evidence is too thin."""
    def bucket(b, execs, fill, max_rows, rate=10.0, observed=120.0):
        return {"bucket": b, "executions": execs, "fill_ratio": fill,
                "max_rows": max_rows, "calls_per_min": rate,
                "observed_s": observed}

    return {"window_s": 60.0, "models": {
        "a:1": {"model": "a", "version": "1",
                "buckets": [bucket(8, 20, 0.45, 4)],
                "suggestion": {"action": "add_bucket", "bucket": 4,
                               "below": 8, "fill_ratio": 0.45},
                "suggestions": [{"action": "add_bucket", "bucket": 4,
                                 "below": 8, "fill_ratio": 0.45,
                                 "est_saving_device_s": 0.1}]},
        "b:1": {"model": "b", "version": "1",
                "buckets": [bucket(2, 1, 1.0, 2, rate=0.1),
                            bucket(8, 30, 0.9, 8)],
                "suggestion": None,
                "suggestions": [{"action": "retire_bucket", "bucket": 2,
                                 "calls_per_min": 0.1}]},
        "c:1": {"model": "c", "version": "1",
                "buckets": [bucket(8, 3, 0.2, 2)],
                "suggestion": None,
                "suggestions": [{"action": "add_bucket", "bucket": 2,
                                 "below": 8, "fill_ratio": 0.2}]},
    }}


def _stub_engine(config_mod, simple_mod, model_cls, snap):
    models = {}
    for name, ladder in (("a", [1, 8]), ("b", [1, 2, 8]), ("c", [8])):
        backend = simple_mod.AddSubBackend(name=name, max_batch_size=8)
        backend.config.batch_buckets = ladder
        models[name] = _Sched(model_cls(backend) if model_cls.__module__
                              .startswith("client_tpu.") else
                              model_cls(backend, device="cpu"))
    return SimpleNamespace(
        profiler=SimpleNamespace(snapshot=lambda: snap),
        scheduler_for=lambda name, version="": models.get(name),
        models=models)


def _decisions(out):
    return [{k: v for k, v in d.items() if k not in ("ts", "compile_s")}
            for d in out]


def test_tuner_decisions_on_one_snapshot_as_jax():
    from client_tpu.engine.model import Model as JaxModel
    from client_tpu.models import simple as jax_simple
    from client_tpu_torch.engine.model import Model
    from client_tpu_torch.models import simple

    runs = []
    for tune, cfg_mod, simple_mod, model_cls in (
            (port_tune, port_config, simple, Model),
            (jax_tune, jax_config, jax_simple, JaxModel)):
        engine = _stub_engine(cfg_mod, simple_mod, model_cls, _snapshot())
        tuner = tune.Autotuner(engine, tune.AutotuneConfig(
            min_calls=8, max_fill=0.85, budget_bytes=1 << 20))
        for sched in engine.models.values():
            tuner.on_model_loaded(sched.model, sched)
        first = _decisions(tuner.tick())
        again = _decisions(tuner.tick())  # cooling, and already applied
        annotated = tuner.annotate(_snapshot())
        ladders = {n: s.bucket_ladder() for n, s in engine.models.items()}
        arena = tuner.arena.snapshot()
        tuner.on_model_unloaded("a")
        runs.append((first, again, annotated["autotune"]["arena"],
                     {k: (e.get("autotune"), [s.get("state") for s in
                                              e["suggestions"]])
                      for k, e in annotated["models"].items()},
                     ladders, arena, tuner.arena.snapshot()))
        tuner.stop()
    assert runs[0] == runs[1]
    first, again = runs[0][0], runs[0][1]
    assert [(d["action"], d["model"], d["bucket"]) for d in first] == [
        ("add_bucket", "a", 4), ("retire_bucket", "b", 2)]
    assert again == []
    assert runs[0][4] == {"a": [1, 4, 8], "b": [1, 8], "c": [8]}


def test_a_promotion_over_budget_is_rejected_as_jax():
    from client_tpu.engine.model import Model as JaxModel
    from client_tpu.models import simple as jax_simple
    from client_tpu_torch.engine.model import Model
    from client_tpu_torch.models import simple

    runs = []
    for tune, cfg_mod, simple_mod, model_cls in (
            (port_tune, port_config, simple, Model),
            (jax_tune, jax_config, jax_simple, JaxModel)):
        engine = _stub_engine(cfg_mod, simple_mod, model_cls, _snapshot())
        tuner = tune.Autotuner(engine, tune.AutotuneConfig(
            budget_bytes=4096))
        for sched in engine.models.values():  # some over the budget
            tuner.on_model_loaded(sched.model, sched)
        out = _decisions(tuner.tick())
        runs.append((out, tuner.arena.snapshot()))
        tuner.stop()
    assert runs[0] == runs[1]
    assert runs[0][0][0]["action"] == "rejected_budget"


@pytest.mark.parametrize("buckets", [[3, 1], [64, 100, 0, 5, 5], [], [-2]])
def test_swap_buckets_and_ladder_as_jax(buckets):
    from client_tpu.engine.model import Model as JaxModel
    from client_tpu.models import simple as jax_simple
    from client_tpu_torch.engine.model import Model
    from client_tpu_torch.models import simple

    got = []
    for model in (Model(simple.AddSubBackend(), device="cpu"),
                  JaxModel(jax_simple.AddSubBackend())):
        got.append((_outcome(lambda m=model: m.swap_buckets(buckets)),
                    model.config.effective_buckets(),
                    model.pick_bucket(2), model.pick_bucket(63)))
    assert got[0] == got[1]
    unbatched = [_outcome(lambda m=m: m.swap_buckets([1])) for m in (
        Model(simple.SequenceAccumulateBackend(), device="cpu"),
        JaxModel(jax_simple.SequenceAccumulateBackend()))]
    assert unbatched[0] == unbatched[1]


# -- live engines ---------------------------------------------------------------


def _backend(simple_mod, name="tuned"):
    b = simple_mod.AddSubBackend(name=name, max_batch_size=8)
    b.config.instance_count = 1
    b.config.batch_buckets = [1, 8]
    return b


@pytest.fixture(scope="module")
def engines():
    import os

    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepo
    from client_tpu.models import simple as jax_simple
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import simple
    from client_tpu_torch.observability import profiler as port_profiler

    os.environ["CLIENT_TPU_AUTOTUNE"] = (
        '{"interval_s": 3600, "min_calls": 4, "budget_bytes": 4194304}')
    try:
        jax_profiler.reset_profiler()
        port_profiler.reset_profiler()
        jax_repo = JaxRepo()
        jax_repo.register_backend(_backend(jax_simple))
        repo = ModelRepository()
        repo.register("tuned", lambda device: _backend(simple))
        sides = SimpleNamespace(
            port=TorchEngine(repo, device="cpu"), jax=TpuEngine(jax_repo))
    finally:
        del os.environ["CLIENT_TPU_AUTOTUNE"]
    yield sides
    sides.port.shutdown()
    sides.jax.shutdown()


def _drive(engine, cls, rows, n):
    for i in range(n):
        a = np.full((rows, 16), i, np.int32)
        resp = engine.infer(cls(model_name="tuned",
                                inputs={"INPUT0": a, "INPUT1": a}),
                            timeout_s=TIMEOUT)
        assert resp.outputs["OUTPUT0"].tolist() == (2 * a).tolist()


def _census_row(engine, component, model="tuned"):
    for row in engine.memory_census()["owners"]:
        if row["model"] == model and row["component"] == component:
            return row
    return None


def test_half_full_batches_promote_the_same_bucket(engines):
    """Requests of 3 rows fill bucket 8 to 3/8: both tuners reserve,
    warm and promote bucket 3 (the rows seen); the next request of 3
    rows then runs warm in it."""
    got = {}
    for name, engine, cls in (("port", engines.port, InferRequest),
                              ("jax", engines.jax, JaxRequest)):
        _drive(engine, cls, 3, 9)
        out = _decisions(engine.autotuner.tick())
        sched = engine.scheduler_for("tuned")
        a = np.ones((3, 16), np.int32)
        resp = engine.infer(cls(model_name="tuned",
                                inputs={"INPUT0": a, "INPUT1": a}),
                            timeout_s=TIMEOUT)
        snap = engine.profile_snapshot()
        promoted = next(b for b in snap["models"]["tuned:1"]["buckets"]
                        if b["bucket"] == 3)
        got[name] = (out, sched.bucket_ladder(), resp.times.compile_ns,
                     (promoted["compilations"], promoted["cold_executions"],
                      promoted["executions"]),
                     snap["autotune"]["arena"],
                     snap["models"]["tuned:1"]["autotune"])
    assert got["port"] == got["jax"]
    out, ladder, compile_ns, promoted, arena, _ = got["port"]
    assert [(d["action"], d["bucket"], d["applied"]) for d in out] == [
        ("add_bucket", 3, True)]
    assert ladder == [1, 3, 8]
    assert compile_ns == 0 and promoted == (1, 0, 1)
    assert [r["name"] for r in arena["reservations"]] == [
        "bucket:tuned:1:1", "bucket:tuned:1:8", "bucket:tuned:1:3"]


def _bucket_plan(engine, model="tuned"):
    return sum(r["nbytes"] for r in
               engine.autotuner.arena.snapshot()["reservations"]
               if r["name"].startswith(f"bucket:{model}:"))


def test_the_census_holds_the_plan_and_the_recorder_reads_it(engines):
    port_row = _census_row(engines.port, "autotune_warm")
    jax_row = _census_row(engines.jax, "autotune_warm")
    assert port_row == jax_row
    assert port_row["plan_bytes"] == _bucket_plan(engines.port) == \
        _bucket_plan(engines.jax) > 0
    # The census's drift is the plan less the bytes tagged autotune_warm.
    assert port_row["drift_bytes"] == \
        port_row["plan_bytes"] - port_row["bytes"]
    for engine in (engines.port, engines.jax):
        assert engine.timeseries_sample()["hbm_reserved"] == \
            engine.autotuner.arena.reserved_bytes()


def test_an_unload_releases_the_reservations():
    import os

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import simple

    os.environ["CLIENT_TPU_AUTOTUNE"] = '{"interval_s": 3600}'
    try:
        repo = ModelRepository()
        repo.register("cycled", lambda device: _backend(simple, "cycled"))
        engine = TorchEngine(repo, device="cpu")
    finally:
        del os.environ["CLIENT_TPU_AUTOTUNE"]
    try:
        tuner = engine.autotuner
        assert _bucket_plan(engine, "cycled") > 0
        engine.unload_model("cycled")
        assert tuner.arena.reserved_bytes() == 0
        assert _census_row(engine, "autotune_warm", "cycled") is None
        engine.load_model("cycled")
        row = _census_row(engine, "autotune_warm", "cycled")
        assert row["plan_bytes"] == _bucket_plan(engine, "cycled") > 0
        assert row["drift_bytes"] == row["plan_bytes"] - row["bytes"]
    finally:
        engine.shutdown()
