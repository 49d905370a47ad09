"""Self-drive on the port held against the JAX package.

On a fake clock, with no threads and no sleeps, decision for decision:
the ``DispatchTuner`` over a scripted walk of profiler snapshots, queue
depths and service times (starved: tighten the batch cap and the gather
window; backlogged: restore at once, and on a busy card nudge the
admission concurrency cap down; quiet: restore a step per hold), and the
``SelfDriveGovernor``'s SLO-burn loop (tighten a burning model's admitted
rate a step per cooldown, restore a step per quiet hold) through each
package's own ``AdmissionController``. ``SelfDriveConfig`` parses alike,
the router rebalancer's five keys included.
On live engines a dispatch override caps the batches the scheduler
forms, alike, and ``CLIENT_TPU_SELFDRIVE`` puts the same ``selfdrive``
section into ``/v2/profile``.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from client_tpu import admission as jax_adm
from client_tpu.engine import autotune as jax_tune
from client_tpu.engine import config as jax_config
from client_tpu.engine import scheduler as jax_sched
from client_tpu.engine import selfdrive as jax_drive
from client_tpu.engine import types as jax_types
from client_tpu_torch import admission as port_adm
from client_tpu_torch.engine import autotune as port_tune
from client_tpu_torch.engine import config as port_config
from client_tpu_torch.engine import scheduler as port_sched
from client_tpu_torch.engine import selfdrive as port_drive
from client_tpu_torch.engine import types as port_types

TIMEOUT = 60  # seconds, every wait
PACKAGES = {
    "port": SimpleNamespace(adm=port_adm, tune=port_tune, config=port_config,
                            sched=port_sched, drive=port_drive,
                            types=port_types),
    "jax": SimpleNamespace(adm=jax_adm, tune=jax_tune, config=jax_config,
                           sched=jax_sched, drive=jax_drive, types=jax_types),
}


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _sched(pkg, name):
    """A scheduler of ``name`` with the package's own override methods."""
    cls = type("Sched", (), {
        "set_dispatch_override": pkg.sched.Scheduler.set_dispatch_override,
        "dispatch_overrides": pkg.sched.Scheduler.dispatch_overrides})
    s = cls()
    s._dispatch_override = None
    s.model = SimpleNamespace(config=pkg.config.ModelConfig(
        name=name, max_batch_size=16, instance_count=1,
        dynamic_batching=pkg.config.DynamicBatchingConfig(
            preferred_batch_size=[16], max_queue_delay_microseconds=4000)))
    s.depth = 0
    s.queue = SimpleNamespace(qsize=lambda: s.depth)
    return s


class _Slo:
    enabled = True

    def __init__(self):
        self.burning = []

    def fast_burn(self):
        return list(self.burning)


def _stub_engine(pkg, clock):
    scheds = {n: _sched(pkg, n) for n in ("a", "b")}
    state = {"snap": {"duty_cycle": 0.0, "models": {}}}
    return SimpleNamespace(
        profiler=SimpleNamespace(snapshot=lambda: state["snap"]),
        scheduler_for=lambda name, version="": scheds.get(name),
        admission=pkg.adm.AdmissionController(clock=clock),
        slo=_Slo(), scheds=scheds, state=state)


def _entry(name, execs, rows, padded):
    return {"model": name, "version": "1",
            "buckets": [{"bucket": 16, "executions": execs, "rows": rows,
                         "padded_rows": padded}]}


# (dt, duty, {model: (execs, rows, padded) cumulative}, depths, services,
#  burning)
WALK = [
    (1, 0.2, {"a": (10, 20, 140), "b": (10, 150, 10)}, {}, {}, []),
    (1, 0.2, {"a": (20, 40, 280), "b": (20, 300, 20)}, {}, {}, []),
    (40, 0.2, {"a": (30, 60, 420), "b": (30, 450, 30)}, {}, {}, ["a"]),
    (1, 0.95, {"a": (31, 70, 430), "b": (31, 466, 30)}, {"a": 40, "b": 9},
     {"a": 0.05, "b": 0.2}, ["a"]),
    (11, 0.95, {"a": (32, 80, 440), "b": (32, 482, 30)}, {"a": 40, "b": 9},
     {"a": 0.05}, ["a", "b"]),
    (31, 0.1, {"a": (32, 80, 440), "b": (32, 482, 30)}, {}, {}, []),
    (31, 0.1, {"a": (32, 80, 440), "b": (32, 482, 30)}, {}, {}, []),
    (11, 0.1, {"a": (42, 100, 580), "b": (32, 482, 30)}, {}, {}, []),
    (31, 0.1, {"a": (42, 100, 580), "b": (32, 482, 30)}, {}, {}, []),
    (31, 0.1, {"b": (32, 482, 30)}, {}, {}, []),
    (31, 0.1, {"b": (32, 482, 30)}, {}, {}, []),
    (31, 0.1, {"b": (32, 482, 30)}, {}, {}, []),
]


def _walk(pkg, config):
    clock = Clock()
    engine = _stub_engine(pkg, clock)
    gov = pkg.drive.SelfDriveGovernor(engine, config, clock=clock)
    out = []
    for dt, duty, models, depths, services, burning in WALK:
        clock.t += dt
        engine.state["snap"] = {
            "duty_cycle": duty,
            "models": {f"{n}:1": _entry(n, *m) for n, m in models.items()}}
        for name, s in engine.scheds.items():
            s.depth = depths.get(name, 0)
        for name, service in services.items():
            engine.admission.on_request_start(name)
            engine.admission.on_request_end(name, service)
        engine.slo.burning = burning
        decided = gov.tick()
        out.append((decided,
                    {n: s.dispatch_overrides()
                     for n, s in engine.scheds.items()},
                    {n: engine.admission.concurrency_cap(n)
                     for n in engine.scheds},
                    engine.admission.tightened_models()))
    return out, gov.snapshot()


@pytest.mark.parametrize("overrides", [
    {}, {"fill_low": 0.3, "min_calls": 4, "deadline_factor": 0.25},
    {"cooldown_s": 5, "restore_hold_s": 5, "burn_cooldown_s": 1,
     "burn_restore_hold_s": 20, "concurrency_floor": 4}],
    ids=["defaults", "loose", "fast"])
def test_dispatch_and_burn_loops_decide_as_jax(overrides):
    runs = {name: _walk(pkg, pkg.drive.SelfDriveConfig.from_dict(overrides))
            for name, pkg in PACKAGES.items()}
    assert runs["port"] == runs["jax"]
    actions = [d["action"] for step in runs["port"][0]
               for loop in step[0].values() for d in loop]
    assert "tighten" in actions and "restore" in actions
    assert {"dispatch", "concurrency"} & set(actions)


def test_the_tuner_alone_decides_as_jax():
    """The ``DispatchTuner`` driven directly (self-drive's dispatch loop
    without the burn loop), and its snapshot."""
    runs = {}
    for name, pkg in PACKAGES.items():
        clock = Clock()
        engine = _stub_engine(pkg, clock)
        tuner = pkg.tune.DispatchTuner(engine, clock=clock, cooldown_s=2,
                                       restore_hold_s=3)
        out = []
        for dt, duty, models, depths, services, _ in WALK:
            clock.t += dt
            engine.state["snap"] = {
                "duty_cycle": duty,
                "models": {f"{n}:1": _entry(n, *m)
                           for n, m in models.items()}}
            for n, s in engine.scheds.items():
                s.depth = depths.get(n, 0)
            for n, service in services.items():
                engine.admission.on_request_start(n)
                engine.admission.on_request_end(n, service)
            out.append(tuner.tick())
        runs[name] = (out, tuner.snapshot())
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("key,value", [
    ("rebalance_cooldown_s", 30), ("max_moves_per_window", 2),
    ("rebalance_window_s", 60), ("quiesce_wait_s", 1),
    ("drain_after_moves", True)])
def test_the_router_keys_are_refused(monkeypatch, key, value):
    """Each router rebalancer key is refused exactly where the JAX config
    refuses it: a good value parses to JAX's value and type with the whole
    summary equal, and a value that is no number draws the same 400 and
    words on both (``drain_after_moves`` takes any value, as ``bool``,
    on both)."""
    import json

    monkeypatch.setenv("CLIENT_TPU_SELFDRIVE", json.dumps({key: value}))
    jax_cfg = jax_drive.SelfDriveConfig.from_env()
    port_cfg = port_drive.SelfDriveConfig.from_env()
    assert getattr(port_cfg, key) == getattr(jax_cfg, key) == value
    assert type(getattr(port_cfg, key)) is type(getattr(jax_cfg, key))
    assert port_cfg.summary() == jax_cfg.summary()
    monkeypatch.setenv("CLIENT_TPU_SELFDRIVE", json.dumps({key: "x"}))
    got = []
    for drive in (jax_drive, port_drive):
        try:
            got.append(("ok", drive.SelfDriveConfig.from_env().summary()))
        except Exception as exc:  # noqa: BLE001 — either package's 400
            got.append(("refused", exc.status, str(exc)))
    assert got[0] == got[1]
    assert got[0][0] == ("ok" if key == "drain_after_moves" else "refused")


@pytest.mark.parametrize("raw", [
    None, "", "off", "on", '{"interval_s": 0.5, "min_calls": 3}',
    '{"interval_s": -1}', '{"burn_min_ratio": 0}', '{"fill_low": "x"}',
    '{"nope": 1}', "[]", "{bad"])
def test_selfdrive_config_parses_as_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("CLIENT_TPU_SELFDRIVE", raising=False)
    else:
        monkeypatch.setenv("CLIENT_TPU_SELFDRIVE", raw)
    got = []
    for pkg in PACKAGES.values():
        try:
            cfg = pkg.drive.SelfDriveConfig.from_env()
            got.append(("ok", None if cfg is None else cfg.summary()))
        except Exception as exc:  # noqa: BLE001 — either package's 400
            got.append(("error", exc.status, str(exc).split(" (")[0]))
    assert got[0] == got[1]


# -- live engines ---------------------------------------------------------------


def _backend(simple_mod, config_mod):
    b = simple_mod.AddSubBackend(name="driven", max_batch_size=8)
    b.config.instance_count = 1
    b.config.dynamic_batching = config_mod.DynamicBatchingConfig(
        preferred_batch_size=[8], max_queue_delay_microseconds=0)
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

    os.environ["CLIENT_TPU_SELFDRIVE"] = '{"interval_s": 3600}'
    try:
        jax_repo = JaxRepo()
        jax_repo.register_backend(_backend(jax_simple, jax_config))
        repo = ModelRepository()
        repo.register("driven", lambda device: _backend(simple, port_config))
        sides = {"port": TorchEngine(repo, device="cpu"),
                 "jax": TpuEngine(jax_repo)}
    finally:
        del os.environ["CLIENT_TPU_SELFDRIVE"]
    yield sides
    for engine in sides.values():
        engine.shutdown()


def test_a_dispatch_override_caps_the_batches_alike(engines):
    """The worker held on one request while six queue; with the batch
    cap at 2 they run as three batches of two, on both engines."""
    got = {}
    for name, engine in engines.items():
        types = PACKAGES[name].types
        sched = engine.scheduler_for("driven")
        sched.set_dispatch_override(max_batch=2, max_queue_delay_us=0)
        model = sched.model
        entered, release, sizes = (threading.Event(), threading.Event(),
                                   [])
        inner = model.execute_timed

        def gated(inputs, batch_size=None, **kw):
            if not entered.is_set():
                entered.set()
                assert release.wait(TIMEOUT)
            sizes.append(batch_size)
            return inner(inputs, batch_size=batch_size, **kw)

        model.execute_timed = gated
        done = threading.Semaphore(0)
        a = np.ones((1, 16), np.int32)
        for i in range(7):
            engine.async_infer(types.InferRequest(
                model_name="driven", inputs={"INPUT0": a, "INPUT1": a},
                request_id=str(i)), lambda resp: done.release())
            if i == 0:
                assert entered.wait(TIMEOUT)
        release.set()
        for _ in range(7):
            assert done.acquire(timeout=TIMEOUT)
        got[name] = (sizes, sched.dispatch_overrides())
        sched.set_dispatch_override()
        del model.execute_timed
    assert got["port"] == got["jax"]
    assert got["port"] == ([1, 2, 2, 2], {"max_batch": 2,
                                          "max_queue_delay_us": 0})


def test_the_profile_carries_the_selfdrive_section(engines):
    sections = {name: engine.profile_snapshot()["selfdrive"]
                for name, engine in engines.items()}
    assert sections["port"] == sections["jax"]
    assert sections["port"]["enabled"] is True
    for engine in engines.values():
        assert engine.selfdrive._thread is not None
