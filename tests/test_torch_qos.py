"""QoS, priority levels and queue policies on the port, held against the
JAX package.

Decision for decision on injected clocks, with no sleeps: ``QosConfig``
parsing (errors included), ``classify``, the per-class admission gates
and their pushback, the SLO-burn governor's victims and restores over
stub SLO and cost ledgers, and the served order of the weighted fair
queue for one seeded arrival trace. On live engines (one worker held on
a gate around ``Model.execute_timed``): interactive requests leave ahead
of batch ones, an interactive arrival splits a batch-class gather, a
full priority level sheds with the JAX engine's words,
the REJECT and DELAY timeouts, ``preserve_ordering``'s release order,
and ``/v2/qos`` and the ``Qos`` RPC answer the JAX engine's body.
"""

import http.client
import importlib
import json
import threading
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from client_tpu.admission import qos as jax_qos
from client_tpu.engine import config as jax_config
from client_tpu.engine import scheduler as jax_sched
from client_tpu.engine import types as jax_types
from client_tpu_torch.admission import qos as port_qos
from client_tpu_torch.engine import config as port_config
from client_tpu_torch.engine import scheduler as port_sched
from client_tpu_torch.engine import types as port_types

TIMEOUT = 60  # seconds, every wait
QOS = {"classes": {
    "interactive": {"weight": 4, "preempt": True, "protect": True},
    "batch": {"weight": 1, "priority_level": 2, "tokens_per_s": 5,
              "burst": 2},
    "shadow": {"weight": 1, "min_priority": 8, "tokens_per_s": 10,
               "max_inflight": 2, "max_queue_depth": 3}},
    "tenants": {"ui": "interactive", "etl": "batch", "replay": "shadow"},
    "default_class": "interactive"}
# The engines': the two classes of a mixed workload, no quotas.
ENGINE_QOS = {"classes": {
    "interactive": {"weight": 4, "preempt": True},
    "batch": {"weight": 1}},
    "tenants": {"ui": "interactive", "etl": "batch"},
    "default_class": "interactive"}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — either package's errors
        return ("error", type(exc).__name__, str(exc),
                getattr(exc, "status", None),
                getattr(exc, "retry_after_s", None),
                getattr(exc, "reason", None))


# -- the controller -------------------------------------------------------------


@pytest.mark.parametrize("raw", [
    QOS,
    {},
    {"classes": {"a": {"weight": 2}, "b": {"weight": 2}}},
    {"classes": {"default": {}, "z": {"weight": 9}}},
    {"classes": {"a": {"weight": 0}}},
    {"classes": {"a": {"wieght": 1}}},
    {"classes": {"a": {}}, "tenants": {"t": "nope"}},
    {"classes": {"a": {}}, "default_class": "nope"},
    {"klasses": {}},
], ids=["full", "empty", "tie", "named_default", "zero_weight", "typo",
        "bad_tenant", "bad_default", "bad_key"])
def test_config_parses_as_jax(raw):
    def parse(mod):
        cfg = mod.QosConfig.from_dict(raw)
        return (cfg.enabled, cfg.default_class, sorted(cfg.tenants.items()),
                {n: vars(c) for n, c in cfg.classes.items()})

    assert _outcome(lambda: parse(port_qos)) == \
        _outcome(lambda: parse(jax_qos))


def test_config_from_the_environment_as_jax(tmp_path):
    path = tmp_path / "qos.json"
    path.write_text(json.dumps(QOS))
    for value in (json.dumps(QOS), f"@{path}", ""):
        env = {"CLIENT_TPU_QOS": value}
        got = port_qos.QosConfig.from_env(env)
        want = jax_qos.QosConfig.from_env(env)
        assert (got.enabled, got.default_class, list(got.classes)) \
            == (want.enabled, want.default_class, list(want.classes))


@pytest.mark.parametrize("tenant,priority", [
    ("ui", 0), ("etl", 0), ("etl", 9), ("replay", 1), ("", 0), ("", 7),
    ("", 8),
    ("", 50), ("other", 8), ("other", 1)])
def test_classify_as_jax(tenant, priority):
    ctls = [mod.QosController(mod.QosConfig.from_dict(QOS))
            for mod in (port_qos, jax_qos)]
    got = [(c.classify(tenant, priority),
            c.priority_level(c.classify(tenant, priority)))
           for c in ctls]
    assert got[0] == got[1]
    off = [mod.QosController() for mod in (port_qos, jax_qos)]
    assert [c.classify(tenant, priority) for c in off] == ["", ""]


def test_admit_gates_and_pushback_as_jax():
    """One scripted walk on each controller: the batch class's quota
    (with refills on the clock), the shadow class's in-flight and queue
    caps, and the counts in the snapshot."""
    script = [("admit", "batch", 0)] * 3 + [("tick", 0.1)] \
        + [("admit", "batch", 0), ("tick", 0.5), ("admit", "batch", 0)] \
        + [("start", "shadow"), ("start", "shadow"),
           ("admit", "shadow", 0), ("end", "shadow"),
           ("admit", "shadow", 3), ("admit", "shadow", 2),
           ("admit", "interactive", 99), ("admit", "nope", 0)]
    runs = []
    for mod in (port_qos, jax_qos):
        clock = Clock()
        ctl = mod.QosController(mod.QosConfig.from_dict(QOS), clock=clock)
        out = []
        for step in script:
            if step[0] == "tick":
                clock.t += step[1]
            elif step[0] == "start":
                ctl.on_request_start(step[1])
            elif step[0] == "end":
                ctl.on_request_end(step[1])
            else:
                out.append(_outcome(lambda s=step: ctl.admit(
                    "m", s[1], class_queue_depth=s[2])))
        snap = ctl.snapshot()
        runs.append((out, snap))
    assert runs[0] == runs[1]
    outs = [o[0] for o in runs[0][0]]
    assert outs.count("error") == 4


class _Slo:
    def __init__(self):
        self.burning = []

    def fast_burn(self):
        return list(self.burning)


class _Costs:
    def __init__(self):
        self.tenants = {}

    def snapshot(self):
        return {"tenants": {t: dict(v) for t, v in self.tenants.items()}}


def test_governor_victims_and_restores_as_jax():
    """Burning: the non-protected, bucket-carrying class whose occupancy
    grew the most is throttled a step per tick; clear for the hold: the
    throttled classes walk back a step per tick."""
    trace = [
        (["m"], {"etl": 1.0, "replay": 0.2}),
        (["m"], {"etl": 1.1, "replay": 2.0}),
        (["m"], {"etl": 1.2, "replay": 2.0}),
        (["m"], {"etl": 1.2, "replay": 2.0}),
        ([], {"etl": 1.2, "replay": 2.0}),
    ] + [([], {"etl": 1.2, "replay": 2.0, "ui": 9.0})] * 8
    runs = []
    for mod in (port_qos, jax_qos):
        clock, slo, costs = Clock(), _Slo(), _Costs()
        ctl = mod.QosController(mod.QosConfig.from_dict(QOS), clock=clock)
        out = []
        for burning, occupancy in trace:
            clock.t += 1.0
            slo.burning = burning
            costs.tenants = {t: {"device_s": v, "host_s": 0.0,
                                 "padding_s": 0.0}
                             for t, v in occupancy.items()}
            out.append((ctl.governor_tick(slo, costs),
                        sorted(ctl.throttled_classes())))
        snap = ctl.snapshot()
        runs.append((out, snap))
    assert runs[0] == runs[1]
    assert runs[0][0][0][0] == "batch"
    assert "shadow" in [t[0] for t in runs[0][0]]
    assert runs[0][1]["classes"]["interactive"]["throttles"] == 0


def _requests(mod, n, seed):
    """``n`` requests with a seeded class, level and id."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(mod.InferRequest(
            model_name="m", inputs={}, request_id=f"r{i}",
            qos_class=str(rng.choice(["interactive", "batch", "shadow",
                                      ""])),
            priority=int(rng.integers(0, 3))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wfq_served_order_as_jax(seed):
    """One seeded trace of puts (levels, a few pushbacks) and pops of
    random slab sizes: the same requests leave in the same order, a
    shutdown marker only once the class lanes are empty."""
    orders = []
    for types, sched, mod in ((port_types, port_sched, port_qos),
                              (jax_types, jax_sched, jax_qos)):
        rng = np.random.default_rng(seed + 10)
        q = sched._WfqQueue(mod.QosController(mod.QosConfig.from_dict(QOS)))
        reqs = _requests(types, 40, seed)
        served = []
        it = iter(reqs)
        for step in range(60):
            action = rng.integers(0, 4)
            if action < 2:
                r = next(it, None)
                if r is not None:
                    assert q.put(r, r.priority)
            elif action == 2 and served:
                back = served.pop()
                q.put_front(back, back.priority)
            else:
                try:
                    served += q.get_many(int(rng.integers(1, 5)), timeout=0)
                except Exception:  # noqa: BLE001 — queue.Empty
                    pass
            if step == 50:
                q.put(sched._SHUTDOWN, sched._SHUTDOWN_LEVEL)
        for r in it:
            q.put(r, r.priority)
        q.put(sched._SHUTDOWN, sched._SHUTDOWN_LEVEL)
        depths = (q.qsize(), {c: q.class_qsize(c)
                              for c in ("interactive", "batch", "shadow")},
                  [q.level_qsize(lv) for lv in range(3)],
                  q.preempt_pending())
        while q.qsize():
            served += q.get_many(3, timeout=0)
        orders.append(([getattr(r, "request_id", "SHUTDOWN")
                        for r in served], depths))
    assert orders[0] == orders[1]
    assert orders[0][0][-1] == "SHUTDOWN"
    assert orders[0][0].count("SHUTDOWN") == 2


# -- live engines ---------------------------------------------------------------


def _backend(simple_mod, config_mod, name, **dyn):
    b = simple_mod.AddSubBackend(name=name, max_batch_size=4)
    b.config.instance_count = 1
    # "preempt" gathers for 300 ms, so only a split ends its batch early.
    b.config.dynamic_batching = config_mod.DynamicBatchingConfig(
        preferred_batch_size=[4], max_queue_delay_microseconds=(
            300_000 if name == "preempt" else 0), **dyn)
    return b


LEVELS = dict(priority_levels=2, default_priority_level=2,
              priority_queue_policy=None)


def _models(config_mod):
    qp = config_mod.QueuePolicy
    return {
        "q": {},
        "levels": dict(priority_levels=2, default_priority_level=2,
                       priority_queue_policy={1: qp(max_queue_size=2)}),
        "timeouts": dict(
            priority_levels=2, default_priority_level=1,
            default_queue_policy=qp(default_timeout_microseconds=1000),
            priority_queue_policy={2: qp(
                timeout_action="DELAY", default_timeout_microseconds=1000,
                allow_timeout_override=False)}),
        "preempt": {},
        "ordered": dict(preserve_ordering=True),
        "ordered_prio": dict(preserve_ordering=True, priority_levels=2),
    }


class _Gate:
    """Holds a model's first ``n`` executions until released, and logs
    every execution's batch size."""

    def __init__(self, model, n=1):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.sizes = []
        self.left = n
        inner = model.execute_timed

        def gated(inputs, batch_size=None, **kw):
            if self.left > 0:
                self.left -= 1
                self.entered.set()
                assert self.release.wait(TIMEOUT)
            self.sizes.append(batch_size)
            return inner(inputs, batch_size=batch_size, **kw)

        model.execute_timed = gated


@pytest.fixture(scope="module")
def engines():
    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepo
    from client_tpu.models import simple as jax_simple
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import simple
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    jax_repo = JaxRepo()
    for name, dyn in _models(jax_config).items():
        jax_repo.register_backend(_backend(jax_simple, jax_config, name,
                                           **dyn))
    repo = ModelRepository()
    for name, dyn in _models(port_config).items():
        repo.register(name, lambda device, n=name, d=dyn: _backend(
            simple, port_config, n, **d))
    sides = {}
    for side, engine, http_cls, grpc_cls, types in (
            ("port", TorchEngine(repo, device="cpu",
                                 qos=port_qos.QosController(
                                     port_qos.QosConfig.from_dict(
                                         ENGINE_QOS))),
             HttpInferenceServer, GrpcInferenceServer, port_types),
            ("jax", TpuEngine(jax_repo, qos=jax_qos.QosController(
                jax_qos.QosConfig.from_dict(ENGINE_QOS))), JaxHttp, JaxGrpc,
             jax_types)):
        sides[side] = SimpleNamespace(
            engine=engine, types=types, http=http_cls(engine, port=0).start(),
            grpc=grpc_cls(engine, port=0).start())
    yield sides
    for side in sides.values():
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _submit(side, model, rid, tenant="", priority=0, timeout_us=0,
            log=None, done=None):
    a = np.full((1, 16), int(rid[1:]) if rid[1:].isdigit() else 1,
                np.int32)
    req = side.types.InferRequest(
        model_name=model, inputs={"INPUT0": a, "INPUT1": a},
        request_id=rid, tenant=tenant, priority=priority,
        timeout_us=timeout_us)

    def cb(resp):
        if log is not None:
            log.append((rid, None if resp.error is None
                        else (resp.error.status, str(resp.error))))
        if done is not None:
            done.release()

    side.engine.async_infer(req, cb)


def _wait(done, n):
    for _ in range(n):
        assert done.acquire(timeout=TIMEOUT)


def test_interactive_requests_leave_ahead_of_batch_ones(engines):
    """The worker held on a batch request; four batch-class and then
    four interactive requests queue; released, the interactive ones make
    the first wave, on both engines alike."""
    orders = {}
    for name, side in engines.items():
        model = side.engine.scheduler_for("q").model
        gate = _Gate(model)
        log, done = [], threading.Semaphore(0)
        _submit(side, "q", "r0", tenant="etl", log=log, done=done)
        assert gate.entered.wait(TIMEOUT)
        for i in range(1, 5):
            _submit(side, "q", f"b{i}", tenant="etl", log=log, done=done)
        for i in range(1, 5):
            _submit(side, "q", f"i{i}", tenant="ui", log=log, done=done)
        qsnap = side.engine.qos_snapshot(model="q")
        gate.release.set()
        _wait(done, 9)
        orders[name] = (log, gate.sizes, qsnap["queues"])
        del model.execute_timed
    assert orders["port"] == orders["jax"]
    log, sizes, queues = orders["port"]
    assert [rid for rid, _ in log] == \
        ["r0", "i1", "i2", "i3", "i4", "b1", "b2", "b3", "b4"]
    assert all(err is None for _, err in log)
    assert sizes == [1, 4, 4]
    assert queues == {"q": {"interactive": 4, "batch": 4}}


def test_an_interactive_arrival_splits_a_batch_class_gather(engines):
    """An interactive request lands just after a batch-class request was
    popped: that gather runs alone at once instead of waiting out its
    300 ms window, and the interactive request leads the next batch."""
    got = {}
    for name, side in engines.items():
        sched = side.engine.scheduler_for("preempt")
        gate = _Gate(sched.model)
        log, done = [], threading.Semaphore(0)
        _submit(side, "preempt", "r0", tenant="etl", log=log, done=done)
        assert gate.entered.wait(TIMEOUT)
        for rid in ("b1", "b2"):
            _submit(side, "preempt", rid, tenant="etl", log=log, done=done)
        pop = sched.queue.get_many

        def get_many(max_items, timeout=None):
            items = pop(max_items, timeout=timeout)
            if sched.queue.get_many is get_many:
                del sched.queue.get_many
                _submit(side, "preempt", "i1", tenant="ui", log=log,
                        done=done)
            return items

        sched.queue.get_many = get_many
        before = side.engine.qos_snapshot()["classes"]["interactive"][
            "preemptions"]
        gate.release.set()
        _wait(done, 4)
        after = side.engine.qos_snapshot()["classes"]["interactive"][
            "preemptions"]
        got[name] = (log, gate.sizes, after - before)
        del sched.model.execute_timed
    assert got["port"] == got["jax"]
    log, sizes, preemptions = got["port"]
    assert [rid for rid, _ in log] == ["r0", "b1", "i1", "b2"]
    assert sizes == [1, 1, 2] and preemptions == 1


def test_a_full_priority_level_sheds_with_the_jax_words(engines):
    got = {}
    for name, side in engines.items():
        model = side.engine.scheduler_for("levels").model
        gate = _Gate(model)
        log, done = [], threading.Semaphore(0)
        _submit(side, "levels", "r0", log=log, done=done)
        assert gate.entered.wait(TIMEOUT)
        sheds = []
        for i in range(1, 5):
            try:
                _submit(side, "levels", f"r{i}", priority=1, log=log,
                        done=done)
            except Exception as exc:  # noqa: BLE001 — the 429
                sheds.append((f"r{i}", exc.status, str(exc)))
        _submit(side, "levels", "r9", priority=2, log=log, done=done)
        stats = side.engine.model_statistics("levels")
        gate.release.set()
        _wait(done, 4)
        got[name] = (sheds, log,
                     stats["model_stats"][0]["inference_count"])
        del model.execute_timed
    assert got["port"] == got["jax"]
    sheds = got["port"][0]
    assert [s[0] for s in sheds] == ["r3", "r4"]
    assert sheds[0][1] == 429
    assert "priority level 1" in sheds[0][2]
    # Level 1 leaves ahead of level 2.
    assert [rid for rid, _ in got["port"][1]] == ["r0", "r1", "r2", "r9"]


@pytest.mark.parametrize("priority,timeout_us,waited_us", [
    (1, 0, 500), (1, 0, 5000), (1, 200, 500), (1, 9000, 5000),
    (2, 0, 5000), (2, 100, 5000), (0, 0, 5000)])
def test_queue_timeouts_reject_or_delay_as_jax(engines, priority,
                                               timeout_us, waited_us):
    """``_check_timeout`` on a request that waited ``waited_us``: level 1
    rejects after 1 ms unless the request's own timeout overrides; level
    2 delays (runs anyway) and takes no override."""
    got = {}
    for name, side in engines.items():
        sched = side.engine.scheduler_for("timeouts")
        log = []
        req = side.types.InferRequest(
            model_name="timeouts", inputs={}, request_id="t",
            priority=priority, timeout_us=timeout_us,
            response_callback=lambda resp, log=log: log.append(
                (resp.error.status, str(resp.error))))
        req.times.queue_start = side.types.now_ns() - waited_us * 1000
        before = sched.stats.rejection_count
        got[name] = (sched._priority_level(req), sched._check_timeout(req),
                     log, sched.stats.rejection_count - before)
    assert got["port"] == got["jax"]


def test_preserve_ordering_releases_in_arrival_order_as_jax(engines):
    got = {}
    for name, side in engines.items():
        sched = side.engine.scheduler_for("ordered")
        delivered = []
        reqs = []
        for i in range(5):
            r = side.types.InferRequest(
                model_name="ordered", inputs={}, request_id=f"o{i}",
                response_callback=lambda resp: delivered.append(
                    resp.request_id))
            with sched._order_lock:
                r.arrival_seq = sched._arrival_seq
                sched._arrival_seq += 1
            reqs.append(r)
        for i in (2, 0, 4, 1, 3):
            sched._respond(reqs[i], side.types.InferResponse(
                model_name="ordered", model_version="1",
                request_id=reqs[i].request_id, outputs={}))
            delivered.append(f"after {i}")
        got[name] = delivered
    assert got["port"] == got["jax"]
    assert [d for d in got["port"] if not d.startswith("after")] == \
        [f"o{i}" for i in range(5)]


def test_ordering_with_priority_levels_fails_the_load_as_jax(engines):
    """The scheduler refuses the combination (400), so the model gets no
    scheduler and its requests answer as the JAX engine's do."""
    got = {}
    for name, side in engines.items():
        row = {e["name"]: (e["state"], e.get("reason"))
               for e in side.engine.repository_index()}["ordered_prio"]
        a = np.ones((1, 16), np.int32)
        got[name] = (row, side.engine.scheduler_for("ordered_prio"),
                     _outcome(lambda side=side: side.engine.infer(
                         side.types.InferRequest(
                             model_name="ordered_prio",
                             inputs={"INPUT0": a, "INPUT1": a}),
                         timeout_s=TIMEOUT)))
    assert got["port"] == got["jax"]
    assert got["port"][1] is None and got["port"][2][0] == "error"
    from client_tpu_torch.engine.scheduler import make_scheduler
    from client_tpu_torch.engine.stats import ModelStats

    model = engines["port"].engine.repository.get("ordered_prio")
    with pytest.raises(port_types.EngineError) as exc:
        make_scheduler(model, ModelStats("ordered_prio"))
    assert exc.value.status == 400
    assert "preserve_ordering cannot be combined with priority_levels" \
        in str(exc.value)


def _http_qos(side, query=""):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request("GET", "/v2/qos" + query)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("query", ["", "?model=q"])
def test_qos_route_and_rpc_answer_the_jax_body(engines, query):
    from client_tpu_torch.protocol import grpc_stub
    from client_tpu_torch.protocol import ops_pb2 as ops

    got = {name: _http_qos(side, query) for name, side in engines.items()}
    assert got["port"] == got["jax"]
    status, body = got["port"]
    assert status == 200 and body["enabled"] is True
    assert set(body["classes"]) == {"interactive", "batch"}
    with grpc.insecure_channel(engines["port"].grpc.url) as channel:
        stub = grpc_stub.GRPCInferenceServiceStub(channel)
        reply = stub.Qos(ops.QosRequest(model=query.partition("=")[2]),
                         timeout=TIMEOUT)
    assert json.loads(reply.qos_json) == body


def test_both_clients_read_qos_status(engines):
    import client_tpu_torch.grpc as port_grpc
    import client_tpu_torch.http as port_http

    side = engines["port"]
    h = port_http.InferenceServerClient(side.http.url)
    g = port_grpc.InferenceServerClient(side.grpc.url)
    try:
        want = _http_qos(side, "?model=q")[1]
        assert h.get_qos_status("q") == want
        assert g.get_qos_status("q") == want
    finally:
        h.close()
        g.close()


def test_no_qos_keeps_the_priority_heap():
    """Without a controller the schedulers queue by level alone and
    ``/v2/qos`` reports QoS off, on both engines."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository

    bodies, kinds = [], []
    for engine in (TorchEngine(build_repository(["simple"]), device="cpu"),
                   TpuEngine(jax_build(["simple"]))):
        try:
            bodies.append(engine.qos_snapshot())
            kinds.append(type(engine.scheduler_for("simple").queue).__name__)
        finally:
            engine.shutdown()
    assert bodies[0] == bodies[1]
    assert bodies[0]["enabled"] is False and bodies[0]["queues"] == {}
    assert kinds == ["_ReqQueue", "_ReqQueue"]


def test_qos_module_loads_no_jax():
    mod = importlib.import_module("client_tpu_torch.admission.qos")
    assert "jax" not in mod.__dict__
