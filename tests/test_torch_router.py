"""The port's router (``client_tpu_torch/router``) against the JAX
package's.

* Each case of ``tests/test_router.py`` (selection, failover and
  pushback, placement, the rolling drain with fake triggers, the
  frontend) runs on the port: the reference's test method, its module
  globals (``Router``, ``Replica``, ``RouterHttpServer``, the placement
  and drain functions, ``LoadReport``, ``CircuitBreaker``, its
  ``_router`` helper) bound to the port's, against the same scriptable
  fake replicas.
* Decision for decision: with the same seed and the same load reports,
  ``candidates()`` gives the same order as JAX's over 1,000 draws (P2C
  and affinity); both routers shed with the same status, minimum
  ``Retry-After`` and words, answer the same 502 and pass the same 500
  through; ``status()`` has the same keys; placement plans, moves and
  the budget guard equal JAX's on the same inputs, and ``rolling_drain``
  reports the same outcomes on the same stubs.
"""

import inspect
import json
import random
import types

import pytest

import client_tpu.protocol.loadreport as jax_lr
import client_tpu.resilience as jax_res
import client_tpu.router as jax_router
import client_tpu.router.core as jax_core
import client_tpu.router.placement as jax_place
import test_router as ref
from client_tpu_torch import resilience as port_res
from client_tpu_torch import router as port_router
from client_tpu_torch.protocol import loadreport as port_lr
from client_tpu_torch.router import core as port_core
from client_tpu_torch.router import placement as port_place

PORT_GLOBALS = {
    "LOAD_HEADER": port_lr.LOAD_HEADER,
    "LoadReport": port_lr.LoadReport,
    "CircuitBreaker": port_res.CircuitBreaker,
    "Replica": port_router.Replica,
    "Router": port_router.Router,
    "RouterHttpServer": port_router.RouterHttpServer,
    "placement_moves": port_router.placement_moves,
    "plan_placement": port_router.plan_placement,
    "rendezvous_pick": port_router.rendezvous_pick,
    "replicas_from_hostlist": port_router.replicas_from_hostlist,
    "rolling_drain": port_router.rolling_drain,
    "normalize_replica_url": port_core.normalize_replica_url,
    "model_costs": port_place.model_costs,
}


def _ported(fn):
    """``fn`` with its module globals bound to the port's names."""
    env = {**fn.__globals__, **PORT_GLOBALS}
    env["_router"] = types.FunctionType(
        ref._router.__code__, env, "_router", ref._router.__defaults__)
    assert env["Router"].__module__ == "client_tpu_torch.router.core"
    return types.FunctionType(fn.__code__, env, fn.__name__,
                              fn.__defaults__, fn.__closure__)


REF_CASES = sorted(
    (cls_name, name)
    for cls_name, cls in vars(ref).items()
    if cls_name.startswith("Test") and inspect.isclass(cls)
    for name, fn in vars(cls).items()
    if name.startswith("test_") and inspect.isfunction(fn))


@pytest.fixture
def fakes():
    """The reference's two scriptable fake replicas."""
    servers = [ref._FakeReplica(), ref._FakeReplica()]
    yield servers
    for s in servers:
        s.stop()


def test_the_reference_has_its_cases():
    assert len(REF_CASES) == 26


def test_the_port_exports_the_routers_names():
    assert port_router.__all__ == jax_router.__all__


@pytest.mark.parametrize("cls_name,name", REF_CASES,
                         ids=[f"{c}.{n}" for c, n in REF_CASES])
def test_reference_case_on_the_port(cls_name, name, request):
    fn = getattr(ref, cls_name).__dict__[name]
    params = list(inspect.signature(fn).parameters)[1:]
    kwargs = {p: request.getfixturevalue(p) for p in params}
    _ported(fn)(getattr(ref, cls_name)(), **kwargs)


# -- decision for decision --------------------------------------------------------

PKGS = {
    "port": types.SimpleNamespace(core=port_core, lr=port_lr, res=port_res,
                                  place=port_place,
                                  drain=port_router.rolling_drain),
    "jax": types.SimpleNamespace(core=jax_core, lr=jax_lr, res=jax_res,
                                 place=jax_place,
                                 drain=jax_router.rolling_drain),
}


def _fleet(pkg, n: int, seed: int, reports: list, outstanding: list,
           affinity: bool = True):
    """A router over ``n`` replicas that are never contacted, their load
    views set by hand."""
    router = pkg.core.Router(
        [f"10.0.0.{i}:8000" for i in range(n)], seed=seed,
        affinity=affinity, poll_interval_s=3600.0)
    for r, rep, out in zip(router.replicas, reports, outstanding):
        r.observe_report(pkg.lr.LoadReport(**rep))
        r.outstanding = out
    return router


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 7), (5, 1234), (8, 99)])
def test_candidates_order_equals_jax(n, seed):
    rng = random.Random(seed)
    reports = [dict(state=rng.choice(("READY", "READY", "DEGRADED")),
                    inflight=rng.randrange(8), queue_depth=rng.randrange(8),
                    wait_s=rng.random() * 0.05) for _ in range(n)]
    outstanding = [rng.randrange(3) for _ in range(n)]
    orders = {}
    for name, pkg in PKGS.items():
        router = _fleet(pkg, n, seed, reports, outstanding)
        draws = []
        for i in range(1000):
            seq = 0 if i % 3 else i
            draws.append([r.id for r in router.candidates(seq)])
            if i == 500:  # a replica quiesced mid-way changes the pool
                router.quiesce(router.replicas[0].id)
        orders[name] = draws
    assert orders["port"] == orders["jax"]
    assert len({tuple(d[:1]) for d in orders["port"]}) > 1


def test_candidates_without_affinity_equal_jax():
    reports = [dict(inflight=i) for i in range(4)]
    orders = {name: [[r.id for r in _fleet(
        pkg, 4, 5, reports, [0] * 4, affinity=False).candidates(s)]
        for s in range(50)] for name, pkg in PKGS.items()}
    assert orders["port"] == orders["jax"]


def _forward(pkg, fakes, behaviors):
    for f, b in zip(fakes, behaviors):
        f.behavior = b
    router = pkg.core.Router([pkg.core.Replica(f.url) for f in fakes],
                             seed=3, poll_interval_s=3600.0)
    router.refresh()
    try:
        out = router.forward("POST", "/v2/models/m/infer", body=b"{}")
        headers = [(k, v) for k, v in out.headers
                   if k not in ("X-Tpu-Trace-Id", "Date", "Server")]
        return out.status, sorted(headers), json.loads(out.body), \
            sorted(router.status()["replicas"][r.id]["breaker"]
                   for r in router.replicas)
    finally:
        router.stop()


def _answer(status, retry_after=None, state=None, error="x"):
    headers = []
    if retry_after is not None:
        headers.append(("Retry-After", retry_after))
    if state is not None:
        headers.append(("X-Health-State", state))

    def behavior(method, path):
        if path in ("/v2/load", "/v2/health/ready"):
            return ref._FakeReplica.default_behavior(None, method, path)
        return status, headers, json.dumps({"error": error}).encode()
    return behavior


@pytest.mark.parametrize("answers", [
    ((429, "0.750"), (503, "0.250")),
    ((503, "2.000", "DRAINING"), (503, "0.125", "DRAINING")),
    ((429, None), (429, "1.500")),
    ((500, None), (500, None)),
    ((503, None), (500, None)),
], ids=["min-retry-after", "draining", "no-retry-after", "all-500",
        "pushback-and-500"])
def test_shed_and_error_answers_equal_jax(fakes, answers):
    got = {name: _forward(pkg, fakes, [_answer(*a) for a in answers])
           for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]


def test_no_reachable_replica_is_the_same_502(fakes):
    for f in fakes:
        f.stop()
    got = {}
    for name, pkg in PKGS.items():
        router = pkg.core.Router([pkg.core.Replica(f.url) for f in fakes],
                                 seed=3, poll_interval_s=3600.0)
        outs = [router.forward("POST", "/v2/models/m/infer", body=b"{}")
                for _ in range(4)]
        # The last answer's Retry-After is the breakers' cooldown left,
        # read off the clock: to 0.1 s.
        got[name] = [(o.status, o.header("X-Router-Shed"),
                      o.header("Retry-After") and round(
                          float(o.header("Retry-After")), 1),
                      json.loads(o.body)) for o in outs]
        router.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == (502, "no_replica")
    assert got["port"][-1][0] == 503  # every breaker open: when to retry


def test_status_keys_equal_jax(fakes):
    got = {}
    for name, pkg in PKGS.items():
        router = pkg.core.Router([pkg.core.Replica(f.url, pid=1234)
                                  for f in fakes], poll_interval_s=3600.0)
        router.refresh()
        status = router.status()
        got[name] = (sorted(status), {rid: sorted(row) for rid, row in
                                      status["replicas"].items()},
                     sorted(next(iter(status["replicas"].values()))["load"]))
        router.stop()
    assert got["port"] == got["jax"]


def test_router_metrics_render_as_jax(fakes):
    texts = {}
    for name, pkg in PKGS.items():
        router = pkg.core.Router([pkg.core.Replica(f.url) for f in fakes],
                                 seed=11, poll_interval_s=3600.0)
        router.refresh()
        for i in range(20):
            router.forward("POST", "/v2/models/m/infer", body=b"{}",
                           sequence_id=i % 4)
        lines = [ln for ln in router.metrics.render().splitlines()
                 if "duration_us" not in ln and "age_seconds" not in ln]
        texts[name] = lines
        router.stop()
    assert texts["port"] == texts["jax"]


# -- placement and the drain walk ----------------------------------------------------


def _profiles(rng, replicas, models):
    return {rid: {"models": {
        f"{m}:1": {"model": m, "device_s": rng.random() * 10,
                   "hbm_bytes": rng.choice((0, 1 << 28, 3 << 30))}
        for m in rng.sample(models, rng.randrange(1, len(models) + 1))},
        "memory": {"bytes_limit": rng.choice((0, 8 << 30)),
                   "committed_bytes": rng.randrange(4 << 30)}}
        for rid in replicas}


@pytest.mark.parametrize("seed", range(6))
def test_placement_equals_jax(seed):
    rng = random.Random(seed)
    replicas = [f"r{i}" for i in range(rng.randrange(1, 5))]
    models = [f"m{i}" for i in range(rng.randrange(1, 7))]
    profiles = _profiles(rng, replicas, models)
    costs_ledger = {"tenants": {"t": {"models": {
        f"{m}:1": {"interference": {"co_batch_s": rng.random(),
                                    "queue_wait_s": rng.random()}}
        for m in models}}}}
    current = {rid: set(rng.sample(models, rng.randrange(len(models) + 1)))
               for rid in replicas}
    got = {}
    for name, pkg in PKGS.items():
        costs = pkg.place.model_costs(profiles, costs=costs_ledger)
        plan = pkg.place.plan_placement(
            costs, replicas, current=current,
            min_replicas_per_model=1 + seed % 2)
        moves = pkg.place.placement_moves(plan, current)
        got[name] = (costs, plan, moves,
                     pkg.place.budget_guard(moves, profiles),
                     pkg.place.model_hbm_bytes(profiles),
                     pkg.place.interference_costs(costs_ledger))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("case", ["clean", "gate", "trigger-fails", "no-pid"])
def test_rolling_drain_reports_equal_jax(fakes, case):
    got = {}
    for name, pkg in PKGS.items():
        state = {"drained": False}

        def victim(method, path, state=state):
            if path == "/v2/health/ready":
                if state["drained"]:
                    raise ConnectionResetError
                return 200, [("X-Health-State", "READY")], b""
            return 200, [], b"{}"

        def other(method, path):
            if path == "/v2/health/ready" and case == "gate":
                return 503, [("X-Health-State", "DRAINING")], b""
            return ref._FakeReplica.default_behavior(None, method, path)

        fakes[0].behavior, fakes[1].behavior = victim, other
        router = pkg.core.Router([pkg.core.Replica(f.url) for f in fakes],
                                 poll_interval_s=3600.0)
        rid = router.replicas[0].id

        def trigger(state=state):
            if case == "trigger-fails":
                raise RuntimeError("no such pid")
            state["drained"] = True

        triggers = {} if case == "no-pid" else {rid: trigger}
        reports = pkg.drain(router, [rid], triggers=triggers, deadline_s=2.0,
                            gate_timeout_s=0.3)
        got[name] = ([{k: v for k, v in r.items() if k != "step_s"}
                      for r in reports], router.replica(rid).quiesced)
        router.stop()
    assert got["port"] == got["jax"]
