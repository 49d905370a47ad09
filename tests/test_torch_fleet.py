"""The port's fleet planes against the JAX package's.

* Each case of ``tests/test_fleet_obs.py`` runs on the port: the span
  store, the exposition/events merges, the drift math, the monitor's
  config and its edge-triggered ticks, the wait damping, and the
  end-to-end stitched traces and ``/v2/fleet/*`` endpoints over two
  in-process port engines (``simple`` on the CPU) behind the port's
  router. The reference's methods run with their module globals (and
  their classes' helpers) bound to the port's names.
* ``observability/{fleet,scrape}.py`` equal JAX's on the same inputs:
  the merges of two port engines' real ``/metrics``, ``/v2/events``,
  ``/v2/profile``, ``/v2/slo``, ``/v2/costs`` and ``/v2/timeseries``
  bodies (``merge_expositions`` byte for byte), the signals and drift
  scores, and the scrape's histogram quantiles.
* ``FleetMonitorConfig``'s errors word for word, ``SpanStore``'s Chrome
  events and ``RouterMetrics``' families equal JAX's.
* ``FleetRebalancer`` decision for decision on ``tests/test_selfdrive.py``'s
  stub router, whose cases also run on the port.
* ``FleetBlackbox``: one capture through each package's router over the
  same port replicas gives the same bundle sections, none in error.
"""

import inspect
import json
import types

import numpy as np
import pytest

import client_tpu.observability.fleet as jax_fleet
import client_tpu.observability.metrics as jax_metrics
import client_tpu.observability.scrape as jax_scrape
import client_tpu.observability.tracing as jax_tracing
import client_tpu.router as jax_router
import client_tpu.router.blackbox as jax_rbb
import client_tpu.router.selfdrive as jax_rsd
import test_fleet_obs as ref
import test_selfdrive as ref_sd
from client_tpu.engine import selfdrive as jax_sd
from client_tpu_torch import router as port_router
from client_tpu_torch.engine import selfdrive as port_sd
from client_tpu_torch.engine import types as port_types
from client_tpu_torch.observability import blackbox as port_bb
from client_tpu_torch.observability import events as port_events
from client_tpu_torch.observability import fleet as port_fleet
from client_tpu_torch.observability import metrics as port_metrics
from client_tpu_torch.observability import scrape as port_scrape
from client_tpu_torch.observability import tracing as port_tracing
from client_tpu_torch.protocol import loadreport as port_lr
from client_tpu_torch.resilience import CircuitBreaker
from client_tpu_torch.router import blackbox as port_rbb
from client_tpu_torch.router import selfdrive as port_rsd

PORT_GLOBALS = {
    "scrape": port_scrape,
    "journal": port_events.journal,
    **{name: getattr(port_fleet, name) for name in (
        "FleetMonitorConfig", "drift_scores", "fleet_median",
        "merge_events", "merge_expositions", "merge_profiles", "merge_slo",
        "parse_exposition", "profile_signals")},
    "NamedSpan": port_tracing.NamedSpan,
    "SpanStore": port_tracing.SpanStore,
    "LoadReport": port_lr.LoadReport,
    "CircuitBreaker": CircuitBreaker,
    **{name: getattr(port_router, name) for name in (
        "FleetFederator", "FleetMonitor", "Replica", "Router",
        "RouterHttpServer")},
    # test_selfdrive's names
    "SelfDriveConfig": port_sd.SelfDriveConfig,
    "ENV_VAR": port_sd.ENV_VAR,
    "EngineError": port_types.EngineError,
    "FleetRebalancer": port_rsd.FleetRebalancer,
    "_truncate_steps": port_rsd._truncate_steps,
}


def _ported_fn(fn, env):
    return types.FunctionType(fn.__code__, env, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def _ported_module_env(mod) -> dict:
    """``mod``'s globals with the port's names, its helper functions and
    classes rebound into the same environment."""
    env = {**vars(mod), **PORT_GLOBALS}
    for name, obj in vars(mod).items():
        if name.startswith("test_"):
            continue
        if inspect.isfunction(obj) and obj.__module__ == mod.__name__:
            env[name] = _ported_fn(obj, env)
        elif inspect.isclass(obj) and obj.__module__ == mod.__name__:
            env[name] = _ported_class(obj, env)
    assert env["Router"].__module__ == "client_tpu_torch.router.core"
    return env


def _ported_class(cls, env):
    attrs = {}
    for k, v in vars(cls).items():
        if inspect.isfunction(v):
            attrs[k] = _ported_fn(v, env)
        elif isinstance(v, property):
            attrs[k] = property(_ported_fn(v.fget, env))
        elif k not in ("__dict__", "__weakref__"):
            attrs[k] = v
    return type(cls.__name__, cls.__bases__, attrs)


FLEET_ENV = _ported_module_env(ref)
SD_ENV = _ported_module_env(ref_sd)

def _cases(mod, classes=None):
    return sorted(
        (cls_name, name) for cls_name, cls in vars(mod).items()
        if cls_name.startswith("Test") and inspect.isclass(cls)
        and (classes is None or cls_name in classes)
        for name, fn in vars(cls).items()
        if name.startswith("test_") and inspect.isfunction(fn))


FLEET_CASES = _cases(ref)
SD_CASES = _cases(ref_sd, ("TestFleetRebalancer",))


@pytest.fixture(scope="module")
def fleet():
    """Two in-process port engines serving ``simple`` on the CPU behind
    the port's router (the reference's fixture, on the port)."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import HttpInferenceServer

    engines, servers = [], []
    for _ in range(2):
        eng = TorchEngine(build_repository(["simple"]), device="cpu")
        engines.append(eng)
        servers.append(HttpInferenceServer(eng, port=0).start())
    router = port_router.Router([port_router.Replica(s.url)
                                 for s in servers],
                                seed=42, poll_interval_s=3600.0)
    front = port_router.RouterHttpServer(router, port=0).start()
    yield {"engines": engines, "servers": servers, "router": router,
           "front": front}
    front.stop()
    for s in servers:
        s.stop()
    for e in engines:
        e.shutdown()


def test_the_references_have_their_cases():
    assert len(FLEET_CASES) == 36
    assert len(SD_CASES) == 7


@pytest.mark.parametrize("cls_name,name", FLEET_CASES,
                         ids=[f"{c}.{n}" for c, n in FLEET_CASES])
def test_fleet_case_on_the_port(cls_name, name, request):
    cls = FLEET_ENV[cls_name]
    fn = vars(cls)[name]
    params = list(inspect.signature(fn).parameters)[1:]
    fn(cls(), **{p: request.getfixturevalue(p) for p in params})


@pytest.mark.parametrize("cls_name,name", SD_CASES,
                         ids=[f"{c}.{n}" for c, n in SD_CASES])
def test_rebalancer_case_on_the_port(cls_name, name):
    cls = SD_ENV[cls_name]
    vars(cls)[name](cls())


# -- merges on real bodies ---------------------------------------------------------


@pytest.fixture(scope="module")
def bodies(fleet):
    """Each port engine's surfaces after a few requests, as fetched."""
    import urllib.request

    from client_tpu_torch.engine.types import InferRequest

    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    for i, eng in enumerate(fleet["engines"]):
        for _ in range(3 + 2 * i):
            eng.infer(InferRequest(model_name="simple",
                                   inputs={"INPUT0": a, "INPUT1": a}))
    out = {}
    for s in fleet["servers"]:
        rid = port_router.Replica(s.url).id
        out[rid] = {}
        for path in ("/metrics", "/v2/events", "/v2/profile", "/v2/slo",
                     "/v2/costs", "/v2/timeseries"):
            with urllib.request.urlopen(f"http://{s.url}{path}",
                                        timeout=30) as resp:
                data = resp.read().decode()
            out[rid][path] = data if path == "/metrics" else json.loads(data)
    return out


def test_merge_expositions_byte_for_byte(bodies):
    texts = {rid: b["/metrics"] for rid, b in bodies.items()}
    got = port_fleet.merge_expositions(texts)
    assert got == jax_fleet.merge_expositions(texts)
    assert "tpu_inference_exec_count" in got
    assert port_fleet.parse_exposition(got) == \
        jax_fleet.parse_exposition(got)


@pytest.mark.parametrize("path,merge", [
    ("/v2/events", "merge_events"), ("/v2/slo", "merge_slo"),
    ("/v2/costs", "merge_costs"), ("/v2/timeseries", "merge_timeseries")])
def test_surface_merges_equal_jax(bodies, path, merge):
    exports = {rid: b[path] for rid, b in bodies.items()}
    errors = {"10.0.0.9:1": "ConnectionRefusedError: x"}
    got = getattr(port_fleet, merge)(exports, errors)
    assert json.dumps(got) == json.dumps(
        getattr(jax_fleet, merge)(exports, errors))
    if merge in ("merge_events", "merge_timeseries"):
        kw = {"limit": 3}
        assert getattr(port_fleet, merge)(exports, **kw) == \
            getattr(jax_fleet, merge)(exports, **kw)


def test_profile_merge_and_signals_equal_jax(bodies):
    profiles = {rid: b["/v2/profile"] for rid, b in bodies.items()}
    drift = {"flagged": {}}
    assert json.dumps(port_fleet.merge_profiles(profiles, drift=drift)) == \
        json.dumps(jax_fleet.merge_profiles(profiles, drift=drift))
    for rid, b in bodies.items():
        load = {"wait_s": 0.125}
        assert port_fleet.profile_signals(b["/v2/profile"], load) == \
            jax_fleet.profile_signals(b["/v2/profile"], load)
        ts = b["/v2/timeseries"]
        assert port_fleet.timeseries_signals(ts, window_s=30.0) == \
            jax_fleet.timeseries_signals(ts, window_s=30.0)


@pytest.mark.parametrize("seed", range(4))
def test_drift_scores_equal_jax(seed):
    rng = np.random.default_rng(seed)
    signals = {f"r{i}": {s: float(rng.random() * 3) for s in
                         rng.choice(list(port_fleet.SIGNAL_FLOORS), 3,
                                    replace=False)}
               for i in range(4)}
    assert port_fleet.drift_scores(signals) == \
        jax_fleet.drift_scores(signals)


def test_scrape_equals_jax(bodies):
    for b in bodies.values():
        text = b["/metrics"]
        assert port_scrape.parse_samples(text) == \
            jax_scrape.parse_samples(text)
        fam = "tpu_inference_request_duration_us"
        after = port_scrape.histogram_state(text, fam)
        assert after == jax_scrape.histogram_state(text, fam)
        before = {"buckets": {le: 0.0 for le in after["buckets"]},
                  "sum": 0.0, "count": 0.0}
        window = port_scrape.delta(after, before)
        assert window == jax_scrape.delta(after, before)
        for q in (0.5, 0.99):
            got, want = (port_scrape.quantile(window, q),
                         jax_scrape.quantile(window, q))
            assert got == want or (np.isnan(got) and np.isnan(want))


# -- config, spans, metrics --------------------------------------------------------


@pytest.mark.parametrize("raw", [
    None, "", "off", "0", "1", "on", '{"interval_s": 0.2, "threshold": 2}',
    '{"intervall_s": 1}', '{"threshold": "hot"}', '{"threshold": 0}',
    '{"interval_s": 0}', '{"min_replicas": 1}', '{"window_s": -1}',
    "{nope", "[1]"])
def test_monitor_config_words_equal_jax(raw):
    environ = {} if raw is None else {"CLIENT_TPU_FLEET_MONITOR": raw}
    got = []
    for mod in (port_fleet, jax_fleet):
        try:
            cfg = mod.FleetMonitorConfig.from_env(environ=environ)
            got.append(("ok", None if cfg is None else cfg.summary()))
        except ValueError as exc:
            got.append(("error", str(exc)))
    assert got[0] == got[1]


def test_span_store_chrome_events_equal_jax():
    events = {}
    for mod in (port_tracing, jax_tracing):
        store = mod.SpanStore(capacity=4)
        for i in range(6):
            store.add(f"t{i % 3}", [
                mod.NamedSpan("router:request", 100 * i, 100 * i + 50,
                              span_id=f"{i:016x}",
                              args={"outcome": "ok", "status": 200}),
                mod.NamedSpan("router:proxy", 100 * i + 5, 100 * i + 40,
                              span_id=f"{i + 1:016x}",
                              parent_span_id=f"{i:016x}",
                              args={"replica": "h:1", "attempt": 1})])
        events[mod.__name__] = (store.to_chrome_events(),
                                store.to_chrome_events("t1", pid=3),
                                len(store))
    assert events["client_tpu_torch.observability.tracing"] == \
        events["client_tpu.observability.tracing"]


def test_router_metrics_families_equal_jax():
    texts = []
    for mod in (port_metrics, jax_metrics):
        m = mod.RouterMetrics()
        m.requests.inc(replica="a", outcome="ok")
        m.failovers.inc(replica="b")
        m.sheds.inc(reason="all_pushback")
        m.breaker_open.set(1.0, replica="b")
        m.replica_states.set(2.0, state="READY")
        m.request_duration_us.observe(1234.0, replica="a")
        m.load_report_age.set(0.5, replica="a")
        m.affinity_routed.inc(replica="a")
        m.drain_steps.inc(replica="a", outcome="clean")
        m.fleet_drift_score.set(0.7, replica="a", signal="wait_s")
        m.fleet_fetch_failures.inc(replica="b", surface="metrics")
        texts.append((m.render(), m.render(openmetrics=True)))
    assert texts[0] == texts[1]


# -- the rebalancer, decision for decision ---------------------------------------


@pytest.mark.parametrize("over", [
    {}, {"max_moves_per_window": 1, "rebalance_cooldown_s": 1.0},
    {"rebalance_window_s": 5.0, "rebalance_cooldown_s": 0.5}])
def test_rebalancer_decides_as_jax(over):
    runs = {}
    for name, rsd, sd in (("port", port_rsd, port_sd),
                          ("jax", jax_rsd, jax_sd)):
        clk = ref_sd.FakeClock()
        r1 = ref_sd.StubReplica("r1", ["m1", "m2", "m3"],
                                {"m1": 10.0, "m2": 6.0, "m3": 3.0})
        r2 = ref_sd.StubReplica("r2", [], {})
        r3 = ref_sd.StubReplica("r3", ["m3"], {"m3": 1.0})
        router = ref_sd.StubRouter([r1, r2, r3])
        cfg = sd.SelfDriveConfig.from_dict({
            "rebalance_cooldown_s": 60.0, "max_moves_per_window": 4,
            "rebalance_window_s": 300.0, "quiesce_wait_s": 0.1, **over})
        reb = rsd.FleetRebalancer(router, cfg, clock=clk)
        out = []
        for step in range(8):
            flagged = {"r1": {"duty_cycle": 0.99}} if step != 3 else {}
            rec = reb.maybe_rebalance({"flagged": flagged})
            out.append(rec and {k: v for k, v in rec.items() if k != "ts"})
            out.append(reb.snapshot())
            if step == 4:  # undo out of band: the plan wants it again
                r1.models, r2.models = ["m1", "m2", "m3"], []
            clk.advance(2.0 if step % 2 else 70.0)
        runs[name] = (out, r1.posts, r2.posts, r3.posts, router.quiesced)
    assert json.dumps(runs["port"], default=str) == \
        json.dumps(runs["jax"], default=str)


# -- the fleet blackbox ----------------------------------------------------------


def test_fleet_blackbox_sections_equal_jax(fleet, tmp_path):
    """One capture through each package's router, over the same two port
    replicas: the same bundle keys and sections, no section in error, and
    each replica's own capture answered."""
    got = {}
    for name, rpkg, rbb, bb in (
            ("port", port_router, port_rbb, port_bb),
            ("jax", jax_router, jax_rbb,
             __import__("client_tpu.observability.blackbox",
                        fromlist=["BlackboxConfig"]))):
        router = rpkg.Router([rpkg.Replica(s.url)
                              for s in fleet["servers"]],
                             seed=1, poll_interval_s=3600.0)
        router.refresh()
        federator = rpkg.FleetFederator(router)
        cfg = bb.BlackboxConfig.from_dict({"dir": str(tmp_path / name)})
        box = rbb.FleetBlackbox(router, federator, config=cfg)
        result = box.capture("manual", note="parity")
        bundle = box.bundles(result["bundle"]["id"])
        index = box.bundles()
        got[name] = (sorted(result), sorted(bundle),
                     sorted(bundle["sections"]),
                     sorted(result["replicas"]),
                     sorted(index), bundle["trigger"], bundle["router"])
        for section, body in bundle["sections"].items():
            assert not (isinstance(body, dict) and "error" in body), \
                (name, section, body)
        for rid, meta in result["replicas"].items():
            assert "error" not in meta, (name, rid, meta)
        box.close()
        router.stop()
    assert got["port"] == got["jax"]
