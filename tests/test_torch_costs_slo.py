"""The port's cost ledger, SLO tracker and flight recorder held against
the JAX package's.

Under the same knobs and the same injected clocks, the same charges give
the same ``/v2/costs`` snapshot (tenants folded alike, the top-talker
event alike, the ``tpu_cost_*`` counters rendered byte for byte), the
same recorded outcomes give the same ``/v2/slo`` report and fast-burn
verdict, and the same provider samples give the same ``/v2/timeseries``
export under every filter. On live servers two tenants, one tagged by
``X-Tpu-Tenant`` and one by the ``tenant`` parameter, are billed on both
packages; the port's ledger reconciles with its profiler, ``/v2/slo``
counts the requests sent, and the recorder's samples carry the same
signals.
"""

import http.client
import json
from types import SimpleNamespace

import numpy as np
import pytest

from client_tpu.observability import costs as jax_costs
from client_tpu.observability import events as jax_events
from client_tpu.observability import slo as jax_slo
from client_tpu.observability import timeseries as jax_ts
from client_tpu.observability.metrics import MetricRegistry as JaxRegistry
from client_tpu_torch.observability import costs as port_costs
from client_tpu_torch.observability import events as port_events
from client_tpu_torch.observability import slo as port_slo
from client_tpu_torch.observability import timeseries as port_ts
from client_tpu_torch.observability.metrics import (
    MetricRegistry as PortRegistry,
)

TIMEOUT = 60  # seconds, every wait


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared below
        return ("error", type(exc).__name__, str(exc))


def _env_outcomes(parse, raw, var, tmp_path, content):
    path = tmp_path / "knob.json"
    path.write_text(content)
    env = {} if raw is None else {var: raw.replace("@FILE", f"@{path}")}
    got, want = (_outcome(lambda: parse("port", env)),
                 _outcome(lambda: parse("jax", env)))
    if want[0] == "error" and want[1] == "JSONDecodeError":
        return got[:2], want[:2]
    return got, want


# -- the cost ledger -----------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "", "1", "off", "0",
                                 '{"window_s": 0.5, "max_tenants": 2}',
                                 '{"tenants": ["a", "b"], '
                                 '"top_talker_fraction": 7}',
                                 "@FILE", "[1]", "{not json"])
def test_costs_config_equals_jax(tmp_path, raw):
    mods = {"port": port_costs, "jax": jax_costs}
    got, want = _env_outcomes(
        lambda name, env: vars(mods[name].CostsConfig.from_env(env)), raw,
        "CLIENT_TPU_COSTS", tmp_path, '{"window_s": 30}')
    assert got == want


class NsClock:
    def __init__(self):
        self.t = 10**12

    def __call__(self) -> int:
        return self.t


def _cost_script(seed: int) -> list:
    rng = np.random.default_rng(seed)
    tenants = ["", "default", "shadow", "alice", "bob", "carol", "dave",
               " alice ", "x" * 80]
    ops = []
    for _ in range(80):
        r = rng.random()
        model = str(rng.choice(["m1", "m2"]))
        if r < 0.35:
            k = int(rng.integers(1, 4))
            ops.append(("batch", model, [
                (str(rng.choice(tenants)), int(rng.integers(0, 5)),
                 "ab" * 16 if rng.random() < 0.5 else None)
                for _ in range(k)], float(rng.choice([0.0, 0.002, 0.05])),
                int(rng.integers(0, 4)), str(rng.choice(["batch", "wave"])),
                float(rng.choice([0.0, 0.001]))))
        elif r < 0.5:
            ops.append(("queued", model, str(rng.choice(tenants))))
        elif r < 0.65:
            ops.append(("queue", model, str(rng.choice(tenants)),
                        float(rng.choice([0.0, 0.003, 0.2]))))
        elif r < 0.75:
            ops.append(("hbm", model, str(rng.choice(tenants)),
                        float(rng.choice([0.0, 12.5, 4096.0]))))
        elif r < 0.85:
            ops.append(("shed", model, str(rng.choice(tenants)),
                        str(rng.choice(["throttled", "draining"]))))
        else:
            ops.append(("advance", int(rng.choice([1e6, 1e9, 30e9]))))
    return ops


def _run_ledger(mod, events, registry_cls, cfg: dict, ops: list):
    events.journal().clear()
    clock = NsClock()
    ledger = mod.CostLedger(mod.CostsConfig(**cfg), now=clock)
    registry = registry_cls()
    ledger.bind_metrics(registry)
    snaps = []
    for op in ops:
        kind, *a = op
        if kind == "batch":
            model, members, device_s, padded, comp, host_s = a
            ledger.charge_batch(model, "1", members, device_s, padded=padded,
                                component=comp, host_s=host_s)
        elif kind == "queued":
            ledger.note_queued(a[0], a[1])
        elif kind == "queue":
            ledger.charge_queue(a[0], "1", a[1], a[2], trace_id="cd" * 16)
        elif kind == "hbm":
            ledger.charge_hbm(a[0], "1", a[1], a[2])
        elif kind == "shed":
            ledger.note_shed(a[0], "1", a[1], a[2])
        else:
            clock.t += a[0]
        if len(snaps) < 3 and kind == "advance":
            snaps.append(ledger.snapshot(model="m1"))
    snaps.append(ledger.snapshot())
    journal = [(e["name"], e["severity"], e.get("detail"))
               for e in events.journal().export(category="cost")["events"]]
    return snaps, journal, registry.render(), \
        registry.render(openmetrics=True)


@pytest.mark.parametrize("cfg", [
    {},
    {"max_tenants": 2, "top_talker_min_device_s": 0.0},
    {"tenants": ("carol",), "window_s": 1.0, "top_talker_fraction": 0.3},
    {"enabled": False},
], ids=lambda c: json.dumps(c))
@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_snapshots_equal_jax(cfg, seed):
    ops = _cost_script(seed)
    got = _run_ledger(port_costs, port_events, PortRegistry, cfg, ops)
    want = _run_ledger(jax_costs, jax_events, JaxRegistry, cfg, ops)
    assert got == want
    if cfg.get("enabled", True):
        assert got[0][-1]["tenants"]


# -- the SLO tracker -----------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "", '{"availability": 0.99}',
                                 '{"availability": 1.5}',
                                 '{"latency_threshold_us": -1}',
                                 '{"models": {"m": {"latency_target": 0.9}}}',
                                 '{"models": {"m": {"bogus": 1}}}',
                                 '{"fast_burn_threshold": 0}', "@FILE",
                                 "{not json"])
def test_slo_config_equals_jax(tmp_path, raw):
    mods = {"port": port_slo, "jax": jax_slo}

    def parse(name, env):
        cfg = mods[name].SloConfig.from_env(env)
        return vars(cfg), vars(cfg.for_model("m"))

    got, want = _env_outcomes(parse, raw, "CLIENT_TPU_SLO", tmp_path,
                              '{"latency_threshold_us": 100}')
    assert got == want


class Clock:
    def __init__(self, t: float = 5000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("cfg", [
    {"availability": 0.99},
    {"availability": 0.9, "latency_threshold_us": 500,
     "latency_target": 0.95, "fast_burn_threshold": 2.0},
    {"models": {"b": {"availability": 0.5, "latency_threshold_us": 50}}},
], ids=lambda c: json.dumps(c))
@pytest.mark.parametrize("seed", [0, 3])
def test_slo_reports_equal_jax(cfg, seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(300):
        if rng.random() < 0.1:
            ops.append(("advance", float(rng.choice([0.4, 30.0, 400.0]))))
        else:
            ops.append(("record", str(rng.choice(["a", "b"])),
                        bool(rng.random() < 0.8),
                        float(rng.choice([10.0, 400.0, 900.0]))))

    def run(mod, registry_cls):
        clock = Clock()
        registry = registry_cls()
        tracker = mod.SloTracker(mod.SloConfig.from_dict(
            json.loads(json.dumps(cfg))), registry=registry, clock=clock)
        out = []
        for op in ops:
            if op[0] == "advance":
                clock.t += op[1]
                out.append((tracker.snapshot(), tracker.fast_burn()))
            else:
                tracker.record(op[1], op[2], duration_us=op[3])
        out.append((tracker.snapshot(), tracker.fast_burn()))
        return out, registry.render()

    assert run(port_slo, PortRegistry) == run(jax_slo, JaxRegistry)


def test_disabled_slo_records_nothing_as_jax():
    def run(mod):
        t = mod.SloTracker()
        t.record("m", False)
        return t.enabled, t.snapshot(), t.fast_burn()

    assert run(port_slo) == run(jax_slo)


# -- the flight recorder -------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "", "off", "on",
                                 '{"interval_s": 0.5, "capacity": 4}',
                                 '{"interval_s": 0}', '{"capacity": "x"}',
                                 '{"rate": 1}', "[1]", "{not json", "@FILE"])
def test_timeseries_config_equals_jax(tmp_path, raw):
    mods = {"port": port_ts, "jax": jax_ts}
    got, want = _env_outcomes(
        lambda name, env: vars(mods[name].TimeseriesConfig.from_env(env)),
        raw, "CLIENT_TPU_TIMESERIES", tmp_path, '{"capacity": 9}')
    assert got == want


class _Provider:
    def __init__(self, samples):
        self.samples = iter(samples)

    def timeseries_sample(self):
        return next(self.samples)


SAMPLES = [
    {"duty_cycle": 0.1, "queue_depth": {"a": 1, "b": 0},
     "in_flight": {"a": 1}, "hbm_used": 100},
    {"duty_cycle": 0.4, "queue_depth": {"a": 3}, "batch_fill": {"a": 0.5},
     "shed_rate": {"b": 2.0}, "hbm_used": 300, "bogus": 1},
    {"duty_cycle": 0.2, "wave_p50_ms": {"g": 1.5}, "slo_burn": {"a": 0.0},
     "tenant_cost_rate": {"alice": 0.01}, "mfu": {"a": 0.3}},
    {}, {"queue_depth": {"b": 7}, "hbm_used": 50},
]
EXPORTS = [{}, {"signal": "queue_depth"}, {"model": "a"},
           {"signal": "hbm_used", "model": "b"}, {"since_seq": 2},
           {"since_wall": 1001.0}, {"until_wall": 1002.0}, {"limit": 2},
           {"limit": 0}, {"signal": "no_such_signal"}]


@pytest.mark.parametrize("capacity", [3, 900])
def test_recorder_exports_equal_jax(capacity):
    def run(mod):
        clock = Clock(1000.0)
        rec = mod.FlightRecorder(mod.TimeseriesConfig(capacity=capacity),
                                 clock=clock)
        providers = [_Provider(SAMPLES), _Provider(
            [{"duty_cycle": 0.3, "queue_depth": {"c": 2}}] * len(SAMPLES))]
        rec._providers = {id(p): (lambda p=p: p) for p in providers}
        ticks = []
        for _ in SAMPLES:
            clock.t += 1.0
            ticks.append(rec.tick())
        return ticks, [_outcome(lambda kw=kw: rec.export(**kw))
                       for kw in EXPORTS], len(rec)

    assert run(port_ts) == run(jax_ts)


def test_the_recorder_thread_stops_with_its_engine():
    """An engine attaches at construction and detaches at shutdown; the
    last detach stops the 1 Hz thread."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository

    port_ts.reset_recorder()  # a recorder this engine has to itself
    rec = port_ts.recorder()
    engine = TorchEngine(build_repository(["simple"]), device="cpu")
    assert rec.running() and engine in rec.providers()
    sample = engine.timeseries_sample()
    assert {"duty_cycle", "queue_depth", "in_flight", "hbm_used"} \
        <= set(sample)
    engine.shutdown()
    assert not rec.running() and engine not in rec.providers()


# ---------------------------------------------------------------------------
# Both servers
# ---------------------------------------------------------------------------

SLO = '{"availability": 0.99, "latency_threshold_us": 1e9}'


@pytest.fixture
def servers(monkeypatch):
    """Each package's engine (``simple``) behind its HTTP server, with
    ``CLIENT_TPU_SLO`` set and both cost ledgers fresh."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import HttpInferenceServer

    monkeypatch.setenv("CLIENT_TPU_SLO", SLO)
    for mod in (port_costs, jax_costs):
        mod.reset_ledger()
    port = TorchEngine(build_repository(["simple"]), device="cpu")
    jax = TpuEngine(jax_build(["simple"]))
    port.profiler.reset()
    jax.profiler.reset()
    sides = {name: SimpleNamespace(engine=eng,
                                   http=cls(eng, port=0).start())
             for name, eng, cls in (("port", port, HttpInferenceServer),
                                    ("jax", jax, JaxHttp))}
    yield sides
    for side in sides.values():
        side.http.stop()
        side.engine.shutdown()
    for mod in (port_costs, jax_costs):
        mod.reset_ledger()


def _request(side, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _body(params=None):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": a.ravel().tolist()} for n in ("INPUT0", "INPUT1")],
        "parameters": params or {}})


def test_two_tenants_are_billed_on_both(servers):
    sent = {"alice": 5, "bob": 4}
    for side in servers.values():
        # A first request per bucket is cold: out of the bill on both.
        assert _request(side, "POST", "/v2/models/simple/infer",
                        _body())[0] == 200
        for _ in range(sent["alice"]):
            assert _request(side, "POST", "/v2/models/simple/infer",
                            _body(), {"X-Tpu-Tenant": "alice"})[0] == 200
        for _ in range(sent["bob"]):
            assert _request(side, "POST", "/v2/models/simple/infer",
                            _body({"tenant": "bob"}))[0] == 200
    snaps = {name: _request(side, "GET", "/v2/costs?model=simple")[1]
             for name, side in servers.items()}
    for name, snap in snaps.items():
        assert set(snap["tenants"]) == {"default", "alice", "bob"}, name
        for tenant, n in sent.items():
            row = snap["tenants"][tenant]
            assert row["models"]["simple:1"]["requests"] == n, name
            assert row["queue_s"] >= 0 and row["device_s"] >= 0
    assert set(snaps["port"]) == set(snaps["jax"])
    assert set(snaps["port"]["reconciliation"]) \
        == set(snaps["jax"]["reconciliation"])
    rec = snaps["port"]["reconciliation"]
    # The ledger splits the profiler's own device time: they agree.
    assert rec["ledger_device_s"] == pytest.approx(
        rec["profiler_device_s"], abs=2e-6)
    # The counters carry the tenants on both /metrics.
    for name, side in servers.items():
        text = side.engine.prometheus_metrics()
        for tenant in sent:
            assert (f'tpu_cost_queue_seconds_total{{tenant="{tenant}",'
                    'model="simple"}') in text, name
            assert (f'tpu_request_duration_us_count{{model="simple",'
                    f'version="1",tenant="{tenant}"}} {sent[tenant]}') \
                in text, name


def test_slo_counts_the_requests_sent_on_both(servers):
    reports = {}
    for name, side in servers.items():
        for _ in range(6):
            assert _request(side, "POST", "/v2/models/simple/infer",
                            _body())[0] == 200
        assert _request(side, "POST", "/v2/models/no_such/infer",
                        _body())[0] == 404
        reports[name] = _request(side, "GET", "/v2/slo")[1]
    assert reports["port"] == reports["jax"]
    assert reports["port"]["enabled"] is True
    w = reports["port"]["models"]["simple"]["windows"]["5m"]
    assert (w["requests"], w["errors"]) == (6, 0)


def test_recorder_samples_carry_the_same_signals(servers):
    keys = {}
    for name, side in servers.items():
        for _ in range(3):
            _request(side, "POST", "/v2/models/simple/infer", _body())
        side.engine.timeseries_sample()  # the first sets the tick gap
        side.engine.recorder.tick()
        keys[name] = set(side.engine.timeseries_sample())
        ring = _request(side, "GET", "/v2/timeseries?signal=queue_depth"
                        "&model=simple&limit=1")[1]
        assert ring["samples"] and set(ring["samples"][-1]["signals"]) \
            <= {"queue_depth"}
    assert keys["port"] == keys["jax"]
    assert {"duty_cycle", "queue_depth", "in_flight", "batch_fill",
            "hbm_used", "slo_burn"} <= keys["port"]
