"""The port's efficiency profiler and roofline held against the JAX
package's.

Driven with an injected clock, both profilers give equal snapshots and
gauges for the same records (exact: the same arithmetic on the same
numbers; the only difference is the cost's source word, ``counted`` for
the port's counted costs where JAX says ``xla``). ``CLIENT_TPU_ROOFLINE``
parses alike, errors included, and ``bucket_roofline`` joins alike. On
live engines the captured FLOPs of a small BERT bucket equal
``bert_flops_per_example`` times the bucket's rows plus the pooler's and
classifier's matmuls within 1%, and the snapshots of both engines have
the same keys and row counts for the same batches.
"""

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from client_tpu.observability import roofline as jax_roofline
from client_tpu.observability.metrics import MetricRegistry as JaxRegistry
from client_tpu_torch.observability import profiler as port_profiler
from client_tpu_torch.observability import roofline as port_roofline
from client_tpu_torch.observability.metrics import (
    MetricRegistry as PortRegistry,
)

# The JAX package's ``observability`` exports a ``profiler`` function
# under the module's own name.
jax_profiler = importlib.import_module("client_tpu.observability.profiler")

PEAKS = '{"peak_flops": 1e12, "peak_bytes_per_s": 2e11}'
COST = {"available": True, "flops": 4.0e9, "bytes_accessed": 2.5e8,
        "transcendentals": 0.0}


class Clock:
    def __init__(self):
        self.ns = 1_000_000_000

    def __call__(self):
        return self.ns


def _record(mod, clock):
    """The same records on either profiler, the clock advancing."""
    p = mod.EfficiencyProfiler(window_s=30.0, now=clock)
    steps = [
        ("compile", "bert", "1", 4, 2_000_000_000, "rows"),
        ("cost", "bert", "1", 4, COST, "rows"),
        ("exec", "bert", "1", 4, 3, 5_000_000, 700_000, True, "rows"),
        ("exec", "bert", "1", 4, 4, 4_000_000, 600_000, False, "rows"),
        ("exec", "bert", "1", 4, 1, 4_100_000, 500_000, False, "rows"),
        ("exec", "bert", "1", 8, 5, 9_000_000, 900_000, False, "rows"),
        ("cost", "bert", "1", 8, {"available": False, "reason": "x"}, "rows"),
        ("exec", "dlrm", "2", 512, 300, 250_000, 9_000_000, False,
         "lookups"),
        ("exec", "simple", "1", None, 1, 10_000, 20_000, False, "rows"),
        ("wave_cost", "gpt", "1", 4, 1, dict(COST, flops=2.0e8)),
        ("wave", "gpt", "1", 4, 1, 700_000, 1),
        ("wave", "gpt", "1", 4, 1, 750_000, 1),
        ("wave", "gpt", "1", 16, 2, 2_000_000, 2),
    ] + [("exec", "bert", "1", 2, 1, 1_000_000, 100_000, False, "rows")] * 9
    for step in steps:
        clock.ns += 250_000_000
        kind, model, version = step[:3]
        if kind == "compile":
            p.record_compile(model, version, step[3], step[4], axis=step[5])
        elif kind == "cost":
            p.record_cost_model(model, version, step[3], step[4],
                                axis=step[5])
        elif kind == "exec":
            p.record_execution(model, version, step[3], rows=step[4],
                               device_ns=step[5], host_ns=step[6],
                               cold=step[7], axis=step[8])
        elif kind == "wave_cost":
            p.record_wave_cost_model(model, version, step[3], step[4],
                                     step[5])
        else:
            p.record_wave(model, version, step[3], step[4], step[5],
                          waves=step[6])
    return p


def _as_jax_words(obj):
    """The port's snapshot with its cost source word as JAX writes it."""
    if isinstance(obj, dict):
        return {k: ("xla" if k == "cost_model" and v == "counted"
                    else _as_jax_words(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_as_jax_words(v) for v in obj]
    return obj


@pytest.mark.parametrize("peaks", [None, PEAKS], ids=["unknown", "env"])
@pytest.mark.parametrize("advance_s", [0.0, 5.0, 31.0, 120.0])
def test_snapshot_equals_jax(monkeypatch, peaks, advance_s):
    if peaks is None:
        monkeypatch.delenv("CLIENT_TPU_ROOFLINE", raising=False)
    else:
        monkeypatch.setenv("CLIENT_TPU_ROOFLINE", peaks)
    snaps = []
    for mod in (port_profiler, jax_profiler):
        clock = Clock()
        p = _record(mod, clock)
        clock.ns += int(advance_s * 1e9)
        snap = p.snapshot()
        snap["roofline"].pop("device_kind")  # "cpu" on both, by detection
        snaps.append(snap)
    assert _as_jax_words(snaps[0]) == snaps[1]
    assert snaps[0]["models"]["bert:1"]["buckets"][1]["cold_executions"] == 1


@pytest.mark.parametrize("model", ["bert", "gpt", "nobody"])
def test_snapshot_filtered_by_model_equals_jax(model):
    snaps = [_record(mod, Clock()).snapshot(model=model)["models"]
             for mod in (port_profiler, jax_profiler)]
    assert _as_jax_words(snaps[0]) == snaps[1]


@pytest.mark.parametrize("openmetrics", [False, True], ids=["0.0.4", "om"])
def test_profiler_families_render_as_jax(monkeypatch, openmetrics):
    monkeypatch.setenv("CLIENT_TPU_ROOFLINE", PEAKS)
    renders = []
    for mod, registry_cls in ((port_profiler, PortRegistry),
                              (jax_profiler, JaxRegistry)):
        registry = registry_cls()
        clock = Clock()
        p = mod.EfficiencyProfiler(window_s=30.0, now=clock)
        p.bind_metrics(registry)
        clock.ns = _record_bound(p, clock)
        p.update_gauges()
        renders.append(registry.render(openmetrics))
    assert renders[0] == renders[1]


def _record_bound(p, clock):
    p.record_compile("bert", "1", 4, 2_000_000_000)
    p.record_cost_model("bert", "1", 4, COST)
    for i in range(6):
        clock.ns += 100_000_000
        p.record_execution("bert", "1", 4, rows=1 + i % 4,
                           device_ns=3_000_000, host_ns=100_000,
                           cold=i == 0)
    p.record_wave_cost_model("gpt", "1", 2, 1, COST)
    p.record_wave("gpt", "1", 2, 1, 1_500_000, waves=1)
    return clock.ns + 1_000_000_000


@pytest.mark.parametrize("window_s", [0.5, 1.0, 2.0, 60.0])
def test_duty_cycle_window_equals_jax(window_s):
    """Busy intervals straddling the window edge count their overlap,
    on a clock the test drives."""
    duty = []
    for mod in (port_profiler, jax_profiler):
        clock = Clock()
        p = mod.EfficiencyProfiler(window_s=window_s, now=clock)
        got = []
        for step in range(20):
            clock.ns += 300_000_000
            p.record_execution("m", "1", 4, rows=2,
                               device_ns=150_000_000 * (step % 3),
                               cold=step == 0)
            got.append(p.duty_cycle())
        clock.ns += 10**9
        got.append(p.duty_cycle())
        duty.append(got)
    assert duty[0] == duty[1]
    assert 0.0 < max(duty[0]) <= 1.0


# ---------------------------------------------------------------------------
# CLIENT_TPU_ROOFLINE and the join
# ---------------------------------------------------------------------------

ROOFLINE_ENV = [
    None, "", "0", "off", "FALSE", "1", "on", "true", PEAKS,
    '{"capture": false}', '{"capture": "no"}', '{"peak_flops": -1}',
    '{"peak_flops": true}', '{"peak_bytes_per_s": "fast"}', '{"bogus": 1}',
    '{"device_kinds": []}', '{"device_kinds": {"X": 3}}',
    '{"device_kinds": {"Card X": {"peak_flops": 5e14, "extra": 1}}}',
    '{"device_kinds": {"Card X": {"peak_flops": 5e14}}}',
    "[1, 2]", "{not json", "@FILE", "@/no/such/roofline.json",
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared below
        return ("error", type(exc).__name__, str(exc))


@pytest.mark.parametrize("raw", ROOFLINE_ENV, ids=lambda r: repr(r))
def test_roofline_config_and_its_errors_equal_jax(tmp_path, raw):
    path = tmp_path / "roofline.json"
    path.write_text('{"peak_bytes_per_s": 1e12}')
    env = {} if raw is None else {
        "CLIENT_TPU_ROOFLINE": raw.replace("@FILE", f"@{path}")}

    def parse(mod):
        cfg = mod.RooflineConfig.from_env(env)
        kinds = {k: v.as_dict() for k, v in (cfg.device_kinds or {}).items()}
        peaks = [cfg.resolve_peaks(kind) for kind in (
            "card x", "Card X rev 2", "cpu")]
        return (cfg.capture, cfg.peak_flops, cfg.peak_bytes_per_s, kinds,
                [p.as_dict() if p else None for p in peaks])

    port, ref = _outcome(lambda: parse(port_roofline)), \
        _outcome(lambda: parse(jax_roofline))
    if ref[0] == "error" and "invalid JSON" in ref[2]:
        assert port[:2] == ref[:2] and "invalid JSON" in port[2]
    else:
        assert port == ref


def test_the_h100_row_resolves_from_its_device_name():
    peaks = port_roofline.RooflineConfig().resolve_peaks(
        "NVIDIA H100 80GB HBM3")
    assert (peaks.flops_per_s, peaks.bytes_per_s) == (989e12, 3.35e12)
    assert port_roofline.RooflineConfig().resolve_peaks("cpu") is None


@pytest.mark.parametrize("cost", [
    None, {"available": False, "reason": "why"}, COST,
    dict(COST, bytes_accessed=0.0), dict(COST, flops=0.0),
])
@pytest.mark.parametrize("calls,device_s,padded", [
    (0, 0.0, 0.0), (10, 0.5, 0.25), (3, 0.0, 1.5), (7, 2.0, -0.1)])
@pytest.mark.parametrize("peaks", [None, (1e12, 2e11), (1e12, None)])
def test_bucket_roofline_equals_jax(cost, calls, device_s, padded, peaks):
    def join(mod):
        spec = mod.PeakSpec(*peaks) if peaks else None
        return mod.bucket_roofline(cost, calls, device_s, padded, spec)

    assert _as_jax_words(join(port_roofline)) == join(jax_roofline)


@pytest.mark.parametrize("args", [(128,), (2048,), (64, 64, 2, 128),
                                  (512, 1024, 24, 4096)])
def test_bert_flops_per_example_equals_jax(args):
    assert port_roofline.bert_flops_per_example(*args) \
        == jax_roofline.bert_flops_per_example(*args)


# ---------------------------------------------------------------------------
# Live engines
# ---------------------------------------------------------------------------

SEQ = 32
BERT = dict(seq_len=SEQ, hidden=64, n_layers=2, n_heads=2, ffn=128,
            vocab=256, max_batch_size=8)
GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=64, max_streams=4)


def _bert_inputs(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, BERT["vocab"], (rows, SEQ))
            .astype(np.int32),
            "attention_mask": np.ones((rows, SEQ), np.int32)}


@pytest.fixture(scope="module")
def engines():
    """Each package's engine with a small BERT (JAX's weights carried to
    the port) and a narrow ``tiny_gpt``; the port's BERT in both its
    attention routes."""
    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepo
    from client_tpu.models.bert import BertBackend as JaxBert
    from client_tpu.models.generate import TinyGptBackend as JaxGpt
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models.bert import BertBackend
    from client_tpu_torch.models.generate import TinyGptBackend

    jax_repo = JaxRepo()
    jax_repo.register_backend(JaxBert(name="bert_p", **BERT))
    jax_repo.register_backend(JaxGpt(name="tg", attn_impl="reference", **GPT))
    jax_engine = TpuEngine(jax_repo)
    tree = jax_engine.repository.get("bert_p")._params
    repo = ModelRepository()
    for name, impl in (("bert_p", "einsum"), ("bert_flash", "flash")):
        def build(device, name=name, impl=impl):
            b = BertBackend(name=name, attention_impl=impl, device=device,
                            **BERT)
            b.load_jax_params(tree)
            return b
        repo.register(name, build)
    repo.register("tg", lambda device: TinyGptBackend(
        name="tg", attn_impl="fused", device=device, **GPT))
    engine = TorchEngine(repo, device="cpu")
    yield SimpleNamespace(port=engine, jax=jax_engine)
    engine.shutdown()
    jax_engine.shutdown()


def _infer(engine, request_cls, model, rows, seed):
    engine.infer(request_cls(model_name=model,
                             inputs=_bert_inputs(rows, seed)), timeout_s=60)


def _generate(engine, request_cls, n_tokens):
    done = []

    def cb(resp):
        assert resp.error is None, resp.error
        if resp.final:
            done.append(True)

    engine.async_infer(request_cls(
        model_name="tg", inputs={"INPUT_IDS": np.array([3, 5, 7], np.int32)},
        parameters={"max_tokens": n_tokens}), cb)
    import time
    deadline = time.monotonic() + 60
    while not done and time.monotonic() < deadline:
        time.sleep(0.01)
    assert done


@pytest.fixture(scope="module")
def profiled(engines):
    """The same batches on both engines; the snapshots of their models."""
    from client_tpu.engine import InferRequest as JaxRequest
    from client_tpu_torch.engine import InferRequest

    out = {}
    for name, engine, request_cls in (("port", engines.port, InferRequest),
                                      ("jax", engines.jax, JaxRequest)):
        for i, rows in enumerate((1, 3, 3, 8, 2, 1)):
            _infer(engine, request_cls, "bert_p", rows, i)
        _generate(engine, request_cls, 6)
        out[name] = {m: engine.profile_snapshot(model=m)["models"]
                     for m in ("bert_p", "tg")}
    return out


def _shape(obj):
    """Keys at every level, and the lengths of lists, without values."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return None


ROW_KEYS = ("bucket", "axis", "executions", "cold_executions", "rows",
            "padded_rows", "max_rows", "fill_ratio", "compilations")


def test_bert_snapshot_keys_and_rows_equal_jax(profiled):
    port, ref = profiled["port"]["bert_p"], profiled["jax"]["bert_p"]
    assert _shape(port) == _shape(ref)
    rows = [[{k: b[k] for k in ROW_KEYS} for b in m["buckets"]]
            for m in (port["bert_p:1"], ref["bert_p:1"])]
    assert rows[0] == rows[1]
    assert [b["bucket"] for b in rows[0]] == [1, 2, 4, 8]


def test_wave_snapshot_keys_and_counts_equal_jax(profiled):
    port, ref = profiled["port"]["tg"]["tg:1"], profiled["jax"]["tg"]["tg:1"]
    assert _shape(port["decode_waves"]) == _shape(ref["decode_waves"])
    counts = [[(w["bucket"], w["chunk"], w["waves"], w["dispatches"])
               for w in m["decode_waves"]] for m in (port, ref)]
    assert counts[0] == counts[1] == [(1, 1, 5, 5)]


def test_wave_cost_counts_the_decode_kernels_bytes(engines, profiled):
    """The port's fused wave: the plain decode attention reports K2's
    bytes (its arena reads) and no FLOPs (its torch ops are counted), so
    the wave's counted bytes hold them."""
    wave = profiled["port"]["tg"]["tg:1"]["decode_waves"][0]["roofline"]
    assert wave["cost_model"] == "counted"
    cost = engines.port.profiler.cost_models()[("tg", "1", 1, 1)]
    assert cost["kernel_flops"] == 0 and cost["kernel_bytes"] > 0
    assert wave["bytes_per_call"] == cost["bytes_accessed"] \
        > cost["kernel_bytes"]
    assert wave["flops_per_call"] == cost["flops"] > 0


@pytest.mark.parametrize("model", ["bert_p", "bert_flash"])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_captured_flops_equal_the_analytic_bert_count(engines, model, rows):
    """A bucket's counted FLOPs: ``bert_flops_per_example`` for every row
    of the padded bucket, plus the pooler's and classifier's matmuls,
    within 1%."""
    from client_tpu_torch.engine import InferRequest

    _infer(engines.port, InferRequest, model, rows, 99)
    model_obj = engines.port.repository.get(model)
    bucket = model_obj.pick_bucket(rows)
    entry = engines.port.profile_snapshot(model=model)["models"][f"{model}:1"]
    roof = next(b for b in entry["buckets"]
                if b["bucket"] == bucket)["roofline"]
    h = BERT["hidden"]
    want = bucket * (port_roofline.bert_flops_per_example(
        SEQ, h, BERT["n_layers"], BERT["ffn"]) + 2 * h * h + 2 * h * 2)
    assert roof["flops_per_call"] == pytest.approx(want, rel=0.01)
    # Bytes: the weights once (the token table as the rows gathered), the
    # flash kernel's q, k, v, output and bias (its plain version reports
    # them on the CPU; the einsum route has no kernel), and the inputs and
    # outputs.
    backend = model_obj.backend
    params = sum(t.numel() * t.element_size() for t in
                 list(backend.parameters()) + list(backend.buffers())
                 if t is not backend.tok_embed)
    per_layer = (4 * bucket * SEQ * h * 2 + bucket * SEQ * 4
                 if model == "bert_flash" else 0)
    gathered = bucket * SEQ * h * 2
    io = 2 * bucket * SEQ * 4 + bucket * (h + 2) * 4
    assert roof["bytes_per_call"] == params + gathered + io \
        + BERT["n_layers"] * per_layer


def test_profile_route_answers_on_both_servers(engines):
    """``GET /v2/profile`` is the engine's snapshot, on both HTTP
    servers, with the same top-level keys."""
    import http.client

    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.server import HttpInferenceServer

    bodies = []
    for engine, cls in ((engines.port, HttpInferenceServer),
                        (engines.jax, JaxHttp)):
        server = cls(engine, port=0).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            conn.request("GET", "/v2/profile?model=bert_p")
            resp = conn.getresponse()
            bodies.append((resp.status, json.loads(resp.read())))
            conn.close()
        finally:
            server.stop()
    assert bodies[0][0] == bodies[1][0] == 200
    port_keys, jax_keys = (set(b[1]) for b in bodies)
    # Both carry the HBM census's headline (``memory``) beside the table.
    assert port_keys == jax_keys
    assert set(bodies[0][1]["memory"]) == set(bodies[1][1]["memory"])
    assert set(bodies[0][1]["models"]) == {"bert_p:1"}


def test_a_cold_wave_counts_but_keeps_its_time_out():
    """A wave shape's first dispatch, run under the roofline's counter, is
    cold: counted in ``waves`` and ``dispatches``, out of the device time,
    the duty cycle and the roofline's calls (as a cold execution is)."""
    clock = Clock()
    p = port_profiler.EfficiencyProfiler(window_s=30.0, now=clock)
    p.record_wave_cost_model("gpt", "1", 16, 1, COST)
    p.record_wave("gpt", "1", 16, 1, 90_000_000, cold=True)
    cold = p.snapshot()["models"]["gpt:1"]["decode_waves"][0]
    assert (cold["waves"], cold["dispatches"], cold["device_s"]) == (1, 1, 0)
    assert cold["roofline"]["achieved_flops_per_s"] is None
    for _ in range(3):
        clock.ns += 10**8
        p.record_wave("gpt", "1", 16, 1, 2_000_000)
    warm = p.snapshot()["models"]["gpt:1"]["decode_waves"][0]
    assert (warm["waves"], warm["dispatches"]) == (4, 4)
    assert warm["device_s"] == pytest.approx(0.006)
    assert warm["roofline"]["total_flops"] == 3 * COST["flops"]
    assert warm["roofline"]["achieved_flops_per_s"] == pytest.approx(
        COST["flops"] / 0.002)
