"""The port's metrics plane held against the JAX package's.

The metric registries render byte for byte alike for the same operations
(exemplars, escaping and OpenMetrics' ``# EOF`` included; rendering is
string formatting, so exact). ``EngineMetrics`` declares the same
families. After the same request script (sequential, so the batches are
the same), both servers' ``/metrics`` have the same families, types and
label sets, and equal deterministic counters, parsed with
``client_tpu/observability/scrape.py``.
"""

import http.client
import json
from types import SimpleNamespace

import numpy as np
import pytest

from client_tpu.observability import metrics as jax_metrics
from client_tpu.observability import scrape
from client_tpu_torch.observability import metrics as port_metrics

TIMEOUT = 60  # seconds, every wait


def _script(mod, seed: int):
    """A seeded sequence of metric operations on a fresh registry."""
    rng = np.random.default_rng(seed)
    r = mod.MetricRegistry()
    c = r.counter("t_requests_total", "Requests\nwith \\ help", ("model",))
    bare = r.counter("t_bare_total", "No labels")
    g = r.gauge("t_depth", "Depth", ("model", "version"))
    h = r.histogram("t_latency_us", "Latency", ("model",))
    hb = r.histogram("t_batch", "Batch", (), buckets=(1, 2, 4, 8.5))
    models = ['a', 'b"q', "c\\d", "e\nf"]
    for step in range(int(rng.integers(20, 60))):
        op = int(rng.integers(0, 7))
        m = models[int(rng.integers(0, len(models)))]
        ex = f"{int(rng.integers(0, 2**62)):032x}" if rng.random() < 0.5 \
            else None
        if op == 0:
            c.inc(float(rng.integers(1, 4)), exemplar=ex, model=m)
        elif op == 1:
            bare.inc(float(rng.random()))
        elif op == 2:
            g.set(float(rng.normal()) * 1e3, model=m, version=str(step % 3))
        elif op == 3:
            g.inc(0.5, model=m, version="1")
            g.dec(2, model=m, version="2")
        elif op == 4:
            h.observe(float(rng.exponential(2e4)), exemplar=ex, model=m)
        elif op == 5:
            hb.observe(float(rng.integers(0, 12)), exemplar=ex)
        else:
            g.remove(model=m, version="1")
    return r


@pytest.mark.parametrize("openmetrics", [False, True], ids=["0.0.4", "om"])
@pytest.mark.parametrize("seed", range(8))
def test_registry_renders_byte_for_byte_as_jax(seed, openmetrics):
    port = _script(port_metrics, seed).render(openmetrics)
    assert port == _script(jax_metrics, seed).render(openmetrics)
    if openmetrics:
        assert port.endswith("# EOF\n")


def test_empty_registry_renders_as_jax():
    for om in (False, True):
        assert port_metrics.MetricRegistry().render(om) \
            == jax_metrics.MetricRegistry().render(om)


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared below
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("call", [
    lambda r: (r.counter("x", "h", ("a",)), r.gauge("x", "h", ("a",))),
    lambda r: (r.counter("x", "h", ("a",)), r.counter("x", "h", ("b",))),
    lambda r: r.histogram("x", "h", buckets=()),
    lambda r: r.counter("x", "h", ("a", "b")).labels("1"),
    lambda r: r.gauge("x", "h", ("a",)).set(1.0, b="2"),
], ids=["type", "labels", "no-buckets", "arity", "label-name"])
def test_declaration_errors_equal_jax(call):
    port = _error(lambda: call(port_metrics.MetricRegistry()))
    assert port is not None
    assert port == _error(lambda: call(jax_metrics.MetricRegistry()))


@pytest.mark.parametrize("openmetrics", [False, True], ids=["0.0.4", "om"])
def test_engine_vocabulary_and_instruments_render_as_jax(openmetrics):
    """``EngineMetrics`` declares the JAX engine's families (help, type
    and labels), and ``ModelInstruments`` observe alike."""
    renders = []
    for mod in (port_metrics, jax_metrics):
        em = mod.EngineMetrics()
        times = SimpleNamespace(queue_ns=1_500, compute_input_ns=40_000,
                                compute_infer_ns=2_000_000,
                                compute_output_ns=900)
        inst = em.model_instruments("bert", "2")
        assert em.model_instruments("bert", "2") is inst
        for i in range(5):
            inst.observe_request(3_000_000 * i, times,
                                 trace_id=f"{i:032x}" if i % 2 else None)
            inst.observe_execution(1 << i)
        em.queue_depth.set(3, model="bert", version="2")
        renders.append(em.render(openmetrics))
    assert renders[0] == renders[1]


def test_device_gauges_on_the_cpu_render_zero_for_device_0():
    em = port_metrics.EngineMetrics()
    em.update_device_gauges()
    samples = {(m, tuple(sorted(lab.items()))): v
               for m, lab, v in scrape.parse_samples(em.render())}
    for fam in ("tpu_device_hbm_bytes_in_use", "tpu_hbm_limit_bytes",
                "tpu_hbm_peak_bytes"):
        assert samples[(fam, (("device", "0"),))] == 0


# ---------------------------------------------------------------------------
# Both servers
# ---------------------------------------------------------------------------

SEQ = 32
BERT = dict(seq_len=SEQ, hidden=64, n_layers=2, n_heads=2, ffn=128,
            vocab=256, max_batch_size=8)


@pytest.fixture(scope="module")
def servers():
    """Each package's engine (``simple`` and a small BERT with the same
    weights) behind its HTTP server on port 0."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.models.bert import BertBackend as JaxBert
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.bert import BertBackend
    from client_tpu_torch.server import HttpInferenceServer

    jax_repo = jax_build(["simple"])
    jax_bert = JaxBert(name="bert_obs", **BERT)
    jax_repo.register_backend(jax_bert)
    jax_engine = TpuEngine(jax_repo)
    tree = jax_engine.repository.get("bert_obs")._params
    repo = build_repository(["simple"])

    def bert(device):
        b = BertBackend(name="bert_obs", device=device, **BERT)
        b.load_jax_params(tree)
        return b

    repo.register("bert_obs", bert)
    sides = {}
    for name, engine, http_cls in (
            ("port", TorchEngine(repo, device="cpu"), HttpInferenceServer),
            ("jax", jax_engine, JaxHttp)):
        sides[name] = SimpleNamespace(engine=engine,
                                      http=http_cls(engine, port=0).start())
    yield sides
    for side in sides.values():
        side.http.stop()
        side.engine.shutdown()


def _request(side, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _simple_body(rows):
    a = np.arange(16 * rows, dtype=np.int32).reshape(rows, 16)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [rows, 16],
         "data": a.ravel().tolist()} for n in ("INPUT0", "INPUT1")]})


def _bert_body(rows, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BERT["vocab"], (rows, SEQ))
    mask = np.ones((rows, SEQ), np.int64)
    return json.dumps({"inputs": [
        {"name": "input_ids", "datatype": "INT32", "shape": [rows, SEQ],
         "data": ids.ravel().tolist()},
        {"name": "attention_mask", "datatype": "INT32",
         "shape": [rows, SEQ], "data": mask.ravel().tolist()}]})


def _script_requests(side):
    """The same sequence on either server: one request at a time, so every
    batch is the request's own rows."""
    out = []
    for rows in (1, 2, 3, 1, 4, 2):
        out.append(_request(side, "POST", "/v2/models/simple/infer",
                            _simple_body(rows))[0])
    for i, rows in enumerate((1, 3, 2, 1)):
        out.append(_request(side, "POST", "/v2/models/bert_obs/infer",
                            _bert_body(rows, i))[0])
    # A request for a model neither server has counts on no model's
    # counters.
    out.append(_request(side, "POST", "/v2/models/missing/infer",
                        _simple_body(1))[0])
    return out


def _families(text: str) -> dict[str, str]:
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            out[name] = kind
    return out


def _label_sets(text: str) -> dict[str, set]:
    out: dict[str, set] = {}
    for name, labels, _ in scrape.parse_samples(text):
        out.setdefault(name, set()).add(tuple(sorted(labels)))
    return out


# Counters and histogram counts that follow from the request script alone.
DETERMINISTIC = (
    "tpu_inference_request_success", "tpu_inference_request_failure",
    "tpu_inference_count", "tpu_inference_exec_count",
    "tpu_batch_size_bucket", "tpu_batch_size_count", "tpu_batch_size_sum",
    "tpu_request_duration_us_count", "tpu_phase_duration_us_count",
    "tpu_batch_fill_ratio_count",
)
# These follow from the bucket ladder too: the JAX package's ``simple``
# pads to its [1, 8, 64] ladder, the port's to powers of two (its config
# has no ladder of its own), so they are held for the BERT alone.
LADDER = ("tpu_batch_fill_ratio_bucket", "tpu_padded_rows_total",
          "tpu_xla_compilations_total")


@pytest.fixture(scope="module")
def scraped(servers):
    out = {}
    for name, side in servers.items():
        assert _script_requests(side) == [200] * 10 + [404]
        plain = _request(side, "GET", "/metrics")
        om = _request(side, "GET", "/metrics", headers={
            "Accept": "application/openmetrics-text; version=1.0.0"})
        out[name] = SimpleNamespace(plain=plain, om=om)
    return out


@pytest.mark.parametrize("fmt", ["plain", "om"])
def test_metrics_route_status_and_content_type_equal_jax(scraped, fmt):
    port, ref = getattr(scraped["port"], fmt), getattr(scraped["jax"], fmt)
    assert port[0] == ref[0] == 200
    assert port[1]["Content-Type"] == ref[1]["Content-Type"]
    if fmt == "om":
        assert port[2].decode().endswith("# EOF\n")


@pytest.mark.parametrize("fmt", ["plain", "om"])
def test_port_families_are_the_jax_servers_with_their_types(scraped, fmt):
    """Every family the port renders, the JAX server renders with the same
    type; the JAX server's extra families belong to the planes the port
    does not have yet (SLO, costs, shm ring, admission)."""
    port = _families(getattr(scraped["port"], fmt)[2].decode())
    ref = _families(getattr(scraped["jax"], fmt)[2].decode())
    assert port.items() <= ref.items()
    legacy = {"tpu_inference_request_success", "tpu_inference_exec_count"}
    engine = {"tpu_request_duration_us", "tpu_phase_duration_us",
              "tpu_batch_size", "tpu_queue_depth", "tpu_inflight_batches",
              "tpu_device_hbm_bytes_in_use", "tpu_batch_fill_ratio",
              "tpu_device_duty_cycle", "tpu_mfu", "tpu_mbu"}
    counters = {"tpu_fault_injections_total", "tpu_xla_compilations_total",
                "tpu_padded_rows_total", "tpu_device_seconds_total",
                "tpu_model_flops_total"}
    if fmt == "om":
        counters = {c[:-len("_total")] for c in counters}
        legacy = set()
    assert legacy | engine | counters <= set(port)


def test_label_sets_equal_jax(scraped):
    """Each sample name the port renders has the JAX server's label names
    (the HBM gauges' ``device`` label aside: the JAX server on the test's
    8 virtual CPU devices has eight)."""
    port = _label_sets(scraped["port"].plain[2].decode())
    ref = _label_sets(scraped["jax"].plain[2].decode())
    for name, sets in port.items():
        assert name in ref, name
        assert sets == ref[name], name


@pytest.mark.parametrize("family", DETERMINISTIC + LADDER)
def test_deterministic_counters_equal_jax(scraped, family):
    models = ("bert_obs",) if family in LADDER else ("simple", "bert_obs")

    def values(side):
        return sorted((tuple(sorted(lab.items())), v)
                      for m, lab, v in scrape.parse_samples(
                          scraped[side].plain[2].decode())
                      if m == family and lab.get("model") in models)

    port = values("port")
    assert port, family
    assert port == values("jax")


def test_exemplars_link_to_traced_requests(scraped, servers):
    """An OpenMetrics exemplar of the request histogram is the trace id
    of a request the server traced."""
    body = scraped["port"].om[2].decode()
    ids = {line.split('trace_id="')[1].split('"')[0]
           for line in body.splitlines()
           if line.startswith("tpu_request_duration_us_bucket")
           and " # {" in line}
    assert ids
    traced = {e["args"]["trace_id"] for e in servers["port"].engine
              .request_trace_export()["traceEvents"]}
    assert ids <= traced
