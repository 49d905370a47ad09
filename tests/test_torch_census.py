"""The port's HBM census held against the JAX package's.

The same models on both packages (a small BERT with the JAX weights
carried across, a narrow ``tiny_gpt`` over one arena and over 2 shards,
a 2-shard DLRM) give the same owner rows: each model's ``weights``, each
generative model's ``kv_arena``, DLRM's ``embedding`` with its
reservation as the plan and no drift, byte for byte. The one designed
difference is the 2-shard arena's per-row token vector, which JAX keeps
replicated on each shard's device and the port once, on the model's
device. The report's keys, the CPU device rows (zeros), the
``CLIENT_TPU_MEMORY`` words, the pressure edges and the census gauges
agree; ``/v2/memory`` and the ``MemoryCensus`` RPC answer the same body;
an unload drops its rows; tied or viewed tensors count once.
"""

import gc
import http.client
import json
from types import SimpleNamespace

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.observability import events as jax_events
from client_tpu.observability import memory as jax_memory
from client_tpu_torch.observability import events as port_events
from client_tpu_torch.observability import memory as port_memory
from client_tpu_torch.protocol import grpc_stub
from client_tpu_torch.protocol import ops_pb2

TIMEOUT = 60  # seconds, every wait
BERT = dict(seq_len=32, hidden=64, n_layers=2, n_heads=2, ffn=128,
            vocab=256, max_batch_size=8)
GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=32, max_streams=4, attn_impl="fused")
DLRM = dict(emb_shards=2, combine="ring")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared below
        return ("error", type(exc).__name__, str(exc))


@pytest.mark.parametrize("raw", [None, "", "1", "on", "0", "off",
                                 '{"pressure_fraction": 0.5}',
                                 '{"pressure_fraction": 0}',
                                 '{"pressure_fraction": "x"}',
                                 '{"fraction": 0.5}', "[1]", "{not json",
                                 "@FILE", "@/no/such/file.json"])
def test_memory_config_equals_jax(tmp_path, raw):
    path = tmp_path / "memory.json"
    path.write_text('{"pressure_fraction": 0.75}')
    env = {} if raw is None else {
        "CLIENT_TPU_MEMORY": raw.replace("@FILE", f"@{path}")}
    got = _outcome(lambda: vars(port_memory.MemoryConfig.from_env(env)))
    want = _outcome(lambda: vars(jax_memory.MemoryConfig.from_env(env)))
    if want[0] == "error" and "cannot read" in want[2]:
        assert got[:2] == want[:2] and "cannot read" in got[2]
    else:
        assert got == want


def test_weak_tags_equal_jax():
    """Tag, free, re-tag without overwrite, untag: the same rows on both
    (numpy-seeded arrays of the same shapes and dtypes)."""
    rng = np.random.default_rng(0)
    shapes = [((3, 5), np.float32), ((7,), np.int32), ((2, 2, 4), np.float32)]
    data = [rng.standard_normal(s).astype(d) for s, d in shapes]

    def run(census, make):
        a = [make(x) for x in data]
        census.tag("m", "weights", a)
        census.tag("m", "embedding", a[1:2], overwrite=False)
        census.tag("e", "embedding", [a[2]])
        rows = [census.report()["owners"]]
        del a[0]
        gc.collect()
        rows.append(census.report()["owners"])
        census.untag("e")
        rows.append(census.report()["owners"])
        return rows

    assert run(port_memory.HbmCensus(), torch.from_numpy) \
        == run(jax_memory.HbmCensus(), jnp.asarray)


def test_a_storage_counts_once():
    """Tied parameters and views share a storage: the census counts it
    once, for the first owner that holds it."""
    census = port_memory.HbmCensus()
    w = torch.zeros(8, 16)
    held = [w, w.view(16, 8), w[2:4], w.t(), torch.zeros(4)]  # tags are weak
    census.tag("m", "weights", held[:3])
    census.tag("n", "weights", held[3:])
    rows = {(r["model"], r["component"]): (r["bytes"], r["buffers"])
            for r in census.report()["owners"]}
    assert rows == {("m", "weights"): (512, 3), ("n", "weights"): (16, 2)}


def test_pressure_edges_equal_jax():
    """Scripted device rows across the threshold: one ``memory.pressure``
    on the way up, one ``pressure_cleared`` on the way down, on both."""
    script = [(10, 100), (95, 100), (97, 100), (50, 100), (40, 100),
              (99, 100)]

    def run(mod, events):
        events.journal().clear()
        census = mod.HbmCensus(mod.MemoryConfig(pressure_fraction=0.9))
        out = []
        for in_use, limit in script:
            census.device_stats = lambda u=in_use, lim=limit: [{
                "device": "0", "platform": "gpu", "bytes_in_use": u,
                "bytes_limit": lim, "peak_bytes_in_use": u}]
            rep = census.report(events=events.journal())
            out.append((rep["pressure"], rep["totals"]["committed_bytes"],
                        rep["watermark_bytes"]))
        return out, [(e["name"], e["severity"], e.get("detail"))
                     for e in events.journal().export(
                         category="memory")["events"]]

    got = run(port_memory, port_events)
    assert got == run(jax_memory, jax_events)
    assert [e[0] for e in got[1]] == ["pressure", "pressure_cleared",
                                      "pressure"]


# ---------------------------------------------------------------------------
# Both engines with the same models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepo
    from client_tpu.models.bert import BertBackend as JaxBert
    from client_tpu.models.dlrm import DlrmBackend as JaxDlrm
    from client_tpu.models.generate import TinyGptBackend as JaxGpt
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models.bert import BertBackend
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    # Each package's census holds this module's models alone.
    jax_memory.reset_hbm_census()
    port_memory.reset_hbm_census()
    jr = JaxRepo()
    jr.register("bert_c", lambda: JaxBert(name="bert_c", **BERT))
    jr.register("tg", lambda: JaxGpt(name="tg", **GPT))
    jr.register("tg2", lambda: JaxGpt(name="tg2", kv_shards=2, **GPT))
    jr.register("dl", lambda: JaxDlrm(name="dl", **DLRM))
    jax_engine = TpuEngine(jr)
    tree = jax_engine.repository.get("bert_c")._params

    def bert(device):
        b = BertBackend(name="bert_c", device=device, **BERT)
        b.load_jax_params(tree)
        return b

    pr = ModelRepository()
    pr.register("bert_c", bert)
    pr.register("tg", lambda device: TinyGptBackend(name="tg", device=device,
                                                    **GPT))
    pr.register("tg2", lambda device: TinyGptBackend(
        name="tg2", kv_shards=2, device=device, **GPT))
    pr.register("dl", lambda device: DlrmBackend(name="dl", device=device,
                                                 **DLRM))
    port_engine = TorchEngine(pr, device="cpu")
    grpc_server = GrpcInferenceServer(port_engine, port=0).start()
    channel = grpc.insecure_channel(grpc_server.url)
    sides = {
        "port": SimpleNamespace(
            engine=port_engine,
            http=HttpInferenceServer(port_engine, port=0).start(),
            grpc=grpc_server, channel=channel,
            stub=grpc_stub.GRPCInferenceServiceStub(channel)),
        "jax": SimpleNamespace(engine=jax_engine,
                               http=JaxHttp(jax_engine, port=0).start()),
    }
    assert all(e["state"] == "READY" for side in sides.values()
               for e in side.engine.repository_index())
    yield sides
    channel.close()
    grpc_server.stop()
    for side in sides.values():
        side.http.stop()
        side.engine.shutdown()


def _rows(report) -> dict:
    return {(r["model"], r["component"]):
            {k: v for k, v in r.items() if k not in ("model", "component")}
            for r in report["owners"]}


def test_owner_rows_equal_jax(engines):
    got = engines["port"].engine.memory_census()
    want = engines["jax"].engine.memory_census()
    assert set(got) == set(want) and set(got["totals"]) == set(want["totals"])
    assert all(d["bytes_in_use"] == d["bytes_limit"]
               == d["peak_bytes_in_use"] == 0
               for d in got["devices"] + want["devices"])
    port_rows, jax_rows = _rows(got), _rows(want)
    assert set(port_rows) == set(jax_rows) == {
        ("bert_c", "weights"), ("tg", "weights"), ("tg", "kv_arena"),
        ("tg2", "weights"), ("tg2", "kv_arena"), ("dl", "weights"),
        ("dl", "embedding")}
    for owner in port_rows:
        if owner == ("tg2", "kv_arena"):
            continue
        assert port_rows[owner]["bytes"] == jax_rows[owner]["bytes"], owner
    # The sharded arena: JAX replicates the [R] int32 token vector on
    # each of the 2 shards' devices; the port keeps it once.
    tok = engines["port"].engine.scheduler_for("tg2")._arena.tok
    assert jax_rows[("tg2", "kv_arena")]["bytes"] \
        - port_rows[("tg2", "kv_arena")]["bytes"] \
        == tok.numel() * tok.element_size()
    # DLRM's reservation is the plan, and no byte drifts from it.
    for rows_of in (port_rows, jax_rows):
        emb = rows_of[("dl", "embedding")]
        assert emb["plan_bytes"] == emb["bytes"] and emb["drift_bytes"] == 0


def test_memory_route_and_rpc_agree(engines):
    def http_get(side, path):
        conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                          timeout=TIMEOUT)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    port = engines["port"]
    status, body = http_get(port, "/v2/memory")
    rpc = json.loads(port.stub.MemoryCensus(ops_pb2.MemoryRequest(),
                                            timeout=TIMEOUT).memory_json)
    assert status == 200 and body == rpc
    jax_status, jax_body = http_get(engines["jax"], "/v2/memory")
    assert jax_status == 200 and set(body) == set(jax_body)


def test_census_gauges_render_alike(engines):
    # The owner rows; not the unattributed remainder: on the CPU the
    # port's committed bytes are the card allocator's (0 without one),
    # JAX's every live array's.
    def gauges(side):
        return {line for line in side.engine.prometheus_metrics().splitlines()
                if line.startswith("tpu_hbm_census_bytes{")
                and "tg2" not in line and "unattributed" not in line}

    assert gauges(engines["port"]) == gauges(engines["jax"])
    assert 'tpu_hbm_census_bytes{model="dl",component="embedding"} 8192' \
        in gauges(engines["port"])


def test_an_unload_drops_its_rows(engines):
    """The port drops a model's rows at its unload, whoever still holds its
    tensors (here the test's builder holds the JAX weights it copies, so
    JAX's weak tags keep counting them); a reload tags the new weights."""
    port = engines["port"].engine
    port.unload_model("bert_c")
    assert ("bert_c", "weights") not in _rows(port.memory_census())
    port.load_model("bert_c")
    assert _rows(port.memory_census())[("bert_c", "weights")]["bytes"] \
        == _rows(engines["jax"].engine.memory_census())[
            ("bert_c", "weights")]["bytes"]
