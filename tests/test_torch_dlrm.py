"""The port's DLRM subsystem against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

- ``parallel/emb_shard.py``: ``quantize_table``, ``bag_sum_oracle`` and
  ``sharded_bag_sum`` for 2, 4 and 8 shards under both combines (the JAX
  side under ``shard_map`` on the 8 virtual CPU devices of
  ``tests/conftest.py``, its ring in Pallas interpret mode; the port's
  shards on ``cpu``, where ``ring_all_reduce`` is its plain version). Bit
  for bit: every table value is a multiple of 2^-8 and every sum stays
  under 2^15 (``quantize_table``), so no order of additions changes a sum;
- ``engine/rowcache.py``: the same lookups give the same vectors, hits,
  evictions and snapshot;
- ``models/dlrm.py``: ``pre_stage`` equal array for array,
  ``validate_ragged`` error for error (status and words), the weights
  equal, the scores within 1e-5 (relative and absolute: fp32 MLPs, the
  same products summed in another order by the two libraries' GEMMs);
- ``engine/ragged.py``: the same queued requests form the same batches
  (split, never overflowing; empty bags; zero-lookup requests);
- both frontends, and ``examples/python/dlrm_client.py`` over each.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.engine.rowcache import RowCache as JaxRowCache
from client_tpu.models.dlrm import DlrmBackend as JaxDlrm
from client_tpu.parallel import emb_shard as jes
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.model import Model
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.engine.rowcache import RowCache
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.models import build_repository
from client_tpu_torch.models import dlrm
from client_tpu_torch.models.dlrm import DlrmBackend
from client_tpu_torch.parallel import emb_shard as es
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol import grpc_stub

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RTOL = ATOL = 1e-5
TIMEOUT = 60


def make_csr(rng, batch, num_tables=4, max_per_bag=5, rows=64):
    """A random CSR request: (dense, indices, offsets)."""
    counts = rng.integers(0, max_per_bag + 1, size=batch * num_tables)
    indices = rng.integers(0, rows, size=int(counts.sum())).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    dense = rng.standard_normal((batch, 8)).astype(np.float32)
    return dense, indices, offsets


def csr_inputs(dense, indices, offsets):
    return {"DENSE": dense, "INDICES": indices, "OFFSETS": offsets}


# -- emb_shard ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_table_equals_jax(seed):
    x = np.random.default_rng(seed).standard_normal((64, 8)) * 3
    got = es.quantize_table(x)
    assert got.dtype == np.float32
    assert np.array_equal(got, jes.quantize_table(x))
    assert np.array_equal(got * 256, np.round(got * 256))


def _bag_case(seed, rows=256, dim=16, n=200, segs=12):
    rng = np.random.default_rng(seed)
    table = es.quantize_table(rng.standard_normal((rows, dim)))
    idx = rng.integers(0, rows, size=n).astype(np.int32)
    # Segment ids past num_segments are padding and must vanish.
    seg = rng.integers(0, segs + 2, size=n).astype(np.int32)
    return table, idx, seg, segs


@pytest.mark.parametrize("seed", [0, 1])
def test_bag_sum_oracle_equals_jax(seed):
    table, idx, seg, segs = _bag_case(seed)
    want = np.asarray(jes.bag_sum_oracle(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), segs))
    got = es.bag_sum_oracle(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(seg), segs)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("combine", ["psum", "ring"])
def test_sharded_bag_sum_bit_identical_to_jax(shards, combine):
    table, idx, seg, segs = _bag_case(shards)
    mesh = jes.emb_mesh(shards)
    want = np.asarray(jes.sharded_bag_sum(
        mesh, jes.shard_table(table, mesh), jnp.asarray(idx),
        jnp.asarray(seg), segs, combine=combine, interpret=True))
    oracle = np.asarray(jes.bag_sum_oracle(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), segs))
    assert np.array_equal(want, oracle)
    cpu = es.emb_mesh(shards, ["cpu"] * shards)
    got = es.sharded_bag_sum(cpu, es.shard_table(table, cpu),
                             torch.from_numpy(idx), torch.from_numpy(seg),
                             segs, combine=combine)
    assert np.array_equal(got.numpy(), want)


def test_shard_table_rejects_uneven_rows_as_jax_does():
    table = np.zeros((10, 4), np.float32)
    with pytest.raises(ValueError) as jax_exc:
        jes.shard_table(table, jes.emb_mesh(4))
    with pytest.raises(ValueError) as exc:
        es.shard_table(table, es.emb_mesh(4, ["cpu"] * 4))
    assert str(exc.value) == str(jax_exc.value)


def test_shard_table_splits_rows_in_order():
    table = np.arange(32, dtype=np.float32).reshape(8, 4)
    parts = es.shard_table(table, es.emb_mesh(4, ["cpu"] * 4))
    assert [p.shape for p in parts] == [(2, 4)] * 4
    assert np.array_equal(torch.cat(parts).numpy(), table)
    assert all(p.is_contiguous() for p in parts)


def test_emb_mesh_refusals():
    with pytest.raises(ValueError, match="emb_shards=64 but runtime has"):
        es.emb_mesh(64)
    with pytest.raises(ValueError, match="emb_shards=2 but 1 device"):
        es.emb_mesh(2, ["cpu"])
    with pytest.raises(NotImplementedError, match="emb mesh over distinct"):
        es.emb_mesh(2, ["cpu", "meta"])
    with pytest.raises(ValueError, match="combine"):
        mesh = es.emb_mesh(2, ["cpu"] * 2)
        es.sharded_bag_sum(mesh, [torch.zeros(2, 2)] * 2,
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), 1,
                           combine="tree")


# -- RowCache -----------------------------------------------------------------


def _caches(rows=32, dim=4, budget_rows=8):
    table = np.arange(rows * dim, dtype=np.float32).reshape(rows, dim)
    budget = budget_rows * dim * 4
    return RowCache(table, budget), JaxRowCache(table, budget), table


@pytest.mark.parametrize("budget_rows", [0, 1, 4, 8])
def test_row_cache_equals_jax_lookup_for_lookup(budget_rows):
    port, ref, table = _caches(budget_rows=budget_rows)
    rng = np.random.default_rng(budget_rows)
    for _ in range(12):
        rows = rng.zipf(1.3, size=int(rng.integers(0, 10))) % 32
        got, hits = port.lookup_counted(rows)
        want, want_hits = ref.lookup_counted(rows)
        assert np.array_equal(got, want) and hits == want_hits
        assert np.array_equal(got, table[rows])
        assert port.snapshot() == ref.snapshot()
    port.clear()
    ref.clear()
    assert port.snapshot() == ref.snapshot()


def test_row_cache_hits_lru_and_budget():
    """tests/test_dlrm.py TestRowCache, on the port."""
    cache, _, table = _caches()
    out, hits = cache.lookup_counted(np.array([3, 3, 5]))
    assert np.array_equal(out, table[[3, 3, 5]])
    assert (cache.lookups, hits) == (3, 0)  # duplicates fault once
    out, hits = cache.lookup_counted(np.array([3, 5, 9]))
    assert hits == 2 and cache.hit_rate() == pytest.approx(2 / 6)
    lru, _, _ = _caches(budget_rows=4)
    lru.lookup(np.arange(4))
    lru.lookup(np.array([0]))   # 0 is now the most recent
    lru.lookup(np.array([10]))  # evicts row 1
    assert lru.evictions == 1 and lru.size_bytes() == 4 * lru.row_bytes
    assert lru.lookup_counted(np.array([0, 1]))[1] == 1
    before = (lru.lookups, lru.misses)
    lru.clear()
    assert lru.snapshot()["resident_rows"] == 0
    assert (lru.lookups, lru.misses) == before
    with pytest.raises(ValueError, match="2-D"):
        RowCache(np.zeros(4, np.float32))


# -- the backend --------------------------------------------------------------


def test_weights_equal_jax_and_params_from_jax():
    jax_backend = JaxDlrm(name="d", seed=3)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_backend.make_apply_params()[1])
    port = DlrmBackend(name="d", seed=3, device="cpu")
    assert np.array_equal(port.table_host, jax_backend.table_host)
    state = port.state_dict()
    for k, v in dlrm.params_from_jax(params).items():
        assert torch.equal(state[k], v), k


def _pre_stage_cases():
    rng = np.random.default_rng(4)
    cases = [(make_csr(rng, b), pad) for b, pad in
             ((1, None), (2, 64), (3, 128), (8, 128))]
    empty = (np.ones((1, 8), np.float32), np.zeros(0, np.int32),
             np.zeros(5, np.int32))
    return cases + [(empty, None), (empty, 1)]


@pytest.mark.parametrize("host_tables", [False, True])
def test_pre_stage_equals_jax(host_tables):
    kw = dict(name="d", host_tables=host_tables, cache_budget_bytes=256)
    port = DlrmBackend(device="cpu", **kw)
    ref = JaxDlrm(**kw)
    for (dense, idx, off), pad in _pre_stage_cases():
        got = port.pre_stage(csr_inputs(dense, idx, off), pad)
        want = ref.pre_stage(csr_inputs(dense, idx, off), pad)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    if host_tables:
        assert port.row_cache.snapshot() == ref.row_cache.snapshot()


def test_synthetic_inputs_equal_jax():
    port, ref = DlrmBackend(device="cpu"), JaxDlrm()
    for lookups in (0, 1, 5, 128):
        got, want = port.synthetic_inputs(lookups), ref.synthetic_inputs(
            lookups)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def _bad_requests():
    rng = np.random.default_rng(1)
    dense, idx, off = make_csr(rng, 2)
    over = np.zeros(129, np.int32)
    return {
        "offsets_length": (dense, idx, off[:-1]),
        "offsets_start": (dense, idx, off + 1),
        "decreasing": (dense, idx, np.concatenate(
            [[0, off[-1] + 1], off[2:]]).astype(np.int32)),
        "offsets_end": (dense, idx, np.concatenate(
            [off[:-1], [off[-1] + 3]]).astype(np.int32)),
        "too_many_lookups": (dense[:1], over,
                             np.array([0, 129, 129, 129, 129], np.int32)),
        "out_of_range": (dense[:1], np.array([1 << 20], np.int32),
                         np.array([0, 1, 1, 1, 1], np.int32)),
        "negative": (dense[:1], np.array([-1], np.int32),
                     np.array([0, 1, 1, 1, 1], np.int32)),
        "dense_rank": (dense[0], idx, off),
        "indices_rank": (dense, idx[None], off),
        "indices_dtype": (dense, idx.astype(np.int64), off),
        "rows": (np.ones((9, 8), np.float32), np.zeros(0, np.int32),
                 np.zeros(37, np.int32)),
    }


@pytest.fixture(scope="module")
def engines():
    """The port's and the JAX package's engines, each with ``dlrm`` and
    ``dlrm_cached`` at their registered sizes (same seeds)."""
    from client_tpu.models import build_repository as jax_build

    port = TorchEngine(build_repository(["dlrm", "dlrm_cached"]),
                       device="cpu")
    ref = TpuEngine(jax_build(["dlrm", "dlrm_cached"]))
    yield port, ref
    ref.shutdown()
    port.shutdown()


@pytest.mark.parametrize("case", sorted(_bad_requests()))
def test_validation_errors_equal_jax(engines, case):
    port, ref = engines
    inputs = csr_inputs(*_bad_requests()[case])
    with pytest.raises(EngineError) as exc:
        port.infer(InferRequest(model_name="dlrm", inputs=dict(inputs)),
                   timeout_s=TIMEOUT)
    with pytest.raises(Exception) as jax_exc:
        ref.infer(JaxRequest(model_name="dlrm", inputs=dict(inputs)),
                  timeout_s=TIMEOUT)
    assert (exc.value.status, str(exc.value)) == (
        jax_exc.value.status, str(jax_exc.value))
    assert exc.value.status == 400


@pytest.mark.parametrize("model", ["dlrm", "dlrm_cached"])
def test_scores_equal_jax(engines, model):
    port, ref = engines
    rng = np.random.default_rng(7)
    for batch in (1, 2, 5, 8):
        inputs = csr_inputs(*make_csr(rng, batch))
        got = port.infer(InferRequest(model_name=model, inputs=dict(inputs)),
                         timeout_s=TIMEOUT).outputs["OUTPUT0"]
        want = ref.infer(JaxRequest(model_name=model, inputs=dict(inputs)),
                         timeout_s=TIMEOUT).outputs["OUTPUT0"]
        assert got.shape == want.shape == (batch, 1)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_empty_bags_and_zero_lookups(engines):
    port, ref = engines
    dense = np.ones((1, 8), np.float32)
    for idx, off in ((np.zeros(0, np.int32), np.zeros(5, np.int32)),
                     (np.array([3, 4], np.int32),
                      np.array([0, 2, 2, 2, 2], np.int32))):
        inputs = csr_inputs(dense, idx, off)
        got = port.infer(InferRequest(model_name="dlrm", inputs=dict(inputs)),
                         timeout_s=TIMEOUT).outputs["OUTPUT0"]
        want = ref.infer(JaxRequest(model_name="dlrm", inputs=dict(inputs)),
                         timeout_s=TIMEOUT).outputs["OUTPUT0"]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cached_hits_and_equals_uncached_bit_for_bit(engines):
    port, _ = engines
    rng = np.random.default_rng(8)
    inputs = csr_inputs(*make_csr(rng, 2))
    a = port.infer(InferRequest(model_name="dlrm", inputs=dict(inputs)),
                   timeout_s=TIMEOUT).outputs["OUTPUT0"]
    for _ in range(3):
        b = port.infer(InferRequest(model_name="dlrm_cached",
                                    inputs=dict(inputs)),
                       timeout_s=TIMEOUT).outputs["OUTPUT0"]
        assert np.array_equal(a, b)
    cache = port.repository.get("dlrm_cached").backend.row_cache
    assert cache.hits > 0 and cache.hit_rate() > 0


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("combine", ["psum", "ring"])
def test_sharded_backend_bit_identical_to_unsharded(shards, combine):
    """The whole model on sharded tables equals the unsharded model with
    the same seed bit for bit (the bag sums are exact, and the rest is the
    same computation on the same values)."""
    plain = Model(DlrmBackend(name="d0", seed=7, device="cpu"), device="cpu")
    shard = Model(DlrmBackend(name="d1", seed=7, emb_shards=shards,
                              combine=combine, device="cpu"), device="cpu")
    assert len(shard.backend.shards()) == shards
    rng = np.random.default_rng(3)
    inputs = csr_inputs(*make_csr(rng, 3))
    nnz = int(inputs["INDICES"].shape[0])
    o0, _ = plain.execute_timed(dict(inputs), batch_size=nnz)
    o1, _ = shard.execute_timed(dict(inputs), batch_size=nnz)
    assert o0["OUTPUT0"].shape == (8, 1)  # rows stay padded
    assert np.array_equal(o0["OUTPUT0"], o1["OUTPUT0"])


def test_backend_refusals():
    with pytest.raises(ValueError, match="combine"):
        DlrmBackend(emb_shards=2, combine="tree", device="cpu")
    with pytest.raises(ValueError, match="must start on"):
        DlrmBackend(emb_shards=2, emb_devices=["meta", "meta"], device="cpu")


# -- the ragged scheduler -----------------------------------------------------

# (rows, lookups) of each request, queued behind a blocked first execution
# (dlrm: max_lookups 128, max_batch_size 8): B+C+D fill 100 lookups and E
# would overflow 128; E+F+G fill 6 rows and H would overflow 8.
QUEUED = [("A", 1, 10), ("B", 2, 40), ("C", 1, 0), ("D", 3, 60),
          ("E", 1, 40), ("F", 3, 20), ("G", 2, 30), ("H", 3, 5)]


def _queued_request(rng, rows, lookups):
    counts = np.zeros(rows * 4, np.int64)
    np.add.at(counts, rng.integers(0, rows * 4, size=lookups), 1)
    idx = rng.integers(0, 64, size=lookups).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    dense = rng.standard_normal((rows, 8)).astype(np.float32)
    return csr_inputs(dense, idx, off)


def _run_queued(engine, make_request, model):
    """Submit QUEUED with the first execution held until the rest are
    queued; returns ([(rows, lookups) per execution], scores by name)."""
    cfg = model.config
    cfg.dynamic_batching.max_queue_delay_microseconds = 0
    entered, release = threading.Event(), threading.Event()
    executions = []
    real = model.execute_timed

    def held(inputs, batch_size=None, **kw):
        executions.append((int(inputs["DENSE"].shape[0]), batch_size))
        entered.set()
        release.wait(TIMEOUT)
        return real(inputs, batch_size=batch_size, **kw)

    model.execute_timed = held
    rng = np.random.default_rng(11)
    results, done = {}, {name: threading.Event() for name, _, _ in QUEUED}
    try:
        for i, (name, rows, lookups) in enumerate(QUEUED):
            def cb(resp, name=name):
                results[name] = resp
                done[name].set()
            engine.async_infer(make_request(
                _queued_request(rng, rows, lookups)), cb)
            if i == 0:
                assert entered.wait(TIMEOUT)
        release.set()
        for ev in done.values():
            assert ev.wait(TIMEOUT)
    finally:
        release.set()
        model.execute_timed = real
        cfg.dynamic_batching.max_queue_delay_microseconds = 200
    for name, resp in results.items():
        assert resp.error is None, (name, resp.error)
    return executions, {k: r.outputs["OUTPUT0"] for k, r in results.items()}


def test_ragged_batches_equal_jax(engines):
    """The same queue forms the same batches on both sides: split before
    either ceiling overflows, never dropped; an empty-bag request and a
    zero-lookup one ride along. Every score within the tolerance of
    JAX's, and each request's rows windowed out right."""
    port, ref = engines
    got, scores = _run_queued(
        port, lambda inputs: InferRequest(model_name="dlrm", inputs=inputs),
        port.repository.get("dlrm"))
    want, jax_scores = _run_queued(
        ref, lambda inputs: JaxRequest(model_name="dlrm", inputs=inputs),
        ref._schedulers["dlrm"].model)
    assert got == want == [(1, 10), (6, 100), (6, 90), (3, 5)]
    for name, rows, _ in QUEUED:
        assert scores[name].shape == (rows, 1)
        np.testing.assert_allclose(scores[name], jax_scores[name],
                                   rtol=RTOL, atol=ATOL)


def test_batched_scores_equal_serial_bit_for_bit(engines):
    """Rows always pad to max_batch_size, so a request's score does not
    depend on what it was batched with."""
    port, _ = engines
    rng = np.random.default_rng(5)
    reqs = [csr_inputs(*make_csr(rng, int(rng.integers(1, 4))))
            for _ in range(8)]
    model = port.repository.get("dlrm")
    serial = []
    for inputs in reqs:
        out, _ = model.execute_timed(dict(inputs), batch_size=int(
            inputs["INDICES"].shape[0]))
        serial.append(out["OUTPUT0"][:inputs["DENSE"].shape[0]])
    results = [None] * len(reqs)
    done = [threading.Event() for _ in reqs]
    for i, inputs in enumerate(reqs):
        def cb(resp, i=i):
            results[i] = resp
            done[i].set()
        port.async_infer(InferRequest(model_name="dlrm", inputs=inputs), cb)
    for ev in done:
        assert ev.wait(TIMEOUT)
    for resp, want in zip(results, serial):
        assert resp.error is None, resp.error
        assert np.array_equal(resp.outputs["OUTPUT0"], want)


def test_two_requests_over_max_lookups_together_both_serve(engines):
    port, _ = engines
    rng = np.random.default_rng(9)
    events, results = [threading.Event(), threading.Event()], [None, None]
    for i in range(2):
        counts = np.full(4, 24)  # 96 lookups each: 192 together
        idx = rng.integers(0, 64, size=96).astype(np.int32)
        off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

        def cb(resp, i=i):
            results[i] = resp
            events[i].set()
        port.async_infer(InferRequest(model_name="dlrm", inputs=csr_inputs(
            np.ones((1, 8), np.float32), idx, off)), cb)
    for ev in events:
        assert ev.wait(TIMEOUT)
    assert all(r.error is None and r.outputs["OUTPUT0"].shape == (1, 1)
               for r in results)


def test_config_and_metadata_equal_jax(engines):
    port, ref = engines
    for name in ("dlrm", "dlrm_cached"):
        got, want = port.model_config(name), ref.model_config(name)
        for d in (got, want):
            d.pop("platform"), d.pop("backend")
        assert got == want
        got, want = port.model_metadata(name), ref.model_metadata(name)
        got.pop("platform"), want.pop("platform")
        assert got == want


# -- the wire -----------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    """The port and the JAX package, each serving ``dlrm`` with 4-way
    sharded tables (ring combine) over HTTP and gRPC."""
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    repo = ModelRepository()
    repo.register("dlrm", lambda device: DlrmBackend(
        emb_shards=4, combine="ring", device=device))
    engine = TorchEngine(repo, device="cpu")
    http_srv = HttpInferenceServer(engine, port=0).start()
    grpc_srv = GrpcInferenceServer(engine, port=0).start()
    jax_repo = JaxRepository()
    jax_repo.register_backend(JaxDlrm(emb_shards=4, combine="ring"))
    jax_engine = TpuEngine(jax_repo)
    jax_http = JaxHttp(jax_engine, port=0).start()
    jax_grpc = JaxGrpc(jax_engine, port=0).start()
    yield {"port": (http_srv.url, grpc_srv.url),
           "jax": (jax_http.url, f"127.0.0.1:{jax_grpc.port}")}
    for srv in (jax_grpc, jax_http, grpc_srv, http_srv):
        srv.stop()
    jax_engine.shutdown()
    engine.shutdown()


def _http_infer(url, inputs, binary):
    entries, tail = [], b""
    for name, arr in inputs.items():
        wire = "FP32" if arr.dtype == np.float32 else "INT32"
        e = {"name": name, "datatype": wire, "shape": list(arr.shape)}
        if binary:
            e["parameters"] = {"binary_data_size": arr.nbytes}
            tail += arr.tobytes()
        else:
            e["data"] = arr.ravel().tolist()
        entries.append(e)
    head = json.dumps({"inputs": entries}).encode()
    headers = ({"Inference-Header-Content-Length": str(len(head))}
               if binary else {})
    req = urllib.request.Request(f"http://{url}/v2/models/dlrm/infer",
                                 data=head + tail, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            out = json.loads(resp.read())["outputs"][0]
            return 200, np.array(out["data"], np.float32).reshape(
                out["shape"])
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())["error"]


def _grpc_infer(url, inputs):
    req = pb.ModelInferRequest(model_name="dlrm")
    for name, arr in inputs.items():
        wire = "FP32" if arr.dtype == np.float32 else "INT32"
        req.inputs.add(name=name, datatype=wire, shape=list(arr.shape))
        req.raw_input_contents.append(arr.tobytes())
    with grpc.insecure_channel(url) as ch:
        stub = grpc_stub.GRPCInferenceServiceStub(ch)
        try:
            resp = stub.ModelInfer(req, timeout=TIMEOUT)
        except grpc.RpcError as exc:
            return exc.code(), exc.details()
    out = resp.outputs[0]
    return grpc.StatusCode.OK, np.frombuffer(
        resp.raw_output_contents[0], np.float32).reshape(out.shape)


@pytest.mark.parametrize("how", ["json", "binary", "grpc"])
def test_csr_over_the_wire_equals_jax(servers, how):
    """Ragged CSR over each transport against sharded tables: the port's
    score within the tolerance of the JAX server's, identical across the
    port's transports."""
    rng = np.random.default_rng(11)
    inputs = csr_inputs(*make_csr(rng, 2))
    answers = {}
    for side in ("port", "jax"):
        http_url, grpc_url = servers[side]
        if how == "grpc":
            code, out = _grpc_infer(grpc_url, inputs)
            assert code == grpc.StatusCode.OK, out
        else:
            code, out = _http_infer(http_url, inputs, how == "binary")
            assert code == 200, out
        answers[side] = out
    assert answers["port"].shape == (2, 1)
    np.testing.assert_allclose(answers["port"], answers["jax"], rtol=RTOL,
                               atol=ATOL)
    direct = Model(DlrmBackend(device="cpu"), device="cpu")
    want, _ = direct.execute_timed(dict(inputs), batch_size=int(
        inputs["INDICES"].shape[0]))
    assert np.array_equal(answers["port"], want["OUTPUT0"][:2])


@pytest.mark.parametrize("case", ["offsets_end", "too_many_lookups",
                                  "out_of_range", "rows"])
def test_csr_errors_over_the_wire_equal_jax(servers, case):
    inputs = csr_inputs(*_bad_requests()[case])
    got = {}
    for side in ("port", "jax"):
        http_url, grpc_url = servers[side]
        got[side] = (_http_infer(http_url, inputs, True),
                     _grpc_infer(grpc_url, inputs))
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 400
    assert got["port"][1][0] == grpc.StatusCode.INVALID_ARGUMENT


def test_metadata_marks_ragged_tensors(servers):
    url = servers["port"][0]
    with urllib.request.urlopen(f"http://{url}/v2/models/dlrm",
                                timeout=TIMEOUT) as resp:
        md = json.loads(resp.read())
    shapes = {t["name"]: t["shape"] for t in md["inputs"]}
    assert shapes == {"DENSE": [-1, 8], "INDICES": [-1], "OFFSETS": [-1]}


def test_dlrm_client_over_both_transports(servers):
    """examples/python/dlrm_client.py prints its PASS line against the
    port over HTTP and gRPC, with the same scores on both."""
    scores = {}
    for proto, url in zip(("http", "grpc"), servers["port"]):
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", "python",
                                          "dlrm_client.py"),
             "-u", url, "-i", proto], capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, f"{proto}: {proc.stdout}{proc.stderr}"
        assert f"PASS: dlrm ({proto})" in proc.stdout, proc.stdout
        scores[proto] = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith("scores[")]
    assert scores["http"] and scores["http"] == scores["grpc"]
