"""The port's engine and HTTP frontend, on the CPU.

A ``TorchEngine(device="cpu")`` serves a small BERT behind the port's HTTP
server on port 0; requests are hand-built v2 bodies over ``http.client``.
Served outputs are compared with a direct call of the same module: the
same arithmetic on the same rows, so to 1e-5.
"""

import concurrent.futures
import http.client
import json

import numpy as np
import pytest
import torch

from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.model import Model
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.protocol import codec, rest
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype, wire_to_np_dtype
from client_tpu_torch.server import HttpInferenceServer
from client_tpu_torch.server.__main__ import main as server_main

SEQ = 64
SMALL = dict(seq_len=SEQ, hidden=64, n_layers=2, n_heads=4, ffn=128,
             vocab=512, max_batch_size=4)


def _small(name, attention_impl="einsum", delay_us=None):
    def build(device):
        backend = BertBackend(name=name, attention_impl=attention_impl,
                              device=device, **SMALL)
        if delay_us is not None:
            # A wide gather window so concurrent requests surely batch.
            backend.config.dynamic_batching.max_queue_delay_microseconds = \
                delay_us
            backend.config.instance_count = 1
        return backend
    return build


@pytest.fixture(scope="module")
def served():
    repo = ModelRepository()
    repo.register("bert_small", _small("bert_small"))
    repo.register("bert_small_flash", _small("bert_small_flash", "flash"))
    repo.register("bert_batch", _small("bert_batch", delay_us=300_000))
    engine = TorchEngine(repo, device="cpu")
    server = HttpInferenceServer(engine, port=0).start()
    yield engine, server
    server.stop()
    engine.shutdown()


def _request(served, method, path, body=None, headers=None):
    _, server = served
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    try:
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL["vocab"], (n, SEQ)).astype(np.int32)
    mask = np.ones((n, SEQ), np.int32)
    mask[:, SEQ - 5 * (seed % 4):] = 0
    return ids, mask


def _json_body(ids, mask, ids_dtype="INT32"):
    return json.dumps({"inputs": [
        {"name": "input_ids", "datatype": ids_dtype, "shape": list(ids.shape),
         "data": ids.ravel().tolist()},
        {"name": "attention_mask", "datatype": "INT32",
         "shape": list(mask.shape), "data": mask.ravel().tolist()},
    ]})


def _outputs(headers, data):
    jlen = headers.get("Inference-Header-Content-Length")
    head, tail = rest.split_body(data, int(jlen) if jlen else None)
    return {t.name: t.to_numpy()
            for t in rest.parse_tensors(head["outputs"], tail)}


def _direct(engine, model, ids, mask):
    backend = engine.repository.get(model).backend
    with torch.inference_mode():
        out = backend({"input_ids": torch.from_numpy(ids),
                       "attention_mask": torch.from_numpy(mask)})
    return {k: v.numpy() for k, v in out.items()}


def _infer(served, model, ids, mask):
    status, headers, data = _request(served, "POST",
                                     f"/v2/models/{model}/infer",
                                     _json_body(ids, mask))
    assert status == 200, data
    return _outputs(headers, data)


@pytest.mark.parametrize("path", ["/v2/health/live", "/v2/health/ready",
                                  "/v2/models/bert_small/ready",
                                  "/v2/models/bert_small/versions/1/ready"])
def test_health_and_ready(served, path):
    assert _request(served, "GET", path)[0] == 200


def test_server_and_model_metadata(served):
    status, _, data = _request(served, "GET", "/v2")
    assert status == 200 and json.loads(data)["name"] == "client_tpu_torch"
    status, _, data = _request(served, "GET", "/v2/models/bert_small")
    md = json.loads(data)
    assert status == 200 and md["versions"] == ["1"]
    assert md["inputs"] == [
        {"name": "input_ids", "datatype": "INT32", "shape": [-1, SEQ]},
        {"name": "attention_mask", "datatype": "INT32", "shape": [-1, SEQ]}]
    assert [o["name"] for o in md["outputs"]] == ["pooled_output", "logits"]


def test_model_config(served):
    status, _, data = _request(served, "GET", "/v2/models/bert_small/config")
    cfg = json.loads(data)
    assert status == 200
    assert cfg["max_batch_size"] == 4
    assert cfg["dynamic_batching"] == {"preferred_batch_size": [2, 4],
                                       "max_queue_delay_microseconds": 500}
    assert cfg["instance_group"] == [{"count": 2}]


@pytest.mark.parametrize("model", ["bert_small", "bert_small_flash"])
def test_json_infer_equals_direct_call(served, model):
    engine, _ = served
    ids, mask = _rows(2, seed=1)
    got = _infer(served, model, ids, mask)
    want = _direct(engine, model, ids, mask)
    for name in ("logits", "pooled_output"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0)


def test_binary_infer_equals_direct_call(served):
    engine, _ = served
    ids, mask = _rows(3, seed=2)
    inputs = [rest.build_tensor_json(n, a, "INT32", a.shape, binary=True)
              for n, a in (("input_ids", ids), ("attention_mask", mask))]
    head = json.dumps({"inputs": [e for e, _ in inputs],
                       "outputs": [{"name": "logits",
                                    "parameters": {"binary_data": True}}]})
    body = head.encode() + b"".join(raw for _, raw in inputs)
    status, headers, data = _request(
        served, "POST", "/v2/models/bert_small/versions/1/infer", body,
        {"Inference-Header-Content-Length": str(len(head))})
    assert status == 200, data
    assert headers["Content-Type"] == "application/octet-stream"
    got = _outputs(headers, data)
    assert list(got) == ["logits"]  # only what was asked for
    np.testing.assert_allclose(got["logits"],
                               _direct(engine, "bert_small", ids, mask)
                               ["logits"], atol=1e-5, rtol=0)


def test_concurrent_requests_batch_and_equal_solo_answers(served):
    engine, _ = served
    rows = [_rows(1, seed=10 + i) for i in range(8)]
    before = engine.model_statistics("bert_batch")["model_stats"][0]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        results = list(pool.map(
            lambda r: _infer(served, "bert_batch", *r), rows))
    after = engine.model_statistics("bert_batch")["model_stats"][0]
    executions = after["execution_count"] - before["execution_count"]
    assert after["inference_count"] - before["inference_count"] == 8
    assert executions < 8  # dynamic batching put requests together
    assert max(b["batch_size"] for b in after["batch_stats"]) > 1
    for (ids, mask), got in zip(rows, results):
        solo = _direct(engine, "bert_batch", ids, mask)
        for name in ("logits", "pooled_output"):
            np.testing.assert_allclose(got[name], solo[name], atol=1e-5,
                                       rtol=0)


def test_stats_endpoint(served):
    _infer(served, "bert_small", *_rows(1, seed=3))
    status, _, data = _request(served, "GET", "/v2/models/bert_small/stats")
    (st,) = json.loads(data)["model_stats"]
    assert status == 200 and st["name"] == "bert_small"
    assert st["inference_count"] >= 1 and st["execution_count"] >= 1
    assert st["inference_stats"]["compute_infer"]["count"] >= 1
    status, _, data = _request(served, "GET", "/v2/models/stats")
    assert status == 200
    assert {s["name"] for s in json.loads(data)["model_stats"]} >= {
        "bert_small", "bert_batch"}


@pytest.mark.parametrize("case", ["dtype", "shape", "rank", "batch",
                                  "missing_input"])
def test_bad_input_is_400(served, case):
    ids, mask = _rows(1, seed=4)
    if case == "dtype":
        body = _json_body(ids.astype(np.float32), mask, ids_dtype="FP32")
    elif case == "shape":
        body = _json_body(ids[:, :32], mask[:, :32])
    elif case == "rank":
        body = _json_body(ids[0], mask[0])
    elif case == "batch":
        ids, mask = _rows(5, seed=4)  # over max_batch_size 4
        body = _json_body(ids, mask)
    else:
        body = json.dumps({"inputs": [json.loads(_json_body(ids, mask))
                                      ["inputs"][0]]})
    status, _, data = _request(served, "POST",
                               "/v2/models/bert_small/infer", body)
    assert status == 400, data
    assert "error" in json.loads(data)


@pytest.mark.parametrize("case", ["truncated_json", "not_an_object",
                                  "binary_overrun", "header_past_body",
                                  "data_size_mismatch"])
def test_malformed_body_is_400(served, case):
    headers = {}
    if case == "truncated_json":
        body = b'{"inputs": [{"name": "input_ids"'
    elif case == "not_an_object":
        body = b"[1, 2, 3]"
    elif case == "binary_overrun":
        head = json.dumps({"inputs": [{
            "name": "input_ids", "datatype": "INT32", "shape": [1, SEQ],
            "parameters": {"binary_data_size": 4 * SEQ}}]}).encode()
        body = head + b"\0" * 8
        headers = {"Inference-Header-Content-Length": str(len(head))}
    elif case == "header_past_body":
        body = b"{}"
        headers = {"Inference-Header-Content-Length": "100"}
    else:
        body = json.dumps({"inputs": [{
            "name": "input_ids", "datatype": "INT32", "shape": [1, SEQ],
            "data": [1, 2, 3]}]})
    status, _, data = _request(served, "POST",
                               "/v2/models/bert_small/infer", body, headers)
    assert status == 400, data


@pytest.mark.parametrize("path", ["/v2/models/no_such_model/infer",
                                  "/v2/models/bert_small/versions/2/infer"])
def test_unknown_model_or_version_is_404(served, path):
    ids, mask = _rows(1, seed=5)
    status, _, data = _request(served, "POST", path, _json_body(ids, mask))
    assert status == 404, data


def test_unknown_model_metadata_is_404(served):
    assert _request(served, "GET", "/v2/models/no_such_model")[0] == 404


def test_engine_infer_in_process(served):
    engine, _ = served
    ids, mask = _rows(2, seed=6)
    resp = engine.infer(InferRequest(
        model_name="bert_small",
        inputs={"input_ids": ids, "attention_mask": mask}))
    assert resp.outputs["logits"].shape == (2, 2)
    assert resp.times.compute_infer_end >= resp.times.compute_input_end > 0


@pytest.mark.parametrize("entry", ["engine", "model", "backend", "server"])
def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "engine":
            TorchEngine()
        elif entry == "model":
            Model(BertBackend(device="cpu", **SMALL))
        elif entry == "backend":
            BertBackend(**SMALL)
        else:
            server_main(["--zoo", "bert_base", "--http-port", "0"])


def test_server_main_rejects_unknown_zoo_model():
    with pytest.raises(SystemExit) as exc:
        server_main(["--zoo", "no_such_model", "--device", "cpu"])
    assert exc.value.code == 2


@pytest.mark.parametrize("wire", ["INT32", "FP32", "BYTES"])
def test_codec_round_trip(wire):
    if wire == "BYTES":
        arr = np.array([[b"a", b""], [b"xyz", "é".encode()]],
                       dtype=np.object_)
    else:
        arr = np.arange(6, dtype=wire_to_np_dtype(wire)).reshape(2, 3)
    assert np_to_wire_dtype(arr.dtype) == wire
    raw = codec.serialize_tensor(arr)
    back = codec.deserialize_tensor(raw, wire, arr.shape)
    assert back.shape == arr.shape and (back == arr).all()
    entry, _ = rest.build_tensor_json("t", arr, wire, arr.shape, binary=False)
    assert (rest.parse_tensors([entry], b"")[0].to_numpy() == arr).all()
