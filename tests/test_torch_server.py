"""The port's engine and HTTP frontend, on the CPU.

A ``TorchEngine(device="cpu")`` serves a small BERT behind the port's HTTP
server on port 0; requests are hand-built v2 bodies over ``http.client``.
Served outputs are compared with a direct call of the same module: the
same arithmetic on the same rows, so to 1e-5. The generate extension and
the image path (classification, shared-memory refusals, the example
clients) are also held against a live JAX server.
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
from client_tpu_torch.server.classification import classify_output

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


# -- the generate extension ---------------------------------------------------

GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=32, max_streams=4)


@pytest.fixture(scope="module")
def gen_served():
    """The port and the JAX package each serving the same small tiny_gpt
    as "tg" (plus, on the port, a BERT for the single-response case)."""
    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepository
    from client_tpu.models.generate import TinyGptBackend as JaxGpt
    from client_tpu.server import HttpInferenceServer as JaxServer
    from client_tpu_torch.models.generate import TinyGptBackend

    repo = ModelRepository()
    repo.register("tg", lambda device: TinyGptBackend(
        name="tg", device=device, **GPT))
    repo.register("tg_long", lambda device: TinyGptBackend(
        name="tg_long", device=device, **{**GPT, "max_seq_len": 1024}))
    repo.register("bert_small", _small("bert_small"))
    engine = TorchEngine(repo, device="cpu")
    server = HttpInferenceServer(engine, port=0).start()
    jax_repo = JaxRepository()
    jax_repo.register_backend(JaxGpt(name="tg", attn_impl="reference", **GPT))
    jax_engine = TpuEngine(jax_repo)
    jax_server = JaxServer(jax_engine, port=0).start()
    yield engine, server, int(jax_server.url.split(":")[1])
    jax_server.stop()
    jax_engine.shutdown()
    server.stop()
    engine.shutdown()


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _gen_body(prompt, n, **params):
    return json.dumps({
        "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                    "shape": [len(prompt)], "data": prompt}],
        "parameters": {"max_tokens": n, **params}})


def _events(raw: bytes) -> list[dict]:
    text = raw.decode()
    assert text.endswith("\n\n")
    blocks = text.split("\n\n")[:-1]
    assert all(b.startswith("data: ") for b in blocks), text
    return [json.loads(b[len("data: "):]) for b in blocks]


def _tokens(events):
    return [{o["name"]: o["data"] for o in e["outputs"]}["TOKEN"][0]
            for e in events]


@pytest.mark.parametrize("params", [{}, {"temperature": 0.8, "seed": 7,
                                         "top_k": 24, "top_p": 0.9}])
def test_generate_stream_events_equal_the_jax_servers(gen_served, params):
    _, server, jax_port = gen_served
    body = _gen_body([1, 2, 3], 6, **params)
    status, headers, raw = _post(server.port,
                                 "/v2/models/tg/generate_stream", body)
    assert status == 200
    assert headers["Content-Type"] == "text/event-stream"
    assert headers["Transfer-Encoding"] == "chunked"
    events = _events(raw)  # http.client has taken the chunks apart
    assert len(events) == 6  # no event for the final flag: the stream ends
    assert [e["outputs"][1]["data"] for e in events] == [[i] for i in range(6)]
    assert all(e["parameters"] == {"triton_final_response": False}
               for e in events)
    jax_status, _, jax_raw = _post(jax_port, "/v2/models/tg/generate_stream",
                                   body)
    assert jax_status == 200
    assert events == _events(jax_raw)
    assert raw == jax_raw  # the same bytes, framing included


def test_generate_collects_the_streamed_tokens(gen_served):
    _, server, jax_port = gen_served
    body = _gen_body([9, 9, 4], 5)
    status, _, raw = _post(server.port, "/v2/models/tg/generate", body)
    assert status == 200
    data = json.loads(raw)
    assert data["model_name"] == "tg" and len(data["responses"]) == 5
    _, _, stream_raw = _post(server.port, "/v2/models/tg/generate_stream",
                             body)
    assert data["responses"] == _events(stream_raw)
    assert data == json.loads(_post(jax_port, "/v2/models/tg/generate",
                                    body)[2])


def test_generate_for_a_single_response_model(gen_served):
    engine, server, _ = gen_served
    ids, mask = _rows(1, seed=8)
    status, _, raw = _post(server.port, "/v2/models/bert_small/generate",
                           _json_body(ids, mask))
    assert status == 200
    (resp,) = json.loads(raw)["responses"]
    got = {o["name"]: np.array(o["data"], np.float32) for o in resp["outputs"]}
    want = _direct(engine, "bert_small", ids, mask)
    np.testing.assert_allclose(got["logits"], want["logits"].ravel(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["too_long", "binary_output",
                                  "bad_temperature"])
def test_generate_errors_are_400(gen_served, case):
    _, server, _ = gen_served
    if case == "too_long":
        body = _gen_body([1] * 30, 5)
    elif case == "bad_temperature":
        body = _gen_body([1], 2, temperature=-1)
    else:
        body = json.dumps({**json.loads(_gen_body([1], 2)), "outputs": [
            {"name": "TOKEN", "parameters": {"binary_data": True}}]})
    status, _, raw = _post(server.port, "/v2/models/tg/generate", body)
    assert status == 400, raw
    status, _, raw = _post(server.port, "/v2/models/tg/infer",
                           _gen_body([1], 2))
    assert status == 400 and b"decoupled" in raw


def test_generate_stream_error_is_an_event(gen_served):
    _, server, _ = gen_served
    status, _, raw = _post(server.port, "/v2/models/tg/generate_stream",
                           _gen_body([1] * 30, 5))
    assert status == 200  # the headers leave before the scheduler answers
    (event,) = _events(raw)
    assert "max_seq_len" in event["error"]


def test_dead_client_cancels_the_stream(gen_served):
    import socket
    import struct
    import time

    engine, server, _ = gen_served
    sched = engine._schedulers["tg_long"]
    before = engine.model_statistics("tg_long")["model_stats"][0]
    body = _gen_body([1, 2], 1000).encode()
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=60)
    sock.sendall(b"POST /v2/models/tg_long/generate_stream HTTP/1.1\r\n"
                 b"Host: x\r\nContent-Length: " + str(len(body)).encode()
                 + b"\r\n\r\n" + body)
    assert sock.recv(64).startswith(b"HTTP/1.1 200")
    # Close with a reset: the server's next write fails at once.
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
    sock.close()
    deadline = time.monotonic() + 60
    stats = before
    while time.monotonic() < deadline:
        stats = engine.model_statistics("tg_long")["model_stats"][0]
        if stats["inference_stats"]["fail"]["count"] > \
                before["inference_stats"]["fail"]["count"]:
            break
        time.sleep(0.02)
    assert stats["inference_stats"]["fail"]["count"] == \
        before["inference_stats"]["fail"]["count"] + 1
    assert stats["inference_count"] == before["inference_count"]
    while sched._streams and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(sched._free) == GPT["max_streams"]


# -- image models: classification and shared memory ---------------------------

RESNET = dict(stages=((1, 8), (1, 16)))


@pytest.fixture(scope="module")
def image_served():
    """The port and the JAX package each serving ``image_preprocess``,
    ``ensemble_image`` and a small ``resnet50`` (224x224 in, 1000 classes)
    with the same weights."""
    import jax

    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepository
    from client_tpu.models import ensembles as jax_ens
    from client_tpu.models import vision as jax_vision
    from client_tpu.server import HttpInferenceServer as JaxServer
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.vision import ResNet50Backend

    jax_resnet = jax_vision.ResNet50Backend(**RESNET)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_resnet.make_apply_params()[1])

    def resnet(device):
        backend = ResNet50Backend(device=device, **RESNET)
        backend.load_jax_params(params)
        return backend

    repo = build_repository(["image_preprocess", "ensemble_image"])
    repo.register("resnet50", resnet)
    engine = TorchEngine(repo, device="cpu")
    server = HttpInferenceServer(engine, port=0).start()
    jax_repo = JaxRepository()
    for backend in (jax_vision.ResNet50Backend(**RESNET),
                    jax_ens.ImagePreprocessBackend(),
                    jax_ens.EnsembleImageBackend()):
        jax_repo.register_backend(backend)
    jax_engine = TpuEngine(jax_repo)
    jax_server = JaxServer(jax_engine, port=0).start()
    yield engine, server, int(jax_server.url.split(":")[1])
    jax_server.stop()
    jax_engine.shutdown()
    server.stop()
    engine.shutdown()


def _tensor_body(name, arr, outputs, binary=False):
    wire = np_to_wire_dtype(arr.dtype)
    if not binary:
        return json.dumps({"inputs": [{
            "name": name, "datatype": wire, "shape": list(arr.shape),
            "data": arr.ravel().tolist()}], "outputs": outputs}), {}
    head = json.dumps({"inputs": [{
        "name": name, "datatype": wire, "shape": list(arr.shape),
        "parameters": {"binary_data_size": arr.nbytes}}],
        "outputs": outputs}).encode()
    return head + arr.tobytes(), {
        "Inference-Header-Content-Length": str(len(head))}


def _post_both(image_served, model, body, headers):
    _, server, jax_port = image_served
    path = f"/v2/models/{model}/infer"
    return (_post(server.port, path, body, headers),
            _post(jax_port, path, body, headers))


@pytest.mark.parametrize("binary", [False, True])
def test_classification_bytes_equal_the_jax_servers(image_served, binary):
    """Top-3 of a host-side model's FP32 output, identical on both sides
    by construction, so the BYTES strings must be equal."""
    raw = np.random.default_rng(3).integers(0, 256, (2, 40, 50, 3)).astype(
        np.uint8)
    body, headers = _tensor_body(
        "RAW_IMAGE", raw,
        [{"name": "IMAGE", "parameters": {"classification": 3,
                                          "binary_data": binary}}], binary)
    (status, rh, data), (jstatus, jrh, jdata) = _post_both(
        image_served, "image_preprocess", body, headers)
    assert status == jstatus == 200, (data, jdata)
    got, want = _outputs(rh, data)["IMAGE"], _outputs(jrh, jdata)["IMAGE"]
    assert got.shape == want.shape == (2, 3)
    assert got.tolist() == want.tolist()
    assert got[0, 0].decode().split(":")[1].isdigit()


def test_classification_of_resnet50_logits(image_served):
    """Each ``score:idx`` string is the port's own logits formatted by
    ``classify_output``; the indices equal the JAX server's top 3."""
    engine, _, _ = image_served
    x = np.random.default_rng(4).standard_normal((2, 224, 224, 3)).astype(
        np.float32)
    body, headers = _tensor_body(
        "INPUT", x, [{"name": "OUTPUT", "parameters": {"classification": 3}}],
        binary=True)
    (status, rh, data), (jstatus, jrh, jdata) = _post_both(
        image_served, "resnet50", body, headers)
    assert status == jstatus == 200
    got, want = _outputs(rh, data)["OUTPUT"], _outputs(jrh, jdata)["OUTPUT"]
    logits, _ = engine.repository.get("resnet50").execute_timed(
        {"INPUT": x}, batch_size=2)
    assert got.tolist() == classify_output(logits["OUTPUT"], 3, None).tolist()
    top3 = np.argsort(-logits["OUTPUT"], axis=1)[:, :3]
    idx = [[int(e.decode().split(":")[1]) for e in row] for row in got]
    assert idx == top3.tolist()
    assert idx == [[int(e.decode().split(":")[1]) for e in row]
                   for row in want]


@pytest.mark.parametrize("where", ["output", "input"])
def test_shared_memory_region_is_400_on_both(image_served, where):
    x = np.zeros((1, 224, 224, 3), np.float32)
    shm = {"shared_memory_region": "no_such_region",
           "shared_memory_byte_size": 4000}
    if where == "output":
        body = json.dumps({
            "inputs": [{"name": "INPUT", "datatype": "FP32",
                        "shape": list(x.shape), "data": x.ravel().tolist()}],
            "outputs": [{"name": "OUTPUT", "parameters": shm}]})
    else:
        body = json.dumps({"inputs": [{
            "name": "INPUT", "datatype": "FP32", "shape": list(x.shape),
            "parameters": {**shm, "shared_memory_byte_size": x.nbytes}}]})
    (status, _, data), (jstatus, _, jdata) = _post_both(
        image_served, "resnet50", body, {})
    assert status == jstatus == 400
    assert json.loads(data)["error"] == json.loads(jdata)["error"] \
        == "shared memory region 'no_such_region' not registered"


@pytest.mark.parametrize("size", [4 * 224 * 224 * 3 - 4,
                                  4 * 224 * 224 * 3 - 2],
                         ids=["short", "ragged"])
def test_binary_bytes_that_miss_the_shape_are_400_on_both(image_served,
                                                          size):
    """Raw bytes that do not fill the declared shape: both servers answer
    400 with numpy's own error (reshape, or frombuffer for a partial
    element), word for word."""
    head = json.dumps({"inputs": [{
        "name": "INPUT", "datatype": "FP32", "shape": [1, 224, 224, 3],
        "parameters": {"binary_data_size": size}}]}).encode()
    (status, _, data), (jstatus, _, jdata) = _post_both(
        image_served, "resnet50", head + b"\0" * size,
        {"Inference-Header-Content-Length": str(len(head))})
    assert status == jstatus == 400
    assert json.loads(data)["error"] == json.loads(jdata)["error"]
    assert "ValueError" in json.loads(data)["error"]


@pytest.mark.parametrize("script,extra", [
    ("image_client.py", ["--synthetic", "-c", "3"]),
    ("ensemble_image_client.py", [])])
def test_example_clients_pass_against_the_port(image_served, script, extra):
    import os
    import subprocess
    import sys

    _, server, _ = image_served
    repo_root = os.path.join(os.path.dirname(__file__), "..")
    cmd = [sys.executable, os.path.join(repo_root, "examples", "python",
                                        script), "-u", server.url, *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=repo_root))
    assert proc.returncode == 0, f"{proc.stdout}{proc.stderr}"
    assert "PASS" in proc.stdout, proc.stdout
    if script == "image_client.py":
        lines = [ln.strip() for ln in proc.stdout.splitlines()
                 if ln.startswith("    ")]
        assert len(lines) == 3 and all(":" in ln for ln in lines)
