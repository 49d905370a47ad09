"""The port's ``ModelStreamInfer`` bidi stream on the CPU, against a live
JAX ``GrpcInferenceServer``, and the stream writers' flow control and
response coalescing on gRPC and on SSE.

The port and the JAX package serve the same small ``tiny_gpt`` as "tg"
with the same weights. Greedy and seeded sampled streams must equal the
JAX server's message for message (parsed messages serialized
deterministically, per request id: requests multiplexed on one RPC
interleave in no fixed order). Coalesced messages are held by their
concatenated tokens against the uncoalesced stream, never by where they
split. Waits are bounded waits for a condition; every RPC has a timeout.
"""

import http.client
import json
import os
import queue
import subprocess
import sys
import threading
import time

import grpc
import numpy as np
import pytest

from client_tpu_torch.engine import TorchEngine
from client_tpu_torch.models.generate import TinyGptBackend
from client_tpu_torch.models.simple import AddSubBackend
from client_tpu_torch.protocol import grpc_codec, grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer
from client_tpu_torch.server.grpc_server import _Servicer

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TIMEOUT = 120  # seconds, every RPC
GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=32, max_streams=4)
SAMPLED = {"temperature": 0.8, "top_k": 24, "top_p": 0.9}


@pytest.fixture(scope="module")
def served():
    """The port serving "tg", "tg_long" (max_seq 1024), the registered
    ``tiny_gpt`` and ``simple`` over gRPC and HTTP from one engine; the
    JAX package serving the same "tg" over gRPC."""
    from client_tpu.engine import TpuEngine
    from client_tpu.engine.repository import ModelRepository as JaxRepository
    from client_tpu.models.generate import TinyGptBackend as JaxGpt
    from client_tpu.server import GrpcInferenceServer as JaxServer
    from client_tpu_torch.models import build_repository

    repo = build_repository(["tiny_gpt"])
    repo.register("tg", lambda device: TinyGptBackend(
        name="tg", device=device, **GPT))
    repo.register("tg_long", lambda device: TinyGptBackend(
        name="tg_long", device=device, **{**GPT, "max_seq_len": 1024}))
    repo.register("simple", lambda device: AddSubBackend())
    engine = TorchEngine(repo, device="cpu")
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    http_server = HttpInferenceServer(engine, port=0).start()
    jax_repo = JaxRepository()
    jax_repo.register_backend(JaxGpt(name="tg", attn_impl="reference", **GPT))
    jax_engine = TpuEngine(jax_repo)
    jax_server = JaxServer(jax_engine, port=0).start()
    channels = [grpc.insecure_channel(s.url)
                for s in (grpc_server, jax_server)]
    yield (engine, grpc_server, http_server,
           grpc_stub.GRPCInferenceServiceStub(channels[0]),
           grpc_stub.GRPCInferenceServiceStub(channels[1]))
    for ch in channels:
        ch.close()
    jax_server.stop()
    jax_engine.shutdown()
    http_server.stop()
    grpc_server.stop()
    engine.shutdown()


def _gen_request(prompt, n, request_id, model="tg", **params):
    req = pb.ModelInferRequest(model_name=model, id=request_id)
    req.inputs.add(name="INPUT_IDS", datatype="INT32", shape=[len(prompt)])
    req.raw_input_contents.append(np.asarray(prompt, np.int32).tobytes())
    grpc_codec.set_param(req.parameters, "max_tokens", n)
    for k, v in params.items():
        grpc_codec.set_param(req.parameters, k, v)
    return req


def _by_id(messages) -> dict[str, list]:
    out: dict[str, list] = {}
    for m in messages:
        out.setdefault(m.infer_response.id, []).append(m)
    return out


def _wire(msgs) -> list[bytes]:
    return [m.SerializeToString(deterministic=True) for m in msgs]


def _tokens(msgs) -> tuple[list[int], list[int], list[int]]:
    """(tokens, indices, rows per message) of one request's messages."""
    tokens, indices, rows = [], [], []
    for m in msgs:
        r = m.infer_response
        if not r.outputs:
            continue
        outs = {t.name: grpc_codec.tensor_to_ndarray(t, raw)
                for t, raw in zip(r.outputs, r.raw_output_contents)}
        assert len(outs["TOKEN"]) == len(outs["INDEX"])
        tokens += outs["TOKEN"].tolist()
        indices += outs["INDEX"].tolist()
        rows.append(len(outs["TOKEN"]))
    return tokens, indices, rows


def _is_final(m) -> bool:
    p = m.infer_response.parameters
    return "triton_final_response" in p and p[
        "triton_final_response"].bool_param


STREAMS = [([1, 2, 3], 6), ([5], 9), ([7, 8, 9, 10, 11], 4)]


@pytest.mark.parametrize("params", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_multiplexed_streams_equal_the_jax_servers(served, params):
    """Three requests on one RPC: every message of each equals the JAX
    server's, final included."""
    *_, port, jax = served
    requests = [_gen_request(p, n, f"r{i}", **params,
                             **({"seed": 7 + i} if params else {}))
                for i, (p, n) in enumerate(STREAMS)]
    got = _by_id(port.ModelStreamInfer(iter(requests), timeout=TIMEOUT))
    want = _by_id(jax.ModelStreamInfer(iter(requests), timeout=TIMEOUT))
    assert sorted(got) == sorted(want) == ["r0", "r1", "r2"]
    for i, (_, n) in enumerate(STREAMS):
        msgs = got[f"r{i}"]
        assert _wire(msgs) == _wire(want[f"r{i}"])
        assert len(msgs) == n + 1 and _is_final(msgs[-1])
        assert not msgs[-1].infer_response.outputs
        assert _tokens(msgs)[1] == list(range(n))


def test_rpcs_side_by_side_equal_each_alone(served):
    """Four RPCs at once, two requests each, on the port: each request's
    messages equal the same request streamed alone on the JAX server."""
    *_, port, jax = served
    rpcs = [[_gen_request([3 + k, 4, 5][:1 + k % 3], 5 + k, f"p{k}a"),
             _gen_request([9, k], 4, f"p{k}b", **SAMPLED, seed=k)]
            for k in range(4)]
    results: list = [None] * 4

    def run(k):
        results[k] = _by_id(port.ModelStreamInfer(iter(rpcs[k]),
                                                  timeout=TIMEOUT))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    for k in range(4):
        for req in rpcs[k]:
            want = list(jax.ModelStreamInfer(iter([req]), timeout=TIMEOUT))
            assert _wire(results[k][req.id]) == _wire(want)


def test_stream_errors_equal_the_jax_servers(served):
    """An unknown model, a prompt past max_seq and an undecodable tensor
    answer in-band (error_message, the request id where it is known) and
    the RPC goes on serving its other requests."""
    *_, port, jax = served
    bad_tensor = _gen_request([1, 2], 3, "bad")
    bad_tensor.raw_input_contents[0] = b"\x00" * 5
    requests = [pb.ModelInferRequest(model_name="nope", id="u"),
                _gen_request([1] * 30, 5, "long"),
                bad_tensor,
                _gen_request([4, 5], 3, "ok")]
    got = _by_id(port.ModelStreamInfer(iter(requests), timeout=TIMEOUT))
    want = _by_id(jax.ModelStreamInfer(iter(requests), timeout=TIMEOUT))
    assert _wire(got["ok"]) == _wire(want["ok"])
    for rid in ("u", "long"):
        (g,), (w,) = got[rid], want[rid]
        assert g.error_message == w.error_message
        assert g.infer_response.id == w.infer_response.id == rid
    # The undecodable tensor: id unknown, answered with an empty id on
    # both (the codec's words for the size differ, see test_torch_grpc).
    assert [m.error_message != "" for m in got[""]] == [True]
    assert [m.error_message != "" for m in want[""]] == [True]
    assert "max_seq_len" in got["long"][0].error_message


def test_a_cancelled_rpc_cancels_its_streams(served):
    """The client cancels the RPC mid-stream: the scheduler fails the
    request (499) and frees its arena row."""
    engine, *_, port, _ = served
    sched = engine._schedulers["tg_long"]
    before = engine.model_statistics("tg_long")["model_stats"][0][
        "inference_stats"]["fail"]["count"]
    keep_open = threading.Event()

    def requests():
        yield _gen_request([1, 2], 1000, "c", model="tg_long")
        keep_open.wait(TIMEOUT)

    call = port.ModelStreamInfer(requests(), timeout=TIMEOUT)
    first = next(call)
    assert first.infer_response.id == "c" and not first.error_message
    call.cancel()
    keep_open.set()
    deadline = time.monotonic() + TIMEOUT
    fails = before
    while time.monotonic() < deadline:
        fails = engine.model_statistics("tg_long")["model_stats"][0][
            "inference_stats"]["fail"]["count"]
        if fails > before and not sched._streams:
            break
        time.sleep(0.02)
    assert fails == before + 1
    assert not sched._streams and len(sched._free) == GPT["max_streams"]


def test_a_stalled_reader_sheds_the_heaviest_request(served, monkeypatch):
    """With a pending limit of 4 and a reader that stops reading, the
    decode waves pause (the per-RPC probe), the writer makes no progress,
    and the next response on the RPC sheds the request with the most
    pending responses; its siblings on the same RPC finish in full once
    reading resumes, the light stream token for token as when streamed
    alone."""
    engine, *_, port, _ = served
    sched = engine._schedulers["tg_long"]

    class Context:  # the servicer's view of a live RPC
        def add_callback(self, cb):
            return True

        def is_active(self):
            return True

    monkeypatch.setenv("CLIENT_TPU_STREAM_PENDING_LIMIT", "4")
    servicer = _Servicer(engine)
    assert servicer.STREAM_PENDING_LIMIT == 4
    inbox: queue.Queue = queue.Queue()

    def requests():
        while (item := inbox.get(timeout=TIMEOUT)) is not None:
            yield item

    heavy = _gen_request([1, 2], 500, "heavy", model="tg_long")
    light = _gen_request([3, 4, 5], 12, "light", model="tg_long")
    inbox.put(heavy)
    stream = servicer.ModelStreamInfer(requests(), Context())
    messages = [next(stream)]  # starts the reader; then stop reading

    def wait_for(cond, what):
        deadline = time.monotonic() + TIMEOUT
        while not cond():
            assert time.monotonic() < deadline, what
            time.sleep(0.01)

    def stalled_past_grace():
        return len(sched._streams) == 1 and all(
            s.throttled_since is not None
            and time.monotonic() - s.throttled_since
            > servicer.STREAM_STALL_GRACE_S + 0.05 for s in sched._streams)

    # The heavy stream fills the backlog and its waves pause; the writer
    # then makes no progress past the grace. The light request's first
    # token is the next response on the RPC: it sheds the heaviest.
    wait_for(stalled_past_grace, "the decode waves did not pause")
    inbox.put(light)
    wait_for(lambda: [s.req.request_id for s in sched._streams] == ["light"],
             "the heavy request was not shed")
    # A non-generative sibling on the same RPC, sent while stalled.
    simple = pb.ModelInferRequest(model_name="simple", id="simple")
    for key in ("INPUT0", "INPUT1"):
        simple.inputs.add(name=key, datatype="INT32", shape=[1, 16])
        simple.raw_input_contents.append(np.ones((1, 16), np.int32).tobytes())
    inbox.put(simple)
    inbox.put(None)  # the request side ends; read on
    messages += list(stream)
    got = _by_id(messages)
    assert got["heavy"][-1].error_message == "request cancelled"
    assert len(got["heavy"]) < 100
    assert len(got["simple"]) == 1 and _is_final(got["simple"][0])
    alone = _by_id(port.ModelStreamInfer(iter([light]), timeout=TIMEOUT))
    assert _wire(got["light"]) == _wire(alone["light"])
    assert _is_final(got["light"][-1])


def test_coalesced_grpc_stream_carries_the_same_tokens(served, monkeypatch):
    """With the writer slowed (40 ms a message) a response_coalesce stream
    merges its backlog into [k]-row messages; concatenated, they are the
    uncoalesced stream's tokens and indices, and the final still ends it."""
    *_, port, _ = served
    n = 24
    plain = _by_id(port.ModelStreamInfer(iter([_gen_request([7, 8, 9], n,
                                                            "g")]),
                                         timeout=TIMEOUT))["g"]
    monkeypatch.setenv("CLIENT_TPU_STREAM_WRITER_DELAY_MS", "40")
    merged = _by_id(port.ModelStreamInfer(iter([
        _gen_request([7, 8, 9], n, "g", response_coalesce=True),
        _gen_request([2, 3], 6, "h")]), timeout=TIMEOUT))
    tokens, indices, rows = _tokens(merged["g"])
    assert tokens == _tokens(plain)[0] and indices == list(range(n))
    assert max(rows) > 1 and len(rows) < n
    assert _is_final(merged["g"][-1]) and not _is_final(merged["g"][-2])
    # The sibling did not ask for coalescing: one token a message.
    assert _tokens(merged["h"])[2] == [1] * 6


def _sse(served, body) -> list[dict]:
    http_server = served[2]
    conn = http.client.HTTPConnection("127.0.0.1", http_server.port,
                                      timeout=TIMEOUT)
    try:
        conn.request("POST", "/v2/models/tg/generate_stream",
                     json.dumps(body).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        text = resp.read().decode()
    finally:
        conn.close()
    return [json.loads(b[len("data: "):]) for b in text.split("\n\n")[:-1]]


@pytest.mark.parametrize("coalesce", [False, True], ids=["alone", "coalesced"])
def test_sse_coalescing_carries_the_same_tokens(served, monkeypatch,
                                                coalesce):
    """The same on /generate_stream: with the writer slowed, a
    response_coalesce stream sends fewer events than tokens, one with
    several rows; without the parameter every event holds one token."""
    n = 24

    def body(**params):
        return {"inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [3], "data": [7, 8, 9]}],
                "parameters": {"max_tokens": n, **params}}

    plain = _sse(served, body())
    monkeypatch.setenv("CLIENT_TPU_STREAM_WRITER_DELAY_MS", "40")
    events = _sse(served, body(**({"response_coalesce": True}
                                  if coalesce else {})))
    outs = [{o["name"]: o["data"] for o in e["outputs"]} for e in events]
    tokens = [t for o in outs for t in o["TOKEN"]]
    assert tokens == [o["TOKEN"][0] for o in
                      ({p["name"]: p["data"] for p in e["outputs"]}
                       for e in plain)]
    assert [i for o in outs for i in o["INDEX"]] == list(range(n))
    rows = [len(o["TOKEN"]) for o in outs]
    if coalesce:
        assert max(rows) > 1 and len(rows) < n
    else:
        assert rows == [1] * n


def test_grpc_generate_client_passes_against_the_port(served):
    url = served[1].url
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "python",
                                      "grpc_generate_client.py"),
         "-u", url, "-n", "6"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, f"{proc.stdout}{proc.stderr}"
    assert "PASS: streamed 6 generated tokens" in proc.stdout
