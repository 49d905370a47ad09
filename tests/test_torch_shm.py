"""The port's shared-memory data planes on the CPU, against the JAX
package's.

Live servers of both packages (HTTP and gRPC, each on one engine with
``simple``, ``simple_string`` and a small BERT whose weights go across with
``params_from_jax``) are driven by the JAX package's clients
(``client_tpu.http``, ``client_tpu.grpc``) and shm utilities, the same
sequence against each. Status bodies, codes, error words and region bytes
must be equal, bit for bit. The BERT's region bytes are held against the
same request sent inline, bit for bit, and against the JAX server's at the
BERT tolerance ``BERT_ATOL``. A sequence runs
on the port first and then on the JAX server, each on segments of the
same keys made afresh, so that even the keys in a status body agree; every
segment is unlinked in a ``finally``.

In-process device regions are compared on ``device="cpu"``: the port's
CPU tensors against the JAX package's arrays, batched on the device with
the bucket-repeat concatenation (each scheduler given the same batch).
The port's client
utilities are compared with the JAX package's byte for byte.
"""

import json
import os
import urllib.request
from types import SimpleNamespace

import grpc
import jax
import numpy as np
import pytest
import torch

import client_tpu.grpc as grpcclient
import client_tpu.http as httpclient
import client_tpu.utils as jax_utils
import client_tpu.utils.shared_memory as jax_shm
import client_tpu.utils.tpu_shared_memory as jax_tpushm
from client_tpu.engine.types import InferRequest as JaxRequest
from client_tpu.engine.types import OutputRequest as JaxOutput
from client_tpu.models import bert as jax_bert
from client_tpu.protocol.codec import b64_encode_handle as jax_b64
from client_tpu.utils import InferenceServerException
from client_tpu_torch import utils as port_utils
from client_tpu_torch.engine import InferRequest, OutputRequest, TorchEngine
from client_tpu_torch.models import build_repository
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol import grpc_stub
from client_tpu_torch.protocol.codec import b64_encode_handle
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer
from client_tpu_torch.utils import cuda_shared_memory as port_cudashm
from client_tpu_torch.utils import shared_memory as port_shm

TIMEOUT = 60  # seconds, every wait
SMALL_BERT = dict(seq_len=32, hidden=64, n_layers=2, n_heads=4, ffn=128,
                  vocab=512, max_batch_size=4)
# The port's BERT against the JAX package's, same weights: both round bf16
# weights and activations, at other places (``tests/test_torch_bert.py``
# holds the model at 2e-2 on its inputs; on these, pooled outputs differ
# by up to 2.4e-2).
BERT_ATOL = 5e-2
A = np.arange(16, dtype=np.int32).reshape(1, 16)
B = np.full((1, 16), 3, dtype=np.int32)


@pytest.fixture(scope="module")
def servers():
    """The port and the JAX package, each one engine behind HTTP and
    gRPC on port 0, with the same models and the same BERT weights."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp

    jax_backend = jax_bert.BertBackend(name="bert_small", **SMALL_BERT)
    _, params = jax_backend.make_apply_params()
    tree = jax.tree_util.tree_map(np.asarray, params)

    def port_bert(device):
        backend = BertBackend(name="bert_small", device=device, **SMALL_BERT)
        backend.load_jax_params(tree)
        return backend

    repo = build_repository(["simple", "simple_string"])
    repo.register("bert_small", port_bert)
    jax_repo = jax_build(["simple", "simple_string"])
    jax_repo.register("bert_small", lambda: jax_backend)
    sides = []
    for engine, http_cls, grpc_cls in (
            (TorchEngine(repo, device="cpu"), HttpInferenceServer,
             GrpcInferenceServer),
            (TpuEngine(jax_repo), JaxHttp, JaxGrpc)):
        sides.append(SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_cls(engine, port=0).start()))
    yield SimpleNamespace(port=sides[0], jax=sides[1])
    for side in sides:
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _client(side, wire: str):
    if wire == "http":
        return httpclient.InferenceServerClient(side.http.url)
    return grpcclient.InferenceServerClient(side.grpc.url)


def _mod(wire: str):
    return httpclient if wire == "http" else grpcclient


def _answer(fn):
    """What a client call gives: its value, or the error's status and
    words."""
    try:
        return ("ok", fn())
    except InferenceServerException as exc:
        return ("error", str(exc.status()), exc.message())


def _status(value) -> object:
    """A status answer in comparable form: the JSON body over HTTP, the
    message's bytes over gRPC (map order is not fixed on the wire)."""
    if hasattr(value, "SerializeToString"):
        return value.SerializeToString(deterministic=True)
    return value


def _outputs_of(result) -> object:
    """An infer response's outputs in comparable form (its parameters
    differ: the JAX server adds the trace round trip, not ported yet)."""
    resp = result.get_response()
    if hasattr(resp, "SerializeToString"):
        return ([o.SerializeToString(deterministic=True)
                 for o in resp.outputs], list(resp.raw_output_contents))
    return resp["outputs"]


def _key(tag: str) -> str:
    return f"/torch_shm_{tag}_{os.getpid()}"


def _on_both(servers, run):
    """``run(side)`` on the port, then on the JAX server; returns both
    transcripts."""
    return run(servers.port), run(servers.jax)


def _outputs(wire, name, region, size, offset=0):
    out = _mod(wire).InferRequestedOutput(name)
    if region is not None:
        out.set_shared_memory(region, size, offset=offset)
    return out


def _inputs(wire, region, size=64, offsets=(0, 64)):
    mod = _mod(wire)
    ins = []
    for name, off in zip(("INPUT0", "INPUT1"), offsets):
        i = mod.InferInput(name, [1, 16], "INT32")
        i.set_shared_memory(region, size, offset=off)
        ins.append(i)
    return ins


# -- system shm -------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_system_lifecycle_equals_jax(servers, wire):
    """Register, status, infer with inputs and outputs in regions,
    unregister one, unregister all."""
    def run(side):
        c = _client(side, wire)
        hin = jax_shm.create_shared_memory_region("in", _key("lc_in"), 128)
        hout = jax_shm.create_shared_memory_region("out", _key("lc_out"),
                                                   128)
        log = []
        try:
            jax_shm.set_shared_memory_region(hin, [A, B])
            c.register_system_shared_memory("in", _key("lc_in"), 128)
            c.register_system_shared_memory("out", _key("lc_out"), 128)
            log.append(_status(c.get_system_shared_memory_status()))
            log.append(_status(c.get_system_shared_memory_status("in")))
            result = c.infer("simple", _inputs(wire, "in"), outputs=[
                _outputs(wire, "OUTPUT0", "out", 64),
                _outputs(wire, "OUTPUT1", "out", 64, offset=64)])
            log.append(result.as_numpy("OUTPUT0"))
            log.append(_outputs_of(result))
            log.append(bytes(hout._map[:128]))
            c.unregister_system_shared_memory("in")
            log.append(_status(c.get_system_shared_memory_status()))
            c.unregister_system_shared_memory()
            log.append(_status(c.get_system_shared_memory_status()))
        finally:
            c.unregister_system_shared_memory()
            c.close()
            jax_shm.destroy_shared_memory_region(hin)
            jax_shm.destroy_shared_memory_region(hout)
        return log

    port, ref = _on_both(servers, run)
    assert port == ref
    got = np.frombuffer(port[4], np.int32).reshape(2, 16)
    assert (got[0] == (A + B)[0]).all() and (got[1] == (A - B)[0]).all()


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_register_and_offset_errors_equal_jax(servers, wire):
    """A missing key, a double register, a region past its segment, an
    unregistered region, a negative offset and an offset past the region
    all answer 400 / INVALID_ARGUMENT with the same words."""
    def run(side):
        c = _client(side, wire)
        h = jax_shm.create_shared_memory_region("r", _key("err"), 128)
        log = []
        try:
            jax_shm.set_shared_memory_region(h, [A, B])
            log.append(_answer(lambda: c.register_system_shared_memory(
                "nokey", _key("no_such_segment"), 64)))
            log.append(_answer(lambda: c.register_system_shared_memory(
                "r", _key("err"), 128)))
            log.append(_answer(lambda: c.register_system_shared_memory(
                "r", _key("err"), 128)))
            for region, offsets in (("nope", (0, 64)), ("r", (-64, 0)),
                                    ("r", (0, 192)), ("r", (0, 128))):
                log.append(_answer(lambda: c.infer(
                    "simple", _inputs(wire, region, offsets=offsets))))
            log.append(_answer(lambda: c.infer(
                "simple", _inputs(wire, "r"),
                outputs=[_outputs(wire, "OUTPUT0", "nope", 64)])))
        finally:
            c.unregister_system_shared_memory()
            c.close()
            jax_shm.destroy_shared_memory_region(h)
        return log

    port, ref = _on_both(servers, run)
    assert port == ref
    assert [entry[0] for entry in port] == [
        "error", "ok", "error", "error", "error", "error", "error", "error"]


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_region_past_its_segment_is_400(servers, wire):
    """The port answers 400 / INVALID_ARGUMENT with the words the JAX
    engine means to say. The JAX engine closes the mapping before it
    formats ``len(self.map)`` into its message, so it answers 500 /
    INTERNAL with a TypeError's words: a fault of the reference, which
    stays as it is."""
    def run(side):
        c = _client(side, wire)
        h = jax_shm.create_shared_memory_region("r", _key("past"), 128)
        try:
            return _answer(lambda: c.register_system_shared_memory(
                "past", _key("past"), 128, offset=64))
        finally:
            c.close()
            jax_shm.destroy_shared_memory_region(h)

    port, ref = _on_both(servers, run)
    assert port == ("error", "400" if wire == "http" else
                    str(grpc.StatusCode.INVALID_ARGUMENT),
                    "region 'past': offset+byte_size (64+128) exceeds shm "
                    "segment size (128)")
    assert ref[1] in ("500", str(grpc.StatusCode.INTERNAL))
    assert "has no len()" in ref[2]


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_placement_too_small_and_mixed_outputs_equal_jax(servers, wire):
    """An output larger than its placement is refused; a shm output beside
    a raw one takes no raw slot (the raw one comes back inline)."""
    def run(side):
        c = _client(side, wire)
        h = jax_shm.create_shared_memory_region("mix", _key("mix"), 64)
        log = []
        try:
            c.register_system_shared_memory("mix", _key("mix"), 64)
            mod = _mod(wire)
            ins = []
            for name, arr in (("INPUT0", A), ("INPUT1", B)):
                i = mod.InferInput(name, [1, 16], "INT32")
                i.set_data_from_numpy(arr)
                ins.append(i)
            log.append(_answer(lambda: c.infer("simple", ins, outputs=[
                _outputs(wire, "OUTPUT0", "mix", 32)])))
            result = c.infer("simple", ins, outputs=[
                _outputs(wire, "OUTPUT0", "mix", 64),
                _outputs(wire, "OUTPUT1", None, 0)])
            log.append(result.as_numpy("OUTPUT0"))
            log.append(result.as_numpy("OUTPUT1").tolist())
            log.append(bytes(h._map[:64]))
        finally:
            c.unregister_system_shared_memory()
            c.close()
            jax_shm.destroy_shared_memory_region(h)
        return log

    port, ref = _on_both(servers, run)
    assert port == ref
    assert port[0][0] == "error" and port[1] is None
    assert port[2] == (A - B).tolist()
    assert port[3] == (A + B).tobytes()


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_bytes_through_shm_equal_jax(servers, wire):
    """``simple_string``: BYTES inputs and outputs in a region."""
    a = np.array([[str(i).encode() for i in range(16)]], dtype=np.object_)
    b = np.array([[b"2"] * 16], dtype=np.object_)
    size_in = len(jax_utils.serialize_byte_tensor(a)) \
        + len(jax_utils.serialize_byte_tensor(b))

    def run(side):
        c = _client(side, wire)
        hin = jax_shm.create_shared_memory_region("sin", _key("sin"), 256)
        hout = jax_shm.create_shared_memory_region("sout", _key("sout"), 512)
        log = []
        try:
            jax_shm.set_shared_memory_region(hin, [a, b])
            c.register_system_shared_memory("sin", _key("sin"), 256)
            c.register_system_shared_memory("sout", _key("sout"), 512)
            mod = _mod(wire)
            ins = []
            first = len(jax_utils.serialize_byte_tensor(a))
            for name, off, size in (("INPUT0", 0, first),
                                    ("INPUT1", first, size_in - first)):
                i = mod.InferInput(name, [1, 16], "BYTES")
                i.set_shared_memory("sin", size, offset=off)
                ins.append(i)
            result = c.infer("simple_string", ins, outputs=[
                _outputs(wire, "OUTPUT0", "sout", 256),
                _outputs(wire, "OUTPUT1", "sout", 256, offset=256)])
            log.append(_outputs_of(result))
            log.append(bytes(hout._map[:512]))
            log.append(jax_shm.get_contents_as_numpy(
                hout, np.object_, (1, 16)).tolist())
        finally:
            c.unregister_system_shared_memory()
            c.close()
            jax_shm.destroy_shared_memory_region(hin)
            jax_shm.destroy_shared_memory_region(hout)
        return log

    port, ref = _on_both(servers, run)
    assert port == ref
    assert port[2] == [[str(i + 2).encode() for i in range(16)]]


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_bytes_region_shorter_than_its_shape_equals_jax(servers, wire):
    """A BYTES input whose region window holds fewer elements than its
    shape: the same code and words (numpy's reshape error) on both."""
    a = np.array([[str(i).encode() for i in range(16)]], dtype=np.object_)
    short = len(jax_utils.serialize_byte_tensor(a[:, :10]))

    def run(side):
        c = _client(side, wire)
        h = jax_shm.create_shared_memory_region("short", _key("short"), 256)
        try:
            jax_shm.set_shared_memory_region(h, [a])
            c.register_system_shared_memory("short", _key("short"), 256)
            ins = []
            for name in ("INPUT0", "INPUT1"):
                i = _mod(wire).InferInput(name, [1, 16], "BYTES")
                i.set_shared_memory("short", short)
                ins.append(i)
            return _answer(lambda: c.infer("simple_string", ins))
        finally:
            c.unregister_system_shared_memory()
            c.close()
            jax_shm.destroy_shared_memory_region(h)

    port, ref = _on_both(servers, run)
    assert port == ref
    assert port[0] == "error" and "reshape" in port[2]


@pytest.mark.parametrize("param", [
    {"shared_memory_region": "r", "shared_memory_byte_size": 64},
    {"classification": 2}, {"binary_data": True}],
    ids=["shm", "classification", "binary"])
def test_generate_refuses_output_parameters_as_jax(servers, param):
    """The generate routes return JSON tensors only: an output asking for
    shared memory, classes or binary data is a 400 with the same words."""
    body = {"inputs": [{"name": f"INPUT{i}", "datatype": "INT32",
                        "shape": [1, 16], "data": A.ravel().tolist()}
                       for i in range(2)],
            "outputs": [{"name": "OUTPUT0", "parameters": param}]}
    port, ref = _on_both(servers, lambda side: _http_json(
        side.http.url, "/v2/models/simple/generate", body))
    assert port == ref
    assert port[0] == 400 and "JSON tensors only" in port[1]["error"]


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_bert_in_regions_equals_inline_and_jax(servers, wire):
    """A small BERT with its inputs and outputs in system regions: bit for
    bit the same request sent inline, and the JAX server's within
    ``BERT_ATOL``."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, SMALL_BERT["vocab"], (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 20:] = 0

    def run(side):
        c = _client(side, wire)
        mod = _mod(wire)
        hin = jax_shm.create_shared_memory_region("bin", _key("bin"), 512)
        hout = jax_shm.create_shared_memory_region("bout", _key("bout"),
                                                   1024)
        try:
            jax_shm.set_shared_memory_region(hin, [ids, mask])
            c.register_system_shared_memory("bin", _key("bin"), 512)
            c.register_system_shared_memory("bout", _key("bout"), 1024)
            shm_ins, raw_ins = [], []
            for k, (name, arr) in enumerate((("input_ids", ids),
                                             ("attention_mask", mask))):
                i = mod.InferInput(name, [2, 32], "INT32")
                i.set_shared_memory("bin", 256, offset=256 * k)
                shm_ins.append(i)
                i = mod.InferInput(name, [2, 32], "INT32")
                i.set_data_from_numpy(arr)
                raw_ins.append(i)
            c.infer("bert_small", shm_ins, outputs=[
                _outputs(wire, "logits", "bout", 16),
                _outputs(wire, "pooled_output", "bout", 512, offset=16)])
            in_region = (jax_shm.get_contents_as_numpy(
                hout, np.float32, (2, 2)).copy(),
                jax_shm.get_contents_as_numpy(
                    hout, np.float32, (2, 64), offset=16).copy())
            inline = c.infer("bert_small", raw_ins)
            return in_region, (inline.as_numpy("logits"),
                               inline.as_numpy("pooled_output"))
        finally:
            c.unregister_system_shared_memory()
            c.close()
            jax_shm.destroy_shared_memory_region(hin)
            jax_shm.destroy_shared_memory_region(hout)

    (port, port_inline), (ref, _) = _on_both(servers, run)
    for got, inline, want in zip(port, port_inline, ref):
        assert got.tobytes() == inline.tobytes()
        np.testing.assert_allclose(got, want, atol=BERT_ATOL, rtol=0)


# -- host-staged device regions ----------------------------------------------------

def _http_json(url: str, path: str, body: dict | None = None):
    """A raw request (the clients have no ``cudasharedmemory`` calls):
    (status, JSON body)."""
    req = urllib.request.Request(
        f"http://{url}{path}", method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _rpc(side, route, verb, **fields):
    """One device-region RPC of ``route`` ("tpu" or "cuda") on a fresh
    channel; the response's bytes."""
    kind = "Tpu" if route == "tpu" else "Cuda"
    with grpc.insecure_channel(side.grpc.url) as channel:
        stub = grpc_stub.GRPCInferenceServiceStub(channel)
        resp = getattr(stub, f"{kind}SharedMemory{verb}")(
            getattr(pb, f"{kind}SharedMemory{verb}Request")(**fields),
            timeout=TIMEOUT)
    return resp.SerializeToString(deterministic=True)


def _device_register(side, wire, route, name, raw, byte_size,
                     device_id=0):
    """Register a handle on the ``tpu`` or ``cuda`` route or RPC: base64
    over HTTP, raw over gRPC."""
    if wire == "http":
        if route == "tpu":
            return _answer(lambda: _client(side, wire)
                           .register_tpu_shared_memory(
                               name, raw, device_id, byte_size))
        return _http_json(
            side.http.url, f"/v2/cudasharedmemory/region/{name}/register",
            {"raw_handle": {"b64": jax_b64(raw)}, "device_id": device_id,
             "byte_size": byte_size})
    try:
        return ("ok", _rpc(side, route, "Register", name=name,
                           raw_handle=raw, device_id=device_id,
                           byte_size=byte_size))
    except grpc.RpcError as exc:
        return ("error", exc.code(), exc.details())


def _device_status(side, wire, route):
    if wire == "http":
        return _http_json(side.http.url, f"/v2/{route}sharedmemory/status")
    return _rpc(side, route, "Status")


def _device_unregister(side, wire, route):
    if wire == "http":
        return _http_json(side.http.url,
                          f"/v2/{route}sharedmemory/unregister", {})
    return _rpc(side, route, "Unregister")


@pytest.mark.parametrize("route", ["tpu", "cuda"])
@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_host_staged_regions_equal_jax(servers, wire, route):
    """Regions made with the JAX package's ``tpu_shared_memory``,
    registered by handle on the tpu or cuda route, inputs and outputs
    through them; both routes list the same regions."""
    def run(side):
        hin = jax_tpushm.create_shared_memory_region("hs_in", 128)
        hout = jax_tpushm.create_shared_memory_region("hs_out", 128)
        c = _client(side, wire)
        log = []
        try:
            jax_tpushm.set_shared_memory_region(hin, [A, B])
            for name, h in (("hs_in", hin), ("hs_out", hout)):
                log.append(_device_register(
                    side, wire, route, name, jax_tpushm.get_raw_handle(h),
                    128))
            log.append(_device_register(
                side, wire, route, "hs_in", jax_tpushm.get_raw_handle(hin),
                128))
            log.append(_device_status(side, wire, "tpu"))
            log.append(_device_status(side, wire, "cuda"))
            c.infer("simple", _inputs(wire, "hs_in"), outputs=[
                _outputs(wire, "OUTPUT0", "hs_out", 64),
                _outputs(wire, "OUTPUT1", "hs_out", 64, offset=64)])
            log.append(jax_tpushm.get_contents_as_numpy(
                hout, np.int32, (2, 16)).tolist())
            log.append(_device_unregister(side, wire, route))
            log.append(_device_status(side, wire, route))
        finally:
            _device_unregister(side, wire, route)
            c.close()
            jax_tpushm.destroy_shared_memory_region(hin)
            jax_tpushm.destroy_shared_memory_region(hout)
        return log

    port, ref = _on_both(servers, run)
    assert port == ref
    assert port[5] == [(A + B)[0].tolist(), (A - B)[0].tolist()]


FUZZ = {
    "scalar": b"5",
    "list": b"[1, 2]",
    "not_json": b"{not json",
    "not_utf8": b"\xff\xfe",
    "missing_key": json.dumps({"kind": "host_staged",
                               "byte_size": 64}).encode(),
    "empty_key": json.dumps({"kind": "host_staged", "key": "",
                             "byte_size": 64}).encode(),
    "unknown_kind": json.dumps({"kind": "cuda_ipc", "key": "/k",
                                "byte_size": 64}).encode(),
    "bad_byte_size": json.dumps({"kind": "host_staged", "key": "/k",
                                 "byte_size": "many"}).encode(),
    "no_segment": json.dumps({"kind": "host_staged",
                              "key": "/torch_shm_no_such_segment",
                              "byte_size": 64}).encode(),
}


@pytest.mark.parametrize("case", sorted(FUZZ))
@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_malformed_handles_equal_jax(servers, wire, case):
    """Each malformed handle is the client's error, never a 500."""
    port, ref = _on_both(servers, lambda side: _device_register(
        side, wire, "cuda", "fuzz", FUZZ[case], 64))
    assert port == ref
    if wire == "http":
        assert port[0] == 400
    else:
        assert port[1] == grpc.StatusCode.INVALID_ARGUMENT


def test_shm_extensions_equal_jax(servers):
    def shm_extensions(side):
        md = httpclient.InferenceServerClient(
            side.http.url).get_server_metadata()
        return sorted(e for e in md["extensions"] if "shared_memory" in e)

    port, ref = _on_both(servers, shm_extensions)
    assert port == ref == ["cuda_shared_memory", "system_shared_memory",
                           "tpu_shared_memory"]


# -- in-process device regions -----------------------------------------------------

def _execute_batch(engine, model, requests):
    """Run ``requests`` as one batch of ``model``'s scheduler, as its
    worker runs a gathered batch (called directly, so that both engines
    form the same batch whatever their worker threads do); returns the
    responses and the rows of the execution."""
    sched = engine._schedulers[model]
    rows, out = [], [None] * len(requests)
    real = sched.model.execute_timed

    def spy(inputs, batch_size=None, **kw):
        rows.append(batch_size)
        return real(inputs, batch_size=batch_size, **kw)

    for i, req in enumerate(requests):
        req.response_callback = lambda resp, i=i: out.__setitem__(i, resp)
    sched.model.execute_timed = spy
    try:
        sched._execute_batch(requests)
    finally:
        sched.model.execute_timed = real
    for resp in out:
        assert resp is not None and resp.error is None, resp
    return out, rows


def _device_requests(engine, model, inputs: list[dict], outputs):
    """One request per input dict, every input read from a device region
    made of it: a CPU tensor on the port, an array on the JAX engine."""
    port = isinstance(engine, TorchEngine)
    reqs = []
    for k, row in enumerate(inputs):
        feed = {}
        for name, arr in row.items():
            region = f"{model}_{name}_{k}"
            if port:
                engine.cuda_shm.register_device_tensor(
                    region, torch.from_numpy(arr.copy()))
            else:
                engine.tpu_shm.register_device_array(
                    region, jax.device_put(arr))
            feed[name] = engine.read_shm_tensor(
                region, 0, arr.nbytes, "INT32", arr.shape)
        make, out = ((InferRequest, OutputRequest) if port
                     else (JaxRequest, JaxOutput))
        reqs.append(make(model_name=model, inputs=feed,
                         outputs=[out(name=o) for o in outputs],
                         keep_outputs_on_device=True))
    return reqs


@pytest.fixture
def engines(servers):
    yield servers.port.engine, servers.jax.engine
    servers.port.engine.cuda_shm.unregister(None)
    servers.jax.engine.tpu_shm.unregister(None)


def _simple_rows(n):
    rng = np.random.default_rng(n)
    return [{"INPUT0": rng.integers(-50, 50, (1, 16)).astype(np.int32),
             "INPUT1": rng.integers(-50, 50, (1, 16)).astype(np.int32)}
            for _ in range(n)]


def _bert_rows(n):
    rng = np.random.default_rng(n)
    rows = []
    for k in range(n):
        mask = np.ones((1, 32), np.int32)
        mask[0, 8 + 6 * k:] = 0
        rows.append({"input_ids": rng.integers(
            0, SMALL_BERT["vocab"], (1, 32)).astype(np.int32),
            "attention_mask": mask})
    return rows


@pytest.mark.parametrize("model,rows,outputs", [
    ("simple", _simple_rows, ["OUTPUT0", "OUTPUT1"]),
    ("bert_small", _bert_rows, ["logits", "pooled_output"]),
])
def test_device_regions_batch_on_the_device_as_jax(engines, model, rows,
                                                   outputs):
    """Three requests in one batch of bucket 4: joined on the device with
    the first operand repeated; every output equals the JAX engine's
    (``simple`` bit for bit, BERT within ``BERT_ATOL``) and the same rows
    run on the host path bit for bit; every request's window is a view of
    its batch's output."""
    port_engine, jax_engine = engines
    feeds = rows(3)
    port_model = port_engine.repository.get(model)
    concat = []
    real_concat = port_model.concat_rows

    def spy(tensors):
        concat.append(len(tensors))
        return real_concat(tensors)

    port_model.concat_rows = spy
    try:
        got, port_rows = _execute_batch(
            port_engine, model,
            _device_requests(port_engine, model, feeds, outputs))
    finally:
        port_model.concat_rows = real_concat
    want, jax_rows = _execute_batch(
        jax_engine, model,
        _device_requests(jax_engine, model, feeds, outputs))
    assert port_rows == jax_rows == [3]
    assert concat == [4] * len(feeds[0])  # 3 requests + 1 repeated
    host = {name: np.concatenate([f[name] for f in feeds] + [feeds[0][name]])
            for name in feeds[0]}
    inline, _ = port_model.execute_timed(host, batch_size=4)
    for name in outputs:
        batch = got[0].outputs[name]
        assert [r.outputs[name].untyped_storage().data_ptr() for r in got] \
            == [batch.untyped_storage().data_ptr()] * 3
        assert batch.untyped_storage().nbytes() == 4 * batch[0].nbytes
    for k, (g, w) in enumerate(zip(got, want)):
        for name in outputs:
            tensor = g.outputs[name]
            assert isinstance(tensor, torch.Tensor)
            mine, theirs = tensor.numpy(), np.asarray(w.outputs[name])
            assert mine.tobytes() == inline[name][k:k + 1].tobytes()
            if model == "simple":
                assert mine.tobytes() == theirs.tobytes()
            else:
                np.testing.assert_allclose(mine, theirs, atol=BERT_ATOL,
                                           rtol=0)


def test_device_region_output_is_the_batch_window(engines):
    """``write_shm_tensor`` stores a window as it is: ``read_back`` gives
    a tensor sharing the batch output's storage, and the region then feeds
    the next request as its input."""
    port_engine, _ = engines
    feeds = _simple_rows(1)
    port_engine.cuda_shm.register_device_tensor(
        "win", torch.zeros(1, 16, dtype=torch.int32))
    resp = port_engine.infer(_device_requests(
        port_engine, "simple", feeds, ["OUTPUT0"])[0], timeout_s=TIMEOUT)
    out = resp.outputs["OUTPUT0"]
    assert port_engine.write_shm_tensor("win", 0, 64, out) == 64
    back = port_engine.cuda_shm.read_back("win")
    assert back is out
    assert back.untyped_storage().data_ptr() == \
        out.untyped_storage().data_ptr()
    assert back.numpy().tolist() == (feeds[0]["INPUT0"]
                                     + feeds[0]["INPUT1"]).tolist()
    again = port_engine.read_shm_tensor("win", 0, 64, "INT32", [1, 16])
    assert again.untyped_storage().data_ptr() == \
        out.untyped_storage().data_ptr()


def _device_region_errors(engine, mgr, register, make_array):
    log = []
    register(mgr, "dev", make_array(np.zeros((1, 16), np.int32)))
    for fn in (
            lambda: engine.read_shm_tensor("dev", 64, 64, "INT32", [1, 16]),
            lambda: engine.write_shm_tensor(
                "dev", 64, 64, np.zeros((1, 16), np.int32)),
            lambda: engine.write_shm_tensor(
                "dev", 0, 64, np.zeros((2, 16), np.int32)),
            lambda: register(mgr, "dev", make_array(np.zeros(4, np.int32))),
            lambda: mgr.read_back("missing"),
            lambda: engine.read_shm_tensor("missing", 0, 4, "INT32", [1])):
        try:
            fn()
            log.append("ok")
        except Exception as exc:  # noqa: BLE001 — the words are compared
            log.append((type(exc).__name__, getattr(exc, "status", None),
                        str(exc)))
    return log


def test_device_region_errors_equal_jax(engines):
    """Offsets refused on read and write, an output larger than the
    region, a double register and unknown regions, with JAX's words."""
    port_engine, jax_engine = engines
    port = _device_region_errors(
        port_engine, port_engine.cuda_shm,
        lambda m, n, t: m.register_device_tensor(n, t), torch.from_numpy)
    ref = _device_region_errors(
        jax_engine, jax_engine.tpu_shm,
        lambda m, n, a: m.register_device_array(n, a), jax.device_put)
    assert port == ref
    assert all(entry != "ok" for entry in port)


def test_device_id_out_of_range_answers_400(engines, servers):
    """A host-staged region whose device_id is past the engine's devices:
    registered, then refused on read, with JAX's words (the JAX engine
    counts its 8 virtual CPU devices, the port its one CPU)."""
    h = jax_tpushm.create_shared_memory_region("far", 64, device_id=9)
    try:
        answers = []
        for engine, mgr in ((servers.port.engine, servers.port.engine.cuda_shm),
                            (servers.jax.engine, servers.jax.engine.tpu_shm)):
            mgr.register_handle("far", jax_tpushm.get_raw_handle(h), 9, 64)
            try:
                engine.read_shm_tensor("far", 0, 64, "INT32", [1, 16])
            except Exception as exc:  # noqa: BLE001 — the words are compared
                answers.append((exc.status, str(exc)))
    finally:
        jax_tpushm.destroy_shared_memory_region(h)
    assert answers == [(400, "device_id 9 out of range (1 devices)"),
                       (400, "device_id 9 out of range (8 devices)")]


# -- the port's client utilities -----------------------------------------------------

@pytest.mark.parametrize("values", [
    [A, B],
    [np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 12)],
    [np.array([[b"a", b"", "dé".encode()], [b"xyz", b"0", b"\x00\x01"]],
              dtype=np.object_)],
], ids=["int32", "fp32", "bytes"])
def test_shm_utils_write_the_jax_bytes(values):
    """The same tensors give the same segment bytes, and read back equal
    through either package's ``get_contents_as_numpy``."""
    regions = [port_shm.create_shared_memory_region("u", _key("u_port"), 256),
               jax_shm.create_shared_memory_region("u", _key("u_jax"), 256)]
    try:
        port_shm.set_shared_memory_region(regions[0], values)
        jax_shm.set_shared_memory_region(regions[1], values)
        assert bytes(regions[0]._map[:256]) == bytes(regions[1]._map[:256])
        arr = values[0]
        dtype = np.object_ if arr.dtype == np.object_ else arr.dtype
        got = port_shm.get_contents_as_numpy(regions[0], dtype, arr.shape)
        want = jax_shm.get_contents_as_numpy(regions[1], dtype, arr.shape)
        assert got.dtype == want.dtype and got.tolist() == want.tolist() \
            == arr.tolist()
    finally:
        for mod, region in zip((port_shm, jax_shm), regions):
            mod.destroy_shared_memory_region(region)
    assert not os.path.exists("/dev/shm" + _key("u_port"))


def test_cuda_shm_handle_equals_jax():
    """The handle JSON is the JAX package's but for the random key, and
    its base64 form is the same encoding."""
    port = port_cudashm.create_shared_memory_region("hp", 96, device_id=2)
    ref = jax_tpushm.create_shared_memory_region("hp", 96, device_id=2)
    try:
        got = json.loads(port_cudashm.get_raw_handle(port))
        want = json.loads(jax_tpushm.get_raw_handle(ref))
        assert got.pop("key").startswith("/") and want.pop("key")
        assert got == want
        raw = port_cudashm.get_raw_handle(port)
        assert port_cudashm.get_raw_handle_b64(port) == jax_b64(raw) == \
            b64_encode_handle(raw)
        assert port_cudashm.allocated_shared_memory_regions() == ["hp"]
    finally:
        port_cudashm.destroy_shared_memory_region(port)
        jax_tpushm.destroy_shared_memory_region(ref)
    assert port_cudashm.allocated_shared_memory_regions() == []


@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_port_utils_regions_serve_on_the_jax_server(servers, wire):
    """A system region and a device region made with the port's utilities
    register and serve on the JAX server, and on the port's alike."""
    def run(side):
        c = _client(side, wire)
        hin = port_shm.create_shared_memory_region("pin", _key("pin"), 128)
        hout = port_cudashm.create_shared_memory_region("pout", 128)
        try:
            port_shm.set_shared_memory_region(hin, [A, B])
            c.register_system_shared_memory("pin", _key("pin"), 128)
            c.register_tpu_shared_memory(
                "pout", port_cudashm.get_raw_handle(hout), 0, 128)
            c.infer("simple", _inputs(wire, "pin"), outputs=[
                _outputs(wire, "OUTPUT0", "pout", 64),
                _outputs(wire, "OUTPUT1", "pout", 64, offset=64)])
            return port_cudashm.get_contents_as_numpy(
                hout, np.int32, (2, 16)).tolist()
        finally:
            c.unregister_system_shared_memory()
            c.unregister_tpu_shared_memory()
            c.close()
            port_shm.destroy_shared_memory_region(hin)
            port_cudashm.destroy_shared_memory_region(hout)

    port, ref = _on_both(servers, run)
    assert port == ref == [(A + B)[0].tolist(), (A - B)[0].tolist()]


def test_byte_tensor_helpers_equal_jax():
    arr = np.array([b"one", b"", "twö".encode()], dtype=np.object_)
    enc = port_utils.serialize_byte_tensor(arr)
    assert enc.tobytes() == jax_utils.serialize_byte_tensor(arr).tobytes()
    assert port_utils.deserialize_bytes_tensor(enc).tolist() == \
        jax_utils.deserialize_bytes_tensor(enc).tolist() == arr.tolist()
    assert port_utils.np_to_triton_dtype(np.int32) == "INT32"
    assert port_utils.triton_to_np_dtype("FP32") == np.float32
    with pytest.raises(port_utils.InferenceServerException, match="boom"):
        port_utils.raise_error("boom")
