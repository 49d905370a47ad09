"""The port's gRPC frontend on the CPU: its wire schema, codec, config and
coalescing helpers against the JAX package's, and its unary answers
against a live JAX ``GrpcInferenceServer``.

The ``simple`` family must answer exactly what the JAX server answers
(integer and string arithmetic: no tolerance), compared as parsed
messages serialized deterministically (map order is not fixed on the
wire). A small BERT served over ``ModelInfer`` is held against a direct
call of the same module at 1e-5 (the same arithmetic on the same rows, as
``tests/test_torch_server.py`` holds it over HTTP). Error codes and
messages must be equal. Every call has a timeout.
"""

import os
import re
import signal
import subprocess
import sys
from types import SimpleNamespace

import grpc
import numpy as np
import pytest
import torch

from client_tpu.protocol import grpc_codec as jax_codec
from client_tpu.protocol import grpc_service_pb2 as jax_pb
from client_tpu.protocol import grpc_stub as jax_stub
from client_tpu.protocol import model_config as jax_model_config
from client_tpu.engine import types as jax_types
from client_tpu.server import coalesce as jax_coalesce
from client_tpu_torch.engine import types as port_types
from client_tpu_torch.server import coalesce
from client_tpu_torch.engine import TorchEngine
from client_tpu_torch.models import _REGISTRY, build_repository, model_names
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.protocol import grpc_codec, grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol.dtypes import wire_to_np_dtype
from client_tpu_torch.protocol.model_config import config_dict_to_proto
from client_tpu_torch.server import GrpcInferenceServer
from client_tpu_torch.server.grpc_server import _Servicer

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TIMEOUT = 60  # seconds, every RPC
SIMPLE = ["simple", "simple_int8", "simple_string", "simple_identity"]
SMALL_BERT = dict(seq_len=32, hidden=64, n_layers=2, n_heads=4, ffn=128,
                  vocab=512, max_batch_size=4)


# -- the wire schema -----------------------------------------------------------

def test_descriptor_is_byte_identical_to_jax():
    """Both files register grpc_service.proto in the default pool; one
    differing byte would fail the second import."""
    assert pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    assert pb.ModelInferRequest is jax_pb.ModelInferRequest


@pytest.mark.parametrize("name", [m[0] for m in grpc_stub._METHODS])
def test_stub_method_equals_jax(name):
    port = {m[0]: m for m in grpc_stub._METHODS}[name]
    jax = {m[0]: m for m in jax_stub._METHODS}[name]
    assert port == jax  # request and response types, streaming
    assert grpc_stub._SERVICE == jax_stub._SERVICE


def test_stub_lists_the_core_rpcs_of_the_proto():
    service = pb.DESCRIPTOR.services_by_name["GRPCInferenceService"]
    assert [m[0] for m in grpc_stub._METHODS] == [
        m.name for m in service.methods]
    served = [n for n, *_ in grpc_stub._METHODS if n in vars(_Servicer)]
    assert served == [
        "ServerLive", "ServerReady", "ModelReady", "ServerMetadata",
        "ModelMetadata", "ModelInfer", "ModelStreamInfer", "ModelConfig",
        "ModelStatistics", "RepositoryIndex", "RepositoryModelLoad",
        "RepositoryModelUnload", "SystemSharedMemoryStatus",
        "SystemSharedMemoryRegister", "SystemSharedMemoryUnregister",
        "CudaSharedMemoryStatus", "CudaSharedMemoryRegister",
        "CudaSharedMemoryUnregister", "TpuSharedMemoryStatus",
        "TpuSharedMemoryRegister", "TpuSharedMemoryUnregister"]


# -- the codec -----------------------------------------------------------------

WIRE = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
        "UINT32", "UINT64", "FP32", "FP64", "BYTES"]


def _array(wire, seed=0):
    rng = np.random.default_rng(seed)
    if wire == "BYTES":
        items = [b"", b"a", "été".encode(), b"\x00\xff", b"xyz",
                 b"12"]
        arr = np.empty(6, np.object_)
        arr[:] = items
        return arr.reshape(2, 3)
    dt = np.dtype(wire_to_np_dtype(wire))
    if wire == "BOOL":
        return rng.integers(0, 2, (2, 3)).astype(bool)
    if dt.kind == "f":
        return rng.standard_normal((2, 3)).astype(dt)
    info = np.iinfo(dt)
    return np.array([[info.min, info.max, 0], [1, 7, info.max // 3]], dt)


@pytest.mark.parametrize("wire", WIRE)
def test_typed_contents_equal_jax(wire):
    arr = _array(wire)
    got, want = pb.InferTensorContents(), jax_pb.InferTensorContents()
    grpc_codec.fill_contents(got, arr, wire)
    jax_codec.fill_contents(want, arr, wire)
    assert got == want
    back = grpc_codec.contents_to_ndarray(got, wire, arr.shape)
    jax_back = jax_codec.contents_to_ndarray(want, wire, arr.shape)
    assert back.dtype == jax_back.dtype and back.shape == arr.shape
    assert back.tolist() == jax_back.tolist() == arr.tolist()
    tensor = pb.ModelInferRequest.InferInputTensor(
        name="t", datatype=wire, shape=list(arr.shape), contents=got)
    assert grpc_codec.tensor_has_contents(tensor) \
        == jax_codec.tensor_has_contents(tensor) is True


@pytest.mark.parametrize("wire", WIRE + ["FP16"])
def test_raw_contents_equal_jax(wire):
    arr = _array(wire)
    raw = grpc_codec.ndarray_to_raw(arr, wire)
    assert raw == jax_codec.ndarray_to_raw(arr, wire)
    tensor = pb.ModelInferRequest.InferInputTensor(
        name="t", datatype=wire, shape=list(arr.shape))
    back = grpc_codec.tensor_to_ndarray(tensor, raw)
    jax_back = jax_codec.tensor_to_ndarray(tensor, raw)
    assert back.dtype == jax_back.dtype
    assert back.tolist() == jax_back.tolist() == arr.tolist()
    assert grpc_codec.tensor_has_contents(tensor) \
        == jax_codec.tensor_has_contents(tensor) is False


def test_parameters_equal_jax():
    values = {"b": True, "i": -3, "f": 0.25, "s": "text", "n": 7}
    got = pb.ModelInferRequest()
    want = pb.ModelInferRequest()
    for k, v in values.items():
        grpc_codec.set_param(got.parameters, k, v)
        jax_codec.set_param(want.parameters, k, v)
    assert got.SerializeToString(deterministic=True) \
        == want.SerializeToString(deterministic=True)
    assert grpc_codec.params_to_dict(got.parameters) \
        == jax_codec.params_to_dict(got.parameters) == values
    assert grpc_codec.param_value(pb.InferParameter()) is None


def _string_typed(cfg: dict) -> dict:
    """``cfg`` with its BYTES tensors written as the proto's TYPE_STRING."""
    return {**cfg, **{side: [
        {**t, "data_type": ("TYPE_STRING" if t["data_type"] == "TYPE_BYTES"
                            else t["data_type"])} for t in cfg[side]]
        for side in ("input", "output")}}


def _has_bytes(cfg: dict) -> bool:
    return any(t["data_type"] == "TYPE_BYTES"
               for side in ("input", "output") for t in cfg[side])


@pytest.mark.parametrize("name", model_names())
def test_config_proto_equals_jax(name):
    """Equal to JAX's on every port model's config dict, except that the
    port also converts the ``TYPE_BYTES`` those dicts hold, where the JAX
    function raises (its ModelConfig RPC answers UNKNOWN for a BYTES
    model); the JAX function then gets the dict written in TYPE_STRING."""
    cfg = _REGISTRY[name](torch.device("cpu")).config.config_dict()
    if _has_bytes(cfg):
        with pytest.raises(ValueError, match="TYPE_BYTES"):
            jax_model_config.config_dict_to_proto(cfg)
    assert config_dict_to_proto(cfg) == jax_model_config.config_dict_to_proto(
        _string_typed(cfg))


# -- the coalescing helpers ---------------------------------------------------
#
# The same response sequences go through the port's helpers and the JAX
# package's; the answers must be equal exactly (no arithmetic beyond a
# concatenation, so no tolerance).

# One response of each kind a stream writer meets.
KINDS = {
    "token": lambda i: {"TOKEN": np.array([i], np.int32),
                        "INDEX": np.array([i], np.int32)},
    "wide": lambda i: {"TOKEN": np.array([i, i + 1], np.int32),
                       "INDEX": np.array([i, i], np.int32)},
    "int64": lambda i: {"TOKEN": np.array([i], np.int64),
                        "INDEX": np.array([i], np.int32)},
    "rows": lambda i: {"TOKEN": np.full((1, 2), i, np.int32),
                       "INDEX": np.array([i], np.int32)},
    "renamed": lambda i: {"TEXT": np.array([b"t%d" % i], object)},
    "scalar": lambda i: {"TOKEN": np.int32(i),
                         "INDEX": np.array([i], np.int32)},
    "final": lambda i: {"TOKEN": np.array([i], np.int32),
                        "INDEX": np.array([i], np.int32)},
    "error": lambda i: {},
}


def _pair(kind, i=0):
    """The same response built with each package's types: (port, jax)."""
    out = []
    for types in (port_types, jax_types):
        out.append(types.InferResponse(
            model_name="tiny_gpt", model_version="1", request_id="r",
            outputs=KINDS[kind](i), parameters={"seq": i},
            error=(types.EngineError("boom", 500) if kind == "error"
                   else None),
            final=kind in ("final", "error")))
    return out


def _requests(coalesce_on):
    params = {"response_coalesce": True} if coalesce_on else {}
    return (port_types.InferRequest("tiny_gpt", {}, parameters=params),
            jax_types.InferRequest("tiny_gpt", {}, parameters=params))


def _view(resp):
    """A response as plain values, comparable across the two packages."""
    if resp is None:
        return None
    return (resp.model_name, resp.model_version, resp.request_id,
            {n: (a.dtype.str, a.shape, a.tolist())
             for n, a in resp.outputs.items()},
            resp.parameters, resp.final,
            None if resp.error is None else str(resp.error))


@pytest.mark.parametrize("coalesce_on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_mergeable_equals_jax(kind, coalesce_on):
    port_req, jax_req = _requests(coalesce_on)
    port_resp, jax_resp = _pair(kind)
    assert coalesce.mergeable(port_req, port_resp) == \
        jax_coalesce.mergeable(jax_req, jax_resp)


@pytest.mark.parametrize("nxt", list(KINDS))
@pytest.mark.parametrize("prev", ["token", "wide", "rows", "renamed"])
def test_run_compatible_equals_jax(prev, nxt):
    port_prev, jax_prev = _pair(prev, 1)
    port_next, jax_next = _pair(nxt, 2)
    assert coalesce.run_compatible(port_prev, port_next) == \
        jax_coalesce.run_compatible(jax_prev, jax_next)


@pytest.mark.parametrize("kinds", [
    ["token"] * 5,
    ["wide", "wide", "wide"],
    ["rows", "rows"],
    ["token"],
], ids=["tokens", "wide", "rows", "one"])
def test_merge_equals_jax(kinds):
    port, jax = zip(*(_pair(k, i) for i, k in enumerate(kinds)))
    got = coalesce.merge(list(port))
    assert _view(got) == _view(jax_coalesce.merge(list(jax)))
    if len(kinds) == 1:
        assert got is port[0]


# Queues the SSE writer drains: (the kinds in order, the request's opt-in,
# the cap). The first kind is the response the writer already holds.
DRAINS = {
    "tokens": (["token"] * 6, True, None),
    "tokens_then_final": (["token"] * 3 + ["final", "token"], True, None),
    "tokens_then_error": (["token", "token", "error"], True, None),
    "dtype_change": (["token", "token", "int64", "int64"], True, None),
    "trailing_shape_change": (["token", "rows", "rows"], True, None),
    "names_change": (["token", "renamed", "renamed"], True, None),
    "scalar_output": (["token", "scalar", "token"], True, None),
    "capped": (["token"] * 7, True, 3),
    "cap_of_one": (["token"] * 3, True, 1),
    "first_is_final": (["final", "token"], True, None),
    "first_is_error": (["error", "token"], True, None),
    "empty_queue": (["token"], True, None),
    "opted_out": (["token"] * 4, False, None),
}


@pytest.mark.parametrize("case", list(DRAINS))
def test_drain_run_equals_jax(case):
    kinds, coalesce_on, cap = DRAINS[case]
    reqs = _requests(coalesce_on)
    answers = []
    for side, (helpers, req) in enumerate(zip((coalesce, jax_coalesce),
                                              reqs)):
        resps = [_pair(k, i)[side] for i, k in enumerate(kinds)]
        pending = list(resps[1:])

        def get_nowait():
            return pending.pop(0) if pending else None

        kwargs = {} if cap is None else {"cap": cap}
        merged, leftover = helpers.drain_run(resps[0], get_nowait, req,
                                             **kwargs)
        answers.append((_view(merged),
                        None if leftover is None
                        else [r is leftover for r in resps].index(True),
                        len(pending)))
    assert answers[0] == answers[1]


def test_coalesce_cap_equals_jax():
    assert coalesce.COALESCE_MAX == jax_coalesce.COALESCE_MAX


# -- live servers: the port's and the JAX package's ----------------------------

def _bert(device):
    backend = BertBackend(name="bert_small", device=device, **SMALL_BERT)
    backend.config.instance_count = 1
    return backend


@pytest.fixture(scope="module")
def servers():
    """The port (simple family and a small BERT) and the JAX package
    (simple family) each behind a gRPC server on port 0."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import GrpcInferenceServer as JaxServer

    repo = build_repository(SIMPLE)
    repo.register("bert_small", _bert)
    engine = TorchEngine(repo, device="cpu")
    server = GrpcInferenceServer(engine, port=0).start()
    jax_engine = TpuEngine(jax_build(SIMPLE))
    jax_server = JaxServer(jax_engine, port=0).start()
    channels = [grpc.insecure_channel(s.url) for s in (server, jax_server)]
    yield SimpleNamespace(
        engine=engine, server=server, jax_engine=jax_engine,
        port=grpc_stub.GRPCInferenceServiceStub(channels[0]),
        jax=grpc_stub.GRPCInferenceServiceStub(channels[1]))
    for ch in channels:
        ch.close()
    jax_server.stop()
    jax_engine.shutdown()
    server.stop()
    engine.shutdown()


def _both(servers, rpc, request):
    return (getattr(servers.port, rpc)(request, timeout=TIMEOUT),
            getattr(servers.jax, rpc)(request, timeout=TIMEOUT))


def _wire(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


@pytest.mark.parametrize("rpc,request_msg", [
    ("ServerLive", pb.ServerLiveRequest()),
    ("ServerReady", pb.ServerReadyRequest()),
    ("ModelReady", pb.ModelReadyRequest(name="simple")),
    ("ModelReady", pb.ModelReadyRequest(name="simple", version="1")),
    ("ModelReady", pb.ModelReadyRequest(name="no_such_model")),
    ("ModelReady", pb.ModelReadyRequest(name="simple", version="9")),
], ids=["live", "ready", "model", "version", "unknown", "bad_version"])
def test_health_equals_jax(servers, rpc, request_msg):
    got, want = _both(servers, rpc, request_msg)
    assert _wire(got) == _wire(want)


@pytest.mark.parametrize("name", SIMPLE)
def test_model_metadata_equals_jax_but_the_platform(servers, name):
    got, want = _both(servers, "ModelMetadata",
                      pb.ModelMetadataRequest(name=name))
    assert (got.platform, want.platform) == ("pytorch", "jax")
    got.platform = want.platform
    assert _wire(got) == _wire(want)


@pytest.mark.parametrize("name", SIMPLE)
def test_model_config_equals_jax_but_the_platform(servers, name):
    """For a BYTES model the JAX server answers UNKNOWN (its converter
    raises on TYPE_BYTES); the port's answer then equals JAX's converter
    on the JAX engine's config written in TYPE_STRING."""
    got = servers.port.ModelConfig(pb.ModelConfigRequest(name=name),
                                   timeout=TIMEOUT)
    assert got.config.platform == got.config.backend == "pytorch"
    got.config.platform = got.config.backend = "jax"
    jax_cfg = servers.jax_engine.model_config(name)
    if _has_bytes(jax_cfg):
        with pytest.raises(grpc.RpcError) as exc:
            servers.jax.ModelConfig(pb.ModelConfigRequest(name=name),
                                    timeout=TIMEOUT)
        assert exc.value.code() == grpc.StatusCode.UNKNOWN
        assert "TYPE_BYTES" in exc.value.details()
        want = jax_pb.ModelConfigResponse(
            config=jax_model_config.config_dict_to_proto(
                _string_typed(jax_cfg)))
    else:
        want = servers.jax.ModelConfig(pb.ModelConfigRequest(name=name),
                                       timeout=TIMEOUT)
    assert _wire(got) == _wire(want)


def test_server_metadata_and_repository_index(servers):
    engine = servers.engine
    got, want = _both(servers, "ServerMetadata", pb.ServerMetadataRequest())
    assert got.name == "client_tpu_torch" and want.name
    assert list(got.extensions) == engine.server_metadata()["extensions"]
    got, want = _both(servers, "RepositoryIndex", pb.RepositoryIndexRequest())
    port_models = {m.name: m for m in got.models}
    assert set(port_models) == set(SIMPLE) | {"bert_small"}
    for m in want.models:
        assert _wire(port_models[m.name]) == _wire(m)


def test_model_statistics_count_the_grpc_requests(servers):
    port = servers.port
    before = port.ModelStatistics(pb.ModelStatisticsRequest(name="simple"),
                                  timeout=TIMEOUT).model_stats[0]
    port.ModelInfer(_simple_request("simple", typed=False), timeout=TIMEOUT)
    after = port.ModelStatistics(pb.ModelStatisticsRequest(name="simple"),
                                 timeout=TIMEOUT).model_stats[0]
    assert after.name == "simple" and after.version == "1"
    assert after.inference_count == before.inference_count + 1
    assert after.inference_stats.success.count \
        == before.inference_stats.success.count + 1
    assert sum(b.compute_infer.count for b in after.batch_stats) \
        == after.execution_count


def _simple_inputs(name):
    rng = np.random.default_rng(len(name))
    if name == "simple":
        return {"INPUT0": rng.integers(-2**31, 2**31, (2, 16), np.int64)
                .astype(np.int32),
                "INPUT1": rng.integers(-2**31, 2**31, (2, 16), np.int64)
                .astype(np.int32)}
    if name == "simple_int8":
        return {"INPUT0": rng.integers(-128, 128, (1, 16)).astype(np.int8),
                "INPUT1": rng.integers(-128, 128, (1, 16)).astype(np.int8)}
    if name == "simple_string":
        def strings(lo, hi):
            arr = np.empty((1, 16), np.object_)
            arr[0] = [str(v).encode() for v in rng.integers(lo, hi, 16)]
            return arr
        return {"INPUT0": strings(-10**6, 10**6),
                "INPUT1": strings(-10**6, 10**6)}
    arr = np.empty((2, 3), np.object_)
    arr[:] = [[b"", b"\x00\xffz", b"abc"], ["é".encode(), b"1", b"22"]]
    return {"INPUT0": arr}


def _simple_request(name, typed, request_id="r"):
    req = pb.ModelInferRequest(model_name=name, id=request_id)
    for key, arr in _simple_inputs(name).items():
        wire = {np.dtype(np.int32): "INT32", np.dtype(np.int8): "INT8"}.get(
            arr.dtype, "BYTES")
        tensor = req.inputs.add(name=key, datatype=wire,
                                shape=list(arr.shape))
        if typed:
            grpc_codec.fill_contents(tensor.contents, arr, wire)
        else:
            req.raw_input_contents.append(grpc_codec.ndarray_to_raw(arr, wire))
    return req


@pytest.mark.parametrize("typed", [False, True], ids=["raw", "typed"])
@pytest.mark.parametrize("name", SIMPLE)
def test_simple_family_answers_exactly_as_jax(servers, name, typed):
    got, want = _both(servers, "ModelInfer", _simple_request(name, typed))
    assert _wire(got) == _wire(want)
    inputs = _simple_inputs(name)
    outs = {t.name: grpc_codec.tensor_to_ndarray(t, raw)
            for t, raw in zip(got.outputs, got.raw_output_contents)}
    if name == "simple_identity":
        assert outs["OUTPUT0"].tolist() == inputs["INPUT0"].tolist()
    elif name == "simple_string":
        a = inputs["INPUT0"].astype(np.int64)
        b = inputs["INPUT1"].astype(np.int64)
        assert [int(x) for x in outs["OUTPUT0"].ravel()] == (a + b).ravel().tolist()
        assert [int(x) for x in outs["OUTPUT1"].ravel()] == (a - b).ravel().tolist()
    else:  # wrapping integer arithmetic
        a, b = inputs["INPUT0"], inputs["INPUT1"]
        assert (outs["OUTPUT0"] == a + b).all() and (outs["OUTPUT1"] == a - b).all()


def test_simple_family_over_the_stream_equals_jax(servers):
    """Non-decoupled models on ModelStreamInfer: one final response each,
    several requests multiplexed on one RPC."""
    port, jax = servers.port, servers.jax
    requests = [_simple_request(n, typed=i % 2 == 1, request_id=f"s{i}")
                for i, n in enumerate(SIMPLE)]
    got = {m.infer_response.id: m for m in port.ModelStreamInfer(
        iter(requests), timeout=TIMEOUT)}
    want = {m.infer_response.id: m for m in jax.ModelStreamInfer(
        iter(requests), timeout=TIMEOUT)}
    assert sorted(got) == sorted(want) == [f"s{i}" for i in range(4)]
    for rid in got:
        assert not got[rid].error_message
        assert got[rid].infer_response.parameters[
            "triton_final_response"].bool_param
        assert _wire(got[rid]) == _wire(want[rid])


def _bad_shape():
    """Bytes that fill the shape, dims the model does not take."""
    req = _simple_request("simple", typed=False)
    for t in req.inputs:
        t.shape[:] = [1, 32]
    return req


def _shm(where):
    req = _simple_request("simple", typed=False)
    target = req.inputs[0] if where == "input" else req.outputs.add(
        name="OUTPUT0")
    grpc_codec.set_param(target.parameters, "shared_memory_region", "r0")
    grpc_codec.set_param(target.parameters, "shared_memory_byte_size", 128)
    return req


def _wrong_dtype():
    req = pb.ModelInferRequest(model_name="simple")
    for key in ("INPUT0", "INPUT1"):
        req.inputs.add(name=key, datatype="FP32", shape=[1, 16])
        req.raw_input_contents.append(np.zeros((1, 16), np.float32).tobytes())
    return req


def _too_many_rows():
    req = pb.ModelInferRequest(model_name="simple_int8")
    for key in ("INPUT0", "INPUT1"):
        req.inputs.add(name=key, datatype="INT8", shape=[9, 16])
        req.raw_input_contents.append(bytes(9 * 16))
    return req


def _wrong_rank():
    req = _simple_request("simple", typed=False)
    for t in req.inputs:
        t.shape[:] = [2, 4, 4]
    return req


@pytest.mark.parametrize("make", [
    lambda: pb.ModelInferRequest(model_name="no_such_model"),
    _bad_shape,
    lambda: _shm("input"),
    lambda: _shm("output"),
    _wrong_dtype,
    _too_many_rows,
    _wrong_rank,
], ids=["unknown_model", "shape", "shm_input", "shm_output", "dtype",
        "batch", "rank"])
def test_errors_equal_jax(servers, make):
    codes = []
    for stub in (servers.port, servers.jax):
        with pytest.raises(grpc.RpcError) as exc:
            stub.ModelInfer(make(), timeout=TIMEOUT)
        codes.append((exc.value.code(), exc.value.details()))
    assert codes[0] == codes[1]
    assert codes[0][0] in (grpc.StatusCode.NOT_FOUND,
                           grpc.StatusCode.INVALID_ARGUMENT)


def test_raw_bytes_that_miss_the_shape_are_internal_on_both(servers):
    """The same code and the same words: both codecs pass numpy's reshape
    error through."""
    req = _simple_request("simple", typed=False)
    req.inputs[0].shape[:] = [2, 15]
    codes = []
    for stub in (servers.port, servers.jax):
        with pytest.raises(grpc.RpcError) as exc:
            stub.ModelInfer(req, timeout=TIMEOUT)
        codes.append((exc.value.code(), exc.value.details()))
    assert codes[0] == codes[1]
    assert codes[0][0] == grpc.StatusCode.INTERNAL
    assert "reshape" in codes[0][1]


def test_metadata_of_an_unknown_model_equals_jax(servers):
    codes = []
    for stub in (servers.port, servers.jax):
        for rpc, msg in (("ModelMetadata", pb.ModelMetadataRequest),
                         ("ModelConfig", pb.ModelConfigRequest),
                         ("ModelStatistics", pb.ModelStatisticsRequest)):
            with pytest.raises(grpc.RpcError) as exc:
                getattr(stub, rpc)(msg(name="nope"), timeout=TIMEOUT)
            codes.append((rpc, exc.value.code(), exc.value.details()))
    assert codes[:3] == codes[3:]
    assert codes[0][1] == grpc.StatusCode.NOT_FOUND


def _answer(stub, rpc, request):
    """A response's deterministic bytes, or the error's code and words."""
    try:
        return ("ok", _wire(getattr(stub, rpc)(request, timeout=TIMEOUT)))
    except grpc.RpcError as exc:
        return ("error", exc.code(), exc.details())


def test_an_rpc_the_port_lacks_is_unimplemented(servers):
    """Kept under the name it had while ``RepositoryModelLoad`` answered
    UNIMPLEMENTED: every RPC of the core service is served now, and the
    last two, ``RepositoryModelUnload`` and ``RepositoryModelLoad``, unload
    and reload ``simple`` as the JAX server does, step for step (a load
    with parameters is still UNIMPLEMENTED, in the JAX server's words)."""
    served = [n for n, *_ in grpc_stub._METHODS if n in vars(_Servicer)]
    assert served == [n for n, *_ in grpc_stub._METHODS]
    unload = pb.RepositoryModelUnloadRequest(model_name="simple")
    load = pb.RepositoryModelLoadRequest(model_name="simple")
    with_params = pb.RepositoryModelLoadRequest(model_name="simple")
    with_params.parameters["config"].string_param = "{}"
    steps = [
        ("RepositoryModelUnload", unload),
        ("ModelReady", pb.ModelReadyRequest(name="simple")),
        ("ModelInfer", _simple_request("simple", typed=False)),
        ("ModelMetadata", pb.ModelMetadataRequest(name="simple")),
        ("RepositoryModelLoad", with_params),
        ("RepositoryModelUnload",
         pb.RepositoryModelUnloadRequest(model_name="no_such_model")),
        ("RepositoryModelLoad",
         pb.RepositoryModelLoadRequest(model_name="no_such_model")),
        ("RepositoryModelLoad", load),
        ("ModelReady", pb.ModelReadyRequest(name="simple")),
        ("ModelInfer", _simple_request("simple", typed=False)),
        ("RepositoryModelLoad", load),  # a reload with nothing new
    ]
    answers = {"port": [], "jax": []}
    try:
        for side in answers:
            stub = getattr(servers, side)
            for rpc, request in steps:
                answers[side].append(_answer(stub, rpc, request))
                if rpc == "RepositoryModelUnload" and side == "port" \
                        and request.model_name == "simple":
                    index = servers.port.RepositoryIndex(
                        pb.RepositoryIndexRequest(), timeout=TIMEOUT)
                    row = [m for m in index.models if m.name == "simple"]
                    assert [(m.version, m.state, m.reason) for m in row] \
                        == [("1", "UNAVAILABLE", "unloaded")]
    finally:
        for stub in (servers.port, servers.jax):
            stub.RepositoryModelLoad(load, timeout=TIMEOUT)
    assert answers["port"] == answers["jax"]
    assert [a[0] for a in answers["port"]] == [
        "ok", "ok", "error", "error", "error", "error", "error", "ok", "ok",
        "ok", "ok"]
    assert answers["port"][4][1] == grpc.StatusCode.UNIMPLEMENTED
    assert answers["port"][2][1:] == (grpc.StatusCode.INVALID_ARGUMENT,
                                      "model 'simple' is not ready")


# -- a small BERT over ModelInfer -----------------------------------------------

@pytest.mark.parametrize("typed", [False, True], ids=["raw", "typed"])
def test_bert_over_model_infer_equals_a_direct_call(servers, typed):
    engine, port = servers.engine, servers.port
    rng = np.random.default_rng(5)
    ids = rng.integers(0, SMALL_BERT["vocab"], (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 20:] = 0
    req = pb.ModelInferRequest(model_name="bert_small")
    for key, arr in (("input_ids", ids), ("attention_mask", mask)):
        t = req.inputs.add(name=key, datatype="INT32", shape=[2, 32])
        if typed:
            t.contents.int_contents.extend(arr.ravel().tolist())
        else:
            req.raw_input_contents.append(arr.tobytes())
    req.outputs.add(name="logits")
    resp = port.ModelInfer(req, timeout=TIMEOUT)
    assert [t.name for t in resp.outputs] == ["logits"]
    got = np.frombuffer(resp.raw_output_contents[0], np.float32).reshape(
        list(resp.outputs[0].shape))
    backend = engine.repository.get("bert_small").backend
    with torch.inference_mode():
        want = backend({"input_ids": torch.from_numpy(ids),
                        "attention_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(got, want["logits"].numpy(), rtol=0, atol=1e-5)


def test_classification_over_grpc_is_top_k_bytes(servers):
    engine, port = servers.engine, servers.port
    ids = np.arange(64, dtype=np.int32).reshape(2, 32)
    mask = np.ones((2, 32), np.int32)
    req = pb.ModelInferRequest(model_name="bert_small")
    for key, arr in (("input_ids", ids), ("attention_mask", mask)):
        req.inputs.add(name=key, datatype="INT32", shape=[2, 32])
        req.raw_input_contents.append(arr.tobytes())
    out = req.outputs.add(name="pooled_output")
    grpc_codec.set_param(out.parameters, "classification", 3)
    resp = port.ModelInfer(req, timeout=TIMEOUT)
    assert resp.outputs[0].datatype == "BYTES"
    assert list(resp.outputs[0].shape) == [2, 3]
    got = grpc_codec.tensor_to_ndarray(resp.outputs[0],
                                       resp.raw_output_contents[0])
    backend = engine.repository.get("bert_small").backend
    with torch.inference_mode():
        pooled = backend({"input_ids": torch.from_numpy(ids),
                          "attention_mask": torch.from_numpy(mask)})[
            "pooled_output"].numpy()
    top = np.argsort(-pooled, axis=1)[:, :3]
    assert [[int(e.decode().split(":")[1]) for e in row] for row in got] \
        == top.tolist()


# -- TLS ------------------------------------------------------------------------

def test_tls_endpoint_serves_grpcs(servers, tmp_path):
    """certfile and keyfile give a TLS endpoint; a client that trusts the
    self-signed certificate gets the same answer as over plain gRPC."""
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "2", "-nodes", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    server = GrpcInferenceServer(servers.engine, port=0, certfile=cert,
                                 keyfile=key).start()
    try:
        with open(cert, "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        with grpc.secure_channel(f"localhost:{server.port}",
                                 creds) as channel:
            got = grpc_stub.GRPCInferenceServiceStub(channel).ModelInfer(
                _simple_request("simple", typed=False), timeout=TIMEOUT)
    finally:
        server.stop()
    want = servers.port.ModelInfer(_simple_request("simple", typed=False),
                                   timeout=TIMEOUT)
    assert _wire(got) == _wire(want)


def test_tls_needs_the_key(servers, tmp_path):
    with pytest.raises(ValueError, match="keyfile"):
        GrpcInferenceServer(servers.engine, port=0,
                            certfile=str(tmp_path / "cert.pem"))


# -- the example clients and the launcher --------------------------------------

@pytest.mark.parametrize("script", [
    "simple_grpc_infer_client.py", "simple_grpc_string_infer_client.py",
    "grpc_explicit_int8_content_client.py"])
def test_example_clients_pass_against_the_port(servers, script):
    url = servers.server.url
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "python", script),
         "-u", url], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, f"{proc.stdout}{proc.stderr}"
    assert "PASS" in proc.stdout, proc.stdout


def test_the_launcher_serves_both_frontends():
    """``python -m client_tpu_torch.server`` starts HTTP and gRPC on one
    engine; SIGTERM stops it with exit code 0."""
    import http.client

    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--zoo", "simple",
         "--device", "cpu", "--host", "127.0.0.1", "--http-port", "0",
         "--grpc-port", "0"], cwd=REPO, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        urls = {}
        while len(urls) < 2:
            line = proc.stderr.readline()
            assert line, f"launcher exited: {proc.wait(timeout=30)}"
            m = re.match(r"serving (http|grpc) at (\S+)", line)
            if m:
                urls[m.group(1)] = m.group(2)
        conn = http.client.HTTPConnection(urls["http"], timeout=TIMEOUT)
        conn.request("GET", "/v2/models/simple/ready")
        assert conn.getresponse().status == 200
        conn.close()
        with grpc.insecure_channel(urls["grpc"]) as channel:
            stub = grpc_stub.GRPCInferenceServiceStub(channel)
            resp = stub.ModelInfer(_simple_request("simple", typed=True),
                                   timeout=TIMEOUT)
        a, b = _simple_inputs("simple").values()
        assert np.frombuffer(resp.raw_output_contents[0], np.int32).tolist() \
            == (a + b).ravel().tolist()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


def test_the_launcher_refuses_to_serve_nothing():
    from client_tpu_torch.server.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["--no-http", "--no-grpc", "--device", "cpu"])
    assert exc.value.code == 2
