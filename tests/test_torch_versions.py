"""The requested model version, on the port and on the JAX package.

A version is read as the reference reads it (``_parse_version``): empty
means the latest, anything else must be a positive integer, with
surrounding blanks and leading zeros allowed; any other text is a 400
"invalid model version '<v>'", checked before the model's name. Both
engines serve ``simple`` (version 1) and the decoupled ``simple_repeat``;
each version goes to metadata, config, statistics, ready and infer, on
the engines directly, over HTTP (``/versions/<v>``) and over gRPC
(``model_version``). The code and the words must be equal.
"""

import http.client
import json
from types import SimpleNamespace
from urllib.parse import quote

import grpc
import numpy as np
import pytest

from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.repository import _parse_version
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.models import build_repository
from client_tpu_torch.protocol import grpc_codec, grpc_stub
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer

TIMEOUT = 60  # seconds, every request
VERSIONS = ["abc", "0", "-1", "01", " 1 ", "2", "", "1", "+1", "1.0"]
MODELS = ["simple", "simple_repeat", "ghost"]
OPS = ["metadata", "config", "statistics", "ready", "infer"]
A = np.arange(16, dtype=np.int32).reshape(1, 16)


@pytest.fixture(scope="module")
def sides():
    """Each package: one engine with ``simple`` and ``simple_repeat``
    behind HTTP and gRPC on port 0."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp

    names = ["simple", "simple_repeat"]
    out = []
    for engine, http_cls, grpc_cls in (
            (TorchEngine(build_repository(names), device="cpu"),
             HttpInferenceServer, GrpcInferenceServer),
            (TpuEngine(jax_build(names)), JaxHttp, JaxGrpc)):
        out.append(SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_cls(engine, port=0).start()))
    yield SimpleNamespace(port=out[0], jax=out[1])
    for side in out:
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _engine_call(engine, request_cls, op, name, version):
    """(kind, status, words or a digest of the answer)."""
    try:
        if op == "metadata":
            md = engine.model_metadata(name, version)
            return ("ok", md["name"], md["versions"])
        if op == "config":
            return ("ok", engine.model_config(name, version)["name"])
        if op == "statistics":
            stats = engine.model_statistics(name, version)["model_stats"]
            return ("ok", [(s["name"], s["version"]) for s in stats])
        if op == "ready":
            return ("ok", engine.model_is_ready(name, version))
        inputs = ({"IN": np.array([4, 5], np.int32)} if name == "simple_repeat"
                  else {"INPUT0": A, "INPUT1": A})
        resp = engine.infer(request_cls(model_name=name, model_version=version,
                                        inputs=inputs), timeout_s=TIMEOUT)
        return ("ok", {k: np.asarray(v).tolist()
                       for k, v in sorted(resp.outputs.items())})
    except Exception as exc:  # noqa: BLE001 — both engines' EngineError
        return ("error", exc.status, str(exc))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("version", VERSIONS)
def test_engine_answers_alike(sides, version, name, op):
    from client_tpu.engine.types import InferRequest as JaxRequest

    port = _engine_call(sides.port.engine, InferRequest, op, name, version)
    ref = _engine_call(sides.jax.engine, JaxRequest, op, name, version)
    assert port == ref


def _http(server, method, path, body=None):
    host, port = server.url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    try:
        data = json.loads(data) if data else None
    except ValueError:
        pass
    return resp.status, data


_HTTP_SUFFIX = {"metadata": "", "config": "/config", "statistics": "/stats",
                "ready": "/ready", "infer": "/infer"}


def _http_call(server, op, name, version):
    path = f"/v2/models/{name}"
    if version:
        path += f"/versions/{quote(version)}"
    path += _HTTP_SUFFIX[op]
    if op != "infer":
        status, data = _http(server, "GET", path)
    else:
        inputs = ([{"name": "IN", "datatype": "INT32", "shape": [2],
                    "data": [4, 5]}] if name == "simple_repeat" else
                  [{"name": n, "datatype": "INT32", "shape": [1, 16],
                    "data": A.ravel().tolist()} for n in ("INPUT0", "INPUT1")])
        status, data = _http(server, "POST", path,
                             json.dumps({"inputs": inputs}).encode())
    if status != 200 or op == "ready":
        return status, data
    if op == "metadata":
        return status, data["name"], data["versions"]
    if op == "config":
        return status, data["name"]
    if op == "statistics":
        return status, [(s["name"], s["version"]) for s in data["model_stats"]]
    return status, [(o["name"], o["data"]) for o in data["outputs"]]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("version", VERSIONS)
def test_http_answers_alike(sides, version, name, op):
    assert _http_call(sides.port.http, op, name, version) \
        == _http_call(sides.jax.http, op, name, version)


def _grpc_call(server, op, name, version):
    with grpc.insecure_channel(server.url) as channel:
        stub = grpc_stub.GRPCInferenceServiceStub(channel)
        try:
            if op == "metadata":
                md = stub.ModelMetadata(pb.ModelMetadataRequest(
                    name=name, version=version), timeout=TIMEOUT)
                return ("ok", md.name, list(md.versions))
            if op == "config":
                return ("ok", stub.ModelConfig(pb.ModelConfigRequest(
                    name=name, version=version), timeout=TIMEOUT).config.name)
            if op == "statistics":
                st = stub.ModelStatistics(pb.ModelStatisticsRequest(
                    name=name, version=version), timeout=TIMEOUT)
                return ("ok", [(s.name, s.version) for s in st.model_stats])
            if op == "ready":
                return ("ok", stub.ModelReady(pb.ModelReadyRequest(
                    name=name, version=version), timeout=TIMEOUT).ready)
            req = pb.ModelInferRequest(model_name=name, model_version=version)
            if name == "simple_repeat":
                req.inputs.add(name="IN", datatype="INT32", shape=[2])
                req.raw_input_contents.append(
                    np.array([4, 5], np.int32).tobytes())
            else:
                for n in ("INPUT0", "INPUT1"):
                    req.inputs.add(name=n, datatype="INT32", shape=[1, 16])
                    req.raw_input_contents.append(A.tobytes())
            resp = stub.ModelInfer(req, timeout=TIMEOUT)
            return ("ok", [(t.name, grpc_codec.tensor_to_ndarray(
                t, raw).tolist()) for t, raw in
                zip(resp.outputs, resp.raw_output_contents)])
        except grpc.RpcError as exc:
            return ("error", exc.code(), exc.details())


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("version", VERSIONS)
def test_grpc_answers_alike(sides, version, name, op):
    assert _grpc_call(sides.port.grpc, op, name, version) \
        == _grpc_call(sides.jax.grpc, op, name, version)


@pytest.mark.parametrize("version", VERSIONS + [None, 7, -3])
def test_parse_version_equals_the_reference(version):
    from client_tpu.engine.repository import _parse_version as jax_parse
    from client_tpu.engine.types import EngineError as JaxError

    def answer(fn, err):
        try:
            return ("ok", fn(version))
        except err as exc:
            return ("error", exc.status, str(exc))

    assert answer(_parse_version, EngineError) \
        == answer(jax_parse, JaxError)


def test_the_fault_is_fixed(sides):
    """The cases the fault showed: non-integers are 400 with the words,
    and "01" serves version 1."""
    engine = sides.port.engine
    for bad in ("abc", "0", "-1"):
        with pytest.raises(EngineError) as ei:
            engine.model_metadata("simple", bad)
        assert ei.value.status == 400
        assert str(ei.value) == f"invalid model version '{bad}'"
        assert not engine.model_is_ready("simple", bad)
    assert engine.model_is_ready("simple", "01")
    assert engine.model_metadata("simple", "01")["name"] == "simple"
