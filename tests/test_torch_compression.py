"""HTTP compression both ways on the port's server, held against the JAX
server.

A request body sent with ``Content-Encoding: gzip`` or ``deflate`` is
decoded before the route reads it; an answer is compressed at level 1
when the client's ``Accept-Encoding`` names one; another encoding
answers 415 with the JAX server's words. Each package's HTTP client,
with ``request_compression_algorithm`` and
``response_compression_algorithm`` each set to ``gzip``, ``deflate`` or
nothing, gets the same outputs from both servers.
"""

import gzip
import http.client
import json
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

TIMEOUT = 60  # seconds, every wait
ALGOS = [None, "gzip", "deflate"]


@pytest.fixture(scope="module")
def servers():
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import HttpInferenceServer

    sides = {}
    for name, engine, cls in (
            ("port", TorchEngine(build_repository(["simple"]), device="cpu"),
             HttpInferenceServer),
            ("jax", TpuEngine(jax_build(["simple"])), JaxHttp)):
        sides[name] = SimpleNamespace(engine=engine,
                                      http=cls(engine, port=0).start())
    yield sides
    for side in sides.values():
        side.http.stop()
        side.engine.shutdown()


def _client_infer(mod, url, request_algo, response_algo):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    client = mod.InferenceServerClient(url)
    try:
        inputs = []
        for i, name in enumerate(("INPUT0", "INPUT1")):
            inp = mod.InferInput(name, [1, 16], "INT32")
            inp.set_data_from_numpy(a * (i + 2))
            inputs.append(inp)
        result = client.infer(
            "simple", inputs,
            request_compression_algorithm=request_algo,
            response_compression_algorithm=response_algo)
        return {n: result.as_numpy(n).tolist()
                for n in ("OUTPUT0", "OUTPUT1")}
    finally:
        client.close()


@pytest.mark.parametrize("response_algo", ALGOS)
@pytest.mark.parametrize("request_algo", ALGOS)
@pytest.mark.parametrize("client", ["port", "jax"])
def test_each_client_compresses_both_ways_against_both_servers(
        servers, client, request_algo, response_algo):
    import client_tpu.http as jax_http
    import client_tpu_torch.http as port_http

    mod = port_http if client == "port" else jax_http
    got = {name: _client_infer(mod, side.http.url, request_algo,
                               response_algo)
           for name, side in servers.items()}
    assert got["port"] == got["jax"]
    a = np.arange(16)
    assert got["port"]["OUTPUT0"] == [(2 * a + 3 * a).tolist()]
    assert got["port"]["OUTPUT1"] == [(2 * a - 3 * a).tolist()]


def _raw(side, body: bytes, headers: dict):
    conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                      timeout=TIMEOUT)
    try:
        conn.request("POST", "/v2/models/simple/infer", body,
                     dict({"Content-Type": "application/json"}, **headers))
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Content-Encoding"),
                resp.read())
    finally:
        conn.close()


def _body() -> bytes:
    a = np.arange(16, dtype=np.int32)
    return json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": a.tolist()} for n in ("INPUT0", "INPUT1")]}).encode()


@pytest.mark.parametrize("accept,decode", [
    ("gzip", gzip.decompress), ("deflate", zlib.decompress)])
def test_the_answer_is_compressed_at_level_1(servers, accept, decode):
    """The same compressed bytes from both servers: level 1 of the same
    codec over the same JSON."""
    got = {name: _raw(side, _body(), {"Accept-Encoding": accept})
           for name, side in servers.items()}
    assert got["port"] == got["jax"]
    status, encoding, payload = got["port"]
    assert (status, encoding) == (200, accept)
    assert json.loads(decode(payload))["outputs"][0]["name"] == "OUTPUT0"


@pytest.mark.parametrize("encoding", ["br", "zstd", "identity"])
def test_an_unknown_encoding_answers_415_in_the_jax_servers_words(
        servers, encoding):
    got = {name: _raw(side, _body(), {"Content-Encoding": encoding})
           for name, side in servers.items()}
    assert got["port"] == got["jax"]
    status, _, payload = got["port"]
    assert status == 415
    assert json.loads(payload) == {
        "error": f"unsupported Content-Encoding '{encoding}'"}


@pytest.mark.parametrize("encoding", ["gzip", "deflate"])
def test_a_corrupt_compressed_body_answers_400(servers, encoding):
    statuses = {name: _raw(side, b"not compressed",
                           {"Content-Encoding": encoding})[0]
                for name, side in servers.items()}
    assert statuses == {"port": 400, "jax": 400}
