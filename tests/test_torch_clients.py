"""The port's clients against the JAX package's, on both packages' servers.

The matrix is {``client_tpu.http`` / ``client_tpu.grpc``,
``client_tpu_torch.http`` / ``client_tpu_torch.grpc``} x {the JAX server,
the port's server}. Each server (HTTP and gRPC from one engine) serves
``simple``, ``simple_string``, ``simple_sequence``, ``simple_repeat`` and a
narrow ``tiny_gpt`` ("tg"). Each case, taken from ``tests/test_http_e2e.py``
and ``tests/test_grpc_e2e.py``, runs once with the JAX client to warm the
server (a first call per bucket pays a compile on the JAX server and a cold
first execution on the port's, which ``InferStat`` counts as a cold
start; each engine's buckets for batches of 1 to 8 are warmed first, so
dynamic batching cannot reach a cold one in one run and not the other),
then once with each client on fresh client objects. The
two runs must give equal outputs, equal exceptions (class name,
``status()``, message and ``retry_after_s``) and equal ``InferStat``
counts. Trace ids are random per request, so a result is compared by the
form of its trace id, never its value.

What the port's server lacks answers alike for both clients: HTTP
compression (415). The repository cases (load and unload over HTTP and
gRPC) unload and reload a model on the port's server as on the JAX
server. The shared-memory cases use each package's own
utilities on segments of the same names, keyed by the test process.
"""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import client_tpu.grpc as jax_grpc
import client_tpu.http as jax_http
import client_tpu.utils as jax_utils
import client_tpu.utils.shared_memory as jax_shm
import client_tpu.utils.tpu_shared_memory as jax_devshm
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.http as port_http
import client_tpu_torch.utils as port_utils
import client_tpu_torch.utils.cuda_shared_memory as port_devshm
import client_tpu_torch.utils.shared_memory as port_shm

TIMEOUT = 60  # seconds, every wait
GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=64, max_streams=4)
MODELS = ["simple", "simple_string", "simple_sequence", "simple_repeat"]
# System shm keys are unique to the test process: /dev/shm is shared by
# every suite that runs on the machine at the same time.
CL_IN_KEY, CL_OUT_KEY = f"/cl_in_{os.getpid()}", f"/cl_out_{os.getpid()}"
GCL_IN_KEY, GCL_OUT_KEY = f"/gcl_in_{os.getpid()}", f"/gcl_out_{os.getpid()}"
STAT_KEYS = ("completed_request_count", "reported_request_count",
             "retry_count", "stale_socket_retry_count",
             "breaker_rejected_count", "cold_start_count")
ERRORS = (jax_utils.InferenceServerException,
          port_utils.InferenceServerException)

JAX = SimpleNamespace(name="jax", http=jax_http, grpc=jax_grpc,
                      shm=jax_shm, devshm=jax_devshm)
PORT = SimpleNamespace(name="port", http=port_http, grpc=port_grpc,
                       shm=port_shm, devshm=port_devshm)


@pytest.fixture(scope="module")
def servers():
    """Each package's engine behind its HTTP and gRPC servers on port 0,
    with the JAX engine's buckets warmed for the batch sizes used here."""
    from client_tpu.engine import InferRequest as JaxRequest
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.models.generate import TinyGptBackend as JaxGpt
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttpServer
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    repo = build_repository(MODELS)
    repo.register("tg", lambda device: TinyGptBackend(
        name="tg", device=device, **GPT))
    jax_repo = jax_build(MODELS)
    jax_repo.register_backend(JaxGpt(name="tg", attn_impl="reference", **GPT))
    jax_engine = TpuEngine(jax_repo)
    for rows in range(1, 9):
        a = np.zeros((rows, 16), np.int32)
        jax_engine.infer(JaxRequest(model_name="simple", inputs={
            "INPUT0": a, "INPUT1": a}), timeout_s=TIMEOUT)
        s = np.full((rows, 16), b"1", dtype=np.object_)
        jax_engine.infer(JaxRequest(model_name="simple_string", inputs={
            "INPUT0": s, "INPUT1": s}), timeout_s=TIMEOUT)
    # The port's server marks a bucket's first execution cold as well (a
    # Server-Timing `compile` entry), so its buckets are warmed alike.
    from client_tpu_torch.engine import InferRequest

    port_engine = TorchEngine(repo, device="cpu")
    for rows in range(1, 9):
        a = np.zeros((rows, 16), np.int32)
        port_engine.infer(InferRequest(model_name="simple", inputs={
            "INPUT0": a, "INPUT1": a}), timeout_s=TIMEOUT)
        s = np.full((rows, 16), b"1", dtype=np.object_)
        port_engine.infer(InferRequest(model_name="simple_string", inputs={
            "INPUT0": s, "INPUT1": s}), timeout_s=TIMEOUT)
    sides = {}
    for name, engine, http_cls, grpc_cls in (
            ("port", port_engine, HttpInferenceServer, GrpcInferenceServer),
            ("jax", jax_engine, JaxHttpServer, JaxGrpc)):
        sides[name] = SimpleNamespace(
            engine=engine, http=http_cls(engine, port=0).start(),
            grpc=grpc_cls(engine, port=0).start())
    yield sides
    for side in sides.values():
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _err(exc) -> tuple:
    return ("error", type(exc).__name__, exc.status(), exc.message(),
            getattr(exc, "retry_after_s", None))


def _answer(fn):
    try:
        return ("ok", fn())
    except ERRORS as exc:
        return _err(exc)


def _plain(value):
    """A proto as its deterministic bytes; anything else as it is."""
    if hasattr(value, "SerializeToString"):
        return value.SerializeToString(deterministic=True).hex()
    return value


def _trace_form(trace_id):
    return None if trace_id is None else (len(trace_id), trace_id == "")


def _digest(result) -> dict:
    """An HTTP or gRPC ``InferResult`` as comparable values."""
    resp = result.get_response()
    if isinstance(resp, dict):
        names = [o["name"] for o in resp.get("outputs", [])]
        head = {k: resp.get(k) for k in ("id", "model_name", "model_version")}
    else:
        names = [o.name for o in resp.outputs]
        head = {"id": resp.id, "model_name": resp.model_name,
                "model_version": resp.model_version}
    outs = {}
    for n in names:
        arr = result.as_numpy(n)
        outs[n] = None if arr is None else (str(arr.dtype), arr.tolist())
    return {"head": head, "outputs": outs,
            "trace": _trace_form(result.trace_id()),
            "timing": sorted(result.server_timing())}


def _simple_inputs(mod, batch=1, b_value=1):
    a = np.arange(16 * batch, dtype=np.int32).reshape(batch, 16)
    b = np.full((batch, 16), b_value, dtype=np.int32)
    i0 = mod.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a)
    i1 = mod.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b)
    return [i0, i1]


# ---------------------------------------------------------------------------
# HTTP cases (``tests/test_http_e2e.py``)
# ---------------------------------------------------------------------------

HTTP_CASES = {}


def http_case(fn):
    HTTP_CASES[fn.__name__] = fn
    return fn


@http_case
def live_ready(pkg, c):
    return [c.is_server_live(), c.is_server_ready(),
            c.is_model_ready("simple"), c.is_model_ready("missing_model")]


@http_case
def metadata(pkg, c):
    return [_answer(c.get_server_metadata),
            _answer(lambda: c.get_model_metadata("simple")),
            _answer(lambda: c.get_model_metadata("simple", "1")),
            _answer(lambda: c.get_model_metadata("missing_model"))]


@http_case
def config(pkg, c):
    return [_answer(lambda: c.get_model_config(m)) for m in MODELS]


@http_case
def repository(pkg, c):
    log = [_answer(c.get_model_repository_index)]
    log.append(_answer(lambda: c.unload_model("simple_string")))
    log.append(c.is_model_ready("simple_string"))
    log.append(_answer(lambda: c.load_model("simple_string")))
    log.append(c.is_model_ready("simple_string"))
    return log


@http_case
def statistics(pkg, c):
    def shape(stats):
        return [(s["name"], s["version"], sorted(s)) for s in
                stats["model_stats"]]
    return [_answer(lambda: shape(c.get_inference_statistics("simple"))),
            _answer(lambda: shape(c.get_inference_statistics())),
            _answer(lambda: c.get_inference_statistics("missing_model"))]


@http_case
def binary(pkg, c):
    return _digest(c.infer("simple", _simple_inputs(pkg.http),
                           request_id="req-1"))


@http_case
def json_tensors(pkg, c):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 3, dtype=np.int32)
    i0 = pkg.http.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a, binary_data=False)
    i1 = pkg.http.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b, binary_data=False)
    outs = [pkg.http.InferRequestedOutput("OUTPUT0", binary_data=False)]
    result = c.infer("simple", [i0, i1], outputs=outs)
    return [_digest(result), result.get_output("OUTPUT0"),
            result.get_output("OUTPUT1")]


@http_case
def requested_outputs(pkg, c):
    outs = [pkg.http.InferRequestedOutput("OUTPUT1")]
    return _digest(c.infer("simple", _simple_inputs(pkg.http), outputs=outs))


@http_case
def string_model(pkg, c):
    a = np.array([[str(i).encode() for i in range(16)]], dtype=np.object_)
    b = np.array([[b"1"] * 16], dtype=np.object_)
    i0 = pkg.http.InferInput("INPUT0", [1, 16], "BYTES")
    i0.set_data_from_numpy(a)
    i1 = pkg.http.InferInput("INPUT1", [1, 16], "BYTES")
    i1.set_data_from_numpy(b, binary_data=False)
    return _digest(c.infer("simple_string", [i0, i1]))


@http_case
def async_infer(pkg, c):
    inputs = _simple_inputs(pkg.http)
    handles = [c.async_infer("simple", inputs) for _ in range(8)]
    return [_digest(h.get_result(timeout=TIMEOUT)) for h in handles]


@http_case
def compression(pkg, c):
    inputs = _simple_inputs(pkg.http, batch=4)
    return [_answer(lambda: _digest(c.infer(
        "simple", inputs, request_compression_algorithm=req,
        response_compression_algorithm=resp)))
        for req, resp in (("gzip", "gzip"), ("deflate", "deflate"),
                          (None, "gzip"), (None, "deflate"))]


@http_case
def sequence(pkg, c):
    outs = []
    vals = [4, 6, 1]
    for i, v in enumerate(vals):
        inp = pkg.http.InferInput("INPUT", [1], "INT32")
        inp.set_data_from_numpy(np.array([v], dtype=np.int32))
        outs.append(_digest(c.infer(
            "simple_sequence", [inp], sequence_id=77,
            sequence_start=(i == 0), sequence_end=(i == len(vals) - 1))))
    return outs


@http_case
def errors(pkg, c):
    bad = np.zeros((1, 4), dtype=np.int32)
    i0 = pkg.http.InferInput("INPUT0", [1, 4], "INT32")
    i0.set_data_from_numpy(bad)
    i1 = pkg.http.InferInput("INPUT1", [1, 4], "INT32")
    i1.set_data_from_numpy(bad)
    inp = pkg.http.InferInput("IN", [2], "INT32")
    inp.set_data_from_numpy(np.array([1, 2], np.int32))
    return [_answer(lambda: c.infer("simple", [i0, i1])),
            _answer(lambda: c.infer("missing_model", [i0, i1])),
            _answer(lambda: c.infer("simple", _simple_inputs(pkg.http),
                                    model_version="abc")),
            _answer(lambda: c.infer("simple", _simple_inputs(pkg.http),
                                    model_version="2")),
            _answer(lambda: c.infer("simple_repeat", [inp])),
            _answer(lambda: c.async_infer("missing_model", [i0, i1])
                    .get_result(timeout=TIMEOUT))]


@http_case
def statics(pkg, c):
    """``generate_request_body`` and ``parse_response_body`` need no
    server: both packages give the same bytes and parse them alike."""
    inputs = _simple_inputs(pkg.http)
    body, jlen = pkg.http.InferenceServerClient.generate_request_body(
        inputs, request_id="s", sequence_id=5, sequence_start=True,
        priority=2, timeout=100, parameters={"k": "v"})
    json_body, none_len = pkg.http.InferenceServerClient \
        .generate_request_body(inputs[:0])
    result = c.infer("simple", inputs)
    parsed = pkg.http.InferenceServerClient.parse_response_body(
        body, header_length=jlen)
    return [body.hex(), jlen, json_body.hex(), none_len, _digest(result),
            parsed.get_response()]


@http_case
def client_side_errors(pkg, c):
    """Errors raised before any request leaves."""
    def wrong_dtype():
        pkg.http.InferInput("X", [2], "INT32").set_data_from_numpy(
            np.zeros(2, np.float32))

    def wrong_shape():
        pkg.http.InferInput("X", [2], "INT32").set_data_from_numpy(
            np.zeros(3, np.int32))

    def not_numpy():
        pkg.http.InferInput("X", [2], "INT32").set_data_from_numpy([1, 2])

    def ssl():
        pkg.http.InferenceServerClient("localhost:1", ssl=True)

    def no_url():
        pkg.http.InferenceServerClient("")

    return [_answer(f) for f in (wrong_dtype, wrong_shape, not_numpy, ssl,
                                 no_url)]


@http_case
def system_shm(pkg, c):
    """Inputs and outputs in system shm segments made with the package's
    own utilities (the same names and keys in both runs of a case)."""
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 2, dtype=np.int32)
    hin = pkg.shm.create_shared_memory_region("cl_in", CL_IN_KEY, 128)
    hout = pkg.shm.create_shared_memory_region("cl_out", CL_OUT_KEY, 128)
    log = []
    try:
        pkg.shm.set_shared_memory_region(hin, [a, b])
        log.append(_answer(lambda: c.register_system_shared_memory(
            "cl_in", CL_IN_KEY, 128)))
        log.append(_answer(lambda: c.register_system_shared_memory(
            "cl_out", CL_OUT_KEY, 128)))
        log.append(_answer(lambda: c.register_system_shared_memory(
            "cl_in", CL_IN_KEY, 128)))
        log.append(_answer(c.get_system_shared_memory_status))
        log.append(_answer(lambda: c.get_system_shared_memory_status(
            "cl_out")))
        i0 = pkg.http.InferInput("INPUT0", [1, 16], "INT32")
        i0.set_shared_memory("cl_in", 64)
        i1 = pkg.http.InferInput("INPUT1", [1, 16], "INT32")
        i1.set_shared_memory("cl_in", 64, offset=64)
        o0 = pkg.http.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory("cl_out", 64)
        o1 = pkg.http.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory("cl_out", 64, offset=64)
        log.append(_digest(c.infer("simple", [i0, i1], outputs=[o0, o1])))
        log.append(pkg.shm.get_contents_as_numpy(
            hout, np.int32, (2, 16)).tolist())
        log.append(_answer(lambda: c.unregister_system_shared_memory(
            "cl_in")))
        log.append(_answer(lambda: c.infer("simple", [i0, i1])))
        log.append(_answer(c.get_system_shared_memory_status))
    finally:
        _answer(c.unregister_system_shared_memory)
        pkg.shm.destroy_shared_memory_region(hin)
        pkg.shm.destroy_shared_memory_region(hout)
    return log


def _device_case(pkg, c, mod):
    """Device regions by handle (host-staged on the port's server),
    registered on the tpu route and its cuda alias."""
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    hin = pkg.devshm.create_shared_memory_region("cl_din", 128)
    hout = pkg.devshm.create_shared_memory_region("cl_dout", 128)
    log = []
    try:
        pkg.devshm.set_shared_memory_region(hin, [a, a])
        log.append(_answer(lambda: c.register_tpu_shared_memory(
            "cl_din", pkg.devshm.get_raw_handle(hin), 0, 128)))
        log.append(_answer(lambda: c.register_cuda_shared_memory(
            "cl_dout", pkg.devshm.get_raw_handle(hout), 0, 128)))
        log.append(_answer(lambda: _plain(c.get_cuda_shared_memory_status())))
        i0 = mod.InferInput("INPUT0", [1, 16], "INT32")
        i0.set_shared_memory("cl_din", 64)
        i1 = mod.InferInput("INPUT1", [1, 16], "INT32")
        i1.set_shared_memory("cl_din", 64, offset=64)
        o0 = mod.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory("cl_dout", 64)
        log.append(_digest(c.infer("simple", [i0, i1], outputs=[o0])))
        log.append(pkg.devshm.get_contents_as_numpy(
            hout, np.int32, (1, 16)).tolist())
        log.append(_answer(lambda: c.unregister_tpu_shared_memory(
            "cl_din")))
        log.append(_answer(lambda: c.unregister_cuda_shared_memory()))
    finally:
        pkg.devshm.destroy_shared_memory_region(hin)
        pkg.devshm.destroy_shared_memory_region(hout)
    return log


@http_case
def device_shm(pkg, c):
    return _device_case(pkg, c, pkg.http)


def _stats(c) -> dict:
    stat = c.get_infer_stat()
    return {k: stat[k] for k in STAT_KEYS}


def _run_http(pkg, side, case):
    c = pkg.http.InferenceServerClient(side.http.url, concurrency=4)
    try:
        return HTTP_CASES[case](pkg, c), _stats(c)
    finally:
        c.close()


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
@pytest.mark.parametrize("server", ["port", "jax"])
def test_http_client_equals_jax(servers, server, case):
    side = servers[server]
    _run_http(JAX, side, case)  # warm the server
    ref = _run_http(JAX, side, case)
    port = _run_http(PORT, side, case)
    assert port == ref


# ---------------------------------------------------------------------------
# gRPC cases (``tests/test_grpc_e2e.py``)
# ---------------------------------------------------------------------------

GRPC_CASES = {}


def grpc_case(fn):
    GRPC_CASES[fn.__name__] = fn
    return fn


def _proto(msg):
    return msg.SerializeToString(deterministic=True).hex()


@grpc_case
def g_live_ready(pkg, c):
    return [c.is_server_live(), c.is_server_ready(),
            c.is_model_ready("simple"), _answer(
                lambda: c.is_model_ready("ghost"))]


@grpc_case
def g_metadata(pkg, c):
    return [_proto(c.get_server_metadata()),
            c.get_server_metadata(as_json=True),
            _proto(c.get_model_metadata("simple")),
            c.get_model_metadata("simple", as_json=True),
            _answer(lambda: c.get_model_metadata("ghost")),
            _answer(lambda: c.get_model_metadata("simple", "0"))]


@grpc_case
def g_config(pkg, c):
    return [_answer(lambda: _proto(c.get_model_config(m)))
            for m in MODELS + ["ghost"]]


@grpc_case
def g_repository(pkg, c):
    return [_proto(c.get_model_repository_index()),
            _answer(lambda: c.unload_model("simple_string")),
            c.is_model_ready("simple_string"),
            _answer(lambda: c.load_model("simple_string")),
            c.is_model_ready("simple_string")]


@grpc_case
def g_statistics(pkg, c):
    st = c.get_inference_statistics("simple")
    return [[(s.name, s.version) for s in st.model_stats],
            sorted(c.get_inference_statistics(as_json=True)),
            _answer(lambda: c.get_inference_statistics("ghost"))]


@grpc_case
def g_raw(pkg, c):
    return _digest(c.infer("simple", _simple_inputs(pkg.grpc),
                           request_id="42"))


@grpc_case
def g_typed_contents(pkg, c):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 5, dtype=np.int32)
    i0 = pkg.grpc.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a, use_contents=True)
    i1 = pkg.grpc.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b, use_contents=True)
    result = c.infer("simple", [i0, i1])
    out = result.get_output("OUTPUT0", as_json=True)
    return [_digest(result), out, result.get_output("missing")]


@grpc_case
def g_requested_outputs(pkg, c):
    outs = [pkg.grpc.InferRequestedOutput("OUTPUT1")]
    return _digest(c.infer("simple", _simple_inputs(pkg.grpc), outputs=outs))


@grpc_case
def g_string_model(pkg, c):
    a = np.array([[b"7"] * 16], dtype=np.object_)
    b = np.array([[b"3"] * 16], dtype=np.object_)
    i0 = pkg.grpc.InferInput("INPUT0", [1, 16], "BYTES")
    i0.set_data_from_numpy(a)
    i1 = pkg.grpc.InferInput("INPUT1", [1, 16], "BYTES")
    i1.set_data_from_numpy(b, use_contents=True)
    return _digest(c.infer("simple_string", [i0, i1]))


def _async(c, model, inputs, **kw):
    done = threading.Event()
    box = []

    def cb(result, error):
        box.append((result, error))
        done.set()

    ctx = c.async_infer(model, inputs, cb, **kw)
    assert done.wait(timeout=TIMEOUT)
    result, error = box[0]
    return [type(ctx).__name__,
            _digest(result) if result is not None else None,
            _err(error) if error is not None else None]


@grpc_case
def g_async_infer(pkg, c):
    return [_async(c, "simple", _simple_inputs(pkg.grpc)),
            _async(c, "ghost", _simple_inputs(pkg.grpc)),
            _async(c, "simple", _simple_inputs(pkg.grpc),
                   compression_algorithm="gzip")]


@grpc_case
def g_errors(pkg, c):
    bad = np.zeros((1, 4), dtype=np.int32)
    i0 = pkg.grpc.InferInput("INPUT0", [1, 4], "INT32")
    i0.set_data_from_numpy(bad)
    i1 = pkg.grpc.InferInput("INPUT1", [1, 4], "INT32")
    i1.set_data_from_numpy(bad)
    inp = pkg.grpc.InferInput("IN", [2], "INT32")
    inp.set_data_from_numpy(np.array([1, 2], np.int32))
    return [_answer(lambda: c.infer("simple", [i0, i1])),
            _answer(lambda: c.infer("simple", _simple_inputs(pkg.grpc),
                                    model_version="-1")),
            _answer(lambda: c.infer("simple", _simple_inputs(pkg.grpc),
                                    model_version="01") and "ok"),
            _answer(lambda: c.infer("simple_repeat", [inp])),
            _answer(lambda: pkg.grpc.InferenceServerClient(
                "localhost:1", ssl=True))]


@grpc_case
def g_compression(pkg, c):
    inputs = _simple_inputs(pkg.grpc, batch=4)
    return [_digest(c.infer("simple", inputs, compression_algorithm=algo))
            for algo in ("gzip", "deflate", "none")]


@grpc_case
def g_sequence(pkg, c):
    outs = []
    for i, v in enumerate([10, 20, 30]):
        inp = pkg.grpc.InferInput("INPUT", [1], "INT32")
        inp.set_data_from_numpy(np.array([v], dtype=np.int32))
        outs.append(_digest(c.infer(
            "simple_sequence", [inp], sequence_id=900,
            sequence_start=(i == 0), sequence_end=(i == 2))))
    return outs


@grpc_case
def g_system_shm(pkg, c):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    hin = pkg.shm.create_shared_memory_region("gcl_in", GCL_IN_KEY, 128)
    hout = pkg.shm.create_shared_memory_region("gcl_out", GCL_OUT_KEY,
                                               128)
    log = []
    try:
        pkg.shm.set_shared_memory_region(hin, [a, a])
        log.append(_answer(lambda: c.register_system_shared_memory(
            "gcl_in", GCL_IN_KEY, 128)))
        log.append(_answer(lambda: c.register_system_shared_memory(
            "gcl_out", GCL_OUT_KEY, 128)))
        log.append(_proto(c.get_system_shared_memory_status()))
        log.append(c.get_system_shared_memory_status("gcl_in", as_json=True))
        i0 = pkg.grpc.InferInput("INPUT0", [1, 16], "INT32")
        i0.set_shared_memory("gcl_in", 64)
        i1 = pkg.grpc.InferInput("INPUT1", [1, 16], "INT32")
        i1.set_shared_memory("gcl_in", 64, offset=64)
        o1 = pkg.grpc.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory("gcl_out", 64, offset=64)
        log.append(_digest(c.infer("simple", [i0, i1], outputs=[o1])))
        log.append(pkg.shm.get_contents_as_numpy(
            hout, np.int32, (2, 16)).tolist())
        o1.unset_shared_memory()
        log.append(_digest(c.infer("simple", [i0, i1], outputs=[o1])))
        log.append(_answer(lambda: c.unregister_system_shared_memory()))
        log.append(_answer(lambda: c.infer("simple", [i0, i1])))
    finally:
        _answer(c.unregister_system_shared_memory)
        pkg.shm.destroy_shared_memory_region(hin)
        pkg.shm.destroy_shared_memory_region(hout)
    return log


@grpc_case
def g_device_shm(pkg, c):
    return _device_case(pkg, c, pkg.grpc)


class _Collector:
    """A stream callback: every (result, error) in arrival order, and a
    semaphore released per callback."""

    def __init__(self):
        self.items = []
        self.sem = threading.Semaphore(0)

    def __call__(self, result, error):
        self.items.append((result, error))
        self.sem.release()

    def wait(self, n):
        for _ in range(n):
            assert self.sem.acquire(timeout=TIMEOUT)

    def digest(self):
        return [(_digest(r) if r is not None else None,
                 _err(e) if e is not None else None) for r, e in self.items]


def _final(result) -> bool:
    params = result.get_response().parameters
    return ("triton_final_response" in params
            and params["triton_final_response"].bool_param)


@grpc_case
def g_stream_basic(pkg, c):
    col = _Collector()
    c.start_stream(col)
    c.async_stream_infer("simple", _simple_inputs(pkg.grpc), request_id="s1")
    col.wait(1)
    c.stop_stream()
    return col.digest()


@grpc_case
def g_stream_decoupled(pkg, c):
    col = _Collector()
    c.start_stream(col)
    inp = pkg.grpc.InferInput("IN", [3], "INT32")
    inp.set_data_from_numpy(np.array([5, 6, 7], dtype=np.int32))
    c.async_stream_infer("simple_repeat", [inp], request_id="d1")
    while not (col.items and col.items[-1][0] is not None
               and _final(col.items[-1][0])):
        col.wait(1)
    c.stop_stream()
    return col.digest()


@grpc_case
def g_stream_sequence(pkg, c):
    col = _Collector()
    c.start_stream(col)
    for i, v in enumerate([2, 4, 8]):
        inp = pkg.grpc.InferInput("INPUT", [1], "INT32")
        inp.set_data_from_numpy(np.array([v], dtype=np.int32))
        c.async_stream_infer("simple_sequence", [inp], sequence_id=777,
                             sequence_start=(i == 0), sequence_end=(i == 2))
    col.wait(3)
    c.stop_stream()
    return col.digest()


@grpc_case
def g_stream_error(pkg, c):
    col = _Collector()
    c.start_stream(col)
    inp = pkg.grpc.InferInput("INPUT0", [1, 16], "INT32")
    inp.set_data_from_numpy(np.zeros((1, 16), dtype=np.int32))
    c.async_stream_infer("ghost", [inp])
    c.async_stream_infer("simple", _simple_inputs(pkg.grpc),
                         model_version="abc")
    col.wait(2)
    c.stop_stream()
    return col.digest()


@grpc_case
def g_stream_generate(pkg, c):
    """Greedy ``tg`` streams, token for token, two requests on one RPC."""
    col = _Collector()
    c.start_stream(col)
    for rid, prompt in (("a", [1, 2, 3]), ("b", [9, 8, 7, 6, 5])):
        inp = pkg.grpc.InferInput("INPUT_IDS", [len(prompt)], "INT32")
        inp.set_data_from_numpy(np.asarray(prompt, np.int32))
        c.async_stream_infer("tg", [inp], request_id=rid,
                             parameters={"max_tokens": 6})
    while sum(r is not None and _final(r) for r, _ in col.items) < 2:
        col.wait(1)
    c.stop_stream()
    by_id = {}
    for r, e in col.items:
        assert e is None, e
        by_id.setdefault(r.get_response().id, []).append(
            r.as_numpy("TOKEN").tolist() if r.get_response().outputs
            else None)
    return sorted(by_id.items())


@grpc_case
def g_stream_lifecycle(pkg, c):
    """Start twice, send after stop, and a stream cancelled with a long
    generation in flight: no callback sees the cancellation."""
    col = _Collector()
    log = [_answer(lambda: c.async_stream_infer(
        "simple", _simple_inputs(pkg.grpc)))]
    c.start_stream(col)
    log.append(_answer(lambda: c.start_stream(col)))
    inp = pkg.grpc.InferInput("INPUT_IDS", [2], "INT32")
    inp.set_data_from_numpy(np.array([1, 2], np.int32))
    c.async_stream_infer("tg", [inp], request_id="long",
                         parameters={"max_tokens": 50})
    col.wait(1)  # the stream is up and generating
    c.stop_stream(cancel_requests=True)
    log.append(all(e is None for _, e in col.items))
    log.append(_answer(lambda: c.async_stream_infer(
        "simple", _simple_inputs(pkg.grpc))))
    c.stop_stream()  # a second stop does nothing
    col2 = _Collector()
    c.start_stream(col2)  # a new stream after the cancelled one
    c.async_stream_infer("simple", _simple_inputs(pkg.grpc), request_id="n")
    col2.wait(1)
    c.stop_stream()
    log.append(col2.digest())
    return log


@grpc_case
def g_keepalive_and_headers(pkg, c):
    ka = pkg.grpc.KeepAliveOptions(keepalive_time_ms=10000,
                                   keepalive_timeout_ms=5000,
                                   keepalive_permit_without_calls=True)
    url = c._endpoints[0][0]
    with pkg.grpc.InferenceServerClient(url, keepalive_options=ka) as c2:
        return [_digest(c2.infer("simple", _simple_inputs(pkg.grpc),
                                 headers={"x-test": "1"},
                                 client_timeout=TIMEOUT)),
                c2.is_server_live(headers={"x-test": "1"})]


def _run_grpc(pkg, side, case):
    c = pkg.grpc.InferenceServerClient(side.grpc.url)
    try:
        return GRPC_CASES[case](pkg, c), _stats(c)
    finally:
        c.close()


@pytest.mark.parametrize("case", sorted(GRPC_CASES))
@pytest.mark.parametrize("server", ["port", "jax"])
def test_grpc_client_equals_jax(servers, server, case):
    side = servers[server]
    _run_grpc(JAX, side, case)  # warm the server
    ref = _run_grpc(JAX, side, case)
    port = _run_grpc(PORT, side, case)
    assert port == ref
