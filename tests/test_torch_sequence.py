"""The port's sequence batching and decoupled scheduler against the JAX
package's, on the CPU.

- Both sequence schedulers (``direct`` and ``oldest``) take the same
  scripted steps as the JAX engine and must give the same running sums
  (INT32, no tolerance) and the same errors (status and words), restarts,
  capacity and ends included; the idle-GC races the JAX suite encodes
  (``tests/test_engine.py``) are ported case for case.
- The ``sequence_id`` / ``sequence_start`` / ``sequence_end`` parameters
  over HTTP and gRPC (unary and on one stream) against live JAX servers.
- ``simple_repeat`` through the ``DecoupledScheduler``: ``/generate``,
  ``/generate_stream`` and ``ModelStreamInfer`` response for response
  against the JAX servers; writer-paced emits and cancellation.
- The reference's sequence and repeat example clients against the port.
No waits are timed by sleeping, except where a case needs a sequence to go
idle-stale (its idle window is then 50-100 ms).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import grpc
import numpy as np
import pytest
import torch

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.models.simple import SequenceAccumulateBackend as JaxSeq
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.engine.scheduler import DecoupledScheduler
from client_tpu_torch.engine.sequence import (
    OldestSequenceScheduler,
    SequenceScheduler,
)
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.models import build_repository
from client_tpu_torch.models.simple import SequenceAccumulateBackend
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol import grpc_stub

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TIMEOUT = 60
MODELS = ["simple_sequence", "simple_sequence_oldest", "simple_repeat"]


def _engine(name, strategy="direct", device="cpu", **sb):
    """A port engine serving one SequenceAccumulateBackend with the
    sequence-batching fields in ``sb`` changed."""
    backend = SequenceAccumulateBackend(name=name, strategy=strategy)
    for k, v in sb.items():
        setattr(backend.config.sequence_batching, k, v)
    repo = ModelRepository()
    repo.register(name, lambda device: backend)
    return TorchEngine(repo, device=device)


def _jax_engine(name, strategy="direct", **sb):
    backend = JaxSeq(name=name, strategy=strategy)
    for k, v in sb.items():
        setattr(backend.config.sequence_batching, k, v)
    repo = JaxRepository()
    repo.register_backend(backend)
    return TpuEngine(repo)


def _step(engine, make, model, sid, value, start=False, end=False):
    """A step's running sum, or (status, words) of its error."""
    try:
        resp = engine.infer(make(
            model_name=model, inputs={"INPUT": np.array([value], np.int32)},
            sequence_id=sid, sequence_start=start, sequence_end=end),
            timeout_s=TIMEOUT)
    except Exception as exc:  # noqa: BLE001 — compared below
        return (exc.status, str(exc))
    return int(resp.outputs["OUTPUT"][0])


# (sequence id, value, start, end) steps, run in order on both engines.
SCRIPTS = {
    "one": [(1, 5, True, False), (1, 3, False, False), (1, 2, False, False),
            (1, 10, False, True)],
    "interleaved": [(1, 1, True, False), (2, 100, True, False),
                    (1, 1, False, True), (2, 100, False, True)],
    "restart": [(55, 4, True, False), (55, 10, True, False),
                (55, 1, False, True)],
    "errors": [(0, 1, True, False), (999, 1, False, False),
               (3, 7, True, True), (3, 1, False, False),
               (4, 2147483647, True, False), (4, 1, False, True)],
    "capacity": [(1, 1, True, False), (2, 2, True, False),
                 (3, 3, True, False), (1, 9, False, True),
                 (3, 3, True, False), (3, 1, False, True),
                 (2, 1, False, True)],
}


@pytest.mark.parametrize("strategy", ["direct", "oldest"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_steps_equal_jax(strategy, script):
    """Sum for sum and error for error; "capacity" runs with room for two
    live sequences (the oldest arena answers 429 for a third)."""
    sb = ({"max_candidate_sequences": 2} if script == "capacity" else {})
    port = _engine("seq", strategy, **sb)
    ref = _jax_engine("seq", strategy, **sb)
    try:
        got = [_step(port, InferRequest, "seq", *s) for s in SCRIPTS[script]]
        want = [_step(ref, JaxRequest, "seq", *s) for s in SCRIPTS[script]]
    finally:
        port.shutdown()
        ref.shutdown()
    assert got == want
    if script == "errors":
        assert got[0][0] == got[1][0] == got[3][0] == 400
        assert got[4:] == [2147483647, -2147483648]  # INT32 wraps
    if script == "capacity" and strategy == "oldest":
        assert got[2] == (429, "max candidate sequences (2) exceeded")


@pytest.mark.parametrize("strategy,cls", [
    ("direct", SequenceScheduler), ("oldest", OldestSequenceScheduler)])
def test_strategy_picks_the_scheduler(strategy, cls):
    eng = _engine("seq", strategy)
    try:
        sched = eng._schedulers["seq"]
        assert type(sched) is cls
        assert len(sched.workers) == 1
        assert eng.model_config("seq")["sequence_batching"] == {
            "strategy": strategy}
    finally:
        eng.shutdown()


@pytest.mark.parametrize("strategy", ["direct", "oldest"])
def test_many_concurrent_sequences(strategy):
    """64 sequences of 8 steps side by side: every running sum exact; the
    oldest strategy batches steps of distinct sequences into waves
    (executions well under requests)."""
    eng = _engine("seq", strategy, max_queue_delay_microseconds=50_000)
    n_seq, n_steps = 64, 8
    errs = []

    def run(sid):
        total = 0
        for s in range(n_steps):
            total += sid * 10 + s
            got = _step(eng, InferRequest, "seq", sid, sid * 10 + s,
                        s == 0, s == n_steps - 1)
            if got != total:
                errs.append((sid, s, got, total))

    try:
        threads = [threading.Thread(target=run, args=(sid,))
                   for sid in range(1, n_seq + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs[:5]
        stats = eng.model_statistics("seq")["model_stats"][0]
        assert stats["inference_count"] == n_seq * n_steps
        if strategy == "oldest":
            assert stats["execution_count"] < n_seq * n_steps / 2
            assert max(b["batch_size"] for b in stats["batch_stats"]) > 1
        assert eng._schedulers["seq"].active_sequences() == 0
    finally:
        eng.shutdown()


def test_step_outlasting_idle_window_survives_gc():
    """A step that runs longer than the idle window keeps its slot while a
    new sequence's start runs the GC (tests/test_engine.py)."""
    class SlowSeq(SequenceAccumulateBackend):
        def step(self, state, inputs):
            time.sleep(0.4)  # outlasts the 100 ms idle window
            return super().step(state, inputs)

    backend = SlowSeq(name="slow")
    backend.config.sequence_batching.max_sequence_idle_microseconds = 100_000
    backend.config.instance_count = 2
    repo = ModelRepository()
    repo.register("slow", lambda device: backend)
    eng = TorchEngine(repo, device="cpu")
    try:
        sched = eng._schedulers["slow"]
        res = {}
        t = threading.Thread(target=lambda: res.setdefault(
            "a", _step(eng, InferRequest, "slow", 1, 5, True)))
        t.start()
        while not any(s.inflight for s in list(sched._slots.values())):
            time.sleep(0.001)
        time.sleep(0.15)  # seq 1's step is in flight and "idle"-stale
        assert _step(eng, InferRequest, "slow", 2, 1, True, True) == 1
        t.join()
        assert res["a"] == 5
        assert _step(eng, InferRequest, "slow", 1, 2, end=True) == 7
    finally:
        eng.shutdown()


def test_idle_sequence_with_queued_request_survives_gc():
    """An idle-stale sequence whose next step is in the forming wave is not
    evicted by a new sequence's row acquisition in that same wave."""
    eng = _engine("gc", "oldest", max_sequence_idle_microseconds=100_000,
                  max_queue_delay_microseconds=100_000)
    try:
        assert _step(eng, InferRequest, "gc", 1, 5, True) == 5
        time.sleep(0.25)  # seq 1 is now idle-stale
        results, done = {}, {9: threading.Event(), 1: threading.Event()}

        def cb(sid):
            def _cb(resp):
                results[sid] = (resp.error if resp.error is not None
                                else int(resp.outputs["OUTPUT"][0]))
                done[sid].set()
            return _cb

        # The new sequence is queued first: its row acquisition runs the
        # GC with seq 1's stale step in the same wave.
        eng.async_infer(InferRequest(
            model_name="gc", inputs={"INPUT": np.array([7], np.int32)},
            sequence_id=9, sequence_start=True, sequence_end=True), cb(9))
        eng.async_infer(InferRequest(
            model_name="gc", inputs={"INPUT": np.array([3], np.int32)},
            sequence_id=1, sequence_end=True), cb(1))
        assert done[9].wait(TIMEOUT) and done[1].wait(TIMEOUT)
        assert results == {9: 7, 1: 8}
    finally:
        eng.shutdown()


def test_direct_pending_sequence_survives_gc():
    eng = _engine("gc", max_sequence_idle_microseconds=50_000)
    sched = eng._schedulers["gc"]
    try:
        assert _step(eng, InferRequest, "gc", 1, 4, True) == 4
        # A continuation stuck in the queue past the idle window: marked
        # pending (as submit does), its timestamp left to go stale.
        with sched._slots_lock:
            sched._pending[1] = 1
        time.sleep(0.12)
        probe = InferRequest(model_name="gc", inputs={
            "INPUT": np.array([1], np.int32)}, sequence_id=2,
            sequence_start=True)
        sched._put_slot(sched._get_slot(probe))  # runs the idle GC
        assert 1 in sched._slots, "pending sequence evicted while queued"
        with sched._slots_lock:
            sched._pending.pop(1, None)
        time.sleep(0.12)
        probe.sequence_id = 3
        sched._put_slot(sched._get_slot(probe))
        assert 1 not in sched._slots, "an idle sequence is still evicted"
    finally:
        eng.shutdown()


def test_oldest_pending_sequence_survives_gc():
    eng = _engine("gc", "oldest", max_sequence_idle_microseconds=50_000)
    sched = eng._schedulers["gc"]
    try:
        assert _step(eng, InferRequest, "gc", 1, 4, True) == 4
        with sched._arena_lock:
            sched._pending[1] = 1
        time.sleep(0.12)
        probe = InferRequest(model_name="gc", inputs={
            "INPUT": np.array([1], np.int32)}, sequence_id=2,
            sequence_start=True)
        sched._acquire_row(probe, protect={2})  # runs the idle GC
        assert 1 in sched._rows, "pending sequence's row evicted while queued"
        sched._release_row(2)
        with sched._arena_lock:
            sched._pending.pop(1, None)
        assert _step(eng, InferRequest, "gc", 1, 1, end=True) == 5
    finally:
        eng.shutdown()


def test_failed_wave_resets_the_arena_and_keeps_serving():
    eng = _engine("reset", "oldest")
    try:
        assert _step(eng, InferRequest, "reset", 1, 5, True) == 5
        sched = eng._schedulers["reset"]
        real = sched._step

        def boom(*a, **kw):
            sched._step = real  # fail exactly once
            raise RuntimeError("injected device failure")

        sched._step = boom
        assert _step(eng, InferRequest, "reset", 1, 1) == (
            500, "injected device failure")
        # The live sequence went with the arena...
        assert _step(eng, InferRequest, "reset", 1, 1)[0] == 400
        # ...and fresh sequences are served.
        assert _step(eng, InferRequest, "reset", 2, 3, True) == 3
        assert _step(eng, InferRequest, "reset", 2, 4, end=True) == 7
    finally:
        eng.shutdown()


def test_oldest_padded_lanes_touch_only_the_dummy_row():
    """Three live sequences in a 4-lane bucket: the padded lane scatters
    into the dummy row; the free rows stay zero."""
    eng = _engine("pad", "oldest", max_candidate_sequences=8,
                  max_queue_delay_microseconds=200_000)
    try:
        sched = eng._schedulers["pad"]
        done = threading.Barrier(4)
        out = {}

        def one(sid):
            out[sid] = _step(eng, InferRequest, "pad", sid, sid * 3, True)
            done.wait(TIMEOUT)

        for sid in (1, 2, 3):
            threading.Thread(target=one, args=(sid,)).start()
        done.wait(TIMEOUT)
        assert out == {1: 3, 2: 6, 3: 9}
        arena = sched._arena.clone()
        used = set(sched._rows.values())
        free = [r for r in range(8) if r not in used]
        assert torch.equal(arena[free], torch.zeros_like(arena[free]))
        assert sorted(arena[sorted(used)].ravel().tolist()) == [3, 6, 9]
    finally:
        eng.shutdown()


# -- the decoupled scheduler --------------------------------------------------


def test_repeat_runs_in_the_decoupled_scheduler():
    eng = TorchEngine(build_repository(["simple_repeat"]), device="cpu")
    try:
        assert type(eng._schedulers["simple_repeat"]) is DecoupledScheduler
        with pytest.raises(EngineError) as exc:
            eng.infer(InferRequest(model_name="simple_repeat", inputs={
                "IN": np.array([1], np.int32)}), timeout_s=TIMEOUT)
        assert exc.value.status == 400 and "decoupled" in str(exc.value)
    finally:
        eng.shutdown()


def test_repeat_responses_equal_jax_engine():
    from client_tpu.models import build_repository as jax_build

    port = TorchEngine(build_repository(["simple_repeat"]), device="cpu")
    ref = TpuEngine(jax_build(["simple_repeat"]))

    def collect(engine, make, inputs):
        got, done = [], threading.Event()

        def cb(resp):
            got.append((resp.error and (resp.error.status, str(resp.error)),
                        {k: (v.dtype.str, v.tolist())
                         for k, v in resp.outputs.items()},
                        resp.parameters, resp.final))
            if resp.final:
                done.set()
        engine.async_infer(make(model_name="simple_repeat", inputs=inputs,
                                request_id="r"), cb)
        assert done.wait(TIMEOUT)
        return got

    try:
        for inputs in ({"IN": np.array([4, 5, 6], np.int32)},
                       {"IN": np.zeros(0, np.int32)},
                       {"IN": np.array([7, 8], np.int32),
                        "DELAY": np.array([1000, 0], np.uint32)},
                       {"IN": np.array([1.5], np.float32)}):
            assert collect(port, InferRequest, inputs) == collect(
                ref, JaxRequest, inputs)
    finally:
        port.shutdown()
        ref.shutdown()


def test_repeat_waits_on_backpressure_then_cancels_with_499():
    eng = TorchEngine(build_repository(["simple_repeat"]), device="cpu")
    try:
        held = threading.Event()
        got, done = [], threading.Event()
        req = InferRequest(model_name="simple_repeat",
                           inputs={"IN": np.arange(5, dtype=np.int32)})

        def backlogged():
            if got:  # after the first response the writer "stalls"
                held.set()
                return True
            return False

        req.backpressure = backlogged

        def cb(resp):
            got.append(resp)
            if resp.final:
                done.set()

        eng.async_infer(req, cb)
        assert held.wait(TIMEOUT)
        assert len(got) == 1  # the second emit waits on the writer
        req.cancel()
        assert done.wait(TIMEOUT)
        assert got[-1].error.status == 499
        assert [int(r.outputs["OUT"][0]) for r in got[:-1]] == [0]
    finally:
        eng.shutdown()


# -- the frontends ------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    """The port and the JAX package, each serving simple_sequence,
    simple_sequence_oldest and simple_repeat over HTTP and gRPC."""
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    engine = TorchEngine(build_repository(MODELS), device="cpu")
    http_srv = HttpInferenceServer(engine, port=0).start()
    grpc_srv = GrpcInferenceServer(engine, port=0).start()
    jax_engine = TpuEngine(jax_build(MODELS))
    jax_http = JaxHttp(jax_engine, port=0).start()
    jax_grpc = JaxGrpc(jax_engine, port=0).start()
    yield {"port": (http_srv.url, grpc_srv.url),
           "jax": (jax_http.url, f"127.0.0.1:{jax_grpc.port}")}
    for srv in (jax_grpc, jax_http, grpc_srv, http_srv):
        srv.stop()
    jax_engine.shutdown()
    engine.shutdown()


def _post(url, path, body):
    req = urllib.request.Request(f"http://{url}{path}",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _seq_body(value, **params):
    return {"inputs": [{"name": "INPUT", "datatype": "INT32", "shape": [1],
                        "data": [value]}], "parameters": params}


HTTP_SCRIPT = [
    dict(sequence_id=11, sequence_start=True), dict(sequence_id=11),
    dict(sequence_id=12, sequence_start=True), dict(sequence_id=11,
                                                    sequence_end=True),
    dict(sequence_id=11), dict(), dict(sequence_id=0, sequence_start=True),
    dict(sequence_id=12, sequence_start=True, sequence_end=True)]


@pytest.mark.parametrize("model", MODELS[:2])
def test_sequence_parameters_over_http_equal_jax(servers, model):
    answers = {}
    for side in ("port", "jax"):
        url = servers[side][0]
        answers[side] = []
        for i, params in enumerate(HTTP_SCRIPT):
            status, data = _post(url, f"/v2/models/{model}/infer",
                                 _seq_body(i + 1, **params))
            body = json.loads(data)
            answers[side].append(
                (status, body["outputs"][0]["data"] if status == 200
                 else body["error"]))
    assert answers["port"] == answers["jax"]
    assert [a[0] for a in answers["port"]] == [200, 200, 200, 200, 400,
                                               400, 400, 200]
    assert answers["port"][3][1] == [1 + 2 + 4]


def _grpc_seq_request(model, value, rid="", **params):
    req = pb.ModelInferRequest(model_name=model, id=rid)
    req.inputs.add(name="INPUT", datatype="INT32", shape=[1])
    req.raw_input_contents.append(np.array([value], np.int32).tobytes())
    for k, v in params.items():
        if isinstance(v, bool):
            req.parameters[k].bool_param = v
        else:
            req.parameters[k].int64_param = v
    return req


@pytest.mark.parametrize("model", MODELS[:2])
def test_sequence_parameters_over_grpc_equal_jax(servers, model):
    answers = {}
    for side in ("port", "jax"):
        with grpc.insecure_channel(servers[side][1]) as ch:
            stub = grpc_stub.GRPCInferenceServiceStub(ch)
            out = []
            for i, params in enumerate(HTTP_SCRIPT):
                try:
                    resp = stub.ModelInfer(
                        _grpc_seq_request(model, i + 1, **params),
                        timeout=TIMEOUT)
                    out.append(np.frombuffer(resp.raw_output_contents[0],
                                             np.int32).tolist())
                except grpc.RpcError as exc:
                    out.append((exc.code(), exc.details()))
            answers[side] = out
    assert answers["port"] == answers["jax"]
    assert answers["port"][3] == [7]


@pytest.mark.parametrize("model", MODELS[:2])
def test_sequences_on_one_stream_equal_jax(servers, model):
    """Two interleaved sequences and a bad step on one ModelStreamInfer
    RPC: message for message, by request id."""
    reqs = []
    for i in range(3):
        for sid, base in ((21, 1), (22, 10)):
            reqs.append(_grpc_seq_request(
                model, base * (i + 1), rid=f"{sid}-{i}", sequence_id=sid,
                sequence_start=i == 0, sequence_end=i == 2))
    reqs.append(_grpc_seq_request(model, 1, rid="bad", sequence_id=23))
    answers = {}
    for side in ("port", "jax"):
        with grpc.insecure_channel(servers[side][1]) as ch:
            stub = grpc_stub.GRPCInferenceServiceStub(ch)
            msgs = {}
            for msg in stub.ModelStreamInfer(iter(reqs), timeout=TIMEOUT):
                r = msg.infer_response
                msgs[r.id] = (msg.error_message, list(r.outputs) and
                              np.frombuffer(r.raw_output_contents[0],
                                            np.int32).tolist())
            answers[side] = msgs
    assert answers["port"] == answers["jax"]
    assert answers["port"]["22-2"] == ("", [60])
    assert "without start flag" in answers["port"]["bad"][0]


def _repeat_body(values, delays=None):
    inputs = [{"name": "IN", "datatype": "INT32", "shape": [len(values)],
               "data": list(values)}]
    if delays is not None:
        inputs.append({"name": "DELAY", "datatype": "UINT32",
                       "shape": [len(delays)], "data": list(delays)})
    return {"id": "rq", "inputs": inputs}


@pytest.mark.parametrize("values,delays", [([3, 1, 4, 1, 5], None),
                                           ([], None),
                                           ([9, 8], [500, 0])])
def test_repeat_over_http_equals_jax(servers, values, delays):
    body = _repeat_body(values, delays)
    for route in ("generate", "generate_stream", "infer"):
        got = [_post(servers[side][0], f"/v2/models/simple_repeat/{route}",
                     body) for side in ("port", "jax")]
        assert got[0] == got[1], route
        if route == "infer":
            assert got[0][0] == 400
        else:
            assert got[0][0] == 200
    status, data = _post(servers["port"][0],
                         "/v2/models/simple_repeat/generate", body)
    outs = [r["outputs"] for r in json.loads(data)["responses"]]
    assert [o[0]["data"] for o in outs] == [[v] for v in values]


def test_repeat_over_model_stream_infer_equals_jax(servers):
    reqs = []
    for rid, values in (("a", [1, 2, 3]), ("b", []), ("c", [7])):
        req = pb.ModelInferRequest(model_name="simple_repeat", id=rid)
        req.inputs.add(name="IN", datatype="INT32", shape=[len(values)])
        req.raw_input_contents.append(np.array(values, np.int32).tobytes())
        reqs.append(req)
    answers = {}
    for side in ("port", "jax"):
        with grpc.insecure_channel(servers[side][1]) as ch:
            stub = grpc_stub.GRPCInferenceServiceStub(ch)
            msgs = {}
            for msg in stub.ModelStreamInfer(iter(reqs), timeout=TIMEOUT):
                msgs.setdefault(msg.infer_response.id, []).append(
                    msg.SerializeToString(deterministic=True))
            answers[side] = msgs
    assert answers["port"] == answers["jax"]
    assert [len(answers["port"][k]) for k in "abc"] == [4, 1, 2]


@pytest.mark.parametrize("script,which", [
    ("simple_http_sequence_sync_client.py", 0),
    ("simple_grpc_sequence_sync_client.py", 1),
    ("simple_grpc_sequence_stream_client.py", 1),
    ("simple_grpc_custom_repeat_client.py", 1)])
def test_example_clients_pass_against_the_port(servers, script, which):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "python", script),
         "-u", servers["port"][which]], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, f"{proc.stdout}{proc.stderr}"
    assert "PASS" in proc.stdout, proc.stdout
