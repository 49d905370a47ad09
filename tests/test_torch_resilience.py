"""The port's resilience layer and the clients' support modules against
the JAX package's.

``client_tpu_torch.resilience`` must draw the same backoff for the same
seed, classify errors alike and walk the circuit breaker through the same
states, raising the same exceptions, as ``client_tpu.resilience``
(scripted on a fake clock, so nothing waits). The cases are those of
``tests/test_resilience.py``, each run on both packages and compared.
Then the two HTTP and gRPC clients under retry, pushback, breaker and
deadline budget, against small fake servers that fail on purpose, and the
HTTP client's multi-URL failover over two port servers: equal outputs,
exceptions and ``InferStat`` counts. The support copies (``InferStat``,
the trace context, ``Server-Timing``, pushback, load report, rendezvous
hash) give the same values as their JAX counterparts.
"""

import http.server
import random
import re
import socket
import threading
import time
from concurrent import futures
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

import client_tpu.grpc as jax_grpc
import client_tpu.http as jax_http
import client_tpu.observability.client_stats as jax_stats
import client_tpu.observability.tracing as jax_tracing
import client_tpu.protocol.loadreport as jax_load
import client_tpu.protocol.pushback as jax_pushback
import client_tpu.resilience as jax_res
import client_tpu.router.core as jax_router
import client_tpu.utils as jax_utils
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.http as port_http
import client_tpu_torch.observability.client_stats as port_stats
import client_tpu_torch.observability.tracing as port_tracing
import client_tpu_torch.protocol.loadreport as port_load
import client_tpu_torch.protocol.pushback as port_pushback
import client_tpu_torch.resilience as port_res
import client_tpu_torch.router.core as port_router
import client_tpu_torch.utils as port_utils
from client_tpu_torch.protocol import grpc_service_pb2 as pb

TIMEOUT = 30  # seconds, every wait
JAX = SimpleNamespace(res=jax_res, utils=jax_utils, http=jax_http,
                      grpc=jax_grpc, stats=jax_stats)
PORT = SimpleNamespace(res=port_res, utils=port_utils, http=port_http,
                       grpc=port_grpc, stats=port_stats)
STAT_KEYS = ("completed_request_count", "reported_request_count",
             "retry_count", "stale_socket_retry_count",
             "breaker_rejected_count", "cold_start_count")


def _on_both(fn):
    """``fn(pkg)`` on the port and on the JAX package."""
    return fn(PORT), fn(JAX)


def _outcome(fn):
    """A call's value, or its exception as (class name, status, words,
    retry_after_s)."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared across packages
        status = getattr(exc, "status", None)
        words = exc.message() if hasattr(exc, "message") else str(exc)
        # An open breaker names the cooldown left, which the clock moves.
        words = re.sub(r"retry in [0-9.]+s", "retry in _s", words)
        return ("error", type(exc).__name__,
                status() if callable(status) else status, words,
                getattr(exc, "retry_after_s", None))


def _exc(pkg, kind):
    """One error of each shape the classification sees."""
    err = pkg.utils.InferenceServerException
    shapes = {
        "502": lambda: err("x", status=502),
        "503": lambda: err("x", status=503),
        "500": lambda: err("x", status=500),
        "400": lambda: err("x", status=400),
        "404": lambda: err("x", status=404),
        "429": lambda: err("x", status=429),
        "unavailable": lambda: err("x", status="StatusCode.UNAVAILABLE"),
        "internal": lambda: err("x", status="StatusCode.INTERNAL"),
        "deadline": lambda: err("x", status="StatusCode.DEADLINE_EXCEEDED"),
        "invalid": lambda: err("x", status="StatusCode.INVALID_ARGUMENT"),
        "exhausted": lambda: err("x", status="StatusCode.RESOURCE_EXHAUSTED"),
        "no_status": lambda: err("x"),
        "reset": ConnectionResetError,
        "refused": ConnectionRefusedError,
        "timeout": TimeoutError,
        "socket_timeout": socket.timeout,
        "value": lambda: ValueError("x"),
    }
    exc = shapes[kind]()
    if kind == "429":
        exc.retry_after_s = "0.25"
    return exc


KINDS = ["502", "503", "500", "400", "404", "429", "unavailable", "internal",
         "deadline", "invalid", "exhausted", "no_status", "reset", "refused",
         "timeout", "socket_timeout", "value"]


@pytest.mark.parametrize("kind", KINDS)
def test_classification_equals_jax(kind):
    def classify(pkg):
        exc = _exc(pkg, kind)
        p = pkg.res.RetryPolicy()
        return (p.retryable(exc), pkg.res.counts_as_server_fault(exc),
                pkg.res.status_of(exc), pkg.res.retry_after_of(exc))

    port, ref = _on_both(classify)
    assert port == ref


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("jitter", [True, False])
def test_backoff_draws_equal_jax(seed, jitter):
    def draws(pkg):
        p = pkg.res.RetryPolicy(initial_backoff_s=0.1, max_backoff_s=0.5,
                                backoff_multiplier=2.0, jitter=jitter,
                                seed=seed)
        out = [p.backoff_s(i) for i in range(1, 12)]
        out += [p.backoff_s(8, remaining_s=0.01), p.backoff_s(3, 1.0, 0.7),
                p.backoff_s(2, retry_after_s=-1.0)]
        return out

    port, ref = _on_both(draws)
    assert port == ref
    caps = [min(0.5, 0.1 * 2.0 ** (i - 1)) for i in range(1, 12)]
    assert all(0.0 <= d <= c for d, c in zip(port, caps))


def test_policy_validation_equals_jax():
    port, ref = _on_both(lambda pkg: [
        _outcome(lambda: pkg.res.RetryPolicy(max_attempts=0)),
        _outcome(lambda: pkg.res.CircuitBreaker(failure_threshold=0))])
    assert port == ref
    assert port[0][1] == "ValueError"


def _script(pkg, failures, *, policy=None, deadline_s=None, cost_s=0.0,
            breaker=None, start=0.0):
    """run_with_resilience on a fake clock: ``failures`` are the error
    kinds the attempts raise in turn, then "ok"."""
    now = [start]
    log = []

    def attempt(remaining):
        log.append(("attempt", remaining))
        now[0] += cost_s
        if len(log_attempts := [x for x in log if x[0] == "attempt"]) \
                <= len(failures):
            raise _exc(pkg, failures[len(log_attempts) - 1])
        return "ok"

    def sleep(s):
        log.append(("sleep", s))
        now[0] += s

    out = _outcome(lambda: pkg.res.run_with_resilience(
        attempt, policy=policy(pkg) if policy else None,
        breaker=breaker(pkg, now) if breaker else None,
        deadline_s=deadline_s, host="h", sleep=sleep, clock=lambda: now[0],
        on_retry=lambda n, exc, d: log.append(("retry", n, d)),
        on_breaker_reject=lambda: log.append(("rejected",))))
    return out, log


SCRIPTS = {
    "retries_until_success": dict(
        failures=["503", "503"],
        policy=lambda pkg: pkg.res.RetryPolicy(max_attempts=4, seed=1)),
    "non_retryable_raises": dict(
        failures=["400"],
        policy=lambda pkg: pkg.res.RetryPolicy(max_attempts=5, seed=1)),
    "attempts_exhausted": dict(
        failures=["503"] * 5,
        policy=lambda pkg: pkg.res.RetryPolicy(max_attempts=3, seed=1)),
    "pushback_replaces_backoff": dict(
        failures=["429", "429"],
        policy=lambda pkg: pkg.res.RetryPolicy(max_attempts=4, seed=3)),
    "connection_errors_retry": dict(
        failures=["reset", "refused", "timeout"],
        policy=lambda pkg: pkg.res.RetryPolicy(max_attempts=4, seed=5)),
    "deadline_bounds_total_time": dict(
        failures=["503"] * 100, cost_s=0.4, deadline_s=1.0,
        policy=lambda pkg: pkg.res.RetryPolicy(
            max_attempts=100, initial_backoff_s=0.0, jitter=False)),
    "deadline_before_first_attempt": dict(
        failures=[], deadline_s=-1.0,
        policy=lambda pkg: pkg.res.RetryPolicy()),
    "breaker_counts_only_server_faults": dict(
        failures=["400"],
        breaker=lambda pkg, now: pkg.res.CircuitBreaker(
            failure_threshold=1, clock=lambda: now[0])),
    "breaker_opens_then_rejects": dict(
        failures=["503"] * 4,
        policy=lambda pkg: pkg.res.RetryPolicy(max_attempts=4, seed=2),
        breaker=lambda pkg, now: pkg.res.CircuitBreaker(
            failure_threshold=2, cooldown_s=10.0, clock=lambda: now[0])),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_run_with_resilience_equals_jax(name):
    port, ref = _on_both(lambda pkg: _script(pkg, **SCRIPTS[name]))
    assert port == ref
    if name == "deadline_bounds_total_time":
        assert len([x for x in port[1] if x[0] == "attempt"]) == 3
    if name == "breaker_opens_then_rejects":
        assert port[0][1] == "CircuitBreakerOpenError"


def _breaker_walk(pkg, steps):
    """Apply (op, host, now) steps to one breaker on a fake clock; the
    state, open seconds or exception after each."""
    now = [0.0]
    br = pkg.res.CircuitBreaker(failure_threshold=3, cooldown_s=5.0,
                                clock=lambda: now[0])
    out = []
    for op, host, t in steps:
        now[0] = t
        if op == "check":
            out.append(_outcome(lambda: br.check(host)))
        elif op == "fail":
            br.record_failure(host)
        elif op == "ok":
            br.record_success(host)
        out.append((br.state(host), br.open_seconds_total()))
    return out


WALKS = {
    "open_after_consecutive_and_probe": [
        ("check", "h", 0), ("fail", "h", 0), ("fail", "h", 0),
        ("fail", "h", 1), ("check", "h", 2), ("check", "h", 6.5),
        ("check", "h", 6.6), ("ok", "h", 7), ("check", "h", 7)],
    "failed_probe_reopens": [
        ("fail", "h", 0), ("fail", "h", 0), ("fail", "h", 0),
        ("check", "h", 5.1), ("fail", "h", 5.2), ("check", "h", 6),
        ("check", "h", 10.3)],
    "success_resets_count": [
        ("fail", "h", 0), ("fail", "h", 0), ("ok", "h", 0),
        ("fail", "h", 0), ("fail", "h", 0)],
    "per_host_isolation": [
        ("fail", "a", 0), ("fail", "a", 0), ("fail", "a", 0),
        ("check", "b", 1), ("check", "a", 2)],
    "stale_probe_reclaimed": [
        ("fail", "h", 0), ("fail", "h", 0), ("fail", "h", 0),
        ("check", "h", 5.1), ("check", "h", 6), ("check", "h", 10.3),
        ("ok", "h", 10.4)],
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_breaker_transitions_equal_jax(name):
    port, ref = _on_both(lambda pkg: _breaker_walk(pkg, WALKS[name]))
    assert port == ref


def test_half_open_probe_resolved_by_non_server_fault():
    def walk(pkg):
        now = [0.0]
        br = pkg.res.CircuitBreaker(failure_threshold=1, cooldown_s=5.0,
                                    clock=lambda: now[0])

        def fail(kind):
            def attempt(remaining):
                raise _exc(pkg, kind)
            return _outcome(lambda: pkg.res.run_with_resilience(
                attempt, breaker=br, host="h"))

        out = [fail("503"), br.state("h")]
        now[0] = 5.1
        out += [fail("429"), br.state("h"), _outcome(
            lambda: pkg.res.run_with_resilience(lambda r: "ok", breaker=br,
                                                host="h"))]
        return out

    port, ref = _on_both(walk)
    assert port == ref
    assert port[3] == "closed"


# ---------------------------------------------------------------------------
# Connection pool (the port's), as ``tests/test_resilience.py`` holds JAX's
# ---------------------------------------------------------------------------


def test_pool_symmetric_churn_and_bounds():
    pool = port_http._ConnectionPool("localhost", 1, size=1, timeout=1)
    for _ in range(10):
        conn, _ = pool.acquire()
        pool.release(conn, broken=True)
    assert pool.live == 0
    conn, reused = pool.acquire()
    assert not reused and pool.live == 1
    pool.release(conn)
    conn2, reused2 = pool.acquire()
    assert reused2 and conn2 is conn
    pool.release(conn2, broken=True)
    pool.release(conn2, broken=True)  # a double release is safe
    assert pool.live == 0
    c1, _ = pool.acquire()
    c2, _ = pool.acquire()
    pool.release(c1)
    pool.release(c2)  # over the bound: closed and counted down
    assert pool.live == 1
    pool.close()
    assert pool.live == 0


def test_pool_concurrent_churn():
    pool = port_http._ConnectionPool("localhost", 1, size=4, timeout=1)
    errs = []

    def churn():
        try:
            for i in range(200):
                conn, _ = pool.acquire()
                pool.release(conn, broken=(i % 3 == 0))
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=churn) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    pool.close()
    assert pool.live == 0


def test_stale_replay_recomputes_deadline():
    """The replay of a stale pooled socket gets the budget that remains,
    not the budget from before the stale attempt."""
    class _Resp:
        status = 200

        def read(self):
            return b""

    class _Conn:
        def __init__(self, fail_after_s=None):
            self.fail_after_s = fail_after_s
            self.timeout = None
            self.sock = None

        def request(self, *a, **kw):
            if self.fail_after_s is not None:
                time.sleep(self.fail_after_s)
                raise ConnectionResetError("stale keep-alive")

        def getresponse(self):
            return _Resp()

        def close(self):
            pass

    stale, fresh = _Conn(fail_after_s=0.08), _Conn()
    handed = [(stale, True), (fresh, False)]

    class _Pool:
        def acquire(self):
            return handed.pop(0)

        def release(self, conn, broken=False):
            pass

        def close(self):
            pass

    c = port_http.InferenceServerClient("localhost:9")
    c._pool = _Pool()
    try:
        resp, _ = c._request_once("GET", "/x", None, {}, 0.5)
        assert resp.status == 200
        assert stale.timeout == pytest.approx(0.5, abs=0.02)
        assert fresh.timeout <= 0.5 - 0.07
        assert c.get_infer_stat()["stale_socket_retry_count"] == 1
    finally:
        c.close()


# ---------------------------------------------------------------------------
# The clients under faults, against fake servers
# ---------------------------------------------------------------------------


class _FlakyHttp:
    """An HTTP server that answers each request with the next
    (status, headers, body, delay_s) of its script, then 200s of a
    ``simple`` response."""

    OK_BODY = (b'{"model_name":"simple","model_version":"1","outputs":'
               b'[{"name":"OUTPUT0","datatype":"INT32","shape":[1],'
               b'"data":[7]}]}')

    def __init__(self):
        self.script = []
        self.seen = 0
        flaky = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _answer(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                self.rfile.read(length)
                flaky.seen += 1
                status, headers, body, delay = (
                    flaky.script.pop(0) if flaky.script
                    else (200, {}, flaky.OK_BODY, 0.0))
                if delay:
                    time.sleep(delay)
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _answer

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        self.url = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def flaky():
    srv = _FlakyHttp()
    yield srv
    srv.stop()


def _err_body(msg):
    return ('{"error": "%s"}' % msg).encode()


HTTP_FAULTS = {
    "retry_503_then_ok": dict(
        script=[(503, {}, _err_body("busy"), 0.0)],
        policy=dict(max_attempts=3, initial_backoff_s=0.001, seed=1)),
    "pushback_429_then_ok": dict(
        script=[(429, {"Retry-After": "0.010"}, _err_body("shed"), 0.0)],
        policy=dict(max_attempts=3, seed=1)),
    "pushback_exhausted": dict(
        script=[(503, {"Retry-After": "0.005"}, _err_body("drain"), 0.0)] * 3,
        policy=dict(max_attempts=2, seed=1)),
    "no_policy_returns_pushback": dict(
        script=[(503, {"Retry-After": "1.500"}, _err_body("drain"), 0.0)]),
    "not_retryable_400": dict(
        script=[(400, {}, _err_body("bad input"), 0.0)],
        policy=dict(max_attempts=3, seed=1)),
    "breaker_opens_on_5xx": dict(
        script=[(500, {}, _err_body("boom"), 0.0)] * 2,
        breaker=dict(failure_threshold=2, cooldown_s=60.0), calls=3),
    "deadline_budget": dict(
        script=[(200, {}, _FlakyHttp.OK_BODY, 0.6)],
        policy=dict(max_attempts=3, seed=1), network_timeout=0.2),
    "non_json_error_body": dict(
        script=[(502, {}, b"<html>bad gateway</html>", 0.0)]),
}


def _http_under_fault(pkg, flaky_srv, case):
    spec = HTTP_FAULTS[case]
    flaky_srv.script = list(spec["script"])
    policy = (pkg.res.RetryPolicy(**spec["policy"]) if "policy" in spec
              else None)
    breaker = (pkg.res.CircuitBreaker(**spec["breaker"]) if "breaker" in spec
               else None)
    c = pkg.http.InferenceServerClient(
        flaky_srv.url, retry_policy=policy, circuit_breaker=breaker,
        network_timeout=spec.get("network_timeout", 60.0))
    try:
        inp = pkg.http.InferInput("INPUT0", [1], "INT32")
        inp.set_data_from_numpy(np.array([1], np.int32))
        out = []
        for _ in range(spec.get("calls", 1)):
            out.append(_outcome(lambda: c.infer(
                "simple", [inp]).as_numpy("OUTPUT0").tolist()))
        stat = c.get_infer_stat()
        time.sleep(0.7 if case == "deadline_budget" else 0)
        return out, {k: stat[k] for k in STAT_KEYS}, flaky_srv.seen
    finally:
        c.close()
        flaky_srv.seen = 0


@pytest.mark.parametrize("case", sorted(HTTP_FAULTS))
def test_http_client_under_faults_equals_jax(flaky, case):
    port, ref = _on_both(lambda pkg: _http_under_fault(pkg, flaky, case))
    assert port == ref


def test_http_failover_over_two_port_servers():
    """Multi-URL mode over two port HTTP servers: the P2C order (seeded
    alike) spreads requests over both and a sequence stays on the one its
    id hashes to; then one server stops, and every request of a new client
    still answers while the stopped target's breaker opens. Both clients
    give equal answers and statistics, each on its own pair of servers."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import HttpInferenceServer

    a = np.arange(16, dtype=np.int32).reshape(1, 16)

    def simple(pkg):
        inputs = [pkg.http.InferInput(n, [1, 16], "INT32")
                  for n in ("INPUT0", "INPUT1")]
        for inp in inputs:
            inp.set_data_from_numpy(a)
        return inputs

    def counts(engine):
        return engine.model_statistics("simple")["model_stats"][0][
            "inference_count"]

    def drive(pkg):
        engines = [TorchEngine(build_repository(["simple", "simple_sequence"]),
                               device="cpu") for _ in range(2)]
        servers = [HttpInferenceServer(e, port=0).start() for e in engines]
        urls = [s.url for s in servers]
        out = []
        try:
            c = pkg.http.InferenceServerClient(urls, network_timeout=5.0)
            c._rng = random.Random(11)
            try:
                for _ in range(8):
                    out.append(_outcome(lambda: c.infer(
                        "simple", simple(pkg)).as_numpy("OUTPUT0").tolist()))
                out.append([counts(e) for e in engines])
                seq = []
                for i, v in enumerate([4, 6, 1]):
                    inp = pkg.http.InferInput("INPUT", [1], "INT32")
                    inp.set_data_from_numpy(np.array([v], np.int32))
                    seq.append(c.infer(
                        "simple_sequence", [inp], sequence_id=5150,
                        sequence_start=(i == 0), sequence_end=(i == 2))
                        .as_numpy("OUTPUT").tolist())
                out.append(seq)
            finally:
                c.close()
            servers[1].stop()
            c = pkg.http.InferenceServerClient(
                urls, network_timeout=5.0,
                circuit_breaker=pkg.res.CircuitBreaker(failure_threshold=2,
                                                       cooldown_s=60.0))
            c._rng = random.Random(12)
            try:
                for _ in range(12):
                    out.append(_outcome(lambda: c.infer(
                        "simple", simple(pkg)).as_numpy("OUTPUT0").tolist()))
                out.append(c._breaker.state(urls[1]))
                stat = c.get_infer_stat()
                out.append({k: stat[k] for k in STAT_KEYS})
            finally:
                c.close()
        finally:
            servers[0].stop()
            for e in engines:
                e.shutdown()
        return out

    port, ref = _on_both(drive)
    assert port == ref
    assert all(o[0] == "ok" for o in port[:8] + port[10:22])
    assert min(port[8]) > 0, f"requests per server {port[8]}"
    assert port[9] == [[4], [10], [11]]
    assert port[22] == "open" and port[23]["breaker_rejected_count"] > 0


class _FlakyGrpc:
    """A gRPC server whose ``ModelInfer`` fails with each (code, trailing
    metadata) of its script, then answers."""

    def __init__(self):
        self.script = []
        self.seen = 0

        def infer(request, context):
            self.seen += 1
            if self.script:
                code, meta = self.script.pop(0)
                context.set_trailing_metadata(meta)
                context.abort(code, f"scripted {code.name.lower()}")
            resp = pb.ModelInferResponse(model_name=request.model_name,
                                         model_version="1", id=request.id)
            resp.outputs.add(name="OUT", datatype="INT32", shape=[1])
            resp.raw_output_contents.append(np.array([9], np.int32).tobytes())
            return resp

        handler = grpc.method_handlers_generic_handler(
            "inference.GRPCInferenceService",
            {"ModelInfer": grpc.unary_unary_rpc_method_handler(
                infer, request_deserializer=pb.ModelInferRequest.FromString,
                response_serializer=pb.ModelInferResponse.SerializeToString)})
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self.server.add_generic_rpc_handlers((handler,))
        self.url = f"127.0.0.1:{self.server.add_insecure_port('127.0.0.1:0')}"
        self.server.start()

    def stop(self):
        self.server.stop(0)


@pytest.fixture(scope="module")
def flaky_grpc():
    srv = _FlakyGrpc()
    yield srv
    srv.stop()


GRPC_FAULTS = {
    "unavailable_then_ok": dict(
        script=[(grpc.StatusCode.UNAVAILABLE, ())],
        policy=dict(max_attempts=3, initial_backoff_s=0.001, seed=1)),
    "pushback_metadata": dict(
        script=[(grpc.StatusCode.RESOURCE_EXHAUSTED,
                 (("retry-after", "0.010"),))],
        policy=dict(max_attempts=3, seed=1)),
    "pushback_ms_exhausted": dict(
        script=[(grpc.StatusCode.RESOURCE_EXHAUSTED,
                 (("retry-pushback-ms", "5"),))] * 3,
        policy=dict(max_attempts=2, seed=1)),
    "not_retryable": dict(
        script=[(grpc.StatusCode.INVALID_ARGUMENT, ())],
        policy=dict(max_attempts=3, seed=1)),
    "breaker_opens": dict(
        script=[(grpc.StatusCode.INTERNAL, ())] * 2,
        breaker=dict(failure_threshold=2, cooldown_s=60.0), calls=3),
    "no_policy_keeps_pushback": dict(
        script=[(grpc.StatusCode.UNAVAILABLE, (("retry-after", "2.5"),))]),
}


def _grpc_under_fault(pkg, srv, case, use_async):
    spec = GRPC_FAULTS[case]
    srv.script = list(spec["script"])
    policy = (pkg.res.RetryPolicy(**spec["policy"]) if "policy" in spec
              else None)
    breaker = (pkg.res.CircuitBreaker(**spec["breaker"]) if "breaker" in spec
               else None)
    c = pkg.grpc.InferenceServerClient(srv.url, retry_policy=policy,
                                       circuit_breaker=breaker)
    try:
        inp = pkg.grpc.InferInput("IN", [1], "INT32")
        inp.set_data_from_numpy(np.array([1], np.int32))
        out = []
        for _ in range(spec.get("calls", 1)):
            if not use_async:
                out.append(_outcome(lambda: c.infer(
                    "m", [inp], client_timeout=TIMEOUT)
                    .as_numpy("OUT").tolist()))
                continue
            done = threading.Event()
            box = []

            def cb(result, error):
                box.append(("ok", result.as_numpy("OUT").tolist())
                           if error is None else _outcome(
                               lambda: (_ for _ in ()).throw(error)))
                done.set()

            c.async_infer("m", [inp], cb, client_timeout=TIMEOUT)
            assert done.wait(TIMEOUT)
            out.append(box[0])
        stat = c.get_infer_stat()
        return out, {k: stat[k] for k in STAT_KEYS}, srv.seen
    finally:
        c.close()
        srv.seen = 0


@pytest.mark.parametrize("use_async", [False, True])
@pytest.mark.parametrize("case", sorted(GRPC_FAULTS))
def test_grpc_client_under_faults_equals_jax(flaky_grpc, case, use_async):
    port, ref = _on_both(
        lambda pkg: _grpc_under_fault(pkg, flaky_grpc, case, use_async))
    assert port == ref


def test_grpc_stream_start_retries_connection():
    """A stream retries its connection only: against an address nothing
    listens on, both clients try ``max_attempts`` times and raise alike."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"

    def start(pkg):
        c = pkg.grpc.InferenceServerClient(
            dead, retry_policy=pkg.res.RetryPolicy(
                max_attempts=2, initial_backoff_s=0.0, jitter=False))
        try:
            out = _outcome(lambda: c.start_stream(lambda r, e: None))
            stat = c.get_infer_stat()
            return out, {k: stat[k] for k in STAT_KEYS}
        finally:
            c.close()

    port, ref = _on_both(start)
    assert port == ref
    assert port[0][1] == "ConnectionError" and port[1]["retry_count"] == 1


# ---------------------------------------------------------------------------
# Support copies
# ---------------------------------------------------------------------------


def test_infer_stat_equals_jax():
    def feed(pkg):
        s = pkg.stats.InferStat()
        s.record(10.04, None, trace_id="a" * 32)
        s.record(20.0, {"queue": 1.5, "compute_infer": 3.25,
                        "compile": 1200.0}, trace_id=None)
        s.record(5.55, {"compute_input": 0.06, "compute_output": 0.04})
        s.record_retry()
        s.record_stale_socket_retry()
        s.record_breaker_rejection()
        return s.get()

    port, ref = _on_both(feed)
    assert port == ref


@pytest.mark.parametrize("threads", [2, 8])
def test_infer_stat_counts_every_thread(threads):
    """Many threads recording at once lose no update, on both packages."""
    per_thread = 500

    def feed(pkg):
        s = pkg.stats.InferStat()

        def work():
            for _ in range(per_thread):
                s.record(2.0, {"queue": 1.0, "compile": 1.0})
                s.record_retry()

        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(TIMEOUT)
        return s.get()

    port, ref = _on_both(feed)
    assert port == ref
    n = threads * per_thread
    assert port["completed_request_count"] == n
    assert port["cold_start_count"] == port["retry_count"] == n
    assert port["cumulative_total_request_time_us"] == 2.0 * n


HEADERS = [None, "", "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
           "00-" + "AB" * 16 + "-" + "cd" * 8 + "-00",
           "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "garbage",
           " 00-" + "12" * 16 + "-" + "34" * 8 + "-03 "]


@pytest.mark.parametrize("header", HEADERS)
def test_trace_context_equals_jax(header):
    def adopt(tracing):
        ctx = tracing.TraceContext.from_traceparent(header)
        adopted = ctx.parent_span_id != ""
        back = tracing.TraceContext.from_traceparent(ctx.to_traceparent())
        return (adopted, ctx.trace_id if adopted else len(ctx.trace_id),
                ctx.parent_span_id, ctx.flags, len(ctx.span_id),
                back.trace_id == ctx.trace_id,
                back.parent_span_id == ctx.span_id,
                len(ctx.to_traceparent()))

    assert adopt(port_tracing) == adopt(jax_tracing)


TIMINGS = [None, "", "queue;dur=1.5, compute_infer;dur=0.25",
           "queue;dur=1.5;desc=x, compile;dur=12.000, bad;dur=zz",
           "compute_input;dur=0.001,compute_output;dur=3", ",,;dur=1"]


@pytest.mark.parametrize("header", TIMINGS)
def test_parse_server_timing_equals_jax(header):
    assert port_tracing.parse_server_timing(header) \
        == jax_tracing.parse_server_timing(header)


VALUES = [0, -1, 0.0004, 0.0005, 1.2345, 9.9999, 10, 1e9]
RAWS = [None, "", "1.5", "0", "-2", "inf", "nan", "abc", "3", 2.25]


def test_pushback_equals_jax():
    for mod in (port_pushback, jax_pushback):
        assert mod.RETRY_AFTER_HEADER == "Retry-After"
    # What the JAX servers send, read back by the port's parser.
    sent = [jax_pushback.format_retry_after_s(v) for v in VALUES]
    sent += [jax_pushback.format_retry_pushback_ms(v) for v in VALUES]
    assert [port_pushback.parse_retry_after(v) for v in sent] \
        == [jax_pushback.parse_retry_after(v) for v in sent]
    assert [port_pushback.parse_retry_after(v) for v in RAWS] \
        == [jax_pushback.parse_retry_after(v) for v in RAWS]
    metas = [None, {}, {"retry-after": "0.5"},
             {"retry-pushback-ms": "250"},
             [("Retry-After", "1.25"), ("retry-pushback-ms", "9")],
             [("retry-pushback-ms", "x")]]
    assert [port_pushback.parse_pushback_metadata(m) for m in metas] \
        == [jax_pushback.parse_pushback_metadata(m) for m in metas]


LOADS = [None, "", "s=READY;i=3;q=1;b=1;w=0.004;f=0",
         "s=DRAINING;i=0;q=0", "s=DEGRADED;w=-2;f=1", "i=3;q=1",
         "s=READY;i=x", "s=BOGUS", "s=READY;w=100;f=false"]


@pytest.mark.parametrize("raw", LOADS)
def test_load_header_equals_jax(raw):
    def decode(mod):
        r = mod.decode_header(raw)
        if r is None:
            return None
        return (r.state, r.inflight, r.queue_depth, r.active_batches,
                r.wait_s, r.slo_fast_burn, r.draining, r.score())

    assert port_load.LOAD_HEADER == jax_load.LOAD_HEADER
    assert decode(port_load) == decode(jax_load)


def test_rendezvous_pick_equals_jax():
    ids = ["127.0.0.1:8000", "127.0.0.1:8001", "10.0.0.2:8000", "h:1"]
    for token in list(range(200)) + ["seq-a", "", "0"]:
        for k in range(1, len(ids) + 1):
            assert port_router.rendezvous_pick(ids[:k], token) \
                == jax_router.rendezvous_pick(ids[:k], token)
