"""``Expect: 100-continue`` on the port's HTTP server, held against the
JAX server.

A client that sends ``Expect: 100-continue`` holds its body back until
the server's interim ``HTTP/1.1 100 Continue``. Both servers buffer their
writes (one segment for a response's head and body), so the interim line
must be flushed out of the buffer before the handler blocks reading the
body: without that, client and server wait on each other. Each server
gets the headers of a ``simple`` infer, must answer ``100 Continue``
within a second, then the body, and both answer 200 with equal bodies.
"""

import json
import socket
from types import SimpleNamespace

import numpy as np
import pytest

TIMEOUT = 60  # seconds, every wait but the interim answer's


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


def _body() -> bytes:
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    return json.dumps({"id": "e100", "inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": (a * (i + 1)).ravel().tolist()}
        for i, n in enumerate(("INPUT0", "INPUT1"))]}).encode()


def _read_until(sock, marker: bytes, buf: bytes = b"") -> bytes:
    while marker not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            break
        buf += chunk
    return buf


def _expect_continue(port: int) -> tuple[str, int, dict]:
    """Headers first, the body only after the interim answer; returns the
    interim status line, the final status and the final body."""
    body = _body()
    with socket.create_connection(("127.0.0.1", port), timeout=1.0) as sock:
        sock.sendall(
            b"POST /v2/models/simple/infer HTTP/1.1\r\n"
            b"Host: 127.0.0.1\r\nContent-Type: application/json\r\n"
            b"Expect: 100-continue\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode())
        # Within a second, with the body still held back.
        interim = _read_until(sock, b"\r\n\r\n")
        line, _, rest = interim.partition(b"\r\n\r\n")
        sock.settimeout(TIMEOUT)
        sock.sendall(body)
        raw = _read_until(sock, b"\r\n\r\n", rest)
        head, _, payload = raw.partition(b"\r\n\r\n")
        lines = head.decode().split("\r\n")
        length = next(int(h.split(":", 1)[1]) for h in lines[1:]
                      if h.lower().startswith("content-length:"))
        while len(payload) < length:
            payload += sock.recv(65536)
    return (line.decode().split("\r\n")[0], int(lines[0].split()[1]),
            json.loads(payload))


def test_100_continue_arrives_before_the_body_on_both_servers(servers):
    got = {name: _expect_continue(side.http.port)
           for name, side in servers.items()}
    for name, (interim, status, _) in got.items():
        assert interim == "HTTP/1.1 100 Continue", name
        assert status == 200, name
    assert got["port"][2] == got["jax"][2]
    out = {o["name"]: o["data"] for o in got["port"][2]["outputs"]}
    a = np.arange(16)
    assert out["OUTPUT0"] == (a + 2 * a).tolist()
    assert out["OUTPUT1"] == (a - 2 * a).tolist()


def test_a_request_without_expect_is_unchanged(servers):
    """No interim line when the client does not ask for one."""
    import http.client

    answers = {}
    for name, side in servers.items():
        conn = http.client.HTTPConnection("127.0.0.1", side.http.port,
                                          timeout=TIMEOUT)
        conn.request("POST", "/v2/models/simple/infer", _body(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        answers[name] = (resp.status, json.loads(resp.read()))
        conn.close()
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == 200
