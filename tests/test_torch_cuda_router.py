"""The port's router in front of two replicas on the card; each test skips
without one.

Run on a machine with an NVIDIA GPU, beside ``tests/test_torch_cuda.py``
(no JAX needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py tests/test_torch_cuda_router.py

Two engines serving ``bert_long`` (K1 bf16, 12 layers) in this process,
each behind its own HTTP server thread, fronted by the port's
``RouterHttpServer``: every answer through the router is within
``SERVED_ATOL`` of the plain path and carries its replica's load report,
both replicas serve, and K1 launches once per layer of each execution.
Then one replica dies under traffic (its server stops and its sockets
close): the clients see no error and its breaker opens.
"""

import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

import client_tpu_torch.http as httpclient
from client_tpu_torch.engine import TorchEngine
from client_tpu_torch.models import build_repository
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.observability.scrape import parse_samples
from client_tpu_torch.resilience import CircuitBreaker
from client_tpu_torch.router import Replica, Router, RouterHttpServer
from client_tpu_torch.server import HttpInferenceServer

pytestmark = pytest.mark.cuda

# bf16 flash kernel against the plain version through 12 layers (the value
# chip_smoke.py's SERVED_ATOL carries, with its reason there).
SERVED_ATOL = 6e-2
OUTPUTS = ("pooled_output", "logits")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fleet(card):
    engines, servers, conns = [], [], []
    for _ in range(2):
        engine = TorchEngine(build_repository(["bert_long"]), device=card)
        server = HttpInferenceServer(engine, port=0)
        # Keep each server's sockets, so that a test can cut them as a
        # dying process would.
        live = set()
        handler = server.httpd.RequestHandlerClass
        setup = handler.setup

        def tracked(self, setup=setup, live=live):
            setup(self)
            live.add(self.connection)

        handler.setup = tracked
        engines.append(engine)
        servers.append(server.start())
        conns.append(live)
    router = Router([Replica(s.url) for s in servers], seed=3,
                    poll_interval_s=3600.0,
                    breaker=CircuitBreaker(failure_threshold=3,
                                           cooldown_s=1.0))
    front = RouterHttpServer(router, port=0).start()
    yield {"engines": engines, "servers": servers, "conns": conns,
           "router": router, "front": front}
    front.stop()
    for server in servers:
        server.stop()
    for engine in engines:
        engine.shutdown()


def _feeds(seq: int, n: int) -> list:
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        mask = np.ones((1, seq), np.int32)
        mask[0, rng.integers(seq // 4, seq + 1):] = 0
        out.append({"input_ids": rng.integers(0, 30522, (1, seq))
                    .astype(np.int32), "attention_mask": mask})
    return out


def _plain(backend, feed, card) -> dict:
    with torch.inference_mode():
        ref = backend.encode({k: torch.from_numpy(v).to(card)
                              for k, v in feed.items()},
                             fa.flash_attention_plain)
    return {n: ref[n].float().cpu().numpy() for n in OUTPUTS}


def _infer(client, feed) -> dict:
    inputs = []
    for name, arr in feed.items():
        inp = httpclient.InferInput(name, list(arr.shape), "INT32")
        inp.set_data_from_numpy(arr, binary_data=True)
        inputs.append(inp)
    result = client.infer("bert_long", inputs)
    return {n: result.as_numpy(n) for n in OUTPUTS}


def _execs(engine) -> int:
    return sum(s["execution_count"]
               for s in engine.model_statistics()["model_stats"])


def test_answers_through_the_router_match_the_plain_path(fleet, card):
    model = fleet["engines"][0].repository.get("bert_long")
    seq = model.config.input[0].dims[0]
    feeds = _feeds(seq, 12)
    refs = [_plain(model.backend, f, card) for f in feeds]
    before = [_execs(e) for e in fleet["engines"]]
    fa.launches = 0

    def send(k: int) -> list:
        client = httpclient.InferenceServerClient(fleet["front"].url)
        try:
            return [(j, _infer(client, feeds[j]))
                    for j in range(k, len(feeds), 4)]
        finally:
            client.close()

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        answers = [a for part in pool.map(send, range(4)) for a in part]
    execs = sum(_execs(e) for e in fleet["engines"]) - sum(before)
    assert fa.launches == len(model.backend.layers) * execs > 0
    for j, got in answers:
        err = max(float(np.abs(got[n] - refs[j][n]).max()) for n in OUTPUTS)
        assert err <= SERVED_ATOL, (j, err)
    for row in fleet["router"].status()["replicas"].values():
        # Each replica's report came back on its answers (X-Tpu-Load).
        assert row["load_age_s"] is not None
        assert row["load"]["state"] == "READY"
    served = {labels["replica"]: v for name, labels, v in
              parse_samples(fleet["router"].metrics.render())
              if name == "tpu_router_requests_total"
              and labels["outcome"] == "ok"}
    assert len(served) == 2 and all(v > 0 for v in served.values()), served


def test_a_replica_dies_under_traffic(fleet, card):
    model = fleet["engines"][0].repository.get("bert_long")
    seq = model.config.input[0].dims[0]
    feeds = _feeds(seq, 4)
    refs = [_plain(model.backend, f, card) for f in feeds]
    victim = fleet["router"].replicas[0].id
    errors, worst = [], [0.0]
    stop = threading.Event()

    def sender(k: int) -> None:
        client = httpclient.InferenceServerClient(fleet["front"].url)
        try:
            while not stop.is_set():
                try:
                    got = _infer(client, feeds[k])
                except Exception as exc:  # noqa: BLE001 — counted
                    errors.append(repr(exc))
                    continue
                worst[0] = max(worst[0], max(
                    float(np.abs(got[n] - refs[k][n]).max())
                    for n in OUTPUTS))
        finally:
            client.close()

    threads = [threading.Thread(target=sender, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    fleet["servers"][0].stop()
    for conn in list(fleet["conns"][0]):
        try:
            conn.shutdown(2)
            conn.close()
        except OSError:
            pass
    deadline = time.monotonic() + 10
    opened = False
    while not opened and time.monotonic() < deadline:
        opened = fleet["router"].breaker.state(victim) == CircuitBreaker.OPEN
        time.sleep(0.01)
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]
    assert opened, "the dead replica's breaker never opened"
    assert worst[0] <= SERVED_ATOL
