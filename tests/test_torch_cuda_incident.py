"""The shm slot ring and the incident blackbox on the card; each test skips
without one.

Run on a machine with an NVIDIA GPU, beside ``tests/test_torch_cuda.py``
(no JAX needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py tests/test_torch_cuda_incident.py

``bert_long`` (K1 bf16, 12 layers) answers a ring slot byte for byte as it
answers the same request over binary HTTP, one request at a time, and
launches K1 once per layer for each. A process whose CUDA context a
device-side assert broke still writes its crash bundle (the crash path
makes no CUDA call; the card's name in its fingerprint is the one the
engine read at start), and the card serves on in this process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import client_tpu_torch.http as httpclient
from client_tpu_torch.engine import TorchEngine
from client_tpu_torch.models import build_repository
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.server import HttpInferenceServer
from client_tpu_torch.utils.shm_ring import RingProducer

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, every wait


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _feed(seq: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    mask = np.ones((1, seq), np.int32)
    mask[0, rng.integers(seq // 4, seq + 1):] = 0
    return {"input_ids": rng.integers(0, 30522, (1, seq)).astype(np.int32),
            "attention_mask": mask}


def test_ring_answer_equals_binary_http_for_bert_long(card):
    engine = TorchEngine(build_repository(["bert_long"]), device=card)
    server = HttpInferenceServer(engine, port=0).start()
    client = httpclient.InferenceServerClient(server.url)
    try:
        model = engine.repository.get("bert_long")
        seq = model.config.input[0].dims[0]
        layers = len(model.backend.layers)
        feeds = [_feed(seq, 7 + i) for i in range(3)]
        outputs = ("pooled_output", "logits")
        with RingProducer(client, "bert", f"/cuda_incident_{os.getpid()}",
                          slot_count=4, slot_bytes=8 * seq) as prod:
            for feed in feeds:
                fa.launches = 0
                prod.fill(feed)
                assert prod.doorbell("bert_long")["admitted"] == 1
                _, ring, err = prod.reap(timeout_s=TIMEOUT)
                assert err is None
                assert fa.launches == layers
                ins = []
                for name, arr in feed.items():
                    inp = httpclient.InferInput(name, list(arr.shape),
                                                "INT32")
                    inp.set_data_from_numpy(arr)
                    ins.append(inp)
                res = client.infer("bert_long", ins)
                for name in outputs:
                    want = res.as_numpy(name)
                    assert ring[name].dtype == want.dtype
                    assert ring[name].tobytes() == want.tobytes(), name
                    assert np.isfinite(want).all()
    finally:
        client.close()
        server.stop()
        engine.shutdown()


_CRASH = r"""
import json, os, sys
import torch
from client_tpu_torch.engine import TorchEngine
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.observability.events import journal

engine = TorchEngine(ModelRepository(), device="cuda")
journal().emit("admission", "shed", severity="WARNING", model="m")
print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
x = torch.zeros(4, device="cuda")
x[torch.tensor([1 << 20], device="cuda")] += 1  # out of range: assert
torch.cuda.synchronize()
print("unreachable", flush=True)
"""


def test_crash_bundle_after_a_cuda_error(card, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO,
               CLIENT_TPU_BLACKBOX=json.dumps({"dir": str(tmp_path)}))
    proc = subprocess.run([sys.executable, "-c", _CRASH], cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=env)
    assert proc.returncode != 0
    assert "unreachable" not in proc.stdout
    device = json.loads(proc.stdout.splitlines()[0])["device"]
    lines = [json.loads(line) for line in proc.stderr.splitlines()
             if line.startswith('{"blackbox": "crash"')]
    assert len(lines) == 1 and "CUDA" in lines[0]["error"]
    crash = [n for n in os.listdir(tmp_path) if n.endswith("-crash.json")]
    assert len(crash) == 1
    bundle = json.loads((tmp_path / crash[0]).read_bytes())
    assert bundle["trigger"] == "crash" and "CUDA" in bundle["note"]
    fp = bundle["sections"]["fingerprint"]
    assert fp["device"] == device
    assert fp["versions"]["torch"] == torch.__version__
    assert fp["versions"]["cuda"] == torch.version.cuda
    assert any(e["category"] == "admission"
               for e in bundle["sections"]["journal"]["events"])
    # This process's context is another: the card serves on.
    assert float(torch.ones(4, device=card).sum()) == 4.0
