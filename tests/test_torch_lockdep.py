"""The port's lockdep (``client_tpu_torch/utils/lockdep.py``) against the
JAX package's.

* Each case of ``tests/test_lockdep.py`` runs against the port's module:
  the reference's test function, with its module global ``lockdep`` and
  its ``dep`` fixture bound to the port's module.
* The port's declared ranks equal the JAX package's on every name both
  have, and every name the port's lock sites use is one the JAX package
  uses or one of the port's own, ranked innermost.
* A fresh process under ``CLIENT_TPU_LOCKDEP=1`` (every lock a lockdep
  lock from import on) serves ``simple`` and a small BERT on the CPU over
  HTTP and gRPC, rings doorbells of both wires, drives a reaped ring over
  a staged dataset and takes blackbox captures, with no violation on
  lockdep's record (which keeps the violations a caller swallowed).
"""

import ast
import inspect
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest

import client_tpu.utils.lockdep as jax_lockdep
import test_lockdep as ref
from client_tpu_torch.utils import lockdep

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_CASES = sorted(name for name, fn in vars(ref).items()
                   if name.startswith("test_") and inspect.isfunction(fn))


@pytest.fixture
def dep():
    """The reference's fixture, on the port's module: checking on, a
    clean graph, the earlier state restored after."""
    was_enabled = lockdep.enabled()
    lockdep.enable()
    lockdep.reset()
    yield lockdep
    lockdep.reset()
    if not was_enabled:
        lockdep.disable()


def test_the_reference_has_its_cases():
    assert len(REF_CASES) == 17


@pytest.mark.parametrize("name", REF_CASES)
def test_reference_case_on_the_port(name, request):
    fn = getattr(ref, name)
    ported = types.FunctionType(
        fn.__code__, {**fn.__globals__, "lockdep": lockdep}, fn.__name__,
        fn.__defaults__, fn.__closure__)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    ported(**kwargs)


def _port_lock_names() -> set[str]:
    """Every name a lock site of the port passes to a lockdep factory."""
    names = set()
    for path in (REPO / "client_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("Lock", "RLock", "Condition")
                    and getattr(node.func.value, "id", "") == "lockdep"):
                assert node.args and isinstance(node.args[0], ast.Constant), (
                    f"{path}:{node.lineno} makes an unnamed lock")
                names.add(node.args[0].value)
    return names


def test_declared_order_equals_the_jax_packages_on_shared_names():
    shared = set(lockdep.DECLARED_ORDER) & set(jax_lockdep.DECLARED_ORDER)
    assert shared == set(jax_lockdep.DECLARED_ORDER)
    for name in shared:
        assert lockdep.DECLARED_ORDER[name] \
            == jax_lockdep.DECLARED_ORDER[name], name


def test_every_port_lock_is_named_as_in_the_jax_package_or_innermost():
    port = _port_lock_names()
    jax_names = set()
    for path in (REPO / "client_tpu").rglob("*.py"):
        text = path.read_text()
        for kind in ("Lock", "RLock", "Condition"):
            for chunk in text.split(f"lockdep.{kind}(\"")[1:]:
                jax_names.add(chunk.split("\"", 1)[0])
    own = port - jax_names
    assert own, "the port has locks of its own"
    top = max(jax_lockdep.DECLARED_ORDER.values())
    for name in own:
        assert lockdep.DECLARED_ORDER.get(name, 0) > top, name
    assert len(port) >= 40


def test_no_plain_lock_outside_lockdep():
    """Every lock of the port is made by a lockdep factory (lockdep's own
    graph lock and primitives aside)."""
    for path in (REPO / "client_tpu_torch").rglob("*.py"):
        if path.name == "lockdep.py":
            continue
        text = path.read_text()
        for plain in ("threading.Lock(", "threading.RLock(",
                      "threading.Condition("):
            assert plain not in text, f"{path}: {plain}"


def _inversion(dep):
    a, b = dep.Lock("t.a"), dep.Lock("t.b")
    with a, b:
        pass
    with b, a:
        pass


def _declared_rank(dep):
    outer = dep.Lock("t.outer", order=1)
    inner = dep.Lock("t.inner", order=2)
    with inner, outer:
        pass


def _self_deadlock(dep):
    lk = dep.Lock("t.self")
    with lk, lk:
        pass


def _sleep_under_lock(dep):
    with dep.Lock("t.sleep"):
        import time
        time.sleep(0)


@pytest.mark.parametrize("case", [
    (_inversion, "LockOrderViolation", "lock-order inversion"),
    (_declared_rank, "LockOrderViolation", "declared-order violation"),
    (_self_deadlock, "LockOrderViolation", "self-deadlock"),
    (_sleep_under_lock, "BlockingUnderLock", "time.sleep(0)"),
], ids=["inversion", "declared_rank", "self_deadlock", "sleep_under_lock"])
def test_a_swallowed_violation_stays_on_record(dep, case):
    """A caller that catches the raise (a journal sink's guard does) does
    not erase the violation: ``violations()`` keeps its first line until
    ``reset()``."""
    body, kind, words = case
    assert dep.violations() == []
    try:
        body(dep)
    except getattr(dep, kind):
        pass
    else:
        pytest.fail(f"{body.__name__} raised no {kind}")
    found = dep.violations()
    assert len(found) == 1 and words in found[0] and "\n" not in found[0]
    dep.reset()
    assert dep.violations() == []


_SERVE = r"""
import json, os, sys, time
import numpy as np
from client_tpu_torch.utils import lockdep
assert lockdep.enabled()
import client_tpu_torch.grpc as grpcclient
import client_tpu_torch.http as httpclient
from client_tpu_torch.engine import TorchEngine
from client_tpu_torch.models import build_repository
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer
from client_tpu_torch.utils.shm_ring import RingProducer, staged_inputs_meta
from client_tpu_torch.utils.shm_ring.staged import build_staged_dataset

repo = build_repository(["simple", "simple_sequence"])
repo.register("bert_small", lambda device: BertBackend(
    name="bert_small", device=device, seq_len=32, hidden=64, n_layers=2,
    n_heads=4, ffn=128, vocab=512, max_batch_size=4))
eng = TorchEngine(repo, device="cpu", warmup=True)
http = HttpInferenceServer(eng, port=0).start()
grpc = GrpcInferenceServer(eng, port=0).start()
hc = httpclient.InferenceServerClient(http.url, concurrency=4)
gc = grpcclient.InferenceServerClient(grpc.url)
pid = os.getpid()
a = np.arange(16, dtype=np.int32).reshape(1, 16)
for c, mod in ((hc, httpclient), (gc, grpcclient)):
    with RingProducer(c, "r", f"/ld_ring_{pid}", slot_count=8,
                      slot_bytes=4096) as prod:
        for i in range(6):
            prod.fill({"INPUT0": a + i, "INPUT1": a})
        assert prod.doorbell("simple")["admitted"] == 6
        for i in range(6):
            _, out, err = prod.reap(timeout_s=60)
            assert err is None and (out["OUTPUT0"] == 2 * a + i).all()
    ids = np.ones((2, 32), np.int32)
    ins = [mod.InferInput("input_ids", [2, 32], "INT32"),
           mod.InferInput("attention_mask", [2, 32], "INT32")]
    for inp in ins:
        inp.set_data_from_numpy(ids)
    assert c.infer("bert_small", ins).as_numpy("logits").shape[0] == 2
    assert "id" in c.capture_bundle(note="lockdep")
# Concurrent requests through the dynamic batcher.
reqs = []
for i in range(16):
    i0 = httpclient.InferInput("INPUT0", [1, 16], "INT32")
    i0.set_data_from_numpy(a + i)
    i1 = httpclient.InferInput("INPUT1", [1, 16], "INT32")
    i1.set_data_from_numpy(a)
    reqs.append(hc.async_infer("simple", [i0, i1]))
for r in reqs:
    r.get_result()
# A sequence, and a reaped ring over a staged dataset.
for step in range(3):
    i0 = httpclient.InferInput("INPUT", [1], "INT32")
    i0.set_data_from_numpy(np.array([step], np.int32))
    hc.infer("simple_sequence", [i0], sequence_id=7,
             sequence_start=step == 0, sequence_end=step == 2)
tensors = {"INPUT0": np.stack([np.arange(16, dtype=np.int32) + r
                               for r in range(4)]),
           "INPUT1": np.full((4, 16), 3, np.int32)}
refs = lambda r: {"INPUT0": ("INPUT0", r, 1), "INPUT1": ("INPUT1", r, 1)}
ds = build_staged_dataset(f"/ld_ds_{pid}", tensors)
try:
    hc.register_staged_dataset("ds", f"/ld_ds_{pid}")
    spec = {"model_name": "simple", "inputs": staged_inputs_meta(refs(0)),
            "dataset": "ds"}
    with RingProducer(hc, "rr", f"/ld_rr_{pid}", slot_count=4,
                      slot_bytes=4096, dataset=ds, dataset_name="ds",
                      spec=spec) as prod:
        for r in range(4):
            while prod.fill_staged(refs(r)) is None:
                time.sleep(0.001)
        for r in range(4):
            _, out, err = prod.reap(timeout_s=60)
            assert err is None
    hc.unregister_staged_dataset("ds")
finally:
    ds.close(unlink=True)
hc.close()
gc.close()
grpc.stop()
http.stop()
eng.shutdown()
print(json.dumps({"graph": lockdep.graph(),
                  "violations": lockdep.violations()}))
"""


def test_fresh_process_serves_under_lockdep(tmp_path):
    env = dict(os.environ, CLIENT_TPU_LOCKDEP="1", PYTHONPATH=str(REPO),
               CLIENT_TPU_BLACKBOX=json.dumps({"dir": str(tmp_path)}))
    proc = subprocess.run([sys.executable, "-c", _SERVE], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LockOrderViolation" not in proc.stderr
    assert "BlockingUnderLock" not in proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    # Raised or swallowed, no violation was recorded.
    assert record["violations"] == []
    graph = record["graph"]
    # The checked locks really were lockdep's: a load nests the
    # repository's state lock under its per-name load lock.
    assert "engine.repository" in graph["engine.repository.load"]
    assert len([n for n in os.listdir(tmp_path)
                if n.endswith("-manual.json")]) == 2
