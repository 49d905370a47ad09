"""Overload protection and the census planes on the card; each test skips
without one.

Run on a machine with an NVIDIA GPU, beside ``tests/test_torch_cuda.py``
(no JAX needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py tests/test_torch_cuda_overload.py

An expired batch launches no kernel, before or after the scheduler; the
census's rows on the card equal the parameter and arena bytes and stay
under the allocator's; the ledger's device seconds reconcile with the
profiler's; a drain lets a stream of K1 fp32 and K2 launches finish.
"""

import threading

import numpy as np
import pytest
import torch

from client_tpu_torch.admission.drain import drain
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.engine.types import DeadlineExpired, now_ns
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.models.dlrm import DlrmBackend
from client_tpu_torch.models.generate import TinyGptBackend
from client_tpu_torch.observability import costs
from client_tpu_torch.observability.memory import (
    reset_hbm_census,
    tensor_leaves,
)
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SMALL = dict(seq_len=200, hidden=256, n_layers=2, n_heads=4, ffn=512,
             vocab=512, max_batch_size=4)
GPT = dict(n_layers=2, d_model=128, n_heads=2, d_ff=256, vocab=256,
           max_seq_len=256, max_streams=4, attention_impl="flash",
           attn_impl="fused")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _engine(**builders) -> TorchEngine:
    repo = ModelRepository()
    for name, build in builders.items():
        repo.register(name, build)
    return TorchEngine(repo)


def _bert_request(**kw) -> InferRequest:
    ids = np.zeros((1, SMALL["seq_len"]), np.int32)
    return InferRequest(model_name="b", inputs={
        "input_ids": ids, "attention_mask": np.ones_like(ids)}, **kw)


def test_an_expired_batch_launches_no_kernel(card):
    engine = _engine(b=lambda device: BertBackend(name="b", device=device,
                                                  attention_impl="flash",
                                                  **SMALL))
    try:
        model = engine.repository.get("b")
        ids = np.zeros((1, SMALL["seq_len"]), np.int32)
        inputs = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
        before = fa.launches
        with pytest.raises(DeadlineExpired):
            model.execute_timed(inputs, batch_size=1,
                                deadline_ns=now_ns() - 1)
        assert fa.launches == before
        # Through the engine: expired on arrival, then with time to spare.
        req = _bert_request()
        req.deadline_ns = now_ns() - 1
        with pytest.raises(DeadlineExpired):
            engine.infer(req)
        assert fa.launches == before
        engine.infer(_bert_request())
        assert fa.launches == before + SMALL["n_layers"]
    finally:
        engine.shutdown()


def test_the_census_on_the_card(card):
    reset_hbm_census()
    engine = _engine(
        b=lambda device: BertBackend(name="b", device=device, **SMALL),
        g=lambda device: TinyGptBackend(name="g", device=device, **GPT),
        d=lambda device: DlrmBackend(name="d", device=device,
                                     emb_devices=[device] * 2,
                                     emb_shards=2, combine="ring"))
    try:
        report = engine.memory_census()
        rows = {(r["model"], r["component"]): r for r in report["owners"]}
        bert = engine.repository.get("b").backend
        assert rows[("b", "weights")]["bytes"] == sum(
            p.numel() * p.element_size() for p in bert.parameters())
        arena = tensor_leaves(engine.scheduler_for("g")._arena)
        assert rows[("g", "kv_arena")]["bytes"] == sum(
            t.numel() * t.element_size() for t in arena)
        assert rows[("d", "embedding")]["drift_bytes"] == 0
        assert 0 < report["attributed_bytes"] <= torch.cuda.memory_allocated()
        device = report["devices"][0]
        assert device["bytes_limit"] == torch.cuda.mem_get_info(0)[1] \
            == torch.cuda.get_device_properties(0).total_memory
        assert device["bytes_in_use"] > 0
    finally:
        engine.shutdown()


def test_the_ledger_reconciles_with_the_profiler_on_the_card(card):
    costs.ledger().reset()
    engine = _engine(b=lambda device: BertBackend(name="b", device=device,
                                                  **SMALL))
    engine.profiler.reset()
    try:
        for tenant in ("a", "b", "a", "b", ""):
            engine.infer(_bert_request(tenant=tenant))
        rec = engine.costs_snapshot(model="b")["reconciliation"]
    finally:
        engine.shutdown()
    assert 0.95 <= rec["device_s_ratio"] <= 1.05


def test_a_drain_finishes_a_stream_on_the_card(card):
    engine = _engine(g=lambda device: TinyGptBackend(name="g", device=device,
                                                     **GPT))
    tokens, done = [], threading.Event()

    def cb(resp):
        if resp.error is not None or resp.final:
            done.set()
        else:
            tokens.append(int(resp.outputs["TOKEN"][0]))

    k1, k2 = fa.launches_fp32, da.launches
    engine.async_infer(InferRequest(
        model_name="g", inputs={"INPUT_IDS": np.arange(9, dtype=np.int32)},
        parameters={"max_tokens": 200}), cb)
    while not tokens:  # mid-generation
        assert not done.wait(0.001)
    report = drain(engine, deadline_s=60)
    assert done.is_set() and len(tokens) == 200
    assert report["clean"] and report["pending"] == 0
    assert fa.launches_fp32 > k1 and da.launches - k2 >= 199
    assert engine.health_state() == "DRAINING" and not engine.is_ready()
