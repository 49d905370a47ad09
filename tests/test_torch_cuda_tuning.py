"""Warm-up, the autotuner's warm probe and the planning arena on the card;
each test skips without one.

Run on a machine with an NVIDIA GPU, beside ``tests/test_torch_cuda.py``
(no JAX needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py tests/test_torch_cuda_tuning.py

A warmed BERT launched K1 bf16 once per layer for each bucket of its
ladder before any request, and its first request is warm; a warmed
generative model launched K1 fp32 and K2 before any request, and its
stream's decode dispatches are warm; ``Model.warm_bucket`` returns a
positive cold time and launches the kernel; a warm execution that fails
on the card fails the load, so the model is not READY and serves
nothing; the arena's budget is the card's total memory times the
fraction, and the census reads a bucket's reservation as plan only.
"""

import os
import threading

import numpy as np
import pytest
import torch

from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.arena import device_hbm_budget
from client_tpu_torch.engine.model import Model
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models.bert import BertBackend
from client_tpu_torch.models.generate import TinyGptBackend
from client_tpu_torch.observability.profiler import profiler
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SMALL = dict(seq_len=200, hidden=256, n_layers=2, n_heads=4, ffn=512,
             vocab=512, max_batch_size=4, attention_impl="flash")
GPT = dict(n_layers=2, d_model=128, n_heads=2, d_ff=256, vocab=256,
           max_seq_len=256, max_streams=4, attention_impl="flash",
           attn_impl="fused")
TIMEOUT = 120  # seconds, every wait


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _engine(**backends) -> TorchEngine:
    repo = ModelRepository()
    for name, build in backends.items():
        repo.register(name, build)
    return TorchEngine(repo, warmup=True)


def test_warmup_launches_k1_once_per_layer_and_bucket(card):
    profiler().reset()
    fa.launches = 0
    engine = _engine(tb=lambda dev: BertBackend(name="tb", device=dev,
                                                **SMALL))
    try:
        warm = fa.launches
        buckets = engine.repository.get("tb").config.effective_buckets()
        assert warm == SMALL["n_layers"] * len(buckets) > 0
        rng = np.random.default_rng(0)
        resp = engine.infer(InferRequest(model_name="tb", inputs={
            "input_ids": rng.integers(0, 512, (3, 200)).astype(np.int32),
            "attention_mask": np.ones((3, 200), np.int32)}),
            timeout_s=TIMEOUT)
        assert resp.times.compile_ns == 0
        assert fa.launches == warm + SMALL["n_layers"]
        assert np.isfinite(resp.outputs["logits"]).all()
    finally:
        engine.shutdown()


def test_generative_warmup_launches_k1_fp32_and_k2(card):
    profiler().reset()
    fa.launches_fp32 = da.launches = 0
    engine = _engine(tg=lambda dev: TinyGptBackend(name="tg", device=dev,
                                                   **GPT))
    try:
        assert fa.launches_fp32 > 0 and da.launches > 0
        done = threading.Event()
        tokens = []

        def cb(resp):
            assert resp.error is None, resp.error
            if resp.final:
                done.set()
            else:
                tokens.append(int(resp.outputs["TOKEN"][0]))

        engine.async_infer(InferRequest(
            model_name="tg", inputs={"INPUT_IDS": np.arange(
                1, 30, dtype=np.int32)}, parameters={"max_tokens": 8}), cb)
        assert done.wait(TIMEOUT) and len(tokens) == 8
        waves = [w for k, w in profiler()._waves.items() if k[0] == "tg"]
        assert sum(w.dispatches for w in waves) >= 7
        assert sum(w.cold_dispatches for w in waves) == 0
    finally:
        engine.shutdown()


def test_warm_bucket_returns_a_cold_time_and_launches(card):
    model = Model(BertBackend(name="wb", device=card, **SMALL), device=card)
    fa.launches = 0
    cold_s = model.warm_bucket(3)  # not in the ladder
    assert cold_s > 0
    assert fa.launches == SMALL["n_layers"]
    assert model.warm_bucket(3) == 0.0  # warm now, and launched again
    assert fa.launches == 2 * SMALL["n_layers"]


def test_the_arena_budget_is_the_cards_memory(card):
    total = torch.cuda.mem_get_info()[1]
    assert device_hbm_budget(0.9, fallback_bytes=1) == int(total * 0.9)
    assert device_hbm_budget(0.25) == int(total * 0.25)


def test_a_failed_warm_execution_on_the_card_fails_the_model(card,
                                                            monkeypatch):
    real = Model.execute_timed

    def broken(self, *args, synthetic=False, **kwargs):
        if synthetic:
            raise RuntimeError("kernel launch failed")
        return real(self, *args, synthetic=synthetic, **kwargs)

    monkeypatch.setattr(Model, "execute_timed", broken)
    engine = TorchEngine(_repo(), warmup=True)
    try:
        (entry,) = [e for e in engine.repository_index()
                    if e["name"] == "ta"]
        assert entry["state"] == "UNAVAILABLE"
        assert "kernel launch failed" in entry["reason"]
        assert engine.scheduler_for("ta") is None
        assert not engine.model_is_ready("ta")
    finally:
        engine.shutdown()


def test_the_census_reads_a_bucket_reservation_as_plan(card):
    os.environ["CLIENT_TPU_AUTOTUNE"] = '{"interval_s": 3600}'
    try:
        engine = TorchEngine(_repo())
    finally:
        del os.environ["CLIENT_TPU_AUTOTUNE"]
    try:
        tuner = engine.autotuner
        plan = sum(r["nbytes"] for r in
                   tuner.arena.snapshot()["reservations"]
                   if r["name"].startswith("bucket:ta:"))
        row = next(r for r in engine.memory_census()["owners"]
                   if (r["model"], r["component"]) == ("ta",
                                                      "autotune_warm"))
        assert row["plan_bytes"] == plan > 0
        assert row["drift_bytes"] == row["plan_bytes"] - row["bytes"]
        assert engine.timeseries_sample()["hbm_reserved"] == \
            tuner.arena.reserved_bytes()
    finally:
        engine.shutdown()


def _repo() -> ModelRepository:
    repo = ModelRepository()
    repo.register("ta", lambda dev: BertBackend(name="ta", device=dev,
                                                **SMALL))
    return repo
