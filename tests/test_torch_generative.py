"""The port's continuous-batching engine against the JAX package's.

``TorchEngine(device="cpu")`` and ``TpuEngine`` serve the same small
``tiny_gpt`` (``TestFusedDecode.KW``: 2 layers, d_model 64, 2 heads, vocab
128, max_seq 32, 4 streams); greedy and seeded sampled streams must be
equal token for token, on both decode paths. Then the scheduler's own
contract: batch invariance, more streams than rows, stop tokens, the 400s
of request validation, the sync-infer 400, cancellation freeing the row,
and chunked decode equal to per-wave decode.
"""

import threading
import time

import numpy as np
import pytest

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.models.generate import TinyGptBackend as JaxGpt
from client_tpu_torch.engine import EngineError, InferRequest, TorchEngine
from client_tpu_torch.engine.generative import GenerativeScheduler
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models.generate import TinyGptBackend

KW = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
          max_seq_len=32, max_streams=4)

# TestFusedDecode._stream_suite: greedy over three prompt lengths, then the
# seed-42 and seed-7 sampled streams.
SUITE = [([1, 2, 3], 6, {}), ([7] * 9, 6, {}), ([5], 6, {}),
         ([4, 4], 8, dict(temperature=1.0, seed=42)),
         ([4, 4], 8, dict(temperature=0.8, seed=7, top_k=24, top_p=0.9))]


def _engine(attn_impl="fused", **overrides):
    repo = ModelRepository()
    repo.register("tg", lambda device: TinyGptBackend(
        name="tg", attn_impl=attn_impl, device=device,
        **{**KW, **overrides}))
    return TorchEngine(repo, device="cpu")


def _gen_async(eng, prompt, n, request_cls=InferRequest, backpressure=None,
               **params):
    """Start one stream (with ``backpressure`` as its frontend's probe);
    returns (request, join() -> tokens)."""
    toks, errs, done = [], [], threading.Event()

    def cb(resp):
        if resp.error is not None:
            errs.append(resp.error)
            done.set()
        elif resp.final:
            done.set()
        else:
            assert int(resp.outputs["INDEX"][0]) == len(toks)
            toks.append(int(resp.outputs["TOKEN"][0]))

    req = request_cls(model_name="tg",
                      inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
                      parameters={"max_tokens": n, **params})
    req.backpressure = backpressure
    eng.async_infer(req, cb)

    def join():
        assert done.wait(120), "stream stalled"
        if errs:
            raise errs[0]
        return toks

    return req, join


def _gen(eng, prompt, n, **params):
    return _gen_async(eng, prompt, n, **params)[1]()


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX engine's suite streams, per decode path."""
    out = {}
    for impl in ("reference", "fused"):
        repo = JaxRepository()
        repo.register_backend(JaxGpt(name="tg", attn_impl=impl, **KW))
        eng = TpuEngine(repo)
        try:
            out[impl] = [_gen(eng, p, n, request_cls=JaxRequest, **kw)
                         for p, n, kw in SUITE]
        finally:
            eng.shutdown()
    return out


@pytest.fixture(scope="module")
def eng():
    e = _engine()
    yield e
    e.shutdown()


@pytest.mark.parametrize("attn_impl", ["reference", "fused"])
def test_streams_equal_the_jax_engine(jax_streams, attn_impl):
    e = _engine(attn_impl)
    try:
        assert isinstance(e._schedulers["tg"], GenerativeScheduler)
        got = [_gen(e, p, n, **kw) for p, n, kw in SUITE]
    finally:
        e.shutdown()
    assert got == jax_streams[attn_impl]
    assert all(len(t) == n for t, (_, n, _) in zip(got, SUITE))


def _concurrently(eng, prompts, n):
    joins = [_gen_async(eng, p, n)[1] for p in prompts]
    return [j() for j in joins]


def test_batch_invariance(eng):
    prompts = [[i, i + 1, i + 2] for i in range(1, 5)]
    solo = [_gen(eng, p, 8) for p in prompts]
    assert _concurrently(eng, prompts, 8) == solo


def test_more_streams_than_rows_all_complete(eng):
    prompts = [[i + 1, (3 * i) % 128] for i in range(12)]
    solo = [_gen(eng, p, 5) for p in prompts]
    assert _concurrently(eng, prompts, 5) == solo
    sched = eng._schedulers["tg"]
    assert not sched._streams and len(sched._free) == KW["max_streams"]


def test_stop_token_ends_the_stream_unemitted(eng):
    full = _gen(eng, [9, 8, 7], 10)
    stop = full[3]
    first = full.index(stop)
    got = _gen(eng, [9, 8, 7], 10, stop_token_ids=f"{stop},127")
    assert got == full[:first]
    assert _gen(eng, [9, 8, 7], 10, eos_id=stop) == full[:first]


@pytest.mark.parametrize("prompt,params", [
    ([1, 2], {"max_tokens": "many"}),
    ([1, 2], {"max_tokens": 0}),
    ([], {}),
    ([1] * 20, {"max_tokens": 13}),          # 20 + 13 > max_seq 32
    ([1, 128], {}),                          # id outside the vocab
    ([-1], {}),
    ([1], {"seed": "x"}),
    ([1], {"temperature": "hot"}),
    ([1], {"temperature": -0.5}),
    ([1], {"temperature": float("nan")}),
    ([1], {"top_k": -1}),
    ([1], {"top_k": float("inf")}),
    ([1], {"top_p": 1.5}),
    ([1], {"top_p": 0.0}),
    ([1], {"stop_token_ids": "3,x"}),
    ([1], {"stop_token_ids": 128}),
])
def test_invalid_requests_are_400(eng, prompt, params):
    params = {"max_tokens": 4, **params}
    n = params.pop("max_tokens")
    with pytest.raises(EngineError) as exc:
        _gen(eng, prompt, n, **params)
    assert exc.value.status == 400


def test_sync_infer_on_a_decoupled_model_is_400(eng):
    with pytest.raises(EngineError) as exc:
        eng.infer(InferRequest(model_name="tg",
                               inputs={"INPUT_IDS": np.array([1], np.int32)}))
    assert exc.value.status == 400
    assert eng.model_config("tg")["model_transaction_policy"] == {
        "decoupled": True}
    assert "generate" in eng.server_metadata()["extensions"]


def test_cancellation_frees_the_row(eng):
    sched = eng._schedulers["tg"]
    reqs = []
    for i in range(KW["max_streams"]):
        # A backpressure probe that never clears parks every stream, so
        # all rows are held until the cancel.
        reqs.append(_gen_async(eng, [i + 1], 30, backpressure=lambda: True))
    deadline = time.monotonic() + 30
    while sched._free and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not sched._free
    for req, _ in reqs:
        req.cancel()
    for _, join in reqs:
        with pytest.raises(EngineError) as exc:
            join()
        assert exc.value.status == 499
    assert _gen(eng, [3, 4], 4)  # rows are free again
    assert len(sched._free) == KW["max_streams"]


def test_backpressure_probe_that_raises_throttles_nothing(eng):
    _, join = _gen_async(eng, [5, 6], 6, backpressure=lambda: 1 / 0)
    assert join() == _gen(eng, [5, 6], 6)


def test_chunked_decode_equals_per_wave(eng, monkeypatch):
    want = [_gen(eng, p, 13) for p in ([7, 8], [1] * 17)]
    monkeypatch.setenv("CLIENT_TPU_GEN_CHUNK", "4")
    chunked = _engine()
    try:
        assert chunked._schedulers["tg"]._chunk == 4
        assert [_gen(chunked, p, 13) for p in ([7, 8], [1] * 17)] == want
        stats = chunked.model_statistics("tg")["model_stats"][0]
        # 2 prefills and far fewer dispatches than the 24 tokens decoded.
        assert stats["execution_count"] < 2 + 24
    finally:
        chunked.shutdown()
