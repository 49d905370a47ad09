"""Entry points of the port: one forward on the flagship model, and the
multi-chip dry run.

Counterpart of the repository's ``__graft_entry__.py``:

- :func:`entry` returns BERT-base's forward (12 layers, hidden 768, seq
  128, the zoo's ``bert_base``) and example args of batch 8.
- :func:`dryrun_multichip` runs, on a mesh of ``n_devices`` shards that
  repeat one device (the card by default, or the CPU), the three train
  steps (dp x sp x tp, dp x pp, dp x ep x tp) and the five served dry runs
  of the JAX package at its shapes: a dp x tp BERT, sequence-parallel ring
  attention, tp-sharded generation (head dim 8: kernel K2 on the card), the
  served MoE and pipelined LMs, and ep x tp expert-parallel decode (head
  dim 16), each through ``TorchEngine``.

    python -c "from client_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from client_tpu_torch.parallel.training import _mesh_on


def entry(device=None):
    """BERT-base's forward (the zoo's ``bert_base``) on ``device`` (None:
    the card) and its example args: ``fn(*args)`` returns ``logits [8, 2]``
    and ``pooled_output [8, 768]``. ``fn`` is the backend module itself
    (weights in ``load_jax_params``' layout)."""
    from client_tpu_torch.models.bert import BertBackend

    backend = BertBackend(device=device)
    batch, seq = 8, backend.config.input[0].dims[0]
    dev = backend.tok_embed.device
    example_args = ({
        "input_ids": torch.full((batch, seq), 7, dtype=torch.int32,
                                device=dev),
        "attention_mask": torch.ones((batch, seq), dtype=torch.int32,
                                     device=dev),
    },)
    return backend, example_args


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The full multi-chip dry run over ``n_devices`` shards of ``device``
    (None: the card; ``"cpu"`` on purpose): dp x sp x tp training, dp x pp
    pipeline training, dp x ep x tp MoE training, dp x tp served BERT,
    sequence-parallel ring attention, tp sharded generation, the served
    MoE / pipelined LM families, and ep x tp expert-parallel decode.
    Returns each train step's loss and each generative run's tokens."""
    from client_tpu_torch.engine.backend_init import resolve_device
    from client_tpu_torch.parallel.moe import dryrun_moe_step
    from client_tpu_torch.parallel.pipeline import dryrun_pipeline_step
    from client_tpu_torch.parallel.training import dryrun_training_step

    device = resolve_device(device)
    out = {
        "train": dryrun_training_step(n_devices, device=device),
        "pipeline": dryrun_pipeline_step(n_devices, device=device),
        "moe": dryrun_moe_step(n_devices, device=device),
    }
    _dryrun_sharded_inference(n_devices, device)
    _dryrun_sequence_parallel(n_devices, device)
    out["gpt_tiny_mc"] = _dryrun_sharded_generation(n_devices, device)
    _dryrun_served_lm_families(n_devices, device)
    out["moe_gpt_dry"] = _dryrun_moe_generation(n_devices, device)
    return out


def _serve(backend, device, run):
    """``run(engine)`` on an engine serving ``backend`` alone."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository

    repo = ModelRepository()
    repo.register(backend.config.name, lambda _dev: backend)
    engine = TorchEngine(repo, device=device)
    try:
        return run(engine)
    finally:
        engine.shutdown()


def _infer(engine, name: str, inputs: dict) -> dict:
    from client_tpu_torch.engine import InferRequest

    resp = engine.infer(InferRequest(model_name=name, inputs=inputs),
                        timeout_s=300)
    return resp.outputs


def _dryrun_sharded_inference(n_devices: int, device) -> None:
    """A (dp, tp) mesh BERT with tiny shapes through the engine."""
    from client_tpu_torch.parallel.serving import ShardedBertBackend

    backend = ShardedBertBackend(
        _mesh_on(n_devices, ("dp", "tp"), device), name="bert_tiny_mc",
        seq_len=16, hidden=64, n_layers=2, n_heads=4, ffn=128, vocab=512,
        max_batch_size=8, device=device)
    ones = np.ones((2, 16), dtype=np.int32)
    out = _serve(backend, device, lambda e: _infer(
        e, "bert_tiny_mc", {"input_ids": ones, "attention_mask": ones}))
    logits = np.asarray(out["logits"])
    assert logits.shape == (2, 2) and np.isfinite(logits).all(), out


def _dryrun_sequence_parallel(n_devices: int, device) -> None:
    """Ring attention over a (dp, sp) mesh, served through the engine."""
    from client_tpu_torch.parallel.serving import LongContextBertBackend

    backend = LongContextBertBackend(
        _mesh_on(n_devices, ("dp", "sp"), device), name="bert_sp_tiny",
        seq_len=32, hidden=64, n_layers=2, n_heads=4, ffn=128, vocab=512,
        max_batch_size=4, device=device)
    ones = np.ones((2, 32), dtype=np.int32)
    out = _serve(backend, device, lambda e: _infer(
        e, "bert_sp_tiny", {"input_ids": ones, "attention_mask": ones}))
    logits = np.asarray(out["logits"])
    assert logits.shape == (2, 2) and np.isfinite(logits).all(), out


def stream(engine, name: str, prompt, max_tokens: int) -> list[int]:
    """One greedy stream through ``engine.async_infer``: its tokens."""
    from client_tpu_torch.engine import InferRequest

    tokens, errors, done = [], [], threading.Event()

    def cb(resp):
        if resp.error is not None:
            errors.append(resp.error)
            done.set()
        elif resp.final:
            done.set()
        else:
            tokens.append(int(resp.outputs["TOKEN"][0]))

    engine.async_infer(InferRequest(
        model_name=name, inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
        parameters={"max_tokens": max_tokens}), cb)
    assert done.wait(300), f"{name}: generation stalled"
    assert not errors, errors
    return tokens


def _dryrun_sharded_generation(n_devices: int, device) -> list[int]:
    """Tensor-parallel tiny GPT (8 heads of dim 8, the KV arena split on
    its heads) streamed through the continuous-batching scheduler."""
    from client_tpu_torch.parallel.serving import ShardedTinyGptBackend

    backend = ShardedTinyGptBackend(
        _mesh_on(n_devices, ("tp",), device), name="gpt_tiny_mc", n_layers=2,
        d_model=64, n_heads=8, d_ff=128, vocab=256, max_seq_len=32,
        max_streams=4, device=device)
    tokens = _serve(backend, device,
                    lambda e: stream(e, "gpt_tiny_mc", [1, 2, 3], 4))
    assert len(tokens) == 4 and all(0 <= t < 256 for t in tokens), tokens
    return tokens


def _dryrun_served_lm_families(n_devices: int, device) -> None:
    """The served MoE (dp x ep x tp) and pipelined (dp x pp) LMs: one
    request each through the engine."""
    from client_tpu_torch.parallel.serving import (
        MoeLmBackend,
        PipelinedLmBackend,
    )

    for backend in (
            MoeLmBackend(_mesh_on(n_devices, ("dp", "ep", "tp"), device),
                         device=device),
            PipelinedLmBackend(_mesh_on(n_devices, ("dp", "pp"), device),
                               device=device)):
        ids = (np.arange(2 * backend.seq_len, dtype=np.int32)
               .reshape(2, backend.seq_len) % backend.vocab)
        out = _serve(backend, device, lambda e: _infer(
            e, backend.config.name, {"INPUT_IDS": ids}))
        logits = np.asarray(out["LOGITS"])
        assert logits.shape == (2, backend.seq_len, backend.vocab), \
            logits.shape
        assert np.isfinite(logits).all()


def _dryrun_moe_generation(n_devices: int, device) -> list[int]:
    """Expert-parallel decode: the MoE GPT (4 heads of dim 16, experts on
    ep, heads on tp) streamed through the continuous-batching scheduler."""
    from client_tpu_torch.parallel.serving import MoeGptBackend

    backend = MoeGptBackend(
        _mesh_on(n_devices, ("ep", "tp"), device), name="moe_gpt_dry",
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256,
        max_seq_len=32, max_streams=4, device=device)
    tokens = _serve(backend, device,
                    lambda e: stream(e, "moe_gpt_dry", [1, 2, 3], 4))
    assert len(tokens) == 4 and all(0 <= t < 256 for t in tokens), tokens
    return tokens


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        got = fn(*args)
    print("entry() OK:", {k: tuple(v.shape) for k, v in got.items()})
    print("dryrun_multichip OK:", dryrun_multichip(8))
