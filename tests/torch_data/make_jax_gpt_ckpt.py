"""Write the JAX-written checkpoint fixture ``jax_gpt_ckpt/``.

A narrow ``tiny_gpt`` (``MODEL`` below; head dim 64, the one the port's
attention kernels are built for) saved by the JAX package's
``client_tpu.engine.checkpoint.save_params``, so its arrays are the
zstd-compressed frames orbax writes, and ``expect.json``: the model's
arguments, each leaf's SHA-256 (of its C-order little-endian bytes, bf16
and fp32 as stored), and the greedy tokens the JAX engine generates from
that checkpoint for ``PROMPTS``. The port restores the fixture with no
JAX (``tests/test_torch_checkpoint.py``, ``tests/test_torch_cuda.py``,
``chip_smoke.py``). Run from the repository root with JAX installed:

    python tests/torch_data/make_jax_gpt_ckpt.py
"""

import hashlib
import json
import os
import shutil
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from client_tpu.engine import InferRequest, TpuEngine  # noqa: E402
from client_tpu.engine.checkpoint import save_params  # noqa: E402
from client_tpu.engine.repository import ModelRepository  # noqa: E402
from client_tpu.models.generate import TinyGptBackend  # noqa: E402

NAME = "jax_gpt_fixture"
MODEL = dict(n_layers=2, d_model=128, n_heads=2, d_ff=512, vocab=512,
             max_seq_len=128, max_streams=4, seed=3, attention_impl="flash")
PROMPTS = [[1, 2, 3], [7] * 9, [5, 17, 200, 33, 101]]
MAX_TOKENS = 8
OUT = os.path.join(HERE, "jax_gpt_ckpt")


def leaf_digests(params) -> dict:
    """Dotted path -> (dtype name, shape, SHA-256 of the leaf's bytes)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        arr = np.ascontiguousarray(np.asarray(leaf))
        out[name] = {"dtype": arr.dtype.name, "shape": list(arr.shape),
                     "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out


def greedy_tokens(ckpt: str) -> list[list[int]]:
    """The JAX engine's greedy streams of ``PROMPTS`` from ``ckpt``."""
    backend = TinyGptBackend(name=NAME, **MODEL)
    backend.weights_path = ckpt
    repo = ModelRepository()
    repo.register_backend(backend)
    engine = TpuEngine(repo)
    try:
        streams = []
        for prompt in PROMPTS:
            toks, done = [], threading.Event()

            def on_response(resp, toks=toks, done=done):
                if resp.error is not None or resp.final:
                    toks.append(resp.error)  # None after the last token
                    done.set()
                else:
                    toks.append(int(resp.outputs["TOKEN"][0]))

            engine.async_infer(InferRequest(
                model_name=NAME,
                inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
                parameters={"max_tokens": MAX_TOKENS}), on_response)
            if not done.wait(600) or toks.pop() is not None:
                raise RuntimeError(f"no stream for {prompt}: {toks}")
            streams.append(toks)
        return streams
    finally:
        engine.shutdown()


def main() -> None:
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    params = TinyGptBackend(name=NAME, **MODEL)._init_params()
    ckpt = save_params(os.path.join(OUT, "ckpt"), params)
    expect = {"name": NAME, "model": MODEL, "prompts": PROMPTS,
              "max_tokens": MAX_TOKENS, "leaves": leaf_digests(params),
              "greedy_tokens": greedy_tokens(ckpt)}
    with open(os.path.join(OUT, "expect.json"), "w") as f:
        json.dump(expect, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
