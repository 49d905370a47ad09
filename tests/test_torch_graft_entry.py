"""The port's entry points (``client_tpu_torch/graft_entry.py``) against the
repository's ``__graft_entry__.py``, on the CPU.

``entry(device="cpu")`` is BERT-base's forward at batch 8, seq 128: with
the JAX ``entry()``'s weights carried over (``load_jax_params``) its
outputs equal JAX's within BERT's tolerance of the port's other tests
(logits 2e-2, pooled output 4e-2: bf16 weights and activations, rounded
at other places by the two frameworks). ``dryrun_multichip`` runs the
three train steps and the five served dry runs on a mesh of CPU shards.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from client_tpu_torch import graft_entry

ATOL = {"logits": 2e-2, "pooled_output": 4e-2}


@pytest.fixture(scope="module")
def both():
    jfn, jargs = jax_entry.entry()
    want = {k: np.asarray(v) for k, v in jax.jit(jfn)(*jargs).items()}
    fn, args = graft_entry.entry(device="cpu")
    fn.load_jax_params(jax.tree_util.tree_map(np.asarray, jargs[0]))
    with torch.inference_mode():
        got = {k: v.float().numpy() for k, v in fn(*args).items()}
    return jargs, args, want, got


def test_entry_shapes(both):
    _, _, want, got = both
    assert got["logits"].shape == want["logits"].shape == (8, 2)
    assert got["pooled_output"].shape == want["pooled_output"].shape == (
        8, 768)


@pytest.mark.parametrize("name", ["logits", "pooled_output"])
def test_entry_equals_jax(both, name):
    _, _, want, got = both
    assert np.isfinite(got[name]).all()
    np.testing.assert_allclose(got[name], want[name], atol=ATOL[name])


def test_entry_example_args_equal_jax(both):
    jargs, args, _, _ = both
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(args[0][key].numpy(),
                                      np.asarray(jargs[1][key]))


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(8)


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip(n):
    out = graft_entry.dryrun_multichip(n, device="cpu")
    for step in ("train", "pipeline", "moe"):
        assert np.isfinite(out[step]) and out[step] > 0
    for name in ("gpt_tiny_mc", "moe_gpt_dry"):
        assert len(out[name]) == 4 and all(0 <= t < 256 for t in out[name])
