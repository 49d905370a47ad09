"""The port's BERT against the JAX package's, with the same weights.

The JAX ``BertBackend``'s params go across with ``params_from_jax``; the
same seeded inputs, padded rows included, go through both. The JAX flash
path runs its Pallas kernel in interpret mode off-TPU. Tolerance 2e-2, as
in ``tests/test_ops.py``: bf16 weights and activations, and the two
frameworks round some elementwise steps (GELU) at different places.
"""

import jax
import numpy as np
import pytest
import torch

from client_tpu.models import bert as jax_bert
from client_tpu.models import model_names as jax_model_names
from client_tpu_torch.models import bert as torch_bert
from client_tpu_torch.models import build_repository, model_names

SMALL = dict(seq_len=64, hidden=64, n_layers=2, n_heads=4, ffn=128,
             vocab=512, max_batch_size=4)


@pytest.fixture(scope="module", params=["einsum", "flash"])
def pair(request):
    """(JAX apply fn, JAX params, port backend with the same weights)."""
    impl = request.param
    fn, params = jax_bert.BertBackend(
        name=f"jax_{impl}", attention_impl=impl, **SMALL).make_apply_params()
    port = torch_bert.BertBackend(name=f"torch_{impl}", attention_impl=impl,
                                  device="cpu", **SMALL)
    port.load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return fn, params, port


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL["vocab"], (3, 64)).astype(np.int32)
    mask = np.ones((3, 64), np.int32)
    mask[1, -11:] = 0   # padded tail
    mask[2, 20:] = 0    # mostly padding
    return ids, mask


def _run_port(port, ids, mask, attend=None):
    inputs = {"input_ids": torch.from_numpy(ids),
              "attention_mask": torch.from_numpy(mask)}
    with torch.inference_mode():
        out = port.encode(inputs, attend or port.attend)
    return {k: v.numpy() for k, v in out.items()}


def test_port_matches_jax(pair):
    fn, params, port = pair
    ids, mask = _inputs()
    want = {k: np.asarray(v) for k, v in
            fn(params, {"input_ids": ids, "attention_mask": mask}).items()}
    got = _run_port(port, ids, mask)
    for name in ("logits", "pooled_output"):
        assert got[name].shape == want[name].shape
        assert got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], want[name], atol=2e-2, rtol=0)


def test_flash_and_einsum_paths_agree(pair):
    _, _, port = pair
    ids, mask = _inputs(seed=6)
    flash = _run_port(port, ids, mask,
                      torch_bert._flash.flash_attention)
    einsum = _run_port(port, ids, mask, torch_bert.einsum_attention)
    np.testing.assert_allclose(flash["logits"], einsum["logits"], atol=2e-2,
                               rtol=0)


def test_gelu_is_the_tanh_approximation(monkeypatch):
    """The FFN activation is jax.nn.gelu's default (tanh), not torch's
    default (erf); the encoder calls it once per layer."""
    x = torch.linspace(-6, 6, 1001)
    want = np.asarray(jax.nn.gelu(x.numpy()))
    np.testing.assert_allclose(torch_bert.gelu(x).numpy(), want, atol=1e-6,
                               rtol=0)
    erf = torch.nn.functional.gelu(x)
    assert float((torch_bert.gelu(x) - erf).abs().max()) > 1e-4
    calls = []
    real = torch_bert.gelu
    monkeypatch.setattr(torch_bert, "gelu",
                        lambda t: calls.append(1) or real(t))
    port = torch_bert.BertBackend(device="cpu", **SMALL)
    _run_port(port, *_inputs())
    assert len(calls) == SMALL["n_layers"]


def test_fused_qkv_is_qkv_major():
    """The fused projection's output splits as [b, s, 3, heads, head_dim]:
    q is the first `hidden` columns, k the next, v the last."""
    port = torch_bert.BertBackend(device="cpu", **SMALL)
    seen = {}

    def spy(q, k, v, bias2d):
        seen.setdefault("qkv", (q, k, v))
        return torch_bert.einsum_attention(q, k, v, bias2d)

    ids, mask = _inputs()
    _run_port(port, ids, mask, spy)
    with torch.inference_mode():
        x = torch.nn.functional.embedding(torch.from_numpy(ids),
                                          port.tok_embed) + port.pos_embed
        x = torch_bert._layer_norm(x, port.embed_ln)
        fused = port.layers[0].wqkv(x)
    h, heads = SMALL["hidden"], SMALL["n_heads"]
    for i, got in enumerate(seen["qkv"]):
        want = fused[..., i * h:(i + 1) * h].reshape(3, 64, heads, h // heads)
        assert torch.equal(got, want)


def test_params_from_jax_fills_every_weight():
    _, params = jax_bert.BertBackend(name="j", **SMALL).make_apply_params()
    tree = jax.tree_util.tree_map(np.asarray, params)
    state = torch_bert.params_from_jax(tree)
    port = torch_bert.BertBackend(device="cpu", **SMALL)
    assert set(state) == set(port.state_dict())
    # JAX dense layers are x @ w with w [in, out]; nn.Linear keeps [out, in].
    w = np.asarray(tree["layers"][0]["wqkv"]["w"], np.float32)
    np.testing.assert_array_equal(state["layers.0.wqkv.weight"].numpy(), w.T)
    port.load_jax_params(tree)
    assert port.layers[0].wqkv.weight.dtype == torch.bfloat16
    assert port.embed_ln.weight.dtype == torch.float32


def test_seeded_init_is_reproducible():
    a = torch_bert.BertBackend(device="cpu", **SMALL).state_dict()
    b = torch_bert.BertBackend(device="cpu", **SMALL).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_backend_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_bert.BertBackend(**SMALL)


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError, match="attention_impl"):
        torch_bert.BertBackend(attention_impl="ring", device="cpu", **SMALL)


def test_zoo_registry_is_the_ports_own():
    jax_before = jax_model_names()
    assert {"bert_base", "bert_long"} <= set(model_names())
    # bert_long, tiny_gpt_long and dlrm_cached load by name only, as in
    # the JAX zoo; the default set is the JAX zoo's.
    from client_tpu.models import build_repository as jax_build_repository

    defaults = build_repository().names()
    assert defaults == [
        "bert_base", "bert_postprocess", "bert_preprocess", "densenet_onnx",
        "dlrm", "ensemble_bert", "ensemble_image", "image_preprocess",
        "resnet50", "simple", "simple_identity", "simple_int8",
        "simple_repeat", "simple_sequence", "simple_sequence_oldest",
        "simple_string", "ssd_mobilenet_v2_coco_quantized",
        "ssd_mobilenet_v2_tpu", "tiny_gpt"]
    assert defaults == sorted(jax_build_repository().names())
    assert build_repository(["bert_long"]).names() == ["bert_long"]
    with pytest.raises(KeyError, match="no_such_model"):
        build_repository(["no_such_model"])
    assert jax_model_names() == jax_before


@pytest.mark.parametrize("name", ["bert_base", "bert_long"])
def test_registered_configs_match_the_jax_zoo(name):
    """Same serving contract as the JAX zoo entry: inputs, outputs,
    batching, instances, and the attention path."""
    from client_tpu.models import _REGISTRY as jax_registry

    want = jax_registry[name]()
    got = build_repository([name])._builders[name][None](torch.device("cpu"))
    assert got.attention_impl == want.attention_impl
    for field in ("name", "max_batch_size", "instance_count"):
        assert getattr(got.config, field) == getattr(want.config, field)
    for side in ("input", "output"):
        assert [(t.name, t.data_type, t.dims) for t in getattr(got.config, side)] \
            == [(t.name, t.data_type, t.dims) for t in getattr(want.config, side)]
    assert got.config.dynamic_batching.preferred_batch_size \
        == want.config.dynamic_batching.preferred_batch_size
    assert got.config.dynamic_batching.max_queue_delay_microseconds \
        == want.config.dynamic_batching.max_queue_delay_microseconds
    assert len(got.layers) == 12 and got.tok_embed.shape == (30522, 768)
