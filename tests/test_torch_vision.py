"""The port's ResNet-50 and DenseNet-121 against the JAX package's, with
the same weights.

The JAX backends' params go across with ``params_from_jax``; the same
numpy-seeded NHWC inputs go through both. Two routes:

- fp32: ``client_tpu.models.vision._conv`` is patched (for this module
  only) to cast both operands to fp32, and the port runs ``.float()``.
  Both sides then compute in fp32 after the same bf16 quantization of
  the input and of the weights, so a layout, padding or stride error
  shows as O(1). Tolerance 1e-4 x max|logit|.
  Measured: within 3.1e-7 x max|logit|.
- bf16: both packages at their defaults. Measured: ResNet within 2.1e-7
  x max|logit|, DenseNet within 1.7e-3 x max|logit| (XLA and PyTorch
  round some bf16 steps, the 2x2 average pool among them, in other
  places). Tolerance 1e-2 x max|logit|.

Small sizes: ResNet ``stages=((1, 8), (1, 16))`` at 32x32 (and 33x33 for
odd-size padding), DenseNet ``blocks=(2, 2), growth=8``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import vision as jax_vision
from client_tpu_torch.engine.model import Model
from client_tpu_torch.models import build_repository
from client_tpu_torch.models import vision as torch_vision

FP32_RTOL = 1e-4
BF16_RTOL = 1e-2

RESNET = dict(stages=((1, 8), (1, 16)), num_classes=10)
DENSENET = dict(blocks=(2, 2), growth=8, num_classes=10)
MODELS = {"resnet": (jax_vision.ResNet50Backend,
                     torch_vision.ResNet50Backend, RESNET),
          "densenet": (jax_vision.DenseNet121Backend,
                       torch_vision.DenseNet121Backend, DENSENET)}


def _conv_fp32(x, w, stride=1, padding="SAME", feature_group_count=1):
    return jax.lax.conv_general_dilated(
        x.astype(jnp.float32), w.astype(jnp.float32),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=feature_group_count)


@pytest.fixture(scope="module", params=[(m, s) for m in MODELS
                                        for s in (32, 33)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(JAX apply, JAX params, port module with the same weights, size)."""
    model, size = request.param
    jax_cls, torch_cls, kw = MODELS[model]
    fn, params = jax_cls(name="j", image_size=size, **kw).make_apply_params()
    port = torch_cls(name="t", image_size=size, device="cpu", **kw)
    port.load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return fn, params, port, size


def _images(size, n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _port(port, x):
    with torch.inference_mode():
        return port({"INPUT": torch.from_numpy(x)})["OUTPUT"].numpy()


def test_fp32_route_matches_jax(pair):
    fn, params, port, size = pair
    x = _images(size)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vision, "_conv", _conv_fp32)
        # A fresh function object, so jit traces under the patch.
        want = np.asarray(jax.jit(lambda p, i: fn(p, i))(
            params, {"INPUT": x})["OUTPUT"])
    got = _port(copy.deepcopy(port).float(), x)
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=FP32_RTOL * scale, rtol=0)


def test_bf16_route_matches_jax(pair):
    fn, params, port, size = pair
    x = _images(size, seed=1)
    want = np.asarray(jax.jit(fn)(params, {"INPUT": x})["OUTPUT"])
    assert port.stem.w.dtype == torch.bfloat16
    got = _port(port, x)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=BF16_RTOL * scale, rtol=0)


@pytest.mark.parametrize("size", list(range(1, 20)) + [33, 56, 112, 150,
                                                       224, 300])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                      (7, 2)])
def test_same_pad_is_xlas(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert torch_vision.same_pad(size, k, stride) == tuple(want)


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (28, 3, 2, (0, 1)), (14, 3, 2, (0, 1)), (56, 1, 2, (0, 0)),
    (300, 3, 2, (0, 1)), (150, 3, 2, (0, 1)), (75, 3, 2, (1, 1)),
    (38, 3, 2, (0, 1)), (19, 3, 2, (1, 1)), (10, 3, 2, (0, 1)),
    (5, 3, 2, (1, 1)), (3, 3, 2, (1, 1)), (2, 3, 2, (0, 1))])
def test_same_pad_on_the_main_path(size, k, stride, want):
    assert torch_vision.same_pad(size, k, stride) == want


@pytest.mark.parametrize("size", [9, 10])
@pytest.mark.parametrize("k,stride,groups", [(3, 2, 1), (3, 2, 8), (7, 2, 1),
                                             (3, 1, 8), (1, 2, 1)])
def test_conv_pads_like_xla(size, k, stride, groups):
    """The odd pixel of a SAME pad goes after: a symmetric pad would keep
    the shape and shift the result by one pixel."""
    rng = np.random.default_rng(size * k)
    x = rng.standard_normal((2, size, size, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8 // groups, 8)).astype(np.float32)
    want = np.asarray(_conv_fp32(x, w, stride=stride,
                                 feature_group_count=groups))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch_vision.params_from_jax({"w": w})["w"]
    got = torch_vision.conv(xt, wt, stride, groups).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("size", [9, 10, 112])
def test_max_pool_pads_with_minus_inf(size):
    x = -np.abs(np.random.default_rng(size).standard_normal(
        (2, size, size, 4))).astype(np.float32) - 1.0
    want = np.asarray(jax_vision._max_pool(x, 3, 2))
    got = torch_vision.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                                3, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model", list(MODELS))
def test_params_from_jax_fills_every_weight(model):
    jax_cls, torch_cls, kw = MODELS[model]
    _, params = jax_cls(name="j", image_size=32, **kw).make_apply_params()
    tree = jax.tree_util.tree_map(np.asarray, params)
    state = torch_vision.params_from_jax(tree)
    port = torch_cls(name="t", image_size=32, device="cpu", **kw)
    own = port.state_dict()
    assert sorted(state) == sorted(own)
    for key, value in state.items():
        assert value.shape == own[key].shape, key
    w = tree["stem"]["w"]  # HWIO
    assert torch.equal(state["stem.w"][5, 2, 1, 0],
                       torch.tensor(float(w[1, 0, 2, 5])))
    assert own["stem.w"].is_contiguous(memory_format=torch.channels_last)
    assert own["stem.w"].dtype == torch.bfloat16
    assert own["fc.b"].dtype == torch.float32


@pytest.mark.parametrize("name", ["resnet50", "densenet_onnx"])
def test_registered_configs_match_the_jax_zoo(name):
    from client_tpu.models import _REGISTRY as jax_registry

    want = jax_registry[name]().config
    got = build_repository([name])._builders[name][None](torch.device("cpu"))
    for field in ("name", "max_batch_size", "instance_count"):
        assert getattr(got.config, field) == getattr(want, field)
    for side in ("input", "output"):
        assert [(t.name, t.data_type, t.dims)
                for t in getattr(got.config, side)] \
            == [(t.name, t.data_type, t.dims) for t in getattr(want, side)]
    assert got.config.dynamic_batching.preferred_batch_size \
        == want.dynamic_batching.preferred_batch_size
    assert got.config.dynamic_batching.max_queue_delay_microseconds \
        == want.dynamic_batching.max_queue_delay_microseconds
    assert got.config.effective_buckets() == want.effective_buckets()


def test_full_size_shapes():
    """Full ResNet-50 and DenseNet-121: their parameter counts, and one
    224x224 image through each."""
    resnet = torch_vision.ResNet50Backend(device="cpu")
    densenet = torch_vision.DenseNet121Backend(device="cpu")
    assert sum(p.numel() for p in resnet.parameters()) == 25_557_032
    assert sum(p.numel() for p in densenet.parameters()) == 7_978_856
    x = _images(224, n=1)
    for port in (resnet, densenet):
        out = _port(port, x)
        assert out.shape == (1, 1000) and np.isfinite(out).all()


def test_executes_through_the_model_on_a_padded_bucket():
    """Model.execute_timed pads 3 rows to the 4-row bucket; the served
    rows equal a direct call on the same padded batch."""
    port = torch_vision.ResNet50Backend(name="r", image_size=32,
                                        max_batch_size=4, device="cpu",
                                        **RESNET)
    model = Model(port, device="cpu")
    x = _images(32)
    out, phases = model.execute_timed({"INPUT": x}, batch_size=3)
    assert out["OUTPUT"].shape == (3, 10)
    assert phases.start <= phases.input_end <= phases.infer_end \
        <= phases.output_end
    padded = np.concatenate([x, np.zeros_like(x[:1])])
    np.testing.assert_array_equal(out["OUTPUT"], _port(port, padded)[:3])
