"""The port's SSD-MobileNet-v2 against the JAX package's, with the same
weights, at 300x300 (its anchors are fixed to that size), batch 1 and 2.

- Heads, fp32 route: ``client_tpu.models.ssd._conv`` is patched to cast
  both operands to fp32 and the port runs ``.float()``; the box
  encodings and class scores before NMS agree within 1e-4 x max|enc| and
  1e-4 (measured: 4.2e-5 on the scores; an fp32 difference of 1e-5 in the
  features grows through 17 blocks of random weights). An anchor-order,
  padding or depthwise-layout error shows as O(1). The JAX side runs op
  by op there (see ``_jax_fp32``).
- NMS: the JAX package's own ``decode_and_nms`` (taken from the apply
  function's closure, under ``jax.vmap``) and the port's batched one get
  identical fp32 inputs, the real heads' outputs among them. Every
  decision must be equal: classes, scores and counts exactly, boxes
  within 1e-6 (``exp`` may differ by an ulp).
- Whole model, fp32 route: classes and counts exactly equal, boxes and
  scores within 1e-5. The class scores saturate (many anchors at
  exactly 1.0 or 1 - 2**-24), so a rounding difference in the heads may
  pick another anchor of equal score: where the boxes of a step differ,
  the test asserts that the two picks' scores differ by less than 1e-5,
  says so, and compares that image's boxes no further.
- Whole model, bf16 route (both at their defaults): shapes, scores sorted,
  count in [0, 10], the top score within 2e-2. NMS decisions are not
  compared here: bf16 heads round to ties.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import ssd as jax_ssd
from client_tpu_torch.models import build_repository
from client_tpu_torch.models import ssd as torch_ssd
from client_tpu_torch.models import vision as torch_vision

OUT = "TFLite_Detection_PostProcess"
N_ANCHORS = 1917


def _conv_fp32(x, w, stride=1, padding="SAME", feature_group_count=1):
    return jax.lax.conv_general_dilated(
        x.astype(jnp.float32), w.astype(jnp.float32),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=feature_group_count)


@pytest.fixture(scope="module")
def ssd():
    """(JAX apply, its closure cells, JAX params, port module with the
    same weights)."""
    fn, params = jax_ssd.SsdMobileNetV2Backend(name="j").make_apply_params()
    port = torch_ssd.SsdMobileNetV2Backend(name="t", device="cpu")
    port.load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    cells = {k: c.cell_contents
             for k, c in zip(fn.__code__.co_freevars, fn.__closure__)}
    return fn, cells, params, port


@pytest.fixture(scope="module")
def port_fp32(ssd):
    return copy.deepcopy(ssd[3]).float()


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 300, 300, 3)).astype(np.uint8)


def _port(port, x):
    with torch.inference_mode():
        out = port({"normalized_input_image_tensor": torch.from_numpy(x)})
    return {k: v.numpy() for k, v in out.items()}


def _jax_fp32(fn, params, x):
    """The JAX apply on the fp32 route, op by op: under ``jax.jit`` XLA on
    the CPU computes the bf16 dequantization in fp32 and, since an fp32
    convolution follows, drops its rounding to bf16 (a 2e-3 change of the
    input that the random network amplifies to O(0.1)). Op by op, every
    bf16 result is rounded, as in the port."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ssd, "_conv", _conv_fp32)
        out = fn(params, {"normalized_input_image_tensor": jnp.asarray(x)})
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_nms(cells, boxes_enc, scores):
    out = jax.jit(jax.vmap(cells["decode_and_nms"]))(boxes_enc, scores)
    return [np.asarray(v) for v in out]


def _port_nms(boxes_enc, scores):
    with torch.inference_mode():
        out = torch_ssd.decode_and_nms(torch.from_numpy(boxes_enc),
                                       torch.from_numpy(scores),
                                       torch.from_numpy(
                                           torch_ssd.make_anchors()))
    return [v.numpy() for v in out]


def test_anchors_and_blocks_match_jax():
    np.testing.assert_array_equal(torch_ssd.make_anchors(),
                                  jax_ssd._make_anchors())
    assert torch_ssd.make_anchors().shape == (N_ANCHORS, 4)
    assert torch_ssd._mbv2_blocks() == jax_ssd._mbv2_blocks()


def test_params_from_jax_fills_every_weight(ssd):
    _, _, params, port = ssd
    tree = jax.tree_util.tree_map(np.asarray, params)
    state = torch_vision.params_from_jax(tree)
    own = port.state_dict()
    assert sorted(state) == sorted(own)
    for key, value in state.items():
        assert value.shape == own[key].shape, key
    # Depthwise: JAX [3,3,1,mid] (feature_group_count=mid) -> [mid,1,3,3].
    wd = tree["blocks"][1]["wd"]
    assert wd.shape == (3, 3, 1, 96) and own["blocks.1.wd"].shape == (96, 1,
                                                                      3, 3)
    assert torch.equal(own["blocks.1.wd"][40, 0, 2, 1].float(),
                       torch.tensor(float(wd[2, 1, 0, 40])))


def test_fp32_heads_match_jax(ssd, port_fp32):
    """Box encodings and class scores before NMS, in JAX's anchor order."""
    fn, cells, params, _ = ssd
    x = _images(2, seed=3)

    def heads(p, img):
        feats = cells["backbone_feats"](
            p, (img.astype(jnp.bfloat16) - 127.5) / 127.5)
        boxes, scores = [], []
        for feat, head in zip(feats, p["heads"]):
            boxes.append(jax_ssd._conv(feat, head["box"]).reshape(2, -1, 4))
            scores.append(jax_ssd._conv(feat, head["cls"]).reshape(
                2, -1, jax_ssd.NUM_CLASSES))
        return (jnp.concatenate(boxes, 1),
                jax.nn.sigmoid(jnp.concatenate(scores, 1)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ssd, "_conv", _conv_fp32)
        # Op by op, as _jax_fp32 explains.
        want_b, want_s = (np.asarray(v) for v in heads(params,
                                                        jnp.asarray(x)))
    with torch.inference_mode():
        got_b, got_s = (v.numpy() for v in
                        port_fp32.head_outputs(torch.from_numpy(x)))
    assert got_b.shape == (2, N_ANCHORS, 4) and got_s.shape == (2, N_ANCHORS,
                                                                91)
    np.testing.assert_allclose(got_b, want_b,
                               atol=1e-4 * float(np.abs(want_b).max()), rtol=0)
    np.testing.assert_allclose(got_s, want_s, atol=1e-4, rtol=0)


def _nms_case(case, port_fp32):
    rng = np.random.default_rng(11)
    enc = rng.standard_normal((2, N_ANCHORS, 4)).astype(np.float32)
    scores = rng.uniform(0, 0.04, (2, N_ANCHORS, 91)).astype(np.float32)
    if case == "heads":
        with torch.inference_mode():
            enc, scores = (v.numpy() for v in port_fp32.head_outputs(
                torch.from_numpy(_images(2, seed=4))))
    elif case == "uniform":
        scores = rng.uniform(0, 1, scores.shape).astype(np.float32)
    elif case == "ties":
        # Equal scores on many overlapping anchors: the first index wins.
        scores[:, 100:400, 7] = 0.75
        scores[:, 1500:1600, 30] = 0.75
        scores[1, :, 3] = 0.5
    elif case == "threshold":
        # >= 0.05 keeps; just under it starts at 0.
        scores[:, 10, 5] = np.float32(0.05)
        scores[:, 900, 6] = np.nextafter(np.float32(0.05), np.float32(0))
        scores[0, 1200, 90] = np.float32(0.05)
    elif case == "empty":
        pass
    elif case == "boxes_at_anchors":
        # Zero encodings: boxes are the anchors, whose cells overlap.
        enc[:] = 0.0
        scores[:, :, 1] = rng.uniform(0.3, 0.9, (2, N_ANCHORS))
    return enc, scores


@pytest.mark.parametrize("case", ["heads", "uniform", "ties", "threshold",
                                  "empty", "boxes_at_anchors"])
def test_nms_decisions_equal_jax(ssd, port_fp32, case):
    _, cells, _, _ = ssd
    enc, scores = _nms_case(case, port_fp32)
    want = _jax_nms(cells, enc, scores)
    got = _port_nms(enc, scores)
    names = ("boxes", "classes", "scores", "count")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    if case == "empty":
        assert (got[3] == 0).all() and (got[0] == 0).all()
    if case == "threshold":
        assert 0.05 in got[2][0] and got[3][0] >= 2


@pytest.mark.parametrize("batch", [1, 2])
def test_fp32_route_matches_jax(ssd, port_fp32, batch):
    fn, _, params, _ = ssd
    x = _images(batch, seed=batch)
    want = _jax_fp32(fn, params, x)
    got = _port(port_fp32, x)
    for name in want:
        assert got[name].shape == want[name].shape, name
    np.testing.assert_array_equal(got[OUT + ":1"], want[OUT + ":1"])
    np.testing.assert_array_equal(got[OUT + ":3"], want[OUT + ":3"])
    np.testing.assert_allclose(got[OUT + ":2"], want[OUT + ":2"], atol=1e-5,
                               rtol=0)
    for b in range(batch):
        for i in range(torch_ssd.MAX_DETECTIONS):
            g, w = got[OUT][b, 0, i], want[OUT][b, 0, i]
            if np.abs(g - w).max() <= 1e-5:
                continue
            sg, sw = got[OUT + ":2"][b, 0, i], want[OUT + ":2"][b, 0, i]
            assert abs(float(sg) - float(sw)) < 1e-5, (b, i, sg, sw)
            warnings.warn(f"image {b}, detection {i}: a near-tie of fp32 "
                          f"scores ({sg!r} and {sw!r}) picked another "
                          "anchor; its boxes are compared no further")
            break


@pytest.mark.parametrize("batch", [1, 2])
def test_bf16_route(ssd, batch):
    fn, _, params, port = ssd
    x = _images(batch, seed=10 + batch)
    want = {k: np.asarray(v) for k, v in jax.jit(fn)(
        params, {"normalized_input_image_tensor": x}).items()}
    got = _port(port, x)
    assert got[OUT].shape == (batch, 1, 10, 4)
    assert got[OUT + ":1"].shape == got[OUT + ":2"].shape == (batch, 1, 10)
    assert got[OUT + ":3"].shape == (batch, 1)
    for name in got:
        assert got[name].dtype == np.float32 and np.isfinite(got[name]).all()
        assert got[name].shape == want[name].shape
    s = got[OUT + ":2"][:, 0]
    assert (np.diff(s, axis=1) <= 0).all()
    count = got[OUT + ":3"][:, 0]
    assert ((0 <= count) & (count <= 10)).all()
    np.testing.assert_array_equal(count, (s > 0).sum(axis=1))
    np.testing.assert_allclose(s[:, 0], want[OUT + ":2"][:, 0, 0], atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("name", ["ssd_mobilenet_v2_coco_quantized",
                                  "ssd_mobilenet_v2_tpu"])
def test_registered_configs_match_the_jax_zoo(name):
    from client_tpu.models import _REGISTRY as jax_registry

    want = jax_registry[name]().config
    got = build_repository([name])._builders[name][None](torch.device("cpu")).config
    for field in ("name", "max_batch_size", "instance_count"):
        assert getattr(got, field) == getattr(want, field)
    for side in ("input", "output"):
        assert [(t.name, t.data_type, t.dims) for t in getattr(got, side)] \
            == [(t.name, t.data_type, t.dims) for t in getattr(want, side)]
    assert (got.dynamic_batching is None) == (want.dynamic_batching is None)
    if want.dynamic_batching is not None:
        assert got.dynamic_batching.preferred_batch_size \
            == want.dynamic_batching.preferred_batch_size
        assert got.dynamic_batching.max_queue_delay_microseconds \
            == want.dynamic_batching.max_queue_delay_microseconds
    assert got.scheduler_kind() == want.scheduler_kind()
    assert got.effective_buckets() == want.effective_buckets()
