"""The port's host-side models, classification strings and ensembles
against the JAX package's.

- ``bert_preprocess``, ``bert_postprocess``, ``image_preprocess`` and
  ``classify_output``: the same inputs give the same outputs bit for bit
  (the port carries the JAX package's numpy).
- The ensembles are served by ``TorchEngine(device="cpu")`` and by
  ``TpuEngine``, each with small backends registered under ``resnet50``
  and ``bert_base`` and the same weights (``load_jax_params``). Their
  outputs agree within the bf16 tolerance of ``tests/test_torch_vision.py``
  (1e-2 x max|logit|) and of ``tests/test_torch_bert.py`` (2e-2); the
  port's ensemble equals its composing models run by hand bit for bit.
- The ensemble scheduler's errors: an unsatisfiable step, a missing
  output, and an ensemble naming a model that is not in the repository
  (a load error).
"""

import jax
import numpy as np
import pytest
import torch

from client_tpu.engine import InferRequest as JaxInferRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.config import EnsembleStep as JaxEnsembleStep
from client_tpu.engine.config import ModelConfig as JaxModelConfig
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.models import bert as jax_bert
from client_tpu.models import ensembles as jax_ens
from client_tpu.models import vision as jax_vision
from client_tpu.server.classification import (
    classify_output as jax_classify,
)
from client_tpu_torch.engine import EngineError, InferRequest, TorchEngine
from client_tpu_torch.engine.config import EnsembleStep, ModelConfig
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models import bert as torch_bert
from client_tpu_torch.models import build_repository
from client_tpu_torch.models import ensembles as torch_ens
from client_tpu_torch.models import vision as torch_vision
from client_tpu_torch.server.classification import classify_output

RESNET = dict(stages=((1, 8), (1, 16)))
BERT = dict(seq_len=128, hidden=64, n_layers=2, n_heads=4, ffn=128,
            max_batch_size=8)
TEXTS = [b"A great movie", "hello world", b"", b"x " * 300,
         "Café au lait".encode()]


def _jax_host(backend_cls, inputs):
    return backend_cls().make_apply()(inputs)


def _port_host(backend_cls, inputs):
    return backend_cls()(inputs)


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == np.object_:
            assert g.tolist() == w.tolist(), name
        else:
            assert g.tobytes() == w.tobytes(), name


def test_bert_preprocess_is_bit_identical():
    texts = np.array([[t] for t in TEXTS], dtype=np.object_)
    _assert_same(_port_host(torch_ens.BertPreprocessBackend, {"TEXT": texts}),
                 _jax_host(jax_ens.BertPreprocessBackend, {"TEXT": texts}))


def test_bert_postprocess_is_bit_identical():
    logits = np.random.default_rng(0).standard_normal((6, 2)).astype(
        np.float32) * 4
    logits[5] = [1.5, 1.5]  # a tie takes the first label
    _assert_same(
        _port_host(torch_ens.BertPostprocessBackend, {"logits": logits}),
        _jax_host(jax_ens.BertPostprocessBackend, {"logits": logits}))


@pytest.mark.parametrize("shape", [(480, 640), (333, 500), (224, 224),
                                   (7, 1000)])
def test_image_preprocess_is_bit_identical(shape):
    raw = np.random.default_rng(shape[0]).integers(
        0, 256, (2, *shape, 3)).astype(np.uint8)
    _assert_same(
        _port_host(torch_ens.ImagePreprocessBackend, {"RAW_IMAGE": raw}),
        _jax_host(jax_ens.ImagePreprocessBackend, {"RAW_IMAGE": raw}))


@pytest.mark.parametrize("count", [1, 3, 12])
@pytest.mark.parametrize("labels", [None, ["cat", "dog", "emu"]])
def test_classify_output_is_bit_identical(count, labels):
    rng = np.random.default_rng(count)
    scores = rng.standard_normal((3, 10)).astype(np.float32)
    scores[1, 4:8] = 0.25  # ties order as np.argsort(-x) orders them
    for arr in (scores, scores[0]):
        got = classify_output(arr, count, labels)
        want = jax_classify(arr, count, labels)
        assert got.dtype == np.object_ and got.tolist() == want.tolist()


def test_host_side_models_are_not_staged():
    """A host-side model runs numpy to numpy, BYTES included, with no
    padding to a bucket, even on a model whose device is given."""
    from client_tpu_torch.engine.model import Model

    model = Model(torch_ens.BertPreprocessBackend(), device="cpu")
    texts = np.array([[b"one two"], [b"three"], [b"four"]], dtype=np.object_)
    out, phases = model.execute_timed({"TEXT": texts}, batch_size=3)
    assert out["input_ids"].shape == (3, 128)  # not padded to 4
    assert isinstance(out["input_ids"], np.ndarray)
    assert phases.start <= phases.infer_end <= phases.output_end


# -- ensembles served by both engines -----------------------------------------

@pytest.fixture(scope="module")
def engines():
    """The port's and the JAX package's engines serving both ensembles,
    with the same small resnet50 and bert_base under those names."""
    jax_resnet = jax_vision.ResNet50Backend(name="resnet50", **RESNET)
    jax_bert_b = jax_bert.BertBackend(name="bert_base", **BERT)
    jax_repo = JaxRepository()
    for backend in (jax_resnet, jax_bert_b, jax_ens.BertPreprocessBackend(),
                    jax_ens.BertPostprocessBackend(),
                    jax_ens.ImagePreprocessBackend(),
                    jax_ens.EnsembleBertBackend(),
                    jax_ens.EnsembleImageBackend()):
        jax_repo.register_backend(backend)
    jax_engine = TpuEngine(jax_repo)

    def numpy_params(backend):
        return jax.tree_util.tree_map(np.asarray,
                                      backend.make_apply_params()[1])

    resnet_params = numpy_params(
        jax_vision.ResNet50Backend(name="resnet50", **RESNET))
    bert_params = numpy_params(jax_bert.BertBackend(name="bert_base", **BERT))

    def resnet(device):
        port = torch_vision.ResNet50Backend(device=device, **RESNET)
        port.load_jax_params(resnet_params)
        return port

    def bert(device):
        port = torch_bert.BertBackend(device=device, **BERT)
        port.load_jax_params(bert_params)
        return port

    repo = build_repository(["image_preprocess", "ensemble_image",
                             "bert_preprocess", "bert_postprocess",
                             "ensemble_bert"])
    repo.register("resnet50", resnet)
    repo.register("bert_base", bert)
    engine = TorchEngine(repo, device="cpu")
    yield engine, jax_engine
    engine.shutdown()
    jax_engine.shutdown()


def _raw_images(n, h, w, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("n,h,w", [(1, 480, 640), (2, 333, 500)])
def test_ensemble_image_matches_jax_and_its_steps(engines, n, h, w):
    engine, jax_engine = engines
    raw = _raw_images(n, h, w, seed=h)
    got = engine.infer(InferRequest(model_name="ensemble_image",
                                    inputs={"RAW_IMAGE": raw}))
    want = jax_engine.infer(JaxInferRequest(model_name="ensemble_image",
                                            inputs={"RAW_IMAGE": raw}))
    logits = got.outputs["CLASS_LOGITS"]
    ref = np.asarray(want.outputs["CLASS_LOGITS"])
    assert logits.shape == ref.shape == (n, 1000)
    np.testing.assert_allclose(logits, ref,
                               atol=1e-2 * float(np.abs(ref).max()), rtol=0)
    # By hand: preprocess on the host, then resnet50 on the same bucket.
    image = torch_ens.ImagePreprocessBackend()({"RAW_IMAGE": raw})["IMAGE"]
    model = engine.repository.get("resnet50")
    by_hand, _ = model.execute_timed({"INPUT": image}, batch_size=n)
    assert logits.tobytes() == by_hand["OUTPUT"].tobytes()


def test_ensemble_bert_matches_jax_and_its_steps(engines):
    engine, jax_engine = engines
    texts = np.array([[t] for t in TEXTS[:4]], dtype=np.object_)
    got = engine.infer(InferRequest(model_name="ensemble_bert",
                                    inputs={"TEXT": texts}))
    want = jax_engine.infer(JaxInferRequest(model_name="ensemble_bert",
                                            inputs={"TEXT": texts}))
    assert got.outputs["LABEL"].shape == (4, 1)
    score = got.outputs["SCORE"]
    ref = np.asarray(want.outputs["SCORE"])
    # bf16 on both sides: the gap measured on these inputs is 2.1e-3.
    np.testing.assert_allclose(score, ref, atol=5e-3, rtol=0)
    # Where the JAX score is clear of that tolerance around 0.5, the two
    # sides must pick the same label.
    clear = np.abs(ref.ravel() - 0.5) > 5e-3
    assert clear.sum() >= 2
    assert got.outputs["LABEL"][clear].tolist() \
        == np.asarray(want.outputs["LABEL"])[clear].tolist()
    pre = torch_ens.BertPreprocessBackend()({"TEXT": texts})
    logits, _ = engine.repository.get("bert_base").execute_timed(
        pre, batch_size=4)
    post = torch_ens.BertPostprocessBackend()({"logits": logits["logits"]})
    assert got.outputs["LABEL"].tolist() == post["LABEL"].tolist()
    assert got.outputs["SCORE"].tobytes() == post["SCORE"].tobytes()


def test_ensemble_counts_each_composing_model(engines):
    engine, _ = engines

    def counts():
        return {s["name"]: s["inference_count"]
                for s in engine.model_statistics()["model_stats"]}

    before = counts()
    engine.infer(InferRequest(model_name="ensemble_image",
                              inputs={"RAW_IMAGE": _raw_images(1, 50, 60, 0)}))
    after = counts()
    for name in ("ensemble_image", "image_preprocess", "resnet50"):
        assert after[name] == before[name] + 1, name
    assert after["bert_base"] == before["bert_base"]


def test_ensemble_config_matches_jax(engines):
    engine, jax_engine = engines
    for name in ("ensemble_image", "ensemble_bert"):
        got = engine.model_config(name)
        want = jax_engine.model_config(name)
        assert got["ensemble_scheduling"] == want["ensemble_scheduling"]
        assert got["platform"] == want["platform"] == "ensemble"
        assert got["max_batch_size"] == want["max_batch_size"]
        assert got["input"] == want["input"]
        assert got["output"] == want["output"]


def test_requested_outputs_filter_the_ensemble(engines):
    engine, _ = engines
    from client_tpu_torch.engine.types import OutputRequest

    texts = np.array([[b"fine"]], dtype=np.object_)
    resp = engine.infer(InferRequest(model_name="ensemble_bert",
                                     inputs={"TEXT": texts},
                                     outputs=[OutputRequest("SCORE")]))
    assert list(resp.outputs) == ["SCORE"]


def _echo_repo(steps, outputs=("OUT",)):
    """A repository with ``pre`` (``bert_preprocess`` under another name)
    and an ensemble ``ens`` over ``steps``."""
    from client_tpu_torch.engine.config import TensorConfig
    from client_tpu_torch.engine.repository import ConfigOnlyBackend

    repo = ModelRepository()
    repo.register("pre", lambda device: torch_ens.BertPreprocessBackend(
        name="pre"))
    cfg = ModelConfig(
        name="ens", platform="ensemble", max_batch_size=8,
        input=[TensorConfig("TEXT", "BYTES", [1])],
        output=[TensorConfig(o, "INT32", [128]) for o in outputs],
        ensemble_scheduling=steps)
    repo.register("ens", lambda device: ConfigOnlyBackend(cfg))
    return repo


@pytest.mark.parametrize("fault", ["unsatisfiable", "missing_output"])
def test_ensemble_errors(fault):
    if fault == "unsatisfiable":
        steps = [EnsembleStep("pre", input_map={"TEXT": "_never"},
                              output_map={"input_ids": "OUT"})]
        match = r"unsatisfiable steps; missing tensors \['_never'\]"
    else:
        steps = [EnsembleStep("pre", input_map={"TEXT": "TEXT"},
                              output_map={"input_ids": "_ids"})]
        match = "no step produced output 'OUT'"
    engine = TorchEngine(_echo_repo(steps), device="cpu")
    try:
        with pytest.raises(EngineError, match=match) as exc:
            engine.infer(InferRequest(
                model_name="ens",
                inputs={"TEXT": np.array([[b"a b"]], dtype=np.object_)}))
        assert exc.value.status == 500
        fails = engine.model_statistics("ens")["model_stats"][0]
        assert fails["inference_stats"]["fail"]["count"] == 1
    finally:
        engine.shutdown()


def test_ensemble_naming_a_missing_model_is_a_load_error():
    steps = [EnsembleStep("pre", input_map={"TEXT": "TEXT"},
                          output_map={"input_ids": "_ids"}),
             EnsembleStep("no_such_model", input_map={"x": "_ids"},
                          output_map={"y": "OUT"})]
    # The engine loads the rest, as the JAX engine does: the failure stays
    # in the repository index, and loading the ensemble again raises it.
    engine = TorchEngine(_echo_repo(steps), device="cpu")
    try:
        rows = {e["name"]: e for e in engine.repository_index()}
        assert rows["ens"]["state"] == "UNAVAILABLE"
        assert "['no_such_model']" in rows["ens"]["reason"]
        assert rows["pre"]["state"] == "READY"
        with pytest.raises(EngineError, match=r"\['no_such_model'\]"):
            engine.load_model("ens")
    finally:
        engine.shutdown()


@pytest.mark.parametrize("names", [["ensemble_image"], ["ensemble_bert"],
                                   ["image_preprocess", "ensemble_image"]])
def test_load_by_name_membership_as_in_jax(names):
    from client_tpu.models import build_repository as jax_build_repository

    assert build_repository(names).names() \
        == sorted(jax_build_repository(names).names())


def test_ensemble_scheduler_kind_as_in_jax():
    assert ModelConfig(name="e", ensemble_scheduling=[
        EnsembleStep("m")]).scheduler_kind() == JaxModelConfig(
        name="e", ensemble_scheduling=[JaxEnsembleStep("m")]
    ).scheduler_kind() == "ENSEMBLE"


def test_host_side_registrations_match_the_jax_zoo():
    from client_tpu.models import _REGISTRY as jax_registry

    for name in ("bert_preprocess", "bert_postprocess", "image_preprocess",
                 "ensemble_bert", "ensemble_image"):
        want = jax_registry[name]().config
        got = build_repository([name])._builders[name][None](
            torch.device("cpu")).config
        assert got.max_batch_size == want.max_batch_size, name
        assert got.instance_count == want.instance_count, name
        for side in ("input", "output"):
            assert [(t.name, t.data_type, t.dims)
                    for t in getattr(got, side)] \
                == [(t.name, t.data_type, t.dims)
                    for t in getattr(want, side)], name
