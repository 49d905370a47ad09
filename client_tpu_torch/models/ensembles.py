"""Ensemble pipelines and their host-side pre/post-process models.

Counterpart of ``client_tpu/models/ensembles.py``. The composing pre- and
post-process models are host-side (``host_side = True``; in the JAX
package ``jittable = False``): BYTES object arrays cannot go to the card,
so they take and return numpy arrays on the host. Their bodies are the
JAX package's numpy, so their outputs are identical bit for bit.

- ``bert_preprocess``   BYTES text [1] -> input_ids/attention_mask INT32[S]
  (a deterministic FNV-1a hash wordpiece stand-in; no vocab ships)
- ``bert_postprocess``  logits FP32[num_labels] -> BYTES label + FP32 score
- ``image_preprocess``  UINT8 HWC (any size) -> FP32 [224,224,3],
  nearest-neighbour resized and mean/std normalized

Ensembles, run by ``engine/ensemble.py``:

- ``ensemble_bert``  TEXT -> LABEL, SCORE   (bert_preprocess -> bert_base
  -> bert_postprocess)
- ``ensemble_image`` RAW_IMAGE -> CLASS_LOGITS   (image_preprocess ->
  resnet50)
"""

from __future__ import annotations

import numpy as np

from client_tpu_torch.engine.config import (
    EnsembleStep,
    ModelConfig,
    TensorConfig,
)
from client_tpu_torch.engine.model import ModelBackend
from client_tpu_torch.engine.repository import ConfigOnlyBackend
from client_tpu_torch.models import register_model

SEQ_LEN = 128
CLS_ID = 101
SEP_ID = 102


def _hash_token(tok: bytes) -> int:
    """Stable token-id hash into the BERT vocab range (1000..30521)."""
    h = 2166136261
    for c in tok:
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return 1000 + h % (30522 - 1000)


class _HostBackend(ModelBackend):
    host_side = True


class BertPreprocessBackend(_HostBackend):
    def __init__(self, name: str = "bert_preprocess", seq_len: int = SEQ_LEN):
        super().__init__()
        self.seq_len = seq_len
        self.config = ModelConfig(
            name=name,
            max_batch_size=8,
            input=[TensorConfig("TEXT", "BYTES", [1])],
            output=[TensorConfig("input_ids", "INT32", [seq_len]),
                    TensorConfig("attention_mask", "INT32", [seq_len])],
        )

    def forward(self, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        seq_len = self.seq_len
        texts = inputs["TEXT"]
        batch = texts.shape[0]
        ids = np.zeros((batch, seq_len), np.int32)
        mask = np.zeros((batch, seq_len), np.int32)
        for i in range(batch):
            raw = texts[i, 0]
            if isinstance(raw, str):
                raw = raw.encode()
            toks = [_hash_token(t) for t in bytes(raw).lower().split()]
            toks = [CLS_ID] + toks[: seq_len - 2] + [SEP_ID]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class BertPostprocessBackend(_HostBackend):
    LABELS = (b"negative", b"positive")

    def __init__(self, name: str = "bert_postprocess", num_labels: int = 2):
        super().__init__()
        self.config = ModelConfig(
            name=name,
            max_batch_size=8,
            input=[TensorConfig("logits", "FP32", [num_labels])],
            output=[TensorConfig("LABEL", "BYTES", [1]),
                    TensorConfig("SCORE", "FP32", [1])],
        )

    def forward(self, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        logits = np.asarray(inputs["logits"], np.float32)
        exp = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = exp / exp.sum(axis=-1, keepdims=True)
        best = probs.argmax(axis=-1)
        labels = np.array(
            [[self.LABELS[min(b, len(self.LABELS) - 1)]] for b in best],
            dtype=np.object_)
        scores = probs.max(axis=-1, keepdims=True).astype(np.float32)
        return {"LABEL": labels, "SCORE": scores}


class ImagePreprocessBackend(_HostBackend):
    """UINT8 [H,W,3] (any size) -> FP32 [224,224,3], mean/std normalized."""

    MEAN = np.array([123.675, 116.28, 103.53], np.float32)
    STD = np.array([58.395, 57.12, 57.375], np.float32)

    def __init__(self, name: str = "image_preprocess", size: int = 224):
        super().__init__()
        self.size = size
        self.config = ModelConfig(
            name=name,
            max_batch_size=8,
            input=[TensorConfig("RAW_IMAGE", "UINT8", [-1, -1, 3])],
            output=[TensorConfig("IMAGE", "FP32", [size, size, 3])],
        )

    def forward(self, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        size = self.size
        imgs = inputs["RAW_IMAGE"]
        batch = imgs.shape[0]
        out = np.empty((batch, size, size, 3), np.float32)
        for i in range(batch):
            img = imgs[i]
            h, w = img.shape[0], img.shape[1]
            # nearest-neighbour resize on the host
            ys = (np.arange(size) * h // size).clip(0, h - 1)
            xs = (np.arange(size) * w // size).clip(0, w - 1)
            resized = img[ys][:, xs].astype(np.float32)
            out[i] = (resized - self.MEAN) / self.STD
        return {"IMAGE": out}


BERT_STEPS = [
    EnsembleStep(model_name="bert_preprocess",
                 input_map={"TEXT": "TEXT"},
                 output_map={"input_ids": "_ids", "attention_mask": "_mask"}),
    EnsembleStep(model_name="bert_base",
                 input_map={"input_ids": "_ids", "attention_mask": "_mask"},
                 output_map={"logits": "_logits"}),
    EnsembleStep(model_name="bert_postprocess",
                 input_map={"logits": "_logits"},
                 output_map={"LABEL": "LABEL", "SCORE": "SCORE"}),
]

IMAGE_STEPS = [
    EnsembleStep(model_name="image_preprocess",
                 input_map={"RAW_IMAGE": "RAW_IMAGE"},
                 output_map={"IMAGE": "_image"}),
    EnsembleStep(model_name="resnet50",
                 input_map={"INPUT": "_image"},
                 output_map={"OUTPUT": "CLASS_LOGITS"}),
]


def ensemble_bert_config(name: str = "ensemble_bert") -> ModelConfig:
    """preprocess -> bert_base -> postprocess, string I/O end to end."""
    return ModelConfig(
        name=name, platform="ensemble", max_batch_size=8,
        input=[TensorConfig("TEXT", "BYTES", [1])],
        output=[TensorConfig("LABEL", "BYTES", [1]),
                TensorConfig("SCORE", "FP32", [1])],
        ensemble_scheduling=list(BERT_STEPS))


def ensemble_image_config(name: str = "ensemble_image") -> ModelConfig:
    """image_preprocess -> resnet50."""
    return ModelConfig(
        name=name, platform="ensemble", max_batch_size=8,
        input=[TensorConfig("RAW_IMAGE", "UINT8", [-1, -1, 3])],
        output=[TensorConfig("CLASS_LOGITS", "FP32", [1000])],
        ensemble_scheduling=list(IMAGE_STEPS))


register_model("bert_preprocess")(lambda device: BertPreprocessBackend())
register_model("bert_postprocess")(lambda device: BertPostprocessBackend())
register_model("image_preprocess")(lambda device: ImagePreprocessBackend())
register_model("ensemble_bert")(
    lambda device: ConfigOnlyBackend(ensemble_bert_config()))
register_model("ensemble_image")(
    lambda device: ConfigOnlyBackend(ensemble_image_config()))
