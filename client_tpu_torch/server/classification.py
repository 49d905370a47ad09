"""Classification extension: top-K "score:index[:label]" string outputs.

The port's own copy of ``client_tpu/server/classification.py``: a client
may ask for an output as its top-K classes (``"classification": K`` in
the output's parameters) instead of raw scores. Labels come from the
model config's ``parameters["labels"][output_name]`` list, which a
directory model fills from the file its output's ``label_filename`` names.
"""

from __future__ import annotations

import numpy as np


def classify_output(scores: np.ndarray, count: int,
                    labels: list[str] | None) -> np.ndarray:
    """[batch, classes] scores -> [batch, count] BYTES of 'score:idx[:label]'.
    Ties order as ``np.argsort(-scores)`` orders them, as in the JAX
    package."""
    if scores.ndim == 1:
        scores = scores[None, :]
    batch = scores.shape[0]
    flat = scores.reshape(batch, -1)
    k = min(count, flat.shape[1])
    top = np.argsort(-flat, axis=1)[:, :k]
    out = np.empty((batch, k), dtype=np.object_)
    for b in range(batch):
        for j in range(k):
            idx = int(top[b, j])
            entry = f"{flat[b, idx]:f}:{idx}"
            if labels and idx < len(labels):
                entry += f":{labels[idx]}"
            out[b, j] = entry.encode("utf-8")
    return out


def output_labels(engine, req, name: str) -> list[str] | None:
    """The labels of output ``name`` of the model version ``req`` ran on,
    or None."""
    model = engine.repository.get(req.model_name, req.model_version)
    if model is None:
        return None
    return (model.config.parameters.get("labels") or {}).get(name)
