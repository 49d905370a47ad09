"""The ``simple*`` conformance models: the family the canonical example
clients assert exact values against.

Counterpart of ``client_tpu/models/simple.py``:

- ``simple``           INT32[16] add/sub, dynamically batched, on the card
- ``simple_int8``      the same in INT8 (the explicit-content clients)
- ``simple_string``    BYTES decimal-string add/sub, host-side
- ``simple_identity``  BYTES passthrough, host-side

``simple`` and ``simple_int8`` run as tensor ops on the model's device;
integer sums wrap as the JAX package's do. The BYTES models are host-side
(``host_side = True``; ``jittable = False`` in the JAX package): object
arrays cannot go to the card. ``simple_sequence*`` waits for sequence
batching and ``simple_repeat`` for the non-generative decoupled scheduler.
"""

from __future__ import annotations

import numpy as np
import torch

from client_tpu_torch.engine.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorConfig,
)
from client_tpu_torch.engine.model import ModelBackend
from client_tpu_torch.models import register_model


class AddSubBackend(ModelBackend):
    """INPUT0, INPUT1 [n] -> OUTPUT0 = sum, OUTPUT1 = difference."""

    def __init__(self, name: str = "simple", n: int = 16,
                 max_batch_size: int = 64, datatype: str = "INT32"):
        super().__init__()
        self.config = ModelConfig(
            name=name,
            max_batch_size=max_batch_size,
            input=[TensorConfig("INPUT0", datatype, [n]),
                   TensorConfig("INPUT1", datatype, [n])],
            output=[TensorConfig("OUTPUT0", datatype, [n]),
                    TensorConfig("OUTPUT1", datatype, [n])],
            dynamic_batching=DynamicBatchingConfig(
                preferred_batch_size=sorted(
                    {min(8, max_batch_size), max_batch_size}),
                max_queue_delay_microseconds=100),
            instance_count=4,
        )

    def forward(self, inputs: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        a, b = inputs["INPUT0"], inputs["INPUT1"]
        return {"OUTPUT0": a + b, "OUTPUT1": a - b}


class _HostBackend(ModelBackend):
    host_side = True


class StringAddSubBackend(_HostBackend):
    """BYTES decimal strings [n] -> their sum and difference as BYTES."""

    def __init__(self, name: str = "simple_string", n: int = 16):
        super().__init__()
        self.config = ModelConfig(
            name=name,
            max_batch_size=8,
            input=[TensorConfig("INPUT0", "BYTES", [n]),
                   TensorConfig("INPUT1", "BYTES", [n])],
            output=[TensorConfig("OUTPUT0", "BYTES", [n]),
                    TensorConfig("OUTPUT1", "BYTES", [n])],
        )

    def forward(self, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        a = np.vectorize(int)(inputs["INPUT0"]).astype(np.int64)
        b = np.vectorize(int)(inputs["INPUT1"]).astype(np.int64)
        enc = np.vectorize(lambda v: str(v).encode())
        return {"OUTPUT0": enc(a + b).astype(np.object_),
                "OUTPUT1": enc(a - b).astype(np.object_)}


class IdentityBackend(_HostBackend):
    """BYTES [-1] passed through unchanged."""

    def __init__(self, name: str = "simple_identity"):
        super().__init__()
        self.config = ModelConfig(
            name=name,
            max_batch_size=8,
            input=[TensorConfig("INPUT0", "BYTES", [-1])],
            output=[TensorConfig("OUTPUT0", "BYTES", [-1])],
        )

    def forward(self, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        return {"OUTPUT0": inputs["INPUT0"]}


register_model("simple")(lambda device: AddSubBackend())
register_model("simple_int8")(
    lambda device: AddSubBackend(name="simple_int8", max_batch_size=8,
                                 datatype="INT8"))
register_model("simple_string")(lambda device: StringAddSubBackend())
register_model("simple_identity")(lambda device: IdentityBackend())
