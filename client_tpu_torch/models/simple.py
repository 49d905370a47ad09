"""The ``simple*`` conformance models: the family the canonical example
clients assert exact values against.

Counterpart of ``client_tpu/models/simple.py``:

- ``simple``           INT32[16] add/sub, dynamically batched, on the card
- ``simple_int8``      the same in INT8 (the explicit-content clients)
- ``simple_string``    BYTES decimal-string add/sub, host-side
- ``simple_identity``  BYTES passthrough, host-side
- ``simple_sequence``  stateful INT32 running sum, direct strategy
- ``simple_sequence_oldest``  the same through the oldest-sequence arena
- ``simple_repeat``    decoupled: one response per element of IN

``simple``, ``simple_int8`` and the sequence models run as tensor ops on
the model's device; integer sums wrap as the JAX package's do. The BYTES
models are host-side (``host_side = True``; ``jittable = False`` in the
JAX package): object arrays cannot go to the card. ``simple_repeat`` runs
on the host too, in the ``DecoupledScheduler``'s worker: it has no device
work.
"""

from __future__ import annotations

import time
from typing import Any, Iterator

import numpy as np
import torch

from client_tpu_torch.engine.config import (
    DynamicBatchingConfig,
    ModelConfig,
    SequenceBatchingConfig,
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


class SequenceAccumulateBackend(ModelBackend):
    """Stateful accumulator: OUTPUT is the running sum of INPUT over the
    sequence; the state is an INT32 [1] tensor on the model's device.
    ``strategy="oldest"`` serves it through the arena-batched
    oldest-sequence scheduler."""

    def __init__(self, name: str = "simple_sequence",
                 strategy: str = "direct",
                 max_candidate_sequences: int = 64):
        super().__init__()
        self.config = ModelConfig(
            name=name,
            max_batch_size=0,  # a sequence request is shape [1]
            input=[TensorConfig("INPUT", "INT32", [1])],
            output=[TensorConfig("OUTPUT", "INT32", [1])],
            sequence_batching=SequenceBatchingConfig(
                strategy=strategy,
                max_candidate_sequences=max_candidate_sequences),
        )

    def initial_state(self) -> torch.Tensor:
        return torch.zeros(1, dtype=torch.int32)

    def step(self, state: torch.Tensor, inputs: dict[str, torch.Tensor]
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        acc = state + inputs["INPUT"]
        return acc, {"OUTPUT": acc}


class RepeatBackend(_HostBackend):
    """Decoupled: one response per element of IN (OUT the element, IDX its
    index), DELAY microseconds before each where given."""

    def __init__(self, name: str = "simple_repeat"):
        super().__init__()
        self.config = ModelConfig(
            name=name,
            max_batch_size=0,
            input=[TensorConfig("IN", "INT32", [-1]),
                   TensorConfig("DELAY", "UINT32", [-1], optional=True)],
            output=[TensorConfig("OUT", "INT32", [1]),
                    TensorConfig("IDX", "UINT32", [1])],
            decoupled=True,
        )

    def generate(self, inputs: dict[str, np.ndarray],
                 parameters: dict[str, Any]
                 ) -> Iterator[dict[str, np.ndarray]]:
        data = np.ravel(inputs["IN"]).astype(np.int32)
        delays = np.ravel(inputs.get("DELAY", np.zeros(0, np.uint32)))
        for i, v in enumerate(data):
            if i < len(delays) and delays[i]:
                time.sleep(int(delays[i]) / 1e6)
            yield {"OUT": np.array([v], dtype=np.int32),
                   "IDX": np.array([i], dtype=np.uint32)}


register_model("simple")(lambda device: AddSubBackend())
register_model("simple_int8")(
    lambda device: AddSubBackend(name="simple_int8", max_batch_size=8,
                                 datatype="INT8"))
register_model("simple_string")(lambda device: StringAddSubBackend())
register_model("simple_identity")(lambda device: IdentityBackend())
register_model("simple_sequence")(lambda device: SequenceAccumulateBackend())
register_model("simple_sequence_oldest")(
    lambda device: SequenceAccumulateBackend(name="simple_sequence_oldest",
                                             strategy="oldest"))
register_model("simple_repeat")(lambda device: RepeatBackend())
