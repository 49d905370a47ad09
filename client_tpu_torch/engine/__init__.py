"""Serving engine: repository, schedulers, model executor, façade."""

from client_tpu_torch.engine.engine import TorchEngine
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
    OutputRequest,
)

__all__ = ["EngineError", "InferRequest", "InferResponse", "OutputRequest",
           "TorchEngine"]
