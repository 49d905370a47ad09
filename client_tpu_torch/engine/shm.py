"""Shared-memory tensor I/O: what the port has of
``client_tpu/engine/shm.py``.

The port registers no shared-memory region yet, so an input or output
that names one is refused, with the JAX engine's words for an
unregistered region. Both frontends call this one rule.
"""

from __future__ import annotations

from client_tpu_torch.engine.types import EngineError


def refuse_shm(params: dict) -> None:
    """Raise a 400 when a tensor's parameters name a shared-memory
    region."""
    region = params.get("shared_memory_region")
    if region is not None:
        raise EngineError(
            f"shared memory region '{region}' not registered", 400)
