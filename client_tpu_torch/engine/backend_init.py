"""Device resolution for the port's entry points.

Counterpart of ``client_tpu/engine/backend_init.py``. Every entry point
(engine, ``Model``, backends, the server) takes ``device=None``, which
means ``cuda``. Without a usable card they raise: nothing carries on on the
CPU unless the caller asked for it with ``device="cpu"``.
"""

from __future__ import annotations

import logging

import torch

from client_tpu_torch.config import env_str

log = logging.getLogger("client_tpu_torch")
if not log.handlers:  # visible stderr progress by default; apps may override
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[client_tpu_torch] %(asctime)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(env_str("CLIENT_TPU_LOGLEVEL"))

_logged: set[str] = set()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``. Raises RuntimeError for a CUDA device when CUDA
    is unavailable, and ValueError for a device type other than cuda/cpu."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU by "
                "default; pass device='cpu' (or --device cpu) to run on the "
                "CPU on purpose")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device '{dev}' (use cuda or cpu)")
    key = str(dev)
    if key not in _logged:
        _logged.add(key)
        if dev.type == "cuda":
            props = torch.cuda.get_device_properties(dev)
            log.info("device %s: %s, compute capability %d.%d, %.1f GiB",
                     dev, props.name, props.major, props.minor,
                     props.total_memory / 2**30)
        else:
            log.info("device cpu (requested explicitly)")
    return dev
