"""The environment variables the port reads.

The port's own small reader for the ``CLIENT_TPU_*`` variables it shares
with ``client_tpu/config.py``: the same names, the same defaults and the
same parsing, read at the point of use (never at import).
"""

from __future__ import annotations

import os

_INT_DEFAULTS = {
    # Decode chunk K: one dispatch advances every stream K tokens.
    "CLIENT_TPU_GEN_CHUNK": "1",
    # Generative dispatch-ahead depth, in waves, before the worker blocks
    # on the oldest token fetch.
    "CLIENT_TPU_GEN_PIPELINE": "32",
    # Per-stream pending-response backlog of /generate_stream before the
    # slow-consumer cancel; backpressure starts at half of it.
    "CLIENT_TPU_STREAM_PENDING_LIMIT": "1024",
}


def env_int(name: str) -> int:
    """The integer value of ``name``, or its default when unset or blank."""
    text = os.environ.get(name, "").strip()
    try:
        return int(text if text else _INT_DEFAULTS[name])
    except ValueError:
        raise ValueError(f"{name} expects an integer, got {text!r}") from None
