"""The environment variables the port reads.

The port's own small reader for the ``CLIENT_TPU_*`` variables it shares
with ``client_tpu/config.py``: the same names, the same defaults and the
same parsing, read at the point of use (never at import).
"""

from __future__ import annotations

import os

_DEFAULTS = {
    # Decode chunk K: one dispatch advances every stream K tokens.
    "CLIENT_TPU_GEN_CHUNK": "1",
    # Generative dispatch-ahead depth, in waves, before the worker blocks
    # on the oldest token fetch.
    "CLIENT_TPU_GEN_PIPELINE": "32",
    # Oldest-sequence batcher dispatch-ahead depth, in waves, before the
    # worker blocks on the oldest wave's outputs.
    "CLIENT_TPU_SEQ_PIPELINE": "2",
    # Per-stream pending-response backlog (HTTP generate_stream, gRPC
    # stream RPC) before the slow-consumer shed; SSE backpressure starts
    # at half of it, the gRPC stream's at the mark itself.
    "CLIENT_TPU_STREAM_PENDING_LIMIT": "1024",
    # Test knob: a per-message stream-writer delay (ms) that forces a
    # writer backlog, so the coalescing and shed paths can be exercised
    # deterministically.
    "CLIENT_TPU_STREAM_WRITER_DELAY_MS": "0",
}


def _text(name: str) -> str:
    text = os.environ.get(name, "").strip()
    return text if text else _DEFAULTS[name]


def env_int(name: str) -> int:
    """The integer value of ``name``, or its default when unset or blank."""
    text = _text(name)
    try:
        return int(text)
    except ValueError:
        raise ValueError(f"{name} expects an integer, got {text!r}") from None


def env_float(name: str) -> float:
    """The number value of ``name``, or its default when unset or blank."""
    text = _text(name)
    try:
        return float(text)
    except ValueError:
        raise ValueError(f"{name} expects a number, got {text!r}") from None
