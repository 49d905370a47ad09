"""Retry-After pushback, as the clients read it.

The port's copy of ``client_tpu/protocol/pushback.py``. The servers
format pushback here and both clients parse it here, so HTTP's
``Retry-After`` header, gRPC's trailing metadata and a shm-ring slot's
error string agree on sub-second values:

* :func:`format_retry_after_s` / :func:`format_retry_pushback_ms`: the
  servers' wire text (fractional seconds; integral milliseconds);

* :func:`parse_retry_after`: text -> seconds; None on absent, unparsable,
  negative or non-finite input (None means "no pushback", never "retry
  immediately").
* :func:`parse_pushback_metadata`: the gRPC client's trailing-metadata
  view (``retry-after`` preferred, ``retry-pushback-ms`` fallback);
* :func:`format_slot_error` / :func:`parse_slot_error_retry_after`: the
  shm slot ring's encoding, a ``[retry-after=<s>s]`` suffix on the slot's
  error string (a slot has no header side channel).
"""

from __future__ import annotations

import re

__all__ = [
    "RETRY_AFTER_HEADER",
    "RETRY_AFTER_METADATA_KEY",
    "RETRY_PUSHBACK_MS_METADATA_KEY",
    "format_retry_after_s",
    "format_retry_pushback_ms",
    "parse_retry_after",
    "parse_pushback_metadata",
    "format_slot_error",
    "parse_slot_error_retry_after",
]

RETRY_AFTER_HEADER = "Retry-After"
RETRY_AFTER_METADATA_KEY = "retry-after"
RETRY_PUSHBACK_MS_METADATA_KEY = "retry-pushback-ms"


def format_retry_after_s(seconds: float) -> str:
    """Canonical wire text for a pushback interval in seconds. Negative
    input clamps to 0; any positive interval renders as at least
    ``"0.001"``, so rounding cannot erase a request to back off."""
    s = float(seconds)
    if s <= 0.0:
        return "0.000"
    return f"{max(round(s, 3), 0.001):.3f}"


def format_retry_pushback_ms(seconds: float) -> str:
    """Integral-millisecond mirror of :func:`format_retry_after_s`:
    rounded, and at least 1 ms for positive input."""
    s = float(seconds)
    if s <= 0.0:
        return "0"
    return str(max(1, round(s * 1000)))


def parse_retry_after(raw) -> float | None:
    """Text (or None) -> pushback seconds, or None when the value is
    absent, unparsable, or negative. HTTP-date is not used here."""
    if raw is None:
        return None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        return None
    # "inf" and "nan" read as "no pushback", not "wait forever".
    return value if 0 <= value < float("inf") else None


def parse_pushback_metadata(meta) -> float | None:
    """gRPC trailing metadata (a mapping with lowercase keys, or an
    iterable of (key, value)) -> pushback seconds, or None."""
    if meta is None:
        return None
    if not hasattr(meta, "get"):
        meta = {str(k).lower(): v for k, v in meta}
    value = parse_retry_after(meta.get(RETRY_AFTER_METADATA_KEY))
    if value is not None:
        return value
    ms = parse_retry_after(meta.get(RETRY_PUSHBACK_MS_METADATA_KEY))
    return ms / 1000.0 if ms is not None else None


_SLOT_RETRY_AFTER_RE = re.compile(r" \[retry-after=(\d+(?:\.\d+)?)s\]$")


def format_slot_error(message: str, retry_after_s: float | None) -> str:
    """Fold a pushback interval into a shm-ring slot error string."""
    if retry_after_s is None:
        return message
    return f"{message} [retry-after={format_retry_after_s(retry_after_s)}s]"


def parse_slot_error_retry_after(error) -> float | None:
    """Pushback seconds from a slot error string, or None when the error
    carries no ``[retry-after=...s]`` suffix (non-admission failures)."""
    if not error:
        return None
    m = _SLOT_RETRY_AFTER_RE.search(str(error))
    return parse_retry_after(m.group(1)) if m else None
