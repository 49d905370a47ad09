"""The environment variables the port reads.

The port's own small reader for the ``CLIENT_TPU_*`` variables it shares
with ``client_tpu/config.py``: the same names, the same defaults and the
same parsing, read at the point of use (never at import).
"""

from __future__ import annotations

import os

_DEFAULTS = {
    # Admission-controller limits (inline JSON or `@/path.json`); unset
    # admits everything (in-flight accounting only).
    "CLIENT_TPU_ADMISSION": "",
    # Bucket autotuner with its HBM planning arena: unset/`0`/`off`
    # disables; `1`/`on` defaults; else inline JSON or `@/path.json`.
    "CLIENT_TPU_AUTOTUNE": "",
    # Per-tenant cost ledger (GET /v2/costs): `0`/`off` disables; unset/
    # `1`/`on` defaults; else inline JSON or `@/path.json`.
    "CLIENT_TPU_COSTS": "",
    # Incident blackbox (journal-triggered bundles on disk, GET
    # /v2/debug/bundles): `0`/`off` disables; unset/`1`/`on` defaults;
    # else inline JSON or `@/path.json`.
    "CLIENT_TPU_BLACKBOX": "",
    # Capacity of the operational event-journal ring (GET /v2/events).
    "CLIENT_TPU_EVENT_BUFFER": "1024",
    # Deterministic fault-injection plan (inline JSON or `@/path.json`);
    # unset injects nothing.
    "CLIENT_TPU_FAULTS": "",
    # The router's fleet drift monitor: unset/`0`/`off` disables; `1`/`on`
    # defaults; else inline JSON or `@/path.json` (interval_s, threshold,
    # min_replicas, window_s).
    "CLIENT_TPU_FLEET_MONITOR": "",
    # Decode chunk K: one dispatch advances every stream K tokens.
    "CLIENT_TPU_GEN_CHUNK": "1",
    # Generative dispatch-ahead depth, in waves, before the worker blocks
    # on the oldest token fetch.
    "CLIENT_TPU_GEN_PIPELINE": "32",
    # A flag: run-time lock-order and blocking-under-lock checking
    # (utils/lockdep.py), read when that module is imported. Tests and
    # checks only.
    "CLIENT_TPU_LOCKDEP": "",
    # `json` attaches a JSON-lines handler to the `client_tpu_torch`
    # logger and mirrors journal events to the same stream.
    "CLIENT_TPU_LOG": "",
    # Level of the `client_tpu_torch` logger's default stderr handler.
    "CLIENT_TPU_LOGLEVEL": "INFO",
    # HBM census memory-pressure events: `0`/`off` silences them; unset/
    # `1`/`on` defaults; else inline JSON or `@/path.json`.
    "CLIENT_TPU_MEMORY": "",
    # Efficiency-profiler sliding-window length in seconds.
    "CLIENT_TPU_PROFILE_WINDOW_S": "60",
    # Tenant QoS classes (inline JSON or `@/path.json`); unset disables.
    "CLIENT_TPU_QOS": "",
    # Roofline attribution (FLOP and byte capture, MFU/MBU peaks): `0`/
    # `off` disables capture; unset/`1`/`on` defaults; else inline JSON or
    # `@/path.json` with `peak_flops`, `peak_bytes_per_s`, `device_kinds`,
    # `capture`.
    "CLIENT_TPU_ROOFLINE": "",
    # Router span-store capacity (stitched traces on /v2/trace/requests).
    "CLIENT_TPU_ROUTER_TRACE_BUFFER": "512",
    # Oldest-sequence batcher dispatch-ahead depth, in waves, before the
    # worker blocks on the oldest wave's outputs.
    "CLIENT_TPU_SEQ_PIPELINE": "2",
    # Self-drive governor (dispatch retune, SLO-burn tightening): unset/
    # `0`/`off` disables; `1`/`on` defaults; else inline JSON or
    # `@/path.json`.
    "CLIENT_TPU_SELFDRIVE": "",
    # Idle sleep (ms) of the engine-side ring reaper between sweeps that
    # admitted nothing.
    "CLIENT_TPU_SHM_REAPER_INTERVAL_MS": "1.0",
    # Per-ring slot cap of one reaper sweep (the fairness quantum).
    "CLIENT_TPU_SHM_REAPER_SPAN": "32",
    # SLO objectives (inline JSON or `@/path.json`); unset disables
    # tracking.
    "CLIENT_TPU_SLO": "",
    # Total payload bytes of staged datasets attached at once; 0 is
    # unlimited.
    "CLIENT_TPU_STAGED_BUDGET": "0",
    # Per-stream pending-response backlog (HTTP generate_stream, gRPC
    # stream RPC) before the slow-consumer shed; SSE backpressure starts
    # at half of it, the gRPC stream's at the mark itself.
    "CLIENT_TPU_STREAM_PENDING_LIMIT": "1024",
    # Test knob: a per-message stream-writer delay (ms) that forces a
    # writer backlog, so the coalescing and shed paths can be exercised
    # deterministically.
    "CLIENT_TPU_STREAM_WRITER_DELAY_MS": "0",
    # Flight recorder (1 Hz signal ring, GET /v2/timeseries): `0`/`off`
    # disables; unset/`1`/`on` defaults; else inline JSON or `@/path.json`.
    "CLIENT_TPU_TIMESERIES": "",
    # Request-trace span-store capacity (GET /v2/trace/requests).
    "CLIENT_TPU_TRACE_BUFFER": "512",
    # A flag: warm every model at load (each bucket run once on zeros) so
    # that no bucket's first execution under traffic is cold.
    "CLIENT_TPU_WARMUP": "",
}


def env_text(name: str, environ=None) -> str:
    """The stripped raw value of ``name``, or its default when unset (a
    set but blank value stays blank). The JSON knobs parse this
    themselves (``@file`` indirection, the ``1``/``on`` words)."""
    default = _DEFAULTS[name]
    raw = (os.environ if environ is None else environ).get(name)
    return default if raw is None else raw.strip()


def env_flag(name: str, environ=None) -> bool:
    """A flag: unset, blank, ``0``, ``false`` and ``off`` are False,
    anything else True."""
    return env_text(name, environ).lower() not in ("", "0", "false", "off")


def _text(name: str) -> str:
    text = env_text(name)
    return text if text else _DEFAULTS[name]


def env_str(name: str) -> str:
    """The value of ``name``, or its default when unset or blank."""
    return _text(name)


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
