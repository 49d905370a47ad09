"""Flight recorder: a process-global 1 Hz time-series sampler.

The port's copy of ``client_tpu/observability/timeseries.py``. One
daemon thread samples a small signal vocabulary once a second into a
bounded ring, so that "what did duty cycle / queue depth / card memory
do over the last ten minutes" has an answer:

- ``duty_cycle`` — the card's busy fraction (the efficiency profiler's
  window);
- ``queue_depth`` / ``in_flight`` — per-model scheduler backlog and
  batches executing;
- ``batch_fill`` — per-model EWMA of the padded-batch fill ratio;
- ``mfu`` — per-model MFU from the profiler's roofline;
- ``shed_rate`` — per-model admission sheds per second;
- ``wave_p50_ms`` — per-model decode-wave p50;
- ``tenant_cost_rate`` — per-tenant device seconds per second;
- ``hbm_used`` / ``hbm_reserved`` — card bytes in use (the HBM census)
  against planner reservations (none until the autotuner is ported);
- ``slo_burn`` — per-model fast-window availability burn rate.

Engines *attach* themselves weakly and contribute one sample dict per
tick through ``timeseries_sample()``; an engine detaches at shutdown and
the thread stops once no engine is attached. Export follows the event
journal's cursor contract: a rising ``seq`` per sample, ``since=``
exclusive, ``next_seq`` to resume, ``dropped`` counting overwrites.

``CLIENT_TPU_TIMESERIES``: ``0``/``off`` disables; ``1``/``on``/unset
takes the defaults (1 Hz, a 900-sample ring, about 15 minutes); else
inline JSON or ``@file`` with ``interval_s`` / ``capacity``. Served as
``GET /v2/timeseries?signal=&model=&since=`` and the ``Timeseries`` RPC.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, fields

from client_tpu_torch.config import env_text
from client_tpu_torch.utils import lockdep

__all__ = [
    "SIGNALS",
    "SCALAR_SIGNALS",
    "TimeseriesConfig",
    "FlightRecorder",
    "recorder",
    "reset_recorder",
]

ENV_VAR = "CLIENT_TPU_TIMESERIES"

# Per-model signals carry {model: value} maps; scalar signals one float.
# (`tenant_cost_rate` reuses the map machinery with TENANT keys: each
# tenant's device-seconds-per-second — its share of device occupancy —
# from cost-ledger deltas.)
SCALAR_SIGNALS = ("duty_cycle", "hbm_used", "hbm_reserved",
                  "qos_throttled")
MODEL_SIGNALS = ("queue_depth", "in_flight", "batch_fill", "shed_rate",
                 "wave_p50_ms", "slo_burn", "tenant_cost_rate", "mfu")
SIGNALS = SCALAR_SIGNALS + MODEL_SIGNALS


@dataclass
class TimeseriesConfig:
    """``CLIENT_TPU_TIMESERIES`` knobs. Unlike the opt-in subsystems the
    recorder defaults ON: unset takes defaults, ``0``/``off`` disables."""

    interval_s: float = 1.0   # sampling period
    capacity: int = 900       # ring size in samples (~15 min at 1 Hz)
    enabled: bool = True

    @classmethod
    def from_dict(cls, data: dict) -> "TimeseriesConfig":
        known = {f.name for f in fields(cls) if f.name != "enabled"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{ENV_VAR}: unknown key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        cfg = cls()
        if "interval_s" in data:
            try:
                cfg.interval_s = float(data["interval_s"])
            except (TypeError, ValueError):
                raise ValueError(
                    f"{ENV_VAR}: key 'interval_s' expects a number, "
                    f"got {data['interval_s']!r}") from None
        if "capacity" in data:
            try:
                cfg.capacity = int(data["capacity"])
            except (TypeError, ValueError):
                raise ValueError(
                    f"{ENV_VAR}: key 'capacity' expects an integer, "
                    f"got {data['capacity']!r}") from None
        if cfg.interval_s <= 0:
            raise ValueError(f"{ENV_VAR}: interval_s must be > 0")
        if cfg.capacity < 1:
            raise ValueError(f"{ENV_VAR}: capacity must be >= 1")
        return cfg

    @classmethod
    def from_env(cls, environ=os.environ) -> "TimeseriesConfig":
        raw = env_text(ENV_VAR, environ)
        if raw.lower() in ("0", "false", "off"):
            return cls(enabled=False)
        if not raw or raw.lower() in ("1", "true", "on"):
            return cls()
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as f:
                    raw = f.read()
            except OSError as exc:
                raise ValueError(
                    f"{ENV_VAR}: cannot read '{raw[1:]}': {exc}") from None
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{ENV_VAR}: invalid JSON ({exc})") from None
        if not isinstance(data, dict):
            raise ValueError(f"{ENV_VAR}: expected a JSON object")
        return cls.from_dict(data)


class FlightRecorder:
    """Bounded ring of per-second signal samples over weakly-attached
    providers (engines). Thread-safe; the sampling thread starts on the
    first :meth:`attach` and stops with the last :meth:`detach`."""

    def __init__(self, config: TimeseriesConfig | None = None, *,
                 clock=time.time):
        self.config = config or TimeseriesConfig()
        self._clock = clock
        self._ring: deque = deque(maxlen=self.config.capacity)
        self._seq = 0
        self._dropped = 0
        self._lock = lockdep.Lock("timeseries.recorder")
        # id(provider) -> weakref; id keys survive unhashable providers
        # and give O(1) detach. Dead refs are pruned every tick.
        self._providers: dict[int, weakref.ref] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._tick_failures = 0

    # -- providers ------------------------------------------------------------

    def attach(self, provider) -> None:
        """Register a sample provider (an object with a zero-arg
        ``timeseries_sample() -> dict`` method) and make sure the
        sampling thread runs. Idempotent per provider identity; a no-op
        when the recorder is disabled."""
        if not self.config.enabled:
            return
        with self._lock:
            self._providers[id(provider)] = weakref.ref(provider)
        self.start()

    def detach(self, provider) -> None:
        """Drop a provider; the sampling thread stops with the last one
        (an engine's shutdown leaves no thread behind)."""
        with self._lock:
            self._providers.pop(id(provider), None)
            idle = all(r() is None for r in self._providers.values())
        if idle:
            self.stop()

    def providers(self) -> list:
        """Live providers (dead weakrefs pruned as a side effect)."""
        out = []
        with self._lock:
            for key in list(self._providers):
                obj = self._providers[key]()
                if obj is None:
                    del self._providers[key]
                else:
                    out.append(obj)
        return out

    # -- lifecycle ------------------------------------------------------------

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "FlightRecorder":
        """Start the sampling thread (idempotent; no-op when disabled)."""
        if not self.config.enabled or self.running():
            return self
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            # An event per thread: a stop racing a restart ends the old
            # thread, never the new one.
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(self._stop,),
                name="flight-recorder", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the sampling thread (idempotent); the ring is kept."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2)
        self._thread = None

    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.config.interval_s):
            with self._lock:
                if all(r() is None for r in self._providers.values()):
                    # Every provider was collected without a detach: end
                    # here (an attach after this starts a new thread).
                    if self._thread is threading.current_thread():
                        self._thread = None
                    return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the recorder must not die
                self._tick_failures += 1
                if self._tick_failures == 1:
                    logging.getLogger(
                        "client_tpu_torch.timeseries").exception(
                        "flight-recorder tick failed (logged once; "
                        "further failures only counted)")

    # -- sampling -------------------------------------------------------------

    def tick(self) -> dict | None:
        """Take one sample across all live providers and append it to
        the ring. Also the test/offline entry point — callable without
        the thread. Returns the sample (None when disabled)."""
        if not self.config.enabled:
            return None
        signals: dict = {}
        for provider in self.providers():
            try:
                contributed = provider.timeseries_sample()
            # tpulint: allow[swallowed-exception] one sick provider must not stop the others from recording
            except Exception:  # noqa: BLE001 — one sick provider must
                continue       # not stop the others from recording
            if not contributed:
                continue
            for name, value in contributed.items():
                if name in SCALAR_SIGNALS:
                    # Co-resident engines share one device: take the max
                    # rather than double-counting the same HBM.
                    prev = signals.get(name)
                    signals[name] = (value if prev is None
                                     else max(prev, value))
                elif name in MODEL_SIGNALS and isinstance(value, dict):
                    signals.setdefault(name, {}).update(value)
        with self._lock:
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            sample = {"seq": self._seq, "ts_wall": self._clock(),
                      "signals": signals}
            self._ring.append(sample)
        return sample

    # -- export ---------------------------------------------------------------

    def export(self, *, signal: str | None = None,
               model: str | None = None,
               since_seq: int | None = None,
               since_wall: float | None = None,
               until_wall: float | None = None,
               limit: int | None = None) -> dict:
        """The ``GET /v2/timeseries`` body. ``signal`` narrows to one
        signal family, ``model`` narrows per-model maps to one model,
        ``since_seq`` is the exclusive cursor from the previous
        response's ``next_seq``, ``since_wall``/``until_wall`` bound the
        samples by wall stamp (exclusive lower, inclusive upper — "the
        60 s around this edge" without cursor arithmetic), ``limit``
        keeps the newest n samples. Unknown signal names raise
        ValueError (HTTP 400)."""
        if signal is not None and signal not in SIGNALS:
            raise ValueError(
                f"unknown signal {signal!r}; valid: {list(SIGNALS)}")
        with self._lock:
            samples = list(self._ring)
            next_seq = self._seq
            dropped = self._dropped
        if since_seq is not None:
            samples = [s for s in samples if s["seq"] > since_seq]
        if since_wall is not None:
            samples = [s for s in samples if s["ts_wall"] > since_wall]
        if until_wall is not None:
            samples = [s for s in samples if s["ts_wall"] <= until_wall]
        if limit is not None and limit >= 0:
            samples = samples[-limit:]
        out_samples = []
        for s in samples:
            sig = s["signals"]
            if signal is not None:
                sig = {signal: sig[signal]} if signal in sig else {}
            if model is not None:
                narrowed = {}
                for name, value in sig.items():
                    if isinstance(value, dict):
                        if model in value:
                            narrowed[name] = {model: value[model]}
                    else:
                        narrowed[name] = value
                sig = narrowed
            out_samples.append({"seq": s["seq"], "ts_wall": s["ts_wall"],
                                "signals": sig})
        return {
            "enabled": self.config.enabled,
            "interval_s": self.config.interval_s,
            "capacity": self.config.capacity,
            "signals": list(SIGNALS),
            "samples": out_samples,
            "next_seq": next_seq,
            "dropped": dropped,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# -- process-global recorder ---------------------------------------------------

_default: FlightRecorder | None = None
_default_lock = lockdep.Lock("timeseries.default")


def recorder() -> FlightRecorder:
    """The process-global flight recorder (double-checked, like
    :func:`client_tpu_torch.observability.events.journal`); sized from
    ``CLIENT_TPU_TIMESERIES`` on first access."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = FlightRecorder(TimeseriesConfig.from_env())
    return _default


def reset_recorder() -> None:
    """Stop and drop the global recorder (tests); the next
    :func:`recorder` call recreates it with current env settings."""
    global _default
    with _default_lock:
        if _default is not None:
            _default.stop()
        _default = None
