"""Trace extension: device-level profiling behind ``/v2/trace/setting``.

Counterpart of ``client_tpu/engine/trace.py``, with its settings and
error words. Where the JAX engine wraps ``jax.profiler``, this one runs a
``torch.profiler`` session (CPU activity, and the card's kernels and
copies through CUPTI when CUDA is available) over every model the engine
serves while it is active (the card's activity is traced process-wide;
the CPU side, on the session's own thread, is little), and writes it as
a Chrome trace (``trace_<pid>_<n>.json``, for ``chrome://tracing`` or
Perfetto) into ``log_dir`` when it stops.

Settings: ``trace_level`` — ``["OFF"]`` or ``["TIMESTAMPS"]``;
``log_dir`` — where the trace is written (``trace_file`` is accepted as
an alias on update).
"""

from __future__ import annotations

import os
import threading

from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.utils import lockdep


class TraceManager:
    """Engine-wide device trace control (``torch.profiler`` start/stop)."""

    def __init__(self):
        self._lock = lockdep.Lock("engine.trace")
        self._log_dir = ""
        self._session: _Session | None = None
        self._written = 0

    def setting(self) -> dict:
        with self._lock:
            return {
                "trace_level": (["TIMESTAMPS"] if self._session is not None
                                else ["OFF"]),
                "log_dir": self._log_dir,
            }

    def update(self, d: dict) -> dict:
        """Apply a settings delta; returns the resulting settings."""
        level = d.get("trace_level")
        log_dir = d.get("log_dir", d.get("trace_file"))
        if isinstance(level, str):
            level = [level]
        want_active = (None if level is None
                       else any(lv and lv.upper() != "OFF" for lv in level))
        with self._lock:
            # Deactivation first: {"trace_level": ["OFF"], "log_dir": new}
            # is the natural stop-and-redirect call and must succeed.
            if want_active is False and self._session is not None:
                self._stop_locked()
            if log_dir:
                if self._session is not None:
                    raise EngineError(
                        "cannot change log_dir while a trace is active", 400)
                self._log_dir = str(log_dir)
            if want_active and self._session is None:
                if not self._log_dir:
                    raise EngineError(
                        "trace activation requires a log_dir", 400)
                self._written += 1
                try:
                    self._session = _Session(os.path.join(
                        self._log_dir,
                        f"trace_{os.getpid()}_{self._written}.json"))
                except Exception as exc:  # noqa: BLE001 — the caller's 500
                    raise EngineError(
                        f"failed to start device trace: {exc}", 500) from None
        return self.setting()

    def _stop_locked(self) -> None:
        session, self._session = self._session, None
        session.stop()

    def shutdown(self) -> None:
        with self._lock:
            if self._session is not None:
                self._stop_locked()


class _Session:
    """One ``torch.profiler`` session on a thread of its own: the profiler
    must stop on the thread that started it, and each HTTP request has a
    thread of its own. A failure to stop or to write leaves the manager
    inactive all the same: the trace is not running, which is what the
    caller asked for."""

    def __init__(self, path: str):
        self.path = path
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-trace")
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            self._thread.join()
            raise self._error

    def _run(self) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as exc:  # noqa: BLE001 — raised by __init__
            self._error = exc
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            prof.export_chrome_trace(self.path)
        except Exception:  # noqa: BLE001 — see the class docstring
            pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
