"""The operational event journal, and the opt-in JSON log sink.

The port's copy of ``client_tpu/observability/events.py``. Every state
transition the serving stack makes lands here as one :class:`Event`
carrying wall-clock and monotonic stamps, the model and version it
concerns, a severity and, when a request caused it, that request's
``trace_id``, so an operator can go from ``GET /v2/events`` to the
request's spans in ``GET /v2/trace/requests``.

Emit points (category.name) in this slice: ``lifecycle.server_start`` /
``lifecycle.server_shutdown`` / ``lifecycle.model_load_failed``,
``model.load`` / ``model.unload``, ``fault.injected`` and
``compile.finished`` (a bucket's first execution).

The default journal is process-global (:func:`journal`), like the fault
registry: models and fault sites emit from below the engine. The buffer
is a bounded deque (``CLIENT_TPU_EVENT_BUFFER``, default 1024); old
events fall off the head and ``dropped`` counts them, so a reader polling
with a ``since`` cursor can see a gap.

``CLIENT_TPU_LOG=json`` mirrors every event, and every record of the
``client_tpu_torch`` logger, to stderr as one JSON object per line.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import deque

from client_tpu_torch.config import env_int, env_text
from client_tpu_torch.utils import lockdep

ENV_BUFFER = "CLIENT_TPU_EVENT_BUFFER"
ENV_LOG = "CLIENT_TPU_LOG"
DEFAULT_CAPACITY = 1024
LOGGER = "client_tpu_torch"

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


class Event:
    """One journal entry. ``seq`` is a cursor, gap-free per journal;
    ``ts_wall`` is epoch seconds, ``ts_mono_ns`` the monotonic stamp that
    orders it against trace spans."""

    __slots__ = ("seq", "ts_wall", "ts_mono_ns", "category", "name",
                 "severity", "model", "version", "trace_id", "detail")

    def __init__(self, seq, ts_wall, ts_mono_ns, category, name, severity,
                 model=None, version=None, trace_id=None, detail=None):
        self.seq = seq
        self.ts_wall = ts_wall
        self.ts_mono_ns = ts_mono_ns
        self.category = category
        self.name = name
        self.severity = severity
        self.model = model
        self.version = version
        self.trace_id = trace_id
        self.detail = detail or {}

    def to_dict(self) -> dict:
        d = {
            "seq": self.seq,
            "ts_wall": self.ts_wall,
            "ts_mono_ns": self.ts_mono_ns,
            "category": self.category,
            "name": self.name,
            "severity": self.severity,
        }
        if self.model is not None:
            d["model"] = self.model
        if self.version:
            d["version"] = str(self.version)
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.detail:
            d["detail"] = self.detail
        return d


class EventJournal:
    """Bounded, thread-safe event ring. ``emit`` takes one lock and
    appends; sinks run outside the lock, so a slow stderr cannot stall
    the serving path."""

    def __init__(self, capacity: int | None = None, clock=time.time,
                 mono_ns=time.monotonic_ns):
        if capacity is None:
            try:
                capacity = env_int(ENV_BUFFER)
            except ValueError:
                capacity = DEFAULT_CAPACITY
        self.capacity = max(1, int(capacity))
        self._clock = clock
        self._mono_ns = mono_ns
        self._events: deque[Event] = deque(maxlen=self.capacity)
        self._lock = lockdep.Lock("observability.events")
        self._seq = 0
        self._dropped = 0
        self._sinks: list = []

    def emit(self, category: str, name: str, *, severity: str = "INFO",
             model: str | None = None, version=None,
             trace_id: str | None = None, **detail) -> Event:
        if severity not in _SEV_RANK:
            raise ValueError(f"unknown severity {severity!r} "
                             f"(valid: {', '.join(SEVERITIES)})")
        with self._lock:
            self._seq += 1
            evt = Event(self._seq, self._clock(), self._mono_ns(),
                        category, name, severity, model=model,
                        version=str(version) if version is not None else None,
                        trace_id=trace_id, detail=detail or None)
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(evt)
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(evt)
            except Exception:  # noqa: BLE001 — a broken sink must not
                pass           # take down the serving path
        return evt

    def snapshot(self, *, model: str | None = None,
                 severity: str | None = None, since_seq: int | None = None,
                 since_ts: float | None = None,
                 until_ts: float | None = None,
                 category: str | None = None,
                 limit: int | None = None) -> list[Event]:
        """Filtered copy, oldest first. ``severity`` is a minimum (WARNING
        returns WARNING and ERROR); ``since_seq`` / ``since_ts`` are
        exclusive cursors, ``until_ts`` an inclusive wall upper bound;
        ``limit`` keeps the newest."""
        min_rank = None
        if severity is not None:
            sev = str(severity).upper()
            if sev not in _SEV_RANK:
                raise ValueError(f"unknown severity {severity!r} "
                                 f"(valid: {', '.join(SEVERITIES)})")
            min_rank = _SEV_RANK[sev]
        with self._lock:
            events = list(self._events)
        out = []
        for e in events:
            if model is not None and e.model != model:
                continue
            if category is not None and e.category != category:
                continue
            if min_rank is not None and _SEV_RANK[e.severity] < min_rank:
                continue
            if since_seq is not None and e.seq <= since_seq:
                continue
            if since_ts is not None and e.ts_wall <= since_ts:
                continue
            if until_ts is not None and e.ts_wall > until_ts:
                continue
            out.append(e)
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def export(self, **filters) -> dict:
        """The ``GET /v2/events`` body."""
        events = self.snapshot(**filters)
        with self._lock:
            next_seq = self._seq
            dropped = self._dropped
        return {
            "events": [e.to_dict() for e in events],
            "next_seq": next_seq,
            "dropped": dropped,
            "capacity": self.capacity,
        }

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        """Empty the ring (tests); ``seq`` keeps counting, so cursors held
        across a clear stay valid."""
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def add_sink(self, fn) -> None:
        """Call ``fn(event)`` after every emit, outside the lock; adding
        the same callable twice adds it once."""
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)


_default: EventJournal | None = None
_default_lock = lockdep.Lock("observability.events.default")


def journal() -> EventJournal:
    """The process-global journal; ``CLIENT_TPU_LOG=json`` wires the
    stderr sink on first access."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = EventJournal()
                configure_logging()
    return _default


def reset_journal() -> None:
    """Drop the global journal (tests); the next :func:`journal` makes a
    new one with the current environment."""
    global _default
    with _default_lock:
        _default = None


class _JsonLogFormatter(logging.Formatter):
    """One JSON object per log record; ``trace_id`` rides along when the
    caller attached one with ``extra={"trace_id": ...}``."""

    def format(self, record: logging.LogRecord) -> str:
        d = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        trace_id = getattr(record, "trace_id", None)
        if trace_id:
            d["trace_id"] = trace_id
        if record.exc_info and record.exc_info[0] is not None:
            d["exc"] = self.formatException(record.exc_info)
        return json.dumps(d, default=str)


def _event_sink(stream):
    def sink(evt: Event) -> None:
        d = evt.to_dict()
        d["kind"] = "event"
        try:
            stream.write(json.dumps(d, default=str) + "\n")
            stream.flush()
        except (OSError, ValueError):
            pass

    return sink


def configure_logging(environ=os.environ, stream=None,
                      jour: EventJournal | None = None) -> bool:
    """With ``CLIENT_TPU_LOG=json``: attach a JSON-lines handler to the
    ``client_tpu_torch`` logger (in place of its propagation) and mirror
    every journal event to the same stream. Returns True when the sink
    was installed. Idempotent for the handler."""
    if env_text(ENV_LOG, environ).lower() != "json":
        return False
    out = stream or sys.stderr
    logger = logging.getLogger(LOGGER)
    if not any(getattr(h, "_client_tpu_json", False)
               for h in logger.handlers):
        handler = logging.StreamHandler(out)
        handler.setFormatter(_JsonLogFormatter())
        handler._client_tpu_json = True
        logger.addHandler(handler)
        logger.propagate = False
        if logger.level == logging.NOTSET:
            logger.setLevel(logging.INFO)
    target = jour if jour is not None else _default
    if target is not None:
        target.add_sink(_event_sink(out))
    return True
