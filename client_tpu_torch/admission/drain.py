"""Graceful drain: a SIGTERM shutdown that drops no admitted work.

The port's copy of ``client_tpu/admission/drain.py``. An orchestrator
sends SIGTERM and grants a grace period before SIGKILL; an abrupt exit
drops every request in flight. The drain loses nothing already admitted:

1. ``engine.begin_drain()`` — readiness turns false (``/v2/health/ready``
   answers 503, ``ServerReady`` false) and every NEW request is refused
   with 503 and ``Retry-After`` pushback.
2. The frontends stop accepting: the HTTP accept loop ends (handler
   threads already serving run on) and the gRPC server takes no new RPCs,
   with a grace window for the active ones.
3. Poll until the engine is empty (the admission controller's requests
   in flight plus what the schedulers hold) or the deadline passes.
4. ``engine.shutdown()`` — the schedulers answer what is left with 503
   (``Scheduler.stop()``), then the gRPC stop is re-armed with a short
   grace, since idle client connections would otherwise hold it for the
   whole deadline.

The wall time goes on the ``tpu_drain_duration_seconds`` gauge and into
the returned report. ``install_sigterm_handler`` wires the sequence to
SIGTERM for ``python -m client_tpu_torch.server``.
"""

from __future__ import annotations

import logging
import signal
import threading
import time

_log = logging.getLogger("client_tpu_torch")

DEFAULT_DRAIN_DEADLINE_S = 30.0


def _pending_work(engine) -> int:
    """Requests admitted but not yet finally responded, plus anything a
    scheduler still holds (covers in-process callers that bypass the
    engine's admission accounting)."""
    pending = 0
    admission = getattr(engine, "admission", None)
    if admission is not None:
        pending += admission.total_inflight()
    for sched in engine.schedulers():
        pending += sched.queue.qsize()
        pending += max(0, getattr(sched, "active_batches", 0))
    return pending


def drain(engine, http_servers=(), grpc_servers=(),
          deadline_s: float = DEFAULT_DRAIN_DEADLINE_S,
          poll_s: float = 0.02) -> dict:
    """Run the full drain sequence; returns a report dict:
    ``{"drain_s", "clean", "pending"}`` where ``clean`` means every
    admitted request finished inside the deadline (``pending`` is what
    remained when the deadline forced shutdown — those requests get 503
    responses from ``Scheduler.stop()``, not severed connections)."""
    from client_tpu_torch.observability.events import journal

    jour = journal()
    start = time.monotonic()
    deadline = start + max(0.0, deadline_s)
    engine.begin_drain()
    jour.emit("drain", "begin", deadline_s=deadline_s,
              http_frontends=len(http_servers),
              grpc_frontends=len(grpc_servers))
    # Stop accepting new work. HTTP: the accept loop ends (threads serving
    # accepted connections run on; their new requests hit the drain gate).
    # gRPC: new RPCs are rejected immediately; in-flight ones get the
    # remaining grace. Neither wait happens here — draining the engine is
    # the clock that matters.
    for srv in http_servers:
        try:
            srv.httpd.shutdown()
        except Exception:  # noqa: BLE001 — a dead frontend must not stop
            _log.exception("http frontend shutdown failed during drain")
    grpc_stops = []
    for srv in grpc_servers:
        try:
            grpc_stops.append(
                (srv,
                 srv.server.stop(grace=max(0.0, deadline - time.monotonic()))))
        except Exception:  # noqa: BLE001
            _log.exception("grpc frontend stop failed during drain")
    pending = _pending_work(engine)
    while pending > 0 and time.monotonic() < deadline:
        time.sleep(poll_s)
        pending = _pending_work(engine)
    if pending:
        _log.warning(
            "drain deadline (%.1fs) passed with %d request(s) pending; "
            "they will be failed with 503 by scheduler shutdown",
            deadline_s, pending)
    engine.shutdown()
    # The first stop()'s grace is sized for in-flight RPCs, but its
    # termination event also waits out *idle* client connections — the
    # client library's channel cache keeps HTTP/2 connections open long
    # after their RPCs finish, so the event cannot fire until the grace
    # expires. Every admitted request has been responded to by now
    # (drained, or failed 503 by scheduler shutdown), so re-arm stop
    # with a short grace to force idle connections closed.
    for srv, evt in grpc_stops:
        if evt.wait(0.05):
            continue
        try:
            evt = srv.server.stop(grace=0.25)
        except Exception:  # noqa: BLE001
            _log.exception("grpc frontend final stop failed during drain")
        evt.wait(max(0.0, deadline - time.monotonic()))
    for srv in http_servers:
        try:
            srv.httpd.server_close()
        except OSError:
            _log.exception("http frontend close failed during drain")
    drain_s = time.monotonic() - start
    metrics = getattr(engine, "metrics", None)
    if metrics is not None:
        metrics.drain_duration.set(drain_s)
    _log.info("drain complete in %.3fs (clean=%s, pending=%d)",
              drain_s, pending == 0, pending)
    jour.emit("drain", "end",
              severity="INFO" if pending == 0 else "WARNING",
              drain_s=round(drain_s, 4), clean=pending == 0,
              pending=pending)
    return {"drain_s": drain_s, "clean": pending == 0, "pending": pending}


def install_sigterm_handler(engine, http_servers=(), grpc_servers=(),
                            deadline_s: float = DEFAULT_DRAIN_DEADLINE_S,
                            on_done=None) -> threading.Event:
    """Install a SIGTERM handler running :func:`drain` on a background
    thread (signal handlers must return promptly; the drain takes up to
    ``deadline_s``). Returns an Event set when the drain finishes — the
    server main loop waits on it and exits. ``on_done(report)`` runs
    after the drain, still on the drain thread. Must be called from the
    main thread (CPython signal API restriction)."""
    done = threading.Event()
    fired = threading.Event()

    def _run():
        report = drain(engine, http_servers, grpc_servers,
                       deadline_s=deadline_s)
        if on_done is not None:
            try:
                on_done(report)
            except Exception:  # noqa: BLE001
                _log.exception("drain on_done callback raised")
        done.set()

    def _handler(signum, frame):
        if fired.is_set():
            return  # double SIGTERM: first drain is already running
        fired.set()
        _log.info("SIGTERM received; draining (deadline %.1fs)", deadline_s)
        threading.Thread(target=_run, name="drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _handler)
    return done
