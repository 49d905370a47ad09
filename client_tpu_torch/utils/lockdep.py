"""lockdep: named locks with run-time lock-order and blocking checks.

The port's copy of ``client_tpu/utils/lockdep.py``. The engine runs many
concurrent loops (scheduler workers, the autotuner, the flight recorder,
the SLO governor, the shm ring reaper, the blackbox's capture thread)
over some sixty lock sites. Under ``CLIENT_TPU_LOCKDEP`` (tests and
checks only) the :func:`Lock`/:func:`RLock`/:func:`Condition` factories
return instrumented primitives that

* record each thread's acquisition chains into one process-global
  **lock-order graph** keyed by lock *name* (a name is a class of locks:
  every ``metrics.family`` instance shares one node);
* raise :class:`LockOrderViolation` the moment an acquisition would
  close a cycle in that graph (an A->B edge exists and a thread now
  takes B->A: a potential deadlock even if this run did not deadlock),
  with the stacks of **both** edges in the message;
* raise on a same-instance re-acquire of a non-reentrant lock (a
  certain self-deadlock);
* enforce the **declared ranks** of :data:`DECLARED_ORDER`: acquiring a
  lower-ranked lock while holding a higher-ranked one raises before any
  cycle exists;
* patch ``time.sleep`` so that a sleep while any lockdep lock is held
  raises :class:`BlockingUnderLock`; a reviewed exception wraps the
  call in :func:`allow_blocking`.

With the variable unset the factories return plain ``threading``
primitives: one function call at construction, nothing patched, no
graph.

Names follow ``<subsystem>.<role>`` and are the JAX package's for every
lock that has a counterpart there, so its ranks apply unchanged. The
port's own locks (the kernel wrappers' launch counters and bind locks,
the ``nvcc`` build lock, the per-cuBLAS-handle stream table, the
scheduler's busy counter) rank innermost. Locks created *before*
:func:`enable` (module-level locks of modules already imported) stay
plain: set the variable before the process imports the port.
"""

from __future__ import annotations

import os
import threading
import time
import traceback

from client_tpu_torch import config as _config

__all__ = [
    "Lock",
    "RLock",
    "Condition",
    "LockOrderViolation",
    "BlockingUnderLock",
    "DECLARED_ORDER",
    "enable",
    "disable",
    "enabled",
    "reset",
    "allow_blocking",
    "held_names",
    "violations",
]


class LockOrderViolation(RuntimeError):
    """Two lock names were acquired in both orders (potential deadlock),
    or a declared rank was violated, or a non-reentrant lock was
    re-acquired by its holder."""


class BlockingUnderLock(RuntimeError):
    """A known-blocking call (``time.sleep``) ran while holding a lock."""


# Declared ordering: rank of each lock name, lowest = outermost (taken
# first). Acquiring a name with a LOWER rank while holding a HIGHER rank
# raises. Names absent from this table are unranked: they participate in
# cycle detection only. Keep ranks sparse so layers can be inserted.
DECLARED_ORDER: dict[str, int] = {
    # control plane (model lifecycle) — outermost
    "engine.engine": 100,
    # Per-name load serializer is taken BEFORE the repository state
    # lock (repository.load holds it across _load_serialized, which
    # re-enters the state lock for each phase).
    "engine.repository.load": 150,
    "engine.repository": 200,
    # QoS controller: admission-side class gates + governor. Taken
    # before any scheduler queue lock (classification happens at admit,
    # never under a queue condition); holds admission.bucket (unranked)
    # across governor rate retargets.
    "qos.controller": 250,
    # data plane (request flow)
    "scheduler.queue": 300,
    "scheduler.order": 310,
    "sequence.slots": 320,
    "sequence.arena": 330,
    "engine.model": 400,
    # shared resources below the schedulers
    "engine.arena": 500,
    "shm.system": 510,
    "shm.device": 510,
    # Staged datasets sit between the plain shm managers and the ring
    # plane: ring completion paths may resolve staged descriptors but
    # never the reverse.
    "shmstaged.manager": 515,
    "shmring.manager": 520,
    "shmring.ring": 530,
    "engine.rowcache": 540,
    # telemetry: leaf locks — safe to take under anything above
    "engine.stats": 600,
    "observability.profiler": 700,
    "observability.slo": 700,
    "observability.slo.model": 710,
    "observability.events": 720,
    "metrics.registry": 800,
    "metrics.family": 810,
    "metrics.value": 820,
    # Blackbox trigger matcher: runs inside journal sinks, i.e. on the
    # emitting thread AFTER observability.events is released but while
    # the emitter may still hold any lock above — so it ranks innermost.
    # Neither lock is ever held across an emit or a metrics update (the
    # capture thread journals blackbox.captured with no locks held).
    "observability.blackbox": 830,
    "observability.blackbox.store": 840,
    # The port's own locks, with no counterpart in the JAX package. Each
    # is a leaf or nearly so: the blackbox's bundle-id counter and crash
    # hook list, the scheduler's busy counter and the stream table take
    # nothing under them; a kernel wrapper's bind lock takes the build
    # lock (nvcc runs under it), and the launch counters are taken alone.
    "observability.blackbox.seq": 850,
    "observability.blackbox.hooks": 860,
    "scheduler.active": 900,
    "engine.worker_streams": 905,
    "ops.flash_attention.bind": 910,
    "ops.decode_attention.bind": 910,
    "parallel.kv_shard.bind": 910,
    "ops.cuda_build": 920,
    "ops.flash_attention.count": 930,
    "ops.decode_attention.count": 930,
    "parallel.kv_shard.count": 930,
}

_enabled = False
_graph_lock = threading.Lock()
# name -> {successor_name: formatted stack captured when the edge was
# first recorded}. Edge A->B means "some thread held A while taking B".
_graph: dict[str, dict[str, str]] = {}
# Every violation raised, first line of its message, oldest first: a
# raise can be swallowed by the caller (a journal sink's guard, a
# frontend's handler), the record stays.
_violations: list[str] = []
_tls = threading.local()
_real_sleep = time.sleep


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def held_names() -> tuple[str, ...]:
    """Names of the lockdep locks the calling thread currently holds
    (outermost first). Empty when disabled."""
    return tuple(lk._name for lk in _held())


def _blocking_depth() -> int:
    return getattr(_tls, "allow_blocking", 0)


class allow_blocking:
    """Context manager marking a region where blocking while holding a
    lock is intentional and reviewed."""

    def __enter__(self):
        _tls.allow_blocking = _blocking_depth() + 1
        return self

    def __exit__(self, *exc):
        _tls.allow_blocking = _blocking_depth() - 1
        return False


def _recorded(exc: RuntimeError) -> RuntimeError:
    with _graph_lock:
        _violations.append(str(exc).split("\n", 1)[0])
    return exc


def _checked_sleep(seconds):
    if _held() and _blocking_depth() == 0:
        raise _recorded(BlockingUnderLock(
            f"time.sleep({seconds!r}) while holding lockdep lock(s) "
            f"{list(held_names())} — sleeping under a lock stalls every "
            "other thread contending for it; move the sleep outside the "
            "critical section (or wrap in lockdep.allow_blocking() if "
            "reviewed)\n" + "".join(traceback.format_stack(limit=8))))
    _real_sleep(seconds)


def _stack() -> str:
    return "".join(traceback.format_stack(limit=12)[:-3])


def _find_path(start: str, goal: str) -> list[str] | None:
    """DFS for a path start→…→goal in the order graph (caller holds
    ``_graph_lock``)."""
    stack = [(start, [start])]
    seen = {start}
    while stack:
        node, path = stack.pop()
        for succ in _graph.get(node, ()):
            if succ == goal:
                return path + [succ]
            if succ not in seen:
                seen.add(succ)
                stack.append((succ, path + [succ]))
    return None


def _record_edges(new_lock) -> None:
    """Called with the acquisition *about to happen*: check ranks and
    cycles against every lock the thread already holds, then record the
    edges."""
    held = _held()
    if not held:
        return
    new_name = new_lock._name
    for prior in held:
        prior_name = prior._name
        if prior_name == new_name:
            # Two same-named instances nested (e.g. parent/child rings).
            # Instance-level ordering of one class is out of scope for
            # the name-keyed graph; the self-deadlock case (same
            # *instance*) is raised separately in _DepLock.acquire.
            continue
        if (prior._order is not None and new_lock._order is not None
                and new_lock._order < prior._order):
            raise _recorded(LockOrderViolation(
                f"declared-order violation: acquiring '{new_name}' "
                f"(rank {new_lock._order}) while holding '{prior_name}' "
                f"(rank {prior._order}) — lower ranks are outermost and "
                "must be taken first\n--- acquisition stack ---\n"
                + _stack()))
        with _graph_lock:
            reverse = _find_path(new_name, prior_name)
            if reverse is not None:
                chain = " -> ".join(reverse)
                stacks = []
                for a, b in zip(reverse, reverse[1:]):
                    stacks.append(
                        f"--- earlier edge {a} -> {b} recorded at ---\n"
                        + _graph[a][b])
                exc = LockOrderViolation(
                    f"lock-order inversion: this thread holds "
                    f"'{prior_name}' and is acquiring '{new_name}', but "
                    f"the opposite order {chain} was already observed "
                    "(potential deadlock)\n"
                    + "".join(stacks)
                    + "--- this acquisition ---\n" + _stack())
                # _graph_lock is held: record without _recorded().
                _violations.append(str(exc).split("\n", 1)[0])
                raise exc
            edges = _graph.setdefault(prior_name, {})
            if new_name not in edges:
                edges[new_name] = _stack()


class _DepLock:
    """Instrumented non-reentrant lock."""

    _reentrant = False

    def __init__(self, name: str, order: int | None):
        self._name = name
        self._order = order
        self._inner = self._make_inner()
        self._count = 0          # recursion depth (RLock subclass)

    def _make_inner(self):
        return threading.Lock()

    def _owned_by_me(self) -> bool:
        return any(lk is self for lk in _held())

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._owned_by_me():
            if not self._reentrant:
                raise _recorded(LockOrderViolation(
                    f"self-deadlock: thread re-acquiring non-reentrant "
                    f"lock '{self._name}' it already holds\n" + _stack()))
        else:
            _record_edges(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._count += 1
            if self._count == 1 or not self._reentrant:
                _held().append(self)
        return ok

    def release(self):
        self._count -= 1
        if self._count == 0 or not self._reentrant:
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockdep.{type(self).__name__} {self._name!r}>"


class _DepRLock(_DepLock):
    _reentrant = True

    def _make_inner(self):
        return threading.RLock()


class _DepCondition(_DepLock):
    """Instrumented condition variable. Acquire/release are tracked like
    a lock; ``wait``/``wait_for`` delegate to the real Condition (the
    thread is parked there, so the held-stack needs no adjustment — a
    blocked thread makes no acquisitions)."""

    def __init__(self, name: str, order: int | None):
        super().__init__(name, order)
        self._cond = threading.Condition(self._inner)

    def wait(self, timeout: float | None = None):
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()


def Lock(name: str = "anon", order: int | None = None):  # noqa: N802
    """A named lock: plain ``threading.Lock`` unless lockdep is enabled.
    ``order`` overrides the :data:`DECLARED_ORDER` rank for this name."""
    if not _enabled:
        return threading.Lock()
    return _DepLock(name, DECLARED_ORDER.get(name) if order is None
                    else order)


def RLock(name: str = "anon", order: int | None = None):  # noqa: N802
    if not _enabled:
        return threading.RLock()
    return _DepRLock(name, DECLARED_ORDER.get(name) if order is None
                     else order)


def Condition(name: str = "anon", order: int | None = None):  # noqa: N802
    if not _enabled:
        return threading.Condition()
    return _DepCondition(name, DECLARED_ORDER.get(name) if order is None
                         else order)


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn checking on for locks created *after* this call and patch
    ``time.sleep``. Prefer setting ``CLIENT_TPU_LOCKDEP=1`` before the
    process imports client_tpu_torch so module-level locks are covered
    too."""
    global _enabled
    _enabled = True
    time.sleep = _checked_sleep


def disable() -> None:
    global _enabled
    _enabled = False
    time.sleep = _real_sleep


def reset() -> None:
    """Forget every recorded edge and violation (test isolation)."""
    with _graph_lock:
        _graph.clear()
        _violations.clear()


def violations() -> list[str]:
    """Every violation raised since the last :func:`reset`, oldest
    first, as the first line of its message, whether or not the caller
    let the exception through."""
    with _graph_lock:
        return list(_violations)


def graph() -> dict[str, list[str]]:
    """Snapshot of the observed order graph (name -> successors)."""
    with _graph_lock:
        return {k: sorted(v) for k, v in _graph.items()}


if _config.env_flag("CLIENT_TPU_LOCKDEP", os.environ):
    enable()
