"""Client-side resilience primitives: retry, circuit breaking, deadlines.

Production inference clients (the reference's C++ client behind Envoy/gRPC
service configs) never surface a single stale socket or transient 503 to
the caller; they retry with exponential backoff + full jitter, stop
hammering a host that is clearly down (circuit breaker), and bound the
*total* time spent across attempts by an end-to-end deadline budget.

The port's copy of ``client_tpu/resilience/__init__.py``. These classes
are transport-agnostic. Both ``client_tpu_torch.http`` and
``client_tpu_torch.grpc`` accept them as opt-in constructor arguments
(``retry_policy=`` / ``circuit_breaker=``) and funnel every call through
:func:`run_with_resilience`. Classification rules (what is retryable)
follow the usual contract:

* connection-level failures (refused, reset, stale keep-alive, timeout)
  are retryable;
* HTTP 502/503 and gRPC UNAVAILABLE are retryable;
* every other 4xx (INVALID_ARGUMENT, NOT_FOUND, ...) is NEVER retried —
  the request itself is wrong and replaying it cannot help.
"""

from __future__ import annotations

import random
import socket
import time
from http.client import BadStatusLine

from client_tpu_torch.utils import InferenceServerException, lockdep

__all__ = [
    "RetryPolicy",
    "CircuitBreaker",
    "CircuitBreakerOpenError",
    "DeadlineExceededError",
    "retry_after_of",
    "run_with_resilience",
]

# Exceptions that indicate the connection (not the request) failed.
# BadStatusLine covers http.client.RemoteDisconnected (its subclass);
# ConnectionError covers reset/refused/aborted/broken-pipe.
CONNECTION_ERRORS = (ConnectionError, BadStatusLine, socket.timeout,
                     TimeoutError, socket.gaierror)

# HTTP statuses that signal transient server-side trouble.
RETRYABLE_HTTP_STATUSES = frozenset({502, 503})

# gRPC status codes (matched as substrings of the stringified code the
# clients store in InferenceServerException.status, e.g.
# "StatusCode.UNAVAILABLE").
RETRYABLE_GRPC_CODES = ("UNAVAILABLE",)


class DeadlineExceededError(InferenceServerException):
    """The end-to-end deadline budget ran out before a retry could run."""

    def __init__(self, msg, last_error=None):
        super().__init__(msg, status=504)
        self.last_error = last_error


class CircuitBreakerOpenError(InferenceServerException):
    """The per-host breaker is open: the call was rejected locally,
    without touching the network."""

    def __init__(self, host, cooldown_remaining_s):
        super().__init__(
            f"circuit breaker open for host '{host}' "
            f"(retry in {cooldown_remaining_s:.2f}s)", status=503)
        self.host = host
        self.cooldown_remaining_s = cooldown_remaining_s


def status_of(exc) -> int | str | None:
    """Best-effort status extraction across our error shapes:
    InferenceServerException.status() (int for HTTP, "StatusCode.X" str
    for gRPC) and EngineError.status (int attribute)."""
    status = getattr(exc, "status", None)
    if callable(status):
        status = status()
    return status


def retry_after_of(exc) -> float | None:
    """Server pushback attached to an error by the transports: the HTTP
    client parses a ``Retry-After`` header, the gRPC client the
    ``retry-after``/``retry-pushback-ms`` trailing metadata — both land
    on ``exc.retry_after_s``. None when the server sent no pushback."""
    value = getattr(exc, "retry_after_s", None)
    if value is None:
        return None
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    return value if value >= 0 else None


class RetryPolicy:
    """Retry schedule + retryable-status classification.

    ``max_attempts`` counts the first try: ``max_attempts=4`` means up to
    three retries. Backoff is capped exponential with full jitter
    (delay ~ U(0, min(max_backoff, initial * multiplier^n)), the AWS
    architecture-blog scheme) — jitter decorrelates a thundering herd of
    clients all retrying the same blip. Pass ``seed`` for deterministic
    backoff draws in tests.
    """

    def __init__(self, max_attempts=3, initial_backoff_s=0.05,
                 max_backoff_s=2.0, backoff_multiplier=2.0, jitter=True,
                 retryable_statuses=RETRYABLE_HTTP_STATUSES,
                 retryable_grpc_codes=RETRYABLE_GRPC_CODES, seed=None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.initial_backoff_s = float(initial_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.backoff_multiplier = float(backoff_multiplier)
        self.jitter = jitter
        self.retryable_statuses = frozenset(retryable_statuses)
        self.retryable_grpc_codes = tuple(retryable_grpc_codes)
        self._rng = random.Random(seed)
        self._rng_lock = lockdep.Lock("resilience.rng")

    def retryable(self, exc) -> bool:
        if isinstance(exc, CONNECTION_ERRORS):
            return True
        if retry_after_of(exc) is not None:
            # Explicit server pushback (429 + Retry-After / gRPC
            # retry-pushback): the server ASKED for a retry later —
            # retryable by definition, whatever the status code.
            return True
        status = status_of(exc)
        if status is None:
            # A wrapped connection failure (e.g. gRPC future timeout or an
            # InferenceServerException with no status from a dead socket)
            # is not classifiable; stay conservative and do not retry.
            return False
        if isinstance(status, int):
            return status in self.retryable_statuses
        text = str(status)
        if any(code in text for code in self.retryable_grpc_codes):
            return True
        return False

    def backoff_s(self, retry_index: int, remaining_s: float | None = None,
                  retry_after_s: float | None = None):
        """Delay before retry number ``retry_index`` (1-based). Never
        exceeds the remaining deadline budget when one is given.

        ``retry_after_s`` is server pushback (Retry-After / gRPC
        retry-pushback metadata): when present it REPLACES the jittered
        exponential draw — the server knows when capacity frees up;
        guessing earlier hammers it, guessing later wastes budget."""
        if retry_after_s is not None:
            delay = max(0.0, float(retry_after_s))
        else:
            cap = min(self.max_backoff_s,
                      self.initial_backoff_s
                      * self.backoff_multiplier ** max(0, retry_index - 1))
            if self.jitter:
                with self._rng_lock:
                    delay = self._rng.uniform(0.0, cap)
            else:
                delay = cap
        if remaining_s is not None:
            delay = min(delay, max(0.0, remaining_s))
        return delay


class CircuitBreaker:
    """Per-host three-state breaker: closed -> open after
    ``failure_threshold`` CONSECUTIVE failures -> half-open probe after
    ``cooldown_s`` -> closed on probe success (or back to open on probe
    failure). While open, calls fail locally with
    :class:`CircuitBreakerOpenError` instead of burning a network round
    trip on a host that is clearly down.

    One instance may be shared across clients; state is tracked per
    ``host`` key. ``open_seconds_total()`` reports cumulative time any
    host spent open.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    class _HostState:
        __slots__ = ("state", "consecutive_failures", "opened_at",
                     "probe_in_flight", "probe_started_at", "open_accum_s")

        def __init__(self):
            self.state = CircuitBreaker.CLOSED
            self.consecutive_failures = 0
            self.opened_at = 0.0
            self.probe_in_flight = False
            self.probe_started_at = 0.0
            self.open_accum_s = 0.0

    def __init__(self, failure_threshold=5, cooldown_s=5.0,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = lockdep.Lock("resilience.breaker")
        self._hosts: dict[str, CircuitBreaker._HostState] = {}

    def _host(self, host: str) -> "_HostState":
        st = self._hosts.get(host)
        if st is None:
            st = self._hosts.setdefault(host, self._HostState())
        return st

    def state(self, host: str = "") -> str:
        with self._lock:
            return self._host(host).state

    def _emit(self, name: str, host: str, trace_id: str | None,
              severity: str = "INFO", **detail) -> None:
        """Journal a state transition as a ``breaker.<name>`` event
        (outside the breaker lock: the journal has its own lock and runs
        its sinks)."""
        from client_tpu_torch.observability.events import journal

        journal().emit("breaker", name, severity=severity,
                       trace_id=trace_id, host=host, **detail)

    def check(self, host: str = "", trace_id: str | None = None) -> None:
        """Gate one call attempt; raises CircuitBreakerOpenError when the
        host is open (or half-open with the single probe already taken)."""
        probing = False
        with self._lock:
            st = self._host(host)
            if st.state == self.CLOSED:
                return
            now = self._clock()
            elapsed = now - st.opened_at
            if st.state == self.OPEN:
                if elapsed < self.cooldown_s:
                    raise CircuitBreakerOpenError(
                        host, self.cooldown_s - elapsed)
                st.state = self.HALF_OPEN
                st.probe_in_flight = False
                probing = True
            # HALF_OPEN: exactly one probe at a time; concurrent callers
            # are rejected until the probe resolves. A probe older than
            # cooldown_s is treated as abandoned (its attempt died without
            # reporting success OR failure) and a fresh probe is admitted,
            # so the breaker can never wedge permanently in HALF_OPEN.
            if st.probe_in_flight:
                probe_age = now - st.probe_started_at
                if probe_age < self.cooldown_s:
                    raise CircuitBreakerOpenError(
                        host, self.cooldown_s - probe_age)
            st.probe_in_flight = True
            st.probe_started_at = now
        if probing:
            self._emit("half_open", host, trace_id)

    def record_success(self, host: str = "",
                       trace_id: str | None = None) -> None:
        with self._lock:
            st = self._host(host)
            closed = st.state != self.CLOSED
            if closed:
                st.open_accum_s += self._clock() - st.opened_at
            st.state = self.CLOSED
            st.consecutive_failures = 0
            st.probe_in_flight = False
        if closed:
            self._emit("closed", host, trace_id)

    def record_failure(self, host: str = "",
                       trace_id: str | None = None) -> None:
        opened = None
        with self._lock:
            st = self._host(host)
            now = self._clock()
            if st.state == self.HALF_OPEN:
                # Failed probe: re-open for a fresh cooldown, folding the
                # half-open interval into the cumulative open time.
                st.open_accum_s += now - st.opened_at
                st.state = self.OPEN
                st.opened_at = now
                st.probe_in_flight = False
                opened = {"probe_failed": True}
            else:
                st.consecutive_failures += 1
                if (st.state == self.CLOSED
                        and st.consecutive_failures
                        >= self.failure_threshold):
                    st.state = self.OPEN
                    st.opened_at = now
                    opened = {"failures": st.consecutive_failures}
        if opened is not None:
            self._emit("open", host, trace_id, severity="ERROR",
                       cooldown_s=self.cooldown_s, **opened)

    def open_seconds_total(self) -> float:
        with self._lock:
            now = self._clock()
            total = 0.0
            for st in self._hosts.values():
                total += st.open_accum_s
                if st.state != self.CLOSED:
                    total += now - st.opened_at
            return total


def counts_as_server_fault(exc) -> bool:
    """Whether a failure should trip the breaker: connection-level errors
    and 5xx/UNAVAILABLE/INTERNAL do; 4xx (the caller's fault) must not —
    a flood of bad requests does not mean the host is down."""
    if isinstance(exc, CONNECTION_ERRORS):
        return True
    status = status_of(exc)
    if isinstance(status, int):
        return status >= 500
    if status is not None:
        text = str(status)
        return any(code in text for code in
                   ("UNAVAILABLE", "INTERNAL", "UNKNOWN",
                    "DEADLINE_EXCEEDED"))
    return False


def run_with_resilience(attempt, *, policy=None, breaker=None,
                        deadline_s=None, host="", on_retry=None,
                        on_breaker_reject=None, sleep=time.sleep,
                        clock=time.monotonic, trace_id=None):
    """Run ``attempt(remaining_s)`` under retry/breaker/deadline control.

    ``attempt`` receives the remaining deadline budget in seconds (None
    when no budget is set) so it can cap its own per-attempt socket/RPC
    timeout; it returns the result or raises. ``on_retry(n, exc, delay)``
    fires before each backoff sleep (clients record it in InferStat).

    The deadline budget bounds TOTAL time across attempts: no retry is
    started — and no backoff slept — past the budget; on exhaustion the
    last transport error is re-raised (or DeadlineExceededError if the
    budget expired before the first attempt could run).
    """
    start = clock()
    max_attempts = policy.max_attempts if policy is not None else 1
    attempt_no = 0
    while True:
        attempt_no += 1
        remaining = None
        if deadline_s is not None:
            remaining = deadline_s - (clock() - start)
            if remaining <= 0:
                raise DeadlineExceededError(
                    f"deadline budget of {deadline_s:.3f}s exhausted "
                    f"before attempt {attempt_no}")
        if breaker is not None:
            try:
                breaker.check(host, trace_id=trace_id)
            except CircuitBreakerOpenError:
                if on_breaker_reject is not None:
                    on_breaker_reject()
                raise
        try:
            result = attempt(remaining)
        except Exception as exc:  # noqa: BLE001 — classified below
            if breaker is not None:
                if counts_as_server_fault(exc):
                    breaker.record_failure(host, trace_id=trace_id)
                else:
                    # The host answered (4xx, RESOURCE_EXHAUSTED, a wrapped
                    # error with no status): the breaker must resolve any
                    # half-open probe as a SUCCESS — leaving it unresolved
                    # would reject every future call to this host forever.
                    breaker.record_success(host, trace_id=trace_id)
            if (policy is None or attempt_no >= max_attempts
                    or not policy.retryable(exc)):
                raise
            if deadline_s is not None:
                remaining = deadline_s - (clock() - start)
                if remaining <= 0:
                    raise
            delay = policy.backoff_s(attempt_no, remaining,
                                     retry_after_s=retry_after_of(exc))
            if on_retry is not None:
                on_retry(attempt_no, exc, delay)
            if delay > 0:
                sleep(delay)
            continue
        if breaker is not None:
            breaker.record_success(host, trace_id=trace_id)
        return result
