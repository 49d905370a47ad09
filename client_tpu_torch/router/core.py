"""Router core: replica handles, selection and load-aware forwarding.

The port's copy of ``client_tpu/router/core.py``: the same selection,
the same pushback aggregation, the same headers and spans, on the
standard library alone (no framework: the HTTP client imports this
module for its own multi-URL selection). A :class:`Replica` is a
keep-alive ``http.client`` connection pool plus the replica's last
:class:`~client_tpu_torch.protocol.loadreport.LoadReport`; a
:class:`Router` is the selection policy wrapped around per-replica
circuit breaking (:class:`client_tpu_torch.resilience.CircuitBreaker`,
keyed by replica id) and pushback aggregation.

Selection order for one request:

1. **Affinity**: a nonzero ``sequence_id`` rendezvous-hashes onto the
   eligible replicas (:func:`rendezvous_pick`), so a sequence keeps
   reaching the replica that holds its state, and losing a replica
   remaps only the sequences that lived on it.
2. **Power of two choices**: two eligible replicas drawn from the
   router's ``random.Random(seed)``; the one with the lower score (the
   router's own outstanding count plus the replica's piggybacked report)
   goes first.
3. **Failover**: the other eligible replicas by ascending score. A
   transport error trips the breaker and moves on; a 429/503 is the
   replica's pushback (it is alive and protecting itself), which resets
   the breaker rather than feeding it, and also moves on. Only when every
   candidate pushed back does the router shed, with the fleet's
   **minimum** ``Retry-After``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import queue
import random
import threading
import time
from http.client import BadStatusLine, HTTPConnection

from client_tpu_torch.config import env_int
from client_tpu_torch.observability.events import journal
from client_tpu_torch.observability.metrics import RouterMetrics
from client_tpu_torch.observability.tracing import (
    NamedSpan,
    SpanStore,
    TraceContext,
    new_span_id,
)
from client_tpu_torch.protocol.loadreport import (
    LOAD_HEADER,
    LoadReport,
    decode_header,
)
from client_tpu_torch.protocol.pushback import (
    RETRY_AFTER_HEADER,
    format_retry_after_s,
    parse_retry_after,
)
from client_tpu_torch.resilience import CircuitBreaker, CircuitBreakerOpenError
from client_tpu_torch.utils import lockdep

_log = logging.getLogger("client_tpu_torch")

# Connection died before any response bytes: safe to replay once on a
# fresh socket (same replay the HTTP client transport does).
_STALE_SOCKET_ERRORS = (BadStatusLine, ConnectionResetError,
                        BrokenPipeError, ConnectionAbortedError)

# Hop-by-hop headers (RFC 9110 §7.6.1) are never forwarded in either
# direction; Content-Length/Host are recomputed by the transport.
_HOP_HEADERS = frozenset((
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "te", "trailer", "transfer-encoding",
    "upgrade", "host", "content-length",
))

# Pushback interval attached to a shed when a replica answered 429/503
# without naming one (e.g. an injected fault) — small but nonzero so the
# aggregated minimum can never tell clients "retry immediately".
_DEFAULT_PUSHBACK_S = 0.05

# Router-side span ring capacity (one entry per routed request).
ENV_TRACE_BUFFER = "CLIENT_TPU_ROUTER_TRACE_BUFFER"
DEFAULT_TRACE_BUFFER = 512


def normalize_replica_url(url: str) -> str:
    """``http://host:port/`` -> ``host:port`` (the replica id)."""
    if "://" in url:
        url = url.split("://", 1)[1]
    return url.rstrip("/")


def replicas_from_hostlist(hosts, port: int = 8000) -> list[str]:
    """Replica ids for one engine process per host — the multihost wiring
    (every host of a ``parallel/multihost.py`` cluster runs the same
    server program, so replicas differ only in host)."""
    return [f"{h}:{port}" for h in hosts]


def rendezvous_pick(ids, token) -> str:
    """Highest-random-weight (rendezvous) hash: every client that knows
    the same id set picks the same replica for ``token``, and removing a
    replica only remaps the tokens that lived on it."""
    return max(ids, key=lambda i: hashlib.blake2b(
        f"{i}|{token}".encode(), digest_size=8).digest())


class ProxyResponse:
    """One upstream (or router-synthesized) response: status, a filtered
    header list, the body, and — for streaming proxying — an optional
    chunk iterator that replaces the body."""

    __slots__ = ("status", "headers", "body", "stream", "replica_id",
                 "trace_id")

    def __init__(self, status, headers, body, stream=None, replica_id=None,
                 trace_id=None):
        self.status = status
        self.headers = headers  # list[(name, value)]
        self.body = body
        self.stream = stream
        self.replica_id = replica_id
        self.trace_id = trace_id

    def header(self, name: str):
        lname = name.lower()
        for k, v in self.headers:
            if k.lower() == lname:
                return v
        return None


class Replica:
    """One engine replica: id, keep-alive pool, last load report, and the
    router-local outstanding count (the freshest load signal of all —
    it updates at request granularity, not report granularity)."""

    def __init__(self, url: str, *, pool_size: int = 32,
                 timeout_s: float = 120.0, pid: int | None = None):
        self.id = normalize_replica_url(url)
        host, _, port = self.id.partition(":")
        self.host = host
        self.port = int(port or 80)
        self.pid = pid
        self.timeout_s = timeout_s
        self.load = LoadReport(ts=0.0)
        self.load_age_ref = 0.0  # monotonic stamp of the last report
        self.outstanding = 0
        self.quiesced = False
        self._lock = lockdep.Lock("router.replica")
        self._pool: queue.LifoQueue = queue.LifoQueue()
        self._pool_size = pool_size

    # -- load/score ----------------------------------------------------------

    def observe_report(self, report: LoadReport | None) -> None:
        if report is None:
            return
        with self._lock:
            self.load = report
            self.load_age_ref = time.monotonic()

    def observe_headers(self, headers) -> None:
        """Refresh the load view from a response's piggyback header."""
        for k, v in headers:
            if k.lower() == LOAD_HEADER.lower():
                self.observe_report(decode_header(v))
                return

    def load_age_s(self) -> float:
        with self._lock:
            if self.load_age_ref == 0.0:
                return float("inf")
            return time.monotonic() - self.load_age_ref

    def score(self) -> float:
        """Routing cost, smaller is better: what the router itself has in
        flight to this replica plus the replica's self-reported load."""
        with self._lock:
            return self.outstanding + self.load.score()

    @property
    def draining(self) -> bool:
        return self.quiesced or self.load.draining

    # -- transport -----------------------------------------------------------

    def _acquire(self):
        try:
            return self._pool.get_nowait(), True
        except queue.Empty:
            return HTTPConnection(self.host, self.port,
                                  timeout=self.timeout_s), False

    def _release(self, conn, broken=False):
        if broken or self._pool.qsize() >= self._pool_size:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
            return
        self._pool.put(conn)

    def send(self, method: str, path: str, headers=None, body=None,
             timeout_s: float | None = None):
        """One proxied exchange -> (status, header_list, body_bytes).
        Pooled keep-alive sockets that die before any response byte are
        replayed once on a fresh connection. Raises OSError-family on an
        unreachable/dead replica."""
        hdrs = {k: v for k, v in (headers or {}).items()
                if k.lower() not in _HOP_HEADERS}
        for replay in (False, True):
            conn, reused = self._acquire()
            if timeout_s is not None:
                conn.timeout = timeout_s
                if conn.sock is not None:
                    conn.sock.settimeout(timeout_s)
            got_response = False
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                got_response = True
                data = resp.read()
            except Exception as exc:
                self._release(conn, broken=True)
                if (reused and not replay and not got_response
                        and isinstance(exc, _STALE_SOCKET_ERRORS)):
                    continue
                raise
            self._release(conn)
            return resp.status, resp.getheaders(), data

    def send_stream(self, method: str, path: str, headers=None, body=None,
                    timeout_s: float | None = None):
        """Streaming variant for SSE (`generate_stream`): returns
        (status, header_list, chunk_iterator). The connection stays out
        of the pool until the iterator is exhausted or closed."""
        hdrs = {k: v for k, v in (headers or {}).items()
                if k.lower() not in _HOP_HEADERS}
        conn, _ = self._acquire()
        if timeout_s is not None:
            conn.timeout = timeout_s
        try:
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
        except Exception:
            self._release(conn, broken=True)
            raise

        def chunks():
            try:
                while True:
                    piece = resp.read(16 * 1024)
                    if not piece:
                        break
                    yield piece
            finally:
                # A streamed connection's reuse safety depends on the
                # iterator having been fully drained; discard it.
                self._release(conn, broken=True)

        return resp.status, resp.getheaders(), chunks()

    def fetch_load(self, timeout_s: float = 5.0) -> LoadReport:
        """Pull ``GET /v2/load`` (bootstrap / background refresh)."""
        status, headers, data = self.send("GET", "/v2/load",
                                          timeout_s=timeout_s)
        if status != 200:
            raise OSError(f"/v2/load returned {status}")
        report = LoadReport.from_json_dict(json.loads(data))
        self.observe_report(report)
        return report

    def probe_ready(self, timeout_s: float = 5.0):
        """(ready, state) from ``GET /v2/health/ready`` — used by the
        rolling-drain coordinator's readiness gate."""
        status, headers, _ = self.send("GET", "/v2/health/ready",
                                       timeout_s=timeout_s)
        state = None
        for k, v in headers:
            if k.lower() == "x-health-state":
                state = v
        return status == 200, state

    def close(self) -> None:
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                return
            except Exception:  # noqa: BLE001
                pass


class Router:
    """Load-aware L7 selection + forwarding over N :class:`Replica`s.

    Thread-safe; one instance serves every handler thread of the
    standalone router server and can equally be embedded in-process.
    """

    def __init__(self, replicas, *, breaker: CircuitBreaker | None = None,
                 metrics: RouterMetrics | None = None,
                 affinity: bool = True, seed: int | None = None,
                 poll_interval_s: float = 2.0,
                 request_timeout_s: float = 120.0):
        self.replicas: list[Replica] = [
            r if isinstance(r, Replica)
            else Replica(r, timeout_s=request_timeout_s)
            for r in replicas]
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        # Breaker tuned for a fronting router: a dead replica should be
        # cut within a handful of requests and re-probed about once a
        # second, not the client default's five-failure/5s cadence.
        self.breaker = breaker or CircuitBreaker(failure_threshold=3,
                                                 cooldown_s=1.0)
        self.metrics = metrics or RouterMetrics()
        self.affinity = affinity
        self.request_timeout_s = request_timeout_s
        self.events = journal()
        try:
            trace_cap = env_int(ENV_TRACE_BUFFER)
        except ValueError:
            trace_cap = DEFAULT_TRACE_BUFFER
        self.spans = SpanStore(capacity=trace_cap)
        self._rng = random.Random(seed)
        self._poll_interval_s = poll_interval_s
        self._poll_thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Router":
        """Bootstrap load views and start the background refresh poller
        (piggyback keeps views fresh under traffic; the poller covers
        idle periods and newly recovered replicas)."""
        self.refresh()
        self._stop.clear()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="router-load-poll", daemon=True)
        self._poll_thread.start()
        self.events.emit("router", "start",
                         replicas=[r.id for r in self.replicas])
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2)
            self._poll_thread = None
        for r in self.replicas:
            r.close()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            self.refresh(max_age_s=self._poll_interval_s)

    def refresh(self, max_age_s: float = 0.0) -> None:
        """Pull ``/v2/load`` from replicas whose view is older than
        ``max_age_s``. Breaker-neutral: a failed poll must not consume
        the half-open probe that real traffic uses to close the breaker."""
        for r in self.replicas:
            if r.load_age_s() <= max_age_s:
                continue
            try:
                r.fetch_load()
            except Exception:  # noqa: BLE001 — poller is best-effort
                pass
        self._update_state_gauges()

    def _update_state_gauges(self) -> None:
        counts = {"READY": 0, "DEGRADED": 0, "DRAINING": 0, "DOWN": 0}
        for r in self.replicas:
            if self.breaker.state(r.id) == CircuitBreaker.OPEN:
                counts["DOWN"] += 1
            elif r.draining:
                counts["DRAINING"] += 1
            else:
                counts[r.load.state if r.load.state in counts
                       else "READY"] += 1
            self.metrics.breaker_open.set(
                1.0 if self.breaker.state(r.id) == CircuitBreaker.OPEN
                else 0.0, replica=r.id)
            age = r.load_age_s()
            self.metrics.load_report_age.set(
                0.0 if age == float("inf") else age, replica=r.id)
        for state, n in counts.items():
            self.metrics.replica_states.set(float(n), state=state)

    # -- replica control (rolling drain) ------------------------------------

    def replica(self, replica_id: str) -> Replica:
        for r in self.replicas:
            if r.id == replica_id:
                return r
        raise KeyError(f"unknown replica {replica_id!r}")

    def quiesce(self, replica_id: str) -> None:
        """Stop routing NEW requests to a replica (in-flight ones finish);
        step one of a rolling-drain walk."""
        self.replica(replica_id).quiesced = True
        self.events.emit("router", "quiesce", replica=replica_id)

    def unquiesce(self, replica_id: str) -> None:
        self.replica(replica_id).quiesced = False
        self.events.emit("router", "unquiesce", replica=replica_id)

    # -- selection -----------------------------------------------------------

    def eligible(self) -> list[Replica]:
        """Replicas the router will offer new work: not quiesced, not
        known-DRAINING, breaker not refusing (open breakers stay listed
        while half-open so the probe request can close them — the
        per-request ``check`` below arbitrates)."""
        return [r for r in self.replicas if not r.draining]

    def candidates(self, sequence_id: int = 0) -> list[Replica]:
        """Forwarding order for one request: affinity pin or P2C winner
        first, then the remaining eligible replicas by ascending score."""
        pool = self.eligible()
        if not pool:
            return []
        if len(pool) == 1:
            return pool
        rest = sorted(pool, key=lambda r: r.score())
        if self.affinity and sequence_id:
            by_id = {r.id: r for r in pool}
            primary = by_id[rendezvous_pick(sorted(by_id), sequence_id)]
        else:
            a, b = self._rng.sample(pool, 2)
            primary = a if a.score() <= b.score() else b
        rest.remove(primary)
        return [primary] + rest

    # -- forwarding ----------------------------------------------------------

    def forward(self, method: str, path: str, headers=None, body=None,
                sequence_id: int = 0, stream: bool = False,
                trace_ctx: TraceContext | None = None) -> ProxyResponse:
        """Route one request. Tries candidates in selection order;
        transport failures trip the per-replica breaker and fail over;
        pushback (429/503 + Retry-After, or a DRAINING 503) marks the
        replica and fails over breaker-neutrally. Sheds only when every
        candidate pushed back — with the fleet's minimum Retry-After —
        and answers 502 only when no replica was reachable at all.

        Every call records the router's own spans (select, one proxy
        span per attempt, the request root) into ``self.spans`` under
        the request's trace id — adopted from the caller's
        ``traceparent`` or generated here — and forwards a child
        context downstream so replica phase spans parent onto the
        attempt that carried them. The trace id is echoed on every
        response (success, shed, or 502) as ``X-Tpu-Trace-Id``."""
        t0 = time.monotonic()
        t0_ns = time.monotonic_ns()
        ctx = trace_ctx
        if ctx is None:
            tp = next((v for k, v in (headers or {}).items()
                       if k.lower() == "traceparent"), None)
            ctx = TraceContext.from_traceparent(tp)
        trace_id = ctx.trace_id
        # The downstream header set; traceparent is re-stamped per
        # attempt so each replica's spans hang off the attempt span.
        fwd_headers = {k: v for k, v in (headers or {}).items()
                       if k.lower() != "traceparent"}
        spans: list[NamedSpan] = []

        def finish(resp: ProxyResponse, outcome: str) -> ProxyResponse:
            spans.append(NamedSpan(
                "router:request", t0_ns, time.monotonic_ns(),
                span_id=ctx.span_id, parent_span_id=ctx.parent_span_id,
                args={"method": method, "path": path, "outcome": outcome,
                      "status": resp.status,
                      **({"replica": resp.replica_id}
                         if resp.replica_id else {}),
                      **({"sequence_id": sequence_id}
                         if sequence_id else {})}))
            self.spans.add(trace_id, spans)
            resp.headers.append(("X-Tpu-Trace-Id", trace_id))
            resp.trace_id = trace_id
            return resp

        cands = self.candidates(sequence_id)
        pinned = bool(self.affinity and sequence_id and len(cands) > 1)
        policy = ("none" if not cands else "single" if len(cands) == 1
                  else "affinity" if pinned else "p2c")
        spans.append(NamedSpan(
            "router:select", t0_ns, time.monotonic_ns(),
            span_id=new_span_id(), parent_span_id=ctx.span_id,
            args={"policy": policy,
                  "candidates": [r.id for r in cands]}))
        pushbacks: list[tuple[int, float]] = []
        last_5xx: ProxyResponse | None = None
        open_cooldowns: list[float] = []
        for attempt, replica in enumerate(cands, start=1):
            try:
                self.breaker.check(replica.id, trace_id)
            except CircuitBreakerOpenError as exc:
                open_cooldowns.append(exc.cooldown_remaining_s)
                now_ns = time.monotonic_ns()
                spans.append(NamedSpan(
                    "router:proxy", now_ns, now_ns,
                    span_id=new_span_id(), parent_span_id=ctx.span_id,
                    args={"replica": replica.id, "attempt": attempt,
                          "outcome": "breaker_open"}))
                continue
            attempt_ctx = ctx.child()
            fwd_headers["traceparent"] = attempt_ctx.to_traceparent()
            a0_ns = time.monotonic_ns()

            def attempt_span(outcome, status=None, *, replica=replica,
                             attempt=attempt, attempt_ctx=attempt_ctx,
                             a0_ns=a0_ns):
                args = {"replica": replica.id, "attempt": attempt,
                        "outcome": outcome}
                if status is not None:
                    args["status"] = status
                spans.append(NamedSpan(
                    "router:proxy", a0_ns, time.monotonic_ns(),
                    span_id=attempt_ctx.span_id,
                    parent_span_id=ctx.span_id, args=args))

            with replica._lock:
                replica.outstanding += 1
            try:
                if stream:
                    status, rhdrs, chunks = replica.send_stream(
                        method, path, fwd_headers, body,
                        self.request_timeout_s)
                    data = b""
                else:
                    status, rhdrs, data = replica.send(
                        method, path, fwd_headers, body,
                        self.request_timeout_s)
                    chunks = None
            except Exception as exc:  # noqa: BLE001 — transport failure
                with replica._lock:
                    replica.outstanding -= 1
                self.breaker.record_failure(replica.id, trace_id)
                self.metrics.requests.inc(replica=replica.id,
                                          outcome="unreachable")
                self.metrics.failovers.inc(replica=replica.id)
                attempt_span("unreachable")
                _log.debug("router: replica %s unreachable: %r",
                           replica.id, exc)
                continue
            if not stream:
                with replica._lock:
                    replica.outstanding -= 1
                replica.observe_headers(rhdrs)
            else:
                # Streamed responses decrement when the iterator closes.
                inner = chunks

                def finishing(inner=inner, replica=replica):
                    try:
                        yield from inner
                    finally:
                        with replica._lock:
                            replica.outstanding -= 1
                chunks = finishing()
            state_hdr = next((v for k, v in rhdrs
                              if k.lower() == "x-health-state"), None)
            retry_after = next(
                (parse_retry_after(v) for k, v in rhdrs
                 if k.lower() == RETRY_AFTER_HEADER.lower()), None)
            if status in (429, 503):
                # The replica answered: it is alive. Pushback resets the
                # breaker's consecutive-failure count rather than feeding
                # it — shedding load is the opposite of being down.
                self.breaker.record_success(replica.id, trace_id)
                if state_hdr == "DRAINING":
                    with replica._lock:
                        replica.load = LoadReport(
                            state="DRAINING",
                            inflight=replica.load.inflight)
                        replica.load_age_ref = time.monotonic()
                    self.events.emit("router", "replica_draining",
                                     replica=replica.id)
                pushbacks.append((status,
                                  retry_after if retry_after is not None
                                  else _DEFAULT_PUSHBACK_S))
                self.metrics.requests.inc(replica=replica.id,
                                          outcome="pushback")
                self.metrics.failovers.inc(replica=replica.id)
                attempt_span("pushback", status)
                if stream:
                    for _ in chunks:  # release the connection
                        pass
                continue
            if status >= 500:
                # A 5xx without pushback counts against the replica (the
                # same classification counts_as_server_fault applies
                # client-side) and the router retries elsewhere; the last
                # body is kept in case every replica says 500.
                self.breaker.record_failure(replica.id, trace_id)
                self.metrics.requests.inc(replica=replica.id,
                                          outcome="error")
                self.metrics.failovers.inc(replica=replica.id)
                attempt_span("error", status)
                last_5xx = ProxyResponse(status, self._resp_headers(
                    rhdrs, replica), data, replica_id=replica.id)
                if stream:
                    for _ in chunks:
                        pass
                continue
            self.breaker.record_success(replica.id, trace_id)
            self.metrics.requests.inc(replica=replica.id, outcome="ok")
            if pinned and replica is cands[0]:
                self.metrics.affinity_routed.inc(replica=replica.id)
            self.metrics.request_duration_us.observe(
                (time.monotonic() - t0) * 1e6, replica=replica.id)
            attempt_span("ok", status)
            return finish(ProxyResponse(
                status, self._resp_headers(rhdrs, replica), data,
                stream=chunks, replica_id=replica.id), "ok")
        resp = self._exhausted(pushbacks, last_5xx, open_cooldowns, cands)
        outcome = ("shed" if resp.header("X-Router-Shed")
                   else "error")
        if outcome == "shed":
            now_ns = time.monotonic_ns()
            spans.append(NamedSpan(
                "router:shed", now_ns, now_ns,
                span_id=new_span_id(), parent_span_id=ctx.span_id,
                args={"reason": resp.header("X-Router-Shed"),
                      "status": resp.status}))
        return finish(resp, outcome)

    @staticmethod
    def _resp_headers(rhdrs, replica) -> list:
        out = [(k, v) for k, v in rhdrs
               if k.lower() not in _HOP_HEADERS
               and k.lower() != "content-length"]
        out.append(("X-Tpu-Replica", replica.id))
        return out

    def _exhausted(self, pushbacks, last_5xx, open_cooldowns,
                   cands) -> ProxyResponse:
        if pushbacks:
            # EVERY reachable candidate pushed back: shed honestly, with
            # the minimum Retry-After — the soonest any replica said it
            # might accept work. 429 if any replica rate-limited; 503
            # when the whole fleet is draining/unavailable.
            status = 429 if any(s == 429 for s, _ in pushbacks) else 503
            retry_after = min(ra for _, ra in pushbacks)
            self.metrics.sheds.inc(reason="all_pushback")
            self.events.emit("router", "shed", severity="WARNING",
                             reason="all_pushback",
                             candidates=len(pushbacks),
                             retry_after_s=retry_after)
            body = json.dumps({"error": f"all {len(pushbacks)} replicas "
                               "pushed back"}).encode()
            return ProxyResponse(status, [
                (RETRY_AFTER_HEADER, format_retry_after_s(retry_after)),
                ("X-Router-Shed", "all_pushback"),
                ("Content-Type", "application/json")], body)
        if last_5xx is not None:
            return last_5xx
        if open_cooldowns:
            # Nothing eligible but breakers will re-probe soon: tell the
            # client when.
            retry_after = max(min(open_cooldowns), 0.01)
            self.metrics.sheds.inc(reason="no_replica")
            body = json.dumps({"error": "no reachable replica "
                               "(circuit breakers open)"}).encode()
            return ProxyResponse(503, [
                (RETRY_AFTER_HEADER, format_retry_after_s(retry_after)),
                ("X-Router-Shed", "no_replica"),
                ("Content-Type", "application/json")], body)
        self.metrics.sheds.inc(reason="no_replica")
        self.events.emit("router", "shed", severity="ERROR",
                         reason="no_replica", candidates=len(cands))
        body = json.dumps({"error": "no reachable replica"}).encode()
        return ProxyResponse(502, [("X-Router-Shed", "no_replica"),
                                   ("Content-Type", "application/json")],
                             body)

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """``GET /v2/router/status`` / fleet half of ``GET /v2/load``."""
        self._update_state_gauges()
        out = {}
        for r in self.replicas:
            age = r.load_age_s()
            out[r.id] = {
                "load": r.load.to_json_dict(),
                "load_age_s": (None if age == float("inf")
                               else round(age, 3)),
                "outstanding": r.outstanding,
                "quiesced": r.quiesced,
                "breaker": self.breaker.state(r.id),
                "pid": r.pid,
            }
        return {
            "replicas": out,
            "affinity": self.affinity,
            "eligible": [r.id for r in self.eligible()],
        }
