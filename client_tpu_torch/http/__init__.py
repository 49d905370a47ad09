"""Python HTTP/REST client library.

The port's copy of ``client_tpu/http/__init__.py``, with the API of
``tritonclient.http``: ``InferenceServerClient`` with health, metadata,
config, statistics, repository control and the shared-memory control
plane; ``InferInput`` / ``InferRequestedOutput`` / ``InferResult``; sync
``infer`` and pool-based ``async_infer``. The transport is stdlib
``http.client`` over a connection pool and a thread pool. A list of URLs
makes one client balance over several servers (power of two choices, a
circuit breaker per target, failover). Opt-in resilience
(``retry_policy=``, ``circuit_breaker=``) comes from
``client_tpu_torch.resilience``.

The operational GETs: ``get_events``, ``get_slo_status``,
``get_profile``, ``get_timeseries``, ``get_memory``, ``get_costs``,
``get_qos_status`` and ``get_bundles`` (with ``capture_bundle``). The
shm slot ring (``register_shm_ring``, ``ring_doorbell``, ...; the
producer side is ``RingProducer``, re-exported here) and staged datasets
(``register_staged_dataset``, ...). Not ported yet: trace settings and
the fleet GETs, whose routes the port's server does not have. This module
loads neither torch nor jax.
"""

from __future__ import annotations

import base64
import gzip
import json
import queue
import random
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from http.client import BadStatusLine, HTTPConnection
from urllib.parse import quote, urlencode

import numpy as np

from client_tpu_torch.observability.client_stats import InferStat
from client_tpu_torch.observability.tracing import (
    TraceContext,
    parse_server_timing,
)
from client_tpu_torch.protocol import rest
from client_tpu_torch.protocol.codec import b64_encode_handle, serialize_tensor
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.protocol.loadreport import LOAD_HEADER, decode_header
from client_tpu_torch.protocol.pushback import (
    RETRY_AFTER_HEADER,
    parse_retry_after,
)
from client_tpu_torch.resilience import (
    CircuitBreaker,
    CircuitBreakerOpenError,
    run_with_resilience,
)
from client_tpu_torch.router.core import rendezvous_pick
from client_tpu_torch.utils import (
    InferenceServerException,
    raise_error,
)
from client_tpu_torch.utils import lockdep
from client_tpu_torch.utils.shm_ring import RingProducer  # noqa: F401


class InferInput:
    """An input tensor for an inference request: binary or JSON data, or
    a shared-memory region."""

    def __init__(self, name, shape, datatype):
        self._name = name
        self._shape = list(shape)
        self._datatype = datatype
        self._parameters = {}
        self._data = None          # JSON-inline list
        self._raw_data = None      # binary payload bytes

    def name(self):
        return self._name

    def datatype(self):
        return self._datatype

    def shape(self):
        return self._shape

    def set_shape(self, shape):
        self._shape = list(shape)
        return self

    def set_data_from_numpy(self, input_tensor, binary_data=True):
        if not isinstance(input_tensor, np.ndarray):
            raise_error("input_tensor must be a numpy array")
        dtype = np_to_wire_dtype(input_tensor.dtype)
        if self._datatype != dtype and not (
                self._datatype == "BYTES" and dtype in ("BYTES", None)):
            raise_error(
                f"got unexpected datatype {dtype} from numpy array, expected "
                f"{self._datatype}")
        valid_shape = list(input_tensor.shape) == self._shape
        if not valid_shape:
            raise_error(
                f"got unexpected numpy array shape [{list(input_tensor.shape)}]"
                f", expected [{self._shape}]")
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        if binary_data:
            self._data = None
            self._raw_data = serialize_tensor(input_tensor, self._datatype)
            self._parameters["binary_data_size"] = len(self._raw_data)
        else:
            self._raw_data = None
            self._parameters.pop("binary_data_size", None)
            if self._datatype == "BYTES":
                flat = np.ravel(input_tensor, order="C")
                self._data = [
                    x.decode("utf-8") if isinstance(x, (bytes, np.bytes_))
                    else str(x)
                    for x in flat
                ]
            else:
                self._data = np.ravel(input_tensor, order="C").tolist()
        return self

    def set_shared_memory(self, region_name, byte_size, offset=0):
        self._data = None
        self._raw_data = None
        self._parameters.pop("binary_data_size", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset:
            self._parameters["shared_memory_offset"] = offset
        return self

    def _get_tensor(self):
        entry = {
            "name": self._name,
            "shape": self._shape,
            "datatype": self._datatype,
        }
        if self._parameters:
            entry["parameters"] = dict(self._parameters)
        if self._data is not None:
            entry["data"] = self._data
        return entry


class InferRequestedOutput:
    """A requested output: classification count, binary flag, shm
    placement."""

    def __init__(self, name, binary_data=True, class_count=0):
        self._name = name
        self._parameters = {}
        if binary_data:
            self._parameters["binary_data"] = True
        if class_count:
            self._parameters["classification"] = class_count

    def name(self):
        return self._name

    def set_shared_memory(self, region_name, byte_size, offset=0):
        self._parameters.pop("binary_data", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset:
            self._parameters["shared_memory_offset"] = offset
        return self

    def unset_shared_memory(self):
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        return self

    def _get_tensor(self):
        entry = {"name": self._name}
        if self._parameters:
            entry["parameters"] = dict(self._parameters)
        return entry


class InferResult:
    """Parsed inference response: JSON head + binary tails mapped by offset
    (the v2 binary-tensor extension)."""

    def __init__(self, response_body: bytes, header_length: int | None,
                 verbose: bool = False):
        self._head, tail = rest.split_body(response_body, header_length)
        if "error" in self._head:
            raise InferenceServerException(self._head["error"])
        self._tensors = {
            t.name: t
            for t in rest.parse_tensors(self._head.get("outputs", []), tail)
        }
        # Populated by the client transport from the response headers
        # (traceparent round-trip + Server-Timing phase breakdown).
        self._trace_id = None
        self._server_timing: dict = {}

    @classmethod
    def from_response_body(cls, response_body, verbose=False,
                           header_length=None, content_encoding=None):
        if content_encoding == "gzip":
            response_body = gzip.decompress(response_body)
        elif content_encoding == "deflate":
            response_body = zlib.decompress(response_body)
        return cls(response_body, header_length, verbose)

    def as_numpy(self, name):
        t = self._tensors.get(name)
        if t is None:
            return None
        if "shared_memory_region" in t.parameters:
            return None  # caller reads from its own region
        return t.to_numpy()

    def get_output(self, name):
        t = self._tensors.get(name)
        if t is None:
            return None
        entry = {"name": t.name, "datatype": t.datatype, "shape": t.shape}
        if t.parameters:
            entry["parameters"] = t.parameters
        if t.data is not None:
            entry["data"] = t.data
        return entry

    def get_response(self):
        return self._head

    def trace_id(self):
        """The W3C trace id this request ran under (32 hex chars), echoed
        by the server; correlate against ``GET /v2/trace/requests``."""
        return self._trace_id

    def server_timing(self):
        """Server-side phase durations in microseconds
        ({queue, compute_input, compute_infer, compute_output}), parsed
        from the Server-Timing response header; empty if absent."""
        return dict(self._server_timing)


class InferAsyncRequest:
    def __init__(self, future, verbose=False):
        self._future = future

    def get_result(self, block=True, timeout=None):
        if not block:
            if not self._future.done():
                raise InferenceServerException("result not ready")
        try:
            return self._future.result(timeout=timeout)
        except InferenceServerException:
            raise
        except Exception as exc:  # noqa: BLE001
            raise InferenceServerException(str(exc)) from exc


# Connection died before any response bytes: safe to replay regardless of
# method, since the server cannot have begun processing a request it never
# acknowledged. BadStatusLine covers http.client.RemoteDisconnected.
_STALE_SOCKET_ERRORS = (BadStatusLine, ConnectionResetError,
                        BrokenPipeError, ConnectionAbortedError)


def _parse_retry_after(resp) -> float | None:
    """Server pushback from a Retry-After header (seconds form only —
    this ecosystem's servers send fractional seconds; HTTP-date is not
    used here). None when absent or unparsable. Parsing is shared with
    the gRPC metadata path (``protocol/pushback.py``) so both
    transports agree on sub-second handling."""
    if resp is None:
        return None
    return parse_retry_after(resp.getheader(RETRY_AFTER_HEADER))


class _RetryableStatus(Exception):
    """Internal: a response with a retryable HTTP status (502/503, or an
    admission-shed 429 carrying Retry-After pushback), re-raised through
    the resilience loop; carries the response so retry exhaustion degrades
    to returning it (original _request contract). ``retry_after_s`` feeds
    RetryPolicy.backoff_s so the client waits exactly as long as the
    server asked."""

    def __init__(self, resp, data):
        super().__init__(f"HTTP {resp.status}")
        self.resp = resp
        self.data = data
        self.status = resp.status
        self.retry_after_s = _parse_retry_after(resp)


class _Target:
    """One server endpoint of a multi-URL client: its connection pool,
    its last piggybacked load report, and the client-local outstanding
    count. Single-URL clients never build these (zero overhead on the
    common path)."""

    def __init__(self, url, concurrency, timeout):
        if "://" in url:
            url = url.split("://", 1)[1]
        host, _, port = url.rstrip("/").partition(":")
        self.host = host
        self.port = int(port or 80)
        self.id = f"{self.host}:{self.port}"
        self.pool = _ConnectionPool(self.host, self.port, concurrency,
                                    timeout)
        self.load = None
        self.outstanding = 0
        self._lock = lockdep.Lock("httpclient.endpoint")

    def observe(self, resp) -> None:
        """Learn the endpoint's load from a response's X-Tpu-Load
        piggyback header — the zero-extra-RPC load view."""
        report = decode_header(resp.getheader(LOAD_HEADER))
        if report is not None:
            with self._lock:
                self.load = report

    def score(self) -> float:
        with self._lock:
            return self.outstanding + (self.load.score() if self.load
                                       else 0.0)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self.load is not None and self.load.draining


class _ConnectionPool:
    """LIFO keep-alive pool with symmetric accounting.

    ``live`` counts connections in existence (pooled + checked out): +1
    exactly once when a connection is constructed, -1 exactly once when it
    is destroyed (``_discard``, guarded against double-close so an errant
    double release can never drift the counter negative).
    """

    def __init__(self, host, port, size, timeout):
        self._host, self._port, self._timeout = host, port, timeout
        self._pool: queue.LifoQueue = queue.LifoQueue()
        self._lock = lockdep.Lock("httpclient.pool")
        self._created = 0
        self._size = size

    @property
    def live(self) -> int:
        with self._lock:
            return self._created

    def acquire(self) -> tuple[HTTPConnection, bool]:
        """Returns (conn, reused): reused connections came out of the pool
        and may be stale keep-alive sockets — the transport replays once on
        a fresh connection if one dies before response bytes arrive."""
        try:
            return self._pool.get_nowait(), True
        except queue.Empty:
            pass
        conn = HTTPConnection(self._host, self._port, timeout=self._timeout)
        # Count only after successful construction, so a failing
        # constructor cannot leak a phantom entry.
        with self._lock:
            self._created += 1
        return conn, False

    def _discard(self, conn: HTTPConnection) -> None:
        if getattr(conn, "_pool_discarded", False):
            return
        conn._pool_discarded = True
        try:
            conn.close()
        finally:
            with self._lock:
                self._created -= 1

    def release(self, conn: HTTPConnection, broken=False):
        if broken or self._pool.qsize() >= self._size:
            # enforce the pool bound: excess/broken connections are closed
            self._discard(conn)
            return
        self._pool.put(conn)

    def close(self):
        while True:
            try:
                self._discard(self._pool.get_nowait())
            except queue.Empty:
                return


class InferenceServerClient:
    """HTTP client for the v2 protocol (control plane + inference)."""

    def __init__(self, url, verbose=False, concurrency=1,
                 connection_timeout=60.0, network_timeout=60.0,
                 max_greenlets=None, ssl=False, ssl_options=None,
                 ssl_context_factory=None, insecure=False,
                 retry_policy=None, circuit_breaker=None):
        if ssl:
            raise InferenceServerException(
                "ssl is not supported by this transport yet")
        # Router-aware URL handling: a list (or comma-separated string) of
        # URLs makes the client balance across N replicas itself — P2C on
        # load score learned from X-Tpu-Load piggyback headers, per-target
        # circuit breaking, and transparent failover. A single URL (which
        # may be a standalone router frontend) keeps the
        # original single-pool transport untouched.
        urls = ([u.strip() for u in url.split(",") if u.strip()]
                if isinstance(url, str) else [str(u) for u in url])
        if not urls:
            raise InferenceServerException("no server url given")
        timeout = max(connection_timeout, network_timeout)
        self._targets = [_Target(u, concurrency, timeout) for u in urls]
        self._host = self._targets[0].host
        self._port = self._targets[0].port
        self._verbose = verbose
        self._pool = self._targets[0].pool
        self._rng = random.Random()
        self._executor = ThreadPoolExecutor(max_workers=max(concurrency, 1))
        self._stats = InferStat()
        # Opt-in resilience (client_tpu_torch.resilience): when a RetryPolicy is
        # set, `network_timeout` becomes the end-to-end deadline budget —
        # it bounds the TOTAL wall time across all attempts and backoffs,
        # and each attempt's socket timeout shrinks to what remains.
        self._retry_policy = retry_policy
        self._breaker = circuit_breaker
        if len(self._targets) > 1 and self._breaker is None:
            # Multi-URL mode implies per-target circuit breaking: failover
            # without breaker memory would re-probe a dead replica on
            # every request.
            self._breaker = CircuitBreaker()
        self._breaker_host = f"{self._host}:{self._port}"
        self._network_timeout = network_timeout

    def get_infer_stat(self):
        """Cumulative client-side inference statistics (round-trip time
        plus the server-reported phase breakdown) — the InferStat
        equivalent of tritonclient's."""
        return self._stats.get()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._executor.shutdown(wait=False)
        for target in self._targets:
            target.pool.close()

    # -- low-level ----------------------------------------------------------

    def _request(self, method, path, body=None, headers=None,
                 query_params=None):
        headers = dict(headers or {})
        if query_params:
            path = path + "?" + urlencode(query_params)
        multi = len(self._targets) > 1
        send = self._request_multi if multi else self._request_once
        # Multi-target clients do per-target breaking inside the failover
        # loop; the resilience wrapper only adds value when a RetryPolicy
        # asks for cross-sweep retries.
        if self._retry_policy is None and (multi or self._breaker is None):
            return send(method, path, body, headers, None)
        # Correlate breaker transitions this request causes with its
        # distributed trace: infer() stamps a W3C traceparent header
        # (version-traceid-spanid-flags) before reaching here.
        trace_id = None
        tp = headers.get("traceparent")
        if tp:
            parts = tp.split("-")
            if len(parts) == 4:
                trace_id = parts[1]

        def attempt(remaining_s):
            resp, data = send(method, path, body, headers, remaining_s)
            retryable = (self._retry_policy is not None
                         and (resp.status
                              in self._retry_policy.retryable_statuses
                              or (resp.status in (429, 503)
                                  and _parse_retry_after(resp)
                                  is not None)))
            # A breaker-only client still needs 5xx surfaced as failures so
            # consecutive server faults trip it (4xx stays a plain return:
            # the caller's fault, not the host's). Multi-target mode
            # already recorded per-target outcomes inside the sweep.
            trips_breaker = (not multi and self._breaker is not None
                             and resp.status >= 500)
            if retryable or trips_breaker:
                # Surface retryable statuses as failures so the resilience
                # loop replays them; _RetryableStatus keeps (resp, data) so
                # exhaustion falls back to the plain return-the-response
                # contract every call site already handles.
                raise _RetryableStatus(resp, data)
            return resp, data

        try:
            return run_with_resilience(
                attempt,
                policy=self._retry_policy,
                breaker=None if multi else self._breaker,
                deadline_s=(self._network_timeout
                            if self._retry_policy is not None else None),
                host=self._breaker_host,
                on_retry=lambda n, exc, delay: self._stats.record_retry(),
                on_breaker_reject=self._stats.record_breaker_rejection,
                trace_id=trace_id)
        except _RetryableStatus as exc:
            return exc.resp, exc.data

    # -- multi-target (router-aware) transport -------------------------------

    def _order_targets(self, headers):
        """Sweep order: known-DRAINING targets last-resort only; affinity
        pin for an X-Sequence-Id header, else power-of-two-choices on load
        score; remaining targets by ascending score (failover order)."""
        pool = [t for t in self._targets if not t.draining]
        if not pool:
            pool = list(self._targets)
        if len(pool) == 1:
            return pool
        rest = sorted(pool, key=lambda t: t.score())
        seq = headers.get("X-Sequence-Id")
        if seq:
            by_id = {t.id: t for t in pool}
            primary = by_id[rendezvous_pick(sorted(by_id), seq)]
        else:
            a, b = self._rng.sample(pool, 2)
            primary = a if a.score() <= b.score() else b
        rest.remove(primary)
        return [primary] + rest

    def _request_multi(self, method, path, body, headers, remaining_s):
        """One sweep across the targets with the router's classification:
        transport failure trips that target's breaker and fails over;
        pushback (429/503 + Retry-After) is breaker-neutral-positive and
        fails over; a 5xx counts against the target and fails over. The
        sweep returns a pushback response only when EVERY reachable
        target pushed back (honest aggregation, client edition)."""
        last_exc = None
        pushback = None
        last_5xx = None
        for target in self._order_targets(headers):
            if self._breaker is not None:
                try:
                    self._breaker.check(target.id, None)
                except CircuitBreakerOpenError as exc:
                    self._stats.record_breaker_rejection()
                    last_exc = exc
                    continue
            with target._lock:
                target.outstanding += 1
            try:
                resp, data = self._request_on(target.pool, method, path,
                                              body, headers, remaining_s)
            except Exception as exc:  # noqa: BLE001 — transport failure
                if self._breaker is not None:
                    self._breaker.record_failure(target.id, None)
                last_exc = exc
                continue
            finally:
                with target._lock:
                    target.outstanding -= 1
            target.observe(resp)
            if (resp.status in (429, 503)
                    and _parse_retry_after(resp) is not None):
                # Alive and shedding — the opposite of down.
                if self._breaker is not None:
                    self._breaker.record_success(target.id, None)
                pushback = (resp, data)
                continue
            if resp.status >= 500:
                if self._breaker is not None:
                    self._breaker.record_failure(target.id, None)
                last_5xx = (resp, data)
                continue
            if self._breaker is not None:
                self._breaker.record_success(target.id, None)
            return resp, data
        if pushback is not None:
            return pushback
        if last_5xx is not None:
            return last_5xx
        raise last_exc if last_exc is not None else InferenceServerException(
            "no reachable server")

    def _request_once(self, method, path, body, headers, remaining_s):
        return self._request_on(self._pool, method, path, body, headers,
                                remaining_s)

    def _request_on(self, pool, method, path, body, headers, remaining_s):
        """One wire attempt, with the urllib3-style stale-socket replay: a
        pooled keep-alive connection that dies before ANY response bytes
        are read is discarded and the request replayed exactly once on a
        fresh connection (server-side idle timeouts routinely race the
        client's next use; independent of RetryPolicy)."""
        deadline = (time.monotonic() + remaining_s
                    if remaining_s is not None else None)
        for replay in (False, True):
            conn, reused = pool.acquire()
            if deadline is not None:
                # Per-attempt socket timeout shrinks to the remaining
                # deadline budget so one attempt cannot overrun the total.
                # Recomputed per iteration: the replay must not reuse the
                # pre-attempt budget, or it would overrun by whatever the
                # stale first attempt consumed. Floor at 1ms — settimeout(0)
                # would flip the socket into non-blocking mode.
                attempt_remaining = max(deadline - time.monotonic(), 0.001)
                conn.timeout = attempt_remaining
                if conn.sock is not None:
                    conn.sock.settimeout(attempt_remaining)
            got_response = False
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                got_response = True
                data = resp.read()
                pool.release(conn)
            except Exception as exc:
                pool.release(conn, broken=True)
                if (reused and not replay and not got_response
                        and isinstance(exc, _STALE_SOCKET_ERRORS)
                        and (deadline is None
                             or deadline - time.monotonic() > 0)):
                    self._stats.record_stale_socket_retry()
                    continue
                raise
            if self._verbose:
                print(f"{method} {path}, status {resp.status}")
            return resp, data

    def _get_json(self, path, query_params=None, headers=None):
        resp, data = self._request("GET", path, headers=headers,
                                   query_params=query_params)
        self._raise_if_error(resp, data)
        return json.loads(data) if data else {}

    def _post_json(self, path, obj=None, query_params=None, headers=None):
        body = json.dumps(obj).encode() if obj is not None else b""
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        resp, data = self._request(
            "POST", path, body=body, headers=hdrs,
            query_params=query_params)
        self._raise_if_error(resp, data)
        return json.loads(data) if data else {}

    @staticmethod
    def _raise_if_error(resp, data):
        if resp.status >= 400:
            msg = ""
            try:
                msg = json.loads(data).get("error", "")
            except Exception:  # noqa: BLE001
                msg = data.decode("utf-8", errors="replace")
            exc = InferenceServerException(msg or f"HTTP {resp.status}",
                                           status=resp.status)
            # Surface server pushback (admission sheds, drain) so callers
            # and resilience.retry_after_of can honor it.
            retry_after = _parse_retry_after(resp)
            if retry_after is not None:
                exc.retry_after_s = retry_after
            raise exc

    # -- health / metadata ---------------------------------------------------

    def is_server_live(self, headers=None, query_params=None):
        resp, _ = self._request("GET", "/v2/health/live",
                                query_params=query_params)
        return resp.status == 200

    def is_server_ready(self, headers=None, query_params=None):
        resp, _ = self._request("GET", "/v2/health/ready",
                                query_params=query_params)
        return resp.status == 200

    def is_model_ready(self, model_name, model_version="", headers=None,
                       query_params=None):
        path = f"/v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"
        resp, _ = self._request("GET", path + "/ready",
                                query_params=query_params)
        return resp.status == 200

    def get_server_metadata(self, headers=None, query_params=None):
        return self._get_json("/v2", query_params, headers)

    def get_model_metadata(self, model_name, model_version="", headers=None,
                           query_params=None):
        path = f"/v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"
        return self._get_json(path, query_params, headers)

    def get_model_config(self, model_name, model_version="", headers=None,
                         query_params=None):
        path = f"/v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"
        return self._get_json(path + "/config", query_params, headers)

    def get_model_repository_index(self, headers=None, query_params=None):
        return self._post_json("/v2/repository/index", {}, query_params, headers)

    def load_model(self, model_name, headers=None, query_params=None,
                   config=None, files=None):
        body = {}
        params = {}
        if config is not None:
            params["config"] = config
        for path, content in (files or {}).items():
            params[path] = base64.b64encode(content).decode("ascii")
        if params:
            body["parameters"] = params
        self._post_json(f"/v2/repository/models/{quote(model_name)}/load",
                        body, query_params, headers)

    def unload_model(self, model_name, headers=None, query_params=None,
                     unload_dependents=False):
        body = {}
        if unload_dependents:
            body["parameters"] = {"unload_dependents": True}
        self._post_json(f"/v2/repository/models/{quote(model_name)}/unload",
                        body, query_params, headers)

    def get_inference_statistics(self, model_name="", model_version="",
                                 headers=None, query_params=None):
        if model_name:
            path = f"/v2/models/{quote(model_name)}"
            if model_version:
                path += f"/versions/{model_version}"
            path += "/stats"
        else:
            path = "/v2/models/stats"
        return self._get_json(path, query_params, headers)

    # -- shared memory control ----------------------------------------------

    def get_system_shared_memory_status(self, region_name="", headers=None,
                                        query_params=None):
        path = "/v2/systemsharedmemory"
        if region_name:
            path += f"/region/{quote(region_name)}"
        return self._get_json(path + "/status", query_params, headers)

    def register_system_shared_memory(self, name, key, byte_size, offset=0,
                                      headers=None, query_params=None):
        self._post_json(
            f"/v2/systemsharedmemory/region/{quote(name)}/register",
            {"key": key, "offset": offset, "byte_size": byte_size},
            query_params, headers)

    def unregister_system_shared_memory(self, name="", headers=None,
                                        query_params=None):
        path = "/v2/systemsharedmemory"
        if name:
            path += f"/region/{quote(name)}"
        self._post_json(path + "/unregister", {}, query_params, headers)

    def get_tpu_shared_memory_status(self, region_name="", headers=None,
                                     query_params=None):
        path = "/v2/tpusharedmemory"
        if region_name:
            path += f"/region/{quote(region_name)}"
        return self._get_json(path + "/status", query_params, headers)

    def register_tpu_shared_memory(self, name, raw_handle, device_id,
                                   byte_size, headers=None,
                                   query_params=None):
        """Register a device region by serialized buffer handle (the
        port's server reads the handle as a host-staged region).
        ``raw_handle`` may be the raw bytes from
        ``cuda_shared_memory.get_raw_handle`` or an already-base64
        string."""
        if isinstance(raw_handle, (bytes, bytearray)):
            raw_handle = b64_encode_handle(bytes(raw_handle))
        self._post_json(
            f"/v2/tpusharedmemory/region/{quote(name)}/register",
            {"raw_handle": {"b64": raw_handle}, "device_id": device_id,
             "byte_size": byte_size},
            query_params, headers)

    def unregister_tpu_shared_memory(self, name="", headers=None,
                                     query_params=None):
        path = "/v2/tpusharedmemory"
        if name:
            path += f"/region/{quote(name)}"
        self._post_json(path + "/unregister", {}, query_params, headers)

    # CUDA-named aliases, for drop-in use by tritonclient callers:
    get_cuda_shared_memory_status = get_tpu_shared_memory_status
    register_cuda_shared_memory = register_tpu_shared_memory
    unregister_cuda_shared_memory = unregister_tpu_shared_memory

    # -- shm slot ring (zero-copy data plane) -------------------------------

    def register_shm_ring(self, name, key, spec=None, headers=None,
                          query_params=None):
        """Attach a slot-ring segment (made with
        ``client_tpu_torch.utils.shm_ring``) by POSIX shm key; the
        geometry is read from the ring's header. A ``spec`` (a doorbell's
        span spec without start/count) makes a reaped ring: the engine's
        reaper sweeps FILLED slots, and no doorbell is rung."""
        body = {"key": key}
        if spec is not None:
            body["spec"] = spec
        self._post_json(f"/v2/shm/ring/{quote(name)}/register",
                        body, query_params, headers)

    def unregister_shm_ring(self, name="", headers=None, query_params=None):
        path = "/v2/shm/ring"
        if name:
            path += f"/{quote(name)}"
        self._post_json(path + "/unregister", {}, query_params, headers)

    def get_shm_ring_status(self, name="", headers=None, query_params=None):
        path = "/v2/shm/ring"
        if name:
            path += f"/{quote(name)}"
        return self._get_json(path + "/status", query_params, headers)

    def ring_doorbell(self, name, spec, headers=None, query_params=None):
        """Submit a span of FILLED slots in one round trip (``spec`` as
        ``RingProducer.doorbell`` builds it); returns ``{"admitted",
        "rejected", "skipped"}``. The answers are read from the slots."""
        return self._post_json(f"/v2/shm/ring/{quote(name)}/doorbell",
                               spec, query_params, headers)

    # -- staged datasets (many-producer fan-in) -----------------------------

    def register_staged_dataset(self, name, key, headers=None,
                                query_params=None):
        """Attach a staged-dataset segment (built with
        ``client_tpu_torch.utils.shm_ring.staged``) by POSIX shm key; the
        server reads and checks its manifest."""
        self._post_json(f"/v2/shm/dataset/{quote(name)}/register",
                        {"key": key}, query_params, headers)

    def unregister_staged_dataset(self, name="", headers=None,
                                  query_params=None):
        path = "/v2/shm/dataset"
        if name:
            path += f"/{quote(name)}"
        self._post_json(path + "/unregister", {}, query_params, headers)

    def get_staged_dataset_status(self, name="", headers=None,
                                  query_params=None):
        path = "/v2/shm/dataset"
        if name:
            path += f"/{quote(name)}"
        return self._get_json(path + "/status", query_params, headers)

    # -- inference -----------------------------------------------------------

    # -- operational control plane -------------------------------------------

    def get_events(self, model_name="", severity="", category="",
                   since_seq=None, since_wall=None, until_wall=None,
                   limit=None, headers=None, query_params=None):
        """Server operational event timeline (``GET /v2/events``):
        breaker/admission/drain/model/fault/deadline transitions with
        trace correlation. ``severity`` is a minimum (e.g. ``WARNING``);
        ``since_seq`` the exclusive cursor from the previous response's
        ``next_seq``; ``since_wall``/``until_wall`` an epoch-seconds
        window (exclusive lower, inclusive upper)."""
        qp = dict(query_params or {})
        if model_name:
            qp["model"] = model_name
        if severity:
            qp["severity"] = severity
        if category:
            qp["category"] = category
        if since_seq is not None:
            qp["since"] = int(since_seq)
        if since_wall is not None:
            qp["since_wall"] = float(since_wall)
        if until_wall is not None:
            qp["until_wall"] = float(until_wall)
        if limit is not None:
            qp["limit"] = int(limit)
        return self._get_json("/v2/events", qp or None, headers)

    def get_slo_status(self, headers=None, query_params=None):
        """Per-model SLO burn-rate report (``GET /v2/slo``)."""
        return self._get_json("/v2/slo", query_params, headers)

    def get_profile(self, model_name="", headers=None, query_params=None):
        """Efficiency profiler cost table (``GET /v2/profile``): per-model
        per-bucket fill ratios, padding-waste device-seconds, compile
        counts, device duty cycle, and a suggested bucket-ladder tweak."""
        qp = dict(query_params or {})
        if model_name:
            qp["model"] = model_name
        return self._get_json("/v2/profile", qp or None, headers)

    def get_timeseries(self, signal="", model_name="", since_seq=None,
                       since_wall=None, until_wall=None, limit=None,
                       headers=None, query_params=None):
        """Flight-recorder signal ring (``GET /v2/timeseries``): ~15 min
        of 1 Hz duty-cycle / queue-depth / batch-fill / shed-rate /
        wave-p50 / HBM / SLO-burn samples. ``since_seq`` is the
        exclusive cursor from the previous response's ``next_seq``;
        ``since_wall``/``until_wall`` an epoch-seconds window
        (exclusive lower, inclusive upper)."""
        qp = dict(query_params or {})
        if signal:
            qp["signal"] = signal
        if model_name:
            qp["model"] = model_name
        if since_seq is not None:
            qp["since"] = int(since_seq)
        if since_wall is not None:
            qp["since_wall"] = float(since_wall)
        if until_wall is not None:
            qp["until_wall"] = float(until_wall)
        if limit is not None:
            qp["limit"] = int(limit)
        return self._get_json("/v2/timeseries", qp or None, headers)

    def get_memory(self, headers=None, query_params=None):
        """HBM census report (``GET /v2/memory``): live device bytes per
        ``(model, component)`` owner, plan-vs-actual drift, watermark."""
        return self._get_json("/v2/memory", query_params, headers)

    def get_costs(self, model_name="", headers=None, query_params=None):
        """Per-tenant cost ledger (``GET /v2/costs``): device-seconds,
        HBM-byte-seconds, queue-seconds, and interference attribution
        per tenant, with profiler/census reconciliation. Tag requests
        with the ``X-Tpu-Tenant`` header or a ``tenant`` request
        parameter to attribute their spend."""
        qp = dict(query_params or {})
        if model_name:
            qp["model"] = model_name
        return self._get_json("/v2/costs", qp or None, headers)

    def get_qos_status(self, model_name="", headers=None,
                       query_params=None):
        """Tenant QoS status (``GET /v2/qos``): the class table (WFQ
        weights, token-bucket quotas, governor throttle ratios, inflight
        and shed/preemption tallies) and each model's lane depths;
        ``model_name`` narrows the lane depths to one model."""
        qp = dict(query_params or {})
        if model_name:
            qp["model"] = model_name
        return self._get_json("/v2/qos", qp or None, headers)

    def get_bundles(self, bundle_id="", headers=None, query_params=None):
        """Incident-blackbox bundles (``GET /v2/debug/bundles[/{id}]``):
        the ring's index, or one whole bundle with ``bundle_id`` (render
        it with ``tools/blackbox_report.py``)."""
        path = "/v2/debug/bundles"
        if bundle_id:
            path += f"/{bundle_id}"
        return self._get_json(path, query_params, headers)

    def capture_bundle(self, trigger="manual", incident="", note="",
                       headers=None, query_params=None):
        """Capture an incident bundle now (``POST /v2/debug/capture``)
        and return its meta. ``incident`` stamps a shared incident id; a
        trigger other than ``manual`` respects the server's debounce and
        cooldown and may answer ``{"deduped": true}``."""
        body = {"trigger": trigger or "manual"}
        if incident:
            body["incident"] = incident
        if note:
            body["note"] = note
        return self._post_json("/v2/debug/capture", body, query_params,
                               headers)

    @staticmethod
    def generate_request_body(inputs, outputs=None, request_id="",
                              sequence_id=0, sequence_start=False,
                              sequence_end=False, priority=0, timeout=None,
                              parameters=None):
        """Build (body, header_length) without sending — mirrors the
        static ``generate_request_body`` of tritonclient."""
        params = dict(parameters or {})
        if outputs is None:
            # No explicit outputs: ask the server for binary encoding of all
            # outputs (tritonclient's default, which sets
            # binary_data_output when outputs are unspecified).
            params.setdefault("binary_data_output", True)
        if sequence_id:
            params["sequence_id"] = sequence_id
            params["sequence_start"] = sequence_start
            params["sequence_end"] = sequence_end
        if priority:
            params["priority"] = priority
        if timeout is not None:
            params["timeout"] = timeout
        tensor_entries = [(i._get_tensor(), i._raw_data) for i in inputs]
        out_entries = [o._get_tensor() for o in outputs] if outputs else None
        body, jlen = rest.build_infer_request_body(
            tensor_entries, out_entries, request_id=request_id,
            parameters=params or None)
        has_binary = any(raw is not None for _, raw in tensor_entries)
        return body, (jlen if has_binary else None)

    @staticmethod
    def parse_response_body(response_body, verbose=False, header_length=None,
                            content_encoding=None):
        return InferResult.from_response_body(
            response_body, verbose, header_length, content_encoding)

    def _infer_request(self, model_name, model_version, body, header_length,
                       headers, query_params, request_compression_algorithm,
                       response_compression_algorithm, timeout_ms=None,
                       sequence_id=0):
        req_headers = dict(headers or {})
        if sequence_id:
            # Affinity signal for L7 routing (this client's own multi-URL
            # sweep and the standalone router both rendezvous-hash on it)
            # — a header, so no intermediary ever parses the body.
            req_headers.setdefault("X-Sequence-Id", str(sequence_id))
        if timeout_ms is not None:
            # End-to-end deadline propagation: the server's scheduler and
            # model skip this request once the budget lapses (504 instead
            # of wasted device time).
            req_headers["timeout-ms"] = f"{float(timeout_ms):g}"
        if header_length is not None:
            req_headers[rest.HEADER_INFERENCE_CONTENT_LENGTH] = str(header_length)
        if request_compression_algorithm == "gzip":
            body = gzip.compress(body)
            req_headers["Content-Encoding"] = "gzip"
        elif request_compression_algorithm == "deflate":
            body = zlib.compress(body)
            req_headers["Content-Encoding"] = "deflate"
        if response_compression_algorithm in ("gzip", "deflate"):
            req_headers["Accept-Encoding"] = response_compression_algorithm
        # Distributed tracing: propagate the caller's traceparent, or start
        # a new trace per request so every inference is correlatable with
        # the server's span timeline.
        req_headers.setdefault("traceparent",
                               TraceContext.new().to_traceparent())

        path = f"/v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"
        path += "/infer"
        t0 = time.monotonic_ns()
        resp, data = self._request("POST", path, body=body,
                                   headers=req_headers,
                                   query_params=query_params)
        round_trip_us = (time.monotonic_ns() - t0) / 1e3
        encoding = resp.getheader("Content-Encoding")
        if encoding == "gzip":
            data = gzip.decompress(data)
        elif encoding == "deflate":
            data = zlib.decompress(data)
        self._raise_if_error(resp, data)
        hdr = resp.getheader(rest.HEADER_INFERENCE_CONTENT_LENGTH)
        result = InferResult(data, int(hdr) if hdr is not None else None,
                             self._verbose)
        tp = resp.getheader("traceparent") or ""
        if tp.count("-") >= 2:
            result._trace_id = tp.split("-")[1]
        result._server_timing = parse_server_timing(
            resp.getheader("Server-Timing"))
        self._stats.record(round_trip_us, result._server_timing,
                           trace_id=result._trace_id)
        return result

    def infer(self, model_name, inputs, model_version="", outputs=None,
              request_id="", sequence_id=0, sequence_start=False,
              sequence_end=False, priority=0, timeout=None, headers=None,
              query_params=None, request_compression_algorithm=None,
              response_compression_algorithm=None, parameters=None,
              timeout_ms=None):
        body, header_length = self.generate_request_body(
            inputs, outputs, request_id, sequence_id, sequence_start,
            sequence_end, priority, timeout, parameters)
        return self._infer_request(
            model_name, model_version, body, header_length, headers,
            query_params, request_compression_algorithm,
            response_compression_algorithm, timeout_ms=timeout_ms,
            sequence_id=sequence_id)

    def async_infer(self, model_name, inputs, model_version="", outputs=None,
                    request_id="", sequence_id=0, sequence_start=False,
                    sequence_end=False, priority=0, timeout=None,
                    headers=None, query_params=None,
                    request_compression_algorithm=None,
                    response_compression_algorithm=None, parameters=None,
                    timeout_ms=None):
        body, header_length = self.generate_request_body(
            inputs, outputs, request_id, sequence_id, sequence_start,
            sequence_end, priority, timeout, parameters)
        future = self._executor.submit(
            self._infer_request, model_name, model_version, body,
            header_length, headers, query_params,
            request_compression_algorithm, response_compression_algorithm,
            timeout_ms, sequence_id)
        return InferAsyncRequest(future, self._verbose)
