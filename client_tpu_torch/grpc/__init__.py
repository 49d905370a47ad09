"""Python gRPC client library.

The port's copy of ``client_tpu/grpc/__init__.py``, with the API of
``tritonclient.grpc``: ``InferenceServerClient`` with health, metadata,
config, statistics, repository control and the shared-memory RPCs; unary
``infer``, callback-based ``async_infer``, and the bidirectional stream
(``start_stream`` / ``async_stream_infer`` / ``stop_stream``). Channels
and stubs are cached process-wide by URL and options. Opt-in resilience
(``retry_policy=``, ``circuit_breaker=``) comes from
``client_tpu_torch.resilience``.

The operational RPCs: ``get_events``, ``get_slo_status``,
``get_profile``, ``get_timeseries``, ``get_memory``, ``get_costs``,
``get_qos_status`` and ``get_bundles`` (with ``capture_bundle``;
messages in the port's ``ops_pb2``). The shm slot ring
(``register_shm_ring``, ``ring_doorbell``, ...; the producer side is
``RingProducer``, re-exported here) and staged datasets
(``register_staged_dataset``, ...). Not ported yet: the fleet merges.
This module loads neither torch nor jax.
"""

from __future__ import annotations

import base64
import itertools
import json
import logging
import queue
import threading
import time

import grpc
import numpy as np

from client_tpu_torch.observability.client_stats import InferStat
from client_tpu_torch.observability.tracing import TraceContext
from client_tpu_torch.protocol import grpc_codec
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol import ops_pb2 as ops
from client_tpu_torch.protocol.codec import serialize_tensor
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.protocol.grpc_stub import GRPCInferenceServiceStub
from client_tpu_torch.protocol.pushback import parse_pushback_metadata
from client_tpu_torch.resilience import run_with_resilience
from client_tpu_torch.utils import (
    InferenceServerException,
    raise_error,
)
from client_tpu_torch.utils import lockdep
from client_tpu_torch.utils.shm_ring import RingProducer  # noqa: F401

service_pb2 = pb  # re-export, as tritonclient re-exports its generated pb2

_log = logging.getLogger("client_tpu_torch")

_channel_cache: dict[tuple, tuple[grpc.Channel, GRPCInferenceServiceStub]] = {}
_channel_cache_lock = lockdep.Lock("grpcclient.channel_cache")


class KeepAliveOptions:
    """gRPC keepalive knobs, as in tritonclient."""

    def __init__(self, keepalive_time_ms=7200000, keepalive_timeout_ms=20000,
                 keepalive_permit_without_calls=False,
                 http2_max_pings_without_data=2):
        self.keepalive_time_ms = keepalive_time_ms
        self.keepalive_timeout_ms = keepalive_timeout_ms
        self.keepalive_permit_without_calls = keepalive_permit_without_calls
        self.http2_max_pings_without_data = http2_max_pings_without_data


def _grpc_error(exc: grpc.RpcError) -> InferenceServerException:
    try:
        err = InferenceServerException(
            msg=exc.details(), status=str(exc.code()))
    except Exception:  # noqa: BLE001
        return InferenceServerException(msg=str(exc))
    # Server pushback rides in trailing metadata (admission sheds / drain:
    # `retry-after` in fractional seconds, `retry-pushback-ms` integral) —
    # surfaced as retry_after_s so resilience.retry_after_of finds it and
    # RetryPolicy waits exactly as long as the server asked. Parsing is
    # shared with the HTTP Retry-After path (``protocol/pushback.py``)
    # so both transports agree on sub-second handling.
    try:
        retry_after_s = parse_pushback_metadata(exc.trailing_metadata())
        if retry_after_s is not None:
            err.retry_after_s = retry_after_s
    except Exception:  # noqa: BLE001 — pushback is best-effort
        pass
    return err


class InferInput:
    """Input tensor; data goes in raw_input_contents (fast path) by default,
    or typed contents via set_data_from_numpy(..., use_contents=True)."""

    def __init__(self, name, shape, datatype):
        self._input = pb.ModelInferRequest.InferInputTensor(
            name=name, datatype=datatype, shape=[int(d) for d in shape])
        self._raw = None

    def name(self):
        return self._input.name

    def datatype(self):
        return self._input.datatype

    def shape(self):
        return list(self._input.shape)

    def set_shape(self, shape):
        del self._input.shape[:]
        self._input.shape.extend(int(d) for d in shape)
        return self

    def set_data_from_numpy(self, input_tensor, use_contents=False):
        if not isinstance(input_tensor, np.ndarray):
            raise_error("input_tensor must be a numpy array")
        dtype = np_to_wire_dtype(input_tensor.dtype)
        expected = self._input.datatype
        if expected != dtype and not (expected == "BYTES" and dtype is None):
            raise_error(
                f"got unexpected datatype {dtype}, expected {expected}")
        if list(input_tensor.shape) != list(self._input.shape):
            raise_error(
                f"got unexpected numpy array shape "
                f"[{list(input_tensor.shape)}], expected "
                f"[{list(self._input.shape)}]")
        self._input.parameters.pop("shared_memory_region", None)
        self._input.parameters.pop("shared_memory_byte_size", None)
        self._input.parameters.pop("shared_memory_offset", None)
        if use_contents:
            self._raw = None
            self._input.contents.Clear()
            grpc_codec.fill_contents(self._input.contents, input_tensor,
                                     expected)
        else:
            self._input.contents.Clear()
            self._raw = serialize_tensor(input_tensor, expected)
        return self

    def set_shared_memory(self, region_name, byte_size, offset=0):
        self._raw = None
        self._input.contents.Clear()
        grpc_codec.set_param(self._input.parameters, "shared_memory_region",
                             region_name)
        grpc_codec.set_param(self._input.parameters,
                             "shared_memory_byte_size", byte_size)
        if offset:
            grpc_codec.set_param(self._input.parameters,
                                 "shared_memory_offset", offset)
        return self

    def _get_tensor(self):
        return self._input, self._raw


class InferRequestedOutput:
    def __init__(self, name, class_count=0):
        self._output = pb.ModelInferRequest.InferRequestedOutputTensor(
            name=name)
        if class_count:
            grpc_codec.set_param(self._output.parameters, "classification",
                                 class_count)

    def name(self):
        return self._output.name

    def set_shared_memory(self, region_name, byte_size, offset=0):
        grpc_codec.set_param(self._output.parameters, "shared_memory_region",
                             region_name)
        grpc_codec.set_param(self._output.parameters,
                             "shared_memory_byte_size", byte_size)
        if offset:
            grpc_codec.set_param(self._output.parameters,
                                 "shared_memory_offset", offset)
        return self

    def unset_shared_memory(self):
        self._output.parameters.pop("shared_memory_region", None)
        self._output.parameters.pop("shared_memory_byte_size", None)
        self._output.parameters.pop("shared_memory_offset", None)
        return self

    def _get_tensor(self):
        return self._output


class InferResult:
    """Zero-copy-ish view over ModelInferResponse: as_numpy slices
    raw_output_contents by output index."""

    def __init__(self, result: "pb.ModelInferResponse"):
        self._result = result

    def _response_params(self) -> dict:
        return grpc_codec.params_to_dict(self._result.parameters)

    def trace_id(self):
        """The W3C trace id this request ran under (32 hex chars), echoed
        as the ``traceparent`` response parameter when the request sent
        one; None otherwise."""
        tp = self._response_params().get("traceparent") or ""
        parts = tp.split("-")
        return parts[1] if len(parts) >= 3 else None

    def server_timing(self):
        """Server-side phase durations in microseconds
        ({queue, compute_input, compute_infer, compute_output}, plus
        ``compile`` when this request paid a compile), from the
        ``server_*_us`` response parameters; empty if absent."""
        params = self._response_params()
        out = {}
        for phase in ("queue", "compute_input", "compute_infer",
                      "compute_output", "compile"):
            v = params.get(f"server_{phase}_us")
            if v is not None:
                out[phase] = float(v)
        return out

    def as_numpy(self, name):
        raw_idx = 0
        for tensor in self._result.outputs:
            # shm-placed outputs carry no payload at all — they must not
            # consume a raw_output_contents slot
            is_shm = "shared_memory_region" in tensor.parameters
            has_raw = not is_shm and not grpc_codec.tensor_has_contents(tensor)
            if tensor.name == name:
                if is_shm:
                    return None
                if has_raw:
                    if raw_idx < len(self._result.raw_output_contents):
                        return grpc_codec.tensor_to_ndarray(
                            tensor,
                            self._result.raw_output_contents[raw_idx])
                    return None
                return grpc_codec.tensor_to_ndarray(tensor, None)
            if has_raw:
                raw_idx += 1
        return None

    def get_output(self, name, as_json=False):
        for tensor in self._result.outputs:
            if tensor.name == name:
                if as_json:
                    from google.protobuf import json_format

                    return json_format.MessageToDict(
                        tensor, preserving_proto_field_name=True)
                return tensor
        return None

    def get_response(self, as_json=False):
        if as_json:
            from google.protobuf import json_format

            return json_format.MessageToDict(
                self._result, preserving_proto_field_name=True)
        return self._result


class CallContext:
    """Cancellable handle returned by async_infer."""

    def __init__(self, future):
        self._future = future

    def cancel(self):
        return self._future.cancel()


class _InferStream:
    """Single bidi stream: request queue feeds the stream-stream call; a
    reader thread dispatches responses to the user callback."""

    def __init__(self, stub, callback, stream_timeout=None, headers=None):
        self._q: queue.Queue = queue.Queue()
        self._callback = callback
        self._closed = False
        metadata = list(headers.items()) if headers else None
        self._call = stub.ModelStreamInfer(
            self._request_iterator(), timeout=stream_timeout,
            metadata=metadata)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _request_iterator(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def _read_loop(self):
        try:
            for response in self._call:
                # A user callback that raises must not kill the reader
                # thread — later responses on the stream would be silently
                # dropped (same guard the unary async path applies).
                try:
                    if response.error_message:
                        self._callback(
                            None, InferenceServerException(
                                response.error_message))
                    else:
                        self._callback(
                            InferResult(response.infer_response), None)
                except Exception:  # noqa: BLE001 — user callback fault
                    pass
        except grpc.RpcError as exc:
            if not self._closed:
                try:
                    self._callback(None, _grpc_error(exc))
                except Exception:  # noqa: BLE001
                    pass

    def send(self, request):
        if self._closed:
            raise_error("stream is closed")
        self._q.put(request)

    def close(self, cancel_requests=False):
        if self._closed:
            return
        self._closed = True
        if cancel_requests:
            self._call.cancel()
        self._q.put(None)
        self._reader.join(timeout=10)
        if not self._reader.is_alive():
            return
        # The reader is wedged (server stopped sending without closing the
        # stream, or a response is stuck in flow control). Cancelling the
        # call unblocks the response iterator; a silent return here would
        # leak the thread AND the RPC.
        _log.warning("stream reader did not terminate within 10s; "
                     "cancelling the call")
        self._call.cancel()
        self._reader.join(timeout=2)
        if self._reader.is_alive():
            raise_error("stream reader did not terminate within 10s "
                        "(call cancelled; reader thread leaked)")


class InferenceServerClient:
    def __init__(self, url, verbose=False, ssl=False, root_certificates=None,
                 private_key=None, certificate_chain=None, creds=None,
                 keepalive_options=None, channel_args=None,
                 retry_policy=None, circuit_breaker=None):
        if ssl:
            raise InferenceServerException(
                "ssl is not supported by this transport yet")
        options = list(channel_args or [])
        options += [
            ("grpc.max_send_message_length", -1),
            ("grpc.max_receive_message_length", -1),
        ]
        if keepalive_options is not None:
            options += [
                ("grpc.keepalive_time_ms",
                 keepalive_options.keepalive_time_ms),
                ("grpc.keepalive_timeout_ms",
                 keepalive_options.keepalive_timeout_ms),
                ("grpc.keepalive_permit_without_calls",
                 int(keepalive_options.keepalive_permit_without_calls)),
                ("grpc.http2.max_pings_without_data",
                 keepalive_options.http2_max_pings_without_data),
            ]
        # Router-aware URL handling: a comma-separated string (or list) of
        # URLs round-robins calls across N replicas, each on its own
        # cached channel, with the per-call breaker host tracking the
        # replica actually dialed. A single URL behaves exactly as before.
        urls = ([u.strip() for u in url.split(",") if u.strip()]
                if isinstance(url, str) else [str(u) for u in url])
        if not urls:
            raise InferenceServerException("no server url given")
        self._endpoints: list[tuple[str, grpc.Channel,
                                    GRPCInferenceServiceStub]] = []
        for u in urls:
            key = (u, tuple(sorted(options)))
            # Process-global channel/stub reuse keyed by URL+options, the
            # same allocation hygiene as tritonclient's channel cache.
            with _channel_cache_lock:
                cached = _channel_cache.get(key)
                if cached is None:
                    channel = grpc.insecure_channel(u, options=options)
                    stub = GRPCInferenceServiceStub(channel)
                    _channel_cache[key] = (channel, stub)
                else:
                    channel, stub = cached
            self._endpoints.append((u, channel, stub))
        url = self._endpoints[0][0]
        self._channel = self._endpoints[0][1]
        self._rr = itertools.count()
        self._local = threading.local()
        self._verbose = verbose
        self._stream: _InferStream | None = None
        self._stats = InferStat()
        # Opt-in resilience: when a RetryPolicy is set, a call's
        # `client_timeout` becomes the end-to-end deadline budget across
        # all attempts (each attempt's RPC deadline shrinks to what
        # remains). Streaming retries connection establishment only.
        self._retry_policy = retry_policy
        self._breaker = circuit_breaker
        self._async_executor = None
        self._async_executor_lock = lockdep.Lock("grpcclient.async_executor")

    @property
    def _client_stub(self):
        """The stub for the next call. Multi-URL clients rotate here — the
        stub is bound at the call site (``self._client_stub.ModelInfer``),
        so one rotation covers all of that call's retry attempts — and the
        thread records which endpoint it dialed for breaker attribution."""
        if len(self._endpoints) == 1:
            return self._endpoints[0][2]
        url, _, stub = self._endpoints[next(self._rr)
                                      % len(self._endpoints)]
        self._local.host = url
        return stub

    @property
    def _breaker_host(self):
        if len(self._endpoints) == 1:
            return self._endpoints[0][0]
        return getattr(self._local, "host", self._endpoints[0][0])

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
        self.stop_stream()
        if self._async_executor is not None:
            self._async_executor.shutdown(wait=False)
        # channel stays cached for other clients of the same URL

    # -- health / metadata ---------------------------------------------------

    @staticmethod
    def _md(headers):
        return list(headers.items()) if headers else None

    def _unary(self, rpc, request, metadata, client_timeout, trace_id=None,
               **rpc_kwargs):
        """One unary RPC under the configured retry/breaker/deadline.
        With a retry policy, ``client_timeout`` is the total budget across
        attempts and each attempt's RPC deadline is the remaining slice."""

        def attempt(remaining_s):
            try:
                return rpc(request, metadata=metadata,
                           timeout=(remaining_s if remaining_s is not None
                                    else client_timeout),
                           **rpc_kwargs)
            except grpc.RpcError as exc:
                raise _grpc_error(exc) from None

        if self._retry_policy is None and self._breaker is None:
            return attempt(None)
        return run_with_resilience(
            attempt,
            policy=self._retry_policy,
            breaker=self._breaker,
            deadline_s=(client_timeout
                        if self._retry_policy is not None else None),
            host=self._breaker_host,
            on_retry=lambda n, exc, delay: self._stats.record_retry(),
            on_breaker_reject=self._stats.record_breaker_rejection,
            trace_id=trace_id)

    def _call(self, method, request, headers=None, as_json=False,
              client_timeout=None):
        response = self._unary(method, request, self._md(headers),
                               client_timeout)
        if as_json:
            from google.protobuf import json_format

            return json_format.MessageToDict(
                response, preserving_proto_field_name=True)
        return response

    def is_server_live(self, headers=None, client_timeout=None):
        return self._call(self._client_stub.ServerLive,
                          pb.ServerLiveRequest(), headers,
                          client_timeout=client_timeout).live

    def is_server_ready(self, headers=None, client_timeout=None):
        return self._call(self._client_stub.ServerReady,
                          pb.ServerReadyRequest(), headers,
                          client_timeout=client_timeout).ready

    def is_model_ready(self, model_name, model_version="", headers=None,
                       client_timeout=None):
        return self._call(
            self._client_stub.ModelReady,
            pb.ModelReadyRequest(name=model_name, version=model_version),
            headers, client_timeout=client_timeout).ready

    def get_server_metadata(self, headers=None, as_json=False,
                            client_timeout=None):
        return self._call(self._client_stub.ServerMetadata,
                          pb.ServerMetadataRequest(), headers, as_json,
                          client_timeout)

    def get_model_metadata(self, model_name, model_version="", headers=None,
                           as_json=False, client_timeout=None):
        return self._call(
            self._client_stub.ModelMetadata,
            pb.ModelMetadataRequest(name=model_name, version=model_version),
            headers, as_json, client_timeout)

    def get_model_config(self, model_name, model_version="", headers=None,
                         as_json=False, client_timeout=None):
        return self._call(
            self._client_stub.ModelConfig,
            pb.ModelConfigRequest(name=model_name, version=model_version),
            headers, as_json, client_timeout)

    def get_model_repository_index(self, headers=None, as_json=False,
                                   client_timeout=None):
        return self._call(self._client_stub.RepositoryIndex,
                          pb.RepositoryIndexRequest(), headers, as_json,
                          client_timeout)

    def load_model(self, model_name, headers=None, config=None, files=None,
                   client_timeout=None):
        request = pb.RepositoryModelLoadRequest(model_name=model_name)
        if config is not None:
            request.parameters["config"].string_param = config
        for path, content in (files or {}).items():
            request.parameters[path].string_param = base64.b64encode(
                content).decode("ascii")
        self._call(self._client_stub.RepositoryModelLoad, request,
                   headers, client_timeout=client_timeout)

    def unload_model(self, model_name, headers=None,
                     unload_dependents=False, client_timeout=None):
        request = pb.RepositoryModelUnloadRequest(model_name=model_name)
        if unload_dependents:
            request.parameters["unload_dependents"].bool_param = True
        self._call(self._client_stub.RepositoryModelUnload, request,
                   headers, client_timeout=client_timeout)

    def get_inference_statistics(self, model_name="", model_version="",
                                 headers=None, as_json=False,
                                 client_timeout=None):
        return self._call(
            self._client_stub.ModelStatistics,
            pb.ModelStatisticsRequest(name=model_name,
                                      version=model_version),
            headers, as_json, client_timeout)

    # -- shared memory -------------------------------------------------------

    def _events_via(self, stub, model_name="", severity="", category="",
                    since_seq=None, limit=None, headers=None,
                    client_timeout=None, since_wall=None,
                    until_wall=None):
        request = ops.EventsRequest(
            model=model_name, severity=severity, category=category,
            since_seq=int(since_seq) if since_seq else 0,
            since_wall=float(since_wall) if since_wall else 0.0,
            until_wall=float(until_wall) if until_wall else 0.0,
            limit=int(limit) if limit else 0)
        response = self._unary(stub.Events, request,
                               self._md(headers), client_timeout)
        events = []
        for e in response.events:
            ev = {"seq": e.seq, "ts_wall": e.ts_wall,
                  "ts_mono_ns": e.ts_mono_ns, "category": e.category,
                  "name": e.name, "severity": e.severity}
            if e.model:
                ev["model"] = e.model
            if e.version:
                ev["version"] = e.version
            if e.trace_id:
                ev["trace_id"] = e.trace_id
            if e.detail_json:
                ev["detail"] = json.loads(e.detail_json)
            events.append(ev)
        return {"events": events, "next_seq": response.next_seq,
                "dropped": response.dropped}

    def get_events(self, model_name="", severity="", category="",
                   since_seq=None, since_wall=None, until_wall=None,
                   limit=None, headers=None, client_timeout=None):
        """Structured event journal (gRPC mirror of ``GET /v2/events``).
        Returns the same dict shape as the HTTP endpoint: ``events`` (each
        with its ``detail`` decoded from JSON), ``next_seq``, ``dropped``.
        ``since_wall``/``until_wall`` bound the events by epoch-seconds
        wall stamp (exclusive lower, inclusive upper)."""
        return self._events_via(self._client_stub, model_name, severity,
                                category, since_seq, limit, headers,
                                client_timeout, since_wall=since_wall,
                                until_wall=until_wall)

    def get_slo_status(self, model_name="", headers=None,
                       client_timeout=None):
        """SLO burn-rate snapshot (gRPC mirror of ``GET /v2/slo``)."""
        response = self._unary(
            self._client_stub.SloStatus,
            ops.SloStatusRequest(model=model_name),
            self._md(headers), client_timeout)
        return json.loads(response.slo_json)

    def get_profile(self, model_name="", headers=None, client_timeout=None):
        """Efficiency profiler cost table (gRPC mirror of
        ``GET /v2/profile``): per-model/per-bucket fill ratios,
        padding-waste device-seconds, compile counts, duty cycle."""
        response = self._unary(
            self._client_stub.Profile,
            ops.ProfileRequest(model=model_name),
            self._md(headers), client_timeout)
        return json.loads(response.profile_json)

    def get_timeseries(self, signal="", model_name="", since_seq=None,
                       since_wall=None, until_wall=None, limit=None,
                       headers=None, client_timeout=None):
        """Flight-recorder signal ring (gRPC mirror of
        ``GET /v2/timeseries``): the 1 Hz duty-cycle / queue-depth /
        HBM sample history; ``since_seq`` is the exclusive cursor from
        the previous response's ``next_seq``; ``since_wall``/
        ``until_wall`` an epoch-seconds window (exclusive lower,
        inclusive upper)."""
        response = self._unary(
            self._client_stub.Timeseries,
            ops.TimeseriesRequest(signal=signal, model=model_name,
                                  since_seq=since_seq or 0,
                                  since_wall=float(since_wall or 0.0),
                                  until_wall=float(until_wall or 0.0),
                                  limit=limit or 0),
            self._md(headers), client_timeout)
        return json.loads(response.timeseries_json)

    def get_memory(self, headers=None, client_timeout=None):
        """HBM census report (gRPC mirror of ``GET /v2/memory``)."""
        response = self._unary(
            self._client_stub.MemoryCensus, ops.MemoryRequest(),
            self._md(headers), client_timeout)
        return json.loads(response.memory_json)

    def get_costs(self, model_name="", headers=None, client_timeout=None):
        """Per-tenant cost ledger (gRPC mirror of ``GET /v2/costs``):
        device/HBM/queue seconds and interference attribution per
        tenant. Tag requests with a ``tenant`` request parameter to
        attribute their spend."""
        response = self._unary(
            self._client_stub.Costs,
            ops.CostsRequest(model=model_name),
            self._md(headers), client_timeout)
        return json.loads(response.costs_json)

    def get_qos_status(self, model_name="", headers=None,
                       client_timeout=None):
        """Tenant QoS status (gRPC mirror of ``GET /v2/qos``): class
        weights, quotas, governor throttle ratios, and each model's lane
        depths."""
        response = self._unary(
            self._client_stub.Qos, ops.QosRequest(model=model_name),
            self._md(headers), client_timeout)
        return json.loads(response.qos_json)

    def get_bundles(self, bundle_id="", headers=None,
                    client_timeout=None):
        """Incident-blackbox bundles (gRPC mirror of ``GET
        /v2/debug/bundles[/{id}]``): the ring's index, or one whole
        bundle with ``bundle_id``."""
        response = self._unary(
            self._client_stub.BlackboxBundles,
            ops.BlackboxBundlesRequest(bundle_id=bundle_id),
            self._md(headers), client_timeout)
        return json.loads(response.bundles_json)

    def capture_bundle(self, trigger="manual", incident="", note="",
                       headers=None, client_timeout=None):
        """Capture an incident bundle now (gRPC mirror of ``POST
        /v2/debug/capture``) and return its meta; a trigger other than
        ``manual`` respects the server's debounce and cooldown and may
        answer ``{"deduped": true}``."""
        response = self._unary(
            self._client_stub.BlackboxCapture,
            ops.BlackboxCaptureRequest(trigger=trigger or "manual",
                                       incident=incident, note=note),
            self._md(headers), client_timeout)
        return json.loads(response.bundle_json)

    def get_system_shared_memory_status(self, region_name="", headers=None,
                                        as_json=False, client_timeout=None):
        return self._call(
            self._client_stub.SystemSharedMemoryStatus,
            pb.SystemSharedMemoryStatusRequest(name=region_name),
            headers, as_json, client_timeout)

    def register_system_shared_memory(self, name, key, byte_size, offset=0,
                                      headers=None, client_timeout=None):
        self._call(
            self._client_stub.SystemSharedMemoryRegister,
            pb.SystemSharedMemoryRegisterRequest(
                name=name, key=key, offset=offset, byte_size=byte_size),
            headers, client_timeout=client_timeout)

    def unregister_system_shared_memory(self, name="", headers=None,
                                        client_timeout=None):
        self._call(
            self._client_stub.SystemSharedMemoryUnregister,
            pb.SystemSharedMemoryUnregisterRequest(name=name), headers,
            client_timeout=client_timeout)

    def get_tpu_shared_memory_status(self, region_name="", headers=None,
                                     as_json=False, client_timeout=None):
        return self._call(
            self._client_stub.TpuSharedMemoryStatus,
            pb.TpuSharedMemoryStatusRequest(name=region_name),
            headers, as_json, client_timeout)

    def register_tpu_shared_memory(self, name, raw_handle, device_id,
                                   byte_size, headers=None,
                                   client_timeout=None):
        """Register a device region by serialized buffer handle (the raw
        bytes travel in the proto's ``raw_handle``; the port's server reads
        the handle as a host-staged region)."""
        self._call(
            self._client_stub.TpuSharedMemoryRegister,
            pb.TpuSharedMemoryRegisterRequest(
                name=name, raw_handle=raw_handle, device_id=device_id,
                byte_size=byte_size),
            headers, client_timeout=client_timeout)

    def unregister_tpu_shared_memory(self, name="", headers=None,
                                     client_timeout=None):
        self._call(
            self._client_stub.TpuSharedMemoryUnregister,
            pb.TpuSharedMemoryUnregisterRequest(name=name), headers,
            client_timeout=client_timeout)

    get_cuda_shared_memory_status = get_tpu_shared_memory_status
    register_cuda_shared_memory = register_tpu_shared_memory
    unregister_cuda_shared_memory = unregister_tpu_shared_memory

    # -- shm slot ring (zero-copy data plane) -------------------------------

    def register_shm_ring(self, name, key, spec=None, headers=None,
                          client_timeout=None):
        """Attach a slot-ring segment (made with
        ``client_tpu_torch.utils.shm_ring``) by POSIX shm key. A ``spec``
        (a doorbell's span spec without start/count) makes a reaped
        ring: the engine's reaper sweeps FILLED slots, and no doorbell is
        rung."""
        self._call(self._client_stub.RingRegister,
                   ops.RingRegisterRequest(
                       name=name, key=key,
                       spec_json=json.dumps(spec) if spec else ""),
                   headers, client_timeout=client_timeout)

    def unregister_shm_ring(self, name="", headers=None,
                            client_timeout=None):
        self._call(self._client_stub.RingUnregister,
                   ops.RingUnregisterRequest(name=name), headers,
                   client_timeout=client_timeout)

    def get_shm_ring_status(self, name="", headers=None,
                            client_timeout=None):
        response = self._unary(
            self._client_stub.RingStatus,
            ops.RingStatusRequest(name=name),
            self._md(headers), client_timeout)
        return json.loads(response.status_json)

    def ring_doorbell(self, name, spec, headers=None, client_timeout=None):
        """Submit a span of FILLED ring slots in one RPC; the span spec
        rides as JSON (the HTTP doorbell's body), and the answers are
        read from the slots."""
        response = self._unary(
            self._client_stub.RingDoorbell,
            ops.RingDoorbellRequest(name=name,
                                    doorbell_json=json.dumps(spec)),
            self._md(headers), client_timeout)
        return json.loads(response.result_json)

    # -- staged datasets (many-producer fan-in) -----------------------------

    def register_staged_dataset(self, name, key, headers=None,
                                client_timeout=None):
        """Attach a staged-dataset segment (built with
        ``client_tpu_torch.utils.shm_ring.staged``) by POSIX shm key."""
        self._call(self._client_stub.DatasetRegister,
                   ops.DatasetRegisterRequest(name=name, key=key),
                   headers, client_timeout=client_timeout)

    def unregister_staged_dataset(self, name="", headers=None,
                                  client_timeout=None):
        self._call(self._client_stub.DatasetUnregister,
                   ops.DatasetUnregisterRequest(name=name), headers,
                   client_timeout=client_timeout)

    def get_staged_dataset_status(self, name="", headers=None,
                                  client_timeout=None):
        response = self._unary(
            self._client_stub.DatasetStatus,
            ops.DatasetStatusRequest(name=name),
            self._md(headers), client_timeout)
        return json.loads(response.status_json)

    # -- inference -----------------------------------------------------------

    def _make_request(self, model_name, inputs, model_version, outputs,
                      request_id, sequence_id, sequence_start, sequence_end,
                      priority, timeout, parameters):
        request = pb.ModelInferRequest(
            model_name=model_name, model_version=model_version,
            id=request_id)
        if sequence_id:
            grpc_codec.set_param(request.parameters, "sequence_id",
                                 sequence_id)
            grpc_codec.set_param(request.parameters, "sequence_start",
                                 sequence_start)
            grpc_codec.set_param(request.parameters, "sequence_end",
                                 sequence_end)
        if priority:
            grpc_codec.set_param(request.parameters, "priority", priority)
        if timeout is not None:
            grpc_codec.set_param(request.parameters, "timeout", timeout)
        for k, v in (parameters or {}).items():
            grpc_codec.set_param(request.parameters, k, v)
        for i in inputs:
            tensor, raw = i._get_tensor()
            request.inputs.append(tensor)
            if raw is not None:
                request.raw_input_contents.append(raw)
        for o in outputs or []:
            request.outputs.append(o._get_tensor())
        return request

    def infer(self, model_name, inputs, model_version="", outputs=None,
              request_id="", sequence_id=0, sequence_start=False,
              sequence_end=False, priority=0, timeout=None,
              client_timeout=None, headers=None, compression_algorithm=None,
              parameters=None):
        # Distributed tracing: propagate the caller's traceparent (parameter
        # wins, then RPC metadata), or start a new trace per request so the
        # server echoes the id and phase timings back as response
        # parameters.
        params = dict(parameters or {})
        params.setdefault("traceparent",
                          (headers or {}).get("traceparent")
                          or TraceContext.new().to_traceparent())
        request = self._make_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout,
            params)
        tp_parts = params["traceparent"].split("-")
        trace_id = tp_parts[1] if len(tp_parts) >= 3 else None
        t0 = time.monotonic_ns()
        response = self._unary(
            self._client_stub.ModelInfer, request, self._md(headers),
            client_timeout, trace_id=trace_id,
            compression=_compression(compression_algorithm))
        result = InferResult(response)
        self._stats.record((time.monotonic_ns() - t0) / 1e3,
                           result.server_timing(),
                           trace_id=result.trace_id() or trace_id)
        return result

    def async_infer(self, model_name, inputs, callback, model_version="",
                    outputs=None, request_id="", sequence_id=0,
                    sequence_start=False, sequence_end=False, priority=0,
                    timeout=None, client_timeout=None, headers=None,
                    compression_algorithm=None, parameters=None):
        request = self._make_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout,
            parameters)
        if self._retry_policy is not None or self._breaker is not None:
            # gRPC's call-future cannot replay itself, so the resilient
            # async path runs the retrying unary call on a worker thread.
            with self._async_executor_lock:
                if self._async_executor is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._async_executor = ThreadPoolExecutor(max_workers=4)
            task = self._async_executor.submit(
                self._unary, self._client_stub.ModelInfer, request,
                self._md(headers), client_timeout,
                compression=_compression(compression_algorithm))

            def _task_done(f):
                try:
                    result = InferResult(f.result())
                except InferenceServerException as exc:
                    callback(None, exc)
                    return
                except Exception as exc:  # noqa: BLE001
                    callback(None, InferenceServerException(str(exc)))
                    return
                callback(result, None)

            task.add_done_callback(_task_done)
            return CallContext(task)
        future = self._client_stub.ModelInfer.future(
            request, metadata=self._md(headers), timeout=client_timeout,
            compression=_compression(compression_algorithm))

        def _done(f):
            # only the RPC result fetch is guarded: an exception raised by
            # the user's own callback must not re-invoke it as an error
            try:
                result = InferResult(f.result())
            except grpc.RpcError as exc:
                callback(None, _grpc_error(exc))
                return
            except Exception as exc:  # noqa: BLE001
                callback(None, InferenceServerException(str(exc)))
                return
            callback(result, None)

        future.add_done_callback(_done)
        return CallContext(future)

    # -- streaming -----------------------------------------------------------

    def start_stream(self, callback, stream_timeout=None, headers=None):
        if self._stream is not None:
            raise_error("stream already started")
        if self._retry_policy is not None:
            # Streaming retries CONNECTION ESTABLISHMENT only: once a
            # stream is up, replaying in-flight stream requests would
            # reorder sequences, so mid-stream errors still surface to the
            # user callback. Each readiness probe waits up to 1s.
            def attempt(remaining_s):
                wait = 1.0 if remaining_s is None else min(1.0, remaining_s)
                try:
                    grpc.channel_ready_future(self._channel).result(
                        timeout=wait)
                except grpc.FutureTimeoutError:
                    raise ConnectionError(
                        "gRPC channel not ready (connection "
                        "establishment timed out)") from None

            run_with_resilience(
                attempt,
                policy=self._retry_policy,
                breaker=self._breaker,
                deadline_s=stream_timeout,
                host=self._breaker_host,
                on_retry=lambda n, exc, delay: self._stats.record_retry(),
                on_breaker_reject=self._stats.record_breaker_rejection)
        self._stream = _InferStream(self._client_stub, callback,
                                    stream_timeout, headers)

    def stop_stream(self, cancel_requests=False):
        if self._stream is not None:
            self._stream.close(cancel_requests)
            self._stream = None

    def async_stream_infer(self, model_name, inputs, model_version="",
                           outputs=None, request_id="", sequence_id=0,
                           sequence_start=False, sequence_end=False,
                           priority=0, timeout=None, parameters=None,
                           enable_empty_final_response=False):
        if self._stream is None:
            raise_error("stream not started (call start_stream first)")
        request = self._make_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout,
            parameters)
        self._stream.send(request)


def _compression(name):
    if name is None:
        return None
    if name == "gzip":
        return grpc.Compression.Gzip
    if name == "deflate":
        return grpc.Compression.Deflate
    return grpc.Compression.NoCompression
