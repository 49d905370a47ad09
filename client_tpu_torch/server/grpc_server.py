"""gRPC frontend: inference.GRPCInferenceService over the engine.

Counterpart of ``client_tpu/server/grpc_server.py``: health, server and
model metadata, model config and statistics, the repository index, unary
``ModelInfer`` and the bidirectional ``ModelStreamInfer``, on which one RPC
carries many requests and their responses (several per request for a
decoupled model) come back correlated by request id, each request ended
by the ``triton_final_response`` parameter. A stateful model's requests
carry the ``sequence_id``, ``sequence_start`` and ``sequence_end``
parameters; a stream's requests of one sequence reach the sequence
batcher in the order they were sent.

An output may ask for its top-K classes (``classification`` in its
parameters). The shared-memory RPCs: ``SystemSharedMemory*`` on the
engine's system regions, and the ``TpuSharedMemory*`` and
``CudaSharedMemory*`` RPCs alike on its device regions (a raw handle), as
in the JAX server. A tensor may be read from a region and an output
written into one (it then takes no ``raw_output_contents`` slot); a region
that is not registered answers INVALID_ARGUMENT. ``RepositoryModelLoad``
and ``RepositoryModelUnload`` (``unload_dependents`` as a ``bool_param``)
load and unload at run time. A request adopts the caller's W3C trace
context from its ``traceparent`` parameter or, on ``ModelInfer``, the
RPC's metadata (the parameter wins); a caller that sent one gets it back
on the final response with the server's phases (``server_<phase>_us``,
and ``server_compile_us`` for a cold first execution). The
``grpc.pre_infer`` fault site fires on ``ModelInfer`` entry.

A request's end-to-end deadline is the RPC's (``context.time_remaining()``)
or its ``timeout_ms`` parameter, which wins and is the only one on a
stream, whose RPC deadline covers every request on it; an expired one
answers DEADLINE_EXCEEDED. The ``tenant`` parameter tags it for the cost
ledger and ``priority`` may put it in the admission shadow class. A shed
answers RESOURCE_EXHAUSTED (UNAVAILABLE while draining) with the
``retry-after`` and ``retry-pushback-ms`` trailers; ``ServerReady``
carries the health state in an ``x-health-state`` trailer. The
operational RPCs ``Events``, ``SloStatus``, ``Profile``, ``Timeseries``,
``MemoryCensus``, ``Costs`` and ``Qos`` answer the HTTP routes' bodies
(reports as JSON strings), and so do ``BlackboxCapture`` and
``BlackboxBundles`` (the incident blackbox), ``Ring{Register,Status,
Unregister,Doorbell}`` (the shm slot ring: a register's ``spec_json``
makes a reaped ring, a doorbell's span spec rides as JSON) and
``Dataset{Register,Status,Unregister}`` (staged datasets). Each
``ModelInfer`` answer carries the replica's load report in the
``x-tpu-load`` trailer (the header form of ``X-Tpu-Load``).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent import futures

import grpc
import numpy as np

from client_tpu_torch.config import env_float, env_int
from client_tpu_torch.engine.engine import TorchEngine
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
    OutputRequest,
    now_ns,
)
from client_tpu_torch.faults import FaultInjected
from client_tpu_torch.observability.tracing import TraceContext
from client_tpu_torch.protocol import grpc_codec
from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol import ops_pb2 as ops
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.protocol.grpc_stub import (
    GRPCInferenceServiceServicer,
    add_GRPCInferenceServiceServicer_to_server,
)
from client_tpu_torch.protocol.loadreport import (
    LOAD_METADATA_KEY,
    encode_header,
)
from client_tpu_torch.protocol.model_config import config_dict_to_proto
from client_tpu_torch.protocol.pushback import (
    RETRY_AFTER_METADATA_KEY,
    RETRY_PUSHBACK_MS_METADATA_KEY,
    format_retry_after_s,
    format_retry_pushback_ms,
)
from client_tpu_torch.server.classification import (
    classify_output,
    output_labels,
)
from client_tpu_torch.server.coalesce import (
    COALESCE_MAX,
    merge,
    mergeable,
    run_compatible,
)
from client_tpu_torch.utils import lockdep

_log = logging.getLogger("client_tpu_torch")

_STATUS_BY_HTTP = {
    400: grpc.StatusCode.INVALID_ARGUMENT,
    404: grpc.StatusCode.NOT_FOUND,
    415: grpc.StatusCode.INVALID_ARGUMENT,
    429: grpc.StatusCode.RESOURCE_EXHAUSTED,
    499: grpc.StatusCode.CANCELLED,
    500: grpc.StatusCode.INTERNAL,
    # UNAVAILABLE, so that a client's retry policy treats a transient
    # overload as the HTTP transport does the same engine error.
    503: grpc.StatusCode.UNAVAILABLE,
    504: grpc.StatusCode.DEADLINE_EXCEEDED,
}


def _abort(context, exc: Exception):
    # A shed carries its pushback in trailing metadata: `retry-after` in
    # fractional seconds and `retry-pushback-ms`, which the clients'
    # RetryPolicy waits out instead of its own backoff.
    retry_after_s = getattr(exc, "retry_after_s", None)
    if retry_after_s is not None:
        context.set_trailing_metadata((
            (RETRY_AFTER_METADATA_KEY, format_retry_after_s(retry_after_s)),
            (RETRY_PUSHBACK_MS_METADATA_KEY,
             format_retry_pushback_ms(retry_after_s)),
        ))
    if isinstance(exc, EngineError):
        code = _STATUS_BY_HTTP.get(exc.status, grpc.StatusCode.UNKNOWN)
        context.abort(code, str(exc))
    context.abort(grpc.StatusCode.INTERNAL, str(exc))


def _proto_to_request(engine: TorchEngine, request: "pb.ModelInferRequest",
                      context=None) -> InferRequest:
    inputs: dict[str, np.ndarray] = {}
    raw = list(request.raw_input_contents)
    raw_idx = 0
    for tensor in request.inputs:
        p = grpc_codec.params_to_dict(tensor.parameters)
        if p.get("shared_memory_region") is not None:
            arr = engine.read_shm_tensor(
                p["shared_memory_region"],
                int(p.get("shared_memory_offset", 0)),
                int(p.get("shared_memory_byte_size", 0)),
                tensor.datatype, tensor.shape)
        elif raw_idx < len(raw) and not grpc_codec.tensor_has_contents(tensor):
            arr = grpc_codec.tensor_to_ndarray(tensor, raw[raw_idx])
            raw_idx += 1
        else:
            arr = grpc_codec.tensor_to_ndarray(tensor, None)
        inputs[tensor.name] = arr

    outputs = []
    for o in request.outputs:
        p = grpc_codec.params_to_dict(o.parameters)
        outputs.append(OutputRequest(
            name=o.name, classification_count=int(p.get("classification", 0)),
            shm_region=p.get("shared_memory_region"),
            shm_offset=int(p.get("shared_memory_offset", 0)),
            shm_byte_size=int(p.get("shared_memory_byte_size", 0))))

    params = grpc_codec.params_to_dict(request.parameters)
    req = InferRequest(
        model_name=request.model_name,
        model_version=request.model_version,
        request_id=request.id,
        inputs=inputs,
        outputs=outputs,
        parameters=params,
        sequence_id=int(params.get("sequence_id", 0)),
        sequence_start=bool(params.get("sequence_start", False)),
        sequence_end=bool(params.get("sequence_end", False)),
        priority=int(params.get("priority", 0)),
        timeout_us=int(params.get("timeout", 0)),
        tenant=str(params.get("tenant", "") or ""),
    )
    # The end-to-end deadline: a `timeout_ms` parameter (the only one
    # mid-stream, where the RPC's deadline covers the whole stream) wins
    # over the RPC's own, which the client set net of transit. An RPC
    # whose deadline has already passed is expired here (the JAX server
    # serves it as if it had none).
    timeout_ms = params.get("timeout_ms")
    if timeout_ms is not None:
        req.set_deadline_from_timeout_ms(float(timeout_ms))
    elif context is not None:
        remaining = context.time_remaining()
        if remaining is not None:
            req.deadline_ns = now_ns() + max(0, int(remaining * 1e9))
    return req


def _response_to_proto(engine: TorchEngine, req: InferRequest,
                       resp: InferResponse) -> "pb.ModelInferResponse":
    out = pb.ModelInferResponse(
        model_name=resp.model_name,
        model_version=resp.model_version,
        id=resp.request_id,
    )
    for k, v in (resp.parameters or {}).items():
        grpc_codec.set_param(out.parameters, k, v)
    out_req = {o.name: o for o in req.outputs}
    for name, arr in resp.outputs.items():
        o = out_req.get(name)
        if o is not None and o.classification_count > 0:
            arr = classify_output(arr, o.classification_count,
                                  output_labels(engine, req, name))
        dt = np_to_wire_dtype(arr.dtype)
        tensor = out.outputs.add(name=name, datatype=dt, shape=list(arr.shape))
        if o is not None and o.shm_region and o.classification_count <= 0:
            written = engine.write_shm_tensor(o.shm_region, o.shm_offset,
                                              o.shm_byte_size, arr)
            for key, value in (("shared_memory_region", o.shm_region),
                               ("shared_memory_offset", o.shm_offset),
                               ("shared_memory_byte_size", written)):
                grpc_codec.set_param(tensor.parameters, key, value)
            continue
        out.raw_output_contents.append(grpc_codec.ndarray_to_raw(arr, dt))
    # The trace round trip: only for a caller that sent a traceparent (the
    # response's parameters stay as they were for everyone else), and only
    # on a stream's final response.
    if (req.trace is not None and resp.final
            and req.parameters.get("traceparent")):
        grpc_codec.set_param(out.parameters, "traceparent",
                             req.trace.to_traceparent())
        if resp.times is not None:
            t = resp.times
            for phase, ns in (("queue", t.queue_ns),
                              ("compute_input", t.compute_input_ns),
                              ("compute_infer", t.compute_infer_ns),
                              ("compute_output", t.compute_output_ns)):
                grpc_codec.set_param(out.parameters,
                                     f"server_{phase}_us", ns // 1000)
            if t.compile_ns > 0:
                grpc_codec.set_param(out.parameters, "server_compile_us",
                                     t.compile_ns // 1000)
    return out


def _adopt_trace(req: InferRequest, context=None) -> None:
    """Adopt the caller's W3C trace context: the ``traceparent`` request
    parameter (which works on streams, where a message has no metadata of
    its own) or the RPC's metadata; the parameter wins. An id from the
    metadata is copied into ``req.parameters``, so the response carries
    it back."""
    tp = req.parameters.get("traceparent")
    if not tp and context is not None:
        md = dict(context.invocation_metadata() or [])
        tp = md.get("traceparent")
        if tp:
            req.parameters["traceparent"] = tp
    req.trace = TraceContext.from_traceparent(tp)


class _Servicer(GRPCInferenceServiceServicer):
    # How long the writer must make no progress, with the backlog over the
    # mark, before the shed fires: far past any healthy pause, yet prompt
    # for a consumer that stopped reading.
    STREAM_STALL_GRACE_S = 0.25

    def __init__(self, engine: TorchEngine):
        self.engine = engine
        # Slow-consumer mark per stream RPC: producers pause while this
        # many responses sit unwritten; a consumer that then stays stalled
        # gets the request with the most pending responses cancelled
        # (logged) and, while the backlog keeps growing, further offenders
        # one at a time, so one runaway request on a multi-request RPC is
        # shed without killing its siblings.
        self.STREAM_PENDING_LIMIT = max(
            1, env_int("CLIENT_TPU_STREAM_PENDING_LIMIT"))

    # -- health / metadata ---------------------------------------------------

    def ServerLive(self, request, context):  # noqa: N802
        return pb.ServerLiveResponse(live=self.engine.is_live())

    def ServerReady(self, request, context):  # noqa: N802
        # The HTTP frontend's X-Health-State, as a trailer: a router tells
        # a draining server from a dead one by it.
        context.set_trailing_metadata(
            (("x-health-state", self.engine.health_state()),))
        return pb.ServerReadyResponse(ready=self.engine.is_ready())

    def ModelReady(self, request, context):  # noqa: N802
        return pb.ModelReadyResponse(
            ready=self.engine.model_is_ready(request.name, request.version))

    def ServerMetadata(self, request, context):  # noqa: N802
        md = self.engine.server_metadata()
        return pb.ServerMetadataResponse(
            name=md["name"], version=md["version"],
            extensions=md["extensions"])

    def ModelMetadata(self, request, context):  # noqa: N802
        try:
            md = self.engine.model_metadata(request.name, request.version)
        except EngineError as exc:
            _abort(context, exc)
        resp = pb.ModelMetadataResponse(
            name=md["name"], versions=md["versions"], platform=md["platform"])
        for io_key, holder in (("inputs", resp.inputs),
                               ("outputs", resp.outputs)):
            for t in md[io_key]:
                holder.add(name=t["name"], datatype=t["datatype"],
                           shape=t["shape"])
        return resp

    def ModelConfig(self, request, context):  # noqa: N802
        try:
            cfg = self.engine.model_config(request.name, request.version)
        except EngineError as exc:
            _abort(context, exc)
        return pb.ModelConfigResponse(config=config_dict_to_proto(cfg))

    def ModelStatistics(self, request, context):  # noqa: N802
        try:
            stats = self.engine.model_statistics(request.name,
                                                 request.version)
        except EngineError as exc:
            _abort(context, exc)
        resp = pb.ModelStatisticsResponse()
        for s in stats["model_stats"]:
            entry = resp.model_stats.add(
                name=s["name"], version=s["version"],
                last_inference=s["last_inference"],
                inference_count=s["inference_count"],
                execution_count=s["execution_count"])
            for phase, msg in (
                    ("success", entry.inference_stats.success),
                    ("fail", entry.inference_stats.fail),
                    ("queue", entry.inference_stats.queue),
                    ("compute_input", entry.inference_stats.compute_input),
                    ("compute_infer", entry.inference_stats.compute_infer),
                    ("compute_output", entry.inference_stats.compute_output)):
                msg.count = s["inference_stats"][phase]["count"]
                msg.ns = s["inference_stats"][phase]["ns"]
            for b in s.get("batch_stats", []):
                be = entry.batch_stats.add(batch_size=b["batch_size"])
                be.compute_infer.count = b["compute_infer"]["count"]
                be.compute_infer.ns = b["compute_infer"]["ns"]
        return resp

    def RepositoryIndex(self, request, context):  # noqa: N802
        resp = pb.RepositoryIndexResponse()
        for e in self.engine.repository_index():
            resp.models.add(name=e["name"], version=e.get("version", ""),
                            state=e.get("state", ""),
                            reason=e.get("reason", ""))
        return resp

    def RepositoryModelLoad(self, request, context):  # noqa: N802
        if request.parameters:
            # A config or file override is refused, never ignored in
            # favour of the repository's own config.
            context.abort(grpc.StatusCode.UNIMPLEMENTED,
                          "load_model parameters (config/file overrides) "
                          "are not supported")
        try:
            self.engine.load_model(request.model_name)
        except Exception as exc:  # noqa: BLE001
            _abort(context, exc)
        return pb.RepositoryModelLoadResponse()

    def RepositoryModelUnload(self, request, context):  # noqa: N802
        unload_dependents = bool(
            request.parameters["unload_dependents"].bool_param
            if "unload_dependents" in request.parameters else False)
        try:
            self.engine.unload_model(request.model_name,
                                     unload_dependents=unload_dependents)
        except Exception as exc:  # noqa: BLE001
            _abort(context, exc)
        return pb.RepositoryModelUnloadResponse()

    # -- operational control plane -------------------------------------------

    def Events(self, request, context):  # noqa: N802
        """``GET /v2/events`` over gRPC. Empty strings and zeros mean no
        filter (proto3 defaults); ``since_seq`` is the exclusive cursor of
        the previous answer's ``next_seq``."""
        try:
            out = self.engine.events_export(
                model=request.model or None,
                severity=request.severity or None,
                category=request.category or None,
                since_seq=request.since_seq or None,
                since_ts=request.since_wall or None,
                until_ts=request.until_wall or None,
                limit=request.limit or None)
        except ValueError as exc:  # an unknown severity name
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        resp = ops.EventsResponse(next_seq=out["next_seq"],
                                  dropped=out["dropped"])
        for e in out["events"]:
            resp.events.add(
                seq=e["seq"], ts_wall=e["ts_wall"],
                ts_mono_ns=e["ts_mono_ns"], category=e["category"],
                name=e["name"], severity=e["severity"],
                model=e.get("model", ""), version=e.get("version", ""),
                trace_id=e.get("trace_id", ""),
                detail_json=(json.dumps(e["detail"])
                             if e.get("detail") else ""))
        return resp

    def SloStatus(self, request, context):  # noqa: N802
        """``GET /v2/slo`` over gRPC, narrowed to ``model`` if set."""
        snap = self.engine.slo_snapshot()
        if request.model:
            snap["models"] = {k: v for k, v in snap["models"].items()
                              if k == request.model}
        return ops.SloStatusResponse(slo_json=json.dumps(snap))

    def Profile(self, request, context):  # noqa: N802
        """``GET /v2/profile`` over gRPC."""
        snap = self.engine.profile_snapshot(model=request.model or None)
        return ops.ProfileResponse(profile_json=json.dumps(snap))

    def Timeseries(self, request, context):  # noqa: N802
        """``GET /v2/timeseries`` over gRPC."""
        try:
            out = self.engine.timeseries_export(
                signal=request.signal or None,
                model=request.model or None,
                since_seq=request.since_seq or None,
                since_wall=request.since_wall or None,
                until_wall=request.until_wall or None,
                limit=request.limit or None)
        except ValueError as exc:  # an unknown signal name
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        return ops.TimeseriesResponse(timeseries_json=json.dumps(out))

    def MemoryCensus(self, request, context):  # noqa: N802
        """``GET /v2/memory`` over gRPC."""
        return ops.MemoryResponse(
            memory_json=json.dumps(self.engine.memory_census()))

    def Costs(self, request, context):  # noqa: N802
        """``GET /v2/costs`` over gRPC."""
        snap = self.engine.costs_snapshot(model=request.model or None)
        return ops.CostsResponse(costs_json=json.dumps(snap))

    def Qos(self, request, context):  # noqa: N802
        """``GET /v2/qos`` over gRPC."""
        snap = self.engine.qos_snapshot(model=request.model or None)
        return ops.QosResponse(qos_json=json.dumps(snap))

    def BlackboxCapture(self, request, context):  # noqa: N802
        """``POST /v2/debug/capture`` over gRPC: the bundle's meta as
        JSON."""
        try:
            meta = self.engine.blackbox_capture(
                request.trigger or "manual",
                incident=request.incident or None,
                note=request.note or None)
        except EngineError as exc:
            _abort(context, exc)
        return ops.BlackboxCaptureResponse(bundle_json=json.dumps(meta))

    def BlackboxBundles(self, request, context):  # noqa: N802
        """``GET /v2/debug/bundles[/{id}]`` over gRPC: the index, or one
        bundle when ``bundle_id`` is set."""
        try:
            out = self.engine.blackbox_bundles(request.bundle_id or None)
        except EngineError as exc:
            _abort(context, exc)
        return ops.BlackboxBundlesResponse(bundles_json=json.dumps(out))

    # -- the shm slot ring and staged datasets -------------------------------

    def RingRegister(self, request, context):  # noqa: N802
        try:
            spec = (json.loads(request.spec_json)
                    if request.spec_json else None)
            self.engine.ring_shm.register(request.name, request.key,
                                          spec=spec)
        except Exception as exc:  # noqa: BLE001
            _abort(context, exc)
        return ops.RingRegisterResponse()

    def RingStatus(self, request, context):  # noqa: N802
        status = self.engine.ring_shm.status(request.name or None)
        return ops.RingStatusResponse(status_json=json.dumps(status))

    def RingUnregister(self, request, context):  # noqa: N802
        try:
            self.engine.ring_shm.unregister(request.name or None)
        except Exception as exc:  # noqa: BLE001
            _abort(context, exc)
        return ops.RingUnregisterResponse()

    def RingDoorbell(self, request, context):  # noqa: N802
        """The HTTP doorbell's span spec, as JSON; the answers land in
        the slots."""
        try:
            spec = json.loads(request.doorbell_json or "{}")
            result = self.engine.ring_doorbell(request.name, spec)
        except Exception as exc:  # noqa: BLE001
            _abort(context, exc)
        return ops.RingDoorbellResponse(result_json=json.dumps(result))

    def DatasetRegister(self, request, context):  # noqa: N802
        try:
            self.engine.staged_shm.register(request.name, request.key)
        except Exception as exc:  # noqa: BLE001
            _abort(context, exc)
        return ops.DatasetRegisterResponse()

    def DatasetStatus(self, request, context):  # noqa: N802
        status = self.engine.staged_shm.status(request.name or None)
        return ops.DatasetStatusResponse(status_json=json.dumps(status))

    def DatasetUnregister(self, request, context):  # noqa: N802
        try:
            self.engine.staged_shm.unregister(request.name or None)
        except Exception as exc:  # noqa: BLE001
            _abort(context, exc)
        return ops.DatasetUnregisterResponse()

    # -- shared memory -------------------------------------------------------

    def SystemSharedMemoryStatus(self, request, context):  # noqa: N802
        resp = pb.SystemSharedMemoryStatusResponse()
        for name, info in self.engine.system_shm.status(
                request.name or None).items():
            region = resp.regions[name]
            region.name = name
            region.key = info["key"]
            region.offset = info["offset"]
            region.byte_size = info["byte_size"]
        return resp

    def SystemSharedMemoryRegister(self, request, context):  # noqa: N802
        try:
            self.engine.system_shm.register(
                request.name, request.key, request.offset, request.byte_size)
        except Exception as exc:  # noqa: BLE001 — the RPC must answer
            _abort(context, exc)
        return pb.SystemSharedMemoryRegisterResponse()

    def SystemSharedMemoryUnregister(self, request, context):  # noqa: N802
        self.engine.system_shm.unregister(request.name or None)
        return pb.SystemSharedMemoryUnregisterResponse()

    def _device_status(self, request, resp):
        for name, info in self.engine.cuda_shm.status(
                request.name or None).items():
            region = resp.regions[name]
            region.name = name
            region.device_id = info["device_id"]
            region.byte_size = info["byte_size"]
        return resp

    def _device_register(self, request, context, resp):
        try:
            self.engine.cuda_shm.register_handle(
                request.name, request.raw_handle, request.device_id,
                request.byte_size)
        except Exception as exc:  # noqa: BLE001 — the RPC must answer
            _abort(context, exc)
        return resp

    def _device_unregister(self, request, resp):
        self.engine.cuda_shm.unregister(request.name or None)
        return resp

    # The Tpu and Cuda RPCs reach the same device regions.
    def TpuSharedMemoryStatus(self, request, context):  # noqa: N802
        return self._device_status(request, pb.TpuSharedMemoryStatusResponse())

    def TpuSharedMemoryRegister(self, request, context):  # noqa: N802
        return self._device_register(request, context,
                                     pb.TpuSharedMemoryRegisterResponse())

    def TpuSharedMemoryUnregister(self, request, context):  # noqa: N802
        return self._device_unregister(
            request, pb.TpuSharedMemoryUnregisterResponse())

    def CudaSharedMemoryStatus(self, request, context):  # noqa: N802
        return self._device_status(request,
                                   pb.CudaSharedMemoryStatusResponse())

    def CudaSharedMemoryRegister(self, request, context):  # noqa: N802
        return self._device_register(request, context,
                                     pb.CudaSharedMemoryRegisterResponse())

    def CudaSharedMemoryUnregister(self, request, context):  # noqa: N802
        return self._device_unregister(
            request, pb.CudaSharedMemoryUnregisterResponse())

    # -- inference -----------------------------------------------------------

    def ModelInfer(self, request, context):  # noqa: N802
        # The fault site on entry, before the request is decoded; a drop
        # answers UNAVAILABLE, the code of a severed HTTP/2 connection.
        try:
            self.engine.faults.fire("grpc.pre_infer")
        except FaultInjected as exc:
            context.abort(_STATUS_BY_HTTP.get(exc.status,
                                              grpc.StatusCode.UNAVAILABLE),
                          str(exc))
        try:
            req = _proto_to_request(self.engine, request, context)
            _adopt_trace(req, context)
            # A client that goes away marks the request, so the scheduler
            # skips it instead of spending device time on it; add_callback
            # returns False when the RPC already ended (the callback would
            # never fire), so cancel at once.
            if not context.add_callback(req.cancel):
                req.cancel()
            resp = self.engine.infer(req)
            # The load-report piggyback, as HTTP's X-Tpu-Load: each unary
            # answer refreshes the caller's view of this replica's load.
            # Telemetry never fails an inference that succeeded.
            try:
                context.set_trailing_metadata((
                    (LOAD_METADATA_KEY,
                     encode_header(self.engine.load_report())),))
            except Exception:  # noqa: BLE001
                _log.debug("load report failed", exc_info=True)
            return _response_to_proto(self.engine, req, resp)
        except Exception as exc:  # noqa: BLE001 — the RPC must answer
            _abort(context, exc)

    def ModelStreamInfer(self, request_iterator, context):  # noqa: N802
        """Bidi stream: requests in, responses out; a decoupled model sends
        several responses per request, the last marked final.

        Response callbacks run on scheduler threads (for a generative model
        the one arena thread every stream's decode shares), so they only
        enqueue the engine's responses, whose tensors are host numpy
        arrays; protobuf encoding happens on this RPC's writer below."""
        out_q: queue.Queue = queue.Queue()
        inflight = [0]
        lock = lockdep.Lock("grpc_server.stream")
        done_reading = threading.Event()
        live_reqs: dict = {}  # id(req) -> req (InferRequest is unhashable)
        pending_by_req: dict = {}  # id(req) -> responses enqueued, unwritten
        # When the stream dies (client cancel or disconnect), every request
        # in flight on it is abandoned: mark them, so the schedulers stop
        # spending device time (a generation stream retires at the next
        # wave). If the RPC already ended, add_callback returns False and
        # never fires; requests are then cancelled as they are inserted.
        stream_dead = not context.add_callback(
            lambda: [r.cancel() for r in list(live_reqs.values())])

        choke_at = [self.STREAM_PENDING_LIMIT]
        # Writer progress: advances on every batch popped and every message
        # yielded (a consumer taking messages is progress).
        progress = [0]
        armed_at: list = [None]  # (progress, monotonic) at the crossing

        def choke_if_backlogged():
            """Shed one request when the RPC's backlog crosses the mark and
            the writer then makes no progress for the grace window (a
            decode wave legitimately bursts many rows at once, so crossing
            only arms it). The next shed needs the backlog to grow by
            another full mark, since a cancelled request stops producing at
            its next wave. At 8x the mark it sheds regardless of progress,
            a memory bound against a producer that outruns a slow but
            moving reader."""
            size = out_q.qsize()
            if size < self.STREAM_PENDING_LIMIT:
                choke_at[0] = self.STREAM_PENDING_LIMIT  # re-arm on drain
                armed_at[0] = None
                return
            if size < 8 * self.STREAM_PENDING_LIMIT:
                p = progress[0]
                now = time.monotonic()
                armed = armed_at[0]
                if armed is None or armed[0] != p:
                    armed_at[0] = (p, now)  # arm, or re-arm on progress
                    return
                if now - armed[1] < self.STREAM_STALL_GRACE_S:
                    return
            if size < choke_at[0]:
                return
            with lock:
                # Check again under the lock: two callbacks crossing the
                # mark at once must shed one victim, not one each.
                size = out_q.qsize()
                if size < choke_at[0]:
                    return
                victim = None
                worst = -1
                for rid, r in live_reqs.items():
                    if r.cancelled:
                        continue  # already shedding; let it drain
                    n = pending_by_req.get(rid, 0)
                    if n > worst:
                        victim, worst = r, n
                if victim is not None:
                    choke_at[0] = size + self.STREAM_PENDING_LIMIT
            if victim is None:
                return
            _log.warning(
                "stream RPC backlog at %d pending responses (mark %d); "
                "cancelling the heaviest in-flight request (%d pending) "
                "(slow consumer)", size, self.STREAM_PENDING_LIMIT, worst)
            victim.cancel()

        # One probe per RPC, shared by every request on it: producers
        # (decode waves) pause while this stream's write queue is over the
        # mark; the shed above only takes a consumer that then stays
        # stalled.
        def rpc_backlogged() -> bool:
            return out_q.qsize() >= self.STREAM_PENDING_LIMIT

        def make_cb(req):
            def cb(resp):
                # Scheduler-thread side: enqueue only; the writer encodes.
                with lock:
                    pending_by_req[id(req)] = \
                        pending_by_req.get(id(req), 0) + 1
                out_q.put(("resp", req, resp))
                choke_if_backlogged()
                if resp.final:
                    with lock:
                        inflight[0] -= 1
                        live_reqs.pop(id(req), None)
                        rem = inflight[0]
                    if rem == 0 and done_reading.is_set():
                        out_q.put(None)  # wake the writer to exit
            return cb

        def pump_requests():
            try:
                for request in request_iterator:
                    try:
                        req = _proto_to_request(self.engine, request)
                    except Exception as exc:  # noqa: BLE001
                        out_q.put(("err", str(exc), ""))
                        continue
                    _adopt_trace(req)
                    req.backpressure = rpc_backlogged
                    with lock:
                        inflight[0] += 1
                        live_reqs[id(req)] = req
                    # Close the insertion race: a termination callback that
                    # fired before this request reached live_reqs missed it.
                    if stream_dead or not context.is_active():
                        req.cancel()
                    try:
                        self.engine.async_infer(req, make_cb(req))
                    except Exception as exc:  # noqa: BLE001
                        out_q.put(("err", str(exc), req.request_id))
                        with lock:
                            inflight[0] -= 1
                            live_reqs.pop(id(req), None)
            except grpc.RpcError:
                # The client cancelled or tore the stream down while the
                # reader waited on the request iterator: a normal end of
                # the request side (the termination callback cancels the
                # work in flight).
                pass
            finally:
                done_reading.set()
                out_q.put(None)  # wake the writer to check its state

        threading.Thread(target=pump_requests, name="grpc-stream-reader",
                         daemon=True).start()

        def encode(item) -> pb.ModelStreamInferResponse:
            if item[0] == "err":
                msg = pb.ModelStreamInferResponse(error_message=item[1])
                if item[2]:
                    msg.infer_response.id = item[2]
                return msg
            _, req, resp = item
            if resp.error is not None:
                msg = pb.ModelStreamInferResponse(
                    error_message=str(resp.error))
                msg.infer_response.id = req.request_id
                return msg
            proto = _response_to_proto(self.engine, req, resp)
            if resp.final:
                grpc_codec.set_param(proto.parameters,
                                     "triton_final_response", True)
            return pb.ModelStreamInferResponse(infer_response=proto)

        # Writer: drain what is queued, coalesce per request, encode, yield.
        # Coalescing is opt-in per request (`response_coalesce`) and
        # self-throttling: an idle writer ships every token alone; a
        # backlogged one merges what has queued. Only per-request order is
        # contractual on a multi-request stream, and merging keeps it (the
        # queue is FIFO per request).
        delay_s = env_float("CLIENT_TPU_STREAM_WRITER_DELAY_MS") / 1e3
        while True:
            batch = [out_q.get()]
            while len(batch) < COALESCE_MAX:
                try:
                    batch.append(out_q.get_nowait())
                except queue.Empty:
                    break
            progress[0] += 1  # batch popped
            saw_sentinel = False
            # plan: ("resp", req, [resps...]) and ("err", ...) items;
            # open_runs[id(req)] is a run that may still grow.
            plan: list = []
            open_runs: dict = {}
            dec: dict = {}  # id(req) -> count, applied under one lock below
            for item in batch:
                if item is None:
                    saw_sentinel = True
                    continue
                if item[0] == "resp":
                    _, req, resp = item
                    dec[id(req)] = dec.get(id(req), 0) + 1
                    if mergeable(req, resp):
                        run = open_runs.get(id(req))
                        if (run is not None
                                and run_compatible(run[2][-1], resp)):
                            run[2].append(resp)
                            continue
                        entry = ("resp", req, [resp])
                        open_runs[id(req)] = entry
                        plan.append(entry)
                    else:
                        open_runs.pop(id(req), None)  # final/error closes it
                        plan.append(("resp", req, [resp]))
                else:
                    plan.append(item)
            if dec:
                with lock:
                    for rid, k in dec.items():
                        n = pending_by_req.get(rid, k) - k
                        if n > 0:
                            pending_by_req[rid] = n
                        else:
                            pending_by_req.pop(rid, None)
            for item in plan:
                try:
                    if item[0] == "resp":
                        msg = encode(("resp", item[1], merge(item[2])))
                    else:
                        msg = encode(item)
                except Exception as exc:  # noqa: BLE001 — an encoding
                    # failure must not kill the writer with finals pending
                    msg = pb.ModelStreamInferResponse(
                        error_message=f"response encoding failed: {exc}")
                    if item[0] == "resp" and item[1].request_id:
                        msg.infer_response.id = item[1].request_id
                yield msg
                progress[0] += 1  # the consumer took a message
                if delay_s:
                    time.sleep(delay_s)
            # Exit once the request side is done and no response remains in
            # flight (a late final posts the sentinel again).
            if saw_sentinel and done_reading.is_set():
                with lock:
                    remaining = inflight[0]
                if remaining == 0 and out_q.empty():
                    return


class GrpcInferenceServer:
    """gRPC v2 server over a :class:`TorchEngine`."""

    def __init__(self, engine: TorchEngine, host: str = "127.0.0.1",
                 port: int = 8001, max_workers: int = 64,
                 certfile: str | None = None, keyfile: str | None = None):
        # max_workers sizes grpcio's handler pool. Every live
        # ModelStreamInfer RPC holds one pool thread for its whole life,
        # so the pool bounds the concurrent streams.
        self.engine = engine
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", -1),
                ("grpc.max_receive_message_length", -1),
                # Tolerate client keepalive pings: gRPC core's default
                # policy answers "too_many_pings" with GOAWAY after two
                # pings without data, killing the idle channels keepalive
                # protects.
                ("grpc.keepalive_permit_without_calls", 1),
                ("grpc.http2.min_ping_interval_without_data_ms", 500),
                ("grpc.http2.max_ping_strikes", 0),
            ])
        add_GRPCInferenceServiceServicer_to_server(_Servicer(engine),
                                                   self.server)
        if certfile:
            # TLS endpoint for grpcs:// clients.
            if not keyfile:
                raise ValueError(
                    "GrpcInferenceServer: certfile requires keyfile "
                    "(grpc.ssl_server_credentials takes the key and the "
                    "certificate chain as separate PEMs)")
            with open(keyfile, "rb") as f:
                key = f.read()
            with open(certfile, "rb") as f:
                crt = f.read()
            creds = grpc.ssl_server_credentials([(key, crt)])
            self.port = self.server.add_secure_port(f"{host}:{port}", creds)
        else:
            self.port = self.server.add_insecure_port(f"{host}:{port}")
        self.host = host

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "GrpcInferenceServer":
        self.server.start()
        return self

    def stop(self, grace: float = 2.0) -> None:
        self.server.stop(grace).wait()
