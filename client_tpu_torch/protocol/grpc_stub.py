"""gRPC stubs for inference.GRPCInferenceService.

The port's own copy of ``client_tpu/protocol/grpc_stub.py``: a hand-written
equivalent of the ``*_pb2_grpc.py`` file ``grpc_tools`` would generate. The
method table lists every RPC of ``grpc_service.proto`` under its
fully-qualified path, so these stubs interoperate with any v2 gRPC peer;
a second table lists the operational RPCs (events, SLO, profile, the shm
slot ring, staged datasets, timeseries, memory, costs, QoS and the
blackbox; messages in ``ops_pb2``), the JAX package's table entry for
entry.
"""

from __future__ import annotations

import grpc

from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol import ops_pb2 as ops

_SERVICE = "inference.GRPCInferenceService"

# (method name, request message, response message, is_streaming)
_METHODS = [
    ("ServerLive", pb.ServerLiveRequest, pb.ServerLiveResponse, False),
    ("ServerReady", pb.ServerReadyRequest, pb.ServerReadyResponse, False),
    ("ModelReady", pb.ModelReadyRequest, pb.ModelReadyResponse, False),
    ("ServerMetadata", pb.ServerMetadataRequest, pb.ServerMetadataResponse,
     False),
    ("ModelMetadata", pb.ModelMetadataRequest, pb.ModelMetadataResponse,
     False),
    ("ModelInfer", pb.ModelInferRequest, pb.ModelInferResponse, False),
    ("ModelStreamInfer", pb.ModelInferRequest, pb.ModelStreamInferResponse,
     True),
    ("ModelConfig", pb.ModelConfigRequest, pb.ModelConfigResponse, False),
    ("ModelStatistics", pb.ModelStatisticsRequest,
     pb.ModelStatisticsResponse, False),
    ("RepositoryIndex", pb.RepositoryIndexRequest,
     pb.RepositoryIndexResponse, False),
    ("RepositoryModelLoad", pb.RepositoryModelLoadRequest,
     pb.RepositoryModelLoadResponse, False),
    ("RepositoryModelUnload", pb.RepositoryModelUnloadRequest,
     pb.RepositoryModelUnloadResponse, False),
    ("SystemSharedMemoryStatus", pb.SystemSharedMemoryStatusRequest,
     pb.SystemSharedMemoryStatusResponse, False),
    ("SystemSharedMemoryRegister", pb.SystemSharedMemoryRegisterRequest,
     pb.SystemSharedMemoryRegisterResponse, False),
    ("SystemSharedMemoryUnregister", pb.SystemSharedMemoryUnregisterRequest,
     pb.SystemSharedMemoryUnregisterResponse, False),
    ("CudaSharedMemoryStatus", pb.CudaSharedMemoryStatusRequest,
     pb.CudaSharedMemoryStatusResponse, False),
    ("CudaSharedMemoryRegister", pb.CudaSharedMemoryRegisterRequest,
     pb.CudaSharedMemoryRegisterResponse, False),
    ("CudaSharedMemoryUnregister", pb.CudaSharedMemoryUnregisterRequest,
     pb.CudaSharedMemoryUnregisterResponse, False),
    ("TpuSharedMemoryStatus", pb.TpuSharedMemoryStatusRequest,
     pb.TpuSharedMemoryStatusResponse, False),
    ("TpuSharedMemoryRegister", pb.TpuSharedMemoryRegisterRequest,
     pb.TpuSharedMemoryRegisterResponse, False),
    ("TpuSharedMemoryUnregister", pb.TpuSharedMemoryUnregisterRequest,
     pb.TpuSharedMemoryUnregisterResponse, False),
]


# The operational RPCs, in the JAX package's table's order.
_OPS_METHODS = [
    ("Events", ops.EventsRequest, ops.EventsResponse, False),
    ("SloStatus", ops.SloStatusRequest, ops.SloStatusResponse, False),
    ("Profile", ops.ProfileRequest, ops.ProfileResponse, False),
    ("RingRegister", ops.RingRegisterRequest, ops.RingRegisterResponse,
     False),
    ("RingStatus", ops.RingStatusRequest, ops.RingStatusResponse, False),
    ("RingUnregister", ops.RingUnregisterRequest,
     ops.RingUnregisterResponse, False),
    ("RingDoorbell", ops.RingDoorbellRequest, ops.RingDoorbellResponse,
     False),
    ("DatasetRegister", ops.DatasetRegisterRequest,
     ops.DatasetRegisterResponse, False),
    ("DatasetStatus", ops.DatasetStatusRequest,
     ops.DatasetStatusResponse, False),
    ("DatasetUnregister", ops.DatasetUnregisterRequest,
     ops.DatasetUnregisterResponse, False),
    ("Timeseries", ops.TimeseriesRequest, ops.TimeseriesResponse, False),
    ("MemoryCensus", ops.MemoryRequest, ops.MemoryResponse, False),
    ("Costs", ops.CostsRequest, ops.CostsResponse, False),
    ("Qos", ops.QosRequest, ops.QosResponse, False),
    ("BlackboxCapture", ops.BlackboxCaptureRequest,
     ops.BlackboxCaptureResponse, False),
    ("BlackboxBundles", ops.BlackboxBundlesRequest,
     ops.BlackboxBundlesResponse, False),
]


class GRPCInferenceServiceStub:
    """Client-side stub: one callable per RPC (``.future`` on each for the
    asynchronous form, grpcio's standard mechanism)."""

    def __init__(self, channel: grpc.Channel):
        for name, req_t, resp_t, streaming in _METHODS + _OPS_METHODS:
            make = channel.stream_stream if streaming else channel.unary_unary
            setattr(self, name, make(
                f"/{_SERVICE}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString))


class GRPCInferenceServiceServicer:
    """Server-side base class: every RPC answers UNIMPLEMENTED until a
    subclass overrides it."""


def _make_unimplemented(name):
    def method(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED,
                      f"{name} is not implemented")

    return method


for _name, _req, _resp, _streaming in _METHODS + _OPS_METHODS:
    setattr(GRPCInferenceServiceServicer, _name, _make_unimplemented(_name))


def add_GRPCInferenceServiceServicer_to_server(servicer, server):  # noqa: N802
    handlers = {}
    for name, req_t, resp_t, streaming in _METHODS + _OPS_METHODS:
        make = (grpc.stream_stream_rpc_method_handler if streaming
                else grpc.unary_unary_rpc_method_handler)
        handlers[name] = make(getattr(servicer, name),
                              request_deserializer=req_t.FromString,
                              response_serializer=resp_t.SerializeToString)
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, handlers),))
