"""Protobuf messages of the operational control-plane RPCs.

The port's copy of ``client_tpu/protocol/ops_pb2.py``, the companion of
``grpc_service_pb2`` for the Events, SloStatus, Profile, Timeseries,
MemoryCensus and Costs RPCs (``/v2/events``, ``/v2/slo``,
``/v2/profile``, ``/v2/timeseries``, ``/v2/memory`` and ``/v2/costs``
over gRPC). No ``protoc`` is needed: the FileDescriptorProto is built
here, registered in the default descriptor pool, and the message classes
made from it. Wire-compatible with the equivalent .proto, whose other
messages (shm rings, datasets, QoS, the blackbox) stay in the file so
that it equals the JAX package's:

    syntax = "proto3"; package inference;
    message EventsRequest  { string model = 1; string severity = 2;
                             uint64 since_seq = 3; string category = 4;
                             uint32 limit = 5; double since_wall = 6;
                             double until_wall = 7; }
    message Event          { uint64 seq = 1; double ts_wall = 2;
                             uint64 ts_mono_ns = 3; string category = 4;
                             string name = 5; string severity = 6;
                             string model = 7; string version = 8;
                             string trace_id = 9; string detail_json = 10; }
    message EventsResponse { repeated Event events = 1;
                             uint64 next_seq = 2; uint64 dropped = 3; }
    message SloStatusRequest  { string model = 1; }
    message SloStatusResponse { string slo_json = 1; }
    message ProfileRequest    { string model = 1; }
    message ProfileResponse   { string profile_json = 1; }
    message RingRegisterRequest    { string name = 1; string key = 2;
                                     string spec_json = 3; }
    message RingRegisterResponse   {}
    message RingStatusRequest      { string name = 1; }
    message RingStatusResponse     { string status_json = 1; }
    message RingUnregisterRequest  { string name = 1; }
    message RingUnregisterResponse {}
    message RingDoorbellRequest    { string name = 1;
                                     string doorbell_json = 2; }
    message RingDoorbellResponse   { string result_json = 1; }
    message DatasetRegisterRequest    { string name = 1; string key = 2; }
    message DatasetRegisterResponse   {}
    message DatasetStatusRequest      { string name = 1; }
    message DatasetStatusResponse     { string status_json = 1; }
    message DatasetUnregisterRequest  { string name = 1; }
    message DatasetUnregisterResponse {}
    message TimeseriesRequest  { string signal = 1; string model = 2;
                                 uint64 since_seq = 3; uint32 limit = 4;
                                 double since_wall = 5;
                                 double until_wall = 6; }
    message TimeseriesResponse { string timeseries_json = 1; }
    message MemoryRequest      {}
    message MemoryResponse     { string memory_json = 1; }
    message CostsRequest       { string model = 1; }
    message CostsResponse      { string costs_json = 1; }
    message QosRequest         { string model = 1; }
    message QosResponse        { string qos_json = 1; }
    message BlackboxCaptureRequest  { string trigger = 1;
                                      string incident = 2;
                                      string note = 3; }
    message BlackboxCaptureResponse { string bundle_json = 1; }
    message BlackboxBundlesRequest  { string bundle_id = 1; }
    message BlackboxBundlesResponse { string bundles_json = 1; }

The report-shaped answers (SLO, profile, timeseries, memory, costs)
carry the HTTP endpoint's JSON body as a string, and an event's detail
its JSON, so that their open-ended schemas are not frozen into the proto.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2 as _descriptor_pb2
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

_F = _descriptor_pb2.FieldDescriptorProto

_FILE_NAME = "client_tpu_ops_service.proto"


def _file_proto() -> _descriptor_pb2.FileDescriptorProto:
    fdp = _descriptor_pb2.FileDescriptorProto()
    fdp.name = _FILE_NAME
    fdp.package = "inference"
    fdp.syntax = "proto3"

    def message(name: str):
        m = fdp.message_type.add()
        m.name = name
        return m

    def field(msg, name: str, number: int, ftype,
              label=_F.LABEL_OPTIONAL, type_name: str = ""):
        f = msg.field.add()
        f.name = name
        f.number = number
        f.type = ftype
        f.label = label
        if type_name:
            f.type_name = type_name

    m = message("EventsRequest")
    field(m, "model", 1, _F.TYPE_STRING)
    field(m, "severity", 2, _F.TYPE_STRING)
    field(m, "since_seq", 3, _F.TYPE_UINT64)
    field(m, "category", 4, _F.TYPE_STRING)
    field(m, "limit", 5, _F.TYPE_UINT32)
    field(m, "since_wall", 6, _F.TYPE_DOUBLE)
    field(m, "until_wall", 7, _F.TYPE_DOUBLE)

    m = message("Event")
    field(m, "seq", 1, _F.TYPE_UINT64)
    field(m, "ts_wall", 2, _F.TYPE_DOUBLE)
    field(m, "ts_mono_ns", 3, _F.TYPE_UINT64)
    field(m, "category", 4, _F.TYPE_STRING)
    field(m, "name", 5, _F.TYPE_STRING)
    field(m, "severity", 6, _F.TYPE_STRING)
    field(m, "model", 7, _F.TYPE_STRING)
    field(m, "version", 8, _F.TYPE_STRING)
    field(m, "trace_id", 9, _F.TYPE_STRING)
    field(m, "detail_json", 10, _F.TYPE_STRING)

    m = message("EventsResponse")
    field(m, "events", 1, _F.TYPE_MESSAGE, label=_F.LABEL_REPEATED,
          type_name=".inference.Event")
    field(m, "next_seq", 2, _F.TYPE_UINT64)
    field(m, "dropped", 3, _F.TYPE_UINT64)

    m = message("SloStatusRequest")
    field(m, "model", 1, _F.TYPE_STRING)

    m = message("SloStatusResponse")
    field(m, "slo_json", 1, _F.TYPE_STRING)

    m = message("ProfileRequest")
    field(m, "model", 1, _F.TYPE_STRING)

    m = message("ProfileResponse")
    field(m, "profile_json", 1, _F.TYPE_STRING)

    # shm slot-ring control plane (register-by-key + batched doorbell;
    # the doorbell span spec and status tables ride as JSON, matching
    # the HTTP bodies byte for byte).
    m = message("RingRegisterRequest")
    field(m, "name", 1, _F.TYPE_STRING)
    field(m, "key", 2, _F.TYPE_STRING)
    field(m, "spec_json", 3, _F.TYPE_STRING)

    message("RingRegisterResponse")

    m = message("RingStatusRequest")
    field(m, "name", 1, _F.TYPE_STRING)

    m = message("RingStatusResponse")
    field(m, "status_json", 1, _F.TYPE_STRING)

    m = message("RingUnregisterRequest")
    field(m, "name", 1, _F.TYPE_STRING)

    message("RingUnregisterResponse")

    m = message("RingDoorbellRequest")
    field(m, "name", 1, _F.TYPE_STRING)
    field(m, "doorbell_json", 2, _F.TYPE_STRING)

    m = message("RingDoorbellResponse")
    field(m, "result_json", 1, _F.TYPE_STRING)

    # Staged-dataset control plane (many-producer fan-in; the status
    # table rides as JSON, matching the HTTP body byte for byte).
    m = message("DatasetRegisterRequest")
    field(m, "name", 1, _F.TYPE_STRING)
    field(m, "key", 2, _F.TYPE_STRING)

    message("DatasetRegisterResponse")

    m = message("DatasetStatusRequest")
    field(m, "name", 1, _F.TYPE_STRING)

    m = message("DatasetStatusResponse")
    field(m, "status_json", 1, _F.TYPE_STRING)

    m = message("DatasetUnregisterRequest")
    field(m, "name", 1, _F.TYPE_STRING)

    message("DatasetUnregisterResponse")

    # Flight recorder + HBM census (the /v2/timeseries and /v2/memory
    # bodies ride as JSON strings, same pattern as slo/profile).
    m = message("TimeseriesRequest")
    field(m, "signal", 1, _F.TYPE_STRING)
    field(m, "model", 2, _F.TYPE_STRING)
    field(m, "since_seq", 3, _F.TYPE_UINT64)
    field(m, "limit", 4, _F.TYPE_UINT32)
    field(m, "since_wall", 5, _F.TYPE_DOUBLE)
    field(m, "until_wall", 6, _F.TYPE_DOUBLE)

    m = message("TimeseriesResponse")
    field(m, "timeseries_json", 1, _F.TYPE_STRING)

    message("MemoryRequest")

    m = message("MemoryResponse")
    field(m, "memory_json", 1, _F.TYPE_STRING)

    # Per-tenant cost ledger (the /v2/costs body rides as JSON, same
    # pattern as slo/profile/memory).
    m = message("CostsRequest")
    field(m, "model", 1, _F.TYPE_STRING)

    m = message("CostsResponse")
    field(m, "costs_json", 1, _F.TYPE_STRING)

    # Tenant QoS status (the /v2/qos body rides as JSON, same pattern
    # as slo/profile/memory/costs).
    m = message("QosRequest")
    field(m, "model", 1, _F.TYPE_STRING)

    m = message("QosResponse")
    field(m, "qos_json", 1, _F.TYPE_STRING)

    # Incident blackbox (the /v2/debug/bundles and /v2/debug/capture
    # bodies ride as JSON, same pattern as slo/profile/memory/costs).
    m = message("BlackboxCaptureRequest")
    field(m, "trigger", 1, _F.TYPE_STRING)
    field(m, "incident", 2, _F.TYPE_STRING)
    field(m, "note", 3, _F.TYPE_STRING)

    m = message("BlackboxCaptureResponse")
    field(m, "bundle_json", 1, _F.TYPE_STRING)

    m = message("BlackboxBundlesRequest")
    field(m, "bundle_id", 1, _F.TYPE_STRING)

    m = message("BlackboxBundlesResponse")
    field(m, "bundles_json", 1, _F.TYPE_STRING)

    return fdp


# The file must equal the JAX package's byte for byte: both register it
# under one name in protobuf's default pool, and a process that imports
# both (the parity tests) fails on the second import if one byte differs.
DESCRIPTOR = _descriptor_pool.Default().Add(_file_proto())

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(
    DESCRIPTOR, "client_tpu_torch.protocol.ops_pb2", globals())

__all__ = [
    "EventsRequest",
    "Event",
    "EventsResponse",
    "SloStatusRequest",
    "SloStatusResponse",
    "ProfileRequest",
    "ProfileResponse",
    "RingRegisterRequest",
    "RingRegisterResponse",
    "RingStatusRequest",
    "RingStatusResponse",
    "RingUnregisterRequest",
    "RingUnregisterResponse",
    "RingDoorbellRequest",
    "RingDoorbellResponse",
    "DatasetRegisterRequest",
    "DatasetRegisterResponse",
    "DatasetStatusRequest",
    "DatasetStatusResponse",
    "DatasetUnregisterRequest",
    "DatasetUnregisterResponse",
    "TimeseriesRequest",
    "TimeseriesResponse",
    "MemoryRequest",
    "MemoryResponse",
    "CostsRequest",
    "CostsResponse",
    "QosRequest",
    "QosResponse",
    "BlackboxCaptureRequest",
    "BlackboxCaptureResponse",
    "BlackboxBundlesRequest",
    "BlackboxBundlesResponse",
]
