"""numpy <-> gRPC protobuf tensor conversion.

The port's own copy of ``client_tpu/protocol/grpc_codec.py``. Two
encodings, as in the v2 protocol: ``raw_*_contents`` (packed little-endian
bytes, the fast path) and the typed ``InferTensorContents`` fields (used by
the explicit-content example clients).
"""

from __future__ import annotations

import numpy as np

from client_tpu_torch.protocol import grpc_service_pb2 as pb
from client_tpu_torch.protocol.codec import deserialize_tensor, serialize_tensor
from client_tpu_torch.protocol.dtypes import DataType, wire_to_np_dtype

# Typed-contents field per wire dtype (BYTES handled apart).
_CONTENT_FIELD = {
    DataType.BOOL: "bool_contents",
    DataType.INT8: "int_contents",
    DataType.INT16: "int_contents",
    DataType.INT32: "int_contents",
    DataType.INT64: "int64_contents",
    DataType.UINT8: "uint_contents",
    DataType.UINT16: "uint_contents",
    DataType.UINT32: "uint_contents",
    DataType.UINT64: "uint64_contents",
    DataType.FP32: "fp32_contents",
    DataType.FP64: "fp64_contents",
    DataType.BYTES: "bytes_contents",
}


def set_param(param_map, key, value) -> None:
    p = param_map[key]
    if isinstance(value, bool):
        p.bool_param = value
    elif isinstance(value, int):
        p.int64_param = value
    elif isinstance(value, float):
        p.double_param = value
    else:
        p.string_param = str(value)


def param_value(p: "pb.InferParameter"):
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else None


def params_to_dict(param_map) -> dict:
    return {k: param_value(v) for k, v in param_map.items()}


def fill_contents(contents: "pb.InferTensorContents", arr: np.ndarray,
                  datatype: str) -> None:
    """Populate the typed contents field from a numpy array."""
    field = _CONTENT_FIELD.get(datatype)
    if field is None:
        raise ValueError(
            f"datatype {datatype} has no typed contents field; use raw")
    if datatype == DataType.BYTES:
        contents.bytes_contents.extend(
            x if isinstance(x, bytes) else
            bytes(x) if isinstance(x, (bytearray, np.bytes_)) else
            str(x).encode("utf-8")
            for x in np.ravel(arr, order="C"))
    else:
        getattr(contents, field).extend(np.ravel(arr, order="C").tolist())


def contents_to_ndarray(contents: "pb.InferTensorContents", datatype: str,
                        shape) -> np.ndarray:
    field = _CONTENT_FIELD.get(datatype)
    if field is None:
        raise ValueError(f"datatype {datatype} not representable as contents")
    shape = tuple(int(d) for d in shape)
    if datatype == DataType.BYTES:
        arr = np.array(list(contents.bytes_contents), dtype=np.object_)
    else:
        arr = np.array(getattr(contents, field),
                       dtype=wire_to_np_dtype(datatype))
    return arr.reshape(shape)


def tensor_to_ndarray(tensor, raw: bytes | None) -> np.ndarray:
    """InferInputTensor/InferOutputTensor (and its raw slice) -> ndarray."""
    if raw is not None:
        return deserialize_tensor(raw, tensor.datatype, tensor.shape)
    return contents_to_ndarray(tensor.contents, tensor.datatype, tensor.shape)


def ndarray_to_raw(arr: np.ndarray, datatype: str) -> bytes:
    return serialize_tensor(arr, datatype)


def tensor_has_contents(tensor) -> bool:
    """True if any typed ``InferTensorContents`` field is populated: such a
    tensor takes no ``raw_*_contents`` slot (client and server must agree
    on this rule, or raw slots are assigned to the wrong tensors)."""
    c = tensor.contents
    return any(len(getattr(c, f.name)) for f in c.DESCRIPTOR.fields)
