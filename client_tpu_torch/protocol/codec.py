"""Tensor (de)serialization for the v2 binary-tensor extension.

The port's own copy of ``client_tpu/protocol/codec.py``: fixed-size tensors
are row-major raw bytes in their dtype; a BYTES tensor is each element as a
4-byte little-endian length followed by its bytes.
"""

from __future__ import annotations

import base64
import struct

import numpy as np

from client_tpu_torch.protocol.dtypes import (
    DataType,
    np_to_wire_dtype,
    wire_to_np_dtype,
)


def serialize_bytes_tensor(tensor: np.ndarray) -> bytes:
    """BYTES tensor -> length-prefixed elements in row-major order."""
    out = bytearray()
    for item in np.ravel(tensor, order="C"):
        if isinstance(item, str):
            raw = item.encode("utf-8")
        elif isinstance(item, (bytes, bytearray, np.bytes_)):
            raw = bytes(item)
        else:
            raw = str(item).encode("utf-8")
        out += struct.pack("<I", len(raw)) + raw
    return bytes(out)


def deserialize_bytes_tensor(encoded: bytes,
                             count: int | None = None) -> np.ndarray:
    """Inverse of :func:`serialize_bytes_tensor`: a 1-D object array of
    the elements up to the end of the buffer, or up to ``count`` of them
    (a shared-memory region may hold more bytes than its tensor). An
    element whose length overruns the buffer raises ValueError; a buffer
    that ends early gives fewer elements, and the caller's reshape says
    so, as in the JAX package."""
    items = []
    offset = 0
    while offset + 4 <= len(encoded):
        if count is not None and len(items) >= count:
            break
        (length,) = struct.unpack_from("<I", encoded, offset)
        offset += 4
        if offset + length > len(encoded):
            raise ValueError(
                f"malformed BYTES tensor: element length {length} at offset "
                f"{offset - 4} overruns buffer of {len(encoded)} bytes")
        items.append(encoded[offset:offset + length])
        offset += length
    return np.array(items, dtype=np.object_)


def serialize_tensor(tensor: np.ndarray, wire_dtype: str | None = None) -> bytes:
    """Any tensor -> raw wire bytes."""
    if wire_dtype is None:
        wire_dtype = np_to_wire_dtype(tensor.dtype)
    if wire_dtype == DataType.BYTES:
        return serialize_bytes_tensor(tensor)
    return np.ascontiguousarray(
        tensor, dtype=wire_to_np_dtype(wire_dtype)).tobytes()


def deserialize_tensor(raw: bytes, wire_dtype: str, shape) -> np.ndarray:
    """Raw wire bytes -> ndarray of the given v2 dtype and shape. Bytes
    that do not fill the shape exactly raise numpy's own ValueError
    (``frombuffer`` or ``reshape``), as in the JAX package, so both
    servers answer with the same words."""
    shape = tuple(int(d) for d in shape)
    if wire_dtype == DataType.BYTES:
        count = int(np.prod(shape, dtype=np.int64))
        return deserialize_bytes_tensor(raw, count).reshape(shape)
    np_dtype = wire_to_np_dtype(wire_dtype)
    if np_dtype is None:
        raise ValueError(f"unknown datatype '{wire_dtype}'")
    return np.frombuffer(raw, dtype=np_dtype).reshape(shape)


def b64_encode_handle(raw: bytes) -> str:
    """An opaque region handle as base64 text, for the JSON control plane
    (gRPC carries the raw bytes)."""
    return base64.b64encode(raw).decode("ascii")


def b64_decode_handle(encoded: str) -> bytes:
    return base64.b64decode(encoded)
