"""KServe v2 datatype names, their numpy types and byte sizes.

The port's own copy of ``client_tpu/protocol/dtypes.py``, trimmed to what
the HTTP frontend and the engine use. BF16 maps to numpy only where
``ml_dtypes`` is installed; numpy itself has no bfloat16.
"""

from __future__ import annotations

import numpy as np

try:
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:
    _BF16 = None


class DataType:
    """String constants for the v2 wire datatypes."""

    BOOL = "BOOL"
    UINT8 = "UINT8"
    UINT16 = "UINT16"
    UINT32 = "UINT32"
    UINT64 = "UINT64"
    INT8 = "INT8"
    INT16 = "INT16"
    INT32 = "INT32"
    INT64 = "INT64"
    FP16 = "FP16"
    FP32 = "FP32"
    FP64 = "FP64"
    BYTES = "BYTES"
    BF16 = "BF16"

    ALL = (BOOL, UINT8, UINT16, UINT32, UINT64, INT8, INT16, INT32, INT64,
           FP16, FP32, FP64, BYTES, BF16)


_WIRE_TO_NP = {
    DataType.BOOL: np.bool_,
    DataType.UINT8: np.uint8,
    DataType.UINT16: np.uint16,
    DataType.UINT32: np.uint32,
    DataType.UINT64: np.uint64,
    DataType.INT8: np.int8,
    DataType.INT16: np.int16,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.FP16: np.float16,
    DataType.FP32: np.float32,
    DataType.FP64: np.float64,
    DataType.BYTES: np.object_,
}
if _BF16 is not None:
    _WIRE_TO_NP[DataType.BF16] = _BF16

_NP_TO_WIRE = {np.dtype(t): w for w, t in _WIRE_TO_NP.items()}

# BYTES is variable-length: -1, as in the reference's tables.
_BYTE_SIZE = {
    DataType.BOOL: 1, DataType.UINT8: 1, DataType.UINT16: 2,
    DataType.UINT32: 4, DataType.UINT64: 8, DataType.INT8: 1,
    DataType.INT16: 2, DataType.INT32: 4, DataType.INT64: 8,
    DataType.FP16: 2, DataType.BF16: 2, DataType.FP32: 4, DataType.FP64: 8,
    DataType.BYTES: -1,
}


def np_to_wire_dtype(np_dtype) -> str | None:
    """numpy dtype (or anything np.dtype accepts) -> v2 wire name, or None."""
    dt = np.dtype(np_dtype)
    if dt.kind in ("S", "U"):
        return DataType.BYTES
    return _NP_TO_WIRE.get(dt)


def wire_to_np_dtype(wire: str):
    """v2 wire name -> numpy type (np.object_ for BYTES), or None."""
    return _WIRE_TO_NP.get(wire)


def dtype_byte_size(wire: str) -> int:
    """Per-element size in bytes; -1 for variable-length BYTES."""
    try:
        return _BYTE_SIZE[wire]
    except KeyError:
        raise ValueError(f"unknown datatype '{wire}'") from None
