"""Client-side utilities: the port's trimmed copy of
``client_tpu/utils/__init__.py``.

The names and signatures are those of ``tritonclient.utils``, so that a
client can switch imports without other changes. Only what the clients
(``client_tpu_torch.http``, ``client_tpu_torch.grpc``) and the
shared-memory utilities (``utils.shared_memory``,
``utils.cuda_shared_memory``) need is here.
"""

from __future__ import annotations

import numpy as np

from client_tpu_torch.protocol import codec as _codec
from client_tpu_torch.protocol import dtypes as _dtypes


class InferenceServerException(Exception):
    """Raised by client APIs; carries an optional status and details."""

    def __init__(self, msg, status=None, debug_details=None):
        self._msg = msg
        self._status = status
        self._debug_details = debug_details
        super().__init__(msg)

    def __str__(self):
        msg = super().__str__() if self._msg is None else self._msg
        if self._status is not None:
            msg = "[" + str(self._status) + "] " + msg
        return msg

    def message(self):
        return self._msg

    def status(self):
        return self._status

    def debug_details(self):
        return self._debug_details


def raise_error(msg):
    raise InferenceServerException(msg=msg)


def np_to_triton_dtype(np_dtype):
    return _dtypes.np_to_wire_dtype(np_dtype)


def triton_to_np_dtype(dtype):
    return _dtypes.wire_to_np_dtype(dtype)


def serialize_byte_tensor(input_tensor: np.ndarray):
    """A BYTES tensor as a flat uint8 array of its wire form (each element
    a 4-byte little-endian length, then its bytes)."""
    if input_tensor.size == 0:
        return np.empty([0], dtype=np.uint8)
    return np.frombuffer(_codec.serialize_bytes_tensor(input_tensor),
                         dtype=np.uint8)


def serialized_byte_size(tensor_value: np.ndarray) -> int:
    """The byte size of a BYTES tensor's wire form."""
    if tensor_value.size == 0:
        return 0
    return len(_codec.serialize_bytes_tensor(tensor_value))


def deserialize_bytes_tensor(encoded_tensor) -> np.ndarray:
    """Every element of a BYTES wire buffer, as a 1-D object array."""
    if isinstance(encoded_tensor, np.ndarray):
        encoded_tensor = encoded_tensor.tobytes()
    return _codec.deserialize_bytes_tensor(bytes(encoded_tensor))
