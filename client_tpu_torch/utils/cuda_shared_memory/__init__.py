"""Client-side device shared memory: the port of
``client_tpu/utils/tpu_shared_memory``, under the name of
``tritonclient.utils.cuda_shared_memory``.

The same API: create a region, get the raw handle to register with a
server (raw bytes over gRPC, base64 over HTTP), set and get tensors. The
handle is the JAX package's: a JSON description of the region's host
staging segment (kind ``host_staged``, shm key, byte size, device id), so
a handle made here registers on either package's server, on its ``cuda``
or ``tpu`` routes and RPCs alike. The server reads the staging segment
and stages a whole batch to the card with one copy; it takes no
cross-process CUDA IPC handle (``engine/shm.py``).
"""

from __future__ import annotations

import uuid

import numpy as np

from client_tpu_torch.engine.shm import make_tpu_handle
from client_tpu_torch.protocol.codec import b64_encode_handle
from client_tpu_torch.utils import shared_memory as _sysshm


class CudaSharedMemoryException(Exception):
    pass


class CudaSharedMemoryRegion:
    def __init__(self, triton_shm_name: str, byte_size: int, device_id: int,
                 staging: "_sysshm.SharedMemoryRegion"):
        self.triton_shm_name = triton_shm_name
        self.byte_size = byte_size
        self.device_id = device_id
        self._staging = staging


_regions: dict[str, CudaSharedMemoryRegion] = {}


def create_shared_memory_region(triton_shm_name, byte_size,
                                device_id=0) -> CudaSharedMemoryRegion:
    key = f"/cudashm_{uuid.uuid4().hex[:12]}"
    staging = _sysshm.create_shared_memory_region(
        f"{triton_shm_name}__staging", key, byte_size)
    region = CudaSharedMemoryRegion(triton_shm_name, byte_size, device_id,
                                    staging)
    _regions[triton_shm_name] = region
    return region


def get_raw_handle(shm_handle: CudaSharedMemoryRegion) -> bytes:
    """The handle bytes for a register call."""
    return make_tpu_handle(shm_handle._staging.shm_key,
                           shm_handle.byte_size, shm_handle.device_id)


def get_raw_handle_b64(shm_handle: CudaSharedMemoryRegion) -> str:
    return b64_encode_handle(get_raw_handle(shm_handle))


def set_shared_memory_region(shm_handle: CudaSharedMemoryRegion,
                             input_values, offset=0) -> None:
    _sysshm.set_shared_memory_region(shm_handle._staging, input_values,
                                     offset=offset)


def get_contents_as_numpy(shm_handle: CudaSharedMemoryRegion, datatype,
                          shape, offset=0) -> np.ndarray:
    return _sysshm.get_contents_as_numpy(shm_handle._staging, datatype,
                                         shape, offset=offset)


def allocated_shared_memory_regions():
    return list(_regions.keys())


def destroy_shared_memory_region(shm_handle: CudaSharedMemoryRegion) -> None:
    _regions.pop(shm_handle.triton_shm_name, None)
    _sysshm.destroy_shared_memory_region(shm_handle._staging)
