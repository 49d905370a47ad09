"""Client-side POSIX system shared memory: the port of
``client_tpu/utils/shared_memory``.

The API of ``tritonclient.utils.shared_memory``: create a region (a
``/dev/shm/<key>`` segment, mapped), copy tensors into it back to back in
their wire form, read a tensor out as a numpy view, destroy it (unlinking
the segment it created). Register the region with a server by its key.
"""

from __future__ import annotations

import mmap
import os

import numpy as np

from client_tpu_torch.protocol.codec import serialize_tensor
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.utils import deserialize_bytes_tensor


class SharedMemoryException(Exception):
    pass


class SharedMemoryRegion:
    """A created or attached POSIX shm region."""

    def __init__(self, triton_shm_name: str, shm_key: str, byte_size: int,
                 fd: int, map_: mmap.mmap, created: bool):
        self.triton_shm_name = triton_shm_name
        self.shm_key = shm_key
        self.byte_size = byte_size
        self._fd = fd
        self._map = map_
        self._created = created
        self._closed = False


_mapped_regions: dict[str, SharedMemoryRegion] = {}


def _key_path(shm_key: str) -> str:
    return "/dev/shm/" + shm_key.lstrip("/")


def create_shared_memory_region(triton_shm_name, shm_key, byte_size,
                                create_only=False) -> SharedMemoryRegion:
    path = _key_path(shm_key)
    existed = os.path.exists(path)
    if create_only and existed:
        raise SharedMemoryException(
            f"shared memory region '{shm_key}' already exists")
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
    try:
        if not existed or os.fstat(fd).st_size < byte_size:
            os.ftruncate(fd, byte_size)
        map_ = mmap.mmap(fd, byte_size)
    except Exception:
        os.close(fd)
        raise
    region = SharedMemoryRegion(triton_shm_name, shm_key, byte_size, fd,
                                map_, created=not existed)
    _mapped_regions[triton_shm_name] = region
    return region


def set_shared_memory_region(shm_handle: SharedMemoryRegion, input_values,
                             offset=0) -> None:
    """Copy a list of numpy tensors into the region, back to back."""
    if not isinstance(input_values, (list, tuple)):
        raise SharedMemoryException(
            "input_values must be a list/tuple of numpy arrays")
    pos = offset
    for arr in input_values:
        arr = np.asarray(arr)
        raw = serialize_tensor(arr, np_to_wire_dtype(arr.dtype))
        if pos + len(raw) > shm_handle.byte_size:
            raise SharedMemoryException(
                f"tensors exceed region size {shm_handle.byte_size}")
        shm_handle._map[pos:pos + len(raw)] = raw
        pos += len(raw)


def get_contents_as_numpy(shm_handle: SharedMemoryRegion, datatype, shape,
                          offset=0) -> np.ndarray:
    """The region's bytes at ``offset`` as a numpy array of ``datatype``
    and ``shape``: a view of the mapping, or for BYTES a decoded copy."""
    shape = tuple(int(d) for d in shape)
    if datatype in (np.object_, bytes, "BYTES"):
        n = 1
        for d in shape:
            n *= d
        raw = bytes(shm_handle._map[offset:shm_handle.byte_size])
        return deserialize_bytes_tensor(raw)[:n].reshape(shape)
    np_dtype = np.dtype(datatype)
    count = int(np.prod(shape)) if shape else 1
    view = memoryview(shm_handle._map)[offset:offset
                                       + count * np_dtype.itemsize]
    return np.frombuffer(view, dtype=np_dtype).reshape(shape)


def mapped_shared_memory_regions():
    return list(_mapped_regions.keys())


def destroy_shared_memory_region(shm_handle: SharedMemoryRegion) -> None:
    if shm_handle._closed:
        return
    shm_handle._closed = True
    _mapped_regions.pop(shm_handle.triton_shm_name, None)
    try:
        shm_handle._map.close()
    except BufferError:
        # Views from get_contents_as_numpy still reference the mapping;
        # the last one's collection unmaps it.
        shm_handle._map = None
    os.close(shm_handle._fd)
    if shm_handle._created:
        try:
            os.unlink(_key_path(shm_handle.shm_key))
        except FileNotFoundError:
            pass
