"""Server-side shared-memory region managers: the port of
``client_tpu/engine/shm.py``.

Two data planes, as in the JAX package (register by key, register by
handle):

**SystemShmManager**: POSIX system shm registered by key. The server opens
``/dev/shm/<key>`` and maps it; tensor reads are zero-copy ``np.frombuffer``
views of the mapping, and the batch pays its one host-to-device copy in
``Model.execute_timed``.

**CudaShmManager**: the device regions, the counterpart of the JAX
package's ``TpuShmManager``, with the same two kinds and the same handle
bytes:

- ``host_staged``, registered from a raw handle (JSON: kind, shm key, byte
  size, device id) by any process, over either frontend. The handle
  describes a host staging segment: reads are zero-copy host views and the
  batch pays one H2D copy, with no network bytes. Cross-process CUDA IPC
  handles are not taken, since the JAX package has no cross-process device
  region either.
- ``device``, in process: :meth:`CudaShmManager.register_device_tensor`
  makes a region of a tensor on the card. A read returns that tensor
  (reshaped, no copy); the batcher concatenates such inputs on the card,
  and a request that sets ``keep_outputs_on_device`` gets its window of
  the batch's outputs as a tensor on the card, which the region then
  stores as it is. The window is a basic slice ``v[a:b]``: a view, which
  launches nothing, so the port needs no counterpart of the JAX package's
  ``DeviceTensorView`` (slicing a ``jax.Array`` dispatches an execution).

A device region's tensor is the caller's own, not a copy: a torch tensor
is mutable where a ``jax.Array`` is a snapshot. So a caller must not write
a region while a request that reads it is in flight. A write made on a
CUDA stream other than the one the batch runs on is ordered by an event:
register and write record one on the caller's current stream, and the
batch's stream waits on it (:func:`wait_for_writer`) before it reads the
tensor. Output windows are complete when the response is delivered (the
executor waits for the forward pass), so a reader on another stream needs
no event.

Handles serialize as JSON bytes: raw over gRPC, base64 over HTTP.
"""

from __future__ import annotations

import json
import mmap
import os

import numpy as np
import torch

from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.protocol.codec import (
    b64_decode_handle,
    deserialize_tensor,
    serialize_tensor,
)
from client_tpu_torch.protocol.dtypes import (
    DataType,
    np_to_wire_dtype,
    wire_to_np_dtype,
)
from client_tpu_torch.utils import lockdep

# The attribute a device region's read carries: the CUDA event recorded
# after the region's last write, on the writer's stream.
_READY = "_region_ready"


class _SysRegion:
    __slots__ = ("name", "key", "offset", "byte_size", "fd", "map")

    def __init__(self, name, key, offset, byte_size):
        self.name = name
        self.key = key
        self.offset = int(offset)
        self.byte_size = int(byte_size)
        path = shm_path(key)
        if not os.path.exists(path):
            raise EngineError(
                f"shared memory key '{key}' does not exist", 400)
        if self.offset < 0 or self.byte_size < 0:
            raise EngineError(
                f"region '{name}': offset/byte_size must be non-negative "
                f"(got {self.offset}/{self.byte_size})", 400)
        self.fd = os.open(path, os.O_RDWR)
        try:
            self.map = mmap.mmap(self.fd, 0)
        except Exception:
            os.close(self.fd)
            raise
        size = len(self.map)
        if self.offset + self.byte_size > size:
            self.close()
            raise EngineError(
                f"region '{name}': offset+byte_size "
                f"({self.offset}+{self.byte_size}) exceeds shm segment size "
                f"({size})", 400)

    def close(self):
        # Idempotent: unregister-all may race a single unregister.
        if self.map is not None:
            try:
                self.map.close()
                self.map = None
            except BufferError:
                # Zero-copy views still reference the mapping: drop ours,
                # and the last view's collection unmaps it.
                self.map = None
        if self.fd >= 0:
            fd, self.fd = self.fd, -1
            os.close(fd)

    def read_view(self, offset: int, byte_size: int) -> memoryview:
        offset = int(offset)
        if offset < 0 or offset > self.byte_size:
            raise EngineError(
                f"offset {offset} outside region '{self.name}' "
                f"({self.byte_size}B)", 400)
        start = self.offset + offset
        if byte_size <= 0:
            byte_size = self.byte_size - offset
        if byte_size == 0:
            return memoryview(b"")  # offset == byte_size: an empty window
        if byte_size < 0 or start + byte_size > self.offset + self.byte_size:
            raise EngineError(
                f"read of {byte_size}B at {offset} exceeds region "
                f"'{self.name}' ({self.byte_size}B)", 400)
        return memoryview(self.map)[start:start + byte_size]

    def read_ndarray(self, offset, byte_size, datatype, shape) -> np.ndarray:
        view = self.read_view(offset, byte_size)
        if datatype == DataType.BYTES:
            return deserialize_tensor(bytes(view), datatype, shape)
        # A view of the mapping; the batch's staging makes the one copy.
        return np.frombuffer(view, dtype=np.uint8).view(
            _np_dtype(datatype)).reshape(tuple(int(d) for d in shape))

    def write_ndarray(self, offset, byte_size, arr: np.ndarray) -> int:
        offset = int(offset)
        if offset < 0 or offset > self.byte_size:
            raise EngineError(
                f"offset {offset} outside region '{self.name}' "
                f"({self.byte_size}B)", 400)
        raw = serialize_tensor(arr, np_to_wire_dtype(arr.dtype))
        start = self.offset + offset
        # The placement size is clamped to the region, so that a write
        # never spills past it.
        limit = byte_size if byte_size > 0 else self.byte_size
        limit = min(limit, self.byte_size - offset)
        if len(raw) > limit:
            raise EngineError(
                f"output ({len(raw)}B) exceeds shm placement in region "
                f"'{self.name}' ({limit}B)", 400)
        self.map[start:start + len(raw)] = raw
        return len(raw)


def shm_path(key: str) -> str:
    """POSIX shm keys live under /dev/shm; '/key' and 'key' both work."""
    return "/dev/shm/" + key.lstrip("/")


def _np_dtype(datatype: str):
    dt = wire_to_np_dtype(datatype)
    if dt is None:
        raise EngineError(f"unknown datatype '{datatype}'", 400)
    return dt


def _status(regions: dict, name: str | None, fields) -> dict:
    items = (regions.items() if name is None
             else [(name, regions[name])] if name in regions else [])
    return {n: {"name": n, **fields(r)} for n, r in items}


class SystemShmManager:
    def __init__(self):
        self._regions: dict[str, _SysRegion] = {}
        self._lock = lockdep.Lock("shm.system")

    def register(self, name, key, offset, byte_size) -> None:
        with self._lock:
            if name in self._regions:
                raise EngineError(
                    f"shared memory region '{name}' already registered", 400)
            self._regions[name] = _SysRegion(name, key, offset, byte_size)

    def register_from_json(self, name, body: dict) -> None:
        self.register(name, body["key"], int(body.get("offset", 0)),
                      int(body["byte_size"]))

    def unregister(self, name: str | None) -> None:
        with self._lock:
            if name is None:
                for r in self._regions.values():
                    r.close()
                self._regions.clear()
                return
            region = self._regions.pop(name, None)
            if region is not None:
                region.close()

    def has_region(self, name) -> bool:
        with self._lock:
            return name in self._regions

    def status(self, name: str | None = None) -> dict:
        with self._lock:
            return _status(self._regions, name, lambda r: {
                "key": r.key, "offset": r.offset, "byte_size": r.byte_size})

    def _get(self, name) -> _SysRegion:
        with self._lock:
            region = self._regions.get(name)
        if region is None:
            raise EngineError(
                f"shared memory region '{name}' not registered", 400)
        return region

    def read_tensor(self, name, offset, byte_size, datatype,
                    shape) -> np.ndarray:
        return self._get(name).read_ndarray(offset, byte_size, datatype,
                                            shape)

    def write_tensor(self, name, offset, byte_size, arr: np.ndarray) -> int:
        return self._get(name).write_ndarray(offset, byte_size,
                                             np.asarray(arr))


# ---------------------------------------------------------------------------
# Device regions
# ---------------------------------------------------------------------------


def make_tpu_handle(key: str, byte_size: int, device_id: int = 0) -> bytes:
    """A cross-process device region's handle (host-staged backing): the
    JAX package's ``make_tpu_handle`` bytes."""
    return json.dumps({
        "kind": "host_staged",
        "key": key,
        "byte_size": int(byte_size),
        "device_id": int(device_id),
    }).encode("utf-8")


def _record_ready(t: torch.Tensor) -> torch.cuda.Event | None:
    """An event on the current stream of ``t``'s card, after the work
    queued so far (the caller's fill); None off the card."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def wait_for_writer(t) -> None:
    """Order the current stream of ``t``'s card after the write that
    filled a device region's tensor ``t``; nothing for a tensor that was
    not read from a device region."""
    ev = getattr(t, _READY, None)
    if ev is not None:
        torch.cuda.current_stream(t.device).wait_event(ev)


class _CudaRegion:
    __slots__ = ("name", "device_id", "byte_size", "kind", "staging",
                 "tensor", "ready")

    def __init__(self, name, device_id, byte_size, kind,
                 staging: _SysRegion | None = None,
                 tensor: torch.Tensor | None = None):
        self.name = name
        self.device_id = int(device_id)
        self.byte_size = int(byte_size)
        self.kind = kind  # 'host_staged' | 'device'
        self.staging = staging
        self.tensor = tensor
        self.ready = _record_ready(tensor) if tensor is not None else None

    def close(self):
        if self.staging is not None:
            self.staging.close()
        self.tensor = None
        self.ready = None


class CudaShmManager:
    """Device regions by name; ``devices`` are the engine's devices, which
    a region's ``device_id`` indexes."""

    def __init__(self, devices: list | None = None):
        self._regions: dict[str, _CudaRegion] = {}
        self._lock = lockdep.Lock("shm.device")
        self._devices = devices

    def _device(self, device_id: int) -> torch.device:
        devices = self._devices or [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if device_id >= len(devices):
            raise EngineError(
                f"device_id {device_id} out of range "
                f"({len(devices)} devices)", 400)
        return torch.device(devices[device_id])

    # -- registration --------------------------------------------------------

    def register_handle(self, name, raw_handle: bytes, device_id,
                        byte_size) -> None:
        """The gRPC and HTTP register path: raw handle bytes. Any malformed
        handle is the client's error (400), never a 500: a JSON scalar or
        list, a missing or non-string key, an unknown kind, a non-numeric
        byte_size."""
        try:
            desc = json.loads(bytes(raw_handle).decode("utf-8"))
        except Exception:  # noqa: BLE001 — bad bytes or bad JSON, one answer
            raise EngineError(
                f"region '{name}': malformed TPU buffer handle", 400) from None
        if not isinstance(desc, dict):
            raise EngineError(
                f"region '{name}': malformed TPU buffer handle", 400)
        if desc.get("kind") != "host_staged":
            raise EngineError(
                f"region '{name}': unsupported handle kind "
                f"'{desc.get('kind')}'", 400)
        key = desc.get("key")
        if not isinstance(key, str) or not key:
            raise EngineError(
                f"region '{name}': handle missing shm key", 400)
        try:
            staged_size = int(desc.get("byte_size", byte_size))
        except (TypeError, ValueError):
            raise EngineError(
                f"region '{name}': malformed handle byte_size", 400) \
                from None
        staging = _SysRegion(name, key, 0, staged_size)
        with self._lock:
            if name in self._regions:
                staging.close()
                raise EngineError(
                    f"shared memory region '{name}' already registered", 400)
            self._regions[name] = _CudaRegion(
                name, device_id, byte_size, "host_staged", staging=staging)

    def register_from_json(self, name, body: dict) -> None:
        raw = b64_decode_handle(body["raw_handle"]["b64"])
        self.register_handle(name, raw, int(body.get("device_id", 0)),
                             int(body["byte_size"]))

    def register_device_tensor(self, name, tensor: torch.Tensor,
                               device_id: int = 0) -> None:
        """In process: the region is ``tensor`` itself, not a copy. Call it
        on the stream that filled the tensor (an event recorded there
        orders the batch's reads after the fill)."""
        with self._lock:
            if name in self._regions:
                raise EngineError(
                    f"shared memory region '{name}' already registered", 400)
            self._regions[name] = _CudaRegion(
                name, device_id, tensor.nbytes, "device", tensor=tensor)

    def unregister(self, name: str | None) -> None:
        with self._lock:
            if name is None:
                for r in self._regions.values():
                    r.close()
                self._regions.clear()
                return
            region = self._regions.pop(name, None)
            if region is not None:
                region.close()

    def has_region(self, name) -> bool:
        with self._lock:
            return name in self._regions

    def status(self, name: str | None = None) -> dict:
        with self._lock:
            return _status(self._regions, name, lambda r: {
                "device_id": r.device_id, "byte_size": r.byte_size})

    def _get(self, name) -> _CudaRegion:
        with self._lock:
            region = self._regions.get(name)
        if region is None:
            raise EngineError(
                f"shared memory region '{name}' not registered", 400)
        return region

    # -- data plane ----------------------------------------------------------

    def read_tensor(self, name, offset, byte_size, datatype, shape):
        """A device region gives its tensor, reshaped, carrying the event
        of its last write (:func:`wait_for_writer`). A host-staged region
        gives a zero-copy host view: the batcher assembles the batch on the
        host and stages it to the card once, instead of a round trip per
        request."""
        region = self._get(name)
        shape = tuple(int(d) for d in shape)
        if region.kind == "device":
            with self._lock:
                t, ready = region.tensor, region.ready
            if int(offset):
                raise EngineError(
                    f"region '{name}': offsets unsupported for device "
                    "regions", 400)
            out = t.reshape(shape) if tuple(t.shape) != shape else t.view(
                t.shape)  # a new tensor object over the same storage
            if ready is not None:
                setattr(out, _READY, ready)
            return out
        # The registered ordinal is checked although the read stays on the
        # host (the batch is placed on the card in the executor).
        self._device(region.device_id)
        return region.staging.read_ndarray(offset, byte_size, datatype, shape)

    def write_tensor(self, name, offset, byte_size, arr) -> int:
        region = self._get(name)
        if region.kind == "device":
            # The region holds one tensor: offsets are refused, as on reads,
            # and the output must fit.
            if int(offset):
                raise EngineError(
                    f"region '{name}': offsets unsupported for device "
                    "regions", 400)
            if int(arr.nbytes) > region.byte_size:
                raise EngineError(
                    f"output ({arr.nbytes}B) exceeds device region "
                    f"'{name}' ({region.byte_size}B)", 400)
            # A tensor is stored as it is (an output window stays a view of
            # its batch's output); a host array moves to the region's card.
            t = (arr if isinstance(arr, torch.Tensor)
                 else torch.tensor(np.asarray(arr),
                                   device=self._device(region.device_id)))
            ready = _record_ready(t)
            with self._lock:
                region.tensor, region.ready = t, ready
            return int(t.nbytes)
        return region.staging.write_ndarray(offset, byte_size,
                                            np.asarray(arr))

    def read_back(self, name) -> torch.Tensor:
        """In process: the current tensor of a device region."""
        region = self._get(name)
        if region.kind == "device":
            return region.tensor
        raise EngineError(
            f"region '{name}' is host-staged; read via its shm key", 400)
