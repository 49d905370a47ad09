"""Client-side staged-dataset segment (the shared read-only data half
of the many-producer shm fan-in plane).

The port's copy of ``client_tpu/utils/shm_ring/staged.py``; the header,
manifest and descriptor formats are the JAX package's, byte for byte.

A staged dataset is a POSIX shm segment created ONCE per host that holds
a manifest of named tensors: the dtype/shape/offset table lives in the
header region and the raw tensor payloads are packed behind it. Any
number of co-located producers attach the same segment read-only and
reference rows of its tensors by ``(dataset, tensor, offset)``
descriptors in their ring slots (24 bytes per input) instead of copying
tensor bytes into the slot — the TensorSocket sharing model (PAPERS.md,
arXiv 2409.18749): one copy of the dataset in memory no matter how many
producers replay it.

Segment layout (word fields are aligned little-endian uint64)::

    [ header words ]
      0   magic           DSET_MAGIC ("TPUDSET1")
      8   version         DSET_VERSION
      16  tensor_count
      24  manifest_bytes  length of the JSON manifest at byte 64
      32  payload_base    byte offset of the packed payload (page aligned)
      40  total_bytes     full segment size
    [ manifest JSON at byte 64: [{"name","datatype","shape","offset",
      "byte_size"}, ...], offsets relative to payload_base ]
    [ payload: tensors back-to-back, each 64-byte aligned ]

The magic is written last, so an attacher that sees it sees a complete
manifest and payload. The segment is immutable after build — producers
and the engine map it read-only in spirit; nothing ever writes past
creation, which is what makes the one-copy sharing safe without locks.

Descriptor wire format (one per staged input, in the ring slot's
request region)::

    [uint64 tensor_index][uint64 row_start][uint64 row_count]

resolved server-side as a zero-copy row-slice view of the manifest
tensor: shape ``[row_count, *tensor.shape[1:]]``.
"""

from __future__ import annotations

import json
import mmap
import os

import numpy as np

from client_tpu_torch.protocol.dtypes import np_to_wire_dtype, wire_to_np_dtype

DSET_MAGIC = 0x3154455344555054         # b"TPUDSET1" little-endian
DSET_VERSION = 1
DSET_MANIFEST_OFF = 64                  # JSON manifest starts here

OFF_DSET_MAGIC = 0
OFF_DSET_VERSION = 8
OFF_DSET_TENSOR_COUNT = 16
OFF_DSET_MANIFEST_BYTES = 24
OFF_DSET_PAYLOAD_BASE = 32
OFF_DSET_TOTAL_BYTES = 40

DESCRIPTOR_BYTES = 24                   # [tensor_idx][row_start][row_count]


class StagedDatasetError(Exception):
    pass


def _align(n: int, a: int) -> int:
    return (int(n) + a - 1) & ~(a - 1)


def _key_path(shm_key: str) -> str:
    return "/dev/shm/" + shm_key.lstrip("/")


def pack_descriptor(tensor_index: int, row_start: int,
                    row_count: int) -> bytes:
    return np.asarray([tensor_index, row_start, row_count],
                      dtype="<u8").tobytes()


def unpack_descriptor(raw) -> tuple[int, int, int]:
    words = np.frombuffer(bytes(raw[:DESCRIPTOR_BYTES]), dtype="<u8")
    if words.size != 3:
        raise StagedDatasetError(
            f"descriptor must be {DESCRIPTOR_BYTES} bytes")
    return int(words[0]), int(words[1]), int(words[2])


def build_staged_dataset(shm_key: str,
                         tensors: dict[str, np.ndarray]) -> "StagedDataset":
    """Create the segment and pack ``{name: ndarray}`` behind a manifest.

    Tensors must be fixed-dtype (no BYTES/object arrays — row slicing
    needs a constant row stride) and at least rank 1 (axis 0 is the row
    axis producers index).
    """
    if not tensors:
        raise StagedDatasetError("staged dataset needs at least one tensor")
    packed: list[tuple[dict, np.ndarray]] = []
    pos = 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == object:
            raise StagedDatasetError(
                f"tensor '{name}': BYTES/object tensors cannot be staged "
                "(no fixed row stride)")
        if arr.ndim < 1:
            raise StagedDatasetError(
                f"tensor '{name}': staged tensors need a row axis "
                "(rank >= 1)")
        pos = _align(pos, 64)
        packed.append((
            {"name": str(name),
             "datatype": np_to_wire_dtype(arr.dtype),
             "shape": list(arr.shape),
             "offset": pos,
             "byte_size": int(arr.nbytes)}, arr))
        pos += int(arr.nbytes)
    manifest = json.dumps([m for m, _ in packed]).encode("utf-8")
    payload_base = _align(DSET_MANIFEST_OFF + len(manifest), 4096)
    total = payload_base + pos
    path = _key_path(shm_key)
    existed = os.path.exists(path)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, total)
        map_ = mmap.mmap(fd, total)
    except Exception:
        os.close(fd)
        raise
    words = np.frombuffer(map_, dtype="<u8", count=DSET_MANIFEST_OFF // 8)
    words[:] = 0
    words[OFF_DSET_VERSION // 8] = DSET_VERSION
    words[OFF_DSET_TENSOR_COUNT // 8] = len(packed)
    words[OFF_DSET_MANIFEST_BYTES // 8] = len(manifest)
    words[OFF_DSET_PAYLOAD_BASE // 8] = payload_base
    words[OFF_DSET_TOTAL_BYTES // 8] = total
    map_[DSET_MANIFEST_OFF:DSET_MANIFEST_OFF + len(manifest)] = manifest
    for meta, arr in packed:
        start = payload_base + meta["offset"]
        map_[start:start + meta["byte_size"]] = arr.tobytes()
    # magic last: an attacher that sees it sees a complete dataset
    words[OFF_DSET_MAGIC // 8] = DSET_MAGIC
    return StagedDataset(shm_key, fd, map_, created=not existed)


class StagedDataset:
    """A mapped staged-dataset segment: manifest lookups, zero-copy
    tensor views, and descriptor packing for producers."""

    def __init__(self, key: str, fd: int, map_: mmap.mmap, *,
                 created: bool):
        self.key = key
        self._fd = fd
        self._map = map_
        self._created = created
        self._closed = False
        words = np.frombuffer(map_, dtype="<u8",
                              count=DSET_MANIFEST_OFF // 8)
        if int(words[OFF_DSET_MAGIC // 8]) != DSET_MAGIC:
            raise StagedDatasetError(
                f"'{key}' is not a staged-dataset segment (bad magic)")
        if int(words[OFF_DSET_VERSION // 8]) != DSET_VERSION:
            raise StagedDatasetError(
                f"dataset '{key}': unsupported version "
                f"{int(words[OFF_DSET_VERSION // 8])}")
        manifest_bytes = int(words[OFF_DSET_MANIFEST_BYTES // 8])
        self.payload_base = int(words[OFF_DSET_PAYLOAD_BASE // 8])
        self.total_bytes = int(words[OFF_DSET_TOTAL_BYTES // 8])
        raw = bytes(map_[DSET_MANIFEST_OFF:
                         DSET_MANIFEST_OFF + manifest_bytes])
        self.manifest: list[dict] = json.loads(raw.decode("utf-8"))
        self._index = {m["name"]: i for i, m in enumerate(self.manifest)}

    @classmethod
    def attach(cls, shm_key: str) -> "StagedDataset":
        path = _key_path(shm_key)
        if not os.path.exists(path):
            raise StagedDatasetError(
                f"staged dataset '{shm_key}' does not exist")
        fd = os.open(path, os.O_RDWR)
        try:
            map_ = mmap.mmap(fd, 0)
        except Exception:
            os.close(fd)
            raise
        try:
            return cls(shm_key, fd, map_, created=False)
        except Exception:
            try:
                map_.close()
            except BufferError:
                pass
            os.close(fd)
            raise

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._map.close()
        except BufferError:
            self._map = None   # outstanding tensor views; GC unmaps later
        if self._fd >= 0:
            fd, self._fd = self._fd, -1
            os.close(fd)
        if unlink and self._created:
            try:
                os.unlink(_key_path(self.key))
            except FileNotFoundError:
                pass

    def __enter__(self) -> "StagedDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close(unlink=True)

    # -- manifest lookups ----------------------------------------------------

    @property
    def names(self) -> list[str]:
        return [m["name"] for m in self.manifest]

    def index(self, tensor: str) -> int:
        idx = self._index.get(tensor)
        if idx is None:
            raise StagedDatasetError(
                f"dataset '{self.key}' has no tensor '{tensor}' "
                f"(has: {', '.join(self._index)})")
        return idx

    def rows(self, tensor: str) -> int:
        return int(self.manifest[self.index(tensor)]["shape"][0])

    def tensor(self, tensor: str) -> np.ndarray:
        """Zero-copy view of a whole manifest tensor."""
        m = self.manifest[self.index(tensor)]
        start = self.payload_base + int(m["offset"])
        view = memoryview(self._map)[start:start + int(m["byte_size"])]
        return np.frombuffer(view, dtype=wire_to_np_dtype(m["datatype"])
                             ).reshape(tuple(int(d) for d in m["shape"]))

    def descriptor(self, tensor: str, row_start: int,
                   row_count: int) -> bytes:
        """Pack (and bounds-check) one staged-input descriptor."""
        idx = self.index(tensor)
        n_rows = int(self.manifest[idx]["shape"][0])
        if row_start < 0 or row_count < 1 \
                or row_start + row_count > n_rows:
            raise StagedDatasetError(
                f"rows [{row_start}, {row_start + row_count}) outside "
                f"tensor '{tensor}' ({n_rows} rows)")
        return pack_descriptor(idx, row_start, row_count)


__all__ = [
    "DESCRIPTOR_BYTES",
    "DSET_MAGIC",
    "DSET_MANIFEST_OFF",
    "DSET_VERSION",
    "StagedDataset",
    "StagedDatasetError",
    "build_staged_dataset",
    "pack_descriptor",
    "unpack_descriptor",
]
