"""Server side of the staged-dataset segment (fourth shm data plane).

The port's copy of ``client_tpu/engine/staged.py``.
:class:`StagedDatasetManager` sits alongside the ring manager
(``engine.shmring``): producers build a read-only dataset segment once
per host (``client_tpu_torch.utils.shm_ring.staged``), register it by key
(``POST /v2/shm/dataset/<name>/register`` / the ``DatasetRegister``
RPC), and then reference rows of its tensors from ring slots by 24-byte
``(tensor_index, row_start, row_count)`` descriptors. :meth:`resolve`
turns a descriptor into a zero-copy row-slice view of the mapped
payload: however many producers share the dataset, a batch pays one
host copy (into the pinned staging buffer, ``Model.execute_timed``) and
one host-to-device copy.

Attach-time validation is strict and always a client error (400, never
500): bad magic, unsupported version, malformed manifest, unknown
dtypes, offset/byte_size tables that overlap or spill past the payload
all reject at register time, so a descriptor that names a registered
tensor can only fail on row range. An optional byte budget
(``CLIENT_TPU_STAGED_BUDGET``) caps the total payload bytes attached at
once — staged datasets are whole-dataset mappings, so the budget is the
operator's guard against a producer staging more than the host can
spare.
"""

from __future__ import annotations

import json
import os

import numpy as np

from client_tpu_torch import config as envcfg
from client_tpu_torch.engine.shm import _SysRegion, shm_path
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.protocol.dtypes import wire_to_np_dtype
from client_tpu_torch.utils.shm_ring.staged import (
    DSET_MAGIC,
    DSET_MANIFEST_OFF,
    DSET_VERSION,
    OFF_DSET_MAGIC,
    OFF_DSET_MANIFEST_BYTES,
    OFF_DSET_PAYLOAD_BASE,
    OFF_DSET_TENSOR_COUNT,
    OFF_DSET_TOTAL_BYTES,
    OFF_DSET_VERSION,
)
from client_tpu_torch.utils import lockdep

ENV_BUDGET = "CLIENT_TPU_STAGED_BUDGET"


class _Dataset:
    """One attached dataset: the mapped region, the validated manifest,
    and per-dataset accounting."""

    def __init__(self, name: str, key: str):
        path = shm_path(key)
        if not os.path.exists(path):
            raise EngineError(
                f"dataset '{name}': shm key '{key}' does not exist", 400)
        total = os.path.getsize(path)
        if total < DSET_MANIFEST_OFF:
            raise EngineError(
                f"dataset '{name}': segment smaller than the dataset "
                f"header ({total} < {DSET_MANIFEST_OFF})", 400)
        self.name = name
        self.key = key
        self.region = _SysRegion(name, key, 0, total)
        try:
            self._validate(total)
        except EngineError:
            self.region.close()
            raise
        self.refs = 0

    def _validate(self, total: int) -> None:
        words = np.frombuffer(self.region.map, dtype="<u8",
                              count=DSET_MANIFEST_OFF // 8)
        if int(words[OFF_DSET_MAGIC // 8]) != DSET_MAGIC:
            raise EngineError(
                f"dataset '{self.name}': '{self.key}' is not a "
                "staged-dataset segment (bad magic)", 400)
        if int(words[OFF_DSET_VERSION // 8]) != DSET_VERSION:
            raise EngineError(
                f"dataset '{self.name}': unsupported dataset version "
                f"{int(words[OFF_DSET_VERSION // 8])}", 400)
        manifest_bytes = int(words[OFF_DSET_MANIFEST_BYTES // 8])
        self.payload_base = int(words[OFF_DSET_PAYLOAD_BASE // 8])
        declared_total = int(words[OFF_DSET_TOTAL_BYTES // 8])
        tensor_count = int(words[OFF_DSET_TENSOR_COUNT // 8])
        if manifest_bytes < 2 \
                or DSET_MANIFEST_OFF + manifest_bytes > total:
            raise EngineError(
                f"dataset '{self.name}': manifest ({manifest_bytes}B) "
                "exceeds the segment", 400)
        if self.payload_base < DSET_MANIFEST_OFF + manifest_bytes \
                or self.payload_base > total or declared_total > total:
            raise EngineError(
                f"dataset '{self.name}': payload_base/total_bytes "
                "inconsistent with the segment size", 400)
        raw = bytes(self.region.map[DSET_MANIFEST_OFF:
                                    DSET_MANIFEST_OFF + manifest_bytes])
        try:
            manifest = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise EngineError(
                f"dataset '{self.name}': manifest is not valid JSON",
                400) from None
        if not isinstance(manifest, list) or not manifest \
                or len(manifest) != tensor_count:
            raise EngineError(
                f"dataset '{self.name}': manifest entry count does not "
                f"match tensor_count ({tensor_count})", 400)
        payload_room = total - self.payload_base
        spans = []
        for i, m in enumerate(manifest):
            if not isinstance(m, dict):
                raise EngineError(
                    f"dataset '{self.name}': manifest[{i}] is not an "
                    "object", 400)
            try:
                name = m["name"]
                datatype = m["datatype"]
                shape = [int(d) for d in m["shape"]]
                offset = int(m["offset"])
                byte_size = int(m["byte_size"])
            except (KeyError, TypeError, ValueError):
                raise EngineError(
                    f"dataset '{self.name}': manifest[{i}] is missing or "
                    "mistypes name/datatype/shape/offset/byte_size",
                    400) from None
            if datatype == "BYTES" \
                    or wire_to_np_dtype(datatype) is None:
                raise EngineError(
                    f"dataset '{self.name}': tensor '{name}' has "
                    f"unstageable datatype '{datatype}'", 400)
            if not shape or any(d < 0 for d in shape):
                raise EngineError(
                    f"dataset '{self.name}': tensor '{name}' needs a "
                    "non-negative rank>=1 shape", 400)
            expect = int(np.dtype(wire_to_np_dtype(datatype)).itemsize)
            for d in shape:
                expect *= d
            if byte_size != expect:
                raise EngineError(
                    f"dataset '{self.name}': tensor '{name}' byte_size "
                    f"{byte_size} does not match shape/dtype ({expect})",
                    400)
            if offset < 0 or offset + byte_size > payload_room:
                raise EngineError(
                    f"dataset '{self.name}': tensor '{name}' "
                    f"({offset}+{byte_size}B) spills past the payload "
                    f"({payload_room}B)", 400)
            spans.append((offset, offset + byte_size, name))
        spans.sort()
        for (s0, e0, n0), (s1, _e1, n1) in zip(spans, spans[1:]):
            if s1 < e0:
                raise EngineError(
                    f"dataset '{self.name}': tensors '{n0}' and '{n1}' "
                    "overlap in the payload", 400)
        self.manifest = manifest
        self.payload_bytes = sum(e - s for s, e, _ in spans)
        self.total_bytes = total

    def resolve(self, tensor_index: int, row_start: int,
                row_count: int) -> np.ndarray:
        """Zero-copy row-slice view for one descriptor."""
        if tensor_index < 0 or tensor_index >= len(self.manifest):
            raise EngineError(
                f"dataset '{self.name}': descriptor names tensor "
                f"{tensor_index} (has {len(self.manifest)})", 400)
        m = self.manifest[tensor_index]
        n_rows = int(m["shape"][0])
        if row_start < 0 or row_count < 1 \
                or row_start + row_count > n_rows:
            raise EngineError(
                f"dataset '{self.name}': rows [{row_start}, "
                f"{row_start + row_count}) outside tensor "
                f"'{m['name']}' ({n_rows} rows)", 400)
        row_bytes = int(m["byte_size"]) // max(1, n_rows)
        shape = [row_count] + [int(d) for d in m["shape"][1:]]
        return self.region.read_ndarray(
            self.payload_base + int(m["offset"]) + row_start * row_bytes,
            row_count * row_bytes, m["datatype"], shape)

    def close(self) -> None:
        self.region.close()


class StagedDatasetManager:
    """Registry + descriptor resolver for staged-dataset segments.

    ``registry``/``events`` bind the ``tpu_shm_dataset_*`` metric family
    and the journal; both optional so the manager stays usable
    standalone in tests.
    """

    def __init__(self, registry=None, events=None,
                 budget_bytes: int | None = None):
        self._datasets: dict[str, _Dataset] = {}
        self._lock = lockdep.Lock("shmstaged.manager")
        self._events = events
        self._budget = (envcfg.env_int(ENV_BUDGET)
                        if budget_bytes is None else int(budget_bytes))
        self._m_bytes = self._m_refs = None
        if registry is not None:
            self._m_bytes = registry.gauge(
                "tpu_shm_dataset_bytes",
                "Payload bytes of each attached staged dataset",
                ("dataset",))
            self._m_refs = registry.counter(
                "tpu_shm_dataset_refs_total",
                "Staged-input descriptors resolved per dataset",
                ("dataset",))

    # -- registration (mirrors the other shm managers) ----------------------

    def register(self, name: str, key: str) -> None:
        ds = _Dataset(name, key)
        with self._lock:
            if name in self._datasets:
                ds.close()
                raise EngineError(
                    f"dataset '{name}' already registered", 400)
            if self._budget > 0:
                held = sum(d.payload_bytes
                           for d in self._datasets.values())
                if held + ds.payload_bytes > self._budget:
                    ds.close()
                    raise EngineError(
                        f"dataset '{name}' ({ds.payload_bytes}B) exceeds "
                        f"the staged budget ({held}B of {self._budget}B "
                        "attached)", 400)
            self._datasets[name] = ds
        if self._m_bytes is not None:
            self._m_bytes.set(ds.payload_bytes, dataset=name)
        if self._events is not None:
            self._events.emit(
                "shm_dataset", "attach", dataset=name, key=key,
                tensors=len(ds.manifest),
                payload_bytes=ds.payload_bytes)

    def register_from_json(self, name: str, body: dict) -> None:
        key = body.get("key") if isinstance(body, dict) else None
        if not isinstance(key, str) or not key:
            raise EngineError(
                f"dataset '{name}': register body requires a string "
                "'key'", 400)
        self.register(name, key)

    def unregister(self, name: str | None) -> None:
        with self._lock:
            if name is None:
                datasets = list(self._datasets.items())
                self._datasets.clear()
            else:
                ds = self._datasets.pop(name, None)
                datasets = [(name, ds)] if ds is not None else []
        for ds_name, ds in datasets:
            ds.close()
            if self._m_bytes is not None:
                self._m_bytes.remove(dataset=ds_name)
            if self._events is not None:
                self._events.emit("shm_dataset", "detach",
                                  dataset=ds_name, refs=ds.refs)

    def has_region(self, name: str) -> bool:
        with self._lock:
            return name in self._datasets

    def status(self, name: str | None = None) -> dict:
        with self._lock:
            items = (
                self._datasets.items() if name is None
                else [(name, self._datasets[name])]
                if name in self._datasets else [])
            return {
                n: {"name": n, "key": d.key,
                    "tensors": [
                        {"name": m["name"], "datatype": m["datatype"],
                         "shape": m["shape"]} for m in d.manifest],
                    "payload_bytes": d.payload_bytes,
                    "total_bytes": d.total_bytes, "refs": d.refs}
                for n, d in items
            }

    def profile_table(self) -> dict:
        return self.status()

    # -- the descriptor data plane -------------------------------------------

    def resolve(self, name: str, tensor_index: int, row_start: int,
                row_count: int) -> np.ndarray:
        with self._lock:
            ds = self._datasets.get(name)
        if ds is None:
            raise EngineError(f"dataset '{name}' not registered", 400)
        arr = ds.resolve(tensor_index, row_start, row_count)
        ds.refs += 1
        if self._m_refs is not None:
            self._m_refs.inc(dataset=name)
        return arr


__all__ = ["StagedDatasetManager"]
