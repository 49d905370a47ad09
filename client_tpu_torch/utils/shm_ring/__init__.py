"""Client-side zero-copy shm slot ring (TensorSocket-style data plane).

The port's copy of ``client_tpu/utils/shm_ring/__init__.py``. The segment
layout below is the wire, byte for byte the JAX package's, so a producer
of either package feeds a server of either package.

A single POSIX shm segment holds a lock-free single-producer /
single-consumer ring of fixed-size tensor slots (PAPERS.md, arXiv
2409.18749): the co-located client serializes request tensors straight
into a slot, rings one **batched doorbell** over the ordinary HTTP/gRPC
control channel for a whole span of FILLED slots, and then polls the
slot state words in shm for completion — the engine writes each
response back into the slot's response region, so neither request nor
response bytes ever cross a socket.

Segment layout (all word fields are aligned little-endian uint64, so
single-word loads/stores are atomic under the GIL)::

    [ header page, HEADER_BYTES ]
      0   magic           RING_MAGIC ("TPURING1")
      8   version         RING_VERSION
      16  slot_count
      24  slot_bytes      request payload capacity per slot
      32  resp_bytes      response capacity per slot
      40  producer_pid    liveness word (written once at create)
      64  head            producer cursor (cumulative slots published)
      128 tail            producer cursor (cumulative slots released)
      192 heartbeat       producer-owned activity counter (own cache line)
    [ state area: slot_count words at STATE_STRIDE spacing ]
      per-slot state word: FREE -> FILLED -> IN_FLIGHT -> DONE -> FREE
    [ payload area: slot_count x (slot_bytes + resp_bytes) ]

head and tail sit on separate cache lines and are written ONLY by the
producer, so the full/empty check never races the server; the server
owns the FILLED->IN_FLIGHT->DONE state transitions. Release/acquire
ordering is by program order under the GIL: the producer writes the
payload before storing FILLED, the server stores DONE only after the
response bytes land, and each side reads the state word before touching
the payload it guards.
"""

from __future__ import annotations

import json
import mmap
import os
import time

import numpy as np

from client_tpu_torch.protocol.codec import deserialize_tensor, serialize_tensor
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype, wire_to_np_dtype

RING_MAGIC = 0x31474E4952555054          # b"TPURING1" little-endian
RING_VERSION = 1
HEADER_BYTES = 4096
STATE_STRIDE = 64                        # one cache line per state word

OFF_MAGIC = 0
OFF_VERSION = 8
OFF_SLOT_COUNT = 16
OFF_SLOT_BYTES = 24
OFF_RESP_BYTES = 32
OFF_PRODUCER_PID = 40
OFF_HEAD = 64
OFF_TAIL = 128
OFF_HEARTBEAT = 192

SLOT_FREE = 0
SLOT_FILLED = 1
SLOT_IN_FLIGHT = 2
SLOT_DONE = 3

STATE_NAMES = {SLOT_FREE: "FREE", SLOT_FILLED: "FILLED",
               SLOT_IN_FLIGHT: "IN_FLIGHT", SLOT_DONE: "DONE"}


class ShmRingError(Exception):
    pass


def _align64(n: int) -> int:
    return (int(n) + 63) & ~63


def ring_total_bytes(slot_count: int, slot_bytes: int,
                     resp_bytes: int) -> int:
    return (HEADER_BYTES + slot_count * STATE_STRIDE
            + slot_count * (slot_bytes + resp_bytes))


def _key_path(shm_key: str) -> str:
    return "/dev/shm/" + shm_key.lstrip("/")


class RingBuffer:
    """The mapped ring segment; producer-side cursor/state accessors.

    Word accessors go through a uint64 numpy view over the (8-aligned)
    header+state prefix of the mapping — aligned single-word loads and
    stores, which is the atomicity the SPSC protocol needs.
    """

    def __init__(self, key: str, fd: int, map_: mmap.mmap, *,
                 created: bool):
        self.key = key
        self._fd = fd
        self._map = map_
        self._created = created
        self._closed = False
        words = np.frombuffer(self._map, dtype="<u8",
                              count=HEADER_BYTES // 8)
        if int(words[OFF_MAGIC // 8]) != RING_MAGIC:
            raise ShmRingError(f"'{key}' is not a ring segment (bad magic)")
        if int(words[OFF_VERSION // 8]) != RING_VERSION:
            raise ShmRingError(
                f"ring '{key}': unsupported version "
                f"{int(words[OFF_VERSION // 8])}")
        self.slot_count = int(words[OFF_SLOT_COUNT // 8])
        self.slot_bytes = int(words[OFF_SLOT_BYTES // 8])
        self.resp_bytes = int(words[OFF_RESP_BYTES // 8])
        self.total_bytes = ring_total_bytes(
            self.slot_count, self.slot_bytes, self.resp_bytes)
        if len(self._map) < self.total_bytes:
            raise ShmRingError(
                f"ring '{key}': segment truncated "
                f"({len(self._map)} < {self.total_bytes})")
        self._words = np.frombuffer(
            self._map, dtype="<u8",
            count=(HEADER_BYTES + self.slot_count * STATE_STRIDE) // 8)

    # -- creation / attachment ----------------------------------------------

    @classmethod
    def create(cls, shm_key: str, slot_count: int, slot_bytes: int,
               resp_bytes: int) -> "RingBuffer":
        """Create (or re-initialize) the segment and write a fresh header."""
        if slot_count < 1:
            raise ShmRingError("slot_count must be >= 1")
        slot_bytes = _align64(slot_bytes)
        resp_bytes = _align64(resp_bytes)
        total = ring_total_bytes(slot_count, slot_bytes, resp_bytes)
        path = _key_path(shm_key)
        existed = os.path.exists(path)
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, total)
            map_ = mmap.mmap(fd, total)
        except Exception:
            os.close(fd)
            raise
        header = np.frombuffer(map_, dtype="<u8", count=HEADER_BYTES // 8)
        header[:] = 0
        header[OFF_SLOT_COUNT // 8] = slot_count
        header[OFF_SLOT_BYTES // 8] = slot_bytes
        header[OFF_RESP_BYTES // 8] = resp_bytes
        header[OFF_VERSION // 8] = RING_VERSION
        # state words before the magic: an attacher that sees the magic
        # must see a fully initialized ring
        states = np.frombuffer(
            map_, dtype="<u8", offset=HEADER_BYTES,
            count=slot_count * STATE_STRIDE // 8)
        states[:] = 0
        # Liveness word: the engine-side reaper probes this pid to fail
        # and detach rings whose producer died mid-fill.
        header[OFF_PRODUCER_PID // 8] = os.getpid()
        header[OFF_MAGIC // 8] = RING_MAGIC
        return cls(shm_key, fd, map_, created=not existed)

    @classmethod
    def attach(cls, shm_key: str) -> "RingBuffer":
        path = _key_path(shm_key)
        if not os.path.exists(path):
            raise ShmRingError(f"ring segment '{shm_key}' does not exist")
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
                pass  # a validation-path numpy view still holds the map
            os.close(fd)
            raise

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        self._words = None
        try:
            self._map.close()
        except BufferError:
            self._map = None   # outstanding views; GC unmaps later
        if self._fd >= 0:
            fd, self._fd = self._fd, -1
            os.close(fd)
        if unlink and self._created:
            try:
                os.unlink(_key_path(self.key))
            except FileNotFoundError:
                pass

    # -- word accessors ------------------------------------------------------

    @property
    def head(self) -> int:
        return int(self._words[OFF_HEAD // 8])

    @property
    def tail(self) -> int:
        return int(self._words[OFF_TAIL // 8])

    @property
    def occupancy(self) -> int:
        return self.head - self.tail

    @property
    def producer_pid(self) -> int:
        return int(self._words[OFF_PRODUCER_PID // 8])

    @property
    def heartbeat(self) -> int:
        return int(self._words[OFF_HEARTBEAT // 8])

    def beat(self) -> None:
        """Bump the producer activity counter (producer-owned word)."""
        self._words[OFF_HEARTBEAT // 8] += 1

    def _bump(self, word_off: int) -> None:
        self._words[word_off // 8] += 1

    def state(self, slot: int) -> int:
        return int(self._words[(HEADER_BYTES
                                + slot * STATE_STRIDE) // 8])

    def set_state(self, slot: int, value: int) -> None:
        self._words[(HEADER_BYTES + slot * STATE_STRIDE) // 8] = value

    # -- payload windows -----------------------------------------------------

    def _payload_base(self) -> int:
        return HEADER_BYTES + self.slot_count * STATE_STRIDE

    def request_offset(self, slot: int) -> int:
        """Byte offset of the slot's request region within the segment."""
        return self._payload_base() + slot * (self.slot_bytes
                                              + self.resp_bytes)

    def response_offset(self, slot: int) -> int:
        return self.request_offset(slot) + self.slot_bytes

    def request_view(self, slot: int) -> memoryview:
        off = self.request_offset(slot)
        return memoryview(self._map)[off:off + self.slot_bytes]

    def response_view(self, slot: int) -> memoryview:
        off = self.response_offset(slot)
        return memoryview(self._map)[off:off + self.resp_bytes]

    # -- producer protocol ---------------------------------------------------

    def acquire(self) -> int | None:
        """Next free slot index, or None when the ring is full."""
        if self.head - self.tail >= self.slot_count:
            return None
        slot = self.head % self.slot_count
        if self.state(slot) != SLOT_FREE:
            return None
        return slot

    def fill(self, inputs: dict) -> tuple[int, list] | None:
        """Serialize ``{name: ndarray}`` back-to-back into the next free
        slot and publish it (state FILLED, head+1). Returns
        ``(slot, meta)`` where meta is the per-input placement list the
        doorbell carries, or None on backpressure (ring full)."""
        slot = self.acquire()
        if slot is None:
            return None
        view = self.request_view(slot)
        meta = []
        pos = 0
        for name, arr in inputs.items():
            arr = np.asarray(arr)
            raw = serialize_tensor(arr, np_to_wire_dtype(arr.dtype))
            if pos + len(raw) > self.slot_bytes:
                raise ShmRingError(
                    f"inputs exceed slot_bytes ({self.slot_bytes})")
            view[pos:pos + len(raw)] = raw
            meta.append({"name": name,
                         "datatype": np_to_wire_dtype(arr.dtype),
                         "shape": list(arr.shape),
                         "offset": pos, "byte_size": len(raw)})
            pos += len(raw)
        self.set_state(slot, SLOT_FILLED)   # payload before state: release
        self._bump(OFF_HEAD)
        return slot, meta

    def fill_staged(self, dataset, refs: dict) -> tuple[int, list] | None:
        """Stage one request by *reference*: write a 24-byte
        ``(tensor, row_start, row_count)`` descriptor per input instead
        of tensor bytes. ``dataset`` is an attached
        :class:`~client_tpu_torch.utils.shm_ring.staged.StagedDataset` and
        ``refs`` maps ``{input_name: (tensor_name, row_start,
        row_count)}``. Returns ``(slot, meta)`` or None when the ring is
        full."""
        from client_tpu_torch.utils.shm_ring.staged import DESCRIPTOR_BYTES

        slot = self.acquire()
        if slot is None:
            return None
        view = self.request_view(slot)
        meta = []
        pos = 0
        for input_name, (tensor, row_start, row_count) in refs.items():
            desc = dataset.descriptor(tensor, row_start, row_count)
            if pos + DESCRIPTOR_BYTES > self.slot_bytes:
                raise ShmRingError(
                    f"descriptors exceed slot_bytes ({self.slot_bytes})")
            view[pos:pos + DESCRIPTOR_BYTES] = desc
            meta.append({"name": input_name, "staged": True,
                         "offset": pos, "byte_size": DESCRIPTOR_BYTES})
            pos += DESCRIPTOR_BYTES
        self.set_state(slot, SLOT_FILLED)   # payload before state: release
        self._bump(OFF_HEAD)
        return slot, meta

    def poll(self, timeout_s: float = 10.0,
             spin_sleep_s: float | None = None) -> int:
        """Block until the OLDEST outstanding slot completes; returns its
        index. Release order is ring order, which keeps head/tail exact.

        ``spin_sleep_s=None`` (default) spins a short bounded burst and
        then backs off to 100 us sleeps: the producer shares a machine —
        and under an in-process server, a GIL — with the engine, so an
        unbounded pure spin slows down the very completions it is waiting
        for. Pass ``0.0`` to force a pure spin (dedicated-core setups) or
        an explicit sleep interval to fix the backoff."""
        if self.head == self.tail:
            raise ShmRingError("poll() with no outstanding slots")
        slot = self.tail % self.slot_count
        deadline = time.monotonic() + timeout_s
        spins = 0
        while self.state(slot) != SLOT_DONE:
            if time.monotonic() >= deadline:
                raise ShmRingError(
                    f"slot {slot} not DONE after {timeout_s}s "
                    f"(state {STATE_NAMES.get(self.state(slot))})")
            if spin_sleep_s is None:
                spins += 1
                if spins > 256:
                    time.sleep(100e-6)
            elif spin_sleep_s:
                time.sleep(spin_sleep_s)
        return slot

    def read_response(self, slot: int, copy: bool = True):
        """Decode a DONE slot's response region ->
        ``(outputs: {name: ndarray}, error: str | None)``. With
        ``copy=False`` fixed-size outputs are zero-copy views valid only
        until :meth:`release`."""
        view = self.response_view(slot)
        hlen = int(np.frombuffer(view[:8], dtype="<u8")[0])
        if hlen <= 0 or 8 + hlen > self.resp_bytes:
            raise ShmRingError(
                f"slot {slot}: corrupt response header ({hlen}B)")
        header = json.loads(bytes(view[8:8 + hlen]).decode("utf-8"))
        if header.get("error"):
            return {}, header["error"]
        outputs = {}
        pos = 8 + hlen
        for out in header.get("outputs", []):
            raw = view[pos:pos + int(out["byte_size"])]
            if out["datatype"] == "BYTES":
                arr = deserialize_tensor(bytes(raw), "BYTES", out["shape"])
            else:
                arr = np.frombuffer(
                    raw, dtype=wire_to_np_dtype(out["datatype"])
                ).reshape(tuple(int(d) for d in out["shape"]))
                if copy:
                    arr = arr.copy()
            outputs[out["name"]] = arr
            pos += int(out["byte_size"])
        return outputs, None

    def release(self, slot: int) -> None:
        """Hand a consumed DONE slot back to the pool (state FREE,
        tail+1). Must be called in poll() order."""
        if slot != self.tail % self.slot_count:
            raise ShmRingError(
                f"release out of order: slot {slot}, expected "
                f"{self.tail % self.slot_count}")
        self.set_state(slot, SLOT_FREE)
        self._bump(OFF_TAIL)


class RingProducer:
    """Context manager pairing a :class:`RingBuffer` with a client's ring
    control surface (``register_shm_ring`` / ``ring_doorbell`` /
    ``unregister_shm_ring`` — both Python clients provide these)::

        with RingProducer(client, "ring0", "/tpu_ring0",
                          slot_count=64, slot_bytes=1 << 20) as prod:
            prod.fill({"INPUT": img})
            prod.doorbell("resnet50")
            slot, outputs, err = prod.reap()

    ``fill`` accumulates a pending span; ``doorbell`` submits it in one
    control-channel round trip; ``reap`` polls shm for the oldest
    completion. One producer per ring (SPSC) — many producers per host
    mean many rings, multiplexed server-side by the reaper.

    Fan-in extensions:

    * ``dataset=`` (an attached :class:`staged.StagedDataset`) +
      ``dataset_name=`` (its server-registered name) arm
      :meth:`fill_staged`, which stages 24-byte row descriptors instead
      of tensor bytes;
    * ``spec=`` registers the ring in **reaped mode**: the span spec
      (``model_name``, ``inputs`` metadata, optional
      ``outputs``/``timeout_ms``/``priority``/``dataset``) is fixed at
      register time, the engine-side reaper sweeps FILLED slots without
      any doorbell call, and :meth:`doorbell` becomes invalid.
    """

    def __init__(self, client, name: str, shm_key: str, *,
                 slot_count: int = 64, slot_bytes: int = 1 << 20,
                 resp_bytes: int | None = None, dataset=None,
                 dataset_name: str | None = None,
                 spec: dict | None = None):
        self._client = client
        self.name = name
        self.shm_key = shm_key
        self._slot_count = slot_count
        self._slot_bytes = slot_bytes
        self._resp_bytes = (slot_bytes + 4096 if resp_bytes is None
                            else resp_bytes)
        self._dataset = dataset
        self._dataset_name = dataset_name
        self._spec = dict(spec) if spec is not None else None
        self.ring: RingBuffer | None = None
        self._pending: list[int] = []
        self._meta: list | None = None

    @property
    def reaped(self) -> bool:
        return self._spec is not None

    def __enter__(self) -> "RingProducer":
        self.ring = RingBuffer.create(
            self.shm_key, self._slot_count, self._slot_bytes,
            self._resp_bytes)
        try:
            if self._spec is not None:
                self._client.register_shm_ring(self.name, self.shm_key,
                                               spec=self._spec)
            else:
                self._client.register_shm_ring(self.name, self.shm_key)
        except Exception:
            self.ring.close(unlink=True)
            self.ring = None
            raise
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._client.unregister_shm_ring(self.name)
        except Exception:
            pass
        if self.ring is not None:
            self.ring.close(unlink=True)
            self.ring = None

    def fill(self, inputs: dict) -> int | None:
        """Stage one request into the next free slot; None = ring full
        (reap completions, then retry). All requests in one doorbell span
        must share tensor names/shapes/dtypes."""
        filled = self.ring.fill(inputs)
        if filled is None:
            return None
        slot, meta = filled
        if self._spec is None:
            # doorbell mode: accumulate the span (a reaped ring's spans
            # are swept server-side; nothing to accumulate)
            if self._meta is None:
                self._meta = meta
            self._pending.append(slot)
        self.ring.beat()
        return slot

    def fill_staged(self, refs: dict) -> int | None:
        """Stage one request by staged-dataset reference:
        ``{input_name: (tensor_name, row_start, row_count)}`` against
        the producer's ``dataset=``. None = ring full."""
        if self._dataset is None:
            raise ShmRingError(
                "fill_staged needs RingProducer(dataset=...)")
        filled = self.ring.fill_staged(self._dataset, refs)
        if filled is None:
            return None
        slot, meta = filled
        if self._spec is None:
            if self._meta is None:
                self._meta = meta
            self._pending.append(slot)
        self.ring.beat()
        return slot

    def doorbell(self, model_name: str, model_version: str = "", *,
                 outputs=None, timeout_ms: float = 0.0,
                 priority: int = 0, tenant: str = "",
                 headers=None) -> dict:
        """Submit the pending span in one control-channel round trip."""
        if self._spec is not None:
            raise ShmRingError(
                f"ring '{self.name}' is reaped — the engine sweeps "
                "FILLED slots; no doorbell needed")
        if not self._pending:
            return {"admitted": 0, "rejected": 0}
        spec = {
            "start": self._pending[0],
            "count": len(self._pending),
            "model_name": model_name,
            "model_version": model_version,
            "inputs": self._meta,
        }
        if any(m.get("staged") for m in self._meta):
            if not self._dataset_name:
                raise ShmRingError(
                    "staged fills need RingProducer(dataset_name=...) — "
                    "the server-registered dataset name")
            spec["dataset"] = self._dataset_name
        if outputs:
            spec["outputs"] = list(outputs)
        if timeout_ms:
            spec["timeout_ms"] = float(timeout_ms)
        if priority:
            spec["priority"] = int(priority)
        if tenant:
            # Cost-ledger tenant tag — the shm analogue of the HTTP
            # X-Tpu-Tenant header (rides in the span spec slot header).
            spec["tenant"] = str(tenant)
        self._pending = []
        self._meta = None
        return self._client.ring_doorbell(self.name, spec, headers=headers)

    def reap(self, timeout_s: float = 10.0, copy: bool = True,
             spin_sleep_s: float | None = None):
        """Wait for the oldest outstanding slot; returns
        ``(slot, outputs, error)`` with the slot released.
        ``spin_sleep_s`` is forwarded to :meth:`RingBuffer.poll` —
        background/shadow producers should pass a coarse interval
        (milliseconds): they don't need reap latency, and a fleet of
        them at the default 100 us backoff measurably steals host CPU
        from the live plane it is supposed to shadow."""
        slot = self.ring.poll(timeout_s=timeout_s,
                              spin_sleep_s=spin_sleep_s)
        outputs, error = self.ring.read_response(slot, copy=copy)
        self.ring.release(slot)
        self.ring.beat()
        return slot, outputs, error

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def outstanding(self) -> int:
        """Slots published but not yet released (includes pending)."""
        return self.ring.occupancy if self.ring is not None else 0


def staged_inputs_meta(refs: dict) -> list[dict]:
    """The ``inputs`` metadata a span of :meth:`RingBuffer.fill_staged`
    fills with the same ``refs`` structure will carry — for building a
    reaped-mode register ``spec`` before the first fill."""
    from client_tpu_torch.utils.shm_ring.staged import DESCRIPTOR_BYTES

    return [{"name": input_name, "staged": True,
             "offset": i * DESCRIPTOR_BYTES,
             "byte_size": DESCRIPTOR_BYTES}
            for i, input_name in enumerate(refs)]


__all__ = [
    "HEADER_BYTES", "RING_MAGIC", "RING_VERSION", "STATE_STRIDE",
    "OFF_PRODUCER_PID", "OFF_HEARTBEAT",
    "SLOT_FREE", "SLOT_FILLED", "SLOT_IN_FLIGHT", "SLOT_DONE",
    "RingBuffer", "RingProducer", "ShmRingError", "ring_total_bytes",
    "staged_inputs_meta",
]
