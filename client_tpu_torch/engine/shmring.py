"""Server side of the zero-copy shm slot ring (TensorSocket-style).

The port's copy of ``client_tpu/engine/shmring.py``.
:class:`RingShmManager` sits alongside ``SystemShmManager`` /
``CudaShmManager`` as the third shared-memory data plane:
a co-located producer creates the segment with
``client_tpu_torch.utils.shm_ring`` and registers it by key; each **batched
doorbell** (``POST /v2/shm/ring/<name>/doorbell`` or the ``RingDoorbell``
RPC) names a contiguous span of FILLED slots plus the span's shared
tensor metadata, and every slot is admitted as a normal
:class:`InferRequest` whose input tensors are zero-copy
``np.frombuffer`` views into the slot (via ``_SysRegion.read_view``).
On the card the batch's staging (``Model.execute_timed``) copies such a
view once, into a pinned buffer, and from there once to the card: a
request pays one host copy and one host-to-device copy, and no tensor
byte crosses a socket.
Outputs are written back into the slot's response region and completion
is flagged through the slot state word, so the producer polls shm for
results instead of holding N HTTP responses open.

Many-producer fan-in (the fourth data plane, with ``engine.staged``):

* A slot input flagged ``{"staged": true}`` holds a 24-byte
  ``(tensor_index, row_start, row_count)`` descriptor instead of tensor
  bytes; the span spec names the registered ``dataset`` and the
  descriptor resolves to a zero-copy row slice of the shared
  staged-dataset segment — N producers replay one in-memory dataset
  without N copies.
* A ring registered with a ``spec`` runs in **reaped mode**: the span
  spec is fixed at register time and one engine-side :class:`_Reaper`
  thread multiplexes every reaped ring, sweeping FILLED slots
  round-robin with a per-ring span cap (``CLIENT_TPU_SHM_REAPER_SPAN``)
  so one hot producer cannot starve the rest. The reaper also probes
  each ring's producer-pid liveness word: a dead producer's IN_FLIGHT
  slots are failed and the ring detached, journaled as
  ``shm_ring.producer_dead``.

Ownership split (see ``client_tpu_torch.utils.shm_ring`` for the layout): the
producer owns head/tail and the FREE->FILLED and DONE->FREE state
transitions; this manager owns FILLED->IN_FLIGHT->DONE. Response bytes
land before the DONE store, and slot payloads are only read after the
FILLED observation — program order under the GIL gives the
release/acquire pairing on the aligned uint64 words.

Slot response region wire format::

    [uint64 header_len][JSON header][raw tensor bytes back-to-back]
    header = {"outputs": [{"name","datatype","shape","byte_size"}, ...],
              "error": null | "message"}

Raw tensor bytes use the same ``serialize_tensor`` codec as the binary
HTTP path, which is what makes ring-path outputs byte-identical to it.
An output the engine still holds on the card is fetched to the host
(a synchronous copy) before its bytes are written, so the DONE store
never precedes the bytes it guards.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from client_tpu_torch import config as envcfg
from client_tpu_torch import faults as _faults

from client_tpu_torch.engine.shm import _SysRegion, shm_path
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    OutputRequest,
)
from client_tpu_torch.protocol.codec import serialize_tensor
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.protocol.pushback import format_slot_error
from client_tpu_torch.utils.shm_ring import (
    HEADER_BYTES,
    OFF_HEAD,
    OFF_HEARTBEAT,
    OFF_MAGIC,
    OFF_PRODUCER_PID,
    OFF_RESP_BYTES,
    OFF_SLOT_BYTES,
    OFF_SLOT_COUNT,
    OFF_TAIL,
    OFF_VERSION,
    RING_MAGIC,
    RING_VERSION,
    SLOT_DONE,
    SLOT_FILLED,
    SLOT_IN_FLIGHT,
    STATE_STRIDE,
    ring_total_bytes,
)
from client_tpu_torch.utils import lockdep
from client_tpu_torch.utils.shm_ring.staged import DESCRIPTOR_BYTES

# Span-size histogram buckets: the doorbell's whole point is amortizing
# the control-channel round trip, so the interesting range is 1..slots.
_SPAN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

ENV_REAPER_INTERVAL = "CLIENT_TPU_SHM_REAPER_INTERVAL_MS"
ENV_REAPER_SPAN = "CLIENT_TPU_SHM_REAPER_SPAN"

FAULT_SITE = "shmring.doorbell"


def _host_array(arr) -> np.ndarray:
    """The output as host bytes: a tensor (on the card with
    ``keep_outputs_on_device``) is copied to the host, and the copy has
    completed when this returns."""
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class _Ring:
    """One attached ring: the mapped region plus word accessors and
    per-ring accounting (doorbells, slot outcomes, reaped-mode spec)."""

    def __init__(self, name: str, key: str):
        path = shm_path(key)
        if not os.path.exists(path):
            raise EngineError(
                f"ring '{name}': shm key '{key}' does not exist", 400)
        total = os.path.getsize(path)
        if total < HEADER_BYTES:
            raise EngineError(
                f"ring '{name}': segment smaller than the ring header "
                f"({total} < {HEADER_BYTES})", 400)
        self.name = name
        self.key = key
        self.region = _SysRegion(name, key, 0, total)
        words = np.frombuffer(self.region.map, dtype="<u8",
                              count=HEADER_BYTES // 8)
        if int(words[OFF_MAGIC // 8]) != RING_MAGIC:
            self.region.close()
            raise EngineError(
                f"ring '{name}': '{key}' is not a ring segment "
                "(bad magic)", 400)
        if int(words[OFF_VERSION // 8]) != RING_VERSION:
            self.region.close()
            raise EngineError(
                f"ring '{name}': unsupported ring version "
                f"{int(words[OFF_VERSION // 8])}", 400)
        self.slot_count = int(words[OFF_SLOT_COUNT // 8])
        self.slot_bytes = int(words[OFF_SLOT_BYTES // 8])
        self.resp_bytes = int(words[OFF_RESP_BYTES // 8])
        if (self.slot_count < 1
                or total < ring_total_bytes(self.slot_count,
                                            self.slot_bytes,
                                            self.resp_bytes)):
            self.region.close()
            raise EngineError(
                f"ring '{name}': geometry exceeds segment size", 400)
        self._words = np.frombuffer(
            self.region.map, dtype="<u8",
            count=(HEADER_BYTES + self.slot_count * STATE_STRIDE) // 8)
        # Serializes completion writes against detach; slot payloads are
        # disjoint, so concurrent completions need no ordering among
        # themselves.
        self.lock = lockdep.Lock("shmring.ring")
        self.closed = False
        # Reaped-mode state: the register-time span spec (None for
        # explicit-doorbell rings) and the server-side sweep cursor —
        # cumulative like head/tail, touched only by the reaper thread.
        self.spec: dict | None = None
        self.swept = self.tail
        # Slots this manager holds IN_FLIGHT (guarded by ``lock``): the
        # detach path fails them instead of leaving the producer polling
        # a state word that will never store DONE.
        self.inflight_slots: set[int] = set()
        self.doorbells = 0
        self.slots_ok = 0
        self.slots_error = 0
        self.slots_backpressured = 0
        self.slots_skipped = 0
        self.reap_slots = 0

    # -- ring words ----------------------------------------------------------

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

    def state(self, slot: int) -> int:
        return int(self._words[(HEADER_BYTES
                                + slot * STATE_STRIDE) // 8])

    def set_state(self, slot: int, value: int) -> None:
        self._words[(HEADER_BYTES + slot * STATE_STRIDE) // 8] = value

    # -- slot I/O ------------------------------------------------------------

    def request_offset(self, slot: int) -> int:
        return (HEADER_BYTES + self.slot_count * STATE_STRIDE
                + slot * (self.slot_bytes + self.resp_bytes))

    def read_inputs(self, slot: int, metas: list[dict],
                    resolve=None) -> dict:
        """Zero-copy input views for one slot (``_SysRegion.read_view``
        under ``read_ndarray``; BYTES tensors decode, fixed dtypes are
        frombuffer views; the batch's staging makes the one copy).
        Inputs flagged ``staged`` hold a 24-byte dataset descriptor and
        go through ``resolve(tensor_index, row_start, row_count)``."""
        base = self.request_offset(slot)
        inputs = {}
        for m in metas:
            off = int(m.get("offset", 0))
            size = int(m["byte_size"])
            if off < 0 or off + size > self.slot_bytes:
                raise EngineError(
                    f"ring '{self.name}': input '{m.get('name')}' "
                    f"({off}+{size}B) exceeds slot_bytes "
                    f"({self.slot_bytes})", 400)
            if m.get("staged"):
                if resolve is None:
                    raise EngineError(
                        f"ring '{self.name}': staged input "
                        f"'{m.get('name')}' without a dataset", 400)
                if size != DESCRIPTOR_BYTES:
                    raise EngineError(
                        f"ring '{self.name}': staged input "
                        f"'{m.get('name')}' descriptor must be "
                        f"{DESCRIPTOR_BYTES}B (got {size})", 400)
                words = np.frombuffer(
                    bytes(self.region.read_view(base + off,
                                                DESCRIPTOR_BYTES)),
                    dtype="<u8")
                inputs[m["name"]] = resolve(
                    int(words[0]), int(words[1]), int(words[2]))
            else:
                inputs[m["name"]] = self.region.read_ndarray(
                    base + off, size, m["datatype"], m["shape"])
        return inputs

    def write_response(self, slot: int, outputs: dict | None,
                       error: str | None) -> bool:
        """Serialize a completion into the slot's response region and
        store DONE. Returns False when the payload overflows resp_bytes
        (the slot then carries an overflow *error* response instead)."""
        fit = True
        raws: list[tuple[dict, bytes]] = []
        if error is None:
            for out_name, arr in (outputs or {}).items():
                arr = _host_array(arr)
                raw = serialize_tensor(arr, np_to_wire_dtype(arr.dtype))
                raws.append(({"name": out_name,
                              "datatype": np_to_wire_dtype(arr.dtype),
                              "shape": list(arr.shape),
                              "byte_size": len(raw)}, raw))
            header = json.dumps({"outputs": [m for m, _ in raws],
                                 "error": None}).encode("utf-8")
            total = 8 + len(header) + sum(len(r) for _, r in raws)
            if total > self.resp_bytes:
                error = (f"response ({total}B) exceeds ring resp_bytes "
                         f"({self.resp_bytes})")
                fit = False
        if error is not None:
            raws = []
            header = json.dumps({"outputs": [],
                                 "error": str(error)}).encode("utf-8")
            if 8 + len(header) > self.resp_bytes:
                header = json.dumps(
                    {"outputs": [], "error": "response overflow"}
                ).encode("utf-8")
        with self.lock:
            if self.closed:
                return fit
            base = self.region.offset + self.request_offset(slot) \
                + self.slot_bytes
            m = self.region.map
            m[base:base + 8] = np.uint64(len(header)).tobytes()
            pos = base + 8
            m[pos:pos + len(header)] = header
            pos += len(header)
            for _, raw in raws:
                m[pos:pos + len(raw)] = raw
                pos += len(raw)
            self.set_state(slot, SLOT_DONE)   # bytes first, then DONE
        return fit

    def close(self) -> None:
        with self.lock:
            self.closed = True
            self.region.close()


class _Reaper:
    """The engine-side multi-ring reaper: ONE daemon thread sweeping
    every reaped ring's FILLED slots round-robin. Exits on its stop
    event (manager shutdown) or when the last reaped ring detaches —
    the manager restarts a fresh reaper on the next reaped register."""

    def __init__(self, manager: "RingShmManager", interval_s: float,
                 span_cap: int):
        self._manager = manager
        self._interval_s = max(1e-4, float(interval_s))
        self._span_cap = max(1, int(span_cap))
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="shmring-reaper", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread.is_alive() \
                and threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            swept = self._manager._sweep_once(self._span_cap)
            if self._manager._reaper_should_exit(self):
                return
            if swept == 0:
                self._stop_evt.wait(self._interval_s)


class RingShmManager:
    """Registry + doorbell executor + reaper host for shm slot rings.

    ``registry``/``events`` bind the ``tpu_shm_ring_*`` /
    ``tpu_shm_reaper_*`` metric families and the journal; ``datasets``
    is the engine's :class:`~client_tpu_torch.engine.staged
    .StagedDatasetManager` (staged descriptor resolution) and
    ``submit`` its ``async_infer`` (reaped-mode admission). All optional
    so the manager stays usable standalone in tests.
    """

    def __init__(self, registry=None, events=None, datasets=None,
                 submit=None, reaper_interval_s: float | None = None,
                 reaper_span: int | None = None):
        self._rings: dict[str, _Ring] = {}
        self._lock = lockdep.Lock("shmring.manager")
        self._events = events
        self._datasets = datasets
        self._submit = submit
        self._reaper: _Reaper | None = None
        self._rr = 0
        self._reaper_interval_s = (
            envcfg.env_float(ENV_REAPER_INTERVAL) / 1000.0
            if reaper_interval_s is None else float(reaper_interval_s))
        self._reaper_span = (envcfg.env_int(ENV_REAPER_SPAN)
                             if reaper_span is None else int(reaper_span))
        self._m_doorbells = self._m_slots = None
        self._m_occupancy = self._m_span = None
        self._m_reaper_sweeps = self._m_reaper_slots = None
        self._m_reaper_rings = self._m_reaper_dead = None
        if registry is not None:
            self._m_doorbells = registry.counter(
                "tpu_shm_ring_doorbells_total",
                "Batched ring doorbells received", ("ring",))
            self._m_slots = registry.counter(
                "tpu_shm_ring_slots_total",
                "Ring slots processed by outcome "
                "(ok|error|backpressured|skipped|detached)",
                ("ring", "outcome"))
            self._m_occupancy = registry.gauge(
                "tpu_shm_ring_occupancy",
                "Slots published but not yet released (head - tail)",
                ("ring",))
            self._m_span = registry.histogram(
                "tpu_shm_ring_doorbell_span",
                "Slots named per doorbell", ("ring",),
                buckets=_SPAN_BUCKETS)
            self._m_reaper_sweeps = registry.counter(
                "tpu_shm_reaper_sweeps_total",
                "Reaper passes over the reaped-ring set")
            self._m_reaper_slots = registry.counter(
                "tpu_shm_reaper_slots_total",
                "Slots admitted by the reaper per ring", ("ring",))
            self._m_reaper_rings = registry.gauge(
                "tpu_shm_reaper_rings",
                "Rings currently registered in reaped mode")
            self._m_reaper_dead = registry.counter(
                "tpu_shm_reaper_dead_producers_total",
                "Rings reclaimed after their producer died", ("ring",))

    # -- registration (mirrors the other shm managers) ----------------------

    def register(self, name: str, key: str,
                 spec: dict | None = None) -> None:
        parsed = None
        if spec is not None:
            if self._submit is None:
                raise EngineError(
                    f"ring '{name}': reaped mode needs an engine-bound "
                    "manager (no submit path)", 400)
            parsed = self._parse_spec(name, spec, reaped=True)
        ring = _Ring(name, key)
        if parsed is not None:
            ring.spec = parsed
        with self._lock:
            if name in self._rings:
                ring.close()
                raise EngineError(
                    f"ring '{name}' already registered", 400)
            self._rings[name] = ring
        if parsed is not None:
            self._ensure_reaper()
        self._update_reaper_gauge()
        if self._events is not None:
            self._events.emit(
                "shm_ring", "attach", ring=name, key=key,
                slot_count=ring.slot_count, slot_bytes=ring.slot_bytes,
                resp_bytes=ring.resp_bytes, reaped=parsed is not None,
                producer_pid=ring.producer_pid or None)

    def register_from_json(self, name: str, body: dict) -> None:
        key = body.get("key") if isinstance(body, dict) else None
        if not isinstance(key, str) or not key:
            raise EngineError(
                f"ring '{name}': register body requires a string 'key'",
                400)
        spec = body.get("spec")
        if spec is not None and not isinstance(spec, dict):
            raise EngineError(
                f"ring '{name}': register 'spec' must be an object", 400)
        self.register(name, key, spec=spec)

    def unregister(self, name: str | None) -> None:
        with self._lock:
            if name is None:
                rings = list(self._rings.items())
                self._rings.clear()
            else:
                ring = self._rings.pop(name, None)
                rings = [(name, ring)] if ring is not None else []
        for ring_name, ring in rings:
            # Satellite of the detach contract: a doorbell span the
            # engine still holds IN_FLIGHT is failed into the slots
            # BEFORE the mapping closes — the producer observes DONE +
            # error instead of polling a state word forever.
            failed = self._fail_inflight(
                ring, "ring detached with request in flight")
            ring.close()
            if self._m_occupancy is not None:
                # A detached ring's last-scraped occupancy must not render
                # stale forever.
                self._m_occupancy.remove(ring=ring_name)
            if self._events is not None:
                self._events.emit("shm_ring", "detach", ring=ring_name,
                                  doorbells=ring.doorbells,
                                  slots_ok=ring.slots_ok,
                                  slots_error=ring.slots_error)
                if failed:
                    self._events.emit(
                        "shm_ring", "detach_inflight",
                        severity="WARNING", ring=ring_name,
                        slots=failed)
        self._update_reaper_gauge()

    def has_region(self, name: str) -> bool:
        with self._lock:
            return name in self._rings

    def status(self, name: str | None = None) -> dict:
        with self._lock:
            items = (
                self._rings.items() if name is None
                else [(name, self._rings[name])] if name in self._rings
                else [])
            return {n: self._ring_row(r) for n, r in items}

    @staticmethod
    def _ring_row(r: _Ring) -> dict:
        occ = r.occupancy
        return {
            "name": r.name, "key": r.key,
            "slot_count": r.slot_count, "slot_bytes": r.slot_bytes,
            "resp_bytes": r.resp_bytes,
            "head": r.head, "tail": r.tail, "occupancy": occ,
            "fill": round(occ / r.slot_count, 4) if r.slot_count else 0.0,
            "doorbells": r.doorbells,
            "slots_ok": r.slots_ok, "slots_error": r.slots_error,
            "slots_backpressured": r.slots_backpressured,
            "slots_skipped": r.slots_skipped,
            "reaped": r.spec is not None,
            "swept": r.swept, "reap_slots": r.reap_slots,
            "producer_pid": r.producer_pid,
            "heartbeat": r.heartbeat,
        }

    def profile_table(self) -> dict:
        """The ``/v2/profile`` per-ring occupancy/backpressure table."""
        return self.status()

    def update_gauges(self) -> None:
        """Refresh occupancy gauges (called at metrics scrape time)."""
        if self._m_occupancy is None:
            return
        with self._lock:
            rings = list(self._rings.values())
        for r in rings:
            self._m_occupancy.set(r.occupancy, ring=r.name)
        self._update_reaper_gauge()

    def _update_reaper_gauge(self) -> None:
        if self._m_reaper_rings is None:
            return
        with self._lock:
            reaped = sum(1 for r in self._rings.values()
                         if r.spec is not None)
        self._m_reaper_rings.set(reaped)

    def _get(self, name: str) -> _Ring:
        with self._lock:
            ring = self._rings.get(name)
        if ring is None:
            raise EngineError(f"ring '{name}' not registered", 400)
        return ring

    # -- span spec parsing (shared by doorbell and reaped register) ---------

    def _parse_spec(self, ring_name: str, spec: dict,
                    reaped: bool = False) -> dict:
        try:
            metas = list(spec["inputs"])
            model_name = spec["model_name"]
        except (KeyError, TypeError, ValueError):
            what = "reaped spec" if reaped else "doorbell"
            raise EngineError(
                f"{what} requires model_name and inputs metadata",
                400) from None
        if not metas or not all(isinstance(m, dict) for m in metas):
            raise EngineError(
                f"ring '{ring_name}': span names no input tensors", 400)
        dataset = spec.get("dataset") or None
        if any(m.get("staged") for m in metas):
            if not dataset:
                raise EngineError(
                    f"ring '{ring_name}': staged inputs need the span "
                    "spec to name a registered 'dataset'", 400)
            if self._datasets is None:
                raise EngineError(
                    f"ring '{ring_name}': no staged-dataset manager "
                    "bound", 400)
        return {
            "metas": metas,
            "model_name": model_name,
            "model_version": spec.get("model_version", "") or "",
            "out_names": list(spec.get("outputs") or []),
            "timeout_ms": float(spec.get("timeout_ms", 0) or 0),
            "priority": int(spec.get("priority", 0) or 0),
            "tenant": str(spec.get("tenant", "") or ""),
            "dataset": dataset,
        }

    def _resolver(self, dataset: str | None):
        if dataset is None:
            return None

        def resolve(tensor_index: int, row_start: int,
                    row_count: int):
            return self._datasets.resolve(dataset, tensor_index,
                                          row_start, row_count)
        return resolve

    # -- the doorbell --------------------------------------------------------

    def doorbell(self, name: str, spec: dict) -> dict:
        """Admit a contiguous span of FILLED slots as InferRequests
        through the manager's ``submit``. Per-slot failures (admission
        shed, validation, model errors) are written into that slot's
        response region and flagged DONE — the doorbell call itself only
        fails on malformed specs, so one bad slot never voids the span.
        Returns ``{"admitted", "rejected", "skipped"}``.
        """
        try:
            _faults.fire(FAULT_SITE)
        except _faults.FaultInjected as exc:
            raise EngineError(str(exc), exc.status or 503) from None
        ring = self._get(name)
        if self._submit is None:
            raise EngineError(
                f"ring '{name}': a doorbell needs an engine-bound manager "
                "(no submit path)", 400)
        if ring.spec is not None:
            raise EngineError(
                f"ring '{name}' is reaped — the engine sweeps FILLED "
                "slots; explicit doorbells would double-admit", 400)
        parsed = self._parse_spec(name, spec)
        try:
            start = int(spec["start"])
            count = int(spec["count"])
        except (KeyError, TypeError, ValueError):
            raise EngineError(
                "doorbell requires start, count, model_name and "
                "inputs metadata", 400) from None
        if count < 1 or count > ring.slot_count:
            raise EngineError(
                f"doorbell span {count} outside 1..{ring.slot_count}", 400)
        if start < 0 or start >= ring.slot_count:
            raise EngineError(
                f"doorbell start {start} outside ring "
                f"(slot_count {ring.slot_count})", 400)
        ring.doorbells += 1
        if self._m_doorbells is not None:
            self._m_doorbells.inc(ring=name)
            self._m_span.observe(count, ring=name)
        admitted = rejected = skipped = 0
        backpressured = 0
        for k in range(count):
            slot = (start + k) % ring.slot_count
            outcome = self._admit_slot(ring, slot, parsed)
            if outcome == "admitted":
                admitted += 1
            elif outcome == "skipped":
                skipped += 1
            else:
                rejected += 1
                if outcome == "backpressured":
                    backpressured += 1
        if backpressured and self._events is not None:
            self._events.emit(
                "shm_ring", "overflow", severity="WARNING", ring=name,
                model=parsed["model_name"], backpressured=backpressured,
                span=count, occupancy=ring.occupancy)
        if self._m_occupancy is not None:
            self._m_occupancy.set(ring.occupancy, ring=name)
        return {"admitted": admitted, "rejected": rejected,
                "skipped": skipped}

    def _admit_slot(self, ring: _Ring, slot: int, parsed: dict) -> str:
        """FILLED -> IN_FLIGHT -> submitted, with per-slot error
        isolation. Returns the outcome label."""
        from client_tpu_torch.admission import AdmissionError

        if ring.state(slot) != SLOT_FILLED:
            # Producer protocol violation (or a replayed doorbell):
            # never touch a slot the producer hasn't published.
            ring.slots_skipped += 1
            if self._m_slots is not None:
                self._m_slots.inc(ring=ring.name, outcome="skipped")
            return "skipped"
        ring.set_state(slot, SLOT_IN_FLIGHT)
        with ring.lock:
            ring.inflight_slots.add(slot)
        try:
            req = InferRequest(
                model_name=parsed["model_name"],
                model_version=parsed["model_version"],
                request_id=f"{ring.name}/{slot}",
                inputs=ring.read_inputs(
                    slot, parsed["metas"],
                    resolve=self._resolver(parsed["dataset"])),
                outputs=[OutputRequest(n) for n in parsed["out_names"]],
                priority=parsed["priority"],
                tenant=parsed["tenant"],
            )
            if parsed["timeout_ms"]:
                req.set_deadline_from_timeout_ms(parsed["timeout_ms"])
            self._submit(req, self._completion(ring, slot))
        except AdmissionError as exc:
            # The slot channel has no header side channel for pushback,
            # so the Retry-After rides the error string; producers parse
            # it back out (parse_slot_error_retry_after) to pace their
            # backoff.
            self._finish_slot(
                ring, slot, None,
                format_slot_error(str(exc),
                                  getattr(exc, "retry_after_s", None)),
                outcome="backpressured")
            return "backpressured"
        except Exception as exc:  # noqa: BLE001 — per-slot isolation
            self._finish_slot(ring, slot, None, str(exc),
                              outcome="error")
            return "error"
        return "admitted"

    # -- the reaper (multi-ring fan-in) --------------------------------------

    def _ensure_reaper(self) -> None:
        with self._lock:
            if self._reaper is not None:
                return
            reaper = _Reaper(self, self._reaper_interval_s,
                             self._reaper_span)
            self._reaper = reaper
        reaper.start()

    def _reaper_should_exit(self, reaper: _Reaper) -> bool:
        """True when no reaped rings remain; clears the manager's slot
        under the lock so a racing reaped register starts a fresh
        thread instead of relying on one that is about to exit."""
        with self._lock:
            if any(r.spec is not None for r in self._rings.values()):
                return False
            if self._reaper is reaper:
                self._reaper = None
            return True

    def _sweep_once(self, span_cap: int) -> int:
        """One fair pass: visit every reaped ring (rotating the start
        position), admitting at most ``span_cap`` slots per ring."""
        with self._lock:
            rings = [r for r in self._rings.values()
                     if r.spec is not None]
            if rings:
                self._rr = (self._rr + 1) % len(rings)
                rings = rings[self._rr:] + rings[:self._rr]
        total = 0
        for ring in rings:
            if self._check_liveness(ring):
                continue   # reclaimed: ring is gone
            total += self._sweep_ring(ring, span_cap)
        if self._m_reaper_sweeps is not None:
            self._m_reaper_sweeps.inc()
        return total

    def _sweep_ring(self, ring: _Ring, span_cap: int) -> int:
        head = ring.head
        if ring.swept >= head:
            return 0
        # Same chaos site as the explicit doorbell, but with reaper
        # error isolation: an injected error skips this ring for one
        # sweep instead of killing the thread.
        try:
            _faults.fire(FAULT_SITE)
        except _faults.FaultInjected as exc:
            if self._events is not None:
                self._events.emit(
                    "shm_ring", "reaper_fault", severity="WARNING",
                    ring=ring.name, kind=exc.kind)
            return 0
        admitted = 0
        visited = 0
        while ring.swept < head and visited < span_cap:
            slot = ring.swept % ring.slot_count
            ring.swept += 1
            visited += 1
            try:
                outcome = self._admit_slot(ring, slot, ring.spec)
            except Exception:  # noqa: BLE001 — reaper must survive
                outcome = "error"
            if outcome == "admitted":
                admitted += 1
                ring.reap_slots += 1
        if admitted and self._m_reaper_slots is not None:
            self._m_reaper_slots.inc(admitted, ring=ring.name)
        if admitted and self._m_occupancy is not None:
            self._m_occupancy.set(ring.occupancy, ring=ring.name)
        return admitted

    def _check_liveness(self, ring: _Ring) -> bool:
        """Probe the producer-pid word; reclaim the ring when the
        producer is gone. Returns True when the ring was reclaimed."""
        pid = ring.producer_pid
        if pid <= 0:
            return False
        try:
            os.kill(pid, 0)
            return False
        except ProcessLookupError:
            pass
        except PermissionError:
            return False   # pid exists under another uid: alive
        if self._m_reaper_dead is not None:
            self._m_reaper_dead.inc(ring=ring.name)
        if self._events is not None:
            self._events.emit(
                "shm_ring", "producer_dead", severity="WARNING",
                ring=ring.name, pid=pid, occupancy=ring.occupancy,
                heartbeat=ring.heartbeat)
        self.unregister(ring.name)
        return True

    def _fail_inflight(self, ring: _Ring, reason: str) -> int:
        """Fail every slot this manager still holds IN_FLIGHT (detach /
        dead-producer reclaim): the error response + DONE store reach
        the segment before it closes. A concurrent real completion for
        one of these slots just overwrites the error — either way the
        slot ends DONE."""
        with ring.lock:
            slots = sorted(ring.inflight_slots)
            ring.inflight_slots.clear()
        for slot in slots:
            try:
                ring.write_response(slot, None, reason)
            # the mapping is already gone; there is nobody to deliver to
            except Exception:
                pass
            if self._m_slots is not None:
                self._m_slots.inc(ring=ring.name, outcome="detached")
        return len(slots)

    def shutdown(self) -> None:
        """Stop the reaper thread (if any) and detach every ring."""
        with self._lock:
            reaper, self._reaper = self._reaper, None
        if reaper is not None:
            reaper.stop()
        self.unregister(None)

    def _completion(self, ring: _Ring, slot: int):
        def _cb(resp) -> None:
            if not resp.final:
                return
            if resp.error is not None:
                self._finish_slot(ring, slot, None, str(resp.error),
                                  outcome="error")
            else:
                self._finish_slot(ring, slot, resp.outputs, None,
                                  outcome="ok")
        return _cb

    def _finish_slot(self, ring: _Ring, slot: int, outputs, error,
                     outcome: str) -> None:
        try:
            fit = ring.write_response(slot, outputs, error)
        except Exception:
            # Detached/unmapped mid-flight: drop the completion; the
            # producer side is gone with the mapping.
            fit = True
        with ring.lock:
            ring.inflight_slots.discard(slot)
        if not fit:
            outcome = "error"
        if outcome == "ok":
            ring.slots_ok += 1
        elif outcome == "backpressured":
            ring.slots_backpressured += 1
        else:
            ring.slots_error += 1
        if self._m_slots is not None:
            self._m_slots.inc(ring=ring.name, outcome=outcome)
