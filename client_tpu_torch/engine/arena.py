"""HBM planning arena: deterministic first-fit packing under a budget.

The port's copy of ``client_tpu/engine/arena.py``. The autotuner
(``engine/autotune.py``) must know whether a ladder promotion fits in
the card's memory before it warms the candidate bucket. This module is
the planning layer: a byte budget for the card, carved from its total
memory (``torch.cuda.mem_get_info()[1]``, the census's limit), with
named offset-based reservations in the style of the offset-calculation
arenas of "Efficient Memory Management for Deep Neural Net Inference"
(arXiv 2001.03288):

- each reservation is an ``[offset, offset + nbytes)`` interval of one
  linear arena: co-resident models pack instead of fragmenting, and no
  two reservations overlap by construction;
- placement is first fit at the lowest free offset (gaps that releases
  leave are reused before the tail grows), so one reserve sequence
  always gives one layout, readable in ``/v2/profile``;
- a reservation that fits no gap raises :class:`ArenaExhausted`, which
  the tuner turns into an ``autotune.rejected_budget`` event instead of
  an out-of-memory error on the card.

The arena plans; PyTorch's caching allocator owns the card's memory.
"""

from __future__ import annotations

from dataclasses import dataclass

from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.utils import lockdep

# Reservations round up to this grain: sub-KiB precision would be false
# accuracy in a planner.
ALIGN = 1024


class ArenaExhausted(EngineError):
    """A reservation does not fit in any free gap of the arena."""

    def __init__(self, message: str):
        # 507 Insufficient Storage: the honest HTTP translation should a
        # frontend ever surface this (the tuner normally absorbs it).
        super().__init__(message, 507)


@dataclass(frozen=True)
class Reservation:
    """One named ``[offset, offset + nbytes)`` interval in the arena."""

    name: str
    offset: int
    nbytes: int

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


class ArenaAllocator:
    """First-fit offset allocator over a single linear byte budget."""

    def __init__(self, budget_bytes: int, label: str = "hbm"):
        if budget_bytes <= 0:
            raise EngineError(
                f"arena '{label}': budget must be positive, "
                f"got {budget_bytes}", 500)
        self.budget = int(budget_bytes)
        self.label = label
        self._lock = lockdep.Lock("engine.arena")
        self._res: dict[str, Reservation] = {}

    # -- core ops -------------------------------------------------------------

    @staticmethod
    def _align(nbytes: int) -> int:
        return max(ALIGN, (int(nbytes) + ALIGN - 1) // ALIGN * ALIGN)

    def reserve(self, name: str, nbytes: int) -> Reservation:
        """Place ``name`` at the lowest free offset that fits (first-fit;
        released gaps are reused before the tail grows). Raises
        :class:`ArenaExhausted` when no gap fits, ``EngineError`` when the
        name is already reserved (release first — reservations are not
        resizable in place)."""
        need = self._align(nbytes)
        with self._lock:
            if name in self._res:
                raise EngineError(
                    f"arena '{self.label}': '{name}' already reserved "
                    f"({self._res[name].nbytes} bytes)", 500)
            offset = self._first_fit_locked(need)
            if offset is None:
                raise ArenaExhausted(
                    f"arena '{self.label}': cannot reserve {need} bytes for "
                    f"'{name}' — {self.free_bytes_locked()} of {self.budget} "
                    f"bytes free, largest gap "
                    f"{self.largest_gap_locked()} bytes")
            r = Reservation(name, offset, need)
            self._res[name] = r
            return r

    def _first_fit_locked(self, need: int) -> int | None:
        cursor = 0
        for r in sorted(self._res.values(), key=lambda r: r.offset):
            if r.offset - cursor >= need:
                return cursor
            cursor = max(cursor, r.end)
        if self.budget - cursor >= need:
            return cursor
        return None

    def reserve_sharded(self, name: str, nbytes: int,
                        shards: int = 1) -> Reservation:
        """Reserve one card's share of a buffer split over ``shards``
        cards: ``ceil(nbytes / shards)``. The arena models one card's
        memory, while a row-sharded KV arena (``parallel/kv_shard.py``)
        reports its bytes over every shard."""
        shards = max(1, int(shards))
        return self.reserve(name, (int(nbytes) + shards - 1) // shards)

    def release(self, name: str) -> bool:
        """Free one reservation; returns False when the name is unknown
        (idempotent — unload paths call this unconditionally)."""
        with self._lock:
            return self._res.pop(name, None) is not None

    def release_prefix(self, prefix: str) -> int:
        """Free every reservation whose name starts with ``prefix``
        (e.g. ``bucket:simple:1:``); returns the count released."""
        with self._lock:
            doomed = [n for n in self._res if n.startswith(prefix)]
            for n in doomed:
                del self._res[n]
            return len(doomed)

    # -- introspection --------------------------------------------------------

    def get(self, name: str) -> Reservation | None:
        with self._lock:
            return self._res.get(name)

    def reserved_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._res.values())

    def free_bytes(self) -> int:
        with self._lock:
            return self.free_bytes_locked()

    def free_bytes_locked(self) -> int:
        return self.budget - sum(r.nbytes for r in self._res.values())

    def largest_gap_locked(self) -> int:
        cursor, largest = 0, 0
        for r in sorted(self._res.values(), key=lambda r: r.offset):
            largest = max(largest, r.offset - cursor)
            cursor = max(cursor, r.end)
        return max(largest, self.budget - cursor)

    def snapshot(self) -> dict:
        """JSON view for ``/v2/profile``: budget, usage, and the packed
        layout sorted by offset (offsets make overlap auditable)."""
        with self._lock:
            layout = sorted(self._res.values(), key=lambda r: r.offset)
            reserved = sum(r.nbytes for r in layout)
            return {
                "label": self.label,
                "budget_bytes": self.budget,
                "reserved_bytes": reserved,
                "free_bytes": self.budget - reserved,
                "reservations": [
                    {"name": r.name, "offset": r.offset, "nbytes": r.nbytes}
                    for r in layout
                ],
            }


def device_hbm_budget(fraction: float, fallback_bytes: int = 0) -> int:
    """The arena's budget: the card's total memory
    (``torch.cuda.mem_get_info()[1]``) scaled by ``fraction``. Without a
    card there is no limit to read, and the budget is ``fallback_bytes``,
    so the planner still works on the CPU."""
    import torch

    limit = 0
    if torch.cuda.is_available():
        limit = int(torch.cuda.mem_get_info()[1])
    if limit <= 0:
        return int(fallback_bytes)
    return int(limit * fraction)
