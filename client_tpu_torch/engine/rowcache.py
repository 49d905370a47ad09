"""Hot-row embedding cache: a host-side LRU over a table's hot rows.

Counterpart of ``client_tpu/engine/rowcache.py``. DLRM traffic is Zipf
skewed: a few rows of each table take most lookups. A ``DlrmBackend``
with host tables (``host_tables=True``) resolves every batch's lookups
here before staging: hot rows come from the cache, cold rows from the
backing table, inserted as they fault, evicting the least recently used
past the byte budget. The card then receives the gathered vectors, and
only pools them.

The engine binds each cache to its metric registry at load
(:meth:`RowCache.bind_metrics`: ``tpu_emb_lookups_total``,
``tpu_emb_cache_hits_total``, ``tpu_emb_cache_size_bytes``) and clears it
on every load and unload of its model (the weights may have changed; the
counters stay monotonic).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from client_tpu_torch.utils import lockdep


class RowCache:
    """LRU of hot rows of ``table`` (the host backing store ``[rows,
    dim]``, a DLRM backend's stacked tables) within ``budget_bytes`` of
    resident vectors; a budget of 0 caches nothing."""

    def __init__(self, table: np.ndarray, budget_bytes: int = 0):
        if table.ndim != 2:
            raise ValueError(f"backing table must be 2-D, got {table.shape}")
        self._table = table
        self.row_bytes = int(table.shape[1]) * int(table.itemsize)
        self.capacity_rows = (max(1, int(budget_bytes) // self.row_bytes)
                              if budget_bytes > 0 else 0)
        self.budget_bytes = int(budget_bytes)
        self._lock = lockdep.Lock("engine.rowcache")
        # row id -> its vector; recency order, least recent first.
        self._rows: OrderedDict[int, np.ndarray] = OrderedDict()
        # Cumulative counters: clear() leaves them alone.
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        # (lookups counter, hits counter, size gauge, labels) per bound
        # registry.
        self._bound: list = []

    def bind_metrics(self, registry, model: str, version) -> None:
        """Declare the ``tpu_emb_*`` families on an engine's registry;
        every later lookup batch adds its counts there."""
        labels = {"model": str(model), "version": str(version)}
        self._bound.append((
            registry.counter(
                "tpu_emb_lookups_total",
                "Embedding rows resolved through the hot-row cache",
                ("model", "version")),
            registry.counter(
                "tpu_emb_cache_hits_total",
                "Embedding lookups served from the hot-row cache",
                ("model", "version")),
            registry.gauge(
                "tpu_emb_cache_size_bytes",
                "Resident bytes of the hot-row embedding cache",
                ("model", "version")),
            labels,
        ))
        for _lookups, _hits, size, lab in self._bound:
            size.set(self.size_bytes(), **lab)

    def _record(self, lookups: int, hits: int) -> None:
        size_bytes = self.size_bytes()
        for lk, h, size, lab in self._bound:
            if lookups:
                lk.inc(lookups, **lab)
            if hits:
                h.inc(hits, **lab)
            size.set(size_bytes, **lab)

    def size_bytes(self) -> int:
        return len(self._rows) * self.row_bytes

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def lookup(self, rows: np.ndarray) -> np.ndarray:
        """The vectors ``[len(rows), dim]`` of ``rows``; see
        :meth:`lookup_counted`."""
        out, _ = self.lookup_counted(rows)
        return out

    def lookup_counted(self, rows: np.ndarray) -> tuple[np.ndarray, int]:
        """The vectors ``[len(rows), dim]`` of ``rows`` and this batch's
        hits. A row repeated in one batch counts one lookup each time (64
        lookups of one hot row are 64 hits) but faults at most once."""
        rows = np.asarray(rows)
        n = int(rows.shape[0])
        out = np.empty((n, self._table.shape[1]), dtype=self._table.dtype)
        if n == 0:
            return out, 0
        uniq, inverse = np.unique(rows, return_inverse=True)
        counts = np.bincount(inverse, minlength=len(uniq))
        gathered = np.empty((len(uniq), self._table.shape[1]),
                            dtype=self._table.dtype)
        hits = 0
        with self._lock:
            for i, r in enumerate(uniq):
                r = int(r)
                vec = self._rows.get(r)
                if vec is not None:
                    self._rows.move_to_end(r)
                    gathered[i] = vec
                    hits += int(counts[i])
                    continue
                vec = np.array(self._table[r])
                gathered[i] = vec
                if self.capacity_rows > 0:
                    self._rows[r] = vec
                    while len(self._rows) > self.capacity_rows:
                        self._rows.popitem(last=False)
                        self.evictions += 1
            self.lookups += n
            self.hits += hits
            self.misses += n - hits
        out[:] = gathered[inverse]
        self._record(n, hits)
        return out, hits

    def clear(self) -> None:
        """Drop every resident row; the counters stay."""
        with self._lock:
            self._rows.clear()
            self.invalidations += 1
        self._record(0, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity_rows": self.capacity_rows,
                "resident_rows": len(self._rows),
                "size_bytes": self.size_bytes(),
                "budget_bytes": self.budget_bytes,
                "lookups": self.lookups,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": round(self.hit_rate(), 4),
            }
