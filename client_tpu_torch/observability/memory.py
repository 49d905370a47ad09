"""HBM census: byte-accurate attribution of live device memory.

The port's copy of ``client_tpu/observability/memory.py``, on PyTorch's
caching allocator:

- **Owner tagging** — load paths register the tensors they create (a
  model's weights in ``engine/model.py``, DLRM's embedding tables, the
  generative KV arena through a provider) against a ``(model,
  component)`` owner. Registration is weak: a freed tensor drops out of
  the census on the next walk, never pinned. Tied or viewed tensors
  share one storage, so the walk counts each storage once, by its data
  pointer, for the first owner that holds it.
- **The walk** — :meth:`HbmCensus.report` sums live tagged bytes per
  owner, reads ``torch.cuda.memory_stats(i)`` per visible card
  (``allocated_bytes.all.current`` is in use, ``.peak`` the peak,
  ``mem_get_info`` the limit; one row of zeros without a card, as the
  JAX package's CPU rows are), takes ``torch.cuda.memory_allocated`` as
  the committed bytes, and buckets the remainder as ``unattributed``.
- **Plan reconciliation** — planner arenas (none registers until the
  autotuner is ported) and the backends' own reservations (DLRM's
  ``hbm_reservation_bytes``) are held against the actuals:
  ``drift_bytes = plan - actual`` per owner.

Rendered as ``tpu_hbm_census_bytes{model,component}`` /
``tpu_hbm_plan_drift_bytes{model,component}`` plus the watermark gauge,
served at ``GET /v2/memory`` and the ``MemoryCensus`` RPC. Crossing the
pressure threshold (``CLIENT_TPU_MEMORY``, default 90% of the limit)
emits an edge-triggered ``memory.pressure`` event. Importing this module
loads no torch: the walk imports it.
"""

from __future__ import annotations

import json
import os
import weakref
from dataclasses import dataclass, fields

from client_tpu_torch.config import env_text
from client_tpu_torch.utils import lockdep

__all__ = [
    "COMPONENTS",
    "MemoryConfig",
    "HbmCensus",
    "hbm_census",
    "reset_hbm_census",
    "tensor_leaves",
]

ENV_VAR = "CLIENT_TPU_MEMORY"

# The owner vocabulary the load paths tag with (free-form strings are
# accepted too).
COMPONENTS = ("weights", "kv_arena", "embedding", "rowcache",
              "autotune_warm")

# Arena reservation-name prefixes -> census component, for plan
# reconciliation ("bucket:{model}:{version}:{b}", "kv:{model}:{version}").
_PLAN_COMPONENTS = {
    "bucket": "autotune_warm",
    "kv": "kv_arena",
    "rowcache": "rowcache",
}


@dataclass
class MemoryConfig:
    """``CLIENT_TPU_MEMORY`` knobs: unset means defaults (the census is
    always on); ``0``/``off`` only silences pressure events."""

    pressure_fraction: float = 0.9   # bytes_in_use/bytes_limit threshold
    pressure_events: bool = True

    @classmethod
    def from_dict(cls, data: dict) -> "MemoryConfig":
        known = {f.name for f in fields(cls) if f.name != "pressure_events"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{ENV_VAR}: unknown key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        cfg = cls()
        if "pressure_fraction" in data:
            try:
                cfg.pressure_fraction = float(data["pressure_fraction"])
            except (TypeError, ValueError):
                raise ValueError(
                    f"{ENV_VAR}: key 'pressure_fraction' expects a "
                    f"number, got {data['pressure_fraction']!r}") from None
        if not 0 < cfg.pressure_fraction <= 1:
            raise ValueError(
                f"{ENV_VAR}: pressure_fraction must be in (0, 1]")
        return cfg

    @classmethod
    def from_env(cls, environ=os.environ) -> "MemoryConfig":
        raw = env_text(ENV_VAR, environ)
        if raw.lower() in ("0", "false", "off"):
            return cls(pressure_events=False)
        if not raw or raw.lower() in ("1", "true", "on"):
            return cls()
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as f:
                    raw = f.read()
            except OSError as exc:
                raise ValueError(
                    f"{ENV_VAR}: cannot read '{raw[1:]}': {exc}") from None
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{ENV_VAR}: invalid JSON ({exc})") from None
        if not isinstance(data, dict):
            raise ValueError(f"{ENV_VAR}: expected a JSON object")
        return cls.from_dict(data)


def tensor_leaves(tree) -> list:
    """The leaves of a nest of dicts, lists, tuples and dataclass-like
    objects (an arena's ``k`` / ``v`` / ``tok``), in order; None (a
    released arena) has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tensor_leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [leaf for name in tree.__dataclass_fields__
                for leaf in tensor_leaves(getattr(tree, name))]
    return [tree]


def _storage(t) -> tuple[tuple, int]:
    """(key, bytes) of a tensor's storage: the key (device, data pointer)
    is shared by every view and tied parameter of one storage."""
    st = t.untyped_storage()
    return (str(t.device), st.data_ptr()), int(st.nbytes())


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen: dict = {}
    for t in tensors:
        key, nbytes = _storage(t)
        seen[key] = nbytes
    return sum(seen.values())


class HbmCensus:
    """Registration-tag map + the census walk. Process-global (load
    paths run below the engine and must find it without plumbing);
    :func:`reset_hbm_census` drops it between tests."""

    def __init__(self, config: MemoryConfig | None = None):
        self.config = config or MemoryConfig()
        self._lock = lockdep.Lock("observability.memory")
        # id(tensor) -> (weakref, model, component); the weakref both
        # detects death and guards against id reuse.
        self._tags: dict[int, tuple[weakref.ref, str, str]] = {}
        # Dynamic owners: id(owner) -> (weakref, model, component, fn),
        # fn(owner) -> iterable of tensors. fn is a plain function, never
        # a closure over the owner (the census must not keep it alive).
        self._providers: dict[int, tuple] = {}
        # Planner arenas, weakly (none registers until autotune is ported).
        self._arenas: list[weakref.ref] = []
        self._watermark = 0          # high-water committed bytes
        self._pressured = False      # edge-trigger latch

    # -- registration ---------------------------------------------------------

    def tag(self, model: str, component: str, tree, *,
            overwrite: bool = True) -> int:
        """Attribute every weakref-able leaf of ``tree`` to ``(model,
        component)``. Re-tagging a tensor overwrites its owner unless
        ``overwrite=False``: the generic weights pass in ``Model`` passes
        False so that a more specific tag placed at construction (DLRM's
        ``embedding`` tables) survives it. Returns the tensors
        registered."""
        count = 0
        with self._lock:
            for leaf in tensor_leaves(tree):
                try:
                    ref = weakref.ref(leaf)
                except TypeError:
                    continue  # ints and the like: no device memory
                prior = self._tags.get(id(leaf))
                if (not overwrite and prior is not None
                        and prior[0]() is leaf):
                    continue
                self._tags[id(leaf)] = (ref, str(model), str(component))
                count += 1
        return count

    def untag(self, model: str | None = None,
              component: str | None = None) -> int:
        """Drop tags and providers by owner (unload paths); None matches
        everything."""
        with self._lock:
            victims = [
                key for key, (_, m, c) in self._tags.items()
                if (model is None or m == model)
                and (component is None or c == component)]
            for key in victims:
                del self._tags[key]
            gone = [key for key, (_, m, c, _fn) in self._providers.items()
                    if (model is None or m == model)
                    and (component is None or c == component)]
            for key in gone:
                del self._providers[key]
        return len(victims) + len(gone)

    def register_provider(self, model: str, component: str, owner,
                          fn) -> None:
        """Dynamic attribution for an owner whose tensors may be replaced
        (a KV arena rebuilt after a failed step). ``fn(owner)`` returns the
        owner's live tensors at walk time; it must be a plain function
        taking the owner, never a closure over it. Idempotent per owner."""
        with self._lock:
            self._providers[id(owner)] = (
                weakref.ref(owner), str(model), str(component), fn)

    def unregister_provider(self, owner) -> None:
        with self._lock:
            self._providers.pop(id(owner), None)

    def register_arena(self, arena) -> None:
        """Register a planner arena for plan-vs-actual reconciliation
        (idempotent per arena identity)."""
        with self._lock:
            self._arenas = [r for r in self._arenas
                            if r() is not None and r() is not arena]
            self._arenas.append(weakref.ref(arena))

    def unregister_arena(self, arena) -> None:
        with self._lock:
            self._arenas = [r for r in self._arenas
                            if r() is not None and r() is not arena]

    # -- the walk -------------------------------------------------------------

    def device_stats(self) -> list[dict]:
        """One entry per visible card from the caching allocator's
        counters; one entry of zeros without a card, as the JAX
        package's CPU rows are. The single source behind the
        ``tpu_device_hbm_bytes_in_use`` / ``tpu_hbm_limit_bytes`` /
        ``tpu_hbm_peak_bytes`` gauges."""
        import torch

        if not torch.cuda.is_available():
            return [{"device": "0", "platform": "cpu", "bytes_in_use": 0,
                     "bytes_limit": 0, "peak_bytes_in_use": 0}]
        out = []
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            out.append({
                "device": str(i),
                "platform": "gpu",
                "bytes_in_use": int(ms.get("allocated_bytes.all.current",
                                           0)),
                "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                0)),
            })
        return out

    def _attributed(self) -> dict[tuple[str, str], dict]:
        """{(model, component): {"bytes": n, "buffers": k}} over live
        tagged tensors and providers, each storage counted once; dead
        tags pruned as a side effect."""
        with self._lock:
            items = list(self._tags.items())
            providers = list(self._providers.items())
        owned: list[tuple[tuple[str, str], object]] = []
        dead = []
        for key, (ref, model, component) in items:
            t = ref()
            if t is None:
                dead.append(key)
            else:
                owned.append(((model, component), t))
        for key, (ref, model, component, fn) in providers:
            obj = ref()
            if obj is None:
                dead.append(key)
                continue
            try:
                tensors = list(fn(obj))
            # An owner mid-teardown has no arena to count.
            except Exception:  # noqa: BLE001
                continue
            owned += [((model, component), t) for t in tensors]
        if dead:
            with self._lock:
                for key in dead:
                    self._tags.pop(key, None)
                    self._providers.pop(key, None)
        owners: dict[tuple[str, str], dict] = {}
        seen: set = set()
        for owner, t in owned:
            skey, nbytes = _storage(t)
            row = owners.setdefault(owner, {"bytes": 0, "buffers": 0})
            row["buffers"] += 1
            if skey not in seen:
                seen.add(skey)
                row["bytes"] += nbytes
        return owners

    def _plans(self) -> dict[tuple[str, str], int]:
        """{(model, component): reserved bytes} from every registered
        planner arena, component mapped by reservation-name prefix."""
        with self._lock:
            arenas = [r() for r in self._arenas]
        plans: dict[tuple[str, str], int] = {}
        for arena in arenas:
            if arena is None:
                continue
            try:
                snap = arena.snapshot()
            except Exception:  # noqa: BLE001 — arena mid-teardown
                continue
            for res in snap.get("reservations", ()):
                parts = str(res.get("name", "")).split(":")
                if len(parts) < 2:
                    continue
                component = _PLAN_COMPONENTS.get(parts[0])
                if component is None:
                    continue
                owner = (parts[1], component)
                plans[owner] = plans.get(owner, 0) + int(
                    res.get("nbytes", 0))
        return plans

    def report(self, extra_plans: dict | None = None,
               events=None) -> dict:
        """The ``GET /v2/memory`` body. ``extra_plans`` maps ``(model,
        component)`` to planned bytes from outside the arenas (DLRM's
        ``hbm_reservation_bytes``); ``events`` is the journal that
        pressure edges go to (None = no events)."""
        import torch

        devices = self.device_stats()
        total_in_use = sum(d["bytes_in_use"] for d in devices)
        total_limit = sum(d["bytes_limit"] for d in devices)
        total_peak = sum(d["peak_bytes_in_use"] for d in devices)
        live_bytes = live_count = 0
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                live_bytes += int(torch.cuda.memory_allocated(i))
                live_count += int(torch.cuda.memory_stats(i).get(
                    "allocation.all.current", 0))
        committed = total_in_use if total_in_use > 0 else live_bytes

        attributed = self._attributed()
        plans = self._plans()
        for owner, nbytes in (extra_plans or {}).items():
            plans[owner] = plans.get(owner, 0) + int(nbytes)

        owners = []
        attributed_bytes = 0
        for owner in sorted(set(attributed) | set(plans)):
            actual = attributed.get(owner, {"bytes": 0, "buffers": 0})
            plan = plans.get(owner)
            attributed_bytes += actual["bytes"]
            row = {
                "model": owner[0],
                "component": owner[1],
                "bytes": actual["bytes"],
                "buffers": actual["buffers"],
            }
            if plan is not None:
                row["plan_bytes"] = plan
                row["drift_bytes"] = plan - actual["bytes"]
            owners.append(row)
        unattributed = max(0, committed - attributed_bytes)
        fraction = (attributed_bytes / committed) if committed else 1.0

        with self._lock:
            if committed > self._watermark:
                self._watermark = committed
            watermark = self._watermark

        pressure = None
        if total_limit > 0:
            used_fraction = total_in_use / total_limit
            pressure = {
                "fraction": round(used_fraction, 6),
                "threshold": self.config.pressure_fraction,
                "over": used_fraction >= self.config.pressure_fraction,
            }
            self._pressure_edge(pressure, total_in_use, total_limit,
                                events)
        return {
            "devices": devices,
            "totals": {
                "bytes_in_use": total_in_use,
                "bytes_limit": total_limit,
                "peak_bytes_in_use": total_peak,
                "live_array_bytes": live_bytes,
                "live_arrays": live_count,
                "committed_bytes": committed,
            },
            "owners": owners,
            "attributed_bytes": attributed_bytes,
            "unattributed_bytes": unattributed,
            "attributed_fraction": round(fraction, 6),
            "watermark_bytes": watermark,
            "pressure": pressure,
        }

    def _pressure_edge(self, pressure: dict, in_use: int, limit: int,
                       events) -> None:
        """Edge-triggered ``memory.pressure`` events: one on crossing the
        threshold upward, one ``pressure_cleared`` on the way back down,
        never one per scrape."""
        if not self.config.pressure_events or events is None:
            return
        over = pressure["over"]
        with self._lock:
            was = self._pressured
            self._pressured = over
        if over and not was:
            events.emit("memory", "pressure", severity="WARNING",
                        bytes_in_use=in_use, bytes_limit=limit,
                        fraction=pressure["fraction"],
                        threshold=pressure["threshold"])
        elif was and not over:
            events.emit("memory", "pressure_cleared",
                        bytes_in_use=in_use, bytes_limit=limit,
                        fraction=pressure["fraction"])


# -- process-global census -----------------------------------------------------

_default: HbmCensus | None = None
_default_lock = lockdep.Lock("observability.memory.default")


def hbm_census() -> HbmCensus:
    """The process-global census: load paths tag into it from below the
    engine, the engine reads reports out of it."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = HbmCensus(MemoryConfig.from_env())
    return _default


def reset_hbm_census() -> None:
    """Drop the global census (tests); the next :func:`hbm_census` call
    makes it again with the current environment."""
    global _default
    with _default_lock:
        _default = None
