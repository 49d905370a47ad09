"""The bucket autotuner and the dispatch tuner: act on ``/v2/profile``
instead of only reporting it.

The port's copy of ``client_tpu/engine/autotune.py``:

- :class:`Autotuner`, a daemon thread woken every ``interval_s``, reads
  the efficiency profiler's snapshot and walks each model's
  ``suggestions``;
- **promotion** (``add_bucket``): under hysteresis (at least
  ``min_calls`` executions below ``max_fill`` fill, a per-bucket
  cooldown) the candidate is first *reserved* against the planning
  arena's budget (:class:`client_tpu_torch.engine.arena.ArenaAllocator`;
  a promotion that does not fit is an ``autotune.rejected_budget`` event,
  not an out-of-memory error), then *warmed off the hot path* (one
  execution on zeros through ``Model.warm_bucket`` on the tuner's thread,
  which takes the bucket's cold first execution: its kernels' first
  launch, cuBLAS's plans, the allocator's blocks), and only then swapped
  into the scheduler's ladder (``Scheduler.swap_ladder``);
- **retirement** (``retire_bucket``): a bucket whose call rate stayed
  below ``retire_rate_per_min`` for a full profile window leaves the
  ladder (a batch that already picked it still runs); the ladder always
  keeps its capacity;
- every decision goes to the event journal and the ``tpu_autotune_*``
  metrics; ``/v2/profile`` gains an ``autotune`` section and a ``state``
  (``applied`` or ``suggested``) on each suggestion.

The arena only plans, as the JAX package's does: a reservation holds no
memory. The HBM census reads the reservations as each model's
``autotune_warm`` plan beside the bytes tagged with that component, and
reports the difference as drift.

:class:`DispatchTuner` is self-drive's dispatch loop
(``engine/selfdrive.py``): duty cycle, queue wait and fill together drive
the scheduler's dispatch override and the admission controller's
concurrency cap.

Opt-in through ``CLIENT_TPU_AUTOTUNE`` (inline JSON or ``@file``; ``1`` or
``true`` takes the defaults). Unset, nothing here is built: no thread, no
arena, ladders fixed at load.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, fields

import numpy as np

from client_tpu_torch.config import env_text
from client_tpu_torch.engine.arena import (
    ArenaAllocator,
    ArenaExhausted,
    device_hbm_budget,
)
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.observability.events import journal
from client_tpu_torch.observability.memory import hbm_census
from client_tpu_torch.protocol.dtypes import wire_to_np_dtype
from client_tpu_torch.utils import lockdep

_log = logging.getLogger("client_tpu_torch")

ENV_VAR = "CLIENT_TPU_AUTOTUNE"

# The arena's budget without a card (the CPU): large enough that packing,
# not the budget, is what a normal promotion meets; ``budget_bytes`` sets
# a small one to test rejection.
_DEFAULT_CPU_BUDGET = 1 << 30  # 1 GiB


@dataclass
class AutotuneConfig:
    """``CLIENT_TPU_AUTOTUNE`` knobs (all optional).

    Hysteresis: ``min_calls``/``max_fill`` gate promotions (both must
    hold *in the profiler snapshot* — the profiler applies its own
    identical defaults when building the suggestion list), and
    ``cooldown_s`` spaces repeated decisions on the same (model, bucket)
    so a noisy window can't flap the ladder. Retirement additionally
    requires the profiler to have observed the bucket for a full window
    (absence of calls on a just-added bucket is not evidence).
    """

    interval_s: float = 5.0          # tuner wake period
    min_calls: int = 8               # executions before fill is trusted
    max_fill: float = 0.85           # promote only below this fill
    retire_rate_per_min: float = 0.5  # retire below this call rate
    cooldown_s: float = 60.0         # per-(model,bucket,action) spacing
    max_ladder: int = 12             # never grow a ladder past this
    hbm_fraction: float = 0.9        # share of the card's memory planned
    budget_bytes: int = 0            # explicit budget (0 = from device)
    activation_factor: float = 2.0   # io-bytes -> activation estimate

    @classmethod
    def from_dict(cls, data: dict) -> "AutotuneConfig":
        known = {f.name: f.type for f in fields(cls)}
        unknown = set(data) - set(known)
        if unknown:
            raise EngineError(
                f"{ENV_VAR}: unknown key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}", 400)
        cfg = cls()
        for f in fields(cls):
            if f.name not in data:
                continue
            raw = data[f.name]
            try:
                coerce = int if f.name in (
                    "min_calls", "max_ladder", "budget_bytes") else float
                setattr(cfg, f.name, coerce(raw))
            except (TypeError, ValueError):
                raise EngineError(
                    f"{ENV_VAR}: key '{f.name}' expects a number, "
                    f"got {raw!r}", 400) from None
        if cfg.interval_s <= 0:
            raise EngineError(f"{ENV_VAR}: interval_s must be > 0", 400)
        if not 0 < cfg.hbm_fraction <= 1:
            raise EngineError(
                f"{ENV_VAR}: hbm_fraction must be in (0, 1]", 400)
        return cfg

    @classmethod
    def from_env(cls, env_var: str = ENV_VAR) -> "AutotuneConfig | None":
        """None when unset/disabled (the engine then builds no tuner at
        all); ``"1"``/``"true"``/``"on"`` → defaults; otherwise inline
        JSON or ``@/path/to/file.json``."""
        raw = env_text(env_var)
        if not raw or raw.lower() in ("0", "false", "off"):
            return None
        if raw.lower() in ("1", "true", "on"):
            return cls()
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as f:
                    raw = f.read()
            except OSError as exc:
                raise EngineError(
                    f"{env_var}: cannot read '{raw[1:]}': {exc}", 400) \
                    from None
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise EngineError(
                f"{env_var}: invalid JSON ({exc})", 400) from None
        if not isinstance(data, dict):
            raise EngineError(
                f"{env_var}: expected a JSON object", 400)
        return cls.from_dict(data)

    def summary(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class Autotuner:
    """The background ladder tuner; one per engine (see module doc)."""

    def __init__(self, engine, config: AutotuneConfig, registry=None):
        self.engine = engine
        self.config = config
        budget = config.budget_bytes or device_hbm_budget(
            config.hbm_fraction, fallback_bytes=_DEFAULT_CPU_BUDGET)
        self.arena = ArenaAllocator(budget, label="hbm:0")
        # The census holds these reservations against the live tagged
        # bytes (tpu_hbm_plan_drift_bytes); it holds the arena weakly.
        hbm_census().register_arena(self.arena)
        self._lock = lockdep.Lock("engine.autotune")
        # (model, version, action, bucket) -> monotonic deadline before
        # which the same decision is not retried (hysteresis spacing).
        self._cooldown: dict[tuple, float] = {}
        # (model, version, action, bucket) of applied decisions: the
        # applied-vs-suggested annotation in /v2/profile.
        self._applied: set[tuple] = set()
        self._decisions: deque[dict] = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._metrics = None
        if registry is not None:
            self.bind_metrics(registry)

    # -- metrics --------------------------------------------------------------

    def bind_metrics(self, registry) -> None:
        self._metrics = {
            "decisions": registry.counter(
                "tpu_autotune_decisions_total",
                "Autotuner ladder decisions "
                "(add_bucket / retire_bucket / rejected_budget)",
                ("model", "version", "action")),
            "ticks": registry.counter(
                "tpu_autotune_ticks_total",
                "Autotuner evaluation passes over the profiler snapshot"),
            "compile_seconds": registry.counter(
                "tpu_autotune_compile_seconds_total",
                "Off-hot-path XLA compile time paid by the tuner thread"),
            "ladder": registry.gauge(
                "tpu_autotune_ladder_size",
                "Batch-bucket ladder length under autotuning",
                ("model", "version")),
            "budget": registry.gauge(
                "tpu_autotune_hbm_budget_bytes",
                "HBM arena budget the tuner plans against"),
            "reserved": registry.gauge(
                "tpu_autotune_hbm_reserved_bytes",
                "HBM arena bytes reserved for buckets and KV arenas"),
        }
        self._metrics["budget"].set(float(self.arena.budget))
        self._metrics["reserved"].set(0.0)

    def _count(self, action: str, model: str, version: str) -> None:
        if self._metrics is not None:
            self._metrics["decisions"].inc(
                model=model, version=version, action=action)

    def _refresh_gauges(self) -> None:
        if self._metrics is not None:
            self._metrics["reserved"].set(float(self.arena.reserved_bytes()))

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autotuner", daemon=True)
        self._thread.start()
        self._journal("enabled", severity="INFO",
                      interval_s=self.config.interval_s,
                      budget_bytes=self.arena.budget)

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            self._thread = None
        hbm_census().unregister_arena(self.arena)

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the tuner must never take
                _log.exception("autotune: tick failed")  # serving down

    # -- journal --------------------------------------------------------------

    def _journal(self, name: str, model: str | None = None,
                 version=None, severity: str = "INFO", **detail) -> None:
        journal().emit("autotune", name, model=model,
                       version=str(version) if version is not None else None,
                       severity=severity, **detail)

    # -- reservations (load/unload surface) -----------------------------------

    def _bucket_nbytes(self, model, bucket: int) -> int:
        """Planning estimate for one bucket's working set: bucket rows x
        per-row I/O bytes x ``activation_factor`` (inputs, outputs and an
        allowance for intermediates; BYTES tensors stay on the host and
        cost the card nothing)."""
        per_row = 0
        for tc in list(model.config.input) + list(model.config.output):
            if tc.data_type == "BYTES":
                continue
            n = 1
            for d in tc.dims:
                n *= d if d and d > 0 else 1
            per_row += n * np.dtype(wire_to_np_dtype(tc.data_type)).itemsize
        return max(1, int(bucket * per_row * self.config.activation_factor))

    def on_model_loaded(self, model, sched) -> None:
        """Reserve the loaded ladder's buckets (and a generative KV arena,
        a row cache) in the planning arena. A load succeeds even over the
        budget: an overcommit journals a WARNING; only the tuner's own
        promotions are refused."""
        name = model.config.name
        version = model.config.version
        prefix = f"bucket:{name}:{version}:"
        self.arena.release_prefix(prefix)  # a re-load replaces, idempotent
        self.arena.release(f"kv:{name}:{version}")
        self.arena.release(f"rowcache:{name}:{version}")
        if model.config.axis_capacity() > 0:
            for b in model.config.effective_buckets():
                self._reserve_advisory(f"{prefix}{b}",
                                       self._bucket_nbytes(model, b),
                                       name, version)
        arena_nbytes = getattr(sched, "arena_nbytes", None)
        if callable(arena_nbytes):
            # A sharded KV arena reports every shard's bytes; the planner
            # models one card.
            shards_of = getattr(sched, "arena_shards", None)
            shards = int(shards_of()) if callable(shards_of) else 1
            self._reserve_advisory(f"kv:{name}:{version}",
                                   int(arena_nbytes()), name, version,
                                   shards=shards)
        # A host-table embedding cache is working set the planner should
        # see beside the buckets and KV arenas.
        cache = getattr(model.backend, "row_cache", None)
        if cache is not None and cache.budget_bytes > 0:
            self._reserve_advisory(f"rowcache:{name}:{version}",
                                   int(cache.budget_bytes), name, version)
        if self._metrics is not None and model.config.axis_capacity() > 0:
            self._metrics["ladder"].set(
                float(len(model.config.effective_buckets())),
                model=name, version=str(version))
        self._refresh_gauges()

    def _reserve_advisory(self, rname: str, nbytes: int,
                          model: str, version, shards: int = 1) -> None:
        try:
            self.arena.reserve_sharded(rname, nbytes, shards)
        except ArenaExhausted as exc:
            self._journal("budget_overcommit", model=model, version=version,
                          severity="WARNING", reservation=rname,
                          nbytes=nbytes, error=str(exc))

    def on_model_unloaded(self, name: str) -> None:
        self.arena.release_prefix(f"bucket:{name}:")
        self.arena.release_prefix(f"kv:{name}:")
        self.arena.release_prefix(f"rowcache:{name}:")
        with self._lock:
            for key in [k for k in self._cooldown if k[0] == name]:
                del self._cooldown[key]
            self._applied = {k for k in self._applied if k[0] != name}
        self._refresh_gauges()

    def on_version_retired(self, name: str, version) -> None:
        """One version dropped or replaced by a re-load (the model stays
        up): its cooldowns, applied marks and reservations go, so a
        version coming back inherits none of them."""
        version = str(version)
        self.arena.release_prefix(f"bucket:{name}:{version}:")
        self.arena.release(f"kv:{name}:{version}")
        self.arena.release(f"rowcache:{name}:{version}")
        with self._lock:
            for key in [k for k in self._cooldown
                        if k[0] == name and k[1] == version]:
                del self._cooldown[key]
            self._applied = {k for k in self._applied
                             if not (k[0] == name and k[1] == version)}
        self._refresh_gauges()

    # -- the decision pass ----------------------------------------------------

    def tick(self) -> list[dict]:
        """One evaluation pass (the loop calls this every ``interval_s``;
        tests call it directly for determinism). Returns the decisions
        applied or rejected this pass."""
        if self._metrics is not None:
            self._metrics["ticks"].inc()
        snap = self.engine.profiler.snapshot()
        out: list[dict] = []
        for entry in snap.get("models", {}).values():
            name, version = entry["model"], entry["version"]
            sched = self.engine.scheduler_for(name, version)
            if sched is None or sched.model.config.axis_capacity() <= 0:
                continue
            for sug in entry.get("suggestions") or []:
                action = sug.get("action")
                if action == "add_bucket":
                    d = self._try_add(sched, entry, sug)
                elif action == "retire_bucket":
                    d = self._try_retire(sched, entry, sug)
                else:
                    d = None
                if d is not None:
                    out.append(d)
        self._refresh_gauges()
        return out

    def _cooling(self, key: tuple) -> bool:
        with self._lock:
            return time.monotonic() < self._cooldown.get(key, 0.0)

    def _set_cooldown(self, *keys: tuple) -> None:
        deadline = time.monotonic() + self.config.cooldown_s
        with self._lock:
            for key in keys:
                self._cooldown[key] = deadline

    def _record(self, action: str, name: str, version, bucket: int,
                applied: bool, **detail) -> dict:
        d = {"action": action, "model": name, "version": str(version),
             "bucket": bucket, "applied": applied,
             "ts": round(time.time(), 3), **detail}
        with self._lock:
            self._decisions.append(d)
            if applied:
                self._applied.add((name, str(version), action, bucket))
        return d

    def _try_add(self, sched, entry: dict, sug: dict) -> dict | None:
        name, version = entry["model"], entry["version"]
        model = sched.model
        candidate = int(sug["bucket"])
        ladder = sched.bucket_ladder()
        if candidate in ladder or not 1 <= candidate <= \
                model.config.axis_capacity():
            return None
        if len(ladder) >= self.config.max_ladder:
            return None
        # Re-validate the profiler's evidence against OUR thresholds (the
        # profiler's suggestion constants may be looser than this config).
        src = next((b for b in entry["buckets"]
                    if b["bucket"] == sug.get("below")), None)
        if src is None or src["executions"] < self.config.min_calls \
                or src["fill_ratio"] >= self.config.max_fill:
            return None
        key = (name, str(version), "add_bucket", candidate)
        if self._cooling(key):
            return None
        self._set_cooldown(key)
        # 1. Budget first: never pay a warm execution for a bucket that
        # cannot be kept.
        rname = f"bucket:{name}:{version}:{candidate}"
        nbytes = self._bucket_nbytes(model, candidate)
        try:
            self.arena.reserve(rname, nbytes)
        except ArenaExhausted as exc:
            self._count("rejected_budget", name, str(version))
            self._journal("rejected_budget", model=name, version=version,
                          severity="WARNING", bucket=candidate,
                          nbytes=nbytes, fill_ratio=sug.get("fill_ratio"),
                          below=sug.get("below"), error=str(exc))
            return self._record("rejected_budget", name, version,
                                candidate, applied=False, nbytes=nbytes)
        # 2. Warm off the hot path: one execution at exactly the candidate
        # shape on this thread, while the workers serve the old ladder.
        try:
            compile_s = model.warm_bucket(candidate)
        except Exception as exc:  # noqa: BLE001 — journalled, refused
            self.arena.release(rname)
            self._journal("compile_failed", model=name, version=version,
                          severity="ERROR", bucket=candidate,
                          error=str(exc))
            return self._record("compile_failed", name, version,
                                candidate, applied=False, error=str(exc))
        if self._metrics is not None and compile_s:
            self._metrics["compile_seconds"].inc(compile_s)
        # 3. Promotion: later batches may land on the candidate; batches in
        # flight are untouched.
        new_ladder = sched.swap_ladder(ladder + [candidate])
        self._count("add_bucket", name, str(version))
        if self._metrics is not None:
            self._metrics["ladder"].set(
                float(len(new_ladder)), model=name, version=str(version))
        self._journal("add_bucket", model=name, version=version,
                      bucket=candidate, below=sug.get("below"),
                      fill_ratio=sug.get("fill_ratio"),
                      est_saving_device_s=sug.get("est_saving_device_s"),
                      compile_s=round(compile_s, 3), ladder=new_ladder,
                      reserved_bytes=nbytes)
        _log.info("autotune: model '%s' v%s: promoted bucket %d "
                  "(ladder %s, compile %.3fs)", name, version, candidate,
                  new_ladder, compile_s)
        return self._record("add_bucket", name, version, candidate,
                            applied=True, below=sug.get("below"),
                            compile_s=round(compile_s, 3),
                            ladder=new_ladder)

    def _try_retire(self, sched, entry: dict, sug: dict) -> dict | None:
        name, version = entry["model"], entry["version"]
        bucket = int(sug["bucket"])
        ladder = sched.bucket_ladder()
        # The ladder's invariants: the bucket is in it, is not its
        # capacity (pick_bucket covers every legal batch), and the ladder
        # keeps at least one bucket.
        if bucket not in ladder or bucket == max(ladder) or len(ladder) <= 1:
            return None
        if sug.get("calls_per_min", 0.0) >= self.config.retire_rate_per_min:
            return None
        key = (name, str(version), "retire_bucket", bucket)
        if self._cooling(key):
            return None
        # Re-adding what we just retired must also wait out the cooldown.
        self._set_cooldown(key, (name, str(version), "add_bucket", bucket))
        new_ladder = sched.swap_ladder([b for b in ladder if b != bucket])
        self.arena.release(f"bucket:{name}:{version}:{bucket}")
        self._count("retire_bucket", name, str(version))
        if self._metrics is not None:
            self._metrics["ladder"].set(
                float(len(new_ladder)), model=name, version=str(version))
        self._journal("retire_bucket", model=name, version=version,
                      bucket=bucket,
                      calls_per_min=sug.get("calls_per_min"),
                      ladder=new_ladder)
        _log.info("autotune: model '%s' v%s: retired bucket %d "
                  "(ladder %s)", name, version, bucket, new_ladder)
        return self._record("retire_bucket", name, version, bucket,
                            applied=True, ladder=new_ladder)

    # -- /v2/profile annotation -----------------------------------------------

    def annotate(self, snap: dict) -> dict:
        """Fold tuner state into a profiler snapshot: a top-level
        ``autotune`` section (config, arena layout, recent decisions) and
        a ``state`` on every suggestion — ``applied`` when the tuner has
        already acted on it, ``suggested`` otherwise."""
        with self._lock:
            applied = set(self._applied)
            decisions = list(self._decisions)
        for entry in snap.get("models", {}).values():
            name, version = entry["model"], str(entry["version"])
            sugs = list(entry.get("suggestions") or [])
            single = entry.get("suggestion")
            if single is not None:
                sugs.append(single)
            for sug in sugs:
                key = (name, version, sug.get("action"),
                       int(sug.get("bucket", -1)))
                sug["state"] = "applied" if key in applied else "suggested"
            sched = self.engine.scheduler_for(name, entry["version"])
            if sched is not None:
                entry["autotune"] = {"ladder": sched.bucket_ladder()}
        snap["autotune"] = {
            "enabled": True,
            "config": self.config.summary(),
            "arena": self.arena.snapshot(),
            "decisions": decisions,
        }
        return snap


class DispatchTuner:
    """Load-adaptive dispatch tuning: the self-drive loop that acts on
    duty-cycle, queue wait, and fill *together* (the bucket
    :class:`Autotuner` above only reads fill).

    Per model, each tick classifies the operating point and actuates
    through :meth:`Scheduler.set_dispatch_override` (tighten-only) and
    the admission controller's dynamic concurrency cap:

    - **starved** (fill below ``fill_low``, queue wait near zero):
      arrivals are too sparse to fill the configured batch — waiting out
      the full dispatch deadline buys nothing but padding. Tighten: cap
      ``max_batch`` just above the observed mean batch occupancy (so the
      bucket picker lands on a small, *full* bucket) and cut the gather
      deadline by ``deadline_factor`` (floored at ``min_deadline_us``).
    - **backlogged** (queue wait above ``wait_high_s``): full batches
      are exactly what soaks a backlog — walk any dispatch override back
      out immediately; when duty-cycle is also above ``duty_high`` the
      device itself is the bottleneck, so additionally nudge the model's
      admission concurrency cap down (shed early rather than queue).
    - **quiet**: after ``restore_hold_s`` with neither condition,
      restore one step per window (override widens multiplicatively,
      concurrency cap clears) — the QoS governor's stepwise idiom.

    Damping: per-(model, action) cooldowns space repeated actuations; a
    journal edge fires only on the inactive->active transition
    (``autotune.dispatch_tighten`` / ``autotune.concurrency_nudge``) and
    on the full restore (``autotune.dispatch_restore`` /
    ``autotune.concurrency_restore``), never per tick. The clock is
    injectable so hysteresis is provable on a fake clock."""

    def __init__(self, engine, *, fill_low: float = 0.5,
                 wait_high_s: float = 0.5, duty_high: float = 0.85,
                 min_deadline_us: int = 100, deadline_factor: float = 0.5,
                 min_calls: int = 8, cooldown_s: float = 30.0,
                 restore_hold_s: float = 30.0,
                 concurrency_floor: int = 2, clock=time.monotonic):
        self.engine = engine
        self.fill_low = float(fill_low)
        self.wait_high_s = float(wait_high_s)
        self.duty_high = float(duty_high)
        self.min_deadline_us = max(0, int(min_deadline_us))
        self.deadline_factor = min(0.95, max(0.05, float(deadline_factor)))
        self.min_calls = max(1, int(min_calls))
        self.cooldown_s = float(cooldown_s)
        self.restore_hold_s = float(restore_hold_s)
        self.concurrency_floor = max(1, int(concurrency_floor))
        self._clock = clock
        self._lock = lockdep.Lock("engine.dispatch_tuner")
        # (model, version) -> mutable loop state.
        self._state: dict[tuple, dict] = {}
        self._decisions: deque[dict] = deque(maxlen=64)
        self.action_count = 0

    # -- helpers --------------------------------------------------------------

    def _journal(self, name: str, model: str, version,
                 severity: str = "INFO", **detail) -> None:
        journal().emit("autotune", name, model=model,
                       version=str(version) if version is not None else None,
                       severity=severity, **detail)

    def _note(self, st: dict, action: str, name: str, version,
              **detail) -> dict:
        now = self._clock()
        st["cooldown"][action] = now + self.cooldown_s
        d = {"action": action, "model": name, "version": str(version),
             **detail}
        with self._lock:
            self._decisions.append(d)
            self.action_count += 1
        return d

    def _cooling(self, st: dict, action: str) -> bool:
        return self._clock() < st["cooldown"].get(action, 0.0)

    # -- one evaluation pass ---------------------------------------------------

    def tick(self) -> list[dict]:
        """Classify every batched model and actuate; returns the
        decisions taken this pass (tests drive this directly)."""
        snap = self.engine.profiler.snapshot()
        loads = self.engine.admission.load_snapshot()
        duty = float(snap.get("duty_cycle") or 0.0)
        out: list[dict] = []
        seen: set[tuple] = set()
        for entry in snap.get("models", {}).values():
            name, version = entry["model"], entry["version"]
            seen.add((name, str(version)))
            sched = self.engine.scheduler_for(name, version)
            if sched is None:
                continue
            cfg = sched.model.config
            dyn = cfg.dynamic_batching
            if dyn is None or cfg.max_batch_size <= 1:
                continue
            buckets = entry.get("buckets") or []
            execs = sum(b["executions"] for b in buckets)
            rows = sum(b["rows"] for b in buckets)
            padded = sum(b["padded_rows"] for b in buckets)
            depth = sched.queue.qsize()
            service = loads.get(name, {}).get("ewma_service_s", 0.0)
            wait_s = depth * service / max(1, cfg.instance_count)
            with self._lock:  # snapshot() iterates _state concurrently
                st = self._state.setdefault((name, str(version)), {
                    "tight": False, "nudged": False, "cooldown": {},
                    "quiet_since": None, "prev": (0, 0, 0)})
            # Profiler bucket counters are cumulative — classify on the
            # delta since the last classification, so a model that goes
            # idle reads as quiet (and restores) instead of frozen at
            # its last fill ratio forever.
            pe, pr, pp = st.get("prev", (0, 0, 0))
            if execs < pe or rows < pr or padded < pp:
                pe = pr = pp = 0  # counters reset (reload/unload)
            d_execs, d_rows = execs - pe, rows - pr
            d_padded = padded - pp
            fill = d_rows / max(1, d_rows + d_padded)
            # No executions at all since the previous pass = idle, even
            # if a sub-min_calls residue is still accumulating.
            stalled = execs == st.get("last_seen", -1)
            st["last_seen"] = execs
            backlogged = wait_s >= self.wait_high_s
            if backlogged:
                st["prev"] = (execs, rows, padded)
                st["quiet_since"] = None
                out.extend(self._on_backlog(st, sched, name, version,
                                            duty, wait_s, loads))
            elif d_execs >= self.min_calls:
                st["prev"] = (execs, rows, padded)
                if fill < self.fill_low:
                    st["quiet_since"] = None
                    d = self._on_starved(st, sched, entry, name, version,
                                         fill, d_rows, d_execs)
                    if d is not None:
                        out.append(d)
                else:
                    out.extend(self._on_quiet(st, sched, name, version))
            elif d_execs == 0 or stalled:
                # Fully idle since the last pass: quiet. A stalled
                # partial delta is discarded, not hoarded forever.
                st["prev"] = (execs, rows, padded)
                out.extend(self._on_quiet(st, sched, name, version))
            # else: a trickle below min_calls — keep accumulating the
            # delta; no classification, no actuation.
        # A fully idle model ages out of the profiler window and stops
        # appearing in the snapshot — exactly when its override should
        # restore. Walk actuated states the pass above never visited.
        with self._lock:
            stale = [(k, st) for k, st in self._state.items()
                     if k not in seen and (st["tight"] or st["nudged"])]
        for (name, version), st in stale:
            sched = self.engine.scheduler_for(name, version)
            if sched is None:
                continue
            out.extend(self._on_quiet(st, sched, name, version))
        return out

    def _on_starved(self, st: dict, sched, entry: dict, name: str,
                    version, fill: float, rows: int,
                    execs: int) -> dict | None:
        if self._cooling(st, "dispatch"):
            return None
        cfg = sched.model.config
        cur = sched.dispatch_overrides()
        dyn = cfg.dynamic_batching
        cur_delay = cur.get("max_queue_delay_us",
                            dyn.max_queue_delay_microseconds)
        new_delay = max(self.min_deadline_us,
                        int(cur_delay * self.deadline_factor))
        # Cap the batch just above observed occupancy: the bucket picker
        # then lands on a small bucket that actually fills, instead of
        # padding the configured maximum.
        mean_rows = max(1.0, rows / max(1, execs))
        cap = 1
        while cap < mean_rows:
            cap *= 2
        cap = min(cfg.max_batch_size, cap)
        if new_delay >= cur_delay and cap >= cur.get(
                "max_batch", cfg.max_batch_size):
            return None  # already at the floor — nothing to tighten
        sched.set_dispatch_override(max_queue_delay_us=new_delay,
                                    max_batch=cap)
        entered = not st["tight"]
        st["tight"] = True
        if entered:
            self._journal("dispatch_tighten", name, version,
                          severity="WARNING", fill_ratio=round(fill, 4),
                          max_batch=cap, max_queue_delay_us=new_delay)
        return self._note(st, "dispatch", name, version,
                          fill_ratio=round(fill, 4), max_batch=cap,
                          max_queue_delay_us=new_delay)

    def _on_backlog(self, st: dict, sched, name: str, version,
                    duty: float, wait_s: float, loads: dict) -> list[dict]:
        out = []
        # A backlog wants full batches: drop any dispatch tightening NOW
        # (no cooldown — holding a starvation override through a burst
        # would throttle exactly when throughput matters).
        if st["tight"]:
            sched.set_dispatch_override()
            st["tight"] = False
            self._journal("dispatch_restore", name, version,
                          wait_s=round(wait_s, 4), reason="backlog")
            out.append(self._note(st, "dispatch_restore", name, version,
                                  reason="backlog"))
        if duty >= self.duty_high and not self._cooling(st, "concurrency"):
            adm = self.engine.admission
            inflight = loads.get(name, {}).get("inflight", 0)
            cur = adm.concurrency_cap(name) or max(
                inflight, self.concurrency_floor * 2)
            cap = max(self.concurrency_floor, int(cur * 0.75))
            if cap < cur:
                adm.set_concurrency_cap(name, cap)
                entered = not st["nudged"]
                st["nudged"] = True
                if entered:
                    self._journal("concurrency_nudge", name, version,
                                  severity="WARNING", cap=cap,
                                  duty_cycle=round(duty, 4),
                                  wait_s=round(wait_s, 4))
                out.append(self._note(st, "concurrency", name, version,
                                      cap=cap))
        return out

    def _on_quiet(self, st: dict, sched, name: str, version) -> list[dict]:
        if not (st["tight"] or st["nudged"]):
            st["quiet_since"] = None
            return []
        now = self._clock()
        if st["quiet_since"] is None:
            st["quiet_since"] = now
            return []
        if now - st["quiet_since"] < self.restore_hold_s:
            return []
        # One restore step per quiet window, then the window restarts.
        st["quiet_since"] = now
        out = []
        if st["nudged"]:
            self.engine.admission.set_concurrency_cap(name, None)
            st["nudged"] = False
            self._journal("concurrency_restore", name, version)
            out.append(self._note(st, "concurrency_restore", name,
                                  version))
            return out
        cfg = sched.model.config
        dyn = cfg.dynamic_batching
        cur = sched.dispatch_overrides()
        new_delay = min(dyn.max_queue_delay_microseconds,
                        max(1, int(cur.get(
                            "max_queue_delay_us",
                            dyn.max_queue_delay_microseconds))
                            * 2))
        new_cap = min(cfg.max_batch_size,
                      cur.get("max_batch", cfg.max_batch_size) * 2)
        if new_delay >= dyn.max_queue_delay_microseconds \
                and new_cap >= cfg.max_batch_size:
            sched.set_dispatch_override()
            st["tight"] = False
            self._journal("dispatch_restore", name, version,
                          reason="quiet")
            out.append(self._note(st, "dispatch_restore", name, version,
                                  reason="quiet"))
        else:
            sched.set_dispatch_override(max_queue_delay_us=new_delay,
                                        max_batch=new_cap)
            out.append(self._note(st, "dispatch_step", name, version,
                                  max_batch=new_cap,
                                  max_queue_delay_us=new_delay))
        return out

    def snapshot(self) -> dict:
        """Loop state for observability surfaces (/v2/profile's
        ``selfdrive`` section): per-model phase plus recent decisions."""
        with self._lock:
            decisions = list(self._decisions)
            models = {f"{n}:{v}": {"tight": st["tight"],
                                   "nudged": st["nudged"]}
                      for (n, v), st in self._state.items()}
        return {"models": models, "decisions": decisions,
                "action_count": self.action_count}
