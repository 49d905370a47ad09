"""Continuous efficiency profiler: where does the card's time go?

The port's copy of ``client_tpu/observability/profiler.py``, recorded
from ``Model.execute_timed`` and the generative scheduler at the cost of
a few dict operations per batch:

- **Batch-fill cost attribution**: per (model, version, bucket) the
  executions, real and padded rows, device and host time and their
  EWMA, rendered as ``tpu_batch_fill_ratio`` and
  ``tpu_padded_rows_total``.
- **First executions**: a bucket's first execution is the port's
  "compile" (a kernel's first-use build, cuBLAS's handle and workspace
  set-up): it counts on ``tpu_xla_compilations_total`` (the reference's
  wire name), observes ``tpu_xla_compile_seconds``, is journalled as
  ``compile.finished``, and is kept out of device time.
- **Device duty cycle**: a sliding window (``CLIENT_TPU_PROFILE_WINDOW_S``,
  default 60 s) of busy intervals (CUDA-event device time of each warm
  execution and of each decode wave), sampled at scrape time into
  ``tpu_device_duty_cycle``, with ``tpu_device_seconds_total`` per model.
- **Roofline**: the counted cost of each bucket and wave shape
  (:mod:`client_tpu_torch.observability.roofline`) joined to its device
  seconds: ``tpu_model_flops_total``, ``tpu_mfu`` and ``tpu_mbu``.

The profiler is process-global (:func:`profiler`) because models record
from below the engine; each engine binds its own ``MetricRegistry``
(:meth:`EfficiencyProfiler.bind_metrics`, weak references: a dead engine
is pruned, a rebind replaces). ``GET /v2/profile`` is
:meth:`EfficiencyProfiler.snapshot`.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass, field

from client_tpu_torch.config import env_float
from client_tpu_torch.observability import roofline as _roofline
from client_tpu_torch.utils import lockdep

# Fill ratio lives in (0, 1]; power-of-two ladders can't go below 0.5 but
# custom ladders (and max_batch_size overflow buckets) can.
FILL_RATIO_BUCKETS = (0.25, 0.5, 0.625, 0.75, 0.875, 1.0)
# A first execution's set-up: the reference's compile ladder.
COMPILE_SECONDS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                           20.0, 40.0, 80.0, 160.0)
# Decode wave steps, the reference's ladder.
WAVE_SECONDS_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                        0.05, 0.1, 0.25, 1.0)

# EWMA smoothing for per-call device/host time (~last 10 calls dominate).
_EWMA_ALPHA = 0.2

# A bucket ladder tweak is only suggested once a bucket has enough calls
# to make its fill ratio meaningful, and only when it wastes real time.
_SUGGEST_MIN_CALLS = 8
_SUGGEST_MAX_FILL = 0.85
# A bucket is "cold" (a retire candidate) when its call rate over the
# profile window drops below this floor: a bucket nobody uses decays to
# ~0 calls/min once the window slides past it.
_SUGGEST_RETIRE_RATE_PER_MIN = 0.5


@dataclass
class _BucketCost:
    """Accumulated cost of one (model, version, bucket) execution shape."""

    calls: int = 0
    cold_calls: int = 0
    rows: int = 0            # real rows executed
    padded_rows: int = 0     # zero rows added to reach the bucket
    device_ns: int = 0       # executable time, warm calls only
    host_ns: int = 0         # staging + fetch host time, warm calls only
    device_ns_ewma: float = 0.0
    host_ns_ewma: float = 0.0
    compile_count: int = 0
    compile_ns: int = 0
    max_rows: int = 0
    # Which quantity the bucket pads: "rows" (default) or "lookups"
    # (ragged DLRM — ``rows`` above then counts summed lookups, and the
    # fill/suggestion math is identical; only renderers need the tag so a
    # 512-lookup bucket isn't misread as a 512-row batch).
    axis: str = "rows"
    # Recency tracking for retire suggestions: a two-window rotation gives
    # an O(1)-per-call sliding call rate (a timestamp deque would cost
    # memory proportional to call rate — thousands/s under load). The
    # current window accumulates calls since ``win_start``; when it
    # exceeds the profiler window it rotates into ``prev_*``. The rate at
    # snapshot time is (prev + current calls) / (prev + current span) —
    # a bucket that goes quiet decays toward zero as the span grows.
    first_seen: int = 0      # mono ns of first record (0 = never)
    win_start: int = 0       # current rate-window start, mono ns
    win_calls: int = 0
    prev_win_s: float = 0.0  # span of the rotated-out window, seconds
    prev_win_calls: int = 0
    # The cost counted at the bucket's first execution (record_cost_model):
    # {"available": True, "flops", "bytes_accessed", ...} or the
    # annotated absence. None until the first capture attempt.
    cost_model: dict | None = None

    def fill_ratio(self) -> float:
        total = self.rows + self.padded_rows
        return (self.rows / total) if total else 1.0

    def padding_waste_device_s(self) -> float:
        """Device seconds spent on padding rows: the executable runs the
        full bucket, so the padded fraction of its time is pure waste."""
        total = self.rows + self.padded_rows
        if not total or not self.padded_rows:
            return 0.0
        return (self.device_ns / 1e9) * (self.padded_rows / total)

    def touch(self, now: int, window_ns: int) -> None:
        """Count one call into the sliding rate window (rotate first when
        the current window has outlived the profiler window)."""
        if self.first_seen == 0:
            self.first_seen = now
        if self.win_start == 0:
            self.win_start = now
        elif now - self.win_start >= window_ns:
            self.prev_win_calls = self.win_calls
            self.prev_win_s = (now - self.win_start) / 1e9
            self.win_calls = 0
            self.win_start = now
        self.win_calls += 1

    def calls_per_min(self, now: int) -> float:
        """Sliding call rate: counted calls over the covered span (clamped
        to ≥1 s so a just-created bucket doesn't read as infinite)."""
        if self.win_start == 0:
            return 0.0
        span_s = (now - self.win_start) / 1e9 + self.prev_win_s
        return 60.0 * (self.win_calls + self.prev_win_calls) \
            / max(span_s, 1.0)


@dataclass
class _WaveCost:
    """Accumulated decode-wave timing for one (model, version, bucket,
    chunk) shape — fed by the generative scheduler at fetch time (waves
    don't pass through ``Model.execute_timed``; they are dispatched
    pipelined and their occupancy is only known when the token fetch
    lands)."""

    waves: int = 0
    dispatches: int = 0      # executable launches (waves / chunk)
    # Dispatches run cold (a shape's first, counted for the roofline):
    # in the counts, kept out of the device time.
    cold_dispatches: int = 0
    device_ns: int = 0
    wave_ns_ewma: float = 0.0
    # Per-dispatch per-wave samples for snapshot percentiles; bounded so
    # a long-running engine can't grow it.
    recent: deque = field(default_factory=lambda: deque(maxlen=512))
    # Static cost of one dispatch (the whole K-chunk, not one wave).
    cost_model: dict | None = None


class _Bound:
    """One engine registry's instrument handles (see bind_metrics)."""

    __slots__ = ("registry_ref", "fill_ratio", "padded_rows",
                 "compilations", "compile_seconds", "device_seconds",
                 "duty_cycle", "wave_seconds", "model_flops",
                 "mfu", "mbu")

    def __init__(self, registry):
        self.registry_ref = weakref.ref(registry)
        self.fill_ratio = registry.histogram(
            "tpu_batch_fill_ratio",
            "Real rows / padded bucket rows per device execution",
            ("model", "version"), buckets=FILL_RATIO_BUCKETS)
        self.padded_rows = registry.counter(
            "tpu_padded_rows_total",
            "Zero rows added to reach the batch bucket (pure device waste)",
            ("model", "version", "bucket"))
        self.compilations = registry.counter(
            "tpu_xla_compilations_total",
            "XLA compilations (first call per model/bucket signature)",
            ("model", "version", "bucket"))
        self.compile_seconds = registry.histogram(
            "tpu_xla_compile_seconds",
            "XLA compile duration per first-call bucket trace (seconds)",
            ("model", "version"), buckets=COMPILE_SECONDS_BUCKETS)
        self.device_seconds = registry.counter(
            "tpu_device_seconds_total",
            "Cumulative executable-busy device time (warm executions)",
            ("model", "version"))
        self.duty_cycle = registry.gauge(
            "tpu_device_duty_cycle",
            "Busy device time / wall time over the profiler window "
            "(sampled at scrape; >1.0 means concurrent instances)")
        self.duty_cycle.set(0.0)
        self.wave_seconds = registry.histogram(
            "tpu_decode_wave_seconds",
            "Per-wave decode step time of the generative engine "
            "(bucket = wave lane count, chunk = waves per dispatch)",
            ("model", "version", "bucket", "chunk"),
            buckets=WAVE_SECONDS_BUCKETS)
        self.model_flops = registry.counter(
            "tpu_model_flops_total",
            "XLA cost-model FLOPs dispatched by warm executions "
            "(static flops per call, padded bucket priced in full)",
            ("model", "version", "bucket"))
        self.mfu = registry.gauge(
            "tpu_mfu",
            "Model FLOP/s utilization per bucket: cost-model flops x "
            "warm calls / device seconds, over the device-kind peak "
            "(absent when peaks or cost model are unknown)",
            ("model", "version", "bucket"))
        self.mbu = registry.gauge(
            "tpu_mbu",
            "Memory bandwidth utilization per bucket: cost-model bytes "
            "accessed x warm calls / device seconds, over the "
            "device-kind peak (absent when unknown)",
            ("model", "version", "bucket"))


class EfficiencyProfiler:
    """Low-overhead always-on cost attribution; see module docstring."""

    def __init__(self, window_s: float | None = None, now=time.monotonic_ns):
        if window_s is None:
            window_s = env_float("CLIENT_TPU_PROFILE_WINDOW_S")
        self.window_s = max(1.0, window_s)
        self._now = now
        self._t0 = now()
        self._lock = lockdep.Lock("observability.profiler")
        self._costs: dict[tuple[str, str, int], _BucketCost] = {}
        # (model, version, wave bucket, chunk) -> _WaveCost.
        self._waves: dict[tuple[str, str, int, int], _WaveCost] = {}
        # (end_mono_ns, device_ns) of warm executions inside the window.
        self._busy: deque[tuple[int, int]] = deque()
        self._bound: dict[int, _Bound] = {}

    # -- metric binding ------------------------------------------------------

    def bind_metrics(self, registry) -> None:
        """Declare the profiler's metric families on an engine's
        MetricRegistry and mirror every later observation into it.
        Idempotent per registry; multiple engines may bind; dead
        registries are pruned on the next record."""
        b = _Bound(registry)
        with self._lock:
            self._bound[id(registry)] = b

    def _bindings(self) -> list[_Bound]:
        with self._lock:
            out = []
            for rid, b in list(self._bound.items()):
                if b.registry_ref() is None:
                    del self._bound[rid]
                else:
                    out.append(b)
            return out

    # -- recording (the hot path) -------------------------------------------

    def record_execution(self, model: str, version, bucket: int | None,
                         rows: int, device_ns: int, host_ns: int = 0,
                         cold: bool = False, axis: str = "rows") -> None:
        """One device execution: ``rows`` real units padded up to
        ``bucket`` (None/0 = unbatched model, no padding), taking
        ``device_ns`` in the executable and ``host_ns`` in staging+fetch.
        ``axis`` names the padded unit — batch "rows" (default) or summed
        embedding "lookups" for ragged models; the accounting is the same,
        renderers use the tag. ``cold=True`` (the bucket's first
        execution) keeps the call/row counts but excludes the interval
        from device-time accumulation: it is set-up, not load, and is
        accounted by :meth:`record_compile`."""
        key = (str(model), str(version), int(bucket or 0))
        rows = max(0, int(rows))
        padded = max(0, key[2] - rows) if key[2] else 0
        end = self._now()
        with self._lock:
            c = self._costs.get(key)
            if c is None:
                c = self._costs[key] = _BucketCost()
            c.axis = axis
            c.calls += 1
            c.rows += rows
            c.padded_rows += padded
            c.max_rows = max(c.max_rows, rows)
            c.touch(end, int(self.window_s * 1e9))
            if cold:
                c.cold_calls += 1
            else:
                c.device_ns += max(0, device_ns)
                c.host_ns += max(0, host_ns)
                c.device_ns_ewma = (
                    device_ns if c.device_ns_ewma == 0.0
                    else _EWMA_ALPHA * device_ns
                    + (1 - _EWMA_ALPHA) * c.device_ns_ewma)
                c.host_ns_ewma = (
                    host_ns if c.host_ns_ewma == 0.0
                    else _EWMA_ALPHA * host_ns
                    + (1 - _EWMA_ALPHA) * c.host_ns_ewma)
                self._busy.append((end, max(0, device_ns)))
                self._prune_locked(end)
            flops = 0.0
            if not cold and c.cost_model and c.cost_model.get("available"):
                flops = float(c.cost_model.get("flops", 0.0))
        fill = (rows / key[2]) if key[2] else 1.0
        for b in self._bindings():
            b.fill_ratio.observe(fill, model=key[0], version=key[1])
            if padded:
                b.padded_rows.inc(padded, model=key[0], version=key[1],
                                  bucket=str(key[2]))
            if not cold and device_ns > 0:
                b.device_seconds.inc(device_ns / 1e9,
                                     model=key[0], version=key[1])
            if flops > 0:
                b.model_flops.inc(flops, model=key[0], version=key[1],
                                  bucket=str(key[2]))

    def record_compile(self, model: str, version, bucket: int | None,
                       compile_ns: int, trace_id: str | None = None,
                       axis: str = "rows") -> None:
        """A bucket's first execution finished: count it, observe its
        duration, and journal ``compile.finished``. ``axis`` tags the
        bucket's padded unit."""
        key = (str(model), str(version), int(bucket or 0))
        with self._lock:
            c = self._costs.get(key)
            if c is None:
                c = self._costs[key] = _BucketCost()
            c.axis = axis
            c.compile_count += 1
            c.compile_ns += max(0, compile_ns)
        for b in self._bindings():
            b.compilations.inc(model=key[0], version=key[1],
                               bucket=str(key[2]))
            b.compile_seconds.observe(compile_ns / 1e9,
                                      model=key[0], version=key[1])
        from client_tpu_torch.observability.events import journal

        journal().emit("compile", "finished", model=key[0],
                       version=key[1], trace_id=trace_id,
                       bucket=key[2], compile_s=round(compile_ns / 1e9, 3))

    def record_cost_model(self, model: str, version, bucket: int | None,
                          cost: dict | None, axis: str = "rows") -> None:
        """Attach the cost counted at a bucket's first execution
        (:class:`client_tpu_torch.observability.roofline.CostCapture`,
        alongside :meth:`record_compile`). An available capture always
        replaces a prior one (a new input signature); an *unavailable*
        one only fills an empty slot."""
        if not cost:
            return
        key = (str(model), str(version), int(bucket or 0))
        with self._lock:
            c = self._costs.get(key)
            if c is None:
                c = self._costs[key] = _BucketCost()
            c.axis = axis
            if cost.get("available") or c.cost_model is None:
                c.cost_model = dict(cost)

    def record_wave_cost_model(self, model: str, version, bucket: int,
                               chunk: int, cost: dict | None) -> None:
        """Same contract as :meth:`record_cost_model` for a decode-wave
        executable — the cost prices one *dispatch* (all ``chunk``
        scanned waves), matching _WaveCost.dispatches."""
        if not cost:
            return
        key = (str(model), str(version), int(bucket), max(1, int(chunk)))
        with self._lock:
            w = self._waves.get(key)
            if w is None:
                w = self._waves[key] = _WaveCost()
            if cost.get("available") or w.cost_model is None:
                w.cost_model = dict(cost)

    def record_wave(self, model: str, version, bucket: int, chunk: int,
                    duration_ns: int, waves: int = 1,
                    cold: bool = False) -> None:
        """One generative decode dispatch completed: ``waves`` logical
        wave steps (``chunk`` > 1 when a scanned K-chunk) over a
        ``bucket``-lane executable took ``duration_ns`` of device
        occupancy.  Feeds ``tpu_decode_wave_seconds`` (one observation per
        logical wave, at the per-wave time), the snapshot's decode-wave
        table, and the duty-cycle window — generative waves never pass
        through ``Model.execute_timed``, so without this the busiest
        engine in the fleet read as idle. ``cold=True`` (a shape's first
        dispatch, run under the roofline's counter) counts the waves and
        the dispatch but keeps its time out, as ``record_execution`` keeps
        a cold execution's."""
        key = (str(model), str(version), int(bucket), max(1, int(chunk)))
        waves = max(1, int(waves))
        duration_ns = max(0, int(duration_ns))
        per_wave_ns = duration_ns / waves
        end = self._now()
        with self._lock:
            w = self._waves.get(key)
            if w is None:
                w = self._waves[key] = _WaveCost()
            w.waves += waves
            w.dispatches += 1
            if cold:
                w.cold_dispatches += 1
                return
            w.device_ns += duration_ns
            w.wave_ns_ewma = (
                per_wave_ns if w.wave_ns_ewma == 0.0
                else _EWMA_ALPHA * per_wave_ns
                + (1 - _EWMA_ALPHA) * w.wave_ns_ewma)
            w.recent.append(per_wave_ns)
            self._busy.append((end, duration_ns))
            self._prune_locked(end)
            flops = 0.0
            if w.cost_model and w.cost_model.get("available"):
                flops = float(w.cost_model.get("flops", 0.0))
        per_wave_s = per_wave_ns / 1e9
        for b in self._bindings():
            for _ in range(waves):
                b.wave_seconds.observe(per_wave_s, model=key[0],
                                       version=key[1], bucket=str(key[2]),
                                       chunk=str(key[3]))
            if flops > 0:
                b.model_flops.inc(flops, model=key[0], version=key[1],
                                  bucket=str(key[2]))

    def cost_models(self) -> dict:
        """The counted cost of each bucket, keyed ``(model, version,
        bucket)``, and of each wave shape, keyed ``(model, version, bucket,
        chunk)``: the capture's dicts, with the hand-written kernels'
        share (``kernel_flops``, ``kernel_bytes``) that the snapshot's
        roofline folds in."""
        with self._lock:
            out = {k: dict(c.cost_model) for k, c in self._costs.items()
                   if c.cost_model}
            out.update({k: dict(w.cost_model) for k, w in self._waves.items()
                        if w.cost_model})
        return out

    # -- duty cycle ----------------------------------------------------------

    def _prune_locked(self, now: int) -> None:
        horizon = now - int(self.window_s * 1e9)
        while self._busy and self._busy[0][0] < horizon:
            self._busy.popleft()

    def duty_cycle(self) -> float:
        """Busy device time / wall time over the sliding window. Intervals
        straddling the window edge contribute their overlap only."""
        now = self._now()
        window_ns = int(self.window_s * 1e9)
        start = now - window_ns
        with self._lock:
            self._prune_locked(now)
            busy = 0
            for end, dur in self._busy:
                busy += min(end, now) - max(end - dur, start)
        wall = min(window_ns, max(1, now - self._t0))
        return busy / wall

    def update_gauges(self) -> None:
        """Refresh ``tpu_device_duty_cycle`` and the per-bucket
        ``tpu_mfu`` / ``tpu_mbu`` gauges on every bound registry; called
        at scrape time so a quiet period still reads current. MFU/MBU
        rows exist only where both the cost model and the device peaks
        are known — an unknown-peaks CPU host scrapes the (empty)
        families cleanly rather than lying with zeros."""
        duty = self.duty_cycle()
        rows = self._utilization_rows()
        for b in self._bindings():
            b.duty_cycle.set(round(duty, 6))
            for model, version, bucket, mfu, mbu in rows:
                if mfu is not None:
                    b.mfu.set(round(mfu, 6), model=model, version=version,
                              bucket=bucket)
                if mbu is not None:
                    b.mbu.set(round(mbu, 6), model=model, version=version,
                              bucket=bucket)

    def _utilization_rows(self) -> list[tuple]:
        """(model, version, bucket, mfu, mbu) for every bucket with an
        available cost model and warm device time; wave cells aggregate
        across chunks into their lane bucket. Empty when peaks are
        unknown (CPU host without a CLIENT_TPU_ROOFLINE override)."""
        peaks = _roofline.resolve_peaks()
        if peaks is None or not (peaks.flops_per_s or peaks.bytes_per_s):
            return []
        agg: dict[tuple[str, str, str], list[float]] = {}
        with self._lock:
            for (mname, version, bucket), c in self._costs.items():
                warm = c.calls - c.cold_calls
                if warm <= 0 or c.device_ns <= 0:
                    continue
                if not (c.cost_model and c.cost_model.get("available")):
                    continue
                row = agg.setdefault((mname, version, str(bucket)),
                                     [0.0, 0.0, 0.0])
                row[0] += float(c.cost_model.get("flops", 0.0)) * warm
                row[1] += float(
                    c.cost_model.get("bytes_accessed", 0.0)) * warm
                row[2] += c.device_ns / 1e9
            for (mname, version, bucket, _chunk), w in self._waves.items():
                warm = w.dispatches - w.cold_dispatches
                if warm <= 0 or w.device_ns <= 0:
                    continue
                if not (w.cost_model and w.cost_model.get("available")):
                    continue
                row = agg.setdefault((mname, version, str(bucket)),
                                     [0.0, 0.0, 0.0])
                row[0] += float(w.cost_model.get("flops", 0.0)) * warm
                row[1] += float(
                    w.cost_model.get("bytes_accessed", 0.0)) * warm
                row[2] += w.device_ns / 1e9
        out = []
        for (mname, version, bucket), (flops, byts, dev_s) in agg.items():
            if dev_s <= 0:
                continue
            mfu = (flops / dev_s / peaks.flops_per_s) \
                if peaks.flops_per_s else None
            mbu = (byts / dev_s / peaks.bytes_per_s) \
                if peaks.bytes_per_s else None
            if mfu is not None or mbu is not None:
                out.append((mname, version, bucket, mfu, mbu))
        return out

    # -- report ---------------------------------------------------------------

    def snapshot(self, model: str | None = None) -> dict:
        """The ``GET /v2/profile`` body: per-model/per-bucket cost table
        with padding-waste estimates and a bucket-ladder suggestion."""
        now = self._now()
        ctx = _roofline.roofline_context()
        peaks_dict = ctx.get("peaks")
        peaks = None
        if isinstance(peaks_dict, dict):
            peaks = _roofline.PeakSpec(peaks_dict.get("flops_per_s"),
                                       peaks_dict.get("bytes_per_s"),
                                       peaks_dict.get("source", "registry"))
        with self._lock:
            items = sorted(self._costs.items())
            wave_items = sorted(
                (k, (w.waves, w.device_ns, w.wave_ns_ewma,
                     sorted(w.recent), w.dispatches, w.cost_model,
                     w.dispatches - w.cold_dispatches))
                for k, w in self._waves.items())
        models: dict[str, dict] = {}
        # Per-model roofline accumulators: [flops, bytes, wasted_flops,
        # covered_device_s] summed over buckets+waves with cost models.
        roofline_agg: dict[str, list[float]] = {}

        def model_entry(mname: str, version: str) -> dict:
            mkey = f"{mname}:{version}"
            entry = models.get(mkey)
            if entry is None:
                entry = models[mkey] = {
                    "model": mname, "version": version,
                    "device_s": 0.0, "host_s": 0.0,
                    "padding_waste_device_s": 0.0,
                    "compilations": 0, "compile_s": 0.0,
                    "buckets": [], "suggestion": None,
                    "suggestions": [],
                }
                roofline_agg[mkey] = [0.0, 0.0, 0.0, 0.0]
            return entry

        def accumulate_roofline(mkey: str, rl: dict,
                                device_s: float) -> None:
            if rl.get("cost_model") != "counted":
                return
            agg = roofline_agg[mkey]
            agg[0] += rl["total_flops"]
            agg[1] += rl["total_bytes"]
            agg[2] += rl["padding_wasted_flops"]
            agg[3] += device_s

        for (mname, version, bucket), c in items:
            if model and mname != model:
                continue
            entry = model_entry(mname, version)
            waste = c.padding_waste_device_s()
            entry["device_s"] += c.device_ns / 1e9
            entry["host_s"] += c.host_ns / 1e9
            entry["padding_waste_device_s"] += waste
            entry["compilations"] += c.compile_count
            entry["compile_s"] += c.compile_ns / 1e9
            warm = c.calls - c.cold_calls
            total_rows = c.rows + c.padded_rows
            rl = _roofline.bucket_roofline(
                c.cost_model, warm, c.device_ns / 1e9,
                (c.padded_rows / total_rows) if total_rows else 0.0,
                peaks)
            accumulate_roofline(f"{mname}:{version}", rl,
                                c.device_ns / 1e9)
            entry["buckets"].append({
                "bucket": bucket,
                "axis": c.axis,
                "roofline": rl,
                "executions": c.calls,
                "cold_executions": c.cold_calls,
                "rows": c.rows,
                "padded_rows": c.padded_rows,
                "max_rows": c.max_rows,
                "fill_ratio": round(c.fill_ratio(), 4),
                "device_s": round(c.device_ns / 1e9, 6),
                "host_s": round(c.host_ns / 1e9, 6),
                "device_s_per_call_ewma": round(c.device_ns_ewma / 1e9, 6),
                "host_s_per_call_ewma": round(c.host_ns_ewma / 1e9, 6),
                "padding_waste_device_s": round(waste, 6),
                "compilations": c.compile_count,
                "compile_s": round(c.compile_ns / 1e9, 6),
                "calls_per_min": round(c.calls_per_min(now), 3),
                "observed_s": round(
                    (now - c.first_seen) / 1e9 if c.first_seen else 0.0, 3),
            })
        # Generative decode waves (record_wave): per (bucket, chunk) wave
        # step times.  Wave device time also counts into the model's
        # device_s total — generative engines never pass execute_timed,
        # so without this their models profile as idle.
        for (mname, version, bucket, chunk), \
                (wv, dns, ewma, recent, dispatches, wcost, warm) \
                in wave_items:
            if model and mname != model:
                continue
            entry = model_entry(mname, version)
            entry["device_s"] += dns / 1e9
            rl = _roofline.bucket_roofline(wcost, warm, dns / 1e9, 0.0,
                                           peaks)
            accumulate_roofline(f"{mname}:{version}", rl, dns / 1e9)

            def pct(q: float) -> float:
                if not recent:
                    return 0.0
                return recent[min(len(recent) - 1, int(q * len(recent)))]

            entry.setdefault("decode_waves", []).append({
                "bucket": bucket,
                "chunk": chunk,
                "waves": wv,
                "dispatches": dispatches,
                "device_s": round(dns / 1e9, 6),
                "wave_ms_ewma": round(ewma / 1e6, 3),
                "wave_ms_p50": round(pct(0.5) / 1e6, 3),
                "wave_ms_p99": round(pct(0.99) / 1e6, 3),
                "roofline": rl,
            })
        for mkey, entry in models.items():
            entry["device_s"] = round(entry["device_s"], 6)
            entry["host_s"] = round(entry["host_s"], 6)
            entry["compile_s"] = round(entry["compile_s"], 6)
            entry["padding_waste_device_s"] = round(
                entry["padding_waste_device_s"], 6)
            entry["suggestion"] = _suggest_bucket_tweak(entry["buckets"])
            entry["suggestions"] = _suggest_ladder_tweaks(
                entry["buckets"], self.window_s)
            entry["roofline"] = _model_roofline(
                roofline_agg[mkey], entry["device_s"], peaks)
        return {
            "window_s": self.window_s,
            "duty_cycle": round(self.duty_cycle(), 6),
            "roofline": ctx,
            "models": models,
        }

    def reset(self) -> None:
        """Drop accumulated costs (a fresh start for a test or a run);
        metric bindings survive."""
        with self._lock:
            self._costs.clear()
            self._waves.clear()
            self._busy.clear()
            self._t0 = self._now()


def _model_roofline(agg: list[float], device_s: float, peaks) -> dict:
    """Model-level roofline rollup from the per-bucket accumulators
    (flops, bytes, padding-wasted flops, covered device seconds).
    ``cost_model_coverage`` is the fraction of the model's device time
    whose executables carry a cost model — the honesty knob: a 0.4
    coverage MFU describes 40% of the time, not the model."""
    flops, byts, wasted, covered_s = agg
    out = {
        "total_flops": flops,
        "total_bytes": byts,
        "padding_wasted_flops": wasted,
        "cost_model_coverage": round(covered_s / device_s, 4)
        if device_s > 0 else 0.0,
        "achieved_flops_per_s": None,
        "achieved_bytes_per_s": None,
        "arithmetic_intensity": None,
        "mfu": None,
        "mbu": None,
        "bound": "unknown",
    }
    if covered_s <= 0:
        return out
    achieved_f = flops / covered_s
    achieved_b = byts / covered_s
    intensity = (flops / byts) if byts > 0 else None
    out["achieved_flops_per_s"] = achieved_f
    out["achieved_bytes_per_s"] = achieved_b
    out["arithmetic_intensity"] = round(intensity, 4) \
        if intensity is not None else None
    out["bound"] = _roofline.classify_bound(intensity, peaks)
    if peaks and peaks.flops_per_s:
        out["mfu"] = round(achieved_f / peaks.flops_per_s, 6)
    if peaks and peaks.bytes_per_s:
        out["mbu"] = round(achieved_b / peaks.bytes_per_s, 6)
    return out


def _suggest_bucket_tweak(buckets: list[dict]) -> dict | None:
    """Greedy ladder tweak: the bucket wasting the most device time on
    padding, with enough calls to trust its fill ratio and headroom below
    it (max observed rows < bucket), suggests inserting a bucket at the
    observed row high-water mark. Returns None when the ladder looks
    right-sized."""
    worst = None
    for b in buckets:
        if b["bucket"] <= 1 or b["executions"] < _SUGGEST_MIN_CALLS:
            continue
        if b["fill_ratio"] >= _SUGGEST_MAX_FILL:
            continue
        if b["max_rows"] >= b["bucket"]:
            continue
        if worst is None or (b["padding_waste_device_s"]
                             > worst["padding_waste_device_s"]):
            worst = b
    if worst is None:
        return None
    suggested = max(1, worst["max_rows"])
    # Execution time scales about linearly with bucket rows, so
    # re-landing these executions on the smaller bucket saves the row
    # fraction of their device time.
    saving = worst["device_s"] * (1 - suggested / worst["bucket"])
    return {
        "action": "add_bucket",
        "bucket": suggested,
        "below": worst["bucket"],
        "fill_ratio": worst["fill_ratio"],
        "est_saving_device_s": round(saving, 6),
        "reason": (f"bucket {worst['bucket']} ran {worst['executions']} "
                   f"executions at {worst['fill_ratio']:.0%} fill "
                   f"(max {worst['max_rows']} real rows); a "
                   f"{suggested}-row bucket would absorb them"),
    }


def _suggest_ladder_tweaks(buckets: list[dict],
                           window_s: float) -> list[dict]:
    """The full suggestion list (the JAX package's autotuner acts on it;
    the port has none yet): the greedy
    ``add_bucket`` (same semantics as :func:`_suggest_bucket_tweak`) plus
    one ``retire_bucket`` per cold bucket — tracked for at least a full
    profile window yet called below :data:`_SUGGEST_RETIRE_RATE_PER_MIN`.
    The largest tracked bucket is never suggested for retirement (the
    ladder must keep covering max_batch_size)."""
    out: list[dict] = []
    add = _suggest_bucket_tweak(buckets)
    if add is not None:
        out.append(add)
    largest = max((b["bucket"] for b in buckets), default=0)
    for b in buckets:
        if b["bucket"] < 1 or b["bucket"] >= largest:
            continue
        if b.get("observed_s", 0.0) < window_s:
            continue  # too young: absence of calls is not yet evidence
        rate = b.get("calls_per_min", 0.0)
        if rate >= _SUGGEST_RETIRE_RATE_PER_MIN:
            continue
        out.append({
            "action": "retire_bucket",
            "bucket": b["bucket"],
            "calls_per_min": rate,
            "reason": (f"bucket {b['bucket']} saw "
                       f"{rate:.2f} calls/min over the last "
                       f"{window_s:.0f}s window (floor "
                       f"{_SUGGEST_RETIRE_RATE_PER_MIN})"),
        })
    return out


# -- process-global default profiler ------------------------------------------

_default: EfficiencyProfiler | None = None
_default_lock = lockdep.Lock("observability.profiler.default")


def profiler() -> EfficiencyProfiler:
    """The process-global profiler (double-checked, like
    :func:`client_tpu_torch.observability.events.journal`): models record into
    it from below the engine; engines bind their metric registries to it
    from above."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = EfficiencyProfiler()
    return _default


def reset_profiler() -> None:
    """Drop the global profiler (tests); the next profiler() recreates it
    with current env settings."""
    global _default
    with _default_lock:
        _default = None
