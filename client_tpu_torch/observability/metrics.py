"""Prometheus-style metric primitives, and the engine's metric vocabulary.

The port's copy of ``client_tpu/observability/metrics.py``: Counter, Gauge
and Histogram (with exemplars) behind a :class:`MetricRegistry`, rendered
in the text exposition format 0.0.4 or, with ``openmetrics=True``, in
OpenMetrics 1.0 (counter samples suffixed ``_total``, bucket exemplars
``# {trace_id="..."} value`` linking to ``/v2/trace/requests``, and the
closing ``# EOF``). :class:`EngineMetrics` declares every family the JAX
engine declares, with the same names (the ``tpu_`` prefix is the wire
vocabulary), help, types and label sets, so a scraper reads both servers
alike. The HBM census, QoS and admission families are declared but fed
only by their planes. :class:`RouterMetrics` declares the router's
``tpu_router_*`` and ``tpu_fleet_*`` families, on a registry of its own.

- ``MetricRegistry.histogram/gauge/counter`` are get-or-create;
  declaring a name again with another type or labels raises.
- Child series (one per label combination) are made on first use; an
  ``observe``/``inc`` is a bisect and a few adds under a per-family lock.
- Rendering emits HELP, TYPE, then the samples of each family, label
  values escaped, histogram buckets cumulative up to ``+Inf``.
"""

from __future__ import annotations

from bisect import bisect_left

from client_tpu_torch.utils import lockdep

# Microsecond latency ladder: sub-ms queue hops through multi-second
# first-compile requests (16 finite buckets keeps series count modest).
DURATION_US_BUCKETS = (
    50, 100, 250, 500, 1000, 2500, 5000, 10_000, 25_000, 50_000,
    100_000, 250_000, 500_000, 1_000_000, 5_000_000, 30_000_000,
)
# Batch-size ladder matches power_buckets() padding (scheduler.py).
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def escape_label_value(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v) -> str:
    """Render a sample value: integral floats print as integers."""
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _label_str(labelnames, labelvalues) -> str:
    return ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in zip(labelnames, labelvalues))


class _Metric:
    """One metric family: name, help, a child per label-value combination."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}
        self._lock = lockdep.Lock("metrics.family")

    def labels(self, *values, **kw):
        if kw:
            values = tuple(kw[k] for k in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"metric '{self.name}' takes labels {self.labelnames}, "
                f"got {values}")
        values = tuple(str(v) for v in values)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    values, self._make_child())
        return child

    def _make_child(self):
        raise NotImplementedError

    def remove(self, **labels):
        """Drop one child series — for gauges tracking a resource that no
        longer exists (a detached shm ring, an unloaded model), where the
        last-set value would otherwise render stale forever."""
        values = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            self._children.pop(values, None)

    def _family_name(self, openmetrics: bool) -> str:
        return self.name

    def collect(self, openmetrics: bool = False) -> list[str]:
        fam = self._family_name(openmetrics)
        lines = [f"# HELP {fam} {escape_help(self.help)}",
                 f"# TYPE {fam} {self.kind}"]
        with self._lock:
            items = sorted(self._children.items())
        for values, child in items:
            lines.extend(self._render_child(values, child, openmetrics))
        return lines

    def _render_child(self, values, child,
                      openmetrics: bool = False) -> list[str]:
        raise NotImplementedError


class _Value:
    __slots__ = ("v", "lock")

    def __init__(self):
        self.v = 0.0
        self.lock = lockdep.Lock("metrics.value")


class _CounterValue:
    __slots__ = ("v", "exemplar", "lock")

    def __init__(self):
        self.v = 0.0
        # Last (increment, trace_id) supplied with an exemplar; rendered
        # on the OpenMetrics `_total` sample (the spec permits counter
        # exemplars) linking the series to /v2/trace/requests.
        self.exemplar: tuple[float, str] | None = None
        self.lock = lockdep.Lock("metrics.value")


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterValue()

    def inc(self, amount: float = 1.0, exemplar: str | None = None,
            **labels):
        """Add ``amount``; ``exemplar`` (a trace_id) is retained as the
        series' last exemplar for OpenMetrics rendering."""
        child = self.labels(**labels) if self.labelnames else self.labels()
        with child.lock:
            child.v += amount
            if exemplar:
                child.exemplar = (float(amount), str(exemplar))

    def _family_name(self, openmetrics: bool) -> str:
        # OpenMetrics advertises the counter by its base name and
        # suffixes every sample with `_total`.
        if openmetrics and self.name.endswith("_total"):
            return self.name[:-len("_total")]
        return self.name

    def _render_child(self, values, child,
                      openmetrics: bool = False) -> list[str]:
        ls = _label_str(self.labelnames, values)
        body = f"{{{ls}}}" if ls else ""
        name = self.name
        ex = ""
        if openmetrics:
            name = self._family_name(True) + "_total"
            if child.exemplar is not None:
                v, trace_id = child.exemplar
                ex = (f' # {{trace_id="{escape_label_value(trace_id)}"}} '
                      f"{format_value(v)}")
        return [f"{name}{body} {format_value(child.v)}{ex}"]


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _Value()

    def set(self, value: float, **labels):
        child = self.labels(**labels) if self.labelnames else self.labels()
        with child.lock:
            child.v = float(value)

    def inc(self, amount: float = 1.0, **labels):
        child = self.labels(**labels) if self.labelnames else self.labels()
        with child.lock:
            child.v += amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def _render_child(self, values, child,
                      openmetrics: bool = False) -> list[str]:
        ls = _label_str(self.labelnames, values)
        body = f"{{{ls}}}" if ls else ""
        return [f"{self.name}{body} {format_value(child.v)}"]


class _HistValue:
    __slots__ = ("counts", "sum", "exemplars", "lock")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the +Inf bucket
        # Last (value, trace_id) that landed in each bucket; OpenMetrics
        # exemplars linking a bucket straight to /v2/trace/requests.
        self.exemplars: list[tuple[float, str] | None] = \
            [None] * (n_buckets + 1)
        self.sum = 0.0
        self.lock = lockdep.Lock("metrics.value")


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labelnames: tuple[str, ...] = (),
                 buckets=DURATION_US_BUCKETS):
        super().__init__(name, help_text, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram '{name}' needs >= 1 finite bucket")
        self.buckets = tuple(bs)

    def _make_child(self):
        return _HistValue(len(self.buckets))

    def observe(self, value: float, exemplar: str | None = None, **labels):
        """Record ``value``; ``exemplar`` (a trace_id) is retained as the
        bucket's last exemplar for OpenMetrics rendering."""
        child = self.labels(**labels) if self.labelnames else self.labels()
        idx = bisect_left(self.buckets, value)
        with child.lock:
            child.counts[idx] += 1
            child.sum += value
            if exemplar:
                child.exemplars[idx] = (float(value), str(exemplar))

    def _render_child(self, values, child,
                      openmetrics: bool = False) -> list[str]:
        ls = _label_str(self.labelnames, values)
        with child.lock:
            counts = list(child.counts)
            exemplars = list(child.exemplars)
            total_sum = child.sum
        lines = []
        cum = 0
        sep = "," if ls else ""

        def _ex(i: int) -> str:
            if not openmetrics or exemplars[i] is None:
                return ""
            v, trace_id = exemplars[i]
            return (f' # {{trace_id="{escape_label_value(trace_id)}"}} '
                    f"{format_value(v)}")

        for i, (le, n) in enumerate(zip(self.buckets, counts)):
            cum += n
            lines.append(
                f'{self.name}_bucket{{{ls}{sep}le="{format_value(le)}"}} '
                f"{cum}{_ex(i)}")
        cum += counts[-1]
        lines.append(f'{self.name}_bucket{{{ls}{sep}le="+Inf"}} {cum}'
                     f"{_ex(len(counts) - 1)}")
        body = f"{{{ls}}}" if ls else ""
        lines.append(f"{self.name}_sum{body} {format_value(total_sum)}")
        lines.append(f"{self.name}_count{body} {cum}")
        return lines


class MetricRegistry:
    """Ordered collection of metric families with get-or-create semantics."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = lockdep.Lock("metrics.registry")

    def _get_or_create(self, cls, name, help_text, labelnames, **kw):
        labelnames = tuple(labelnames or ())
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != labelnames):
                    raise ValueError(
                        f"metric '{name}' already registered as "
                        f"{type(existing).__name__}{existing.labelnames}")
                return existing
            m = cls(name, help_text, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_text, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name, help_text, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name, help_text, labelnames=(),
                  buckets=DURATION_US_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labelnames,
                                   buckets=buckets)

    def render(self, openmetrics: bool = False) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.collect(openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + ("\n" if lines else "")


class ModelInstruments:
    """Per-model:version bound handles for the hot-path observations."""

    __slots__ = ("_em", "_labels")

    def __init__(self, em: "EngineMetrics", model: str, version: str):
        self._em = em
        self._labels = {"model": model, "version": version}

    def observe_request(self, total_ns: int, times,
                        trace_id: str | None = None,
                        tenant: str = "") -> None:
        em = self._em
        lab = self._labels
        em.request_duration_us.observe(max(0, total_ns) / 1e3,
                                       exemplar=trace_id,
                                       tenant=tenant or "default", **lab)
        em.phase_duration_us.observe(times.queue_ns / 1e3,
                                     phase="queue", **lab)
        em.phase_duration_us.observe(times.compute_input_ns / 1e3,
                                     phase="compute_input", **lab)
        em.phase_duration_us.observe(times.compute_infer_ns / 1e3,
                                     phase="compute_infer", **lab)
        em.phase_duration_us.observe(times.compute_output_ns / 1e3,
                                     phase="compute_output", **lab)

    def observe_execution(self, batch_size: int) -> None:
        self._em.batch_size.observe(batch_size, **self._labels)

    def record_rejection(self) -> None:
        self._em.queue_rejections.inc(**self._labels)

    def record_deadline_expired(self, stage: str) -> None:
        self._em.deadline_expirations.inc(stage=stage, **self._labels)


class EngineMetrics:
    """The engine's standard metric vocabulary on one registry.

    Histograms: tpu_request_duration_us, tpu_phase_duration_us{phase},
    tpu_batch_size. Gauges: tpu_queue_depth, tpu_inflight_batches,
    tpu_device_hbm_bytes_in_use, tpu_hbm_limit_bytes, tpu_hbm_peak_bytes,
    tpu_drain_duration_seconds. Counters: tpu_queue_rejections_total,
    tpu_admission_rejections_total{reason},
    tpu_deadline_expirations_total{stage}.
    """

    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry or MetricRegistry()
        r = self.registry
        self.request_duration_us = r.histogram(
            "tpu_request_duration_us",
            "End-to-end successful request duration (microseconds); "
            "tenant is the cost-ledger tag (bounded: registered tenants "
            "+ default + shadow, overflow folds to other)",
            ("model", "version", "tenant"))
        self.phase_duration_us = r.histogram(
            "tpu_phase_duration_us",
            "Per-phase request duration (microseconds)",
            ("model", "version", "phase"))
        self.batch_size = r.histogram(
            "tpu_batch_size",
            "Requests per model execution (batch size)",
            ("model", "version"), buckets=BATCH_SIZE_BUCKETS)
        self.queue_depth = r.gauge(
            "tpu_queue_depth",
            "Requests waiting in the scheduler queue",
            ("model", "version"))
        self.inflight_batches = r.gauge(
            "tpu_inflight_batches",
            "Batches currently executing on device",
            ("model", "version"))
        self.hbm_bytes = r.gauge(
            "tpu_device_hbm_bytes_in_use",
            "Device HBM bytes in use (0 when the platform does not report "
            "memory stats, e.g. CPU)",
            ("device",))
        self.hbm_limit_bytes = r.gauge(
            "tpu_hbm_limit_bytes",
            "Device HBM capacity limit (0 when the platform does not "
            "report memory stats, e.g. CPU)",
            ("device",))
        self.hbm_peak_bytes = r.gauge(
            "tpu_hbm_peak_bytes",
            "Peak device HBM bytes in use since process start (0 when the "
            "platform does not report memory stats, e.g. CPU)",
            ("device",))
        self.hbm_census_bytes = r.gauge(
            "tpu_hbm_census_bytes",
            "Live device-buffer bytes attributed to an owner by the HBM "
            "census (component: weights, kv_arena, embedding, rowcache, "
            "autotune_warm; the unattributed remainder rides with "
            "model=\"\", component=\"unattributed\")",
            ("model", "component"))
        self.hbm_plan_drift_bytes = r.gauge(
            "tpu_hbm_plan_drift_bytes",
            "Planner-reservation bytes minus census-actual bytes per "
            "owner (positive: the arena reserved more than is live; "
            "negative: live memory the plan never charged)",
            ("model", "component"))
        self.hbm_census_watermark_bytes = r.gauge(
            "tpu_hbm_census_watermark_bytes",
            "High-water committed device bytes observed by the census "
            "since process start")
        self.hbm_census_watermark_bytes.set(0)
        self.queue_rejections = r.counter(
            "tpu_queue_rejections_total",
            "Requests rejected at admission (backpressure, HTTP 429)",
            ("model", "version"))
        self.admission_rejections = r.counter(
            "tpu_admission_rejections_total",
            "Requests shed by the admission controller, by reason "
            "(queue_depth, estimated_wait, concurrency, throttled, "
            "draining) and cost-ledger tenant tag",
            ("model", "version", "reason", "tenant"))
        self.deadline_expirations = r.counter(
            "tpu_deadline_expirations_total",
            "Requests whose end-to-end deadline expired before the given "
            "stage ran (admission, queue, execute)",
            ("model", "version", "stage"))
        self.drain_duration = r.gauge(
            "tpu_drain_duration_seconds",
            "Wall time of the last graceful drain (0 until one runs)")
        self.drain_duration.set(0.0)
        self.qos_sheds = r.counter(
            "tpu_qos_sheds_total",
            "Requests shed by a per-class QoS gate, by class and reason "
            "(qos_inflight, qos_queue, qos_throttled)",
            ("qos_class", "reason"))
        self.qos_inflight = r.gauge(
            "tpu_qos_inflight",
            "Admitted-but-unfinished requests per QoS class",
            ("qos_class",))
        self.qos_throttle_ratio = r.gauge(
            "tpu_qos_throttle_ratio",
            "Governor throttle ratio per QoS class (1 = full configured "
            "token-bucket rate; the SLO-burn governor halves it per step)",
            ("qos_class",))
        self.qos_preemptions = r.counter(
            "tpu_qos_preemptions_total",
            "In-assembly batches split because a preempt-class request "
            "arrived (WFQ preemption)",
            ("model",))
        self._instruments: dict[tuple[str, str], ModelInstruments] = {}
        self._lock = lockdep.Lock("metrics.instruments")

    def model_instruments(self, model: str, version: str) -> ModelInstruments:
        key = (str(model), str(version))
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = ModelInstruments(self, key[0], key[1])
                    # Copy-on-write: lock-free fast-path readers only ever
                    # see a fully-built dict, never one mid-mutation.
                    updated = dict(self._instruments)
                    updated[key] = inst
                    self._instruments = updated
        return inst

    def update_device_gauges(self, census=None) -> None:
        """Refresh each visible card's bytes in use (the caching
        allocator's live tensor bytes), capacity and peak from the HBM
        census's device walk (``HbmCensus.device_stats``, one source for
        both), at scrape time. Without a card (``device="cpu"``) the
        gauges still render, pinned to 0 on device "0", as the JAX
        package's do on the CPU."""
        if census is None:
            from client_tpu_torch.observability.memory import hbm_census

            census = hbm_census()
        devices = census.device_stats()
        for d in devices:
            self.hbm_bytes.set(d["bytes_in_use"], device=d["device"])
            self.hbm_limit_bytes.set(d["bytes_limit"], device=d["device"])
            self.hbm_peak_bytes.set(d["peak_bytes_in_use"],
                                    device=d["device"])
        if not devices:
            self.hbm_bytes.set(0, device="0")
            self.hbm_limit_bytes.set(0, device="0")
            self.hbm_peak_bytes.set(0, device="0")

    def update_census_gauges(self, report: dict) -> None:
        """Refresh the attribution gauges from one census report
        (``TorchEngine.memory_census``), at scrape time like the device
        gauges."""
        for row in report.get("owners", ()):
            self.hbm_census_bytes.set(row["bytes"], model=row["model"],
                                      component=row["component"])
            if "drift_bytes" in row:
                self.hbm_plan_drift_bytes.set(
                    row["drift_bytes"], model=row["model"],
                    component=row["component"])
        self.hbm_census_bytes.set(report.get("unattributed_bytes", 0),
                                  model="", component="unattributed")
        self.hbm_census_watermark_bytes.set(
            report.get("watermark_bytes", 0))

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics)


class RouterMetrics:
    """The L7 router's metric vocabulary (``tpu_router_*``,
    ``tpu_fleet_*``), the JAX router's families by name, help, type and
    labels.

    On a registry of its own by default, so a router in one process with
    replicas scrapes only routing metrics from its ``/metrics``. Balance
    reads off ``tpu_router_requests_total{replica}``."""

    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry or MetricRegistry()
        r = self.registry
        self.requests = r.counter(
            "tpu_router_requests_total",
            "Requests forwarded, by replica and outcome (ok, error, "
            "pushback, unreachable)",
            ("replica", "outcome"))
        self.failovers = r.counter(
            "tpu_router_failovers_total",
            "Requests re-routed to another replica after the first "
            "candidate failed or pushed back, by failed replica",
            ("replica",))
        self.sheds = r.counter(
            "tpu_router_sheds_total",
            "Requests shed by the router itself: every candidate pushed "
            "back (all_pushback) or no replica was reachable (no_replica)",
            ("reason",))
        self.breaker_open = r.gauge(
            "tpu_router_breaker_open",
            "1 while the per-replica circuit breaker is open",
            ("replica",))
        self.replica_states = r.gauge(
            "tpu_router_replicas",
            "Replicas known to the router, by last observed health state",
            ("state",))
        self.request_duration_us = r.histogram(
            "tpu_router_request_duration_us",
            "Router-observed request duration including failovers "
            "(microseconds)",
            ("replica",))
        self.load_report_age = r.gauge(
            "tpu_router_load_report_age_seconds",
            "Seconds since each replica's load report was refreshed "
            "(piggyback or /v2/load poll)",
            ("replica",))
        self.affinity_routed = r.counter(
            "tpu_router_affinity_routed_total",
            "Requests pinned to a replica by sequence-id rendezvous "
            "affinity rather than P2C",
            ("replica",))
        self.drain_steps = r.counter(
            "tpu_router_drain_steps_total",
            "Rolling-drain steps executed, by replica and outcome "
            "(clean, dirty, timeout, skipped)",
            ("replica", "outcome"))
        self.fleet_drift_score = r.gauge(
            "tpu_fleet_drift_score",
            "Per-replica drift from the fleet median, by signal "
            "(duty_cycle, fill_ratio, wave_ms_p50, wait_s); unitless "
            "|v-median|/max(|median|,floor) skew",
            ("replica", "signal"))
        self.fleet_fetch_failures = r.counter(
            "tpu_fleet_fetch_failures_total",
            "Per-replica fetch failures while federating a fleet "
            "surface (events, profile, metrics, slo, trace)",
            ("replica", "surface"))

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics)
