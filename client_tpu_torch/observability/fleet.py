"""Fleet-level observability: merge N replicas' surfaces into one view.

The port's copy of ``client_tpu/observability/fleet.py``, the pure half
of the router's fleet plane. Given the payloads fetched from every
replica (by :class:`client_tpu_torch.router.fleet.FleetFederator`), it
merges them with each surface's semantics:

- **events** and **timeseries**: each entry tagged with its replica,
  merge-sorted by wall stamp, with each replica's ``next_seq`` cursor so
  incremental fleet polls resume per replica.
- **metrics**: each replica's exposition parsed and one fleet exposition
  rendered: counters and histograms sum, gauges sum except level-like
  families (duty cycle, ratios, limits), which take the max.
- **profile**, **slo**, **costs**: keyed by replica (summing device
  seconds would hide the skew that should show), plus a small fleet
  section.

Fetch failures ride inline (``errors: {replica: reason}``): a dead
replica degrades the aggregate, never fails it.

The drift math: :func:`profile_signals` and :func:`timeseries_signals`
extract each replica's scalar signals (duty cycle, batch fill, decode
wave p50, MFU, queue wait), and :func:`drift_scores` scores each
replica's distance from the fleet median, normalised so that one
threshold serves signals of different units. :class:`FleetMonitorConfig`
parses ``CLIENT_TPU_FLEET_MONITOR``.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, fields

from client_tpu_torch.config import env_text

__all__ = [
    "ENV_VAR",
    "FleetMonitorConfig",
    "drift_scores",
    "fleet_median",
    "merge_costs",
    "merge_events",
    "merge_expositions",
    "merge_profiles",
    "merge_slo",
    "merge_timeseries",
    "parse_exposition",
    "profile_signals",
    "timeseries_signals",
]

ENV_VAR = "CLIENT_TPU_FLEET_MONITOR"

# -- exposition merge ---------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(?:\s+\S+)?\s*$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

# Gauge families where "sum across replicas" is a lie: these are levels
# or ratios, so the fleet value is the worst replica, not the total.
# Matched by exact name or suffix.
_MAX_GAUGE_SUFFIXES = (
    "_ratio", "_fraction", "_duty_cycle", "_limit", "_burn_rate",
    "_drift_score", "_utilization",
)


def parse_exposition(text: str) -> dict[str, dict]:
    """Parse Prometheus text exposition (classic 0.0.4 or OpenMetrics)
    into ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.

    Tolerant by design — unparseable lines are skipped, not fatal: this
    feeds an aggregation endpoint that must survive a replica mid-update.
    """
    families: dict[str, dict] = {}
    order: list[str] = []

    def fam(name: str) -> dict:
        if name not in families:
            families[name] = {"type": "untyped", "help": "", "samples": []}
            order.append(name)
        return families[name]

    for line in text.splitlines():
        line = line.strip()
        if not line or line == "# EOF":
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                name = parts[2]
                if parts[1] == "TYPE":
                    fam(name)["type"] = parts[3] if len(parts) > 3 \
                        else "untyped"
                else:
                    fam(name)["help"] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        sample_name, label_blob, raw_value = m.group(1), m.group(2), \
            m.group(3)
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = dict(_LABEL_RE.findall(label_blob)) if label_blob else {}
        # Attach the sample to its family: longest declared family name
        # that prefixes the sample name (covers _bucket/_sum/_count and
        # the OpenMetrics counter `_total` sample rename).
        owner = None
        for fname in order:
            if sample_name == fname or sample_name.startswith(fname + "_"):
                if owner is None or len(fname) > len(owner):
                    owner = fname
        if owner is None:
            owner = sample_name
        fam(owner)["samples"].append((sample_name, labels, value))
    return {name: families[name] for name in order if families[name]}


def _merge_mode(family: str, ftype: str) -> str:
    if ftype in ("counter", "histogram", "summary"):
        return "sum"
    if ftype == "gauge":
        for suffix in _MAX_GAUGE_SUFFIXES:
            if family.endswith(suffix) or family.endswith(suffix + "s"):
                return "max"
        return "sum"
    return "sum"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def merge_expositions(exposures: dict[str, str]) -> str:
    """Merge per-replica exposition texts into one classic-dialect text.

    Series identity is (sample name, labels); counters and histograms
    sum across replicas, level-like gauges take the fleet max (see
    module doc). Type/help come from the first replica declaring the
    family.
    """
    merged: dict[str, dict] = {}
    order: list[str] = []
    for _replica in sorted(exposures):
        for fname, f in parse_exposition(exposures[_replica]).items():
            if fname not in merged:
                merged[fname] = {"type": f["type"], "help": f["help"],
                                 "series": {}}
                order.append(fname)
            dst = merged[fname]
            if dst["type"] == "untyped" and f["type"] != "untyped":
                dst["type"] = f["type"]
            mode = _merge_mode(fname, dst["type"])
            for sample_name, labels, value in f["samples"]:
                key = (sample_name,
                       tuple(sorted(labels.items())))
                if key not in dst["series"]:
                    dst["series"][key] = value
                elif mode == "max":
                    dst["series"][key] = max(dst["series"][key], value)
                else:
                    dst["series"][key] += value
    lines: list[str] = []
    for fname in order:
        f = merged[fname]
        if f["help"]:
            lines.append(f"# HELP {fname} {f['help']}")
        lines.append(f"# TYPE {fname} {f['type']}")
        for (sample_name, labels), value in f["series"].items():
            blob = ""
            if labels:
                inner = ",".join(f'{k}="{v}"' for k, v in labels)
                blob = "{" + inner + "}"
            lines.append(f"{sample_name}{blob} {_fmt_value(value)}")
    return "\n".join(lines) + "\n" if lines else ""


# -- events merge -------------------------------------------------------------


def merge_events(exports: dict[str, dict],
                 errors: dict[str, str] | None = None,
                 limit: int | None = None) -> dict:
    """Merge per-replica ``/v2/events`` exports into one fleet timeline.

    Every event gains a ``replica`` field; ordering is by wall stamp
    (then per-replica seq) because seq spaces are per-process. The
    ``cursors`` map carries each replica's ``next_seq`` so a poller can
    resume each replica exactly where it left off (``?since=`` is
    per-replica, never global).
    """
    events: list[dict] = []
    cursors: dict[str, int] = {}
    dropped = 0
    for replica in sorted(exports):
        exp = exports[replica]
        cursors[replica] = int(exp.get("next_seq", 0))
        dropped += int(exp.get("dropped", 0))
        for evt in exp.get("events", ()):
            tagged = dict(evt)
            tagged["replica"] = replica
            events.append(tagged)
    events.sort(key=lambda e: (e.get("ts_wall", 0), e.get("replica", ""),
                               e.get("seq", 0)))
    if limit is not None and limit >= 0:
        events = events[-limit:]
    return {
        "events": events,
        "cursors": cursors,
        "dropped": dropped,
        "replicas": sorted(exports),
        "errors": dict(errors or {}),
    }


def merge_timeseries(exports: dict[str, dict],
                     errors: dict[str, str] | None = None,
                     limit: int | None = None) -> dict:
    """Merge per-replica ``/v2/timeseries`` exports into one fleet
    stream. Same contract as :func:`merge_events`: every sample gains a
    ``replica`` tag, ordering is by wall stamp (seq spaces are
    per-process), ``cursors`` carries each replica's ``next_seq`` so an
    incremental poller resumes per replica."""
    samples: list[dict] = []
    cursors: dict[str, int] = {}
    dropped = 0
    interval_s = None
    for replica in sorted(exports):
        exp = exports[replica] or {}
        cursors[replica] = int(exp.get("next_seq", 0))
        dropped += int(exp.get("dropped", 0))
        if interval_s is None and exp.get("interval_s") is not None:
            interval_s = exp["interval_s"]
        for s in exp.get("samples", ()):
            tagged = dict(s)
            tagged["replica"] = replica
            samples.append(tagged)
    samples.sort(key=lambda s: (s.get("ts_wall", 0),
                                s.get("replica", ""), s.get("seq", 0)))
    if limit is not None and limit >= 0:
        samples = samples[-limit:]
    return {
        "samples": samples,
        "cursors": cursors,
        "dropped": dropped,
        "interval_s": interval_s,
        "replicas": sorted(exports),
        "errors": dict(errors or {}),
    }


# -- profile / slo merge ------------------------------------------------------


def merge_profiles(profiles: dict[str, dict],
                   errors: dict[str, str] | None = None,
                   drift: dict | None = None) -> dict:
    """Fleet profile: per-replica snapshots keyed by replica id plus a
    computed fleet section (medians + per-replica signals). Raw
    snapshots are passed through untouched so ``tools/profile_report.py
    --fleet`` can reuse the single-replica renderer per row."""
    signals = {r: profile_signals(p) for r, p in profiles.items()}
    scores, medians = drift_scores(signals)
    fleet = {
        "replica_count": len(profiles),
        "signals": signals,
        "medians": medians,
        "drift_scores": scores,
    }
    out = {
        "replicas": profiles,
        "fleet": fleet,
        "errors": dict(errors or {}),
    }
    if drift is not None:
        out["drift"] = drift
    return out


def merge_slo(exports: dict[str, dict],
              errors: dict[str, str] | None = None) -> dict:
    """Fleet SLO: per-replica keyed (burn rates don't sum), plus the
    fleet-level alarm — the worst fast-burn seen anywhere."""
    worst = {"replica": None, "fast_burn": 0.0}
    for replica, exp in exports.items():
        for model in (exp or {}).get("models", {}).values():
            for window in model.get("windows", ()):
                burn = float(window.get("burn_rate", 0.0) or 0.0)
                if burn > worst["fast_burn"]:
                    worst = {"replica": replica, "fast_burn": burn}
    return {
        "replicas": exports,
        "worst": worst,
        "errors": dict(errors or {}),
    }


def merge_costs(exports: dict[str, dict],
                errors: dict[str, str] | None = None) -> dict:
    """Fleet cost ledger: per-replica snapshots keyed by replica, plus
    fleet-wide per-tenant totals (device/padding/queue/HBM seconds sum
    across replicas — each replica meters its own device) and the
    fleet's loudest top-talker."""
    tenants: dict[str, dict] = {}
    totals = {"device_s": 0.0, "padding_s": 0.0, "queue_s": 0.0,
              "hbm_byte_s": 0.0, "requests": 0}
    worst = {"replica": None, "tenant": None, "share": 0.0}
    for replica, exp in exports.items():
        for tenant, row in (exp or {}).get("tenants", {}).items():
            agg = tenants.setdefault(tenant, {
                "device_s": 0.0, "padding_s": 0.0, "queue_s": 0.0,
                "hbm_byte_s": 0.0, "requests": 0,
                "co_batch_s": 0.0, "queue_wait_s": 0.0,
                "admission_sheds": 0})
            for key in ("device_s", "padding_s", "queue_s",
                        "hbm_byte_s", "requests"):
                agg[key] += row.get(key, 0)
            interference = row.get("interference", {})
            for key in ("co_batch_s", "queue_wait_s", "admission_sheds"):
                agg[key] += interference.get(key, 0)
        for key in totals:
            totals[key] += (exp or {}).get("totals", {}).get(key, 0)
        top = (exp or {}).get("top_talker")
        if top and float(top.get("share", 0.0)) > worst["share"]:
            worst = {"replica": replica, "tenant": top.get("tenant"),
                     "share": float(top.get("share", 0.0))}
    return {
        "replicas": exports,
        "tenants": tenants,
        "totals": totals,
        "top_talker": worst if worst["tenant"] is not None else None,
        "errors": dict(errors or {}),
    }


# -- drift math ---------------------------------------------------------------

# Normalization floors: |v - median| / max(|median|, floor). The floor
# keeps near-zero medians (idle fleet) from turning measurement noise
# into huge relative scores.
SIGNAL_FLOORS = {
    "duty_cycle": 0.05,
    "fill_ratio": 0.05,
    "wave_ms_p50": 1.0,
    "wait_s": 0.05,
    "mfu": 0.02,
}


def profile_signals(profile: dict | None,
                    load: dict | None = None) -> dict[str, float]:
    """Extract the drift signals from one replica's ``/v2/profile``
    snapshot (plus optionally its LoadReport dict for queue wait).
    Signals without evidence are omitted, not zeroed — a replica that
    has never decoded must not read as 'drifted to 0 ms waves'."""
    signals: dict[str, float] = {}
    if profile:
        duty = profile.get("duty_cycle")
        if duty is not None:
            signals["duty_cycle"] = float(duty)
        rows = padded = 0.0
        waves_total = 0.0
        wave_weighted = 0.0
        mfu_weighted = mfu_weight = 0.0
        for m in profile.get("models", {}).values():
            for b in m.get("buckets", ()):
                rows += float(b.get("rows", 0) or 0)
                padded += float(b.get("padded_rows", 0) or 0)
            for w in m.get("decode_waves", ()):
                n = float(w.get("waves", 0) or 0)
                p50 = w.get("wave_ms_p50")
                if n > 0 and p50 is not None:
                    waves_total += n
                    wave_weighted += n * float(p50)
            # Roofline MFU, device-time weighted across models: a busy
            # model's utilization should dominate the replica signal.
            mfu = (m.get("roofline") or {}).get("mfu")
            if mfu is not None:
                weight = max(float(m.get("device_s", 0.0) or 0.0), 1e-9)
                mfu_weighted += float(mfu) * weight
                mfu_weight += weight
        if padded > 0:
            signals["fill_ratio"] = rows / padded
        if waves_total > 0:
            signals["wave_ms_p50"] = wave_weighted / waves_total
        if mfu_weight > 0:
            signals["mfu"] = mfu_weighted / mfu_weight
    if load:
        wait = load.get("wait_s")
        if wait is not None:
            signals["wait_s"] = float(wait)
    return signals


def timeseries_signals(export: dict | None, window_s: float = 60.0,
                       now: float | None = None) -> dict[str, float]:
    """Extract the drift signals from one replica's ``/v2/timeseries``
    export as *windowed medians* — the flight-recorder upgrade over
    :func:`profile_signals`' single-scrape instantaneous values. A
    replica mid-GC or mid-compile no longer reads as drifted: one
    outlier second cannot move a 60-sample median. Keys match
    ``profile_signals`` (duty_cycle / fill_ratio / wave_ms_p50) so
    :func:`drift_scores` and SIGNAL_FLOORS apply unchanged; signals
    without evidence in the window are omitted, not zeroed."""
    if not export:
        return {}
    samples = export.get("samples") or []
    if not samples:
        return {}
    if now is None:
        now = max(float(s.get("ts_wall", 0) or 0) for s in samples)
    duty: list[float] = []
    fill: list[float] = []
    wave: list[float] = []
    mfu: list[float] = []
    for s in samples:
        if float(s.get("ts_wall", 0) or 0) < now - window_s:
            continue
        sig = s.get("signals") or {}
        if sig.get("duty_cycle") is not None:
            duty.append(float(sig["duty_cycle"]))
        for source, dest in (("batch_fill", fill), ("wave_p50_ms", wave),
                             ("mfu", mfu)):
            per_model = sig.get(source)
            if isinstance(per_model, dict) and per_model:
                vals = [float(v) for v in per_model.values()]
                dest.append(sum(vals) / len(vals))
    signals: dict[str, float] = {}
    if duty:
        signals["duty_cycle"] = fleet_median(duty)
    if fill:
        signals["fill_ratio"] = fleet_median(fill)
    if wave:
        signals["wave_ms_p50"] = fleet_median(wave)
    if mfu:
        signals["mfu"] = fleet_median(mfu)
    return signals


def fleet_median(values: list[float]) -> float:
    s = sorted(values)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return s[mid]
    return (s[mid - 1] + s[mid]) / 2.0


def drift_scores(signals_by_replica: dict[str, dict[str, float]],
                 ) -> tuple[dict[str, dict[str, float]],
                            dict[str, float]]:
    """Score each replica's distance from the fleet median per signal.

    ``score = |v - median| / max(|median|, floor)`` — a unitless skew so
    one threshold (FleetMonitorConfig.threshold) covers duty cycle
    (0..1) and wave latency (ms) alike. Signals reported by fewer than
    two replicas are skipped: no fleet, no drift.
    """
    by_signal: dict[str, dict[str, float]] = {}
    for replica, signals in signals_by_replica.items():
        for name, value in signals.items():
            by_signal.setdefault(name, {})[replica] = value
    medians: dict[str, float] = {}
    scores: dict[str, dict[str, float]] = {
        r: {} for r in signals_by_replica}
    for name, per_replica in by_signal.items():
        if len(per_replica) < 2:
            continue
        median = fleet_median(list(per_replica.values()))
        medians[name] = median
        floor = SIGNAL_FLOORS.get(name, 1.0)
        denom = max(abs(median), floor)
        for replica, value in per_replica.items():
            scores[replica][name] = abs(value - median) / denom
    return scores, medians


# -- monitor config -----------------------------------------------------------


@dataclass
class FleetMonitorConfig:
    """``CLIENT_TPU_FLEET_MONITOR`` knobs (grammar matches
    ``CLIENT_TPU_AUTOTUNE``: unset/"0"/"off" disables, "1"/"true"/"on"
    takes defaults, else inline JSON or ``@file``)."""

    interval_s: float = 5.0    # monitor wake period
    threshold: float = 0.5     # drift score above this flags the replica
    min_replicas: int = 2      # no drift math below this fleet size
    window_s: float = 60.0     # flight-recorder median window per scrape

    @classmethod
    def from_dict(cls, data: dict) -> "FleetMonitorConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{ENV_VAR}: unknown key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        cfg = cls()
        for f in fields(cls):
            if f.name not in data:
                continue
            raw = data[f.name]
            try:
                coerce = int if f.name == "min_replicas" else float
                setattr(cfg, f.name, coerce(raw))
            except (TypeError, ValueError):
                raise ValueError(
                    f"{ENV_VAR}: key '{f.name}' expects a number, "
                    f"got {raw!r}") from None
        if cfg.interval_s <= 0:
            raise ValueError(f"{ENV_VAR}: interval_s must be > 0")
        if cfg.threshold <= 0:
            raise ValueError(f"{ENV_VAR}: threshold must be > 0")
        if cfg.min_replicas < 2:
            raise ValueError(f"{ENV_VAR}: min_replicas must be >= 2")
        if cfg.window_s <= 0:
            raise ValueError(f"{ENV_VAR}: window_s must be > 0")
        return cfg

    @classmethod
    def from_env(cls, env_var: str = ENV_VAR,
                 environ=os.environ) -> "FleetMonitorConfig | None":
        raw = env_text(env_var, environ)
        if not raw or raw.lower() in ("0", "false", "off"):
            return None
        if raw.lower() in ("1", "true", "on"):
            return cls()
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as f:
                    raw = f.read()
            except OSError as exc:
                raise ValueError(
                    f"{env_var}: cannot read '{raw[1:]}': {exc}") from None
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{env_var}: invalid JSON ({exc})") from None
        if not isinstance(data, dict):
            raise ValueError(f"{env_var}: expected a JSON object")
        return cls.from_dict(data)

    def summary(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}
