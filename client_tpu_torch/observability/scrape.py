"""Exposition-format scraping: parse ``/metrics``, difference two
histogram snapshots, read a quantile off one.

The port's copy of ``client_tpu/observability/scrape.py``: the same
parse and the same Prometheus ``histogram_quantile`` interpolation, so a
tool that reads a histogram's p50/p99 off ``/metrics`` before and after a
run reads both servers alike.
"""

from __future__ import annotations

import math
import re

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+\d+)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_samples(text: str) -> list[tuple[str, dict, float]]:
    """Yield (metric_name, labels, value) for every sample line."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # OpenMetrics exposition suffixes bucket/counter samples with an
        # exemplar ("... # {trace_id=...} value"); drop it, or the greedy
        # label match would read the exemplar value as the sample value.
        # (Our label values never contain " # ", so the split is safe.)
        if " # " in line:
            line = line.split(" # ", 1)[0].rstrip()
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labelstr, raw = m.group(1), m.group(2) or "", m.group(3)
        labels = {k: _unescape(v) for k, v in _LABEL_RE.findall(labelstr)}
        try:
            value = float(raw)
        except ValueError:
            continue
        out.append((name, labels, value))
    return out


def histogram_state(text: str, family: str) -> dict:
    """Aggregate one histogram family over ALL its label sets into
    {"buckets": {le: cumulative_count}, "sum": s, "count": n}.

    Aggregating cumulative buckets across label sets is sound because every
    series of a family shares the same ``le`` ladder.
    """
    buckets: dict[float, float] = {}
    total_sum = 0.0
    total_count = 0.0
    for name, labels, value in parse_samples(text):
        if name == f"{family}_bucket" and "le" in labels:
            le = (math.inf if labels["le"] == "+Inf"
                  else float(labels["le"]))
            buckets[le] = buckets.get(le, 0.0) + value
        elif name == f"{family}_sum":
            total_sum += value
        elif name == f"{family}_count":
            total_count += value
    return {"buckets": buckets, "sum": total_sum, "count": total_count}


def delta(after: dict, before: dict) -> dict:
    """Windowed difference of two histogram_state snapshots."""
    buckets = {
        le: after["buckets"].get(le, 0.0) - before["buckets"].get(le, 0.0)
        for le in after["buckets"]
    }
    return {"buckets": buckets,
            "sum": after["sum"] - before["sum"],
            "count": after["count"] - before["count"]}


def quantile(state: dict, q: float) -> float:
    """Prometheus-style histogram_quantile: linear interpolation inside the
    target bucket; returns NaN for an empty window and the highest finite
    bound when the target lands in +Inf."""
    count = state["count"]
    if count <= 0 or not state["buckets"]:
        return float("nan")
    rank = q * count
    les = sorted(state["buckets"])
    prev_le, prev_cum = 0.0, 0.0
    for le in les:
        cum = state["buckets"][le]
        if cum >= rank:
            if math.isinf(le):
                finite = [b for b in les if not math.isinf(b)]
                return finite[-1] if finite else float("nan")
            width = le - prev_le
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return le
            return prev_le + width * (rank - prev_cum) / in_bucket
        prev_le, prev_cum = le, cum
    return les[-1] if les and not math.isinf(les[-1]) else float("nan")
