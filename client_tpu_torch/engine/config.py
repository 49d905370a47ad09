"""Model configuration: the engine-side analog of Triton's ``config.pbtxt``.

The port's own copy of ``client_tpu/engine/config.py``, trimmed to what
the port serves: batched models with optional dynamic batching, ragged
models batched along a lookups axis (DLRM), stateful models with
sequence batching, decoupled (streaming) models and ensembles. A config
is built in code by a zoo backend, or read from a directory repository's
``config.pbtxt`` / ``config.json`` by :meth:`ModelConfig.from_dict`.
Field names match the reference's model-config schema.

Dynamic batching carries Triton's priority levels, queue policies
(``default_queue_policy`` and per-level ``priority_queue_policy``: a
level's queue bound and its wait timeout with the REJECT or DELAY
action) and ``preserve_ordering``, read as the reference reads them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from client_tpu_torch.protocol.dtypes import DataType


def _norm_dtype(dt: str) -> str:
    """Accept both bare ('INT32') and proto-enum ('TYPE_INT32') spellings."""
    if dt.startswith("TYPE_"):
        dt = dt[len("TYPE_"):]
    if dt == "STRING":
        dt = "BYTES"
    if dt not in DataType.ALL:
        raise ValueError(f"unknown data_type '{dt}'")
    return dt


@dataclass
class TensorConfig:
    name: str
    data_type: str  # v2 wire name, e.g. "INT32"
    dims: list[int]
    optional: bool = False
    # A ragged tensor (DLRM's CSR indices and offsets) carries its own
    # variable leading dim instead of the implicit [-1] batch dim: its
    # wire shape is exactly ``dims``.
    ragged: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "TensorConfig":
        return cls(
            name=d["name"],
            data_type=_norm_dtype(d["data_type"]),
            dims=[int(x) for x in d["dims"]],
            optional=bool(d.get("optional", False)),
            ragged=bool(d.get("ragged", False)),
        )


@dataclass
class QueuePolicy:
    """Triton's ModelQueuePolicy (the ``schedule_policy`` extension): what
    happens to a request that waits too long or arrives at a full
    queue."""

    timeout_action: str = "REJECT"  # REJECT | DELAY (execute anyway)
    default_timeout_microseconds: int = 0  # 0 = no queue timeout
    allow_timeout_override: bool = True    # request timeout_us may override
    max_queue_size: int = 0                # 0 = unbounded

    @classmethod
    def from_dict(cls, d: dict) -> "QueuePolicy":
        return cls(
            timeout_action=str(d.get("timeout_action", "REJECT")).upper(),
            default_timeout_microseconds=int(
                d.get("default_timeout_microseconds", 0)),
            allow_timeout_override=bool(d.get("allow_timeout_override",
                                              True)),
            max_queue_size=int(d.get("max_queue_size", 0)),
        )

    def to_dict(self) -> dict:
        return {"timeout_action": self.timeout_action,
                "default_timeout_microseconds":
                    self.default_timeout_microseconds,
                "allow_timeout_override": self.allow_timeout_override,
                "max_queue_size": self.max_queue_size}


@dataclass
class DynamicBatchingConfig:
    preferred_batch_size: list[int] = field(default_factory=list)
    max_queue_delay_microseconds: int = 0
    # Responses leave in arrival order even when instances finish out of
    # order (Triton's preserve_ordering).
    preserve_ordering: bool = False
    # Priority levels (lower is served first, Triton's convention; a
    # request priority of 0 maps to default_priority_level).
    priority_levels: int = 0
    default_priority_level: int = 0
    default_queue_policy: QueuePolicy | None = None
    # Per-level overrides: level -> policy.
    priority_queue_policy: dict[int, QueuePolicy] = field(
        default_factory=dict)

    def policy_for(self, level: int) -> QueuePolicy | None:
        return self.priority_queue_policy.get(level,
                                              self.default_queue_policy)


@dataclass
class SequenceBatchingConfig:
    # 'direct' (a slot per sequence) or 'oldest' (steps of distinct live
    # sequences batched into one execution), Triton's two strategies.
    strategy: str = "direct"
    # Triton's default idle window, 1 s; a sequence with a step queued or
    # running is never evicted, whatever this value.
    max_sequence_idle_microseconds: int = 1_000_000
    # 'oldest': the state arena's capacity in live sequences, and how long
    # a forming wave waits for more candidates.
    max_candidate_sequences: int = 64
    max_queue_delay_microseconds: int = 1000


@dataclass
class EnsembleStep:
    """One composing model of an ensemble and how its tensors map onto
    the ensemble's."""

    model_name: str
    model_version: int = -1
    input_map: dict[str, str] = field(default_factory=dict)   # model input -> ensemble tensor
    output_map: dict[str, str] = field(default_factory=dict)  # model output -> ensemble tensor


@dataclass
class ModelConfig:
    name: str
    platform: str = "pytorch"       # 'pytorch' | 'ensemble'
    max_batch_size: int = 0         # 0 = the model handles full shapes itself
    input: list[TensorConfig] = field(default_factory=list)
    output: list[TensorConfig] = field(default_factory=list)
    dynamic_batching: DynamicBatchingConfig | None = None
    sequence_batching: SequenceBatchingConfig | None = None
    ensemble_scheduling: list[EnsembleStep] = field(default_factory=list)
    instance_count: int = 1
    # Decoupled transaction policy: one request, any number of responses,
    # the last flagged final (Triton's ``model_transaction_policy``).
    decoupled: bool = False
    version: int = 1
    # The bucket ladder, when not powers of two up to the axis capacity.
    batch_buckets: list[int] | None = None
    # The quantity the bucket ladder pads: "rows" (batch rows) or
    # "lookups" (the summed embedding lookups of a ragged DLRM batch; rows
    # still cap at max_batch_size).
    padding_axis: str = "rows"
    max_lookups: int = 0  # the ladder's ceiling along "lookups"
    # Free-form settings: a directory model's ``zoo_builder``,
    # ``weights_path`` and the ``labels`` of its ``label_filename``s.
    parameters: dict[str, Any] = field(default_factory=dict)

    def scheduler_kind(self) -> str:
        """ENSEMBLE, SEQUENCE, DYNAMIC or NONE: the kinds the port
        schedules."""
        if self.ensemble_scheduling:
            return "ENSEMBLE"
        if self.sequence_batching is not None:
            return "SEQUENCE"
        return "DYNAMIC" if self.dynamic_batching is not None else "NONE"

    def axis_capacity(self) -> int:
        """Ceiling of the bucket ladder along the padding axis:
        max_lookups for lookup-bucketed models, else max_batch_size."""
        if self.padding_axis == "lookups":
            return self.max_lookups
        return self.max_batch_size

    def effective_buckets(self) -> list[int]:
        """Buckets a batch pads up to: ``batch_buckets`` when set, else
        powers of two up to the axis capacity."""
        cap = self.axis_capacity()
        if cap <= 0:
            return [0]
        if self.batch_buckets:
            return sorted({int(b) for b in self.batch_buckets})
        buckets, b = [], 1
        while b < cap:
            buckets.append(b)
            b *= 2
        buckets.append(cap)
        return buckets

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """A config from its dict form (``config.json``, or
        :func:`~client_tpu_torch.protocol.model_config.load_pbtxt`), as the
        reference reads it."""
        db = None
        if "dynamic_batching" in d:
            raw = d["dynamic_batching"] or {}
            db = DynamicBatchingConfig(
                preferred_batch_size=[int(x) for x in
                                      raw.get("preferred_batch_size", [])],
                max_queue_delay_microseconds=int(
                    raw.get("max_queue_delay_microseconds", 0)),
                preserve_ordering=bool(raw.get("preserve_ordering", False)),
                priority_levels=int(raw.get("priority_levels", 0)),
                default_priority_level=int(
                    raw.get("default_priority_level", 0)),
                default_queue_policy=QueuePolicy.from_dict(
                    raw["default_queue_policy"])
                if raw.get("default_queue_policy") else None,
                priority_queue_policy={
                    int(k): QueuePolicy.from_dict(v)
                    for k, v in (raw.get("priority_queue_policy")
                                 or {}).items()})
        sb = None
        if "sequence_batching" in d:
            raw = d["sequence_batching"] or {}
            oldest = raw.get("oldest") or {}
            sb = SequenceBatchingConfig(
                strategy=("oldest" if "oldest" in raw
                          else raw.get("strategy", "direct")),
                max_sequence_idle_microseconds=int(
                    raw.get("max_sequence_idle_microseconds", 1_000_000)),
                max_candidate_sequences=int(
                    oldest.get("max_candidate_sequences",
                               raw.get("max_candidate_sequences", 64))),
                max_queue_delay_microseconds=int(
                    oldest.get("max_queue_delay_microseconds",
                               raw.get("max_queue_delay_microseconds",
                                       1000))),
            )
        steps = [EnsembleStep(model_name=s["model_name"],
                              model_version=int(s.get("model_version", -1)),
                              input_map=dict(s.get("input_map", {})),
                              output_map=dict(s.get("output_map", {})))
                 for s in (d.get("ensemble_scheduling") or {}).get("step",
                                                                   [])]
        group = d.get("instance_group")
        return cls(
            name=d["name"],
            platform=d.get("platform", d.get("backend", "pytorch")),
            max_batch_size=int(d.get("max_batch_size", 0)),
            input=[TensorConfig.from_dict(x) for x in d.get("input", [])],
            output=[TensorConfig.from_dict(x) for x in d.get("output", [])],
            dynamic_batching=db,
            sequence_batching=sb,
            ensemble_scheduling=steps,
            instance_count=int(
                (group or [{}])[0].get("count", 1)
                if isinstance(group, list)
                else (group or {}).get("count", 1)),
            decoupled=bool((d.get("model_transaction_policy") or {})
                           .get("decoupled", False)),
            version=int(d.get("version", 1)),
            batch_buckets=([int(b) for b in d["batch_buckets"]]
                           if d.get("batch_buckets") else None),
            padding_axis=str(d.get("padding_axis", "rows")),
            max_lookups=int(d.get("max_lookups", 0)),
            parameters=dict(d.get("parameters", {})),
        )

    def metadata_dict(self, versions: list[str] | None = None) -> dict:
        """v2 model-metadata JSON (GET /v2/models/<name>); ``versions``
        lists the loaded versions of the name."""
        def io_md(tc: TensorConfig) -> dict:
            # A ragged tensor owns its variable leading dim: no batch dim.
            dims = (([-1] if self.max_batch_size > 0 and not tc.ragged
                     else []) + list(tc.dims))
            return {"name": tc.name, "datatype": tc.data_type, "shape": dims}

        return {
            "name": self.name,
            "versions": versions or [str(self.version)],
            "platform": self.platform,
            "inputs": [io_md(t) for t in self.input],
            "outputs": [io_md(t) for t in self.output],
        }

    def config_dict(self) -> dict:
        """v2 model-config JSON (GET /v2/models/<name>/config)."""
        out: dict[str, Any] = {
            "name": self.name,
            "platform": self.platform,
            "backend": self.platform,
            "max_batch_size": self.max_batch_size,
            "input": [{"name": t.name, "data_type": f"TYPE_{t.data_type}",
                       "dims": t.dims,
                       **({"ragged": True} if t.ragged else {})}
                      for t in self.input],
            "output": [{"name": t.name, "data_type": f"TYPE_{t.data_type}",
                        "dims": t.dims} for t in self.output],
        }
        if self.padding_axis != "rows":
            out["padding_axis"] = self.padding_axis
            out["max_lookups"] = self.max_lookups
        if self.dynamic_batching is not None:
            db = self.dynamic_batching
            dyn = out["dynamic_batching"] = {
                "preferred_batch_size": db.preferred_batch_size,
                "max_queue_delay_microseconds":
                    db.max_queue_delay_microseconds,
            }
            if db.preserve_ordering:
                dyn["preserve_ordering"] = True
            if db.priority_levels:
                dyn["priority_levels"] = db.priority_levels
                dyn["default_priority_level"] = db.default_priority_level
            if db.default_queue_policy is not None:
                dyn["default_queue_policy"] = db.default_queue_policy.to_dict()
            if db.priority_queue_policy:
                dyn["priority_queue_policy"] = {
                    int(k): v.to_dict()
                    for k, v in db.priority_queue_policy.items()}
        if self.instance_count != 1:
            out["instance_group"] = [{"count": self.instance_count}]
        if self.sequence_batching is not None:
            out["sequence_batching"] = {
                "strategy": self.sequence_batching.strategy}
        if self.ensemble_scheduling:
            out["ensemble_scheduling"] = {"step": [
                {"model_name": s.model_name, "model_version": s.model_version,
                 "input_map": s.input_map, "output_map": s.output_map}
                for s in self.ensemble_scheduling]}
        if self.decoupled:
            out["model_transaction_policy"] = {"decoupled": True}
        return out
