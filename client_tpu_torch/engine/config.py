"""Model configuration: the engine-side analog of Triton's ``config.pbtxt``.

The port's own copy of ``client_tpu/engine/config.py``, trimmed to what
the port serves: batched models with optional dynamic batching, ragged
models batched along a lookups axis (DLRM), stateful models with
sequence batching, decoupled (streaming) models and ensembles, built in
code (no ``config.pbtxt`` parsing yet). Field names match the
reference's model-config schema.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


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


@dataclass
class DynamicBatchingConfig:
    preferred_batch_size: list[int] = field(default_factory=list)
    max_queue_delay_microseconds: int = 0


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
    # The quantity the bucket ladder pads: "rows" (batch rows) or
    # "lookups" (the summed embedding lookups of a ragged DLRM batch; rows
    # still cap at max_batch_size).
    padding_axis: str = "rows"
    max_lookups: int = 0  # the ladder's ceiling along "lookups"

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
        """Buckets a batch pads up to: powers of two up to the axis
        capacity."""
        cap = self.axis_capacity()
        if cap <= 0:
            return [0]
        buckets, b = [], 1
        while b < cap:
            buckets.append(b)
            b *= 2
        buckets.append(cap)
        return buckets

    def metadata_dict(self) -> dict:
        """v2 model-metadata JSON (GET /v2/models/<name>)."""
        def io_md(tc: TensorConfig) -> dict:
            # A ragged tensor owns its variable leading dim: no batch dim.
            dims = (([-1] if self.max_batch_size > 0 and not tc.ragged
                     else []) + list(tc.dims))
            return {"name": tc.name, "datatype": tc.data_type, "shape": dims}

        return {
            "name": self.name,
            "versions": [str(self.version)],
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
            out["dynamic_batching"] = {
                "preferred_batch_size": db.preferred_batch_size,
                "max_queue_delay_microseconds":
                    db.max_queue_delay_microseconds,
            }
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
