"""Engine config dict -> ``ModelConfig`` protobuf, for the gRPC ModelConfig
RPC.

The port's own copy of ``config_dict_to_proto`` from
``client_tpu/protocol/model_config.py``, with one fix: a BYTES tensor
written ``TYPE_BYTES`` (as every engine config dict writes it) becomes
``TYPE_STRING``, where the JAX package raises. Only the blocks a port
config dict holds are converted: the name, platform and IO, the preferred
sizes and delay of dynamic batching, sequence batching, instance groups,
ensemble scheduling and the decoupled policy. Queue policies, priority
levels and parameters come with the slices that add them to the
engine. The reverse direction and ``config.pbtxt`` loading are not
ported: nothing in the port reads a config file yet.
"""

from __future__ import annotations

from client_tpu_torch.protocol import grpc_service_pb2 as pb


def config_dict_to_proto(d: dict) -> "pb.ModelConfig":
    cfg = pb.ModelConfig(
        name=d.get("name", ""),
        platform=d.get("platform", ""),
        backend=d.get("backend", ""),
        max_batch_size=int(d.get("max_batch_size", 0)),
    )
    for io_key, holder in (("input", cfg.input), ("output", cfg.output)):
        for t in d.get(io_key, []):
            entry = holder.add(name=t["name"],
                               dims=[int(x) for x in t["dims"]])
            dt = t.get("data_type", "TYPE_INVALID")
            if not dt.startswith("TYPE_"):
                dt = "TYPE_" + dt
            if dt == "TYPE_BYTES":
                # The proto names BYTES TYPE_STRING. The JAX package maps
                # only the unprefixed name, so its ModelConfig RPC fails
                # on the "TYPE_BYTES" its own config dicts hold.
                dt = "TYPE_STRING"
            entry.data_type = pb.DataType.Value(dt)
    if "dynamic_batching" in d:
        db = d["dynamic_batching"] or {}
        cfg.dynamic_batching.preferred_batch_size.extend(
            int(x) for x in db.get("preferred_batch_size", []))
        cfg.dynamic_batching.max_queue_delay_microseconds = int(
            db.get("max_queue_delay_microseconds", 0))
    if "sequence_batching" in d:
        sb = d["sequence_batching"] or {}
        if sb.get("strategy") == "oldest":
            oldest = sb.get("oldest") or {}
            cfg.sequence_batching.oldest.SetInParent()
            cfg.sequence_batching.oldest.max_candidate_sequences = int(
                oldest.get("max_candidate_sequences",
                           sb.get("max_candidate_sequences", 0)))
            cfg.sequence_batching.oldest.max_queue_delay_microseconds = int(
                oldest.get("max_queue_delay_microseconds",
                           sb.get("max_queue_delay_microseconds", 0)))
        else:
            cfg.sequence_batching.direct.SetInParent()
        cfg.sequence_batching.max_sequence_idle_microseconds = int(
            sb.get("max_sequence_idle_microseconds", 0))
    if d.get("ensemble_scheduling"):
        for s in d["ensemble_scheduling"].get("step", []):
            step = cfg.ensemble_scheduling.step.add(
                model_name=s["model_name"],
                model_version=int(s.get("model_version", -1)))
            step.input_map.update(s.get("input_map", {}))
            step.output_map.update(s.get("output_map", {}))
    for g in d.get("instance_group", []) or []:
        cfg.instance_group.add(count=int(g.get("count", 1)))
    if (d.get("model_transaction_policy") or {}).get("decoupled"):
        cfg.model_transaction_policy.decoupled = True
    return cfg
