"""``ModelConfig`` protobuf <-> engine config dict, and ``config.pbtxt``
loading.

The port's own copy of ``client_tpu/protocol/model_config.py``:
``config_dict_to_proto`` serves the gRPC ModelConfig RPC, and
``proto_to_config_dict`` / :func:`load_pbtxt` read a Triton-style
``config.pbtxt`` of a directory repository through protobuf's
``text_format`` over the port's own ``grpc_service_pb2``. One fix: a BYTES
tensor written ``TYPE_BYTES`` (as every engine config dict writes it)
becomes ``TYPE_STRING``, where the JAX package raises. The queue-policy
and priority blocks are read from a file like any other, so that a model
asking for them fails its load with a reason (the port's engine has
neither yet) instead of loading without them.
"""

from __future__ import annotations

from google.protobuf import text_format

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
    for key, val in (d.get("parameters") or {}).items():
        if isinstance(val, (str, int, float, bool)):
            cfg.parameters[key].string_value = str(val)
    return cfg


def _tensor_dict(t, output: bool) -> dict:
    entry = {"name": t.name, "data_type": pb.DataType.Name(t.data_type),
             "dims": list(t.dims)}
    if t.reshape.shape:
        entry["reshape"] = {"shape": list(t.reshape.shape)}
    if output:
        if t.label_filename:
            entry["label_filename"] = t.label_filename
    elif t.optional:
        entry["optional"] = True
    return entry


def _policy_dict(qp) -> dict:
    return {
        "timeout_action":
            pb.ModelQueuePolicy.TimeoutAction.Name(qp.timeout_action),
        "default_timeout_microseconds": qp.default_timeout_microseconds,
        "allow_timeout_override": qp.allow_timeout_override,
        "max_queue_size": qp.max_queue_size,
    }


def proto_to_config_dict(cfg: "pb.ModelConfig") -> dict:
    """The engine config dict of a ``ModelConfig`` message, as the JAX
    package reads it (its defaults for a field the message leaves unset)."""
    d: dict = {
        "name": cfg.name,
        "platform": cfg.platform or cfg.backend or "pytorch",
        "max_batch_size": cfg.max_batch_size,
        "input": [_tensor_dict(t, False) for t in cfg.input],
        "output": [_tensor_dict(t, True) for t in cfg.output],
    }
    if cfg.HasField("dynamic_batching"):
        db = cfg.dynamic_batching
        d["dynamic_batching"] = {
            "preferred_batch_size": list(db.preferred_batch_size),
            "max_queue_delay_microseconds": db.max_queue_delay_microseconds,
        }
        if db.preserve_ordering:
            d["dynamic_batching"]["preserve_ordering"] = True
        if db.priority_levels:
            d["dynamic_batching"]["priority_levels"] = db.priority_levels
            d["dynamic_batching"]["default_priority_level"] = \
                db.default_priority_level
        if db.HasField("default_queue_policy"):
            d["dynamic_batching"]["default_queue_policy"] = _policy_dict(
                db.default_queue_policy)
        if db.priority_queue_policy:
            d["dynamic_batching"]["priority_queue_policy"] = {
                int(k): _policy_dict(v)
                for k, v in db.priority_queue_policy.items()}
    if cfg.HasField("sequence_batching"):
        sb: dict = {"max_sequence_idle_microseconds":
                    cfg.sequence_batching.max_sequence_idle_microseconds
                    or 1_000_000_000}
        if cfg.sequence_batching.WhichOneof("strategy_choice") == "oldest":
            sb["strategy"] = "oldest"
            oldest = cfg.sequence_batching.oldest
            sb["oldest"] = {
                "max_candidate_sequences":
                    oldest.max_candidate_sequences or 64,
                "max_queue_delay_microseconds":
                    oldest.max_queue_delay_microseconds or 1000,
            }
        d["sequence_batching"] = sb
    if cfg.ensemble_scheduling.step:
        d["ensemble_scheduling"] = {"step": [
            {"model_name": s.model_name, "model_version": s.model_version,
             "input_map": dict(s.input_map), "output_map": dict(s.output_map)}
            for s in cfg.ensemble_scheduling.step]}
    if cfg.instance_group:
        d["instance_group"] = [{"count": g.count or 1}
                               for g in cfg.instance_group]
    if cfg.model_transaction_policy.decoupled:
        d["model_transaction_policy"] = {"decoupled": True}
    if cfg.parameters:
        d["parameters"] = {k: v.string_value
                           for k, v in cfg.parameters.items()}
    return d


def load_pbtxt(path: str) -> dict:
    """Parse a Triton-style ``config.pbtxt`` into an engine config dict."""
    with open(path) as f:
        cfg = text_format.Parse(f.read(), pb.ModelConfig())
    return proto_to_config_dict(cfg)
