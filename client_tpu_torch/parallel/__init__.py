"""Sharding across devices for serving.

Counterpart of ``client_tpu/parallel/__init__.py``; what is ported so far
is the row-sharded KV arena of the generative engine (``kv_shard``).
"""

from client_tpu_torch.parallel.kv_shard import (  # noqa: F401
    arena_row_layout,
    kv_mesh,
    ring_all_reduce,
    shard_arena,
    sharded_decode_attention,
)
