"""Sharding across devices for serving.

Counterpart of ``client_tpu/parallel/__init__.py``: the mesh and its
collectives, within a process and across processes (``mesh``), the
process group and global meshes (``multihost``), ring attention over a
sequence axis (``ring_attention``), expert-parallel MoE and its train
step (``moe``), pipeline stages and their train step (``pipeline``), the
training LM, AdamW and its train step (``training``), the six sharded
serving families (``serving``), the row-sharded KV arena of the
generative engine (``kv_shard``) and DLRM's row-sharded embedding tables
(``emb_shard``).
"""

from client_tpu_torch.parallel.emb_shard import (  # noqa: F401
    emb_mesh,
    shard_table,
    sharded_bag_sum,
)
from client_tpu_torch.parallel.kv_shard import (  # noqa: F401
    arena_row_layout,
    kv_mesh,
    ring_all_reduce,
    shard_arena,
    sharded_decode_attention,
)
from client_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_axes,
)
from client_tpu_torch.parallel.moe import moe_ffn  # noqa: F401
from client_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: F401
