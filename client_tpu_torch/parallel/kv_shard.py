"""The row-sharded KV arena, its fused decode wave, and kernel K3.

Counterpart of ``client_tpu/parallel/kv_shard.py``. The arena's row axis
is split over the ``n`` shards of a ``"kv"`` mesh: each stream's whole
context lives on one shard, so a decode wave needs no cross-shard softmax.
Each shard runs the fused decode kernel K2 (``ops/decode_attention.py``)
on its own rows, the lanes it does not own contribute zeros, and the
partial outputs are summed across the shards.

Row layout (:func:`arena_row_layout`): one junk row per shard, the last
local row of each, takes the scatters of the lanes that shard does not
own; shard 0's junk row is also the dummy row the scheduler pads with.

The sum is :func:`ring_all_reduce`, kernel K3
(``client_tpu_torch/csrc/ring_all_reduce.cu``), or with ``combine="psum"``
a plain sum, the counterpart of ``jax.lax.psum``. JAX runs one program per
device under ``shard_map``; the port drives every shard from the one
process and stream that calls it, as JAX's single controller does. A mesh
may repeat a device (the counterpart of JAX's virtual CPU devices): the
CPU tests put every shard on ``cpu``, and one card can hold every shard.
A mesh over distinct cards is not built yet (:func:`kv_mesh` raises).
"""

from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from client_tpu_torch.observability import roofline
from client_tpu_torch.ops import cuda_build
from client_tpu_torch.ops.decode_attention import (
    WaveIndex,
    decode_wave_attention,
)
from client_tpu_torch.utils import lockdep

# The range the kernel takes, the one the staged kernel it replaced took
# (8 16-byte groups of every partial in a block's 227 KB of shared memory).
# What holds it there now is the launch: the pointer tables go by value, 2 x
# 1,816 pointers (29 KB) of the 32,764 bytes of parameters CUDA allows.
_MAX_SHARDS = 1816
# The partials' dtypes the kernel sums, by its C code.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = 0
launches_by_dtype = collections.Counter()  # by the partials' dtype
launches_by_shards = collections.Counter()  # by (dtype, shard count)
_count_lock = lockdep.Lock("parallel.kv_shard.count")
_fwd = None
_bind_lock = lockdep.Lock("parallel.kv_shard.bind")


class KvMesh:
    """The ``"kv"`` axis: one torch device per shard, in shard order."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def kv_mesh(n_shards: int,
            devices: Sequence[torch.device | str] | None = None, *,
            axis: str = "kv") -> KvMesh:
    """A ``"kv"`` mesh of ``n_shards``: by default the first ``n_shards``
    CUDA devices (ValueError when there are fewer), else ``devices``, which
    may repeat one device. Raises NotImplementedError for distinct devices:
    shards on several cards are not built yet. ``axis`` names the mesh in
    the error messages (``parallel.emb_shard`` builds its ``"emb"`` mesh
    here)."""
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"{axis}_shards must be >= 1, got {n_shards}")
    if devices is None:
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(
                f"{axis}_shards={n} but runtime has {count} device(s)")
        picked = [torch.device("cuda", i) for i in range(n)]
    else:
        picked = [torch.device(d) for d in devices]
        if len(picked) != n:
            raise ValueError(f"{axis}_shards={n} but {len(picked)} "
                             "device(s) were given")
        picked = [torch.device("cuda", torch.cuda.current_device())
                  if d.type == "cuda" and d.index is None else d
                  for d in picked]
    if len(set(picked)) > 1:
        raise NotImplementedError(
            f"a {axis} mesh over distinct devices "
            f"{sorted(map(str, set(picked)))} is not built yet; place every "
            "shard on one device")
    return KvMesh(picked)


def arena_row_layout(capacity: int, n_shards: int
                     ) -> tuple[int, list[int], int]:
    """(total_rows, free_rows, dummy_row) for a ``capacity``-stream arena
    over ``n_shards``. Unsharded: ``capacity`` real rows plus the one
    trailing dummy. Sharded: ``capacity`` real rows plus one junk row per
    shard (each shard's last local row), so ``capacity`` must divide
    evenly; every shard then holds ``capacity / n + 1`` rows."""
    if n_shards <= 1:
        return capacity + 1, list(range(capacity)), capacity
    if capacity % n_shards:
        raise ValueError(
            f"max_streams ({capacity}) must be divisible by kv_shards "
            f"({n_shards}) for an even row partition")
    total = capacity + n_shards
    r_loc = total // n_shards
    free = [r for r in range(total) if (r + 1) % r_loc != 0]
    return total, free, r_loc - 1


@dataclass
class ShardedKvArena:
    """The generative KV cache split by rows over a mesh, updated in place.
    Shard ``i`` holds global rows ``[i * r, (i + 1) * r)`` of ``r = R / n``.
    """

    k: list[torch.Tensor]  # per shard [L, R / n, S, H, D], the arena's dtype
    v: list[torch.Tensor]
    tok: torch.Tensor      # [R] int32, once, on the caller's device


def shard_arena(arena, mesh: KvMesh) -> ShardedKvArena:
    """Split an arena (``k`` / ``v`` ``[L, R, S, H, D]`` and ``tok``
    ``[R]``) by rows over ``mesh``: each shard's contiguous copy goes to its
    device; ``tok`` stays where it is."""
    n = mesh.size
    if arena.k.shape[1] % n:
        raise ValueError(f"{arena.k.shape[1]} arena rows do not split over "
                         f"{n} shards")

    def split(t):
        return [part.to(device=dev, memory_format=torch.contiguous_format,
                        copy=True)
                for part, dev in zip(torch.tensor_split(t, n, dim=1),
                                     mesh.devices)]

    return ShardedKvArena(k=split(arena.k), v=split(arena.v), tok=arena.tok)


class ShardedWaveIndex:
    """One wave's lanes over a row-sharded arena: the global index (the
    token slots and positions read it) and each shard's local index
    (:meth:`WaveIndex.local`), built and staged once per wave."""

    def __init__(self, index: WaveIndex, mesh: KvMesh):
        n = mesh.size
        if index.n_rows % n:
            raise ValueError(f"{index.n_rows} arena rows do not split over "
                             f"{n} shards")
        r_loc = index.n_rows // n
        self.index, self.mesh = index, mesh
        self.rows, self.lens = index.rows, index.lens
        self.shards = [index.local(i * r_loc, r_loc, dev)
                       for i, dev in enumerate(mesh.devices)]

    def shifted(self, k: int) -> "ShardedWaveIndex":
        """The same lanes ``k`` positions further on (chunked decode)."""
        return ShardedWaveIndex(self.index.shifted(k), self.mesh)


# -- K3: ring all-reduce -------------------------------------------------------


def _check_partials(parts: list[torch.Tensor]) -> None:
    if not parts:
        raise ValueError("ring_all_reduce needs at least one partial")
    for i, p in enumerate(parts):
        if p.shape != parts[0].shape or p.dtype != parts[0].dtype:
            raise ValueError(
                f"partial {i} is {p.dtype} {tuple(p.shape)}, partial 0 "
                f"{parts[0].dtype} {tuple(parts[0].shape)}")


def ring_all_reduce_plain(partials: Sequence[torch.Tensor]
                          ) -> list[torch.Tensor]:
    """The ring's hops step by step: at each of the ``n - 1`` hops shard
    ``i`` receives what shard ``i - 1`` held and adds it, so shard ``i``
    sums ``x_i + x_{i-1} + x_{i-2} + ...`` in that order, each hop's sum
    in the partials' dtype, as K3 and JAX's ``_ring_kernel`` do. Returns
    the ``n`` sums, each on its shard's device; ``n == 1`` returns the
    input. Hop ``j`` is one add of the partials rolled by ``j`` (shard
    ``i`` receives ``x_{i-j}``), on the first shard's device: the same
    additions as one hop a shard, in n - 1 launches."""
    parts = list(partials)
    _check_partials(parts)
    n = len(parts)
    if n == 1:
        return parts
    x = torch.stack([p.to(parts[0].device) for p in parts])
    out = x.clone()
    for j in range(1, n):
        out += x.roll(j, 0)
    return [o.to(p.device) for o, p in zip(out.unbind(0), parts)]


def load_kernel():
    """Build (on first use) and bind the kernel's C entry points: the
    launch, the error string, and the walk's plan (:func:`ring_plan`)."""
    global _fwd
    with _bind_lock:
        if _fwd is None:
            lib = cuda_build.load("ring_all_reduce")
            fn = lib.client_tpu_ring_all_reduce
            fn.argtypes = [ctypes.c_void_p] * 2 + [
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.client_tpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.client_tpu_cuda_error_string.restype = ctypes.c_char_p
            plan = lib.client_tpu_ring_all_reduce_plan
            plan.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
            plan.restype = ctypes.c_int
            _fwd = (fn, lib.client_tpu_cuda_error_string, plan)
        return _fwd


_PLAN_FIELDS = ("lane_bytes", "r", "warps", "blocks", "ring_rows", "whole",
                "staged")


def ring_plan(n: int, numel: int, dtype: torch.dtype,
              align: int = 16) -> dict | None:
    """How the kernel runs ``n`` partials of ``numel`` elements of
    ``dtype`` whose pointers are all ``align``-byte aligned: None for
    ``n <= 8`` (one launch of the unrolled kernel), else the walk's two
    passes, ``{"main": ..., "tail": ...}``, each a dict of its lane bytes
    (4, 8 or 16; 2 for one bf16/fp16 element; 0: no pass), chains a thread
    ``r``, ``warps`` a CTA, shard ``blocks``, ``ring_rows``, ``whole``
    (every row staged at once) and ``staged`` (0: the direct walk, which
    reads every partial into registers, up to 16 shards). Builds the
    kernel on first use."""
    if n <= 8:
        return None
    out = (ctypes.c_int * 14)()
    _, err_str, plan = load_kernel()
    err = plan(n, numel, _DTYPES[dtype], align, out)
    if err != 0:
        raise ValueError(f"no plan for {n} shards of {numel} {dtype}: "
                         f"{err_str(err).decode()}")
    return {"main": dict(zip(_PLAN_FIELDS, out[:7])),
            "tail": dict(zip(_PLAN_FIELDS, out[7:]))}


def ring_work(n: int, numel: int, elem_bytes: int = 4) -> tuple[float, int]:
    """(FLOPs, bytes) of an all-reduce of ``n`` partials of ``numel``
    elements of ``elem_bytes`` each: each partial read once and each of
    the ``n`` sums written once, and ``(n - 1) * n * numel``
    additions."""
    return float((n - 1) * n * numel), 2 * n * numel * elem_bytes


def ring_all_reduce(partials: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce-sum of ``n`` same-shaped partials, one per shard; returns
    the ``n`` sums (replicated) in the partials' dtype, each in the ring's
    order of additions, every hop's sum rounded to that dtype. ``n == 1``
    returns the input without a launch. On the card this launches K3 once
    (or raises): every partial contiguous fp32, bf16 or fp16 on one card,
    at most 1,816 of them; past 8 the register-blocked walk
    (:func:`ring_plan`). On the CPU it is the plain version.
    ``launches`` counts the launches, ``launches_by_dtype`` them by the
    partials' dtype and ``launches_by_shards`` by (dtype, shard count)."""
    parts = list(partials)
    _check_partials(parts)
    n = len(parts)
    if n == 1:
        return parts
    device, dtype = parts[0].device, parts[0].dtype
    if all(p.device.type == "cpu" for p in parts):
        roofline.kernel_work(0.0, ring_work(n, parts[0].numel(),
                                            parts[0].element_size())[1])
        return ring_all_reduce_plain(parts)
    if device.type != "cuda":
        raise ValueError(f"ring_all_reduce runs on cuda or cpu, not {device}")
    if dtype not in _DTYPES:
        raise ValueError(f"the ring all-reduce kernel sums float32, bfloat16 "
                         f"or float16 partials, got {dtype}")
    for i, p in enumerate(parts):
        if p.device != device:
            raise ValueError(f"partial {i} is on {p.device}, partial 0 on "
                             f"{device}: the kernel takes one card")
        if not p.is_contiguous():
            raise ValueError(f"partial {i} must be contiguous")
    if n > _MAX_SHARDS:
        raise ValueError(f"the ring all-reduce kernel takes 1 to "
                         f"{_MAX_SHARDS} shards (their pointer tables go by "
                         f"value with the launch), got {n}")
    numel = parts[0].numel()
    out = torch.empty((n, *parts[0].shape), dtype=dtype, device=device)
    if numel == 0:
        return list(out.unbind(0))
    sums = out.unbind(0)

    def ptrs(tensors):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors])

    fwd, err_str, _ = load_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fwd(ptrs(parts), ptrs(sums), n, numel, _DTYPES[dtype],
                  stream)
    if err != 0:
        raise RuntimeError(
            f"ring all-reduce kernel launch failed: {err_str(err).decode()}")
    roofline.kernel_work(*ring_work(n, numel, parts[0].element_size()))
    global launches
    with _count_lock:
        launches += 1
        launches_by_dtype[dtype] += 1
        launches_by_shards[dtype, n] += 1
    return list(sums)


# -- the sharded fused decode wave ---------------------------------------------


def sharded_decode_attention(mesh: KvMesh, arena: ShardedKvArena,
                             q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, index: ShardedWaveIndex, *,
                             layer: int, combine: str = "ring"
                             ) -> torch.Tensor:
    """One layer's fused decode wave over a row-sharded arena: every shard
    runs K2 on its own rows (lanes it does not own scatter into its junk
    row with length 0), the unowned lanes' outputs are set to 0 (K2 gives
    exactly ``v_new`` at length 0), and ``combine`` sums the partials:
    ``"ring"`` through K3, ``"psum"`` plainly. Updates the shards in place
    and returns ``o`` ``[B, H, D]`` on the mesh's first device."""
    if combine not in ("ring", "psum"):
        raise ValueError(f"combine must be 'ring' or 'psum', got {combine!r}")
    if index.mesh is not mesh or len(arena.k) != mesh.size:
        raise ValueError("the arena and the wave index must be split over "
                         "this mesh")
    parts = []
    for k_sh, v_sh, dev, local in zip(arena.k, arena.v, mesh.devices,
                                      index.shards):
        o = decode_wave_attention(k_sh, v_sh, q.to(dev), k_new.to(dev),
                                  v_new.to(dev), local, layer=layer)
        parts.append(torch.where(local.owned[:, None, None], o, 0.0))
    if combine == "ring":
        return ring_all_reduce(parts)[0]
    first = mesh.devices[0]
    return torch.stack([p.to(first) for p in parts]).sum(0)
