"""The fused decode wave: a hand-written Hopper kernel and its plain version.

Counterpart of ``client_tpu/ops/decode_kernel.py`` (the Pallas TPU kernel
``_decode_kernel``). For one layer of one decode wave, lane ``b`` writes
``k_new[b]`` / ``v_new[b]`` (``[H, D]``) into the KV arena at
``(layer, rows[b], lens[b])`` in place and attends ``q[b]`` over positions
``0 .. lens[b]``. The arena is ``[L, R, S, H, D]`` fp32 and is updated in
place, as the JAX version's donated, aliased arena is.

:func:`decode_wave_attention` launches the CUDA kernel in
``client_tpu_torch/csrc/decode_attention.cu`` for tensors on the card and
takes :func:`decode_wave_attention_plain` only for tensors on the CPU. The
kernel is built for head dims 32 and 64 (``HEAD_DIMS``) and raises on any
other. ``launches`` counts kernel launches, and ``launches_by_head_dim``
each instantiation's. Each call reports its work (:func:`work`) to a
roofline capture running on its thread.

A wave's ``rows`` and ``lens`` come as a :class:`WaveIndex`: checked on the
host, where the scheduler holds them as numpy, then staged to the device
once and shared by every layer's launch, with the kernel's split plan
(:func:`split_plan`: how many CTAs share each lane's prefix), computed
from the host's lengths so that no launch waits on a device read.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from client_tpu_torch.observability import roofline
from client_tpu_torch.ops import cuda_build
from client_tpu_torch.utils import lockdep

_NEG_INF = -1e30
HEAD_DIMS = (32, 64)  # the head dims the kernel is instantiated for
_SPLIT_KEYS = 256  # keys per CTA the split plan aims at
_MAX_SPLIT = 8     # CTAs per (lane, head): the portable cluster size

launches = 0
launches_by_head_dim = dict.fromkeys(HEAD_DIMS, 0)
_count_lock = lockdep.Lock("ops.decode_attention.count")
_fwd = None
_bind_lock = lockdep.Lock("ops.decode_attention.bind")


def stage(host: np.ndarray, device: torch.device
          ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Copy a host array to ``device`` without blocking the host. Returns
    the pinned host tensor the copy reads from (None off the card), which
    the caller keeps referenced until the copy's stream has passed it, and
    the device tensor."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return None, t.clone()
    pinned = t.pin_memory()
    return pinned, pinned.to(device, non_blocking=True)


def split_plan(lens) -> int:
    """CTAs that share each (lane, head) of a wave whose lanes have prefix
    lengths ``lens``: ceil(longest / 256), at least 1 and at most 8 (the
    portable cluster size). The same for every lane of the wave: it is the
    launch's cluster size."""
    lens = np.asarray(lens)
    longest = int(lens.max()) if lens.size else 0
    return min(_MAX_SPLIT, max(1, -(-longest // _SPLIT_KEYS)))


class WaveIndex:
    """The lanes of one wave: ``rows`` (arena row per lane) and ``lens``
    (valid prefix length per lane), int32 ``[B]`` on ``device``.

    Built from host arrays, which are checked against the arena's ``n_rows``
    and ``seq`` first (ValueError otherwise), so no kernel launch can be
    handed an index outside the arena. On the card the pinned host copies
    are kept here, referenced until the object is dropped, so the
    asynchronous copies never read a buffer that was reused.

    ``n_split`` is the kernel's split plan for these lengths
    (:func:`split_plan`); :meth:`shifted` and :meth:`local` compute their
    own.

    A shard's view of a wave over a row-sharded arena (:meth:`local`) also
    carries ``owned``, bool ``[B]`` on ``device``: the lanes whose row the
    shard holds. The others point at the shard's junk row with length 0."""

    def __init__(self, rows, lens, n_rows: int, seq: int,
                 device: torch.device | str = "cpu", owned=None):
        rows_np = np.ascontiguousarray(rows, dtype=np.int32)
        lens_np = np.ascontiguousarray(lens, dtype=np.int32)
        if rows_np.ndim != 1 or rows_np.shape != lens_np.shape:
            raise ValueError(f"rows and lens must be two [B] vectors, got "
                             f"{rows_np.shape} and {lens_np.shape}")
        if rows_np.size and (rows_np.min() < 0 or rows_np.max() >= n_rows):
            raise ValueError(f"rows {rows_np.tolist()} outside the arena's "
                             f"[0, {n_rows})")
        if lens_np.size and (lens_np.min() < 0 or lens_np.max() >= seq):
            raise ValueError(f"lens {lens_np.tolist()} outside [0, {seq})")
        self.n_rows, self.seq = int(n_rows), int(seq)
        self.rows_host, self.lens_host = rows_np, lens_np
        self.n_split = split_plan(lens_np)
        host = [rows_np, lens_np]
        self.owned_host = None
        if owned is not None:
            self.owned_host = np.ascontiguousarray(owned, dtype=bool)
            if self.owned_host.shape != rows_np.shape:
                raise ValueError(f"owned must be [B], got "
                                 f"{self.owned_host.shape}")
            host.append(self.owned_host.astype(np.int32))
        self._pinned, staged = stage(np.stack(host), torch.device(device))
        self.rows, self.lens = staged[0], staged[1]
        self.owned = None if owned is None else staged[2] != 0

    def shifted(self, k: int) -> "WaveIndex":
        """The same lanes ``k`` positions further on (chunked decode's step
        ``k``), checked again on the host. Lanes a shard does not own stay
        at length 0."""
        step = k if self.owned_host is None else k * self.owned_host
        return WaveIndex(self.rows_host, self.lens_host + step, self.n_rows,
                         self.seq, self.rows.device, self.owned_host)

    def local(self, lo: int, n_local: int,
              device: torch.device | str) -> "WaveIndex":
        """This wave as the shard holding global rows ``[lo, lo + n_local)``
        sees it: an owned lane keeps its length and gets row ``row - lo``;
        any other lane gets the shard's junk row ``n_local - 1`` and length
        0. JAX computes this on the device in every layer; here it is done
        once per wave on the host, and checked like any index."""
        owned = (self.rows_host >= lo) & (self.rows_host < lo + n_local)
        return WaveIndex(np.where(owned, self.rows_host - lo, n_local - 1),
                         np.where(owned, self.lens_host, 0), n_local,
                         self.seq, device, owned)


def work(index: WaveIndex, heads: int, dim: int) -> tuple[float, int]:
    """(FLOPs, bytes) of one layer's call, from the lanes' host lengths:
    each lane's valid K/V prefix read once, q, k_new, v_new read and the
    output written, the two scattered slots, rows and lens; q.k and p.v
    over the prefix and the new position at 2 FLOP per MAC."""
    b = int(index.lens_host.shape[0])
    keys = int(index.lens_host.sum())
    lane_bytes = heads * dim * 4
    nbytes = (2 * keys * lane_bytes + 4 * b * lane_bytes
              + 2 * b * lane_bytes + 2 * b * 4)
    return 4.0 * heads * dim * (keys + b), nbytes


def decode_wave_attention_plain(k_arena: torch.Tensor, v_arena: torch.Tensor,
                                q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, index: WaveIndex, *,
                                layer: int) -> torch.Tensor:
    """The port of ``reference_decode_attention``: scatter the new K/V in
    place, gather each lane's row, dense masked softmax over ``pos <=
    lens``. Returns ``o`` ``[B, H, D]``. Padded lanes that share the dummy
    row read whichever of their stores landed last there; their outputs are
    junk in every version and are discarded."""
    rows, lens = index.rows.long(), index.lens.long()
    k_arena[layer, rows, lens] = k_new
    v_arena[layer, rows, lens] = v_new
    ck = k_arena[layer, rows]                       # [B, S, H, D]
    cv = v_arena[layer, rows]
    scores = torch.einsum("bhd,bshd->bhs", q, ck) / math.sqrt(q.shape[-1])
    pos = torch.arange(k_arena.shape[2], device=q.device)
    mask = pos[None, :] <= lens[:, None]
    scores = torch.where(mask[:, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(scores, dim=-1), cv)


def load_kernel():
    """Build (on first use) and bind the kernel's C entry point."""
    global _fwd
    with _bind_lock:
        if _fwd is None:
            lib = cuda_build.load("decode_attention")
            fn = lib.client_tpu_decode_wave_fwd
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.client_tpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.client_tpu_cuda_error_string.restype = ctypes.c_char_p
            _fwd = (fn, lib.client_tpu_cuda_error_string)
        return _fwd


def check_kernel_args(k_arena: torch.Tensor, v_arena: torch.Tensor,
                      q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, index: WaveIndex,
                      layer: int) -> None:
    """Raise ValueError for what the kernel does not take: anything but
    contiguous fp32 ``[L, R, S, H, D]`` arenas, D in ``HEAD_DIMS``, at
    16-byte aligned addresses (the kernel's TMA loads need it) and ``[B, H,
    D]`` lanes on one
    device, an index checked for another arena, or a layer out of range."""
    if k_arena.dim() != 5 or k_arena.shape != v_arena.shape:
        raise ValueError(f"k/v arenas must share one [L, R, S, H, D] shape, "
                         f"got {tuple(k_arena.shape)}, {tuple(v_arena.shape)}")
    n_layers, n_rows, seq, heads, dim = k_arena.shape
    b = index.rows.shape[0]
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.shape != (b, heads, dim):
            raise ValueError(f"{name} must be [{b}, {heads}, {dim}], got "
                             f"{tuple(t.shape)}")
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena), ("q", q),
                    ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != k_arena.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {k_arena.device}")
    if dim not in HEAD_DIMS:
        raise ValueError(
            f"the kernel is built for head dims {HEAD_DIMS}, got {dim}")
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address")
    if (index.n_rows, index.seq) != (n_rows, seq):
        raise ValueError(
            f"the wave index was checked for {index.n_rows} rows of "
            f"{index.seq}, the arena has {n_rows} of {seq}")
    if index.rows.device != k_arena.device:
        raise ValueError(f"the wave index is on {index.rows.device}, the "
                         f"arena on {k_arena.device}")
    if n_layers * n_rows * seq >= 2**31:
        raise ValueError(f"the kernel indexes at most 2^31 arena positions, "
                         f"got {n_layers} x {n_rows} x {seq}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    if b > 65535:
        raise ValueError(f"at most 65535 lanes per launch, got {b}")


def decode_wave_attention(k_arena: torch.Tensor, v_arena: torch.Tensor,
                          q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, index: WaveIndex, *,
                          layer: int) -> torch.Tensor:
    """One layer's fused decode wave; returns ``o`` ``[B, H, D]`` and
    updates the arenas in place. On the card this launches the Hopper
    kernel as ``B * H`` clusters of ``index.n_split`` CTAs (or raises with
    the runtime's message, for a cluster the card refuses too); on the CPU
    it is the plain version."""
    if k_arena.device.type == "cpu":
        # The plain version's torch ops count their own FLOPs.
        roofline.kernel_work(0.0, work(index, q.shape[1], q.shape[2])[1])
        return decode_wave_attention_plain(k_arena, v_arena, q, k_new, v_new,
                                           index, layer=layer)
    if k_arena.device.type != "cuda":
        raise ValueError(
            f"decode_wave_attention runs on cuda or cpu, not {k_arena.device}")
    check_kernel_args(k_arena, v_arena, q, k_new, v_new, index, layer)
    b, heads, dim = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    fwd, err_str = load_kernel()
    with torch.cuda.device(k_arena.device):
        stream = torch.cuda.current_stream(k_arena.device).cuda_stream
        err = fwd(k_arena.data_ptr(), v_arena.data_ptr(), q.data_ptr(),
                  k_new.data_ptr(), v_new.data_ptr(), index.rows.data_ptr(),
                  index.lens.data_ptr(), out.data_ptr(), b, heads, dim,
                  k_arena.shape[0], layer, k_arena.shape[1],
                  k_arena.shape[2], index.n_split,
                  1.0 / math.sqrt(dim), stream)
    if err != 0:
        raise RuntimeError(
            f"decode wave kernel launch failed: {err_str(err).decode()}")
    roofline.kernel_work(*work(index, heads, dim))
    global launches
    with _count_lock:
        launches += 1
        launches_by_head_dim[dim] += 1
    return out
