"""A mesh of torch devices with named axes, and the collectives over it.

Counterpart of ``client_tpu/parallel/mesh.py``. Axis vocabulary:

- ``dp`` — data parallel (batch dimension)
- ``sp`` — sequence/context parallel (sequence dimension)
- ``tp`` — tensor parallel (hidden/heads dimensions)
- ``pp`` — pipeline parallel (layer stages)
- ``ep`` — expert parallel (MoE experts)

JAX runs one program per device and lets GSPMD or ``shard_map`` insert the
collectives. The port drives every shard of a process from the one calling
thread, as ``parallel/kv_shard.py`` does: a sharded value is a list of
per-shard tensors along an axis, and :func:`psum`, :func:`all_gather` and
:func:`ppermute` are plain torch over that list. Within a process a mesh
repeats one device (the counterpart of JAX's virtual CPU devices): the CPU
tests put eight shards on ``cpu``, and one card can hold every shard. A
mesh over distinct devices of one process is not built yet
(:func:`make_mesh` raises).

A mesh may span processes (``parallel/multihost.py`` ``global_mesh``):
its ``ranks`` grid says which process owns each shard, and the ranks may
vary along one axis only, the process axis (``process_axis``), each
process holding a contiguous run of its indices. Along that axis a shard
list holds this process's shards only (:meth:`Mesh.local`), and the
collectives exchange the rest over the ``torch.distributed`` process
group: every process gathers every shard and sums in shard order
(:func:`sum_in_order`), so a forward gives the same bits in every process
and on the one-process mesh. Under gloo, card tensors are staged through
the host by an explicit copy at the exchange; the compute stays on the
card.

The exchanges are autograd functions, so a train step differentiates
through them. A value replicated over the processes holds
its whole cotangent in every process (as a GSPMD array is one value):
the backward of :func:`all_gather` and :func:`psum` takes this process's
slice of it, and a replicated value that per-process work reads first
passes :func:`vary`, whose backward is the sum over the processes. So
an all-gather read per process transposes to a reduce-scatter,
:func:`ppermute` to the inverse permutation, and no gradient is scaled by
the process count. Every process must build a graph of the same shape,
so that autograd runs the backward exchanges in the same order in each
(so a pipeline whose ``pp`` spans processes computes every stage on
every tick).

:func:`place_with_specs` splits a params tree by per-leaf specs (tuples of
axis names, :func:`P`), as ``jax.device_put`` with ``NamedSharding`` does:
each leaf becomes a :class:`Shards` of per-shard views.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def P(*axes) -> tuple:
    """A partition spec: one mesh axis name (or None) per tensor dim, the
    counterpart of ``jax.sharding.PartitionSpec``."""
    return tuple(axes)


def _factor(n: int, ways: int) -> list[int]:
    """Greedy near-balanced factorization of n into `ways` factors."""
    dims = [1] * ways
    remaining = n
    i = ways - 1
    while remaining > 1 and i >= 0:
        # largest power-of-two-ish divisor step: prefer 2s
        f = 2 if remaining % 2 == 0 else remaining
        dims[i] *= f
        remaining //= f
        i = (i - 1) if i > 0 else ways - 1
    return dims


def mesh_axes(n_devices: int,
              axes: tuple[str, ...] = ("dp", "sp", "tp")) -> dict[str, int]:
    """Pick per-axis sizes whose product is n_devices."""
    dims = _factor(n_devices, len(axes))
    assert int(np.prod(dims)) == n_devices, (dims, n_devices)
    return dict(zip(axes, dims))


def drop_absent(mesh, axis):
    """Null out spec entries naming axes this mesh doesn't carry."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh.shape)
        return kept if kept else None
    return axis if axis in mesh.shape else None


class Mesh:
    """Named axes over a grid of torch devices. ``shape`` is ``{axis:
    size}`` in axis order, as JAX's ``mesh.shape``; ``devices`` is the grid
    (an object array). Every shard of this process is on one device
    (:attr:`device`).

    ``ranks`` (an int grid of the same shape; None: every shard is this
    process's) says which process owns each shard, ``rank`` is this
    process's. The ranks may vary along one axis only (``process_axis``),
    in contiguous runs; any other layout raises NotImplementedError."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: np.ndarray | None = None, rank: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid cannot carry "
                             f"the axes {self.axis_names}")
        if ranks is None:
            ranks = np.zeros(devices.shape, dtype=np.int64)
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.rank = int(rank)
        if self.ranks.shape != devices.shape:
            raise ValueError(f"ranks {self.ranks.shape} and devices "
                             f"{devices.shape} differ in shape")
        mine = self.ranks == self.rank
        if not mine.any():
            raise ValueError(f"process {self.rank} owns no shard of the mesh")
        distinct = {str(d) for d in devices[mine].flat}
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over distinct devices {sorted(distinct)} is not "
                "built yet; place every shard on one device")
        self.device = devices[mine].flat[0]
        self.process_axis = None
        self._local = {}
        varying = [i for i in range(devices.ndim)
                   if (np.diff(self.ranks, axis=i) != 0).any()]
        if len(varying) > 1 or (varying and (np.diff(
                self.ranks, axis=varying[0]) < 0).any()):
            raise NotImplementedError(
                f"ranks {self.ranks.tolist()}: a mesh may span processes "
                "along one axis only, each process a contiguous run of it")
        if varying:
            self.process_axis = self.axis_names[varying[0]]
            along = np.moveaxis(self.ranks, varying[0], 0).reshape(
                devices.shape[varying[0]], -1)[:, 0]
            idx = np.flatnonzero(along == self.rank)
            self._local[self.process_axis] = range(int(idx[0]),
                                                   int(idx[-1]) + 1)
            self.n_processes = len(set(along.tolist()))
        else:
            self.n_processes = 1

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        """The axis's size, 1 for an axis this mesh does not carry."""
        return int(self.shape.get(axis, 1))

    def local(self, axis: str) -> range:
        """The indices along ``axis`` whose shards this process holds:
        every index, but a run of them along the process axis."""
        return self._local.get(axis, range(self.axis_size(axis)))

    def crosses(self, axis: str) -> bool:
        """Whether ``axis`` spans processes."""
        return axis == self.process_axis

    def check_crossing(self, allowed: tuple[str, ...], what: str) -> None:
        """Raise NotImplementedError when the mesh spans processes along
        an axis ``what`` does not exchange over."""
        if self.process_axis is not None and \
                self.process_axis not in allowed:
            raise NotImplementedError(
                f"{what} across processes is built along {allowed or 'no'} "
                f"axis, not '{self.process_axis}'")

    def __repr__(self) -> str:
        spans = (f", {self.n_processes} processes along "
                 f"'{self.process_axis}'" if self.process_axis else "")
        return f"Mesh({self.shape}, device={self.device}{spans})"


def make_mesh(n_devices: int | None = None,
              axes: tuple[str, ...] = ("dp", "sp", "tp"),
              axis_sizes: dict[str, int] | None = None,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``, by default every
    CUDA device (one on a one-card machine, a degree-1 mesh, as JAX on one
    chip). ``devices`` may repeat one device. Raises ValueError for more
    devices than there are, and NotImplementedError for distinct devices."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "CUDA is not available: a mesh takes every CUDA device by "
                "default; pass devices=['cpu'] * n for shards on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    picked = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        picked.append(d)
    if n_devices is None:
        n_devices = len(picked)
    if n_devices > len(picked):
        raise ValueError(
            f"requested {n_devices} devices, runtime has {len(picked)}")
    sizes = axis_sizes or mesh_axes(n_devices, axes)
    shape = tuple(int(sizes[a]) for a in axes)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"axis sizes {sizes} do not multiply to "
                         f"{n_devices} devices")
    grid = np.empty(n_devices, dtype=object)
    for i, d in enumerate(picked[:n_devices]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


# -- the collectives ----------------------------------------------------------


def _check_parts(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str):
    if len(parts) != len(mesh.local(axis)):
        raise ValueError(f"{len(parts)} shards along '{axis}', the mesh has "
                         f"{len(mesh.local(axis))} here")


def split(mesh: Mesh, x: torch.Tensor, dim: int, axis: str
          ) -> list[torch.Tensor]:
    """``x`` split evenly along ``dim`` over ``axis``: one view per shard
    this process holds, in shard order (one shard, ``x`` itself, when the
    mesh lacks the axis). Raises ValueError when the dim does not divide."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over '{axis}' ({n})")
    size = x.shape[dim] // n
    return [x.narrow(dim, i * size, size).to(mesh.device)
            for i in mesh.local(axis)]


def sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Partials added in shard order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _exchange(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` from every process of the mesh, in process order (an
    all-gather over the default process group). Under gloo a card tensor
    goes through the host: an explicit copy out and one back."""
    import torch.distributed as dist

    staged = t.device.type == "cuda" and dist.get_backend() == "gloo"
    send = (t.detach().cpu() if staged else t.detach()).contiguous()
    got = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    dist.all_gather(got, send)
    return [g.to(t.device) for g in got] if staged else got


class _AllGather(torch.autograd.Function):
    """This process's stacked shards ``[L, ...]`` along the process axis ->
    every shard ``[n, ...]``, the same in every process. Backward: this
    process's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
        ctx.span = mesh.local(mesh.process_axis)
        return torch.cat(_exchange(mesh, local))

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return None, ct[ctx.span.start:ctx.span.stop]


class _Vary(torch.autograd.Function):
    """A replicated value read by per-process work: the identity forward;
    backward, each process's cotangent summed over the processes in
    process order (the transpose of the replication)."""

    @staticmethod
    def forward(ctx, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return None, sum_in_order(_exchange(ctx.mesh, ct))


def vary(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x``, replicated over ``axis``, as per-shard work along it reads it:
    itself unless ``axis`` spans processes and ``x`` carries a gradient,
    then :class:`_Vary` (backward: the sum over the processes)."""
    if mesh.crosses(axis) and torch.is_grad_enabled() and x.requires_grad:
        return _Vary.apply(mesh, x)
    return x


def _gather_all(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str
                ) -> list[torch.Tensor]:
    """Every shard along ``axis`` in shard order: ``parts`` itself, or, when
    the axis spans processes, every process's (:class:`_AllGather`)."""
    _check_parts(mesh, parts, axis)
    if not mesh.crosses(axis):
        return list(parts)
    return list(_AllGather.apply(mesh, torch.stack(list(parts))).unbind(0))


def psum(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str
         ) -> torch.Tensor:
    """The sum of one partial per shard along ``axis``, added in shard
    order: the value every shard holds after ``jax.lax.psum``."""
    return sum_in_order(_gather_all(mesh, parts, axis))


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str,
               dim: int = 0) -> torch.Tensor:
    """The shards along ``axis`` joined along ``dim`` in shard order (a
    tiled ``jax.lax.all_gather``)."""
    full = _gather_all(mesh, parts, axis)
    return full[0] if len(full) == 1 else torch.cat(full, dim=dim)


def ppermute(mesh: Mesh, parts: Sequence, axis: str) -> list:
    """One hop right around the ring along ``axis``: shard ``j`` sends to
    ``(j + 1) % n``, so shard ``j`` then holds what shard ``j - 1`` had.
    Across processes the shards are gathered (:class:`_AllGather`) and
    each process takes its own (:class:`_Vary`): backward, the inverse
    permutation."""
    _check_parts(mesh, parts, axis)
    n = mesh.axis_size(axis)
    if not mesh.crosses(axis):
        return [parts[(j - 1) % n] for j in range(n)]
    full = _AllGather.apply(mesh, torch.stack(list(parts)))
    full = vary(mesh, full, axis)
    return [full[(j - 1) % n] for j in mesh.local(axis)]


# -- placement ----------------------------------------------------------------


class Shards:
    """One leaf placed by a spec: ``axes`` are the mesh axes it is split
    over, in dim order, and ``parts`` an object array of per-shard tensors
    indexed by those axes' coordinates (None at a shard another process
    holds). A leaf split over no axis (replicated) has one part."""

    def __init__(self, axes: tuple[str, ...], parts: np.ndarray,
                 mesh: Mesh | None = None):
        self.axes = axes
        self.parts = parts
        self.mesh = mesh

    def part(self, **coords: int) -> torch.Tensor:
        """The shard at ``coords`` (axis=index); axes the leaf is not split
        over are ignored, since it is replicated along them."""
        return self.parts[tuple(coords.get(a, 0) for a in self.axes)]

    def along(self, axis: str, **coords: int) -> list[torch.Tensor]:
        """This process's shards along ``axis`` in order, at ``coords`` on
        the other axes (one shard when the leaf is not split over
        ``axis``)."""
        if axis not in self.axes:
            return [self.part(**coords)]
        n = self.parts.shape[self.axes.index(axis)]
        got = [self.part(**{**coords, axis: i}) for i in range(n)]
        return [p for p in got if p is not None]


def place(mesh: Mesh, x: torch.Tensor, spec: tuple) -> Shards:
    """``x`` split by ``spec`` (one axis name or None per leading dim),
    mesh-absent axes dropped, into per-shard views on the mesh's device;
    only this process's shards along the process axis."""
    spec = tuple(drop_absent(mesh, a) for a in spec)
    dims = []
    for dim, axis in enumerate(spec):
        if isinstance(axis, tuple):
            if len(axis) > 1:
                raise ValueError(f"spec {spec}: one mesh axis per dim")
            axis = axis[0]
        if axis is not None:
            dims.append((dim, axis))
    axes = tuple(a for _, a in dims)
    parts = np.empty(tuple(mesh.axis_size(a) for a in axes), dtype=object)
    for dim, axis in dims:
        if x.shape[dim] % mesh.axis_size(axis):
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over '{axis}' "
                             f"({mesh.axis_size(axis)})")
    for idx in np.ndindex(*parts.shape):
        if any(i not in mesh.local(axis) for (_, axis), i in zip(dims, idx)):
            continue  # another process's shard
        t = x
        for (dim, axis), i in zip(dims, idx):
            size = x.shape[dim] // mesh.axis_size(axis)
            t = t.narrow(dim, i * size, size)
        parts[idx] = t.to(mesh.device)
    return Shards(axes, parts, mesh)


def place_with_specs(mesh: Mesh, params, specs):
    """A params tree (dicts, lists, tensor leaves) with each leaf placed by
    the matching entry of ``specs`` (:func:`place`), mesh-absent axes
    dropped."""
    if isinstance(params, dict):
        return {k: place_with_specs(mesh, v, specs[k])
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [place_with_specs(mesh, v, s) for v, s in zip(params, specs)]
    return place(mesh, params, specs)


def dp_map(mesh: Mesh | None, fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to each ``dp`` shard of the batch (dim 0) of ``xs``,
    the outputs joined in shard order (across processes when ``dp`` spans
    them); one call when there is no ``dp``."""
    if mesh is None or mesh.axis_size("dp") == 1:
        return fn(*xs)
    shards = [split(mesh, x, 0, "dp") for x in xs]
    return all_gather(mesh, [fn(*parts) for parts in zip(*shards)], "dp")
