"""A mesh of torch devices with named axes, and the collectives over it.

Counterpart of ``client_tpu/parallel/mesh.py``. Axis vocabulary:

- ``dp`` — data parallel (batch dimension)
- ``sp`` — sequence/context parallel (sequence dimension)
- ``tp`` — tensor parallel (hidden/heads dimensions)
- ``pp`` — pipeline parallel (layer stages)
- ``ep`` — expert parallel (MoE experts)

JAX runs one program per device and lets GSPMD or ``shard_map`` insert the
collectives. The port drives every shard from the one calling thread, as
``parallel/kv_shard.py`` does: a sharded value is a list of per-shard
tensors along an axis, and :func:`psum`, :func:`all_gather` and
:func:`ppermute` are plain torch over that list. A mesh may repeat one
device (the counterpart of JAX's virtual CPU devices): the CPU tests put
eight shards on ``cpu``, and one card can hold every shard. A mesh over
distinct devices is not built yet (:func:`make_mesh` raises).

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
    (an object array). Every shard is on one device (:attr:`device`)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid cannot carry "
                             f"the axes {self.axis_names}")
        distinct = {str(d) for d in devices.flat}
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over distinct devices {sorted(distinct)} is not "
                "built yet; place every shard on one device")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        return self.devices.flat[0]

    def axis_size(self, axis: str) -> int:
        """The axis's size, 1 for an axis this mesh does not carry."""
        return int(self.shape.get(axis, 1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


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


# -- the collectives -----------------------------------------------------------


def _check_parts(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str):
    if len(parts) != mesh.axis_size(axis):
        raise ValueError(f"{len(parts)} shards along '{axis}', the mesh has "
                         f"{mesh.axis_size(axis)}")


def split(mesh: Mesh, x: torch.Tensor, dim: int, axis: str
          ) -> list[torch.Tensor]:
    """``x`` split evenly along ``dim`` over ``axis``: one view per shard,
    in shard order (one shard, ``x`` itself, when the mesh lacks the axis).
    Raises ValueError when the dim does not divide."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over '{axis}' ({n})")
    size = x.shape[dim] // n
    return [x.narrow(dim, i * size, size).to(mesh.device) for i in range(n)]


def sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Partials added in shard order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def psum(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str
         ) -> torch.Tensor:
    """The sum of one partial per shard along ``axis``, added in shard
    order: the value every shard holds after ``jax.lax.psum``."""
    _check_parts(mesh, parts, axis)
    return sum_in_order(parts)


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str,
               dim: int = 0) -> torch.Tensor:
    """The shards along ``axis`` joined along ``dim`` in shard order (a
    tiled ``jax.lax.all_gather``)."""
    _check_parts(mesh, parts, axis)
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=dim)


def ppermute(mesh: Mesh, parts: Sequence, axis: str) -> list:
    """One hop right around the ring along ``axis``: shard ``j`` sends to
    ``(j + 1) % n``, so shard ``j`` then holds what shard ``j - 1`` had."""
    _check_parts(mesh, parts, axis)
    n = len(parts)
    return [parts[(j - 1) % n] for j in range(n)]


# -- placement -----------------------------------------------------------------


class Shards:
    """One leaf placed by a spec: ``axes`` are the mesh axes it is split
    over, in dim order, and ``parts`` an object array of per-shard tensors
    indexed by those axes' coordinates. A leaf split over no axis
    (replicated) has one part."""

    def __init__(self, axes: tuple[str, ...], parts: np.ndarray):
        self.axes = axes
        self.parts = parts

    def part(self, **coords: int) -> torch.Tensor:
        """The shard at ``coords`` (axis=index); axes the leaf is not split
        over are ignored, since it is replicated along them."""
        return self.parts[tuple(coords.get(a, 0) for a in self.axes)]

    def along(self, axis: str, **coords: int) -> list[torch.Tensor]:
        """The shards along ``axis`` in order, at ``coords`` on the other
        axes (one shard when the leaf is not split over ``axis``)."""
        if axis not in self.axes:
            return [self.part(**coords)]
        n = self.parts.shape[self.axes.index(axis)]
        return [self.part(**{**coords, axis: i}) for i in range(n)]


def place(mesh: Mesh, x: torch.Tensor, spec: tuple) -> Shards:
    """``x`` split by ``spec`` (one axis name or None per leading dim),
    mesh-absent axes dropped, into per-shard views on the mesh's device."""
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
    for idx in np.ndindex(*parts.shape):
        t = x
        for (dim, axis), i in zip(dims, idx):
            t = split(mesh, t, dim, axis)[i]
        parts[idx] = t.to(mesh.device)
    return Shards(axes, parts)


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
    the outputs joined in shard order; one call when there is no ``dp``."""
    if mesh is None or mesh.axis_size("dp") == 1:
        return fn(*xs)
    shards = [split(mesh, x, 0, "dp") for x in xs]
    return all_gather(mesh, [fn(*parts) for parts in zip(*shards)], "dp")
