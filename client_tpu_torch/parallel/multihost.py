"""Several processes as one mesh, over ``torch.distributed``.

Counterpart of ``client_tpu/parallel/multihost.py``. JAX's distributed
runtime wires the processes into one cluster and a ``Mesh`` over
``jax.devices()`` then spans them all. Here every process runs the same
program too: :func:`initialize` joins the ``torch.distributed`` process
group, and :func:`global_mesh` builds a
:class:`~client_tpu_torch.parallel.mesh.Mesh` whose shards are ordered by
process rank and then by local index, each process holding its own. The
collectives of ``parallel/mesh.py`` exchange across the processes along
the one axis that spans them (the slowest-varying one, as in JAX's
multi-slice convention, so only that axis's traffic leaves a process).

NCCL takes one card per process: ranks that share a card are refused by
NCCL (and :func:`initialize` raises); such processes pass
``backend="gloo"``, which stages card tensors through the host at each
exchange.

Usage (the same script in every process)::

    from client_tpu_torch.parallel import multihost
    multihost.initialize("127.0.0.1:29500", 2, rank)   # or MASTER_ADDR ...
    mesh = multihost.global_mesh(axes=("dp", "tp"), shape={"dp": 2})
    batch = multihost.host_local_array(global_shape, P("dp", None), rows,
                                       mesh)
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from client_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    make_mesh,
    mesh_axes,
    place,
)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None, timeout_s: float = 300.0) -> int:
    """Join (or form) the process group; returns this process's rank.

    The arguments default to torch's own ``MASTER_ADDR`` / ``MASTER_PORT``
    (the address), ``WORLD_SIZE`` and ``RANK``, which stand in for JAX's
    autodetection. ``backend=None`` is NCCL for a process on the card
    (``device=None`` or a CUDA device; it raises without CUDA) and gloo for
    ``device="cpu"``. A first all-reduce runs here, so a backend that
    refuses the processes (NCCL with two ranks on one card) raises here;
    there is no switch to another backend. A second call returns the rank
    (idempotent). ``timeout_s`` bounds every collective of the group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the process count "
            "and this process's id, as arguments or as MASTER_ADDR / "
            "MASTER_PORT, WORLD_SIZE and RANK")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "join the group on the CPU")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    probe = torch.ones(1, device=device if backend == "nccl" else "cpu")
    try:
        dist.all_reduce(probe)
        if probe.is_cuda:
            torch.cuda.synchronize(probe.device)
    except Exception:
        dist.destroy_process_group()
        raise
    if int(probe.item()) != int(num_processes):
        raise RuntimeError(f"the first all-reduce over {num_processes} "
                           f"processes gave {probe.item()}")
    return dist.get_rank()


def process_count() -> int:
    """The processes in the group (1 before :func:`initialize`)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _local_devices(devices) -> list[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a global mesh takes this process's "
                "CUDA devices by default; pass devices=['cpu'] * n")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def global_mesh(axes=("dp", "tp"), shape: dict[str, int] | None = None,
                devices=None) -> Mesh:
    """A mesh over every process's devices, ordered by rank and then by
    local index. ``devices`` are this process's (default: its CUDA
    devices); every process must give as many. ``shape`` optionally pins
    axis sizes (e.g. dp = the process count, so only dp crosses
    processes), with JAX's errors: the pinned sizes must divide the device
    count, and at most one axis may stay free. The axis that spans the
    processes must be the only one along which the owner changes
    (``Mesh`` raises otherwise)."""
    import torch.distributed as dist

    local = _local_devices(devices)
    n_proc = process_count()
    if n_proc > 1:
        counts = [None] * n_proc
        dist.all_gather_object(counts, len(local))
        if len(set(counts)) != 1:
            raise ValueError(f"processes hold {counts} devices; a global "
                             "mesh needs as many in each")
    n = n_proc * len(local)
    if shape:
        pinned = 1
        for a in axes:
            if a in shape:
                pinned *= int(shape[a])
        free = [a for a in axes if a not in shape]
        if n % pinned:
            raise ValueError(
                f"pinned axis sizes {shape} do not divide {n} devices")
        rest = n // pinned
        if len(free) > 1:
            raise ValueError(
                "at most one axis may be left unpinned; got "
                f"{free} over {rest} devices")
        sizes = [int(shape.get(a, rest)) for a in axes]
    else:
        sizes = [mesh_axes(n, tuple(axes))[a] for a in axes]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"axis sizes {dict(zip(axes, sizes))} do not "
                         f"multiply to {n} devices")
    if n_proc == 1:
        return make_mesh(n, axes=tuple(axes),
                         axis_sizes=dict(zip(axes, sizes)), devices=local)
    me = process_index()
    grid = np.empty(n, dtype=object)
    ranks = np.arange(n) // len(local)
    for i in range(n):
        # Every process gives the same device list, so another process's
        # shard is named as its own would be.
        grid[i] = local[i % len(local)]
    return Mesh(grid.reshape(sizes), tuple(axes), ranks.reshape(sizes), me)


def host_local_array(global_shape, spec, local_data, mesh: Mesh) -> Shards:
    """A global array of ``global_shape`` split by ``spec`` (one mesh axis
    or None per dim), from the rows this process owns: ``local_data`` is
    its contiguous block along the split dims' process axis (the whole
    array on a one-process mesh). Returns its shards on this process's
    device, as ``jax.make_array_from_process_local_data`` does."""
    local_data = torch.as_tensor(np.asarray(local_data))
    spec = tuple(spec) + (None,) * (len(global_shape) - len(spec))
    whole = torch.zeros(tuple(global_shape), dtype=local_data.dtype)
    index = []
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.crosses(axis):
            span = mesh.local(axis)
            size = global_shape[dim] // mesh.axis_size(axis)
            index.append(slice(span.start * size, span.stop * size))
        else:
            index.append(slice(None))
    block = whole[tuple(index)]
    if tuple(block.shape) != tuple(local_data.shape):
        raise ValueError(
            f"this process owns a {tuple(block.shape)} block of "
            f"{tuple(global_shape)}, got {tuple(local_data.shape)}")
    block.copy_(local_data)
    return place(mesh, whole, spec)
