"""The mesh of the framework's two parallel axes, over ``torch.distributed`` ranks.

Counterpart of the JAX package's ``parallel/mesh.py`` ``make_mesh``: a mesh
with axes ("data", "domain"), all ranks on "data" by default.  JAX's mesh is
a grid of the devices one program sees; the port's is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, which the caller has joined (``parallel.launch.process_group``
or ``torch.distributed.init_process_group``), one process a rank:

* "data"   shards the batch (A4, ``dp.py``) or, in ``parallel/sequence.py``,
  the time axis;
* "domain" holds the source-domain models side by side.

Rank r sits at ``(r // domain, r % domain)``; a rank at or past ``data *
domain`` takes part in making the mesh and is outside it
(``get_coordinate()`` is None).  Each rank's device is explicit: the card
the caller names (``cuda:i``, as ``launch.torchrun_group`` gives each rank)
or else ``cuda:(rank % device_count)``, made the current device, or the CPU
when the caller asks for it.  The backend is the caller's choice when it
joins the group; nothing here guesses it.

JAX's placement helpers (``data_sharding``, ``domain_sharding``,
``replicated``) return a ``NamedSharding``; the port's return its nearest
counterpart, the ``torch.distributed.tensor`` placements over the mesh's
("data", "domain") dims, and ``place`` cuts a rank's part of an array that
every rank holds whole (JAX's ``device_put`` from the host): a ``Shard(d)``
over a mesh dim keeps the rank's equal slice of axis d (the axis must be
divisible by that dim's size, as ``device_put`` requires), a ``Replicate()``
keeps all of it.  ``parallel.dp.replicate`` makes the replicated parts
equal on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from ..ops import resolve_device

AXES = ("data", "domain")


def make_mesh(data: Optional[int] = None, domain: int = 1, device="cuda") -> DeviceMesh:
    """Mesh with axes ("data", "domain") over the first ``data * domain``
    ranks; ``data`` defaults to all ranks over ``domain``.  ``device``
    "cuda" (the default; refused without CUDA) puts rank r on
    ``cuda:(r % device_count)``, ``cuda:i`` on card i, "cpu" on the CPU.
    Every rank of the group calls it, in the same order as its other
    collectives."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: join it first "
                           "(parallel.launch.process_group or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if data is None:
        data = world // domain
    if data * domain > world:
        raise ValueError(f"need {data * domain} devices, have {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    grid = torch.arange(data * domain).reshape(data, domain)
    return DeviceMesh(dev.type, grid, mesh_dim_names=AXES)


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index on ``axis``, the axis' size)."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, not {axis!r}")
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _placements(mesh: DeviceMesh, by_axis: dict) -> Tuple[Placement, ...]:
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, not {AXES}")
    return tuple(by_axis.get(a, Replicate()) for a in AXES)


def data_sharding(mesh: DeviceMesh, batch_axis: int = 0) -> Tuple[Placement, ...]:
    """Shard an array's batch axis over "data"."""
    return _placements(mesh, {"data": Shard(batch_axis)})


def domain_sharding(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """Shard a stacked-models leading axis over "domain"."""
    return _placements(mesh, {"domain": Shard(0)})


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    return _placements(mesh, {})


def place(mesh: DeviceMesh, x, placements: Sequence[Placement]):
    """This rank's part of ``x`` (a tensor or numpy array, the same whole on
    every rank) under ``placements``, contiguous; a rank outside the mesh
    has none and raises."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    for d, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, size = mesh.size(d), x.shape[pl.dim]
            if size % n:
                raise ValueError(f"axis {pl.dim} of length {size} is not divisible by the {n} "
                                 f"ranks of mesh axis {AXES[d]!r}")
            s = size // n
            x = x[(slice(None),) * pl.dim + (slice(coord[d] * s, (coord[d] + 1) * s),)]
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} is neither Shard nor Replicate")
    return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)
