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

Rank r sits at ``(r // domain, r % domain)``.  Each rank's device is
explicit: ``cuda:(rank % device_count)``, made the current device, or the CPU
when the caller asks for it.  The backend is the caller's choice when it
joins the group; nothing here guesses it.  JAX's placement helpers
(``data_sharding``, ``domain_sharding``, ``replicated``) come with their
users, ``dp.py`` and the ensemble's ``mesh=`` (``ROADMAP.md`` A4).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import resolve_device

AXES = ("data", "domain")


def make_mesh(data: Optional[int] = None, domain: int = 1, device="cuda") -> DeviceMesh:
    """Mesh with axes ("data", "domain") over the first ``data * domain``
    ranks; ``data`` defaults to all ranks over ``domain``.  ``device``
    "cuda" (the default; refused without CUDA) puts rank r on
    ``cuda:(r % device_count)``, "cpu" on the CPU.  Every rank of the group
    calls it, in the same order as its other collectives."""
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
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    grid = torch.arange(data * domain).reshape(data, domain)
    return DeviceMesh(dev.type, grid, mesh_dim_names=AXES)
