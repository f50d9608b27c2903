"""Training of heterogeneous multi-source member pipelines.

Counterpart of the JAX package's ``parallel/multi_pipeline.py``.  The K
source->target adaptation runs are independent programs of different shapes
(each source has its own (C_s, T_s)), so they are not stacked like the
voting ensemble; they are run member by member.  With one device, or one
member, that is a plain loop in order (what runs on one card and on the
CPU).  With several CUDA devices each member gets a thread of its own, its
work placed on ``devices[i % len(devices)]`` by ``torch.cuda.device``, the
current device of that thread, so members can train on several cards at
once.  The tests run those threads on the CPU only; no run on several
cards has checked this path yet (``ROADMAP.md`` C6).  Under ``torchrun``
``cli.multi_source`` gives each rank its members (member i on rank i % P)
and its own device.  The reference has no counterpart: multi-source is K
sequential full runs (SURVEY §2.6).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import torch

from ..ops import resolve_device


def train_members_parallel(
    member_fns: Sequence[Callable[[], object]],
    devices: Optional[Sequence] = None,
) -> List[object]:
    """Run each ``member_fns[i]()`` with a device pinned round-robin;
    returns the results in order.

    ``devices`` defaults to every CUDA device (``cuda:0`` .. ``cuda:n-1``),
    and is refused when CUDA is absent, as ``resolve_device`` refuses it
    (name ``["cpu"]`` to train on the CPU).  Each callable builds and trains
    one member pipeline and returns its result (a ``{'params', 'mstate'}``
    dict)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]

    def run(i, fn):
        dev = devs[i % len(devs)]
        if dev.type != "cuda":
            return fn()
        with torch.cuda.device(dev):
            return fn()

    if len(devs) == 1 or len(member_fns) == 1:
        return [run(i, fn) for i, fn in enumerate(member_fns)]
    with ThreadPoolExecutor(max_workers=min(len(member_fns), len(devs))) as ex:
        return list(ex.map(run, range(len(member_fns)), member_fns))
