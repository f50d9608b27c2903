"""Starting ranks of ``torch.distributed``: one process a rank, joined with a deadline.

The JAX package runs its collectives inside one program over a mesh of
devices (``jax.shard_map``).  PyTorch's collectives run between processes,
one a rank, so the port's parallel ops need those processes started, a
process group joined in each, and the ranks' results brought back:

* ``spawn(fn, world_size, args)`` runs ``fn(rank, world_size, *args)`` in
  ``world_size`` processes of the ``spawn`` start method (CUDA cannot be used
  after ``fork``) and returns their results in rank order.  A rank that
  raises, dies, or does not finish by the deadline fails the whole call, and
  every process is stopped before it returns: a collective that hangs fails
  the caller and does not hang it;
* ``process_group(rank, world_size, init_method, backend)`` joins the default
  process group for the ``with`` block.  The backend is the caller's: NCCL
  needs a card of its own for each rank, ``"cpu:gloo,cuda:gloo"`` serves
  ranks that share a card, and the CPU;
* ``torchrun_group(device)`` joins the group that ``torchrun`` (``python -m
  torch.distributed.run``) describes in the environment, choosing the
  backend and the rank's device itself; the CLIs run under it.

``fn`` is pickled by reference, so it must be a module-level function of an
importable module; its arguments and result are pickled too (numpy arrays
and Python values; send large tensors through files).
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from ..ops import resolve_device

#: The backend of ranks that share a card: NCCL refuses two ranks on one card, and gloo takes
#: CUDA tensors in the collectives the port uses (``ops/collectives.py``).
SHARED_CARD_BACKEND = "cpu:gloo,cuda:gloo"

#: How long a collective of ``torchrun_group``'s group may wait before it raises: a day, since a
#: rank of ``cli.multi_source`` waits at a barrier for the slowest member's whole curriculum (a
#: rank that dies fails the command at once: torchrun stops the others).
CLI_COLLECTIVE_TIMEOUT = datetime.timedelta(days=1)


def _rank_main(fn: Callable, rank: int, world_size: int, args: Sequence, results) -> None:
    try:
        out = fn(rank, world_size, *args)
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn: Callable, world_size: int, args: Sequence = (), timeout: float = 300.0) -> List[Any]:
    """``[fn(r, world_size, *args) for r in range(world_size)]``, each in a
    process of its own, all started together.  Raises ``RuntimeError`` with
    the rank's traceback if a rank fails or exits without a result, and
    ``TimeoutError`` if the ranks are not done within ``timeout`` seconds;
    every process is stopped before it returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, tuple(args), results),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(f"ranks {missing} did not finish within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                # the queue is drained before a dead rank is reported: a
                # rank's result may still be in flight when it exits
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None and p.exitcode != 0]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world_size)]


@contextlib.contextmanager
def process_group(rank: int, world_size: int, init_method: str, backend: str,
                  timeout: float = 300.0):
    """The default process group of ``world_size`` ranks, joined as ``rank``
    through ``init_method`` (``"file://..."`` or ``"tcp://localhost:PORT"``)
    on ``backend``, for the ``with`` block; a collective that waits longer
    than ``timeout`` seconds raises."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def torchrun_group(device="cuda"):
    """The default process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), joined through
    ``init_method="env://"`` for the ``with`` block; yields ``(rank,
    world_size, device)``, ``device`` this rank's.

    ``device`` is the entry point's ``--device`` ("cuda" refused without
    CUDA, as ``resolve_device`` refuses it).  The backend: "cpu" joins on
    gloo; "cuda" with at least ``LOCAL_WORLD_SIZE`` cards on NCCL, rank on
    ``cuda:LOCAL_RANK``; "cuda" with fewer cards than local ranks on
    ``SHARED_CARD_BACKEND``, the ranks sharing the cards (``cuda:(LOCAL_RANK
    % device_count)``).  Each rank prints its backend and device.  With no
    ``WORLD_SIZE``, or a ``WORLD_SIZE`` of 1, it joins nothing: one process,
    ``(0, 1, device)``.  The group is left after a barrier when the block
    ends, and without one when it raises.  A collective that waits longer
    than ``CLI_COLLECTIVE_TIMEOUT`` raises."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        yield 0, 1, dev
        return
    if dev.index is not None:
        raise ValueError(f"--device {dev} under torchrun: pass the type ('cuda' or 'cpu'); "
                         "each rank takes its card from LOCAL_RANK")
    rank = int(os.environ["RANK"])
    local_rank, local_world = int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    if dev.type == "cpu":
        backend = "gloo"
    elif torch.cuda.device_count() >= local_world:
        backend, dev = "nccl", torch.device("cuda", local_rank)
    else:
        backend = SHARED_CARD_BACKEND
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"[rank {rank} of {world}] backend {backend}, device {dev}", flush=True)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=CLI_COLLECTIVE_TIMEOUT)
    try:
        yield rank, world, dev
        dist.barrier()
    finally:
        dist.destroy_process_group()
