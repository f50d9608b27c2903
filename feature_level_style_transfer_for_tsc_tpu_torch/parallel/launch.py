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
  ranks that share a card, and the CPU.

``fn`` is pickled by reference, so it must be a module-level function of an
importable module; its arguments and result are pickled too (numpy arrays
and Python values; send large tensors through files).
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.distributed as dist


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
