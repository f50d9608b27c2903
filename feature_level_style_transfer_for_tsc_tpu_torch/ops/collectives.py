"""Collectives of the port's parallel ops, and the data-parallel group.

PyTorch's collectives carry no gradient, and a sharded op built on them
would give gradients silently wrong.  So the ones a sharded forward takes
are ``autograd.Function``s here, each with its adjoint:

* ``all_reduce_sum``: the sum over the group of every rank's tensor; its
  backward all-reduces the gradient of the sum (every rank's loss may
  depend on it);
* ``all_gather_rows``: every rank's rows, concatenated in rank order along
  ``dim``; its backward all-reduces the gradient of the whole and keeps
  this rank's rows.

``all_gather`` (no gradient) returns the parts.  Every collective is one
that gloo takes on CUDA tensors (no ``send``/``recv``, which it takes on CPU
tensors only), so ranks that share one card run on gloo.  Every rank must
run the same collectives in the same order, backward passes included.

**The data-parallel group** is a context variable, the counterpart of the
JAX package's ``_CROSS_REPLICA_AXIS`` (JAX ``ops/batchnorm.py:27-47``), set
by ``data_parallel`` (``ops.batchnorm.bn_cross_replica``, JAX's name).
Inside it, each rank holds a shard of the batch rows, and every quantity of
the port that depends on the whole batch is taken over the group:
BatchNorm's training moments (``ops/batchnorm.py``), the CPC InfoNCE
softmax (``models/cpc.py``), the noise transfer's batch means and counts
(``models/adapters.py``), CDAN's sums (``losses/cdan.py``), the critic's
dropout draws (``models/common.py``), and the batch means of the losses,
which return the rank's *contribution*: the contributions summed over the
ranks are the global loss.  A scalar that every rank computes from
all-reduced sums (CDAN's product of two sums) enters as its 1/P share,
because ``all_reduce_sum``'s backward sums the ranks' gradients.
``all_reduce_grads`` sums the gradients of the contributions and
``reduce_values`` the reported losses.  With no group set each of these is
the identity and every op computes what it computes alone.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_parallel_group", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Within this context the port's batch-global quantities are taken
    over ``group``, whose ranks each hold a shard of the batch rows."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def data_group():
    """The data-parallel group set by ``data_parallel``, or None."""
    return _DATA_GROUP.get()


def rank_and_size(group) -> Tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` of ``group``, in the group's rank order (no gradient)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _moved(in_dim, t: torch.Tensor) -> torch.Tensor:
    """A vmap rule's operand with its batch dim first, or ``t`` unbatched."""
    return t if in_dim is None else t.movedim(in_dim, 0)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` of every rank's ``t``; its gradient is the sum
    of every rank's gradient of that sum, the same Function applied to it.

    Under ``torch.func.vmap`` (a batched pull's cotangents, ``train/
    pipeline.py`` ``batched_pull``, or K runs) the vmap rule all-reduces the
    whole batched tensor, its batch dim moved to the front, in ONE
    collective.  The backward calls the Function on ``g`` rather than
    ``dist.all_reduce`` on it, so a batched ``g`` (a backward under vmap)
    reaches that rule too; every rank runs the same collectives in the same
    order, batched or not."""

    @staticmethod
    def forward(t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, t, group):
        out = _AllReduceSum.apply(_moved(in_dims[0], t), group)
        return out, (None if in_dims[0] is None else 0)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(t, group)


class _AllGatherRows(torch.autograd.Function):
    """Every rank's ``t`` concatenated along ``dim`` in rank order; the
    backward all-reduces the gradient of the whole (``_AllReduceSum``, so a
    batched gradient takes its vmap rule) and keeps this rank's rows of it.
    Under ``torch.func.vmap`` one gather of the batched tensor along the
    shifted dim."""

    @staticmethod
    def forward(t, dim: int, group):
        return torch.cat(all_gather(t, group), dim=dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        t, dim, group = inputs
        ctx.dim, ctx.group, ctx.rows = dim % t.dim(), group, t.shape[dim]

    @staticmethod
    def backward(ctx, g):
        g = _AllReduceSum.apply(g, ctx.group)
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.rows, ctx.rows).contiguous(), None, None

    @staticmethod
    def vmap(info, in_dims, t, dim, group):
        if in_dims[0] is None:
            return _AllGatherRows.apply(t, dim, group), None
        t = t.movedim(in_dims[0], 0)
        return _AllGatherRows.apply(t, dim % (t.dim() - 1) + 1, group), 0


def all_gather_rows(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return _AllGatherRows.apply(t, dim, group)


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
    """Under a data-parallel group, the gradients summed over the ranks in
    one all-reduce (a None stays None: every rank has the same graph);
    else ``grads`` as they are.  A gradient may carry leading cotangent or
    run axes (a batched pull's (N, ...) gradients): it is summed
    elementwise, whatever its shape."""
    group = data_group()
    grads = list(grads)
    if group is None:
        return grads
    live = [g for g in grads if g is not None]
    if not live:
        return grads
    flat = torch.cat([g.reshape(-1) for g in live])
    dist.all_reduce(flat, group=group)
    out, pos = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[pos : pos + g.numel()].view(g.shape))
        pos += g.numel()
    return out


def reduce_values(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Under a data-parallel group, the ranks' contributions to each value
    (scalars, or values of one shape with leading cotangent or run axes)
    summed in one all-reduce, detached: the global values, the same bits on
    every rank; else ``values`` as they are."""
    group = data_group()
    if group is None:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach() for k in keys])
    dist.all_reduce(stacked, group=group)
    return {k: stacked[i] for i, k in enumerate(keys)}
