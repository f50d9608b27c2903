"""Data parallelism on ``torch.distributed``: the batch sharded, the state replicated.

Counterpart of the JAX package's ``parallel/dp.py``.  JAX gets data
parallelism from GSPMD: it places the batch axis of the stacked epoch
arrays on the mesh's "data" axis, replicates the state, and XLA's
partitioner inserts every ``psum``.  PyTorch has no partitioner, and the
port's ops are ``autograd.Function``s over ``ctypes`` kernels, which
``DTensor`` cannot shard.  So every quantity that depends on the whole batch
takes a collective placed by hand (``ops/collectives.py``), and the API is
multi-controller, as in ``parallel/sequence.py``: each rank runs the same
calls on its own shard of the batch with the same replicated state.

* ``shard_epoch_batches(mesh, xb, yb)``: this rank's columns ``[i*B/P,
  (i+1)*B/P)`` of stacked ``(nb, B, ...)`` batches (JAX's ``P(None,
  "data")``); raises when P does not divide B;
* ``replicate(mesh, tree)``: every leaf of a state broadcast from the
  axis' first rank, in place: tensors, optimizer states, GradNorm, plateau
  and scheduler values, and the ``torch.Generator`` that draws the CPC
  anchors and dropout masks, so that they come out alike on every rank;
* ``train_epoch`` (``OSCNNClassifier.train_epoch``), ``phase2_epoch``,
  ``phase3_epoch``, ``phase4_epoch``, ``phase5_grads`` and ``phase5_epoch``
  (``StyleTransferPipeline``'s; phase 1 is ``dp_explicit``'s): the
  single-device methods inside ``bn_cross_replica`` over the axis' group.
  There each rank's loss is its contribution to the global loss, each
  pull's gradients are summed over the ranks before GradNorm's norms and
  the optimizers, and the losses given to GradNorm, the schedulers (phase
  4's nf plateau: the last batch's global total) and the metrics are the
  global values; the new state is the same bits on every rank.  ``dropout_masks``, when
  pinned, are the rank's rows of the global batch's; drawn, the global
  batch's are drawn and sliced.  ``phase5_epoch``'s ``collect_features``
  returns the rank's rows.

Every ``PipelineConfig`` knob runs data-parallel (``merged_pullbacks``,
``stacked_pullbacks``: the batched pull's cotangents pass the collectives'
vmap rules; ``fused_optimizers``: ``FusedRMSprop`` steps on the global
gradients), and so do both bf16 switches and both WN routes.  The bf16
switches move no collective: ``compute_dtype="bfloat16"`` runs only the
OS-CNN convs in bf16 and casts their outputs to f32 before BatchNorm, as
JAX's ``models/os_cnn.py`` does, so BatchNorm's moments, CDAN's sums, the
noise transfer's means and CPC's gathered columns are f32 sums in both
packages; ``FLSTTSC_WN_MXU=bf16`` changes the WN's products, which are per
row.  The op-by-op WN route (``FLSTTSC_WN_FUSED=0``) is per row too.  Only
the multirun (``MultiRunStylePipeline``) raises ``ValueError``: the JAX package
has no data-parallel multirun (its ``train/multirun.py`` takes no mesh).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..losses.gradnorm import GradNormState
from ..ops.batchnorm import bn_cross_replica
from ..train.classifier import OSCNNClassifier
from ..train.optim import FusedRMSprop
from ..train.pipeline import StyleTransferPipeline
from .mesh import axis_group, data_sharding, place

#: the refusal of the multirun, which does not run data-parallel in the JAX package either
NOT_DATA_PARALLEL = ("{} does not run data-parallel: the JAX package has no data-parallel "
                     "multirun (its train/multirun.py takes no mesh)")


def shard_epoch_batches(mesh: DeviceMesh, xb, yb):
    """This rank's shard of stacked epoch batches (nb, B, ...), B over "data"."""
    sh = data_sharding(mesh, batch_axis=1)
    return place(mesh, xb, sh), place(mesh, yb, sh)


def _walk(x, fn):
    """``fn`` over the leaves of a training state (tensors, generators and
    plain values), containers updated in place where they are mutable; the
    walk order is the same on every rank of one program."""
    if isinstance(x, (torch.Tensor, torch.Generator, bool, int, float, str)) or x is None:
        return fn(x)
    if isinstance(x, dict):
        for k in list(x):
            x[k] = _walk(x[k], fn)
        return x
    if isinstance(x, list):
        for i, v in enumerate(x):
            x[i] = _walk(v, fn)
        return x
    if isinstance(x, tuple):
        values = [_walk(v, fn) for v in x]
        return type(x)(*values) if hasattr(x, "_fields") else tuple(values)
    if isinstance(x, torch.optim.Optimizer):
        for group in x.param_groups:
            for k in group:
                if k != "params":
                    group[k] = _walk(group[k], fn)
            for p in group["params"]:
                if p in x.state:
                    x.state[p] = _walk(x.state[p], fn)
        return x
    if isinstance(x, FusedRMSprop):  # its leaves are the params' tensors; v and lr hold views
        _walk([x.v, x.lr], fn)
        return x
    if isinstance(x, GradNormState):
        for k, v in list(vars(x).items()):
            setattr(x, k, _walk(v, fn))
        return x
    raise TypeError(f"replicate: no rule for a leaf of type {type(x).__name__}")


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree, axis: str = "data"):
    """Every leaf of ``tree`` broadcast from the first rank of ``axis``, in
    place (returned, for JAX's idiom): the tensors in one broadcast a dtype
    and device, each ``torch.Generator``'s state among them, and the plain
    values in one ``broadcast_object_list``."""
    group, _, _ = axis_group(mesh, axis)
    src = dist.get_global_rank(group, 0)
    tensors, generators, values = [], [], []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, torch.Generator):
            generators.append((x, x.get_state()))
            tensors.append(generators[-1][1])
        else:
            values.append(x)
        return x

    tree = _walk(tree, collect)
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        pos = 0
        for t in ts:
            t.copy_(flat[pos : pos + t.numel()].view(t.shape))
            pos += t.numel()
    for g, state in generators:
        g.set_state(state)
    dist.broadcast_object_list(values, src, group=group)
    it = iter(values)
    return _walk(tree, lambda x: x if isinstance(x, (torch.Tensor, torch.Generator)) else next(it))


def train_epoch(mesh: DeviceMesh, clf: OSCNNClassifier, state, xb, yb,
                cpc_anchors: Optional[Sequence[int]] = None, axis: str = "data"):
    """``clf.train_epoch`` with the batch sharded over ``axis``: ``xb``,
    ``yb`` this rank's shard (``shard_epoch_batches``), ``state``
    replicated; returns the global epoch means."""
    if not isinstance(clf, OSCNNClassifier):
        raise ValueError(f"dp.train_epoch takes an OSCNNClassifier, not {type(clf).__name__}")
    group, _, _ = axis_group(mesh, axis)
    with bn_cross_replica(group):
        return clf.train_epoch(state, xb, yb, cpc_anchors)


def _check_pipeline(pipe) -> None:
    """Refuse what does not run data-parallel: the multirun."""
    if not isinstance(pipe, StyleTransferPipeline):
        raise ValueError(NOT_DATA_PARALLEL.format(f"{type(pipe).__name__} (the multirun)"))


def phase2_epoch(mesh: DeviceMesh, pipe: StyleTransferPipeline, state, xb, yb,
                 axis: str = "data"):
    """``pipe.phase2_epoch`` (source pretrain) over this rank's shard of the
    stacked source batches, ``state`` replicated: the global metrics."""
    _check_pipeline(pipe)
    group, _, _ = axis_group(mesh, axis)
    with bn_cross_replica(group):
        return pipe.phase2_epoch(state, xb, yb)


def phase3_epoch(mesh: DeviceMesh, pipe: StyleTransferPipeline, state, xt, yt, xs, ys,
                 supervised: bool, cpc_anchors: Optional[Sequence[int]] = None,
                 axis: str = "data"):
    """``pipe.phase3_epoch`` (self-supervised, ``supervised`` adding the CE
    terms) over this rank's shards, ``state`` replicated: the global
    metrics."""
    _check_pipeline(pipe)
    group, _, _ = axis_group(mesh, axis)
    with bn_cross_replica(group):
        return pipe.phase3_epoch(state, xt, yt, xs, ys, supervised, cpc_anchors)


def phase4_epoch(mesh: DeviceMesh, pipe: StyleTransferPipeline, state, xt, yt, xs, ys,
                 supervised: bool, cpc_anchors: Optional[Sequence[int]] = None,
                 axis: str = "data"):
    """``pipe.phase4_epoch`` (NF pretrain, joint when ``supervised``) over
    this rank's shards, ``state`` replicated: the global metrics; the nf
    plateau steps on the last batch's global total on every rank."""
    _check_pipeline(pipe)
    group, _, _ = axis_group(mesh, axis)
    with bn_cross_replica(group):
        return pipe.phase4_epoch(state, xt, yt, xs, ys, supervised, cpc_anchors)


def phase5_grads(mesh: DeviceMesh, pipe: StyleTransferPipeline, state, bt, lt, bs, ls,
                 epoch: int, cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None,
                 axis: str = "data"):
    """``pipe.phase5_grads`` of this rank's batch rows: (global losses,
    new_m, the rank's feats, the global gradients of the total, n_t, n_s)."""
    _check_pipeline(pipe)
    group, _, _ = axis_group(mesh, axis)
    with bn_cross_replica(group):
        return pipe.phase5_grads(state, bt, lt, bs, ls, epoch, cpc_anchors, dropout_masks)


def phase5_epoch(mesh: DeviceMesh, pipe: StyleTransferPipeline, state, xt, yt, xs, ys,
                 epoch: int, collect_features: bool = False,
                 cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None,
                 axis: str = "data"):
    """``pipe.phase5_epoch`` over this rank's shards of the stacked batches
    (``shard_epoch_batches``), ``state`` replicated: the global metrics."""
    _check_pipeline(pipe)
    group, _, _ = axis_group(mesh, axis)
    with bn_cross_replica(group):
        return pipe.phase5_epoch(state, xt, yt, xs, ys, epoch, collect_features, cpc_anchors,
                                 dropout_masks)
