"""The phase-1 epoch with its data-parallel collectives placed by hand.

Counterpart of the JAX package's ``parallel/dp_explicit.py``, kept under
its name so that a reader finds it.  In JAX it is the hand-written
``shard_map`` fallback to GSPMD's ``dp.py``; in the port both are placed by
hand, and this module holds the phase-1 target-pretrain epoch
(``StyleTransferPipeline.phase1_epoch``, reference
``train_and_test.py:141-180``), whose step has the three collective
patterns of JAX's (``dp_explicit.py:1-30``):

* **gradients**: each rank differentiates its contribution to the global
  loss (its CE summands over the global batch size, its InfoNCE rows) and
  the gradients are summed with one all-reduce (``ModuleSteps._grads``,
  ``ops.collectives.all_reduce_grads``);
* **BatchNorm moments** of the global batch: ``bn_cross_replica`` makes
  ``batch_norm`` all-reduce its stacked (sum, sum of squares);
* **CPC InfoNCE negatives**: the softmax runs over the whole batch, so the
  prediction columns are all-gathered and each rank scores its rows against
  all of them (``models.cpc.info_nce_contrib``, JAX's ``_cpc_contrib``,
  taken by ``cpc_apply`` under the group).

The metrics are the global means, and the new state is the same bits on
every rank.
"""

from __future__ import annotations

from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from ..ops.batchnorm import bn_cross_replica
from ..train.pipeline import StyleTransferPipeline
from .dp import NOT_DATA_PARALLEL
from .mesh import axis_group


def make_dp_phase1_epoch(pipe: StyleTransferPipeline, mesh: DeviceMesh, axis: str = "data"):
    """A phase-1 epoch equal to ``pipe.phase1_epoch`` with every
    data-parallel collective placed by hand: ``epoch(state, xb, yb,
    cpc_anchor=None) -> metrics``, with ``xb``, ``yb`` this rank's shard of
    the stacked batches (``dp.shard_epoch_batches``) and ``state``
    replicated (``dp.replicate``)."""
    if not isinstance(pipe, StyleTransferPipeline):
        raise ValueError(NOT_DATA_PARALLEL.format(f"{type(pipe).__name__} (the multirun)"))
    group, _, _ = axis_group(mesh, axis)

    def epoch(state, xb, yb, cpc_anchor: Optional[int] = None):
        with bn_cross_replica(group):
            return pipe.phase1_epoch(state, xb, yb, cpc_anchor)

    return epoch
