"""Batch normalization with torch ``BatchNorm1d`` semantics.

Counterpart of the JAX package's ``ops/batchnorm.py``: the running
statistics are explicit state (``BNStats``) threaded through every step, so
the reference's deliberate train/eval flips become a ``training`` flag:

* training: normalize with the batch's biased statistics and return new
  running stats (momentum 0.1, unbiased variance).  As in the JAX package
  they are differentiable: phase 5's eval-mode s2t pass normalizes with the
  stats its target pass just updated, and its gradient reaches that batch
  through them.  The training loop stores them detached;
* eval: normalize with the running statistics and return them unchanged.

Inside ``bn_cross_replica(group)`` (JAX's name; the port's data-parallel
group, ``ops/collectives.py``) the training moments are those of the GLOBAL
batch, whose rows or time steps the group's ranks hold in shards, over
local rows x P values: the mean from an all-reduce of the sums, then the
variance from an all-reduce of the squared deviations from it, the
two-pass variance of the unsharded op.  JAX's ``E[x^2] - mean^2`` from one
all-reduce (JAX ``ops/batchnorm.py:71-90``) cancels where a channel's mean
dwarfs its spread: at the CPU test's source shapes it moved a phase-5
gradient 0.7% from the unsharded step's (``tests/test_torch_port_dp.py``).

Channel-last layout: x is (..., C); stats are (C,).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .collectives import all_reduce_sum, data_group, data_parallel, rank_and_size


#: JAX's name for the context of the port's data-parallel group: inside it training-mode
#: ``batch_norm`` takes its moments over the group, and the port's other batch-global
#: quantities are global too (``ops/collectives.py``)
bn_cross_replica = data_parallel


class BNStats(NamedTuple):
    mean: torch.Tensor  # (C,)
    var: torch.Tensor  # (C,)


def init_bn_stats(num_features: int, device="cpu") -> BNStats:
    return BNStats(
        torch.zeros(num_features, device=device), torch.ones(num_features, device=device)
    )


def batch_norm_eval(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    stats: BNStats,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Normalize the last axis with the running statistics."""
    inv = torch.rsqrt(stats.var + eps)
    return (x - stats.mean) * (inv * scale) + bias


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    stats: BNStats,
    training: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, BNStats]:
    """Normalize over all axes but the last; returns (y, new running stats)."""
    if not training:
        return batch_norm_eval(x, scale, bias, stats, eps), stats
    dims = tuple(range(x.dim() - 1))
    group = data_group()
    if group is not None:
        n = x.numel() // x.shape[-1] * rank_and_size(group)[1]
        mean = all_reduce_sum(x.sum(dim=dims), group) / n
        var = all_reduce_sum(torch.square(x - mean).sum(dim=dims), group) / n  # biased
        unbiased = var * (n / max(n - 1, 1))
        new_stats = BNStats((1 - momentum) * stats.mean + momentum * mean,
                            (1 - momentum) * stats.var + momentum * unbiased)
        return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias, new_stats
    mean = x.mean(dim=dims)
    var = torch.square(x - mean).mean(dim=dims)  # biased
    n = x.numel() // x.shape[-1]
    new_stats = BNStats(
        (1 - momentum) * stats.mean + momentum * mean,
        (1 - momentum) * stats.var + momentum * var * (n / max(n - 1, 1)),
    )
    y = (x - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return y, new_stats
