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

Channel-last layout: x is (..., C); stats are (C,).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


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
    mean = x.mean(dim=dims)
    var = torch.square(x - mean).mean(dim=dims)  # biased
    n = x.numel() // x.shape[-1]
    new_stats = BNStats(
        (1 - momentum) * stats.mean + momentum * mean,
        (1 - momentum) * stats.var + momentum * var * (n / max(n - 1, 1)),
    )
    y = (x - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return y, new_stats
