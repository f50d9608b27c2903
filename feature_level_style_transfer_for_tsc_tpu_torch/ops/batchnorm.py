"""Eval-mode batch normalization with torch ``BatchNorm1d`` semantics.

Counterpart of the JAX package's ``ops/batchnorm.py`` for serving: the
running statistics are explicit state (``BNStats``), and eval mode
normalizes with them and leaves them unchanged.  Training-mode statistics
(momentum update, unbiased variance) come with the training slice.

Channel-last layout: x is (..., C); stats are (C,).
"""

from __future__ import annotations

from typing import NamedTuple

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
