"""Wasserstein critic loss (reference widgets.py:59-61)."""

from __future__ import annotations

import torch

from ..ops.collectives import data_group, rank_and_size


def wgan_loss(values_from_target_side: torch.Tensor, values_from_s2t2s: torch.Tensor,
              values_from_source_side: torch.Tensor) -> torch.Tensor:
    """Under a data-parallel group, the rank's contribution: its rows' sums
    over the global batch sizes."""
    group = data_group()
    if group is None:
        return (
            -values_from_target_side.mean() - values_from_s2t2s.mean()
            + values_from_source_side.mean()
        )
    p = rank_and_size(group)[1]
    t, s2t2s, s = values_from_target_side, values_from_s2t2s, values_from_source_side
    return -t.sum() / (t.numel() * p) - s2t2s.sum() / (s2t2s.numel() * p) + s.sum() / (s.numel() * p)
