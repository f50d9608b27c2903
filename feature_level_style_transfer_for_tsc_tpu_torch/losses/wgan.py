"""Wasserstein critic loss (reference widgets.py:59-61)."""

from __future__ import annotations

import torch


def wgan_loss(values_from_target_side: torch.Tensor, values_from_s2t2s: torch.Tensor,
              values_from_source_side: torch.Tensor) -> torch.Tensor:
    return (
        -values_from_target_side.mean() - values_from_s2t2s.mean()
        + values_from_source_side.mean()
    )
