"""Affine coupling transform of the simplified-WaveGlow flow.

Counterpart of the JAX package's ``ops/coupling.py``.  Forward (density
direction, reference Simplified_NF_WaveGlow.py:165-178):
``x1' = exp(log_s) * x1 + b`` with log-determinant ``sum(log_s)``.  Inverse
(synthesis direction, reference :183-203): ``x1 = (x1' - b) * exp(-log_s)``.
Operands are (B, T, C/2).
"""

from __future__ import annotations

from typing import Tuple

import torch


def affine_coupling_forward(
    x1: torch.Tensor, log_s: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x1', sum(log_s))."""
    return torch.exp(log_s) * x1 + b, torch.sum(log_s)


def affine_coupling_inverse(x1p: torch.Tensor, log_s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (x1p - b) * torch.exp(-log_s)
