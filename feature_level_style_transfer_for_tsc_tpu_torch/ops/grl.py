"""Gradient reversal layer (GRL) with its annealed coefficient.

Counterpart of the JAX package's ``ops/grl.py``: the forward value is
unchanged and the backward gradient is multiplied by ``-coeff`` (reference
``C_DAN.py:40-44,70-71``, ``widgets.py:8-13,36-37,118``).  ``grl_coeff`` is
the reference's ``calc_coeff`` schedule of the iteration counter.
"""

from __future__ import annotations

import math

import torch


class GradientReversal(torch.autograd.Function):
    """Identity forward, ``-coeff * g`` backward; its vmap rule is generated
    (``torch.func.vmap`` over runs, ``train/multirun.py``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x: torch.Tensor, coeff: float) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.coeff = inputs[1]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.coeff * g, None


def gradient_reversal(x: torch.Tensor, coeff: float) -> torch.Tensor:
    return GradientReversal.apply(x, coeff)


def grl_coeff(
    iter_num: int,
    high: float = 1.0,
    low: float = 0.0,
    alpha: float = 100.0,
    max_iter: float = 50.0,
) -> float:
    """``2*(high-low)/(1+exp(-alpha*iter/max_iter)) - (high-low) + low`` with
    ``iter`` clamped to ``max_iter`` (reference widgets.py:35-38,116-119)."""
    it = min(float(iter_num), max_iter)
    return 2.0 * (high - low) / (1.0 + math.exp(-alpha * it / max_iter)) - (high - low) + low
