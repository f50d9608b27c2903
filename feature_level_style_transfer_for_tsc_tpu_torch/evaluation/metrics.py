"""Evaluation metrics: per-class precision weights of ensemble members.

Counterpart of the JAX package's ``evaluation/metrics.py``: parity with the
reference's numpy loops (``multi_source_voting.py:281-367``), vectorized.
"""

from __future__ import annotations

import torch


def per_class_precision_weights(
    pred: torch.Tensor, labels: torch.Tensor, num_class: int
) -> torch.Tensor:
    """w[c] = (# correct predictions of class c) / (# predictions of class c),
    0 when the class is never predicted (reference :297-310)."""
    pred_onehot = torch.nn.functional.one_hot(pred.long(), num_class).to(torch.float32)  # (N, C)
    correct = (pred == labels).to(torch.float32)[:, None] * pred_onehot
    num_pred = pred_onehot.sum(0)
    num_correct = correct.sum(0)
    return torch.where(
        num_pred > 0, num_correct / torch.clamp(num_pred, min=1), torch.zeros_like(num_pred)
    )


def normalize_model_weights(weights: torch.Tensor) -> torch.Tensor:
    """Normalize per-class weights across models by their mean, replacing
    NaN/inf with 0 (reference :358-367).

    weights: (M, C) -> (M, C).
    """
    out = weights / weights.mean(0, keepdim=True)
    return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
