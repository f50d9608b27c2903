"""Classification losses (torch ``nn.CrossEntropyLoss`` parity)."""

from __future__ import annotations

import torch

from ..ops.collectives import data_group, rank_and_size


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch from integer labels
    (reference train_and_test.py:81); under a data-parallel group the
    rank's contribution, its rows' sum over the global batch size."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    group = data_group()
    if group is None:
        return nll.mean()
    return nll.sum() / (nll.shape[0] * rank_and_size(group)[1])


def softmax_entropy(probs: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Per-sample entropy of softmaxed probabilities, epsilon inside the log
    (reference ``Entropy``, C_DAN.py:28-34)."""
    return -torch.sum(probs * torch.log(probs + epsilon), dim=1)
