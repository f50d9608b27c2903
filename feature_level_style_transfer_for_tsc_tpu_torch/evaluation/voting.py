"""Multi-source ensemble voting: the reference's three vote rules.

Counterpart of the JAX package's ``evaluation/voting.py`` (reference
``multi_source_voting.py:405-429``): each of M source-adapted models
contributes ``softmax(logits) * (1 + 120*e^{-H}) * 9^{w_m}``, where H is the
prediction entropy (natural log) and ``w_m`` the model's normalized
per-class train-split precision; the argmax of the sum wins.
"""

from __future__ import annotations

import torch

from ..config import VotingConfig


def _probs_and_entropy(logits: torch.Tensor):
    probs = torch.softmax(logits, dim=-1)
    ent = -torch.sum(probs * torch.log(probs), dim=-1, keepdim=True)  # scipy entropy
    return probs, ent


def entropy_precision_vote(
    logits: torch.Tensor,  # (M, N, C) stacked per-model logits
    class_weights: torch.Tensor,  # (M, C) normalized per-class precision weights
    cfg: VotingConfig = VotingConfig(),
) -> torch.Tensor:
    """Ensemble prediction (N,) — argmax of summed scaled votes."""
    probs, ent = _probs_and_entropy(logits)
    contrib = probs * (1.0 + cfg.entropy_scale * torch.exp(-ent)) * torch.pow(
        cfg.weight_base, class_weights[:, None, :]
    )
    return torch.argmax(contrib.sum(0), dim=-1)


def entropy_only_vote(logits: torch.Tensor, entropy_scale: float = 2.0) -> torch.Tensor:
    """The commented entropy-only variant (reference :118-227): scales by
    ``1 + entropy_scale*e^{-H}`` without precision weights."""
    probs, ent = _probs_and_entropy(logits)
    contrib = probs * (1.0 + entropy_scale * torch.exp(-ent))
    return torch.argmax(contrib.sum(0), dim=-1)


def predicted_label_vote(
    logits: torch.Tensor,  # (M, N, C)
    class_weights: torch.Tensor,  # (M, C)
    entropy_scale: float = 120.0,
    weight_base: float = 12.0,
) -> torch.Tensor:
    """The per-predicted-label weight variant kept in the reference's
    ``visualization.py:231-440``: each sample is scaled by the weight of its
    OWN argmax class, with base 12."""
    probs, ent = _probs_and_entropy(logits)
    pred = torch.argmax(probs, dim=-1)  # (M, N)
    sample_w = torch.gather(class_weights, 1, pred)[:, :, None]
    contrib = probs * (1.0 + entropy_scale * torch.exp(-ent)) * torch.pow(weight_base, sample_w)
    return torch.argmax(contrib.sum(0), dim=-1)
