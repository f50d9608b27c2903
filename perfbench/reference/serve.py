"""Plain PyTorch reference of serving: a classifier's logits, and the ensemble's vote.

The vote is the reference's entropy and precision rule (multi_source_voting.py:281-429):
each member's per-class precision on the target's train split, normalised across members
by their mean (NaN and infinities as 0); each member's softmax scaled by
``1 + a e^{-H}`` (H the prediction's entropy, natural log) and by ``b ** weight``, with the
configuration's ``entropy_scale`` a and ``weight_base`` b (120 and 9 in the reference); the
argmax of the members' sum wins.
"""

from __future__ import annotations

from typing import List

import torch

from . import model


def masks(layers, device) -> List[torch.Tensor]:
    return [torch.from_numpy(model.os_mask(layer)).to(device) for layer in layers]


def logits(member, masks_ext, masks_cls, x: torch.Tensor, block: int = 512) -> torch.Tensor:
    """A member's logits over x (N, T, C), ``block`` series at a time."""
    with torch.no_grad():
        return torch.cat([model.classifier_logits(member["params"], member["mstate"], masks_ext,
                                                  masks_cls, x[i:i + block])
                          for i in range(0, x.shape[0], block)])


def accepted(served: torch.Tensor, logits: torch.Tensor, tie: float) -> torch.Tensor:
    """The served predictions (M, N) that the reference's logits (M, N, C) accept: those
    whose logit lies within ``tie`` of the largest logit magnitude below the best (a near
    tie that rounding may break either way); elsewhere the reference's own argmax."""
    best = logits.max(-1)
    got = logits.gather(-1, served[..., None].long())[..., 0]
    ok = (best.values - got) <= tie * logits.abs().amax()
    return torch.where(ok, served.long(), best.indices)


def class_weights(pred: torch.Tensor, labels: torch.Tensor, n_class: int) -> torch.Tensor:
    """(M, C) normalised per-class precision of each member's train-split predictions
    (M, N)."""
    onehot = torch.nn.functional.one_hot(pred, n_class).float()  # (M, N, C)
    correct = (pred == labels[None]).float()[..., None] * onehot
    n_pred, n_ok = onehot.sum(1), correct.sum(1)
    w = torch.where(n_pred > 0, n_ok / n_pred.clamp(min=1), torch.zeros_like(n_pred))
    return torch.nan_to_num(w / w.mean(0, keepdim=True), nan=0.0, posinf=0.0, neginf=0.0)


def vote_scores(member_logits: torch.Tensor, weights: torch.Tensor, entropy_scale: float = 120.0,
                weight_base: float = 9.0) -> torch.Tensor:
    """(N, C) summed votes of (M, N, C) logits."""
    probs = torch.softmax(member_logits, dim=-1)
    ent = -torch.sum(probs * torch.log(probs), dim=-1, keepdim=True)
    return (probs * (1.0 + entropy_scale * torch.exp(-ent))
            * torch.pow(weight_base, weights[:, None, :])).sum(0)
