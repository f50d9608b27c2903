"""CDAN conditional-adversarial alignment loss.

Counterpart of the JAX package's ``losses/cdan.py`` (reference
``C_DAN.py:49-82``): flattened features and softmaxed logits fused by the
randomized multilinear map, the critic (with its own gradient reversal),
entropy weights ``1 + e^{-H}`` normalized by their detached batch sum with
gradient reversal on the entropy path, and the difference of the weighted
critic sums.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.critics import CriticState, ad_net_apply, ad_net_coeff, random_layer_apply
from ..ops.collectives import all_reduce_sum, data_group, rank_and_size
from ..ops.grl import gradient_reversal
from .classification import softmax_entropy


def _flatten_features(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, C*T) in the reference's channel-major order."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def cdan_loss(
    ad_net_params: Dict,
    ad_net_state: CriticState,
    target_feature: torch.Tensor,
    s2t_feature: torch.Tensor,
    target_logits: torch.Tensor,
    s2t_logits: torch.Tensor,
    *,
    random_layer: Dict,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
    dropout_masks: Optional[Sequence[Sequence[torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, CriticState]:
    """``dropout_masks``, when given, are the critic's keep-masks for the
    target and the s2t call, two each.  Under a data-parallel group the
    four sums are global (one all-reduce) and the loss, the same on every
    rank, is returned as the rank's 1/P share of it."""
    prob_target = torch.softmax(target_logits, dim=1)
    prob_s2t = torch.softmax(s2t_logits, dim=1)
    fusion_t = random_layer_apply(random_layer, [_flatten_features(target_feature), prob_target])
    fusion_s = random_layer_apply(random_layer, [_flatten_features(s2t_feature), prob_s2t])
    masks = dropout_masks if dropout_masks is not None else (None, None)
    target_out, state1 = ad_net_apply(ad_net_params, ad_net_state, fusion_t, training=training,
                                      generator=generator, dropout_masks=masks[0])
    s2t_out, state2 = ad_net_apply(ad_net_params, state1, fusion_s, training=training,
                                   generator=generator, dropout_masks=masks[1])
    coeff = ad_net_coeff(state2)
    w_t = 1.0 + torch.exp(-gradient_reversal(softmax_entropy(prob_target), coeff))
    w_s = 1.0 + torch.exp(-gradient_reversal(softmax_entropy(prob_s2t), coeff))
    group = data_group()
    if group is not None:
        sums = all_reduce_sum(torch.stack([w_t.sum(), w_s.sum(), target_out[:, 0].sum(),
                                           s2t_out[:, 0].sum()]), group)
        norm = sums[:2].detach()
        distance = (sums[0] / norm[0]) * sums[2] - (sums[1] / norm[1]) * sums[3]
        return distance / rank_and_size(group)[1], state2
    w_t = w_t / w_t.sum().detach()
    w_s = w_s / w_s.sum().detach()
    # The reference's unassigned ``.view(-1, 1)`` (C_DAN.py:75,77) makes
    # ``weight (B,) * critic_out (B, 1)`` broadcast to (B, B), so each sum is
    # (sum w) * (sum out); kept exactly (PARITY.md:103-107).
    distance_target = w_t.sum() * target_out[:, 0].sum()
    distance_s2t = w_s.sum() * s2t_out[:, 0].sum()
    return distance_target - distance_s2t, state2
