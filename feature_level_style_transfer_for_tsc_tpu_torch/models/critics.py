"""Adversarial critics and the CDAN randomized multilinear map.

Counterpart of the JAX package's ``models/critics.py`` (reference
``widgets.py:15-42,95-131``, ``C_DAN.py:11-25``).  The reference modules
bump an ``iter_num`` counter inside forward to anneal their gradient
reversal; here the counter is explicit state (``CriticState``), starting at
-1 and incremented before the coefficient is taken.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.grl import gradient_reversal, grl_coeff
from .common import dropout, dropout_mask, linear, linear_init, xavier_normal_linear_init


class CriticState(NamedTuple):
    """GRL annealing counter (reference widgets.py:28-31,108-112)."""

    iter_num: torch.Tensor  # int32 scalar, starts at -1


def critic_state_init() -> CriticState:
    """On the host: the coefficient is read from it on every call."""
    return CriticState(torch.tensor(-1, dtype=torch.int32))


def _advance(state: CriticState, training: bool, max_iter: float) -> CriticState:
    if not training:
        return state
    return CriticState(torch.clamp(state.iter_num + 1, max=int(max_iter)))


# ------------------------------------------- AdversarialNetworkforCDAN -----

AD_NET_ALPHA = 100.0
AD_NET_MAX_ITER = 20.0


def ad_net_init(generator: torch.Generator, in_feature: int, hidden_size: int,
                device="cpu") -> Tuple[Dict, CriticState]:
    """3-layer MLP critic with xavier-normal init (widgets.py:83-106)."""
    params = {
        "l1": xavier_normal_linear_init(generator, in_feature, hidden_size, device),
        "l2": xavier_normal_linear_init(generator, hidden_size, hidden_size, device),
        "l3": xavier_normal_linear_init(generator, hidden_size, 1, device),
    }
    return params, critic_state_init()


def ad_net_coeff(state: CriticState) -> float:
    return grl_coeff(int(state.iter_num), alpha=AD_NET_ALPHA, max_iter=AD_NET_MAX_ITER)


def ad_net_apply(params: Dict, state: CriticState, x: torch.Tensor, *, training: bool,
                 generator: Optional[torch.Generator] = None,
                 dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                 ) -> Tuple[torch.Tensor, CriticState]:
    """Critic value with GRL on the input (widgets.py:113-131).  Dropout 0.2
    after each hidden layer, its keep-masks from ``generator`` or given."""
    new_state = _advance(state, training, AD_NET_MAX_ITER)
    x = gradient_reversal(x, ad_net_coeff(new_state))
    masks = dropout_masks if dropout_masks is not None else (None, None)
    h = torch.relu(linear(params["l1"], x))
    h = dropout(h, 0.2, training, generator, masks[0])
    h = torch.relu(linear(params["l2"], h))
    h = dropout(h, 0.2, training, generator, masks[1])
    return linear(params["l3"], h), new_state


def draw_dropout_masks(generator: torch.Generator, batch: int,
                       hidden: int) -> List[List[torch.Tensor]]:
    """The dropout multipliers of one ``cdan_loss`` call, drawn from
    ``generator`` as it draws them: the target call's two (after l1 and l2),
    then the s2t call's, each (batch, hidden).  Multi-run training draws
    each run's outside ``torch.func.vmap`` and passes them as
    ``dropout_masks``."""
    return [[dropout_mask((batch, hidden), 0.2, generator) for _ in range(2)] for _ in range(2)]


# --------------------------------------- FeatureDiscriminatorforSource -----

FEAT_DISC_ALPHA = 100.0
FEAT_DISC_MAX_ITER = 20.0


def feature_discriminator_init(generator: torch.Generator, length_of_feature: int,
                               device="cpu") -> Tuple[Dict, CriticState]:
    """WGAN critic MLP L->800->400->50->1, LeakyReLU(0.2) (widgets.py:15-42)."""
    dims = (length_of_feature, 800, 400, 50, 1)
    params = {f"l{i + 1}": linear_init(generator, dims[i], dims[i + 1], device) for i in range(4)}
    return params, critic_state_init()


def feature_discriminator_apply(params: Dict, state: CriticState, x: torch.Tensor, *,
                                training: bool) -> Tuple[torch.Tensor, CriticState]:
    new_state = _advance(state, training, FEAT_DISC_MAX_ITER)
    coeff = grl_coeff(int(new_state.iter_num), alpha=FEAT_DISC_ALPHA, max_iter=FEAT_DISC_MAX_ITER)
    h = gradient_reversal(x, coeff)
    for name in ("l1", "l2", "l3"):
        h = F.leaky_relu(linear(params[name], h), 0.2)
    return linear(params["l4"], h), new_state


# ------------------------------------------------------------ RandomLayer --

def random_layer_init(generator: torch.Generator, input_dim_list: Sequence[int],
                      output_dim: int = 1024, device="cpu") -> Dict:
    """Fixed (non-learned) random projection matrices (C_DAN.py:11-25)."""
    return {
        "matrices": [
            torch.randn(d, output_dim, generator=generator).to(device) for d in input_dim_list
        ],
        "output_dim": torch.tensor(float(output_dim), device=device),
    }


def random_layer_apply(params: Dict, input_list) -> torch.Tensor:
    """Elementwise product of projections, scaled by output_dim^(-1/n)."""
    projected = [x @ m for x, m in zip(input_list, params["matrices"])]
    out = projected[0] / torch.pow(params["output_dim"], 1.0 / len(projected))
    for p in projected[1:]:
        out = out * p
    return out
