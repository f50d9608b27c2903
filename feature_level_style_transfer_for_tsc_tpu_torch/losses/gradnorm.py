"""GradNorm loss balancing.

Counterpart of the JAX package's ``losses/gradnorm.py`` (reference
``train_and_test.py:498-761``), closed-form:

* ``norms_i = w_i * N_i`` with ``N_i = sum_p ||d loss_i / d trunk_p||_2``;
* the constant target ``mean(norms) * inverse_train_rate ** alpha`` (all
  detached), and ``d gap / d w_i = sign(w_i N_i - const_i) * N_i``;
* a torch Adam step on the weights, then clamp at 0 and renormalize to a
  fixed sum (7 for the target group, 8 for the source group).

The weights may carry leading run axes, ``(K, 2)`` and ``(K, 3)`` in
multi-run training (``train/multirun.py``): every reduction is over the
last axis, one row a run (Adam is elementwise); the first-step flag is
shared, as every run takes the same steps.
"""

from __future__ import annotations

from typing import Sequence

import torch


class GradNormState:
    """Loss weights, the first step's sigmoid losses, and the weights' Adam."""

    def __init__(self, init_weights: Sequence[float], lr: float, device="cpu"):
        self.weights = torch.tensor(list(init_weights), dtype=torch.float32, device=device)
        self.initial_sigmoid_loss = torch.ones_like(self.weights)
        self.initialized = False
        self.optimizer = torch.optim.Adam([self.weights], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def gradnorm_init(init_weights: Sequence[float], lr: float, device="cpu") -> GradNormState:
    return GradNormState(init_weights, lr, device)


@torch.no_grad()
def gradnorm_step(state: GradNormState, losses: torch.Tensor, trunk_grad_norms: torch.Tensor,
                  *, alpha: float = 3.0, weight_sum: float = 7.0) -> GradNormState:
    """One GradNorm weight update (reference :646-761), in place."""
    sig = torch.sigmoid(losses.detach())
    if not state.initialized:
        state.initial_sigmoid_loss = sig.clone()
        state.initialized = True
    loss_ratio = sig / state.initial_sigmoid_loss
    inverse_train_rate = loss_ratio / loss_ratio.mean(-1, keepdim=True)
    norms = state.weights * trunk_grad_norms
    const = norms.mean(-1, keepdim=True) * inverse_train_rate ** alpha
    state.weights.grad = torch.sign(norms - const) * trunk_grad_norms
    state.optimizer.step()
    state.weights.clamp_(min=0.0)
    state.weights.mul_(weight_sum / state.weights.sum(-1, keepdim=True))
    return state
