"""Optimizers and LR schedules with the JAX package's hyperparameters.

Counterpart of the JAX package's ``train/optim.py`` (reference
``train_and_test.py:97-134``): torch's own ``RMSprop`` (alpha 0.99, eps 1e-8
outside the sqrt) for the main modules and ``Adam`` (0.9, 0.999, 1e-8) for
CPC, one optimizer per module; StepLR as a function of a per-module epoch
counter and ReduceLROnPlateau as an explicit state machine (mode 'min', rel
threshold 1e-4, patience 10, cooldown 0), whose learning rate is written
into the module's optimizer; the WGAN clamp of the critics.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

#: the hyperparameters but the learning rate, under the JAX package's optax names
RMSPROP_HYPERPARAMS = {"decay": 0.99, "eps": 1e-8, "initial_scale": 0.0}
ADAM_HYPERPARAMS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def make_rmsprop(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Optimizer:
    h = RMSPROP_HYPERPARAMS
    return torch.optim.RMSprop(list(params), lr=lr, alpha=h["decay"], eps=h["eps"])


def make_adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Optimizer:
    h = ADAM_HYPERPARAMS
    return torch.optim.Adam(list(params), lr=lr, betas=(h["b1"], h["b2"]), eps=h["eps"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def step_lr(base_lr: float, epoch: int, step_size: int, gamma: float) -> float:
    """torch StepLR: lr = base * gamma**(epoch // step_size)."""
    return base_lr * gamma ** (epoch // step_size)


class PlateauState(NamedTuple):
    """torch ReduceLROnPlateau (mode='min', threshold_mode='rel') state."""

    lr: float
    best: float
    num_bad: int


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(lr=float(lr), best=float("inf"), num_bad=0)


def plateau_step(state: PlateauState, metric: float, *, factor: float, min_lr: float,
                 patience: int = 10, threshold: float = 1e-4) -> PlateauState:
    """One per-epoch plateau update; returns the new state (lr inside)."""
    metric = float(metric)
    improved = metric < state.best * (1.0 - threshold)
    best = metric if improved else state.best
    num_bad = 0 if improved else state.num_bad + 1
    lr = state.lr
    if num_bad > patience:
        lr, num_bad = max(state.lr * factor, min_lr), 0
    return PlateauState(lr=lr, best=best, num_bad=num_bad)


@torch.no_grad()
def clip_params(params: Iterable[torch.Tensor], bound: float) -> None:
    """WGAN critic clamp, in place: every parameter to [-bound, +bound]
    (reference train_and_test.py:763-766)."""
    for p in params:
        p.clamp_(-bound, bound)
