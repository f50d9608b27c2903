"""Optimizers and LR schedules with the JAX package's hyperparameters.

Counterpart of the JAX package's ``train/optim.py`` (reference
``train_and_test.py:97-134``): torch's own ``RMSprop`` (alpha 0.99, eps 1e-8
outside the sqrt) for the main modules and ``Adam`` (0.9, 0.999, 1e-8) for
CPC, one optimizer per module; StepLR as a function of a per-module epoch
counter and ReduceLROnPlateau as an explicit state machine (mode 'min', rel
threshold 1e-4, patience 10, cooldown 0), whose learning rate is written
into the module's optimizer; the WGAN clamp of the critics.

``StackedRMSprop`` and ``StackedAdam`` are K runs of those optimizers over
stacked leaves (a leading run axis, ``train/multirun.py``), with one
learning rate a run: torch's single-tensor update written out on the
stacked tensors (the same operations in the same order, so on the CPU each
run's step is torch's, bit for bit), the step count shared.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Sequence, Union

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


class StackedOptimizer:
    """K runs of one optimizer over leaves with a leading run axis: the
    moments stacked the same way, the step count shared, a learning rate a
    run (``lr``, K floats).  Steps with each leaf's ``.grad``, as torch's."""

    #: the state keys of a leaf, torch's names
    keys: Sequence[str] = ()
    #: the torch optimizer of one run
    torch_cls = torch.optim.Optimizer

    def __init__(self, params: Iterable[torch.Tensor], lr: Union[float, Sequence[float]],
                 runs: int):
        self.params = list(params)
        self.runs = runs
        self.count = 0
        self.state = {k: [torch.zeros_like(p) for p in self.params] for k in self.keys}
        self.lr: List[float] = []
        self.set_lr(lr)

    def set_lr(self, lr: Union[float, Sequence[float]]) -> None:
        lrs = [float(lr)] * self.runs if isinstance(lr, (int, float)) else [float(v) for v in lr]
        if len(lrs) != self.runs:
            raise ValueError(f"{len(lrs)} learning rates for {self.runs} runs")
        self.lr = lrs

    def _per_run(self, values: Sequence[float], like: torch.Tensor) -> torch.Tensor:
        """(K, 1, ..., 1) float32 factors on ``like``'s device."""
        v = torch.tensor(values, dtype=torch.float32, device=like.device)
        return v.reshape(self.runs, *([1] * (like.dim() - 1)))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        factors = {}
        for i, p in enumerate(self.params):
            key = (p.dim(), p.device)
            if key not in factors:
                factors[key] = self._per_run(self._step_sizes(), p)
            self._update(p, p.grad, [self.state[k][i] for k in self.keys], factors[key])

    def _step_sizes(self) -> List[float]:
        raise NotImplementedError

    def _update(self, p, g, moments, neg_step) -> None:
        raise NotImplementedError


class StackedRMSprop(StackedOptimizer):
    """torch ``RMSprop`` (alpha, eps of ``make_rmsprop``), K runs."""

    keys = ("square_avg",)
    torch_cls = torch.optim.RMSprop

    def _step_sizes(self) -> List[float]:
        return [-lr for lr in self.lr]

    def _update(self, p, g, moments, neg_lr) -> None:
        h = RMSPROP_HYPERPARAMS
        (square_avg,) = moments
        square_avg.mul_(h["decay"]).addcmul_(g, g, value=1 - h["decay"])
        avg = square_avg.sqrt().add_(h["eps"])
        p.add_(neg_lr * g / avg)  # torch's addcdiv_(g, avg, value=-lr), its order


class StackedAdam(StackedOptimizer):
    """torch ``Adam`` (betas, eps of ``make_adam``), K runs."""

    keys = ("exp_avg", "exp_avg_sq")
    torch_cls = torch.optim.Adam

    def _step_sizes(self) -> List[float]:
        # torch's step size, lr / bias_correction1, in double, one a run
        return [-(lr / (1 - ADAM_HYPERPARAMS["b1"] ** self.count)) for lr in self.lr]

    def _update(self, p, g, moments, neg_step) -> None:
        h = ADAM_HYPERPARAMS
        exp_avg, exp_avg_sq = moments
        exp_avg.lerp_(g, 1 - h["b1"])
        exp_avg_sq.mul_(h["b2"]).addcmul_(g, g, value=1 - h["b2"])
        bias_correction2_sqrt = (1 - h["b2"] ** self.count) ** 0.5
        denom = (exp_avg_sq.sqrt() / bias_correction2_sqrt).add_(h["eps"])
        p.add_(neg_step * exp_avg / denom)  # torch's addcdiv_, its order


def stack_optimizers(optimizers: Sequence[torch.optim.Optimizer],
                     params: Sequence[torch.Tensor]) -> StackedOptimizer:
    """K torch optimizers of one module (RMSprop or Adam, one learning rate
    each) as one stacked optimizer over ``params``, the module's stacked
    leaves; every run must have taken the same number of steps."""
    cls = StackedAdam if isinstance(optimizers[0], torch.optim.Adam) else StackedRMSprop
    out = cls(params, [o.param_groups[0]["lr"] for o in optimizers], len(optimizers))
    per_run = [[o.state.get(p, {}) for p in o.param_groups[0]["params"]] for o in optimizers]
    steps = {int(s["step"]) if s else 0 for states in per_run for s in states}
    if len(steps) != 1:
        raise ValueError(f"the runs' optimizers stepped unequally: {sorted(steps)}")
    out.count = steps.pop()
    if out.count:
        for k in cls.keys:
            out.state[k] = [torch.stack([states[i][k] for states in per_run]).contiguous()
                            for i in range(len(out.params))]
    return out


def unstack_optimizer(stacked: StackedOptimizer, run: int,
                      params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
    """Run ``run`` of a stacked optimizer as the torch optimizer of one run
    over ``params``, that run's leaves (what ``stack_optimizers`` read)."""
    make = make_adam if stacked.torch_cls is torch.optim.Adam else make_rmsprop
    opt = make(params, stacked.lr[run])
    if stacked.count:
        for i, p in enumerate(params):
            opt.state[p] = {"step": torch.tensor(float(stacked.count)),
                            **{k: stacked.state[k][i][run].clone() for k in stacked.keys}}
    return opt


def set_lr(optimizer, lr: Union[float, Sequence[float]]) -> None:
    """The learning rate of a torch optimizer, or of a stacked one (a float
    for every run, or one a run)."""
    if isinstance(optimizer, StackedOptimizer):
        optimizer.set_lr(lr)
        return
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
