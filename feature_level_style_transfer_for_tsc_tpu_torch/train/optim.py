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

``FusedRMSprop`` is the JAX package's fused RMSprop
(``PipelineConfig.fused_optimizers``, its ``train/optim.py:106-164``): the
RMSprop modules as one flat second moment ``v`` and one flat learning rate a
element ``lr`` (a module's slice holds its learning rate), in the JAX
package's flat order (modules sorted, each module's leaves in
``jax.tree_util`` order, ``jax_order``), optionally with a leading run axis.
Each step updates every leaf of the stepped modules through views of the
two buffers, so nothing is raveled; a module outside the step keeps its
values and its slice of ``v`` bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence, Union

import torch

#: the hyperparameters but the learning rate, under the JAX package's optax names
RMSPROP_HYPERPARAMS = {"decay": 0.99, "eps": 1e-8, "initial_scale": 0.0}
ADAM_HYPERPARAMS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def jax_order(tree) -> List[torch.Tensor]:
    """The tensors of a tree in ``jax.tree_util`` leaf order: dict keys
    sorted at every level, lists and NamedTuples in their own order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in jax_order(tree[k])]
    return [leaf for v in tree for leaf in jax_order(v)]


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


class FusedRMSState(NamedTuple):
    """The JAX package's ``FusedRMSState``: the flat second moment ``v`` and
    the flat per-element learning rate ``lr`` (each (N,), or (K, N) for K
    runs)."""

    v: torch.Tensor
    lr: torch.Tensor


class FusedRMSprop:
    """The RMSprop modules of ``modules`` (name -> parameter tree) as one
    flat update with a learning rate per element (decay 0.99, eps 1e-8
    outside the sqrt: ``RMSPROP_HYPERPARAMS``).  The flat order is the JAX
    package's: modules sorted, each module's leaves in ``jax_order``.
    ``runs``: every leaf carries a leading run axis of K runs, ``v`` and
    ``lr`` are (K, N) and a learning rate is one float or K.  ``state``:
    the buffers to hold (else ``v`` zeros and each module's ``lrs``).

    ``step(names)`` updates the leaves of the named modules from each
    leaf's ``.grad``, as a torch optimizer does."""

    def __init__(self, modules: Mapping[str, object], lrs: Optional[Mapping[str, object]] = None,
                 runs: Optional[int] = None, state: Optional[FusedRMSState] = None):
        self.names = tuple(sorted(modules))
        self.runs = runs
        self.leaves = {n: jax_order(modules[n]) for n in self.names}
        lead = () if runs is None else (runs,)
        self.offsets: Dict[str, tuple] = {}
        pos = 0
        for n in self.names:
            size = sum(p[0].numel() if runs else p.numel() for p in self.leaves[n])
            self.offsets[n] = (pos, pos + size)
            pos += size
        if state is None:
            device = self.leaves[self.names[0]][0].device
            state = FusedRMSState(torch.zeros(*lead, pos, device=device),
                                  torch.zeros(*lead, pos, device=device))
        if tuple(state.v.shape) != (*lead, pos) or tuple(state.lr.shape) != (*lead, pos):
            raise ValueError(f"fused RMSprop buffers {tuple(state.v.shape)} and "
                             f"{tuple(state.lr.shape)}, the modules' {(*lead, pos)}")
        self.v, self.lr = state.v, state.lr
        # each leaf's (v, lr) views, in the leaf's shape (run axis first)
        self.views = {}
        for n in self.names:
            lo, views = self.offsets[n][0], []
            for p in self.leaves[n]:
                size = p[0].numel() if runs else p.numel()
                views.append((self.v[..., lo : lo + size].view(p.shape),
                              self.lr[..., lo : lo + size].view(p.shape)))
                lo += size
            self.views[n] = views
        for n, lr in (lrs or {}).items():
            self.set_lr(n, lr)

    @property
    def state(self) -> FusedRMSState:
        return FusedRMSState(self.v, self.lr)

    def set_lr(self, name: str, lr: Union[float, Sequence[float]]) -> None:
        """Module ``name``'s slice of ``lr``: one float, or one a run."""
        lo, hi = self.offsets[name]
        if self.runs is None:
            self.lr[lo:hi] = float(lr)
            return
        lrs = [float(lr)] * self.runs if isinstance(lr, (int, float)) else [float(v) for v in lr]
        if len(lrs) != self.runs:
            raise ValueError(f"{len(lrs)} learning rates for {self.runs} runs")
        self.lr[:, lo:hi] = torch.tensor(lrs, dtype=torch.float32, device=self.lr.device)[:, None]

    @torch.no_grad()
    def step(self, names: Iterable[str]) -> None:
        """One update of the named modules' leaves from their ``.grad``
        (JAX ``fused_rmsprop_update`` with those modules in the step mask):
        ``v = 0.99 v + 0.01 g*g``, ``p += -lr * g / (sqrt(v) + eps)``, in
        torch ``RMSprop``'s order of operations."""
        stepped = set(names)
        unknown = stepped - set(self.names)
        if unknown:
            raise KeyError(f"modules {sorted(unknown)} are not fused")
        ps, gs, vs, lrs = [], [], [], []
        for n in self.names:
            if n in stepped:
                for p, (v, lr) in zip(self.leaves[n], self.views[n]):
                    ps.append(p)
                    gs.append(torch.zeros_like(p) if p.grad is None else p.grad)
                    vs.append(v)
                    lrs.append(lr)
        if not ps:
            return
        h = RMSPROP_HYPERPARAMS
        torch._foreach_mul_(vs, h["decay"])
        torch._foreach_addcmul_(vs, gs, gs, value=1 - h["decay"])
        avg = torch._foreach_sqrt(vs)
        torch._foreach_add_(avg, h["eps"])
        upd = torch._foreach_mul(torch._foreach_neg(lrs), gs)
        torch._foreach_div_(upd, avg)
        torch._foreach_add_(ps, upd)  # torch's addcdiv_(g, avg, value=-lr), its order

    def zero_grad(self, names: Iterable[str]) -> None:
        for n in names:
            for p in self.leaves[n]:
                p.grad = None


def stack_fused(fused: Sequence[FusedRMSprop], modules: Mapping[str, object]) -> FusedRMSprop:
    """K one-run fused optimizers as one over ``modules``, the stacked
    leaves of K runs."""
    return FusedRMSprop(modules, runs=len(fused), state=FusedRMSState(
        torch.stack([f.v for f in fused]).contiguous(), torch.stack([f.lr for f in fused]).contiguous()))


def unstack_fused(stacked: FusedRMSprop, run: int, modules: Mapping[str, object]) -> FusedRMSprop:
    """Run ``run`` of a stacked fused optimizer over ``modules``, that run's
    leaves."""
    return FusedRMSprop(modules, state=FusedRMSState(stacked.v[run].clone(),
                                                     stacked.lr[run].clone()))


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
