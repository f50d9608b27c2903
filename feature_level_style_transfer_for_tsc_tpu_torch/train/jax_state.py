"""The port's whole training state under the JAX package's checkpoint keys.

The JAX package's ``init_state`` (per-module optimizers) holds, besides
params, mstate and consts:

* ``['opt'][m]``: ``optax.inject_hyperparams`` over ``optax.flatten`` of
  RMSprop (``inner_state[0].nu``) or, for CPC, Adam
  (``inner_state[0].{count,mu,nu}``), the moments ONE flat vector per module
  in ``jax.tree_util`` leaf order (``jax_order``); with
  ``fused_optimizers``, ``['opt']['fused']`` (``FusedRMSState``: the RMSprop
  modules' flat ``v`` and per-element ``lr``) and ``['opt']['cpc']`` instead;
* ``['sched'][m]``, the StepLR counters, and ``['plateau'][m]``;
* ``['gradnorm'][k]``: weights, first sigmoid losses, a flag and the
  weights' Adam as ``opt_state[0]``;
* ``['rng']``, a threefry key.

``state_to_flat`` writes the port's pipeline state (torch optimizers, ``PlateauState``
of floats, ``GradNormState``, a ``torch.Generator``) as those NamedTuples,
flattened by ``io.checkpoint``; ``load_state`` reads a file of either
package back through the same NamedTuples (``from_jax_params``) into a
fresh port state.  The torch generator cannot become a threefry key: the
port writes two words drawn from it as ``['rng']`` and its full state under
a key of its own, ``['generator']``, which the JAX package's restore does
not read; a file without it (a JAX-written one) seeds the generator from
the two ``['rng']`` words.

``classifier_state_to_flat`` / ``load_classifier_state`` do the same for
the state of ``OSCNNClassifier`` and ``BucketedOSCNNClassifier`` (params,
mstate, ``['opt'][m]``, ``['rng']``, ``['epoch']``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple

import numpy as np
import torch

from ..io.checkpoint import flatten, from_jax_params, register_namedtuples, tree_items
from ..losses.gradnorm import GradNormState
from .optim import (
    ADAM_HYPERPARAMS,
    RMSPROP_HYPERPARAMS,
    FusedRMSprop,
    FusedRMSState,
    PlateauState,
    jax_order,
    set_lr,
)

MODEL_KEYS = ("params", "mstate", "consts")


class InjectHyperparamsState(NamedTuple):
    count: np.ndarray
    hyperparams: Dict[str, np.ndarray]
    inner_state: tuple


class ScaleByRmsState(NamedTuple):
    nu: np.ndarray


class ScaleByAdamState(NamedTuple):
    count: np.ndarray
    mu: np.ndarray
    nu: np.ndarray


class SavedGradNorm(NamedTuple):
    """The JAX package's ``GradNormState``."""

    weights: torch.Tensor
    initial_sigmoid_loss: torch.Tensor
    initialized: np.ndarray
    opt_state: tuple


register_namedtuples(InjectHyperparamsState, ScaleByRmsState, ScaleByAdamState, SavedGradNorm,
                     PlateauState, FusedRMSState)


def exact_scalar(v: float) -> np.ndarray:
    """A Python float as float32 where that holds it exactly, else float64
    (the JAX package casts either to its float32 on restore)."""
    v = float(v)
    return np.asarray(np.float32(v) if float(np.float32(v)) == v or v != v else np.float64(v))


def _moments(optimizer: torch.optim.Optimizer, params):
    """(step count, {state key: flat float32 vector}) of the tensors of
    ``params`` in JAX order; zeros and count 0 where the optimizer has not
    stepped yet."""
    ps = jax_order(params)
    states = [optimizer.state.get(p, {}) for p in ps]
    steps = {int(s["step"]) for s in states if s}
    if len(steps) > 1 or (steps and not all(states)):
        raise ValueError(f"the parameters of one module stepped unequally: {sorted(steps)}")
    keys = ("exp_avg", "exp_avg_sq") if isinstance(optimizer, torch.optim.Adam) else ("square_avg",)
    flat = {k: torch.cat([(s[k] if s else torch.zeros_like(p)).detach().reshape(-1)
                          for p, s in zip(ps, states)]).cpu().numpy() for k in keys}
    return (steps.pop() if steps else 0), flat


def _set_moments(optimizer: torch.optim.Optimizer, params, count: int,
                 vectors: Mapping[str, torch.Tensor]) -> None:
    """The inverse of ``_moments``: every tensor of ``params`` at step
    ``count``; count 0 leaves no state, as before a first step."""
    ps = jax_order(params)
    for p in ps:
        optimizer.state.pop(p, None)
    if count == 0:
        return
    total = sum(p.numel() for p in ps)
    for key, vec in vectors.items():
        if tuple(vec.shape) != (total,):
            raise ValueError(f"{key}: a flat vector of {total} expected, got {tuple(vec.shape)}")
    lo = 0
    for p in ps:
        state = {"step": torch.tensor(float(count))}
        for key, vec in vectors.items():
            state[key] = vec[lo : lo + p.numel()].to(p.device, p.dtype).reshape(p.shape).clone()
        optimizer.state[p] = state
        lo += p.numel()


def optax_state(optimizer: torch.optim.Optimizer, params) -> InjectHyperparamsState:
    """One module's torch ``RMSprop`` or ``Adam`` over the tensors of
    ``params`` as the JAX package's ``['opt'][m]``: the step count, the
    hyperparameters (the learning rate exactly, see ``exact_scalar``) and
    ``nu`` (RMSprop's ``square_avg``), or ``count``/``mu``/``nu`` (Adam's
    step, ``exp_avg``, ``exp_avg_sq``)."""
    count, flat = _moments(optimizer, params)
    adam = isinstance(optimizer, torch.optim.Adam)
    hyper = {k: np.float32(v) for k, v in (ADAM_HYPERPARAMS if adam else RMSPROP_HYPERPARAMS).items()}
    lrs = {float(g["lr"]) for g in optimizer.param_groups}
    if len(lrs) != 1:
        raise ValueError(f"one learning rate a module, got {sorted(lrs)}")
    hyper["learning_rate"] = exact_scalar(lrs.pop())
    inner = (ScaleByAdamState(np.int32(count), flat["exp_avg"], flat["exp_avg_sq"]) if adam
             else ScaleByRmsState(flat["square_avg"]),)
    return InjectHyperparamsState(np.int32(count), hyper, inner)


def load_optax_state(optimizer: torch.optim.Optimizer, params,
                     saved: InjectHyperparamsState) -> None:
    """The inverse of ``optax_state``, from the state as read back.  Raises
    where a hyperparameter other than the learning rate is not the port's,
    or the saved counts differ."""
    adam = isinstance(optimizer, torch.optim.Adam)
    for k, v in (ADAM_HYPERPARAMS if adam else RMSPROP_HYPERPARAMS).items():
        have = float(saved.hyperparams[k])
        if np.float32(have) != np.float32(v):
            raise ValueError(f"hyperparameter {k} is {have}, the port's is {v}")
    count, inner = int(saved.count), saved.inner_state[0]
    if adam:
        if int(inner.count) != count:
            raise ValueError(f"the counts {count} and {int(inner.count)} differ")
        vectors = {"exp_avg": inner.mu, "exp_avg_sq": inner.nu}
    else:
        vectors = {"square_avg": inner.nu}
    _set_moments(optimizer, params, count, vectors)
    set_lr(optimizer, float(saved.hyperparams["learning_rate"]))


def opt_saved(opt: Dict, params: Dict) -> Dict:
    """``state["opt"]`` as the JAX package's ``['opt']``: each module's
    optax state (``optax_state``), and a fused RMSprop as its
    ``FusedRMSState`` (``v``, ``lr``) under ``['fused']``."""
    return {m: o.state if isinstance(o, FusedRMSprop) else optax_state(o, params[m])
            for m, o in opt.items()}


@torch.no_grad()
def load_opt(opt: Dict, params: Dict, saved: Mapping) -> None:
    """The inverse of ``opt_saved``, into the optimizers of a fresh state of
    the same layout (per module, or fused: ``fused_optimizers``)."""
    if set(saved) != set(opt):
        raise ValueError(f"the saved optimizer state holds {sorted(saved)}, this state "
                         f"{sorted(opt)}: another fused_optimizers setting")
    for m, o in opt.items():
        if not isinstance(o, FusedRMSprop):
            load_optax_state(o, params[m], saved[m])
            continue
        for key in FusedRMSState._fields:
            have, got = getattr(o, key), getattr(saved[m], key)
            if tuple(got.shape) != tuple(have.shape):
                raise ValueError(f"opt/fused/{key}: {tuple(got.shape)}, the port's "
                                 f"{tuple(have.shape)}")
            have.copy_(got)  # in place: the leaves' views read these buffers


def _gradnorm_saved(g: GradNormState) -> SavedGradNorm:
    count, flat = _moments(g.optimizer, [g.weights])
    return SavedGradNorm(g.weights, g.initial_sigmoid_loss, np.bool_(g.initialized),
                         (ScaleByAdamState(np.int32(count), flat["exp_avg"], flat["exp_avg_sq"]),))


@torch.no_grad()
def _load_gradnorm(g: GradNormState, saved: SavedGradNorm) -> None:
    if saved.weights.shape != g.weights.shape:
        raise ValueError(f"gradnorm weights: {tuple(saved.weights.shape)}, "
                         f"the port's {tuple(g.weights.shape)}")
    g.weights.copy_(saved.weights)  # in place: the weights' Adam holds this tensor
    g.initial_sigmoid_loss = saved.initial_sigmoid_loss.to(g.weights.device, torch.float32)
    g.initialized = bool(saved.initialized)
    adam = saved.opt_state[0]
    _set_moments(g.optimizer, [g.weights], int(adam.count),
                 {"exp_avg": adam.mu, "exp_avg_sq": adam.nu})


def rng_words(generator: torch.Generator) -> np.ndarray:
    """Two uint32 words drawn from a copy of ``generator`` (which does not
    advance): the port's stand-in for the JAX package's PRNG key."""
    g = torch.Generator()
    g.set_state(generator.get_state())
    return torch.randint(0, 2**32, (2,), generator=g, dtype=torch.int64).numpy().astype(np.uint32)


def state_to_flat(state: Dict) -> Dict[str, np.ndarray]:
    """``state`` as ``{keystr: array}`` under every key of the JAX package's
    ``init_state``, plus ``['generator']``; plateau lr and best exactly
    (``exact_scalar``)."""
    return flatten({
        **{k: state[k] for k in MODEL_KEYS},
        "opt": opt_saved(state["opt"], state["params"]),
        "sched": {m: np.int32(v) for m, v in state["sched"].items()},
        "plateau": {m: PlateauState(exact_scalar(p.lr), exact_scalar(p.best), np.int32(p.num_bad))
                    for m, p in state["plateau"].items()},
        "gradnorm": {k: _gradnorm_saved(g) for k, g in state["gradnorm"].items()},
        "rng": rng_words(state["generator"]),
        "generator": state["generator"].get_state(),
    })


def _load_model(state: Dict, flat: Mapping[str, np.ndarray], keys) -> Dict:
    """Each model leaf of ``state[k]`` (k in ``keys``) read from ``flat``
    under its key and copied in place (the optimizers hold the parameters),
    as the JAX package's restore fills its template; the other entries of
    ``flat`` as ``from_jax_params`` rebuilds them, with every module's
    optimizer state loaded."""
    with torch.no_grad():
        for key, leaf in tree_items({k: state[k] for k in keys}):
            saved = torch.from_numpy(np.array(flat[key]))
            if saved.shape != leaf.shape:
                raise ValueError(f"{key}: {tuple(saved.shape)}, the port's {tuple(leaf.shape)}")
            leaf.copy_(saved)
    skip = tuple(f"[{k!r}]" for k in keys)
    saved = from_jax_params({k: v for k, v in flat.items() if not k.startswith(skip)})
    load_opt(state["opt"], state["params"], saved["opt"])
    return saved


def _seed_from_rng(generator: torch.Generator, rng) -> None:
    """Seed ``generator`` from the two words of a JAX PRNG key."""
    hi, lo = (int(w) for w in rng)
    generator.manual_seed(hi << 32 | lo)


def load_state(state: Dict, flat: Mapping[str, np.ndarray]) -> Dict:
    """``flat`` (``state_to_flat``'s, or the JAX package's) into ``state``,
    a fresh port state, as the JAX package's restore fills its template."""
    saved = _load_model(state, flat, MODEL_KEYS)
    state["sched"] = {m: int(saved["sched"][m]) for m in state["sched"]}
    state["plateau"] = {m: PlateauState(float(saved["plateau"][m].lr), float(saved["plateau"][m].best),
                                        int(saved["plateau"][m].num_bad))
                        for m in state["plateau"]}
    for k, g in state["gradnorm"].items():
        _load_gradnorm(g, saved["gradnorm"][k])
    if "generator" in saved:
        state["generator"].set_state(saved["generator"])
    else:
        _seed_from_rng(state["generator"], saved["rng"])
    return state


def classifier_state_to_flat(state: Dict) -> Dict[str, np.ndarray]:
    """An ``OSCNNClassifier`` or ``BucketedOSCNNClassifier`` training state
    under the keys of the JAX package's: params, mstate, ``['opt'][m]`` per
    module (``optax_state``), ``['rng']`` (two words of the generator, see
    ``rng_words``) and ``['epoch']``."""
    return flatten({
        "params": state["params"],
        "mstate": state["mstate"],
        "opt": {m: optax_state(o, state["params"][m]) for m, o in state["opt"].items()},
        "rng": rng_words(state["generator"]),
        "epoch": np.int32(state["epoch"]),
    })


def load_classifier_state(state: Dict, flat: Mapping[str, np.ndarray]) -> Dict:
    """The inverse of ``classifier_state_to_flat``: ``flat`` (the port's,
    or a JAX classifier's state flattened by ``jax.tree_util`` key paths)
    into ``state``, a fresh port state of the same model; the generator is
    seeded from the two ``['rng']`` words."""
    saved = _load_model(state, flat, ("params", "mstate"))
    state["epoch"] = int(saved["epoch"])
    _seed_from_rng(state["generator"], saved["rng"])
    return state
