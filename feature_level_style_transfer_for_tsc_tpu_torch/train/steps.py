"""Training and evaluation pieces shared by the port's trainers.

``StyleTransferPipeline`` (``train/pipeline.py``), ``OSCNNClassifier``
(``train/classifier.py``) and ``BucketedOSCNNClassifier``
(``train/bucketed.py``) keep their parameters as leaf tensors in nested
dictionaries, one torch optimizer per named module in ``state["opt"]`` (or,
with ``fused_optimizers``, one fused RMSprop for the RMSprop modules), and
step each module's optimizer once a batch through ``ModuleSteps``; their
evaluation runs fixed-size batches through ``batched_argmax``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..ops.collectives import all_reduce_grads
from .optim import set_lr, step_lr


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and NamedTuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [leaf for v in tree for leaf in leaves(v)]


def detached(tree):
    """A tree of dicts, lists and NamedTuples with every tensor detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(detached(v) for v in tree))
    return [detached(v) for v in tree]


def batched_argmax(predict: Callable, params, mstate, x: np.ndarray, batch_size: int,
                   device) -> np.ndarray:
    """Argmax class predictions of ``predict(params, mstate, batch)`` in
    batches of ``batch_size``; the last batch is padded by repeating its
    last series, and the padded rows are dropped."""
    xs = torch.as_tensor(x, dtype=torch.float32).to(device)
    preds = []
    for i in range(0, xs.shape[0], batch_size):
        xe = xs[i : i + batch_size]
        pad = batch_size - xe.shape[0]
        if pad:
            xe = torch.cat([xe, xe[-1:].expand(pad, *xe.shape[1:])], 0)
        preds.append(torch.argmax(predict(params, mstate, xe), -1)[: batch_size - pad])
    return torch.cat(preds).cpu().numpy()


class ModuleSteps:
    """One optimizer step of named modules and their StepLR; the class needs
    ``self.config`` (a ``PipelineConfig``) and ``self.base_lr`` (module name
    -> initial learning rate)."""

    def _apply_updates(self, state: Dict, names: Sequence[str], grads: Dict[str, list]) -> None:
        """One step of each named module's optimizer.  A parameter that got
        no gradient steps with zero, as in the JAX package.  The modules of a
        fused optimizer (``state["opt"]["fused"]``, ``fused_optimizers``)
        step in one update of it (JAX ``train/pipeline.py:277-296``)."""
        fused = state["opt"].get("fused")
        in_fused = [n for n in names if fused is not None and n in fused.offsets]
        for name in names:
            for p, g in zip(leaves(state["params"][name]), grads[name]):
                p.grad = torch.zeros_like(p) if g is None else g
            if name not in in_fused:
                state["opt"][name].step()
                state["opt"][name].zero_grad(set_to_none=True)
        if in_fused:
            fused.step(in_fused)
            fused.zero_grad(in_fused)

    @staticmethod
    def _set_module_lr(state: Dict, name: str, lr) -> None:
        """Write module ``name``'s learning rate (a float, or one a run) into
        whichever optimizer layout the state holds: its slice of the fused
        optimizer's ``lr``, or its own optimizer (JAX
        ``train/pipeline.py:298-309``)."""
        fused = state["opt"].get("fused")
        if fused is not None and name in fused.offsets:
            fused.set_lr(name, lr)
        else:
            set_lr(state["opt"][name], lr)

    def _grads(self, loss: torch.Tensor, state: Dict, names: Sequence[str],
               retain_graph: bool = False) -> Dict[str, list]:
        """d loss / d params of each named module (None where unused); under
        a data-parallel group ``loss`` is the rank's contribution and the
        gradients are summed over the ranks (one all-reduce)."""
        params = [leaves(state["params"][n]) for n in names]
        flat = all_reduce_grads(torch.autograd.grad(loss, [p for ps in params for p in ps],
                                                    retain_graph=retain_graph, allow_unused=True))
        out, i = {}, 0
        for name, ps in zip(names, params):
            out[name] = list(flat[i : i + len(ps)])
            i += len(ps)
        return out

    def _train_step(self, state, loss, new_m, names) -> None:
        grads = self._grads(loss, state, names)
        self._apply_updates(state, names, grads)
        state["mstate"] = detached(new_m)

    def _steplr(self, state: Dict, name: str, count: int) -> None:
        """Write module ``name``'s torch StepLR value after ``count``
        scheduler steps into its optimizer."""
        o = self.config.optim
        step, gamma = o.steplr_step, o.steplr_gamma
        if name == "noise":
            step, gamma = o.noise_steplr_step, o.noise_steplr_gamma
        elif name == "cpc":
            gamma = o.cpc_steplr_gamma
        self._set_module_lr(state, name, step_lr(self.base_lr[name], count, step, gamma))

    def _step_steplr(self, state: Dict, names: Sequence[str]) -> None:
        """Increment the modules' scheduler counters and refresh their LRs."""
        for n in names:
            state["sched"][n] += 1
            self._steplr(state, n, state["sched"][n])
