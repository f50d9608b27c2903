"""Shared helpers of the comparison baselines.

Counterpart of the JAX package's ``baselines/common.py`` (Adam +
StepLR(25, 0.5), the reference's ``Comparison/`` optimizers), plus what both
port pipelines share: the target-derived OS-CNN specs, one optimizer step
over named modules, and the batched target evaluation.

PyTorch idiom inside, as in ``train/pipeline.py``: an epoch is a Python loop
over stacked batches, parameters are leaf tensors updated in place by torch
optimizers, and BatchNorm statistics are explicit state under the JAX
package's keys.  The learning rate is written into the optimizer after each
epoch (``set_lr``), so a new one applies from the next epoch, as the JAX
package's ``inject_hyperparams`` learning rate does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..models.os_cnn import os_block_masks, os_cnn_apply, os_cnn_res_apply
from ..ops import resolve_device
from ..structure import total_out_channels
from ..train.classifier import build_specs
from ..train.optim import make_adam
from ..train.steps import batched_argmax, leaves

LR = 2e-3  # every Comparison/ optimizer (CoDATS main.py:81-103, SLARDA train.py:149-187)


# The JAX package's name.  The StepLR part is not the optimizer's: each epoch
# writes ``steplr_value`` into it (``set_lr``).
make_adam_steplr = make_adam


def steplr_value(base_lr: float, count: int, step_size: int = 25, gamma: float = 0.5) -> float:
    """torch StepLR(step_size, gamma) value after ``count`` scheduler steps."""
    return base_lr * gamma ** (count // step_size)


class BaselinePipeline:
    """Target-shaped OS-CNN specs (both baselines build every extractor and
    classifier from the TARGET's shape), optimizer steps and evaluation."""

    #: the target extractor's and classifier's keys in params and mstate
    target_keys: Tuple[str, str] = ("ext", "t_cls")

    def __init__(self, target_shape, config: Optional[PipelineConfig], device):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self.target_shape = tuple(target_shape)
        c_t, t_t, _ = self.target_shape
        self.ext_specs, self.cls_specs = build_specs(c_t, t_t, self.config)
        self.feat_channels = total_out_channels(self.ext_specs[-1])
        self.ext_masks = os_block_masks(self.ext_specs, self.device)
        self.cls_masks = os_block_masks(self.cls_specs, self.device)
        self.lr = LR

    def _batch(self, a, dtype=torch.float32) -> torch.Tensor:
        """A host batch (numpy) on the pipeline's device."""
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

    # ---------------------------------------------------- optimizer steps --

    def _grads(self, loss: torch.Tensor, params: Dict, names: Sequence[str]) -> Dict[str, list]:
        """d loss / d params of each named module (None where unused)."""
        tensors = [leaves(params[n]) for n in names]
        flat = torch.autograd.grad(loss, [t for ts in tensors for t in ts], allow_unused=True)
        out, i = {}, 0
        for name, ts in zip(names, tensors):
            out[name] = list(flat[i : i + len(ts)])
            i += len(ts)
        return out

    def _apply_updates(self, opt: torch.optim.Optimizer, params: Dict, names: Sequence[str],
                       grads: Dict[str, list]) -> None:
        """One step of ``opt`` over the named modules; a parameter that got
        no gradient steps with zero, as in the JAX package."""
        for name in names:
            for p, g in zip(leaves(params[name]), grads[name]):
                p.grad = torch.zeros_like(p) if g is None else g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def _step(self, opt, params: Dict, names: Sequence[str], loss: torch.Tensor) -> None:
        self._apply_updates(opt, params, names, self._grads(loss, params, names))

    # --------------------------------------------------------------- eval --

    @torch.inference_mode()
    def predict_target(self, params: Dict, mstate: Dict, x: torch.Tensor) -> torch.Tensor:
        """Target logits in eval mode (running BatchNorm statistics)."""
        ext, cls = self.target_keys
        feat, _ = os_cnn_res_apply(params[ext], mstate[ext], self.ext_masks, x, False)
        logits, _, _ = os_cnn_apply(params[cls], mstate[cls], self.cls_masks, feat, False)
        return logits

    def evaluate_target(self, state: Dict, x: np.ndarray, y: np.ndarray) -> float:
        """Accuracy over ``config.batch_size`` batches; the last batch is
        padded by repeating its last series, and the padded rows dropped."""
        pred = batched_argmax(self.predict_target, state["params"], state["mstate"], x,
                              self.config.batch_size, self.device)
        return float(np.mean(pred == y))


def epoch_means(losses: Dict[str, list]) -> Dict[str, torch.Tensor]:
    """Each key's per-batch losses averaged over the epoch."""
    return {k: torch.stack(v).mean(0) for k, v in losses.items()}


def to_record(metrics: Dict[str, torch.Tensor]) -> Dict:
    """Metric tensors as floats (scalars) or lists, for a history record."""
    return {k: v.detach().cpu().numpy().tolist() for k, v in metrics.items()}
