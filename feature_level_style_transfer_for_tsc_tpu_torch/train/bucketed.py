"""Bucketed OS-CNN trainer: one model per shape bucket.

Counterpart of the JAX package's ``train/bucketed.py``.  Datasets are
grouped into buckets keyed by

    (C, receptive_field(T), T_bucket, class_bucket)

— the first two fix the ARCHITECTURE (the layer specs derive from C and
min(T//4, max_kernel); for the univariate archive every T >= 4*89 = 356
shares one architecture), the last two are padded shapes.  Within a bucket
the dataset's true T and n_class are data (masks and a float32 ``t_valid``),
so one ``BucketedOSCNNClassifier`` trains every dataset of its bucket, with
exact semantics through ``models/os_cnn_padded.py`` (padded == unpadded).

On the TPU a bucket saves a compile per dataset.  PyTorch compiles no
program per shape, so here a bucket buys the JAX package's semantics (the
same padded model, the same results file), not speed: every step runs at
the bucket's padded length, which costs time over the dataset's own.

The train step is per batch (the number of batches per epoch varies per
dataset), StepLR is stepped once an epoch (``_step_schedulers``), and the
epoch's loss is read from the device once, from its last batch.  CPC is not
offered on this path: its prediction horizon ``timestep = T//2`` sizes the
parameters themselves, which cannot be masked.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.batching import epoch_batches
from ..losses.classification import cross_entropy
from ..models.os_cnn import os_block_masks, os_cnn_init, os_cnn_res_init
from ..models.os_cnn_padded import (
    class_mask,
    os_cnn_apply_padded,
    os_cnn_res_apply_padded,
    time_mask,
)
from ..ops import resolve_device
from ..structure import default_parameter_budgets, receptive_field, total_out_channels
from .classifier import specs_for_rf, training_state
from .optim import make_rmsprop
from .steps import ModuleSteps, batched_argmax

MODULES = ("ext", "cls")


def bucket_t(t: int, granularity: float = 1.5, t_min: int = 64) -> int:
    """Smallest bucket length >= t from a geometric series (ratio 1.5)."""
    b = t_min
    while b < t:
        b = int(np.ceil(b * granularity))
    return b


def bucket_classes(n: int, step: int = 4) -> int:
    return max(step, -(-n // step) * step)


def bucket_key(
    in_channels: int, t: int, n_class: int, max_kernel_size: int = 89
) -> Tuple[int, int, int, int]:
    """(C, rf, T_bucket, class_bucket) — rf fixes the architecture."""
    return (
        in_channels,
        receptive_field(t, max_kernel_size),
        bucket_t(t),
        bucket_classes(n_class),
    )


class BucketedOSCNNClassifier(ModuleSteps):
    """OS-CNN classifier whose one model serves a whole bucket."""

    def __init__(
        self,
        in_channels: int,
        rf: int,
        t_bucket: int,
        class_bucket: int,
        config: Optional[PipelineConfig] = None,
        device="cuda",
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self.in_channels = in_channels
        self.rf = rf
        self.t_bucket = t_bucket
        self.class_bucket = class_bucket
        budgets = [
            int(b * self.config.budget_multiplier)
            for b in default_parameter_budgets(in_channels)
        ]
        self.ext_specs, self.cls_specs = specs_for_rf(in_channels, rf, budgets)
        self.feature_channels = total_out_channels(self.ext_specs[-1])
        self.ext_masks = os_block_masks(self.ext_specs, self.device)
        self.cls_masks = os_block_masks(self.cls_specs, self.device)
        o = self.config.optim
        self.base_lr = {"ext": o.lr_target_ext, "cls": o.lr_target_cls}

    @classmethod
    def for_dataset(cls, in_channels: int, t: int, n_class: int, config=None, device="cuda"):
        cfg = config or PipelineConfig()
        key = bucket_key(in_channels, t, n_class, cfg.max_kernel_size)
        return cls(*key, config=cfg, device=device)

    # -------------------------------------------------------------- state --

    def init_models(self, generator: torch.Generator) -> Dict:
        ext_p, ext_s = os_cnn_res_init(generator, self.ext_specs, self.device)
        cls_p, cls_s = os_cnn_init(generator, self.cls_specs, self.class_bucket, self.device)
        return {"params": {"ext": ext_p, "cls": cls_p}, "mstate": {"ext": ext_s, "cls": cls_s}}

    def init_state(self, generator: torch.Generator) -> Dict:
        optimizers = {n: (lambda ps, n=n: make_rmsprop(ps, self.base_lr[n])) for n in MODULES}
        return training_state(self.init_models(generator), optimizers, generator)

    def t_valid(self, t: int) -> torch.Tensor:
        """A dataset's true length as the float32 tensor the masks take."""
        return torch.tensor(float(t), device=self.device)

    def cmask(self, n_class: int) -> torch.Tensor:
        return class_mask(self.class_bucket, torch.tensor(n_class, device=self.device))

    # -------------------------------------------------------------- steps --

    def _forward(self, params, mstate, x, training, tmask, t_valid, cmask):
        feat, ext_s = os_cnn_res_apply_padded(
            params["ext"], mstate["ext"], self.ext_masks, x, training, tmask, t_valid
        )
        logits, pooled, cls_s = os_cnn_apply_padded(
            params["cls"], mstate["cls"], self.cls_masks, feat, training,
            tmask, t_valid, cmask,
        )
        return logits, pooled, {"ext": ext_s, "cls": cls_s}

    def train_batch(self, state: Dict, x, y, t_valid: torch.Tensor,
                    cmask: torch.Tensor) -> torch.Tensor:
        """One step of both modules on one padded batch; returns its CE."""
        x = torch.as_tensor(x).to(self.device)
        y = torch.as_tensor(y).to(self.device, torch.long)
        tmask = time_mask(self.t_bucket, t_valid)
        logits, _, new_m = self._forward(
            state["params"], state["mstate"], x, True, tmask, t_valid, cmask
        )
        ce = cross_entropy(logits, y)
        self._train_step(state, ce, new_m, MODULES)
        return ce.detach()

    def _step_schedulers(self, state: Dict) -> None:
        state["epoch"] += 1
        for name in MODULES:
            self._steplr(state, name, state["epoch"])

    @torch.inference_mode()
    def predict_logits(self, params, mstate, x, t_valid: torch.Tensor,
                       cmask: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        tmask = time_mask(self.t_bucket, t_valid)
        logits, _, _ = self._forward(params, mstate, x, False, tmask, t_valid, cmask)
        return logits

    # ---------------------------------------------------------------- fit --

    def _pad_x(self, x: np.ndarray) -> np.ndarray:
        pad = self.t_bucket - x.shape[1]
        assert pad >= 0, f"T={x.shape[1]} exceeds bucket {self.t_bucket}"
        return np.pad(x, ((0, 0), (0, pad), (0, 0))) if pad else x

    def fit(self, train_ds, test_ds=None, epochs: int = 0, verbose: bool = True):
        """Host-side epoch loop: init from ``seed``, shuffle from ``seed + 1``."""
        epochs = epochs or self.config.target_pretrain_epochs
        t_valid = self.t_valid(train_ds.time_length)
        cmask = self.cmask(train_ds.num_class)
        x_pad = self._pad_x(train_ds.x)
        state = self.init_state(torch.Generator().manual_seed(self.config.seed))
        shuffle = torch.Generator().manual_seed(self.config.seed + 1)
        history = []
        for ep in range(epochs):
            xb, yb = epoch_batches(x_pad, train_ds.y, shuffle, self.config.batch_size)
            xb = torch.as_tensor(xb).to(self.device)  # one copy an epoch
            yb = torch.as_tensor(yb).to(self.device)
            for x, y in zip(xb, yb):
                ce = self.train_batch(state, x, y, t_valid, cmask)
            self._step_schedulers(state)
            # one device read an epoch (the last batch's loss), not one a batch
            rec = {"epoch": ep, "c_loss": float(ce)}
            if test_ds is not None and (ep % self.config.eval_every == 0 or ep == epochs - 1):
                rec["test_acc"] = self.evaluate(state, test_ds.x, test_ds.y, train_ds.num_class)
            history.append(rec)
            if verbose:
                print(rec)
        return state, history

    def evaluate(self, state: Dict, x: np.ndarray, y: np.ndarray, n_class: int) -> float:
        t_valid, cmask = self.t_valid(x.shape[1]), self.cmask(n_class)

        def predict(params, mstate, xe):
            return self.predict_logits(params, mstate, xe, t_valid, cmask)

        pred = batched_argmax(predict, state["params"], state["mstate"], self._pad_x(x),
                              self.config.batch_size, self.device)
        return float(np.mean(pred == y))
