"""Standalone OS-CNN classifier trainer (extractor + classifier + CPC).

Counterpart of the JAX package's ``train/classifier.py``
``OSCNNClassifier``: the reference's target-pretraining slice as a
reusable trainer (``train_and_test.py:141-180``), an ``OS_CNN_res``
feature extractor feeding an ``OS_CNN`` classifier with cross-entropy plus,
with ``with_cpc``, the CPC self-supervised loss; RMSprop(1e-3 / 3e-3) +
Adam(2e-3) with StepLR(25, 0.8 / 0.7).  Ensemble members (serving, the
vote) are this model without CPC.

PyTorch idiom inside, as in ``train/pipeline.py``: an epoch is a Python
loop over stacked batches, one torch optimizer per module steps the leaf
tensors in place (``steps.ModuleSteps``), and the epoch's losses are read
from the device once, at its end.  The CPC anchors come from the state's
``torch.Generator`` unless given.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.batching import epoch_batches
from ..losses.classification import cross_entropy
from ..models.cpc import cpc_apply, cpc_init, draw_anchor
from ..models.os_cnn import (
    os_block_apply,
    os_block_masks,
    os_cnn_apply,
    os_cnn_head,
    os_cnn_init,
    os_cnn_res_apply,
    os_cnn_res_init,
)
from ..ops import resolve_device
from ..ops.collectives import reduce_values
from ..structure import (
    LayerSpec,
    default_parameter_budgets,
    generate_layer_parameter_list,
    layer_parameter_list_input_change,
    receptive_field,
    total_out_channels,
)
from .optim import make_adam, make_rmsprop
from .steps import ModuleSteps, batched_argmax, leaves


def build_specs(
    in_channels: int, time_length: int, config: PipelineConfig
) -> Tuple[List[LayerSpec], List[LayerSpec]]:
    """(extractor specs, classifier specs) of one target-shaped model
    (reference train_and_test.py:38-67)."""
    budgets = [int(b * config.budget_multiplier) for b in default_parameter_budgets(in_channels)]
    rf = receptive_field(time_length, config.max_kernel_size)
    return specs_for_rf(in_channels, rf, budgets)


def specs_for_rf(in_channels: int, rf: int, budgets: List[int]) -> Tuple[List[LayerSpec], List[LayerSpec]]:
    """(extractor specs, classifier specs) for receptive field ``rf``."""
    ext_specs = generate_layer_parameter_list(1, rf, budgets, in_channels)
    cls_specs = layer_parameter_list_input_change(ext_specs, total_out_channels(ext_specs[-1]))
    return ext_specs, cls_specs


def training_state(models: Dict, optimizers: Dict, generator: torch.Generator) -> Dict:
    """``models`` (params, mstate) plus what training carries: one
    optimizer per module (``optimizers``: name -> factory over the module's
    tensors, made leaves that require grad), the epoch counter and the
    generator of CPC anchors, seeded from a draw of ``generator``."""
    params = models["params"]
    for p in leaves(params):
        p.requires_grad_(True)
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    return {
        "params": params,
        "mstate": models["mstate"],
        "opt": {name: make(leaves(params[name])) for name, make in optimizers.items()},
        "epoch": 0,
        "generator": torch.Generator().manual_seed(seed),
    }


class OSCNNClassifier(ModuleSteps):
    """Static model definition + train/eval functions on ``device``."""

    def __init__(
        self,
        in_channels: int,
        time_length: int,
        num_class: int,
        config: Optional[PipelineConfig] = None,
        with_cpc: bool = True,
        device="cuda",
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self.in_channels = in_channels
        self.time_length = time_length
        self.num_class = num_class
        self.with_cpc = with_cpc
        self.ext_specs, self.cls_specs = build_specs(in_channels, time_length, self.config)
        self.feature_channels = total_out_channels(self.ext_specs[-1])
        self.ext_masks = os_block_masks(self.ext_specs, self.device)
        self.cls_masks = os_block_masks(self.cls_specs, self.device)
        o = self.config.optim
        self.base_lr = {"ext": o.lr_target_ext, "cls": o.lr_target_cls, "cpc": o.lr_cpc}
        self.modules = ("ext", "cls", "cpc") if with_cpc else ("ext", "cls")

    # ------------------------------------------------------------- state --

    def init_models(self, generator: torch.Generator) -> Dict:
        """Params and model state (BatchNorm statistics) under the JAX
        package's keys; ``params['cpc']`` with ``with_cpc``."""
        ext_p, ext_s = os_cnn_res_init(generator, self.ext_specs, self.device)
        cls_p, cls_s = os_cnn_init(generator, self.cls_specs, self.num_class, self.device)
        params = {"ext": ext_p, "cls": cls_p}
        if self.with_cpc:
            params["cpc"] = cpc_init(generator, self.feature_channels, self.config.cpc_hidden,
                                     self.time_length // 2, self.device)
        return {"params": params, "mstate": {"ext": ext_s, "cls": cls_s}}

    def init_state(self, generator: torch.Generator) -> Dict:
        """``init_models`` plus RMSprop for ``ext`` and ``cls``, Adam for
        ``cpc``, the epoch counter and the generator of CPC anchors."""
        make = {"ext": make_rmsprop, "cls": make_rmsprop, "cpc": make_adam}
        optimizers = {n: (lambda ps, n=n: make[n](ps, self.base_lr[n])) for n in self.modules}
        return training_state(self.init_models(generator), optimizers, generator)

    # ----------------------------------------------------------- forward --

    def forward(self, params, mstate, x: torch.Tensor, training: bool):
        """(logits, pooled, feat, new_mstate)."""
        feat, ext_s = os_cnn_res_apply(params["ext"], mstate["ext"], self.ext_masks, x, training)
        logits, pooled, cls_s = os_cnn_apply(params["cls"], mstate["cls"], self.cls_masks, feat,
                                             training)
        return logits, pooled, feat, {"ext": ext_s, "cls": cls_s}

    # -------------------------------------------------------- train step --

    def train_epoch(self, state: Dict, xb, yb,
                    cpc_anchors: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
        """One epoch over stacked batches (nb, B, T, C): CE (+ CPC at an
        anchor drawn from the state's generator, or ``cpc_anchors[i]`` for
        batch i), one step of each module's optimizer, then StepLR; returns
        the epoch means of ``c_loss`` and ``sl_loss`` (device tensors)."""
        xb = torch.as_tensor(xb).to(self.device)  # one copy an epoch
        yb = torch.as_tensor(yb).to(self.device, torch.long)
        c_losses, sl_losses = [], []
        for i, (x, y) in enumerate(zip(xb, yb)):
            params = state["params"]
            logits, _, feat, new_m = self.forward(params, state["mstate"], x, True)
            c_loss = cross_entropy(logits, y)
            if self.with_cpc:
                anchor = (draw_anchor(params["cpc"], state["generator"]) if cpc_anchors is None
                          else cpc_anchors[i])
                sl_loss = cpc_apply(params["cpc"], feat, anchor)
            else:
                sl_loss = torch.zeros((), device=self.device)
            self._train_step(state, c_loss + sl_loss, new_m, self.modules)
            c_losses.append(c_loss.detach())
            sl_losses.append(sl_loss.detach())
        state["epoch"] += 1
        for name in self.modules:  # StepLR per epoch (reference :97-107,131-134)
            self._steplr(state, name, state["epoch"])
        return reduce_values({"c_loss": torch.stack(c_losses).mean(),
                              "sl_loss": torch.stack(sl_losses).mean()})

    # --------------------------------------------------------------- eval --

    @torch.inference_mode()
    def predict_logits(self, params, mstate, x) -> torch.Tensor:
        """No-grad serving forward with the folded-BN conv epilogue."""
        return self.predict_head(params, self.predict_block(params, mstate, x))

    @torch.inference_mode()
    def predict_block(self, params, mstate, x) -> torch.Tensor:
        """``predict_logits`` up to the classifier block's output (B, T, C):
        every conv of the model, before the time pool and the head."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        feat, _ = os_cnn_res_apply(params["ext"], mstate["ext"], self.ext_masks, x, False,
                                   fused_infer=True)
        y, _ = os_block_apply(params["cls"]["block"], mstate["cls"]["block"], self.cls_masks,
                              feat, False, fused_infer=True)
        return y

    @torch.inference_mode()
    def predict_head(self, params, y: torch.Tensor) -> torch.Tensor:
        """The rest of ``predict_logits``: the classifier's time pool and
        linear head on ``predict_block``'s output."""
        return os_cnn_head(params["cls"], torch.mean(y, dim=1))

    def evaluate(self, state: Dict, x: np.ndarray, y: np.ndarray, batch_size: int = 0) -> float:
        """Argmax accuracy over batches of ``batch_size`` (default the
        config's), the last one padded by repeating its last series."""
        pred = batched_argmax(self.predict_logits, state["params"], state["mstate"], x,
                              batch_size or self.config.batch_size, self.device)
        return float(np.mean(pred == y))

    # ----------------------------------------------------------------- fit --

    def fit(self, train_ds, test_ds=None, epochs: int = 0, log_every: int = 1,
            verbose: bool = True):
        """Host-side epoch loop: init from ``seed``, shuffle from ``seed + 1``."""
        epochs = epochs or self.config.target_pretrain_epochs
        state = self.init_state(torch.Generator().manual_seed(self.config.seed))
        shuffle = torch.Generator().manual_seed(self.config.seed + 1)
        history = []
        for ep in range(epochs):
            xb, yb = epoch_batches(train_ds.x, train_ds.y, shuffle, self.config.batch_size)
            metrics = self.train_epoch(state, xb, yb)
            values = torch.stack(list(metrics.values())).tolist()  # one read an epoch
            rec = {"epoch": ep, **dict(zip(metrics, values))}
            if test_ds is not None and (ep % self.config.eval_every == 0 or ep == epochs - 1):
                rec["train_acc"] = self.evaluate(state, train_ds.x, train_ds.y)
                rec["test_acc"] = self.evaluate(state, test_ds.x, test_ds.y)
            history.append(rec)
            if verbose and ep % log_every == 0:
                print(rec)
        return state, history
