"""The serving part of the style-transfer pipeline: the target model's predictions.

Counterpart of the JAX package's ``train/pipeline.py`` ``StyleTransferPipeline``
for serving only: the target extractor ``t_ext`` (OS_CNN_res) and the target
classifier ``t_cls`` (OS_CNN), their specs and masks built as in the
pipeline's constructor, ``target_features``/``classify_target``, the
no-grad ``_predict_target`` and the batched ``predict_target``.  The source
side, the flow, the critics and the five training phases come with the
training slice.

A state is ``{"params": {"t_ext", "t_cls"}, "mstate": {"t_ext", "t_cls"}}``
under the JAX package's keys, so a training checkpoint of either package
restores into it (``io/checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..models.os_cnn import (
    os_block_masks,
    os_cnn_apply,
    os_cnn_init,
    os_cnn_res_apply,
    os_cnn_res_init,
)
from ..ops import resolve_device
from .classifier import build_specs

#: checkpoint key prefixes of the target model within a full pipeline state
TARGET_PREFIXES = (
    "['params']['t_ext']", "['params']['t_cls']",
    "['mstate']['t_ext']", "['mstate']['t_cls']",
)


class TargetPredictor:
    """The target extractor + classifier of a pipeline, served on ``device``."""

    def __init__(
        self,
        target_channels: int,
        target_length: int,
        target_classes: int,
        config: Optional[PipelineConfig] = None,
        device="cuda",
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self.t_shape = (target_channels, target_length, target_classes)
        self.t_ext_specs, self.cls_specs = build_specs(
            target_channels, target_length, self.config
        )
        self.t_ext_masks = os_block_masks(self.t_ext_specs, self.device)
        self.cls_masks = os_block_masks(self.cls_specs, self.device)

    def init_state(self, generator: torch.Generator) -> Dict:
        t_ext_p, t_ext_s = os_cnn_res_init(generator, self.t_ext_specs, self.device)
        t_cls_p, t_cls_s = os_cnn_init(generator, self.cls_specs, self.t_shape[2], self.device)
        return {
            "params": {"t_ext": t_ext_p, "t_cls": t_cls_p},
            "mstate": {"t_ext": t_ext_s, "t_cls": t_cls_s},
        }

    def target_features(self, params, mstate, x, fused_infer: bool = False) -> torch.Tensor:
        return os_cnn_res_apply(
            params["t_ext"], mstate["t_ext"], self.t_ext_masks, x, fused_infer=fused_infer
        )

    def classify_target(self, params, mstate, feat, fused_infer: bool = False):
        """(logits, pooled)."""
        return os_cnn_apply(
            params["t_cls"], mstate["t_cls"], self.cls_masks, feat, fused_infer=fused_infer
        )

    @torch.inference_mode()
    def predict_logits(self, params, mstate, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's ``_predict_target``: no grad, so the folded-BN
        conv epilogue (and with ``FLSTTSC_FUSE_EPILOGUE=1`` the fused kernel)
        is safe."""
        feat = self.target_features(params, mstate, x, fused_infer=True)
        logits, _ = self.classify_target(params, mstate, feat, fused_infer=True)
        return logits

    def predict_target(self, state: Dict, x: np.ndarray) -> np.ndarray:
        """Argmax class predictions in fixed-size batches of
        ``config.batch_size``; the last batch is padded by repeating its
        last series, and the padded rows are dropped (the JAX package's
        ``_batched_predictions``)."""
        bs = self.config.batch_size
        xs = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        n = xs.shape[0]
        preds = []
        for i in range(0, n, bs):
            xe = xs[i : i + bs]
            pad = bs - xe.shape[0]
            if pad:
                xe = torch.cat([xe, xe[-1:].expand(pad, *xe.shape[1:])], 0)
            logits = self.predict_logits(state["params"], state["mstate"], xe)
            preds.append(torch.argmax(logits, -1)[: bs - pad])
        return torch.cat(preds).cpu().numpy()
