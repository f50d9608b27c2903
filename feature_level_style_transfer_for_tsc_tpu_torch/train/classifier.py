"""OS-CNN classifier (extractor + classifier), eval path for ensemble members.

Counterpart of the JAX package's ``train/classifier.py`` ``OSCNNClassifier``
(``forward`` and ``predict_logits``): an ``OS_CNN_res`` feature extractor
feeding an ``OS_CNN`` classifier (reference ``train_and_test.py:141-180``).
Training (the CPC loss, the optimizers, ``fit``) comes with the training
slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
from ..structure import (
    LayerSpec,
    default_parameter_budgets,
    generate_layer_parameter_list,
    layer_parameter_list_input_change,
    receptive_field,
    total_out_channels,
)


def build_specs(
    in_channels: int, time_length: int, config: PipelineConfig
) -> Tuple[List[LayerSpec], List[LayerSpec]]:
    """(extractor specs, classifier specs) of one target-shaped model
    (reference train_and_test.py:38-67)."""
    budgets = [int(b * config.budget_multiplier) for b in default_parameter_budgets(in_channels)]
    rf = receptive_field(time_length, config.max_kernel_size)
    ext_specs = generate_layer_parameter_list(1, rf, budgets, in_channels)
    cls_specs = layer_parameter_list_input_change(ext_specs, total_out_channels(ext_specs[-1]))
    return ext_specs, cls_specs


class OSCNNClassifier:
    """Static model definition + eval-mode forward on ``device``."""

    def __init__(
        self,
        in_channels: int,
        time_length: int,
        num_class: int,
        config: Optional[PipelineConfig] = None,
        device="cuda",
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self.num_class = num_class
        self.ext_specs, self.cls_specs = build_specs(in_channels, time_length, self.config)
        self.ext_masks = os_block_masks(self.ext_specs, self.device)
        self.cls_masks = os_block_masks(self.cls_specs, self.device)

    def init_state(self, generator: torch.Generator) -> Dict:
        ext_p, ext_s = os_cnn_res_init(generator, self.ext_specs, self.device)
        cls_p, cls_s = os_cnn_init(generator, self.cls_specs, self.num_class, self.device)
        return {"params": {"ext": ext_p, "cls": cls_p}, "mstate": {"ext": ext_s, "cls": cls_s}}

    def forward(self, params, mstate, x: torch.Tensor, fused_infer: bool = False):
        """(logits, pooled, feat) in eval mode."""
        feat = os_cnn_res_apply(
            params["ext"], mstate["ext"], self.ext_masks, x, fused_infer=fused_infer
        )
        logits, pooled = os_cnn_apply(
            params["cls"], mstate["cls"], self.cls_masks, feat, fused_infer=fused_infer
        )
        return logits, pooled, feat

    @torch.inference_mode()
    def predict_logits(self, params, mstate, x) -> torch.Tensor:
        """No-grad serving forward with the folded-BN conv epilogue."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        logits, _, _ = self.forward(params, mstate, x, fused_infer=True)
        return logits
