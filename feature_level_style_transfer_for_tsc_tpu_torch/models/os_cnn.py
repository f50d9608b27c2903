"""OS-CNN model family in eval mode: omni-scale classifier and residual extractor.

Counterpart of the JAX package's ``models/os_cnn.py`` for serving
(reference ``OS_CNN/OS_CNN.py:44-220``):

* ``os_block_*``   — stack of masked omni-scale conv layers, each
                     conv -> BatchNorm -> (ReLU except optionally the last);
* ``os_cnn_*``     — OS block (all-ReLU) -> mean over time -> Linear head;
                     returns (logits, pooled_feature);
* ``os_cnn_res_*`` — single residual layer: ReLU(OS block(x) + Conv1x1BN(x)),
                     the feature extractor trunk.

Layout: (B, T, C).  Each module is a (params, state) pair of nested
dictionaries with the JAX package's keys; state carries the BatchNorm
running statistics.  Only eval mode is here: the apply functions normalize
with the running statistics and return no new state.  ``fused_infer=True``
folds each BatchNorm into a scale/shift epilogue of the conv (no-grad
inference path); ``FLSTTSC_FUSE_EPILOGUE=1`` then runs that epilogue inside
the conv kernel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..ops.batchnorm import batch_norm_eval, init_bn_stats
from ..ops.osconv import build_os_mask, init_os_conv_params, masked_os_conv
from ..structure import LayerSpec, total_out_channels
from .common import conv1x1, conv1x1_init, linear, linear_init


# ----------------------------------------------------------- one OS layer --

def os_layer_init(generator: torch.Generator, layer_spec: LayerSpec, device="cpu") -> Tuple[Dict, Dict]:
    out_ch = total_out_channels(layer_spec)
    params = {
        "conv": init_os_conv_params(generator, layer_spec, device),
        "bn_scale": torch.ones(out_ch, device=device),
        "bn_bias": torch.zeros(out_ch, device=device),
    }
    return params, {"bn": init_bn_stats(out_ch, device)}


def os_layer_apply(
    params: Dict,
    state: Dict,
    mask: torch.Tensor,
    x: torch.Tensor,
    relu: bool,
    fused_infer: bool = False,
) -> torch.Tensor:
    conv, st = params["conv"], state["bn"]
    if fused_infer:
        inv_scale = params["bn_scale"] * torch.rsqrt(st.var + 1e-5)
        return masked_os_conv(
            x, conv["weight"], conv["bias"], mask,
            scale=inv_scale, shift=params["bn_bias"] - st.mean * inv_scale, relu=relu,
        )
    y = masked_os_conv(x, conv["weight"], conv["bias"], mask)
    y = batch_norm_eval(y, params["bn_scale"], params["bn_bias"], st)
    return torch.relu(y) if relu else y


# -------------------------------------------------------------- OS block ---

def os_block_masks(layer_specs: List[LayerSpec], device="cpu") -> List[torch.Tensor]:
    """Static masks, one per layer; kept out of params (never trained)."""
    return [torch.from_numpy(build_os_mask(spec)).to(device) for spec in layer_specs]


def os_block_init(generator: torch.Generator, layer_specs: List[LayerSpec], device="cpu") -> Tuple[Dict, Dict]:
    layers = [os_layer_init(generator, spec, device) for spec in layer_specs]
    return {"layers": [p for p, _ in layers]}, {"layers": [s for _, s in layers]}


def os_block_apply(
    params: Dict,
    state: Dict,
    masks: List[torch.Tensor],
    x: torch.Tensor,
    relu_at_last: bool = True,
    fused_infer: bool = False,
) -> torch.Tensor:
    n = len(masks)
    for i, (p, s, m) in enumerate(zip(params["layers"], state["layers"], masks)):
        relu = True if i < n - 1 else relu_at_last
        x = os_layer_apply(p, s, m, x, relu, fused_infer)
    return x


# ------------------------------------------------------- OS_CNN classifier -

def os_cnn_init(generator: torch.Generator, layer_specs: List[LayerSpec], n_class: int, device="cpu") -> Tuple[Dict, Dict]:
    block_p, block_s = os_block_init(generator, layer_specs, device)
    out_ch = total_out_channels(layer_specs[-1])
    return (
        {"block": block_p, "hidden": linear_init(generator, out_ch, n_class, device)},
        {"block": block_s},
    )


def os_cnn_apply(
    params: Dict,
    state: Dict,
    masks: List[torch.Tensor],
    x: torch.Tensor,
    few_shot: bool = False,
    fused_infer: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, pooled_feature) — reference OS_CNN.forward.

    ``few_shot=True`` skips the Linear head and returns the pooled feature
    in both slots (reference OS_CNN.py:82,106-108).
    """
    y = os_block_apply(params["block"], state["block"], masks, x, True, fused_infer)
    pooled = torch.mean(y, dim=1)  # AdaptiveAvgPool1d(1) over time
    logits = pooled if few_shot else linear(params["hidden"], pooled)
    return logits, pooled


# -------------------------------------------- OS_CNN_res feature extractor -

def os_cnn_res_init(generator: torch.Generator, layer_specs: List[LayerSpec], device="cpu") -> Tuple[Dict, Dict]:
    block_p, block_s = os_block_init(generator, layer_specs, device)
    out_ch = total_out_channels(layer_specs[-1])
    in_ch = layer_specs[0][0][0]
    params = {
        "block": block_p,
        "res": conv1x1_init(generator, in_ch, out_ch, device=device),
        "res_bn_scale": torch.ones(out_ch, device=device),
        "res_bn_bias": torch.zeros(out_ch, device=device),
    }
    return params, {"block": block_s, "res_bn": init_bn_stats(out_ch, device)}


def os_cnn_res_apply(
    params: Dict,
    state: Dict,
    masks: List[torch.Tensor],
    x: torch.Tensor,
    fused_infer: bool = False,
) -> torch.Tensor:
    """ReLU(OS_block(x, no final relu) + BN(Conv1x1(x))) — Res_OS_layer."""
    main = os_block_apply(
        params["block"], state["block"], masks, x, relu_at_last=False, fused_infer=fused_infer
    )
    shortcut = batch_norm_eval(
        conv1x1(params["res"], x), params["res_bn_scale"], params["res_bn_bias"], state["res_bn"]
    )
    return torch.relu(main + shortcut)
