"""Padded-shape OS-CNN: exact semantics on time/class-padded inputs.

Counterpart of the JAX package's ``models/os_cnn_padded.py``.  These
variants run the SAME math as ``models/os_cnn.py`` on inputs padded to a
bucket shape, with the dataset's true sizes passed as tensors (masks and a
float32 ``t_valid``), so that every dataset of a bucket runs one model:

* the input is zero beyond ``t_valid`` and every layer re-zeroes positions
  ``>= t_valid``, so each conv sees exactly the reference's zero "same"
  padding at the true sequence end (OS_CNN.py:59);
* BatchNorm statistics are sums over the ``B * t_valid`` valid positions,
  identical to the unpadded batch statistics; ``n_valid`` is a float32
  tensor, as the JAX package's traced scalar is, so the unbiased factor
  ``n / (n - 1)`` is float32 arithmetic on both sides;
* the average pool divides by ``t_valid``, not the padded length;
* padded class logits are pinned to -1e9: cross-entropy and argmax match
  the unpadded head exactly (to f32).

The conv is ``ops.osconv.masked_os_conv``: the ``os_conv_fwd`` kernel on a
CUDA tensor at the bucket's length.  A bucket's architecture must match the
dataset's: the layer specs derive from (C, receptive_field(T)).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..ops.batchnorm import BNStats
from ..ops.osconv import masked_os_conv
from .common import conv1x1, linear


def time_mask(t_bucket: int, t_valid: torch.Tensor) -> torch.Tensor:
    """(t_bucket, 1) float mask of the valid time steps."""
    steps = torch.arange(t_bucket, device=t_valid.device)[:, None]
    return (steps < t_valid).to(torch.float32)


def class_mask(c_bucket: int, c_valid: torch.Tensor) -> torch.Tensor:
    return (torch.arange(c_bucket, device=c_valid.device) < c_valid).to(torch.float32)


def masked_batch_norm(
    x: torch.Tensor,  # (B, T_bucket, C), zero beyond the mask
    scale: torch.Tensor,
    bias: torch.Tensor,
    stats: BNStats,
    training: bool,
    tmask: torch.Tensor,  # (T_bucket, 1)
    n_valid: torch.Tensor,  # float32 scalar: B * t_valid
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, BNStats]:
    """Torch-parity BN whose batch statistics span only valid positions."""
    if training:
        # x is already zero at masked positions, so plain sums are masked sums
        mean = torch.sum(x, dim=(0, 1)) / n_valid
        var = torch.sum(torch.square(x - mean) * tmask, dim=(0, 1)) / n_valid
        unbiased = var * (n_valid / torch.clamp(n_valid - 1, min=1))
        new_stats = BNStats(
            (1 - momentum) * stats.mean + momentum * mean,
            (1 - momentum) * stats.var + momentum * unbiased,
        )
        use_mean, use_var = mean, var
    else:
        new_stats = stats
        use_mean, use_var = stats.mean, stats.var
    inv = torch.rsqrt(use_var + eps)
    return (x - use_mean) * (inv * scale) + bias, new_stats


def os_block_apply_padded(
    params: Dict,
    state: Dict,
    masks: List[torch.Tensor],
    x: torch.Tensor,
    training: bool,
    tmask: torch.Tensor,
    t_valid: torch.Tensor,
    relu_at_last: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    n_valid = x.shape[0] * t_valid
    new_states = []
    n = len(masks)
    for i, (p, s, m) in enumerate(zip(params["layers"], state["layers"], masks)):
        # mask BEFORE BN: the conv output is nonzero in the pad region (bias
        # everywhere + taps reading the valid boundary), and masked_batch_norm
        # assumes zeros there
        y = masked_os_conv(x, p["conv"]["weight"], p["conv"]["bias"], m) * tmask
        y, new_bn = masked_batch_norm(
            y, p["bn_scale"], p["bn_bias"], s["bn"], training, tmask, n_valid
        )
        if i < n - 1 or relu_at_last:
            y = torch.relu(y)
        x = y * tmask  # re-zero the pad so the next conv sees "same" padding
        new_states.append({"bn": new_bn})
    return x, {"layers": new_states}


def os_cnn_apply_padded(
    params: Dict,
    state: Dict,
    masks: List[torch.Tensor],
    x: torch.Tensor,
    training: bool,
    tmask: torch.Tensor,
    t_valid: torch.Tensor,
    cmask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Classifier on padded shapes; padded class logits pinned to -1e9."""
    y, new_block = os_block_apply_padded(
        params["block"], state["block"], masks, x, training, tmask, t_valid, True
    )
    pooled = torch.sum(y, dim=1) / t_valid  # masked AdaptiveAvgPool1d(1)
    logits = linear(params["hidden"], pooled)
    logits = logits * cmask + (cmask - 1.0) * 1e9
    return logits, pooled, {"block": new_block}


def os_cnn_res_apply_padded(
    params: Dict,
    state: Dict,
    masks: List[torch.Tensor],
    x: torch.Tensor,
    training: bool,
    tmask: torch.Tensor,
    t_valid: torch.Tensor,
) -> Tuple[torch.Tensor, Dict]:
    n_valid = x.shape[0] * t_valid
    main, new_block = os_block_apply_padded(
        params["block"], state["block"], masks, x, training, tmask, t_valid,
        relu_at_last=False,
    )
    shortcut, new_res_bn = masked_batch_norm(
        conv1x1(params["res"], x) * tmask, params["res_bn_scale"], params["res_bn_bias"],
        state["res_bn"], training, tmask, n_valid,
    )
    return torch.relu(main + shortcut) * tmask, {"block": new_block, "res_bn": new_res_bn}
