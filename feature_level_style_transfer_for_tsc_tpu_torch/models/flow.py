"""Simplified-WaveGlow normalizing flow: the style-transfer engine.

Counterpart of the JAX package's ``models/flow.py`` (reference
``Simplified_NF_WaveGlow.py``):

* ``inv1x1_*``   invertible 1x1 channel mixing, a random rotation with det +1
  at init; ``slogdet`` for the log-determinant and the inverse taken from
  the current weight on every call (the JAX package's documented fixes of
  the reference's ``torch.logdet`` and stale ``W_inverse``);
* ``wn_*``       the WaveNet coupling net: weight-normed start, L dilated
  kernel-3 convs (dilation 2^i) with the tanh*sigmoid gate, res/skip 1x1s,
  zero-init end; the cond layer reads the same input as the main branch;
* ``waveglow_*`` n_flows of (inv1x1 -> split -> affine coupling), density and
  synthesis directions, and the NLL.

``wn_apply`` routes the coupling net as the JAX package does, by its own
switches, read per call:

* by default (``FLSTTSC_WN_FUSED`` unset or 1) through
  ``ops.wn_fused.WNCore``, the whole net in the fused kernels;
* with ``FLSTTSC_WN_FUSED=0``, or with a ``dilated_conv=`` override, op by
  op: per layer a dilated conv (``_dilated_conv_same``, formulated as
  ``FLSTTSC_CONV_IMPL`` says: ``conv``, ``im2col`` or ``pallas``, the last
  the tap-conv kernel) and the gate (``ops.gate``, its kernel).

Either way a CUDA tensor runs the hand-written kernels of its route and a
CPU tensor their plain PyTorch versions.  Both routes run under
``torch.func.vmap`` over K runs (``train/multirun.py``): the kernels'
Functions take the runs through their vmap rules (``WNCore``; ``GateCore``,
``TapConvCore``).  Layout (B, T, C), channel split
along the last axis.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.collectives import data_group, rank_and_size
from ..ops.coupling import affine_coupling_forward, affine_coupling_inverse
from ..ops.gate import fused_add_tanh_sigmoid_multiply
from ..ops.osconv import _conv_im2col, conv_impl, tap_conv
from ..ops.wn_fused import wn_apply_fused
from .common import conv1x1, uniform, weight_norm_init, weight_norm_weight


# --------------------------------------------------------------- inv 1x1 ---

def inv1x1_init(generator: torch.Generator, channels: int, device="cpu") -> Dict:
    """Random orthonormal W with det +1 via QR (reference :17-22)."""
    w = np.linalg.qr(torch.randn(channels, channels, generator=generator).double().numpy())[0]
    if np.linalg.det(w) < 0:
        w[:, 0] = -w[:, 0]
    return {"weight": torch.as_tensor(w, dtype=torch.float32, device=device)}


def inv1x1_forward(params: Dict, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (z @ W.T, B*T*log|det W|)."""
    w = params["weight"]
    b, t, _ = z.shape
    _, logdet = torch.linalg.slogdet(w)
    return z @ w.T, b * t * logdet


def inv1x1_inverse(params: Dict, z: torch.Tensor) -> torch.Tensor:
    return z @ torch.linalg.inv(params["weight"]).T


# --------------------------------------------------------------------- WN --

def wn_init(generator: torch.Generator, n_in_channels: int, n_layers: int, n_channels: int,
            device="cpu") -> Dict:
    """Weight-normed start/cond/in/res-skip layers (kernel 3) with
    torch-default biases; the end conv is zero so each coupling starts as the
    identity (reference :75-78)."""
    params: Dict = {
        "start": weight_norm_init(generator, (1, n_in_channels, n_channels), device),
        "cond": weight_norm_init(generator, (1, n_in_channels, 2 * n_channels * n_layers), device),
        "end": {
            "weight": torch.zeros(n_channels, 2 * n_in_channels, device=device),
            "bias": torch.zeros(2 * n_in_channels, device=device),
        },
        "in_layers": [],
        "res_skip_layers": [],
    }
    bound_start = 1.0 / np.sqrt(n_in_channels)
    params["start"]["bias"] = uniform((n_channels,), bound_start, generator, device)
    params["cond"]["bias"] = uniform((2 * n_channels * n_layers,), bound_start, generator, device)
    in_bound = 1.0 / np.sqrt(n_channels * 3)
    bound_rs = 1.0 / np.sqrt(n_channels)
    for i in range(n_layers):
        res_skip_ch = 2 * n_channels if i < n_layers - 1 else n_channels
        layer = weight_norm_init(generator, (3, n_channels, 2 * n_channels), device)
        layer["bias"] = uniform((2 * n_channels,), in_bound, generator, device)
        params["in_layers"].append(layer)
        rs = weight_norm_init(generator, (1, n_channels, res_skip_ch), device)
        rs["bias"] = uniform((res_skip_ch,), bound_rs, generator, device)
        params["res_skip_layers"].append(rs)
    return params


def _dilated_conv_same(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       dilation: int) -> torch.Tensor:
    """Kernel-k dilated "same" conv, channel-last (B, T, C_in) -> (B, T, C_out)
    with w (k, C_in, C_out), formulated as ``conv_impl()`` says:

    * "pallas": ``ops.osconv.tap_conv``, the tap-conv kernel on CUDA;
    * "im2col": unfold + one einsum;
    * "conv": ``F.conv1d`` with ``dilation`` (a library conv, as the JAX
      package leaves this one to XLA)."""
    k = w.shape[0]
    pad = (k * dilation - dilation) // 2
    impl = conv_impl()
    if impl in ("pallas", "im2col"):
        x_pad = F.pad(x, (0, 0, pad, pad))
        conv = tap_conv if impl == "pallas" else _conv_im2col
        return conv(x_pad, w, dilation) + bias
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=pad, dilation=dilation)
    return y.transpose(1, 2) + bias


def wn_fused_enabled() -> bool:
    """The fused WN route (``WNCore``) unless ``FLSTTSC_WN_FUSED`` is 0; read
    per call, as in the JAX package."""
    return os.environ.get("FLSTTSC_WN_FUSED", "1") not in ("0", "false", "False")


def wn_apply(params: Dict, x: torch.Tensor, n_channels: int,
             dilated_conv: Optional[Callable] = None) -> torch.Tensor:
    """The coupling net x (B, T, n_half) -> (B, T, 2*n_half).

    ``dilated_conv(x, w, bias, dilation)`` overrides the dilated-conv
    primitive (the JAX package's ``parallel/sequence.py`` passes a
    halo-exchange conv here) and takes the op-by-op route."""
    if dilated_conv is None:
        if wn_fused_enabled():
            return wn_apply_fused(params, x, weight_norm_weight)
        dilated_conv = _dilated_conv_same
    n_layers = len(params["in_layers"])
    audio = conv1x1(
        {"weight": weight_norm_weight(params["start"])[0], "bias": params["start"]["bias"]}, x
    )
    spect = conv1x1(
        {"weight": weight_norm_weight(params["cond"])[0], "bias": params["cond"]["bias"]}, x
    )
    output = torch.zeros_like(audio)
    for i in range(n_layers):
        w_in = weight_norm_weight(params["in_layers"][i])
        in_act = dilated_conv(audio, w_in, params["in_layers"][i]["bias"], 2 ** i)
        off = i * 2 * n_channels
        acts = fused_add_tanh_sigmoid_multiply(
            in_act, spect[..., off : off + 2 * n_channels], n_channels
        )
        w_rs = weight_norm_weight(params["res_skip_layers"][i])[0]
        res_skip = acts @ w_rs + params["res_skip_layers"][i]["bias"]
        if i < n_layers - 1:
            audio = audio + res_skip[..., :n_channels]
            output = output + res_skip[..., n_channels:]
        else:
            output = output + res_skip
    return output @ params["end"]["weight"] + params["end"]["bias"]


# --------------------------------------------------------------- WaveGlow --

def waveglow_init(generator: torch.Generator, n_flows: int, n_group: int,
                  n_channels_for_wn: int, n_wn_layers: int = 8, device="cpu") -> Dict:
    """Reference WaveGlow(n_flows, C_feat, 120) with an 8-layer WN (:125-146)."""
    if n_group % 2:
        raise ValueError(f"n_group must be even (reference :131), got {n_group}")
    convinv, wn = [], []
    for _ in range(n_flows):
        convinv.append(inv1x1_init(generator, n_group, device))
        wn.append(wn_init(generator, n_group // 2, n_wn_layers, n_channels_for_wn, device=device))
    return {"convinv": convinv, "wn": wn}


def _soft_clamp(log_s: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(log_s / cap)``; cap=0 disables (reference exact)."""
    return cap * torch.tanh(log_s / cap) if cap else log_s


def waveglow_forward(params: Dict, x: torch.Tensor, n_wn_ch: int, log_s_clamp: float = 0.0):
    """Density direction: features -> (z, log_s_list, log_det_w_list) (:148-181)."""
    log_s_list, log_det_w_list = [], []
    audio = x
    for k in range(len(params["convinv"])):
        audio, log_det_w = inv1x1_forward(params["convinv"][k], audio)
        log_det_w_list.append(log_det_w)
        n_half = audio.shape[-1] // 2
        audio_0, audio_1 = audio[..., :n_half], audio[..., n_half:]
        output = wn_apply(params["wn"][k], audio_0, n_wn_ch)
        b = output[..., :n_half]  # reference order: b first, log_s second (:172-173)
        log_s = _soft_clamp(output[..., n_half:], log_s_clamp)
        audio_1, _ = affine_coupling_forward(audio_1, log_s, b)
        log_s_list.append(log_s)
        audio = torch.cat([audio_0, audio_1], dim=-1)
    return audio, log_s_list, log_det_w_list


def waveglow_forward_pair(params: Dict, x_a: torch.Tensor, x_b: torch.Tensor, n_wn_ch: int,
                          log_s_clamp: float = 0.0):
    """The density direction on two batches in one pass (the flow is
    per-sample), with each batch's share of the log-determinants."""
    ba, bb = x_a.shape[0], x_b.shape[0]
    z, log_s_list, log_det_list = waveglow_forward(
        params, torch.cat([x_a, x_b], dim=0), n_wn_ch, log_s_clamp
    )
    return (
        (z[:ba], [ls[:ba] for ls in log_s_list], [ld * (ba / (ba + bb)) for ld in log_det_list]),
        (z[ba:], [ls[ba:] for ls in log_s_list], [ld * (bb / (ba + bb)) for ld in log_det_list]),
    )


def waveglow_infer(params: Dict, noise: torch.Tensor, n_wn_ch: int,
                   log_s_clamp: float = 0.0) -> torch.Tensor:
    """Synthesis direction: noise -> features (reference :183-203)."""
    audio = noise
    for k in reversed(range(len(params["convinv"]))):
        n_half = audio.shape[-1] // 2
        audio_0, audio_1 = audio[..., :n_half], audio[..., n_half:]
        output = wn_apply(params["wn"][k], audio_0, n_wn_ch)
        b = output[..., :n_half]
        s = _soft_clamp(output[..., n_half:], log_s_clamp)
        audio_1 = affine_coupling_inverse(audio_1, s, b)
        audio = inv1x1_inverse(params["convinv"][k], torch.cat([audio_0, audio_1], dim=-1))
    return audio


def waveglow_loss(model_output, sigma: float = 1.0) -> torch.Tensor:
    """WaveGlow NLL (reference WaveGlowLoss, :223-241).  Under a
    data-parallel group, the rank's contribution: its rows' terms (the
    log-determinants are its rows' share) over the global element count."""
    z, log_s_list, log_det_w_list = model_output
    log_s_total = sum(torch.sum(ls) for ls in log_s_list)
    log_det_w_total = sum(log_det_w_list)
    loss = torch.sum(z * z) / (2 * sigma * sigma) - log_s_total - log_det_w_total
    group = data_group()
    rows = z.shape[0] if group is None else z.shape[0] * rank_and_size(group)[1]
    return loss / (rows * z.shape[1] * z.shape[2])
