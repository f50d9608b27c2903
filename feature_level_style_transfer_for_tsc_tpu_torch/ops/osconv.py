"""Masked omni-scale conv1d, the OS-CNN backbone op, with its CUDA kernels.

Counterpart of the JAX package's ``ops/osconv.py``.  The reference emulates
N parallel conv1d branches with different prime kernel sizes as ONE conv at
the layer's largest kernel size whose weight is multiplied by a centered
zero-mask on every forward (reference ``OS_CNN/OS_CNN.py:14-77``):

* channel-last layout ``x: (B, T, C_in) -> (B, T, C_out)``;
* weight layout ``(K, C_in, C_out)`` ("WIO"), mask ``(K, 1, C_out)``;
* "same" padding is asymmetric ``((K-1)//2, K//2)`` (reference OS_CNN.py:59).

The conv itself runs in one of two kernels of ``csrc/os_conv.cu`` on a CUDA
tensor, and in the plain PyTorch version beside each on a CPU tensor:

* ``os_conv`` (``os_conv_fwd``) replaces ``_os_conv_kernel``;
* ``os_conv_fused`` (``os_conv_fused_fwd``) replaces ``_os_conv_fused_kernel``:
  the folded eval-mode BatchNorm ``y*scale + shift`` and an optional ReLU are
  applied before the single store.  ``FLSTTSC_FUSE_EPILOGUE=1`` selects it
  on the no-grad inference path, read per call as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..structure import LayerSpec, mask_bounds
from . import _build, use_kernel

#: Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"os_conv_fwd": 0, "os_conv_fused_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_os_mask(layer_spec: LayerSpec) -> np.ndarray:
    """(K, 1, C_out) zero/one mask, one centered band per branch.

    Parity with reference ``creat_mask``/``creak_layer_mask``
    (OS_CNN.py:15-41): branch b with kernel size k keeps taps
    ``[left, left+k)`` where left/right come from ``calculate_mask_index``.
    """
    largest = layer_spec[-1][-1]
    cols = []
    for (_, out_ch, k) in layer_spec:
        band = np.zeros((largest, 1, out_ch), np.float32)
        lo, hi = mask_bounds(k, largest)
        band[lo:hi] = 1.0
        cols.append(band)
    return np.concatenate(cols, axis=-1)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def init_os_conv_params(
    generator: torch.Generator, layer_spec: LayerSpec, device="cpu"
) -> dict:
    """Kaiming-uniform init per branch placed into its mask band.

    Torch's Conv1d default: kaiming_uniform(a=sqrt(5)) for the weight and
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the bias (reference
    OS_CNN.py:26-41).  Drawn on the CPU from ``generator``, then moved.
    """
    largest = layer_spec[-1][-1]
    in_ch = layer_spec[0][0]
    w_cols, b_cols = [], []
    for (_, out_ch, k) in layer_spec:
        fan_in = in_ch * k
        gain = np.sqrt(2.0 / (1 + 5.0))  # kaiming_uniform with a=sqrt(5)
        big = torch.zeros(largest, in_ch, out_ch)
        lo, hi = mask_bounds(k, largest)
        big[lo:hi] = _uniform((k, in_ch, out_ch), gain * np.sqrt(3.0 / fan_in), generator)
        w_cols.append(big)
        b_cols.append(_uniform((out_ch,), 1.0 / np.sqrt(fan_in), generator))
    return {
        "weight": torch.cat(w_cols, dim=-1).to(device),
        "bias": torch.cat(b_cols, dim=-1).to(device),
    }


def fuse_epilogue_in_kernel() -> bool:
    # read per call so tests and runs can flip it
    return os.environ.get("FLSTTSC_FUSE_EPILOGUE", "0") == "1"


# ------------------------------------------------------ plain versions ----

def os_conv_plain(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y[:, t] = sum_j x_pad[:, t+j] @ w[j]``: (B, T+K-1, C_in) -> (B, T, C_out)."""
    k = w.shape[0]
    t = x_pad.shape[1] - k + 1
    y = x_pad[:, :t] @ w[0]
    for j in range(1, k):
        y += x_pad[:, j : j + t] @ w[j]
    return y


def os_conv_fused_plain(
    x_pad: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    relu: bool,
) -> torch.Tensor:
    y = os_conv_plain(x_pad, w) * scale + shift
    return torch.relu(y) if relu else y


# ---------------------------------------------------- kernel wrappers -----

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/os_conv.cu``."""
    lib = _build.load("os_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.os_conv_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.os_conv_fwd.restype = i
    lib.os_conv_fused_fwd.argtypes = [p, p, p, p, i, p, i, i, i, i, i, p]
    lib.os_conv_fused_fwd.restype = i
    return lib


def _check_operands(x_pad: torch.Tensor, w: torch.Tensor, *vectors: torch.Tensor):
    """Shapes (B, t_pad, C_in), (K, C_in, C_out) and (C_out,) vectors, all
    contiguous float32 on x_pad's device; returns the output shape."""
    tensors = (x_pad, w) + vectors
    for t in tensors:
        if t.device != x_pad.device:
            raise ValueError(f"operands on {t.device} and {x_pad.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the os_conv kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the os_conv kernels take contiguous tensors")
    if x_pad.dim() != 3 or w.dim() != 3 or x_pad.shape[2] != w.shape[1]:
        raise ValueError(f"shapes {tuple(x_pad.shape)} and {tuple(w.shape)} do not chain")
    b, t_pad, _ = x_pad.shape
    k, _, c_out = w.shape
    if min(b, k, c_out, w.shape[1]) < 1 or t_pad < k or b > 65535:
        raise ValueError(f"unsupported shapes {tuple(x_pad.shape)}, {tuple(w.shape)}")
    for v in vectors:
        if v.shape != (c_out,):
            raise ValueError(f"epilogue vector of shape {tuple(v.shape)}, want ({c_out},)")
    return (b, t_pad - k + 1, c_out)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def os_conv(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID conv ``sum_j x_pad[:, t+j] @ w[j]``; kernel on CUDA, plain on CPU."""
    if not use_kernel(x_pad):
        return os_conv_plain(x_pad, w)
    out_shape = _check_operands(x_pad, w)
    lib = _lib()
    y = torch.empty(out_shape, device=x_pad.device, dtype=torch.float32)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.os_conv_fwd(
            x_pad.data_ptr(), w.data_ptr(), y.data_ptr(),
            x_pad.shape[0], x_pad.shape[1], x_pad.shape[2], w.shape[0], w.shape[2],
            stream,
        )
    LAUNCHES["os_conv_fwd"] += 1
    _raise_on(err, "os_conv_fwd")
    return y


def os_conv_fused(
    x_pad: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    relu: bool,
) -> torch.Tensor:
    """``relu?(os_conv(x_pad, w) * scale + shift)`` with one store; kernel on
    CUDA, plain on CPU.  No gradient: inference only."""
    if not use_kernel(x_pad):
        return os_conv_fused_plain(x_pad, w, scale, shift, relu)
    out_shape = _check_operands(x_pad, w, scale, shift)
    lib = _lib()
    y = torch.empty(out_shape, device=x_pad.device, dtype=torch.float32)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.os_conv_fused_fwd(
            x_pad.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            int(relu), y.data_ptr(),
            x_pad.shape[0], x_pad.shape[1], x_pad.shape[2], w.shape[0], w.shape[2],
            stream,
        )
    LAUNCHES["os_conv_fused_fwd"] += 1
    _raise_on(err, "os_conv_fused_fwd")
    return y


# ------------------------------------------------------------ the op ------

def masked_os_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """Masked omni-scale "same" conv1d with optional affine + ReLU epilogue.

    x: (B, T, C_in); weight: (K, C_in, C_out); mask broadcastable to weight.
    Returns (B, T, C_out).  scale/shift (if given) fold an inference-mode
    BatchNorm: ``y*scale + shift`` after bias.
    """
    k = weight.shape[0]
    w = weight * mask
    x_pad = F.pad(x, (0, 0, (k - 1) // 2, k // 2))
    if scale is not None:
        # fold bias into the shift: (conv + bias)*scale + shift
        eff_shift = bias * scale + (shift if shift is not None else 0.0)
        if fuse_epilogue_in_kernel():
            return os_conv_fused(x_pad, w, scale.contiguous(), eff_shift, relu)
        y = os_conv(x_pad, w) * scale + eff_shift
        return torch.relu(y) if relu else y
    y = os_conv(x_pad, w) + bias
    return torch.relu(y) if relu else y
