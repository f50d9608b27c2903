"""Preprocessing on tensors: z-normalization and sliding-window extraction.

Counterpart of the JAX package's ``data/preprocess.py``.  The reference
relies on the UCR/UEA archives being pre-z-normalized and has no windowing;
these utilities serve raw signals, on whatever device their input is on:

* ``znormalize`` — per-series per-channel standardization over time,
  ignoring NaN (the padding of unequal-length archives);
* ``nan_to_zero`` — that padding replaced by zeros;
* ``sliding_windows`` / ``windows_as_batch`` — fixed-length windows over
  the time axis, as a window axis or folded into the batch.
"""

from __future__ import annotations

from typing import Tuple

import torch


def znormalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-series per-channel z-norm over the time axis; x is (..., T, C)."""
    mean = torch.nanmean(x, dim=-2, keepdim=True)
    std = torch.sqrt(torch.nanmean(torch.square(x - mean), dim=-2, keepdim=True))
    return (x - mean) / (std + eps)


def nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    """Replace padding NaNs (unequal-length .ts archives) with zeros."""
    return torch.nan_to_num(x, nan=0.0)


def sliding_windows(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """(N, T, C) -> (N, num_windows, window, C).

    num_windows = (T - window) // stride + 1; the tail shorter than a full
    window is dropped (standard TSC windowing).
    """
    t = x.shape[1]
    if (t - window) // stride + 1 <= 0:
        raise ValueError(f"window {window} longer than series {t}")
    return x.unfold(1, window, stride).transpose(-1, -2)


def windows_as_batch(x: torch.Tensor, y: torch.Tensor, window: int,
                     stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten windows into a larger batch, replicating labels.

    (N, T, C), (N,) -> (N*num_windows, window, C), (N*num_windows,)
    """
    w = sliding_windows(x, window, stride)
    n, num, _, c = w.shape
    return w.reshape(n * num, window, c), torch.repeat_interleave(y, num)
