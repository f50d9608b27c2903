"""Shared primitives with torch-default-parity initializers.

Counterpart of the JAX package's ``models/common.py`` (the parts serving
uses).  Parameters are plain dictionaries of tensors, laid out as in the JAX
package so that its checkpoints load unchanged:

* ``nn.Linear`` / ``nn.Conv1d`` (kernel 1): weight ``(in, out)`` and bias
  ``(out,)``, both ~ U(-1/sqrt(fan_in), +...) (kaiming_uniform(a=sqrt(5))
  reduces to exactly that bound).

Layout is channel-last throughout: sequences are (B, T, C).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def uniform(shape, bound: float, generator: torch.Generator, device="cpu") -> torch.Tensor:
    """U(-bound, bound), drawn on the CPU from ``generator``, then moved."""
    return torch.empty(shape).uniform_(-bound, bound, generator=generator).to(device)


def linear_init(generator: torch.Generator, in_features: int, out_features: int, device="cpu") -> Dict:
    bound = 1.0 / np.sqrt(in_features)
    return {
        "weight": uniform((in_features, out_features), bound, generator, device),
        "bias": uniform((out_features,), bound, generator, device),
    }


def linear(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["weight"] + params["bias"]


def conv1x1_init(generator: torch.Generator, in_ch: int, out_ch: int, bias: bool = True, device="cpu") -> Dict:
    bound = 1.0 / np.sqrt(in_ch)
    p = {"weight": uniform((in_ch, out_ch), bound, generator, device)}
    if bias:
        p["bias"] = uniform((out_ch,), bound, generator, device)
    return p


def conv1x1(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Pointwise conv over the channel (last) axis of (B, T, C)."""
    y = x @ params["weight"]
    if "bias" in params:
        y = y + params["bias"]
    return y
