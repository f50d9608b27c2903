"""Shared primitives with torch-default-parity initializers.

Counterpart of the JAX package's ``models/common.py``.  Parameters are plain
dictionaries of tensors, laid out as in the JAX package so that its
checkpoints load unchanged:

* ``nn.Linear`` / ``nn.Conv1d`` (kernel 1): weight ``(in, out)`` and bias
  ``(out,)``, both ~ U(-1/sqrt(fan_in), +...) (kaiming_uniform(a=sqrt(5))
  reduces to exactly that bound);
* ``nn.LSTM`` / ``nn.GRU``: ``w_ih (in, G*H)``, ``w_hh (H, G*H)`` and the two
  biases, every one ~ U(-1/sqrt(H), +...), in torch's gate order;
* weight norm: ``{"v": (K, C_in, C_out), "g": (C_out,)}``, the norm taken per
  output channel.

Random draws come from an explicit ``torch.Generator`` on the CPU and are
then moved to ``device``.

Layout is channel-last throughout: sequences are (B, T, C).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.collectives import data_group, rank_and_size


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


def xavier_normal_linear_init(generator: torch.Generator, in_features: int, out_features: int,
                              device="cpu") -> Dict:
    """torch ``xavier_normal_`` weight + zero bias (reference widgets.py:83-91)."""
    std = np.sqrt(2.0 / (in_features + out_features))
    w = torch.empty(in_features, out_features).normal_(0.0, std, generator=generator)
    return {"weight": w.to(device), "bias": torch.zeros(out_features, device=device)}


# ----------------------------------------------------------- weight norm ---

def weight_norm_init(generator: torch.Generator, shape_kio: Tuple[int, int, int],
                     device="cpu") -> Dict:
    """torch ``weight_norm(conv, 'weight')`` over a (K, C_in, C_out) weight:
    v like the plain conv weight, g = ||v|| per output channel."""
    k, c_in, _ = shape_kio
    v = uniform(shape_kio, 1.0 / np.sqrt(c_in * k), generator, device)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=(0, 1)))}


def weight_norm_weight(params: Dict) -> torch.Tensor:
    v, g = params["v"], params["g"]
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    return v * (g / torch.clamp(norm, min=1e-12))


# ------------------------------------------------------- recurrent cells ---

def _rnn_init(generator, input_size: int, hidden_size: int, gates: int, device) -> Dict:
    bound = 1.0 / np.sqrt(hidden_size)
    return {
        "w_ih": uniform((input_size, gates * hidden_size), bound, generator, device),
        "w_hh": uniform((hidden_size, gates * hidden_size), bound, generator, device),
        "b_ih": uniform((gates * hidden_size,), bound, generator, device),
        "b_hh": uniform((gates * hidden_size,), bound, generator, device),
    }


def lstm_init(generator: torch.Generator, input_size: int, hidden_size: int, device="cpu") -> Dict:
    return _rnn_init(generator, input_size, hidden_size, 4, device)


def lstm_cell(params: Dict, x, h, c):
    """Torch gate order: input, forget, cell(g), output."""
    hid = h.shape[-1]
    z = x @ params["w_ih"] + params["b_ih"] + h @ params["w_hh"] + params["b_hh"]
    i = torch.sigmoid(z[..., :hid])
    f = torch.sigmoid(z[..., hid : 2 * hid])
    g = torch.tanh(z[..., 2 * hid : 3 * hid])
    o = torch.sigmoid(z[..., 3 * hid :])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def gru_init(generator: torch.Generator, input_size: int, hidden_size: int, device="cpu") -> Dict:
    return _rnn_init(generator, input_size, hidden_size, 3, device)


def gru_cell(params: Dict, x, h):
    """Torch gate order: reset, update, new."""
    hid = h.shape[-1]
    gi = x @ params["w_ih"] + params["b_ih"]
    gh = h @ params["w_hh"] + params["b_hh"]
    r = torch.sigmoid(gi[..., :hid] + gh[..., :hid])
    z = torch.sigmoid(gi[..., hid : 2 * hid] + gh[..., hid : 2 * hid])
    n = torch.tanh(gi[..., 2 * hid :] + r * gh[..., 2 * hid :])
    return (1 - z) * n + z * h


def gru_scan(params: Dict, xs: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """A GRU over (B, T, C), returning every hidden state (B, T, H)."""
    hs, h = [], h0
    for t in range(xs.shape[1]):
        h = gru_cell(params, xs[:, t], h)
        hs.append(h)
    return torch.stack(hs, dim=1)


# ----------------------------------------------------------------- misc ----

def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout, ``x * mask``.  ``mask`` is the multiplier (keep /
    (1 - rate), 0 where dropped) when given, else drawn on the CPU from
    ``generator``; with neither, or outside training, x is returned.  Under
    a data-parallel group the draw is the global batch's (rows of every
    rank, in rank order) and the rank keeps its own rows, so a replicated
    generator draws what one device would."""
    if not training or rate == 0.0:
        return x
    if mask is None:
        if generator is None:
            return x
        group = data_group()
        if group is None:
            mask = dropout_mask(x.shape, rate, generator)
        else:
            i, n = rank_and_size(group)
            b = x.shape[0]
            mask = dropout_mask((b * n, *x.shape[1:]), rate, generator)[i * b : (i + 1) * b]
    return x * mask.to(x.device)


def dropout_mask(shape, rate: float, generator: torch.Generator) -> torch.Tensor:
    """A keep-mask multiplier: 1/(1 - rate) with probability 1 - rate, else 0."""
    keep = torch.rand(shape, generator=generator) >= rate
    return keep.to(torch.float32) / (1.0 - rate)


def layer_norm(params: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, biased variance (torch ``nn.LayerNorm``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]


def layer_norm_init(dim: int, device="cpu") -> Dict:
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}
