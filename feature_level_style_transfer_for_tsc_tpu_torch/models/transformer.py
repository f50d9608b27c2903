"""Sequence-transformer domain discriminator (CoDATS / SLARDA baselines).

Counterpart of the JAX package's ``models/transformer.py`` (reference
``Comparison/SLARDA/models.py:6-141`` and
``Comparison/CoDATS/discriminator.py:13-150``):

* the input feature map is reshaped to (B, n_patches, patch_size);
* a linear patch embedding + prepended CLS token feed a pre-norm transformer
  (depth x [Attention, FeedForward], residual connections, GELU MLP);
* the CLS output goes through a Linear head: 1 unit for SLARDA's binary
  critic, ``num_class`` units for CoDATS's domain classifier;
* CoDATS additionally applies a fixed-coefficient (1.2) gradient reversal on
  the input (discriminator.py:25-33); SLARDA does not.

As in the JAX package: the GELU is the tanh form (``jax.nn.gelu``'s
default), the attention scale is ``dim ** -0.5`` over the full width, not a
head's, and the qkv projection has no bias.  These products run outside any
Pallas kernel in the JAX package, so they are plain PyTorch here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.grl import gradient_reversal
from .common import dropout, layer_norm, layer_norm_init, linear, linear_init, uniform


def _linear_no_bias_init(generator: torch.Generator, in_f: int, out_f: int, device) -> Dict:
    return {"weight": uniform((in_f, out_f), 1.0 / np.sqrt(in_f), generator, device)}


def seq_transformer_init(generator: torch.Generator, patch_size: int, dim: int, depth: int,
                         heads: int, mlp_dim: int, device="cpu") -> Dict:
    params: Dict = {
        "patch_embed": linear_init(generator, patch_size, dim, device),
        "cls_token": torch.randn((1, 1, dim), generator=generator).to(device),
        "layers": [],
    }
    for _ in range(depth):
        params["layers"].append(
            {
                "attn_norm": layer_norm_init(dim, device),
                "qkv": _linear_no_bias_init(generator, dim, 3 * dim, device),
                "attn_out": linear_init(generator, dim, dim, device),
                "ff_norm": layer_norm_init(dim, device),
                "ff1": linear_init(generator, dim, mlp_dim, device),
                "ff2": linear_init(generator, mlp_dim, dim, device),
            }
        )
    return params


def _attention(layer: Dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    q, k, v = torch.chunk(x @ layer["qkv"]["weight"], 3, dim=-1)
    hd = d // heads
    q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2) for t in (q, k, v))
    # Reference scale: dim ** -0.5 over the FULL dim, not per-head
    # (SLARDA models.py:64 / CoDATS discriminator.py:75).
    attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * (d ** -0.5), dim=-1)
    out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2).reshape(b, n, d)
    return linear(layer["attn_out"], out)


def seq_transformer_apply(
    params: Dict,
    x: torch.Tensor,
    heads: int,
    *,
    training: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(B, n_patches, patch_size) -> CLS feature (B, dim).  Dropout after
    the MLP's GELU only when ``training and dropout_rate > 0``, its masks
    drawn from ``generator`` (neither baseline turns it on)."""
    h = linear(params["patch_embed"], x)
    cls = params["cls_token"].expand(x.shape[0], 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1)
    for layer in params["layers"]:
        h = h + _attention(layer, layer_norm(layer["attn_norm"], h), heads)
        ff = F.gelu(linear(layer["ff1"], layer_norm(layer["ff_norm"], h)), approximate="tanh")
        if training and dropout_rate > 0 and generator is not None:
            ff = dropout(ff, dropout_rate, training, generator)
        h = h + linear(layer["ff2"], ff)
    return h[:, 0]


def discriminator_att_init(generator: torch.Generator, patch_size: int, att_hid_dim: int,
                           depth: int, heads: int, mlp_dim: int, num_class: int = 1,
                           device="cpu") -> Dict:
    return {
        "transformer": seq_transformer_init(generator, patch_size, att_hid_dim, depth, heads,
                                            mlp_dim, device),
        "head": linear_init(generator, att_hid_dim, num_class, device),
    }


def discriminator_att_apply(
    params: Dict,
    x: torch.Tensor,
    patch_size: int,
    heads: int,
    *,
    grl: Optional[float] = None,
) -> torch.Tensor:
    """Domain output from a (B, T, C) feature map, flattened then re-patched
    at ``patch_size`` exactly like the reference's
    ``input.view(B, -1, patch_size)`` over (B, C, T).  ``grl=1.2``
    reproduces CoDATS (discriminator.py:27-28); ``grl=None`` SLARDA."""
    if grl is not None:
        x = gradient_reversal(x, grl)
    # the reference flattens (B, C, T) row-major: swap to it first
    flat = x.transpose(1, 2).reshape(x.shape[0], -1, patch_size)
    return linear(params["head"], seq_transformer_apply(params["transformer"], flat, heads))
