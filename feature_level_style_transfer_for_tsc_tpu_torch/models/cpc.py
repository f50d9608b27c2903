"""Contrastive Predictive Coding (CPC) self-supervised auxiliary loss.

Counterpart of the JAX package's ``models/cpc.py`` (reference
``Comparison/SLARDA/train.py:41-76``): a GRU over the features, a random
anchor ``t ~ U[0, timestep/2)``, ``timestep`` per-step Linears predicting
z[:, t+1 .. t+timestep] from the context c_t, and InfoNCE over the batch.

As in the JAX package the GRU runs over the static prefix of
``timestep//2`` steps and the output is taken at the anchor: a causal GRU's
output at t depends only on steps <= t, so this is exact.  The anchor is
drawn on the host from a ``torch.Generator`` or passed in (``anchor=``): a
Python int, or a 0-d integer tensor, one a run under ``torch.func.vmap``
(``train/multirun.py``), where the steps are gathered as the JAX package's
dynamic slice takes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..ops.collectives import all_gather_rows, data_group, rank_and_size
from .common import gru_init, gru_scan, linear_init


def cpc_init(generator: torch.Generator, num_channels: int, gru_hidden_dim: int, timestep: int,
             device="cpu") -> Dict:
    return {
        "gru": gru_init(generator, num_channels, gru_hidden_dim, device),
        "wk": [linear_init(generator, gru_hidden_dim, num_channels, device) for _ in range(timestep)],
    }


def draw_anchor(params: Dict, generator: torch.Generator) -> int:
    """The reference's ``torch.randint(timestep//2)`` anchor."""
    return int(torch.randint(0, len(params["wk"]) // 2, (), generator=generator))


def _context(params: Dict, features: torch.Tensor) -> torch.Tensor:
    """GRU outputs over the static prefix of ``timestep//2`` steps."""
    prefix = max(len(params["wk"]) // 2, 1)
    hidden = params["gru"]["w_hh"].shape[0]
    return gru_scan(params["gru"], features[:, :prefix], features.new_zeros(features.shape[0], hidden))


Anchor = Union[int, torch.Tensor]


def _info_nce(params: Dict, z: torch.Tensor, context: torch.Tensor, anchor: Anchor) -> torch.Tensor:
    b = z.shape[0]
    timestep = len(params["wk"])
    if isinstance(anchor, torch.Tensor):
        anchor = anchor.to(z.device)
    steps = anchor + 1 + torch.arange(timestep, device=z.device)
    encode_samples = z.index_select(1, steps).transpose(0, 1)  # (ts, B, C)
    c_t = context.index_select(1, steps[:1] - 1)[:, 0]  # (B, hidden)
    pred = torch.stack([c_t @ p["weight"] + p["bias"] for p in params["wk"]])  # (ts, B, C)
    group = data_group()
    if group is not None:
        return info_nce_contrib(encode_samples, pred, group)
    total = torch.einsum("sbc,sdc->sbd", encode_samples, pred)  # (ts, B, B)
    nce = torch.diagonal(torch.log_softmax(total, dim=-1), dim1=1, dim2=2).sum()
    return nce / (-1.0 * b * timestep)


def info_nce_contrib(encode_local: torch.Tensor, pred_local: torch.Tensor, group) -> torch.Tensor:
    """This rank's contribution to the global InfoNCE loss, its batch rows
    sharded over ``group`` (JAX ``parallel/dp_explicit.py`` ``_cpc_contrib``):
    the softmax runs over the whole batch, so every rank's prediction
    columns are gathered (``(ts, B_loc, C)`` -> ``(ts, B_glob, C)``, rank
    order) and the local rows are scored against all of them; the diagonal
    of rank i's rows sits at global columns ``i * B_loc + arange(B_loc)``.
    The contributions sum to the unsharded loss."""
    timestep, b_loc, _ = encode_local.shape
    i, n = rank_and_size(group)
    pred_all = all_gather_rows(pred_local, group, dim=1)  # (ts, B_glob, C)
    total = torch.einsum("sbc,sdc->sbd", encode_local, pred_all)  # (ts, B_loc, B_glob)
    rows = torch.arange(b_loc, device=total.device)
    diag = torch.log_softmax(total, dim=-1)[:, rows, i * b_loc + rows]  # (ts, B_loc)
    return diag.sum() / (-1.0 * b_loc * n * timestep)


def cpc_apply(params: Dict, features: torch.Tensor, anchor: Anchor) -> torch.Tensor:
    """InfoNCE loss of features (B, T, C) at anchor ``anchor``."""
    return _info_nce(params, features, _context(params, features), anchor)


def cpc_apply_pair(params: Dict, feats_a: torch.Tensor, feats_b: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   anchors: Optional[Sequence[Anchor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent CPC losses with one batched GRU scan over both feature
    batches; the anchors are drawn from ``generator`` unless given."""
    if anchors is None:
        anchors = (draw_anchor(params, generator), draw_anchor(params, generator))
    b = feats_a.shape[0]
    context = _context(params, torch.cat([feats_a, feats_b], dim=0))
    return (
        _info_nce(params, feats_a, context[:b], anchors[0]),
        _info_nce(params, feats_b, context[b:], anchors[1]),
    )
