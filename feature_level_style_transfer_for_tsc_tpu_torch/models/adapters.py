"""Cross-domain adapters: DimensionUnification, ProbTransfer, NoiseTransfer.

Counterpart of the JAX package's ``models/adapters.py`` (reference
``widgets.py:46-78,136-167``).  NoiseTransfer's running buffers are explicit
state threaded through each step.  Layout: sequence features (B, T, C),
pooled features (B, C).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..ops.collectives import all_reduce_sum, data_group, rank_and_size
from .common import conv1x1, conv1x1_init, linear_init, lstm_cell, lstm_init


# ------------------------------------------------- DimensionUnification ----

def dimension_unification_init(generator: torch.Generator, source_channel: int,
                               target_channel: int, source_length: int, target_length: int,
                               device="cpu") -> Dict:
    return {
        "length": linear_init(generator, source_length, target_length, device),
        "channel": conv1x1_init(generator, source_channel, target_channel, device=device),
    }


def dimension_unification_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, T_s, C_s) -> (B, T_t, C_t): Linear over time -> ReLU -> 1x1 conv
    over channels -> ReLU (reference widgets.py:66-78)."""
    y = torch.einsum("bsc,st->btc", x, params["length"]["weight"])
    y = torch.relu(y + params["length"]["bias"][None, :, None])
    return torch.relu(conv1x1(params["channel"], y))


# --------------------------------------------------------- ProbTransfer ----

def prob_transfer_init(generator: torch.Generator, num_channels: int, device="cpu") -> Dict:
    return {"lstm": lstm_init(generator, num_channels, num_channels, device)}


def prob_transfer_apply(params: Dict, pooled: torch.Tensor) -> torch.Tensor:
    """The pooled feature through an LSTM cell twice, the final hidden state
    (reference widgets.py:46-55 feeds the vector as a 2-step sequence)."""
    h = torch.zeros_like(pooled)
    cell = torch.zeros_like(pooled)
    for _ in range(2):
        h, cell = lstm_cell(params["lstm"], pooled, h, cell)
    return h


# -------------------------------------------------------- NoiseTransfer ----

class NoiseTransferState(NamedTuple):
    """Running noise-space averages (reference widgets.py:142-151 buffers),
    stored channel-last (T, C); the counters are int32 scalars."""

    target_avg: torch.Tensor
    source_avg: torch.Tensor
    time: torch.Tensor
    cal_num_target: torch.Tensor
    cal_num_source: torch.Tensor


def noise_transfer_init(generator: torch.Generator, noise_channel: int, length_of_noise: int,
                        device="cpu") -> Tuple[Dict, NoiseTransferState]:
    params = {"conv": conv1x1_init(generator, noise_channel, noise_channel, device=device)}
    zeros = torch.zeros(length_of_noise, noise_channel, device=device)
    count = torch.zeros((), dtype=torch.int32)  # host counters: read every step
    return params, NoiseTransferState(zeros, zeros.clone(), count, count.clone(), count.clone())


def noise_transfer_apply(params: Dict, state: NoiseTransferState, target_noise: torch.Tensor,
                         source_noise: torch.Tensor) -> Tuple[torch.Tensor, NoiseTransferState]:
    """Style-transfer mixer (reference widgets.py:152-167).

    The first call adds the plain batch mean; later calls add
    ``batch/cal_num_so_far * mean(batch)`` (a growing accumulator, kept as
    the reference has it).  Gradients flow through the current batch's
    contribution; the stored averages are detached.  Under a data-parallel
    group the means and the counts are the global batch's (one all-reduce),
    and the delta, the same on every rank, is added to the rank's rows.
    """
    b_t, b_s = target_noise.shape[0], source_noise.shape[0]
    group = data_group()
    if group is None:
        mean_t, mean_s = target_noise.mean(dim=0), source_noise.mean(dim=0)
    else:
        n = rank_and_size(group)[1]
        b_t, b_s = b_t * n, b_s * n
        sums = all_reduce_sum(torch.stack([target_noise.sum(dim=0), source_noise.sum(dim=0)]),
                              group)
        mean_t, mean_s = sums[0] / b_t, sums[1] / b_s
    first = int(state.time) == 0
    coef_t = 1.0 if first else b_t / max(float(state.cal_num_target), 1.0)
    coef_s = 1.0 if first else b_s / max(float(state.cal_num_source), 1.0)
    target_avg = state.target_avg + coef_t * mean_t
    source_avg = state.source_avg + coef_s * mean_s
    delta = F.selu(conv1x1(params["conv"], target_avg - source_avg))
    new_state = NoiseTransferState(
        target_avg.detach(), source_avg.detach(), state.time + 1,
        state.cal_num_target + b_t, state.cal_num_source + b_s,
    )
    return delta[None] + source_noise, new_state
