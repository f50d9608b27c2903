"""Sequence parallelism: the time axis of very long series sharded over ranks.

Counterpart of the JAX package's ``parallel/sequence.py``.  A series too
long for one device is cut along time into P equal shards, one a rank of a
mesh axis (``parallel.mesh.make_mesh``), and every conv takes its halo (the
rows its taps reach past the shard's ends) from the neighbouring shards.
Everything else in this model family is pointwise in time (1x1 convs, gates,
couplings, the invertible channel mixings) and needs no communication, but
for BatchNorm's batch statistics, which one all-reduce makes global.

**The API is multi-controller**, PyTorch's idiom, where JAX's is one
program over a mesh: each rank runs the same calls on its own shard
``x_local (B, T/P, C)`` with the mesh, names the mesh axis (``axis``,
"data" by default) and gets its own output shard back.  ``shard_time``
cuts a rank's shard from a whole series (JAX's ``device_put`` with
``P(None, axis, None)``) and ``gather_time`` puts the shards back together.

* ``time_sharded_os_conv``: the masked omni-scale "same" conv, halos
  ``((K-1)//2, K//2)``, through ``OSConvCore`` (``os_conv_fwd`` on CUDA);
* ``time_sharded_dilated_conv``: the WN's kernel-3 dilated "same" conv,
  halo ``d*(k-1)//2`` a side, through ``tap_conv`` (``tap_conv_fwd`` on
  CUDA, and its input gradient again in the backward) whatever
  ``FLSTTSC_CONV_IMPL`` says;
* ``time_sharded_wn_apply``: the port's ``wn_apply`` with that halo conv
  as its ``dilated_conv=``, the op-by-op route (gate: ``gate_fwd``);
* ``time_sharded_waveglow_forward``: the flow's density direction, its
  log-determinants from the GLOBAL length, the same on every rank;
* ``time_sharded_os_cnn_res_apply``: the OS-CNN residual extractor, its
  training-mode BatchNorm statistics global, so outputs and new running
  statistics equal the unsharded op's.

On CUDA tensors these launch the kernels, on CPU tensors the plain versions,
as every op of the port (``ops/__init__.py``).

**The halo exchange** is an ``all_gather`` of each shard's boundary slab
(its trailing left-halo rows and leading right-halo rows), from which each
rank takes its two neighbours' slabs; the first and last shards take zeros,
the reference's zero "same" padding.  JAX moves 2 slabs a shard with
``ppermute``; the all_gather moves P.  At P <= 8 and halos of at most 128
rows that is a few MB a conv, and it keeps to collectives that gloo takes
on CUDA tensors, where its ``send``/``recv`` take CPU tensors only: so
ranks that share one card run on gloo.

**Gradients.** PyTorch's plain collectives carry no gradient, and sharded
ops built on them would give input gradients silently wrong in the rows at
the shard edges.  So the halo exchange and the statistics' all-reduce are
``autograd.Function``s: the halo exchange's backward sends each halo row's
gradient back to the rank that donated the row and adds it there (the zero
halos' gradients are dropped), and the all-reduce's backward all-reduces
the gradient of the global sums (``batch_norm`` under ``bn_cross_replica``,
``ops/collectives.py``).  Every rank must run the same backward.
**Parameter gradients come out as each rank's share**: the sum over the
ranks is the gradient of the sum of the ranks' losses, and summing them is
the caller's ``all_reduce`` (``collectives.all_reduce_grads``).  The
log-determinants are replicated: a loss summed over ranks counts them once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.flow import wn_apply
from ..ops.batchnorm import batch_norm, bn_cross_replica
from ..ops.collectives import all_gather
from ..ops.coupling import affine_coupling_forward
from ..ops.osconv import OSConvCore, tap_conv
from .mesh import axis_group


class _HaloExchange(torch.autograd.Function):
    """``[left_halo | x_local | right_halo]`` along time, zeros at the
    sequence's two ends; its backward is the adjoint (see the module)."""

    @staticmethod
    def forward(ctx, x, pad_l: int, pad_r: int, group):
        b, t, c = x.shape
        if t < max(pad_l, pad_r):
            raise ValueError(f"time shard of {t} steps cannot donate a {max(pad_l, pad_r)}-step "
                             "halo; use fewer shards")
        i, n = dist.get_rank(group), dist.get_world_size(group)
        ctx.shape, ctx.pads, ctx.group = (b, t, c), (pad_l, pad_r), group
        slabs = all_gather(torch.cat([x[:, t - pad_l:], x[:, :pad_r]], dim=1), group)
        left = slabs[i - 1][:, :pad_l] if i > 0 else x.new_zeros(b, pad_l, c)
        right = slabs[i + 1][:, pad_l:] if i < n - 1 else x.new_zeros(b, pad_r, c)
        return torch.cat([left, x, right], dim=1)

    @staticmethod
    def backward(ctx, g):
        (_, t, _), (pad_l, pad_r), group = ctx.shape, ctx.pads, ctx.group
        i, n = dist.get_rank(group), dist.get_world_size(group)
        slabs = all_gather(torch.cat([g[:, :pad_l], g[:, pad_l + t:]], dim=1), group)
        dx = g[:, pad_l : pad_l + t].clone()
        if i < n - 1:  # my trailing rows were the right neighbour's left halo
            dx[:, t - pad_l:] += slabs[i + 1][:, :pad_l]
        if i > 0:  # my leading rows were the left neighbour's right halo
            dx[:, :pad_r] += slabs[i - 1][:, pad_l:]
        return dx, None, None, None


def _halo_exchange(x_local: torch.Tensor, pad_l: int, pad_r: int, group) -> torch.Tensor:
    """(B, T_shard, C) -> (B, pad_l + T_shard + pad_r, C) with the
    neighbours' rows as halos, zeros at the sequence's ends."""
    if pad_l == pad_r == 0:
        return x_local
    return _HaloExchange.apply(x_local, pad_l, pad_r, group)


def _halo_tap_conv(x_local, w, bias, dilation: int, group):
    """The dilated "same" conv of a shard: halo ``d*(k-1)//2`` a side, then
    the VALID tap conv (the kernel on CUDA, the plain version on the CPU)."""
    pad = dilation * (w.shape[0] - 1) // 2
    return tap_conv(_halo_exchange(x_local, pad, pad, group), w, dilation) + bias


# ---------------------------------------------------------------------------
# placing shards
# ---------------------------------------------------------------------------

def shard_time(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This rank's time shard ``x[:, i*T/P:(i+1)*T/P]`` (contiguous) of a
    whole series (B, T, C); T must be divisible by the axis size P."""
    _, i, n = axis_group(mesh, axis)
    t = x.shape[1]
    if t % n:
        raise ValueError(f"time length {t} is not divisible by the {n} shards of mesh axis {axis!r}")
    s = t // n
    return x[:, i * s : (i + 1) * s].contiguous()


def gather_time(y_local: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The whole series from every rank's shard along ``axis``, on every
    rank (no gradient)."""
    group, _, _ = axis_group(mesh, axis)
    return torch.cat(all_gather(y_local.detach(), group), dim=1)


# ---------------------------------------------------------------------------
# standalone conv primitives
# ---------------------------------------------------------------------------

def time_sharded_os_conv(mesh: DeviceMesh, x_local: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, mask: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The masked OS conv (``ops.osconv.masked_os_conv``) of a time shard
    (B, T/P, C_in) with weight (K, C_in, C_out): (B, T/P, C_out)."""
    group, _, _ = axis_group(mesh, axis)
    k = weight.shape[0]
    x_ext = _halo_exchange(x_local, (k - 1) // 2, k // 2, group)
    return OSConvCore.apply(x_ext, weight * mask) + bias


def time_sharded_dilated_conv(mesh: DeviceMesh, x_local: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, dilation: int, axis: str = "data") -> torch.Tensor:
    """The dilated "same" conv (reference WN padding ``(k*d - d)/2``) of a
    time shard, weight (K, C_in, C_out), K odd: halo ``d*(k-1)//2`` a side."""
    group, _, _ = axis_group(mesh, axis)
    return _halo_tap_conv(x_local, weight, bias, dilation, group)


# ---------------------------------------------------------------------------
# model-level consumers
# ---------------------------------------------------------------------------

def time_sharded_wn_apply(mesh: DeviceMesh, params: Dict, x_local: torch.Tensor, n_channels: int,
                          axis: str = "data") -> torch.Tensor:
    """The WN coupling net (``models.flow.wn_apply``) of a time shard: each
    of its dilated convs exchanges its own halo, the rest is local."""
    group, _, _ = axis_group(mesh, axis)

    def halo_conv(xl, w, bias, dilation):
        return _halo_tap_conv(xl, w, bias, dilation, group)

    return wn_apply(params, x_local, n_channels, dilated_conv=halo_conv)


def time_sharded_waveglow_forward(mesh: DeviceMesh, params: Dict, x_local: torch.Tensor,
                                  n_wn_ch: int, axis: str = "data"
                                  ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The WaveGlow density direction (``models.flow.waveglow_forward``) of
    a time shard: (z_local, log_s_list of shards, log_det_w_list).  Each
    log-determinant is ``B * T_global * log|det W|``, the same on every rank
    (not ``inv1x1_forward``'s, which takes the local length)."""
    group, _, n = axis_group(mesh, axis)
    b, t_local, _ = x_local.shape
    t_global = t_local * n

    def halo_conv(xl, w, bias, dilation):
        return _halo_tap_conv(xl, w, bias, dilation, group)

    log_s_list, log_det_list = [], []
    audio = x_local
    for k in range(len(params["convinv"])):
        w = params["convinv"][k]["weight"]
        _, logdet = torch.linalg.slogdet(w)
        log_det_list.append(b * t_global * logdet)
        audio = audio @ w.T  # the port's 1x1 mixing (inv1x1_forward), TF32 as the caller sets it
        n_half = audio.shape[-1] // 2
        audio_0, audio_1 = audio[..., :n_half], audio[..., n_half:]
        output = wn_apply(params["wn"][k], audio_0, n_wn_ch, dilated_conv=halo_conv)
        bcoef, log_s = output[..., :n_half], output[..., n_half:]
        audio_1, _ = affine_coupling_forward(audio_1, log_s, bcoef)
        log_s_list.append(log_s)
        audio = torch.cat([audio_0, audio_1], dim=-1)
    return audio, log_s_list, log_det_list


def time_sharded_os_cnn_res_apply(mesh: DeviceMesh, params: Dict, state: Dict,
                                  masks: List[torch.Tensor], x_local: torch.Tensor,
                                  axis: str = "data", training: bool = False
                                  ) -> Tuple[torch.Tensor, Dict]:
    """The OS_CNN_res extractor (``models.os_cnn.os_cnn_res_apply``) of a
    time shard, the port's parameter layout: each layer's masked conv
    (unfused, ``os_conv_fwd`` on CUDA) exchanges its halo, then the sharded
    BatchNorm, no ReLU on the block's last layer; the shortcut is a 1x1 conv
    with a sharded BatchNorm.  Returns (features shard, new state); in
    training the new running statistics are global, the same on every rank."""
    group, _, _ = axis_group(mesh, axis)
    h = x_local
    new_layers = []
    layers = list(zip(params["block"]["layers"], state["block"]["layers"], masks))
    with bn_cross_replica(group):
        for i, (p, s, mask) in enumerate(layers):
            w = p["conv"]["weight"] * mask
            k = w.shape[0]
            x_ext = _halo_exchange(h, (k - 1) // 2, k // 2, group)
            y = OSConvCore.apply(x_ext, w) + p["conv"]["bias"]
            y, new_bn = batch_norm(y, p["bn_scale"], p["bn_bias"], s["bn"], training)
            if i < len(layers) - 1:  # no ReLU on the block's last layer (res variant)
                y = torch.relu(y)
            new_layers.append({"bn": new_bn})
            h = y
        shortcut = x_local @ params["res"]["weight"] + params["res"]["bias"]
        shortcut, new_res_bn = batch_norm(shortcut, params["res_bn_scale"],
                                          params["res_bn_bias"], state["res_bn"], training)
    return torch.relu(h + shortcut), {"block": {"layers": new_layers}, "res_bn": new_res_bn}
