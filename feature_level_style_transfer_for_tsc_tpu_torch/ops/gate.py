"""Fused WaveNet gate: ``tanh(x[..., :n]) * sigmoid(x[..., n:])`` on ``x = a + b``.

Counterpart of the JAX package's ``ops/gate.py`` (reference
``Simplified_NF_WaveGlow.py:44-54``, the one op the reference fuses).  Layout
is channel-last: a, b are (..., 2n) and the result is (..., n).

* ``gate_fwd`` (CUDA, ``csrc/gate.cu``) replaces ``_gate_kernel``.  Each
  operand is a row-strided 2-D view: the op-by-op WN passes a column slice of
  its cond projection as ``b`` without a copy;
* ``gate_plain`` is the plain PyTorch version beside it;
* ``GateCore`` is the ``autograd.Function``: the kernel for a CUDA tensor,
  the plain version for a CPU tensor, and the JAX package's ``_gate_bwd``
  (XLA there, no Pallas) in plain PyTorch as its backward, recomputing
  ``a + b`` from the saved operands.  Under ``torch.func.vmap`` (K runs,
  ``train/multirun.py``) its vmap rule folds the runs into the rows:
  ``GateRunCore``, ONE launch of the same kernel for the K runs, counted as
  ``gate_fwd_runs``, each run's rows the bits of its one-run call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, use_kernel

#: Launches of the kernel, counted by its wrapper where it launches; ``gate_fwd_runs``
#: counts the launches over K runs folded into the rows (``GateRunCore``).
LAUNCHES = {"gate_fwd": 0, "gate_fwd_runs": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gate_plain(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    x = a + b
    return torch.tanh(x[..., :n]) * torch.sigmoid(x[..., n:])


# ---------------------------------------------------- kernel wrapper ------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/gate.cu``."""
    lib = _build.load("gate")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gate_fwd.argtypes = [p, ll, p, ll, p, ll, i, p]
    lib.gate_fwd.restype = i
    return lib


def _rows(t: torch.Tensor, n: int) -> Optional[torch.Tensor]:
    """``t`` (..., 2n) as an (M, 2n) view with a unit column stride, or None
    when no such view of its memory exists."""
    if t.shape[-1] != 2 * n:
        return None
    try:
        v = t.view(-1, 2 * n)
    except RuntimeError:
        return None
    return v if v.stride(1) == 1 and (v.shape[0] < 2 or v.stride(0) >= 2 * n) else None


def gate_fwd(a: torch.Tensor, b: torch.Tensor, n: int, name: str = "gate_fwd") -> torch.Tensor:
    """The kernel: a, b (..., 2n) float32 CUDA tensors, each contiguous or a
    row-strided view -> (..., n); the launch counted as ``name``."""
    for t in (a, b):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"gate_fwd takes CUDA operands on one device, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gate_fwd takes float32, got {t.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"gate operands of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    a2, b2 = _rows(a, n), _rows(b, n)
    if a2 is None or b2 is None:
        raise ValueError("gate_fwd takes contiguous tensors or row-strided (M, 2n) views")
    out = torch.empty(a2.shape[0], n, device=a.device)
    if a2.shape[0] == 0:  # nothing to launch
        return out.reshape(*a.shape[:-1], n)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gate_fwd(a2.data_ptr(), a2.stride(0), b2.data_ptr(), b2.stride(0),
                           out.data_ptr(), a2.shape[0], n, stream)
    LAUNCHES[name] += 1
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    return out.reshape(*a.shape[:-1], n)


# ------------------------------------------------------------ the op ------

class GateCore(torch.autograd.Function):
    """The gate: ``gate_fwd`` on CUDA, ``gate_plain`` on the CPU; the plain
    backward of JAX's ``_gate_bwd``, the same gradient for a and b.  Under
    ``torch.func.vmap`` one ``GateRunCore`` call for all runs."""

    LAUNCH = "gate_fwd"

    @classmethod
    def forward(cls, a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
        if not use_kernel(a):
            return gate_plain(a, b, n)
        # an operand with no row-strided view of its memory is copied first
        a, b = (t if _rows(t, n) is not None else t.contiguous() for t in (a, b))
        return gate_fwd(a, b, n, cls.LAUNCH)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, n = inputs
        ctx.save_for_backward(a, b)
        ctx.n = n

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        n = ctx.n
        x = a + b
        t = torch.tanh(x[..., :n])
        s = torch.sigmoid(x[..., n:])
        dx = torch.cat([g * (1.0 - t * t) * s, g * t * s * (1.0 - s)], dim=-1)
        return dx, dx, None

    @staticmethod
    def vmap(info, in_dims, a, b, n):
        # The gate has no weights and is elementwise over rows, so K runs are
        # the rows of one call: the kernel takes any (M, 2n) row-strided view
        # and already flattens every leading axis into M, as JAX's
        # _gate_pallas flattens them into its m rows.  No kernel change: the
        # runs go first (a runs-first slice of a stacked projection keeps its
        # row-strided view; an unbatched operand is expanded, and copied by
        # the forward), and each run's rows give its one-run bits.
        a, b = (t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)
                for t, d in zip((a, b), in_dims[:2]))
        return GateRunCore.apply(a, b, n), 0


class GateRunCore(GateCore):
    """The gate of K runs with the runs folded into the rows: one launch,
    counted as ``gate_fwd_runs``; the same backward."""

    LAUNCH = "gate_fwd_runs"


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Gate of the WN coupling network (reference fused op parity)."""
    if a.shape != b.shape or a.shape[-1] != 2 * n:
        raise ValueError(f"expected (..., {2 * n}) inputs, got {tuple(a.shape)} and {tuple(b.shape)}")
    return GateCore.apply(a, b, n)
