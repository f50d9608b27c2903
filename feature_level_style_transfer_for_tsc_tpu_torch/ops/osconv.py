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

Both run the tap GEMM of ``csrc/tap_gemm.cuh`` (3xTF32 on the tensor cores,
f32 accuracy) after a prep kernel that splits w into TF32 hi and lo parts
and finds, per group of 8 output columns, the span of taps whose weights
are nonzero; the GEMM skips the mask's dead taps outside it.
``tap_windows_plain`` is that window search in PyTorch.  The bf16 instance
is a kernel of its own, ``csrc/tap_gemm_bf16.cuh`` (bf16 staging, native
bf16 tensor-core products), with the same windows.

bf16 (``PipelineConfig.compute_dtype="bfloat16"``, ``models/os_cnn.py``):
``os_conv`` and ``os_conv_runs`` take bf16 operands as the JAX package's
bf16 XLA conv does (its Pallas kernels take f32 only, ``osconv.py:356-366``):
on CUDA the bf16 kernel (``os_conv_fwd[bf16]``: bf16 in device memory and
shared memory, each product exact on the bf16 tensor cores, the sum f32,
the output rounded to bf16), on the CPU ``os_conv_plain``, which widens to
f32, convolves and rounds.  The backward is the same transposed convs on
bf16 tensors (bf16 gradients, as JAX's XLA VJP).  ``os_conv_fused`` and
``tap_conv_fwd`` take float32 only.

Gradients: ``masked_os_conv`` runs the conv through ``OSConvCore``, an
``autograd.Function`` whose forward is ``os_conv`` and whose backward is the
plain transposed conv (``torch.nn.grad.conv1d_input`` / ``conv1d_weight``),
as the JAX package's ``_conv_core`` custom VJP takes its backward from XLA
convs outside any Pallas kernel.  ``os_conv_fused`` has no gradient and
refuses inputs that require one.

Runs (``train/multirun.py``): under ``torch.func.vmap`` over K independent
runs, ``OSConvCore``'s vmap rule moves the run axis to the front and calls
``OSConvRunCore`` once on ``x_pad (K, B, t_pad, C_in)`` and ``w (K, Kt,
C_in, C_out)``: on CUDA ``os_conv_runs`` (``os_conv_fwd_runs``, the run on
the kernel's grid: one launch set for the K runs, each run's bits those of
a one-run call), its backward one grouped transposed conv (``groups=K``);
on the CPU the plain version and the one-run backward run by run.  The
fused path's ``OSConvFusedCore`` does the same for ``os_conv_fused_runs``
(no gradient), and ``TapConvCore`` (the op-by-op WN route) for
``TapConvRunCore`` (``tap_conv_runs``: ``tap_conv_fwd_runs``).

The tap conv, the flow's dilated kernel-3 conv under
``FLSTTSC_CONV_IMPL=pallas`` (``conv_impl``, read per call):

* ``tap_conv(x_pad, w, dilation)`` is the VALID channel-last conv
  ``y[t] = sum_j x_pad[t + j*d] @ w[j]`` through ``TapConvCore``: for a
  CUDA tensor ``tap_conv_fwd`` (``csrc/tap_conv.cu``, the same tap GEMM
  with every tap live, replaces ``_tap_conv_kernel``; it takes float32
  only and raises on other dtypes),
  for a CPU tensor ``tap_conv_plain`` (k shifted matmuls, the JAX package's
  ``_tap_conv_xla``);
* its backward is the JAX package's ``_tap_conv_bwd``: dx is the same tap
  conv (the kernel again, through ``TapConvDxCore``) on g padded by (k-1)*d
  each side with the taps flipped and transposed, dw[j] one matmul per tap.
  Under a batch of cotangents (``stacked_pullbacks``) dx is one tap conv
  with the cotangents folded into the batch rows (into each run's rows for
  the runs form).
* ``tap_conv_runs(x_pad, w, dilation)``: K runs of one shape, x_pad (K, B,
  t_pad, C_in) and w (K, k, C_in, C_out): on CUDA ``tap_conv_fwd_runs``
  (the run on the kernel's grid, each run the one-run call's bits; a call
  whose K * B passes the grid's limit is split on the host), on the CPU the
  plain version run by run.  ``TapConvRunCore`` is its Function, with the
  same backward run by run (dx the runs tap conv, dw one batched product).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..structure import LayerSpec, mask_bounds
from . import _build, use_kernel

#: Launches of each kernel, counted by its wrapper where it launches; the
#: ``_runs`` entries count the run-axis launches (one a call, whatever K, unless the
#: grid's limit splits it, ``run_chunks``); the
#: bf16 instance counts under its own names.
LAUNCHES = {"os_conv_fwd": 0, "os_conv_fused_fwd": 0, "tap_conv_fwd": 0,
            "os_conv_fwd_runs": 0, "os_conv_fused_fwd_runs": 0,
            "os_conv_fwd[bf16]": 0, "os_conv_fwd_runs[bf16]": 0, "tap_conv_fwd_runs": 0}

#: The tap GEMM's main grid carries run * batch + b on its z axis (``csrc/tap_gemm.cuh``),
#: whose limit is 65,535 blocks: a run-axis conv with more rows is split on the host.
GRID_Z = 65535


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


def conv_impl() -> str:
    """How the flow's dilated convs are formulated: "pallas" (``tap_conv``,
    the tap-conv kernel on CUDA), "conv" (``F.conv1d``) or "im2col" (unfold
    + one einsum).  The same values and default as the JAX package, read
    per call."""
    return os.environ.get("FLSTTSC_CONV_IMPL", "conv")


# ------------------------------------------------------ plain versions ----

def os_conv_plain(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y[:, t] = sum_j x_pad[:, t+j] @ w[j]``: (B, T+K-1, C_in) -> (B, T, C_out).
    bf16 operands are widened to f32 (each product exact), summed in f32 and
    the sum rounded to bf16 (TF32 off on a card, as PyTorch's default for
    matmul), not left to a bf16 conv whose accumulation is unspecified."""
    if x_pad.dtype == torch.bfloat16:
        return os_conv_plain(x_pad.float(), w.float()).bfloat16()
    k = w.shape[0]
    t = x_pad.shape[1] - k + 1
    y = x_pad[:, :t] @ w[0]
    for j in range(1, k):
        y += x_pad[:, j : j + t] @ w[j]
    return y


def unfold1d(x_pad: torch.Tensor, k: int, dilation: int = 1) -> torch.Tensor:
    """im2col for conv1d: (..., T_pad, C) -> (..., T_out, k, C) by k slices."""
    t_out = x_pad.shape[-2] - (k - 1) * dilation
    return torch.stack(
        [x_pad[..., j * dilation : j * dilation + t_out, :] for j in range(k)], dim=-2
    )


def _conv_im2col(x_pad: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    return torch.einsum("...tki,kio->...to", unfold1d(x_pad, w.shape[0], dilation), w)


def tap_conv_plain(x_pad: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """``y[:, t] = sum_j x_pad[:, t + j*d] @ w[j]``: (B, t_pad, C_in) ->
    (B, t_pad - (k-1)*d, C_out), as k shifted matmuls."""
    k = w.shape[0]
    t_out = x_pad.shape[-2] - (k - 1) * dilation
    y = x_pad[..., :t_out, :] @ w[0]
    for j in range(1, k):
        y = y + x_pad[..., j * dilation : j * dilation + t_out, :] @ w[j]
    return y


def tap_windows_plain(w: torch.Tensor, group: int = 8) -> torch.Tensor:
    """``(ceil(C_out / group), 2)`` int32 tap windows of ``w`` (K, C_in, C_out):
    row g is ``[lo, hi)``, the span of taps j at which any ``w[j, :, cols of
    g]`` is nonzero, and ``(0, 0)`` when all of them are zero.  The plain
    mirror of the window search of ``csrc/tap_gemm.cuh``'s ``prep_kernel``."""
    k, _, c_out = w.shape
    n_groups = -(-c_out // group)
    live = F.pad((w != 0).any(dim=1), (0, n_groups * group - c_out))  # (K, padded C_out)
    live = live.reshape(k, n_groups, group).any(dim=2)  # (K, groups)
    taps = torch.arange(k, device=w.device).unsqueeze(1)
    lo = torch.where(live, taps, k).min(dim=0).values
    hi = torch.where(live, taps + 1, 0).max(dim=0).values
    empty = hi <= lo
    return torch.stack([lo.masked_fill(empty, 0), hi.masked_fill(empty, 0)], dim=1).to(torch.int32)


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
def _tap_lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/tap_conv.cu``."""
    lib = _build.load("tap_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tap_conv_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.tap_conv_fwd.restype = i
    lib.tap_conv_fwd_runs.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.tap_conv_fwd_runs.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/os_conv.cu``."""
    lib = _build.load("os_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.os_conv_fwd_runs.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.os_conv_fwd_runs.restype = i
    lib.os_conv_fused_fwd_runs.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, p]
    lib.os_conv_fused_fwd_runs.restype = i
    return lib


def _check_operands(x_pad: torch.Tensor, w: torch.Tensor, *vectors: torch.Tensor,
                    bf16: bool = False):
    """Shapes (B, t_pad, C_in), (K, C_in, C_out) and (C_out,) vectors, all
    contiguous float32 (or, where ``bf16`` allows it, all bfloat16) on
    x_pad's device; returns the output shape."""
    tensors = (x_pad, w) + vectors
    dtypes = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    for t in tensors:
        if t.device != x_pad.device:
            raise ValueError(f"operands on {t.device} and {x_pad.device}")
        if t.dtype not in dtypes or t.dtype != x_pad.dtype:
            what = "float32 or bfloat16, one for all" if bf16 else "float32"
            raise TypeError(f"the conv kernels take {what}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the conv kernels take contiguous tensors")
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


def _work(w: torch.Tensor, runs: int = 1) -> torch.Tensor:
    """The scratch of the tap GEMM's prep kernel for ``runs`` runs of w (K,
    C_in, C_out): each run's weights as the GEMM reads them, then each run's
    2 ints a group of 8 columns for the windows (K - lo, then hi).  float32
    (``csrc/tap_gemm.cuh`` ``work_words``): TF32 hi and lo planes, K x (C_in
    padded to 8) x (C_out padded to 64) words each; bfloat16
    (``csrc/tap_gemm_bf16.cuh`` ``bf16_work_words``): one bf16 copy of the
    same padded shape, half a word an element."""
    k, c_in, c_out = w.shape[-3:]
    elems = k * (-(-c_in // 8) * 8) * (-(-c_out // 64) * 64)
    words = (elems // 2 if w.dtype == torch.bfloat16 else 2 * elems) + 2 * -(-c_out // 8)
    return torch.empty(runs * words, device=w.device, dtype=torch.int32)


def _on(device: torch.device):
    """The context for launching on ``device``: a no-op where it is already
    the current device (the common case, and the cheap one)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def _launch(name: str, x_pad: torch.Tensor, w: torch.Tensor, out_shape, runs: int,
            epilogue=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ``os_conv_fwd_runs`` call, or ``os_conv_fused_fwd_runs`` with
    ``epilogue`` = (scale, shift, relu), on checked operands with ``runs``
    leading runs (none for a one-run call, which is the kernel's runs = 1),
    into ``out`` (contiguous, of ``out_shape``) or a new tensor, counted as
    ``name`` (``name[bf16]`` on bf16 operands, the bf16 instance)."""
    lib = _lib()
    bf16 = x_pad.dtype == torch.bfloat16
    y = torch.empty(out_shape, device=x_pad.device, dtype=x_pad.dtype) if out is None else out
    work = _work(w, runs)
    dims = (runs, *x_pad.shape[-3:], w.shape[-3], w.shape[-1])
    with _on(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        if epilogue is None:
            err = lib.os_conv_fwd_runs(x_pad.data_ptr(), w.data_ptr(), work.data_ptr(),
                                       y.data_ptr(), *dims, int(bf16), stream)
        else:
            scale, shift, relu = epilogue
            err = lib.os_conv_fused_fwd_runs(x_pad.data_ptr(), w.data_ptr(), work.data_ptr(),
                                             scale.data_ptr(), shift.data_ptr(), int(relu),
                                             y.data_ptr(), *dims, stream)
    name += "[bf16]" if bf16 else ""
    LAUNCHES[name] += 1
    _raise_on(err, name)
    return y


def _no_grad(name: str, *tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no gradient; call it under torch.inference_mode()")


def os_conv(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID conv ``sum_j x_pad[:, t+j] @ w[j]``, float32 or bfloat16;
    kernel on CUDA, plain on CPU."""
    if not use_kernel(x_pad):
        return os_conv_plain(x_pad, w)
    return _launch("os_conv_fwd", x_pad, w, _check_operands(x_pad, w, bf16=True), 1)


def os_conv_fused(
    x_pad: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    relu: bool,
) -> torch.Tensor:
    """``relu?(os_conv(x_pad, w) * scale + shift)`` with one store; kernel on
    CUDA, plain on CPU.  No gradient: inference only."""
    _no_grad("os_conv_fused", x_pad, w, scale, shift)
    if not use_kernel(x_pad):
        return os_conv_fused_plain(x_pad, w, scale, shift, relu)
    return _launch("os_conv_fused_fwd", x_pad, w, _check_operands(x_pad, w, scale, shift), 1,
                   (scale, shift, relu))


def _check_runs(x_pad: torch.Tensor, w: torch.Tensor, *vectors: torch.Tensor,
                bf16: bool = False):
    """x_pad (K, B, t_pad, C_in), w (K, Kt, C_in, C_out) and (K, C_out)
    vectors with one K (dtypes as ``_check_operands``): returns K and the
    output shape."""
    if x_pad.dim() != 4 or w.dim() != 4 or x_pad.shape[0] != w.shape[0]:
        raise ValueError(f"run shapes {tuple(x_pad.shape)} and {tuple(w.shape)} do not chain")
    runs = x_pad.shape[0]
    if any(v.dim() != 2 or v.shape[0] != runs for v in vectors):
        raise ValueError(f"epilogue vectors {[tuple(v.shape) for v in vectors]} for {runs} runs")
    out_shape = _check_operands(x_pad[0], w[0], *(v[0] for v in vectors), bf16=bf16)
    for t in (x_pad, w) + vectors:
        if not t.is_contiguous():
            raise ValueError("the conv kernels take contiguous tensors")
    return runs, (runs, *out_shape)


def _launch_runs(name: str, x_pad: torch.Tensor, w: torch.Tensor, out_shape,
                 vectors=(), relu: bool = False) -> torch.Tensor:
    """``_launch`` of K checked runs (the fused kernel where ``vectors`` =
    (scale, shift)), one launch a chunk of ``run_chunks``: one for K * B <=
    ``GRID_Z``, and a call past the grid's z limit split on the host."""
    chunks = run_chunks(out_shape[0], x_pad.shape[1])
    y = torch.empty(out_shape, device=x_pad.device, dtype=x_pad.dtype)
    for a, b in chunks:
        epilogue = (*(v[a:b] for v in vectors), relu) if vectors else None
        _launch(name, x_pad[a:b], w[a:b], (b - a, *out_shape[1:]), b - a, epilogue, y[a:b])
    return y


def os_conv_runs(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K independent ``os_conv`` calls of one shape, x_pad (K, B, t_pad,
    C_in) and w (K, Kt, C_in, C_out) -> (K, B, T, C_out), float32 or
    bfloat16: on CUDA one ``os_conv_fwd_runs`` launch (the kernel with the run
    on its grid; one a ``run_chunks`` chunk past the grid's limit), on the
    CPU the plain version run by run."""
    if not use_kernel(x_pad):
        return torch.stack([os_conv_plain(xk, wk) for xk, wk in zip(x_pad, w)])
    _, out_shape = _check_runs(x_pad, w, bf16=True)
    return _launch_runs("os_conv_fwd_runs", x_pad, w, out_shape)


def os_conv_fused_runs(x_pad: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """K independent ``os_conv_fused`` calls of one shape (scale and shift
    (K, C_out)): on CUDA one ``os_conv_fused_fwd_runs`` launch (split as
    ``os_conv_runs``), on the CPU the plain version run by run.  No
    gradient: inference only."""
    _no_grad("os_conv_fused_runs", x_pad, w, scale, shift)
    if not use_kernel(x_pad):
        return torch.stack([os_conv_fused_plain(*args, relu)
                            for args in zip(x_pad, w, scale, shift)])
    _, out_shape = _check_runs(x_pad, w, scale, shift)
    return _launch_runs("os_conv_fused_fwd_runs", x_pad, w, out_shape, (scale, shift), relu)


def tap_conv_fwd(x_pad: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The tap-conv kernel on CUDA tensors; same contract as ``tap_conv_plain``."""
    if x_pad.device.type != "cuda":
        raise ValueError(f"tap_conv_fwd takes CUDA tensors, got {x_pad.device}")
    _check_operands(x_pad, w)
    b, t_pad, c_in = x_pad.shape
    k, _, c_out = w.shape
    t_out = t_pad - (k - 1) * dilation
    if dilation < 1 or t_out < 1:
        raise ValueError(f"unsupported dilation {dilation} for t_pad={t_pad}, k={k}")
    lib = _tap_lib()
    y = torch.empty(b, t_out, c_out, device=x_pad.device, dtype=torch.float32)
    work = _work(w)
    with _on(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tap_conv_fwd(x_pad.data_ptr(), w.data_ptr(), work.data_ptr(), y.data_ptr(),
                               b, t_pad, c_in, k, c_out, dilation, stream)
    LAUNCHES["tap_conv_fwd"] += 1
    _raise_on(err, "tap_conv_fwd")
    return y


def run_chunks(runs: int, batch: int, limit: Optional[int] = None):
    """The ``[start, stop)`` run ranges of the run-axis conv launches
    (``os_conv_fwd_runs``, ``os_conv_fused_fwd_runs``, ``tap_conv_fwd_runs``)
    that K = ``runs`` runs of ``batch`` rows take: as many runs a call as
    the grid's z axis holds (runs * batch <= ``limit``, ``GRID_Z`` by
    default), in order."""
    limit = GRID_Z if limit is None else limit
    if batch > limit:
        raise ValueError(f"a batch of {batch} exceeds the grid's {limit}")
    per = limit // batch
    return [(s, min(s + per, runs)) for s in range(0, runs, per)]


def tap_conv_fwd_runs(x_pad: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The tap-conv kernel over K runs on CUDA tensors: x_pad (K, B, t_pad,
    C_in), w (K, k, C_in, C_out) -> (K, B, t_out, C_out), every run the
    one-run call's bits; one ``tap_conv_fwd_runs`` launch set a chunk of
    ``run_chunks`` (one for K * B <= ``GRID_Z``)."""
    if x_pad.device.type != "cuda":
        raise ValueError(f"tap_conv_fwd_runs takes CUDA tensors, got {x_pad.device}")
    if x_pad.dim() != 4 or w.dim() != 4 or x_pad.shape[0] != w.shape[0]:
        raise ValueError(f"run shapes {tuple(x_pad.shape)} and {tuple(w.shape)} do not chain")
    _check_operands(x_pad[0], w[0])
    for t in (x_pad, w):
        if not t.is_contiguous():
            raise ValueError("the conv kernels take contiguous tensors")
    runs, b, t_pad, c_in = x_pad.shape
    k, _, c_out = w.shape[1:]
    t_out = t_pad - (k - 1) * dilation
    if dilation < 1 or t_out < 1:
        raise ValueError(f"unsupported dilation {dilation} for t_pad={t_pad}, k={k}")
    lib = _tap_lib()
    y = torch.empty(runs, b, t_out, c_out, device=x_pad.device, dtype=torch.float32)
    for start, stop in run_chunks(runs, b):
        work = _work(w, stop - start)
        with _on(x_pad.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.tap_conv_fwd_runs(x_pad[start].data_ptr(), w[start].data_ptr(),
                                        work.data_ptr(), y[start].data_ptr(), stop - start, b,
                                        t_pad, c_in, k, c_out, dilation, stream)
        LAUNCHES["tap_conv_fwd_runs"] += 1
        _raise_on(err, "tap_conv_fwd_runs")
    return y


def tap_conv_runs(x_pad: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """K independent ``tap_conv`` forwards of one shape, x_pad (K, B, t_pad,
    C_in) and w (K, k, C_in, C_out) -> (K, B, t_out, C_out): on CUDA
    ``tap_conv_fwd_runs``, on the CPU the plain version run by run."""
    if not use_kernel(x_pad):
        return torch.stack([tap_conv_plain(xk, wk, dilation) for xk, wk in zip(x_pad, w)])
    return tap_conv_fwd_runs(x_pad, w, dilation)


# ----------------------------------------------------------- gradient -----

def _os_conv_bwd(x_pad, w, g, need_dx: bool, need_dw: bool):
    """dx and dw of ``os_conv`` (None where not needed): the transposed
    convs in torch's (N, C, T) layout."""
    w_oik = w.permute(2, 1, 0)  # (C_out, C_in, K), torch's conv layout
    g_ncw = g.transpose(1, 2)
    dx = dw = None
    if need_dx:
        dx = torch.nn.grad.conv1d_input(
            (x_pad.shape[0], x_pad.shape[2], x_pad.shape[1]), w_oik, g_ncw
        ).transpose(1, 2)
    if need_dw:
        dw = torch.nn.grad.conv1d_weight(
            x_pad.transpose(1, 2), w_oik.shape, g_ncw
        ).permute(2, 1, 0)
    return dx, dw


def os_conv_runs_bwd_grouped(x_pad, w, g, need_dx: bool, need_dw: bool):
    """dx and dw of ``os_conv_runs`` for all K runs at once: one transposed
    conv each with ``groups=K`` over the runs' channels side by side,
    x_pad (K, B, t_pad, C_in) -> (B, K*C_in, t_pad), w (K, Kt, C_in, C_out)
    -> (K*C_out, C_in, Kt), g (K, B, T, C_out) -> (B, K*C_out, T)."""
    runs, b, t_pad, c_in = x_pad.shape
    _, k, _, c_out = w.shape
    w_oik = w.permute(0, 3, 2, 1).reshape(runs * c_out, c_in, k)
    g_ncw = g.permute(1, 0, 3, 2).reshape(b, runs * c_out, g.shape[2])
    dx = dw = None
    if need_dx:
        dx = torch.nn.grad.conv1d_input((b, runs * c_in, t_pad), w_oik, g_ncw, groups=runs)
        dx = dx.reshape(b, runs, c_in, t_pad).permute(1, 0, 3, 2)
    if need_dw:
        x_ncw = x_pad.permute(1, 0, 3, 2).reshape(b, runs * c_in, t_pad)
        dw = torch.nn.grad.conv1d_weight(x_ncw, w_oik.shape, g_ncw, groups=runs)
        dw = dw.reshape(runs, c_out, c_in, k).permute(0, 3, 2, 1)
    return dx, dw


def _runs_first(info, in_dims, *tensors):
    """The vmap rule's operands with the run axis first and contiguous (an
    operand that is not batched is expanded to every run)."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)
        out.append(t.contiguous())
    return out


class OSConvCore(torch.autograd.Function):
    """``os_conv`` with the plain transposed conv as its backward; under
    ``torch.func.vmap`` one ``OSConvRunCore`` call for all runs."""

    @staticmethod
    def forward(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return os_conv(x_pad, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x_pad, w = ctx.saved_tensors
        return _os_conv_bwd(x_pad, w, g, *ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, x_pad, w):
        return OSConvRunCore.apply(*_runs_first(info, in_dims, x_pad, w)), 0


class OSConvRunCore(torch.autograd.Function):
    """K runs of the conv, x_pad (K, B, t_pad, C_in) and w (K, Kt, C_in,
    C_out): ``os_conv_runs`` forward; backward the grouped transposed conv
    on CUDA, the one-run backward run by run on the CPU."""

    @staticmethod
    def forward(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return os_conv_runs(x_pad, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x_pad, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        if use_kernel(g):
            return os_conv_runs_bwd_grouped(x_pad, w, g.contiguous(), *need)
        per_run = [_os_conv_bwd(xk, wk, gk, *need) for xk, wk, gk in zip(x_pad, w, g)]
        return tuple(torch.stack(d) if n else None for d, n in zip(zip(*per_run), need))


class OSConvFusedCore(torch.autograd.Function):
    """``os_conv_fused`` (no gradient) with a vmap rule: under
    ``torch.func.vmap`` one ``os_conv_fused_runs`` call for all runs."""

    @staticmethod
    def forward(x_pad, w, scale, shift, relu: bool):
        return os_conv_fused(x_pad, w, scale, shift, relu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("os_conv_fused has no gradient")

    @staticmethod
    def vmap(info, in_dims, x_pad, w, scale, shift, relu):
        args = _runs_first(info, in_dims[:4], x_pad, w, scale, shift)
        return os_conv_fused_runs(*args, relu), 0


def _tap(x_pad: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The tap conv of one run (w 3-D) or of K runs (w 4-D, ``tap_conv_runs``):
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if w.dim() == 4:
        return tap_conv_runs(x_pad, w, dilation)
    if use_kernel(x_pad):
        return tap_conv_fwd(x_pad, w, dilation)
    return tap_conv_plain(x_pad, w, dilation)


def _tap_dx(g: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """dx_pad of a tap conv (of one run, or of K runs with g and w run-first):
    ``dx_pad[s] = sum_j g[s - j*d] @ w[j].T``, the tap conv of g padded by
    (k-1)*d each side with the flipped, transposed taps, through
    ``TapConvDxCore``."""
    lp = (w.shape[-3] - 1) * dilation
    w_t = torch.flip(w, (-3,)).transpose(-2, -1).contiguous()
    return TapConvDxCore.apply(F.pad(g, (0, 0, lp, lp)), w_t, dilation)


def _tap_dw(x_pad: torch.Tensor, g: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    """dw of a tap conv, one product a tap: ``dw[j] = x_pad[:, j*d : j*d +
    t_out]^T @ g`` over every row, of one run or batched over K leading runs."""
    lead = g.shape[:-3]  # () or (K,)
    rows = g.shape[-3] * g.shape[-2]
    t_out, c_in = g.shape[-2], x_pad.shape[-1]
    g2 = g.reshape(*lead, rows, g.shape[-1])
    return torch.stack([
        x_pad[..., j * dilation : j * dilation + t_out, :].reshape(*lead, rows, c_in)
        .transpose(-2, -1) @ g2 for j in range(k)], dim=len(lead))


class TapConvDxCore(torch.autograd.Function):
    """The tap conv's input gradient, the tap conv of the padded g with the
    flipped, transposed taps, as an op of its own: the kernel on CUDA, the
    plain version on the CPU; one run (w_t 3-D) or K runs (w_t 4-D, the
    runs kernel).  Its vmap rule takes a batch of cotangents
    (``train/pipeline.py`` ``batched_pull``: g batched, the taps shared) as
    ONE tap conv with the cotangent axis folded into the batch rows (each
    run's rows for the runs form), and batched taps as a run axis (joined
    with the runs form's own).  No gradient of its own."""

    @staticmethod
    def forward(g_pad: torch.Tensor, w_t: torch.Tensor, dilation: int) -> torch.Tensor:
        return _tap(g_pad, w_t, dilation)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the tap conv's input gradient has no gradient of its own")

    @staticmethod
    def vmap(info, in_dims, g_pad, w_t, dilation):
        g_dim, w_dim = in_dims[:2]
        if w_dim is None:
            # a cotangent batch (N, [K,] B, t_pad, C): N folded into the batch rows
            g = g_pad.movedim(g_dim, 0)
            runs = w_t.dim() == 4
            if runs:
                g = g.transpose(0, 1)  # (K, N, B, ...)
            lead = g.shape[: 2 + runs]
            y = _tap(g.reshape(*lead[:-2], lead[-2] * lead[-1], *g.shape[2 + runs:]).contiguous(),
                     w_t, dilation)
            y = y.reshape(*lead, *y.shape[1 + runs:])
            return (y.transpose(0, 1) if runs else y), 0
        # batched taps: the vmap axis is (or joins) the run axis
        w = w_t.movedim(w_dim, 0)
        g = (g_pad.movedim(g_dim, 0) if g_dim is not None
             else g_pad.expand(info.batch_size, *g_pad.shape))
        if w.dim() == 4:
            return _tap(g.contiguous(), w.contiguous(), dilation), 0
        n, k = w.shape[:2]
        y = _tap(g.reshape(n * k, *g.shape[2:]).contiguous(),
                 w.reshape(n * k, *w.shape[2:]).contiguous(), dilation)
        return y.reshape(n, k, *y.shape[1:]), 0


class TapConvCore(torch.autograd.Function):
    """The tap conv with the JAX package's hand-written backward; under
    ``torch.func.vmap`` one ``TapConvRunCore`` call for all runs."""

    @staticmethod
    def forward(x_pad: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
        return _tap(x_pad, w, dilation)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x_pad, w, dilation = inputs
        ctx.save_for_backward(x_pad, w)
        ctx.dilation = dilation

    @staticmethod
    def vmap(info, in_dims, x_pad, w, dilation):
        return TapConvRunCore.apply(*_runs_first(info, in_dims[:2], x_pad, w), dilation), 0

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x_pad, w = ctx.saved_tensors
        d = ctx.dilation
        dx = _tap_dx(g, w, d) if ctx.needs_input_grad[0] else None
        dw = _tap_dw(x_pad, g, w.shape[-3], d) if ctx.needs_input_grad[1] else None
        return dx, dw, None


class TapConvRunCore(TapConvCore):
    """K runs of the tap conv, x_pad (K, B, t_pad, C_in) and w (K, k, C_in,
    C_out): ``tap_conv_runs`` forward; the backward of JAX's
    ``_tap_conv_bwd`` run by run, dx the runs tap conv (``TapConvDxCore``
    with 4-D taps), dw one batched product a tap (JAX too takes dw outside
    its kernel).  Under ``torch.func.vmap`` the vmap axis joins the run axis."""

    @staticmethod
    def vmap(info, in_dims, x_pad, w, dilation):
        x, w = _runs_first(info, in_dims[:2], x_pad, w)  # (N, K, ...)
        n, k = w.shape[:2]
        y = TapConvRunCore.apply(x.reshape(n * k, *x.shape[2:]), w.reshape(n * k, *w.shape[2:]),
                                 dilation)
        return y.reshape(n, k, *y.shape[1:]), 0


def tap_conv(x_pad: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """VALID dilated conv1d, channel-last: (B, t_pad, C_in) x (k, C_in, C_out)
    -> (B, t_pad - (k-1)*dilation, C_out), with its gradient."""
    return TapConvCore.apply(x_pad, w, dilation)


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
            return OSConvFusedCore.apply(x_pad, w, scale.contiguous(), eff_shift, relu)
        y = OSConvCore.apply(x_pad, w) * scale + eff_shift
        return torch.relu(y) if relu else y
    y = OSConvCore.apply(x_pad, w) + bias
    return torch.relu(y) if relu else y
