"""The WaveNet coupling net (WN) of one flow step as two hand-written kernels.

Counterpart of the JAX package's ``ops/wn_fused.py``.  The whole coupling net
(start 1x1, L layers of a kernel-3 conv with dilation ``2**i`` plus the cond
slice, the tanh*sigmoid gate, the res/skip 1x1 with the last layer
zero-embedded, the end 1x1) runs on the batch collapsed into rows,
``(B*T, C)``, with position masks ``pos = row % T`` in place of padding:

* ``wn_fwd`` (CUDA, ``csrc/wn_fused.cu``) replaces ``_wn_fwd_kernel``; it
  returns y, the per-layer audio ``aud`` (L, R, C) and the skip sum, every
  layer product a 3xTF32 tensor-core GEMM over tiles of rows;
* ``wn_bwd`` replaces ``_wn_bwd_kernel``: the reverse layer walk recomputing
  z from ``aud``, the input gradient and every weight gradient; the end
  projection's gradients (and ``gbc``, equal to ``gbi``) are taken outside,
  as the JAX package does (``wn_fused.py:444-450``).
* Their bf16 instances are kernel sets of their own (``csrc/wn_fwd_bf16.cuh``,
  ``csrc/wn_bwd_bf16.cuh``): bf16 copies of the operands written once, bf16
  weight planes, native bf16 tensor-core products; the backward's bias
  gradients as f32 tile sums.

Beside each kernel is its plain PyTorch version, ``wn_fwd_plain`` and
``wn_bwd_plain`` (the backward written out, not by autograd).  ``WNCore`` is
the ``autograd.Function`` over the stacked effective weights; like every op
of the port it takes the kernels for a CUDA tensor and the plain versions
for a CPU tensor.  ``stack_effective`` builds those weights from the
weight-normed parameters in differentiable torch.

Runs (``train/multirun.py``): under ``torch.func.vmap`` over K independent
runs, ``WNCore``'s vmap rule calls ``WNRunCore`` once on ``x (K, B, T, H)``
and the K-stacked effective weights: on CUDA ``wn_fwd_runs`` and
``wn_bwd_runs`` (``csrc/wn_fused.cu`` with the run on a grid axis of every
kernel: the launches of one run, each run's bits a one-run call's), on the
CPU the plain versions run by run.

Cotangent batches (``PipelineConfig.stacked_pullbacks``): both Functions'
backwards go through ``WNBwdCore``, whose vmap rule takes a batch of
cotangents as the runs of ONE ``wn_bwd_runs`` call, so each cotangent gets
the one-cotangent call's bits and the launches are those of one call.

bf16 operands (``FLSTTSC_WN_MXU=bf16``, read per call by ``mxu_bf16`` as
the JAX package's ``_mxu_bf16``): every product the JAX kernels take through
``_dot`` (each layer product of both directions, and ``gwe`` outside them)
rounds both operands to bf16 and sums the exact products in f32; biases, the
gate, masks, the residual and skip sums and the bias gradients stay f32.
``WNCore`` and ``WNRunCore`` take the flag as their last argument: on CUDA
the kernels' bf16 instances (counted as ``wn_fwd[bf16]``, ...), on the CPU
the plain versions with ``bf16=True``.  The op-by-op route ignores it, as
in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build, use_kernel

#: Launches of each host entry, counted by its wrapper where it launches; the
#: ``_runs`` entries count the run-axis calls (one a call, whatever K); the
#: bf16 instances count under their own names (``wn_fwd[bf16]``, ...).
ENTRIES = ("wn_fwd", "wn_bwd", "wn_fwd_runs", "wn_bwd_runs")
LAUNCHES = {name + tag: 0 for tag in ("", "[bf16]") for name in ENTRIES}

#: Input rows a stage of ``wn_bwd``'s weight-gradient kernel (``WG_RB`` in
#: ``csrc/wn_fused.cu``), and reduction columns a stage of the f32 row-tile
#: products of both directions (``RT_KS``); a row slice is a whole number of
#: stages, which the C entry checks.
STAGE_ROWS = 32
#: The same two of the bf16 kernels (``H_RB``, ``H_KS`` in
#: ``csrc/wn_bwd_bf16.cuh``; the bf16 forward's stages are ``H_KS`` deep).
BF16_STAGE = 128
#: Rows of a tile whose f32 column sums make the bf16 backward's bias
#: gradients (``H_TILE``): its slices are whole tiles.
BF16_TILE = 64
#: bf16 values a 16-byte chunk: the bf16 kernels pad every row they stage
#: (and g_z's two halves) to a multiple of it.
BF16_CHUNK = 8
#: Most rows a weight-gradient slice of ``wn_bwd`` (partials summed in slice order).
SPLIT_ROWS = 1024
#: Fewest slices a weight-gradient reduction is cut into, where the rows allow:
#: enough blocks to fill the card on short series.
MIN_SLICES = 64
#: Widest WN channel count C the kernels take (``FlowConfig.wn_channels`` is
#: 120); the half width H may be any.
MAX_C = 128
#: Most layers: the dilation ``2**i`` is an int shift in the kernels.
MAX_LAYERS = 30


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def mxu_bf16() -> bool:
    """``FLSTTSC_WN_MXU=bf16``: the fused WN's products on bf16 operands (f32
    sums); any other value (default "f32") keeps them f32.  Read per call."""
    return os.environ.get("FLSTTSC_WN_MXU", "f32") == "bf16"


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def wgrad_split_rows(rows: int, bf16: bool = False) -> int:
    """Rows of each slice of ``wn_bwd``'s weight-gradient reductions: a
    multiple of STAGE_ROWS (bf16: of BF16_TILE, whole tiles), at most
    SPLIT_ROWS, and small enough for MIN_SLICES slices where ``rows``
    allows."""
    stage = BF16_TILE if bf16 else STAGE_ROWS
    return min(SPLIT_ROWS, _round_up(-(-rows // MIN_SLICES), stage))


def global_kernels(n_layers: int, bf16: bool = False) -> Dict[str, Dict[str, int]]:
    """``__global__`` launches per call of each host entry, by kernel (the
    name without its template arguments): ``wn_fwd`` (bf16:
    ``csrc/wn_fwd_bf16.cuh``'s) and ``wn_bwd`` (bf16:
    ``csrc/wn_bwd_bf16.cuh``'s)."""
    if bf16:
        fwd = {"bf16_copies_kernel": 1, "wsplit16_fwd_kernel": 1, "rowgemm_kernel": 1,
               "wn_layer_fwd16_kernel": n_layers}
    else:
        fwd = {"wsplit_fwd_kernel": 1, "rowgemm_kernel": 1, "wn_layer_fwd_kernel": n_layers}
    wgrads = 2 * n_layers + 1  # per layer res/skip and in, then the start's
    if bf16:
        bwd = {"bf16_copies_kernel": 1, "wsplit16_kernel": 1, "gskip16_kernel": 1,
               "wn_layer_gz16_kernel": n_layers, "wn_layer_ga16_kernel": n_layers,
               "wgrad16_kernel": wgrads, "reduce_partials_kernel": wgrads, "rowgemm_kernel": 1}
    else:
        bwd = {"wsplit_kernel": 1, "rowgemm_kernel": 2, "wn_layer_gz_kernel": n_layers,
               "wn_layer_ga_kernel": n_layers, "wgrad_kernel": wgrads,
               "reduce_partials_kernel": wgrads}
    return {"wn_fwd": fwd, "wn_bwd": bwd}


def global_launches(n_layers: int, bf16: bool = False) -> Dict[str, int]:
    """``__global__`` launches per call of each host entry: ``wn_fwd`` 2 + L
    (bf16: 3 + L), ``wn_bwd`` 5 + 6L (bf16: 6 + 6L)."""
    return {name: sum(k.values()) for name, k in global_kernels(n_layers, bf16).items()}


def fwd_row_tile(rows: int, sms: int) -> int:
    """Rows a tile of ``wn_fwd``'s layer kernels (both instances; the
    library's ``fwd_row_tile`` mirrored) on a card of ``sms`` SMs: 64,
    halved while the smaller tiles still fit one wave of a block an SM, down
    to 16.  Chosen from one run's rows."""
    mt = 4
    while mt > 1 and -(-rows // (8 * mt)) <= sms:
        mt //= 2
    return 16 * mt


def fwd_wsplit_words(rows: int, c: int, h: int, n_layers: int, bf16: bool = False) -> int:
    """32-bit words of one run's ``wsplit`` scratch of ``wn_fwd`` (the
    library's ``wn_fwd_wsplit_words`` mirrored).  f32: every layer's TF32
    hi/lo weight planes, (output column, reduction) with the reduction
    padded to whole STAGE_ROWS-column stages, z (2Cp, 3C+H) and res/skip
    (2Cp, C), then the end projection's (Ep, C), Cp and Ep C and 2H rounded
    up to 8.  bf16: the bf16 work area, in bf16 values every layer's bf16
    planes (the reduction in the padded layout of its operand, whole stages
    of BF16_STAGE columns: z (2Cp, 3Cp+Hp), res/skip (2Cp, Cp)), the end
    projection's (Ep, Cp), the bf16 copies of x (R, Hp), the aud ping-pong
    (2, R, Cp), acts and skip (R, Cp each); rounded up to 4 words."""
    cp, hp, ep = (_round_up(v, BF16_CHUNK) for v in (c, h, 2 * h))
    stage = BF16_STAGE if bf16 else STAGE_ROWS

    def ks(v):
        return _round_up(v, stage)
    if not bf16:
        return n_layers * 2 * 2 * cp * (ks(3 * c + h) + ks(c)) + 2 * ep * ks(c)
    values = n_layers * 2 * cp * (ks(3 * cp + hp) + ks(cp)) + ep * ks(cp) + rows * (hp + 4 * cp)
    return _round_up(-(-values // 2), 4)


def fwd_scratch(runs: int, rows: int, c: int, n_layers: int, bf16: bool, wsplit_words: int,
                device) -> list:
    """The scratch of one ``wn_fwd_runs`` call in its argument order (acts,
    wsplit), ``wsplit_words`` 32-bit words of wsplit a run: f32, the acts of
    each layer (runs, R, C) between its two products; bf16, none (its bf16
    copy lives in wsplit's work area)."""
    acts = torch.empty(0 if bf16 else runs * rows * c, device=device)
    return [acts, torch.empty(runs * wsplit_words, dtype=torch.int32, device=device)]


def bwd_wsplit_words(rows: int, c: int, h: int, n_layers: int, bf16: bool = False) -> int:
    """32-bit words of one run's ``wsplit`` scratch of ``wn_bwd`` (the
    library's ``wn_bwd_wsplit_words`` mirrored).  f32: every layer's TF32
    hi/lo weight planes, (output column, reduction) with the reduction
    padded to whole 32-column stages: z (2Cp, 3C+H), g_acts (Cp, 2C), the
    transposed taps (Cp, 6C), the cond input gradient (Hp, 2C), Cp and Hp C
    and H rounded up to 8.  bf16: the bf16 work area, in bf16 values every
    layer's bf16 planes (the reduction in the padded layout of its operand,
    whole stages of BF16_STAGE columns: z (2Cp, 3Cp+Hp), g_acts (Cp, 2Cp),
    taps (Cp, 6Cp), cond (Hp, 2Cp)), the bf16 copies of aud (L, R, Cp), x
    (R, Hp), g_skip, g_audio (R, Cp), g_z (R, 2Cp) and acts (R, Cp); then in
    floats the column sums of each tile of BF16_TILE rows of g_z (2C),
    g_audio and g_skip (C each); rounded up to 4 words."""
    cp, hp = _round_up(c, BF16_CHUNK), _round_up(h, BF16_CHUNK)
    if not bf16:
        def ks(v):
            return _round_up(v, STAGE_ROWS)
        return n_layers * 2 * (2 * cp * ks(3 * c + h) + cp * ks(2 * c) + cp * ks(6 * c)
                               + hp * ks(2 * c))

    def ks(v):
        return _round_up(v, BF16_STAGE)
    layer = 2 * cp * ks(3 * cp + hp) + cp * ks(2 * cp) + cp * ks(6 * cp) + hp * ks(2 * cp)
    values = n_layers * layer + rows * (n_layers * cp + hp + 5 * cp)
    tiles = -(-rows // BF16_TILE)
    return _round_up(values // 2 + tiles * 4 * c, 4)


def stack_effective(params: Dict, weight_norm_weight) -> Tuple[torch.Tensor, ...]:
    """Effective (post weight-norm) tensors, stacked, with the last res/skip
    layer embedded into columns [C, 2C) of a zero (C, 2C) weight.
    Differentiable: autograd carries the gradients back to v/g."""
    n_layers = len(params["in_layers"])
    c = params["start"]["v"].shape[-1]
    w_in = torch.stack([weight_norm_weight(p) for p in params["in_layers"]])
    b_in = torch.stack([p["bias"] for p in params["in_layers"]])
    rs_w, rs_b = [], []
    for i, p in enumerate(params["res_skip_layers"]):
        w, b = weight_norm_weight(p)[0], p["bias"]
        if i == n_layers - 1:  # all-skip layer -> cols [c:2c), zero audio block
            w = torch.cat([torch.zeros_like(w), w], dim=1)
            b = torch.cat([torch.zeros_like(b), b])
        rs_w.append(w)
        rs_b.append(b)
    return (
        weight_norm_weight(params["start"])[0], params["start"]["bias"],
        weight_norm_weight(params["cond"])[0], params["cond"]["bias"],
        w_in, b_in, torch.stack(rs_w), torch.stack(rs_b),
        params["end"]["weight"], params["end"]["bias"],
    )


# ------------------------------------------------------ plain versions ----

def _shift(a: torch.Tensor, s: int) -> torch.Tensor:
    """``out[r] = a[r + s]``, zero where ``r + s`` is outside the rows."""
    rows = a.shape[0]
    if s == 0:
        return a
    if abs(s) >= rows:
        return torch.zeros_like(a)
    if s > 0:
        return F.pad(a[s:], (0, 0, 0, s))
    return F.pad(a[: rows + s], (0, 0, -s, 0))


def _mm(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``a @ b``, with bf16: both operands rounded to bf16 (nearest, ties to
    even) and widened back, so that each product is exact and the sum f32
    (the JAX package's ``_dot`` with ``preferred_element_type=f32``)."""
    if bf16:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    return a @ b


def _masks(rows: int, t_len: int, d: int, device):
    pos = torch.arange(rows, device=device) % t_len
    lo = (pos >= d).to(torch.float32)[:, None]
    hi = (pos < t_len - d).to(torch.float32)[:, None]
    return lo, hi


def wn_fwd_plain(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end, b_end,
                 t_len: int, bf16: bool = False):
    """The forward on rows: x2 (R, H) -> (y (R, 2H), aud (L, R, C), skip (R,
    C)); ``bf16``: every product on bf16 operands (``_mm``)."""
    n_layers, taps, c, _ = w_in.shape
    if taps != 3:
        raise ValueError(f"w_in of shape {tuple(w_in.shape)} is not (L, 3, C, 2C)")
    rows = x2.shape[0]
    audio = _mm(x2, w_start, bf16) + b_start
    spect = _mm(x2, w_cond, bf16) + b_cond
    skip = torch.zeros_like(audio)
    aud = []
    for i in range(n_layers):
        d = 2 ** i
        lo, hi = _masks(rows, t_len, d, x2.device)
        aud.append(audio)
        z = (
            _mm(lo * _shift(audio, -d), w_in[i, 0], bf16) + _mm(audio, w_in[i, 1], bf16)
            + _mm(hi * _shift(audio, d), w_in[i, 2], bf16)
            + b_in[i] + spect[:, 2 * c * i : 2 * c * (i + 1)]
        )
        acts = torch.tanh(z[:, :c]) * torch.sigmoid(z[:, c:])
        rs = _mm(acts, w_rs[i], bf16) + b_rs[i]
        audio = audio + rs[:, :c]
        skip = skip + rs[:, c:]
    return _mm(skip, w_end, bf16) + b_end, torch.stack(aud), skip


def wn_fwd_plain_layers(x2, aud, skip, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs,
                        w_end, b_end, t_len: int, bf16: bool = False):
    """``wn_fwd_plain`` taken layer by layer from given inputs: each layer's
    input ``aud[i]`` and the skip sum ``skip`` (another forward's, e.g. a
    kernel's) -> (each layer's input from the one before it, (L, R, C); the
    skip sum; y from ``skip``).  Held against that forward's own aud, skip
    and y, it checks every product without carrying an earlier layer's
    rounding into a later one."""
    n_layers, _, c, _ = w_in.shape
    rows = x2.shape[0]
    inputs = [_mm(x2, w_start, bf16) + b_start]
    spect = _mm(x2, w_cond, bf16) + b_cond
    skip_sum = torch.zeros_like(inputs[0])
    for i in range(n_layers):
        d = 2 ** i
        lo, hi = _masks(rows, t_len, d, x2.device)
        a = aud[i]
        z = (_mm(lo * _shift(a, -d), w_in[i, 0], bf16) + _mm(a, w_in[i, 1], bf16)
             + _mm(hi * _shift(a, d), w_in[i, 2], bf16)
             + b_in[i] + spect[:, 2 * c * i : 2 * c * (i + 1)])
        rs = _mm(torch.tanh(z[:, :c]) * torch.sigmoid(z[:, c:]), w_rs[i], bf16) + b_rs[i]
        inputs.append(a + rs[:, :c])
        skip_sum = skip_sum + rs[:, c:]
    return torch.stack(inputs[:n_layers]), skip_sum, _mm(skip, w_end, bf16) + b_end


def wn_bwd_plain(x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end,
                 t_len: int, bf16: bool = False):
    """The backward of ``wn_fwd_plain`` written out, as ``_wn_bwd_kernel``
    computes it.  Returns the gradients of (x2, w_start, b_start, w_cond,
    b_cond, w_in, b_in, w_rs, b_rs, w_end, b_end); ``bf16``: every product on
    bf16 operands, the bias gradients f32 sums."""
    n_layers, _, c, _ = w_in.shape
    rows = x2.shape[0]
    b_z = b_in + b_cond.reshape(n_layers, 2 * c)
    g_skip = _mm(g2, w_end.T, bf16)
    g_audio = torch.zeros_like(g_skip)
    g_x = torch.zeros_like(x2)
    gwi, gbi, gwr, gbr, gwc = [], [], [], [], []
    for i in reversed(range(n_layers)):
        d = 2 ** i
        lo, hi = _masks(rows, t_len, d, x2.device)
        audio = aud[i]
        a_lo, a_hi = lo * _shift(audio, -d), hi * _shift(audio, d)
        w_c = w_cond[:, 2 * c * i : 2 * c * (i + 1)]
        z = (_mm(a_lo, w_in[i, 0], bf16) + _mm(audio, w_in[i, 1], bf16)
             + _mm(a_hi, w_in[i, 2], bf16) + b_z[i] + _mm(x2, w_c, bf16))
        tt, ss = torch.tanh(z[:, :c]), torch.sigmoid(z[:, c:])
        acts = tt * ss
        g_rs = torch.cat([g_audio, g_skip], dim=1)
        gwr.append(_mm(acts.T, g_rs, bf16))
        gbr.append(g_rs.sum(0))
        g_acts = _mm(g_rs, w_rs[i].T, bf16)
        g_z = torch.cat([g_acts * ss * (1 - tt * tt), g_acts * tt * ss * (1 - ss)], dim=1)
        gwi.append(torch.stack([_mm(a.T, g_z, bf16) for a in (a_lo, audio, a_hi)]))
        gbi.append(g_z.sum(0))
        gwc.append(_mm(x2.T, g_z, bf16))
        g_x = g_x + _mm(g_z, w_c.T, bf16)
        g_audio = (
            g_audio + _mm(_shift(lo * g_z, d), w_in[i, 0].T, bf16) + _mm(g_z, w_in[i, 1].T, bf16)
            + _mm(_shift(hi * g_z, -d), w_in[i, 2].T, bf16)
        )
    gbi = torch.stack(gbi[::-1])
    return (
        g_x + _mm(g_audio, w_start.T, bf16),
        _mm(x2.T, g_audio, bf16), g_audio.sum(0),
        torch.cat(gwc[::-1], dim=1), gbi.reshape(-1),
        torch.stack(gwi[::-1]), gbi,
        torch.stack(gwr[::-1]), torch.stack(gbr[::-1]),
        _mm(skip.T, g2, bf16), g2.sum(0),
    )


def _unpack(gx, g_in, g_rs, g_start, skip, g2, bf16: bool = False):
    """``wn_bwd``'s outputs in ``wn_bwd_plain``'s order from the kernel's
    layouts: g_in (L, 3C+H+1, 2C) = per layer [gwi | gwc slice | gbi], g_rs
    (L, C+1, 2C) = [gwr | gbr], g_start (H+1, C) = [gws | gbs]; the end
    projection's gradients are taken here, as the JAX package does (with
    ``bf16``, one f32 product of bf16-rounded operands, never a bf16 matmul,
    whose output would round).  Every tensor may carry leading run axes
    (``wn_bwd_runs``)."""
    n_layers, k_in, c2 = g_in.shape[-3:]
    lead = g_in.shape[:-3]
    c, h = c2 // 2, g_start.shape[-2] - 1
    gbi = g_in[..., -1, :]
    return (
        gx, g_start[..., :h, :], g_start[..., h, :],
        g_in[..., 3 * c : 3 * c + h, :].movedim(-2, -3).reshape(*lead, h, n_layers * 2 * c),
        gbi.reshape(*lead, -1),
        g_in[..., : 3 * c, :].reshape(*lead, n_layers, 3, c, 2 * c), gbi,
        g_rs[..., :c, :], g_rs[..., c, :],
        _mm(skip.transpose(-1, -2), g2, bf16), g2.sum(-2),
    )


# ---------------------------------------------------- kernel wrappers -----

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/wn_fused.cu``."""
    lib = _build.load("wn_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wn_fwd_wsplit_words.argtypes = [i] * 5
    lib.wn_fwd_wsplit_words.restype = ctypes.c_size_t
    lib.wn_bwd_wsplit_words.argtypes = [i] * 5
    lib.wn_bwd_wsplit_words.restype = ctypes.c_size_t
    lib.wn_fwd_runs.argtypes = [p] * 15 + [i] * 7 + [p]
    lib.wn_fwd_runs.restype = i
    lib.wn_bwd_runs.argtypes = [p] * 19 + [i] * 8 + [p]
    lib.wn_bwd_runs.restype = i
    return lib


def check_geometry(rows: int, t_len: int, h: int, c: int, n_layers: int) -> None:
    """Raise unless the kernels take this WN: ``rows`` = B*T rows of series of
    length ``t_len``, half width ``h`` (any), WN channels ``c`` <= MAX_C and
    1..MAX_LAYERS layers (the C++ ``bad_geometry`` holds the same test)."""
    if not (rows > 0 and t_len > 0 and rows % t_len == 0 and h > 0 and 0 < c <= MAX_C
            and 0 < n_layers <= MAX_LAYERS):
        raise ValueError(
            f"unsupported WN geometry rows={rows} T={t_len} H={h} C={c} layers={n_layers}"
        )


def _check(x2: torch.Tensor, t_len: int, w_in: torch.Tensor, *tensors: torch.Tensor):
    """float32 contiguous operands on one device, a geometry the kernels take."""
    for t in (x2, w_in) + tensors:
        if t.device != x2.device:
            raise ValueError(f"operands on {t.device} and {x2.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the wn kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the wn kernels take contiguous tensors")
    rows, h = x2.shape
    n_layers, taps, c, c2 = w_in.shape
    if taps != 3 or c2 != 2 * c:
        raise ValueError(f"w_in of shape {tuple(w_in.shape)} is not (L, 3, C, 2C)")
    check_geometry(rows, t_len, h, c, n_layers)
    return rows, h, c, n_layers


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _check_runs(x2: torch.Tensor, *weights: torch.Tensor) -> int:
    """Every operand (K, ...) with one K, contiguous; returns K."""
    runs = x2.shape[0]
    for t in (x2,) + weights:
        if t.shape[0] != runs:
            raise ValueError(f"operands of {t.shape[0]} and {runs} runs")
        if not t.is_contiguous():
            raise ValueError("the wn kernels take contiguous tensors")
    return runs


def _launch_fwd(name, x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end,
                b_end, t_len: int, bf16: bool):
    """One ``wn_fwd_runs`` kernel call on K-leading operands (K = 1 for a
    one-run call), counted as ``name`` (``name[bf16]`` for the bf16
    instance): (y (K, R, 2H), aud (K, L, R, C), skip (K, R, C))."""
    runs = _check_runs(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end,
                       b_end)
    n_layers, c = w_in.shape[1], w_in.shape[3]
    b_z = (b_in + b_cond.reshape(runs, n_layers, 2 * c)).contiguous()
    ins = [x2, w_start, b_start, w_cond, b_z, w_in, w_rs, b_rs, w_end, b_end]
    rows, h, c, n_layers = _check(x2[0], t_len, w_in[0], *(t[0] for t in ins))
    lib = _lib()
    dev = x2.device
    y = torch.empty(runs, rows, 2 * h, device=dev)
    aud = torch.empty(runs, n_layers, rows, c, device=dev)
    skip = torch.empty(runs, rows, c, device=dev)
    scratch = fwd_scratch(runs, rows, c, n_layers, bf16,
                          lib.wn_fwd_wsplit_words(rows, c, h, n_layers, int(bf16)), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wn_fwd_runs(*_ptrs(*ins, y, aud, skip, *scratch), runs, rows, t_len, h, c,
                              n_layers, int(bf16), stream)
    name += "[bf16]" if bf16 else ""
    LAUNCHES[name] += 1
    _raise_on(err, name)
    return y, aud, skip


def bwd_scratch(runs: int, rows: int, h: int, c: int, n_layers: int, bf16: bool,
                wsplit_words: int, device) -> list:
    """The scratch of one ``wn_bwd_runs`` call in its argument order (ga,
    gskip, gz, acts, partial, wsplit), ``wsplit_words`` 32-bit words of
    wsplit a run: the f32 g_audio ping-pong (runs, 2, R, C); f32: g_skip (R,
    C), g_z (R, 2C), acts (R, C) a run, bf16: none (their bf16 copies live
    in wsplit's work area); the slice partials of the weight gradients
    (``wgrad_split_rows`` slices of (3C+H+1, 2C) a run); wsplit."""
    split = wgrad_split_rows(rows, bf16)

    def f32(*shape):
        return torch.empty(*shape, device=device)

    per_run = [f32(0), f32(0), f32(0)] if bf16 else [
        f32(runs, rows, c), f32(runs, rows, 2 * c), f32(runs, rows, c)]
    return [f32(runs, 2, rows, c), *per_run,
            f32(runs * -(-rows // split) * (3 * c + h + 1) * 2 * c),
            torch.empty(runs * wsplit_words, dtype=torch.int32, device=device)]


def _launch_bwd(name, x2, g2, aud, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end,
                t_len: int, bf16: bool):
    """One ``wn_bwd_runs`` kernel call on K-leading operands (K = 1 for a
    one-run call), counted as ``name`` (``name[bf16]`` for the bf16
    instance): the kernel's layouts (gx, g_in,
    g_rs, g_start) with a leading K (``_unpack`` reads them).  The weight
    gradients are per run, never summed across runs."""
    runs = _check_runs(x2, g2, aud, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end)
    n_layers, _, c, _ = w_in.shape[1:]
    b_z = (b_in + b_cond.reshape(runs, n_layers, 2 * c)).contiguous()
    ins = [x2, g2, aud, w_cond, w_in, b_z, w_rs, w_start.transpose(1, 2).contiguous(),
           w_end.transpose(1, 2).contiguous()]
    rows, h, c, n_layers = _check(x2[0], t_len, w_in[0], *(t[0] for t in ins))
    if g2.shape[1:] != (rows, 2 * h) or aud.shape[1:] != (n_layers, rows, c):
        raise ValueError(f"g {tuple(g2.shape)} / aud {tuple(aud.shape)} do not match x")
    lib = _lib()
    dev = x2.device
    split = wgrad_split_rows(rows, bf16)
    gx = torch.empty(runs, rows, h, device=dev)
    g_in = torch.empty(runs, n_layers, 3 * c + h + 1, 2 * c, device=dev)
    g_rs = torch.empty(runs, n_layers, c + 1, 2 * c, device=dev)
    g_start = torch.empty(runs, h + 1, c, device=dev)
    scratch = bwd_scratch(runs, rows, h, c, n_layers, bf16,
                          lib.wn_bwd_wsplit_words(rows, c, h, n_layers, int(bf16)), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wn_bwd_runs(*_ptrs(*ins, gx, g_in, g_rs, g_start, *scratch),
                              runs, rows, t_len, h, c, n_layers, split, int(bf16), stream)
    name += "[bf16]" if bf16 else ""
    LAUNCHES[name] += 1
    _raise_on(err, name)
    return gx, g_in, g_rs, g_start


def wn_fwd(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end, b_end,
           t_len: int, bf16: bool = False):
    """The forward kernel (``bf16``: its bf16 instance); same contract as
    ``wn_fwd_plain``."""
    ins = (x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end, b_end)
    return tuple(o[0] for o in _launch_fwd("wn_fwd", *(t[None] for t in ins), t_len, bf16))


def wn_bwd(x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end, t_len: int,
           bf16: bool = False):
    """The backward kernel (``bf16``: its bf16 instance); same contract as
    ``wn_bwd_plain``."""
    ins = (x2, g2, aud, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end)
    out = _launch_bwd("wn_bwd", *(t[None] for t in ins), t_len, bf16)
    return _unpack(*(o[0] for o in out), skip, g2, bf16)


def wn_fwd_runs(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end, b_end,
                t_len: int, bf16: bool = False):
    """K independent ``wn_fwd`` calls of one geometry in one kernel call: x2
    (K, R, H) and every weight with a leading K -> (y (K, R, 2H), aud (K, L,
    R, C), skip (K, R, C))."""
    return _launch_fwd("wn_fwd_runs", x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs,
                       b_rs, w_end, b_end, t_len, bf16)


def wn_bwd_runs(x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end,
                t_len: int, bf16: bool = False):
    """K independent ``wn_bwd`` calls of one geometry in one kernel call;
    every operand and gradient with a leading K."""
    out = _launch_bwd("wn_bwd_runs", x2, g2, aud, w_start, w_cond, b_cond, w_in, b_in, w_rs,
                      w_end, t_len, bf16)
    return _unpack(*out, skip, g2, bf16)


def _per_run(fn, *args, bf16: bool):
    """``fn`` run by run over the leading axis of every tensor argument (the
    last argument, T, is shared), each output stacked."""
    outs = [fn(*(a[k] for a in args[:-1]), args[-1], bf16) for k in range(args[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


# ------------------------------------------------------------ the op ------

def _save(ctx, inputs, output) -> None:
    """``WNCore`` / ``WNRunCore``'s context: the saved operands and
    activations, and the bf16 flag."""
    x, w_start, _, w_cond, b_cond, w_in, b_in, w_rs, _, w_end, _, bf16 = inputs
    _, aud, skip = output
    ctx.mark_non_differentiable(aud, skip)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(x, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end, aud, skip)
    ctx.bf16 = bf16


class WNBwdCore(torch.autograd.Function):
    """The WN's backward as an op of its own, from ``WNCore`` (``runs``
    False: one run, ``wn_bwd``) and ``WNRunCore`` (``runs`` True: every
    operand with a leading K, ``wn_bwd_runs``): the kernel on CUDA, the
    plain version on the CPU.  Returns ``wn_bwd_plain``'s gradients.

    Its vmap rule takes a batch of cotangents (``train/pipeline.py``
    ``batched_pull``: a batched g, the saved operands unbatched): ONE
    ``wn_bwd_runs`` call in which each cotangent is a run (N cotangents of
    K runs: N*K runs, cotangent c of run k at run c*K + k, reading run k's
    operands), every shared operand copied out to the cotangents.  The
    gradients come back per cotangent: they are linear in g, so no two
    cotangents may share a run.  On the CPU the plain version runs
    cotangent by cotangent.  No gradient of its own."""

    @staticmethod
    def forward(x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end,
                t_len: int, bf16: bool, runs: bool):
        args = (x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end, t_len)
        if runs:
            if use_kernel(g2):
                return wn_bwd_runs(*args, bf16)
            return _per_run(wn_bwd_plain, *args, bf16=bf16)
        return (wn_bwd if use_kernel(g2) else wn_bwd_plain)(*args, bf16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the WN backward has no gradient of its own")

    @staticmethod
    def vmap(info, in_dims, *args):
        from .osconv import _runs_first

        *tensors, t_len, bf16, runs = args
        n = info.batch_size
        ops = _runs_first(info, in_dims[:11], *tensors)  # (N, [K,] ...), contiguous
        if runs:  # the cotangent axis in front of the run axis, folded into it
            k = ops[0].shape[1]
            ops = [t.reshape(n * k, *t.shape[2:]) for t in ops]
        if use_kernel(ops[1]):
            out = wn_bwd_runs(*ops, t_len, bf16)
        else:
            out = _per_run(wn_bwd_plain, *ops, t_len, bf16=bf16)
        if runs:
            out = tuple(o.reshape(n, k, *o.shape[1:]) for o in out)
        return out, (0,) * len(out)


def _backward(ctx, g, runs: bool):
    """``WNCore`` / ``WNRunCore``'s backward: g on rows through ``WNBwdCore``."""
    x, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end, aud, skip = ctx.saved_tensors
    if g is None:
        return (None,) * 12
    lead, (b, t, h) = x.shape[:-3], x.shape[-3:]
    x2 = x.reshape(*lead, b * t, h).contiguous()
    g2 = g.reshape(*lead, b * t, 2 * h).contiguous()
    gx, *grads = WNBwdCore.apply(x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs,
                                 w_end, t, ctx.bf16, runs)
    return (gx.reshape(x.shape), *grads, None)


class WNCore(torch.autograd.Function):
    """The WN on stacked effective weights and the bf16 flag (``mxu_bf16``):
    kernels on CUDA, plain on CPU.  Returns (y, aud, skip); aud and skip, the
    saved activations, carry no gradient.  Under ``torch.func.vmap`` one
    ``WNRunCore`` call for all runs; its backward is ``WNBwdCore``."""

    @staticmethod
    def forward(x, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end, b_end,
                bf16: bool):
        b, t, h = x.shape
        x2 = x.reshape(b * t, h).contiguous()
        fwd = wn_fwd if use_kernel(x2) else wn_fwd_plain
        y, aud, skip = fwd(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs,
                           w_end, b_end, t, bf16)
        return y.reshape(b, t, 2 * h), aud, skip

    setup_context = staticmethod(_save)

    @staticmethod
    def backward(ctx, g, _g_aud, _g_skip):
        return _backward(ctx, g, runs=False)

    @staticmethod
    def vmap(info, in_dims, *args):
        from .osconv import _runs_first

        runs = _runs_first(info, in_dims[:-1], *args[:-1])
        return WNRunCore.apply(*runs, args[-1]), (0, 0, 0)


class WNRunCore(torch.autograd.Function):
    """K runs of the WN, x (K, B, T, H) and K-stacked effective weights, and
    the bf16 flag: ``wn_fwd_runs`` on CUDA, the plain version run by run on
    the CPU; the backward ``WNBwdCore`` over the K runs.  Returns (y, aud,
    skip) with a leading K."""

    @staticmethod
    def forward(x, *weights_and_flag):
        *weights, bf16 = weights_and_flag
        runs, b, t, h = x.shape
        x2 = x.reshape(runs, b * t, h).contiguous()
        if use_kernel(x2):
            y, aud, skip = wn_fwd_runs(x2, *weights, t, bf16)
        else:
            y, aud, skip = _per_run(wn_fwd_plain, x2, *weights, t, bf16=bf16)
        return y.reshape(runs, b, t, 2 * h), aud, skip

    setup_context = staticmethod(_save)

    @staticmethod
    def backward(ctx, g, _g_aud, _g_skip):
        return _backward(ctx, g, runs=True)


def wn_apply_fused(params: Dict, x: torch.Tensor, weight_norm_weight) -> torch.Tensor:
    """The coupling net x (B, T, n_half) -> (B, T, 2*n_half) through ``WNCore``
    (reference geometry: kernel 3, dilation 2**i), its products on bf16
    operands under ``FLSTTSC_WN_MXU=bf16``."""
    eff = [t.contiguous() for t in stack_effective(params, weight_norm_weight)]
    return WNCore.apply(x.float(), *eff, mxu_bf16())[0]
