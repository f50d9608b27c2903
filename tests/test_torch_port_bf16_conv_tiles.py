"""A plain mirror of the bf16 OS-conv kernel's staging, on the CPU.

The bf16 tap GEMM (``csrc/tap_gemm_bf16.cuh``, ``os_conv_fwd[bf16]``) runs
only on a card, so this file keeps, in numpy, every index it computes:

* ``tiles`` and ``window_shape``: ``run_bf16``'s tile choice and
  ``launch_bf16``'s window shape (channels and taps a window, shared
  memory), checked at the six serving convs (B=20, T=1152): every
  grid at least two blocks an SM, every block within two blocks an SM's
  shared memory;
* ``osconv._work`` on bf16 weights: the size of the prep kernel's chunk
  layout and the windows (``bf16_work_words``), the float32 size unchanged;
* ``conv_mirror``: the prep kernel's chunks, then each block's walk: its tap
  windows, its windows of channels and taps, the 16-byte granules its
  cp.async copies take from the tensor's bytes (clipped at the tensor's
  end, at any byte offset of the tensor in memory), the unpack of each raw
  row into 16-byte units (unit row x chunks + chunk, so a chunk's A rows
  are linear in its index, at a swizzled place: a permutation), the
  k-steps of two chunks (a spare zero chunk where a window's length is odd)
  and each mma tile's range of k-steps; summed in float64, rounded to bf16
  once.

The mirror is held within 1e-4 (relative L2) of ``os_conv_plain`` in bf16,
the kernel's gate on the card, and within 1e-3 of the JAX package's bf16
conv core (XLA's conv on bf16 operands, the function the kernel stands
for), at the serving layers' (C_in, C_out, K) with their masks at a ragged
T (C_in 7, 25, 50 and 225), with a dead column group and a stray tap, at
byte offsets off 16, and with windows forced narrow (several windows a
block, odd lengths).  The kernel itself is held against ``os_conv_plain``
on the card in tests/test_torch_port_kernels.py (``gpu``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.ops import osconv as j_osconv
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv
from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels
from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import build_specs

SMS = 132  # an H100 SXM's SMs
MT, NT = 2, 4  # m16 and n8 tiles a warp
CH, MAX_CS, RING, STAGE_BYTES, PAD_N, GROUP = 8, 64, 2, 32 * 1024, 64, 8
SMEM_CAP = 110 * 1024  # two blocks an SM
BF16_REL_L2 = 1e-4
JAX_REL_L2 = 1e-3


def _up(v, m):
    return -(-v // m) * m


def tiles(b, t_out, c_out, sms=SMS):
    """(WM, WN, WK) warps of ``run_bf16``: 64 x 32 with four split-K groups
    for C_out <= 32, 128 x 64 where one run's grid fills two blocks an SM,
    else 64 x 64 with two."""
    if c_out <= 32:
        return 2, 1, 4
    wide = -(-t_out // 128) * -(-c_out // 64) * b
    return (4, 2, 1) if wide >= 2 * sms else (2, 2, 2)


def smem(wm, wn, wk, cs, jw):
    """``bf16_smem``: bytes of a block's shared memory."""
    tm, tn = wm * MT * 16, wn * NT * 8
    rows = tm + jw
    stages = RING * STAGE_BYTES + _up(rows * (cs // CH), 8) * 16 + rows * (cs // CH + 1) * 16
    return max(stages, (wk - 1) * wm * wn * 32 * MT * NT * 16 + tm * (tn + 8) * 2)


def swizzle(u, n_ch):
    """The 16-byte unit of unit ``u`` = row * n_ch + chunk of a staged window."""
    shift, mask = (n_ch & -n_ch).bit_length() - 1, 0 if n_ch & 1 else 7
    return u ^ ((u >> shift) & mask)


def ksteps(j0, n_ch, length, lo, hi):
    """The k-steps [a, b) of a window whose chunks reach taps [lo, hi)."""
    clo = min(max(lo - j0, 0) * n_ch, length)
    chi = min(max(hi - j0, 0) * n_ch, length)
    return clo // 2, ((chi + 1) // 2 if chi > clo else clo // 2)


def window_shape(wm, wn, wk, c_in, k):
    """``launch_bf16``: (channels, taps, bytes) of a window."""
    cp8 = _up(c_in, CH)
    cs, jw = min(cp8, MAX_CS), k
    while smem(wm, wn, wk, cs, jw) > SMEM_CAP:
        if cs > 16:
            cs = _up(cs // 2, CH)
        elif jw > 1:
            jw = (jw + 1) // 2
        else:
            break
    return cs, jw, smem(wm, wn, wk, cs, jw)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _tile_window(win, g, k):
    """``group_window``: [lo, hi) of column group g, empty (k, 0)."""
    if g >= len(win) or win[g, 1] <= win[g, 0]:
        return k, 0
    return int(win[g, 0]), int(win[g, 1])


def conv_mirror(x_pad: torch.Tensor, w: torch.Tensor, offset: int = 0, cs=None, jw=None):
    """``os_conv_fwd[bf16]`` as the kernel walks it, on bf16 x_pad (B, t_pad,
    C_in) and w (K, C_in, C_out) lying ``offset`` elements into their
    memory; ``cs`` / ``jw`` force a window's channels / taps.  Returns the
    bf16 output and the number of windows of the busiest block."""
    b, t_pad, c_in = x_pad.shape
    k, _, c_out = w.shape
    t_out = t_pad - k + 1
    wm, wn, wk = tiles(b, t_out, c_out)
    tm, tn = wm * MT * 16, wn * NT * 8
    cs0, jw0, _ = window_shape(wm, wn, wk, c_in, k)
    cs, jw = cs or cs0, jw or jw0
    granules = cs // CH + 1
    ps = STAGE_BYTES // (tn * 16)  # chunks a stage
    ksps = ps // 2
    n_chunks = _up(c_in, CH) // CH
    # prep_bf16_kernel: (K, C_in / 8, C_out padded to 64, 8) chunks, and the windows
    wv = np.zeros((k, n_chunks * CH, _up(c_out, PAD_N)))
    wv[:, :c_in, :c_out] = _value(_bits(w))
    chunks = wv.reshape(k, n_chunks, CH, -1).transpose(0, 1, 3, 2)
    win = osconv.tap_windows_plain(w.float()).numpy()
    # the tensor's memory: x_pad's elements ``offset`` elements in, the bytes
    # past its end never read
    mem = np.full(offset + x_pad.numel() + 16, 0xFFFF, np.uint16)  # NaN bits around it
    mem[offset:offset + x_pad.numel()] = _bits(x_pad).ravel()
    x_end = offset + x_pad.numel()  # in elements: a byte address is twice it
    y = np.zeros((b, t_out, c_out))
    most_windows = 0
    for bz in range(b):
        for t0 in range(0, t_out, tm):
            for n0 in range(0, c_out, tn):
                tile_win = [_tile_window(win, n0 // GROUP + g, k) for g in range(tn // GROUP)]
                live = [(lo, hi) for lo, hi in tile_win if hi > lo]
                blo = min((lo for lo, _ in live), default=k)
                bhi = max((hi for _, hi in live), default=0)
                acc = np.zeros((tm, tn))
                span = bhi - blo
                n_tw = -(-span // jw) if span > 0 else 0
                n_win = n_tw * -(-n_chunks // (cs // CH))
                most_windows = max(most_windows, n_win)
                for i in range(n_win):
                    c0 = i // n_tw * (cs // CH)
                    n_ch = min(cs // CH, n_chunks - c0)
                    j0 = blo + i % n_tw * jw
                    taps = min(jw, bhi - j0)
                    length = taps * n_ch
                    rows = tm + taps
                    valid = min(n_ch * CH, c_in - c0 * CH)
                    # the raw copy (16-byte granules, clipped at the end) and the unpack
                    # into 16-byte units, unit row * n_ch + chunk at its swizzled place
                    units = np.zeros((_up(rows * n_ch, 8), CH))
                    for r in range(rows):
                        t = t0 + j0 + r
                        if t >= t_pad:
                            continue
                        a = offset + (bz * t_pad + t) * c_in + c0 * CH
                        base = a // 8 * 8  # the granule holding the row's first channel
                        need = ((a - base) * 2 + 2 * valid + 15) // 16
                        raw = np.zeros(granules * CH, np.uint16)
                        for q in range(need):
                            n_el = min(CH, x_end - (base + CH * q))
                            assert n_el > 0
                            raw[q * CH:q * CH + n_el] = mem[base + CH * q:base + CH * q + n_el]
                        el = a - base
                        assert (el + 2 * (-(-valid // 2) - 1)) // 2 + 1 < granules * CH // 2
                        row = np.zeros(n_ch * CH)
                        row[:valid] = _value(raw[el:el + valid])
                        for ch in range(n_ch):
                            units[swizzle(r * n_ch + ch, n_ch)] = row[ch * CH:(ch + 1) * CH]
                    assert sorted(swizzle(u, n_ch) for u in range(len(units))) == list(
                        range(len(units)))
                    pairs = -(-length // 2)
                    tile_ks = [ksteps(j0, n_ch, length, lo, hi) for lo, hi in tile_win]
                    for s in range(-(-pairs // ksps)):
                        part = np.zeros((tm, tn))
                        for ks in range(s * ksps, min((s + 1) * ksps, pairs)):
                            prod = np.zeros((tm, tn))
                            for h in (0, 1):
                                p = 2 * ks + h  # the window's chunk; unit m * n_ch + p
                                if p >= length:
                                    continue  # the spare chunk: zero-filled weights
                                a_half = units[[swizzle(m * n_ch + p, n_ch) for m in range(tm)]]
                                b_half = chunks[j0 + p // n_ch, c0 + p % n_ch, n0:n0 + tn]
                                prod += a_half @ b_half.T
                            for nt, (ka, kb) in enumerate(tile_ks):
                                if ka <= ks < kb:
                                    part[:, nt * 8:(nt + 1) * 8] += prod[:, nt * 8:(nt + 1) * 8]
                        acc += part
                t_n, c_n = min(tm, t_out - t0), min(tn, c_out - n0)
                y[bz, t0:t0 + t_n, n0:n0 + c_n] = acc[:t_n, :c_n]
    return torch.from_numpy(y).float().bfloat16(), most_windows


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _serving_layers():
    ext, cls = build_specs(7, 1152, PipelineConfig())
    return ext + cls


def _operands(spec, t, seed, edit=None):
    k, c_in, c_out = spec[-1][-1], spec[0][0], total_out_channels(spec)
    rng = np.random.default_rng(seed)
    mask = osconv.build_os_mask(spec)
    w = rng.standard_normal((k, c_in, c_out)) / math.sqrt(c_in * k) * mask
    if edit == "dead group":
        w[:, :, 8:16] = 0.0
    elif edit == "stray tap":
        w[k - 1, c_in - 1, 0] = 0.5  # column 0 is the kernel-1 branch: its last tap is dead
    x_pad = rng.standard_normal((2, t + k - 1, c_in))
    return torch.tensor(x_pad).bfloat16(), torch.tensor(w).bfloat16()


def test_tiles_fill_the_card_at_the_serving_convs():
    """At the six serving convs every grid holds at least two blocks an SM
    and every block's shared memory leaves room for two: one window a block
    (x staged once), with the channels and taps the header names."""
    got = []
    for spec in _serving_layers():
        k, c_in, c_out = spec[-1][-1], spec[0][0], total_out_channels(spec)
        wm, wn, wk = tiles(20, 1152, c_out)
        tm, tn = wm * MT * 16, wn * NT * 8
        cs, jw, nbytes = window_shape(wm, wn, wk, c_in, k)
        blocks = -(-1152 // tm) * -(-c_out // tn) * 20
        assert blocks >= 2 * SMS and nbytes <= SMEM_CAP
        got.append((c_in, c_out, k, tm, tn, cs, jw, blocks, nbytes))
    assert got == [
        (7, 25, 89, 64, 32, 8, 89, 360, 72992),
        (25, 225, 89, 128, 64, 32, 89, 720, 96848),
        (225, 50, 2, 64, 64, 64, 2, 360, 83488),
        (50, 25, 89, 64, 32, 56, 89, 360, 102272),
        (25, 225, 89, 128, 64, 32, 89, 720, 96848),
        (225, 50, 2, 64, 64, 64, 2, 360, 83488),
    ]


@pytest.mark.parametrize("k, c_in, c_out", [(89, 7, 25), (89, 25, 225), (2, 225, 50), (1, 1, 3)])
def test_work_sizes_match_the_kernels(k, c_in, c_out):
    """``_work``: bf16 weights take one bf16 copy of the chunk layout (K x
    C_in padded to 8 x C_out padded to 64, half a word an element), float32
    ones two TF32 planes of it; then 2 ints a column group, per run."""
    elems = k * _up(c_in, CH) * _up(c_out, PAD_N)
    groups = 2 * -(-c_out // GROUP)
    for dtype, words in ((torch.bfloat16, elems // 2), (torch.float32, 2 * elems)):
        w = torch.zeros(k, c_in, c_out, dtype=dtype)
        assert osconv._work(w).numel() == words + groups
        assert osconv._work(w, runs=3).numel() == 3 * (words + groups)


@pytest.mark.parametrize("layer", range(4))  # 7 -> 25, 25 -> 225, 225 -> 50 (K=2), 50 -> 25
@pytest.mark.parametrize("edit", [None, "dead group", "stray tap"])
def test_mirror_matches_plain_and_jax_at_the_serving_layers(layer, edit):
    """Each serving layer's masked weights (as they are, with a dead column
    group, with a stray tap outside the mask) at T = 77 (the tile's ragged
    edge), x_pad two elements off a 16-byte granule: the mirror within
    BF16_REL_L2 of ``os_conv_plain`` in bf16 and within JAX_REL_L2 of the
    JAX package's bf16 conv core."""
    spec = _serving_layers()[layer]
    x_pad, w = _operands(spec, 77, seed=layer, edit=edit)
    got, _ = conv_mirror(x_pad, w, offset=1)
    want = osconv.os_conv_plain(x_pad, w)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel_l2(got.float(), want.float()) <= BF16_REL_L2
    jax_y = j_osconv._conv_core(jnp.asarray(x_pad.float().numpy(), jnp.bfloat16),
                                jnp.asarray(w.float().numpy(), jnp.bfloat16))
    assert _rel_l2(got.float(), np.asarray(jax_y, np.float32)) <= JAX_REL_L2


@pytest.mark.parametrize(
    "b, t, k, c_in, c_out, offset, cs, jw",
    [
        (2, 40, 9, 25, 40, 3, 16, 4),  # two channel windows a tap range, three tap ranges
        (1, 130, 5, 7, 24, 0, None, 2),  # windows of 2 taps, one chunk a tap: odd lengths
        (3, 20, 3, 50, 70, 5, 16, None),  # four channel windows, the last of one chunk
        (1, 33, 1, 17, 9, 7, None, None),  # one tap, three chunks: a spare chunk
        (2, 64, 89, 1, 25, 1, None, None),  # C_in 1: two taps a k-step
    ],
)
def test_mirror_matches_plain_with_narrow_windows(b, t, k, c_in, c_out, offset, cs, jw):
    """Random dense weights with windows forced narrow (several windows a
    block, staged one after another): within BF16_REL_L2 of the plain bf16
    conv."""
    rng = np.random.default_rng(b * 100 + k)
    x_pad = torch.tensor(rng.standard_normal((b, t + k - 1, c_in))).bfloat16()
    w = torch.tensor(rng.standard_normal((k, c_in, c_out)) / math.sqrt(c_in * k)).bfloat16()
    got, n_win = conv_mirror(x_pad, w, offset=offset, cs=cs, jw=jw)
    assert n_win == max(1, -(-k // (jw or k))) * -(-_up(c_in, CH) // (cs or _up(c_in, CH)))
    assert _rel_l2(got.float(), osconv.os_conv_plain(x_pad, w).float()) <= BF16_REL_L2
