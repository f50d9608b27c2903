"""How the bf16 WN backward stages its work, held on the CPU against the
plain bf16 backward and the JAX package.

``wn_bwd16_tiles_plain`` (here) mirrors the arithmetic of
``csrc/wn_bwd_bf16.cuh`` (``wn_bwd_runs`` with bf16, the JAX package's
``_wn_bwd_kernel`` under ``FLSTTSC_WN_MXU=bf16``) on the scratch that the
wrapper allocates (``wn_fused.bwd_scratch``): one flat int32 buffer a call,
each run's work area laid out as the kernel's ``Area16``
(``wn_fused.bwd_wsplit_words``) and read back from there: the bf16 copies of
aud and x rounded once with every row padded to 8 values, the bf16 weight
planes in the padded layout of the operand each meets, g_skip, g_z (two
halves of Cp each), acts and g_audio written as bf16 copies by the
epilogues that make them, the row-tile products and the weight gradients as
128-deep stage sums (each stage one f32 product added to the running sum),
the weight gradients' row slices of ``wgrad_split_rows(rows, bf16=True)``
rows summed in slice order, and the bias gradients as f32 column sums of
each 64-row tile in the kernel's order (a thread's two rows, the eight row
pairs of a warp as its shuffles add them, then the four m16 tiles; g_skip's
as its FMA kernel's threads add them), summed over a slice's tiles and then
over the slices in order.  The runs of a call go through every pass
together, as the kernels' grids take them, so areas that overlapped would
show.

Held against ``wn_bwd_plain(..., bf16=True)`` by relative L2: the top
layer's bias gradients and the end projection's within 1e-5 (f32 sums of
the same f32 values in another order), its weight gradients within 1e-4
(no earlier bf16 rounding carries into them, but an f32 sum in another
order can round g_z to the neighbouring bf16 value: ``chip_smoke.py``'s
BF16_REL_L2), every output within 1e-3; and, through the
port's ``wn_apply`` with its backward taken by the mirror, against
``jax.grad`` of the JAX package's fused WN with its Pallas kernels in
interpret mode under ``FLSTTSC_WN_MXU=bf16`` within 1e-3 (the JAX
comparison's bar in ``test_torch_port_bf16.py``).  Shapes: H = 25, C not a
multiple of 8, T % 8 != 0 and T < 2^i, a ragged last slice and tile, and two
runs.  ``tests/test_torch_port_wn_bwd_tiles.py`` mirrors the f32 kernels.
"""

import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.models import flow
from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
from feature_level_style_transfer_for_tsc_tpu_torch.ops import wn_fused
from test_torch_port_bf16 import REL_L2, _interpret, _jax_wn, _port_wn, _rel_l2, _wn_case

CH, KS, TILE = wn_fused.BF16_CHUNK, wn_fused.BF16_STAGE, wn_fused.BF16_TILE
TIGHT = 1e-5  # the top layer's bias gradients and the end projection's
TOP = 1e-4  # the top layer's weight gradients (chip_smoke.BF16_REL_L2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _r(v: int, m: int) -> int:
    return -(-v // m) * m


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 (nearest, ties to even) and widened back."""
    return t.bfloat16().float()


def _pair_col(n: int, c: int, cp: int) -> int:
    """The real column of padded column n of [a (Cp) | b (Cp)] (-1: padding)."""
    if n < cp:
        return n if n < c else -1
    return c + n - cp if n - cp < c else -1


class Area:
    """One run's work area in a call's flat int32 scratch, laid out as the
    kernel's ``Area16``: bf16 values (``val``) at the offsets below, then
    f32 tile sums (``f32``)."""

    def __init__(self, buf, run, rows, c, h, n_layers):
        words = wn_fused.bwd_wsplit_words(rows, c, h, n_layers, True)
        assert buf.numel() % words == 0
        area = buf[run * words:(run + 1) * words]
        self.val, self.f32 = area.view(torch.bfloat16), area.view(torch.float32)
        self.rows, self.c, self.h = rows, c, h
        self.cp, self.hp = cp, hp = _r(c, CH), _r(h, CH)
        self.kz, self.kg, self.kt = _r(3 * cp + hp, KS), _r(2 * cp, KS), _r(6 * cp, KS)
        z, g = 0, 2 * cp * self.kz
        t = g + cp * self.kg
        x = t + cp * self.kt
        self.plane_at = {"z": (z, 2 * cp, self.kz), "g": (g, cp, self.kg), "t": (t, cp, self.kt),
                         "x": (x, hp, self.kg)}
        self.layer = x + hp * self.kg
        self.aud = n_layers * self.layer
        self.x = self.aud + n_layers * rows * cp
        self.gskip = self.x + rows * hp
        self.ga = self.gskip + rows * cp
        self.gz = self.ga + rows * cp
        self.acts = self.gz + rows * 2 * cp
        self.tiles = -(-rows // TILE)
        self.bpz = (self.acts + rows * cp) // 2
        self.bpa = self.bpz + self.tiles * 2 * c
        self.bps = self.bpa + self.tiles * c
        end = self.bps + self.tiles * c
        assert end <= words and words - end < 4, (end, words)

    def mat(self, off, rows, cols):
        """bf16 values [off, off + rows * cols) as (rows, cols)."""
        return self.val[off:off + rows * cols].view(rows, cols)

    def plane(self, i, name):
        off, n_rows, k_pad = self.plane_at[name]
        return self.mat(i * self.layer + off, n_rows, k_pad)

    def sums(self, off, width):
        return self.f32[off:off + self.tiles * width].view(self.tiles, width)


def _write_planes(a: Area, i, w_in, w_cond, w_rs):
    """wsplit16_kernel: layer i's bf16 planes, the reduction in the padded
    layout of the operand each meets, zero in the padding and past W."""
    c, h, cp, hp = a.c, a.h, a.cp, a.hp
    w_c = w_cond[:, 2 * c * i:2 * c * (i + 1)]
    planes = {name: torch.zeros(n, k) for name, (_, n, k) in a.plane_at.items()}
    for n in range(2 * cp):
        col = _pair_col(n, c, cp)
        if col < 0:
            continue
        for tap in range(3):
            planes["z"][n, tap * cp:tap * cp + c] = w_in[i, tap, :, col]
        planes["z"][n, 3 * cp:3 * cp + h] = w_c[:, col]
    for k in range(2 * cp):
        col = _pair_col(k, c, cp)
        if col < 0:
            continue
        planes["g"][:c, k] = w_rs[i][:, col]
        planes["x"][:h, k] = w_c[:, col]
        for tap in range(3):
            planes["t"][:c, tap * 2 * cp + k] = w_in[i, tap, :, col]
    for name, p in planes.items():
        a.plane(i, name).copy_(p.bfloat16())


def _segment(m, col0, width, pwidth, shift=0, mask=None):
    """Columns [col0, col0 + pwidth) of each row r + shift of bf16 matrix m
    as f32, zero where that row is outside m or ``mask`` (one bool a row) is
    false: one segment of a staged operand."""
    rows = m.shape[0]
    idx = torch.arange(rows) + shift
    ok = (idx >= 0) & (idx < rows)
    if mask is not None:
        ok &= mask
    out = torch.zeros(rows, pwidth)
    out[ok] = m[idx[ok], col0:col0 + pwidth].float()
    assert not out[:, width:].any()  # the padding is zero
    return out


def _stage_mm(a, plane):
    """a (R, K) @ plane[:, :K]^T as the row-tile products take it: one f32
    product a stage of KS columns, added to the running sum."""
    w = plane[:, :a.shape[1]].float()
    assert not plane[:, a.shape[1]:].float().any()  # zero past A's padded columns
    acc = torch.zeros(a.shape[0], plane.shape[0])
    for k0 in range(0, a.shape[1], KS):
        acc = acc + a[:, k0:k0 + KS] @ w[:, k0:k0 + KS].T
    return acc


def _rt_tile_sums(v):
    """f32 column sums of each 64-row tile of v (R, n) in tile_col_sums'
    order: rows gid and gid + 8 of an m16 tile, then the eight gids as the
    shuffles (xor 4, 8, 16) add them, then the four m16 tiles in order."""
    rows, n = v.shape
    vp = torch.zeros(_r(rows, TILE), n)
    vp[:rows] = v
    t = vp.view(-1, 4, 2, 8, n)  # tile, m16 tile, row half, gid
    s = t[:, :, 0] + t[:, :, 1]
    s = s[:, :, 0::2] + s[:, :, 1::2]
    s = s[:, :, 0::2] + s[:, :, 1::2]
    s = s[:, :, 0] + s[:, :, 1]
    out = s[:, 0]
    for m in range(1, 4):
        out = out + s[:, m]
    return out


def _fma_tile_sums(v):
    """gskip16_kernel's order: a thread's four rows, then the 16 thread rows."""
    rows, n = v.shape
    vp = torch.zeros(_r(rows, TILE), n)
    vp[:rows] = v
    t = vp.view(-1, 16, 4, n)
    s = t[:, :, 0]
    for m in range(1, 4):
        s = s + t[:, :, m]
    out = s[:, 0]
    for y in range(1, 16):
        out = out + s[:, y]
    return out


def _wgrad(a, b, sums, split, rows):
    """The weight gradient: per slice one f32 product a stage of KS rows
    added to the slice's sum, the bias row the slice's tile sums added in order
    (``sums``, (tiles, B's columns)), the slices added in order."""
    total = torch.zeros(a.shape[1] + 1, b.shape[1])
    for rs in range(0, rows, split):
        re = min(rs + split, rows)
        part = torch.zeros(a.shape[1] + 1, b.shape[1])
        acc = torch.zeros(a.shape[1], b.shape[1])
        for r0 in range(rs, re, KS):
            acc = acc + a[r0:min(r0 + KS, re)].T @ b[r0:min(r0 + KS, re)]
        part[:-1] = acc
        bias = torch.zeros(b.shape[1])
        for t in range(rs // TILE, -(-re // TILE)):
            bias = bias + sums[t]
        part[-1] = bias
        total = total + part
    return total


def wn_bwd16_runs_tiles(x2, g2, aud, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end, t_len: int,
                        split_rows=None):
    """The bf16 backward of K runs as ``wn_bwd_runs`` with bf16 stages it:
    every operand K-leading; returns the kernel's layouts (gx, g_in, g_rs,
    g_start) with a leading K.  Every pass takes all runs before the next."""
    runs, rows, h = x2.shape
    n_layers, _, c, _ = w_in.shape[1:]
    split = split_rows or wn_fused.wgrad_split_rows(rows, True)
    ga_pp, none_a, none_b, none_c, partial, wsplit = wn_fused.bwd_scratch(
        runs, rows, h, c, n_layers, True, wn_fused.bwd_wsplit_words(rows, c, h, n_layers, True),
        "cpu")
    assert none_a.numel() == none_b.numel() == none_c.numel() == 0
    # the wrapper sizes the partials for wgrad_split_rows' slices, the most a call takes
    slices = -(-rows // wn_fused.wgrad_split_rows(rows, True))
    assert partial.numel() == runs * slices * (3 * c + h + 1) * 2 * c
    assert split % TILE == 0 and -(-rows // split) <= slices
    wsplit.fill_(-1)  # NaN in every view: a value read before it is written shows
    areas = [Area(wsplit, r, rows, c, h, n_layers) for r in range(runs)]
    cp, hp = areas[0].cp, areas[0].hp
    pos = torch.arange(rows) % t_len
    b_z = b_in + b_cond.reshape(runs, n_layers, 2 * c)
    for r, a in enumerate(areas):  # bf16_copies_kernel, wsplit16_kernel
        for i in range(n_layers):
            a.mat(a.aud + i * rows * cp, rows, cp).copy_(
                torch.nn.functional.pad(aud[r, i], (0, cp - c)).bfloat16())
            _write_planes(a, i, w_in[r], w_cond[r], w_rs[r])
        a.mat(a.x, rows, hp).copy_(torch.nn.functional.pad(x2[r], (0, hp - h)).bfloat16())
    for r, a in enumerate(areas):  # gskip16_kernel
        gs = _bf(g2[r]) @ _bf(w_end[r].T)
        a.mat(a.gskip, rows, cp).copy_(torch.nn.functional.pad(gs, (0, cp - c)).bfloat16())
        a.sums(a.bps, c).copy_(_fma_tile_sums(gs))
    g_x = [None] * runs
    g_in = torch.zeros(runs, n_layers, 3 * c + h + 1, 2 * c)
    g_rs = torch.zeros(runs, n_layers, c + 1, 2 * c)
    top = True
    for i in reversed(range(n_layers)):
        d = 2 ** i
        lo, hi = pos >= d, pos < t_len - d
        ops = []
        for r, a in enumerate(areas):  # wn_layer_gz16_kernel
            au = a.mat(a.aud + i * rows * cp, rows, cp)
            xs = a.mat(a.x, rows, hp)
            a_z = torch.cat([_segment(au, 0, c, cp, -d, lo), _segment(au, 0, c, cp),
                             _segment(au, 0, c, cp, d, hi), _segment(xs, 0, h, hp)], dim=1)
            ga16, gs16 = a.mat(a.ga, rows, cp), a.mat(a.gskip, rows, cp)
            a_grs = torch.cat([torch.zeros(rows, cp) if top else _segment(ga16, 0, c, cp),
                               _segment(gs16, 0, c, cp)], dim=1)
            zp = _stage_mm(a_z, a.plane(i, "z"))
            z = torch.cat([zp[:, :c], zp[:, cp:cp + c]], dim=1) + b_z[r, i]
            tt, ss = torch.tanh(z[:, :c]), torch.sigmoid(z[:, c:])
            g_acts = _stage_mm(a_grs, a.plane(i, "g"))[:, :c]
            za, zb = g_acts * ss * (1 - tt * tt), g_acts * tt * ss * (1 - ss)
            gz16 = a.mat(a.gz, rows, 2 * cp)
            gz16.zero_()
            gz16[:, :c], gz16[:, cp:cp + c] = za.bfloat16(), zb.bfloat16()
            acts16 = a.mat(a.acts, rows, cp)
            acts16.zero_()
            acts16[:, :c] = (tt * ss).bfloat16()
            bpz = a.sums(a.bpz, 2 * c)
            bpz[:, :c], bpz[:, c:] = _rt_tile_sums(za), _rt_tile_sums(zb)
            ops.append((a_z, a_grs))
        for r, a in enumerate(areas):  # wgrad16_kernel, res/skip then in
            a_z, a_grs = ops[r]
            b_rs = torch.cat([a_grs[:, :c], a_grs[:, cp:cp + c]], dim=1)
            sums_rs = torch.cat([torch.zeros(a.tiles, c) if top else a.sums(a.bpa, c),
                                 a.sums(a.bps, c)], dim=1)
            g_rs[r, i] = _wgrad(_segment(a.mat(a.acts, rows, cp), 0, c, cp)[:, :c], b_rs, sums_rs,
                                split, rows)
            gz16 = a.mat(a.gz, rows, 2 * cp)
            b_in_ = torch.cat([_segment(gz16, 0, c, cp)[:, :c], _segment(gz16, cp, c, cp)[:, :c]], 1)
            a_in = torch.cat([a_z[:, k * cp:k * cp + c] for k in range(3)] + [a_z[:, 3 * cp:3 * cp + h]],
                             dim=1)
            g_in[r, i] = _wgrad(a_in, b_in_, a.sums(a.bpz, 2 * c), split, rows)
        for r, a in enumerate(areas):  # wn_layer_ga16_kernel
            gz16 = a.mat(a.gz, rows, 2 * cp)
            up, dn = (pos + d) % t_len >= d, (pos - d) % t_len < t_len - d  # masks at the source row
            a_taps = torch.cat([_segment(gz16, half * cp, c, cp, s_, m_)
                                for s_, m_ in ((d, up), (0, None), (-d, dn)) for half in (0, 1)], 1)
            a_gz = torch.cat([_segment(gz16, 0, c, cp), _segment(gz16, cp, c, cp)], dim=1)
            assert torch.equal(up, pos < t_len - d) and torch.equal(dn, pos >= d)
            ga_next = None if top else ga_pp[r, (i + 1) % 2]
            v = (0.0 if ga_next is None else ga_next) + _stage_mm(a_taps, a.plane(i, "t"))[:, :c]
            ga_pp[r, i % 2] = v
            ga16 = a.mat(a.ga, rows, cp)
            ga16.zero_()
            ga16[:, :c] = v.bfloat16()
            a.sums(a.bpa, c).copy_(_rt_tile_sums(v))
            gxi = _stage_mm(a_gz, a.plane(i, "x"))[:, :h]
            g_x[r] = gxi if top else g_x[r] + gxi
        top = False
    g_start = torch.zeros(runs, h + 1, c)
    gx = torch.zeros(runs, rows, h)
    for r, a in enumerate(areas):  # the start's weight gradient and input gradient
        ga16 = _segment(a.mat(a.ga, rows, cp), 0, c, cp)[:, :c]
        g_start[r] = _wgrad(_segment(a.mat(a.x, rows, hp), 0, h, hp)[:, :h], ga16,
                            a.sums(a.bpa, c), split, rows)
        gx[r] = g_x[r] + _bf(ga_pp[r, 0]) @ _bf(w_start[r].T)
    return gx, g_in, g_rs, g_start


def wn_bwd16_tiles_plain(x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end,
                         t_len: int, bf16: bool = True, split_rows=None):
    """``wn_bwd_plain(..., bf16=True)``'s contract computed as the bf16
    kernels stage it, one run (``bf16``, passed by ``WNCore``, must be on)."""
    assert bf16, "the staging mirror is the bf16 kernels'"
    ins = (x2, g2, aud, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end)
    out = wn_bwd16_runs_tiles(*(t[None] for t in ins), t_len, split_rows)
    return wn_fused._unpack(*(o[0] for o in out), skip, g2, True)


def _bwd_args(b, t, h, c, n_layers, seed):
    g = torch.Generator().manual_seed(seed)
    params = flow.wn_init(g, h, n_layers, c)
    params["end"]["weight"] = 0.3 * torch.randn(c, 2 * h, generator=g)
    for layer in params["in_layers"] + params["res_skip_layers"] + [params["start"], params["cond"]]:
        layer["g"] = layer["g"] * (0.5 + torch.rand(layer["g"].shape, generator=g))
    eff = [e.detach() for e in wn_fused.stack_effective(params, weight_norm_weight)]
    x2 = torch.randn(b * t, h, generator=g)
    g2 = torch.randn(b * t, 2 * h, generator=g)
    _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t, True)
    return (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)


def _l2(got, want) -> float:
    return _rel_l2(got.numpy(), want.numpy())


@pytest.mark.parametrize(
    "b, t, h, c, n_layers, split",
    [
        (2, 37, 25, 12, 7, None),  # H 25, C % 8 != 0, T % 8 != 0, d = 64 past T; slices 64 + 10
        (3, 100, 25, 20, 8, 64),  # 300 rows: five slices, the last 44 rows (a ragged tile)
        (1, 65, 9, 16, 3, 64),  # a last slice and tile of one row
        (2, 60, 25, 33, 4, 128),  # C of 33: g_z's halves each padded to 40; 120 rows
    ],
)
def test_bf16_tiles_mirror_matches_wn_bwd_plain(b, t, h, c, n_layers, split):
    """Every output of the mirror within 1e-3 (relative L2) of
    ``wn_bwd_plain(..., bf16=True)``, the top layer's within 1e-4, its bias
    gradients and the end projection's within 1e-5; the layouts of
    ``_unpack``."""
    args = _bwd_args(b, t, h, c, n_layers, seed=b + t + c)
    got = wn_bwd16_tiles_plain(*args, split_rows=split)
    want = wn_fused.wn_bwd_plain(*args, bf16=True)
    assert len(got) == len(want) == 11
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert torch.isfinite(g).all()
        assert _l2(g, w) <= REL_L2, (i, _l2(g, w))
    top = slice(2 * c * (n_layers - 1), None)
    for i, sl, bar in ((3, (slice(None), top), TOP), (4, top, TIGHT), (5, -1, TOP), (6, -1, TIGHT),
                       (7, -1, TOP), (8, -1, TIGHT), (9, ..., TIGHT), (10, ..., TIGHT)):
        # gwc, gbc, gwi, gbi, gwr, gbr of the top layer; gwe, gbe
        assert _l2(got[i][sl], want[i][sl]) <= bar, (i, _l2(got[i][sl], want[i][sl]))


def test_bf16_tiles_mirror_runs_give_the_one_run_bits():
    """Two runs in one call: each run's work area is its own (the passes
    take the runs together, so an overlap would move a run's values), and
    each run gives the one-run call's bits."""
    cases = [_bwd_args(2, 37, 25, 12, 7, seed=s) for s in (1, 2)]
    stacked = [torch.stack(parts) for parts in zip(*(a[:-1] for a in cases))]
    x2, g2, aud, skip = stacked[:4]
    out = wn_bwd16_runs_tiles(x2, g2, aud, *stacked[4:], 37)
    for r, args in enumerate(cases):
        one = wn_bwd16_runs_tiles(*(a[None] for a in args[:2] + args[2:3] + args[4:-1]), 37)
        for got, want in zip(out, one):
            assert torch.equal(got[r], want[0])


@pytest.mark.parametrize("b, t, h, c", [(2, 37, 25, 12)])
def test_bf16_tiles_mirror_matches_jax_wn_apply(b, t, h, c, monkeypatch):
    """The port's fused ``wn_apply`` under ``FLSTTSC_WN_MXU=bf16`` with its
    backward taken by the mirror (7 layers: d = 64 past T) against
    ``jax.grad`` of the JAX package's fused WN, its Pallas kernels in
    interpret mode: the value and every gradient within relative L2 1e-3."""
    _interpret(monkeypatch)
    params, x = _wn_case(b, t, h, c, 7, seed=t + h)
    monkeypatch.setenv("FLSTTSC_WN_MXU", "bf16")
    monkeypatch.setattr(wn_fused, "wn_bwd_plain", wn_bwd16_tiles_plain)
    y16, g16 = _port_wn(params, x, c)
    jy16, jg16 = _jax_wn(params, x, c)
    assert _rel_l2(y16, jy16) <= REL_L2
    assert set(g16) == set(jg16)
    for k, want in jg16.items():
        assert g16[k].shape == want.shape, k
        assert _rel_l2(g16[k], want) <= REL_L2, (k, _rel_l2(g16[k], want))


@pytest.mark.parametrize(
    "rows, c, h, n_layers, words",
    [
        # pair: planes 8 x (2*120*512 + 120*256 + 120*768 + 32*256) values, copies
        # 46,080 x 1,592 values, 720 tiles x 480 floats
        (46_080, 120, 25, 8, 38_041_088),
        # C 33 -> Cp 40, H 9 -> Hp 16, 3 tiles: 3 x (2*40*256 + 40*128 + 40*256 + 16*128)
        # + 130 x (3*40 + 16 + 5*40) values, + 3 x 132 floats
        (130, 33, 9, 3, 79_068),
    ],
)
def test_bf16_scratch_sizes(rows, c, h, n_layers, words):
    """The bf16 work area's size (``bwd_wsplit_words``, the library's
    ``wn_bwd_wsplit_words`` mirrored), and the scratch that ``_launch_bwd``
    allocates from it: the f32 g_audio ping-pong, no f32 g_skip, g_z or
    acts, the partials of ``wgrad_split_rows(rows, bf16=True)`` slices."""
    assert wn_fused.bwd_wsplit_words(rows, c, h, n_layers, True) == words
    split = wn_fused.wgrad_split_rows(rows, True)
    scratch = wn_fused.bwd_scratch(2, rows, h, c, n_layers, True, words, "cpu")
    assert [tuple(s.shape) for s in scratch] == [
        (2, 2, rows, c), (0,), (0,), (0,), (2 * -(-rows // split) * (3 * c + h + 1) * 2 * c,),
        (2 * words,)]
    assert [s.dtype for s in scratch] == [torch.float32] * 5 + [torch.int32]
    f32 = wn_fused.bwd_scratch(2, rows, h, c, n_layers, False,
                               wn_fused.bwd_wsplit_words(rows, c, h, n_layers), "cpu")
    assert [tuple(s.shape) for s in f32[:4]] == [(2, 2, rows, c), (2, rows, c), (2, rows, 2 * c),
                                                 (2, rows, c)]


@pytest.mark.parametrize(
    "rows, split, slices",
    [(46_080, 768, 60), (23_040, 384, 60), (6_000, 128, 47), (2_400, 64, 38), (74, 64, 2),
     (10, 64, 1), (200_000, 1_024, 196)],
)
def test_bf16_slices_are_whole_tiles(rows, split, slices):
    """bf16 slices are whole 64-row tiles (the bias rows add whole tiles'
    sums), at most 1,024 rows, about 64 where the rows allow."""
    assert wn_fused.wgrad_split_rows(rows, True) == split
    assert split % wn_fused.BF16_TILE == 0
    assert -(-rows // split) == slices


def test_bf16_global_launches():
    """The bf16 backward launches 6 + 6L ``__global__`` kernels a call (the
    copies, the planes, g_skip; per layer gz, two weight gradients with
    their reductions, ga; the start's weight gradient, its reduction and
    input gradient); the bf16 forward 3 + L (its own kernels:
    ``tests/test_torch_port_bf16_wn_fwd_tiles.py``)."""
    assert wn_fused.global_launches(8, bf16=True) == {"wn_fwd": 11, "wn_bwd": 54}
    k = wn_fused.global_kernels(8, bf16=True)["wn_bwd"]
    assert k["wgrad16_kernel"] == k["reduce_partials_kernel"] == 17
    assert sum(k.values()) == 54


def test_rt_tile_sums_follow_the_warp_order():
    """``_rt_tile_sums`` adds a tile's rows in the kernel's tree, not in row
    order: values whose sum depends on the order show it."""
    v = torch.zeros(64, 1)
    v[0], v[1], v[8] = 1e8, 1.0, -1e8  # rows gid 0, gid 1, gid 0 + 8 of m16 tile 0
    # tile_col_sums: (row 0 + row 8) first, then the gid pairs: 0 + 1 = 1
    assert _rt_tile_sums(v).item() == 1.0
    assert ((v[0] + v[1]) + v[8]).item() == 0.0  # row order loses the 1


def _trunc32(v: np.ndarray) -> np.ndarray:
    """float64 to float32 rounded toward zero, as the tensor core's
    accumulate keeps its sum."""
    f = v.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(v), np.nextafter(f, np.float32(0)), f)


def _emulated_bf16_wgrad(a, b, stage_steps: int, slice_rows: int) -> np.ndarray:
    """A^T B as the bf16 kernel takes it: per mma k16 step the 16 exact
    products of bf16 operands added to the stage's registers and the sum
    truncated to float32; each stage of ``stage_steps`` k-steps added to the
    slice's sum, the slices summed in order, both with rounded float32 adds."""
    m, n = a.shape[1], b.shape[1]
    steps = np.einsum("skm,skn->smn", a.reshape(-1, 16, m).astype(np.float64),
                      b.reshape(-1, 16, n).astype(np.float64))
    total = np.zeros((m, n), np.float32)
    for r0 in range(0, len(a), slice_rows):
        acc = np.zeros((m, n), np.float32)
        s1 = min(r0 + slice_rows, len(a)) // 16
        for st in range(r0 // 16, s1, stage_steps):
            part = np.zeros((m, n), np.float32)
            for p in steps[st:min(st + stage_steps, s1)]:
                part = _trunc32(part.astype(np.float64) + p)
            acc = acc + part
        total = total + acc
    return total


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_stage_sums_keep_a_long_row_reduction_at_f32_accuracy(seed):
    """One mma tile of gwi at the pair shape's 46,080 rows, bf16 operands:
    the kernel's staging (8 k16 steps a stage, bf16 ``wgrad_split_rows``
    slices) stays under 1e-6 of the float64 sum of the same products, as
    float32 does; one tensor-core accumulator over every row does not."""
    rows = 46_080
    rng = np.random.default_rng(seed)
    a = _bf(torch.from_numpy(rng.standard_normal((rows, 16)).astype(np.float32))).numpy()
    b = _bf(torch.from_numpy(rng.standard_normal((rows, 8)).astype(np.float32))).numpy()
    want = a.astype(np.float64).T @ b.astype(np.float64)

    def rel(y):
        return np.abs(y - want).max() / np.abs(want).max()

    staged = _emulated_bf16_wgrad(a, b, KS // 16, wn_fused.wgrad_split_rows(rows, True))
    single = _emulated_bf16_wgrad(a, b, rows // 16, rows)
    assert rel(staged) < 1e-6
    assert rel(single) > 1e-6
    assert rel(a.T @ b) < 1e-6
