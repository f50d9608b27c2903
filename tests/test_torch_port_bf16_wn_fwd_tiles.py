"""How the bf16 WN forward stages its work, held on the CPU against the
plain bf16 forward and the JAX package.

``wn_fwd16_runs_tiles`` (here) mirrors the arithmetic of
``csrc/wn_fwd_bf16.cuh`` (``wn_fwd_runs`` with bf16, the JAX package's
``_wn_fwd_kernel`` under ``FLSTTSC_WN_MXU=bf16``) on the scratch that the
wrapper allocates (``wn_fused.fwd_scratch``): one flat int32 buffer a call,
each run's work area laid out as the kernel's ``FArea16``
(``wn_fused.fwd_wsplit_words``) and read back from there: the bf16 copy of
x rounded once with every row padded to 8 values, the bf16 weight planes in
the padded layout of the operand each meets (z as the bf16 backward's),
aud_0 written as its bf16 copy by the start projection, aud_{i+1} by layer
i's res/skip epilogue into the other copy of a ping-pong, acts by the gate
and skip by the last layer, every layer product as 128-deep stage sums (each
stage one f32 product added to the running sum), each layer taken tile by
tile (the rows ``fwd_row_tile`` gives a tile on an H100's 132 SMs), a tile
reading its own rows' acts and skip back.  The runs of a call go through
every pass together, as the kernels' grids take them, so areas that
overlapped would show.

Held against ``wn_fwd_plain(..., bf16=True)`` layer by layer
(``wn_fwd_plain_layers``: each layer from the mirror's own input to it)
within 1e-4 relative L2 (``chip_smoke.py``'s BF16_REL_L2: only f32 sums in
another order, which can round a value to the neighbouring bf16 one) and
free-running within 1e-3; and, through the port's ``wn_apply`` with its
forward taken by the mirror, against the JAX package's fused WN with its
Pallas kernels in interpret mode under ``FLSTTSC_WN_MXU=bf16`` within 1e-3
(the JAX comparison's bar in ``test_torch_port_bf16.py``).  Shapes: H = 25,
C not a multiple of 8, T % 8 != 0 and T < 2^i, ragged last tiles, and each
tile size the short-series rule picks.
``tests/test_torch_port_bf16_wn_bwd_tiles.py`` mirrors the bf16 backward.
"""

import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.models import flow
from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
from feature_level_style_transfer_for_tsc_tpu_torch.ops import wn_fused
from test_torch_port_bf16 import REL_L2, _interpret, _jax_wn, _port_wn, _rel_l2, _wn_case
from test_torch_port_bf16_wn_bwd_tiles import Area, _pair_col, _r, _segment, _stage_mm, _write_planes

CH, KS = wn_fused.BF16_CHUNK, wn_fused.BF16_STAGE
LAYER_BAR = 1e-4  # each layer from the mirror's own input to it (chip_smoke.BF16_REL_L2)
SMS = 132  # an H100 SXM's SMs: the card the short-series rule is tuned on
END_COLS = 128  # columns a pass of the end projection (RT_END_COLS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 (nearest, ties to even) and widened back."""
    return t.bfloat16().float()


class FArea:
    """One run's work area in a call's flat int32 scratch, laid out as the
    kernel's ``FArea16``: bf16 values at the offsets below."""

    def __init__(self, buf, run, rows, c, h, n_layers):
        words = wn_fused.fwd_wsplit_words(rows, c, h, n_layers, True)
        assert buf.numel() % words == 0
        self.val = buf[run * words:(run + 1) * words].view(torch.bfloat16)
        self.rows, self.c, self.h = rows, c, h
        self.cp, self.hp, self.ep = cp, hp, ep = _r(c, CH), _r(h, CH), _r(2 * h, CH)
        self.kz, self.kr = _r(3 * cp + hp, KS), _r(cp, KS)
        self.layer = 2 * cp * (self.kz + self.kr)
        self.end = n_layers * self.layer
        self.x = self.end + ep * self.kr
        self.aud = self.x + rows * hp
        self.acts = self.aud + 2 * rows * cp
        self.skip = self.acts + rows * cp
        end = self.skip + rows * cp
        assert end <= 2 * words and 2 * words - end < 8, (end, words)

    def mat(self, off, rows, cols):
        """bf16 values [off, off + rows * cols) as (rows, cols)."""
        return self.val[off:off + rows * cols].view(rows, cols)

    def z(self, i):
        return self.mat(i * self.layer, 2 * self.cp, self.kz)

    def rs(self, i):
        return self.mat(i * self.layer + 2 * self.cp * self.kz, 2 * self.cp, self.kr)

    def end_plane(self):
        return self.mat(self.end, self.ep, self.kr)

    def aud16(self, i):
        """The ping-pong copy that holds aud_i."""
        return self.mat(self.aud + (i % 2) * self.rows * self.cp, self.rows, self.cp)


def _write_fwd_planes(a: FArea, w_in, w_cond, w_rs, w_end, n_layers):
    """wsplit16_fwd_kernel: each layer's z plane (the bf16 backward's z
    layout: gate-pair rows, [aud taps (Cp each) | x (Hp)] columns) and
    res/skip plane (plane row j audio column j, row Cp + j skip column C +
    j; k over acts' Cp columns), then the end projection's (Ep, Cp), zero in
    the padding and past W."""
    c, h, cp = a.c, a.h, a.cp
    for i in range(n_layers):
        rs = torch.zeros(2 * cp, a.kr)
        for n in range(2 * cp):
            col = _pair_col(n, c, cp)
            if col >= 0:
                rs[n, :c] = w_rs[i][:, col]
        a.rs(i).copy_(rs.bfloat16())
        z = torch.zeros(2 * cp, a.kz)
        for n in range(2 * cp):
            col = _pair_col(n, c, cp)
            if col >= 0:
                for tap in range(3):
                    z[n, tap * cp:tap * cp + c] = w_in[i, tap, :, col]
                z[n, 3 * cp:3 * cp + h] = w_cond[:, 2 * c * i + col]
        a.z(i).copy_(z.bfloat16())
    end = torch.zeros(a.ep, a.kr)
    end[:2 * h, :c] = w_end.T
    a.end_plane().copy_(end.bfloat16())


def _padded(v, width):
    """v (rows, n) with zero columns up to ``width``."""
    return torch.nn.functional.pad(v, (0, width - v.shape[1]))


def _own(m, part, width):
    """Rows ``part`` of bf16 matrix m as f32: a tile's own rows, read back;
    the padding past ``width`` zero."""
    v = m[part].float()
    assert not v[:, width:].any()
    return v


def wn_fwd16_runs_tiles(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end,
                        b_end, t_len: int, tile_rows=None):
    """The bf16 forward of K runs as ``wn_fwd_runs`` with bf16 stages it:
    every operand K-leading; returns (y (K, R, 2H), aud (K, L, R, C), skip
    (K, R, C)).  Every pass takes all runs before the next; each layer goes
    tile by tile, ``tile_rows`` rows a tile (default: the H100's)."""
    runs, rows, h = x2.shape
    n_layers, _, c, _ = w_in.shape[1:]
    tile = tile_rows or wn_fused.fwd_row_tile(rows, SMS)
    acts_f32, wsplit = wn_fused.fwd_scratch(
        runs, rows, c, n_layers, True, wn_fused.fwd_wsplit_words(rows, c, h, n_layers, True), "cpu")
    assert acts_f32.numel() == 0  # the bf16 forward keeps acts only as its bf16 copy
    wsplit.fill_(-1)  # NaN in every bf16 view: a value read before it is written shows
    areas = [FArea(wsplit, r, rows, c, h, n_layers) for r in range(runs)]
    cp, hp = areas[0].cp, areas[0].hp
    pos = torch.arange(rows) % t_len
    b_z = b_in + b_cond.reshape(runs, n_layers, 2 * c)
    for r, a in enumerate(areas):  # bf16_copies_kernel (x only)
        a.mat(a.x, rows, hp).copy_(_padded(x2[r], hp).bfloat16())
    for r, a in enumerate(areas):  # wsplit16_fwd_kernel
        _write_fwd_planes(a, w_in[r], w_cond[r], w_rs[r], w_end[r], n_layers)
    aud = torch.zeros(runs, n_layers, rows, c)
    skip = torch.zeros(runs, rows, c)
    y = torch.zeros(runs, rows, 2 * h)
    for r, a in enumerate(areas):  # the start projection (rowgemm), its bf16 copy
        aud[r, 0] = _bf(x2[r]) @ _bf(w_start[r]) + b_start[r]
        a.aud16(0).copy_(_padded(aud[r, 0], cp).bfloat16())
    for i in range(n_layers):  # one launch a layer
        d, last = 2 ** i, i == n_layers - 1
        for r, a in enumerate(areas):
            au, xs = a.aud16(i), a.mat(a.x, rows, hp)
            acts16, skip16 = a.mat(a.acts, rows, cp), a.mat(a.skip, rows, cp)
            for r0 in range(0, rows, tile):
                part = slice(r0, min(r0 + tile, rows))
                # the taps' rows of this tile, read when the tile runs
                a_z = torch.cat([_segment(au, 0, c, cp, -d, pos >= d)[part],
                                 _segment(au, 0, c, cp)[part],
                                 _segment(au, 0, c, cp, d, pos < t_len - d)[part],
                                 _segment(xs, 0, h, hp)[part]], dim=1)
                zp = _stage_mm(a_z, a.z(i))
                za, zb = zp[:, :c] + b_z[r, i, :c], zp[:, cp:cp + c] + b_z[r, i, c:]
                acts16[part] = _padded(torch.tanh(za) * torch.sigmoid(zb), cp).bfloat16()
                rs = _stage_mm(_own(acts16, part, c), a.rs(i))
                if not last:
                    aud[r, i + 1, part] = aud[r, i, part] + (rs[:, :c] + b_rs[r, i, :c])
                    a.aud16(i + 1)[part] = _padded(aud[r, i + 1, part], cp).bfloat16()
                skip[r, part] = (0.0 if i == 0 else skip[r, part]) + (rs[:, cp:cp + c]
                                                                      + b_rs[r, i, c:])
                if not last:
                    continue
                skip16[part] = _padded(skip[r, part], cp).bfloat16()
                s16 = _own(skip16, part, c)
                for n0 in range(0, 2 * h, END_COLS):
                    nc = min(END_COLS, 2 * h - n0)
                    e = _stage_mm(s16, a.end_plane()[n0:n0 + _r(nc, CH)])
                    y[r, part, n0:n0 + nc] = e[:, :nc] + b_end[r, n0:n0 + nc]
    return y, aud, skip


def wn_fwd16_tiles_plain(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end,
                         b_end, t_len: int, bf16: bool = True, tile_rows=None):
    """``wn_fwd_plain(..., bf16=True)``'s contract computed as the bf16
    kernels stage it, one run (``bf16``, passed by ``WNCore``, must be on)."""
    assert bf16, "the staging mirror is the bf16 kernels'"
    ins = (x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end, b_end)
    return tuple(o[0] for o in wn_fwd16_runs_tiles(*(t[None] for t in ins), t_len, tile_rows))


def _fwd_args(b, t, h, c, n_layers, seed):
    """(x2, the stacked effective weights, T): random weight norms and a
    non-zero end projection (the init's zero end would zero y)."""
    g = torch.Generator().manual_seed(seed)
    params = flow.wn_init(g, h, n_layers, c)
    params["end"]["weight"] = 0.3 * torch.randn(c, 2 * h, generator=g)
    params["end"]["bias"] = 0.1 * torch.randn(2 * h, generator=g)
    for layer in params["in_layers"] + params["res_skip_layers"] + [params["start"], params["cond"]]:
        layer["g"] = layer["g"] * (0.5 + torch.rand(layer["g"].shape, generator=g))
    eff = [e.detach() for e in wn_fused.stack_effective(params, weight_norm_weight)]
    return (torch.randn(b * t, h, generator=g), *eff, t)


def _l2(got, want) -> float:
    return _rel_l2(got.numpy(), want.numpy())


#: (B, T, H, C, layers): rows 74 (16-row tiles), 3,000 (32-row) and 4,500 (64-row), each
#: with a ragged last tile
CASES = [
    (2, 37, 25, 12, 7),  # H 25, C % 8 != 0, T % 8 != 0, d = 64 past T; 74 rows: 4 x 16 + 10
    (3, 1000, 9, 20, 3),  # 3,000 rows: 32-row tiles, the last 24 rows
    (5, 900, 25, 33, 4),  # 4,500 rows: 64-row tiles, the last 20; C 33 padded to 40
]


@pytest.mark.parametrize("b, t, h, c, n_layers", CASES)
def test_bf16_fwd_tiles_mirror_matches_wn_fwd_plain(b, t, h, c, n_layers):
    """The mirror against ``wn_fwd_plain(..., bf16=True)``: each layer from
    its own input (``wn_fwd_plain_layers``) within 1e-4, free-running within
    1e-3, the outputs' shapes and finite values; the tile size the rule
    gives these rows."""
    args = _fwd_args(b, t, h, c, n_layers, seed=b + t + c)
    rows = b * t
    assert wn_fused.fwd_row_tile(rows, SMS) == {74: 16, 3000: 32, 4500: 64}[rows]
    got = wn_fwd16_tiles_plain(*args)
    want = wn_fused.wn_fwd_plain(*args, True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _l2(g, w) <= REL_L2, _l2(g, w)
    forced = wn_fused.wn_fwd_plain_layers(args[0], got[1], got[2], *args[1:], True)
    for name, g, f in zip(("aud", "skip", "y"), (got[1], got[2], got[0]), forced):
        assert _l2(g, f) <= LAYER_BAR, (name, _l2(g, f))


@pytest.mark.parametrize("tile_rows", [16, 32, 64])
def test_bf16_fwd_tile_size_moves_no_bit(tile_rows):
    """A row's arithmetic does not depend on its tile: every tile size gives
    the bits of the others (the halo reads the other copy of the ping-pong,
    so a tile never reads a row that an earlier tile of its layer wrote)."""
    args = _fwd_args(2, 37, 25, 12, 7, seed=3)
    want = wn_fwd16_tiles_plain(*args, tile_rows=74)
    for g, w in zip(wn_fwd16_tiles_plain(*args, tile_rows=tile_rows), want):
        assert torch.equal(g, w)


def test_bf16_fwd_tiles_mirror_runs_give_the_one_run_bits():
    """Two runs in one call: each run's work area is its own (the passes
    take the runs together, so an overlap would move a run's values), and
    each run gives the one-run call's bits."""
    cases = [_fwd_args(2, 37, 25, 12, 7, seed=s) for s in (1, 2)]
    stacked = [torch.stack(parts) for parts in zip(*(a[:-1] for a in cases))]
    out = wn_fwd16_runs_tiles(*stacked, 37)
    for r, args in enumerate(cases):
        one = wn_fwd16_runs_tiles(*(a[None] for a in args[:-1]), 37)
        for got, want in zip(out, one):
            assert torch.equal(got[r], want[0])


def test_bf16_fwd_z_plane_is_the_backward_one():
    """The forward's z plane is laid out as the bf16 backward's (both take
    ``z_weight16``): the same bf16 values at every position."""
    rows, c, h, n_layers = 74, 12, 25, 2
    args = _fwd_args(2, 37, h, c, n_layers, seed=5)
    w_cond, w_in, w_rs, w_end = args[3], args[5], args[7], args[9]
    fbuf = torch.zeros(wn_fused.fwd_wsplit_words(rows, c, h, n_layers, True), dtype=torch.int32)
    bbuf = torch.zeros(wn_fused.bwd_wsplit_words(rows, c, h, n_layers, True), dtype=torch.int32)
    fa, ba = FArea(fbuf, 0, rows, c, h, n_layers), Area(bbuf, 0, rows, c, h, n_layers)
    _write_fwd_planes(fa, w_in, w_cond, w_rs, w_end, n_layers)
    for i in range(n_layers):
        _write_planes(ba, i, w_in, w_cond, w_rs)
        assert torch.equal(fa.z(i), ba.plane(i, "z"))


@pytest.mark.parametrize("b, t, h, c", [(2, 37, 25, 12)])
def test_bf16_fwd_tiles_mirror_matches_jax_wn_apply(b, t, h, c, monkeypatch):
    """The port's fused ``wn_apply`` under ``FLSTTSC_WN_MXU=bf16`` with its
    forward taken by the mirror (7 layers: d = 64 past T) against the JAX
    package's fused WN, its Pallas kernels in interpret mode: the value and
    every gradient (the backward the plain one, on the mirror's aud and
    skip) within relative L2 1e-3."""
    _interpret(monkeypatch)
    params, x = _wn_case(b, t, h, c, 7, seed=t + h + 1)
    monkeypatch.setenv("FLSTTSC_WN_MXU", "bf16")
    monkeypatch.setattr(wn_fused, "wn_fwd_plain", wn_fwd16_tiles_plain)
    y16, g16 = _port_wn(params, x, c)
    jy16, jg16 = _jax_wn(params, x, c)
    assert _rel_l2(y16, jy16) <= REL_L2
    assert set(g16) == set(jg16)
    for k, want in jg16.items():
        assert g16[k].shape == want.shape, k
        assert _rel_l2(g16[k], want) <= REL_L2, (k, _rel_l2(g16[k], want))


@pytest.mark.parametrize(
    "rows, c, h, n_layers, bf16, words",
    [
        # pair, bf16: planes 8 x 240 x (512 + 128) + 56 x 128 values, copies 46,080 x (32 + 4 x 120)
        (46_080, 120, 25, 8, True, 12_414_464),
        # pair, f32: hi and lo planes 8 x 2 x 240 x (416 + 128) + 2 x 56 x 128 words (32-deep stages)
        (46_080, 120, 25, 8, False, 2_103_296),
        # C 33 -> Cp 40, H 9 -> Hp 16, Ep 24: 3 x 80 x (256 + 128) + 24 x 128 + 130 x (16 + 160)
        # = 118,112 values: 59,056 words
        (130, 33, 9, 3, True, 59_056),
    ],
)
def test_fwd_scratch_sizes(rows, c, h, n_layers, bf16, words):
    """The forward's work area (``fwd_wsplit_words``, the library's
    ``wn_fwd_wsplit_words`` mirrored) and the scratch ``_launch_fwd``
    allocates from it: f32 acts (runs, R, C) or none (bf16), the area a run."""
    assert wn_fused.fwd_wsplit_words(rows, c, h, n_layers, bf16) == words
    acts, wsplit = wn_fused.fwd_scratch(2, rows, c, n_layers, bf16, words, "cpu")
    assert acts.numel() == (0 if bf16 else 2 * rows * c) and acts.dtype == torch.float32
    assert wsplit.shape == (2 * words,) and wsplit.dtype == torch.int32


@pytest.mark.parametrize(
    "rows, tile", [(46_080, 64), (23_040, 64), (6_000, 64), (4_225, 64), (4_224, 32), (2_400, 32),
                   (2_113, 32), (2_112, 16), (450, 16), (1, 16)])
def test_fwd_row_tile_rule(rows, tile):
    """64-row tiles, halved while the smaller tiles still fit one wave of a
    block on each of an H100's 132 SMs: VendGunPoint's pair pass (6,000
    rows) keeps 64, VendCoffee's (2,400) takes 32."""
    assert wn_fused.fwd_row_tile(rows, SMS) == tile


def test_bf16_fwd_global_launches():
    """The bf16 forward launches 3 + L ``__global__`` kernels a call: the x
    copy, the planes, the start projection, one a layer."""
    assert wn_fused.global_launches(8, bf16=True)["wn_fwd"] == 11
    assert wn_fused.global_kernels(8, bf16=True)["wn_fwd"] == {
        "bf16_copies_kernel": 1, "wsplit16_fwd_kernel": 1, "rowgemm_kernel": 1,
        "wn_layer_fwd16_kernel": 8}
    assert wn_fused.global_launches(8)["wn_fwd"] == 10
