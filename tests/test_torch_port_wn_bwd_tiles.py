"""How ``wn_bwd`` stages its work, held on the CPU against the JAX package.

``wn_bwd_tiles_plain`` (here) is the plain mirror of the kernels' staging:
tap operands as row ranges of ``aud`` with one mask a row, the transposed
taps of g_z masked at their source row, and every weight gradient a sum of
row-slice partials in slice order.  Its gradients go through the port's
``wn_apply`` (in place of ``wn_bwd_plain``) against ``jax.grad`` of the JAX
package's ``wn_apply``, as ``test_wn_matches_jax_wn_apply`` takes them, at T
not a multiple of 8, T < 2^i (every deep tap dead), a ragged last slice and
a last slice of one row.  A numpy emulation of the tensor core's 3xTF32
products and truncating accumulate shows why the weight-gradient kernel sums
each stage into zeroed registers: over a 46,080-row reduction the staged
sums stay under 1e-6 of float64, and one accumulator does not.

Tolerances: rtol/atol 3e-4 / 5e-4 for the 8-layer WN against JAX, as
``test_torch_port_train_ops.py`` holds it; 1e-6 of max|plain| between the
mirror and ``wn_bwd_plain`` (both float32, sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.models import flow as j_flow
from feature_level_style_transfer_for_tsc_tpu_torch.models import flow
from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
from feature_level_style_transfer_for_tsc_tpu_torch.ops import wn_fused
from test_torch_port_tap_windows import _tf32
from test_torch_port_train_ops import WN_TOL, _close_trees, _grads_tree, _port, _t, _wn_case

MIRROR_TOL = 1e-6


def _stage_rows(a: torch.Tensor, r0: int, r1: int, shift: int = 0, keep=None) -> torch.Tensor:
    """Rows ``[r0 + shift, r1 + shift)`` of ``a``, zero outside ``a`` and
    where ``keep`` (one bool a row) is false: one segment of a staged
    operand of the WN kernels, a contiguous row range and one mask a row."""
    idx = torch.arange(r0 + shift, r1 + shift, device=a.device)
    ok = (idx >= 0) & (idx < a.shape[0])
    if keep is not None:
        ok &= keep
    out = torch.zeros(r1 - r0, a.shape[1], dtype=a.dtype, device=a.device)
    out[ok] = a[idx[ok]]
    return out


def wn_bwd_tiles_plain(x2, g2, aud, skip, w_start, w_cond, b_cond, w_in, b_in, w_rs, w_end,
                       t_len: int, bf16: bool = False, split_rows: int | None = None):
    """``wn_bwd_plain``'s contract, computed as ``wn_bwd``'s kernels stage it.
    The tap operands are row ranges ``aud[r -+ d]`` with a mask a row (``pos
    >= d``, ``pos < T - d``), and the transposed taps of g_z likewise
    (``g_z[u + d]`` live iff ``pos(u + d) >= d``, ``g_z[u - d]`` iff ``pos(u
    - d) < T - d``, each tested at the source row).  Every weight gradient
    is a sum of row-slice partials ``A_s^T B_s`` in slice order, with A = [lo
    aud[r-d] | aud[r] | hi aud[r+d] | x | 1] against g_z, [acts | 1] against
    [g_audio | g_skip] and [x | 1] against g_audio_0, and its rows laid out
    as the kernel writes them (``_unpack``).  ``bf16`` (``FLSTTSC_WN_MXU``,
    passed by ``WNCore``) must be off: this mirrors the f32 kernels."""
    assert not bf16, "the staging mirror is the f32 kernels'"
    n_layers, _, c, _ = w_in.shape
    rows, h = x2.shape
    split = split_rows or wn_fused.wgrad_split_rows(rows)
    pos = torch.arange(rows, device=x2.device) % t_len
    ones = torch.ones(rows, 1, dtype=x2.dtype, device=x2.device)

    def wgrad(a_of, b):
        total = None
        for r0 in range(0, rows, split):
            r1 = min(r0 + split, rows)
            part = a_of(r0, r1).T @ b[r0:r1]
            total = part if total is None else total + part
        return total

    b_z = b_in + b_cond.reshape(n_layers, 2 * c)
    g_skip = g2 @ w_end.T
    g_audio = torch.zeros_like(g_skip)
    g_x = torch.zeros_like(x2)
    g_in, g_rs = [None] * n_layers, [None] * n_layers
    for i in reversed(range(n_layers)):
        d, audio = 2 ** i, aud[i]
        w_c = w_cond[:, 2 * c * i : 2 * c * (i + 1)]

        def a_in(r0, r1, audio=audio, d=d):
            p = pos[r0:r1]
            return torch.cat([_stage_rows(audio, r0, r1, -d, p >= d), audio[r0:r1],
                              _stage_rows(audio, r0, r1, d, p < t_len - d), x2[r0:r1],
                              ones[r0:r1]], dim=1)

        z = a_in(0, rows)[:, : 3 * c + h] @ torch.cat([w_in[i].reshape(3 * c, 2 * c), w_c]) + b_z[i]
        tt, ss = torch.tanh(z[:, :c]), torch.sigmoid(z[:, c:])
        acts = tt * ss
        grs = torch.cat([g_audio, g_skip], dim=1)
        g_rs[i] = wgrad(lambda r0, r1: torch.cat([acts[r0:r1], ones[r0:r1]], dim=1), grs)
        g_acts = grs @ w_rs[i].T
        g_z = torch.cat([g_acts * ss * (1 - tt * tt), g_acts * tt * ss * (1 - ss)], dim=1)
        g_in[i] = wgrad(a_in, g_z)
        g_x = g_x + g_z @ w_c.T
        src_pos_up = (pos + d) % t_len  # pos(u + d)
        src_pos_dn = (pos - d) % t_len  # pos(u - d)
        g_audio = g_audio + torch.cat([
            _stage_rows(g_z, 0, rows, d, src_pos_up >= d), g_z,
            _stage_rows(g_z, 0, rows, -d, src_pos_dn < t_len - d),
        ], dim=1) @ w_in[i].transpose(1, 2).reshape(3 * 2 * c, c)
    g_start = wgrad(lambda r0, r1: torch.cat([x2[r0:r1], ones[r0:r1]], dim=1), g_audio)
    gx = g_x + g_audio @ w_start.T
    return wn_fused._unpack(gx, torch.stack(g_in), torch.stack(g_rs), g_start, skip, g2)


@pytest.mark.parametrize(
    "b, t, h, split",
    [
        (2, 37, 5, 32),  # T % 8 != 0, d = 64 and 128 past T; 74 rows: a ragged last slice of 10
        (3, 20, 4, 32),  # every tap from layer 5 on dead; 60 rows: 32 + 28
        (1, 65, 3, 32),  # a slice boundary + 1: the last slice is one row
        (1, 63, 3, 32),  # a slice boundary - 1
        (2, 32, 3, 32),  # slices that end on series boundaries
    ],
)
def test_tiles_mirror_matches_jax_wn_apply(b, t, h, split, monkeypatch):
    """Value, input grad and every param grad of the port's fused ``wn_apply``
    with its backward computed by the staged mirror, against JAX."""
    c = 16
    params, x = _wn_case(b, t, h, c, seed=t + split)
    monkeypatch.setattr(wn_fused, "wn_bwd_plain",
                        functools.partial(wn_bwd_tiles_plain, split_rows=split))

    def jloss(p, xx):
        return jnp.sum(jnp.sin(j_flow.wn_apply(p, xx, c)))

    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    pp, xt = _port(params, grad=True), _t(x, True)
    loss = torch.sin(flow.wn_apply(pp, xt, c)).sum()
    (gx,) = torch.autograd.grad(loss, xt, retain_graph=True)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **WN_TOL)
    _close_trees(_grads_tree(loss, pp), want_gp, WN_TOL)


def _bwd_args(b, t, h, c, n_layers, seed):
    g = torch.Generator().manual_seed(seed)
    params = flow.wn_init(g, h, n_layers, c)
    params["end"]["weight"] = 0.3 * torch.randn(c, 2 * h, generator=g)
    eff = [e.detach() for e in wn_fused.stack_effective(params, weight_norm_weight)]
    x2 = torch.randn(b * t, h, generator=g)
    g2 = torch.randn(b * t, 2 * h, generator=g)
    _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t)
    return (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)


@pytest.mark.parametrize(
    "b, t, h, c",
    [
        (40, 60, 17, 24),  # VendCoffee's rows: 2,400, slices of 64, d >= T from layer 6 on
        (3, 150, 9, 33),  # VendGunPoint's T; C and H off every tile
        (1, 1100, 4, 8),  # one long series: 35 slices of 32 rows, the last of 12
    ],
)
def test_tiles_mirror_matches_wn_bwd_plain(b, t, h, c):
    """The mirror with ``wgrad_split_rows``'s slices equals ``wn_bwd_plain``
    output by output, the layouts of ``_unpack`` included."""
    args = _bwd_args(b, t, h, c, 8, seed=b + t)
    got = wn_bwd_tiles_plain(*args)
    want = wn_fused.wn_bwd_plain(*args)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= MIRROR_TOL * w.abs().max()


def test_stage_rows_is_a_masked_row_range():
    a = torch.arange(20.0).reshape(10, 2)
    keep = torch.tensor([True, False, True, True])
    got = _stage_rows(a, 7, 11, 2, keep)  # rows 9, 10, 11, 12 of a: only 9 exists
    assert got.tolist() == [[18.0, 19.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]
    assert _stage_rows(a, 0, 3, -1).tolist() == [[0.0, 0.0], [0.0, 1.0], [2.0, 3.0]]


@pytest.mark.parametrize(
    "rows, split, slices",
    [(46_080, 736, 63), (23_040, 384, 60), (6_000, 96, 63), (2_400, 64, 38), (450, 32, 15),
     (10, 32, 1), (200_000, 1_024, 196)],
)
def test_wgrad_slices_are_whole_stages_and_fill_the_card(rows, split, slices):
    """Slices are whole 32-row stages of at most 1,024 rows, about 64 of them
    where the rows allow: at 2,400 rows (VendCoffee's pair pass) 38 slices
    where 1,024-row slices made 3."""
    assert wn_fused.wgrad_split_rows(rows) == split
    assert -(-rows // split) == slices


def _trunc32(v: np.ndarray) -> np.ndarray:
    """float64 to float32 rounded toward zero, as the tensor core's
    accumulate keeps its sum."""
    f = v.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(v), np.nextafter(f, np.float32(0)), f)


def _emulated_wgrad(a, b, stage_steps: int, slice_rows: int) -> np.ndarray:
    """A^T B as the kernel takes it: per mma k-step of 8 rows the three TF32
    products lo*hi, hi*lo, hi*hi, each added to the stage's registers and
    truncated to float32; each stage of ``stage_steps`` k-steps added to the
    slice's sum, the slices summed in order, both with rounded float32 adds."""
    m, n = a.shape[1], b.shape[1]
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)

    def steps(x, y):
        return np.einsum("skm,skn->smn", x.reshape(-1, 8, m).astype(np.float64),
                         y.reshape(-1, 8, n).astype(np.float64))

    prods = np.stack([steps(al, bh), steps(ah, bl), steps(ah, bh)], axis=1)
    total = np.zeros((m, n), np.float32)
    for r0 in range(0, len(a), slice_rows):
        acc = np.zeros((m, n), np.float32)
        s1 = min(r0 + slice_rows, len(a)) // 8
        for st in range(r0 // 8, s1, stage_steps):
            part = np.zeros((m, n), np.float32)
            for terms in prods[st : min(st + stage_steps, s1)]:
                for p in terms:
                    part = _trunc32(part.astype(np.float64) + p)
            acc = acc + part
        total = total + acc
    return total


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_sums_keep_a_long_row_reduction_at_f32_accuracy(seed):
    """One mma tile of gwi at the pair shape's 46,080 rows: the kernel's
    staging (4 k-steps a stage, ``wgrad_split_rows`` slices) stays under
    1e-6 of float64, as float32 does; one tensor-core accumulator over every
    row does not."""
    rows = 46_080
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, 16)).astype(np.float32)
    b = rng.standard_normal((rows, 8)).astype(np.float32)
    want = a.astype(np.float64).T @ b.astype(np.float64)

    def rel(y):
        return np.abs(y - want).max() / np.abs(want).max()

    staged = _emulated_wgrad(a, b, wn_fused.STAGE_ROWS // 8, wn_fused.wgrad_split_rows(rows))
    single = _emulated_wgrad(a, b, rows // 8, rows)
    assert rel(staged) < 1e-6
    assert rel(single) > 1e-6
    assert rel(a.T @ b) < 1e-6
