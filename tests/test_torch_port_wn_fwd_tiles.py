"""How ``wn_fwd`` stages its work, held on the CPU against the JAX package.

``wn_fwd_tiles_plain`` (here) is the plain mirror of the forward kernel's
staging: per tile of rows, the z operand as row ranges
``aud[r -+ d]`` with one mask a row beside ``aud[r]`` and ``x[r]``, then the
gate, res/skip over the acts and the end projection over the skip sum, each
product through one matrix-product function.

* With the float32 product, the port's fused ``wn_apply`` with its forward
  computed by the mirror (and, as a second case, by ``wn_fwd_plain``) goes
  against the JAX package's ``wn_apply`` (its XLA path, as
  ``test_wn_matches_jax_wn_apply`` takes it) at geometries the other WN
  tests leave out: 2H past one 128-column chunk of the end projection, C
  not a multiple of 8, and rows not a multiple of the row tile with series
  that cross tile boundaries.  Tolerance rtol/atol 3e-4 / 5e-4, as
  ``test_torch_port_train_ops.py`` holds the 8-layer WN.
* With a numpy emulation of the tensor core's products (each term split
  into TF32 hi/lo, 8-deep mma steps whose accumulate truncates, each
  32-deep stage summed into zeroed registers and added to the running sum
  with one rounded float32 add), the whole 8-layer forward at C 120 stays
  within 1e-6 of float64 (max |error| over max |float64|) in y, aud and
  skip with three TF32 products a term, and one TF32 product a term misses
  1e-5: the ground of the kernel's 1e-5 gate against ``wn_fwd_plain``.
"""

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
from test_torch_port_wn_bwd_tiles import _stage_rows, _trunc32

STAGE = 32  # reduction columns a stage of the row-tile GEMM (RT_KS)
TILE = 64  # rows a tile of the forward on long series (RT_M); a row's staging does not depend on it
F32_TOL = 1e-6  # three TF32 products a term: as float32 against float64
GATE_TOL = 1e-5  # chip_smoke.py's WN_FWD_REL_TOL


def wn_fwd_tiles_plain(x2, w_start, b_start, w_cond, b_cond, w_in, b_in, w_rs, b_rs, w_end,
                       b_end, t_len: int, bf16: bool = False, mm=torch.matmul):
    """``wn_fwd_plain``'s contract, computed as ``wn_fwd``'s kernels stage it,
    with every layer product (z, res/skip, the end projection) taken by
    ``mm``; the start projection stays a float32 product, as the kernel's
    FMA row GEMM takes it.  ``bf16`` (``FLSTTSC_WN_MXU``, passed by
    ``WNCore``) must be off: this mirrors the f32 kernels."""
    assert not bf16, "the staging mirror is the f32 kernels'"
    n_layers, _, c, _ = w_in.shape
    rows = x2.shape[0]
    pos = torch.arange(rows) % t_len
    b_z = b_in + b_cond.reshape(n_layers, 2 * c)
    audio = x2 @ w_start + b_start
    aud, skip = [], 0
    for i in range(n_layers):
        d = 2 ** i
        aud.append(audio)
        w_z = torch.cat([w_in[i].reshape(3 * c, 2 * c), w_cond[:, 2 * c * i : 2 * c * (i + 1)]])
        acts = torch.empty(rows, c, dtype=x2.dtype)
        for r0 in range(0, rows, TILE):
            r1 = min(r0 + TILE, rows)
            p = pos[r0:r1]
            a = torch.cat([_stage_rows(audio, r0, r1, -d, p >= d), audio[r0:r1],
                           _stage_rows(audio, r0, r1, d, p < t_len - d), x2[r0:r1]], dim=1)
            z = mm(a, w_z) + b_z[i]
            acts[r0:r1] = torch.tanh(z[:, :c]) * torch.sigmoid(z[:, c:])
        rs = mm(acts, w_rs[i])
        skip = skip + rs[:, c:] + b_rs[i, c:]
        audio = audio + rs[:, :c] + b_rs[i, :c]
    return mm(skip, w_end) + b_end, torch.stack(aud), skip


def _mm_tf32(products: int):
    """a @ w as the row-tile GEMM takes it on the tensor core: ``products``
    TF32 products a term (3: lo*hi, hi*lo, hi*hi; 1: hi*hi), each 8-deep mma
    step added to the stage's registers and truncated to float32, each stage
    of STAGE columns added to the float32 running sum."""

    def mm(a, w):
        a, w = a.numpy(), w.numpy()
        ah, wh = _tf32(a), _tf32(w)
        al, wl = _tf32(a - ah), _tf32(w - wh)
        pairs = [(al, wh), (ah, wl), (ah, wh)][-products:]
        acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
        for s0 in range(0, a.shape[1], STAGE):
            part = np.zeros(acc.shape, np.float32)
            for k0 in range(s0, min(s0 + STAGE, a.shape[1]), 8):
                for x, y in pairs:
                    step = x[:, k0 : k0 + 8].astype(np.float64) @ y[k0 : k0 + 8].astype(np.float64)
                    part = _trunc32(part.astype(np.float64) + step)
            acc = acc + part
        return torch.from_numpy(acc)

    return mm


def _fwd_args(b, t, h, c, seed):
    """Stacked effective weights of a random weight-normed WN with a
    non-zero end projection, and an input, as float32 tensors."""
    g = torch.Generator().manual_seed(seed)
    params = flow.wn_init(g, h, 8, c)
    params["end"]["weight"] = 0.3 * torch.randn(c, 2 * h, generator=g)
    params["end"]["bias"] = 0.1 * torch.randn(2 * h, generator=g)
    for layer in params["in_layers"] + params["res_skip_layers"] + [params["start"], params["cond"]]:
        layer["g"] = layer["g"] * (0.5 + torch.rand(layer["g"].shape, generator=g))
    eff = [e.detach() for e in wn_fused.stack_effective(params, weight_norm_weight)]
    return [torch.randn(b * t, h, generator=g)] + eff


@pytest.mark.parametrize("forward", ["tiles", "plain"])
@pytest.mark.parametrize(
    "b, t, h, c",
    [
        (2, 70, 70, 16),  # 2H = 140: past one 128-column chunk; 140 rows, series across tiles
        (3, 45, 9, 20),  # C = 20: padded to 24 in the gate-pair layout; 135 rows
        (4, 50, 4, 24),  # 200 rows: tiles end at 64, 128, 192 inside series; T < 2^6
    ],
)
def test_fused_wn_matches_jax_wn_apply_at_the_forward_tile_geometries(forward, b, t, h, c,
                                                                      monkeypatch):
    """Value, input grad and every param grad of the port's fused ``wn_apply``
    (its forward by the staging mirror or by ``wn_fwd_plain``) against JAX."""
    params, x = _wn_case(b, t, h, c, seed=t + h)
    if forward == "tiles":
        monkeypatch.setattr(wn_fused, "wn_fwd_plain", wn_fwd_tiles_plain)

    def jloss(p, xx):
        return jnp.sum(jnp.sin(j_flow.wn_apply(p, xx, c)))

    want = j_flow.wn_apply(params, jnp.asarray(x), c)
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    pp, xt = _port(params, grad=True), _t(x, True)
    y = flow.wn_apply(pp, xt, c)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **WN_TOL)
    loss = torch.sin(y).sum()
    (gx,) = torch.autograd.grad(loss, xt, retain_graph=True)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **WN_TOL)
    _close_trees(_grads_tree(loss, pp), want_gp, WN_TOL)


@pytest.mark.parametrize("h", [25, 168])
def test_three_tf32_products_keep_the_forward_at_f32_accuracy(h):
    """The 8-layer forward at C 120 on 300 rows (two series of 150, so the
    tiles cross a series boundary): with three TF32 products a term y, aud
    and skip stay within 1e-6 of float64, as the float32 plain version does;
    with one they miss the 1e-5 gate."""
    args = _fwd_args(2, 150, h, 120, seed=h)
    want = wn_fwd_tiles_plain(*[a.double() for a in args], 150)

    def rel(outs):
        return [((o.double() - w).abs().max() / w.abs().max()).item() for o, w in zip(outs, want)]

    three = rel(wn_fwd_tiles_plain(*args, 150, mm=_mm_tf32(3)))
    one = rel(wn_fwd_tiles_plain(*args, 150, mm=_mm_tf32(1)))
    assert max(rel(wn_fused.wn_fwd_plain(*args, 150))) < F32_TOL
    assert max(three) < F32_TOL, three
    assert max(one) > GATE_TOL, one


def test_global_launches():
    """``wn_fwd``: the weight split, the start projection and one launch a
    layer; ``wn_bwd``: 5 + 6L."""
    assert wn_fused.global_launches(8) == {"wn_fwd": 10, "wn_bwd": 53}
