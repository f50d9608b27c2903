"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without a CUDA card.  The file imports neither jax nor the JAX
package, so that it runs on a GPU machine without jax:

    pytest --noconftest tests/test_torch_port_kernels.py -m gpu

Shapes cover the ragged edges of the kernels' tiles: for the OS conv, time
not a multiple of the 128-row tile, C_out not a multiple of 4 or of the C_out
tile, C_in not a multiple of the 8-channel chunk, every taps-a-stage size (K
of 1, 2, 3, 5, 89), and the real masked weights of the serving model's
layers (C_in 7, 25, 50 and 225; C_out 25, 225 and 50), with a column group
whose taps are all zero and a stray nonzero weight outside the mask, so the
tap windows of the pre-pass are exercised; for the WN kernels, rows not a multiple of the 64-row
tile or below one tile, T < 2^7 (the deep layers' taps all masked), B = 1,
C, H off the mma tiling, a last weight-gradient slice of one row or one row
short, H of 65 and 168 (VendGunPoint's and VendCoffee's, past one
128-column chunk, and VendCoffee's pair pass), and each of ``wn_fwd``'s row
tiles (64 rows, and 32 or 16 where the smaller tiles still fit one wave of
a block an SM); for the gate, rows and n off the thread grid, n and row
strides off multiples of 4, operands one column off a 16-byte boundary, the
pair pass's cond slice, no row and one row, the same bits twice; for the tap conv, time and C_out off the 128 x 64 tile,
C_in off the 8-channel chunk, dilations up to 128 (also with t_out < d).  Tolerance: max|kernel - plain| <= 1e-4 * max|plain| for
forward values, both exact float32 with TF32 off, the sums taken in another
order; 1e-5 for every ``wn_fwd`` and ``wn_bwd`` output (3xTF32 stage sums,
fixed-order row-slice partials), and 1e-3 for the other weight gradients,
sums over every row in another order.  Four tests pin what the
3xTF32 kernels return for non-finite inputs, which their contract leaves
out.  Two hold one training step of each baseline (CoDATS, a
SLARDA target step) with the OS conv kernel against the same step with its
plain version on the card.  The last ones run the archive sweep's shapes:
``os_conv_fwd`` and ``OSConvCore``'s dx and dw at the bucket lengths 729
and 1094 for every layer of the (1, 89) bucket's model (C_in = 1 first),
and one padded ``BucketedOSCNNClassifier.train_batch`` of the FordA bucket
against the same step with the plain OS conv.  The run-axis forms of the
multi-run training (``os_conv_fwd_runs``, ``os_conv_fused_fwd_runs``,
``wn_fwd_runs``, ``wn_bwd_runs``) at small K and B: each run the same bits
as a one-run call, and within the gates above of the plain versions; the
run-axis conv's grouped backward and the vmap rules of ``OSConvCore`` and
``WNCore`` (one run-axis launch for all runs) against per-run calls.  The
bf16 conv kernel (``tap_gemm_bf16.cuh``) at the serving layers' masked
weights (C_in 7, 25, 225 and 50: one, four, 29 and seven 8-channel chunks
a tap) at T off every time tile, with a dead column group, with windows
narrowed to fewer channels or taps than the layer has, and its run-axis
form at R = 3 (each run the one-run call's bits).  Under a batch of
cotangents (``stacked_pullbacks``): the WN backward of one run and of K = 2
runs as one ``wn_bwd_runs`` launch, each cotangent the one-cotangent call's
bits (f32 and bf16), and the tap conv's input gradient as one folded
``tap_conv_fwd`` launch with the bits of the single pulls.  The op-by-op
route's run axes: ``tap_conv_fwd_runs`` (each run the one-run call's bits;
split on the host past the grid's limit) and the vmap rules of
``TapConvCore`` and ``GateCore`` (one launch each for K runs).  The
run-axis OS conv split on the host past the grid's limit too, and the
ensemble's members under one ``torch.func.vmap`` (one run-axis launch a
layer, each member's logits its own call's bits).
"""

import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
from feature_level_style_transfer_for_tsc_tpu_torch.models import flow
from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import wn_init
from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels
from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import build_specs

REL_TOL = 1e-4
GRAD_REL_TOL = 1e-3
WN_REL_TOL = 1e-5  # every wn_fwd and wn_bwd output: 3xTF32 staged sums, fixed-order slice partials


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the os_conv kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol=REL_TOL):
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-30), err


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t, k, c_in, c_out",
    [
        (3, 150, 89, 25, 225),
        (2, 1152, 89, 7, 25),
        (2, 33, 2, 225, 50),
        (1, 5, 1, 5, 7),
        (2, 61, 3, 17, 33),
        (4, 100, 5, 3, 130),
    ],
)
@pytest.mark.parametrize("relu", [False, True])
def test_kernels_match_plain(card, b, t, k, c_in, c_out, relu):
    g = torch.Generator(device=card).manual_seed(k * 1000 + c_out)
    x_pad = torch.randn(b, t + k - 1, c_in, device=card, generator=g)
    w = torch.randn(k, c_in, c_out, device=card, generator=g) / (c_in * k) ** 0.5
    scale = torch.rand(c_out, device=card, generator=g) + 0.5
    shift = torch.randn(c_out, device=card, generator=g)
    before = dict(osconv.LAUNCHES)
    got = osconv.os_conv(x_pad, w)
    fused = osconv.os_conv_fused(x_pad, w, scale, shift, relu)
    torch.cuda.synchronize()
    assert got.shape == fused.shape == (b, t, c_out)
    assert osconv.LAUNCHES["os_conv_fwd"] == before["os_conv_fwd"] + 1
    assert osconv.LAUNCHES["os_conv_fused_fwd"] == before["os_conv_fused_fwd"] + 1
    _close(got, osconv.os_conv_plain(x_pad, w))
    _close(fused, osconv.os_conv_fused_plain(x_pad, w, scale, shift, relu))


def _serving_layer(i):
    """Spec of layer ``i`` of the SCP2 serving model (extractor then classifier)."""
    ext, cls = build_specs(7, 1152, PipelineConfig())
    return (ext + cls)[i]


@pytest.mark.gpu
@pytest.mark.parametrize("layer", [0, 1, 2, 3])  # 7 -> 25, 25 -> 225, 225 -> 50 (K=2), 50 -> 25
@pytest.mark.parametrize("edit", ["mask", "dead group", "stray tap"])
def test_kernels_match_plain_on_masked_weights(card, layer, edit):
    """The real masked weights of a serving layer at T off the 128-row tile,
    as they are, with one column group all zero (window empty, output 0
    before the epilogue), and with one nonzero weight outside the mask (the
    window must widen to reach it)."""
    spec = _serving_layer(layer)
    k, c_in, c_out = spec[-1][-1], spec[0][0], total_out_channels(spec)
    g = torch.Generator(device=card).manual_seed(layer)
    mask = torch.from_numpy(osconv.build_os_mask(spec)).to(card)
    w = torch.randn(k, c_in, c_out, device=card, generator=g) / (c_in * k) ** 0.5 * mask
    if edit == "dead group":
        w[:, :, 8:16] = 0.0
    elif edit == "stray tap":
        w[k - 1, c_in - 1, 0] = 0.5  # column 0 is the kernel-1 branch: its last tap is dead
    x_pad = torch.randn(2, 300 + k - 1, c_in, device=card, generator=g)
    scale = torch.rand(c_out, device=card, generator=g) + 0.5
    shift = torch.randn(c_out, device=card, generator=g)
    before = dict(osconv.LAUNCHES)
    got = osconv.os_conv(x_pad, w)
    fused = osconv.os_conv_fused(x_pad, w, scale, shift, True)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["os_conv_fwd"] == before["os_conv_fwd"] + 1
    assert osconv.LAUNCHES["os_conv_fused_fwd"] == before["os_conv_fused_fwd"] + 1
    _close(got, osconv.os_conv_plain(x_pad, w))
    _close(fused, osconv.os_conv_fused_plain(x_pad, w, scale, shift, True))
    if edit == "dead group":
        assert torch.equal(got[:, :, 8:16], torch.zeros_like(got[:, :, 8:16]))


@pytest.mark.gpu
def test_masked_os_conv_on_card_matches_cpu(card, monkeypatch):
    """The whole op (mask, padding, bias, folded BN) on the card against the
    same op on the CPU, through both kernels."""
    spec = [(6, 4, kk) for kk in (1, 2, 3, 5, 7, 11)]
    params = osconv.init_os_conv_params(torch.Generator().manual_seed(0), spec)
    mask = torch.from_numpy(osconv.build_os_mask(spec))
    x = torch.randn(3, 70, 6, generator=torch.Generator().manual_seed(1))
    scale, shift = torch.rand(24) + 0.5, torch.randn(24)
    for fuse in ("0", "1"):
        monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", fuse)
        args = (x, params["weight"], params["bias"], mask)
        want = osconv.masked_os_conv(*args, scale=scale, shift=shift, relu=True)
        got = osconv.masked_os_conv(
            *(a.to(card) for a in args), scale=scale.to(card), shift=shift.to(card), relu=True
        )
        _close(got.cpu(), want)


@pytest.mark.gpu
def test_wrapper_refuses_non_contiguous_input(card):
    x_pad = torch.randn(2, 12, 4, device=card).transpose(0, 1)
    w = torch.randn(3, 4, 5, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        osconv.os_conv(x_pad, w)


def _wn_operands(card, b, t, h, c, n_layers, seed):
    """Stacked effective WN weights (random weight norm, non-zero end: the
    init's zero end would hide most of the backward) and an input."""
    g = torch.Generator().manual_seed(seed)
    params = wn_init(g, h, n_layers, c)
    params["end"]["weight"] = 0.3 * torch.randn(c, 2 * h, generator=g)
    params["end"]["bias"] = 0.1 * torch.randn(2 * h, generator=g)
    for layer in params["in_layers"] + params["res_skip_layers"] + [params["start"], params["cond"]]:
        layer["g"] = layer["g"] * (0.5 + torch.rand(layer["g"].shape, generator=g))
    eff = [e.contiguous().to(card) for e in wn_fused.stack_effective(params, weight_norm_weight)]
    x = torch.randn(b, t, h, generator=g).to(card)
    return params, eff, x


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t, h, c, n_layers",
    [
        (3, 150, 25, 120, 8),  # 450 rows: a ragged last tile
        (2, 37, 5, 16, 8),  # T < 2^7
        (1, 1152, 25, 120, 8),  # B = 1 at the training length
        (4, 20, 3, 33, 3),  # C and H off the thread tiling
        (2, 150, 65, 120, 8),  # VendGunPoint's H: 2H past one column chunk
        (3, 60, 168, 120, 8),  # VendCoffee's H: H and 2H past one chunk
        (1, 40, 25, 120, 8),  # 40 rows: below one row tile and one slice stage
        (1, 65, 25, 120, 8),  # 32-row slices: a last slice of one row
        (1, 63, 25, 120, 8),  # a last slice one row short
        (40, 60, 168, 120, 8),  # VendCoffee's pair pass: 38 slices of 64, d >= T from layer 6
        (8, 1152, 25, 120, 8),  # 144 tiles of 64 rows: wn_fwd's widest tile
        (9, 1000, 7, 33, 3),  # 141 tiles of 64 rows, the last ragged, C and H off the tiling
        (3, 1000, 9, 40, 4),  # 3,000 rows: wn_fwd's 32-row tiles (16 from 2,112 rows down)
    ],
)
def test_wn_kernels_match_plain(card, b, t, h, c, n_layers):
    _, eff, x = _wn_operands(card, b, t, h, c, n_layers, seed=b * 100 + t)
    x2 = x.reshape(b * t, h).contiguous()
    before = dict(wn_fused.LAUNCHES)
    got = wn_fused.wn_fwd(x2, *eff, t)
    twice = wn_fused.wn_fwd(x2, *eff, t)
    want = wn_fused.wn_fwd_plain(x2, *eff, t)
    for gv, wv, av in zip(got, want, twice):
        _close(gv, wv, WN_REL_TOL)
        assert torch.equal(gv, av)
    g2 = torch.randn(b * t, 2 * h, device=card, generator=torch.Generator(card).manual_seed(7))
    _, aud, skip = want
    bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
    grads = wn_fused.wn_bwd(*bwd_args)
    again = wn_fused.wn_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert wn_fused.LAUNCHES["wn_fwd"] == before["wn_fwd"] + 2
    assert wn_fused.LAUNCHES["wn_bwd"] == before["wn_bwd"] + 2
    for gv, wv, av in zip(grads, wn_fused.wn_bwd_plain(*bwd_args), again):
        assert gv.shape == wv.shape
        _close(gv, wv, WN_REL_TOL)
        assert torch.equal(gv, av)  # fixed-order reductions: the same bits every run


@pytest.mark.gpu
def test_wn_core_on_card_matches_cpu(card):
    """The WN through ``WNCore`` with autograd: value, input grad and every
    effective-weight grad on the card against the same op on the CPU."""
    b, t, h, c = 2, 90, 6, 24
    _, eff, x = _wn_operands("cpu", b, t, h, c, 8, seed=3)
    out = {}
    for dev in ("cpu", card):
        ins = [a.to(dev).requires_grad_(True) for a in [x] + eff]
        y = wn_fused.WNCore.apply(*ins, False)[0]
        grads = torch.autograd.grad(torch.sin(y).sum(), ins)
        out[str(dev)] = [y.detach().cpu()] + [gr.cpu() for gr in grads]
    for got, want in zip(out[str(card)], out["cpu"]):
        _close(got, want, GRAD_REL_TOL)


@pytest.mark.gpu
def test_os_conv_autograd_on_card(card):
    """The masked OS conv on the card carries gradients (``OSConvCore``): the
    weights' and the input's equal the plain path's."""
    spec = [(6, 4, kk) for kk in (1, 2, 3, 5, 7, 11)]
    params = osconv.init_os_conv_params(torch.Generator().manual_seed(0), spec)
    mask = torch.from_numpy(osconv.build_os_mask(spec))
    x = torch.randn(3, 70, 6, generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", card):
        w = params["weight"].to(dev).requires_grad_(True)
        bias = params["bias"].to(dev).requires_grad_(True)
        xd = x.to(dev).requires_grad_(True)
        y = osconv.masked_os_conv(xd, w, bias, mask.to(dev))
        grads[str(dev)] = [gr.cpu() for gr in torch.autograd.grad(torch.sin(y).sum(), (xd, w, bias))]
    for got, want in zip(grads[str(card)], grads["cpu"]):
        assert got.abs().max() > 0
        _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("lead, n, b_width, b_col, a_col", [
    ((2, 37), 120, 720, 240, 0),
    ((1, 5), 3, 18, 6, 0),
    ((4, 33), 65, 390, 130, 0),
    ((40 * 1152,), 120, 1920, 720, 0),  # the pair pass: b is layer 3's slice of the cond projection
    ((3, 50), 61, 245, 61, 0),  # n % 4 != 0, b's row stride % 4 != 0
    ((2, 45), 120, 481, 1, 1),  # a and b one column off a 16-byte boundary, b's stride 481
    ((0,), 120, 240, 0, 0),  # M = 0
    ((1,), 120, 1920, 720, 0),  # M = 1
])
def test_gate_kernel_matches_plain(card, lead, n, b_width, b_col, a_col):
    """``gate_fwd`` against ``gate_plain``, ``a`` and ``b`` column slices of
    wider tensors (row-strided views, as the WN's cond projection), the same
    bits twice; one launch a call with rows, none without."""
    g = torch.Generator(device=card).manual_seed(n + b_width)
    a = torch.randn(*lead, a_col + 2 * n, device=card, generator=g)[..., a_col:]
    b = torch.randn(*lead, b_width, device=card, generator=g)[..., b_col : b_col + 2 * n]
    before = gate.LAUNCHES["gate_fwd"]
    got = gate.gate_fwd(a, b, n)
    again = gate.gate_fwd(a, b, n)
    torch.cuda.synchronize()
    rows = a.numel() // (2 * n)
    assert gate.LAUNCHES["gate_fwd"] == before + (2 if rows else 0)
    assert got.shape == (*lead, n)
    assert torch.equal(got, again)
    if rows:
        _close(got, gate.gate_plain(a, b, n))
    column_major = torch.randn(2 * n, 7, device=card).T  # no (M, 2n) view with unit column stride
    with pytest.raises(ValueError, match="row-strided"):
        gate.gate_fwd(column_major, column_major, n)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t_out, c_in, c_out, d",
    [
        (2, 150, 120, 240, 1),
        (3, 37, 240, 120, 128),  # t_out < d: taps reach far past the tile
        (1, 5, 7, 9, 2),
        (4, 100, 17, 33, 64),
        (1, 1152, 120, 240, 16),
        (2, 50, 13, 240, 128),  # t_out < d, C_in off the 8-channel chunk
    ],
)
def test_tap_conv_kernel_matches_plain(card, b, t_out, c_in, c_out, d):
    g = torch.Generator(device=card).manual_seed(d * 10 + c_in)
    x_pad = torch.randn(b, t_out + 2 * d, c_in, device=card, generator=g)
    w = torch.randn(3, c_in, c_out, device=card, generator=g) / (3 * c_in) ** 0.5
    before = osconv.LAUNCHES["tap_conv_fwd"]
    got = osconv.tap_conv_fwd(x_pad, w, d)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["tap_conv_fwd"] == before + 1
    assert got.shape == (b, t_out, c_out)
    _close(got, osconv.tap_conv_plain(x_pad, w, d))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 32])
def test_tap_conv_core_grads_match_plain_autograd(card, d):
    """dx (the kernel on the flipped taps) and dw (matmuls) of
    ``TapConvCore`` against autograd of ``tap_conv_plain``."""
    g = torch.Generator(device=card).manual_seed(d)
    x_pad = torch.randn(3, 90 + 2 * d, 24, device=card, generator=g)
    w = torch.randn(3, 24, 40, device=card, generator=g) / 72 ** 0.5
    gy = torch.randn(3, 90, 40, device=card, generator=g)
    grads = []
    for fn in (osconv.tap_conv, osconv.tap_conv_plain):
        xg, wg = x_pad.clone().requires_grad_(True), w.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xg, wg, d), (xg, wg), gy))
    (dx, dw), (dx_p, dw_p) = grads
    _close(dx, dx_p)
    _close(dw, dw_p, GRAD_REL_TOL)


class _SavedTap:
    """The ctx ``TapConvCore.backward`` reads, for calling it directly."""

    def __init__(self, x_pad, w, dilation):
        self.saved_tensors, self.dilation, self.needs_input_grad = (x_pad, w), dilation, (True, False, False)


@pytest.mark.gpu
def test_tap_conv_refuses_non_float32_on_card(card):
    """A bf16 CUDA operand reaches the kernel's dtype check and raises, in
    the forward and in ``TapConvCore``'s dx; no plain version runs on the card."""
    x_pad = torch.randn(2, 20, 8, device=card, dtype=torch.bfloat16)
    w = torch.randn(3, 8, 8, device=card, dtype=torch.bfloat16)
    before = osconv.LAUNCHES["tap_conv_fwd"]
    with pytest.raises(TypeError, match="float32"):
        osconv.tap_conv(x_pad, w, 2)
    with pytest.raises(TypeError, match="float32"):
        osconv.TapConvCore.backward(_SavedTap(x_pad, w, 2), torch.ones(2, 16, 8, device=card, dtype=torch.bfloat16))
    assert osconv.LAUNCHES["tap_conv_fwd"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["conv", "pallas"])
def test_op_by_op_wn_on_card_matches_cpu(card, impl, monkeypatch):
    """``wn_apply`` on the op-by-op route: value, input grad and every
    parameter grad on the card (gate kernel; tap-conv kernel under
    "pallas") against the same route on the CPU."""
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0")
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", impl)
    params, _, x = _wn_operands("cpu", 2, 90, 6, 24, 8, seed=4)
    out = {}
    before = dict(gate.LAUNCHES, **osconv.LAUNCHES)
    for dev in ("cpu", card):
        leaves = []

        def to(node):
            if isinstance(node, torch.Tensor):
                t = node.detach().to(dev).requires_grad_(True)
                leaves.append(t)
                return t
            if isinstance(node, dict):
                return {k: to(v) for k, v in node.items()}
            return [to(v) for v in node]

        p = to(params)
        xd = x.to(dev).requires_grad_(True)
        y = flow.wn_apply(p, xd, 24)
        grads = torch.autograd.grad(torch.sin(y).sum(), [xd] + leaves)
        out[str(dev)] = [y.detach().cpu()] + [gr.cpu() for gr in grads]
    assert gate.LAUNCHES["gate_fwd"] == before["gate_fwd"] + 8
    taps = 16 if impl == "pallas" else 0
    assert osconv.LAUNCHES["tap_conv_fwd"] == before["tap_conv_fwd"] + taps
    for got, want in zip(out[str(card)], out["cpu"]):
        _close(got, want, GRAD_REL_TOL)


# The 3xTF32 kernels hold their results for finite inputs only (ROADMAP.md,
# "Semantics the port holds").  These tests pin what they return otherwise:
# the split of an inf is hi = inf, lo = inf - inf = NaN, so a product that
# reads it is NaN where the plain version has +-inf; and a tap that a mask
# makes dead is never multiplied, so its 0 * inf is not formed where the
# plain version forms it and gets NaN.

@pytest.mark.gpu
@pytest.mark.parametrize("kernel, d", [("os_conv", 1), ("tap_conv", 2)])
def test_conv_kernels_give_nan_for_an_inf_input(card, kernel, d):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 40 + 2 * d, 8, generator=g)
    w = torch.randn(3, 8, 16, generator=g)
    x[0, 20, 3] = float("inf")
    x, w = x.to(card), w.to(card)
    if kernel == "os_conv":
        got, want = osconv.os_conv(x, w), osconv.os_conv_plain(x, w)
    else:
        got, want = osconv.tap_conv_fwd(x, w, d), osconv.tap_conv_plain(x, w, d)
    hit = torch.zeros(got.shape[1], dtype=torch.bool)
    hit[[20 - j * d for j in range(3)]] = True  # y[t] reads x[t + j*d]
    assert torch.isinf(want[0, hit]).all() and torch.isnan(got[0, hit]).all()
    assert torch.isfinite(got[0, ~hit]).all()
    _close(got[0, ~hit], want[0, ~hit])


@pytest.mark.gpu
def test_os_conv_does_not_form_a_dead_taps_zero_times_inf(card):
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 42, 8, generator=g)
    w = torch.randn(3, 8, 16, generator=g)
    w[2, :, :8] = 0.0  # column group 0's window is taps [0, 2)
    finite = x.clone()
    x[0, 20, 3] = float("inf")  # read by y[18] through tap 2, dead for group 0
    got = osconv.os_conv(x.to(card), w.to(card))
    want = osconv.os_conv_plain(x.to(card), w.to(card))
    assert torch.isnan(want[0, 18, :8]).all()
    assert torch.isfinite(got[0, 18, :8]).all()
    _close(got[0, 18, :8], osconv.os_conv_plain(finite.to(card), w.to(card))[0, 18, :8])
    assert torch.isnan(got[0, 18, 8:]).all() and torch.isinf(want[0, 18, 8:]).all()


@pytest.mark.gpu
def test_wn_bwd_gives_nan_for_an_inf_input_and_skips_a_dead_taps_zero_times_inf(card):
    b, t, h, c, n_layers, layer = 2, 40, 5, 16, 4, 2
    _, eff, x = _wn_operands(card, b, t, h, c, n_layers, seed=3)
    x2 = x.reshape(b * t, h).contiguous()
    g2 = torch.randn(b * t, 2 * h, device=card, generator=torch.Generator(card).manual_seed(8))
    _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t)

    def both(g2, aud):
        args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
        return wn_fused.wn_bwd(*args), wn_fused.wn_bwd_plain(*args)

    # an inf upstream gradient: g_skip's row 7 is +-inf, and so is the last
    # layer's skip-column weight gradient in the plain version; NaN in the kernel
    g_inf = g2.clone()
    g_inf[7, 1] = float("inf")
    got, want = both(g_inf, aud)
    gwr, gwr_plain = got[7][-1][:, c:], want[7][-1][:, c:]
    assert torch.isinf(gwr_plain).all() and torch.isnan(gwr).all()
    # an inf in aud of one layer at the first row q of series 1: series 0
    # reads it only through taps that cross the series boundary (row q - d's
    # tap at r + d, masked there by pos = T - d), so the kernels, which never
    # multiply a masked tap, keep series 0's input gradient finite, where the
    # plain version forms 0 * inf at row q - d
    d, q = 2 ** layer, t
    aud_inf = aud.clone()
    aud_inf[layer, q, 3] = float("inf")
    got, want = both(g2, aud_inf)
    assert torch.isnan(want[0][q - d]).all()
    assert torch.isfinite(got[0][:t]).all()


@pytest.mark.gpu
def test_wn_fwd_gives_nan_for_an_inf_weight_and_skips_a_masked_taps_zero_times_inf(card):
    b, t, h, c, n_layers = 2, 40, 5, 16, 4
    _, eff, x = _wn_operands(card, b, t, h, c, n_layers, seed=4)
    x2 = x.reshape(b * t, h).contiguous()
    # an inf in the end projection's weight: every row's y in that column is
    # +-inf in the plain version and NaN in the kernel's split (lo = inf -
    # inf); the other columns stay within tolerance.  (An inf in x reaches
    # both versions' FP32 start projection first and sums to NaN in both.)
    w_end = eff[8].clone()
    w_end[3, 2] = float("inf")
    args = eff[:8] + [w_end, eff[9]]
    got, want = wn_fused.wn_fwd(x2, *args, t)[0], wn_fused.wn_fwd_plain(x2, *args, t)[0]
    assert torch.isinf(want[:, 2]).all() and torch.isnan(got[:, 2]).all()
    keep = torch.arange(2 * h, device=card) != 2
    _close(got[:, keep], want[:, keep], WN_REL_TOL)
    # an inf in x at the first row q of series 1: the audio of row q is +-inf
    # from the start projection on; series 0 reads it only through taps that
    # cross the series boundary (row q - d's tap at r + d, masked by pos = T -
    # d), which the kernel never multiplies, where the plain version forms
    # 0 * inf and turns series 0 NaN
    q = t
    x_inf = x2.clone()
    x_inf[q, 1] = float("inf")
    got, want = wn_fused.wn_fwd(x_inf, *eff, t), wn_fused.wn_fwd_plain(x_inf, *eff, t)
    assert torch.isnan(want[0][q - 1]).all()
    for gv, wv in zip(got, wn_fused.wn_fwd_plain(x2, *eff, t)):
        rows = gv[..., :t, :]  # series 0 of y, of every layer's aud and of skip
        assert torch.isfinite(rows).all()
        _close(rows, wv[..., :t, :], WN_REL_TOL)


# One training step of each baseline, with the OS conv kernel on, against the
# same step with its plain version on the card (tests/test_baselines.py's
# tiny sizes).  Both start from one seeded state; the gradients each
# optimizer step is given are recorded by module: losses within REL_TOL,
# each module's gradients within GRAD_REL_TOL as relative L2 distance.
BASELINE_KW = dict(batch_size=6, max_kernel_size=5, budget_multiplier=0.02)
BASELINE_DISC = dict(disc_hid=16, disc_depth=2, disc_heads=2, disc_mlp=8)


def _baseline_step(pipe, monkeypatch, plain, epoch):
    """``epoch(state)`` from a fresh seeded state: (metrics, gradients by
    module, os_conv_fwd launches)."""
    state = pipe.init_state(torch.Generator().manual_seed(0))
    seen = {}
    apply = type(pipe)._apply_updates

    def record(self, opt, params, names, grads):
        for n in names:
            seen[n] = torch.cat([g.flatten() for g in grads[n] if g is not None])
        return apply(self, opt, params, names, grads)

    with monkeypatch.context() as m:
        m.setattr(type(pipe), "_apply_updates", record)
        if plain:
            m.setattr(osconv, "os_conv", osconv.os_conv_plain)
        osconv.reset_launch_counts()
        metrics = epoch(state)
        torch.cuda.synchronize()
    return metrics, seen, osconv.LAUNCHES["os_conv_fwd"]


def _check_baseline_step(kern, plain):
    (km, kg, k_launches), (pm, pg, p_launches) = kern, plain
    assert k_launches > 0 and p_launches == 0
    for k in km:
        _close(km[k], pm[k])
    assert set(kg) == set(pg)
    for n in kg:
        rel_l2 = ((kg[n] - pg[n]).norm() / pg[n].norm().clamp_min(1e-30)).item()
        assert rel_l2 <= GRAD_REL_TOL, (n, rel_l2)


@pytest.mark.gpu
def test_codats_step_on_card_matches_plain(card, monkeypatch):
    from feature_level_style_transfer_for_tsc_tpu_torch.baselines.codats import CoDATSPipeline

    shapes = [(2, 16, 2), (1, 12, 3), (3, 20, 4)]
    pipe = CoDATSPipeline(shapes[0], shapes[1:], config=PipelineConfig(**BASELINE_KW),
                          **BASELINE_DISC, device=card)
    g = torch.Generator().manual_seed(1)
    batches = [(torch.randn(1, 6, t, c, generator=g).numpy(),
                torch.randint(0, n, (1, 6), generator=g).numpy()) for c, t, n in shapes]

    def epoch(state):
        (xt, yt), *src = batches
        return pipe.train_epoch(state, xt, yt, [s[0] for s in src], [s[1] for s in src])

    kern = _baseline_step(pipe, monkeypatch, False, epoch)
    te, cl = len(pipe.ext_specs), len(pipe.cls_specs)
    assert kern[2] == 3 * (te + cl)  # the target and two sources: trunk + head each
    _check_baseline_step(kern, _baseline_step(pipe, monkeypatch, True, epoch))


@pytest.mark.gpu
def test_slarda_target_step_on_card_matches_plain(card, monkeypatch):
    from feature_level_style_transfer_for_tsc_tpu_torch.baselines.slarda import SLARDAPipeline

    t_shape, s_shape = (2, 16, 2), (1, 12, 3)
    pipe = SLARDAPipeline(t_shape, s_shape, config=PipelineConfig(**BASELINE_KW),
                          **BASELINE_DISC, device=card)
    g = torch.Generator().manual_seed(2)
    xt = torch.randn(1, 6, t_shape[1], t_shape[0], generator=g).numpy()
    yt = torch.randint(0, t_shape[2], (1, 6), generator=g).numpy()
    xs = torch.randn(1, 6, s_shape[1], s_shape[0], generator=g).numpy()

    def epoch(state):
        return pipe.target_epoch(pipe.transfer_weights(state), xt, yt, xs)

    kern = _baseline_step(pipe, monkeypatch, False, epoch)
    te, cl = len(pipe.ext_specs), len(pipe.cls_specs)
    assert kern[2] == 3 * te + cl  # frozen source, critic pre-pass, encoder; its head
    _check_baseline_step(kern, _baseline_step(pipe, monkeypatch, True, epoch))


# ------------------------------------------------ the archive sweep's shapes --

def _bucket_layer(i):
    """Spec of layer ``i`` of the (1, 89) bucket's model at reference budgets
    (extractor then classifier): FordA, Earthquakes, Computers and
    StarLightCurves train it, padded to 729 or 1094."""
    ext, cls = build_specs(1, 500, PipelineConfig())
    return (ext + cls)[i]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [729, 1094])
@pytest.mark.parametrize("layer", range(6))
def test_os_conv_and_its_core_at_bucket_lengths(card, monkeypatch, t, layer):
    """``os_conv_fwd`` and ``OSConvCore``'s dx and dw at the bucket lengths
    (not multiples of the 128-row tile), C_in = 1 in the first layer."""
    spec = _bucket_layer(layer)
    params = osconv.init_os_conv_params(torch.Generator().manual_seed(layer), spec, card)
    mask = torch.from_numpy(osconv.build_os_mask(spec)).to(card)
    x = torch.randn(20, t, spec[0][0], device=card, generator=torch.Generator(card).manual_seed(t))
    k = mask.shape[0]
    x_pad = torch.nn.functional.pad(x, (0, 0, (k - 1) // 2, k // 2))
    w = params["weight"] * mask
    osconv.reset_launch_counts()
    _close(osconv.os_conv(x_pad, w), osconv.os_conv_plain(x_pad, w))
    assert osconv.LAUNCHES["os_conv_fwd"] == 1
    grads = {}
    for plain in (False, True):
        with monkeypatch.context() as m:
            if plain:
                m.setattr(osconv, "os_conv", osconv.os_conv_plain)
            xd = x.clone().requires_grad_(True)
            wd = params["weight"].clone().requires_grad_(True)
            y = osconv.masked_os_conv(xd, wd, params["bias"], mask)
            grads[plain] = torch.autograd.grad(torch.sin(y).sum(), (xd, wd))
    _close(grads[False][0], grads[True][0])
    _close(grads[False][1], grads[True][1], GRAD_REL_TOL)


@pytest.mark.gpu
def test_padded_train_batch_on_card_matches_plain(card, monkeypatch):
    """One ``BucketedOSCNNClassifier.train_batch`` of the FordA bucket
    (T 500 padded to 729, 2 of 4 classes, reference budgets) with the OS
    conv kernel against the same step with its plain version on the card:
    the loss within REL_TOL, each module's gradients within GRAD_REL_TOL
    (relative L2), six launches.  The series are the port's synthetic ones
    (``make_arrays``, as ``chip_smoke.py`` phase 17's archive), not white
    noise: on white noise this untrained step's gradients move by about
    2e-3 when the conv's forward is multiplied by (1 + 1e-7 N(0, 1)), so no
    gate at 1e-3 could tell a kernel fault from rounding there; on these
    series by 4e-4 (``experiments/sweep_step_conditioning.py``)."""
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays
    from feature_level_style_transfer_for_tsc_tpu_torch.train.bucketed import (
        BucketedOSCNNClassifier,
        bucket_key,
    )

    clf = BucketedOSCNNClassifier(*bucket_key(1, 500, 2), config=PipelineConfig(), device=card)
    assert clf.t_bucket == 729
    xa, ya = make_arrays(20, 1, 500, 2, seed=40)  # the series of the experiment
    x = clf._pad_x(xa.transpose(0, 2, 1).copy())
    y = torch.tensor([int(v.split("_")[1]) for v in ya]).numpy()
    runs = {}
    for plain in (False, True):
        state = clf.init_state(torch.Generator().manual_seed(0))
        seen = {}

        def record(state, names, grads, apply=clf._apply_updates):
            for n in names:
                seen[n] = torch.cat([gr.flatten() for gr in grads[n] if gr is not None])
            return apply(state, names, grads)

        with monkeypatch.context() as m:
            m.setattr(clf, "_apply_updates", record)
            if plain:
                m.setattr(osconv, "os_conv", osconv.os_conv_plain)
            osconv.reset_launch_counts()
            ce = clf.train_batch(state, x, y, clf.t_valid(500), clf.cmask(2))
            torch.cuda.synchronize()
        runs[plain] = (ce, seen, osconv.LAUNCHES["os_conv_fwd"])
    (kc, kg, kl), (pc, pg, pl) = runs[False], runs[True]
    assert kl == len(clf.ext_specs) + len(clf.cls_specs) and pl == 0
    _close(kc, pc)
    for n in pg:
        rel_l2 = ((kg[n] - pg[n]).norm() / pg[n].norm().clamp_min(1e-30)).item()
        assert rel_l2 <= GRAD_REL_TOL, (n, rel_l2)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "runs, b, t, k, c_in, c_out",
    [
        (2, 3, 150, 89, 25, 225),
        (3, 2, 61, 3, 17, 33),
        (4, 1, 33, 2, 225, 50),
        (2, 20, 200, 89, 7, 25),  # one run's grid already wide: 128 x 64 tiles
    ],
)
@pytest.mark.parametrize("relu", [False, True])
def test_os_conv_runs_match_one_run_calls(card, runs, b, t, k, c_in, c_out, relu):
    """Each run of ``os_conv_runs`` / ``os_conv_fused_runs`` is the one-run
    kernel's bits (the run only offsets pointers; the tiles come from one
    run's batch), with one launch for all runs, and the runs' weights masked
    differently so each run has its own tap windows."""
    g = torch.Generator(device=card).manual_seed(runs * 100 + k)
    x_pad = torch.randn(runs, b, t + k - 1, c_in, device=card, generator=g)
    w = torch.randn(runs, k, c_in, c_out, device=card, generator=g) / (c_in * k) ** 0.5
    for r in range(runs):  # a different dead column group and tap span in each run
        w[r, :, :, 8 * r : 8 * r + 8] = 0.0
        if k > r + 1:
            w[r, : r + 1] = 0.0
    scale = torch.rand(runs, c_out, device=card, generator=g) + 0.5
    shift = torch.randn(runs, c_out, device=card, generator=g)
    before = dict(osconv.LAUNCHES)
    got = osconv.os_conv_runs(x_pad, w)
    fused = osconv.os_conv_fused_runs(x_pad, w, scale, shift, relu)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["os_conv_fwd_runs"] == before["os_conv_fwd_runs"] + 1
    assert osconv.LAUNCHES["os_conv_fused_fwd_runs"] == before["os_conv_fused_fwd_runs"] + 1
    assert got.shape == fused.shape == (runs, b, t, c_out)
    for r in range(runs):
        assert torch.equal(got[r], osconv.os_conv(x_pad[r], w[r]))
        assert torch.equal(fused[r], osconv.os_conv_fused(x_pad[r], w[r], scale[r], shift[r], relu))
        _close(got[r], osconv.os_conv_plain(x_pad[r], w[r]))
        _close(fused[r], osconv.os_conv_fused_plain(x_pad[r], w[r], scale[r], shift[r], relu))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "runs, b, t, h, c, n_layers",
    [
        (2, 3, 150, 25, 120, 8),
        (3, 2, 37, 5, 16, 8),  # T < 2^7
        (2, 4, 20, 3, 33, 3),  # C and H off the tiling; odd run strides
        (2, 3, 60, 168, 120, 8),  # VendCoffee's H
        (4, 8, 1152, 25, 120, 8),  # the pair pass's rows a run
    ],
)
def test_wn_runs_match_one_run_calls(card, runs, b, t, h, c, n_layers):
    """Each run of ``wn_fwd_runs`` and ``wn_bwd_runs`` is the one-run
    kernel's bits and within WN_REL_TOL of the plain versions; one launch
    for all runs.  The end projection's gradients are taken outside the
    kernel, as in the JAX package, by one batched product (cuBLAS sums in
    another order than for one run: within WN_REL_TOL, measured 3.1e-6 of
    max|g| at the pair rows on an H100)."""
    ops = [_wn_operands(card, b, t, h, c, n_layers, seed=r * 10 + t) for r in range(runs)]
    eff = [torch.stack(e).contiguous() for e in zip(*(o[1] for o in ops))]
    x2 = torch.stack([o[2].reshape(b * t, h) for o in ops]).contiguous()
    g2 = torch.randn(runs, b * t, 2 * h, device=card, generator=torch.Generator(card).manual_seed(7))
    before = dict(wn_fused.LAUNCHES)
    y, aud, skip = wn_fused.wn_fwd_runs(x2, *eff, t)
    bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
    grads = wn_fused.wn_bwd_runs(*bwd_args)
    torch.cuda.synchronize()
    assert wn_fused.LAUNCHES["wn_fwd_runs"] == before["wn_fwd_runs"] + 1
    assert wn_fused.LAUNCHES["wn_bwd_runs"] == before["wn_bwd_runs"] + 1
    for r in range(runs):
        one = [e[r] for e in eff]
        for got, want, plain in zip((y[r], aud[r], skip[r]), wn_fused.wn_fwd(x2[r], *one, t),
                                    wn_fused.wn_fwd_plain(x2[r], *one, t)):
            assert torch.equal(got, want)
            _close(got, plain, WN_REL_TOL)
        args = tuple(a[r] for a in bwd_args[:-1]) + (t,)
        outs = zip(grads, wn_fused.wn_bwd(*args), wn_fused.wn_bwd_plain(*args))
        for i, (got, want, plain) in enumerate(outs):
            if i < len(grads) - 2:  # the kernel's outputs
                assert torch.equal(got[r], want)
            else:  # the end projection's, one batched product outside the kernel
                _close(got[r], want, WN_REL_TOL)
            _close(got[r], plain, WN_REL_TOL)


@pytest.mark.gpu
def test_vmapped_cores_launch_the_run_kernels_once(card):
    """Under ``torch.func.vmap`` over 3 runs, ``OSConvCore`` and ``WNCore``
    launch their run-axis kernels once (forward and backward) and none of
    the one-run kernels; values and gradients, taken outside the transform,
    match per-run calls (the conv's backward a grouped transposed conv)."""
    runs, b, t, k, c_in, c_out = 3, 2, 40, 5, 6, 24
    g = torch.Generator(device=card).manual_seed(5)
    x_pad = torch.randn(runs, b, t + k - 1, c_in, device=card, generator=g)
    w = (torch.randn(runs, k, c_in, c_out, device=card, generator=g) / 6).requires_grad_(True)
    ops = [_wn_operands(card, b, t, 4, 16, 3, seed=r) for r in range(runs)]
    eff = [torch.stack(e).contiguous().requires_grad_(True) for e in zip(*(o[1] for o in ops))]
    xw = torch.stack([o[2] for o in ops]).requires_grad_(True)
    osconv.reset_launch_counts()
    wn_fused.reset_launch_counts()
    y = torch.func.vmap(osconv.OSConvCore.apply)(x_pad, w)
    z = torch.func.vmap(lambda x, *e: wn_fused.WNCore.apply(x, *e, False)[0])(xw, *eff)
    grads = torch.autograd.grad(torch.sin(y).sum() + torch.sin(z).sum(), [w, xw] + eff)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES == {**osconv.LAUNCHES, "os_conv_fwd": 0, "os_conv_fwd_runs": 1}
    assert wn_fused.LAUNCHES == {**dict.fromkeys(wn_fused.LAUNCHES, 0), "wn_fwd_runs": 1,
                                 "wn_bwd_runs": 1}
    for r in range(runs):
        wr = w[r].detach().requires_grad_(True)
        er = [e[r].detach().requires_grad_(True) for e in eff]
        xr = xw[r].detach().requires_grad_(True)
        yr = osconv.OSConvCore.apply(x_pad[r], wr)
        zr = wn_fused.WNCore.apply(xr, *er, False)[0]
        want = torch.autograd.grad(torch.sin(yr).sum() + torch.sin(zr).sum(), [wr, xr] + er)
        assert torch.equal(y[r], yr) and torch.equal(z[r], zr)
        for got, ref in zip(grads, want):
            _close(got[r], ref, GRAD_REL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("runs", [False, True])
def test_wn_backward_under_a_cotangent_batch(card, bf16, runs):
    """``WNCore`` (one run) and ``WNRunCore`` (K = 2 runs) pulled under 3
    cotangents at once (``batched_pull``, as ``stacked_pullbacks`` pulls):
    ONE ``wn_bwd_runs`` launch of 3 (3K) runs and no one-run launch; each
    cotangent's input and weight gradients the bits of the one-cotangent
    ``wn_bwd`` on the same operands (the end projection's two, one batched
    product outside the kernel, within WN_REL_TOL), f32 and bf16."""
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import batched_pull

    b, t, h, c, n_layers, k = 3, 150, 25, 120, 8, 2
    ops = [_wn_operands(card, b, t, h, c, n_layers, seed=30 + r) for r in range(k if runs else 1)]
    if runs:
        eff = [torch.stack(e).contiguous().requires_grad_(True) for e in zip(*(o[1] for o in ops))]
        x = torch.stack([o[2] for o in ops]).requires_grad_(True)
        y = torch.func.vmap(lambda xx, *ee: wn_fused.WNCore.apply(xx, *ee, bf16)[0])(x, *eff)
    else:
        eff = [e.requires_grad_(True) for e in ops[0][1]]
        x = ops[0][2].requires_grad_(True)
        y = wn_fused.WNCore.apply(x, *eff, bf16)[0]
    cot = torch.randn(3, *y.shape, device=card, generator=torch.Generator(card).manual_seed(9))
    seen = []
    launch = wn_fused.wn_bwd_runs

    def record(*args):
        seen.append([a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args])
        return launch(*args)

    wn_fused.reset_launch_counts()
    try:
        wn_fused.wn_bwd_runs = record
        batched_pull([y], [x, *eff], [cot])
    finally:
        wn_fused.wn_bwd_runs = launch
    torch.cuda.synchronize()
    tag = "[bf16]" if bf16 else ""
    assert wn_fused.LAUNCHES == {**dict.fromkeys(wn_fused.LAUNCHES, 0), "wn_bwd_runs" + tag: 1}
    (args,) = seen
    tensors, (t_len, flag) = args[:-2], args[-2:]
    assert tensors[0].shape[0] == 3 * (k if runs else 1) and flag == bf16
    got = wn_fused.wn_bwd_runs(*tensors, t_len, flag)
    for r in range(tensors[0].shape[0]):
        want = wn_fused.wn_bwd(*(a[r] for a in tensors), t_len, flag)
        for i, (a, w) in enumerate(zip(got, want)):
            if i < len(want) - 2:
                assert torch.equal(a[r], w), (r, i)
            else:
                _close(a[r], w, WN_REL_TOL)


@pytest.mark.gpu
def test_tap_conv_dx_under_a_cotangent_batch(card):
    """``TapConvCore``'s input gradient under 3 cotangents: ONE
    ``tap_conv_fwd`` launch with the cotangents folded into the batch rows,
    each cotangent's dx the bits of the one-cotangent pull's."""
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import batched_pull

    g = torch.Generator(device=card).manual_seed(4)
    x_pad = torch.randn(5, 300, 120, device=card, generator=g).requires_grad_(True)
    w = (torch.randn(3, 120, 240, device=card, generator=g) / 20).requires_grad_(True)
    y = osconv.tap_conv(x_pad, w, 4)
    cot = torch.randn(3, *y.shape, device=card, generator=g)
    osconv.reset_launch_counts()
    got = batched_pull([y], [x_pad], [cot])[0]
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["tap_conv_fwd"] == 1
    for i in range(3):
        (want,) = torch.autograd.grad(y, [x_pad], cot[i], retain_graph=True)
        assert torch.equal(got[i], want), i


@pytest.mark.gpu
@pytest.mark.parametrize("runs, b, t_out, c_in, c_out, d", [
    (3, 2, 150, 120, 240, 1),
    (2, 3, 37, 240, 120, 128),
    (4, 1, 5, 7, 9, 2),
])
def test_tap_conv_runs_match_one_run_calls(card, runs, b, t_out, c_in, c_out, d):
    """``tap_conv_fwd_runs`` (one launch set for K runs): each run the bits
    of the one-run ``tap_conv_fwd`` call, within REL_TOL of the plain
    version."""
    g = torch.Generator(device=card).manual_seed(runs * 10 + d)
    x_pad = torch.randn(runs, b, t_out + 2 * d, c_in, device=card, generator=g)
    w = torch.randn(runs, 3, c_in, c_out, device=card, generator=g) / (3 * c_in) ** 0.5
    osconv.reset_launch_counts()
    got = osconv.tap_conv_fwd_runs(x_pad, w, d)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["tap_conv_fwd_runs"] == 1
    for r in range(runs):
        assert torch.equal(got[r], osconv.tap_conv_fwd(x_pad[r], w[r], d)), r
        _close(got[r], osconv.tap_conv_plain(x_pad[r], w[r], d))


@pytest.mark.gpu
def test_tap_conv_runs_split_at_the_grid_limit(card, monkeypatch):
    """A run-axis call whose K * B passes the grid's z limit (``GRID_Z``,
    lowered here to 7) is split on the host into ``run_chunks`` calls,
    each run still the one-run call's bits."""
    monkeypatch.setattr(osconv, "GRID_Z", 7)
    g = torch.Generator(device=card).manual_seed(3)
    x_pad = torch.randn(5, 3, 40, 16, device=card, generator=g)
    w = torch.randn(5, 3, 16, 24, device=card, generator=g) / 7
    osconv.reset_launch_counts()
    got = osconv.tap_conv_fwd_runs(x_pad, w, 4)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["tap_conv_fwd_runs"] == len(osconv.run_chunks(5, 3)) == 3
    for r in range(5):
        assert torch.equal(got[r], osconv.tap_conv_fwd(x_pad[r], w[r], 4)), r


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_os_conv_runs_split_at_the_grid_limit(card, monkeypatch, fused):
    """A run-axis OS conv whose K * B passes the grid's z limit (``GRID_Z``,
    lowered here to 7) is split on the host into ``run_chunks`` launches,
    each run still the one-run call's bits."""
    monkeypatch.setattr(osconv, "GRID_Z", 7)
    g = torch.Generator(device=card).manual_seed(4)
    x_pad = torch.randn(5, 3, 40, 16, device=card, generator=g)
    w = torch.randn(5, 5, 16, 24, device=card, generator=g) / 9
    scale = torch.rand(5, 24, device=card, generator=g) + 0.5
    shift = torch.randn(5, 24, device=card, generator=g)
    osconv.reset_launch_counts()
    if fused:
        got = osconv.os_conv_fused_runs(x_pad, w, scale, shift, True)
        want = [osconv.os_conv_fused(x_pad[r], w[r], scale[r], shift[r], True) for r in range(5)]
    else:
        got = osconv.os_conv_runs(x_pad, w)
        want = [osconv.os_conv(x_pad[r], w[r]) for r in range(5)]
    torch.cuda.synchronize()
    name = "os_conv_fused_fwd_runs" if fused else "os_conv_fwd_runs"
    assert osconv.LAUNCHES[name] == len(osconv.run_chunks(5, 3)) == 3
    for r in range(5):
        assert torch.equal(got[r], want[r]), r


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", ["0", "1"])
def test_ensemble_members_under_vmap_on_card(card, monkeypatch, fuse):
    """``MultiSourceEnsemble.member_logits`` on the card: the members under
    one ``torch.func.vmap``, one run-axis launch a layer, each member's
    logits the bits of its own ``predict_logits`` call."""
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
        MultiSourceEnsemble,
    )

    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", fuse)
    ens = MultiSourceEnsemble(3, 150, 4, config=PipelineConfig(budget_multiplier=0.2),
                              device=card)
    model = ens.model_def
    members = [model.init_models(torch.Generator().manual_seed(s)) for s in (1, 2, 3)]
    for m in members:  # BatchNorm statistics off their initial values
        for s in list(m["mstate"]["ext"]["block"]["layers"]) + list(
                m["mstate"]["cls"]["block"]["layers"]):
            s["bn"] = type(s["bn"])(torch.randn_like(s["bn"].mean) * 0.1,
                                    torch.rand_like(s["bn"].var) + 0.5)
    x = torch.randn(7, 150, 3, generator=torch.Generator().manual_seed(0))
    layers = len(model.ext_masks) + len(model.cls_masks)
    osconv.reset_launch_counts()
    got = ens.member_logits(ens.stack(members), x)
    torch.cuda.synchronize()
    runs = "os_conv_fused_fwd_runs" if fuse == "1" else "os_conv_fwd_runs"
    assert {n: v for n, v in osconv.LAUNCHES.items() if v} == {runs: layers}
    want = torch.stack([model.predict_logits(m["params"], m["mstate"], x) for m in members])
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_op_by_op_vmap_rules_launch_the_runs_forms(card):
    """Under ``torch.func.vmap`` over K = 3 runs, ``TapConvCore`` is one
    ``tap_conv_fwd_runs`` launch and ``GateCore`` one ``gate_fwd`` launch
    over the runs' rows (``gate_fwd_runs``), b a column slice of a stacked
    projection: both the per-run bits; a batched pull of 2 cotangents
    through the runs' tap conv is one more ``tap_conv_fwd_runs`` launch,
    each cotangent's dx the bits of its single pull."""
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import batched_pull

    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(3, 2, 64, 24, device=card, generator=g).requires_grad_(True)
    w = (torch.randn(3, 3, 24, 48, device=card, generator=g) / 8).requires_grad_(True)
    proj = torch.randn(3, 2, 60, 96, device=card, generator=g)
    osconv.reset_launch_counts()
    gate.reset_launch_counts()
    y = torch.func.vmap(lambda a, b: osconv.tap_conv(a, b, 2))(x, w)
    z = torch.func.vmap(lambda a, b: gate.fused_add_tanh_sigmoid_multiply(a, b[..., 48:96], 24))(
        y.detach(), proj)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["tap_conv_fwd_runs"] == 1 and osconv.LAUNCHES["tap_conv_fwd"] == 0
    assert gate.LAUNCHES["gate_fwd_runs"] == 1 and gate.LAUNCHES["gate_fwd"] == 0
    for r in range(3):
        assert torch.equal(y[r], osconv.tap_conv_fwd(x[r].detach(), w[r].detach(), 2)), r
        assert torch.equal(z[r], gate.gate_fwd(y[r].detach(), proj[r, ..., 48:96], 24)), r
    cot = torch.randn(2, *y.shape, device=card, generator=g)
    osconv.reset_launch_counts()
    got = batched_pull([y], [x], [cot])[0]
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["tap_conv_fwd_runs"] == 1
    for i in range(2):
        (want,) = torch.autograd.grad(y, [x], cot[i], retain_graph=True)
        assert torch.equal(got[i], want), i


# ------------------------------------------------- the bf16 instances -----
#
# ``os_conv_fwd[bf16]`` (PipelineConfig.compute_dtype="bfloat16") and the WN
# kernels' bf16 instances (FLSTTSC_WN_MXU=bf16) against their plain bf16
# versions: the products are exact on both sides and only the f32 sums run in
# another order, but a sum within rounding of a bf16 boundary (the conv's
# output; the WN's intermediates, rounded again as the next product's
# operand) rounds to the neighbouring bf16 value, 2^-8 apart relatively.  So
# they are held by relative L2 distance, BF16_REL_L2, as chip_smoke.py holds
# them, where no such flip feeds a later rounding: the conv, each WN layer
# from the kernel's own input to it (``wn_fwd_plain_layers``), the WN
# backward's top layer.  Through the WN's layers one flip moves the next
# layer's sums and flips more, up to the bf16 noise floor (the plain bf16 WN
# with float64 sums sits up to 0.32 of the switch's own effect from itself
# with f32 sums: chip_smoke.py phase 19's ``control_rel_l2``), so a
# free-running WN output passes within BF16_CASCADE of that effect (plain
# bf16 against plain f32).  With one live layer a flip carries through a few
# roundings only: there every output passes within BF16_FLIPS times that
# control on the same inputs (the kernels' tensor-core sums flip more than
# torch's f32 sums: up to 3.7 times the control at 600 rows on an H100).
# Each run of a run-axis call gives the one-run call's bits.

BF16_REL_L2 = 1e-4
BF16_CASCADE = 0.5
BF16_FLIPS = 6.0
# The top layer's bias gradients (gbc, gbi, gbr): f32 sums of f32 values in another order than
# the plain version's (the kernel's tile sums), held within BF16_BIAS_REL_L2 of the plain
# version.  One bf16 rounding stands before them: g_skip's, as the g_acts product's operand.  The
# kernel sums g_skip term by term, cuBLAS may sum it for the plain version in another f32 order,
# and a sum within rounding of a bf16 boundary then rounds to the neighbouring value: a flip,
# which over few rows moves them past the bar.  BF16_BIAS_BEFORE holds, for such a case, what the
# kernel this one replaced (the 3xTF32 kernel's bf16 instance, the same g_skip order) read there
# on an H100 (experiments/wn_time.py --bias-gaps, in turns with this kernel, one call); the bar
# there is that reading plus BF16_BIAS_REL_L2.  With g_skip summed in the kernel's order
# (``_plain_with_kernel_gskip``) every case is held within BF16_BIAS_REL_L2.
BF16_BIAS_REL_L2 = 1e-5
BF16_BIAS_BEFORE = {(3, 150, 25, 120, 8): 1.7375e-5}  # this kernel 1.7417e-5 there


def _launches_by_kernel(fn, calls: int = 2) -> dict:
    """``__global__`` launches a call of ``fn`` by kernel name (without
    template arguments), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            key = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = key.split("(", 1)[0].split("::")[-1].split("<", 1)[0]
            out[name] = out.get(name, 0) + e.count / calls
    return out


def _plain_with_kernel_gskip(bwd_args):
    """``wn_bwd_plain(..., bf16=True)`` with g_skip (g2 @ w_end^T on bf16
    operands) summed term by term in f32, in order from the first: the
    kernel's FMA order, bit for bit (a product of two bf16 values is exact,
    so a fused and a separate multiply-add agree)."""
    g2 = bwd_args[1]
    saved = wn_fused._mm

    def mm(a, b, bf16):
        if a is not g2:
            return saved(a, b, bf16)
        a, b = a.bfloat16().float(), b.bfloat16().float()
        out = torch.zeros(a.shape[0], b.shape[1], device=a.device)
        for k in range(a.shape[1]):
            out = out + a[:, k:k + 1] * b[k]
        return out

    wn_fused._mm = mm
    try:
        return wn_fused.wn_bwd_plain(*bwd_args, True)
    finally:
        wn_fused._mm = saved


#: Profiler windows a launch count may take: on an H100 a window has lost a
#: contiguous run of its device events, or all of them, a few times in a
#: hundred windows (``chip_smoke.PROFILE_ATTEMPTS``); one window that kept
#: every launch is still required.
PROFILE_WINDOWS = 3


def _check_global_launches(fn, n_layers: int, entry: str, bf16: bool) -> None:
    """The launches a call of each of ``entry``'s kernels as
    ``wn_fused.global_kernels`` states them, adding up to ``global_launches``
    (a profiler window that lost events is taken again, PROFILE_WINDOWS)."""
    want = wn_fused.global_kernels(n_layers, bf16)[entry]
    for _ in range(PROFILE_WINDOWS):
        got = _launches_by_kernel(fn)
        if {k: got.get(k, 0) for k in want} == want:
            break
    assert {k: got.get(k, 0) for k in want} == want
    assert sum(want.values()) == wn_fused.global_launches(n_layers, bf16)[entry]


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _bf16_weights(card, g, k, c_in, c_out, weights):
    """bf16 test weights (K, C_in, C_out): dense, or the serving layer of
    that shape's masked weights, as they are or with column group 1 dead."""
    w32 = torch.randn(k, c_in, c_out, device=card, generator=g) / (c_in * k) ** 0.5
    if weights != "dense":
        spec = next(s for s in map(_serving_layer, range(4))
                    if (s[-1][-1], s[0][0], total_out_channels(s)) == (k, c_in, c_out))
        w32 = w32 * torch.from_numpy(osconv.build_os_mask(spec)).to(card)
    if weights == "dead group":
        w32[:, :, 8:16] = 0.0
    return w32


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t, k, c_in, c_out, weights",
    [
        (3, 150, 89, 25, 225, "dense"),
        (2, 1152, 89, 7, 25, "dense"),  # the serving model's first layer: C_in 7, one chunk a tap
        (2, 33, 2, 225, 50, "dense"),
        (1, 5, 1, 5, 7, "dense"),
        (2, 61, 3, 16, 33, "dense"),  # C_in a multiple of 8: rows on 16-byte granules
        (4, 100, 5, 3, 130, "dense"),
        # the serving layers' masked weights at T off every time tile: C_in 7, 25, 225
        # and 50 (one, four, 29 and seven chunks a tap; 225 in four channel windows)
        (2, 300, 89, 7, 25, "mask"),
        (2, 300, 89, 25, 225, "mask"),
        (2, 300, 2, 225, 50, "mask"),
        (2, 300, 89, 50, 25, "mask"),
        (2, 300, 89, 25, 225, "dead group"),  # an empty window: those columns 0
        (2, 150, 89, 7, 25, "dead group"),
        (2, 100, 89, 200, 130, "dense"),  # windows narrowed to 32 channels: seven a block
        (1, 50, 600, 64, 40, "dense"),  # a kernel longer than one window of taps
    ],
)
def test_os_conv_bf16_matches_plain(card, b, t, k, c_in, c_out, weights):
    """``os_conv`` on bf16 operands launches the bf16 kernel (counted as
    ``os_conv_fwd[bf16]``, not ``os_conv_fwd``), gives bf16, the same bits
    twice, within BF16_REL_L2 of ``os_conv_plain`` in bf16, and differs from
    the f32 kernel on the f32 operands while tracking it within 2e-2."""
    g = torch.Generator(device=card).manual_seed(k * 1000 + c_out)
    x32 = torch.randn(b, t + k - 1, c_in, device=card, generator=g)
    w32 = _bf16_weights(card, g, k, c_in, c_out, weights)
    x_pad, w = x32.bfloat16(), w32.bfloat16()
    before = dict(osconv.LAUNCHES)
    got = osconv.os_conv(x_pad, w)
    twice = osconv.os_conv(x_pad, w)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["os_conv_fwd[bf16]"] == before["os_conv_fwd[bf16]"] + 2
    assert osconv.LAUNCHES["os_conv_fwd"] == before["os_conv_fwd"]
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, c_out)
    assert torch.equal(got, twice)
    assert _rel_l2(got, osconv.os_conv_plain(x_pad, w)) <= BF16_REL_L2
    if weights == "dead group":
        assert not got[:, :, 8:16].any()
    f32 = osconv.os_conv(x32, w32)
    assert not torch.equal(got.float(), f32)
    assert _rel_l2(got, f32) <= 2e-2


@pytest.mark.gpu
def test_os_conv_core_bf16_gradients_on_card(card):
    """``OSConvCore`` on bf16: the bf16 kernel forward and the transposed
    convs on bf16 tensors (cuDNN), against autograd of the plain version in
    bf16; ``os_conv_fused`` refuses bf16."""
    g = torch.Generator(device=card).manual_seed(3)
    x_pad = torch.randn(2, 120 + 8, 7, device=card, generator=g).bfloat16()
    w = (torch.randn(9, 7, 40, device=card, generator=g) / 8).bfloat16()
    gy = torch.randn(2, 120, 40, device=card, generator=g).bfloat16()
    grads = []
    for fn in (osconv.OSConvCore.apply, osconv.os_conv_plain):
        xg, wg = x_pad.clone().requires_grad_(True), w.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xg, wg), (xg, wg), gy))
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        assert _rel_l2(got, want) <= GRAD_REL_TOL
    with pytest.raises(TypeError, match="float32"):
        osconv.os_conv_fused(x_pad, w, torch.ones(40, device=card), torch.zeros(40, device=card),
                             False)


#: (B, T, H, C, layers) of test_wn_bf16_kernels_match_plain
WN_BF16_CASES = [
    (3, 150, 25, 120, 8),  # 450 rows: a ragged last tile
    (2, 37, 5, 16, 8),  # T < 2^7
    (4, 20, 3, 33, 3),  # C and H off the thread tiling
    (3, 60, 168, 120, 8),  # VendCoffee's H: H and 2H past one chunk
    (1, 65, 25, 120, 8),  # 32-row slices: a last slice of one row
    (8, 1152, 25, 120, 8),  # 144 tiles of 64 rows: wn_fwd's widest tile
    (1, 63, 25, 120, 8),  # one row short of a 64-row tile and slice
    (2, 37, 25, 12, 7),  # C % 8 != 0 (g_z's halves padded to 16), T % 8 != 0, d = 64 past T
    (40, 60, 168, 120, 8),  # VendCoffee's pair pass: 38 bf16 slices of 64 rows
]


def _wn_bf16_case(card, b, t, h, c, n_layers):
    """A case's operands: (effective weights, x2, the plain bf16 forward,
    ``wn_bwd``'s arguments)."""
    _, eff, x = _wn_operands(card, b, t, h, c, n_layers, seed=b * 100 + t)
    x2 = x.reshape(b * t, h).contiguous()
    want = wn_fused.wn_fwd_plain(x2, *eff, t, True)
    g2 = torch.randn(b * t, 2 * h, device=card, generator=torch.Generator(card).manual_seed(7))
    _, aud, skip = want
    return eff, x2, want, (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6],
                           eff[8], t)


def _top_bias_gaps(grads, ref, c: int, n_layers: int) -> dict:
    """Relative L2 of the top layer's bias gradients, gbc (its slice), gbi
    and gbr, of ``wn_bwd`` outputs against ``ref``."""
    top = slice(2 * c * (n_layers - 1), None)
    return {name: _rel_l2(grads[i][sl], ref[i][sl])
            for name, i, sl in (("gbc", 4, top), ("gbi", 6, -1), ("gbr", 8, -1))}


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, h, c, n_layers", WN_BF16_CASES)
def test_wn_bf16_kernels_match_plain(card, b, t, h, c, n_layers):
    """``wn_fwd`` / ``wn_bwd`` with ``bf16=True`` (counted as
    ``wn_fwd[bf16]`` / ``wn_bwd[bf16]``) against the plain versions with
    ``bf16=True``: layer by layer, the backward's top layer and the end
    projection within BF16_REL_L2, the top layer's bias gradients within
    BF16_BIAS_REL_L2 (or BF16_BIAS_BEFORE) of the plain version and within
    BF16_BIAS_REL_L2 of it with the kernel's g_skip order
    (``_plain_with_kernel_gskip``); every output within BF16_CASCADE of the
    switch's own effect; the same bits twice; y differs from the f32 kernel's and tracks
    it within 2e-2; the launches of each ``__global__`` kernel as
    ``wn_fused.global_kernels`` states them."""
    eff, x2, want, bwd_args = _wn_bf16_case(card, b, t, h, c, n_layers)
    before = dict(wn_fused.LAUNCHES)
    got = wn_fused.wn_fwd(x2, *eff, t, True)
    twice = wn_fused.wn_fwd(x2, *eff, t, True)
    y32 = wn_fused.wn_fwd(x2, *eff, t)[0]
    assert not torch.equal(got[0], y32) and _rel_l2(got[0], y32) <= 2e-2
    forced = wn_fused.wn_fwd_plain_layers(x2, got[1], got[2], *eff, t, True)
    for gv, fv in zip((got[1], got[2], got[0]), forced):
        assert _rel_l2(gv, fv) <= BF16_REL_L2
    grads = wn_fused.wn_bwd(*bwd_args, True)
    again = wn_fused.wn_bwd(*bwd_args, True)
    plain = wn_fused.wn_bwd_plain(*bwd_args, True)
    torch.cuda.synchronize()
    assert wn_fused.LAUNCHES["wn_fwd[bf16]"] == before["wn_fwd[bf16]"] + 2
    assert wn_fused.LAUNCHES["wn_bwd[bf16]"] == before["wn_bwd[bf16]"] + 2
    assert wn_fused.LAUNCHES["wn_fwd"] == before["wn_fwd"] + 1
    assert wn_fused.LAUNCHES["wn_bwd"] == before["wn_bwd"]
    top = slice(2 * c * (n_layers - 1), None)
    for i, sl in ((3, (slice(None), top)), (4, top), (5, -1), (6, -1), (7, -1), (8, -1), (9, ...),
                  (10, ...)):  # gwc, gbc, gwi, gbi, gwr, gbr of the top layer; gwe, gbe
        assert _rel_l2(grads[i][sl], plain[i][sl]) <= BF16_REL_L2, i
    bar = BF16_BIAS_BEFORE.get((b, t, h, c, n_layers), 0.0) + BF16_BIAS_REL_L2
    for name, gap in _top_bias_gaps(grads, plain, c, n_layers).items():
        assert gap <= bar, (name, gap, bar)
    for name, gap in _top_bias_gaps(grads, _plain_with_kernel_gskip(bwd_args), c,
                                    n_layers).items():
        assert gap <= BF16_BIAS_REL_L2, (name, gap)
    _check_global_launches(lambda: wn_fused.wn_fwd(x2, *eff, t, True), n_layers, "wn_fwd", True)
    _check_global_launches(lambda: wn_fused.wn_bwd(*bwd_args, True), n_layers, "wn_bwd", True)
    for outs, ref, rep, f32 in ((got, want, twice, wn_fused.wn_fwd_plain(x2, *eff, t)),
                                (grads, plain, again, wn_fused.wn_bwd_plain(*bwd_args))):
        for i, (gv, wv, av, fv) in enumerate(zip(outs, ref, rep, f32)):
            assert gv.shape == wv.shape and torch.equal(gv, av)
            bar = max(BF16_REL_L2, BF16_CASCADE * _rel_l2(wv, fv))
            assert _rel_l2(gv, wv) <= bar, (i, _rel_l2(gv, wv), bar)


#: (B, T, H, C, layers, rows a tile on an H100's 132 SMs) of
#: test_wn_bf16_fwd_row_tiles_match_plain: each tile size of the forward's
#: short-series rule with a ragged last tile
WN_BF16_TILE_CASES = [
    (5, 900, 25, 120, 8, 64),  # 4,500 rows: 64-row tiles, the last 20 rows
    (5, 900, 9, 33, 4, 64),  # the same rows at C 33 (padded to 40) and H 9
    (3, 1000, 25, 120, 8, 32),  # 3,000 rows: 32-row tiles, the last 24
    (2, 37, 25, 12, 7, 16),  # 74 rows: 16-row tiles, the last 10; T < 2^6
]


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, h, c, n_layers, tile", WN_BF16_TILE_CASES)
def test_wn_bf16_fwd_row_tiles_match_plain(card, b, t, h, c, n_layers, tile):
    """``wn_fwd`` with ``bf16=True`` at each row-tile size of its
    short-series rule (``fwd_row_tile``; the tile these rows take on an
    H100), each with a ragged last tile: layer by layer within BF16_REL_L2 of
    ``wn_fwd_plain_layers``, free-running within BF16_CASCADE of the switch's
    own effect, the same bits twice, the launches by ``__global__`` kernel."""
    if torch.cuda.get_device_properties(card).multi_processor_count == 132:
        assert wn_fused.fwd_row_tile(b * t, 132) == tile
    _, eff, x = _wn_operands(card, b, t, h, c, n_layers, seed=b * 100 + t)
    x2 = x.reshape(b * t, h).contiguous()
    got = wn_fused.wn_fwd(x2, *eff, t, True)
    twice = wn_fused.wn_fwd(x2, *eff, t, True)
    want = wn_fused.wn_fwd_plain(x2, *eff, t, True)
    f32 = wn_fused.wn_fwd_plain(x2, *eff, t)
    forced = wn_fused.wn_fwd_plain_layers(x2, got[1], got[2], *eff, t, True)
    for gv, fv in zip((got[1], got[2], got[0]), forced):
        assert _rel_l2(gv, fv) <= BF16_REL_L2
    for i, (gv, av, wv, fv) in enumerate(zip(got, twice, want, f32)):
        assert torch.equal(gv, av) and bool(torch.isfinite(gv).all())
        bar = max(BF16_REL_L2, BF16_CASCADE * _rel_l2(wv, fv))
        assert _rel_l2(gv, wv) <= bar, (i, _rel_l2(gv, wv), bar)
    _check_global_launches(lambda: wn_fused.wn_fwd(x2, *eff, t, True), n_layers, "wn_fwd", True)


def _one_flip_rel_l2(skip, w_end, y):
    """How far one bf16 flip of the end product's operand moves y at most,
    relative L2: one bf16 step of ``skip[r, j]`` (the spacing at its value)
    times row j of ``w_end`` in bf16, at the (r, j) where that is largest,
    over |y|.  A flip is the least two f32 orders of the skip sum can give
    where it lies within rounding of a bf16 boundary."""
    s = skip.bfloat16().float()
    _, exp = torch.frexp(s)
    step = torch.where(s != 0, torch.ldexp(torch.ones_like(s), exp - 8), 0.0).max(dim=0).values
    reach = step * w_end.bfloat16().float().norm(dim=1)
    return (reach.max().double() / y.double().norm().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t, h, c, n_layers, live, ragged",
    [(2, 1152, 25, 120, 8, live, False) for live in range(8)]  # the serving widths
    + [  # ragged shapes (the bf16 kernels' padding, tiles and slices)
        (2, 37, 25, 12, 7, 6, True),  # C % 8 != 0, T % 8 != 0, the live layer's taps past T
        (3, 60, 168, 120, 8, 2, True),  # VendCoffee's H
        (1, 65, 25, 120, 8, 3, True),  # a last tile and slice of one row
        (1, 63, 25, 120, 8, 5, True),  # one row short of a tile
        (5, 900, 25, 120, 8, 4, True),  # the forward's 64-row tiles, a last tile of 20 rows
    ],
)
def test_wn_bf16_each_layer_alone(card, monkeypatch, b, t, h, c, n_layers, live, ragged):
    """Every layer's in-projection zero but layer ``live``'s (dilation
    2^live): no layer's input gradient then carries another's rounding down,
    so every output of ``wn_fwd`` / ``wn_bwd`` with ``bf16=True``, the lower
    layers' included, is held within BF16_REL_L2 or BF16_FLIPS times the
    control (the plain version with float64 sums) of the plain version, at
    the serving widths (H 25, C 120, 8 layers, the training length) and at
    ragged ones.  At a ragged shape's few rows one flip alone can pass
    BF16_REL_L2 where the control happens to flip nothing (at 63 rows with
    layer 5 live the forward's y read 1.02e-4 on an H100), so there y is also
    allowed one flip of the end product's operand (``_one_flip_rel_l2``)."""
    _, eff, x = _wn_operands(card, b, t, h, c, n_layers, seed=live)
    w_in = torch.zeros_like(eff[4])
    w_in[live] = eff[4][live]
    eff[4] = w_in
    x2 = x.reshape(b * t, h).contiguous()
    g2 = torch.randn(b * t, 2 * h, device=card, generator=torch.Generator(card).manual_seed(live))
    _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t, True)
    bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
    got = wn_fused.wn_fwd(x2, *eff, t, True) + wn_fused.wn_bwd(*bwd_args, True)
    want = wn_fused.wn_fwd_plain(x2, *eff, t, True) + wn_fused.wn_bwd_plain(*bwd_args, True)
    flip = _one_flip_rel_l2(want[2], eff[8], want[0]) if ragged else 0.0
    monkeypatch.setattr(wn_fused, "_mm", lambda a, w, bf16: (
        a.bfloat16().double() @ w.bfloat16().double()).float())
    exact = wn_fused.wn_fwd_plain(x2, *eff, t, True) + wn_fused.wn_bwd_plain(*bwd_args, True)
    for i, (gv, wv, ev) in enumerate(zip(got, want, exact)):
        bar = max(BF16_REL_L2, BF16_FLIPS * _rel_l2(ev, wv), flip if i == 0 else 0.0)
        assert _rel_l2(gv, wv) <= bar, (i, _rel_l2(gv, wv), bar)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t, h, c, n_layers",
    [
        (3, 150, 25, 120, 8),
        (2, 37, 25, 12, 7),  # C % 8 != 0, T < 2^i
        (3, 60, 168, 120, 8),  # VendCoffee's H
        (1, 65, 25, 120, 8),
        (1, 63, 25, 120, 8),
    ],
)
def test_wn_bf16_bwd_runs_match_one_run_calls(card, b, t, h, c, n_layers):
    """``wn_bwd_runs`` with ``bf16=True`` over R = 3 runs, each its own
    weights and inputs: every run the one-run call's bits (the kernel's
    outputs; the end projection's gradients, one batched product outside,
    within BF16_REL_L2); the scratch the wrapper asks the library for is the
    Python mirror's (``bwd_wsplit_words``)."""
    runs = 3
    ops = [_wn_operands(card, b, t, h, c, n_layers, seed=r * 7 + t) for r in range(runs)]
    eff = [torch.stack(e).contiguous() for e in zip(*(o[1] for o in ops))]
    x2 = torch.stack([o[2].reshape(b * t, h) for o in ops]).contiguous()
    g2 = torch.randn(runs, b * t, 2 * h, device=card, generator=torch.Generator(card).manual_seed(3))
    aud = torch.stack([wn_fused.wn_fwd_plain(x2[r], *[e[r] for e in eff], t, True)[1]
                       for r in range(runs)]).contiguous()
    skip = torch.zeros(runs, b * t, c, device=card)
    bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
    before = dict(wn_fused.LAUNCHES)
    grads = wn_fused.wn_bwd_runs(*bwd_args, True)
    twice = wn_fused.wn_bwd_runs(*bwd_args, True)
    torch.cuda.synchronize()
    assert wn_fused.LAUNCHES["wn_bwd_runs[bf16]"] == before["wn_bwd_runs[bf16]"] + 2
    for r in range(runs):
        args = tuple(a[r] for a in bwd_args[:-1]) + (t, True)
        for i, (got, again, want) in enumerate(zip(grads, twice, wn_fused.wn_bwd(*args))):
            assert torch.equal(got, again)
            if i < len(grads) - 2:  # the kernel's outputs
                assert torch.equal(got[r], want), i
            else:
                assert _rel_l2(got[r], want) <= BF16_REL_L2
    lib = wn_fused._lib()
    for bf16 in (False, True):
        assert lib.wn_bwd_wsplit_words(b * t, c, h, n_layers, int(bf16)) == \
            wn_fused.bwd_wsplit_words(b * t, c, h, n_layers, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t, h, c, n_layers",
    [
        (3, 150, 25, 120, 8),
        (2, 37, 25, 12, 7),  # C % 8 != 0, T < 2^i
        (3, 60, 168, 120, 8),  # VendCoffee's H
        (1, 65, 25, 120, 8),
        (1, 63, 25, 120, 8),
        (5, 900, 25, 120, 8),  # 64-row tiles
        (3, 1000, 25, 120, 8),  # 32-row tiles
    ],
)
def test_wn_bf16_fwd_runs_match_one_run_calls(card, b, t, h, c, n_layers):
    """``wn_fwd_runs`` with ``bf16=True`` over R = 3 runs, each its own
    weights and inputs: every run the one-run call's bits, one launch; the
    scratch the wrapper asks the library for is the Python mirror's
    (``fwd_wsplit_words``, both instances)."""
    runs = 3
    ops = [_wn_operands(card, b, t, h, c, n_layers, seed=r * 7 + t) for r in range(runs)]
    eff = [torch.stack(e).contiguous() for e in zip(*(o[1] for o in ops))]
    x2 = torch.stack([o[2].reshape(b * t, h) for o in ops]).contiguous()
    before = dict(wn_fused.LAUNCHES)
    outs = wn_fused.wn_fwd_runs(x2, *eff, t, True)
    twice = wn_fused.wn_fwd_runs(x2, *eff, t, True)
    torch.cuda.synchronize()
    assert wn_fused.LAUNCHES["wn_fwd_runs[bf16]"] == before["wn_fwd_runs[bf16]"] + 2
    for r in range(runs):
        one = wn_fused.wn_fwd(x2[r], *[e[r] for e in eff], t, True)
        for got, again, want in zip(outs, twice, one):
            assert torch.equal(got, again) and torch.equal(got[r], want)
    lib = wn_fused._lib()
    for bf16 in (False, True):
        assert lib.wn_fwd_wsplit_words(b * t, c, h, n_layers, int(bf16)) == \
            wn_fused.fwd_wsplit_words(b * t, c, h, n_layers, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("t, k, c_in, c_out, weights", [
    (150, 89, 7, 25, "dense"),
    (77, 89, 7, 25, "mask"),  # the serving layers' masked weights, T off the time tiles
    (77, 89, 25, 225, "mask"),
    (77, 2, 225, 50, "mask"),
    (77, 89, 50, 25, "mask"),
])
def test_bf16_runs_match_one_run_calls(card, t, k, c_in, c_out, weights):
    """The run-axis bf16 forms: each run of ``os_conv_runs`` on bf16 (R = 3,
    each run its own weights, run 1 with a dead column group) and of
    ``wn_fwd_runs`` / ``wn_bwd_runs`` with ``bf16=True`` gives the one-run
    bf16 call's bits (the end projection's gradients, one batched product
    outside the kernel, within BF16_REL_L2), one launch each for all runs."""
    runs, b = 3, 2
    g = torch.Generator(device=card).manual_seed(11)
    x_pad = torch.randn(runs, b, t + k - 1, c_in, device=card, generator=g).bfloat16()
    w = torch.stack([_bf16_weights(card, g, k, c_in, c_out, weights)
                     for _ in range(runs)]).bfloat16()
    w[1, :, :, 8:16] = 0  # each run its own tap windows
    before = dict(osconv.LAUNCHES)
    got = osconv.os_conv_runs(x_pad, w)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES["os_conv_fwd_runs[bf16]"] == before["os_conv_fwd_runs[bf16]"] + 1
    assert osconv.LAUNCHES["os_conv_fwd_runs"] == before["os_conv_fwd_runs"]
    for r in range(runs):
        assert torch.equal(got[r], osconv.os_conv(x_pad[r], w[r]))
        assert _rel_l2(got[r], osconv.os_conv_plain(x_pad[r], w[r])) <= BF16_REL_L2
    ops = [_wn_operands(card, 3, 150, 25, 120, 8, seed=r) for r in range(runs)]
    eff = [torch.stack(e).contiguous() for e in zip(*(o[1] for o in ops))]
    x2 = torch.stack([o[2].reshape(3 * 150, 25) for o in ops]).contiguous()
    g2 = torch.randn(runs, 3 * 150, 50, device=card, generator=torch.Generator(card).manual_seed(7))
    before = dict(wn_fused.LAUNCHES)
    y, aud, skip = wn_fused.wn_fwd_runs(x2, *eff, 150, True)
    bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], 150)
    grads = wn_fused.wn_bwd_runs(*bwd_args, True)
    torch.cuda.synchronize()
    assert wn_fused.LAUNCHES["wn_fwd_runs[bf16]"] == before["wn_fwd_runs[bf16]"] + 1
    assert wn_fused.LAUNCHES["wn_bwd_runs[bf16]"] == before["wn_bwd_runs[bf16]"] + 1
    for r in range(runs):
        one = [e[r] for e in eff]
        for a, want in zip((y[r], aud[r], skip[r]), wn_fused.wn_fwd(x2[r], *one, 150, True)):
            assert torch.equal(a, want)
        args = tuple(a[r] for a in bwd_args[:-1]) + (150, True)
        for i, (a, want) in enumerate(zip(grads, wn_fused.wn_bwd(*args))):
            if i < len(grads) - 2:  # the kernel's outputs
                assert torch.equal(a[r], want)
            else:
                assert _rel_l2(a[r], want) <= BF16_REL_L2


@pytest.mark.gpu
@pytest.mark.parametrize("k, c_in, c_out", [(5, 8, 24), (89, 7, 25), (2, 225, 50)])
def test_vmapped_cores_launch_the_bf16_run_kernels_once(card, k, c_in, c_out):
    """Under ``torch.func.vmap`` over 3 runs, bf16 ``OSConvCore`` operands
    and ``WNCore`` with the flag on launch the bf16 run-axis kernels once
    (forward and backward) and nothing else of theirs."""
    runs, b, t = 3, 2, 40
    g = torch.Generator(device=card).manual_seed(5)
    x_pad = torch.randn(runs, b, t + k - 1, c_in, device=card, generator=g).bfloat16()
    w = (torch.randn(runs, k, c_in, c_out, device=card, generator=g) / (c_in * k) ** 0.5).bfloat16()
    w.requires_grad_(True)
    ops = [_wn_operands(card, b, t, 4, 16, 3, seed=r) for r in range(runs)]
    eff = [torch.stack(e).contiguous().requires_grad_(True) for e in zip(*(o[1] for o in ops))]
    xw = torch.stack([o[2] for o in ops]).requires_grad_(True)
    osconv.reset_launch_counts()
    wn_fused.reset_launch_counts()
    y = torch.func.vmap(osconv.OSConvCore.apply)(x_pad, w)
    z = torch.func.vmap(lambda x, *e: wn_fused.WNCore.apply(x, *e, True)[0])(xw, *eff)
    grads = torch.autograd.grad(torch.sin(y.float()).sum() + torch.sin(z).sum(), [w, xw] + eff)
    torch.cuda.synchronize()
    assert osconv.LAUNCHES == {**dict.fromkeys(osconv.LAUNCHES, 0), "os_conv_fwd_runs[bf16]": 1}
    assert wn_fused.LAUNCHES == {**dict.fromkeys(wn_fused.LAUNCHES, 0), "wn_fwd_runs[bf16]": 1,
                                 "wn_bwd_runs[bf16]": 1}
    assert all(bool(torch.isfinite(gr.float()).all()) for gr in grads)
