"""The port's two bf16 switches against the JAX package's, on the CPU.

* ``FLSTTSC_WN_MXU=bf16``: the fused WN's products on bf16 operands with f32
  sums (JAX ``ops/wn_fused.py`` ``_dot``), the port's ``WNCore`` on its plain
  versions against JAX's ``wn_apply_fused`` with its Pallas kernels in
  interpret mode (``FLSTTSC_PALLAS_INTERPRET=1``).
* ``PipelineConfig.compute_dtype="bfloat16"``: the OS-CNN convs in bf16 (JAX
  ``models/os_cnn.py:66-82``, XLA's bf16 conv), the port's ``os_conv_plain``
  on bf16 operands (widened, summed in f32, rounded to bf16) and the
  transposed convs on bf16 tensors.

Shapes are small (batch 2, T <= 32, half width <= 6, 3 WN layers).  Both
switches in training (a phase-5 epoch against JAX, a K-run step against one-run
steps) are in ``tests/test_torch_port_bf16_training.py``.

Tolerances.  The two packages compute the f32 intermediates to within a few
ulps of each other, and where such an intermediate sits near a bf16 rounding
boundary the two round it to neighbouring bf16 values, 2^-8 apart
relatively; so values and gradients are held by their relative L2 distance
(1e-3), not elementwise.  The bf16 runs track the f32 runs within the JAX
package's own bars (``tests/test_ops.py:441-450``: values rtol 2e-2,
gradients max-abs under 3e-2 of max|g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.models import flow as j_flow
from feature_level_style_transfer_for_tsc_tpu.models import os_cnn as j_os_cnn
from feature_level_style_transfer_for_tsc_tpu.models.common import (
    weight_norm_weight as j_weight_norm_weight,
)
from feature_level_style_transfer_for_tsc_tpu.ops import batchnorm as j_bn
from feature_level_style_transfer_for_tsc_tpu.ops import osconv as j_osconv
from feature_level_style_transfer_for_tsc_tpu.ops import wn_fused as j_wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten, from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.models import flow, os_cnn
from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv, wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.structure import generate_layer_parameter_list
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves

REL_L2 = 1e-3
# JAX tests/test_multirun.py tiny_cfg
T_SHAPE, S_SHAPE = (2, 16, 2), (1, 12, 3)
KW = dict(batch_size=4, max_kernel_size=5, cdan_dim=32, cpc_hidden=8, budget_multiplier=0.02,
          eval_every=1)
FLOW = dict(n_flows=2, wn_channels=8, wn_layers=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port(tree, grad=False):
    out = from_jax_params(_flat({"t": tree}))["t"]
    if grad:
        for leaf in leaves(out):
            leaf.requires_grad_(True)
    return out


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = float(np.sqrt((want ** 2).sum()))
    num = float(np.sqrt(((got - want) ** 2).sum()))
    return num / den if den else num


def _interpret(monkeypatch):
    monkeypatch.setenv("FLSTTSC_USE_PALLAS", "1")
    monkeypatch.setenv("FLSTTSC_PALLAS_INTERPRET", "1")


# ------------------------------------------------------ FLSTTSC_WN_MXU ----

def _wn_case(b, t, h, c, n_layers, seed):
    params = j_flow.wn_init(jax.random.PRNGKey(seed), h, n_layers, c)
    rng = np.random.default_rng(seed)
    # a non-zero end projection: the init's zero end would hide the backward
    params["end"] = {"weight": jnp.asarray(0.3 * rng.standard_normal((c, 2 * h)), jnp.float32),
                     "bias": jnp.asarray(0.1 * rng.standard_normal(2 * h), jnp.float32)}
    return params, rng.standard_normal((b, t, h)).astype(np.float32)


def _port_wn(params, x, c):
    """The port's fused WN (``WNCore``, plain versions on the CPU): the value
    and the gradients of sum(sin(y)), by x ("x") and by each parameter (its
    checkpoint key)."""
    pp, xt = _port(params, grad=True), torch.tensor(x, requires_grad=True)
    y = flow.wn_apply(pp, xt, c)
    gx, *gp = torch.autograd.grad(torch.sin(y).sum(), [xt] + leaves(pp))
    it = iter(gp)

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        return [rebuild(v) for v in node]

    return y.detach().numpy(), {"x": gx.numpy(), **flatten({"t": rebuild(pp)})}


def _jax_wn(params, x, c):
    def loss(p, xx):
        return jnp.sum(jnp.sin(j_wn_fused.wn_apply_fused(p, xx, c, j_weight_norm_weight)))

    y = j_wn_fused.wn_apply_fused(params, jnp.asarray(x), c, j_weight_norm_weight)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    return np.asarray(y), {"x": np.asarray(gx), **_flat({"t": gp})}


@pytest.mark.parametrize("b, t, h, c", [(2, 20, 4, 16), (2, 32, 6, 12)])
def test_wn_bf16_mxu_matches_jax(b, t, h, c, monkeypatch):
    """``FLSTTSC_WN_MXU=bf16`` through the fused route of both packages:
    the value and every input and parameter gradient within relative L2
    1e-3 of JAX's; the bf16 run differs from the f32 one and tracks it
    within JAX's own bars."""
    _interpret(monkeypatch)
    params, x = _wn_case(b, t, h, c, 3, seed=t + h)
    monkeypatch.setenv("FLSTTSC_WN_MXU", "bf16")
    y16, g16 = _port_wn(params, x, c)
    jy16, jg16 = _jax_wn(params, x, c)
    assert _rel_l2(y16, jy16) <= REL_L2
    assert set(g16) == set(jg16) and len(g16) == 1 + len(_flat(params))
    for k, want in jg16.items():
        assert g16[k].shape == want.shape, k
        assert _rel_l2(g16[k], want) <= REL_L2, (k, _rel_l2(g16[k], want))
    monkeypatch.setenv("FLSTTSC_WN_MXU", "f32")
    y32, g32 = _port_wn(params, x, c)
    assert np.abs(y16 - y32).max() > 0.0  # the switch engaged
    np.testing.assert_allclose(np.sin(y16).sum(), np.sin(y32).sum(), rtol=2e-2)
    f16 = np.concatenate([g16[k].ravel() for k in sorted(g16)])
    f32 = np.concatenate([g32[k].ravel() for k in sorted(g32)])
    assert 0.0 < np.abs(f16 - f32).max() < 3e-2 * np.abs(f32).max()


def test_wn_bf16_plain_rounds_each_product_operand():
    """``_mm`` rounds both operands to bf16 and sums the exact products in
    f32 (a float64 sum of the same products agrees to f32 rounding), and the
    plain forward's start projection is one such product."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(5, 7, generator=g), torch.randn(7, 3, generator=g)
    want = a.bfloat16().double() @ b.bfloat16().double()
    torch.testing.assert_close(wn_fused._mm(a, b, True).double(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(wn_fused._mm(a, b, False), a @ b)
    eff = wn_fused.stack_effective(flow.wn_init(g, 3, 2, 8), weight_norm_weight)
    x2 = torch.randn(10, 3, generator=g)
    _, aud16, _ = wn_fused.wn_fwd_plain(x2, *eff, 10, True)
    assert torch.equal(aud16[0], wn_fused._mm(x2, eff[0], True) + eff[1])


@pytest.mark.parametrize("bf16", [False, True])
def test_wn_fwd_plain_layers_retraces_the_plain_forward(bf16):
    """``wn_fwd_plain_layers`` given ``wn_fwd_plain``'s own layer inputs and
    skip sum gives back the same bits (the layer-by-layer check of the
    kernels on the card rests on it), and a perturbed layer input moves only
    the next layer's input."""
    g = torch.Generator().manual_seed(1)
    eff = wn_fused.stack_effective(flow.wn_init(g, 3, 4, 8), weight_norm_weight)
    eff[8].copy_(torch.randn(eff[8].shape, generator=g))  # a non-zero end projection
    x2 = torch.randn(24, 3, generator=g)
    y, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, 12, bf16)
    inputs, skip_sum, y_again = wn_fused.wn_fwd_plain_layers(x2, aud, skip, *eff, 12, bf16)
    assert torch.equal(inputs, aud) and torch.equal(skip_sum, skip) and torch.equal(y_again, y)
    moved = aud.clone()
    moved[1] += 1.0
    inputs = wn_fused.wn_fwd_plain_layers(x2, moved, skip, *eff, 12, bf16)[0]
    # layer 1's output (the input of layer 2) moves; layer 2 reads moved[2] == aud[2]
    assert torch.equal(inputs[:2], aud[:2]) and not torch.equal(inputs[2], aud[2])
    assert torch.equal(inputs[3], aud[3])


def test_wn_core_takes_the_flag_on_cpu(monkeypatch):
    """``wn_apply_fused`` reads ``FLSTTSC_WN_MXU`` per call and hands it to
    the plain versions on the CPU (never the kernel wrappers), forward and
    backward."""
    seen = []
    for name in ("wn_fwd_plain", "wn_bwd_plain"):
        real = getattr(wn_fused, name)
        monkeypatch.setattr(wn_fused, name,
                            lambda *a, n=name, r=real: seen.append((n, a[-1])) or r(*a))
    params, x = _wn_case(1, 12, 3, 8, 2, seed=1)
    for value, want in (("bf16", True), ("f32", False), ("anything", False)):
        monkeypatch.setenv("FLSTTSC_WN_MXU", value)
        seen.clear()
        _port_wn(params, x, 8)
        assert seen == [("wn_fwd_plain", want), ("wn_bwd_plain", want)]


# ------------------------------------------------------ compute_dtype -----

LAYER_SPEC = generate_layer_parameter_list(1, 7, [120, 600], 3)[0]  # C_in 3, kernels 1..7


@pytest.mark.parametrize("training", [True, False])
def test_os_layer_bf16_matches_jax(training, monkeypatch):
    """``os_layer_apply(compute_dtype=bf16, fused_infer=True)``: the output,
    the new BatchNorm statistics and the gradients of x, weight, bn_scale and
    bn_bias within relative L2 1e-3 of JAX's; the folded BatchNorm epilogue
    does not run (JAX turns it off under compute_dtype).

    The conv bias's gradient is a sum of the bf16 cotangent over (B, T).
    JAX's CPU backend accumulates that bf16 reduction in bf16, one add at a
    time (its result equals such a sequential sum; 5.6e-3 relative L2 from
    the f32 sum here); PyTorch sums in f32 and rounds once.  So the bias
    gradient is held, within the same 1e-3, to the f32 sum of JAX's own bf16
    cotangent at the bias add, rounded to bf16."""
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", "1")
    p, s = j_os_cnn.os_layer_init(jax.random.PRNGKey(3), LAYER_SPEC)
    rng = np.random.default_rng(3)
    p["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, p["bn_scale"].shape), jnp.float32)
    p["bn_bias"] = jnp.asarray(0.3 * rng.standard_normal(p["bn_bias"].shape), jnp.float32)
    s = {"bn": type(s["bn"])(jnp.asarray(0.3 * rng.standard_normal(s["bn"].mean.shape), jnp.float32),
                             jnp.asarray(rng.uniform(0.5, 2.0, s["bn"].var.shape), jnp.float32))}
    x = rng.standard_normal((2, 32, 3)).astype(np.float32)
    mask = j_osconv.build_os_mask(LAYER_SPEC)

    def jloss(pp, xx):
        y, ns = j_os_cnn.os_layer_apply(pp, s, jnp.asarray(mask), xx, training, True,
                                        compute_dtype=jnp.bfloat16, fused_infer=True)
        return jnp.sum(jnp.sin(y)), (y, ns)

    (_, (jy, jns)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x))

    def tail(yc):  # os_layer_apply after the bf16 conv and its bias
        y, _ = j_bn.batch_norm(yc.astype(jnp.float32), p["bn_scale"], p["bn_bias"], s["bn"],
                               training)
        return jnp.sum(jnp.sin(jnp.maximum(y, 0.0)))

    bf = jnp.bfloat16
    yc = j_osconv.masked_os_conv(jnp.asarray(x, bf), p["conv"]["weight"].astype(bf),
                                 p["conv"]["bias"].astype(bf), jnp.asarray(mask, bf))
    cot = np.asarray(jax.grad(tail)(yc), np.float32)
    want_bias = np.asarray(jnp.asarray(cot.sum((0, 1)), bf), np.float32)

    calls = []
    real = os_cnn.masked_os_conv
    monkeypatch.setattr(os_cnn, "masked_os_conv",
                        lambda *a, **kw: calls.append((a[0].dtype, kw)) or real(*a, **kw))
    monkeypatch.setattr(osconv, "os_conv_fused",
                        lambda *a: pytest.fail("the folded BatchNorm epilogue ran"))
    tree = _port({"p": p, "s": s})
    pp, ps = tree["p"], tree["s"]
    for leaf in leaves(pp):
        leaf.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    y, ns = os_cnn.os_layer_apply(pp, ps, torch.from_numpy(mask), xt, training, True,
                                  compute_dtype=torch.bfloat16, fused_infer=True)
    assert calls == [(torch.bfloat16, {})]
    assert y.dtype == torch.float32
    assert _rel_l2(y.detach().numpy(), jy) <= REL_L2
    assert _rel_l2(ns["bn"].mean.detach().numpy(), jns["bn"].mean) <= REL_L2
    assert _rel_l2(ns["bn"].var.detach().numpy(), jns["bn"].var) <= REL_L2
    wants = {"x": jgx, "weight": jgp["conv"]["weight"], "bias": want_bias,
             "bn_scale": jgp["bn_scale"], "bn_bias": jgp["bn_bias"]}
    gots = dict(zip(wants, torch.autograd.grad(
        torch.sin(y).sum(), [xt, pp["conv"]["weight"], pp["conv"]["bias"], pp["bn_scale"],
                             pp["bn_bias"]])))
    for k, want in wants.items():
        assert gots[k].dtype == torch.float32
        assert _rel_l2(gots[k].numpy(), want) <= REL_L2, (k, _rel_l2(gots[k].numpy(), want))


def test_os_conv_bf16_plain_matches_jax_xla_conv():
    """The conv alone: the port's ``os_conv`` on bf16 CPU tensors (the plain
    version) against the JAX package's conv core in bf16 (XLA's conv with a
    bf16 output), value and both gradients (the transposed convs on bf16
    tensors, bf16 results, as JAX's XLA VJP)."""
    rng = np.random.default_rng(4)
    x_pad = rng.standard_normal((2, 40, 7)).astype(np.float32)
    w = (rng.standard_normal((9, 7, 24)) / np.sqrt(63)).astype(np.float32)
    g = rng.standard_normal((2, 32, 24)).astype(np.float32)
    jx, jw = jnp.asarray(x_pad, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want, vjp = jax.vjp(j_osconv._conv_core, jx, jw)
    want_dx, want_dw = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.tensor(x_pad).bfloat16().requires_grad_(True)
    wt = torch.tensor(w).bfloat16().requires_grad_(True)
    got = osconv.OSConvCore.apply(xt, wt)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.tensor(g).bfloat16())
    for a, b in ((got, want), (dx, want_dx), (dw, want_dw)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        assert _rel_l2(a.float().detach().numpy(), np.asarray(b, np.float32)) <= REL_L2
    # the plain version: widened, summed in f32, rounded once
    assert torch.equal(osconv.os_conv_plain(xt.detach(), wt.detach()),
                       osconv.os_conv_plain(xt.detach().float(), wt.detach().float()).bfloat16())


def test_os_conv_bf16_operands_must_agree():
    """One dtype for both operands; ``os_conv_fused`` stays float32 only
    (its kernel has no bf16 instance, as JAX's fused path is off under
    compute_dtype)."""
    x_pad = torch.zeros(1, 6, 2, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(3, 2, 4, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        osconv._check_operands(x_pad, w, bf16=True)
    with pytest.raises(TypeError, match="float32"):
        osconv._check_operands(x_pad, w.bfloat16())
    assert osconv._check_operands(x_pad, w.bfloat16(), bf16=True) == (1, 4, 4)


def test_pipeline_config_takes_compute_dtype():
    """``compute_dtype="bfloat16"`` builds and selects bf16 convs; any other
    value means f32, as in JAX ``train/pipeline.py:120-122``; it builds
    together with each of the three GradNorm / optimizer knobs."""
    cfg = PipelineConfig(compute_dtype="bfloat16", **KW, flow=FlowConfig(**FLOW))
    assert port_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, cfg, device="cpu").compute_dtype \
        == torch.bfloat16
    other = PipelineConfig(compute_dtype="float16", **KW, flow=FlowConfig(**FLOW))
    assert port_pipeline.TargetPredictor(*T_SHAPE, config=other, device="cpu").compute_dtype is None
    for knob in ({"fused_optimizers": True}, {"stacked_pullbacks": True},
                 {"merged_pullbacks": False}):
        both = PipelineConfig(compute_dtype="bfloat16", **KW, flow=FlowConfig(**FLOW), **knob)
        pipe = port_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, both, device="cpu")
        assert pipe.compute_dtype == torch.bfloat16
        assert all(getattr(pipe.config, k) == v for k, v in knob.items())
