"""The port's training modules against the JAX package's, on the CPU.

Each module of the training slice gets the same numpy-seeded inputs (and
the JAX package's own initial parameters, carried over by
``from_jax_params``) in both packages; the JAX side runs on its XLA path
(``FLSTTSC_USE_PALLAS=0``, as conftest.py sets).  Tolerances, f32 on both
sides with sums in another order: rtol 1e-5 / atol 1e-6 for one-op results,
rtol 1e-4 / atol 1e-5 for composed modules, and rtol/atol 3e-4 / 5e-4 for the
8-layer WN value and gradients, as tests/test_ops.py holds the fused WN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.losses import cdan as j_cdan
from feature_level_style_transfer_for_tsc_tpu.losses import classification as j_cls
from feature_level_style_transfer_for_tsc_tpu.losses import gradnorm as j_gn
from feature_level_style_transfer_for_tsc_tpu.losses import wgan as j_wgan
from feature_level_style_transfer_for_tsc_tpu.models import adapters as j_adapters
from feature_level_style_transfer_for_tsc_tpu.models import cpc as j_cpc
from feature_level_style_transfer_for_tsc_tpu.models import critics as j_critics
from feature_level_style_transfer_for_tsc_tpu.models import flow as j_flow
from feature_level_style_transfer_for_tsc_tpu.ops import batchnorm as j_bn
from feature_level_style_transfer_for_tsc_tpu.ops import coupling as j_coupling
from feature_level_style_transfer_for_tsc_tpu.ops import grl as j_grl
from feature_level_style_transfer_for_tsc_tpu.ops import osconv as j_osconv
from feature_level_style_transfer_for_tsc_tpu.train import optim as j_optim
from feature_level_style_transfer_for_tsc_tpu_torch.data.batching import epoch_batches
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import (
    from_jax_params,
    restore_checkpoint,
    save_checkpoint,
)
from feature_level_style_transfer_for_tsc_tpu_torch.losses import cdan, classification, gradnorm, wgan
from feature_level_style_transfer_for_tsc_tpu_torch.models import adapters, cpc, critics, flow
from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
from feature_level_style_transfer_for_tsc_tpu_torch.ops import batchnorm, coupling, grl, osconv
from feature_level_style_transfer_for_tsc_tpu_torch.ops import wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.train import optim
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import leaves

ONE_OP = {"rtol": 1e-5, "atol": 1e-6}
MODULE = {"rtol": 1e-4, "atol": 1e-5}
WN_TOL = {"rtol": 3e-4, "atol": 5e-4}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port(tree, grad=False):
    """A JAX tree as the port's tree (the checkpoint key layout)."""
    out = from_jax_params(_flat({"t": tree}))["t"]
    if grad:
        for leaf in leaves(out):
            leaf.requires_grad_(True)
    return out


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close_trees(port_tree, jax_tree, tol):
    """Every leaf of a port tree against the JAX tree's leaf of the same key."""
    from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten

    got, want = flatten({"t": port_tree}), _flat({"t": jax_tree})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


def _grads_tree(loss, tree):
    """d loss / d leaf as a tree of the same layout (zeros where unused)."""
    ls = leaves(tree)
    gs = torch.autograd.grad(loss, ls, allow_unused=True, retain_graph=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(ls, gs))

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        return [rebuild(v) for v in node]

    return rebuild(tree)


# ---------------------------------------------------------------- ops ----

def test_batch_norm_training_matches_jax():
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 7, 5)
    scale, bias, mean = _rand(rng, 5), _rand(rng, 5), _rand(rng, 5)
    var = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    want, want_stats = j_bn.batch_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                       j_bn.BNStats(jnp.asarray(mean), jnp.asarray(var)), True)
    got, stats = batchnorm.batch_norm(_t(x), _t(scale), _t(bias),
                                      batchnorm.BNStats(_t(mean), _t(var)), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE)
    np.testing.assert_allclose(stats.mean.numpy(), np.asarray(want_stats.mean), **ONE_OP)
    np.testing.assert_allclose(stats.var.numpy(), np.asarray(want_stats.var), **ONE_OP)


@pytest.mark.parametrize("k", [5, 8])
def test_os_conv_grads_match_jax(k):
    """dx, dw and db of the masked OS conv (through ``OSConvCore``'s plain
    transposed-conv backward) against ``jax.grad`` of ``masked_os_conv``."""
    spec = [(3, 2, kk) for kk in (1, 2, 3, k)]
    rng = np.random.default_rng(k)
    x, w, b = _rand(rng, 2, 30, 3), _rand(rng, k, 3, 8, scale=0.3), _rand(rng, 8)
    mask = osconv.build_os_mask(spec)

    def jloss(x, w, b):
        return jnp.sum(jnp.sin(j_osconv.masked_os_conv(x, w, b, jnp.asarray(mask))))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ins = [_t(x, True), _t(w, True), _t(b, True)]
    got = torch.autograd.grad(torch.sin(osconv.masked_os_conv(*ins, _t(mask))).sum(), ins)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **MODULE)


def test_os_conv_fused_refuses_gradients():
    x_pad, w = torch.zeros(1, 9, 2), torch.zeros(3, 2, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        osconv.os_conv_fused(x_pad, w, torch.ones(4), torch.zeros(4), True)


@pytest.mark.parametrize("it", [-1, 0, 3, 20, 40])
def test_grl_matches_jax(it):
    np.testing.assert_allclose(grl.grl_coeff(it, max_iter=20.0),
                               float(j_grl.grl_coeff(it, max_iter=20.0)), **ONE_OP)
    x = torch.randn(4, 3, requires_grad=True)
    y = grl.gradient_reversal(x, 0.7)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y * 2.0).sum(), x)
    np.testing.assert_allclose(g.numpy(), -1.4 * np.ones((4, 3)), **ONE_OP)


def test_coupling_matches_jax_and_inverts():
    rng = np.random.default_rng(1)
    x1, log_s, b = _rand(rng, 2, 6, 3), _rand(rng, 2, 6, 3, scale=0.5), _rand(rng, 2, 6, 3)
    want, want_ld = j_coupling.affine_coupling_forward(*map(jnp.asarray, (x1, log_s, b)))
    got, ld = coupling.affine_coupling_forward(_t(x1), _t(log_s), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ONE_OP)
    np.testing.assert_allclose(float(ld), float(want_ld), **MODULE)
    back = coupling.affine_coupling_inverse(got, _t(log_s), _t(b))
    np.testing.assert_allclose(back.numpy(), x1, **MODULE)


# ----------------------------------------------------------------- WN -----

def _wn_case(b, t, h, c, seed):
    params = j_flow.wn_init(jax.random.PRNGKey(seed), h, 8, c)
    rng = np.random.default_rng(seed)
    # a non-zero end projection: the init's zero end would hide the backward
    params["end"] = {"weight": jnp.asarray(_rand(rng, c, 2 * h, scale=0.3)),
                     "bias": jnp.asarray(_rand(rng, 2 * h, scale=0.1))}
    return params, _rand(rng, b, t, h)


def _wn_unfused(params, x, n_channels):
    """The coupling net op by op, written out here (autograd over F.conv1d):
    an independent reference for ``WNCore``'s plain versions."""
    n_layers = len(params["in_layers"])
    audio = x @ weight_norm_weight(params["start"])[0] + params["start"]["bias"]
    spect = x @ weight_norm_weight(params["cond"])[0] + params["cond"]["bias"]
    output = torch.zeros_like(audio)
    for i in range(n_layers):
        layer, d = params["in_layers"][i], 2 ** i
        in_act = torch.nn.functional.conv1d(
            audio.transpose(1, 2), weight_norm_weight(layer).permute(2, 1, 0), padding=d, dilation=d
        ).transpose(1, 2) + layer["bias"]
        z = in_act + spect[..., i * 2 * n_channels : (i + 1) * 2 * n_channels]
        acts = torch.tanh(z[..., :n_channels]) * torch.sigmoid(z[..., n_channels:])
        rs = params["res_skip_layers"][i]
        res_skip = acts @ weight_norm_weight(rs)[0] + rs["bias"]
        if i < n_layers - 1:
            audio = audio + res_skip[..., :n_channels]
            output = output + res_skip[..., n_channels:]
        else:
            output = output + res_skip
    return output @ params["end"]["weight"] + params["end"]["bias"]


@pytest.mark.parametrize("path", ["unfused", "wn_core"])
@pytest.mark.parametrize("shape", [(2, 37, 5), (3, 20, 4), (1, 64, 3)])
def test_wn_matches_jax_wn_apply(path, shape, monkeypatch):
    """Value, input grad and every param grad against JAX ``wn_apply``,
    with T not a multiple of 8 and T < 2^7 (the deep taps all masked):
    the port's ``wn_apply`` on its op-by-op route (``FLSTTSC_WN_FUSED=0``)
    and on its fused route (``WNCore``)."""
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0" if path == "unfused" else "1")
    b, t, h = shape
    c = 16
    params, x = _wn_case(b, t, h, c, seed=t)

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


def test_wn_apply_takes_the_plain_versions_on_cpu(monkeypatch):
    """On a CPU tensor ``wn_apply`` runs ``WNCore`` over ``wn_fwd_plain`` and
    ``wn_bwd_plain`` (no kernel wrapper), equal to the op-by-op reference."""
    params, x = _wn_case(2, 12, 3, 8, seed=2)
    for name in ("wn_fwd", "wn_bwd"):
        monkeypatch.setattr(wn_fused, name, lambda *a, n=name: pytest.fail(f"{n} on a CPU tensor"))
    pp, xt = _port(params, grad=True), _t(x, True)
    y = flow.wn_apply(pp, xt, 8)
    want = _wn_unfused(pp, xt, 8)
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), **MODULE)
    got_g = torch.autograd.grad(torch.sin(y).sum(), [xt] + leaves(pp), allow_unused=True)
    want_g = torch.autograd.grad(torch.sin(want).sum(), [xt] + leaves(pp), allow_unused=True)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **MODULE)


@pytest.mark.parametrize("t", [37, 20])
def test_wn_bwd_plain_matches_autograd(t):
    """The backward written out (``wn_bwd_plain``) against autograd of
    ``wn_fwd_plain``: every gradient of the stacked effective weights."""
    params, x = _wn_case(2, t, 5, 16, seed=t + 1)
    eff = [e.detach().clone().requires_grad_(True)
           for e in wn_fused.stack_effective(_port(params), weight_norm_weight)]
    x2 = _t(x.reshape(2 * t, 5), True)
    y, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t)
    g2 = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad(y, [x2] + eff, g2)
    d = [e.detach() for e in eff]
    written = wn_fused.wn_bwd_plain(x2.detach(), g2, aud.detach(), skip.detach(), d[0], d[2], d[3],
                                    d[4], d[5], d[6], d[8], t)
    assert len(written) == len(auto) == 11
    for a, w in zip(auto, written):
        np.testing.assert_allclose(w.numpy(), a.numpy(), rtol=1e-4, atol=1e-5 * float(a.abs().max()))


# --------------------------------------------------------------- flow -----

@pytest.mark.parametrize("clamp", [0.0, 2.0])
def test_flow_matches_jax(clamp):
    """forward_pair (per-batch logdet shares), infer, the NLL, and the round
    trip, with ``log_s_clamp`` off and on."""
    n_group, c = 6, 16
    params = j_flow.waveglow_init(jax.random.PRNGKey(3), 2, n_group, c, 8)
    rng = np.random.default_rng(3)
    for wn in params["wn"]:
        wn["end"] = {"weight": jnp.asarray(_rand(rng, c, n_group, scale=0.2)),
                     "bias": jnp.asarray(_rand(rng, n_group, scale=0.1))}
    xa, xb = _rand(rng, 2, 14, n_group), _rand(rng, 3, 14, n_group)
    ja, jb = j_flow.waveglow_forward_pair(params, jnp.asarray(xa), jnp.asarray(xb), c, clamp)
    pp = _port(params)
    pa, pb = flow.waveglow_forward_pair(pp, _t(xa), _t(xb), c, clamp)
    for got, want in ((pa, ja), (pb, jb)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **MODULE)
        for g, w in zip(got[1], want[1]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODULE)
        for g, w in zip(got[2], want[2]):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(flow.waveglow_loss(got)), float(j_flow.waveglow_loss(want)),
                                   **MODULE)
    noise = _rand(rng, 2, 14, n_group)
    np.testing.assert_allclose(
        flow.waveglow_infer(pp, _t(noise), c, log_s_clamp=clamp).numpy(),
        np.asarray(j_flow.waveglow_infer(params, jnp.asarray(noise), c, log_s_clamp=clamp)),
        **MODULE,
    )
    back = flow.waveglow_infer(pp, pa[0], c, log_s_clamp=clamp)
    np.testing.assert_allclose(back.numpy(), xa, rtol=1e-4, atol=1e-4)


def test_inv1x1_init_is_a_rotation():
    w = flow.inv1x1_init(torch.Generator().manual_seed(0), 6)["weight"].double()
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(6), atol=1e-6)
    assert torch.linalg.det(w) > 0


# ----------------------------------------------------- adapters / cpc -----

def test_adapters_match_jax():
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(4)
    du = j_adapters.dimension_unification_init(key, 3, 4, 10, 14)
    x = _rand(rng, 2, 10, 3)
    np.testing.assert_allclose(
        adapters.dimension_unification_apply(_port(du), _t(x)).numpy(),
        np.asarray(j_adapters.dimension_unification_apply(du, jnp.asarray(x))), **MODULE,
    )
    pt = j_adapters.prob_transfer_init(key, 4)
    pooled = _rand(rng, 3, 4)
    np.testing.assert_allclose(
        adapters.prob_transfer_apply(_port(pt), _t(pooled)).numpy(),
        np.asarray(j_adapters.prob_transfer_apply(pt, jnp.asarray(pooled))), **MODULE,
    )
    # NoiseTransfer over three calls: the first adds the plain mean, later
    # calls the growing batch/cal_num rule (batches of 3, 2 and 3)
    npar, jstate = j_adapters.noise_transfer_init(key, 4, 6)
    pstate = from_jax_params(_flat({"s": jstate}))["s"]
    pnp = _port(npar)
    for b_t, b_s in ((3, 2), (2, 3), (3, 3)):
        tn, sn = _rand(rng, b_t, 6, 4), _rand(rng, b_s, 6, 4)
        want, jstate = j_adapters.noise_transfer_apply(npar, jstate, jnp.asarray(tn), jnp.asarray(sn))
        got, pstate = adapters.noise_transfer_apply(pnp, pstate, _t(tn), _t(sn))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE)
        _close_trees(list(pstate), list(jstate), MODULE)


@pytest.mark.parametrize("anchors", [(0, 3), (2, 1)])
def test_cpc_matches_jax_at_pinned_anchors(anchors):
    rng = np.random.default_rng(5)
    params = j_cpc.cpc_init(jax.random.PRNGKey(5), 4, 6, 8)
    fa, fb = _rand(rng, 3, 16, 4), _rand(rng, 3, 16, 4)
    key = jax.random.PRNGKey(0)
    want = j_cpc.cpc_apply_pair(params, jnp.asarray(fa), jnp.asarray(fb), key, key, anchors=anchors)
    pp = _port(params, grad=True)
    got = cpc.cpc_apply_pair(pp, _t(fa), _t(fb), anchors=anchors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **MODULE)
    single = cpc.cpc_apply(pp, _t(fa), anchors[0])
    np.testing.assert_allclose(float(single), float(got[0]), **ONE_OP)
    jgrad = jax.grad(lambda p: j_cpc.cpc_apply(p, jnp.asarray(fa), key, anchor=anchors[0]))(params)
    _close_trees(_grads_tree(single, pp), jgrad, MODULE)


# ------------------------------------------------------------ critics -----

def test_critics_match_jax_and_counters_advance():
    """ad_net (dropout off) and the feature discriminator: values, the GRL'd
    input gradients, and the counters from -1 through their cap of 20."""
    rng = np.random.default_rng(6)
    ad_p, ad_s = j_critics.ad_net_init(jax.random.PRNGKey(6), 12, 16)
    fd_p, fd_s = j_critics.feature_discriminator_init(jax.random.PRNGKey(7), 5)
    p_ad, p_fd = _port(ad_p), _port(fd_p)
    p_ad_s, p_fd_s = critics.critic_state_init(), critics.critic_state_init()
    x_ad, x_fd = _rand(rng, 4, 12), _rand(rng, 4, 5)
    for step in range(23):
        def jad(x, s=ad_s):
            out, _ = j_critics.ad_net_apply(ad_p, s, x, training=True)
            return jnp.sum(out), out

        def jfd(x, s=fd_s):
            out, _ = j_critics.feature_discriminator_apply(fd_p, s, x, training=True)
            return jnp.sum(out), out

        (jg_ad, jout_ad), (jg_fd, jout_fd) = (
            jax.grad(jad, has_aux=True)(jnp.asarray(x_ad)),
            jax.grad(jfd, has_aux=True)(jnp.asarray(x_fd)),
        )
        _, ad_s = j_critics.ad_net_apply(ad_p, ad_s, jnp.asarray(x_ad), training=True)
        _, fd_s = j_critics.feature_discriminator_apply(fd_p, fd_s, jnp.asarray(x_fd), training=True)
        xa, xf = _t(x_ad, True), _t(x_fd, True)
        out_ad, p_ad_s = critics.ad_net_apply(p_ad, p_ad_s, xa, training=True)
        out_fd, p_fd_s = critics.feature_discriminator_apply(p_fd, p_fd_s, xf, training=True)
        np.testing.assert_allclose(out_ad.detach().numpy(), np.asarray(jout_ad), **MODULE)
        np.testing.assert_allclose(out_fd.detach().numpy(), np.asarray(jout_fd), **MODULE)
        g_ad, g_fd = torch.autograd.grad([out_ad.sum(), out_fd.sum()], [xa, xf])
        np.testing.assert_allclose(g_ad.numpy(), np.asarray(jg_ad), **MODULE)
        np.testing.assert_allclose(g_fd.numpy(), np.asarray(jg_fd), **MODULE)
        assert int(p_ad_s.iter_num) == int(ad_s.iter_num) == min(step, 20)
        assert int(p_fd_s.iter_num) == int(fd_s.iter_num) == min(step, 20)


def test_dropout_masks_are_multipliers():
    from feature_level_style_transfer_for_tsc_tpu_torch.models.common import dropout, dropout_mask

    x = torch.ones(200, 50)
    mask = dropout_mask(x.shape, 0.2, torch.Generator().manual_seed(0))
    assert set(torch.unique(mask).tolist()) == {0.0, 1.25}
    assert torch.equal(dropout(x, 0.2, True, mask=mask), mask)
    assert torch.equal(dropout(x, 0.2, False, mask=mask), x)
    assert 0.75 < float((mask > 0).float().mean()) < 0.85


# ------------------------------------------------------------- losses -----

def test_losses_match_jax():
    rng = np.random.default_rng(7)
    logits, labels = _rand(rng, 5, 3), rng.integers(0, 3, 5)
    np.testing.assert_allclose(
        float(classification.cross_entropy(_t(logits), torch.from_numpy(labels))),
        float(j_cls.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), **ONE_OP,
    )
    probs = torch.softmax(_t(logits), -1)
    np.testing.assert_allclose(classification.softmax_entropy(probs).numpy(),
                               np.asarray(j_cls.softmax_entropy(jnp.asarray(probs.numpy()))), **ONE_OP)
    a, b, c = _rand(rng, 5, 1), _rand(rng, 5, 1), _rand(rng, 5, 1)
    np.testing.assert_allclose(float(wgan.wgan_loss(_t(a), _t(b), _t(c))),
                               float(j_wgan.wgan_loss(*map(jnp.asarray, (a, b, c)))), **ONE_OP)


def test_cdan_matches_jax():
    """The CDAN loss (dropout off, the (B,B) broadcast quirk kept), its new
    critic state, and the gradients of all four inputs."""
    rng = np.random.default_rng(8)
    b, t, c, n = 4, 6, 3, 2
    ad_p, ad_s = j_critics.ad_net_init(jax.random.PRNGKey(8), 16, 16)
    rl = j_critics.random_layer_init(jax.random.PRNGKey(9), [c * t, n], 16)
    ins = [_rand(rng, b, t, c), _rand(rng, b, t, c), _rand(rng, b, n), _rand(rng, b, n)]
    ad_s = j_critics.CriticState(jnp.asarray(3, jnp.int32))

    def jloss(*xs):
        loss, st = j_cdan.cdan_loss(ad_p, ad_s, *xs, random_layer=rl)
        return loss, st

    (want, want_st), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, ins))
    pins = [_t(v, True) for v in ins]
    got, st = cdan.cdan_loss(_port(ad_p), critics.CriticState(torch.tensor(3, dtype=torch.int32)),
                             *pins, random_layer=_port(rl))
    np.testing.assert_allclose(float(got), float(want), **MODULE)
    assert int(st.iter_num) == int(want_st.iter_num) == 5
    for g, w in zip(torch.autograd.grad(got, pins), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5 * float(np.abs(w).max()))


def test_gradnorm_steps_match_jax():
    """Three GradNorm weight updates (the first fixes the initial sigmoid
    losses), each with a torch Adam step, the clamp and the renormalization."""
    rng = np.random.default_rng(10)
    tx = j_gn.optax.adam(1e-3)
    jstate = j_gn.gradnorm_init((2.0, 2.0, 4.0), tx)
    pstate = gradnorm.gradnorm_init((2.0, 2.0, 4.0), 1e-3)
    for _ in range(3):
        losses, norms = rng.uniform(0.1, 3.0, 3).astype(np.float32), rng.uniform(0.1, 5.0, 3).astype(np.float32)
        jstate = j_gn.gradnorm_step(jstate, jnp.asarray(losses), jnp.asarray(norms), tx, weight_sum=8.0)
        gradnorm.gradnorm_step(pstate, _t(losses), _t(norms), weight_sum=8.0)
        np.testing.assert_allclose(pstate.weights.numpy(), np.asarray(jstate.weights), **ONE_OP)
        np.testing.assert_allclose(pstate.initial_sigmoid_loss.numpy(),
                                   np.asarray(jstate.initial_sigmoid_loss), **ONE_OP)
        assert float(pstate.weights.sum()) == pytest.approx(8.0, rel=1e-6)


# ---------------------------------------------------------- optimizers ----

@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_optimizers_match_optax(kind):
    """torch RMSprop / Adam with the JAX package's hyperparameters against
    its optax transformations, over three steps and an LR change."""
    rng = np.random.default_rng(11)
    p0 = {"w": _rand(rng, 4, 3), "b": _rand(rng, 3)}
    tx = (j_optim.make_rmsprop if kind == "rmsprop" else j_optim.make_adam)(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = tx.init(jp)
    pp = {k: _t(v, True) for k, v in p0.items()}
    opt = (optim.make_rmsprop if kind == "rmsprop" else optim.make_adam)(pp.values(), 1e-2)
    for step in range(3):
        if step == 2:
            jst = j_optim.set_lr(jst, 3e-3)
            optim.set_lr(opt, 3e-3)
        g = {k: _rand(rng, *v.shape) for k, v in p0.items()}
        upd, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = j_optim.optax.apply_updates(jp, upd)
        for k, p in pp.items():
            p.grad = _t(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(jp[k]), **ONE_OP)


def test_schedulers_match_jax():
    for epoch in (0, 24, 25, 51, 120):
        assert optim.step_lr(1e-3, epoch, 25, 0.8) == pytest.approx(
            float(j_optim.step_lr(1e-3, epoch, 25, 0.8)), rel=1e-6)
    rng = np.random.default_rng(12)
    metrics = np.concatenate([[5.0, 4.0], np.full(14, 4.0), rng.uniform(3.0, 6.0, 20)]).astype(np.float32)
    ps, js = optim.plateau_init(1e-3), j_optim.plateau_init(1e-3)
    for m in metrics:
        ps = optim.plateau_step(ps, m, factor=0.7, min_lr=1e-4)
        js = j_optim.plateau_step(js, m, factor=0.7, min_lr=1e-4)
        assert ps.num_bad == int(js.num_bad)
        assert ps.lr == pytest.approx(float(js.lr), rel=1e-6)
        assert ps.best == pytest.approx(float(js.best), rel=1e-6)
    assert ps.lr < 1e-3  # the plateau reduced the rate at least once


def test_clip_params_in_place():
    ps = [torch.tensor([-1.0, 0.001, 2.0]), torch.tensor([[0.5]])]
    optim.clip_params(ps, 0.01)
    assert ps[0].tolist() == pytest.approx([-0.01, 0.001, 0.01]) and ps[1].item() == pytest.approx(0.01)


# ---------------------------------------------------------- batching ------

def test_epoch_batches_wrap_and_injected_order():
    x = np.arange(7 * 2 * 1, dtype=np.float32).reshape(7, 2, 1)
    y = np.arange(7, dtype=np.int32)
    perm = np.array([3, 0, 6, 1, 5, 2, 4])
    xb, yb = epoch_batches(x, y, None, 3, perm=perm)
    assert xb.shape == (3, 3, 2, 1)
    np.testing.assert_array_equal(yb.reshape(-1), np.resize(perm, 9))  # tail wraps around
    _, yb2 = epoch_batches(x, y, torch.Generator().manual_seed(0), 3)
    assert sorted(set(yb2.reshape(-1).tolist())) == list(range(7))


# -------------------------------------------------------- checkpoints -----

def test_training_state_round_trips_through_the_jax_key_layout(tmp_path):
    """BN stats, NoiseTransfer and critic states and the random layer come
    back under the JAX package's keys, as the JAX ``save_checkpoint`` writes
    them, with the counters as host integers."""
    from feature_level_style_transfer_for_tsc_tpu.io.checkpoint import save_checkpoint as jax_save

    _, ns = j_adapters.noise_transfer_init(jax.random.PRNGKey(0), 4, 6)
    tree = {
        "mstate": {"noise": ns, "ad": j_critics.critic_state_init(),
                   "bn": j_bn.init_bn_stats(3)},
        "consts": {"random_layer": j_critics.random_layer_init(jax.random.PRNGKey(1), [5, 2], 8)},
    }
    jax_save(str(tmp_path / "jax.npz"), tree)
    state = restore_checkpoint(str(tmp_path / "jax.npz"))
    assert isinstance(state["mstate"]["noise"], adapters.NoiseTransferState)
    assert isinstance(state["mstate"]["ad"], critics.CriticState)
    assert int(state["mstate"]["ad"].iter_num) == -1
    save_checkpoint(str(tmp_path / "port.npz"), state)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("knob", [{"fused_optimizers": True}, {"stacked_pullbacks": True},
                                  {"merged_pullbacks": False}])
def test_pipeline_config_takes_each_knob(knob):
    """Each of the JAX package's execution knobs builds a CPU pipeline that
    takes a phase-5 step with finite losses and moves its parameters
    (their parity with the JAX package: ``test_torch_port_knobs.py`` and
    ``test_torch_port_knobs_fused.py``)."""
    from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

    cfg = PipelineConfig(batch_size=4, max_kernel_size=5, cdan_dim=32, cpc_hidden=8,
                         budget_multiplier=0.02, flow=FlowConfig(n_flows=2, wn_channels=8,
                                                                 wn_layers=2), **knob)
    pipe = StyleTransferPipeline(2, 16, 2, 1, 12, 3, cfg, device="cpu")
    state = pipe.init_state(torch.Generator().manual_seed(0))
    assert ("fused" in state["opt"]) == cfg.fused_optimizers
    before = [p.detach().clone() for p in leaves(state["params"])]
    rng = np.random.default_rng(0)
    losses, _ = pipe.phase5_step(
        state, torch.tensor(rng.standard_normal((4, 16, 2)), dtype=torch.float32),
        torch.tensor(rng.integers(0, 2, 4)), torch.tensor(rng.standard_normal((4, 12, 1)),
                                                          dtype=torch.float32),
        torch.tensor(rng.integers(0, 3, 4)), 0)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(state["params"])))
