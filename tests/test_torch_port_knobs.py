"""``PipelineConfig``'s GradNorm pull knobs against the JAX package, on the CPU.

``merged_pullbacks=False`` (six pulls a step) and ``stacked_pullbacks=True``
(the total, t_nf + s_nf and s2t2s_c as ONE backward under a batch of three
cotangents) in the single run and in the K-run multirun, and the
batched-cotangent rules of the kernels' Functions that the stacked pull
reaches.  The fused optimizers are in ``test_torch_port_knobs_fused.py``.

Geometry: the JAX package's ``tiny_cfg`` of ``tests/test_multirun.py``
(target 2 x 16, 2 classes; source 1 x 12, 3 classes; batch 4; a 2-flow
WaveGlow with a 2-layer, 8-channel WN; ``budget_multiplier=0.02``), one
phase-5 epoch of 2 numpy-seeded batches from the JAX package's
``init_state``, carried into the port with ``from_jax_params``.  The JAX
epochs run on the XLA path (unmerged) and with the Pallas kernels in
interpret mode (stacked).  Randomness is pinned from the test only, as in
``test_torch_port_train_phases.py``: the JAX pipeline's ``cpc_apply_pair``
patched to fixed anchors and ``critics.dropout`` to the identity, the port
given the same anchors and all-ones dropout multipliers.  No JAX file
changes.

Tolerances:

* port against port (unmerged against merged): rtol 1e-6, atol 1e-7 on the
  metrics and every parameter, JAX ``tests/test_multirun.py:220``'s bar
  between its own two pull layouts (the total's pull is the same pull, and
  each merged pull adds exact zeros across the trunks, so the port's two
  agree to the bit);
* port against JAX, unmerged: the metrics (the GradNorm weights, which read
  the trunk norms of both steps, among them) within the parity tolerances
  of ``test_torch_port_train_phases.py``, rtol 1e-4, atol 1e-5, since the two
  frameworks sum in other orders.  Parameters are held port against port:
  across frameworks a two-step epoch moves some of them by far more than
  the summation order (RMSprop's first step turns a gradient at rounding
  level into a step of about 10 lr, the next step's forward sees it, and the
  WGAN clip at 5e-4 keeps the critic's weights at its corners), which the
  one-step parity test of ``test_torch_port_train_phases.py`` avoids;
* stacked, against JAX's stacked epoch and against the port's unstacked
  one: rtol 2e-3, atol 1e-3 on the metrics, JAX ``tests/test_multirun.py:
  277``'s bar (the batched backward sums in another order, and RMSprop's
  first steps turn a sign flip of a gradient at rounding level into a step
  of about 10 lr);
* the batched-cotangent rules against one pull a cotangent: rtol 1e-5,
  atol 1e-6 (the rule runs the same plain version on the same operands;
  PyTorch's own batched ops around it sum in another order).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.config import FlowConfig as JaxFlow
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.models import critics as jax_critics
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten, from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import wn_init
from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.ops.grl import gradient_reversal
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
    MultiRunStylePipeline,
    stack_states,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import batched_pull
from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves

SHAPES = (2, 16, 2, 1, 12, 3)
B, NB = 4, 2
ANCHORS = (2, 1)
KW = dict(batch_size=B, max_kernel_size=5, cdan_dim=32, cpc_hidden=8, budget_multiplier=0.02,
          eval_every=1)
FLOW = dict(n_flows=2, wn_channels=8, wn_layers=2)
LOSS_TOL = {"rtol": 1e-4, "atol": 1e-5}
EXACT_TOL = {"rtol": 1e-6, "atol": 1e-7}
STACKED_TOL = {"rtol": 2e-3, "atol": 1e-3}
RULE_TOL = {"rtol": 1e-5, "atol": 1e-6}
KNOBS = {"merged": {}, "unmerged": {"merged_pullbacks": False},
         "stacked": {"stacked_pullbacks": True}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """JAX's randomness pinned (anchors, identity dropout), the JAX
    package's init state, the batches; the JAX epochs computed once each."""
    mp = pytest.MonkeyPatch()
    cpc_apply_pair = jax_pipeline.cpc_apply_pair
    mp.setattr(jax_pipeline, "cpc_apply_pair",
               lambda p, a, b, r1, r2, anchors=None: cpc_apply_pair(p, a, b, r1, r2, anchors=ANCHORS))
    mp.setattr(jax_critics, "dropout", lambda key, x, rate, training: x)
    rng = np.random.default_rng(13)
    batch = (
        rng.standard_normal((NB, B, SHAPES[1], SHAPES[0])).astype(np.float32),
        rng.integers(0, SHAPES[2], (NB, B)).astype(np.int32),
        rng.standard_normal((NB, B, SHAPES[4], SHAPES[3])).astype(np.float32),
        rng.integers(0, SHAPES[5], (NB, B)).astype(np.int32),
    )
    jstate = jax_pipeline.StyleTransferPipeline(
        *SHAPES, JaxConfig(**KW, flow=JaxFlow(**FLOW))).init_state(jax.random.PRNGKey(13))
    cache = {}

    def jax_epoch(knob: str, pallas: bool):
        if (knob, pallas) not in cache:
            with pytest.MonkeyPatch.context() as env:
                env.setenv("FLSTTSC_USE_PALLAS", "1" if pallas else "0")
                env.setenv("FLSTTSC_PALLAS_INTERPRET", "1")
                jpipe = jax_pipeline.StyleTransferPipeline(
                    *SHAPES, JaxConfig(**KW, flow=JaxFlow(**FLOW), **KNOBS[knob]))
                new, metrics = jpipe.phase5_epoch(jstate, *map(jnp.asarray, batch),
                                                  jnp.asarray(0))
                cache[knob, pallas] = (_jflat(new["params"]),
                                       {k: np.asarray(v) for k, v in metrics.items()})
        return cache[knob, pallas]

    yield jstate, batch, jax_epoch
    mp.undo()


def _jflat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_pipe(knob: str, **extra):
    cfg = PipelineConfig(**KW, flow=FlowConfig(**FLOW), **KNOBS[knob], **extra)
    return port_pipeline.StyleTransferPipeline(*SHAPES, cfg, device="cpu")


def _port_state(ppipe, jstate):
    models = from_jax_params(_jflat({k: jstate[k] for k in ("params", "mstate", "consts")}))
    return ppipe.training_state(models, seed=0)


def _ones_masks():
    return [[torch.ones(B, 1024), torch.ones(B, 1024)] for _ in range(2)]


def _first_batch(batch):
    bt, lt, bs, ls = (torch.as_tensor(b[0]) for b in batch)
    return bt, lt.long(), bs, ls.long()


def _port_epoch(knob, jstate, batch):
    """The port's phase-5 epoch of ``knob`` from JAX's init state: (flat
    params, metrics)."""
    ppipe = _port_pipe(knob)
    pstate = _port_state(ppipe, jstate)
    metrics = ppipe.phase5_epoch(pstate, *batch, 0, cpc_anchors=ANCHORS,
                                 dropout_masks=_ones_masks())
    return flatten(pstate["params"]), {k: v.numpy() for k, v in metrics.items()}


def _check_metrics(got, want, tol, what):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{what}: metric {k}")


# ------------------------------------------------- (1) merged_pullbacks=False --

def test_unmerged_epoch_matches_jax_and_the_merged_epoch(setup):
    """Six pulls a step (JAX ``train/pipeline.py:745-752``): the port's
    unmerged epoch against JAX's unmerged epoch (XLA path) and against the
    port's merged epoch."""
    jstate, batch, jax_epoch = setup
    _, j_metrics = jax_epoch("unmerged", False)
    params, metrics = _port_epoch("unmerged", jstate, batch)
    _check_metrics(metrics, j_metrics, LOSS_TOL, "port unmerged vs JAX unmerged")
    m_params, m_metrics = _port_epoch("merged", jstate, batch)
    _check_metrics(metrics, m_metrics, EXACT_TOL, "port unmerged vs port merged")
    for k, v in m_params.items():
        np.testing.assert_allclose(params[k], v, **EXACT_TOL, err_msg=k)


def test_unmerged_pulls_six_times(setup):
    """The unmerged step pulls the total and each GradNorm loss alone: the
    WN backward runs once a flow per pull that reaches it (total 2F, t_nf F,
    s_nf F, s2t2s_c 2F: 6F) against the merged 5F; the total's gradients
    are the merged step's, bit for bit, and the trunk norms within 1e-6."""
    jstate, batch, _ = setup
    out = {}
    for knob in ("merged", "unmerged"):
        ppipe = _port_pipe(knob)
        pstate = _port_state(ppipe, jstate)
        wn_fused.reset_launch_counts()
        calls = []
        bwd = wn_fused.wn_bwd_plain

        def counted(*a, **k):
            calls.append(1)
            return bwd(*a, **k)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(wn_fused, "wn_bwd_plain", counted)
            out[knob] = ppipe.phase5_grads(pstate, *_first_batch(batch), 0, ANCHORS,
                                           _ones_masks())
        out[knob] += (len(calls),)
    flows = FLOW["n_flows"]
    assert out["merged"][-1] == 5 * flows and out["unmerged"][-1] == 6 * flows
    for m in port_pipeline.ALL_MODULES:
        for a, b in zip(out["unmerged"][3][m], out["merged"][3][m]):
            assert (a is None and b is None) or torch.equal(a, b), m
    for i in (4, 5):
        np.testing.assert_allclose(out["unmerged"][i].numpy(), out["merged"][i].numpy(), rtol=1e-6)


# -------------------------------------------------- (2) stacked_pullbacks=True --

def test_stacked_epoch_tracks_jax_and_the_unstacked_epoch(setup):
    """The stacked pull (JAX ``train/pipeline.py:715-727``): the port's
    stacked epoch against JAX's stacked epoch (Pallas in interpret mode) and
    against the port's unstacked epoch, JAX's tracking bar."""
    jstate, batch, jax_epoch = setup
    _, j_metrics = jax_epoch("stacked", True)
    _, metrics = _port_epoch("stacked", jstate, batch)
    _check_metrics(metrics, j_metrics, STACKED_TOL, "port stacked vs JAX stacked")
    _, m_metrics = _port_epoch("merged", jstate, batch)
    _check_metrics(metrics, m_metrics, STACKED_TOL, "port stacked vs port unstacked")


def test_stacked_takes_no_effect_unmerged(setup):
    """``stacked_pullbacks=True`` with ``merged_pullbacks=False`` pulls as
    unmerged, as in the JAX package (``train/pipeline.py:700-715``)."""
    jstate, batch, _ = setup
    _, both = _port_epoch("unmerged", jstate, batch)
    ppipe = _port_pipe("unmerged", stacked_pullbacks=True)
    pstate = _port_state(ppipe, jstate)
    metrics = ppipe.phase5_epoch(pstate, *batch, 0, cpc_anchors=ANCHORS,
                                 dropout_masks=_ones_masks())
    for k, v in metrics.items():
        np.testing.assert_array_equal(v.numpy(), both[k], err_msg=k)


# ------------------------------------------------------ (6) K runs at once --

def _l2_rel(got, want):
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want) if b is not None)
    num += sum(float((a ** 2).sum()) for a, b in zip(got, want) if b is None and a is not None)
    den = sum(float((b ** 2).sum()) for b in want if b is not None)
    return (num / den) ** 0.5 if den else num ** 0.5



@pytest.mark.parametrize("knob", ["unmerged", "stacked"])
def test_multirun_pulls_match_one_run_pulls(setup, knob):
    """K = 2 runs of one phase-5 step's pulls under each knob against the two
    runs' own pulls: the losses and n_t, n_s (rtol 1e-5) and every module's
    gradients of the total (relative L2 distance 1e-5), the bars of
    ``test_torch_port_multirun.py`` (under vmap PyTorch's batched ops sum
    in another order), and one K-run epoch's metrics against the two runs' epochs
    (the JAX package's multirun bar, rtol 5e-2, atol 2e-2)."""
    jstate, batch, _ = setup
    ppipe = _port_pipe(knob)
    singles = [ppipe.init_state(torch.Generator().manual_seed(s)) for s in (3, 7)]
    mp = MultiRunStylePipeline(ppipe)
    states = stack_states(singles)
    bt, lt, bs, ls = (torch.as_tensor(np.stack([b[0], b[1]])) for b in batch)
    lt, ls = lt.long(), ls.long()
    losses, _, _, grads, n_t, n_s = mp.phase5_grads(states, bt, lt, bs, ls, 0, ANCHORS,
                                                    _ones_masks())
    for i, st in enumerate(singles):
        l1, _, _, g1, nt1, ns1 = ppipe.phase5_grads(st, bt[i], lt[i], bs[i], ls[i], 0, ANCHORS,
                                                    _ones_masks())
        for k in l1:
            np.testing.assert_allclose(float(losses[k][i].detach()), float(l1[k].detach()),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(n_t[i].numpy(), nt1.numpy(), rtol=1e-5)
        np.testing.assert_allclose(n_s[i].numpy(), ns1.numpy(), rtol=1e-5)
        for m in port_pipeline.ALL_MODULES:
            got = [None if g is None else g[i] for g in grads[m]]
            assert _l2_rel(got, g1[m]) <= 1e-5, m
    xt, yt, xs, ys = (np.stack([b, b]) for b in batch)
    states = stack_states([ppipe.init_state(torch.Generator().manual_seed(s)) for s in (3, 7)])
    m_runs = mp.phase5_epoch(states, xt, yt, xs, ys, 0, ANCHORS, _ones_masks())
    for i, s in enumerate((3, 7)):
        st = ppipe.init_state(torch.Generator().manual_seed(s))
        m_one = ppipe.phase5_epoch(st, *batch, 0, cpc_anchors=ANCHORS, dropout_masks=_ones_masks())
        for k, v in m_one.items():
            np.testing.assert_allclose(m_runs[k][i].numpy(), v.numpy(), rtol=5e-2, atol=2e-2,
                                       err_msg=f"run {i} {k}")


# ---------------------------------------------- (7) batched-cotangent rules --

def _random_wn(seed, h=3, c=8, n_layers=2):
    g = torch.Generator().manual_seed(seed)
    params = wn_init(g, h, n_layers, c)
    params["end"]["weight"] = 0.3 * torch.randn(c, 2 * h, generator=g)
    return [e.detach().requires_grad_(True)
            for e in wn_fused.stack_effective(params, weight_norm_weight)]


def _counting_rule(monkeypatch):
    """Count ``WNBwdCore``'s vmap rule and its cotangent batches."""
    seen = []
    rule = wn_fused.WNBwdCore.vmap

    def counted(info, in_dims, *args):
        seen.append(info.batch_size)
        return rule(info, in_dims, *args)

    monkeypatch.setattr(wn_fused.WNBwdCore, "vmap", staticmethod(counted))
    return seen


@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_wn_backward_takes_a_cotangent_batch_in_one_call(monkeypatch, runs, bf16):
    """``WNCore`` (one run) and ``WNRunCore`` (K = 2 runs, through
    ``WNCore``'s vmap rule) under ``batched_pull`` with 3 cotangents: ONE
    ``WNBwdCore`` rule call for the 3 cotangents (counted, so a silent loop
    over the cotangents cannot pass), whose gradients equal three single
    pulls, each cotangent its own (never summed)."""
    g = torch.Generator().manual_seed(5)
    b, t, h = 2, 7, 3
    x = torch.randn(*((2,) if runs else ()), b, t, h, generator=g).requires_grad_(True)
    if runs:
        effs = [_random_wn(s) for s in (1, 2)]
        eff = [torch.stack(e).detach().requires_grad_(True) for e in zip(*effs)]
        y = torch.func.vmap(lambda xx, *ee: wn_fused.WNCore.apply(xx, *ee, bf16)[0])(x, *eff)
    else:
        eff = _random_wn(1)
        y = wn_fused.WNCore.apply(x, *eff, bf16)[0]
    inputs = [x, *eff]
    cot = torch.randn(3, *y.shape, generator=g)
    seen = _counting_rule(monkeypatch)
    got = batched_pull([y], inputs, [cot])
    assert seen == [3]
    for i in range(3):
        want = torch.autograd.grad(y, inputs, cot[i], retain_graph=True, allow_unused=True)
        for a, w in zip(got, want):
            if w is None:
                assert not a[i].any()
            else:
                torch.testing.assert_close(a[i], w, **RULE_TOL)


def test_tap_conv_dx_folds_the_cotangents_into_one_call(monkeypatch):
    """``TapConvCore``'s input gradient under 3 cotangents: ONE tap conv with
    the cotangents folded into the batch rows (counted at the plain
    version), equal to three single pulls; batched taps (a run axis) take
    the runs form, each run the plain tap conv's bits."""
    g = torch.Generator().manual_seed(6)
    x_pad = torch.randn(2, 13, 4, generator=g).requires_grad_(True)
    w = torch.randn(3, 4, 5, generator=g).requires_grad_(True)
    y = osconv.tap_conv(x_pad, w, 2)
    cot = torch.randn(3, *y.shape, generator=g)
    calls = []
    plain = osconv.tap_conv_plain

    def counted(a, b, d):
        calls.append(a.shape[0])
        return plain(a, b, d)

    monkeypatch.setattr(osconv, "tap_conv_plain", counted)
    got = batched_pull([y], [x_pad, w], [cot])
    assert calls == [3 * 2]  # one call, 3 cotangents x batch 2
    for i in range(3):
        want = torch.autograd.grad(y, [x_pad, w], cot[i], retain_graph=True)
        for a, wv in zip(got, want):
            torch.testing.assert_close(a[i], wv, **RULE_TOL)
    # batched taps (a run axis) take the runs form: each run the plain tap conv's
    gp, wt = torch.randn(2, 2, 13, 5, generator=g), torch.randn(2, 3, 5, 4, generator=g)
    out = torch.func.vmap(lambda a, b: osconv.TapConvDxCore.apply(a, b, 2))(gp, wt)
    for r in range(2):
        torch.testing.assert_close(out[r], plain(gp[r], wt[r], 2), rtol=0, atol=0)


def test_plain_backwards_batch_without_a_loop():
    """The backwards that are plain PyTorch (``OSConvCore``'s transposed
    convs, ``OSConvRunCore``'s per-run CPU form, ``GateCore``,
    ``GradientReversal``) take a cotangent batch through batching rules:
    functorch's per-sample fallback, which warns when enabled, never runs;
    each cotangent's gradient equals its single pull."""
    g = torch.Generator().manual_seed(7)
    x_pad = torch.randn(2, 11, 3, generator=g).requires_grad_(True)
    w = torch.randn(5, 3, 4, generator=g).requires_grad_(True)
    xr = torch.randn(2, 2, 11, 3, generator=g).requires_grad_(True)
    wr = torch.randn(2, 5, 3, 4, generator=g).requires_grad_(True)
    a = torch.randn(2, 6, 8, generator=g).requires_grad_(True)
    bb = torch.randn(2, 6, 8, generator=g).requires_grad_(True)
    outs = [
        gradient_reversal(osconv.OSConvCore.apply(x_pad, w), 0.7),
        torch.func.vmap(osconv.OSConvCore.apply)(xr, wr),
        gate.fused_add_tanh_sigmoid_multiply(a, bb, 4),
    ]
    inputs = [x_pad, w, xr, wr, a, bb]
    cots = [torch.randn(3, *o.shape, generator=g) for o in outs]
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = batched_pull(outs, inputs, cots)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    for i in range(3):
        want = torch.autograd.grad(outs, inputs, [c[i] for c in cots], retain_graph=True)
        for x, wv in zip(got, want):
            torch.testing.assert_close(x[i], wv, **RULE_TOL)
