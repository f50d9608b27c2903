"""The op-by-op WN route (``FLSTTSC_WN_FUSED=0``) under the port's multirun, on the CPU.

The run axes of the route's two kernels' Functions (``ops/osconv.py``
``TapConvCore`` -> ``TapConvRunCore``, ``TapConvDxCore``; ``ops/gate.py``
``GateCore`` -> ``GateRunCore``) under ``torch.func.vmap``, forward and both
gradients, against per-run calls: on the CPU the runs kernel's plain
version runs run by run and the folded gate is one plain call over the
runs' rows, so the forwards are the per-run bits; the gradients go through
batched products (tolerance rtol 1e-5, atol 1e-6).  Then the route under
``MultiRunStylePipeline`` at the geometry of ``tests/test_torch_port_
multirun.py`` (K = 2, seeds 3 and 7; a 2-flow WaveGlow with a 2-layer,
8-channel WN; batch 4), with non-zero WN end projections (0.1 N(0, 1); the
init's zero end zeroes every WN layer gradient):

* one K-run phase-5 step against each run's own step under every
  ``FLSTTSC_CONV_IMPL`` (pallas, conv, im2col) and every pull knob
  (merged, unmerged, stacked), at that file's step tolerances (losses rtol
  1e-5, atol 1e-6; each module's gradients within relative L2 1e-5);
* one K = 2 phase-5 epoch with ``FLSTTSC_CONV_IMPL=pallas`` against JAX's
  ``MultiRunStylePipeline`` with ``FLSTTSC_WN_FUSED=0`` and
  ``FLSTTSC_CONV_IMPL=pallas`` (its Pallas kernels in interpret mode), from
  the same JAX-made states, with the batch orders JAX draws and the
  randomness pinned as ``tests/test_torch_port_multirun_jax.py`` pins it,
  at its tolerance (rtol 1e-4, atol 1e-5);
* the stacked pulls of that epoch's first step against the port's
  unstacked ones (losses and trunk norms rtol 1e-5, atol 1e-6; each
  module's gradients within relative L2 1e-5).

The kernels themselves (``tap_conv_fwd_runs``, its host split at the grid's
limit, the folded ``gate_fwd``) are checked on a card by the ``gpu`` tests
of ``tests/test_torch_port_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_multirun import SEEDS, _l2_rel, as_multirun_data, make_pair
from test_torch_port_multirun_jax import (
    ANCHORS,
    FLOW,
    KW,
    SHAPES,
    flat_runs,
    jax_perms,
    stacked_batches,
)

from feature_level_style_transfer_for_tsc_tpu.config import FlowConfig as JaxFlow
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.models import critics as jax_critics
from feature_level_style_transfer_for_tsc_tpu.train import multirun as jax_multirun
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv
from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
    MultiRunData,
    MultiRunStylePipeline,
    stack_states,
    unstack_state,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import (
    ALL_MODULES,
    StyleTransferPipeline,
    batched_pull,
)

OP_BY_OP = {"FLSTTSC_WN_FUSED": "0", "FLSTTSC_CONV_IMPL": "pallas"}
B = KW["batch_size"]
RULE_TOL = {"rtol": 1e-5, "atol": 1e-6}
STEP_LOSS_TOL = {"rtol": 1e-5, "atol": 1e-6}
STEP_GRAD_L2_TOL = 1e-5
JAX_TOL = {"rtol": 1e-4, "atol": 1e-5}
WN_END_SCALE = 0.1
KNOBS = {"merged": {}, "unmerged": {"merged_pullbacks": False},
         "stacked": {"stacked_pullbacks": True}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counting(monkeypatch, module, name):
    """``module.name`` wrapped to record the shape of each call's first argument."""
    calls = []
    fn = getattr(module, name)

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return fn(*args)

    monkeypatch.setattr(module, name, counted)
    return calls


# ------------------------------------------------------------- run axes ----

@pytest.mark.parametrize("d", [1, 2, 4])
def test_tap_conv_runs_under_vmap_match_per_run_calls(d, monkeypatch):
    """``tap_conv`` under ``torch.func.vmap`` over K = 3 runs is ONE
    ``TapConvRunCore`` call (one ``tap_conv_runs``: the plain version run by
    run here, ``tap_conv_fwd_runs`` on a card): its forward the per-run
    bits, x's and w's gradients those of per-run calls; the backward's dx is
    one runs call too."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn(3, 2, 5 + 2 * d, 4, generator=g, requires_grad=True)
    w = torch.randn(3, 3, 4, 6, generator=g, requires_grad=True)
    runs = _counting(monkeypatch, osconv, "tap_conv_runs")
    y = torch.func.vmap(lambda a, b: osconv.tap_conv(a, b, d))(x, w)
    assert runs == [tuple(x.shape)]
    cot = torch.randn(y.shape, generator=g)
    gx, gw = torch.autograd.grad(y, [x, w], cot)
    assert len(runs) == 2 and runs[1][0] == 3  # dx: the runs tap conv of the padded g
    for r in range(3):
        x1, w1 = x[r].detach().requires_grad_(), w[r].detach().requires_grad_()
        y1 = osconv.tap_conv(x1, w1, d)
        assert torch.equal(y[r], y1)
        for got, want in zip((gx[r], gw[r]), torch.autograd.grad(y1, [x1, w1], cot[r])):
            torch.testing.assert_close(got, want, **RULE_TOL)


def test_gate_under_vmap_is_one_call_over_the_runs_rows(monkeypatch):
    """``GateCore`` under ``torch.func.vmap`` over K = 3 runs: ONE gate call
    over the runs folded into the rows (``GateRunCore``, counted as
    ``gate_fwd_runs`` on a card), b a column slice of a stacked projection
    (a row-strided view, kept) and an unbatched a (expanded); the per-run
    bits forward, and both gradients those of per-run calls."""
    g = torch.Generator().manual_seed(4)
    a = torch.randn(5, 6, 8, generator=g, requires_grad=True)
    proj = torch.randn(3, 5, 6, 24, generator=g, requires_grad=True)
    calls = _counting(monkeypatch, gate, "gate_plain")
    y = torch.func.vmap(lambda b: gate.fused_add_tanh_sigmoid_multiply(a, b[..., 8:16], 4))(proj)
    assert calls == [(3, 5, 6, 8)]
    cot = torch.randn(y.shape, generator=g)
    ga, gp = torch.autograd.grad(y, [a, proj], cot)
    want_a = torch.zeros_like(a)
    for r in range(3):
        p1 = proj[r].detach().requires_grad_()
        a1 = a.detach().requires_grad_()
        y1 = gate.fused_add_tanh_sigmoid_multiply(a1, p1[..., 8:16], 4)
        assert torch.equal(y[r], y1)
        d_a, d_p = torch.autograd.grad(y1, [a1, p1], cot[r])
        want_a += d_a
        torch.testing.assert_close(gp[r], d_p, **RULE_TOL)
    torch.testing.assert_close(ga, want_a, **RULE_TOL)


def test_gate_vmap_rule_keeps_row_strided_views():
    """The vmap rule hands the forward its runs-first operands: a runs-first
    column slice of a stacked projection keeps its row-strided (M, 2n) view
    (no copy), an expanded unbatched operand has none (the forward copies
    it)."""
    proj = torch.randn(3, 5, 6, 24)
    assert gate._rows(proj[..., 8:16], 4) is not None
    assert gate._rows(torch.randn(5, 6, 8).expand(3, 5, 6, 8), 4) is None


def test_tap_conv_dx_with_batched_taps():
    """``TapConvDxCore`` under vmap with batched taps (one run's form) takes
    the runs form, and nested over a runs form joins the run axes: each
    slice the plain tap conv's."""
    g = torch.Generator().manual_seed(5)
    gp, wt = torch.randn(2, 3, 13, 5, generator=g), torch.randn(2, 3, 5, 4, generator=g)
    out = torch.func.vmap(lambda a, b: osconv.TapConvDxCore.apply(a, b, 2))(gp, wt)
    for r in range(2):
        torch.testing.assert_close(out[r], osconv.tap_conv_plain(gp[r], wt[r], 2), rtol=0, atol=0)
    gp2, wt2 = torch.randn(2, 3, 2, 13, 5, generator=g), torch.randn(2, 3, 3, 5, 4, generator=g)
    out = torch.func.vmap(lambda a, b: osconv.TapConvDxCore.apply(a, b, 2))(gp2, wt2)
    for n in range(2):
        for r in range(3):
            torch.testing.assert_close(out[n, r], osconv.tap_conv_plain(gp2[n, r], wt2[n, r], 2),
                                       rtol=0, atol=0)


def test_cotangent_batch_over_runs_folds_into_each_runs_rows(monkeypatch):
    """A batched pull (3 cotangents) of K = 2 runs' tap conv: dx is ONE runs
    call with the cotangents folded into each run's batch rows (3 x 2 rows
    a run), and every gradient equals its single pull."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 2, 13, 4, generator=g, requires_grad=True)
    w = torch.randn(2, 3, 4, 5, generator=g, requires_grad=True)
    y = torch.func.vmap(lambda a, b: osconv.tap_conv(a, b, 2))(x, w)
    cot = torch.randn(3, *y.shape, generator=g)
    runs = _counting(monkeypatch, osconv, "tap_conv_runs")
    got = batched_pull([y], [x, w], [cot])
    assert runs == [(2, 3 * 2, 17, 5)]
    for i in range(3):
        want = torch.autograd.grad(y, [x, w], cot[i], retain_graph=True)
        for a_, w_ in zip(got, want):
            torch.testing.assert_close(a_[i], w_, **RULE_TOL)


@pytest.mark.parametrize("runs, batch, limit, want", [
    (8, 60, 65535, [(0, 8)]),
    (8, 9000, 65535, [(0, 7), (7, 8)]),
    (5, 3, 7, [(0, 2), (2, 4), (4, 5)]),
    (1, 65535, 65535, [(0, 1)]),
])
def test_run_chunks_split_at_the_grid_limit(runs, batch, limit, want):
    """``run_chunks``: the run ranges of the ``tap_conv_fwd_runs`` calls,
    each within the grid's z limit (runs x batch <= limit), in order and
    covering every run; a batch beyond the limit is refused."""
    got = osconv.run_chunks(runs, batch, limit)
    assert got == want
    assert all((stop - start) * batch <= limit for start, stop in got)
    with pytest.raises(ValueError, match="exceeds the grid"):
        osconv.run_chunks(runs, limit + 1, limit)


# ---------------------------------------------------- the multirun route --

def _pipe(**knobs):
    return StyleTransferPipeline(*SHAPES, PipelineConfig(**KW, flow=FlowConfig(**FLOW), **knobs),
                                 device="cpu")


@torch.no_grad()
def _with_wn_ends(states, seed: int = 9):
    """Non-zero WN end projections in a stacked state (in place)."""
    g = torch.Generator().manual_seed(seed)
    for wn in states["params"]["nf"]["wn"]:
        wn["end"]["weight"].copy_(WN_END_SCALE * torch.randn(wn["end"]["weight"].shape,
                                                            generator=g))
    return states


def _batch(pairs):
    bt = torch.stack([torch.as_tensor(p[0].x[:B]) for p in pairs])
    lt = torch.stack([torch.as_tensor(p[0].y[:B]).long() for p in pairs])
    bs = torch.stack([torch.as_tensor(p[2].x[:B]) for p in pairs])
    ls = torch.stack([torch.as_tensor(p[2].y[:B]).long() for p in pairs])
    return bt, lt, bs, ls


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("impl", ["pallas", "conv", "im2col"])
def test_k_run_step_matches_single_run_steps(impl, knob, monkeypatch):
    """One K = 2 phase-5 step on the op-by-op route under each
    ``FLSTTSC_CONV_IMPL`` and pull knob against each run's own step from the
    same state: losses, trunk norms and every module's gradients; under
    ``pallas`` the runs' tap convs go through ``tap_conv_runs``."""
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0")
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", impl)
    pipe = _pipe(**KNOBS[knob])
    mp = MultiRunStylePipeline(pipe)
    states = _with_wn_ends(mp.init_states(SEEDS))
    singles = [unstack_state(states, i) for i in range(len(SEEDS))]
    pairs = [make_pair(s) for s in SEEDS]
    bt, lt, bs, ls = _batch(pairs)
    masks = [[torch.ones(B, 1024)] * 2] * 2
    runs = _counting(monkeypatch, osconv, "tap_conv_runs")
    losses, _, _, grads, n_t, n_s = mp.phase5_grads(states, bt, lt, bs, ls, 0, ANCHORS, masks)
    assert bool(runs) == (impl == "pallas")
    for i, st in enumerate(singles):
        l1, _, _, g1, nt1, ns1 = pipe.phase5_grads(st, bt[i], lt[i], bs[i], ls[i], 0, ANCHORS, masks)
        for k in l1:
            np.testing.assert_allclose(float(losses[k][i].detach()), float(l1[k].detach()),
                                       **STEP_LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(n_t[i].numpy(), nt1.numpy(), rtol=1e-5)
        np.testing.assert_allclose(n_s[i].numpy(), ns1.numpy(), rtol=1e-5)
        for m in ALL_MODULES:
            got = [None if g is None else g[i] for g in grads[m]]
            assert _l2_rel(got, g1[m]) <= STEP_GRAD_L2_TOL, (m, _l2_rel(got, g1[m]))


@pytest.fixture(scope="module")
def jax_epoch():
    """JAX's multirun phase-5 epoch on the op-by-op route (its Pallas gate and
    tap conv in interpret mode), from its ``init_states`` with non-zero WN
    end projections: (each run's state flattened, the epoch's permutations,
    JAX's metrics, the data)."""
    mp = pytest.MonkeyPatch()
    cpc_apply, cpc_apply_pair = jax_pipeline.cpc_apply, jax_pipeline.cpc_apply_pair
    mp.setattr(jax_pipeline, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHORS[0]))
    mp.setattr(jax_pipeline, "cpc_apply_pair",
               lambda p, a, b, r1, r2, anchors=None: cpc_apply_pair(p, a, b, r1, r2, anchors=ANCHORS))
    mp.setattr(jax_critics, "dropout", lambda key, x, rate, training: x)
    for k, v in {**OP_BY_OP, "FLSTTSC_USE_PALLAS": "1", "FLSTTSC_PALLAS_INTERPRET": "1"}.items():
        mp.setenv(k, v)
    pairs = [make_pair(s) for s in SEEDS]
    splits = [{"t_train": (d[0].x, d[0].y), "t_test": (d[1].x, d[1].y),
               "s_train": (d[2].x, d[2].y), "s_test": (d[3].x, d[3].y)} for d in pairs]
    jpipe = jax_pipeline.StyleTransferPipeline(*SHAPES, JaxConfig(**KW, flow=JaxFlow(**FLOW)))
    jm = jax_multirun.MultiRunStylePipeline(jpipe)
    data = jax_multirun.MultiRunData.from_pairs(splits)
    states = jm.init_states(list(SEEDS))
    rng = np.random.default_rng(9)
    nf = dict(states["params"]["nf"])
    nf["wn"] = [{**wn, "end": {"weight": jnp.asarray(WN_END_SCALE * rng.standard_normal(
        wn["end"]["weight"].shape).astype(np.float32)), "bias": wn["end"]["bias"]}}
        for wn in nf["wn"]]
    states = {**states, "params": {**states["params"], "nf": nf}}
    epochs = {"p1": 0, "p2": 0, "p3": 0, "p4": 0, "p5": 1}
    perms = [jax_perms(s, p, epochs) for s, p in zip(SEEDS, pairs)]
    skeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(np.asarray(SEEDS) + 1))
    _, sks = jm._split(skeys)
    before = flat_runs(states, len(SEEDS))
    try:  # traced and run here: the patches and variables are read at trace time
        _, m = jm._p5(states, *data.t_train, *data.s_train, sks, jnp.asarray(0))
    finally:
        mp.undo()
    return before, perms, {k: np.asarray(v) for k, v in m.items()}, splits


def _port_epoch(jax_epoch, **knobs):
    """The port's K-run phase-5 epoch on the op-by-op route from JAX's
    states over JAX's batches, each step's pulls recorded."""
    before, perms, _, splits = jax_epoch
    pipe = _pipe(**knobs)
    mp = MultiRunStylePipeline(pipe)
    data = MultiRunData.from_pairs(splits)
    states = stack_states([pipe.state_from_flat(f) for f in before])
    xt, yt = stacked_batches(data.t_train, [p[0] for p in perms], B)
    xs, ys = stacked_batches(data.s_train, [p[1] for p in perms], B)
    nb = min(xt.shape[1], xs.shape[1])
    pulls = []
    grads_fn = mp.phase5_grads

    def record(*args, **kw):
        out = grads_fn(*args, **kw)
        pulls.append(out)
        return out

    mp.phase5_grads = record
    ones = [[torch.ones(B, 1024)] * 2] * 2
    metrics = mp.phase5_epoch(states, xt[:, :nb], yt[:, :nb], xs[:, :nb], ys[:, :nb], 0, ANCHORS,
                              ones)
    return metrics, pulls


def test_op_by_op_epoch_matches_jax_multirun(jax_epoch, monkeypatch):
    """One K = 2 phase-5 epoch on the op-by-op route
    (``FLSTTSC_CONV_IMPL=pallas``) against JAX's multirun on the same route
    from the same states: every metric of each run."""
    for k, v in OP_BY_OP.items():
        monkeypatch.setenv(k, v)
    runs = _counting(monkeypatch, osconv, "tap_conv_runs")
    got, _ = _port_epoch(jax_epoch)
    assert runs
    want = jax_epoch[2]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, **JAX_TOL, err_msg=k)


def test_op_by_op_stacked_pulls_match_unstacked(jax_epoch, monkeypatch):
    """The first step of that epoch with ``stacked_pullbacks=True`` against
    the port's unstacked step from the same state: the losses, trunk norms
    and every module's gradients of each run.  (The epoch's second step
    starts from states that the first step's noise-level updates moved
    apart: RMSprop's first step moves a weight by about 10 lr whatever its
    gradient's size.)"""
    for k, v in OP_BY_OP.items():
        monkeypatch.setenv(k, v)
    _, p0 = _port_epoch(jax_epoch)
    _, p1 = _port_epoch(jax_epoch, stacked_pullbacks=True)
    (l0, _, _, g0, nt0, ns0), (l1, _, _, g1, nt1, ns1) = p0[0], p1[0]
    for k in l0:
        np.testing.assert_allclose(l1[k].detach().numpy(), l0[k].detach().numpy(),
                                   **STEP_LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(nt1.numpy(), nt0.numpy(), **STEP_LOSS_TOL)
    np.testing.assert_allclose(ns1.numpy(), ns0.numpy(), **STEP_LOSS_TOL)
    for m in ALL_MODULES:
        for i in range(len(SEEDS)):
            got = [None if g is None else g[i] for g in g1[m]]
            want = [None if g is None else g[i] for g in g0[m]]
            assert _l2_rel(got, want) <= STEP_GRAD_L2_TOL, (m, i, _l2_rel(got, want))
