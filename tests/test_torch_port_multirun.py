"""The port's multi-run training (``train/multirun.py``) on the CPU.

K = 2 runs (seeds 3 and 7) of the JAX package's ``tests/test_multirun.py``
geometry (target 2 x 16, 2 classes; source 1 x 12, 3 classes; batch 4; a
2-flow WaveGlow with a 2-layer, 8-channel WN; ``budget_multiplier=0.02``).
On the CPU the run-axis Functions run the plain versions run by run, so a
K-run differs from K runs in turn only where ``torch.func.vmap`` batches
PyTorch's own ops (a batched product, the backward of a broadcast), which
sums in another order.

Tolerances:

* one step from the same states (every phase): losses rtol 1e-5, atol
  1e-6 (measured: equal, or 2.1e-6 relative for the CDAN loss, a
  difference of two sums); each module's gradients within 1e-5 relative L2
  distance per run (measured <= 4.3e-7);
* a whole curriculum against the same runs in turn: phases 1-2 rtol 1e-4,
  atol 1e-5, the parity tests' (measured <= 1.5e-5 relative); phases 3-4
  rtol and atol 5e-3 (measured <= 9.3e-4 absolute): the OS convs' biases
  feed a training-mode BatchNorm, so their gradient is zero up to
  rounding, and RMSprop's first step moves each by about 10 lr in the
  direction of that rounding, which the batched sums flip, from the second
  batch on; phase 5 the JAX package's own multirun tolerance (rtol 5e-2, atol
  2e-2, ``tests/test_multirun.py``), for the same reason there.  The
  evaluation is checked on one state instead (the same accuracies as the
  single run's evaluation of each unstacked run, exactly);
* the stacked optimizers against ``torch.optim``, run by run: the same bits.
"""

import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_dataset
from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.ops.grl import gradient_reversal
from feature_level_style_transfer_for_tsc_tpu_torch.train import jax_state
from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
    MultiRunData,
    MultiRunStylePipeline,
    stack_states,
    unstack_state,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.optim import (
    StackedAdam,
    StackedRMSprop,
    make_adam,
    make_rmsprop,
    set_lr,
    stack_optimizers,
    unstack_optimizer,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import (
    ALL_MODULES,
    StyleTransferPipeline,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves

SEEDS = (3, 7)
EPOCHS = {"p1": 1, "p2": 1, "p3": 2, "p4": 2, "p5": 1}
KW = dict(batch_size=4, max_kernel_size=5, cdan_dim=32, cpc_hidden=8, budget_multiplier=0.02,
          eval_every=1)
FLOW = dict(n_flows=2, wn_channels=8, wn_layers=2)
SHAPES = (2, 16, 2, 1, 12, 3)
B = 4
STEP_LOSS_TOL = {"rtol": 1e-5, "atol": 1e-6}
STEP_GRAD_L2_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_pair(seed):
    td, sd = {}, {}
    return (
        make_dataset(10, 2, 16, 2, seed=seed, label_dict=td),
        make_dataset(8, 2, 16, 2, seed=seed + 50, label_dict=td),
        make_dataset(10, 1, 12, 3, seed=seed + 100, label_dict=sd),
        make_dataset(8, 1, 12, 3, seed=seed + 150, label_dict=sd),
    )


def as_multirun_data(pairs):
    return MultiRunData.from_pairs([
        {"t_train": (d[0].x, d[0].y), "t_test": (d[1].x, d[1].y),
         "s_train": (d[2].x, d[2].y), "s_test": (d[3].x, d[3].y)} for d in pairs
    ])


@pytest.fixture(scope="module")
def pipe():
    return StyleTransferPipeline(*SHAPES, PipelineConfig(**KW, flow=FlowConfig(**FLOW)),
                                 device="cpu")


@pytest.fixture(scope="module")
def pairs():
    return [make_pair(s) for s in SEEDS]


@pytest.fixture(scope="module")
def trained(pipe, pairs):
    """One K-run curriculum and the same two runs in turn."""
    seq = [pipe.run(*p, epochs=EPOCHS, verbose=False, pretrain_eval_every=0, seed=s)
           for s, p in zip(SEEDS, pairs)]
    mp = MultiRunStylePipeline(pipe)
    states, history = mp.run(as_multirun_data(pairs), SEEDS, epochs=EPOCHS)
    return mp, states, history, seq


def _l2_rel(got, want):
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want) if b is not None)
    den = sum(float((b ** 2).sum()) for b in want if b is not None)
    return (num / den) ** 0.5 if den else num ** 0.5


# ------------------------------------------------------------ (a) states --

def test_stack_unstack_round_trip(pipe):
    """A stacked state unstacks to its runs, bit for bit (fresh, and after
    training, where the optimizers, GradNorm and plateau states hold
    something), and an unstacked run's ``state_to_flat`` loads into the
    single-run pipeline, which continues it.  (That it has every key of the
    JAX package's ``unstack_state`` is checked in
    ``test_torch_port_multirun_jax.py``, which makes the JAX states.)"""
    sts = [pipe.init_state(torch.Generator().manual_seed(s)) for s in SEEDS]
    stacked = stack_states(sts)
    for i, st in enumerate(sts):
        got, want = jax_state.state_to_flat(unstack_state(stacked, i)), jax_state.state_to_flat(st)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    mp = MultiRunStylePipeline(pipe)
    pair = make_pair(SEEDS[0])
    data = as_multirun_data([pair, pair])
    xt = np.stack([pair[0].x[: 2 * B].reshape(2, B, 16, 2)] * 2)
    yt = np.stack([pair[0].y[: 2 * B].reshape(2, B)] * 2)
    xs = np.stack([pair[2].x[: 2 * B].reshape(2, B, 12, 1)] * 2)
    ys = np.stack([pair[2].y[: 2 * B].reshape(2, B)] * 2)
    mp.phase1_epoch(stacked, xt, yt)
    mp.phase5_epoch(stacked, xt, yt, xs, ys, 0)
    runs = [unstack_state(stacked, i) for i in range(2)]
    again = stack_states(runs)
    for i in range(2):
        got = jax_state.state_to_flat(unstack_state(again, i))
        want = jax_state.state_to_flat(runs[i])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert runs[0]["opt"]["cpc"].state  # the optimizers stepped
    assert not np.array_equal(got["['params']['t_ext']['res']['weight']"],
                              jax_state.state_to_flat(sts[1])["['params']['t_ext']['res']['weight']"])

    flat = pipe.state_to_flat(runs[1])
    # the run continues in the single-run pipeline from its file layout
    resumed = pipe.state_from_flat(flat)
    metrics = pipe.phase5_epoch(resumed, xt[0], yt[0], xs[0], ys[0], 1)
    assert all(np.isfinite(v.numpy()).all() for v in metrics.values())


# --------------------------------------------------- (b) runs in turn ------

def test_multirun_matches_runs_in_turn(trained):
    """K runs at once against the same runs in turn, every epoch's metrics
    (tolerances in the module docstring); histories of (K,) arrays."""
    _, _, history, seq = trained
    for i, (_, seq_hist) in enumerate(seq):
        assert [(r["phase"], r["epoch"]) for r in seq_hist] == [(r["phase"], r["epoch"])
                                                                 for r in history]
        for a, b in zip(seq_hist, history):
            tol = {"p1": (1e-4, 1e-5), "p2": (1e-4, 1e-5), "p3": (5e-3, 5e-3),
                   "p4": (5e-3, 5e-3), "p5": (5e-2, 2e-2)}.get(a["phase"])
            for k, v in b.items():
                if k in ("phase", "epoch"):
                    continue
                assert v.shape[0] == len(SEEDS), k
                if tol:
                    np.testing.assert_allclose(v[i], np.asarray(a[k]), rtol=tol[0], atol=tol[1],
                                               err_msg=f"run {i} {a['phase']}#{a['epoch']} {k}")
    p5 = [r for r in history if r["phase"] == "p5"]
    assert p5[0]["t_c"].shape == (2,) and p5[0]["gradnorm_w_t"].shape == (2, 2)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_evaluation_matches_single_runs(trained, pipe, pairs, fused, monkeypatch):
    """The vmapped evaluation (fused inference, and with the folded BatchNorm
    in ``os_conv_fused_runs``) gives each run the single run's accuracy on
    the unstacked state, exactly."""
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", fused)
    mp, states, _, _ = trained
    data = as_multirun_data(pairs)
    for split, t_or_s in (("t_test", "target"), ("s_train", "source")):
        x, y = getattr(data, split)
        got = getattr(mp, f"evaluate_{t_or_s}")(states, x, y)
        for i in range(len(SEEDS)):
            one = unstack_state(states, i)
            assert got[i] == getattr(pipe, f"evaluate_{t_or_s}")(one, x[i], y[i])


# ------------------------------------------------- one step of each phase --

def _phase_grads(fn, params, names):
    return torch.autograd.grad(fn(), [p for n in names for p in leaves(params[n])],
                               allow_unused=True)


@pytest.mark.parametrize("phase", ["p1", "p2", "p3", "p3u", "p4", "p4u", "p5"])
def test_one_step_matches_single_run_steps(pipe, pairs, phase):
    """One step of every phase (both branches of phases 3 and 4), K runs at
    once from the runs' init states, against each run's own step: the
    losses and every module's gradients (``STEP_*_TOL``)."""
    mp = MultiRunStylePipeline(pipe)
    states = mp.init_states(SEEDS)
    singles = [pipe.init_state(torch.Generator().manual_seed(s)) for s in SEEDS]
    bt = torch.stack([torch.as_tensor(p[0].x[:B]) for p in pairs])
    lt = torch.stack([torch.as_tensor(p[0].y[:B]).long() for p in pairs])
    bs = torch.stack([torch.as_tensor(p[2].x[:B]) for p in pairs])
    ls = torch.stack([torch.as_tensor(p[2].y[:B]).long() for p in pairs])
    anchors = (1, 2)
    runs_anchors = torch.tensor([anchors] * 2)
    masks = [[(torch.rand(B, 1024, generator=torch.Generator().manual_seed(2 * c + j)) >= 0.2)
              .float() / 0.8 for j in range(2)] for c in range(2)]
    sup = not phase.endswith("u")
    if phase == "p5":
        losses, _, _, grads, n_t, n_s = mp.phase5_grads(states, bt, lt, bs, ls, 0, anchors, masks)
        for i, st in enumerate(singles):
            l1, _, _, g1, nt1, ns1 = pipe.phase5_grads(st, bt[i], lt[i], bs[i], ls[i], 0, anchors,
                                                       masks)
            for k in l1:
                np.testing.assert_allclose(float(losses[k][i].detach()), float(l1[k].detach()),
                                           **STEP_LOSS_TOL, err_msg=k)
            np.testing.assert_allclose(n_t[i].numpy(), nt1.numpy(), rtol=1e-5)
            np.testing.assert_allclose(n_s[i].numpy(), ns1.numpy(), rtol=1e-5)
            for m in ALL_MODULES:
                got = [None if g is None else g[i] for g in grads[m]]
                assert _l2_rel(got, g1[m]) <= STEP_GRAD_L2_TOL, m
        return
    forward, batch, names = {
        "p1": (pipe._phase1_forward, (bt, lt), ("t_ext", "t_cls", "cpc")),
        "p2": (pipe._phase2_forward, (bs, ls), ("s_ext", "dim_uni", "s_cls")),
        "p3": (pipe._phase3_forward, (bt, lt, bs, ls), pipe._phase3_names(sup)),
        "p3u": (pipe._phase3_forward, (bt, lt, bs, ls), pipe._phase3_names(sup)),
        "p4": (pipe._phase4_forward, (bt, lt, bs, ls), pipe._phase4_names(sup)[0]),
        "p4u": (pipe._phase4_forward, (bt, lt, bs, ls), pipe._phase4_names(sup)[0]),
    }[phase]
    extra = {} if phase in ("p1", "p2") else {"supervised": sup}
    args = {"p1": (runs_anchors[:, :1],), "p2": ()}.get(phase, (runs_anchors,))

    def runs_forward(params, mstate, consts, *rest):
        return forward(params, mstate, consts, *rest, **extra)

    losses, _ = mp._vmapped(runs_forward, states, *batch, *args)
    grads = _phase_grads(lambda: losses["total"].sum(), states["params"], names)
    for i, st in enumerate(singles):
        one_args = {"p1": ((anchors[0],),), "p2": ()}.get(phase, (anchors,))
        l1, _ = forward(st["params"], st["mstate"], st["consts"], *(b[i] for b in batch),
                        *one_args, **extra)
        for k in l1:
            np.testing.assert_allclose(float(losses[k][i].detach()), float(l1[k].detach()),
                                           **STEP_LOSS_TOL,
                                       err_msg=k)
        g1 = _phase_grads(lambda: l1["total"], st["params"], names)
        got = [None if g is None else g[i] for g in grads]
        assert _l2_rel(got, g1) <= STEP_GRAD_L2_TOL


# ------------------------------------------------------ (d) vmap rules -----

def test_vmap_rules_match_per_run_calls():
    """``OSConvCore``, ``OSConvFusedCore``, ``WNCore`` and
    ``GradientReversal`` under ``torch.func.vmap`` over 3 runs against the
    same Functions run by run, values and gradients (taken outside the
    transform); the run-axis conv's grouped backward (the CUDA one) against
    the per-run backward the CPU takes."""
    runs, b, t, k, c_in, c_out = 3, 2, 9, 5, 3, 10
    g = torch.Generator().manual_seed(0)
    x_pad = torch.randn(runs, b, t + k - 1, c_in, generator=g).requires_grad_(True)
    w = torch.randn(runs, k, c_in, c_out, generator=g).requires_grad_(True)
    scale, shift = torch.rand(runs, c_out, generator=g) + 0.5, torch.randn(runs, c_out, generator=g)
    xw = torch.randn(runs, b, t, 3, generator=g).requires_grad_(True)
    from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
    from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import wn_init

    effs = []
    for r in range(runs):
        params = wn_init(torch.Generator().manual_seed(r), 3, 2, 8)
        params["end"]["weight"] = 0.3 * torch.randn(8, 6, generator=g)
        effs.append(wn_fused.stack_effective(params, weight_norm_weight))
    eff = [torch.stack(e).detach().requires_grad_(True) for e in zip(*effs)]
    coeff = 0.7

    def runs_fn(x_pad, w, xw, *eff):
        y = osconv.OSConvCore.apply(x_pad, w)
        z = wn_fused.WNCore.apply(xw, *eff, False)[0]
        return torch.sin(gradient_reversal(y, coeff)), torch.sin(z)

    y, z = torch.func.vmap(runs_fn)(x_pad, w, xw, *eff)
    ins = [x_pad, w, xw] + eff
    grads = torch.autograd.grad(y.sum() + z.sum(), ins)
    for r in range(runs):
        one = [a[r].detach().requires_grad_(True) for a in ins]
        y1, z1 = runs_fn(*one)
        torch.testing.assert_close(y[r], y1, rtol=0, atol=0)
        torch.testing.assert_close(z[r], z1, rtol=0, atol=0)
        for got, want in zip(grads, torch.autograd.grad(y1.sum() + z1.sum(), one)):
            torch.testing.assert_close(got[r], want, rtol=1e-5, atol=1e-6)
    with torch.inference_mode():
        fused = torch.func.vmap(lambda *a: osconv.OSConvFusedCore.apply(*a, True))(
            x_pad.detach(), w.detach(), scale, shift)
        for r in range(runs):
            assert torch.equal(fused[r], osconv.os_conv_fused(x_pad[r].detach(), w[r].detach(),
                                                              scale[r], shift[r], True))
    gy = torch.randn(runs, b, t, c_out, generator=g)
    grouped = osconv.os_conv_runs_bwd_grouped(x_pad.detach(), w.detach(), gy, True, True)
    for r in range(runs):
        dx, dw = osconv._os_conv_bwd(x_pad[r].detach(), w[r].detach(), gy[r], True, True)
        torch.testing.assert_close(grouped[0][r], dx, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(grouped[1][r], dw, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ (e) no fallback ----

def test_op_by_op_route_raises_under_vmap(pipe, pairs, monkeypatch):
    """``TapConvCore`` and ``GateCore`` have run axes now: under vmap each
    is ONE call of its runs form (``tap_conv_runs``, ``GateRunCore``) with
    the per-run bits, and a multirun on the op-by-op WN route
    (``FLSTTSC_WN_FUSED=0``, ``FLSTTSC_CONV_IMPL=pallas``) trains an NF
    pretrain epoch through them, with finite metrics, no longer raising
    ``NotImplementedError`` (``tests/test_torch_port_multirun_opbyop.py``
    holds the route against JAX); a pipeline on the default device needs
    CUDA."""
    x = torch.randn(2, 3, 12, 4)
    w = torch.randn(2, 3, 4, 4)
    y = torch.func.vmap(lambda a, b: osconv.tap_conv(a, b, 2))(x, w)
    a = torch.randn(2, 5, 8)
    z = torch.func.vmap(lambda a, b: gate.fused_add_tanh_sigmoid_multiply(a, b, 4))(a, a)
    for r in range(2):
        assert torch.equal(y[r], osconv.tap_conv_plain(x[r], w[r], 2))
        assert torch.equal(z[r], gate.gate_plain(a[r], a[r], 4))
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0")
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", "pallas")
    runs = []
    tap_runs = osconv.tap_conv_runs
    monkeypatch.setattr(osconv, "tap_conv_runs", lambda *args: runs.append(1) or tap_runs(*args))
    mp = MultiRunStylePipeline(pipe)
    _, history = mp.run(as_multirun_data(pairs), SEEDS,
                        epochs={"p1": 0, "p2": 0, "p3": 0, "p4": 1, "p5": 0})
    assert runs and history[-1]["phase"] == "p4"
    assert all(np.isfinite(v).all() for k, v in history[-1].items() if k not in ("phase", "epoch"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StyleTransferPipeline(*SHAPES, PipelineConfig(**KW, flow=FlowConfig(**FLOW)))


# ------------------------------------------------- (f) stacked optimizers --

@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_stacked_optimizers_match_torch(kind):
    """``StackedRMSprop`` / ``StackedAdam`` over stacked leaves against one
    ``torch.optim`` optimizer a run, two different learning rates, then new
    ones (a plateau's cut), over 4 steps: the same bits; and the stacked
    moments unstack to torch optimizers that go on stepping alike."""
    g = torch.Generator().manual_seed(1)
    shapes = [(3, 4), (5,), ()]
    singles = [[torch.randn(s, generator=g) for s in shapes] for _ in range(2)]
    stacked = [torch.stack([singles[0][j], singles[1][j]]).clone() for j in range(len(shapes))]
    make, cls = (make_rmsprop, StackedRMSprop) if kind == "rmsprop" else (make_adam, StackedAdam)
    lrs = [1e-3, 3e-4]
    torch_opts = [make(ps, lr) for ps, lr in zip(singles, lrs)]
    opt = cls(stacked, lrs, 2)
    for step in range(4):
        if step == 2:
            lrs = [5e-4, 2e-3]
            for o, lr in zip(torch_opts, lrs):
                set_lr(o, lr)
            set_lr(opt, lrs)
        grads = [torch.randn(2, *s, generator=g) for s in shapes]
        for r in range(2):
            for p, gr in zip(singles[r], grads):
                p.grad = gr[r].clone()
            torch_opts[r].step()
        for p, gr in zip(stacked, grads):
            p.grad = gr
        opt.step()
        opt.zero_grad()
        for r in range(2):
            for p, q in zip(stacked, singles[r]):
                assert torch.equal(p[r], q), (kind, step, r)
    back = [unstack_optimizer(opt, r, [p[r].clone() for p in stacked]) for r in range(2)]
    for r in range(2):
        for p, q in zip(back[r].param_groups[0]["params"], singles[r]):
            assert torch.equal(torch_opts[r].state[q][cls.keys[0]], back[r].state[p][cls.keys[0]])
        assert back[r].param_groups[0]["lr"] == lrs[r]
    restacked = stack_optimizers(back, stacked)
    assert restacked.count == 4 and restacked.lr == lrs
    for key in cls.keys:
        for a, b in zip(restacked.state[key], opt.state[key]):
            assert torch.equal(a, b)


def test_multirun_defaults_to_the_pipelines_device(pipe):
    """The K runs live on the pipeline's device; with ``device="cpu"`` a
    multirun of one epoch each (both phase-4 branches) runs and its
    parameters move, each run's own."""
    mp = MultiRunStylePipeline(pipe)
    assert mp.device == torch.device("cpu")
    states = mp.init_states(SEEDS)
    before = states["params"]["nf"]["wn"][0]["start"]["v"].detach().clone()
    mp.run(as_multirun_data([make_pair(s) for s in SEEDS]), SEEDS,
           epochs={"p1": 0, "p2": 0, "p3": 0, "p4": 2, "p5": 0}, states=states)
    after = states["params"]["nf"]["wn"][0]["start"]["v"]
    assert not torch.equal(after[0], before[0]) and not torch.equal(after[1], before[1])
    assert all(p.device.type == "cpu" for p in leaves(states["params"]))
