"""``PipelineConfig(fused_optimizers=True)`` against the JAX package, on the CPU.

The ten RMSprop modules stepped as one flat update with a learning rate per
element (``train/optim.py`` ``FusedRMSprop``, JAX ``train/optim.py:106-164``
and ``train/pipeline.py:198-205, 263-309``), in the single run, in the K-run
multirun and in the checkpoint layout (``opt/fused/{v,lr}``, ``opt/cpc``).

Geometry: the JAX package's ``tiny_cfg`` of ``tests/test_multirun.py``
(target 2 x 16, 2 classes; source 1 x 12, 3 classes; batch 4; a 2-flow
WaveGlow with a 2-layer, 8-channel WN; ``budget_multiplier=0.02``), from the
JAX package's ``init_state`` carried into the port; one numpy-seeded batch a
epoch, as JAX ``tests/test_pipeline.py:140`` takes one; the JAX epochs on
its XLA path, randomness pinned from the test only (the CPC anchors, the
identity dropout), as ``test_torch_port_train_phases.py`` does.

Tolerances: the fused update against the per-module torch ``RMSprop`` of
the port, 1e-5 (JAX's bar between its fused and per-module epochs; the port
does the same element operations in the same order, so they agree to the
bit); against JAX's fused epochs, atol 1e-5 where the step's gradient is
live, the parity bar of ``test_torch_port_train_phases.py``; K runs at once
against the runs in turn, the bars of ``test_torch_port_multirun.py``
(phase 1 rtol 1e-4, atol 1e-5; phase 5 rtol 5e-2, atol 2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.config import FlowConfig as JaxFlow
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.io.checkpoint import restore_checkpoint as jax_restore
from feature_level_style_transfer_for_tsc_tpu.models import critics as jax_critics
from feature_level_style_transfer_for_tsc_tpu.train import optim as jax_optim
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import (
    flatten,
    from_jax_params,
    save_flat,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train import optim as port_optim
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
    MultiRunStylePipeline,
    stack_states,
    unstack_state,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves
from test_torch_port_train_phases import _check_params, _recording_grads

SHAPES = (2, 16, 2, 1, 12, 3)
B = 4
ANCHORS = (2, 1)
KW = dict(batch_size=B, max_kernel_size=5, cdan_dim=32, cpc_hidden=8, budget_multiplier=0.02,
          eval_every=1)
FLOW = dict(n_flows=2, wn_channels=8, wn_layers=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jflat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    """The JAX fused pipeline and its init state (the per-module init with
    the fused layout's ``opt``, as its ``init_state`` builds it), the batch,
    and JAX's fused phase-1 and phase-5 epochs from that state."""
    mp = pytest.MonkeyPatch()
    cpc_apply, cpc_apply_pair = jax_pipeline.cpc_apply, jax_pipeline.cpc_apply_pair
    mp.setattr(jax_pipeline, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHORS[0]))
    mp.setattr(jax_pipeline, "cpc_apply_pair",
               lambda p, a, b, r1, r2, anchors=None: cpc_apply_pair(p, a, b, r1, r2, anchors=ANCHORS))
    mp.setattr(jax_critics, "dropout", lambda key, x, rate, training: x)
    jpipe = jax_pipeline.StyleTransferPipeline(
        *SHAPES, JaxConfig(**KW, flow=JaxFlow(**FLOW), fused_optimizers=True))
    jstate = dict(jax_pipeline.StyleTransferPipeline(
        *SHAPES, JaxConfig(**KW, flow=JaxFlow(**FLOW))).init_state(jax.random.PRNGKey(17)))
    params = jstate["params"]
    jstate["opt"] = {
        "fused": jax_optim.fused_rmsprop_init({n: params[n] for n in jpipe.rms_modules},
                                              jpipe.rms_base_lrs),
        "cpc": jpipe.tx["cpc"].init(params["cpc"]),
    }
    rng = np.random.default_rng(17)
    batch = (
        rng.standard_normal((1, B, SHAPES[1], SHAPES[0])).astype(np.float32),
        rng.integers(0, SHAPES[2], (1, B)).astype(np.int32),
        rng.standard_normal((1, B, SHAPES[4], SHAPES[3])).astype(np.float32),
        rng.integers(0, SHAPES[5], (1, B)).astype(np.int32),
    )
    j1, _ = jpipe.phase1_epoch(jstate, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
    j5, j5_metrics = jpipe.phase5_epoch(jstate, *map(jnp.asarray, batch), jnp.asarray(0))
    yield jpipe, jstate, batch, j1, j5, j5_metrics
    mp.undo()


def _port_pipe(fused: bool = True):
    cfg = PipelineConfig(**KW, flow=FlowConfig(**FLOW), fused_optimizers=fused)
    return port_pipeline.StyleTransferPipeline(*SHAPES, cfg, device="cpu")


def _port_state(ppipe, jstate):
    models = from_jax_params(_jflat({k: jstate[k] for k in ("params", "mstate", "consts")}))
    return ppipe.training_state(models, seed=0)


def _ones_masks():
    return [[torch.ones(B, 1024), torch.ones(B, 1024)] for _ in range(2)]


def _epochs(ppipe, pstate_fn, batch, monkeypatch):
    """The port's phase-1 and phase-5 epochs, each from a fresh state:
    (params after each, the gradients each last stepped with)."""
    out = []
    for phase in (1, 5):
        pstate = pstate_fn()
        grads = _recording_grads(ppipe, monkeypatch)
        if phase == 1:
            ppipe.phase1_epoch(pstate, batch[0], batch[1], cpc_anchor=ANCHORS[0])
        else:
            ppipe.phase5_epoch(pstate, *batch, 0, cpc_anchors=ANCHORS, dropout_masks=_ones_masks())
        monkeypatch.undo()
        out.append((pstate, dict(grads)))
    return out


# ------------------------------------------------------------- (3) epochs --

def test_fused_epochs_match_jax_and_the_per_module_optimizers(setup, monkeypatch):
    """A phase-1 and a phase-5 epoch with the fused optimizer (JAX
    ``tests/test_pipeline.py:140``): against JAX's fused epochs, and against
    the port's per-module optimizers within 1e-5 (every parameter)."""
    jpipe, jstate, batch, j1, j5, _ = setup
    fused = _epochs(_port_pipe(), lambda: _port_state(_port_pipe(), jstate), batch, monkeypatch)
    per_module = _epochs(_port_pipe(False), lambda: _port_state(_port_pipe(False), jstate), batch,
                         monkeypatch)
    for (pstate, grads), jnew, stepped in zip(fused, (j1, j5),
                                              (("t_ext", "t_cls", "cpc"), port_pipeline.ALL_MODULES)):
        assert isinstance(pstate["opt"]["fused"], port_optim.FusedRMSprop)
        _check_params(jnew["params"], pstate, grads, stepped)
        # v = 0.01 g^2 after one step: |g| to the parity test's gradient bar
        g_got = np.sqrt(pstate["opt"]["fused"].v.numpy() / 0.01)
        g_want = np.sqrt(np.asarray(jnew["opt"]["fused"].v) / 0.01)
        np.testing.assert_allclose(g_got, g_want, rtol=1e-3, atol=1e-5 * g_want.max())
        np.testing.assert_array_equal(pstate["opt"]["fused"].lr.numpy(),
                                      np.asarray(jnew["opt"]["fused"].lr))
    for (f_state, _), (m_state, _) in zip(fused, per_module):
        got, want = flatten(f_state["params"]), flatten(m_state["params"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_fused_update_is_per_module_rmsprop_exactly():
    """JAX's exact-math unit: 3 masked fused steps (module ``b`` outside the
    step) equal the per-module torch ``RMSprop`` of the port, and JAX's
    ``fused_rmsprop_update`` on the same numbers; ``b`` keeps its values and
    its slice of ``v`` bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (4, 5)}, "b": {"k": (3, 3)}, "c": {"z": (7,), "y": (2,)}}
    arrays = {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    grads = [{m: {k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()} for _ in range(3)]
    lrs = {"a": 1e-3, "b": 5e-4, "c": 2e-3}
    names = ("a", "c")

    def tensors():
        return {m: {k: torch.tensor(v) for k, v in d.items()} for m, d in arrays.items()}

    ref = tensors()
    opts = {m: port_optim.make_rmsprop(port_optim.jax_order(ref[m]), lrs[m]) for m in names}
    mine = tensors()
    fused = port_optim.FusedRMSprop(mine, lrs)
    jparams = jax.tree_util.tree_map(jnp.asarray, arrays)
    jstate = jax_optim.fused_rmsprop_init(jparams, [lrs[m] for m in sorted(arrays)])
    mask = np.concatenate([np.full(sum(int(np.prod(s)) for s in shapes[m].values()),
                                   1.0 if m in names else 0.0, np.float32)
                           for m in sorted(shapes)])
    for g in grads:
        for m in names:
            for k in ref[m]:
                ref[m][k].grad = torch.tensor(g[m][k])
                mine[m][k].grad = torch.tensor(g[m][k])
            opts[m].step()
        fused.step(names)
        jparams, jstate = jax_optim.fused_rmsprop_update(
            jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate, mask)
    for m in shapes:
        for k in shapes[m]:
            assert torch.equal(mine[m][k], ref[m][k]), (m, k)
            np.testing.assert_allclose(mine[m][k].numpy(), np.asarray(jparams[m][k]),
                                       rtol=1e-6, atol=1e-8, err_msg=f"{m}{k}")
    lo, hi = fused.offsets["b"]
    assert not fused.v[lo:hi].any() and torch.equal(mine["b"]["k"], torch.tensor(arrays["b"]["k"]))
    np.testing.assert_allclose(fused.v.numpy(), np.asarray(jstate.v), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(fused.lr.numpy(), np.asarray(jstate.lr))


# ------------------------------------------------------- (4) learning rates --

def test_learning_rate_changes_land_in_the_fused_slice(setup):
    """A plateau cut writes the module's slice of ``lr`` and nothing else,
    and the flat order is the JAX package's: every module's learning rate
    set through ``_set_module_lr`` in both packages gives the same vector."""
    jpipe, jstate, *_ = setup
    ppipe = _port_pipe()
    pstate = _port_state(ppipe, jstate)
    fused = pstate["opt"]["fused"]
    before = fused.lr.clone()
    o = ppipe.config.optim
    pstate["plateau"]["nf"] = port_optim.PlateauState(lr=o.lr_nf, best=0.5, num_bad=10)
    ppipe._step_plateau(pstate, "nf", 1.0)
    new_lr = pstate["plateau"]["nf"].lr
    assert new_lr == pytest.approx(o.lr_nf * o.plateau_factor)
    lo, hi = fused.offsets["nf"]
    assert torch.equal(fused.lr[lo:hi], torch.full((hi - lo,), new_lr))
    keep = torch.ones_like(before, dtype=torch.bool)
    keep[lo:hi] = False
    assert torch.equal(fused.lr[keep], before[keep])
    # StepLR: a counter step of the noise module (its own step and gamma)
    pstate["sched"]["noise"] = o.noise_steplr_step - 1
    ppipe._step_steplr(pstate, ("noise",))
    lo, hi = fused.offsets["noise"]
    assert torch.equal(fused.lr[lo:hi], torch.full((hi - lo,), o.lr_noise_trans
                                                   * o.noise_steplr_gamma))
    jst = dict(jstate, opt=dict(jstate["opt"]))
    for i, m in enumerate(port_pipeline.RMS_MODULES):
        ppipe._set_module_lr(pstate, m, 1e-4 * (i + 1))
        jst = jpipe._set_module_lr(jst, m, 1e-4 * (i + 1))
    np.testing.assert_array_equal(fused.lr.numpy(), np.asarray(jst["opt"]["fused"].lr))


# --------------------------------------------------------- (5) checkpoints --

def test_a_jax_fused_state_round_trips_through_the_port(setup, tmp_path):
    """JAX's fused state after a phase-1 epoch (``v`` non-zero in the
    stepped modules) into the port (``state_from_flat``) and back
    (``state_to_flat``): every key of the JAX package's, the same bits (but
    ``['rng']``, which the port redraws from its generator); the port's own
    fused state restores into the JAX package's fused template, the same
    bits; a per-module file does not load into a fused state."""
    jpipe, _, batch, j1, _, _ = setup
    want = _jflat(j1)
    ppipe = _port_pipe()
    pstate = ppipe.state_from_flat(want)
    assert pstate["opt"]["fused"].v.any()
    got = ppipe.state_to_flat(pstate)
    assert set(want) <= set(got) and "['opt']['fused'].v" in want
    for k in want:
        if k != "['rng']":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    ppipe.phase1_epoch(pstate, batch[0], batch[1], cpc_anchor=ANCHORS[0])
    flat = ppipe.state_to_flat(pstate)
    save_flat(str(tmp_path / "port.npz"), flat)
    back = _jflat(jax_restore(str(tmp_path / "port.npz"), j1))
    for k, v in back.items():
        if k != "['rng']":
            # the port writes a learning rate float32 can't hold as float64
            # (``jax_state.exact_scalar``); JAX's restore casts it
            np.testing.assert_array_equal(v, flat[k].astype(v.dtype), err_msg=k)
    per_module = _port_pipe(False)
    with pytest.raises(ValueError, match="fused_optimizers"):
        per_module.state_from_flat(flat)


# ------------------------------------------------------ (6) K runs at once --

def test_multirun_fused_matches_runs_in_turn(setup):
    """K = 2 runs with the fused optimizer (one (K, N) ``FusedRMSprop``)
    against the two runs in turn: a phase-1 and then a phase-5 epoch, each
    run's metrics; the unstacked runs' learning rates against the runs' own;
    and the same K-run phase-1 epoch with the per-module stacked optimizers
    (the same parameters within 1e-5)."""
    _, jstate, batch, *_ = setup
    ppipe = _port_pipe()
    seeds = (3, 7)
    singles = [ppipe.init_state(torch.Generator().manual_seed(s)) for s in seeds]
    mp = MultiRunStylePipeline(ppipe)
    states = stack_states([unstack_state(stack_states(singles), i) for i in range(2)])
    assert tuple(states["opt"]["fused"].v.shape) == (2, singles[0]["opt"]["fused"].v.numel())
    xt, yt, xs, ys = (np.stack([b, b]) for b in batch)
    m1 = mp.phase1_epoch(states, xt, yt, ANCHORS[0])
    m5 = mp.phase5_epoch(states, xt, yt, xs, ys, 0, ANCHORS, _ones_masks())
    for i, st in enumerate(singles):
        o1 = ppipe.phase1_epoch(st, batch[0], batch[1], cpc_anchor=ANCHORS[0])
        o5 = ppipe.phase5_epoch(st, *batch, 0, cpc_anchors=ANCHORS, dropout_masks=_ones_masks())
        for got, want, tol in ((m1, o1, (1e-4, 1e-5)), (m5, o5, (5e-2, 2e-2))):
            for k, v in want.items():
                np.testing.assert_allclose(got[k][i].numpy(), v.numpy(), rtol=tol[0],
                                           atol=tol[1], err_msg=f"run {i} {k}")
        one = unstack_state(states, i)["opt"]["fused"]
        np.testing.assert_array_equal(one.lr.numpy(), st["opt"]["fused"].lr.numpy())
        assert one.v.shape == st["opt"]["fused"].v.shape
    plain = _port_pipe(False)
    a = stack_states([ppipe.init_state(torch.Generator().manual_seed(s)) for s in seeds])
    b = stack_states([plain.init_state(torch.Generator().manual_seed(s)) for s in seeds])
    MultiRunStylePipeline(ppipe).phase1_epoch(a, xt, yt, ANCHORS[0])
    MultiRunStylePipeline(plain).phase1_epoch(b, xt, yt, ANCHORS[0])
    for p, q in zip(leaves(a["params"]), leaves(b["params"])):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-5)
