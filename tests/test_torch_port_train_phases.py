"""The port's training phases against the JAX package's, on the CPU.

One tiny pipeline (target 2 channels, T=16, 2 classes; source 1 channel,
T=12, 3 classes; ``budget_multiplier=0.02`` as tests/test_pipeline.py;
a 2-flow WaveGlow with an 8-layer, 16-channel WN, so the deep layers' taps
reach past T) is initialized by the JAX package and carried into the port
with ``from_jax_params``.  The same numpy-seeded stacked batch goes through
one epoch of each phase in both packages, the JAX one on its XLA path
(``FLSTTSC_USE_PALLAS=0``, as conftest.py sets).

Randomness is pinned from the test only: the JAX pipeline's
``cpc_apply``/``cpc_apply_pair`` are patched to fixed anchors and
``critics.dropout`` to the identity; the port gets the same anchors and
all-ones dropout multipliers.  No JAX file changes.

Tolerances (f32 on both sides, sums in another order): losses and metrics
rtol 1e-4, atol 1e-5; BatchNorm statistics and other state rtol 1e-4,
atol 1e-5; gradients and trunk norms rtol 1e-3, atol 1e-5 * max|g| over
the whole gradient (deep chains, sums over the batch; the OS convs' biases
feed a training-mode BatchNorm, so their gradient is zero up to rounding); updated parameters atol 1e-5 wherever the
step's |g| > 1e-6 * max|g| over the step's gradients and |g| > 1e-5 (an
RMSprop or Adam first step
moves a weight by about lr * 10 * sign(g) or lr * sign(g), whatever the size
of g, so a gradient at noise level may flip its step: the OS convs' biases,
for one, feed a training-mode BatchNorm and have a zero gradient up to
rounding; and below |g| = 1e-5 the optimizers' eps of 1e-8 weighs against
0.1|g|, so the step follows the gradient's rounding), exactly equal for
modules the phase does not step.
"""

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
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline

T_SHAPE, S_SHAPE = (2, 16, 2), (1, 12, 3)
B = 6
ANCHORS = (2, 1)
LOSS_TOL = {"rtol": 1e-4, "atol": 1e-5}
STATE_TOL = {"rtol": 1e-4, "atol": 1e-5}
KW = dict(batch_size=B, max_kernel_size=5, cdan_dim=32, cpc_hidden=8, budget_multiplier=0.02)
FLOW = dict(n_flows=2, wn_channels=16, wn_layers=8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and the tiny CPU ops of these runs, spread over every core by each
    process, slow each other down by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_flat(tree):
    from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten

    return flatten(tree)


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    cpc_apply, cpc_apply_pair = jax_pipeline.cpc_apply, jax_pipeline.cpc_apply_pair
    mp.setattr(jax_pipeline, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHORS[0]))
    mp.setattr(jax_pipeline, "cpc_apply_pair",
               lambda p, a, b, r1, r2, anchors=None: cpc_apply_pair(p, a, b, r1, r2, anchors=ANCHORS))
    mp.setattr(jax_critics, "dropout", lambda key, x, rate, training: x)
    jpipe = jax_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, JaxConfig(**KW, flow=JaxFlow(**FLOW)))
    jstate = jpipe.init_state(jax.random.PRNGKey(0))
    ppipe = port_pipeline.StyleTransferPipeline(
        *T_SHAPE, *S_SHAPE, PipelineConfig(**KW, flow=FlowConfig(**FLOW)), device="cpu"
    )
    rng = np.random.default_rng(0)
    batch = (
        rng.standard_normal((1, B, T_SHAPE[1], T_SHAPE[0])).astype(np.float32),
        rng.integers(0, T_SHAPE[2], (1, B)).astype(np.int32),
        rng.standard_normal((1, B, S_SHAPE[1], S_SHAPE[0])).astype(np.float32),
        rng.integers(0, S_SHAPE[2], (1, B)).astype(np.int32),
    )
    yield jpipe, jstate, ppipe, batch
    mp.undo()


def _port_state(ppipe, jstate):
    models = from_jax_params(_flat({k: jstate[k] for k in ("params", "mstate", "consts")}))
    return ppipe.training_state(models, seed=0)


def _recording_grads(ppipe, monkeypatch):
    """Record the gradients each optimizer step is given."""
    seen = {}
    apply = ppipe._apply_updates

    def record(state, names, grads):
        for n in names:
            seen[n] = [None if g is None else g.clone() for g in grads[n]]
        return apply(state, names, grads)

    monkeypatch.setattr(ppipe, "_apply_updates", record)
    return seen


def _check_params(jparams, pstate, grads, stepped):
    """Updated params against the JAX package's, see the module docstring."""
    want = _flat(jparams)
    got = _port_flat(pstate["params"])
    assert set(got) == set(want)
    g_max = max(float(g.abs().max()) for n in stepped for g in grads[n] if g is not None)
    for name in port_pipeline.ALL_MODULES:
        prefix = f"['{name}']"
        keys = [k for k in got if k.startswith(prefix)]
        if name not in stepped:
            for k in keys:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        for k, g in zip(keys, grads[name]):
            g = np.zeros_like(got[k]) if g is None else g.numpy()
            live = np.abs(g) > max(1e-6 * g_max, 1e-5)
            np.testing.assert_allclose(got[k][live], want[k][live], atol=1e-5, err_msg=k)


def _check_mstate(jmstate, pstate):
    want, got = _flat(jmstate), _port_flat(pstate["mstate"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STATE_TOL, err_msg=k)


def _check_metrics(jm, pm):
    assert set(jm) == set(pm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(pm[k]), np.asarray(jm[k]), **LOSS_TOL, err_msg=k)


def test_phase1_epoch_matches_jax(setup, monkeypatch):
    jpipe, jstate, ppipe, (xt, yt, _, _) = setup
    jnew, jm = jpipe.phase1_epoch(jstate, jnp.asarray(xt), jnp.asarray(yt))
    pstate = _port_state(ppipe, jstate)
    grads = _recording_grads(ppipe, monkeypatch)
    pm = ppipe.phase1_epoch(pstate, xt, yt, cpc_anchor=ANCHORS[0])
    _check_metrics(jm, pm)
    _check_mstate(jnew["mstate"], pstate)
    _check_params(jnew["params"], pstate, grads, ("t_ext", "t_cls", "cpc"))
    for n in ("t_ext", "t_cls", "cpc"):
        assert pstate["sched"][n] == int(jnew["sched"][n]) == 1


def test_phase2_epoch_matches_jax(setup, monkeypatch):
    jpipe, jstate, ppipe, (_, _, xs, ys) = setup
    jnew, jm = jpipe.phase2_epoch(jstate, jnp.asarray(xs), jnp.asarray(ys))
    pstate = _port_state(ppipe, jstate)
    grads = _recording_grads(ppipe, monkeypatch)
    pm = ppipe.phase2_epoch(pstate, xs, ys)
    _check_metrics(jm, pm)
    _check_mstate(jnew["mstate"], pstate)
    _check_params(jnew["params"], pstate, grads, ("s_ext", "dim_uni", "s_cls"))


@pytest.mark.parametrize("supervised", [True, False])
def test_phase3_epoch_matches_jax(setup, monkeypatch, supervised):
    jpipe, jstate, ppipe, batch = setup
    jnew, jm = jpipe.phase3_epoch(jstate, *map(jnp.asarray, batch), supervised)
    pstate = _port_state(ppipe, jstate)
    grads = _recording_grads(ppipe, monkeypatch)
    pm = ppipe.phase3_epoch(pstate, *batch, supervised, cpc_anchors=ANCHORS)
    _check_metrics(jm, pm)
    _check_mstate(jnew["mstate"], pstate)
    stepped = (("t_ext", "t_cls", "cpc", "s_ext", "dim_uni", "s_cls") if supervised
               else ("t_ext", "cpc", "s_ext", "dim_uni"))
    _check_params(jnew["params"], pstate, grads, stepped)


@pytest.mark.parametrize("supervised", [True, False])
def test_phase4_epoch_matches_jax(setup, monkeypatch, supervised):
    jpipe, jstate, ppipe, batch = setup
    jnew, jm = jpipe.phase4_epoch(jstate, *map(jnp.asarray, batch), supervised)
    pstate = _port_state(ppipe, jstate)
    grads = _recording_grads(ppipe, monkeypatch)
    pm = ppipe.phase4_epoch(pstate, *batch, supervised, cpc_anchors=ANCHORS)
    _check_metrics(jm, pm)
    _check_mstate(jnew["mstate"], pstate)
    stepped = (("t_ext", "t_cls", "s_ext", "dim_uni", "s_cls", "nf", "cpc") if supervised
               else ("nf",))
    _check_params(jnew["params"], pstate, grads, stepped)
    np.testing.assert_allclose(pstate["plateau"]["nf"].best, float(jnew["plateau"]["nf"].best),
                               **LOSS_TOL)


def _ones_masks(ppipe):
    return [[torch.ones(B, 1024), torch.ones(B, 1024)] for _ in range(2)]


def test_phase5_grads_and_trunk_norms_match_jax(setup):
    """The 9 losses, the grads of the total, n_t (2) and n_s (3) against a
    ``jax.vjp`` of the JAX ``_phase5_forward`` pulled with the one-hot seeds
    of ``train/pipeline.py:709-744``."""
    jpipe, jstate, ppipe, (xt, yt, xs, ys) = setup
    epoch = 0
    names = ("t_nf", "t_c", "s_nf", "s_c", "s2t2s_c")

    def all_losses(p):
        losses, _, _ = jpipe._phase5_forward(
            p, jstate["mstate"], jstate["consts"], jnp.asarray(xt[0]), jnp.asarray(yt[0]),
            jnp.asarray(xs[0]), jnp.asarray(ys[0]), jax.random.PRNGKey(1), cpc_anchors=ANCHORS,
        )
        gw_t, gw_s = jstate["gradnorm"]["t"].weights, jstate["gradnorm"]["s"].weights
        w = jpipe._staged_weights(epoch)
        total = (
            jnp.sum(gw_t * jnp.stack([losses["t_nf"], losses["t_c"]]))
            + jnp.sum(gw_s * jnp.stack([losses["s_nf"], losses["s_c"], losses["s2t2s_c"]]))
            + w[0] * losses["cdan"] + w[1] * losses["fd"] + w[2] * losses["t_sl"]
            + w[3] * losses["s_sl"]
        )
        return jnp.stack([total] + [losses[n] for n in names]), losses

    vec, pullback, jlosses = jax.vjp(all_losses, jstate["params"], has_aux=True)
    eye = np.eye(6, dtype=np.float32)

    def pull(seed):
        return pullback(jnp.asarray(seed))[0]

    def trunk_norm(g, key):
        return float(sum(jnp.linalg.norm(leaf.reshape(-1))
                         for leaf in jax.tree_util.tree_leaves(g[key]["block"])))

    g_total, g_nf, g_c, g_5 = pull(eye[0]), pull(eye[1] + eye[3]), pull(eye[2] + eye[4]), pull(eye[5])
    want_n_t = [trunk_norm(g_nf, "t_ext"), trunk_norm(g_c, "t_ext")]
    want_n_s = [trunk_norm(g_nf, "s_ext"), trunk_norm(g_c, "s_ext"), trunk_norm(g_5, "s_ext")]

    pstate = _port_state(ppipe, jstate)
    losses, _, _, grads, n_t, n_s = ppipe.phase5_grads(
        pstate, torch.from_numpy(xt[0]), torch.from_numpy(yt[0]).long(),
        torch.from_numpy(xs[0]), torch.from_numpy(ys[0]).long(), epoch,
        cpc_anchors=ANCHORS, dropout_masks=_ones_masks(ppipe),
    )
    assert set(losses) == set(jlosses) and len(losses) == 9
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(n_t.numpy(), want_n_t, rtol=1e-3)
    np.testing.assert_allclose(n_s.numpy(), want_n_s, rtol=1e-3)
    want = _flat(g_total)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name in port_pipeline.ALL_MODULES:
        keys = [k for k in _port_flat(pstate["params"]) if k.startswith(f"['{name}']")]
        assert len(keys) == len(grads[name])
        for k, g in zip(keys, grads[name]):
            g = np.zeros_like(want[k]) if g is None else g.numpy()
            np.testing.assert_allclose(g, want[k], rtol=1e-3, atol=1e-5 * scale, err_msg=k)


def test_phase5_epoch_matches_jax(setup, monkeypatch):
    """Metrics, GradNorm weights, model state and updated params after one
    ``phase5_epoch`` of one batch."""
    jpipe, jstate, ppipe, batch = setup
    jnew, jm = jpipe.phase5_epoch(jstate, *map(jnp.asarray, batch), jnp.asarray(0))
    pstate = _port_state(ppipe, jstate)
    grads = _recording_grads(ppipe, monkeypatch)
    pm = ppipe.phase5_epoch(pstate, *batch, 0, cpc_anchors=ANCHORS,
                            dropout_masks=_ones_masks(ppipe))
    _check_metrics(jm, pm)
    np.testing.assert_allclose(pstate["gradnorm"]["t"].weights.numpy(),
                               np.asarray(jnew["gradnorm"]["t"].weights), **LOSS_TOL)
    np.testing.assert_allclose(pstate["gradnorm"]["s"].weights.numpy(),
                               np.asarray(jnew["gradnorm"]["s"].weights), **LOSS_TOL)
    _check_mstate(jnew["mstate"], pstate)
    _check_params(jnew["params"], pstate, grads, port_pipeline.ALL_MODULES)
    for name in port_pipeline.PLATEAU_MODULES:
        assert pstate["plateau"][name].num_bad == int(jnew["plateau"][name].num_bad)
        np.testing.assert_allclose(pstate["plateau"][name].best,
                                   float(jnew["plateau"][name].best), **LOSS_TOL)
