"""Both bf16 switches of the port in training, on the CPU.

``FLSTTSC_WN_MXU=bf16`` (the fused WN's products on bf16 operands) and
``PipelineConfig.compute_dtype="bfloat16"`` (the OS-CNN convs in bf16)
together, at the JAX package's ``tests/test_multirun.py`` geometry
(``tiny_cfg``: target 2 x 16, 2 classes; source 1 x 12, 3 classes; batch 4;
a 2-flow WaveGlow with a 2-layer, 8-channel WN; ``budget_multiplier=0.02``):

* one phase-5 epoch of one batch from one JAX-made state against JAX's, the
  randomness pinned as ``tests/test_torch_port_train_phases.py`` pins it, the
  JAX Pallas kernels in interpret mode: the counterpart of JAX
  ``test_phase5_epoch_bf16_mxu_tracks_f32``, held to its bars (rtol and atol
  5e-2), with the convs in bf16 as well;
* a K = 2 multirun phase-5 step against the two one-run steps from the same
  states: losses and each module's gradients within relative L2 1e-3.

The single ops are in ``tests/test_torch_port_bf16.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_bf16 import FLOW, KW, S_SHAPE, T_SHAPE, _flat, _interpret, _rel_l2

from feature_level_style_transfer_for_tsc_tpu.config import FlowConfig as JaxFlow
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.models import critics as jax_critics
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.ops import wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import MultiRunStylePipeline

REL_L2 = 1e-3
B = KW["batch_size"]
ANCHORS = (2, 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bf16_setup():
    """JAX's and the port's pipeline at the tiny_cfg geometry with
    compute_dtype="bfloat16", one JAX-made state, one numpy batch; the JAX
    pipeline's CPC anchors and dropout pinned, as
    tests/test_torch_port_train_phases.py pins them."""
    mp = pytest.MonkeyPatch()
    cpc_apply, cpc_apply_pair = jax_pipeline.cpc_apply, jax_pipeline.cpc_apply_pair
    mp.setattr(jax_pipeline, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHORS[0]))
    mp.setattr(jax_pipeline, "cpc_apply_pair",
               lambda p, a, b, r1, r2, anchors=None: cpc_apply_pair(p, a, b, r1, r2, anchors=ANCHORS))
    mp.setattr(jax_critics, "dropout", lambda key, x, rate, training: x)
    jcfg = JaxConfig(compute_dtype="bfloat16", **KW, flow=JaxFlow(**FLOW))
    jpipe = jax_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, jcfg)
    jstate = jpipe.init_state(jax.random.PRNGKey(11))
    cfg = PipelineConfig(compute_dtype="bfloat16", **KW, flow=FlowConfig(**FLOW))
    ppipe = port_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, cfg, device="cpu")
    rng = np.random.default_rng(11)
    batch = (
        rng.standard_normal((1, B, T_SHAPE[1], T_SHAPE[0])).astype(np.float32),
        rng.integers(0, T_SHAPE[2], (1, B)).astype(np.int32),
        rng.standard_normal((1, B, S_SHAPE[1], S_SHAPE[0])).astype(np.float32),
        rng.integers(0, S_SHAPE[2], (1, B)).astype(np.int32),
    )
    yield jpipe, jstate, ppipe, batch
    mp.undo()


def _ones_masks():
    return [[torch.ones(B, 1024), torch.ones(B, 1024)] for _ in range(2)]


def test_phase5_epoch_both_switches_matches_jax(bf16_setup, monkeypatch):
    """One phase-5 epoch of one batch with both switches, from one JAX-made
    state (the counterpart of JAX ``test_phase5_epoch_bf16_mxu_tracks_f32``,
    with the convs in bf16 as well): the port's metrics are finite and
    within rtol and atol 5e-2 of JAX's bf16 metrics."""
    _interpret(monkeypatch)
    monkeypatch.setenv("FLSTTSC_WN_MXU", "bf16")
    jpipe, jstate, ppipe, batch = bf16_setup
    _, jm = jpipe.phase5_epoch(jstate, *map(jnp.asarray, batch), jnp.asarray(0))
    models = from_jax_params(_flat({k: jstate[k] for k in ("params", "mstate", "consts")}))
    pstate = ppipe.training_state(models, seed=0)
    seen = []
    real = wn_fused.wn_bwd_plain
    monkeypatch.setattr(wn_fused, "wn_bwd_plain", lambda *a: seen.append(a[-1]) or real(*a))
    pm = ppipe.phase5_epoch(pstate, *batch, 0, cpc_anchors=ANCHORS, dropout_masks=_ones_masks())
    assert seen and all(seen)  # every WN pullback on bf16 operands
    assert set(pm) == set(jm)
    for k in jm:
        assert np.all(np.isfinite(np.asarray(pm[k]))), k
        np.testing.assert_allclose(np.asarray(pm[k]), np.asarray(jm[k]), rtol=5e-2, atol=5e-2,
                                   err_msg=k)


def test_multirun_step_both_switches_matches_single_runs(bf16_setup, monkeypatch):
    """A K = 2 multirun phase-5 step with both switches against the two
    one-run bf16 steps from the same states: the losses and every module's
    gradients within relative L2 1e-3."""
    monkeypatch.setenv("FLSTTSC_WN_MXU", "bf16")
    _, _, pipe, (xt, yt, xs, ys) = bf16_setup
    seeds = (3, 7)
    mp = MultiRunStylePipeline(pipe)
    states = mp.init_states(seeds)
    singles = [pipe.init_state(torch.Generator().manual_seed(s)) for s in seeds]
    rng = np.random.default_rng(7)
    bt = torch.from_numpy(np.stack([xt[0], rng.standard_normal(xt[0].shape).astype(np.float32)]))
    bs = torch.from_numpy(np.stack([xs[0], rng.standard_normal(xs[0].shape).astype(np.float32)]))
    lt = torch.from_numpy(np.stack([yt[0], yt[0][::-1].copy()])).long()
    ls = torch.from_numpy(np.stack([ys[0], ys[0][::-1].copy()])).long()
    masks = [[(torch.rand(B, 1024, generator=torch.Generator().manual_seed(2 * c + j)) >= 0.2)
              .float() / 0.8 for j in range(2)] for c in range(2)]
    losses, _, _, grads, _, _ = mp.phase5_grads(states, bt, lt, bs, ls, 0, ANCHORS, masks)
    for i, st in enumerate(singles):
        l1, _, _, g1, _, _ = pipe.phase5_grads(st, bt[i], lt[i], bs[i], ls[i], 0, ANCHORS, masks)
        assert _rel_l2([float(losses[k][i].detach()) for k in l1],
                       [float(v.detach()) for v in l1.values()]) <= REL_L2
        for name in port_pipeline.ALL_MODULES:
            pairs = [(g[i].numpy(), w.numpy()) for g, w in zip(grads[name], g1[name])
                     if w is not None]
            got = np.concatenate([a.ravel() for a, _ in pairs])
            want = np.concatenate([b.ravel() for _, b in pairs])
            assert _rel_l2(got, want) <= REL_L2, (i, name, _rel_l2(got, want))
