"""The port's multi-run training against the JAX package's, on the CPU.

One K = 2 curriculum (seeds 3 and 7, the geometry and epochs of the JAX
package's ``tests/test_multirun.py``) runs in JAX's
``MultiRunStylePipeline`` and in the port's, from the same JAX-made
states (``init_states``, each run loaded into the port by
``train/jax_state.py``), over the same data and the batch orders JAX
draws (``jax.random.permutation`` on its per-run key chains, injected
into the port as ``perms``).  Randomness is pinned from the test only, as
``tests/test_torch_port_train_phases.py`` pins it: the JAX pipeline's
``cpc_apply``/``cpc_apply_pair`` are patched to fixed anchors and
``critics.dropout`` to the identity; the port gets the same anchors and
all-ones dropout multipliers.  No JAX file changes.

Each epoch is compared on its own: the port starts it from the state JAX's
multirun began it with (loaded by ``state_from_flat``), so that a
difference does not carry over into the next epoch, where RMSprop's first
step would magnify it (it moves a weight whose gradient is at rounding
level, such as an OS conv's bias before a training-mode BatchNorm, by about
10 lr either way).  Tolerance: every metric of every epoch rtol 1e-4, atol
1e-5, the single-epoch parity tests' (float32 on both sides, sums in
another order; measured on a CPU: phases 1, 3 and 4 within 1.6e-6
relative, phase 2 2.6e-5 (a source loss of the second run, three batches
in), phase 5 4.7e-5 relative, 5.2e-6 absolute, on the CDAN loss, a
difference of two sums).  The JAX compilation of the vmapped phases takes
most of this file's time (about 100 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.config import FlowConfig as JaxFlow
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.data.synthetic import make_dataset
from feature_level_style_transfer_for_tsc_tpu.models import critics as jax_critics
from feature_level_style_transfer_for_tsc_tpu.train import multirun as jax_multirun
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.data.batching import epoch_batches
from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
    MultiRunData,
    MultiRunStylePipeline,
    stack_states,
    unstack_state,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

SEEDS = (3, 7)
EPOCHS = {"p1": 1, "p2": 1, "p3": 2, "p4": 2, "p5": 1}
KW = dict(batch_size=4, max_kernel_size=5, cdan_dim=32, cpc_hidden=8, budget_multiplier=0.02,
          eval_every=1)
FLOW = dict(n_flows=2, wn_channels=8, wn_layers=2)
SHAPES = (2, 16, 2, 1, 12, 3)
ANCHORS = (2, 1)
TOL = {"p1": (1e-4, 1e-5), "p2": (1e-4, 1e-5), "p3": (1e-4, 1e-5), "p4": (1e-4, 1e-5),
       "p5": (1e-4, 1e-5)}


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


def jax_perms(seed, pair, epochs):
    """The batch permutations JAX's multirun draws for one run, in its
    order: per epoch a subkey of the chain from PRNGKey(seed + 1); one
    permutation (phases 1-2) or, split in two, the target's then the
    source's (phases 3-5)."""
    key = jax.random.PRNGKey(seed + 1)
    n_t, n_s = pair[0].x.shape[0], pair[2].x.shape[0]
    out = []
    for phase in ("p1", "p2", "p3", "p4", "p5"):
        for _ in range(epochs[phase]):
            key, sub = jax.random.split(key)
            if phase in ("p1", "p2"):
                out.append(np.asarray(jax.random.permutation(sub, n_t if phase == "p1" else n_s)))
            else:
                k1, k2 = jax.random.split(sub)
                out += [np.asarray(jax.random.permutation(k1, n_t)),
                        np.asarray(jax.random.permutation(k2, n_s))]
    return out


def flat_runs(jstates, n_runs):
    """Each run of a stacked JAX state as ``{keystr: array}``."""
    return [{jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_leaves_with_path(jax_multirun.unstack_state(jstates, i))}
            for i in range(n_runs)]


def stacked_batches(split, perms, batch_size):
    """The port's (K, nb, B, ...) epoch of each run from its permutation."""
    per_run = [epoch_batches(split[0][k], split[1][k], None, batch_size, perm=perm)
               for k, perm in enumerate(perms)]
    return np.stack([b[0] for b in per_run]), np.stack([b[1] for b in per_run])


@pytest.fixture(scope="module")
def epochs():
    yield from jax_epochs()


def jax_epochs():
    """JAX's multirun curriculum as its ``run`` drives it (its own jitted
    vmapped phases and key chain), with the state each epoch starts from:
    [(phase, epoch, each run's state flattened, the epoch's permutations,
    JAX's metrics)], and the data."""
    mp = pytest.MonkeyPatch()
    cpc_apply, cpc_apply_pair = jax_pipeline.cpc_apply, jax_pipeline.cpc_apply_pair
    mp.setattr(jax_pipeline, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHORS[0]))
    mp.setattr(jax_pipeline, "cpc_apply_pair",
               lambda p, a, b, r1, r2, anchors=None: cpc_apply_pair(p, a, b, r1, r2, anchors=ANCHORS))
    mp.setattr(jax_critics, "dropout", lambda key, x, rate, training: x)
    pairs = [make_pair(s) for s in SEEDS]
    splits = [{"t_train": (d[0].x, d[0].y), "t_test": (d[1].x, d[1].y),
               "s_train": (d[2].x, d[2].y), "s_test": (d[3].x, d[3].y)} for d in pairs]
    jpipe = jax_pipeline.StyleTransferPipeline(*SHAPES, JaxConfig(**KW, flow=JaxFlow(**FLOW)))
    jm = jax_multirun.MultiRunStylePipeline(jpipe)
    cfg = jpipe.config
    data = jax_multirun.MultiRunData.from_pairs(splits)
    states = jm.init_states(list(SEEDS))
    perms = [iter(jax_perms(s, p, EPOCHS)) for s, p in zip(SEEDS, pairs)]
    skeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(np.asarray(SEEDS) + 1))
    tt, st = data.t_train, data.s_train
    out = []
    for phase in ("p1", "p2", "p3", "p4", "p5"):
        for e in range(EPOCHS[phase]):
            before = flat_runs(states, len(SEEDS))
            skeys, sks = jm._split(skeys)
            n_perms = 1 if phase in ("p1", "p2") else 2
            used = [[next(p) for _ in range(n_perms)] for p in perms]
            if phase == "p1":
                states, m = jm._p1(states, *tt, sks)
            elif phase == "p2":
                states, m = jm._p2(states, *st, sks)
            elif phase == "p3":
                states, m = jm._p3[e % cfg.selfsup_supervised_every == 0](states, *tt, *st, sks)
            elif phase == "p4":
                states, m = jm._p4[e % cfg.nf_supervised_every == 0](states, *tt, *st, sks)
            else:
                states, m = jm._p5(states, *tt, *st, sks, jnp.asarray(e))
            out.append((phase, e, before, used, {k: np.asarray(v) for k, v in m.items()}))
    yield out, splits, flat_runs(states, len(SEEDS))
    mp.undo()


def test_every_epoch_matches_jax_multirun(epochs):
    """Each epoch of the curriculum, K runs at once in the port from the
    state JAX's multirun began that epoch with, over its batches, against
    JAX's epoch: every metric of each run (tolerances in the module
    docstring)."""
    records, splits, _ = epochs
    ppipe = StyleTransferPipeline(*SHAPES, PipelineConfig(**KW, flow=FlowConfig(**FLOW)),
                                  device="cpu")
    mp = MultiRunStylePipeline(ppipe)
    data = MultiRunData.from_pairs(splits)
    cfg = ppipe.config
    ones = [[torch.ones(KW["batch_size"], 1024) for _ in range(2)] for _ in range(2)]
    bsz = KW["batch_size"]
    for phase, e, before, used, want in records:
        states = stack_states([ppipe.state_from_flat(f) for f in before])
        if phase in ("p1", "p2"):
            split = data.t_train if phase == "p1" else data.s_train
            xb, yb = stacked_batches(split, [u[0] for u in used], bsz)
            got = (mp.phase1_epoch(states, xb, yb, ANCHORS[0]) if phase == "p1"
                   else mp.phase2_epoch(states, xb, yb))
        else:
            xt, yt = stacked_batches(data.t_train, [u[0] for u in used], bsz)
            xs, ys = stacked_batches(data.s_train, [u[1] for u in used], bsz)
            nb = min(xt.shape[1], xs.shape[1])
            batch = (xt[:, :nb], yt[:, :nb], xs[:, :nb], ys[:, :nb])
            if phase == "p3":
                got = mp.phase3_epoch(states, *batch, e % cfg.selfsup_supervised_every == 0, ANCHORS)
            elif phase == "p4":
                got = mp.phase4_epoch(states, *batch, e % cfg.nf_supervised_every == 0, ANCHORS)
            else:
                got = mp.phase5_epoch(states, *batch, e, ANCHORS, ones)
        assert set(got) == set(want), (phase, e)
        tol = TOL[phase]
        for k, v in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=tol[0], atol=tol[1],
                                       err_msg=f"{phase}#{e} {k}")


def test_unstacked_run_has_every_key_of_jax_unstack_state(epochs):
    """``state_to_flat`` of a run the port's multirun stacked from JAX's
    final states and unstacked has every key, with its shape, of the JAX
    package's ``unstack_state``, and the same values."""
    _, _, final = epochs
    ppipe = StyleTransferPipeline(*SHAPES, PipelineConfig(**KW, flow=FlowConfig(**FLOW)),
                                  device="cpu")
    states = stack_states([ppipe.state_from_flat(f) for f in final])
    for i, jflat in enumerate(final):
        flat = ppipe.state_to_flat(unstack_state(states, i))
        assert not sorted(set(jflat) - set(flat))
        for k, v in jflat.items():
            assert flat[k].shape == v.shape, k
            if k != "['rng']":
                np.testing.assert_allclose(flat[k], v, rtol=0, atol=0, err_msg=k)


def test_injected_orders_are_jax_multiruns():
    """The permutations ``jax_perms`` computes are those JAX's multirun's
    vmapped key split and permutation draw."""
    seeds = jnp.asarray(np.asarray(SEEDS) + 1)
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    keys, sub = jax.vmap(lambda k: tuple(jax.random.split(k)))(keys)
    perms = jax.vmap(lambda k: jax.random.permutation(k, 10))(sub)
    for i, s in enumerate(SEEDS):
        np.testing.assert_array_equal(np.asarray(perms[i]), jax_perms(s, make_pair(s), EPOCHS)[0])
