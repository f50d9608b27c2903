"""The port's data parallelism against the JAX package's single-device steps, on the CPU.

The port's ``parallel/dp.py``, ``parallel/dp_explicit.py``, the placement
helpers of ``parallel/mesh.py`` and the domain-sharded ``MultiSourceEnsemble``
run in 4 gloo processes, spawned once for this module
(``tests/_torch_port_dp_ranks.py``, one torch thread a rank, rendezvous
through a file under ``tmp_path``); each rank runs every case on its own
shard of the batch and sends back what it computed.  The JAX side runs
here, on one device: each case is JAX's single-device step or epoch, as
JAX's own tests (``test_parallel.py``, ``test_dp_explicit.py``) hold its
sharded runs against it.

Setup: the tiny pipeline of ``test_torch_port_train_phases.py`` (target 2 x
16, 2 classes; source 1 x 12, 3 classes; a 2-flow WaveGlow with an 8-layer
16-channel WN) at batch 8, 2 rows a rank; a target-shaped classifier
without CPC at batch 8; the parameters the JAX package's, carried across
with ``from_jax_params`` / ``load_classifier_state``; the batches numpy
arrays from a seed.  Randomness is pinned as there: the JAX pipeline's
``cpc_apply``/``cpc_apply_pair`` patched to fixed anchors and
``critics.dropout`` to the identity, the port given the same anchors and
all-ones dropout multipliers (the rank's rows).  A second phase-5 step
draws its anchors and the critic's dropout from the replicated generator
and is held against the port's unsharded step from the same generator.

Tolerances, those of ``test_torch_port_train_phases.py``: losses and
metrics rtol 1e-4, atol 1e-5; BatchNorm statistics and other state rtol
1e-4, atol 1e-5; gradients, trunk norms and GradNorm weights rtol 1e-3,
atol 1e-5 * max|g| over the step's whole gradient (the classifier's
gradients JAX's atol 1e-5, ``test_parallel.py:30-61``); updated parameters
atol 1e-5 wherever every step's |g| > max(1e-6 * max|g|, 1e-5) (an RMSprop
or Adam first step moves a weight by about lr * 10 or lr whatever |g|, so
a noise-level gradient, such as that of an OS conv bias feeding a
training-mode BatchNorm, may flip its step).  Against the port's unsharded
run: atol 1e-5 on losses and norms, atol 1e-5 * max|g| on gradients, the
same parameter rule, but atol 5e-5 after a second step (``SECOND_STEP_ATOL``:
the figure that forced it is there).  Over a two-batch epoch a first
step's flipped noise-level update carries into the second step (the
parameters after the epoch sat up to 4.8e-3 apart, and the BatchNorm
running means lr-scale apart, as JAX's ``test_dp_explicit.py`` notes), so
the second phase-5 step is held against the port's unsharded step from the
DP run's own state after the first, and the epochs' parameters against the
port's unsharded epoch where they agree (classifier, phase 1).  Every
rank's state after every epoch is the same bits.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_dp_ranks import keyed, pipe_state, pipeline, rank_main, recording_phase5
from jax.sharding import NamedSharding

from feature_level_style_transfer_for_tsc_tpu.config import FlowConfig as JaxFlow
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.losses import gradnorm as jax_gradnorm
from feature_level_style_transfer_for_tsc_tpu.losses.classification import cross_entropy as j_ce
from feature_level_style_transfer_for_tsc_tpu.models import critics as jax_critics
from feature_level_style_transfer_for_tsc_tpu.models.cpc import cpc_apply as j_cpc_apply
from feature_level_style_transfer_for_tsc_tpu.ops import batchnorm as j_bn
from feature_level_style_transfer_for_tsc_tpu.parallel import MultiSourceEnsemble as JEnsemble
from feature_level_style_transfer_for_tsc_tpu.parallel import mesh as j_mesh
from feature_level_style_transfer_for_tsc_tpu.train import classifier as jax_classifier
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import BNStats, batch_norm
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch
from feature_level_style_transfer_for_tsc_tpu_torch.train import jax_state
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import OSCNNClassifier

P = 4
B = 8
T_SHAPE, S_SHAPE = (2, 16, 2), (1, 12, 3)
ANCHORS = (2, 1)
KW = dict(batch_size=B, max_kernel_size=5, cdan_dim=32, cpc_hidden=8, budget_multiplier=0.02)
FLOW = dict(n_flows=2, wn_channels=16, wn_layers=8)
CLF_SHAPE = (2, 16, 3)
CLF_KW = dict(batch_size=B, max_kernel_size=5, budget_multiplier=0.02, cpc_hidden=8)
ENS_SHAPE = (1, 24, 3)
ENS_KW = dict(batch_size=8, max_kernel_size=7, budget_multiplier=0.02)
LOSS_TOL = {"rtol": 1e-4, "atol": 1e-5}
STATE_TOL = {"rtol": 1e-4, "atol": 1e-5}
DROPOUT_SEED = 5
# A second RMSprop step divides a gradient by the first step's: within the step's gradient gate
# (atol 1e-5 * max|g| = 1.7e-4 here) the second phase-5 step moved s_ext's shortcut weights
# 2.0e-5 from the unsharded step's.
SECOND_STEP_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here, as in the ranks: the suite runs several
    worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batches(rng, nb, shape):
    c, t, n = shape
    return (rng.standard_normal((nb, B, t, c)).astype(np.float32),
            rng.integers(0, n, (nb, B)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_patched():
    """The JAX pipeline's CPC anchors pinned and its critic's dropout the
    identity, from the test only (no JAX file changes)."""
    mp = pytest.MonkeyPatch()
    cpc_apply, cpc_apply_pair = jax_pipeline.cpc_apply, jax_pipeline.cpc_apply_pair
    mp.setattr(jax_pipeline, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHORS[0]))
    mp.setattr(jax_pipeline, "cpc_apply_pair",
               lambda p, a, b, r1, r2, anchors=None: cpc_apply_pair(p, a, b, r1, r2, anchors=ANCHORS))
    mp.setattr(jax_critics, "dropout", lambda key, x, rate, training: x)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def setup(jax_patched):
    """The JAX models and states, the batches, and the cases the ranks run."""
    rng = np.random.default_rng(0)
    jpipe = jax_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, JaxConfig(**KW, flow=JaxFlow(**FLOW)))
    jstate = jpipe.init_state(jax.random.PRNGKey(0))
    jclf = jax_classifier.OSCNNClassifier(*CLF_SHAPE, config=JaxConfig(**CLF_KW), with_cpc=False)
    jcstate = jclf.init_state(jax.random.PRNGKey(1))
    xt, yt = _batches(rng, 2, T_SHAPE)
    xs, ys = _batches(rng, 2, S_SHAPE)
    clf_xb, clf_yb = _batches(rng, 2, CLF_SHAPE)
    ens_clf = jax_classifier.OSCNNClassifier(*ENS_SHAPE, config=JaxConfig(**ENS_KW), with_cpc=False)
    members = []
    for seed in range(4):
        st = ens_clf.init_state(jax.random.PRNGKey(seed))
        members.append({"params": st["params"], "mstate": st["mstate"]})
    ens = {"shape": ENS_SHAPE, "kw": ENS_KW, "members": [_flat(m) for m in members],
           "train_x": rng.standard_normal((20, 24, 1)).astype(np.float32),
           "train_y": rng.integers(0, 3, 20).astype(np.int32),
           "test_x": rng.standard_normal((12, 24, 1)).astype(np.float32),
           "test_y": rng.integers(0, 3, 12).astype(np.int32)}
    cases = {
        "placement": {"x": np.arange(32, dtype=np.float32).reshape(8, 4), "xb": xt, "yb": yt},
        "bn": {"x": rng.standard_normal((B, 16, 5)).astype(np.float32),
               "r": rng.standard_normal((B, 16, 5)).astype(np.float32),
               "scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
               "bias": rng.standard_normal(5).astype(np.float32),
               "mean": rng.standard_normal(5).astype(np.float32),
               "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)},
        "clf_shape": CLF_SHAPE, "clf_kw": CLF_KW, "clf_state": _flat(jcstate),
        "clf_xb": clf_xb, "clf_yb": clf_yb,
        "pipe": {"t_shape": T_SHAPE, "s_shape": S_SHAPE, "kw": KW, "flow": FLOW,
                 "models": _flat({k: jstate[k] for k in ("params", "mstate", "consts")})},
        "xt": xt, "yt": yt, "xs": xs, "ys": ys, "anchors": ANCHORS,
        "masks": [[np.ones((B, 1024), np.float32)] * 2] * 2, "dropout_seed": DROPOUT_SEED,
        "ensemble": ens,
    }
    return {"jpipe": jpipe, "jstate": jstate, "jclf": jclf, "jcstate": jcstate,
            "members": members, "cases": cases}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory, request):
    """Each rank's results: the 4 gloo ranks, spawned once; the JAX side
    and the port's unsharded runs are computed here while they run."""
    rdv = tmp_path_factory.mktemp("rendezvous") / "store"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, rank_main, P, (f"file://{rdv}", setup["cases"]),
                            timeout=300)
        for name in ("phase5_jax", "phase1_jax", "classifier_jax", "phase5_unsharded"):
            request.getfixturevalue(name)
        return ranks.result()


def _same_bits(results, path):
    """Every rank's value at ``path`` (a tree of arrays and numbers) the
    same bits, returned."""
    def at(r):
        for p in path:
            r = r[p]
        return r

    first = at(results[0])

    def equal(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        if a is None or b is None:
            return a is b
        return np.array_equal(np.asarray(a), np.asarray(b))

    for r, res in enumerate(results[1:], 1):
        assert equal(at(res), first), f"rank {r} differs from rank 0 at {path}"
    return first


def _flat_grads(by_module):
    """``{key: gradient}`` of steps' ``{module: {key: gradient}}``."""
    return {k: g for gs in by_module.values() for k, g in gs.items()}


def _close_grads(got, want, what, atol_rel=1e-5, rtol=1e-3):
    """Each module's gradients (``{module: {key: array or None}}``, None a
    zero) against ``want`` (``{key: array or None}``): rtol, and atol
    ``atol_rel`` * max|g| over the whole step."""
    scale = max(float(np.abs(w).max()) for w in want.values() if w is not None)
    for k, g in _flat_grads(got).items():
        w = want[k]
        w = np.zeros_like(g) if w is None else np.asarray(w)
        g = np.zeros_like(w) if g is None else g
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * scale, err_msg=f"{what}: {k}")


def _check_params(got_flat, want_flat, steps, stepped, atol=1e-5):
    """Updated params where every step's gradient is live (module docstring)."""
    for name in stepped:
        keys = list(steps[0][name])
        g_max = max(float(np.abs(s[name][k]).max()) for s in steps for k in keys
                    if s[name][k] is not None)
        for k in keys:
            full = "['params']" + k
            live = np.ones(np.shape(want_flat[full]), bool)
            for s in steps:
                g = s[name][k]
                if g is None:
                    live[...] = False
                    continue
                live &= np.abs(g) > max(1e-6 * g_max, 1e-5)
            np.testing.assert_allclose(got_flat[full][live], np.asarray(want_flat[full])[live],
                                       atol=atol, err_msg=full)


# ------------------------------------------------------- mesh placements --

def test_placements_match_jax_named_shardings(ranks):
    """``data_sharding`` (batch axis 0 and 1), ``domain_sharding`` and
    ``replicated`` placed on the (4, 1) and (2, 2) meshes: each rank keeps
    what JAX's ``NamedSharding`` of the same name puts on the device at its
    mesh coordinate (counterpart of JAX ``test_parallel.py:24-27``)."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    for name, (data, domain) in (("m4", (4, 1)), ("m22", (2, 2))):
        jm = j_mesh.make_mesh(data=data, domain=domain)
        for key, sh in (("data0", j_mesh.data_sharding(jm)),
                        ("data1", j_mesh.data_sharding(jm, batch_axis=1)),
                        ("domain", j_mesh.domain_sharding(jm)), ("replicated", j_mesh.replicated(jm))):
            index = sh.devices_indices_map(x.shape)
            for r, res in enumerate(ranks):
                want = x[index[jm.devices[r // domain, r % domain]]]
                np.testing.assert_array_equal(res["placement"][name][key], want,
                                              err_msg=f"{name} {key} rank {r}")
        assert isinstance(j_mesh.data_sharding(jm), NamedSharding)
        assert ranks[0]["placement"][name]["placements"] == ["S(1)", "R"]


def test_shard_epoch_batches_and_indivisible_batch(ranks, setup):
    """Rank i gets columns [i*B/P, (i+1)*B/P) of the stacked batches (JAX's
    ``P(None, "data")``); a batch P does not divide is refused."""
    c = setup["cases"]["placement"]
    for r, res in enumerate(ranks):
        xb, yb = res["placement"]["epoch_batches"]
        s = B // P
        np.testing.assert_array_equal(xb, c["xb"][:, r * s:(r + 1) * s])
        np.testing.assert_array_equal(yb, c["yb"][:, r * s:(r + 1) * s])
        assert xb.flags.c_contiguous
        assert "not divisible by the 4 ranks" in res["placement"]["indivisible"]


def test_replicate_broadcasts_every_leaf_and_the_generator(ranks):
    """States that differ from rank to rank (seeds, a step of the
    optimizers, scheduler, plateau and GradNorm values) are rank 0's, bit
    for bit, on every rank after ``replicate``: parameters, statistics,
    optimizer moments and counts, learning rates, GradNorm's weights,
    Adam and flag, the generator, whose next draw agrees."""
    for part in ("clf", "pipe"):
        assert any(not np.array_equal(ranks[1]["replicate"]["before"][part][k], v)
                   for k, v in ranks[0]["replicate"]["before"][part].items()), part
    after = _same_bits(ranks, ("replicate", "after"))
    before = ranks[0]["replicate"]["before"]
    for part in ("clf", "pipe", "clf_generator"):
        want = before[part]
        got = after[part]
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{part} {k}")
        else:
            np.testing.assert_array_equal(got, want)
    assert after["gradnorm_initialized"] is True


# -------------------------------------------------- cross-replica BatchNorm --

def test_cross_replica_batch_norm_matches_jax_and_unsharded(ranks, setup):
    """Training-mode ``batch_norm`` under ``bn_cross_replica``: the ranks'
    outputs and input gradients, put together, the new statistics (the same
    on every rank) and the parameter gradients summed over the ranks,
    against JAX's unsharded ``batch_norm`` and the port's."""
    c = setup["cases"]["bn"]
    stats = j_bn.BNStats(jnp.asarray(c["mean"]), jnp.asarray(c["var"]))

    def loss(x, scale, bias):
        y, new = j_bn.batch_norm(x, scale, bias, stats, True)
        return jnp.sum(y * c["r"]), (y, new)

    (_, (jy, jnew)), jg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(c["x"]), jnp.asarray(c["scale"]), jnp.asarray(c["bias"]))
    x = torch.from_numpy(c["x"]).requires_grad_()
    scale, bias = (torch.from_numpy(c[k]).requires_grad_() for k in ("scale", "bias"))
    py, pnew = batch_norm(x, scale, bias, BNStats(torch.from_numpy(c["mean"]),
                                                  torch.from_numpy(c["var"])), True)
    (py * torch.from_numpy(c["r"])).sum().backward()
    got = {"y": np.concatenate([r["bn"]["y"] for r in ranks]),
           "dx": np.concatenate([r["bn"]["dx"] for r in ranks]),
           "mean": _same_bits(ranks, ("bn", "mean")), "var": _same_bits(ranks, ("bn", "var")),
           "dscale": sum(r["bn"]["dscale"] for r in ranks),
           "dbias": sum(r["bn"]["dbias"] for r in ranks)}
    for want in ({"y": jy, "mean": jnew.mean, "var": jnew.var, "dx": jg[0], "dscale": jg[1],
                  "dbias": jg[2]},
                 {"y": py, "mean": pnew.mean, "var": pnew.var, "dx": x.grad, "dscale": scale.grad,
                  "dbias": bias.grad}):
        for k, v in want.items():
            v = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(v).max()),
                                       err_msg=k)


# ------------------------------------------------------------ classifier --

@pytest.fixture(scope="module")
def classifier_jax(setup):
    jclf, jcstate, c = setup["jclf"], setup["jcstate"], setup["cases"]

    def grads_fn(params, mstate, x, y, rng):
        g, _ = jax.grad(jclf._loss, has_aux=True)(params, mstate, x, y, rng)
        return g

    g0 = jax.jit(grads_fn)(jcstate["params"], jcstate["mstate"], jnp.asarray(c["clf_xb"][0]),
                           jnp.asarray(c["clf_yb"][0]), jax.random.PRNGKey(7))
    jnew, jm = jclf.train_epoch(jcstate, jnp.asarray(c["clf_xb"]), jnp.asarray(c["clf_yb"]))
    return g0, jnew, jm


def test_classifier_dp_grads_match_jax(ranks, classifier_jax):
    """The first step's gradients, summed over the ranks, against JAX's
    single-device gradients at JAX's atol 1e-5 (``test_parallel.py:30-61``);
    the ranks' the same bits."""
    g0, _, _ = classifier_jax
    got = _flat_grads(_same_bits(ranks, ("classifier", "steps"))[0])
    want = _flat(g0)
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], atol=1e-5, err_msg=k)


def test_classifier_dp_epoch_matches_jax_and_unsharded(ranks, classifier_jax, setup):
    """A two-batch ``dp.train_epoch`` against JAX's single-device epoch and
    the port's unsharded one: the epoch means, the parameters (the rule of
    the module docstring), the epoch counter; the ranks' states the same
    bits."""
    _, jnew, jm = classifier_jax
    res = ranks[0]["classifier"]
    state = _same_bits(ranks, ("classifier", "state"))
    np.testing.assert_allclose(res["metrics"]["c_loss"], float(jm["c_loss"]), **LOSS_TOL)
    assert res["metrics"]["sl_loss"] == 0.0
    want = _flat(jnew)
    _check_params(state, want, res["steps"], ("ext", "cls"))
    assert int(state["['epoch']"]) == 1
    c = setup["cases"]
    clf = OSCNNClassifier(*CLF_SHAPE, config=PipelineConfig(**CLF_KW), with_cpc=False, device="cpu")
    pstate = jax_state.load_classifier_state(clf.init_state(torch.Generator().manual_seed(1)),
                                             c["clf_state"])
    pm = clf.train_epoch(pstate, c["clf_xb"], c["clf_yb"])
    np.testing.assert_allclose(res["metrics"]["c_loss"], float(pm["c_loss"]), rtol=0, atol=1e-5)
    _check_params(state, jax_state.classifier_state_to_flat(pstate), res["steps"], ("ext", "cls"))


# ---------------------------------------------------------------- phase 1 --

@pytest.fixture(scope="module")
def phase1_jax(setup):
    jpipe, jstate, c = setup["jpipe"], setup["jstate"], setup["cases"]
    x, y = jnp.asarray(c["xt"][0]), jnp.asarray(c["yt"][0])

    def single_loss(params):
        feat, _ = jpipe.target_features(params, jstate["mstate"], x, True)
        logits, _, _ = jpipe.classify_target(params, jstate["mstate"], feat, True)
        return j_ce(logits, y) + j_cpc_apply(params["cpc"], feat, jax.random.PRNGKey(7),
                                             anchor=ANCHORS[0])

    g0 = jax.jit(jax.grad(single_loss))(jstate["params"])
    jnew, jm = jpipe.phase1_epoch(jstate, jnp.asarray(c["xt"]), jnp.asarray(c["yt"]))
    return g0, jnew, jm


def test_phase1_dp_grads_match_jax(ranks, phase1_jax):
    """``make_dp_phase1_epoch``'s first step: the gradient all-reduce, the
    cross-replica BatchNorm moments and the all-gathered InfoNCE columns
    give JAX's single-device gradients (counterpart of JAX
    ``test_dp_explicit.py:83-144``)."""
    g0, _, _ = phase1_jax
    steps = _same_bits(ranks, ("phase1", "steps"))
    want = _flat(g0)
    want = {k: v for k, v in want.items() if k.startswith(("['t_ext']", "['t_cls']", "['cpc']"))}
    assert set(_flat_grads(steps[0])) == set(want)
    _close_grads(steps[0], want, "phase-1 step")


def test_phase1_dp_epoch_matches_jax_and_unsharded(ranks, phase1_jax, setup):
    """The two-batch DP phase-1 epoch against JAX's single-device
    ``phase1_epoch`` (counterpart of JAX ``test_dp_explicit.py:32-80``):
    metrics, the StepLR counts; and against the port's unsharded epoch:
    metrics and parameters; the ranks' states the same bits.  (The port's own unsharded epoch sits up to 4.8e-3 from JAX's in
    t_cls's conv weights: a first step's flipped noise-level update carried
    into the second step; see the module docstring.)"""
    _, jnew, jm = phase1_jax
    res = ranks[0]["phase1"]
    state = _same_bits(ranks, ("phase1", "state"))
    for k in jm:
        np.testing.assert_allclose(res["metrics"][k], float(jm[k]), **LOSS_TOL, err_msg=k)
    for n in ("t_ext", "t_cls", "cpc"):
        assert int(state[f"['sched']['{n}']"]) == int(jnew["sched"][n]) == 1
    pipe = pipeline(setup["cases"]["pipe"])
    pstate = pipe_state(pipe, setup["cases"]["pipe"])
    c = setup["cases"]
    pm = pipe.phase1_epoch(pstate, c["xt"], c["yt"], cpc_anchor=ANCHORS[0])
    for k in pm:
        np.testing.assert_allclose(res["metrics"][k], float(pm[k]), rtol=0, atol=1e-5, err_msg=k)
    _check_params(state, jax_state.state_to_flat(pstate), res["steps"], ("t_ext", "t_cls", "cpc"))


# ---------------------------------------------------------------- phase 5 --

@pytest.fixture(scope="module")
def phase5_jax(setup):
    """JAX's single-device phase-5 step (the 9 losses, the total's
    gradients, n_t and n_s from a ``jax.vjp`` pulled with the one-hot seeds
    of JAX ``train/pipeline.py:709-744``, the new GradNorm weights) and
    its two-batch ``phase5_epoch``."""
    jpipe, jstate, c = setup["jpipe"], setup["jstate"], setup["cases"]
    names = ("t_nf", "t_c", "s_nf", "s_c", "s2t2s_c")
    gw_t, gw_s = jstate["gradnorm"]["t"].weights, jstate["gradnorm"]["s"].weights
    w = jpipe._staged_weights(0)

    def all_losses(p):
        losses, _, _ = jpipe._phase5_forward(
            p, jstate["mstate"], jstate["consts"], *(jnp.asarray(c[k][0]) for k in ("xt", "yt", "xs", "ys")),
            jax.random.PRNGKey(1), cpc_anchors=ANCHORS)
        total = (jnp.sum(gw_t * jnp.stack([losses["t_nf"], losses["t_c"]]))
                 + jnp.sum(gw_s * jnp.stack([losses["s_nf"], losses["s_c"], losses["s2t2s_c"]]))
                 + w[0] * losses["cdan"] + w[1] * losses["fd"] + w[2] * losses["t_sl"]
                 + w[3] * losses["s_sl"])
        return jnp.stack([total] + [losses[n] for n in names]), losses

    @jax.jit
    def pulls(params):  # jitted: eager, the vjp took a minute
        _, pullback, losses = jax.vjp(all_losses, params, has_aux=True)
        eye = jnp.eye(6)
        return losses, [pullback(seed)[0] for seed in (eye[0], eye[1] + eye[3], eye[2] + eye[4], eye[5])]

    def trunk_norm(g, key):
        return float(sum(jnp.linalg.norm(leaf.reshape(-1))
                         for leaf in jax.tree_util.tree_leaves(g[key]["block"])))

    jlosses, (g_total, g_nf, g_c, g_5) = pulls(jstate["params"])
    n_t = jnp.asarray([trunk_norm(g_nf, "t_ext"), trunk_norm(g_c, "t_ext")])
    n_s = jnp.asarray([trunk_norm(g_nf, "s_ext"), trunk_norm(g_c, "s_ext"), trunk_norm(g_5, "s_ext")])
    g = jpipe.config.gradnorm
    gn_t = jax_gradnorm.gradnorm_step(jstate["gradnorm"]["t"], jnp.stack([jlosses["t_nf"], jlosses["t_c"]]),
                                      n_t, jpipe.tx_weights_t, alpha=g.alpha, weight_sum=g.weights_t_sum)
    gn_s = jax_gradnorm.gradnorm_step(
        jstate["gradnorm"]["s"], jnp.stack([jlosses[k] for k in ("s_nf", "s_c", "s2t2s_c")]), n_s,
        jpipe.tx_weights_s, alpha=g.alpha, weight_sum=g.weights_s_sum)
    step = {"losses": {k: float(v) for k, v in jlosses.items()}, "grads": _flat(g_total),
            "n_t": np.asarray(n_t), "n_s": np.asarray(n_s),
            "w_t": np.asarray(gn_t.weights), "w_s": np.asarray(gn_s.weights)}
    jnew, jm = jpipe.phase5_epoch(jstate, *(jnp.asarray(c[k]) for k in ("xt", "yt", "xs", "ys")),
                                  jnp.asarray(0))
    return step, jnew, jm


@pytest.fixture(scope="module")
def phase5_unsharded(setup):
    """The port's unsharded pinned two-batch epoch, each step recorded."""
    c = setup["cases"]
    pipe = pipeline(c["pipe"])
    state = pipe_state(pipe, c["pipe"])
    steps = recording_phase5(pipe)
    masks = [[torch.ones(B, 1024)] * 2] * 2
    metrics = pipe.phase5_epoch(state, c["xt"], c["yt"], c["xs"], c["ys"], 0,
                                cpc_anchors=ANCHORS, dropout_masks=masks)
    return steps, metrics, jax_state.state_to_flat(state)


def test_phase5_dp_step_matches_jax(ranks, phase5_jax):
    """One data-parallel phase-5 step (the first of the pinned epoch): the
    9 global losses, n_t, n_s, every module's summed gradients and the new
    GradNorm weights against JAX's single-device step, in the pattern of
    ``test_phase5_grads_and_trunk_norms_match_jax``; the ranks' the same
    bits."""
    want, _, _ = phase5_jax
    got = _same_bits(ranks, ("phase5", "steps"))[0]
    assert set(got["losses"]) == set(want["losses"]) and len(got["losses"]) == 9
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, **LOSS_TOL, err_msg=k)
    for k in ("n_t", "n_s", "w_t", "w_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    assert set(_flat_grads(got["grads"])) == set(want["grads"])
    _close_grads(got["grads"], want["grads"], "phase-5 step")


def test_phase5_dp_step_matches_unsharded(ranks, phase5_unsharded):
    """The same step against the port's unsharded step: losses and trunk
    norms atol 1e-5, gradients atol 1e-5 * max|g|."""
    want = phase5_unsharded[0][0]
    got = ranks[0]["phase5"]["steps"][0]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=0, atol=1e-5, err_msg=k)
    for k in ("n_t", "n_s", "w_t", "w_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    _close_grads(got["grads"], _flat_grads(want["grads"]), "phase-5 step vs unsharded", rtol=0)


def test_phase5_dp_step_with_drawn_dropout_matches_unsharded(ranks, setup):
    """A step whose CPC anchors and critic dropout are drawn from the
    replicated generator (the global batch's masks drawn on every rank and
    sliced) against the port's unsharded step from the same generator:
    losses, norms, gradients, new model state, and the generator after."""
    c = setup["cases"]
    got = _same_bits(ranks, ("phase5_dropout",))
    pipe = pipeline(c["pipe"])
    state = pipe_state(pipe, c["pipe"], seed=DROPOUT_SEED)
    losses, new_m, _, grads, n_t, n_s = pipe.phase5_grads(
        state, *(torch.from_numpy(c[k][0]) for k in ("xt",)), torch.from_numpy(c["yt"][0]).long(),
        torch.from_numpy(c["xs"][0]), torch.from_numpy(c["ys"][0]).long(), 0)
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][k], float(v), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["n_t"], n_t.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["n_s"], n_s.numpy(), rtol=0, atol=1e-5)
    want = _flat_grads(keyed(state["params"], grads))
    _close_grads(got["grads"], want, "phase-5 step with dropout vs unsharded", rtol=0)
    from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten

    for k, v in flatten(new_m).items():
        np.testing.assert_allclose(got["new_m"][k], v, **STATE_TOL, err_msg=k)
    np.testing.assert_array_equal(got["generator"], state["generator"].get_state().numpy())
    # the draw differs from the pinned step's: the dropout is live
    assert got["losses"]["cdan"] != ranks[0]["phase5"]["steps"][0]["losses"]["cdan"]


def test_phase5_dp_second_step_matches_unsharded(ranks, setup):
    """The epoch's second step against the port's unsharded step from the
    DP run's own state after the first (restored by ``state_from_flat``),
    so that the first step's noise-level updates do not carry in: the
    global losses, n_t, n_s, gradients, new GradNorm weights, and the state
    after it (the noise transfer's second call, with its global counts, the
    critics' counters, the statistics, the parameters)."""
    c = setup["cases"]
    first, got = _same_bits(ranks, ("phase5", "steps"))
    pipe = pipeline(c["pipe"])
    state = pipe.state_from_flat(first["state"])
    batch = (torch.from_numpy(c["xt"][1]), torch.from_numpy(c["yt"][1]).long(),
             torch.from_numpy(c["xs"][1]), torch.from_numpy(c["ys"][1]).long())
    steps = recording_phase5(pipe)
    pipe.phase5_step(state, *batch, 0, cpc_anchors=ANCHORS, dropout_masks=[[torch.ones(B, 1024)] * 2] * 2)
    want = steps[0]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=0, atol=1e-5, err_msg=k)
    for k in ("n_t", "n_s", "w_t", "w_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    _close_grads(got["grads"], _flat_grads(want["grads"]), "second phase-5 step", rtol=0)
    _check_params(got["state"], want["state"], [got["grads"]], port_pipeline.ALL_MODULES,
                  atol=SECOND_STEP_ATOL)
    for k in (k for k in want["state"] if k.startswith(("['mstate']", "['gradnorm']"))):
        np.testing.assert_allclose(got["state"][k], want["state"][k], **STATE_TOL, err_msg=k)
    assert int(got["state"]["['mstate']['noise'].time"]) == 2
    assert int(got["state"]["['mstate']['noise'].cal_num_target"]) == 2 * B


def test_phase5_dp_epoch_matches_jax_and_unsharded(ranks, phase5_jax, phase5_unsharded):
    """The pinned two-batch DP ``phase5_epoch`` against JAX's single-device
    ``phase5_epoch`` and the port's unsharded one: the metrics, GradNorm
    weights, plateau states and StepLR counts; the ranks' states the same
    bits.  (Its parameters are held step by step, above: over two steps a
    first step's flipped noise-level update moves the second step's
    gradients, and the parameters after the epoch sat up to 2.8e-3 from the
    port's unsharded epoch's, 1.4e-3 from JAX's.)"""
    _, jnew, jm = phase5_jax
    _, u_metrics, u_state = phase5_unsharded
    res = ranks[0]["phase5"]
    state = _same_bits(ranks, ("phase5", "state"))
    assert set(res["metrics"]) == set(jm)
    for k in jm:
        np.testing.assert_allclose(res["metrics"][k], np.asarray(jm[k]), **LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(res["metrics"][k], u_metrics[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    for g in ("t", "s"):
        np.testing.assert_allclose(state[f"['gradnorm']['{g}'].weights"],
                                   np.asarray(jnew["gradnorm"][g].weights), **LOSS_TOL)
    for name in port_pipeline.PLATEAU_MODULES:
        assert int(state[f"['plateau']['{name}'].num_bad"]) == int(jnew["plateau"][name].num_bad)
        np.testing.assert_allclose(state[f"['plateau']['{name}'].best"],
                                   float(jnew["plateau"][name].best), **LOSS_TOL)
        np.testing.assert_allclose(state[f"['plateau']['{name}'].best"],
                                   u_state[f"['plateau']['{name}'].best"], rtol=0, atol=1e-5)
    for name in port_pipeline.PHASE5_STEPLR:
        assert int(state[f"['sched']['{name}']"]) == int(jnew["sched"][name]) == 1


# -------------------------------------------------------------- ensemble --

@pytest.mark.parametrize("members", [4, 3])
def test_domain_sharded_ensemble_matches_jax_sequential(ranks, setup, members):
    """``MultiSourceEnsemble(..., mesh=make_mesh(data=1, domain=M))``, each
    rank its own member, against JAX's sequential ensemble: the same
    predictions, accuracies and vote variants, class weights within 1e-6
    (JAX ``test_parallel.py:94-125``; 3 members on a 3-rank sub-mesh, the
    fourth rank off it); every rank's results the same bits."""
    key = f"ensemble{members}"
    on_mesh = [r[key] for r in ranks if r[key] is not None]
    assert len(on_mesh) == members and all(r["local_members"] == 1 for r in on_mesh)
    if members == 3:
        assert ranks[3][key] is None
    got = _same_bits([{"e": r} for r in on_mesh], ("e",))
    c = setup["cases"]["ensemble"]
    seq = JEnsemble(*ENS_SHAPE, config=JaxConfig(**ENS_KW))

    class Split:
        def __init__(self, x, y):
            self.x, self.y = x, y

    want = seq.evaluate(seq.stack(setup["members"][:members]), Split(c["train_x"], c["train_y"]),
                        Split(c["test_x"], c["test_y"]))
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    assert got["ensemble_acc"] == want["ensemble_acc"]
    assert got["member_accs"] == want["member_accs"]
    assert got["vote_variants"] == want["vote_variants"]
    np.testing.assert_allclose(got["class_weights"], want["class_weights"], atol=1e-6)


# -------------------------------------------------------------- refusals --

@pytest.mark.parametrize("what", ["merged_pullbacks", "stacked_pullbacks", "fused_optimizers",
                                  "compute_dtype", "FLSTTSC_WN_MXU", "FLSTTSC_WN_FUSED",
                                  "multirun", "multirun_phase1", "ensemble_indivisible"])
def test_refusals(ranks, what):
    """Phase 5 data-parallel under a non-default knob, either bf16 switch or
    the op-by-op WN route runs: the step that raised ``ValueError`` until
    these ran data-parallel gives finite global losses, the same bits on
    every rank (``tests/test_torch_port_dp_knobs.py`` holds them against
    JAX and the unsharded step).  The multirun raises ``ValueError``: the JAX
    package has no data-parallel multirun; an ensemble whose members the
    domain axis does not divide is refused as JAX's ``device_put`` refuses
    it."""
    if what not in ("multirun", "multirun_phase1", "ensemble_indivisible"):
        runs = _same_bits(ranks, ("refusals", what))
        assert runs[0] is None, runs[0]
        assert len(runs[1]) == 9 and all(np.isfinite(v) for v in runs[1].values()), runs[1]
        return
    for r in ranks:
        msg = r["refusals"][what]
        assert msg is not None, what
        if what == "ensemble_indivisible":
            assert "not divisible by the 4 ranks of mesh axis 'domain'" in msg
        else:
            assert ("does not run data-parallel: the JAX package has no data-parallel "
                    "multirun") in msg
