"""The archive sweep's training path against the JAX package's, on the CPU.

Covers ``OSCNNClassifier`` training (``train_epoch`` with and without CPC,
``evaluate``, ``fit``), the padded OS-CNN (``models/os_cnn_padded.py``),
``BucketedOSCNNClassifier`` (``train_batch``, its schedulers,
``evaluate``), the bucket keys, the state carried between the packages
(``jax_state.classifier_state_to_flat`` / ``load_classifier_state``) and
``cli.archive_sweep`` in both modes.  Tiny models (``budget_multiplier``
0.02, ``max_kernel_size`` 5, batch 6).

Both packages start from one JAX-made state, carried into the port with
``load_classifier_state``.  Randomness is pinned from the test only: the JAX
classifier's ``cpc_apply`` is patched to a fixed anchor, the port gets the
same anchor (``cpc_anchors``), and both get the same stacked batches.  No
JAX file changes.

Tolerances (f32 on both sides, sums in another order): losses and state
(BatchNorm statistics, optimizer moments) rtol 1e-4, atol 1e-5; outputs rel
1e-5 (padded against unpadded, and against JAX); updated parameters atol
1e-5 where every step's |g| > max(1e-6 * max|g|, 1e-5) (an RMSprop first
step moves a weight by about lr * 10 * sign(g) whatever the size of g, so a
gradient at noise level may flip its step; see
``test_torch_port_train_phases.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.cli import archive_sweep as jax_sweep
from feature_level_style_transfer_for_tsc_tpu.config import OptimConfig as JaxOptim
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.models import os_block_masks as jax_masks
from feature_level_style_transfer_for_tsc_tpu.models import os_cnn_init as jax_cnn_init
from feature_level_style_transfer_for_tsc_tpu.models import os_cnn_padded as jax_padded
from feature_level_style_transfer_for_tsc_tpu.models import os_cnn_res_init as jax_res_init
from feature_level_style_transfer_for_tsc_tpu.train import bucketed as jax_bucketed
from feature_level_style_transfer_for_tsc_tpu.train import classifier as jax_classifier
from feature_level_style_transfer_for_tsc_tpu_torch.cli import archive_sweep
from feature_level_style_transfer_for_tsc_tpu_torch.config import OptimConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.data.dataset import TsClassificationData
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import (
    flatten,
    from_jax_params,
    tree_items,
)
from feature_level_style_transfer_for_tsc_tpu_torch.losses.classification import cross_entropy
from feature_level_style_transfer_for_tsc_tpu_torch.models import os_cnn, os_cnn_padded
from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import MultiSourceEnsemble
from feature_level_style_transfer_for_tsc_tpu_torch.train import bucketed
from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import OSCNNClassifier
from feature_level_style_transfer_for_tsc_tpu_torch.train.jax_state import (
    classifier_state_to_flat,
    load_classifier_state,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves

KW = dict(batch_size=6, max_kernel_size=5, budget_multiplier=0.02, cpc_hidden=8)
SHAPE = (2, 16, 3)  # C, T, classes
B = KW["batch_size"]
ANCHOR = 2  # < (16 // 2) // 2
LOSS_TOL = {"rtol": 1e-4, "atol": 1e-5}
STATE_TOL = {"rtol": 1e-4, "atol": 1e-5}
OUT_TOL = {"rtol": 1e-5, "atol": 1e-6}
SPECS = [[(3, 4, 1), (3, 4, 3), (3, 4, 5)], [(12, 5, 1), (12, 5, 2)]]  # tests/test_bucketing.py's
T_REAL, T_BUCKET = 19, 32
RESULT_KEYS = {"test_acc", "train_acc", "n_train", "C", "T", "classes", "wall_s"}


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
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batches(seed, nb, t=SHAPE[1], c=SHAPE[0], n_class=SHAPE[2]):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nb, B, t, c)).astype(np.float32),
            rng.integers(0, n_class, (nb, B)).astype(np.int32))


def _recording(model, monkeypatch):
    """Each optimizer step's gradients, by module, one list a step."""
    seen = []
    apply = model._apply_updates

    def record(state, names, grads):
        seen.append({n: [None if g is None else g.clone() for g in grads[n]] for n in names})
        return apply(state, names, grads)

    monkeypatch.setattr(model, "_apply_updates", record)
    return seen


def _check_params(want, params, steps):
    """Updated params against ``want`` (flat) where every step's gradient
    is live."""
    assert set(flatten(params)) == set(want)
    for name in steps[0]:
        g_max = max(float(g.abs().max()) for s in steps for g in s[name] if g is not None)
        index = {id(t): i for i, t in enumerate(leaves(params[name]))}
        for key, t in tree_items(params[name], f"[{name!r}]"):
            live = np.ones(t.shape, bool)
            for s in steps:
                g = s[name][index[id(t)]]
                g = np.zeros(t.shape, np.float32) if g is None else g.numpy()
                live &= np.abs(g) > max(1e-6 * g_max, 1e-5)
            np.testing.assert_allclose(t.detach().numpy()[live], want[key][live], atol=1e-5,
                                       err_msg=key)


def _check_state(want_state, pstate, modules):
    """mstate, optimizer moments, learning rates and the epoch."""
    want, got = _flat({k: want_state[k] for k in ("mstate", "opt", "epoch")}), \
        classifier_state_to_flat(pstate)
    got = {k: v for k, v in got.items() if not k.startswith(("['params']", "['rng']"))}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   **STATE_TOL, err_msg=k)
    assert sorted(pstate["opt"]) == sorted(modules)


# --------------------------------------------------- OSCNNClassifier -------

@pytest.mark.parametrize("with_cpc", [True, False])
def test_train_epoch_matches_jax(with_cpc, monkeypatch):
    orig = jax_classifier.cpc_apply
    monkeypatch.setattr(jax_classifier, "cpc_apply", lambda p, f, r: orig(p, f, r, anchor=ANCHOR))
    jclf = jax_classifier.OSCNNClassifier(*SHAPE, config=JaxConfig(**KW), with_cpc=with_cpc)
    jstate = jclf.init_state(jax.random.PRNGKey(0))
    pclf = OSCNNClassifier(*SHAPE, config=PipelineConfig(**KW), with_cpc=with_cpc, device="cpu")
    pstate = load_classifier_state(pclf.init_state(torch.Generator().manual_seed(1)), _flat(jstate))
    assert pstate["epoch"] == 0 and ("cpc" in pstate["params"]) == with_cpc
    xb, yb = _batches(0, 1)
    jnew, jm = jclf.train_epoch(jstate, jnp.asarray(xb), jnp.asarray(yb))
    steps = _recording(pclf, monkeypatch)
    pm = pclf.train_epoch(pstate, xb, yb, cpc_anchors=[ANCHOR])
    for k in ("c_loss", "sl_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), **LOSS_TOL, err_msg=k)
    assert (float(pm["sl_loss"]) != 0.0) == with_cpc
    _check_params(_flat(jnew["params"]), pstate["params"], steps)
    _check_state(jnew, pstate, pclf.modules)
    # a second epoch of two batches: the epoch means.  (Its parameters and
    # statistics are not compared: a noise-level gradient's flipped first
    # step moves an OS conv bias, and the BatchNorm running mean with it.)
    xb, yb = _batches(1, 2)
    _, jm = jclf.train_epoch(jnew, jnp.asarray(xb), jnp.asarray(yb))
    pm = pclf.train_epoch(pstate, xb, yb, cpc_anchors=[ANCHOR, ANCHOR])
    for k in ("c_loss", "sl_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), **LOSS_TOL, err_msg=k)
    assert len(steps) == 3 and pstate["epoch"] == 2
    # and back: the port's state restores into a fresh JAX-shaped port state
    again = load_classifier_state(pclf.init_state(torch.Generator().manual_seed(2)),
                                  classifier_state_to_flat(pstate))
    for k, v in flatten(again["params"]).items():
        np.testing.assert_array_equal(v, flatten(pstate["params"])[k], err_msg=k)
    assert again["epoch"] == 2


def test_predict_and_evaluate_match_jax():
    jclf = jax_classifier.OSCNNClassifier(*SHAPE, config=JaxConfig(**KW), with_cpc=False)
    jstate = jclf.init_state(jax.random.PRNGKey(3))
    pclf = OSCNNClassifier(*SHAPE, config=PipelineConfig(**KW), with_cpc=False, device="cpu")
    pstate = load_classifier_state(pclf.init_state(torch.Generator().manual_seed(1)), _flat(jstate))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((15, SHAPE[1], SHAPE[0])).astype(np.float32)  # 15 = 2 batches + 3
    y = rng.integers(0, SHAPE[2], 15).astype(np.int32)
    want = np.asarray(jclf.predict_logits(jstate["params"], jstate["mstate"], jnp.asarray(x)))
    got = pclf.predict_logits(pstate["params"], pstate["mstate"], x).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
    assert pclf.evaluate(pstate, x, y) == jclf.evaluate(jstate, x, y)
    assert pclf.evaluate(pstate, x, y, batch_size=4) == jclf.evaluate(jstate, x, y, batch_size=4)


def test_fit_schedule_and_history_keys():
    """StepLR every ``steplr_step`` epochs from the epoch counter, CPC's by
    its own gamma; a record per epoch with the JAX package's keys."""
    optim = dict(steplr_step=1, steplr_gamma=0.5, cpc_steplr_gamma=0.25)
    cfg = PipelineConfig(**KW, eval_every=2, optim=OptimConfig(**optim))
    x, y = make_arrays(14, SHAPE[0], SHAPE[1], SHAPE[2], seed=0)
    ds = TsClassificationData(arrays=(x, y), is_train=True)
    state, history = OSCNNClassifier(*SHAPE, config=cfg, device="cpu").fit(ds, ds, epochs=3,
                                                                          verbose=False)
    assert state["epoch"] == 3 and sorted(state["opt"]) == ["cls", "cpc", "ext"]
    o = JaxOptim(**optim)
    for m, base, gamma in (("ext", o.lr_target_ext, 0.5), ("cls", o.lr_target_cls, 0.5),
                           ("cpc", o.lr_cpc, 0.25)):
        assert state["opt"][m].param_groups[0]["lr"] == pytest.approx(base * gamma ** 3)
    keys = [set(h) for h in history]
    assert keys[1] == {"epoch", "c_loss", "sl_loss"}
    assert keys[0] == keys[2] == {"epoch", "c_loss", "sl_loss", "train_acc", "test_acc"}
    assert all(np.isfinite(h["c_loss"]) and np.isfinite(h["sl_loss"]) for h in history)


def test_members_are_built_without_cpc():
    """As JAX ``parallel/multi_source.py``: the ensemble's member model has
    no CPC head."""
    ens = MultiSourceEnsemble(*SHAPE, config=PipelineConfig(**KW), device="cpu")
    assert not ens.model_def.with_cpc
    assert set(ens.model_def.init_models(torch.Generator().manual_seed(0))["params"]) == {"ext", "cls"}


# -------------------------------------------------------- padded OS-CNN ----

def _pad(x, t_bucket):
    return np.pad(x, ((0, 0), (0, t_bucket - x.shape[1]), (0, 0)))


def _padded_inputs():
    x = np.random.default_rng(1).standard_normal((4, T_REAL, 3)).astype(np.float32)
    t_valid = torch.tensor(float(T_REAL))
    return x, t_valid, os_cnn_padded.time_mask(T_BUCKET, t_valid)


@pytest.mark.parametrize("training", [True, False])
def test_padded_extractor_matches_jax_and_unpadded(training):
    jp, js = jax_res_init(jax.random.PRNGKey(0), SPECS)
    model = from_jax_params(_flat({"p": jp, "s": js}))
    masks = os_cnn.os_block_masks(SPECS)
    x, t_valid, tmask = _padded_inputs()
    got, got_s = os_cnn_padded.os_cnn_res_apply_padded(
        model["p"], model["s"], masks, torch.from_numpy(_pad(x, T_BUCKET)), training, tmask, t_valid)
    want, want_s = jax_padded.os_cnn_res_apply_padded(
        jp, js, [jnp.asarray(m) for m in jax_masks(SPECS)], jnp.asarray(_pad(x, T_BUCKET)),
        training, jax_padded.time_mask(T_BUCKET, jnp.asarray(float(T_REAL))),
        jnp.asarray(float(T_REAL)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    unpadded, unpadded_s = os_cnn.os_cnn_res_apply(model["p"], model["s"], masks,
                                                   torch.from_numpy(x), training)
    np.testing.assert_allclose(got[:, :T_REAL].numpy(), unpadded.numpy(), **OUT_TOL)
    assert float(got[:, T_REAL:].abs().max()) == 0.0  # the pad stays zero
    for k, v in flatten(got_s).items():
        np.testing.assert_allclose(v, _flat(want_s)[k], **STATE_TOL, err_msg=k)
        np.testing.assert_allclose(v, flatten(unpadded_s)[k], **STATE_TOL, err_msg=k)


def test_padded_classifier_matches_jax_and_unpadded():
    n_real, n_bucket = 3, 8
    jp, js = jax_cnn_init(jax.random.PRNGKey(0), SPECS, n_bucket)
    model = from_jax_params(_flat({"p": jp, "s": js}))
    masks = os_cnn.os_block_masks(SPECS)
    x, t_valid, tmask = _padded_inputs()
    cmask = os_cnn_padded.class_mask(n_bucket, torch.tensor(n_real))
    logits, pooled, _ = os_cnn_padded.os_cnn_apply_padded(
        model["p"], model["s"], masks, torch.from_numpy(_pad(x, T_BUCKET)), True, tmask, t_valid,
        cmask)
    j_logits, j_pooled, _ = jax_padded.os_cnn_apply_padded(
        jp, js, [jnp.asarray(m) for m in jax_masks(SPECS)], jnp.asarray(_pad(x, T_BUCKET)), True,
        jax_padded.time_mask(T_BUCKET, jnp.asarray(float(T_REAL))), jnp.asarray(float(T_REAL)),
        jax_padded.class_mask(n_bucket, jnp.asarray(n_real)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **OUT_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j_pooled), **OUT_TOL)
    small = dict(model["p"], hidden={"weight": model["p"]["hidden"]["weight"][:, :n_real],
                                     "bias": model["p"]["hidden"]["bias"][:n_real]})
    want_logits, want_pooled, _ = os_cnn.os_cnn_apply(small, model["s"], masks,
                                                      torch.from_numpy(x), True)
    np.testing.assert_allclose(logits[:, :n_real].numpy(), want_logits.numpy(), **OUT_TOL)
    np.testing.assert_allclose(pooled.numpy(), want_pooled.numpy(), **OUT_TOL)
    assert float(logits[:, n_real:].max()) < -1e8  # padded classes dead
    y = torch.tensor([0, 1, 2, 1])
    np.testing.assert_allclose(float(cross_entropy(logits, y)), float(cross_entropy(want_logits, y)),
                               **OUT_TOL)


def test_masked_batch_norm_counts_in_float32():
    """n_valid / (n_valid - 1) is float32 arithmetic, as in the JAX package."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 8, 2)).astype(np.float32))
    t_valid = torch.tensor(5.0)
    tmask = os_cnn_padded.time_mask(8, t_valid)
    stats = os_cnn_padded.BNStats(torch.zeros(2), torch.ones(2))
    _, new = os_cnn_padded.masked_batch_norm(x * tmask, torch.ones(2), torch.zeros(2), stats, True,
                                             tmask, 3 * t_valid)
    assert new.var.dtype == torch.float32
    _, j_new = jax_padded.masked_batch_norm(
        jnp.asarray((x * tmask).numpy()), jnp.ones(2), jnp.zeros(2),
        jax_padded.BNStats(jnp.zeros(2), jnp.ones(2)), True,
        jax_padded.time_mask(8, jnp.asarray(5.0)), jnp.asarray(15.0))
    np.testing.assert_allclose(new.var.numpy(), np.asarray(j_new.var), **OUT_TOL)
    np.testing.assert_allclose(new.mean.numpy(), np.asarray(j_new.mean), **OUT_TOL)


# ------------------------------------------------ BucketedOSCNNClassifier --

def test_bucket_keys_match_jax():
    for c, t, n in [(1, 64, 2), (1, 65, 3), (1, 400, 2), (1, 380, 3), (1, 100, 2), (1, 120, 2),
                    (1, 500, 2), (1, 512, 2), (1, 720, 2), (1, 1024, 3), (2, 144, 2), (3, 19, 5)]:
        assert bucketed.bucket_key(c, t, n) == jax_bucketed.bucket_key(c, t, n), (c, t, n)
        assert bucketed.bucket_key(c, t, n, 5) == jax_bucketed.bucket_key(c, t, n, 5)
    assert bucketed.bucket_t(64) == 64 and bucketed.bucket_t(65) == 96
    assert bucketed.bucket_classes(2) == 4 and bucketed.bucket_classes(5) == 8
    # FordA, Earthquakes, Computers share one bucket; StarLightCurves its own length
    assert bucketed.bucket_key(1, 500, 2) == bucketed.bucket_key(1, 720, 2) == (1, 89, 729, 4)
    assert bucketed.bucket_key(1, 1024, 3) == (1, 89, 1094, 4)
    clf = bucketed.BucketedOSCNNClassifier.for_dataset(1, 24, 3, PipelineConfig(**KW), device="cpu")
    assert (clf.rf, clf.t_bucket, clf.class_bucket) == bucketed.bucket_key(1, 24, 3, 5)[1:]


def _bucket_pair(t, n_class, seed=0):
    key = jax_bucketed.bucket_key(SHAPE[0], t, n_class, KW["max_kernel_size"])
    jclf = jax_bucketed.BucketedOSCNNClassifier(*key, config=JaxConfig(**KW))
    jstate = jclf.init_state(jax.random.PRNGKey(seed))
    pclf = bucketed.BucketedOSCNNClassifier(*key, config=PipelineConfig(**KW), device="cpu")
    pstate = load_classifier_state(pclf.init_state(torch.Generator().manual_seed(1)), _flat(jstate))
    return jclf, jstate, pclf, pstate


def test_bucketed_train_batch_and_evaluate_match_jax(monkeypatch):
    t, n_class = 13, 3
    jclf, jstate, pclf, pstate = _bucket_pair(t, n_class)
    assert pclf.t_bucket == 64 and pclf.class_bucket == 4
    xb, yb = _batches(4, 2, t=t, n_class=n_class)
    xb = np.stack([pclf._pad_x(x) for x in xb])
    t_valid, cmask = jnp.asarray(float(t)), jax_padded.class_mask(4, jnp.asarray(n_class))
    steps = _recording(pclf, monkeypatch)
    jstate, j_ce = jclf.train_batch(jstate, jnp.asarray(xb[0]), jnp.asarray(yb[0]), t_valid, cmask)
    p_ce = pclf.train_batch(pstate, xb[0], yb[0], pclf.t_valid(t), pclf.cmask(n_class))
    np.testing.assert_allclose(float(p_ce), float(j_ce), **LOSS_TOL)
    jstate = jclf._step_schedulers(jstate)
    pclf._step_schedulers(pstate)
    _check_params(_flat(jstate["params"]), pstate["params"], steps)
    _check_state(jstate, pstate, bucketed.MODULES)
    # evaluation of JAX's trained state in both (in eval mode a bias whose
    # noise-level gradient flipped its first step is not normalized away)
    trained = load_classifier_state(pclf.init_state(torch.Generator().manual_seed(2)),
                                    _flat(jstate))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((15, t, SHAPE[0])).astype(np.float32)
    y = rng.integers(0, n_class, 15).astype(np.int32)
    assert pclf.evaluate(trained, x, y, n_class) == jclf.evaluate(jstate, x, y, n_class)
    want = jclf.predict_logits(jstate["params"], jstate["mstate"], jnp.asarray(pclf._pad_x(x[:6])),
                               t_valid, cmask)
    got = pclf.predict_logits(trained["params"], trained["mstate"], pclf._pad_x(x[:6]),
                              pclf.t_valid(t), pclf.cmask(n_class))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    # the next batch's loss (its statistics are not compared: see
    # test_train_epoch_matches_jax)
    _, j_ce = jclf.train_batch(jstate, jnp.asarray(xb[1]), jnp.asarray(yb[1]), t_valid, cmask)
    p_ce = pclf.train_batch(pstate, xb[1], yb[1], pclf.t_valid(t), pclf.cmask(n_class))
    np.testing.assert_allclose(float(p_ce), float(j_ce), **LOSS_TOL)


def test_bucketed_step_equals_the_unpadded_step_on_the_same_weights(monkeypatch):
    """One ``train_batch`` at the bucket's length against one unpadded
    ``train_epoch`` step (no CPC) from the same weights, the head cut to
    the dataset's classes: the same loss, BatchNorm statistics and updated
    parameters (where the gradient is live, see the module docstring); the
    dead classes' head columns do not move."""
    t, n_class = 20, 2
    _, jstate, pclf, pstate = _bucket_pair(t, n_class, seed=4)
    flat = _flat(jstate)  # its optimizers have not stepped: no moments to cut
    for k in ("['params']['cls']['hidden']['weight']", "['params']['cls']['hidden']['bias']"):
        flat[k] = flat[k][..., :n_class]
    uclf = OSCNNClassifier(SHAPE[0], t, n_class, config=PipelineConfig(**KW), with_cpc=False,
                           device="cpu")
    assert uclf.ext_specs == pclf.ext_specs
    ustate = load_classifier_state(uclf.init_state(torch.Generator().manual_seed(9)), flat)
    hidden_before = pstate["params"]["cls"]["hidden"]["weight"].detach().clone()
    xb, yb = _batches(8, 1, t=t, n_class=n_class)
    ce = pclf.train_batch(pstate, pclf._pad_x(xb[0]), yb[0], pclf.t_valid(t), pclf.cmask(n_class))
    steps = _recording(uclf, monkeypatch)
    m = uclf.train_epoch(ustate, xb, yb)
    np.testing.assert_allclose(float(ce), float(m["c_loss"]), **OUT_TOL)
    want = {k: v[..., :n_class] if "['hidden']" in k else v
            for k, v in flatten(pstate["params"]).items()}
    _check_params(want, ustate["params"], steps)
    np.testing.assert_array_equal(pstate["params"]["cls"]["hidden"]["weight"][:, n_class:].detach(),
                                  hidden_before[:, n_class:])
    for k, v in flatten(ustate["mstate"]).items():
        np.testing.assert_allclose(flatten(pstate["mstate"])[k], v, **STATE_TOL, err_msg=k)


# ------------------------------------------------------- cli.archive_sweep --

@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("archive")
    for name, (c, t, n, seed) in {"TinyA": (1, 24, 2, 0), "TinyB": (1, 27, 3, 2)}.items():
        for split, (count, off) in {"TRAIN": (14, 0), "TEST": (9, 1)}.items():
            x, y = make_arrays(count, c, t, n, seed=seed + off)
            write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y)
    return root


@pytest.mark.parametrize("bucket", [False, True])
def test_archive_sweep_writes_the_jax_results(archive, tmp_path, bucket):
    """Both CLIs on the same archive plus a dataset that does not exist: the
    same datasets, keys and sizes, an ``error`` entry for the missing one."""
    common = ["--root", str(archive), "--epochs", "1", "--budget-multiplier", "0.5",
              "--datasets", "TinyA,TinyB,Missing"] + (["--bucket"] if bucket else [])
    got = archive_sweep.main(common + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    jax_sweep.main(common + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert list(got) == list(want) == ["TinyA", "TinyB", "Missing"]
    assert set(got["Missing"]) == set(want["Missing"]) == {"error"}
    assert got["Missing"]["error"].startswith("FileNotFoundError")
    for name in ("TinyA", "TinyB"):
        assert set(got[name]) == set(want[name]) == RESULT_KEYS | ({"bucket"} if bucket else set())
        for k in ("n_train", "C", "T", "classes") + (("bucket",) if bucket else ()):
            assert got[name][k] == want[name][k], (name, k)
        assert 0.0 <= got[name]["test_acc"] <= 1.0 and 0.0 <= got[name]["train_acc"] <= 1.0
    if bucket:  # both datasets in one bucket
        assert got["TinyA"]["bucket"] == got["TinyB"]["bucket"] == [1, 6, 64, 4]


def test_archive_sweep_refusals(archive, tmp_path):
    with pytest.raises(SystemExit):
        archive_sweep.main(["--root", str(archive), "--bucket", "--with-cpc", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            archive_sweep.main(["--root", str(archive), "--out", str(tmp_path / "r.json")])


def test_archive_sweep_with_cpc(archive, tmp_path):
    got = archive_sweep.main(["--root", str(archive), "--epochs", "2", "--budget-multiplier", "0.5",
                              "--with-cpc", "--out", str(tmp_path / "r.json"), "--device", "cpu"])
    assert set(got) == {"TinyA", "TinyB"}
    for r in got.values():
        assert set(r) == RESULT_KEYS
