"""The port's serving path as a whole against the JAX package's.

One tiny archive (target: 2 channels, T=40, 3 classes; source: 1 channel,
T=24) is written as .ts files.  The parameters of the OS-CNN models of a
``StyleTransferPipeline`` state (target and source pairs) and of two
ensemble members, BatchNorm running statistics included, are laid out by
the JAX package's initializers and filled from a numpy seed, and the JAX
``save_checkpoint`` writes them.  Both packages then serve from those same
files on the CPU:

* single checkpoint: JAX ``StyleTransferPipeline.predict_target`` against
  the port's ``TargetPredictor`` and the port's ``cli.predict`` (logits and
  argmax), with the fused epilogue off and on;
* ensemble of 3 (the full state plus the two members): JAX
  ``MultiSourceEnsemble`` and ``evaluation/voting.py`` against the port's
  ``cli.predict`` under each of the three vote rules.

Tolerance: atol=1e-4, rtol=1e-4 on logits and precision weights — f32 sums
taken in another order; the argmax predictions must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.cli.main import build_datasets as jax_build_datasets
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.evaluation import voting as jax_voting
from feature_level_style_transfer_for_tsc_tpu.io.checkpoint import save_checkpoint as jax_save
from feature_level_style_transfer_for_tsc_tpu.models import os_cnn as jax_os_cnn
from feature_level_style_transfer_for_tsc_tpu.parallel.multi_source import (
    MultiSourceEnsemble as JaxEnsemble,
)
from feature_level_style_transfer_for_tsc_tpu.train.classifier import (
    OSCNNClassifier as JaxClassifier,
)
from feature_level_style_transfer_for_tsc_tpu.train.pipeline import StyleTransferPipeline
from feature_level_style_transfer_for_tsc_tpu_torch.cli import predict
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import restore_checkpoint
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import (
    TARGET_PREFIXES,
    TargetPredictor,
)

TOL = {"atol": 1e-4, "rtol": 1e-4}
BUDGET = 0.03
TARGET = ("TinyT", 2, 40, 3)  # name, channels, length, classes
SOURCE = ("TinyS", 1, 24, 2)


def _random_like(tree_shape, rng):
    """Fill the leaves of ``jax.eval_shape``'s result from a numpy seed:
    BN variances in [0.5, 2], BN scales in [0.5, 1.5], every other float
    0.3*N(0, 1) (so BN biases and running means are non-trivial too), and
    integer leaves (counters, PRNG keys) zero.  Tracing the initializers
    instead of running them keeps the JAX package's exact tree layout
    without compiling them."""

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        if not np.issubdtype(sd.dtype, np.floating):
            return np.zeros(sd.shape, sd.dtype)
        if name.endswith(".var"):
            return rng.uniform(0.5, 2.0, sd.shape).astype(np.float32)
        if "bn_scale" in name:
            return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree_shape)


def _pipeline_models(pipe, key):
    """The OS-CNN models of a full pipeline state, under its keys: the target
    pair that serving restores, and the source pair that it must skip.  (The
    pipeline's own ``init_state`` also builds the flow, which does not trace.)"""
    keys = jax.random.split(key, 4)
    t_ext = jax_os_cnn.os_cnn_res_init(keys[0], pipe.t_ext_specs)
    t_cls = jax_os_cnn.os_cnn_init(keys[1], pipe.cls_specs, pipe.t_shape[2])
    s_ext = jax_os_cnn.os_cnn_res_init(keys[2], pipe.s_ext_specs)
    s_cls = jax_os_cnn.os_cnn_init(keys[3], pipe.cls_specs, pipe.s_shape[2])
    return {
        "params": {"t_ext": t_ext[0], "t_cls": t_cls[0], "s_ext": s_ext[0], "s_cls": s_cls[0]},
        "mstate": {"t_ext": t_ext[1], "t_cls": t_cls[1], "s_ext": s_ext[1], "s_cls": s_cls[1]},
        "epoch": jnp.zeros((), jnp.int32),
    }


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The archive, the JAX-written checkpoints and the JAX-side objects."""
    tmp = tmp_path_factory.mktemp("serve")
    root = tmp / "arch"
    for (name, c, t, n_cls), seed in ((TARGET, 0), (SOURCE, 5)):
        for split, n, s in (("TRAIN", 12, seed), ("TEST", 7, seed + 1)):
            x, y = make_arrays(n, c, t, n_cls, seed=s)
            write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y, problem=name)
    t_train, t_test, _, _ = jax_build_datasets(root, TARGET[0], root, SOURCE[0])

    rng = np.random.default_rng(0)
    # batch 3: 7 test series make two full batches and one padded batch
    pipe = StyleTransferPipeline(*TARGET[1:], *SOURCE[1:], JaxConfig(
        batch_size=3, budget_multiplier=BUDGET))
    state = _random_like(jax.eval_shape(functools.partial(_pipeline_models, pipe), jax.random.PRNGKey(0)), rng)
    full = tmp / "final_state.npz"
    jax_save(str(full), state)

    member_def = JaxClassifier(*TARGET[1:], config=JaxConfig(budget_multiplier=BUDGET),
                               with_cpc=False)
    members, member_paths = [], []
    for i in (1, 2):
        st = _random_like(jax.eval_shape(member_def.init_state, jax.random.PRNGKey(i)), rng)
        path = tmp / f"member{i}.npz"
        jax_save(str(path), st)  # optimizer state included: the port skips it
        members.append({"params": st["params"], "mstate": st["mstate"]})
        member_paths.append(path)
    t_member = {
        "params": {"ext": state["params"]["t_ext"], "cls": state["params"]["t_cls"]},
        "mstate": {"ext": state["mstate"]["t_ext"], "cls": state["mstate"]["t_cls"]},
    }
    return {
        "tmp": tmp, "root": root, "t_train": t_train, "t_test": t_test,
        "pipe": pipe, "state": state, "full": full,
        "ensemble_paths": [member_paths[0], full, member_paths[1]],
        "ensemble_members": [members[0], t_member, members[1]],
    }


def _cli(served, ckpts, out, vote="entropy_precision"):
    root = str(served["root"])
    return predict.main([
        "--target-root", root, "--target", TARGET[0],
        "--source-root", root, "--source", SOURCE[0],
        "--checkpoint", ",".join(str(c) for c in ckpts), "--out", str(out),
        "--vote", vote, "--budget-multiplier", str(BUDGET), "--device", "cpu",
    ])


@pytest.mark.parametrize("fuse_env", ["0", "1"])
def test_predict_target_matches_jax(served, fuse_env, monkeypatch):
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", fuse_env)
    pipe, state, x = served["pipe"], served["state"], served["t_test"].x
    want_logits = np.asarray(pipe._predict_target(state["params"], state["mstate"], jnp.asarray(x)))
    want = pipe.predict_target(state, x)

    port = TargetPredictor(*TARGET[1:], config=PipelineConfig(batch_size=3, budget_multiplier=BUDGET),
                           device="cpu")
    port_state = restore_checkpoint(str(served["full"]), TARGET_PREFIXES)
    logits = port.predict_logits(port_state["params"], port_state["mstate"], torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    got = port.predict_target(port_state, x)
    assert got.shape == (7,)
    np.testing.assert_array_equal(got, want)

    out = served["tmp"] / f"single_{fuse_env}"
    acc = _cli(served, [served["full"]], out)
    np.testing.assert_array_equal(np.load(f"{out}_predict.npy"), want)
    assert acc == pytest.approx(float(np.mean(want == served["t_test"].y)))


@pytest.fixture(scope="module")
def jax_ensemble(served):
    ens = JaxEnsemble(*TARGET[1:], config=JaxConfig(budget_multiplier=BUDGET))
    stacked = ens.stack(served["ensemble_members"])
    weights = ens.compute_class_weights(stacked, served["t_train"].x, served["t_train"].y)
    logits = ens.member_logits(stacked, jnp.asarray(served["t_test"].x))
    return ens, weights, logits


def test_ensemble_logits_and_weights_match_jax(served, jax_ensemble):
    ens, want_w, want_logits = jax_ensemble
    port = predict.MultiSourceEnsemble(*TARGET[1:], config=PipelineConfig(budget_multiplier=BUDGET),
                                       device="cpu")
    stacked = port.stack([predict._load_member(str(p), "cpu") for p in served["ensemble_paths"]])
    logits = port.member_logits(stacked, served["t_test"].x)
    assert logits.shape == (3, 7, TARGET[3])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    weights = port.compute_class_weights(stacked, served["t_train"].x, served["t_train"].y)
    np.testing.assert_allclose(weights.numpy(), np.asarray(want_w), **TOL)


@pytest.mark.parametrize("vote", ["entropy_precision", "entropy_only", "predicted_label"])
def test_ensemble_vote_matches_jax(served, jax_ensemble, vote):
    ens, weights, logits = jax_ensemble
    if vote == "entropy_precision":
        want = jax_voting.entropy_precision_vote(logits, weights, ens.voting)
    elif vote == "entropy_only":
        want = jax_voting.entropy_only_vote(logits)
    else:
        want = jax_voting.predicted_label_vote(logits, weights)
    out = served["tmp"] / f"ensemble_{vote}"
    _cli(served, served["ensemble_paths"], out, vote)
    np.testing.assert_array_equal(np.load(f"{out}_predict.npy"), np.asarray(want))


def test_single_member_checkpoint_serves_by_argmax(served):
    """One ``cli.multi_source`` member: plain argmax, as the JAX CLI does."""
    member_def = JaxClassifier(*TARGET[1:], config=JaxConfig(budget_multiplier=BUDGET),
                               with_cpc=False)
    member = served["ensemble_members"][0]
    want = np.asarray(jnp.argmax(member_def.predict_logits(
        member["params"], member["mstate"], jnp.asarray(served["t_test"].x)), -1))
    out = served["tmp"] / "one_member"
    _cli(served, [served["ensemble_paths"][0]], out)
    np.testing.assert_array_equal(np.load(f"{out}_predict.npy"), want)


def test_cuda_requested_without_a_card_raises(served, monkeypatch):
    """No silent CPU fallback: --device cuda refuses to run without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(served["root"])
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        predict.main([
            "--target-root", root, "--target", TARGET[0], "--source-root", root,
            "--source", SOURCE[0], "--checkpoint", str(served["full"]),
            "--budget-multiplier", str(BUDGET),
        ])
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        TargetPredictor(*TARGET[1:])
