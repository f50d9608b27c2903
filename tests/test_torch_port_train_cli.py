"""The port's training CLI (``cli.main --device cpu``) against the JAX package's.

A tiny archive (target 2 channels, T=16, 2 classes; source 1 channel, T=12,
3 classes; ``--budget-multiplier 0.02``) is trained for one or two epochs of
each phase.  The port writes the files the JAX CLI's hooks write, in the JAX
key layout: its ``final_state.npz`` holds every key of the JAX package's
``init_state`` with its shape and restores into that template, its flat
moments cut in JAX leaf order are the port's per-parameter optimizer state,
and both packages' ``cli.predict`` serve its ``epoch_0.npz`` with equal
predictions.  Without ``--device cpu`` and with no CUDA it raises.
tests/test_torch_port_resume.py holds ``--resume`` in both directions.
"""

import json

import jax
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.cli import predict as jax_predict
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.io.checkpoint import restore_checkpoint as jax_restore
from feature_level_style_transfer_for_tsc_tpu.train.pipeline import StyleTransferPipeline
from feature_level_style_transfer_for_tsc_tpu_torch.cli import main as port_main
from feature_level_style_transfer_for_tsc_tpu_torch.cli import predict as port_predict
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays, write_ts_file

PHASES = {"p1": 1, "p2": 1, "p3": 2, "p4": 2, "p5": 3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and the tiny CPU ops of these runs, spread over every core by each
    process, slow each other down by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    root = tmp / "arch"
    for name, c, t, n, seed in (("TinyTarget", 2, 16, 2, 0), ("TinySource", 1, 12, 3, 5)):
        for split, count, s in (("TRAIN", 10, seed), ("TEST", 8, seed + 1)):
            x, y = make_arrays(count, c, t, n, seed=s)
            write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y, problem=name)
    out = tmp / "run"
    args = ["--target-root", str(root), "--target", "TinyTarget", "--source-root", str(root),
            "--source", "TinySource", "--out", str(out), "--budget-multiplier", "0.02",
            "--phase-epochs", json.dumps(PHASES)]
    state, history = port_main.main(args + ["--device", "cpu"])
    return root, out, args, state, history


def test_writes_the_jax_cli_file_set(trained):
    _, out, _, _, history = trained
    evals = [e for e in range(PHASES["p5"]) if e % JaxConfig().eval_every == 0]  # 0 and 2
    want = {"final_state.npz", "history.json", "log.jsonl",
            "feature_of_target_s2t", "feature_of_source_t2s"}
    want |= {f"epoch_{e}{s}.npz" for e in evals for s in ("", "_source")}
    want |= {f"p{i}_{side}_classifier_itself.npz" for i in range(1, 6) for side in ("target", "source")}
    assert {p.name for p in out.iterdir()} == want
    assert {p.name for p in (out / "feature_of_target_s2t").iterdir()} == {
        f"epoch_{e}{k}_feature.npy" for e in evals for k in ("target", "s2t", "source")}
    assert {p.name for p in (out / "feature_of_source_t2s").iterdir()} == {
        f"epoch_{e}{k}_feature.npy" for e in evals for k in ("source", "target", "s2t2s")}
    phases = [h["phase"] for h in history]
    assert phases.count("p5_eval") == len(evals) and phases.count("p4_eval") == 1
    for h in history:
        for k, v in h.items():
            if k not in ("phase", "epoch"):
                assert np.all(np.isfinite(v)), (k, h)
    assert json.loads((out / "history.json").read_text()) == json.loads(json.dumps(history))


def test_final_state_restores_into_the_jax_package(trained):
    """``final_state.npz`` holds params, mstate and consts under the JAX
    keys and dtypes: the JAX package restores it into its own template."""
    _, out, _, state, _ = trained
    pipe = StyleTransferPipeline(2, 16, 2, 1, 12, 3, JaxConfig(budget_multiplier=0.02))
    template = pipe.init_state(jax.random.PRNGKey(0))
    restored = jax_restore(str(out / "final_state.npz"),
                           {k: template[k] for k in ("params", "mstate", "consts")})
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["nf"]["wn"][0]["end"]["weight"]),
        state["params"]["nf"]["wn"][0]["end"]["weight"].detach().numpy(),
    )
    assert int(restored["mstate"]["ad"].iter_num) == int(state["mstate"]["ad"].iter_num) > 0


def test_final_state_is_the_whole_jax_state(trained):
    """Every key of the JAX ``init_state`` template, with its shape, plus the
    port's generator state; the JAX package restores the whole file, and the
    moments and counts are the port's, cut in ``jax.tree_util`` order."""
    from test_torch_port_resume import check_moments, jax_flat

    _, out, _, state, _ = trained
    pipe = StyleTransferPipeline(2, 16, 2, 1, 12, 3, JaxConfig(budget_multiplier=0.02))
    template = jax_flat(pipe.init_state(jax.random.PRNGKey(0)))
    with np.load(out / "final_state.npz") as data:
        saved = {k: data[k] for k in data.files}
    assert set(saved) == set(template) | {"['generator']"}
    for k, v in template.items():
        assert saved[k].shape == v.shape, k
    jstate = jax_restore(str(out / "final_state.npz"), pipe.init_state(jax.random.PRNGKey(0)))
    restored = jax_flat(jstate)
    check_moments(restored, jstate["params"], state)
    for side in ("t", "s"):
        np.testing.assert_array_equal(restored[f"['gradnorm']['{side}'].weights"],
                                      state["gradnorm"][side].weights.numpy())
        assert bool(restored[f"['gradnorm']['{side}'].initialized"])
    assert restored["['rng']"].dtype == np.uint32
    assert int(restored["['sched']['noise']"]) == state["sched"]["noise"] == PHASES["p5"]


def test_epoch_checkpoint_serves_equally_in_both_packages(trained, tmp_path):
    root, out, _, _, _ = trained
    common = ["--target-root", str(root), "--target", "TinyTarget", "--source-root", str(root),
              "--source", "TinySource", "--checkpoint", str(out / "epoch_0.npz"),
              "--budget-multiplier", "0.02"]
    acc_j = jax_predict.main(common + ["--out", str(tmp_path / "jax")])
    acc_p = port_predict.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp_path / "port_predict.npy"),
                                  np.load(tmp_path / "jax_predict.npy"))
    assert acc_p == pytest.approx(acc_j)


def test_cuda_by_default(trained, monkeypatch):
    _, _, args, _, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_main.main(args)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_main.main(args + ["--resume"])
