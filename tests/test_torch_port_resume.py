"""The whole training state across the two packages, and ``cli.main --resume``.

On the tiny archive of tests/test_torch_port_train_cli.py (target 2 channels,
T=16, 2 classes; source 1 channel, T=12, 3 classes; ``--budget-multiplier
0.02``, ``PipelineConfig`` defaults otherwise), the port's CLI trains one
phase-5 epoch, which steps every module's optimizer, both GradNorm weight
sets, the StepLR counters and the plateau states; the JAX CLI's
``--resume`` continues that directory for one more phase-5 epoch (its
counts then double, so it did resume; its losses are finite).  Then:

* the JAX-written ``final_state.npz`` restores into the port with every
  value the JAX package holds: params, moments (sliced in JAX leaf order,
  which the test takes from ``jax.tree_util``), counts, learning rates,
  ``sched``, ``plateau`` and GradNorm;
* from that restored state both packages take one more phase-1 epoch on the
  same numpy batches, the CPC anchor pinned (JAX patched from the test only,
  as tests/test_torch_port_train_phases.py does), and their params agree to
  that file's tolerance; the same epoch with the moments dropped misses by
  far more, so the moments were carried, not only copied;
* the port's ``--resume`` from its own file equals, bit for bit, the same
  ``pipe.run`` started from the in-memory state that wrote the file;
* the port's CLI continues the JAX-written directory for one phase-5
  epoch with finite losses.
"""

import copy
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.cli import main as jax_main
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.io.checkpoint import restore_checkpoint as jax_restore
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.cli import main as port_main
from feature_level_style_transfer_for_tsc_tpu_torch.cli.predict import build_datasets
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import (
    flatten, from_jax_params, load_flat, tree_items)
from feature_level_style_transfer_for_tsc_tpu_torch.train import jax_state
from feature_level_style_transfer_for_tsc_tpu_torch.train import optim as port_optim
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline
from test_torch_port_train_phases import _check_params, _recording_grads

SHAPES = (2, 16, 2, 1, 12, 3)
P5_ONLY = {"p1": 0, "p2": 0, "p3": 0, "p4": 0, "p5": 1}
P1_P5 = {"p1": 1, "p2": 0, "p3": 0, "p4": 0, "p5": 1}
ANCHOR = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and the tiny CPU ops of these runs, spread over every core by each
    process, slow each other down by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_archive(root):
    for name, c, t, n, seed in (("TinyTarget", 2, 16, 2, 0), ("TinySource", 1, 12, 3, 5)):
        for split, count, s in (("TRAIN", 10, seed), ("TEST", 8, seed + 1)):
            x, y = make_arrays(count, c, t, n, seed=s)
            write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y, problem=name)


def cli_args(root, out, phases):
    return ["--target-root", str(root), "--target", "TinyTarget", "--source-root", str(root),
            "--source", "TinySource", "--out", str(out), "--budget-multiplier", "0.02",
            "--phase-epochs", json.dumps(phases)]


def jax_template():
    return jax_pipeline.StyleTransferPipeline(*SHAPES, JaxConfig(budget_multiplier=0.02))


def port_pipe():
    return port_pipeline.StyleTransferPipeline(*SHAPES, PipelineConfig(budget_multiplier=0.02),
                                               device="cpu")


def jax_flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def moments_by_param(jax_params, vector):
    """A module's flat optax vector cut into its parameters in the order
    ``jax.tree_util`` flattens ``jax_params``, keyed by tree path."""
    out, lo = {}, 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params):
        out[jax.tree_util.keystr(path)] = vector[lo : lo + leaf.size].reshape(leaf.shape)
        lo += leaf.size
    assert lo == vector.size
    return out


def check_moments(flat, jax_params, port_state):
    """Every module's ``nu`` (and CPC's ``mu``) of ``flat`` against the
    port's per-parameter ``square_avg`` (``exp_avg_sq``, ``exp_avg``), and
    the counts against the port's steps."""
    for m in port_pipeline.ALL_MODULES:
        opt, inner = port_state["opt"][m], f"['opt']['{m}'].inner_state[0]"
        port_params = dict(tree_items(port_state["params"][m]))
        pairs = [("nu", "exp_avg_sq"), ("mu", "exp_avg")] if m == "cpc" else [("nu", "square_avg")]
        count = int(flat[f"['opt']['{m}'].count"])
        assert count > 0, m
        for jax_key, port_key in pairs:
            want = moments_by_param(jax_params[m], flat[f"{inner}.{jax_key}"])
            assert set(want) == set(port_params), m
            for k, v in want.items():
                state = opt.state[port_params[k]]
                assert int(state["step"]) == count, (m, k)
                np.testing.assert_array_equal(state[port_key].numpy(), v, err_msg=f"{m}{k}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's run, and the JAX CLI's ``--resume`` of a copy of it."""
    tmp = tmp_path_factory.mktemp("resume")
    root = tmp / "arch"
    write_archive(root)
    state, history = port_main.main(cli_args(root, tmp / "port", P5_ONLY) + ["--device", "cpu"])
    shutil.copytree(tmp / "port", tmp / "jax")
    jax_main.main(cli_args(root, tmp / "jax", P5_ONLY) + ["--resume"])
    return tmp, root, state, history


def _finite_p5(out):
    history = json.loads((out / "history.json").read_text())
    assert [h["phase"] for h in history] == ["p5", "p5_eval"]
    for k, v in history[0].items():
        if k not in ("phase", "epoch"):
            assert np.all(np.isfinite(v)), k


def test_the_jax_cli_resumes_a_port_run(runs):
    tmp = runs[0]
    _finite_p5(tmp / "jax")
    port, jax_ = (load_flat(str(tmp / d / "final_state.npz")) for d in ("port", "jax"))
    for m in port_pipeline.ALL_MODULES:
        key = f"['opt']['{m}'].count"
        assert int(jax_[key]) == 2 * int(port[key]) > 0, m
    assert int(jax_["['gradnorm']['t'].opt_state[0].count"]) == 2 * int(
        port["['gradnorm']['t'].opt_state[0].count"])


def test_a_jax_state_restores_into_the_port(runs):
    tmp = runs[0]
    path = str(tmp / "jax" / "final_state.npz")
    jstate = jax_restore(path, jax_template().init_state(jax.random.PRNGKey(0)))
    want = jax_flat(jstate)
    pstate = port_pipe().state_from_flat(load_flat(path))
    got = flatten({k: pstate[k] for k in jax_state.MODEL_KEYS})
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    check_moments(want, jstate["params"], pstate)
    for m, o in pstate["opt"].items():
        lr = want[f"['opt']['{m}'].hyperparams['learning_rate']"]
        assert all(g["lr"] == float(lr) for g in o.param_groups), m
    for m, v in pstate["sched"].items():
        assert v == int(want[f"['sched']['{m}']"]) == 2, m
    for m, ps in pstate["plateau"].items():
        assert ps == (float(want[f"['plateau']['{m}'].lr"]), float(want[f"['plateau']['{m}'].best"]),
                      int(want[f"['plateau']['{m}'].num_bad"])), m
        assert np.isfinite(ps.best), m
    for side, g in pstate["gradnorm"].items():
        pre = f"['gradnorm']['{side}']"
        np.testing.assert_array_equal(g.weights.numpy(), want[f"{pre}.weights"])
        np.testing.assert_array_equal(g.initial_sigmoid_loss.numpy(), want[f"{pre}.initial_sigmoid_loss"])
        assert g.initialized is True and bool(want[f"{pre}.initialized"])
        adam = g.optimizer.state[g.weights]
        assert int(adam["step"]) == int(want[f"{pre}.opt_state[0].count"]) > 0
        np.testing.assert_array_equal(adam["exp_avg"].numpy(), want[f"{pre}.opt_state[0].mu"])
        np.testing.assert_array_equal(adam["exp_avg_sq"].numpy(), want[f"{pre}.opt_state[0].nu"])
    # and back: the port writes every value as the JAX package read it
    back = port_pipe().state_to_flat(pstate)
    for k, v in want.items():
        if k != "['rng']":
            np.testing.assert_array_equal(back[k].astype(v.dtype), v, err_msg=k)


def test_the_next_epoch_from_a_jax_state_agrees(runs, monkeypatch):
    tmp = runs[0]
    path = str(tmp / "jax" / "final_state.npz")
    cpc_apply = jax_pipeline.cpc_apply
    monkeypatch.setattr(jax_pipeline, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHOR))
    jpipe = jax_template()
    jstate = jax_restore(path, jpipe.init_state(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    xt = rng.standard_normal((2, 20, 16, 2)).astype(np.float32)
    yt = rng.integers(0, 2, (2, 20)).astype(np.int32)
    jnew, _ = jpipe.phase1_epoch(jstate, jnp.asarray(xt), jnp.asarray(yt))
    names = ("t_ext", "t_cls", "cpc")

    ppipe = port_pipe()
    pstate = ppipe.state_from_flat(load_flat(path))
    grads = _recording_grads(ppipe, monkeypatch)
    ppipe.phase1_epoch(pstate, xt, yt, cpc_anchor=ANCHOR)
    _check_params(jnew["params"], pstate, grads, names)

    # without the moments the same epoch lands far outside that tolerance
    bare = ppipe.state_from_flat(load_flat(path))
    for m in names:
        bare["opt"][m].state.clear()
    ppipe.phase1_epoch(bare, xt, yt, cpc_anchor=ANCHOR)
    want = jax_flat(jnew["params"])
    gap = max(float(np.abs(v - want[k]).max())
              for k, v in flatten(bare["params"]).items() if k.startswith("['t_ext']"))
    assert gap > 1e-4


def test_resume_from_the_file_equals_resume_from_memory(runs):
    tmp, root, state, _ = runs
    out = tmp / "port_resumed"
    shutil.copytree(tmp / "port", out)
    memory = copy.deepcopy(state)
    got_state, got_history = port_main.main(cli_args(root, out, P1_P5)
                                            + ["--device", "cpu", "--resume"])
    pipe = port_pipe()
    want_state, want_history = pipe.run(*build_datasets(root, "TinyTarget", root, "TinySource"),
                                        epochs=P1_P5, state=memory, seed=0, verbose=False)
    assert got_history == want_history
    got, want = pipe.state_to_flat(got_state), pipe.state_to_flat(want_state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the resumed run moved on from the file's state
    first = load_flat(str(tmp / "port" / "final_state.npz"))
    assert not np.array_equal(first["['params']['nf']['wn'][0]['end']['weight']"],
                              got["['params']['nf']['wn'][0]['end']['weight']"])


def test_the_port_cli_resumes_a_jax_run(runs, capsys):
    tmp, root, _, _ = runs
    out = tmp / "jax_by_port"
    shutil.copytree(tmp / "jax", out)
    port_main.main(cli_args(root, out, P5_ONLY) + ["--device", "cpu", "--resume"])
    assert f"resumed from {out / 'final_state.npz'}" in capsys.readouterr().out
    _finite_p5(out)
    # the JAX file has no generator state: the port seeds it from ['rng']
    assert "['generator']" not in load_flat(str(tmp / "jax" / "final_state.npz"))


def test_jax_order_sorts_dict_keys_and_keeps_list_order():
    tree = {"b": [torch.zeros(1), torch.ones(2)], "a": {"z": torch.zeros(3), "c": torch.zeros(4)},
            "l": [torch.full((i + 1,), float(i)) for i in range(12)]}
    want = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tree))]
    by_id = {id(v): k for k, v in tree_items(tree)}
    assert [by_id[id(t)] for t in jax_state.jax_order(tree)] == want
    assert want.index("['l'][2]") < want.index("['l'][10]")


@pytest.mark.parametrize("which", ["rmsprop", "adam"])
def test_optax_state_round_trip_and_refusals(which):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 2, generator=gen, requires_grad=True),
              "b": [torch.randn(4, generator=gen, requires_grad=True)]}
    make = port_optim.make_adam if which == "adam" else port_optim.make_rmsprop
    opt = make(port_pipeline.leaves(params), 1e-3 / 3)

    def written(o):
        return flatten({"o": jax_state.optax_state(o, params)})

    def read(flat):
        return from_jax_params(flat)["o"]

    fresh = written(opt)
    assert int(fresh["['o'].count"]) == 0
    assert all(not v.any() for k, v in fresh.items() if k.endswith((".mu", ".nu")))
    for _ in range(2):
        for p in port_pipeline.leaves(params):
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    flat = written(opt)
    assert flat["['o'].hyperparams['learning_rate']"].dtype == np.float64  # 1e-3 / 3 exactly
    other = make(port_pipeline.leaves(params), 1.0)
    jax_state.load_optax_state(other, params, read(flat))
    assert other.param_groups[0]["lr"] == 1e-3 / 3
    again = written(other)
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k], err_msg=k)
    jax_state.load_optax_state(other, params, read(fresh))
    assert not other.state  # count 0: no state, as before a first step
    eps = "['o'].hyperparams['eps']"
    with pytest.raises(ValueError, match="hyperparameter eps"):
        jax_state.load_optax_state(other, params, read({**flat, eps: np.float32(1e-6)}))
    if which == "adam":
        inner = "['o'].inner_state[0].count"
        with pytest.raises(ValueError, match="differ"):
            jax_state.load_optax_state(other, params, read({**flat, inner: np.int32(5)}))
    opt.state[params["w"]]["step"] += 1
    with pytest.raises(ValueError, match="unequally"):
        jax_state.optax_state(opt, params)
