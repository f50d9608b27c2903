"""The port's multi-source entry points against the JAX package's, on the CPU.

Tiny archives written by the JAX package's synthetic writer: a target of 2
channels, T=16, 2 classes, and two sources, (1, 12, 3) and (3, 20, 4), at
``--budget-multiplier 0.02`` (tests/test_cli.py's sizes).

The JAX CLI runs once (module fixture ``jax_run``), with
``StyleTransferPipeline.run`` patched in the JAX package from this test
only: member i's "training" records its config's seed, calls the
``checkpoint_hook`` at phase-5 epochs 0, 2 and 4 with target models the JAX
``OSCNNClassifier`` initializes from a key of (seed, epoch), and returns
the one of epoch 99.  The port's CLI runs with its ``run`` patched the same
way on the same models, carried across with ``from_jax_params``.  So the
member each CLI saves shows which seed trained it and which epoch it was
captured at, and the vote runs on known members.  The port also trains two
real members on the CPU (one epoch a phase).

Tolerances: the saved members, the predictions and the labels exactly
equal; ``ensemble.json`` and the class weights within 1e-6; the PNG strips
pixel for pixel (decoded by PIL, here only).
"""

import json
import os
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from feature_level_style_transfer_for_tsc_tpu.cli import multi_source as jax_cli
from feature_level_style_transfer_for_tsc_tpu.cli import visualize as jax_visualize
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu.io import artifacts as jax_artifacts
from feature_level_style_transfer_for_tsc_tpu.io import restore_checkpoint as jax_restore
from feature_level_style_transfer_for_tsc_tpu.parallel.multi_source import (
    MultiSourceEnsemble as JaxEnsemble,
)
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu.train.classifier import OSCNNClassifier as JaxOSCNN
from feature_level_style_transfer_for_tsc_tpu_torch import compat
from feature_level_style_transfer_for_tsc_tpu_torch.cli import multi_source as port_cli
from feature_level_style_transfer_for_tsc_tpu_torch.cli import visualize as port_visualize
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.io import artifacts as port_artifacts
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
    MultiSourceEnsemble,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline

REPO = Path(__file__).resolve().parents[1]
T_SHAPE = (2, 16, 2)
SOURCES = {"TinyA": (1, 12, 3), "TinyB": (3, 20, 4)}
SEED = 3
CAPTURE = (2, 0)  # member i is captured at CAPTURE[i % 2]
HOOK_EPOCHS = (0, 2, 4)
FINAL_EPOCH = 99
BUDGET = 0.02
VOTE_FILES = {"final_predict.npy", "true_label.npy", "prediction_strip.png", "ensemble.json"}


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


def _archive(root, name, shape, seed):
    c, t, n = shape
    for split, s in (("TRAIN", seed), ("TEST", seed + 1)):
        x, y = make_arrays(10, c, t, n, seed=s)
        write_ts_file(os.path.join(root, name, f"{name}_{split}.ts"), x, y)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("arch"))
    _archive(root, "TinyT", T_SHAPE, 0)
    for i, (name, shape) in enumerate(SOURCES.items()):
        _archive(root, name, shape, 5 + 2 * i)
    return root


def _member_state(seed: int, epoch: int):
    """A JAX target model (t_ext, t_cls) made from (seed, epoch), with
    BatchNorm statistics moved off their initial values."""
    model = JaxOSCNN(*T_SHAPE, config=JaxConfig(budget_multiplier=BUDGET), with_cpc=False)
    st = model.init_state(jax.random.PRNGKey(1000 * seed + epoch))
    rng = np.random.default_rng(1000 * seed + epoch)

    def moved(path, a):
        field = jax.tree_util.keystr(path).rsplit(".", 1)[-1]
        shape = np.shape(a)
        if field == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)

    mstate = jax.tree_util.tree_map_with_path(moved, st["mstate"])
    return {"params": {"t_ext": st["params"]["ext"], "t_cls": st["params"]["cls"]},
            "mstate": {"t_ext": mstate["ext"], "t_cls": mstate["cls"]}}


def _fake_run(calls, convert):
    """A stand-in for ``StyleTransferPipeline.run``: records the member's
    seed and source shape, calls the hook at HOOK_EPOCHS, returns the model
    of FINAL_EPOCH."""
    def run(self, t_train, t_test, s_train, s_test, *, epochs=None, verbose=True,
            checkpoint_hook=None, **kw):
        seed = self.config.seed
        calls.append({"seed": seed, "source": (s_train.in_channel, s_train.time_length,
                                               s_train.num_class), "epochs": epochs})
        for e in HOOK_EPOCHS:
            checkpoint_hook(e, convert(_member_state(seed, e)))
        history = [{"phase": "p5", "epoch": FINAL_EPOCH, "seed": seed}]
        return convert(_member_state(seed, FINAL_EPOCH)), history
    return run


def _cli_args(archives, out, *extra):
    return ["--target-root", archives, "--target", "TinyT", "--source-root", archives,
            "--sources", ",".join(SOURCES), "--out", str(out), "--seed", str(SEED),
            "--budget-multiplier", str(BUDGET), *extra]


def _run_cli(main, args, capsys):
    capsys.readouterr()
    result = main(args)
    return result, capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_run(archives, tmp_path_factory):
    """The one JAX CLI run of this file, with ``run`` patched."""
    out = tmp_path_factory.mktemp("jax_run")
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pipeline.StyleTransferPipeline, "run", _fake_run(calls, lambda s: s))
    try:
        from io import StringIO

        buf, old = StringIO(), sys.stdout
        sys.stdout = buf
        try:
            result = jax_cli.main(_cli_args(archives, out, "--capture-epochs",
                                            ",".join(map(str, CAPTURE))))
        finally:
            sys.stdout = old
    finally:
        mp.undo()
    return types.SimpleNamespace(out=out, calls=calls, result=result, stdout=buf.getvalue())


def _check_vote_outputs(port_out: Path, jax_out: Path):
    for name in ("final_predict.npy", "true_label.npy"):
        np.testing.assert_array_equal(np.load(port_out / name), np.load(jax_out / name),
                                      err_msg=name)
    got = json.loads((port_out / "ensemble.json").read_text())
    want = json.loads((jax_out / "ensemble.json").read_text())
    assert set(got) == set(want) and set(got["vote_variants"]) == set(want["vote_variants"])
    np.testing.assert_allclose(got["ensemble_acc"], want["ensemble_acc"], atol=1e-6)
    np.testing.assert_allclose(got["member_accs"], want["member_accs"], atol=1e-6)
    for k, v in want["vote_variants"].items():
        np.testing.assert_allclose(got["vote_variants"][k], v, atol=1e-6, err_msg=k)


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_members_train_with_seed_plus_i_and_capture_like_jax(archives, jax_run, tmp_path,
                                                             monkeypatch, capsys):
    """Member i runs with seed + i, is captured at CAPTURE[i % len], saved
    under the JAX key layout as the JAX CLI saves it, and the vote over the
    members gives the JAX CLI's outputs."""
    calls = []
    monkeypatch.setattr(port_pipeline.StyleTransferPipeline, "run",
                        _fake_run(calls, lambda s: from_jax_params(_flat(s))))
    out = tmp_path / "port_run"
    _, stdout = _run_cli(port_cli.main, _cli_args(archives, out, "--capture-epochs",
                                                  ",".join(map(str, CAPTURE)), "--device", "cpu"),
                         capsys)
    want_calls = [{"seed": SEED + i, "source": shape, "epochs": None}
                  for i, shape in enumerate(SOURCES.values())]
    assert calls == want_calls  # in order: one card runs the members in turn
    # the JAX CLI trains members in threads over its (8 virtual) devices
    assert sorted(jax_run.calls, key=lambda c: c["seed"]) == want_calls
    for i, name in enumerate(SOURCES):
        path = f"member_{name}.npz"
        with np.load(out / path) as got, np.load(jax_run.out / path) as want:
            assert set(got.files) == set(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        captured = _member_state(SEED + i, CAPTURE[i])
        with np.load(out / path) as got:
            np.testing.assert_array_equal(
                got["['params']['ext']['res']['weight']"],
                np.asarray(captured["params"]["t_ext"]["res"]["weight"]))
    assert {f.name for f in out.iterdir()} == {f.name for f in jax_run.out.iterdir()}
    _check_vote_outputs(out, jax_run.out)
    member_lines = [ln for ln in stdout.splitlines() if ln.startswith("[")]
    assert member_lines == sorted(ln for ln in jax_run.stdout.splitlines() if ln.startswith("["))
    assert [ln.split("]")[0] for ln in member_lines] == [
        f"[{name}@p5e{CAPTURE[i]}" for i, name in enumerate(SOURCES)]


def test_member_checkpoints_vote_like_jax(archives, jax_run, tmp_path, capsys):
    """``--member-checkpoints`` on the two JAX-written members: the port's
    vote gives the JAX CLI's outputs over the same members."""
    out = tmp_path / "port_vote"
    paths = ",".join(str(jax_run.out / f"member_{n}.npz") for n in SOURCES)
    result, _ = _run_cli(port_cli.main, _cli_args(archives, out, "--member-checkpoints", paths,
                                                  "--device", "cpu"), capsys)
    assert {f.name for f in out.iterdir()} == VOTE_FILES
    _check_vote_outputs(out, jax_run.out)
    np.testing.assert_allclose(result["class_weights"], np.asarray(jax_run.result["class_weights"]),
                               atol=1e-6)
    np.testing.assert_array_equal(_pixels(out / "prediction_strip.png"),
                                  _pixels(jax_run.out / "prediction_strip.png"))


def test_member_checkpoints_refuse_another_layout(archives, jax_run, tmp_path):
    """A file that is not a member of this target (a key missing) raises,
    as the JAX package's restore against its template does."""
    with np.load(jax_run.out / "member_TinyA.npz") as z:
        flat = {k: z[k] for k in z.files}
    flat.pop(sorted(flat)[0])
    bad = tmp_path / "bad.npz"
    np.savez(bad, **flat)
    with pytest.raises(ValueError, match="not a member"):
        port_cli.main(_cli_args(archives, tmp_path / "o", "--member-checkpoints",
                                f"{bad},{bad}", "--device", "cpu"))


def test_visualize_prints_what_jax_prints(jax_run, tmp_path, capsys):
    args = ["--predictions", str(jax_run.out / "final_predict.npy"),
            "--labels", str(jax_run.out / "true_label.npy"), "--cell", "4", "--per-row", "3"]
    _, port_out = _run_cli(port_visualize.main, args + ["--out", str(tmp_path / "p.png")], capsys)
    _, jax_out = _run_cli(jax_visualize.main, args + ["--out", str(tmp_path / "j.png")], capsys)
    assert port_out.replace("p.png", "X") == jax_out.replace("j.png", "X")
    assert port_out.splitlines()[0].startswith("accuracy_for_test: ")
    np.testing.assert_array_equal(_pixels(tmp_path / "p.png"), _pixels(tmp_path / "j.png"))


@pytest.mark.parametrize("n, cell, per_row", [(1, 10, 40), (40, 10, 40), (45, 10, 40),
                                              (81, 3, 7)])
def test_prediction_strip_pixels_match_jax(tmp_path, n, cell, per_row):
    rng = np.random.default_rng(n)
    pred, labels = rng.integers(0, 3, n), rng.integers(0, 3, n)
    port_artifacts.save_prediction_strip(str(tmp_path / "p.png"), pred, labels, cell, per_row)
    jax_artifacts.save_prediction_strip(str(tmp_path / "j.png"), pred, labels, cell, per_row)
    got, want = Image.open(tmp_path / "p.png"), Image.open(tmp_path / "j.png")
    assert got.mode == want.mode == "RGB" and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ensemble_evaluate_matches_jax():
    rng = np.random.default_rng(0)
    members = [_member_state(s, 7) for s in (1, 2, 3)]
    members = [{"params": {"ext": m["params"]["t_ext"], "cls": m["params"]["t_cls"]},
                "mstate": {"ext": m["mstate"]["t_ext"], "cls": m["mstate"]["t_cls"]}}
               for m in members]
    c, t, n = T_SHAPE
    train = types.SimpleNamespace(x=rng.standard_normal((12, t, c)).astype(np.float32),
                                  y=rng.integers(0, n, 12))
    test = types.SimpleNamespace(x=rng.standard_normal((9, t, c)).astype(np.float32),
                                 y=rng.integers(0, n, 9))
    jens = JaxEnsemble(*T_SHAPE, config=JaxConfig(budget_multiplier=BUDGET))
    want = jens.evaluate(jens.stack(members), train, test)
    ens = MultiSourceEnsemble(*T_SHAPE, config=PipelineConfig(budget_multiplier=BUDGET),
                              device="cpu")
    got = ens.evaluate(ens.stack([from_jax_params(_flat(m)) for m in members]), train, test)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["predictions"], np.asarray(want["predictions"]))
    np.testing.assert_allclose(got["class_weights"], np.asarray(want["class_weights"]), atol=1e-6)
    assert got["member_accs"] == want["member_accs"]
    assert got["vote_variants"] == want["vote_variants"]
    assert got["ensemble_acc"] == want["ensemble_acc"]
    weights = torch.as_tensor(got["class_weights"])
    np.testing.assert_array_equal(ens.predict(ens.stack([from_jax_params(_flat(m))
                                                         for m in members]), test.x, weights),
                                  got["predictions"])


def test_multi_source_trains_members_on_cpu(archives, jax_run, tmp_path, capsys):
    """Two real members, one epoch a phase: the JAX CLI's file set for the
    same flags, members that restore into the JAX ``OSCNNClassifier``
    template, every value finite."""
    out = tmp_path / "trained"
    epochs = json.dumps({"p1": 1, "p2": 1, "p3": 1, "p4": 1, "p5": 1})
    result, stdout = _run_cli(port_cli.main, _cli_args(archives, out, "--phase-epochs", epochs,
                                                       "--device", "cpu"), capsys)
    assert {f.name for f in out.iterdir()} == {f.name for f in jax_run.out.iterdir()}
    assert {f"member_{n}.npz" for n in SOURCES} | VOTE_FILES == {f.name for f in out.iterdir()}
    model = JaxOSCNN(*T_SHAPE, config=JaxConfig(budget_multiplier=BUDGET), with_cpc=False)
    st = model.init_state(jax.random.PRNGKey(0))
    template = {"params": st["params"], "mstate": st["mstate"]}
    for name in SOURCES:
        restored = jax_restore(str(out / f"member_{name}.npz"), template)
        leaves = jax.tree_util.tree_leaves(restored)
        assert len(leaves) == len(jax.tree_util.tree_leaves(template))
        assert all(np.all(np.isfinite(np.asarray(v))) for v in leaves)
        assert f"[{name}] final:" in stdout
    ens = json.loads((out / "ensemble.json").read_text())
    assert 0.0 <= ens["ensemble_acc"] <= 1.0 and len(ens["member_accs"]) == len(SOURCES)
    assert np.all(np.isfinite(result["class_weights"]))
    assert set(np.unique(np.load(out / "final_predict.npy"))) <= set(range(T_SHAPE[2]))


def test_compat_train_runs_the_curriculum_on_cpu(archives):
    t_dict, s_dict = {}, {}
    t_train = compat.TrainData(archives, "TinyT/TinyT_TRAIN.ts", t_dict)
    t_test = compat.TestData(archives, "TinyT/TinyT_TEST.ts", t_dict)
    s_train = compat.TrainData(archives, "TinyA/TinyA_TRAIN.ts", s_dict)
    s_test = compat.TestData(archives, "TinyA/TinyA_TEST.ts", s_dict)
    cfg = PipelineConfig(budget_multiplier=BUDGET)
    epochs = {"p1": 1, "p2": 1, "p3": 1, "p4": 1, "p5": 1}
    state, history = compat.train(t_train, t_test, s_train, s_test, with_nvidia=True,
                                  config=cfg, device="cpu", epochs=epochs, verbose=False)
    pipe = port_pipeline.StyleTransferPipeline(*T_SHAPE, *SOURCES["TinyA"], cfg, device="cpu")
    fresh = pipe.init_state(torch.Generator().manual_seed(0))
    assert set(state) == set(fresh)
    assert set(state["params"]) == set(port_pipeline.ALL_MODULES)
    phases = [h["phase"] for h in history]
    assert [p for p in dict.fromkeys(phases)] == ["p1", "p1_eval", "p2", "p2_eval", "p3",
                                                  "p3_eval", "p4", "p4_eval", "p5", "p5_eval"]


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
def test_train_members_parallel_keeps_the_order(devices):
    """One device runs the members in turn; several run them in threads,
    and the results come back in the members' order either way."""
    import time

    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_pipeline import (
        train_members_parallel,
    )

    done = []

    def member(i):
        time.sleep(0.05 * (3 - i))  # later members finish first in threads
        done.append(i)
        return i

    fns = [lambda i=i: member(i) for i in range(3)]
    assert train_members_parallel(fns, devices) == [0, 1, 2]
    if len(devices) == 1:
        assert done == [0, 1, 2]


def test_entry_points_refuse_without_cuda(archives, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is here")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(_cli_args(archives, tmp_path / "o"))
    d = {}
    ds = compat.TrainData(archives, "TinyT/TinyT_TRAIN.ts", d)
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.train(ds, ds, ds, ds, config=PipelineConfig(budget_multiplier=BUDGET))


def test_port_never_imports_pil_or_optax():
    """The card's machine has no PIL (the strip is written with zlib), and
    the port's optimizers are torch's."""
    port = REPO / "feature_level_style_transfer_for_tsc_tpu_torch"
    for f in sorted(port.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("PIL", "optax"), f"{f}: {line}"
