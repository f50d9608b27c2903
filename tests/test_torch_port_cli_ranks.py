"""The port's CLIs under ``torchrun``, on the CPU, against the JAX package's and one process.

Each run starts P gloo processes with ``parallel.launch.spawn``, each given
the environment ``torchrun`` gives its ranks and calling the CLI's ``main``
with ``--device cpu`` (``tests/_torch_port_cli_ranks.py``), so the CLI
joins through ``parallel.launch.torchrun_group`` as under torchrun.

* ``cli.predict`` over three member checkpoints (JAX target models, 2
  channels, T=16, 2 classes at budget 0.02, BatchNorm statistics moved off
  their initial values, heads scaled and centred so that each member's
  predictions vary, saved by the JAX package) in P = 2, 3 and 4
  processes: P >= 3 shards the members over ``make_mesh(data=1,
  domain=3)``, a member a rank (P = 4: the fourth rank off the mesh), P = 2
  runs the ensemble on rank 0 (``mesh=None``).  Held against JAX's
  ``cli.predict``, which takes its mesh path on the 8 virtual CPU devices
  of ``tests/conftest.py``: the same predictions and the same printed
  result line (accuracy and member accuracies); one ``_predict.npy``
  written, the bytes of the port's one-process run; every serving rank's
  gathered member logits the one-process run's, bit for bit; each rank's
  run-axis conv calls (one a layer and split on a rank that runs members).
* ``cli.multi_source`` in two processes, three commands one after
  another in the same launch: two sources (one epoch a phase; P >= M:
  member i trained by rank i, the vote on the two ranks' mesh), three
  sources (P < M: rank 0 trains members 0 and 2, rank 1 member 1, and rank
  0 votes alone, reading member 1 from the file rank 1 wrote) and
  ``--member-checkpoints`` over two of the JAX members (the mesh, each rank
  reading its own); each against the same command in one process: every
  file the same (members array by array, the rest byte for byte) and every
  voting rank's gathered member logits the same bits.

Also, in this process: ``torchrun_group`` without ``WORLD_SIZE`` (or 1)
joins nothing; under torchrun ``--device cuda`` without a card raises, as
does a device index; ``train_members_parallel`` with no devices named
raises without a card.
"""

import contextlib
import io
import json
import os
import socket
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_port_cli_ranks import cli_rank, recorded_logits

from feature_level_style_transfer_for_tsc_tpu.cli import predict as jax_predict
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu.io import save_checkpoint as jax_save
from feature_level_style_transfer_for_tsc_tpu.train.classifier import OSCNNClassifier as JaxOSCNN
from feature_level_style_transfer_for_tsc_tpu_torch.cli import multi_source as port_ms
from feature_level_style_transfer_for_tsc_tpu_torch.cli import predict as port_predict
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch
from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_pipeline import (
    train_members_parallel,
)

T_SHAPE = (2, 16, 2)
SOURCES = {"TinyA": (1, 12, 3), "TinyB": (3, 20, 4), "TinyC": (2, 14, 2)}
BUDGET = "0.02"
HEAD_SCALE = 30.0  # the members' head weights scaled up, their biases set to centre the logits
LAYERS = 6  # the target model's OS convs at this budget: 3 in the extractor, 3 in the classifier
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here, as in the ranks: the suite runs several
    worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_process(monkeypatch):
    """No torchrun environment in this process."""
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)


def _archive(root: Path, name: str, shape, seed: int):
    c, t, n = shape
    for split, s in (("TRAIN", seed), ("TEST", seed + 1)):
        x, y = make_arrays(10, c, t, n, seed=s)
        write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y)


def _member(seed: int, x: np.ndarray):
    """A JAX member ``{'params', 'mstate'}`` from ``seed``, its BatchNorm
    statistics moved off their initial values and its head scaled and
    centred on the series ``x``, so that each member's predictions vary
    from series to series."""
    model = JaxOSCNN(*T_SHAPE, config=JaxConfig(budget_multiplier=float(BUDGET)), with_cpc=False)
    st = model.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def moved(path, a):
        shape = np.shape(a)
        if jax.tree_util.keystr(path).endswith("var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0.0, 0.3, shape).astype(np.float32)

    member = {"params": st["params"],
              "mstate": jax.tree_util.tree_map_with_path(moved, st["mstate"])}
    head = member["params"]["cls"]["hidden"]
    logits = np.asarray(model.predict_logits(member["params"], member["mstate"], x))
    products = HEAD_SCALE * (logits - np.asarray(head["bias"]))
    head["weight"] = HEAD_SCALE * head["weight"]
    head["bias"] = jax.numpy.asarray(-np.median(products, axis=0), dtype=np.float32)
    return member


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_ranks")
    _archive(root / "arch", "TinyT", T_SHAPE, 0)
    for i, (name, shape) in enumerate(SOURCES.items()):
        _archive(root / "arch", name, shape, 5 + 2 * i)
    t_train, t_test, _, _ = port_predict.build_datasets(root / "arch", "TinyT", root / "arch",
                                                        "TinyA")
    x = np.concatenate([t_train.x, t_test.x])
    ckpts = [str(root / f"member{s}.npz") for s in (11, 12, 13)]
    for seed, path in zip((11, 12, 13), ckpts):
        jax_save(path, _member(seed, x))
    return {"root": root, "arch": str(root / "arch"), "ckpts": ckpts}


def _predict_args(setup, out):
    return ["--target-root", setup["arch"], "--target", "TinyT", "--source-root", setup["arch"],
            "--source", "TinyA", "--checkpoint", ",".join(setup["ckpts"]), "--out", str(out),
            "--budget-multiplier", BUDGET]


def _printed(main, args):
    """What ``main(args)`` printed, and its ``member_logits`` results."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), recorded_logits() as logits:
        main(args)
    return buf.getvalue(), logits


def _same_logits(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _result(stdout: str) -> str:
    """``cli.predict``'s one result line, without the output path."""
    lines = [line for line in stdout.splitlines() if line.startswith("n=")]
    assert len(lines) == 1, stdout
    return lines[0].split(" -> ")[0]


@pytest.fixture(scope="module")
def references(setup):
    """JAX's ``cli.predict`` (its mesh path: 8 devices >= 3 members) and
    the port's in one process."""
    jax_out, port_out = setup["root"] / "jax" / "ens", setup["root"] / "one" / "ens"
    jax_line = _result(_printed(jax_predict.main, _predict_args(setup, jax_out))[0])
    port_printed, port_logits = _printed(port_predict.main,
                                         _predict_args(setup, port_out) + ["--device", "cpu"])
    return {"jax_line": jax_line, "jax_preds": np.load(f"{jax_out}_predict.npy"),
            "port_line": _result(port_printed), "port_logits": port_logits,
            "port_bytes": Path(f"{port_out}_predict.npy").read_bytes()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(world: int, commands):
    """Each ``(cli, args)`` of ``commands`` in turn, in one launch of
    ``world`` processes: per command, the ranks' records in rank order."""
    runs = [(_free_port(), cli, args + ["--device", "cpu"]) for cli, args in commands]
    return list(zip(*launch.spawn(cli_rank, world, (runs,), timeout=300)))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_predict_under_torchrun_matches_jax_and_one_process(setup, references, world):
    out = setup["root"] / f"p{world}" / "ens"
    (ranks,) = _ranks(world, [("predict", _predict_args(setup, out))])
    assert references["port_line"] == references["jax_line"]
    printed = "".join(r["stdout"] for r in ranks)
    assert _result(printed) == references["jax_line"]
    np.testing.assert_array_equal(np.load(f"{out}_predict.npy"), references["jax_preds"])
    assert Path(f"{out}_predict.npy").read_bytes() == references["port_bytes"]
    assert sorted(p.name for p in out.parent.iterdir()) == ["ens_predict.npy"]
    voting = range(3) if world >= 3 else [0]  # the mesh's ranks, else rank 0 alone
    assert [r["runs_calls"] for r in ranks] == [2 * LAYERS if r in voting else 0
                                                for r in range(world)]
    assert len(references["port_logits"]) == 2  # the train split's, then the test split's
    for r in range(world):
        _same_logits(ranks[r]["logits"], references["port_logits"] if r in voting else [])
    assert [r["returned"] for r in ranks] == [r == 0 for r in range(world)]
    assert [f"[rank {r} of {world}] backend gloo, device cpu" in printed
            for r in range(world)] == [True] * world


def _same_files(got: Path, want: Path):
    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in got.iterdir()) == names
    for name in names:
        if name.endswith(".npz"):
            with np.load(got / name) as a, np.load(want / name) as b:
                assert sorted(a.files) == sorted(b.files), name
                for k in a.files:
                    assert a[k].dtype == b[k].dtype, (name, k)
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        else:
            assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_multi_source_under_torchrun_matches_one_process(setup):
    """Three commands in one launch of two processes, each against the same
    command in one process: every file the one-process run's.  Two sources:
    a member a rank, the vote on the two ranks' mesh.  Three sources (fewer
    ranks than members): members 0 and 2 on rank 0, member 1 on rank 1, the
    vote on rank 0 alone.  ``--member-checkpoints`` over two members: the
    mesh, no training."""
    epochs = json.dumps({"p1": 1, "p2": 1, "p3": 1, "p4": 1, "p5": 1})

    def args(out, sources, checkpoints=None):
        extra = ["--member-checkpoints", ",".join(checkpoints)] if checkpoints else []
        return ["--target-root", setup["arch"], "--target", "TinyT", "--source-root",
                setup["arch"], "--sources", ",".join(sources), "--out", str(out),
                "--budget-multiplier", BUDGET, "--phase-epochs", epochs] + extra

    names, root = list(SOURCES), setup["root"]
    commands = {"two": (names[:2],), "three": (names,), "ckpts": (names[:1], setup["ckpts"][:2])}
    one_logits = {what: _printed(port_ms.main, args(root / f"ms_{what}_one", *command)
                                 + ["--device", "cpu"])[1] for what, command in commands.items()}
    by_command = dict(zip(commands, _ranks(2, [("multi_source", args(root / f"ms_{what}", *c))
                                               for what, c in commands.items()])))
    for what in commands:
        _same_files(root / f"ms_{what}", root / f"ms_{what}_one")
    assert len(list((root / "ms_two").iterdir())) == 2 + 4
    assert len(list((root / "ms_three").iterdir())) == 3 + 4
    assert len(list((root / "ms_ckpts").iterdir())) == 4
    trained = {"two": [names[:1], names[1:2]], "three": [names[::2], names[1:2]],
               "ckpts": [[], []]}
    votes = {"two": [2 * LAYERS] * 2,  # its member's vote, train and test splits
             "three": [2 * LAYERS, 0],  # rank 0 votes alone
             "ckpts": [2 * LAYERS] * 2}
    for what, ranks in by_command.items():
        assert len(one_logits[what]) == 2  # the train split's, then the test split's
        for r, rec in enumerate(ranks):
            assert [n for n in names if f"[{n}] final:" in rec["stdout"]] == trained[what][r]
            assert rec["runs_calls"] == votes[what][r], (what, r)
            _same_logits(rec["logits"], one_logits[what] if votes[what][r] else [])
        assert "ensemble accuracy:" in ranks[0]["stdout"]
        assert "ensemble accuracy:" not in ranks[1]["stdout"]
        assert [rec["returned"] for rec in ranks] == [True, False]


@pytest.mark.parametrize("world_size", [None, "1"])
def test_torchrun_group_alone_joins_nothing(monkeypatch, world_size):
    if world_size is not None:
        monkeypatch.setenv("WORLD_SIZE", world_size)
    with launch.torchrun_group("cpu") as (rank, world, device):
        assert (rank, world, device) == (0, 1, torch.device("cpu"))
        assert not dist.is_initialized()


def _as_rank_of_two(monkeypatch):
    for var, value in zip(TORCHRUN_ENV, ("1", "2", "1", "2")):
        monkeypatch.setenv(var, value)


@pytest.mark.parametrize("cli", ["predict", "multi_source"])
def test_torchrun_refuses_cuda_without_a_card(setup, monkeypatch, cli):
    """A rank asked for ``--device cuda`` on a machine without CUDA raises
    before it joins: no fallback hides the device."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is here")
    _as_rank_of_two(monkeypatch)
    args = {"predict": _predict_args(setup, setup["root"] / "refused" / "ens"),
            "multi_source": ["--target-root", setup["arch"], "--target", "TinyT",
                             "--source-root", setup["arch"], "--sources", "TinyA",
                             "--out", str(setup["root"] / "refused_ms")]}[cli]
    main = {"predict": port_predict.main, "multi_source": port_ms.main}[cli]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args + ["--device", "cuda"])
    assert not dist.is_initialized()


def test_torchrun_group_refuses_a_device_index(monkeypatch):
    _as_rank_of_two(monkeypatch)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        with launch.torchrun_group("cpu:0"):
            pass
    assert not dist.is_initialized()


def test_train_members_parallel_refuses_without_cuda():
    """With no devices named it takes every card, and raises without CUDA
    (name ``["cpu"]`` for the CPU), as ``resolve_device`` does."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is here")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_members_parallel([lambda: 1])
    assert train_members_parallel([lambda: 1], ["cpu"]) == [1]
