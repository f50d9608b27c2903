"""The rank side of ``tests/test_torch_port_cli_ranks.py``: the CLIs'
``main``, one command after another, in a process that
``parallel.launch.spawn`` started, with the environment
``torchrun`` gives its ranks (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), so the CLI joins
its group through ``parallel.launch.torchrun_group`` as under torchrun.  No
jax here: the processes start faster without it."""

import contextlib
import io
import os

import torch

from feature_level_style_transfer_for_tsc_tpu_torch.cli import multi_source, predict
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv
from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
    MultiSourceEnsemble,
)

RUNS_FORMS = ("os_conv_runs", "os_conv_fused_runs")


@contextlib.contextmanager
def recorded_logits():
    """Every ``MultiSourceEnsemble.member_logits`` result inside (with a
    mesh, every rank's members gathered), as numpy arrays in call order."""
    calls = []
    member_logits = MultiSourceEnsemble.member_logits

    def recording(self, *args):
        out = member_logits(self, *args)
        calls.append(out.detach().cpu().numpy().copy())
        return out

    MultiSourceEnsemble.member_logits = recording
    try:
        yield calls
    finally:
        MultiSourceEnsemble.member_logits = member_logits


def cli_rank(rank: int, world: int, runs) -> list:
    """Each ``(port, cli, argv)`` of ``runs`` in turn: ``cli``'s
    ``main(argv)`` as rank ``rank`` of ``world``, its group on ``port``.
    For each, what it printed, whether it returned a result, its run-axis
    conv calls and its ``member_logits`` results."""
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost"})
    torch.set_num_threads(1)
    calls = dict.fromkeys(RUNS_FORMS, 0)
    for name in RUNS_FORMS:
        fn = getattr(osconv, name)

        def counting(*args, _name=name, _fn=fn):
            calls[_name] += 1
            return _fn(*args)

        setattr(osconv, name, counting)
    records = []
    for port, cli, argv in runs:
        os.environ["MASTER_PORT"] = str(port)
        calls.update(dict.fromkeys(RUNS_FORMS, 0))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed), recorded_logits() as logits:
            result = {"predict": predict.main, "multi_source": multi_source.main}[cli](list(argv))
        records.append({"rank": rank, "stdout": printed.getvalue(), "logits": logits,
                        "returned": result is not None, "runs_calls": sum(calls.values())})
    return records
