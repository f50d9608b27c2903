"""What decides ``correct``, shown to fail: the control and the planted faults.

The control is the reference computed in TF32 in the program's place (on the CPU, TF32's
rounding of every matmul and conv operand); it has to read past one of the cell's limits.
Each fault is planted in the program underneath a whole run of the cell's loop, which
has to come out not correct: a training step that returns its state unchanged, half of
each batch left out (the means taken over the rest), the WN backward's weight gradients
halved, the WN forward's output lost, and an answer altered where it is produced.
"""

from __future__ import annotations

import pytest

from conftest import tiny_run
from harness import cell, faults

CELLS = ("scp2_ethanol.train_k8", "haptics_3src.serve_ensemble3", "scp2_ethanol.serve_single")


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_a_limit(workload):
    run, _ = tiny_run(workload, seed=2**31 + 5)
    numbers = cell.loop(run.traffic).control(run)
    assert any(numbers[k] > run.limit(k) for k in numbers), numbers


CASES = [(w, f) for w, d in (("scp2_ethanol.train_k8", "train_multirun"),
                              ("scp2_ethanol.serve_single", "serve_single"),
                              ("haptics_3src.serve_ensemble3", "serve_ensemble"))
         for f in faults.FAULTS[d]]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_a_planted_fault_is_not_correct(workload, fault):
    run, bench = tiny_run(workload)
    with faults.planted(run.traffic["loop"], fault):
        result = cell.execute(run, bench, 0.0)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_program_is_correct(workload):
    run, bench = tiny_run(workload)
    result = cell.execute(run, bench, 0.0)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.gpu
def test_the_control_fails_on_the_card(cuda):
    """The control at the single-checkpoint cell's own size on the card (one seed)."""
    from conftest import ROOT

    bench = cell.load_benchmark(ROOT)
    entry, config, traffic = cell.find_cell(bench, ROOT, "scp2_ethanol.serve_single")
    run = cell.Run("scp2_ethanol.serve_single", entry, config, traffic, 2**31 + 3, 1.0, False,
                   cuda, ROOT)
    numbers = cell.loop(traffic).control(run)
    assert any(numbers[k] > run.limit(k) for k in numbers), numbers
