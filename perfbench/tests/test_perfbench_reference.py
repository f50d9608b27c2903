"""The frozen reference against the program's plain CPU path, at the tiny size.

The program on the CPU runs its kernels' plain PyTorch versions; the reference is an
independent copy of the model math.  Running each cell's loop there, the first training
step's losses, every leaf's first gradient and the step's change, and every served logit,
class weight and answer agree to float32 rounding.
"""

from __future__ import annotations

import pytest

from conftest import tiny_run
from harness import cell


def _checks(workload, **traffic):
    run, _ = tiny_run(workload)
    run.traffic.update(traffic)
    out = cell.loop(run.traffic).run(run)
    return {c.name: c.value for c in out.checks}, out


def test_training_step_matches_the_reference():
    got, out = _checks("scp2_ethanol.train_k8", check_steps=2)
    assert got["loss_gap"] < 1e-5
    assert got["grad_median_gap"] < 1e-5
    assert got["change_median_gap"] < 1e-4
    assert got["nf_grad2_median_gap"] < 1e-4
    assert out.attempted >= 1 and out.failed == 0


def test_three_steps_stay_close():
    got, _ = _checks("scp2_ethanol.train_k8")
    assert got["grad_median_gap"] < 1e-5
    assert got["change_median_gap"] < 1e-3
    assert got["nf_grad2_median_gap"] < 1e-4


def test_the_second_step_reaches_the_wn_kernels():
    """The flow's second-step gradients, which the WN kernels' work feeds, are live: the
    WN's internal leaves, which the first step's zero end projection leaves at nought."""
    from loops import train_multirun as loop

    run, _ = tiny_run("scp2_ethanol.train_k8")
    inp = loop.make_inputs(run)
    refs = loop.reference_runs(run, inp)
    for k, out in refs.items():
        first = {p: v for p, v in out["first_grad"].items() if p.startswith("nf.")}
        second = {p: v for p, v in out["second_grad"].items() if p.startswith("nf.")}
        live2 = loop.live_leaves(second)
        dead1 = [p for p, v in first.items() if v == 0.0]
        assert dead1 and set(dead1) <= set(live2), (k, dead1, live2)
        assert len(live2) > len(second) // 2


@pytest.mark.parametrize("workload", ["scp2_ethanol.serve_single", "haptics_3src.serve_ensemble3"])
def test_serving_matches_the_reference(workload):
    got, out = _checks(workload)
    assert got["logit_gap"] < 1e-4
    assert got["answer_gap"] == 0.0
    assert got.get("weights_gap", 0.0) == 0.0
    assert out.attempted >= 1


@pytest.mark.parametrize("clamp", [2.0, 0.02])
def test_the_flow_log_scale_bound_matches_the_program(clamp):
    """The configuration's ``log_s_clamp``, at the benchmark's value and at one small enough
    to bite from the second step on, is applied alike by the program and the reference."""
    run, _ = tiny_run("scp2_ethanol.train_k8")
    run.config["log_s_clamp"] = clamp
    out = cell.loop(run.traffic).run(run)
    got = {c.name: c.value for c in out.checks}
    assert got["loss_gap"] < 1e-5
    assert got["grad_median_gap"] < 1e-5
    assert got["change_median_gap"] < 1e-3
    assert got["nf_grad2_median_gap"] < 1e-4
    assert out.failed == 0


def test_the_reference_flow_bound_is_a_bijection():
    """``soft_clamp`` bounds every log-scale and the reference's inverse undoes its forward
    under it, with an end projection that makes the log-scales large."""
    import torch

    from reference import model
    from harness import weights

    g = torch.Generator().manual_seed(3)
    specs = model.wn_specs(3, 8, 2)
    p = {"convinv": [], "wn": []}
    for _ in range(2):
        q, _ = torch.linalg.qr(torch.randn(6, 6, generator=g))
        p["convinv"].append({"weight": q})
        wn = weights.materialize(specs, 1, 5, torch.device("cpu"))
        wn = weights.run_slice(wn, 0)
        wn["end"]["weight"] = 3.0 * torch.randn(wn["end"]["weight"].shape, generator=g)
        p["wn"].append(wn)
    x = torch.randn(4, 16, 6, generator=g)
    z, ls, _ = model.waveglow_forward(p, x, 8, 0.5)
    raw = model.waveglow_forward(p, x, 8)[1]
    assert max(float(s.abs().max()) for s in raw) > 1.0
    assert all(float(s.abs().max()) <= 0.5 for s in ls)
    torch.testing.assert_close(model.waveglow_infer(p, z, 8, 0.5), x, rtol=1e-4, atol=1e-4)


def test_a_near_tie_in_the_train_split_is_judged_by_its_weights():
    """A train-split prediction that rounding flips on a near tie moves the class weights,
    and the vote with them: the served answer is judged under the weights the reference
    accepts, and an answer that no accepted weights give still fails."""
    import torch

    from loops import serve_ensemble as loop
    from reference import serve as ref

    run, _ = tiny_run("haptics_3src.serve_ensemble3")
    run.config["target"]["classes"] = 3
    g = torch.Generator().manual_seed(7)
    want_train = torch.randn(3, 12, 3, generator=g)
    want_train[0, 0] = torch.tensor([1.0, 1.0 - 1e-7, -1.0])
    y_train = torch.zeros(12, dtype=torch.long)
    y_train[1:] = want_train[0, 1:].argmax(-1)
    served_train = want_train.clone()
    served_train[0, 0, 1] = 1.0 + 1e-7  # the near tie broken the other way
    want_test = torch.randn(3, 9, 3, generator=g)
    w_served = loop.accepted_weights(run, served_train, want_train, y_train)
    w_own = ref.class_weights(want_train.argmax(-1), y_train, 3)
    assert not torch.equal(w_served, w_own)
    vote = run.config["vote"]
    scores = ref.vote_scores(want_test, w_served, vote["entropy_scale"], vote["weight_base"])
    preds = scores.argmax(-1).numpy()
    assert loop.answer_gap(run, preds, served_train, want_train, y_train, want_test) == 0.0
    assert loop.weights_gap(run, w_served, served_train, want_train, y_train) == 0.0
    wrong = scores.argmin(-1).numpy()
    assert loop.answer_gap(run, wrong, served_train, want_train, y_train, want_test) > 2e-3
