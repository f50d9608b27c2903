"""Loop: K seeds' joint (phase-5) training steps at once, closed loop.

The program's ``MultiRunStylePipeline.phase5_step`` on K stacked runs of one dataset pair,
broadcast to every run as ``MultiRunData.broadcast`` gives it.  Each run takes its batches in
epoch order from the training splits by its own permutation; each epoch's batches go to the
card in one move, as the program's ``phase5_epoch`` moves them; the per-epoch learning-rate
schedules are left out.  Set-up builds the K-run state from the benchmark's weights and runs
the first ``check_steps`` steps through the same call and feed as the window: they build and
warm every kernel, and the reference follows them (``check_runs`` of the runs, drawn from the
seed) once the window has closed.  The window then steps until ``--seconds`` have passed.

The WaveGlow's end projections start at zero, so the first step's coupling is the identity
and no first gradient reaches the WN kernels' work: the flow's (``nf``) second-step gradients,
read from RMSprop's state after two steps, are compared on their own.

The configuration's ``log_s_clamp`` (the flow's log-scale bound) goes to the program's
``PipelineConfig`` and to the reference alike.

Traffic keys: ``runs`` (K), ``batch``, ``check_steps``, ``check_runs``, ``trace_steps``,
``limits`` (``loss_gap``, ``grad_median_gap``, ``change_median_gap``, ``nf_grad2_median_gap``).
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import cell, data, port, precision, trace, weights, work
from reference import model
from reference import train as ref

SERIES_KEYS = ("t", "s")
CHECKS = ("loss_gap", "grad_median_gap", "change_median_gap", "nf_grad2_median_gap")
#: the module whose second-step gradients are compared: the flow, with its WN couplings
SECOND = "nf"


def _shapes(config):
    t, s = config["target"], config["source"]
    return model.shapes((t["channels"], t["length"], t["classes"]),
                        (s["channels"], s["length"], s["classes"]),
                        config.get("budget_scale", 1.0), config["max_kernel_size"])


def _specs(config, sh):
    return model.pipeline_specs(sh, config["flow"], config["cdan_dim"], config["cpc_hidden"])


def log_s_clamp(config) -> float:
    """The flow's log-scale bound the configuration states (0: none)."""
    return float(config.get("log_s_clamp", 0.0))


def _program(config, device):
    pkg = port.module("config")
    pipeline = port.module("train.pipeline")
    multirun = port.module("train.multirun")
    flow = config["flow"]
    cfg = pkg.PipelineConfig(
        batch_size=config["batch_size"], max_kernel_size=config["max_kernel_size"],
        cdan_dim=config["cdan_dim"], cpc_hidden=config["cpc_hidden"],
        budget_multiplier=config.get("budget_scale", 1.0), log_s_clamp=log_s_clamp(config),
        flow=pkg.FlowConfig(n_flows=flow["n_flows"], wn_channels=flow["wn_channels"],
                            wn_layers=flow["wn_layers"]))
    t, s = config["target"], config["source"]
    pipe = pipeline.StyleTransferPipeline(t["channels"], t["length"], t["classes"],
                                          s["channels"], s["length"], s["classes"],
                                          config=cfg, device=device)
    return pipe, multirun.MultiRunStylePipeline(pipe), multirun.stack_states


def _splits(config, rng):
    t, s = config["target"], config["source"]
    return {"t": data.series(t["train"], t["channels"], t["length"], t["classes"], rng),
            "s": data.series(s["train"], s["channels"], s["length"], s["classes"], rng)}


class Epochs:
    """Each run's batches in epoch order: per epoch a permutation a run and domain, paired
    to the shorter domain's batch count (the reference's rounds per epoch)."""

    def __init__(self, splits, runs: int, batch: int, rng: np.random.Generator):
        self.splits, self.runs, self.batch, self.rng = splits, runs, batch, rng

    def next(self):
        out = []
        for key in SERIES_KEYS:
            x, y = self.splits[key]
            idx = np.stack([data.epoch_order(len(y), self.batch, self.rng)
                            for _ in range(self.runs)])
            out.append((x[idx], y[idx]))
        nb = min(out[0][1].shape[1], out[1][1].shape[1])
        (xt, yt), (xs, ys) = out
        return xt[:, :nb], yt[:, :nb], xs[:, :nb], ys[:, :nb]


def _norms(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1)


def _first_grads(states, named):
    """Each leaf's first gradient norm a run, worked out from its optimizer's state after
    one step: RMSprop's square_avg is 0.01 g^2, Adam's exp_avg 0.1 g."""
    out = {}
    for m, items in named.items():
        opt = states["opt"][m]
        kind = type(opt).__name__
        for i, (path, _) in enumerate(items):
            if kind == "StackedRMSprop":
                g = torch.sqrt(opt.state["square_avg"][i].reshape(opt.runs, -1).sum(1) / 0.01)
            elif kind == "StackedAdam":
                g = _norms(opt.state["exp_avg"][i]) / 0.1
            else:
                raise cell.Refused(f"module {m}: optimizer {kind} is not the default's")
            out[f"{m}.{path}"] = g.cpu().numpy()
    return out


def _square_sums(states, named, module: str) -> list:
    """Each leaf of ``module``: the sum a run of RMSprop's square_avg, in float64."""
    opt = states["opt"][module]
    if type(opt).__name__ != "StackedRMSprop":
        raise cell.Refused(f"module {module}: optimizer {type(opt).__name__} is not RMSprop")
    return [opt.state["square_avg"][i].reshape(opt.runs, -1).double().sum(1)
            for i in range(len(named[module]))]


def _second_grads(before: list, after: list, named, module: str) -> dict:
    """Each leaf's second gradient norm a run from RMSprop's square_avg after one step and
    after two: 0.01 g2^2 = after - 0.99 before."""
    return {f"{module}.{path}": torch.sqrt(((b - 0.99 * a) / 0.01).clamp(min=0)).cpu().numpy()
            for (path, _), a, b in zip(named[module], before, after)}


def _gap(prog: float, ref_v: float, scale: float) -> float:
    return abs(prog - ref_v) / max(abs(ref_v), scale)


def live_leaves(g_ref: dict) -> list:
    """The leaves whose reference first gradient is not nought to rounding: at least a
    ten-thousandth of its module's whole first gradient.  Leaves a loss is analytically
    blind to get round-off alone (a conv bias before training-mode BatchNorm, CPC's
    prediction biases under its softmax, the critic's output bias under CDAN's normalised
    weights), and RMSprop moves them by its full step whatever the size; the WN layers
    behind a zero end projection get exactly nought."""
    module = {}
    for p, v in g_ref.items():
        m = p.split(".", 1)[0]
        module[m] = module.get(m, 0.0) + v * v
    return [p for p, v in g_ref.items() if v > 0 and v >= 1e-4 * module[p.split(".", 1)[0]] ** 0.5]


def _leaf_gaps(program: dict, reference: dict, k: int, kind: str, live: list) -> list:
    r = reference[kind]
    med = float(np.median([r[p] for p in live]))
    return sorted(((_gap(float(program[kind][p][k]), r[p], med), p) for p in live), reverse=True)


def _global_gap(program: dict, reference: dict, k: int, kind: str, live: list) -> float:
    got = sum(float(program[kind][p][k]) ** 2 for p in live) ** 0.5
    want = sum(reference[kind][p] ** 2 for p in live) ** 0.5
    return abs(got - want) / want


def compare(program: dict, reference: dict, k: int) -> dict:
    """Run ``k``'s numbers: the first step's widest loss gap (relative, at least against 1),
    and over the live leaves (``live_leaves``) the median leaf's gap of first-gradient norms
    and of the norms of the change over the checked steps, each against the larger of the
    leaf's and the median live leaf's reference norm; the same of the second-step gradient
    norms over the flow's live leaves (``SECOND``).  Also, for standard error, each step's
    widest loss gap and the worst leaves, which swing from seed to seed."""
    live = live_leaves(reference["first_grad"])
    live2 = live_leaves({p: v for p, v in reference["second_grad"].items()
                         if p.split(".", 1)[0] == SECOND})
    by_key = [{key: _gap(float(program["losses"][s][key][k]), reference["losses"][s][key], 1.0)
               for key in ref.LOSSES} for s in range(len(reference["losses"]))]
    steps = [max(d.values()) for d in by_key]
    grad = _leaf_gaps(program, reference, k, "first_grad", live)
    change = _leaf_gaps(program, reference, k, "change", live)
    grad2 = _leaf_gaps(program, reference, k, "second_grad", live2)
    return {"loss_gap": steps[0],
            "grad_median_gap": float(np.median([g for g, _ in grad])),
            "change_median_gap": float(np.median([g for g, _ in change])),
            "nf_grad2_median_gap": float(np.median([g for g, _ in grad2])),
            "detail": {"run": k, "loss_gap_by_step": steps,
                       "first_loss_worst": max(by_key[0], key=by_key[0].get), "live": len(live),
                       "live_nf2": len(live2),
                       "change_global_gap": _global_gap(program, reference, k, "change", live),
                       "grad_worst": grad[:2], "change_worst": change[:2],
                       "nf_grad2_worst": grad2[:2]}}


def make_inputs(r: "cell.Run") -> SimpleNamespace:
    """Everything a run draws from its seed: the weights' seed, each run's seed (its CPC
    anchors and dropout), the splits and their epoch orders, the checked steps' batches and
    the runs the reference follows."""
    config, traffic = r.config, r.traffic
    k_runs = traffic["runs"]
    rng = np.random.default_rng(r.seed)
    w_seed, *run_seeds = (int(v) for v in rng.integers(0, 2**62, size=1 + k_runs))
    sh = _shapes(config)
    epochs = Epochs(_splits(config, rng), k_runs, config["batch_size"], rng)
    first = epochs.next()
    check = np.random.default_rng(r.seed + 1).choice(k_runs, traffic["check_runs"], replace=False)
    return SimpleNamespace(
        w_seed=w_seed, run_seeds=run_seeds, sh=sh, specs=_specs(config, sh), epochs=epochs,
        first=first, checked=[tuple(a[:, j] for a in first) for j in range(traffic["check_steps"])],
        check=sorted(int(k) for k in check))


def _cast(tree, dtype):
    """``tree`` (dicts, lists, NamedTuples) with its floating tensors in ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_cast(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


def reference_runs(r: "cell.Run", inp: SimpleNamespace, dtype=torch.float32) -> dict:
    """The reference's steps of the checked runs, from the weights drawn again, computed
    in ``dtype``."""
    device = r.device
    tree = weights.materialize(inp.specs, r.traffic["runs"], inp.w_seed, device)
    masks = _cast(model.masks_for(inp.sh, device), dtype)
    out = {}
    for k in inp.check:
        one = _cast(weights.run_slice(tree, k), dtype)
        steps = [tuple(_cast(torch.as_tensor(a[k]).to(device), dtype) for a in b)
                 for b in inp.checked]
        steps = [(bt, lt.long(), bs, ls.long()) for bt, lt, bs, ls in steps]
        out[k] = ref.run_steps(one["params"], one["mstate"], one["consts"], inp.sh, masks, steps,
                               inp.run_seeds[k], 0, r.config["flow"]["wn_channels"],
                               log_s_clamp(r.config))
        cell.free_device()
    return out


def run(r: "cell.Run") -> "cell.Outcome":
    config, traffic, device = r.config, r.traffic, r.device
    k_runs, batch = traffic["runs"], config["batch_size"]
    if traffic["check_steps"] < 2:
        raise cell.Refused("the checks need two steps at least (the second-step gradients)")
    inp = make_inputs(r)
    sh = inp.sh

    pipe, multi, stack_states = _program(config, device)
    if [list(map(tuple, l)) for l in pipe.t_ext_specs] != [list(map(tuple, l)) for l in sh.t_ext]:
        raise cell.Refused("the program's OS-CNN layers differ from the configuration's")
    tree = weights.materialize(inp.specs, k_runs, inp.w_seed, device)
    states = stack_states([pipe.training_state(port.to_program(weights.run_slice(tree, k)),
                                               inp.run_seeds[k]) for k in range(k_runs)])
    del tree
    cell.free_device()
    named = {m: ref.named_leaves(states["params"][m]) for m in ref.MODULES}
    tracer = trace.Tracer(r.trace)

    feed = {"e": 0, "j": 0, "dev": multi._on_device(inp.first)}

    def step():
        if feed["j"] == feed["dev"][0].shape[1]:
            feed["e"], feed["j"] = feed["e"] + 1, 0
            with tracer.span("batch_to_device"):
                feed["dev"] = multi._on_device(inp.epochs.next())
        xt, yt, xs, ys = feed["dev"]
        j = feed["j"]
        feed["j"] += 1
        with tracer.span("step"):
            return multi.phase5_step(states, xt[:, j], yt[:, j].long(), xs[:, j], ys[:, j].long(),
                                     feed["e"])

    # set-up: the checked first steps, which also build and warm every kernel
    n_check = traffic["check_steps"]
    p0 = {m: [t.detach().clone() for _, t in items] for m, items in named.items()}
    program = {"losses": []}
    for s in range(n_check):
        losses = step()
        program["losses"].append({k: v.cpu().numpy() for k, v in losses.items()})
        if s == 0:
            program["first_grad"] = _first_grads(states, named)
            squares = _square_sums(states, named, SECOND)
        elif s == 1:
            program["second_grad"] = _second_grads(squares, _square_sums(states, named, SECOND),
                                                   named, SECOND)
    program["change"] = {f"{m}.{path}": _norms(t.detach() - p0[m][i]).cpu().numpy()
                         for m, items in named.items() for i, (path, t) in enumerate(items)}
    del p0
    cell.free_device()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    window_start = time.time()
    t0 = time.perf_counter()
    window_losses = []
    while True:
        window_losses.append(step())
        if time.perf_counter() - t0 >= r.seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    steps = len(window_losses)

    sl, traced_s = None, window_s
    if r.trace:
        def traced():
            for _ in range(traffic["trace_steps"]):
                window_losses.append(step())
            return traffic["trace_steps"]

        layers = config["flow"]["wn_layers"]
        for attempt in range(2):
            sl = trace.trace_slice(traced, port.launches)
            complete, kept = trace.completeness(sl, layers)
            if complete:
                break
            if attempt:
                raise cell.Refused(f"the profile lost launches twice: {kept}")
        traced_s = window_s + sl.wall_s
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(1 for losses in window_losses
                 if not all(bool(torch.isfinite(v).all()) for v in losses.values()))
    attempted = len(window_losses)
    del states, multi, pipe, window_losses, feed
    cell.free_device()

    # the reference, once the window has closed
    t_ref = time.perf_counter()
    try:
        refs = reference_runs(r, inp)
    except RuntimeError as e:  # the reference's own steps failed (a singular flow weight)
        print(f"detail the reference failed: {e}", file=sys.stderr)
        refs = None
    if refs is None:
        checks = [cell.Check(name, float("inf"), r.limit(name)) for name in CHECKS]
    else:
        gaps = [compare(program, refs[k], k) for k in inp.check]
        for g in gaps:
            print(f"detail {g['detail']}", file=sys.stderr)
        checks = [cell.Check(name, max(g[name] for g in gaps), r.limit(name)) for name in CHECKS]
    print(f"detail reference_s {time.perf_counter() - t_ref:.1f} failed_steps {failed}",
          file=sys.stderr)

    table = work.step_table(sh, batch, config["flow"], config["cdan_dim"], config["cpc_hidden"])
    t = config["target"]
    h = sh.feat // 2
    wn_args = (h, config["flow"]["wn_channels"], config["flow"]["wn_layers"])
    nfl = config["flow"]["n_flows"]
    pair_f, inf_f = work.wn_fwd(2 * batch, t["length"], *wn_args), work.wn_fwd(batch, t["length"], *wn_args)
    pair_b, inf_b = work.wn_bwd(2 * batch, t["length"], *wn_args), work.wn_bwd(batch, t["length"], *wn_args)
    # a step's WN calls: forward pair and infer a flow; backward pulls total (both),
    # t_nf + s_nf (pair), s2t2s_c (both)
    wn_calls = [(pair_f, nfl), (inf_f, nfl), (pair_b, 3 * nfl), (inf_b, 2 * nfl)]
    per_step = {
        "model_flops": k_runs * sum(v["fwd"] + v["bwd"] for v in table.values()),
        "wn_flops": k_runs * sum(w["flops"] * n for w, n in wn_calls),
        "wn_bytes": k_runs * sum(w["bytes"] * n for w, n in wn_calls),
        "wn_calls": 2 * nfl + 5 * nfl,
    }
    series = 2 * batch * k_runs
    return cell.Outcome(
        metrics={"train_series_per_s": steps * series / window_s},
        attempted=attempted, failed=failed, checks=checks, memory_peak_bytes=int(peak),
        window_start=window_start, slice=sl, traced_window_s=traced_s,
        traced_units=steps + (sl.units if sl is not None else 0), work=per_step)


def as_program(refs: dict, k_runs: int) -> dict:
    """Reference results of some runs in the layout of the program's records."""
    first = next(iter(refs.values()))

    def arr(get):
        out = np.full(k_runs, np.nan)
        for k, v in refs.items():
            out[k] = get(v)
        return out

    return {"losses": [{key: arr(lambda v, s=s, key=key: v["losses"][s][key]) for key in ref.LOSSES}
                       for s in range(len(first["losses"]))],
            "first_grad": {p: arr(lambda v, p=p: v["first_grad"][p]) for p in first["first_grad"]},
            "second_grad": {p: arr(lambda v, p=p: v["second_grad"][p])
                            for p in first["second_grad"]},
            "change": {p: arr(lambda v, p=p: v["change"][p]) for p in first["change"]}}


def control(r: "cell.Run") -> dict:
    """The control's numbers: the reference computed in TF32 in the program's place, held
    against the float32 reference by the same comparison."""
    inp = make_inputs(r)
    base = reference_runs(r, inp)
    with precision.tf32(r.device):
        low = reference_runs(r, inp)
    prog = as_program(low, r.traffic["runs"])
    gaps = [compare(prog, base[k], k) for k in inp.check]
    for g in gaps:
        print(f"detail {g['detail']}", file=sys.stderr)
    return {name: max(g[name] for g in gaps) for name in CHECKS}


def witness(r: "cell.Run") -> dict:
    """Two correct computations held against each other by the same comparison: the
    reference in float32 in the program's place, against the reference in float64.  What
    it reads is what rounding alone moves each number by."""
    inp = make_inputs(r)
    base = reference_runs(r, inp, torch.float64)
    prog = as_program(reference_runs(r, inp), r.traffic["runs"])
    gaps = [compare(prog, base[k], k) for k in inp.check]
    for g in gaps:
        print(f"detail {g['detail']}", file=sys.stderr)
    return {name: max(g[name] for g in gaps) for name in CHECKS}
