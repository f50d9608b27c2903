#!/usr/bin/env python3
"""Check and time the port's WN kernels ``wn_fwd`` and ``wn_bwd`` at the
shapes of ``chip_smoke.py`` phase 6 (f32) or phase 19 (``--bf16``), with
their device time by ``__global__`` kernel.

Run from the repository root on a CUDA card:

    python3 experiments/wn_time.py [--tree DIR] [--reps N] [--label NAME] [--bf16]
                                   [--save PATH] [--against PATH] [--changed NAME]
                                   [--breakdown] [--bias-gaps]

Builds ``wn_fused`` (``ops/csrc``) of the port in ``DIR`` (default: this
tree) and prints ptxas's register and spill lines.  f32: at the pair pass
(B=40, T=1152, n_half 25), the infer pass (B=20), and VendGunPoint's (B=40,
T=150, n_half 65) and VendCoffee's (B=40, T=60, n_half 168) pair passes (C
120, 8 layers, phase 6's inputs) holds every output of ``wn_fwd`` and
``wn_bwd`` against ``wn_fwd_plain`` and ``wn_bwd_plain`` (max|diff| over
max|plain|), checks that two runs give the same bits, and prints the time of
a call beside its FLOPs, and under ``torch.profiler`` the device time a call
of each kernel it launches.

``--bf16`` takes the bf16 instances (``FLSTTSC_WN_MXU=bf16``):
``wn_fwd[bf16]`` and ``wn_bwd[bf16]`` at pair and infer (phase 6's inputs),
held to the plain bf16 versions by phase 19's gates (``wn_bf16_gaps``,
``check_wn_bf16``: the tight outputs within BF16_REL_L2 or BF16_FLIPS times
their control, the free-running ones within BF16_CASCADE of the switch's
effect), the same bits twice, timed beside the bound at the BF16 peak
(effective TFLOP/s, share of the bound); then the run-axis forms
(``wn_fwd_runs[bf16]``, ``wn_bwd_runs[bf16]``) on every distinct WN call of
one K = 8 phase-5 step of ``MultiRunStylePipeline`` with both bf16
switches at the reference main.py pair's shapes (WN end projections 0.1
N(0, 1), as phase 19), each run the one-run call's bits and within phase
19's bars of the plain version (``chip_smoke.run_axis_rows``), timed
beside the K one-run calls.  With a port that has ``global_kernels``, the
launches a call of each ``__global__`` kernel are checked against it.
``--breakdown`` prints only that: each call's device time and launches by
kernel, in a process of its own (``chip_smoke.py`` phase 19 takes its bf16
rows' breakdown so: late in that long process the profiler returned no
device event of whole calls).  ``--bias-gaps`` prints only the top
layer's bias gradients (gbc, gbi, gbr) of ``wn_bwd[bf16]`` at each case of
the ``gpu`` test ``test_wn_bf16_kernels_match_plain`` (its operands; this
tree's ``tests/test_torch_port_kernels.py``): relative L2 against
``wn_bwd_plain(..., bf16=True)``, against it with g_skip summed in the
kernel's order, and the plain version's own gap to its float64-sum control
(the readings behind that test's BF16_BIAS_BEFORE; run it in turns with
``--tree`` on the other tree).

The inputs, the timing, the FLOP count, the gates and the profiler
breakdown are this tree's ``chip_smoke.py``'s own; only the port under test
changes with ``--tree``.  To compare two trees, unpack the other one (``git
archive``) into a git-ignored directory and run this script with and
without ``--tree`` in turns in one call (parent, change, change, parent):
each run is a process of its own, so each imports one port.  ``--save
PATH`` writes every one-run call's outputs (hundreds of MB: under
``build/``), ``--against PATH`` reports, output set by output
set, whether this run's are the same bits (``same_bits``; the ok flag
takes every output set but those that ``--changed NAME`` names, e.g.
``--changed "wn_fwd[bf16]"`` for a change to the bf16 forward, whose
output sets start with that name).  Prints one JSON line a kernel and
shape and a last line {"ok": ..., "label": ..., "card": ...}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
C, LAYERS = 120, 8
SHAPES = (("pair", 40, 1152, 25), ("infer", 20, 1152, 25),
          ("VendGunPoint", 40, 150, 65), ("VendCoffee", 40, 60, 168))
BF16_SHAPES = SHAPES[:2]
RUNS_K = 8


def load_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module, by path (another tree given
    by ``--tree`` may have its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def breakdown(smoke, wn_fused, what: str, call, entry: str, bf16: bool) -> dict:
    """``kernel_breakdown`` of ``call``; the launches by kernel checked
    where the port states them (``global_kernels``)."""
    kernels = getattr(wn_fused, "global_kernels", None)
    expected = None if kernels is None else kernels(LAYERS, bf16)[entry]
    by_kernel = smoke.kernel_breakdown(call, expected=expected)
    if expected is not None:
        smoke.check_breakdown(what, by_kernel, expected)
    return by_kernel


def f32_rows(smoke, wn_fused, wn_init, weight_norm_weight, label, reps, outputs) -> bool:
    names = {"wn_fwd": ("y", "aud", "skip"),
             "wn_bwd": ("gx", "gws", "gbs", "gwc", "gbc", "gwi", "gbi", "gwr", "gbr", "gwe", "gbe")}
    tol = {"wn_fwd": smoke.WN_FWD_REL_TOL, "wn_bwd": smoke.WN_BWD_REL_TOL}
    ok = True
    for what, b, t, h in SHAPES:
        # phase 6's inputs (chip_smoke.wn_phase)
        eff = smoke.random_wn(wn_init, wn_fused, weight_norm_weight, h, C, LAYERS, seed=b + h)
        gen = torch.Generator(device="cuda").manual_seed(b)
        x2 = torch.randn(b * t, h, device="cuda", generator=gen)
        g2 = torch.randn(b * t, 2 * h, device="cuda", generator=gen)
        _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t)
        bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
        work = smoke.wn_work(b, t, h, C, LAYERS)
        for name, call, d in (
            ("wn_fwd", lambda: wn_fused.wn_fwd(x2, *eff, t), "fwd"),
            ("wn_bwd", lambda: wn_fused.wn_bwd(*bwd_args), "bwd"),
        ):
            got, again = call(), call()
            outputs[f"{name} {what}"] = got
            want = getattr(wn_fused, f"{name}_plain")(*((x2, *eff, t) if d == "fwd" else bwd_args))
            rel = {n: smoke.rel_err(g, w)[1] for n, g, w in zip(names[name], got, want)}
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            ms = smoke.cuda_ms(call, reps=reps)
            row = {"label": label, "shape": what, "rows": b * t, "n_half": h,
                   "max_rel": max(rel.values()), "rel": rel, "same_bits": same, "ms": ms,
                   "tflops": work[f"{d}_flops"] / ms / 1e9,
                   "by_kernel": breakdown(smoke, wn_fused, f"{name} {what}", call, name, False)}
            ok &= row["max_rel"] <= tol[name] and same
            print(f"{name} " + json.dumps(row), flush=True)
    return ok


def bf16_rows(smoke, wn_fused, wn_init, weight_norm_weight, label, reps, outputs) -> dict:
    """The bf16 one-run calls at pair and infer, held by phase 19's gates."""
    tot = {}
    for what, b, t, h in BF16_SHAPES:
        eff = smoke.random_wn(wn_init, wn_fused, weight_norm_weight, h, C, LAYERS, seed=b + h)
        gen = torch.Generator(device="cuda").manual_seed(b)
        x2 = torch.randn(b * t, h, device="cuda", generator=gen)
        g2 = torch.randn(b * t, 2 * h, device="cuda", generator=gen)
        _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t, True)
        args = {"fwd": (x2, *eff, t),
                "bwd": (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)}
        work = smoke.wn_work(b, t, h, C, LAYERS)
        for d in ("fwd", "bwd"):
            name = f"wn_{d}[bf16]"
            kern = wn_fused.wn_fwd if d == "fwd" else wn_fused.wn_bwd
            gaps = smoke.wn_bf16_gaps(wn_fused, d, args[d])
            outs = gaps.pop("outs")
            outputs[f"{name} {what}"] = outs
            again = kern(*args[d], True)
            torch.cuda.synchronize()
            call = lambda: kern(*args[d], True)  # noqa: E731
            row = {"label": label, "shape": what, "rows": b * t, "n_half": h, **gaps,
                   "same_bits": all(torch.equal(a, r) for a, r in zip(outs, again)),
                   "ms": smoke.cuda_ms(call, reps=reps),
                   "flop_ms": work[f"{d}_flops"] / smoke.BF16_PEAK * 1e3,
                   "bytes_ms": work[f"{d}_bytes"] / smoke.HBM_RATE * 1e3,
                   "gflop": work[f"{d}_flops"] / 1e9}
            row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
            row["tflops"] = row["gflop"] / row["ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["by_kernel"] = breakdown(smoke, wn_fused, f"{name} {what}", call, f"wn_{d}", True)
            smoke.check_wn_bf16(f"{name} {what}", row)
            smoke.check(row["same_bits"], f"{name} {what}: two runs gave different bits")
            print(f"{name} " + json.dumps(row), flush=True)
            t_ = tot.setdefault(name, {"ms": 0.0, "bound_ms": 0.0, "gflop": 0.0})
            for key in t_:
                t_[key] += row[key]
    for name, t_ in tot.items():
        t_["tflops"] = t_["gflop"] / t_["ms"]
        t_["bound_share"] = t_["bound_ms"] / t_["ms"]
        print(f"{name} pair + infer " + json.dumps(t_), flush=True)
    return tot


def breakdown_rows(smoke, wn_fused, wn_init, weight_norm_weight, bf16: bool) -> None:
    """Only the device time and launches by kernel of each call (phase 6's
    or, ``bf16``, phase 19's shapes and inputs), one line each."""
    for what, b, t, h in BF16_SHAPES if bf16 else SHAPES:
        eff = smoke.random_wn(wn_init, wn_fused, weight_norm_weight, h, C, LAYERS, seed=b + h)
        gen = torch.Generator(device="cuda").manual_seed(b)
        x2 = torch.randn(b * t, h, device="cuda", generator=gen)
        g2 = torch.randn(b * t, 2 * h, device="cuda", generator=gen)
        _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t, bf16)
        args = {"fwd": (x2, *eff, t),
                "bwd": (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)}
        for d in ("fwd", "bwd"):
            kern = wn_fused.wn_fwd if d == "fwd" else wn_fused.wn_bwd
            by_kernel = breakdown(smoke, wn_fused, f"wn_{d} {what}",
                                  lambda: kern(*args[d], bf16), f"wn_{d}", bf16)
            print("breakdown " + json.dumps({"shape": what, "direction": d, "bf16": bf16,
                                             "by_kernel": by_kernel}), flush=True)


def bias_gap_rows(wn_fused, label: str) -> None:
    """``--bias-gaps``: one line a case of ``test_wn_bf16_kernels_match_plain``."""
    spec = importlib.util.spec_from_file_location(
        "card_tests", REPO / "tests" / "test_torch_port_kernels.py")
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    card = torch.device("cuda")
    for case in tests.WN_BF16_CASES:
        c, n_layers = case[3], case[4]
        _, _, _, bwd_args = tests._wn_bf16_case(card, *case)
        grads = wn_fused.wn_bwd(*bwd_args, True)
        plain = wn_fused.wn_bwd_plain(*bwd_args, True)
        ordered = tests._plain_with_kernel_gskip(bwd_args)
        saved = wn_fused._mm
        wn_fused._mm = lambda a, w, bf16: (a.bfloat16().double() @ w.bfloat16().double()).float()
        try:
            exact = wn_fused.wn_bwd_plain(*bwd_args, True)
        finally:
            wn_fused._mm = saved
        print("bias_gaps " + json.dumps({
            "label": label, "case": case,
            "plain": tests._top_bias_gaps(grads, plain, c, n_layers),
            "kernel_order": tests._top_bias_gaps(grads, ordered, c, n_layers),
            "control": tests._top_bias_gaps(exact, plain, c, n_layers)}), flush=True)


def bf16_run_rows(smoke, osconv, wn_fused) -> dict:
    """The run-axis bf16 WN forms on the distinct WN calls of one K = 8
    phase-5 step with both bf16 switches (phase 19's state, its checks)."""
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_dataset
    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import MultiRunStylePipeline
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

    scp2, eth = smoke.SCP2, smoke.ETHANOL
    target = (scp2["channels"], scp2["length"], scp2["classes"])
    source = (eth["channels"], eth["length"], eth["classes"])
    pipe = StyleTransferPipeline(*target, *source, PipelineConfig(compute_dtype="bfloat16"),
                                 device="cuda")
    mp = MultiRunStylePipeline(pipe)
    states = smoke.with_wn_ends(mp.init_states(range(RUNS_K)), torch.Generator().manual_seed(19))
    batch = []
    t_ds = make_dataset(smoke.BATCH, *target, seed=11)
    s_ds = make_dataset(smoke.BATCH, *source, seed=13)
    for a, dtype in ((t_ds.x, torch.float32), (t_ds.y, torch.long), (s_ds.x, torch.float32),
                     (s_ds.y, torch.long)):
        v = torch.as_tensor(np.asarray(a)).to("cuda", dtype)
        batch.append(v.expand(RUNS_K, *v.shape).contiguous())
    os.environ.update(smoke.BF16_ENV)
    with smoke.recorded_calls(wn_fused, ["wn_fwd_runs", "wn_bwd_runs"]) as calls:
        mp.phase5_step(states, *batch, 0)
    torch.cuda.synchronize()
    del states, mp, pipe
    torch.cuda.empty_cache()
    rows = smoke.run_axis_rows(osconv, wn_fused, {}, {}, calls, bf16=True)
    tot = {}
    for name in ("wn_fwd_runs", "wn_bwd_runs"):
        t_ = {"calls": len(rows[name])}
        for key in ("ms", "one_run_calls_ms", "plain_ms", "bound_ms", "flops"):
            t_[key] = sum(r[key] for r in rows[name])
        t_["tflops"] = t_["flops"] / t_["ms"] / 1e9
        t_["bound_share"] = t_["bound_ms"] / t_["ms"]
        t_["same_bits_as_one_run"] = all(r["same_bits_as_one_run"] for r in rows[name])
        tot[f"{name}[bf16]"] = t_
        print(f"{name}[bf16] K={RUNS_K} one step's calls " + json.dumps(t_), flush=True)
    return tot


def same_bits(outputs: dict, against: Path) -> dict:
    """This run's saved outputs against another run's (``--save``), output
    set by output set."""
    other = torch.load(against)
    same = {}
    for what, outs in outputs.items():
        if what in other:
            same[what] = all(torch.equal(a, b.to(a.device)) for a, b in zip(outs, other[what]))
            print(f"same bits as {against.name}: {what} {same[what]}", flush=True)
    return same


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=REPO, help="the tree whose port is timed")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--label", default=None)
    parser.add_argument("--bf16", action="store_true", help="the bf16 instances")
    parser.add_argument("--save", type=Path, default=None, help="write the kernels' outputs")
    parser.add_argument("--against", type=Path, default=None,
                        help="compare the kernels' outputs with a --save of another run")
    parser.add_argument("--changed", action="append", default=[],
                        help="output sets whose bits may differ from --against's (name prefix)")
    parser.add_argument("--breakdown", action="store_true",
                        help="only the device time and launches by kernel of each call")
    parser.add_argument("--bias-gaps", action="store_true",
                        help="only the top layer's bias gradients at the gpu test's cases")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smoke = load_chip_smoke()
    tree = args.tree.resolve()
    label = args.label or tree.name
    sys.path.insert(0, str(tree))
    from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
    from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import wn_init
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, osconv, wn_fused

    if not Path(wn_fused.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {wn_fused.__file__}, not the port in {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; tree: {label}", flush=True)
    lib = _build.build("wn_fused")
    for line in (lib.parent / (lib.name + ".ptxas.txt")).read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    outputs = {}
    summary = {}
    if args.bias_gaps:
        bias_gap_rows(wn_fused, label)
        ok = True
    elif args.breakdown:
        breakdown_rows(smoke, wn_fused, wn_init, weight_norm_weight, args.bf16)
        ok = True  # a launch count off global_kernels raises
    elif args.bf16:
        summary["one_run"] = bf16_rows(smoke, wn_fused, wn_init, weight_norm_weight, label,
                                       args.reps, outputs)
        summary["runs"] = bf16_run_rows(smoke, osconv, wn_fused)
        ok = True  # every gate above raises
    else:
        ok = f32_rows(smoke, wn_fused, wn_init, weight_norm_weight, label, args.reps, outputs)
    if args.save:
        args.save.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: [t.cpu() for t in v] for k, v in outputs.items()}, args.save)
    if args.against:
        summary["same_bits"] = same_bits(outputs, args.against)
        ok &= all(v for k, v in summary["same_bits"].items()
                  if not any(k.startswith(name) for name in args.changed))
    print(json.dumps({"ok": ok, "label": label, "bf16": args.bf16, "card": smi, **summary}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
