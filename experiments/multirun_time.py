"""Time the port's K-run phase-5 step (``train/multirun.py``) on one CUDA card.

Builds ``StyleTransferPipeline`` at the reference main.py pair's shapes
(SelfRegulationSCP2 7 x 1152, 2 classes <- EthanolLevel 1 x 1751, 4
classes; ``PipelineConfig()``: batch 20, a 3-flow WaveGlow with a
120-channel 8-layer WN, ``cdan_dim`` 1024) with random weights from seeds
0..K-1, one batch of 20 target and 20 source synthetic series a run, and
times ``MultiRunStylePipeline.phase5_step`` (one vmapped forward, the four
merged pulls, GradNorm and the stacked optimizer steps; anchors and dropout
drawn from each run's generator, as in training) at each K of ``--ks``:

* a warm-up step a K, then ``--rounds`` rounds that take one step of each
  K in turn (ascending, then descending, and so on), each step timed by
  the host clock between ``torch.cuda.synchronize()`` calls;
* one more step a K under ``torch.profiler``: its device time (the sum of
  the CUDA kernels' self time, without the ranges of host annotations
  such as the optimizers' steps), the device's idle share of the traced
  step's wall time, and its 12 largest kernels (device ms, launches);
* the peak device memory of the K's warm-up step (``max_memory_allocated``
  after ``reset_peak_memory_stats``), less what was allocated before it but
  the K's own states (the other Ks' states, which stay resident for the
  turns, and the runs' models, made once a seed and shared by the knobs);
* aggregate series/s: 40 K series (20 target, 20 source a run) a step.

TF32 is off, as in chip_smoke.py.  ``--bf16`` turns both bf16 switches on:
``FLSTTSC_WN_MXU=bf16`` (the WN kernels' bf16 instances) and
``PipelineConfig(compute_dtype="bfloat16")`` (the OS convs in bf16).  Run it
without ``CUBLAS_WORKSPACE_CONFIG`` (which adds 0.4-0.5 s a step on an
H100): chip_smoke.py phase 18 starts it with that variable
removed.  Importing chip_smoke.py (for ``device_events``) sets it again, so
the script unsets it after the import where its process started without
it (from PR 15 to PR 16 the K sweeps ran with it).  ``--knob`` takes one or more of ``merged`` (the default config),
``unmerged`` (``merged_pullbacks=False``), ``stacked``
(``stacked_pullbacks=True``) and ``fused_opt`` (``fused_optimizers=True``),
comma-separated: the sweep of each in turn, its states freed before the
next.  ``--routes`` takes one
or both WN routes, comma-separated: ``fused`` (the default) and
``op_by_op`` (``FLSTTSC_WN_FUSED=0``, ``FLSTTSC_CONV_IMPL=pallas``: the
run-axis tap conv ``tap_conv_fwd_runs`` and the gate's runs folded into
one ``gate_fwd`` launch), each swept in turn in this one process
(chip_smoke.py phase 18 runs both, phase 23 reads the second).
It imports only torch, numpy, the port of the tree it sits in and that
tree's chip_smoke.py (its ``device_events``).

Usage: python experiments/multirun_time.py [--ks 1,2,4,8] [--rounds 2] [--bf16]
       [--knob merged,unmerged,stacked,fused_opt] [--routes fused,op_by_op]
Prints the card's name and power limit, then one JSON line (the last): with
one knob and one route ``{"card", "kind", "bf16", "route", "knob", "by_k"}``,
with several knobs ``by_knob`` (knob -> its ``by_k``) in place of ``by_k``,
with several routes ``by_route`` (route -> its ``by_k``).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BATCH = 20
TARGET = (7, 1152, 2)  # channels, length, classes
SOURCE = (1, 1751, 4)


def batches(k: int, make_dataset):
    """One (K, 20, ...) batch of each domain: every run the same series."""
    t, s = make_dataset(BATCH, *TARGET, seed=11), make_dataset(BATCH, *SOURCE, seed=13)
    out = []
    for a, dtype in ((t.x, torch.float32), (t.y, torch.long), (s.x, torch.float32),
                     (s.y, torch.long)):
        t = torch.as_tensor(np.asarray(a)).to("cuda", dtype)
        out.append(t.expand(k, *t.shape).contiguous())
    return out


def sweep(mp, ks, rounds: int, make_dataset, smoke, models: dict) -> dict:
    """The K sweep on ``mp`` (a ``MultiRunStylePipeline``); ``smoke`` is
    this tree's chip_smoke.py; ``models`` holds each seed's
    ``init_models``, shared by the knobs (each run's state is the
    ``init_state`` of its seed: those models in a training state of
    ``mp``'s config)."""
    from torch.profiler import ProfilerActivity, profile

    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import stack_states

    runs = {}
    for k in ks:  # every K's states stay resident, so that the steps can take turns
        before = torch.cuda.memory_allocated()
        states = stack_states([mp.pipe.training_state(copy.deepcopy(models[s]), s + 1)
                               for s in range(k)])
        runs[k] = {"states": states, "batch": batches(k, make_dataset), "step_ms": []}
        runs[k]["resident"] = torch.cuda.memory_allocated() - before

    def step(k) -> float:
        r = runs[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp.phase5_step(r["states"], *r["batch"], 0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for k in ks:  # warm-up, and the peak memory of one K's step and its own states
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() - runs[k]["resident"]
        torch.cuda.reset_peak_memory_stats()
        step(k)
        runs[k]["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    order = list(ks)
    for _ in range(rounds):
        for k in order:
            runs[k]["step_ms"].append(step(k))
        order.reverse()
    out = {}
    for k in ks:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_ms = step(k)
        # device work by kernel, host annotations' ranges (the optimizers' steps) left out
        kernels = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count)
                          for e in smoke.device_events(prof)), key=lambda k: -k[1])
        device_ms = sum(ms for _, ms, _ in kernels)
        med = statistics.median(runs[k]["step_ms"])
        out[str(k)] = {
            "step_ms": runs[k]["step_ms"], "median_ms": med,
            "series_per_s": 2 * BATCH * k / (med / 1e3),
            "traced_ms": traced_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / traced_ms,
            "peak_mib": runs[k]["peak_mib"], "top": kernels[:12],
        }
    return out


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    started_with = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    spec.loader.exec_module(smoke)
    if started_with is None:  # chip_smoke.py sets it when imported: time as this process started
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default="1,2,4,8")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--bf16", action="store_true", help="both bf16 switches on")
    ap.add_argument("--routes", default="fused",
                    help="comma-separated, of fused and op_by_op (FLSTTSC_WN_FUSED=0, "
                         "FLSTTSC_CONV_IMPL=pallas): each swept in turn")
    ap.add_argument("--knob", default="merged",
                    help=f"comma-separated, of {', '.join(smoke.KNOBS)}: each swept in turn")
    args = ap.parse_args()
    knobs, routes = args.knob.split(","), args.routes.split(",")
    unknown = [k for k in knobs if k not in smoke.KNOBS]
    if unknown:
        ap.error(f"unknown --knob {unknown}; choose from {list(smoke.KNOBS)}")
    if set(routes) - {"fused", "op_by_op"} or (len(routes) > 1 and len(knobs) > 1):
        ap.error(f"--routes {routes}: fused and op_by_op, several only with one knob")
    if not torch.cuda.is_available():
        print("multirun_time: needs a CUDA card", file=sys.stderr)
        return 2
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_dataset
    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import MultiRunStylePipeline
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.bf16:
        os.environ["FLSTTSC_WN_MXU"] = "bf16"
    cfg = PipelineConfig(compute_dtype="bfloat16" if args.bf16 else "float32")
    ks = [int(k) for k in args.ks.split(",")]
    pipe = StyleTransferPipeline(*TARGET, *SOURCE, cfg, device="cuda")
    models = {s: pipe.init_models(torch.Generator().manual_seed(s)) for s in range(max(ks))}
    by = {}
    for route in routes:
        for knob in knobs:
            if route == "op_by_op":
                os.environ.update(smoke.OP_BY_OP)
            knob_cfg = dataclasses.replace(cfg, **smoke.KNOBS[knob])
            pipe = StyleTransferPipeline(*TARGET, *SOURCE, knob_cfg, device="cuda")
            t_knob = time.perf_counter()
            by[route, knob] = sweep(MultiRunStylePipeline(pipe), ks, args.rounds, make_dataset,
                                    smoke, models)
            print(f"route {route}, knob {knob}: the sweep in {time.perf_counter() - t_knob:.1f} s",
                  flush=True)
            for name in smoke.OP_BY_OP:
                os.environ.pop(name, None)
            del pipe
            torch.cuda.empty_cache()
    head = {"card": smi, "kind": torch.cuda.get_device_name(0), "bf16": args.bf16}
    if len(routes) > 1:
        out = {**head, "knob": knobs[0], "by_route": {r: by[r, knobs[0]] for r in routes}}
    elif len(knobs) > 1:
        out = {**head, "route": routes[0], "by_knob": {k: by[routes[0], k] for k in knobs}}
    else:
        out = {**head, "route": routes[0], "knob": knobs[0], "by_k": by[routes[0], knobs[0]]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
