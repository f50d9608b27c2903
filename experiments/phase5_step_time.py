"""Time the PyTorch port's full-width phase-5 step on one CUDA card.

Builds ``StyleTransferPipeline`` at the reference main.py pair's shapes
(SelfRegulationSCP2 7 x 1152, 2 classes <- EthanolLevel 1 x 1751, 4
classes; ``PipelineConfig(budget_multiplier=1.0)``) with random weights from
a seed, takes one batch of 20 target and 20 source synthetic series, and
runs ``phase5_step`` on one state: 2 warm-up steps, then ``--steps`` steps
timed by the host clock between ``torch.cuda.synchronize()`` calls, then
``chip_smoke.profile_step`` (of the tree this script sits in): one step
under ``torch.profiler`` for its device time by kernel and group and its
idle share, the WN kernels' launches checked complete, and one step
untraced.  TF32 is off, as in chip_smoke.py.  The route is the
environment's (``FLSTTSC_WN_FUSED``).  ``--bf16`` turns both bf16 switches
on: ``FLSTTSC_WN_MXU=bf16`` and ``PipelineConfig(compute_dtype="bfloat16")``
(chip_smoke.py phase 19 profiles its one-run step so, in a process of its
own).  ``--knob`` takes one or more of ``merged`` (the default config),
``unmerged`` (``merged_pullbacks=False``), ``stacked``
(``stacked_pullbacks=True``) and ``fused_opt`` (``fused_optimizers=True``),
comma-separated, each timed in turn on a state of its own (chip_smoke.py
phase 20 times all four so, in a process of its own); each also records
the step's peak device memory (``max_memory_allocated`` over one step after
``reset_peak_memory_stats``, the state and batch included).  The step runs
with ``CUBLAS_WORKSPACE_CONFIG`` as the process started: importing
chip_smoke.py sets it, and the script unsets it again where it was unset.

It imports only torch, numpy, and the port and ``chip_smoke.py`` of the tree
it sits in, so a copy placed in another checkout's ``experiments/`` times
that checkout: run the parent's and the change's copies in one call,
alternating, to compare them.

Usage: python experiments/phase5_step_time.py [--steps 10] [--label name]
       [--deterministic] [--bf16] [--knob merged,unmerged,stacked,fused_opt]
Prints the profile's log lines, then one JSON line (the last): one knob's
record, or with several ``{"card": ..., "by_knob": {knob: record}}``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BATCH = 20
ANCHORS = (100, 37)  # pinned CPC anchors, as chip_smoke.py's phase-5 checks
TARGET = (7, 1152, 2)  # channels, length, classes
SOURCE = (1, 1751, 4)


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    started_with = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    spec.loader.exec_module(smoke)
    if started_with is None:  # chip_smoke.py sets it when imported: time as this process started
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--label", default=str(REPO.name))
    ap.add_argument("--deterministic", action="store_true",
                    help="time under torch.use_deterministic_algorithms, as chip_smoke.py's drives")
    ap.add_argument("--bf16", action="store_true", help="both bf16 switches on")
    ap.add_argument("--knob", default="merged",
                    help=f"comma-separated, of {', '.join(smoke.KNOBS)}: each timed in turn")
    args = ap.parse_args()
    knobs = args.knob.split(",")
    unknown = [k for k in knobs if k not in smoke.KNOBS]
    if unknown:
        ap.error(f"unknown --knob {unknown}; choose from {list(smoke.KNOBS)}")
    if not torch.cuda.is_available():
        print("phase5_step_time: needs a CUDA card", file=sys.stderr)
        return 2
    if args.bf16:
        os.environ["FLSTTSC_WN_MXU"] = "bf16"
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import predict
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays, write_ts_file
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (c, t, n), seed in (("SynSCP2", TARGET, 11), ("SynEthanol", SOURCE, 13)):
            x, y = make_arrays(2 * BATCH, c, t, n, seed=seed)
            write_ts_file(f"{tmp}/{name}/{name}_TRAIN.ts", x, y, problem=name)
            write_ts_file(f"{tmp}/{name}/{name}_TEST.ts", x, y, problem=name)
        tt, _, ss, _ = predict.build_datasets(tmp, "SynSCP2", tmp, "SynEthanol")
    batch = (torch.as_tensor(tt.x[:BATCH]).cuda(), torch.as_tensor(tt.y[:BATCH]).long().cuda(),
             torch.as_tensor(ss.x[:BATCH]).cuda(), torch.as_tensor(ss.y[:BATCH]).long().cuda())
    cfg = PipelineConfig(budget_multiplier=1.0, compute_dtype="bfloat16" if args.bf16 else "float32")
    models = StyleTransferPipeline(*TARGET, *SOURCE, cfg, device="cuda").init_models(
        torch.Generator().manual_seed(21))
    by_knob = {}
    for knob in knobs:
        t_knob = time.perf_counter()
        knob_cfg = dataclasses.replace(cfg, **smoke.KNOBS[knob])
        pipe = StyleTransferPipeline(*TARGET, *SOURCE, knob_cfg, device="cuda")
        # init_state(Generator(21)): the seed's models, shared by the knobs, in a training state
        state = pipe.training_state(copy.deepcopy(models), 22)

        def step() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.phase5_step(state, *batch, 0, cpc_anchors=ANCHORS)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        step()
        torch.cuda.reset_peak_memory_stats()
        step()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        step_ms = [step() for _ in range(args.steps)]
        profiled = smoke.profile_step(pipe, state, batch)
        by_knob[knob] = {
            "label": args.label, "knob": knob, "deterministic": args.deterministic,
            "bf16": args.bf16, "card": torch.cuda.get_device_name(0), "step_ms": step_ms,
            "median_ms": statistics.median(step_ms), "min_ms": min(step_ms),
            "traced_ms": profiled["traced_wall_ms"], "device_ms": profiled["device_ms"],
            "device_idle_share": profiled["device_idle_share"], "peak_mib": peak_mib,
            "profile": profiled,
        }
        del pipe, state
        torch.cuda.empty_cache()
        print(f"knob {knob}: timed and profiled in {time.perf_counter() - t_knob:.1f} s", flush=True)
    out = by_knob[knobs[0]] if len(knobs) == 1 else {
        "card": torch.cuda.get_device_name(0), "by_knob": by_knob}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
