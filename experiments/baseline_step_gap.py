#!/usr/bin/env python3
"""Hold one step of each baseline with the port's OS conv kernel against the
same step with its plain version, on the card, at ``chip_smoke.py`` phase
16's shapes, and print the gaps unchecked.

Run from the repository root on a CUDA card:

    python3 experiments/baseline_step_gap.py [--tree DIR] [--label NAME]
                                             [--codats-sources-train-mode]

Imports the port of ``DIR`` (default: this tree) and ``chip_smoke.py`` of
this tree (``baseline_step_rows``: CoDATS's step, SLARDA's source step with
a pinned CPC anchor and its target step, each from a fresh seeded state on
each domain's first batch of 30), with TF32 off for cuDNN and matmuls as
``cli.baselines`` sets it.  For each step it prints the kernel's launches,
each loss's relative error and each module's gradient gap (relative L2
distance), then a last line {"ok": ..., "label": ..., "card": ...,
"max_grad_l2_rel": ...}, where ``ok`` is ``chip_smoke.py``'s verdict on
the rows (``BASELINE_GRAD_L2_TOL``).

``--codats-sources-train-mode`` runs CoDATS's shared trunk in training
mode (batch statistics, the new running statistics dropped) for the source
batches too, where the pipeline runs it in eval mode: it tests whether eval
mode's running statistics make CoDATS's gap the largest.

A control of the gate: copy the tree to a scratch directory, make
``split_tf32`` in ``ops/csrc/mma_tf32.cuh`` of the copy return a zero low
part (``const float rest = 0.0f;``), so that every product of the OS conv
is one TF32 product, and run with ``--tree`` on the copy; ``ok`` must then
be false.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def load_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module, by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=REPO, help="the tree whose port is run")
    parser.add_argument("--label", default=None)
    parser.add_argument("--codats-sources-train-mode", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smoke = load_chip_smoke()
    tree = args.tree.resolve()
    label = args.label or tree.name
    sys.path.insert(0, str(tree))
    from feature_level_style_transfer_for_tsc_tpu_torch import baselines
    from feature_level_style_transfer_for_tsc_tpu_torch.baselines import codats
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused

    if not Path(osconv.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {osconv.__file__}, not the port in {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.codats_sources_train_mode:
        trunk = codats.os_cnn_res_apply
        codats.os_cnn_res_apply = lambda p, s, m, x, training: trunk(p, s, m, x, True)
    rows = smoke.baseline_step_rows(smoke.baseline_pipes(baselines, PipelineConfig),
                                    smoke.baseline_batches(make_arrays), osconv, wn_fused, gate)
    for what, row in rows.items():
        print(json.dumps({"label": label, "step": what,
                          "codats_sources_train_mode": args.codats_sources_train_mode, **row}),
              flush=True)
    try:
        for what, row in rows.items():
            smoke.check_baseline_step(what, row)
        ok = True
    except AssertionError as e:
        print(f"refused: {e}", flush=True)
        ok = False
    worst = max(v for row in rows.values() for v in row["grad_l2_rel"].values())
    print(json.dumps({"ok": ok, "label": label, "card": smi, "max_grad_l2_rel": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
