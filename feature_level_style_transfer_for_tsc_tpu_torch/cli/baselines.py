"""CoDATS / SLARDA baseline runs (the reference's Comparison/ entry points).

Counterpart of the JAX package's ``cli/baselines.py``, with the same flags
plus ``--device`` (default ``cuda``; it refuses to run when CUDA is absent,
unless ``--device cpu`` asks for the plain PyTorch path).  On CUDA it turns
TF32 off for cuDNN and matmuls: the JAX package trains in exact float32.
Batch 30 as the Comparison/ code; ``--epochs 0`` means the reference's 600
(CoDATS) or 450 target epochs (SLARDA), whose source pretrain is fixed at the
reference's 70 epochs.  It writes ``<out>/<baseline>_history.json``.

Usage:
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.baselines codats \
      --target-root Univariate_ts --target Haptics \
      --source-root Univariate_ts --sources InlineSkate,Worms,SemgHandMovementCh2
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.baselines slarda \
      --target-root Multivariate_ts --target SelfRegulationSCP2 \
      --source-root Multivariate_ts --sources MotorImagery
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..baselines import CoDATSPipeline, SLARDAPipeline
from ..config import PipelineConfig
from ..data.dataset import TestData, TrainData
from ..ops import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("baseline", choices=["codats", "slarda"])
    p.add_argument("--target-root", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--source-root", required=True)
    p.add_argument("--sources", required=True)
    p.add_argument("--epochs", type=int, default=0, help="0 = reference default")
    p.add_argument("--out", default="baseline_log")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    target_dict = {}
    t_train = TrainData(args.target_root, f"{args.target}/{args.target}_TRAIN.ts", target_dict)
    t_test = TestData(args.target_root, f"{args.target}/{args.target}_TEST.ts", target_dict)
    source_trains = [TrainData(args.source_root, f"{s}/{s}_TRAIN.ts", {})
                     for s in args.sources.split(",")]

    cfg = PipelineConfig(seed=args.seed, batch_size=30)  # Comparison uses bs=30
    os.makedirs(args.out, exist_ok=True)
    t_shape = (t_train.in_channel, t_train.time_length, t_train.num_class)

    if args.baseline == "codats":
        pipe = CoDATSPipeline(
            t_shape, [(s.in_channel, s.time_length, s.num_class) for s in source_trains],
            config=cfg, device=device,
        )
        state, history = pipe.fit(t_train, t_test, source_trains, epochs=args.epochs or 600)
    else:
        if len(source_trains) != 1:
            p.error("slarda takes exactly one source")
        s = source_trains[0]
        pipe = SLARDAPipeline(t_shape, (s.in_channel, s.time_length, s.num_class),
                              config=cfg, device=device)
        state, history = pipe.fit(t_train, t_test, s, source_epochs=70,
                                  target_epochs=args.epochs or 450)
    with open(os.path.join(args.out, f"{args.baseline}_history.json"), "w") as f:
        json.dump(history, f)
    print("final:", history[-1])
    return state, history


if __name__ == "__main__":
    main()
