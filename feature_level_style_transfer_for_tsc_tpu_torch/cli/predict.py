"""Inference-only entry point: load trained checkpoint(s) and classify.

Counterpart of the JAX package's ``cli/predict.py``, with the same flags
plus ``--device`` (default ``cuda``; it refuses to run when CUDA is absent,
unless ``--device cpu`` asks for the plain PyTorch path):

* ONE checkpoint: restore the target model (params + BatchNorm running
  statistics) of a full pipeline state, run the no-grad inference path on
  the requested target split, save predictions, print accuracy;
* SEVERAL checkpoints (comma-separated): ensemble serving — the members are
  stacked and run one after another on the card, then combined with the
  selected reference vote rule (``multi_source_voting.py:405-429`` and its
  two in-tree variants).  Full pipeline states and extracted members are
  auto-detected from their npz key paths, as in the JAX package.

Checkpoints written by either package are read (``io/checkpoint.py``).

Usage:
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.predict \
      --target-root Multivariate_ts --target SelfRegulationSCP2 \
      --source-root Univariate_ts --source EthanolLevel \
      --checkpoint train_log/final_state.npz --out predictions --device cuda
  # ensemble over 3 members, entropy+precision vote:
  ... --checkpoint m1.npz,m2.npz,m3.npz --vote entropy_precision
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.dataset import TestData, TrainData
from ..evaluation.voting import entropy_only_vote, entropy_precision_vote, predicted_label_vote
from ..io.checkpoint import restore_checkpoint
from ..ops import resolve_device
from ..parallel.multi_source import MultiSourceEnsemble
from ..train.classifier import OSCNNClassifier
from ..train.pipeline import TARGET_PREFIXES, TargetPredictor


def build_datasets(target_root, target, source_root, source):
    """The four splits, as the JAX package's ``cli/main.py`` loads them."""
    target_dict, source_dict = {}, {}
    t_train = TrainData(target_root, f"{target}/{target}_TRAIN.ts", target_dict)
    t_test = TestData(target_root, f"{target}/{target}_TEST.ts", target_dict)
    s_train = TrainData(source_root, f"{source}/{source}_TRAIN.ts", source_dict)
    s_test = TestData(source_root, f"{source}/{source}_TEST.ts", source_dict)
    return t_train, t_test, s_train, s_test


def _npz(path):
    return path if path.endswith(".npz") else path + ".npz"


def _is_member_layout(path):
    """True when the checkpoint is a ``cli.multi_source`` member (keys under
    ``['params']['ext']…``) rather than a full ``cli.main`` pipeline state
    (``['params']['t_ext']…``)."""
    with np.load(_npz(path)) as z:
        return any("['params']['ext']" in k for k in z.files)


def _load_member(path, device):
    """Restore one ensemble member, auto-detecting the checkpoint layout.

    For a full pipeline state the target-side (extractor, classifier) member
    is extracted as the reference's per-checkpoint model rebuild does
    (multi_source_voting.py:240-279).
    """
    if _is_member_layout(path):
        return restore_checkpoint(path, ("['params']", "['mstate']"), device)
    full = restore_checkpoint(path, TARGET_PREFIXES, device)
    return {
        "params": {"ext": full["params"]["t_ext"], "cls": full["params"]["t_cls"]},
        "mstate": {"ext": full["mstate"]["t_ext"], "cls": full["mstate"]["t_cls"]},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target-root", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--source-root", required=True,
                   help="the source the checkpoint was trained with (shapes)")
    p.add_argument("--source", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="full-state .npz written by cli.main (final_state.npz); "
                   "comma-separate several for ensemble serving "
                   "(cli.main states and cli.multi_source members both accepted)")
    p.add_argument("--split", choices=("test", "train"), default="test")
    p.add_argument("--out", default="predictions",
                   help="prefix: writes <out>_predict.npy "
                   "(reference final_predict.npy analogue)")
    p.add_argument("--vote", default="entropy_precision",
                   choices=("entropy_precision", "entropy_only", "predicted_label"),
                   help="ensemble vote rule (multi-checkpoint only)")
    p.add_argument("--budget-multiplier", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    t_train, t_test, _, _ = build_datasets(
        args.target_root, args.target, args.source_root, args.source
    )
    cfg = PipelineConfig(seed=args.seed, budget_multiplier=args.budget_multiplier)
    shape = (t_train.in_channel, t_train.time_length, t_train.num_class)

    ds = t_test if args.split == "test" else t_train
    paths = [s.strip() for s in args.checkpoint.split(",") if s.strip()]
    if not paths:
        p.error("--checkpoint is empty after splitting on ','")

    member_accs = None
    if len(paths) == 1 and not _is_member_layout(paths[0]):
        predictor = TargetPredictor(*shape, config=cfg, device=device)
        state = restore_checkpoint(paths[0], TARGET_PREFIXES, device)
        preds = predictor.predict_target(state, ds.x)
    elif len(paths) == 1:
        # A single cli.multi_source member: classify with plain argmax (the
        # reference's single-model path, utils.py:27-52 — voting needs >=2
        # models).
        model_def = OSCNNClassifier(*shape, config=cfg, device=device)
        member = _load_member(paths[0], device)
        logits = model_def.predict_logits(member["params"], member["mstate"], ds.x)
        preds = torch.argmax(logits, -1).cpu().numpy()
    else:
        ens = MultiSourceEnsemble(*shape, config=cfg, device=device)
        stacked = ens.stack([_load_member(pp, device) for pp in paths])
        # Precision weights always come from the target TRAIN split
        # (reference :281-367), regardless of which split is scored.
        weights = ens.compute_class_weights(stacked, t_train.x, t_train.y)
        logits = ens.member_logits(stacked, ds.x)
        if args.vote == "entropy_precision":
            preds = entropy_precision_vote(logits, weights, ens.voting)
        elif args.vote == "entropy_only":
            preds = entropy_only_vote(logits)
        else:
            preds = predicted_label_vote(logits, weights)
        preds = preds.cpu().numpy()
        member_accs = [
            float(np.mean(torch.argmax(l, -1).cpu().numpy() == ds.y)) for l in logits
        ]

    out_path = f"{args.out}_predict.npy"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.save(out_path, preds)
    acc = float(np.mean(preds == ds.y))
    extra = (
        f" vote={args.vote} members={[round(a, 4) for a in member_accs]}"
        if member_accs is not None else ""
    )
    print(f"n={len(preds)} split={args.split} accuracy={acc:.4f}{extra} -> {out_path}")
    return acc


if __name__ == "__main__":
    main()
