"""Archive sweep: OS-CNN classifier across every dataset in a UCR/UEA root.

Counterpart of the JAX package's ``cli/archive_sweep.py``, with the same
flags plus ``--device`` (default ``cuda``; it refuses to run when CUDA is
absent, unless ``--device cpu`` asks for the plain PyTorch path).  On CUDA
it turns TF32 off for cuDNN and matmuls: the JAX package trains in exact
float32.  It runs the supervised OS-CNN (``train/classifier.py``, with CPC
under ``--with-cpc``) on every ``<root>/<name>/<name>_{TRAIN,TEST}.ts``
pair and writes a results table to ``--out`` after each dataset; a dataset
that raises gets an ``error`` entry and the sweep goes on.

``--bucket`` pads shapes into (C, receptive-field, T, n_class) buckets
(``train/bucketed.py``): one ``BucketedOSCNNClassifier`` trains every
dataset of its bucket, with exact semantics (masked BN/pool/logits,
padded == unpadded).  Each run pays the bucket's padded length; PyTorch
compiles no program per shape, so this mode is the JAX package's semantics,
not a saving.  CPC is unavailable in bucketed mode (its horizon sizes the
parameters).

Usage:
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.archive_sweep \
      --root Univariate_ts --epochs 100 --out sweep_results.json [--bucket]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..config import PipelineConfig
from ..data.dataset import TestData, TrainData
from ..ops import resolve_device
from ..train.bucketed import BucketedOSCNNClassifier, bucket_key
from ..train.classifier import OSCNNClassifier


def discover(root: str):
    for name in sorted(os.listdir(root)):
        train = os.path.join(root, name, f"{name}_TRAIN.ts")
        test = os.path.join(root, name, f"{name}_TEST.ts")
        if os.path.exists(train) and os.path.exists(test):
            yield name


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--out", default="sweep_results.json")
    p.add_argument("--datasets", default=None, help="comma-separated subset")
    p.add_argument("--with-cpc", action="store_true")
    p.add_argument("--bucket", action="store_true",
                   help="one model per shape bucket (train/bucketed.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget-multiplier", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    if args.bucket and args.with_cpc:
        p.error("--bucket does not support --with-cpc (see module docstring)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    names = args.datasets.split(",") if args.datasets else list(discover(args.root))
    results = {}
    bucket_cache = {}
    for name in names:
        t0 = time.perf_counter()
        try:
            d = {}
            train = TrainData(args.root, f"{name}/{name}_TRAIN.ts", d)
            test = TestData(args.root, f"{name}/{name}_TEST.ts", d)
            cfg = PipelineConfig(seed=args.seed, budget_multiplier=args.budget_multiplier)
            if args.bucket:
                key = bucket_key(train.in_channel, train.time_length,
                                 train.num_class, cfg.max_kernel_size)
                if key not in bucket_cache:
                    bucket_cache[key] = BucketedOSCNNClassifier(*key, config=cfg, device=device)
                clf = bucket_cache[key]
                state, _ = clf.fit(train, None, epochs=args.epochs, verbose=False)
                test_acc = clf.evaluate(state, test.x, test.y, train.num_class)
                train_acc = clf.evaluate(state, train.x, train.y, train.num_class)
            else:
                clf = OSCNNClassifier(
                    train.in_channel, train.time_length, train.num_class,
                    config=cfg, with_cpc=args.with_cpc, device=device,
                )
                state, _ = clf.fit(train, None, epochs=args.epochs, verbose=False)
                test_acc = clf.evaluate(state, test.x, test.y)
                train_acc = clf.evaluate(state, train.x, train.y)
            results[name] = {
                "test_acc": test_acc,
                "train_acc": train_acc,
                "n_train": train.len,
                "C": train.in_channel,
                "T": train.time_length,
                "classes": train.num_class,
                "wall_s": round(time.perf_counter() - t0, 1),
            }
            if args.bucket:
                results[name]["bucket"] = list(key)
        except Exception as e:  # keep sweeping past broken datasets
            results[name] = {"error": f"{type(e).__name__}: {e}"}
        print(name, results[name])
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    ok = [r for r in results.values() if "test_acc" in r]
    if ok:
        mean_acc = sum(r["test_acc"] for r in ok) / len(ok)
        print(f"\n{len(ok)} datasets, mean test acc {mean_acc:.4f}")
    return results


if __name__ == "__main__":
    main()
