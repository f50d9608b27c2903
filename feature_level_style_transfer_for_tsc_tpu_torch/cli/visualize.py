"""Render prediction correctness strips from saved .npy predictions.

Counterpart of the JAX package's ``cli/visualize.py`` (the active part of
the reference's ``visualization.py:443-521``: per-sample correct/incorrect
PNG strips), with the same flags.  Numpy only: it runs no model, so it has
no ``--device``.

Usage:
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.visualize \
      --predictions multi_log/final_predict.npy \
      --labels multi_log/true_label.npy --out strips.png
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.artifacts import save_prediction_strip


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictions", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--out", default="prediction_strip.png")
    p.add_argument("--cell", type=int, default=10)
    p.add_argument("--per-row", type=int, default=40)
    args = p.parse_args(argv)

    pred = np.load(args.predictions)
    labels = np.load(args.labels)
    save_prediction_strip(args.out, pred, labels, cell=args.cell, per_row=args.per_row)
    acc = float(np.mean(pred == labels))
    print(f"accuracy_for_test: {acc}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
