#!/usr/bin/env python3
"""How far rounding alone moves one padded train step of the FordA bucket,
on the CPU.

Run from the repository root:  python3 experiments/sweep_step_conditioning.py

One ``BucketedOSCNNClassifier.train_batch`` of the (1, 89, 729, 4) bucket
(FordA: T 500 padded to 729, 2 of 4 classes, reference budgets, batch 20)
from a fresh seeded state, on two inputs: white noise (N(0, 1)) and the
port's synthetic series (``data/synthetic.make_arrays``, the generator of
``chip_smoke.py`` phase 17's UCR-shaped archive).  The reference is the
plain OS conv in float32.  Against it, each module's gradients (relative L2
distance) of the same step with the OS conv's forward

* multiplied by (1 + 1e-7 N(0, 1)), rounding-sized noise;
* computed by ``F.conv1d`` (another summation order, exact float32);
* and the whole step in float64.

A step whose gradients move by more than the kernels' gate (1e-3) under
rounding-sized noise cannot tell a kernel fault from rounding; prints one
JSON line per input.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig  # noqa: E402
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays  # noqa: E402
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv  # noqa: E402
from feature_level_style_transfer_for_tsc_tpu_torch.train.bucketed import (  # noqa: E402
    BucketedOSCNNClassifier,
    bucket_key,
)
from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves  # noqa: E402

BATCH = 20


def to_double(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double()
    if isinstance(tree, dict):
        return {k: to_double(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_double(v) for v in tree))
    return [to_double(v) for v in tree]


def step_grads(clf, x, y, conv, dtype=torch.float32) -> dict:
    """Each module's gradients (one float64 vector) of one ``train_batch``
    from the seed-0 model, with ``conv`` as the OS conv's forward; the
    optimizer step is replaced by recording the gradients."""
    models = clf.init_models(torch.Generator().manual_seed(0))
    if dtype == torch.float64:
        models = to_double(models)
    for p in leaves(models["params"]):
        p.requires_grad_(True)
    seen = {}

    def record(state, names, grads):
        for n in names:
            seen[n] = torch.cat([g.flatten().double() for g in grads[n] if g is not None])

    saved = osconv.os_conv
    osconv.os_conv = conv
    clf._apply_updates = record
    try:
        t_valid, cmask = clf.t_valid(500).to(dtype), clf.cmask(2).to(dtype)
        clf.train_batch(models, torch.as_tensor(x).to(dtype), y, t_valid, cmask)
    finally:
        osconv.os_conv = saved
        del clf._apply_updates
    return seen


def main() -> int:
    torch.set_num_threads(min(8, torch.get_num_threads()))
    clf = BucketedOSCNNClassifier(*bucket_key(1, 500, 2), config=PipelineConfig(), device="cpu")
    g = torch.Generator().manual_seed(3)
    noise = (torch.randn(BATCH, 500, 1, generator=g).numpy(),
             torch.randint(0, 2, (BATCH,), generator=g).numpy())
    xa, ya = make_arrays(BATCH, 1, 500, 2, seed=40)
    series = (xa.transpose(0, 2, 1).copy(), np.array([int(v.split("_")[1]) for v in ya]))
    perturb = torch.Generator().manual_seed(7)

    def rounding_noise(x_pad, w):
        out = osconv.os_conv_plain(x_pad, w)
        return out * (1 + 1e-7 * torch.randn(out.shape, generator=perturb, dtype=out.dtype))

    def conv1d(x_pad, w):
        return F.conv1d(x_pad.transpose(1, 2), w.permute(2, 1, 0)).transpose(1, 2)

    for name, (x, y) in (("white noise", noise), ("make_arrays series", series)):
        x = clf._pad_x(x)
        ref = step_grads(clf, x, y, osconv.os_conv_plain)
        row = {"input": name}
        for what, conv, dtype in (("rounding noise 1e-7", rounding_noise, torch.float32),
                                  ("F.conv1d", conv1d, torch.float32),
                                  ("float64", osconv.os_conv_plain, torch.float64)):
            got = step_grads(clf, x, y, conv, dtype)
            row[what] = {n: float((got[n] - ref[n]).norm() / ref[n].norm()) for n in ref}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
