"""Faults planted in the program underneath a run, to show the checks catch them.

Each is a context manager that patches functions or methods of the program for its
duration: a training step that returns its state unchanged (the losses computed, no
update); half of each batch left out, the means taken over the rest; the WN backward's
weight gradients halved, and the WN forward's output and skip sum lost (written as zeros),
in the kernels' entries and in their plain versions alike; an answer altered where it is produced (a served
logit moved by half the largest magnitude).  The benchmark's runs plant none;
``perfbench/tests`` and ``perfbench/control.py --mode fault`` do.
"""

from __future__ import annotations

import contextlib

import torch

from harness import port

#: (program module, attribute path) of what each fault patches
TRAIN = ("train.multirun", "MultiRunStylePipeline.phase5_step")
SINGLE = ("train.pipeline", "TargetPredictor.predict_logits")
ENSEMBLE = ("parallel.multi_source", "MultiSourceEnsemble.member_logits")
WN_BWD = [("ops.wn_fused", name) for name in ("wn_bwd_runs", "wn_bwd", "wn_bwd_plain")]
WN_FWD = [("ops.wn_fused", name) for name in ("wn_fwd_runs", "wn_fwd", "wn_fwd_plain")]


def unchanged(orig):
    def step(self, states, bt, lt, bs, ls, epoch, cpc_anchors=None, dropout_masks=None):
        losses = self.phase5_grads(states, bt, lt, bs, ls, epoch, cpc_anchors, dropout_masks)[0]
        return {k: v.detach() for k, v in losses.items()}
    return step


def half_step(orig):
    def step(self, states, bt, lt, bs, ls, epoch, *a, **k):
        h = bt.shape[1] // 2
        return orig(self, states, bt[:, :h], lt[:, :h], bs[:, :h], ls[:, :h], epoch, *a, **k)
    return step


def wn_weight_grads_halved(orig):
    """The WN backward's gradients of its start, conditioning, dilated and res/skip
    weights and biases halved (its outputs 1-8); the input's and the end projection's kept."""
    def call(*args, **kwargs):
        out = orig(*args, **kwargs)
        return (out[0], *(0.5 * g for g in out[1:9]), *out[9:])
    return call


def wn_output_lost(orig):
    """The WN forward's output and its saved skip sum lost: zeros in their place."""
    def call(*args, **kwargs):
        y, aud, skip = orig(*args, **kwargs)
        return torch.zeros_like(y), aud, torch.zeros_like(skip)
    return call


def half_rows(orig):
    def call(self, *args):
        x = torch.as_tensor(args[-1], dtype=torch.float32)
        h = x.shape[-3] // 2
        out = orig(self, *args[:-1], x[..., :h, :, :])
        reps = -(-x.shape[-3] // h)
        return torch.cat([out] * reps, dim=-2)[..., : x.shape[-3], :]
    return call


def altered(orig):
    def call(self, *args):
        out = orig(self, *args).clone()
        out[..., 0, 0] += 0.5 * out.abs().max()
        return out
    return call


#: the faults each loop's cell can have: (targets, wrapper)
FAULTS = {"train_multirun": {"unchanged": ([TRAIN], unchanged),
                             "half_batch": ([TRAIN], half_step),
                             "wn_bwd_halved": (WN_BWD, wn_weight_grads_halved),
                             "wn_fwd_lost": (WN_FWD, wn_output_lost)},
          "serve_single": {"half_batch": ([SINGLE], half_rows), "altered": ([SINGLE], altered)},
          "serve_ensemble": {"half_batch": ([ENSEMBLE], half_rows),
                             "altered": ([ENSEMBLE], altered)}}


@contextlib.contextmanager
def planted(loop: str, fault: str):
    targets, wrap = FAULTS[loop][fault]
    undo = []
    try:
        for module, path in targets:
            *owners, name = path.split(".")
            owner = port.module(module)
            for o in owners:
                owner = getattr(owner, o)
            orig = getattr(owner, name)
            setattr(owner, name, wrap(orig))
            undo.append((owner, name, orig))
        yield
    finally:
        for owner, name, orig in reversed(undo):
            setattr(owner, name, orig)
