"""The rank side of tests/test_torch_port_dp_knobs.py: no JAX here.

``rank_main`` runs in each of the test's spawned gloo processes.  It takes
the cases as numpy arrays (the JAX package's models flattened by their tree
paths, and the batches) and, on its own shard of each batch on the CPU,
runs: the collectives under ``torch.func.vmap`` (forward, and a batched
pull through them); one data-parallel phase-5 step (``dp.phase5_epoch``
of one batch) under each configuration of ``CONFIGS``, and one epoch each
of phases 2, 3 (supervised) and 4 (both branches) through
``dp.phase2_epoch`` / ``phase3_epoch`` / ``phase4_epoch``.  It returns
what each step recorded (the global losses, gradients, trunk norms, new
GradNorm weights and the state after it) and each epoch's global metrics
and state.
"""

from __future__ import annotations

import contextlib
import os

import torch
from _torch_port_dp_ranks import (
    P,
    pipe_state,
    pipeline,
    recording,
    recording_phase5,
)

from feature_level_style_transfer_for_tsc_tpu_torch.ops.collectives import (
    all_gather_rows,
    all_reduce_sum,
)
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import dp, launch
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import mesh as port_mesh
from feature_level_style_transfer_for_tsc_tpu_torch.train import jax_state
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import batched_pull

#: the configurations phase 5 runs data-parallel under: (PipelineConfig knobs, environment)
CONFIGS = {
    "unmerged": ({"merged_pullbacks": False}, {}),
    "stacked": ({"stacked_pullbacks": True}, {}),
    "fused_optimizers": ({"fused_optimizers": True}, {}),
    "compute_dtype": ({"compute_dtype": "bfloat16"}, {}),
    "wn_mxu": ({}, {"FLSTTSC_WN_MXU": "bf16"}),
    "op_by_op": ({}, {"FLSTTSC_WN_FUSED": "0", "FLSTTSC_CONV_IMPL": "pallas"}),
}
#: the configurations at the bf16 noise floor
BF16_CONFIGS = ("compute_dtype", "wn_mxu")


@contextlib.contextmanager
def environ(values):
    """``os.environ`` with ``values`` set inside, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def rank_tensor(rank):
    """This rank's (3, 2, 4) operand of ``collectives_case``."""
    return torch.arange(24.0).reshape(3, 2, 4) / 7 + rank


def collectives_case(m, rank):
    """``all_reduce_sum`` and ``all_gather_rows`` (along a dim and the last)
    under ``torch.func.vmap`` over the leading axis, and a batched pull of 3
    cotangents through both against the 3 single pulls."""
    group, _, _ = port_mesh.axis_group(m, "data")
    x = rank_tensor(rank).requires_grad_()
    out = {"sum": torch.func.vmap(lambda t: all_reduce_sum(t, group))(x),
           "rows": torch.func.vmap(lambda t: all_gather_rows(t, group, 0))(x),
           "last": torch.func.vmap(lambda t: all_gather_rows(t, group, -1))(x)}
    y = torch.sin(all_reduce_sum(x * x, group) + all_gather_rows(x, group, 1).sum(1, keepdim=True))
    cots = torch.randn(3, *y.shape, generator=torch.Generator().manual_seed(rank))
    out["pull"] = batched_pull([y], [x], [cots])[0]
    out["single"] = torch.stack([torch.autograd.grad(y, x, c, retain_graph=True)[0] for c in cots])
    return {k: v.detach().numpy() for k, v in out.items()}


def config_pipeline(c, name):
    knobs, _ = CONFIGS[name]
    return pipeline(c, **knobs)


def phase5_case(m, c, name):
    """One pinned data-parallel phase-5 step (an epoch of the first batch)
    under configuration ``name``, recorded."""
    pipe = config_pipeline(c["pipe"], name)
    state = dp.replicate(m, pipe_state(pipe, c["pipe"]))
    steps = recording_phase5(pipe)
    (xt, yt), (xs, ys) = (dp.shard_epoch_batches(m, c[x][:1], c[y][:1])
                          for x, y in (("xt", "yt"), ("xs", "ys")))
    masks = [[torch.from_numpy(port_mesh.place(m, k, port_mesh.data_sharding(m))) for k in pair]
             for pair in c["masks"]]
    with environ(CONFIGS[name][1]):
        metrics = dp.phase5_epoch(m, pipe, state, xt, yt, xs, ys, 0, cpc_anchors=c["anchors"],
                                  dropout_masks=masks)
    return {"step": steps[0], "metrics": {k: v.detach().numpy().copy() for k, v in metrics.items()}}


def epoch_case(m, c, phase, supervised=None):
    """One data-parallel epoch of phase 2, 3 or 4 of the default config over
    the first batch, each optimizer step's gradients recorded."""
    pipe = pipeline(c["pipe"])
    state = dp.replicate(m, pipe_state(pipe, c["pipe"]))
    steps = recording(pipe)
    (xt, yt), (xs, ys) = (dp.shard_epoch_batches(m, c[x][:1], c[y][:1])
                          for x, y in (("xt", "yt"), ("xs", "ys")))
    if phase == 2:
        metrics = dp.phase2_epoch(m, pipe, state, xs, ys)
    elif phase == 3:
        metrics = dp.phase3_epoch(m, pipe, state, xt, yt, xs, ys, supervised, c["anchors"])
    else:
        metrics = dp.phase4_epoch(m, pipe, state, xt, yt, xs, ys, supervised, c["anchors"])
    return {"steps": steps, "metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.copy() for k, v in jax_state.state_to_flat(state).items()}}


def rank_main(rank, world_size, init_method, cases):
    """Every case on this rank's shards."""
    torch.set_num_threads(1)
    with launch.process_group(rank, world_size, init_method, "gloo", timeout=120):
        m = port_mesh.make_mesh(data=P, device="cpu")
        out = {"collectives": collectives_case(m, rank)}
        out.update({f"phase5_{name}": phase5_case(m, cases, name) for name in CONFIGS})
        out["phase2"] = epoch_case(m, cases, 2)
        out["phase3"] = epoch_case(m, cases, 3, True)
        out["phase4_supervised"] = epoch_case(m, cases, 4, True)
        out["phase4_unsupervised"] = epoch_case(m, cases, 4, False)
    return out
