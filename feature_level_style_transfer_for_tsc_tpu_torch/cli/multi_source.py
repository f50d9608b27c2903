"""Multi-source training + entropy/precision-weighted ensemble voting.

Counterpart of the JAX package's ``cli/multi_source.py`` (the reference's
sequential per-source ``train()`` runs followed by
``multi_source_voting.py:230-429``), with the same flags plus ``--device``
(default ``cuda``; it refuses to run when CUDA is absent, unless
``--device cpu`` asks for the plain PyTorch path).  On CUDA it turns TF32
off for cuDNN and matmuls: the JAX package trains in exact float32.

* member i trains the five-phase ``StyleTransferPipeline`` for source i with
  seed ``--seed + i``; with ``--capture-epochs`` its target model is a
  snapshot taken at phase-5 epoch ``capture_epochs[i % len]`` (the reference
  votes over mid-curriculum checkpoints, epoch_{10,82,280}.tar at
  multi_source_voting.py:265-279), else the end-of-run model;
* each member is saved as ``member_<source>.npz`` in the JAX key layout
  (``params.ext``, ``params.cls``, ``mstate.ext``, ``mstate.cls``);
* ``--member-checkpoints`` restores members (either package's files) and
  votes without training;
* the members are stacked and run under one ``torch.func.vmap`` (one
  run-axis conv launch a layer); the per-class precision weights come from
  the target train split, and the vote's predictions and the true labels
  are saved as .npy like the reference, with ``prediction_strip.png`` and
  ``ensemble.json``.

Under ``torchrun`` (P ranks, ``parallel.launch.torchrun_group``) member i
is trained by rank ``i % P`` on its own device, the JAX package's
round-robin of members over devices, and each rank writes its members'
files and logs.  After a barrier the ensemble follows ``cli.predict``'s
rule: with P >= M members it is sharded over ``make_mesh(data=1,
domain=M)``, rank r holding member r; with P < M rank 0 runs it
(``mesh=None``), reading the members the other ranks trained from their
files.  ``--member-checkpoints`` takes the same rule.  Only rank 0 writes
the vote's files.

Usage:
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.multi_source \
      --target-root Multivariate_ts --target StandWalkJump \
      --source-root Univariate_ts --sources EthanolLevel,Worms,InlineSkate \
      --out multi_log --device cuda
  # one member a rank:
  python -m torch.distributed.run --standalone --nproc-per-node 3 \
      -m feature_level_style_transfer_for_tsc_tpu_torch.cli.multi_source ... --device cuda
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..data.dataset import TestData, TrainData
from ..io.artifacts import save_prediction_strip
from ..io.checkpoint import flatten, from_jax_params, load_flat, save_checkpoint
from ..parallel.launch import torchrun_group
from ..parallel.multi_pipeline import train_members_parallel
from ..parallel.multi_source import MultiSourceEnsemble, ensemble_mesh, tree_map
from ..train.classifier import OSCNNClassifier
from ..train.pipeline import StyleTransferPipeline
from .main import target_member


def restore_member(path: str, template, device):
    """A member file restored against ``template`` (a member state): the
    same keys and shapes, or it raises, as the JAX package's
    ``restore_checkpoint(path, template)`` does."""
    want = {k: v.shape for k, v in flatten(template).items()}
    flat = load_flat(path, ("['params']", "['mstate']"))
    got = {k: v.shape for k, v in flat.items()}
    if got != want:
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"{path} is not a member of this target: missing {missing[:4]}, "
                         f"extra {extra[:4]}, other shapes {shapes[:4]}")
    return from_jax_params(flat, device)


def _host_copy(tree):
    """A detached copy of a member state on the CPU (JAX's ``device_get``)."""
    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target-root", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--source-root", required=True)
    p.add_argument("--sources", required=True, help="comma-separated source dataset names")
    p.add_argument("--out", default="multi_log")
    p.add_argument("--joint-epochs", type=int, default=720)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--member-checkpoints", default=None,
        help="comma-separated member .npz checkpoints: skip training and "
        "vote directly (reference multi_source_voting.py loads 3 tars)",
    )
    p.add_argument("--phase-epochs", default=None, help="JSON phase-length override")
    p.add_argument("--budget-multiplier", type=float, default=1.0)
    p.add_argument(
        "--capture-epochs", default=None,
        help="comma-separated phase-5 epochs; source i's member is snapshot "
        "at capture_epochs[i %% len] instead of end-of-run. Epochs must be "
        "multiples of eval_every (the checkpoint cadence).",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    with torchrun_group(args.device) as (rank, world, device):
        return train_and_vote(args, rank, world, device)


def train_and_vote(args, rank: int, world: int, device):
    """``main`` on this rank: the ensemble's result on rank 0, None on the
    others."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    phase_epochs = json.loads(args.phase_epochs) if args.phase_epochs else None

    target_dict = {}
    t_train = TrainData(args.target_root, f"{args.target}/{args.target}_TRAIN.ts", target_dict)
    t_test = TestData(args.target_root, f"{args.target}/{args.target}_TEST.ts", target_dict)
    os.makedirs(args.out, exist_ok=True)
    shape = (t_train.in_channel, t_train.time_length, t_train.num_class)
    cfg = PipelineConfig(budget_multiplier=args.budget_multiplier)

    if args.member_checkpoints:
        sources, paths = [], args.member_checkpoints.split(",")
    else:
        sources = args.sources.split(",")
        paths = [os.path.join(args.out, f"member_{source}.npz") for source in sources]
    capture_epochs = (
        [int(e) for e in args.capture_epochs.split(",")] if args.capture_epochs else None
    )

    def make_member_fn(i, source):
        def fn():
            source_dict = {}
            s_train = TrainData(args.source_root, f"{source}/{source}_TRAIN.ts", source_dict)
            s_test = TestData(args.source_root, f"{source}/{source}_TEST.ts", source_dict)
            cfg = PipelineConfig(seed=args.seed + i, joint_epochs=args.joint_epochs,
                                 budget_multiplier=args.budget_multiplier)
            pipe = StyleTransferPipeline(
                *shape, s_train.in_channel, s_train.time_length, s_train.num_class, cfg,
                device=device,
            )
            snap = {}
            capture_at = capture_epochs[i % len(capture_epochs)] if capture_epochs else None

            def checkpoint_hook(e, state):
                if capture_at is not None and e == capture_at:
                    snap["member"] = _host_copy(target_member(state))

            state, history = pipe.run(
                t_train, t_test, s_train, s_test, epochs=phase_epochs,
                verbose=False, checkpoint_hook=checkpoint_hook,
            )
            member = snap.get("member") or target_member(state)
            tag = f"@p5e{capture_at}" if "member" in snap else ""
            save_checkpoint(paths[i], member)
            print(f"[{source}{tag}] final:", history[-1])
            return member

        return fn

    # K heterogeneous pipelines: member i on rank i % P.  One process
    # spreads its members over every card for --device cuda (one after
    # another on one card), else runs them on the one device named.
    trained = [i for i in range(len(sources)) if i % world == rank]
    devices = None if world == 1 and device.type == "cuda" and device.index is None else [device]
    held = {}
    if trained:
        held = dict(zip(trained, train_members_parallel(
            [make_member_fn(i, sources[i]) for i in trained], devices)))
    if world > 1:
        dist.barrier()  # every member file is written

    mesh, voting = ensemble_mesh(world, rank, len(paths), device)
    if not voting:
        return None
    ens = MultiSourceEnsemble(*shape, config=cfg, device=device, mesh=mesh)
    to_read = [i for i in ens.local_members(len(paths)) if i not in held]
    if to_read:  # members other ranks trained, or --member-checkpoints
        model_def = OSCNNClassifier(*shape, config=cfg, with_cpc=False, device=device)
        template = model_def.init_models(torch.Generator().manual_seed(0))
        held.update({i: restore_member(paths[i], template, device) for i in to_read})
    stacked = ens.stack([held.get(i) for i in range(len(paths))])
    result = ens.evaluate(stacked, t_train, t_test)
    if rank != 0:
        return None
    np.save(os.path.join(args.out, "final_predict.npy"), result["predictions"])
    np.save(os.path.join(args.out, "true_label.npy"), t_test.y)
    save_prediction_strip(
        os.path.join(args.out, "prediction_strip.png"), result["predictions"], t_test.y
    )
    with open(os.path.join(args.out, "ensemble.json"), "w") as f:
        json.dump(
            {
                "ensemble_acc": result["ensemble_acc"],
                "member_accs": result["member_accs"],
                "vote_variants": result["vote_variants"],
            },
            f,
        )
    print(
        "ensemble accuracy:", result["ensemble_acc"],
        "members:", result["member_accs"],
        "variants:", result["vote_variants"],
    )
    return result


if __name__ == "__main__":
    main()
