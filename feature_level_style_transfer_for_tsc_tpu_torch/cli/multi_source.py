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
* the members are stacked and run one after another on the card; the
  per-class precision weights come from the target train split, and the
  vote's predictions and the true labels are saved as .npy like the
  reference, with ``prediction_strip.png`` and ``ensemble.json``.

Usage:
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.multi_source \
      --target-root Multivariate_ts --target StandWalkJump \
      --source-root Univariate_ts --sources EthanolLevel,Worms,InlineSkate \
      --out multi_log --device cuda
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.dataset import TestData, TrainData
from ..io.artifacts import save_prediction_strip
from ..io.checkpoint import flatten, from_jax_params, load_flat, save_checkpoint
from ..ops import resolve_device
from ..parallel.multi_pipeline import train_members_parallel
from ..parallel.multi_source import MultiSourceEnsemble, tree_map
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
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    phase_epochs = json.loads(args.phase_epochs) if args.phase_epochs else None

    sources = args.sources.split(",")
    target_dict = {}
    t_train = TrainData(args.target_root, f"{args.target}/{args.target}_TRAIN.ts", target_dict)
    t_test = TestData(args.target_root, f"{args.target}/{args.target}_TEST.ts", target_dict)
    os.makedirs(args.out, exist_ok=True)
    shape = (t_train.in_channel, t_train.time_length, t_train.num_class)

    members = []
    if args.member_checkpoints:
        model_def = OSCNNClassifier(
            *shape, config=PipelineConfig(budget_multiplier=args.budget_multiplier), with_cpc=False,
            device=device,
        )
        template = model_def.init_models(torch.Generator().manual_seed(0))
        for path in args.member_checkpoints.split(","):
            members.append(restore_member(path, template, device))
        sources = []
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
            save_checkpoint(os.path.join(args.out, f"member_{source}.npz"), member)
            print(f"[{source}{tag}] final:", history[-1])
            return member

        return fn

    if sources:
        # K heterogeneous pipelines: over every card for --device cuda (one
        # after another on one card), else on the one device named
        devices = None if device.type == "cuda" and device.index is None else [device]
        members.extend(train_members_parallel(
            [make_member_fn(i, s) for i, s in enumerate(sources)], devices))

    ens = MultiSourceEnsemble(
        *shape, config=PipelineConfig(budget_multiplier=args.budget_multiplier), device=device
    )
    stacked = ens.stack(members)
    result = ens.evaluate(stacked, t_train, t_test)
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
