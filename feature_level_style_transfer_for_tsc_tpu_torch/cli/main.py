"""Single source->target style-transfer training run.

Counterpart of the JAX package's ``cli/main.py`` (reference ``main.py:1-11``,
which hard-codes SelfRegulationSCP2 <- EthanolLevel), with the same flags
plus ``--device`` (default ``cuda``; it refuses to run when CUDA is absent,
unless ``--device cpu`` asks for the plain PyTorch path).  On CUDA it turns
TF32 off for cuDNN and matmuls: the JAX package trains in exact float32.

It writes what the JAX CLI writes, under the JAX key layout: ``epoch_*.npz``
and ``epoch_*_source.npz`` at the phase-5 eval cadence,
``p*_{target,source}_classifier_itself.npz`` at each phase end,
``final_state.npz``, ``history.json``, ``log.jsonl`` and the
``feature_of_*`` dumps.  ``final_state.npz`` is the whole training state
(``StyleTransferPipeline.state_to_flat``): params, mstate, consts, the
optimizer moments, learning rates and counts, the schedulers, the GradNorm
weights and the PRNG, under every key of the JAX package's ``init_state``,
plus the port's generator state.  ``--resume`` does what the JAX CLI does:
when ``<out>/final_state.npz`` exists (written by either package), the run
starts from it, the given ``--phase-epochs`` replayed with the batch order
reseeded from ``seed + 1``; the JAX CLI resumes a file the port wrote.

The JAX package's route switches of the flow's coupling net hold here too:
``FLSTTSC_WN_FUSED=0`` trains with the op-by-op WN (the gate kernel) and
``FLSTTSC_CONV_IMPL=pallas`` makes its dilated convs the tap-conv kernel.

Usage:
  python -m feature_level_style_transfer_for_tsc_tpu_torch.cli.main \
      --target-root Multivariate_ts --target SelfRegulationSCP2 \
      --source-root Univariate_ts --source EthanolLevel \
      --out train_log --device cuda
  # the op-by-op WN route:
  FLSTTSC_WN_FUSED=0 FLSTTSC_CONV_IMPL=pallas python -m ... (same flags)
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import PipelineConfig
from ..io.checkpoint import load_flat, save_checkpoint, save_flat
from ..ops import resolve_device
from ..train.pipeline import StyleTransferPipeline
from .predict import build_datasets


def target_member(state):
    """Target extractor + classifier (reference utils.py:9-15), the member
    layout ``cli.predict`` serves."""
    return {
        "params": {"ext": state["params"]["t_ext"], "cls": state["params"]["t_cls"]},
        "mstate": {"ext": state["mstate"]["t_ext"], "cls": state["mstate"]["t_cls"]},
    }


def source_member(state):
    """Source extractor + DimensionUnification + source classifier
    (reference utils.py:18-25)."""
    return {
        "params": {"ext": state["params"]["s_ext"], "dim_uni": state["params"]["dim_uni"],
                   "cls": state["params"]["s_cls"]},
        "mstate": {"ext": state["mstate"]["s_ext"], "cls": state["mstate"]["s_cls"]},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target-root", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--source-root", required=True)
    p.add_argument("--source", required=True)
    p.add_argument("--out", default="train_log")
    p.add_argument("--joint-epochs", type=int, default=720)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--phase-epochs", default=None,
        help='JSON dict overriding phase lengths, e.g. \'{"p1":1,"p2":1,"p3":1,"p4":1,"p5":2}\'',
    )
    p.add_argument("--budget-multiplier", type=float, default=1.0)
    p.add_argument("--resume", action="store_true",
                   help="start from <out>/final_state.npz (either package's) when it exists")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    t_train, t_test, s_train, s_test = build_datasets(
        args.target_root, args.target, args.source_root, args.source
    )
    cfg = PipelineConfig(seed=args.seed, joint_epochs=args.joint_epochs,
                         budget_multiplier=args.budget_multiplier)
    pipe = StyleTransferPipeline(
        t_train.in_channel, t_train.time_length, t_train.num_class,
        s_train.in_channel, s_train.time_length, s_train.num_class, cfg, device=device,
    )
    os.makedirs(args.out, exist_ok=True)

    def checkpoint_hook(epoch, state):
        # train_and_test.py:780-781 saves both sides at the eval cadence
        save_checkpoint(os.path.join(args.out, f"epoch_{epoch}.npz"), target_member(state))
        save_checkpoint(os.path.join(args.out, f"epoch_{epoch}_source.npz"), source_member(state))

    def phase_checkpoint_hook(phase, state):
        # the reference's post-phase-3 classifier_itself pair (:364-372), at
        # every phase end
        save_checkpoint(os.path.join(args.out, f"{phase}_target_classifier_itself.npz"),
                        target_member(state))
        save_checkpoint(os.path.join(args.out, f"{phase}_source_classifier_itself.npz"),
                        source_member(state))

    state = None
    resume_path = os.path.join(args.out, "final_state.npz")
    if args.resume and os.path.exists(resume_path):
        state = pipe.state_from_flat(load_flat(resume_path))
        print(f"resumed from {resume_path}")

    epochs = json.loads(args.phase_epochs) if args.phase_epochs else None
    state, history = pipe.run(
        t_train, t_test, s_train, s_test, epochs=epochs, state=state, seed=args.seed,
        checkpoint_hook=checkpoint_hook, phase_checkpoint_hook=phase_checkpoint_hook,
        artifact_dir=args.out, log_file=os.path.join(args.out, "log.jsonl"),
    )
    save_flat(resume_path, pipe.state_to_flat(state))
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(history, f)
    print("done; final:", history[-1])
    return state, history


if __name__ == "__main__":
    main()
