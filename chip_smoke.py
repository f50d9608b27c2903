#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check its kernels.

Run from the repository root with one CUDA card:  python3 chip_smoke.py

It imports only torch, numpy and the port (never jax or the JAX package),
exits non-zero without a card or without the port beside it, and exits
non-zero when any check fails.  Phases:

1. setup: the card's name and power limit, TF32 off, the build of every
   kernel source in ``ops/csrc`` (one nvcc per source, started together,
   timed, with ptxas's register and spill lines): os_conv, wn_fused, gate,
   tap_conv;
2. each kernel against its plain PyTorch version at the six masked OS convs
   of the full-width serving model (SelfRegulationSCP2 shape of the
   reference main.py: 7 channels, T=1152, 2 classes; budget_multiplier=1.0,
   batch 20), with CUDA-event times of the kernel, the plain version and
   F.conv1d (the library yardstick, TF32 off) beside the bounds: the
   tensor-core bound of the 3xTF32 tap GEMM (three TF32 products a live
   term at the dense TF32 peak), which with the bytes bound is
   ``bound_ms``, and the FP32-pipe bound beside it; the work the tap
   windows leave issued, the effective TFLOP/s on live and on issued
   operations, and kernel_ms / library_ms; every time here and below is
   CUDA events around a run of back-to-back calls (``cuda_ms``), and the
   conv phases also keep the single-call medians that earlier PRs took;
3. single-checkpoint serving through ``cli.predict.main`` on SCP2-shaped
   synthetic data (200 train / 180 test series), with the launch counts,
   the logits against the plain path on the card, and series/s;
4. ensemble serving (3 members, entropy_precision vote) through
   ``cli.predict.main``, the members under one ``torch.func.vmap`` (one
   run-axis launch a layer and split), with launch counts and predictions
   against the plain path, and the members' logits on the whole train and
   test splits and the class weights against the plain path; on each split
   the vmapped logits the bits of the members' own calls, with the
   launches of both counted, and again with the calls split on the host
   past a lowered grid limit; the run-axis calls timed against the
   members' one-run calls, and the series/s of the members one after
   another beside the vmapped ensemble's; phases 3 and 4 run with
   FLSTTSC_FUSE_EPILOGUE unset and =1; every checkpoint carries random
   BatchNorm state, so the folded epilogue is exercised;
5. the vendored VendGunPoint (T=150) once through ``cli.predict.main``;
6. the WN kernels ``wn_fwd``/``wn_bwd`` against ``wn_fwd_plain``/
   ``wn_bwd_plain`` at both full-width training shapes (46,080 rows for the
   pair pass, 23,040 for infer; n_half 25, C 120, 8 layers; random
   weight-normed parameters and a non-zero end projection), and at the
   pair pass (B=40) of the widest half widths the vendored datasets give,
   VendGunPoint's (T=150, n_half 65) and VendCoffee's (T=60, n_half 168),
   every ``wn_fwd`` and ``wn_bwd`` output within 1e-5 of its plain version
   and two runs the same bits, timed beside their bounds (the tensor-core
   bound of f32-accurate products, which with the bytes bound is
   ``bound_ms``, and the FP32-pipe bound beside it), with each one's device
   time by ``__global__`` kernel (``torch.profiler``);
7. the OS conv's gradient on the card: dx and dw through ``OSConvCore``
   against the plain path's autograd at the six full-width conv shapes;
8. training through ``cli.main.main([... "--device", "cuda"])``: SCP2 <-
   EthanolLevel shapes (7 x 1152, 2 classes <- 1 x 1751, 4 classes; 40
   train / 40 test series per domain), ``PipelineConfig()`` defaults, one or
   two epochs of every phase (``PHASE_EPOCHS``); exact launch counts, finite
   losses in phases 1-4 and phase 5's first step (the rest of phase 5 is
   recorded), the checkpoints, ``epoch_0.npz`` served by ``cli.predict``,
   and the phase-5 step time;
8b. ``cli.main ... --resume --device cuda`` on a copy of phase 8's out
   directory (its ``final_state.npz``, the whole training state), phases
   1-4 of 0 epochs and phase 5 of 1, deterministic, with exact launch
   counts: its first phase-5 step's losses must be the same bits as those
   of ``pipe.run`` from a deep copy of the state phase 8 returned;
9. one full-width phase-5 step against the plain path on the card (kernels
   swapped for their plain versions; CPC anchors and CDAN dropout pinned):
   the 9 losses, the trunk-norm vectors, the new GradNorm weights and the
   gradients of the total per module (relative L2 distance and largest
   difference over the module's max|g|), checked on a fresh state with WN
   end projections 0.1*N(0, 1) and measured on the trained state; on both
   states the same step with only the WN kernels on (checked on the fresh
   state) and with only the OS conv kernel on, and on the fresh state the
   plain path on the CPU, are held against the plain path on the card too;
10. one full-width phase-5 step of phase 9's fresh state on the op-by-op
    route against the fused route, both on the card; and the op-by-op
    route's kernels against its plain versions on the card (all kernels,
    and the WN route's kernels alone);
11. one more phase-5 step of that fresh state under ``torch.profiler``: the
    device time by kernel, summed by group (WN kernels, both weight splits
    included; OS conv kernel; the rest), and the device's idle share of the
    traced step's wall time, measured and not checked;
12. the op-by-op WN's kernels at full width: ``gate_fwd`` against
    ``gate_plain`` at the pair (46,080 rows) and infer (23,040) shapes,
    with ``b`` a column slice of a cond projection, beside its bytes bound,
    timed back to back on one input set and over a rotation of sets that
    exceed twice the L2 (each call reads from device memory);
    ``tap_conv_fwd`` against ``tap_conv_plain`` at the 8 dilations of the
    pair pass's forward (120 -> 240) and of its input-gradient pass (240 ->
    120), beside its tensor-core and FP32 bounds (as phase 2), its TFLOP/s,
    and ``F.conv1d`` with ``dilation`` (TF32 off) as the library yardstick;
    ``TapConvCore``'s dx and dw against autograd of the plain version;
13. training through ``cli.main`` on the op-by-op route
    (``FLSTTSC_WN_FUSED=0``, ``FLSTTSC_CONV_IMPL=pallas``, set around the
    call and restored), the shapes and lengths of phase 8: exact launch
    counts (the gate and the tap conv instead of the WN
    kernels), finiteness as phase 8, the checkpoints, the phase-5 step time
    beside phase 8's;
14. the repair of the WN kernels' width on real data: ``cli.main`` from
    disk on the vendored VendSCP2 (target, T=144, n_half 72) <-
    VendEthanol (source), the default fused route, reference budgets, two
    epochs of phases 1-4 and one of phase 5; finiteness as phase 8;
15. multi-source member training through ``cli.multi_source.main``: the
    SCP2 target of phase 8 <- EthanolLevel (1 x 1751, 4 classes) and Worms
    (1 x 900, 5) shapes, 40 train / 40 test series a domain,
    ``PipelineConfig()`` defaults, ``PHASE_EPOCHS``: exact launch counts
    (each member's training drive and the vote's member logits), finiteness
    per member as phase 8, the JAX CLI's file set, each member's wall time
    and phase-5 step time, and ``cli.predict`` over the two saved members
    giving ``final_predict.npy`` bit for bit;
16. the baselines through ``cli.baselines.main``, reference budgets, batch
    30, the default discriminator (128 wide, depth 8, 8 heads, MLP 64), 60
    train / 30 test series a domain: CoDATS on Haptics (1 x 1092, 5) <-
    InlineSkate (1 x 1882, 7), Worms (1 x 900, 5), SemgHandMovementCh2 (1 x
    1500, 6) shapes, 2 epochs; SLARDA on SelfRegulationSCP2 (7 x 1152, 2)
    <- MotorImagery (64 x 3000, 2) shapes, 2 source and 2 target epochs:
    exact ``os_conv_fwd`` launches, finite histories, epoch times; and one
    step of each (CoDATS, SLARDA's source step with a pinned CPC anchor and
    its target step) from a fresh state against the same step with the
    plain OS conv on the card: losses within REL_TOL, each module's
    gradients within BASELINE_GRAD_L2_TOL (relative L2);
17. the archive sweep through ``cli.archive_sweep.main``, reference
    budgets: the vendored ``datasets/Univariate_ts`` (six datasets) and
    ``datasets/Multivariate_ts`` (VendSCP2), ``SWEEP_EPOCHS`` unbucketed
    (once more with FLSTTSC_FUSE_EPILOGUE=1, its evaluation in
    ``os_conv_fused_fwd``) and ``--bucket``, and one epoch ``--with-cpc``
    over the univariate root; then a synthetic archive at four UCR 2018
    shapes (``UCR_SHAPES``: FordA, Earthquakes, Computers, StarLightCurves,
    the last one's test split cut to 1000 series), written by the port's
    ``write_ts_file``, one epoch unbucketed and ``--bucket`` (buckets of
    length 729 and 1094): exact conv launches from the layer specs, every
    dataset with ``test_acc`` and no ``error``, finite histories, the
    native parser for every file (``ts_parser.PARSES``), each dataset's
    wall time and series/s; native against Python parse time of the FordA
    files; and one FordA-bucket train step (500 padded to 729) and one
    evaluation batch against the plain OS conv on the card: the loss and
    the logits within REL_TOL, each module's gradients within
    BASELINE_GRAD_L2_TOL;
18. K = MULTIRUN_K runs of the curriculum in one launch set
    (``train.multirun.MultiRunStylePipeline``, seeds 0..K-1) at phase 8's
    shapes, data and lengths: exact launches of the run-axis kernels
    (``os_conv_fwd_runs``, ``wn_fwd_runs``, ``wn_bwd_runs``; the
    evaluation under FLSTTSC_FUSE_EPILOGUE=1 ``os_conv_fused_fwd_runs``,
    as often as one run's evaluation launches ``os_conv_fused_fwd``, with
    the same accuracies); run 3 unstacked, written by ``state_to_flat``
    and loaded by ``state_from_flat`` unchanged, its next phase-5 losses
    against the K-run's for run 3; one phase-5 step of K fresh runs against
    K one-run steps from the same states (losses within STEP_LOSS_REL_TOL,
    gradients within MULTIRUN_GRAD_L2_TOL relative L2 per module per run,
    each kernel launched as often as by one run); every run-axis kernel at
    the shapes that step and the evaluation gave it, each run against the
    one-run kernel (the same bits, else RUN_AXIS_REL_TOL) and against the
    plain version, timed beside the K one-run calls, the plain version and,
    for the conv, a grouped ``F.conv1d``; and the step's K sweep at
    MULTIRUN_SWEEP (``experiments/multirun_time.py`` in a process of its own, without
    ``CUBLAS_WORKSPACE_CONFIG``, one round, both WN routes, the op-by-op one
    for phase 23): step ms, aggregate series/s, device ms and idle share,
    peak memory a K;
19. both bf16 switches (``FLSTTSC_WN_MXU=bf16`` and
    ``PipelineConfig(compute_dtype="bfloat16")``) on phase 8's pair: one
    phase-5 epoch through ``StyleTransferPipeline.run`` from phase 8's state
    and one of K = MULTIRUN_K runs through ``MultiRunStylePipeline.run``,
    launching only the bf16 instances (``os_conv_fwd[bf16]``,
    ``wn_fwd[bf16]``, ``wn_bwd[bf16]`` and their ``_runs`` forms), exactly;
    one full-width phase-5 step of phase 9's fresh state: every bf16 kernel
    call of it again on its own operands against the plain version (the
    conv within BF16_REL_L2, the WN as below); against the free-running
    plain bf16 step on the card, whose module gradients the controls (the
    plain step with some sums in float64) move by up to 0.2 (each module
    within STEP_GRAD_L2_TOL or twice the controls' spread; each loss within
    STEP_LOSS_REL_TOL or twice the controls' spread); its losses against the
    f32 step's (all but BF16_NOISY_LOSSES, which the controls move by more
    than BF16_LOSS_NOISE), the step traced in a process of its own
    (``experiments/phase5_step_time.py --bf16``); ``os_conv_fwd[bf16]`` at the six
    serving convs against its plain bf16 version, the f32 kernel and
    ``F.conv1d`` in bf16; ``wn_fwd[bf16]`` and ``wn_bwd[bf16]`` at pair +
    infer, layer by layer and free-running (BF16_REL_L2, BF16_CASCADE), and
    each layer alone (BF16_FLIPS); and the run-axis bf16 forms at one K-run
    step's shapes (WN end projections non-zero) (``experiments/multirun_time.py
    --ks 8 --bf16`` times the K-run step, run on its own);
20. PipelineConfig's GradNorm / optimizer knobs on phase 8's pair at full
    width, from phase 9's fresh state with its pinned anchors and masks:
    one phase-5 step each of the default (merged pulls),
    ``merged_pullbacks=False``, ``stacked_pullbacks=True`` and
    ``fused_optimizers=True``, every kernel on, deterministic, with exact
    launches (the WN backward 5F, 6F, and 2F ``wn_bwd_runs`` calls of 3
    runs, F flows): unmerged against merged, the total's gradients the same
    bits, n_t, n_s and the GradNorm weights within KNOB_NORM_REL_TOL;
    stacked against unstacked, each module's gradients within
    STEP_GRAD_L2_TOL and the losses and norms within STEP_LOSS_REL_TOL, and
    every cotangent of every stacked ``wn_bwd_runs`` call the bits of the
    one-cotangent ``wn_bwd`` on its operands (the end projection's two
    gradients, one library product outside the kernel, within
    GRAD_REL_TOL), the pair pass's call timed against three one-run calls;
    the fused update against the per-module one within FUSED_OPT_ATOL, and
    on a phase-1 step the modules outside it untouched, bit for bit; the
    op-by-op route's stacked pulls against its merged ones (the tap conv's
    input gradients folded, ``tap_conv_fwd`` L(2F + 2F) times against
    L(2F + 5F)); K = MULTIRUN_K runs at once with the fused optimizer (the
    (K, N) update against each run's one-run update on the same gradients)
    and with stacked pulls (``wn_bwd_runs`` of 3K runs a call) against the
    same K states' merged pulls (STEP_GRAD_L2_TOL) and against K one-run
    stacked steps (phase 18's gates; where a module passes
    MULTIRUN_GRAD_L2_TOL, within twice the larger of phase 18's control and
    the merged K-run step's own gap from its one-run step); the
    bf16 stacked step (``FLSTTSC_WN_MXU=bf16``: every cotangent of
    ``wn_bwd_runs[bf16]`` the bits of ``wn_bwd[bf16]``) (the knobs'
    K-run step times come from ``experiments/multirun_time.py --knob`` run
    on its own);
21. time-sharded sequence parallelism (``parallel/sequence.py``) at full
    width on EigenWorms' shape (UEA archive, 6 x 17,984, 5 classes;
    synthetic data from the seed), ``PipelineConfig()``'s batch (20),
    layer specs (receptive field 89) and flow (3 flows, n_group the
    extractor's 50 channels, WN 120 channels, 8 layers): SEQ_RANKS = 4 rank
    processes (``parallel.launch.spawn``, joined with a deadline) share the
    card on gloo (``"cpu:gloo,cuda:gloo"``: NCCL refuses two ranks on one
    card), each with a 4,496-step shard; the sharded extractor in training
    and in eval mode, the sharded WaveGlow forward on its features, one
    backward of a fixed random projection of (z, log_s, log-determinants)
    to the input and every parameter, with exact launches a rank
    (``os_conv_fwd`` a layer a pass, ``tap_conv_fwd`` forward and dx,
    ``gate_fwd``; no WN kernel); held against the same unsharded ops on the
    card (outputs and new BatchNorm statistics within SEQ_ATOL,
    log-determinants SEQ_LOGDET_RTOL, the input gradient and each module's
    gradients summed over the ranks within SEQ_GRAD_REL_L2 (relative L2),
    or SEQ_GRAD_FACTOR times the unsharded float32 step's own gap, of the
    unsharded step that takes the ranks' ReLU sign patterns (``ReluSigns``:
    last-bit differences of the statistics flip ReLU inputs within
    rounding of zero; the flips counted, the unpinned gaps recorded) with
    its OS conv's transposed convs in float64); each
    kernel at the shard shapes against its plain version, timed; the
    forward+backward time of a rank (four share the card) and of the
    unsharded ops, recorded;
22. data parallelism (``parallel/dp.py``, ``parallel/dp_explicit.py``) at
    full width on phase 8's pair (``PipelineConfig(budget_multiplier=1.0)``,
    batch 20, DP_RANKS = 4 rank processes sharing the card on gloo as in
    phase 21, 5 series a domain a rank): each rank replicates the states
    (``dp.replicate``) and takes its rows of the batch (``place`` by
    ``data_sharding``); a data-parallel phase-5 step (``dp.phase5_grads``:
    the pulls, pinned CPC anchors, ``pinned_masks()`` sliced by rank), a
    phase-1 step (``make_dp_phase1_epoch``) and a classifier step
    (``dp.train_epoch``), with exact launches a rank (``os_conv_fwd``,
    ``wn_fwd``, ``wn_bwd``), the ranks' gradients and new parameters the
    same bits; held against the unsharded steps on the card (losses
    REL_TOL, trunk norms GRAD_REL_TOL, GradNorm weights REL_TOL, new
    BatchNorm statistics SEQ_ATOL, each module's gradients within
    DP_GRAD_REL_L2 or DP_GRAD_FACTOR times the unsharded float32 step's own
    gap, relative L2, of the unsharded step that takes the ranks' ReLU sign
    patterns with float64 transposed convs, phase 21's reference); the
    domain-sharded ensemble (4 members on ``make_mesh(data=1, domain=4)``,
    ``FLSTTSC_FUSE_EPILOGUE=1``: ``os_conv_fused_fwd``) against the
    one-process ensemble (the same predictions, class weights within
    1e-6); each kernel at a rank's shapes against its plain version, timed
    beside its bound; a rank's phase-5 step and the unsharded one, spawn to
    joined, peak memory a rank, recorded.  In the same spawn, from the same
    state: a data-parallel phase-5 step under each of ``DP_CONFIGS``
    (``merged_pullbacks=False``, ``stacked_pullbacks=True``,
    ``fused_optimizers=True``, ``compute_dtype="bfloat16"``,
    ``FLSTTSC_WN_MXU=bf16``, the op-by-op route with
    ``FLSTTSC_CONV_IMPL=pallas``: ``tap_conv_fwd`` and ``gate_fwd`` on each
    rank) with exact launches, the float32 ones held as the default step,
    the bf16 ones within their gates or twice the largest gap of three
    controls (two correct unsharded bf16 steps: the plain bf16 path, the OS
    convs in micro-batches, the rows in another order; printed); and one
    step each of phases 2, 3 (supervised) and 4 (both branches) through
    ``dp.phase2_epoch`` / ``phase3_epoch`` / ``phase4_epoch`` (one batch,
    exact launches), their losses and gradients held as phase 1's;
23. K = MULTIRUN_K runs at once on the op-by-op WN route
    (``FLSTTSC_WN_FUSED=0``, ``FLSTTSC_CONV_IMPL=pallas``) at phase 8's
    pair and full width (120-channel, 8-layer WN; batch 20), fresh states
    with WN end projections: one K-run phase-5 step, the main path of the
    route's run-axis forms (``tap_conv_fwd_runs``: the tap conv's kernel
    with the run on its grid; ``gate_fwd_runs``: one ``gate_fwd`` launch
    over the runs' rows), with exact launches, as many as a one-run step
    launches ``tap_conv_fwd`` and ``gate_fwd``; held against K one-run
    steps at phase 18's gates (losses STEP_LOSS_REL_TOL, each module's
    gradients MULTIRUN_GRAD_L2_TOL or twice the one-run step's own gap with
    the plain OS conv); every recorded call of both run-axis forms again,
    each run against the one-run kernel (the same bits) and the plain
    version (REL_TOL), timed beside K one-run calls, the plain version and,
    for the tap conv, a grouped dilated ``F.conv1d``; and the K = 8
    op-by-op step timed (phase 18's ``experiments/multirun_time.py``
    process);
24. ``cli.predict`` and ``cli.multi_source`` under ``torchrun`` (``python -m
    torch.distributed.run --standalone``), the ranks sharing the card on
    ``"cpu:gloo,cuda:gloo"``, each rank running the CLI's ``main`` through
    this script's rank mode (``--cli-rank``, which writes its launch
    counts and every ``member_logits`` result), the three commands at
    once: ``cli.predict`` over three members whose predictions vary (heads
    scaled and centred: phase 4's random members each predict one class)
    with 3 ranks (``make_mesh(data=1, domain=3)``, a member a rank) and 2
    (rank 0 alone), the predictions' bytes, the member accuracies (not all
    equal) and every serving rank's gathered member logits those of the
    one-process run, one ``_predict.npy``; ``cli.multi_source`` with phase
    15's two sources over 2 ranks (member i trained by rank i, the vote on
    their mesh), the JAX CLI's file set, finite members,
    ``final_predict.npy`` and each rank's gathered member logits what
    one-process ``cli.predict`` gives over the saved members; exact
    launches a rank; wall times, each rank's startup and a rank's member
    wall time beside phase 15's.

The ``cli.main`` drives (phases 8, 8b, 13, 14) and the drives of phases
15, 16 and 17 run with PyTorch's deterministic
algorithms, so each repeats bit for bit from run to run.  The launch counts
are set to 0 just before each drive of the main path and read just after
it.  The line before the last lists every kernel as JSON,
with the launches of the main-path drives (serving: single and ensemble,
not the VendGunPoint check; training: the two ``cli.main`` drives of phases
8 and 13, not those of phases 8b, 14, 15, 16 and 17, whose counts are
checked and kept apart; the run-axis kernels, phase 18's drive and its
fused evaluation; the bf16 instances, phase 19's two drives; phase 20's
steps are checked and kept apart; phase 21's sharded pass and phase 22's
data-parallel steps and ensemble, and phase 24's CLI runs, each rank
setting its counts to 0 just before each and reading them just after,
summed over the ranks; the op-by-op run-axis forms, phase 23's K-run step;
the ensemble's run-axis convs, phases 4, 22 and 24) and a bound
from the FLOPs or bytes these inputs need (the bf16 instances' at the
BF16 peak); the last line is {"ok": true, "device": {...}}.  Everything measured is also written to
chiprun_out/chip_smoke_results.json.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import hashlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# cuBLAS repeats its sums only with a fixed workspace; set before its first use
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
FP32_PEAK = 67e12  # H100 SXM FP32 FLOP/s outside the tensor cores (NVIDIA data sheet)
TC_PEAK = 494.7e12  # H100 SXM dense TF32 FLOP/s on the tensor cores (NVIDIA data sheet)
BF16_PEAK = 989.4e12  # H100 SXM dense BF16 FLOP/s on the tensor cores (NVIDIA data sheet)
TF32_PRODUCTS = 3  # the tap-GEMM kernels' f32-accurate product: lo*hi + hi*lo + hi*hi
HBM_RATE = 3.35e12  # H100 SXM device memory bytes/s
L2_BYTES = 50e6  # H100 SXM L2
REL_TOL = 1e-4  # max_abs / max|plain|, exact f32 both sides, sums in another order
BATCH = 20
SCP2 = {"channels": 7, "length": 1152, "classes": 2, "n_train": 200, "n_test": 180}
GRAD_REL_TOL = 1e-3  # weight gradients: sums over every row (23k-46k) in another order
WN_BWD_REL_TOL = 1e-5  # every output of wn_bwd: 3xTF32 staged sums, fixed-order slice partials
WN_FWD_REL_TOL = 1e-5  # every output of wn_fwd: 3xTF32 staged sums through 8 layers
STEP_GRAD_L2_TOL = 1e-2  # a whole phase-5 step's gradients per module, every kernel on
# one baseline step's gradients per module, OS conv kernel on; on an H100 the kernel's largest
# gap read 3.2e-4 and the same steps with single-pass TF32 products 8.1e-3 to 1.7e-2
# (experiments/baseline_step_gap.py)
BASELINE_GRAD_L2_TOL = 1e-3
SOURCE = "feature_level_style_transfer_for_tsc_tpu_torch/ops/csrc/os_conv.cu"
WN_SOURCE = "feature_level_style_transfer_for_tsc_tpu_torch/ops/csrc/wn_fused.cu"
WN_BWD16_SOURCE = "feature_level_style_transfer_for_tsc_tpu_torch/ops/csrc/wn_bwd_bf16.cuh"
WN_FWD16_SOURCE = "feature_level_style_transfer_for_tsc_tpu_torch/ops/csrc/wn_fwd_bf16.cuh"
GATE_SOURCE = "feature_level_style_transfer_for_tsc_tpu_torch/ops/csrc/gate.cu"
TAP_SOURCE = "feature_level_style_transfer_for_tsc_tpu_torch/ops/csrc/tap_conv.cu"
REPLACES = {
    "os_conv_fwd": "feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:258",
    "os_conv_fused_fwd": "feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:288",
    "wn_fwd": "feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:164",
    "wn_bwd": "feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:195",
    "gate_fwd": "feature_level_style_transfer_for_tsc_tpu/ops/gate.py:28",
    "tap_conv_fwd": "feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:158",
}
ETHANOL = {"channels": 1, "length": 1751, "classes": 4}  # the reference main.py's source
TRAIN_SERIES = 40  # per split and domain in the training drive
# Epochs per phase of the cli.main drives (phases 8 and 13; phase 14), each
# running both branches of phases 3 and 4.  With so short an NF pretrain the
# flow's NLL can run away in phase 5, in the JAX package too
# (experiments/truncated_pretrain_runaway.py trains both packages on the CPU
# at these and other lengths): past about 1e17 the GradNorm trunk norms
# overflow float32 and the weights turn NaN.  So the drives check phases 1-4
# and phase 5's first step, and record the rest of phase 5 (check_history).
# These lengths were picked among those probed (the grid of that script)
# because their deterministic runs stay finite, which keeps the served
# epoch_0.npz meaningful; they are not what makes the checks pass.
PHASE_EPOCHS = {"p1": 1, "p2": 1, "p3": 2, "p4": 2, "p5": 1}
VENDORED_EPOCHS = {"p1": 2, "p2": 2, "p3": 2, "p4": 2, "p5": 1}
RESUME_EPOCHS = {"p1": 0, "p2": 0, "p3": 0, "p4": 0, "p5": 1}  # the --resume drive (phase 8b)
OP_BY_OP = {"FLSTTSC_WN_FUSED": "0", "FLSTTSC_CONV_IMPL": "pallas"}
WIDE_WN = (("VendGunPoint", 150, 65), ("VendCoffee", 60, 168))  # (dataset, T, n_half)
GATE_OPS = 5  # per output: two adds, one multiply, tanh and sigmoid, each counted once
ANCHORS = (100, 37)  # pinned CPC anchors of the phase-5 comparison (< 1152 // 4)
WORMS = {"channels": 1, "length": 900, "classes": 5}  # a second source of phase 15
# phase 16: the JAX CLI's example pairs, (C, T, classes) of each domain
CODATS_TARGET, SLARDA_TARGET = "SynHaptics", "SynSCP2b"
CODATS_SOURCES, SLARDA_SOURCE = ["SynInlineSkate", "SynWorms", "SynSemgCh2"], "SynMotorImagery"
CODATS_DOMAINS = {"SynHaptics": (1, 1092, 5), "SynInlineSkate": (1, 1882, 7),
                  "SynWorms": (1, 900, 5), "SynSemgCh2": (1, 1500, 6)}
SLARDA_DOMAINS = {"SynSCP2b": (7, 1152, 2), "SynMotorImagery": (64, 3000, 2)}
BASELINE_SERIES = (60, 30)  # train, test series a domain
BASELINE_BATCH = 30  # the Comparison/ code's batch size
BASELINE_EPOCHS = 2  # CoDATS epochs; SLARDA source and target epochs each
SLARDA_ANCHOR = 300  # pinned CPC anchor of the SLARDA source-step comparison (< 3000 // 4)
WN_END_SCALE = 0.1  # std of the WN end projections of the checked phase-5 state
# phase 17: (train, test, T, classes) of four UCR 2018 datasets, from the archive's
# DataSummary.csv; StarLightCurves' test split (8236 series) cut to 1000
UCR_SHAPES = {"FordA": (3601, 1320, 500, 2), "Earthquakes": (322, 139, 512, 2),
              "Computers": (250, 250, 720, 2), "StarLightCurves": (1000, 1000, 1024, 3)}
SWEEP_EPOCHS = 2  # the vendored sweeps (1 under --with-cpc, and over the UCR shapes)
# phase 18: K runs of the multirun; the Ks of its step sweep (experiments/multirun_time.py)
MULTIRUN_K = 8
MULTIRUN_SWEEP = (8,)  # K = 2 and 4 cut to make room for phase 22, K = 1 for phase 24
RUN_AXIS_REL_TOL = 1e-6  # a run of a run-axis kernel against the one-run kernel, where not equal
# A K-run phase-5 step against K one-run steps is held to phase 9's gates (REL_TOL for the
# losses, STEP_GRAD_L2_TOL for each module's gradients per run): its kernels give each run the
# one-run bits, but vmap's batched products and reductions sum in another order, and the
# OS-CNN turns last-bit differences into gradient gaps where a ReLU input is within rounding
# of zero.  Measured on an H100 (fresh states): the one-run step taken
# twice 1.1e-6, K = 1 under vmap 1.1e-6, K = 8 up to 4.4e-5 (losses) and 9.1e-3 (gradients:
# one run's "ad", which the same one-run step with the plain OS conv moves by as much).  So
# the phase takes that control for every run and module, and a module passes within
# MULTIRUN_GRAD_L2_TOL or within twice its control's gap.
STEP_LOSS_REL_TOL = REL_TOL
MULTIRUN_GRAD_L2_TOL = STEP_GRAD_L2_TOL
RUN_AXIS = {  # run-axis kernel: (one-run kernel, source)
    "os_conv_fwd_runs": ("os_conv_fwd", SOURCE), "os_conv_fused_fwd_runs": ("os_conv_fused_fwd", SOURCE),
    "wn_fwd_runs": ("wn_fwd", WN_SOURCE), "wn_bwd_runs": ("wn_bwd", WN_SOURCE),
}
# phase 23: the op-by-op WN route's run-axis forms, the tap conv's kernel with the run on its
# grid and the gate's runs folded into the rows of one gate_fwd launch
OPBYOP_RUN_AXIS = {"tap_conv_fwd_runs": ("tap_conv_fwd", TAP_SOURCE),
                   "gate_fwd_runs": ("gate_fwd", GATE_SOURCE)}
# no run-axis launch outside phases 18 and 23
RUN_AXIS_IDLE = {name: 0 for name in {**RUN_AXIS, **OPBYOP_RUN_AXIS}}
# phase 19: the bf16 switches (FLSTTSC_WN_MXU=bf16, PipelineConfig.compute_dtype="bfloat16").
# Each bf16 instance counts under its own name, "<f32 name>[bf16]"; the JAX code it stands for.
BF16 = {
    "os_conv_fwd[bf16]": (SOURCE, "feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:356 "
                          "XLA conv (bf16 operands and output, compute_dtype)"),
    "wn_fwd[bf16]": (WN_FWD16_SOURCE, "feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:164 "
                     "_wn_fwd_kernel (bf16=True)"),
    "wn_bwd[bf16]": (WN_BWD16_SOURCE, "feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:195 "
                     "_wn_bwd_kernel (bf16=True)"),
    "os_conv_fwd_runs[bf16]": (SOURCE, "feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:356 "
                               "XLA conv (bf16, vmapped)"),
    "wn_fwd_runs[bf16]": (WN_FWD16_SOURCE, "feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:164 "
                          "_wn_fwd_kernel (bf16=True, vmapped)"),
    "wn_bwd_runs[bf16]": (WN_BWD16_SOURCE, "feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:195 "
                          "_wn_bwd_kernel (bf16=True, vmapped)"),
}
BF16_IDLE = {name: 0 for name in BF16}  # no bf16 launch outside phase 19
# In phase 19 (some 700 s into this process) torch.profiler returned no device event of whole
# calls (none of wn_fwd[bf16]'s at pair, one of three of wn_bwd[bf16]'s), with or without 0.1 s
# of idle host time at both ends of its window, while phase 6 and every process of its own (the
# gpu tests, experiments/wn_time.py) kept every one.  So phase 19 profiles in processes of its
# own: the WN rows' breakdown (experiments/wn_time.py --bf16 --breakdown) and the one-run step
# (experiments/phase5_step_time.py --bf16), and every WN profile is checked complete against the
# wrappers' counts (check_breakdown, profile_step).
BF16_ENV = {"FLSTTSC_WN_MXU": "bf16"}
# A bf16 instance against its plain bf16 version, relative L2: the products are exact on both
# sides and only the f32 sums run in another order, so a sum within rounding of a bf16 boundary
# rounds to the neighbouring bf16 value, 2^-8 apart relatively.  BF16_REL_L2 holds where no such
# flip feeds a later rounding: the conv, each WN layer taken from the kernel's own input to it
# (``wn_fused.wn_fwd_plain_layers``), the WN backward's top layer.  Through the WN's 8 layers a
# flip moves the next layer's sums and flips more of its roundings, up to the bf16 noise floor:
# the plain bf16 WN with float64 sums (``f64_sums``, the control) sits up to 0.32 of the switch's
# own effect (plain bf16 against plain f32) from itself with f32 sums (phase 19's
# ``control_rel_l2`` on an H100).  So a free-running WN output passes within BF16_CASCADE times
# that effect, measured on the same inputs.  A sum that cancels magnifies a single flip (the
# phase-5 step's WN gradients), and so do the few roundings a flip carries through with one
# live layer (``one_live_layer``): there an output passes within BF16_REL_L2 or BF16_FLIPS
# times its control.  The kernels' tensor-core sums sit further from the exact sums than
# torch's f32 sums, so they flip more: 0.7-2.7 times the control at 23,040 rows (phase 19's
# ``one_live_layer`` on an H100), up to 3.7 at 600 (the ``gpu`` test).
BF16_REL_L2 = 1e-4
BF16_CASCADE = 0.5
BF16_FLIPS = 6.0
BF16_VS_F32_REL_L2 = 2e-2  # a bf16 instance's output against the f32 kernel's on the same data
# The phase-5 step with both switches.  Its losses against the f32 step's (rtol, atol
# BF16_LOSS_TOL), except a loss that the controls (the plain bf16 step with some of its sums in
# float64, against itself) move by more than BF16_LOSS_NOISE: such a loss is at the bf16 noise
# floor, and it must be one of BF16_NOISY_LOSSES, named with the cause.  Against the plain bf16
# step, every loss within STEP_LOSS_REL_TOL or twice the controls' spread.
BF16_LOSS_TOL = 5e-2
BF16_LOSS_NOISE = 1e-2
BF16_NOISY_LOSSES = {
    "cdan": "the difference of the critic's sums over the target and the s2t features; the s2t "
            "features come through the inverse flow, which magnifies the bf16 WN's roundings "
            "where log_s is large (3-5% between the controls on an H100)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """The wall time of each phase of ``main``, logged as the next one starts."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.name = None
        self.secs = {}

    def start(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.secs[self.name] = now - self.last
            log(f"[clock] {self.name}: {now - self.last:.1f} s (since the start {now - self.t0:.1f} s)")
        self.name, self.last = name, now


def conv_totals(what: str, rows, ms: str, library_ms: str) -> dict:
    """Sums over a conv phase's rows: times, both bounds, live and issued
    GFLOP, effective TFLOP/s on each, and kernel time over library time."""
    single = [k for k in rows[0] if k.endswith("single_call_ms")]
    tot = {k: sum(r[k] for r in rows) for k in
           (ms, library_ms, "bound_ms", "tc_flop_ms", "fp32_bound_ms", "gflop", "issued_gflop",
            *single)}
    tot["live_tflops"] = tot["gflop"] / tot[ms]
    tot["issued_tflops"] = tot["issued_gflop"] / tot[ms]
    tot["kernel_over_library"] = tot[ms] / tot[library_ms]
    log(f"[{what}] {json.dumps(tot)}")
    return tot


def cuda_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls (the
    host's launch work overlaps the device's), median of 3 runs, after
    warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


def single_call_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median CUDA-event time of one call alone, after warmup: the device
    waits for the host's launch work of each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rotated_ms(fn, sets) -> float:
    """Time of one call ``fn(*args)`` over a rotation of input sets, a call
    each, that together exceed the L2, so each call reads from device
    memory: CUDA events around 4 passes, median of 3 runs, after a warm-up
    pass."""
    rounds = 4
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            for args in sets:
                fn(*args)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / (rounds * len(sets)))
    return statistics.median(runs)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    max_abs = (got - want).abs().max().item()
    return max_abs, max_abs / max(want.abs().max().item(), 1e-30)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Run:
    """Launch counts of the drives; ``launches`` sums, per kernel, those of
    the main path (SCP2 serving, single and ensemble, and the training
    drive), ``by_path`` per path, and ``by_drive`` keeps each drive."""

    def __init__(self, *modules):
        self.modules = modules
        self.names = [name for m in modules for name in m.LAUNCHES]
        self.launches = {name: 0 for name in self.names}
        self.by_path = {}
        self.by_drive = {}

    def idle(self) -> dict:
        return {name: 0 for name in self.names}

    def counts(self) -> dict:
        return {name: n for m in self.modules for name, n in m.LAUNCHES.items()}

    def add(self, what: str, counts: dict, path: str) -> None:
        """Counts of a drive that ran in other processes (phases 21-22's ranks),
        each of which set its counts to 0 just before the drive and read
        them just after, added to ``path`` as ``drive`` adds its own."""
        log(f"[{what}] launches={counts}")
        self.by_drive[what] = counts
        per = self.by_path.setdefault(path, self.idle())
        for name, n in counts.items():
            self.launches[name] += n
            per[name] += n

    def drive(self, what: str, fn, expect: dict, path=None):
        for m in self.modules:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = self.counts()
        log(f"[{what}] launches={counts} expected={expect} wall_s={wall:.3f}")
        check(counts == expect, f"{what}: launches {counts} != {expect}")
        self.by_drive[what] = counts
        if path:
            per = self.by_path.setdefault(path, self.idle())
            for name, n in counts.items():
                self.launches[name] += n
                per[name] += n
        return out


@contextlib.contextmanager
def plain_convs(osconv, wn_fused, gate, convs: bool = True, wn: bool = True):
    """The reference run: the plain PyTorch versions of the OS conv kernels
    (``convs``) and of the kernels of both WN routes (``wn``: the fused WN
    kernels, the gate and the tap conv) on the same CUDA tensors, and no
    launch of those kernels inside (the run-axis forms' included: under
    ``torch.func.vmap`` the plain versions run run by run)."""
    saved = (osconv.os_conv, osconv.os_conv_fused, osconv.os_conv_runs, osconv.os_conv_fused_runs,
             wn_fused.wn_fwd, wn_fused.wn_bwd, gate.gate_fwd, osconv.tap_conv_fwd,
             osconv.tap_conv_fwd_runs)
    if convs:
        osconv.os_conv, osconv.os_conv_fused = osconv.os_conv_plain, osconv.os_conv_fused_plain
        osconv.os_conv_runs = lambda x_pad, w: torch.stack(
            [osconv.os_conv_plain(xk, wk) for xk, wk in zip(x_pad, w)])
        osconv.os_conv_fused_runs = lambda x_pad, w, scale, shift, relu: torch.stack(
            [osconv.os_conv_fused_plain(*args, relu) for args in zip(x_pad, w, scale, shift)])
    if wn:
        wn_fused.wn_fwd, wn_fused.wn_bwd = wn_fused.wn_fwd_plain, wn_fused.wn_bwd_plain
        gate.gate_fwd = lambda a, b, n, name="gate_fwd": gate.gate_plain(a, b, n)
        osconv.tap_conv_fwd = osconv.tap_conv_plain
        osconv.tap_conv_fwd_runs = lambda x_pad, w, d: torch.stack(
            [osconv.tap_conv_plain(xk, wk, d) for xk, wk in zip(x_pad, w)])
    for m in (osconv, wn_fused, gate):
        m.reset_launch_counts()
    try:
        yield
    finally:
        (osconv.os_conv, osconv.os_conv_fused, osconv.os_conv_runs, osconv.os_conv_fused_runs,
         wn_fused.wn_fwd, wn_fused.wn_bwd, gate.gate_fwd, osconv.tap_conv_fwd,
         osconv.tap_conv_fwd_runs) = saved
    conv_names = ("os_conv_fwd", "os_conv_fused_fwd", "os_conv_fwd[bf16]", "os_conv_fwd_runs",
                  "os_conv_fused_fwd_runs", "os_conv_fwd_runs[bf16]")
    launched = {n: v for n, v in {**osconv.LAUNCHES, **wn_fused.LAUNCHES, **gate.LAUNCHES}.items()
                if (convs and n in conv_names) or (wn and n not in conv_names)}
    check(not any(launched.values()), f"the plain reference launched {launched}")


@contextlib.contextmanager
def environ(**values):
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


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's and the atomics-free
    index ops) inside: a ``cli.main`` drive then repeats bit for bit from
    run to run: the flow amplifies the order of atomic adds by orders of
    magnitude in phase 5, and the recorded values should repeat."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def stacked(*contexts):
    with contextlib.ExitStack() as stack:
        for ctx in contexts:
            stack.enter_context(ctx)
        yield


def series_per_s(fn, n: int, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return n / statistics.median(times)


# ------------------------------------------------------------------ phase 1 --

def build_kernels(_build, names) -> dict:
    """One nvcc per source, all started together; the wall time of each and
    of the whole, and ptxas's register and spill lines."""
    def one(name):
        t0 = time.perf_counter()
        path = _build.build(name)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(one, names)))
    out = {"wall_s": time.perf_counter() - t0}
    for name, (path, secs) in built.items():
        out[name] = secs
        log(f"build: {path.name} in {secs:.2f} s")
        for line in (path.parent / (path.name + ".ptxas.txt")).read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: all sources in {out['wall_s']:.2f} s")
    return out


# ------------------------------------------------------------------ phase 2 --

def kernel_phase(osconv, layers):
    """Both kernels against their plain versions at the serving shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, c_in, c_out, k, mask, relu in layers:
        x_pad = torch.randn(BATCH, SCP2["length"] + k - 1, c_in, device="cuda", generator=gen)
        w = torch.randn(k, c_in, c_out, device="cuda", generator=gen) / math.sqrt(c_in * k) * mask
        scale = torch.rand(c_out, device="cuda", generator=gen) + 0.5
        shift = torch.randn(c_out, device="cuda", generator=gen)
        y = osconv.os_conv(x_pad, w)
        err, rel = rel_err(y, osconv.os_conv_plain(x_pad, w))
        errs_f = [
            rel_err(osconv.os_conv_fused(x_pad, w, scale, shift, r),
                    osconv.os_conv_fused_plain(x_pad, w, scale, shift, r))
            for r in (False, True)
        ]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"{name}: non-finite kernel output")
        x_ncw = x_pad.transpose(1, 2).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()
        lib_err = rel_err(F.conv1d(x_ncw, w_oik).transpose(1, 2), y)[1]
        # the work these inputs need: only the mask's live taps, (K, 1, C_out)
        live_taps = int(mask.sum().item())
        flops = 2 * BATCH * SCP2["length"] * c_in * live_taps
        dense_flops = 2 * BATCH * SCP2["length"] * k * c_in * c_out
        # the work the kernel issues: each 8-column group's window of taps
        windows = osconv.tap_windows_plain(w).cpu()
        cols = torch.tensor([min(8, c_out - 8 * g) for g in range(len(windows))])
        issued_flops = 2 * BATCH * SCP2["length"] * c_in * int(((windows[:, 1] - windows[:, 0]) * cols).sum())
        conv_bytes = 4 * (x_pad.numel() + w.numel() + y.numel())
        fused_bytes = conv_bytes + 4 * 2 * c_out
        row = {
            "layer": name, "c_in": c_in, "c_out": c_out, "k": k, "relu": relu,
            "live_tap_share": live_taps / (k * c_out),
            "gflop": flops / 1e9, "dense_gflop": dense_flops / 1e9,
            "issued_gflop": issued_flops / 1e9,
            "max_abs": err, "rel": rel,
            "fused_max_abs": max(e[0] for e in errs_f), "fused_rel": max(e[1] for e in errs_f),
            "library_rel_vs_kernel": lib_err,
            "kernel_ms": cuda_ms(lambda: osconv.os_conv(x_pad, w)),
            "fused_ms": cuda_ms(lambda: osconv.os_conv_fused(x_pad, w, scale, shift, relu)),
            "plain_ms": cuda_ms(lambda: osconv.os_conv_plain(x_pad, w), reps=5),
            "fused_plain_ms": cuda_ms(
                lambda: osconv.os_conv_fused_plain(x_pad, w, scale, shift, relu), reps=5
            ),
            "library_ms": cuda_ms(lambda: F.conv1d(x_ncw, w_oik)),
            "kernel_single_call_ms": single_call_ms(lambda: osconv.os_conv(x_pad, w)),
            "library_single_call_ms": single_call_ms(lambda: F.conv1d(x_ncw, w_oik)),
            "flop_ms": flops / FP32_PEAK * 1e3,
            "tc_flop_ms": TF32_PRODUCTS * flops / TC_PEAK * 1e3,
            "bytes_ms": conv_bytes / HBM_RATE * 1e3,
            "fused_bytes_ms": fused_bytes / HBM_RATE * 1e3,
        }
        row["bound_ms"] = max(row["tc_flop_ms"], row["bytes_ms"])
        row["fused_bound_ms"] = max(row["tc_flop_ms"], row["fused_bytes_ms"])
        row["fp32_bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
        row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9  # live taps only
        row["kernel_issued_tflops"] = issued_flops / row["kernel_ms"] / 1e9
        row["kernel_dense_tflops"] = dense_flops / row["kernel_ms"] / 1e9
        row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
        log("kernel " + json.dumps(row))
        check(rel <= REL_TOL, f"{name}: os_conv_fwd rel err {rel:.3e} > {REL_TOL}")
        check(row["fused_rel"] <= REL_TOL, f"{name}: os_conv_fused_fwd rel err {row['fused_rel']:.3e}")
        rows.append(row)
    return rows


# -------------------------------------------------------------- phases 3-5 --

# phase 4: the run-axis calls' grid limit lowered to this many rows a launch, so that the
# ensemble's 3 members over a split of n series take two launches a layer (2 n here)
ENSEMBLE_SPLIT_ROWS = 2


def ensemble_vmap_phase(osconv, wn_fused, ens, members, stacked, weights, splits, n_layers: int,
                        fused: bool) -> dict:
    """Phase 4's members under one ``torch.func.vmap``: on each split, the
    vmapped ``member_logits`` the same bits as the members' own
    ``predict_logits`` calls, with one run-axis launch a layer against one a
    member and layer; the same bits again with the calls split on the host
    past a lowered grid limit (``osconv.GRID_Z``: two launches a layer); the
    run-axis calls of the test split timed against the members' one-run
    calls, the plain version and (unfused) a grouped ``F.conv1d``
    (``run_axis_rows``); the series/s of the vote over the members one
    after another, the form before the vmap, in the same run."""
    from feature_level_style_transfer_for_tsc_tpu_torch.evaluation.voting import (
        entropy_precision_vote,
    )

    runs_name = "os_conv_fused_fwd_runs" if fused else "os_conv_fwd_runs"
    one_name = "os_conv_fused_fwd" if fused else "os_conv_fwd"
    model, m = ens.model_def, len(members)
    out = {"members": m}
    for split, x in splits:
        osconv.reset_launch_counts()
        got = ens.member_logits(stacked, x)
        torch.cuda.synchronize()
        vmap_launches = dict(osconv.LAUNCHES)
        osconv.reset_launch_counts()
        each = torch.stack([model.predict_logits(mb["params"], mb["mstate"], x) for mb in members])
        torch.cuda.synchronize()
        loop_launches = dict(osconv.LAUNCHES)
        limit = ENSEMBLE_SPLIT_ROWS * len(x)
        osconv.reset_launch_counts()
        with patched(osconv, "GRID_Z", limit):
            split_calls = ens.member_logits(stacked, x)
        torch.cuda.synchronize()
        chunks = len(osconv.run_chunks(m, len(x), limit))
        out[split] = {"vmap_launches": vmap_launches[runs_name],
                      "one_run_launches": loop_launches[one_name],
                      "same_bits": torch.equal(got, each),
                      "split_launches": osconv.LAUNCHES[runs_name], "chunks": chunks,
                      "split_same_bits": torch.equal(split_calls, got)}
        log(f"[ensemble vmap {runs_name} {split}] {json.dumps(out[split])}")
        check(vmap_launches == {**{n: 0 for n in osconv.LAUNCHES}, runs_name: n_layers},
              f"ensemble vmap {split}: launches {vmap_launches}")
        check(loop_launches[one_name] == m * n_layers,
              f"ensemble members one by one, {split}: launches {loop_launches}")
        check(out[split]["same_bits"], f"ensemble vmap {split}: logits differ from the members' "
              f"own calls, max abs {(got - each).abs().max().item():.3e}")
        check(chunks == 2 and out[split]["split_launches"] == chunks * n_layers
              and out[split]["split_same_bits"],
              f"ensemble vmap {split}, split past the grid limit: {out[split]}")
    with recorded_calls(osconv, ["os_conv_fused_runs" if fused else "os_conv_runs"],
                        every=True) as calls:
        ens.member_logits(stacked, splits[-1][1])
    rows = run_axis_rows(osconv, wn_fused, {} if fused else calls["os_conv_runs"],
                         calls["os_conv_fused_runs"] if fused else {},
                         {"wn_fwd_runs": {}, "wn_bwd_runs": {}})[runs_name]
    out["rows"] = rows
    out["ms"] = sum(r["ms"] for r in rows)
    out["one_run_calls_ms"] = sum(r["one_run_calls_ms"] for r in rows)
    out["ratio"] = out["ms"] / out["one_run_calls_ms"]
    x_test = splits[-1][1]
    out["loop_series_per_s"] = series_per_s(lambda: entropy_precision_vote(
        torch.stack([model.predict_logits(mb["params"], mb["mstate"], x_test) for mb in members]),
        weights, ens.voting).cpu(), len(x_test))
    log(f"[ensemble vmap {runs_name}] the test split's {len(rows)} run-axis calls {out['ms']:.3f} "
        f"ms against {m} one-run calls each {out['one_run_calls_ms']:.3f} ms "
        f"(ratio {out['ratio']:.3f})")
    return out


def with_random_bn(tree, rng: np.random.Generator, bn_stats_type, key: str = ""):
    """``tree`` with non-trivial BatchNorm state, so the folded epilogue has
    work to do: running means 0.3*N(0, 1), variances in [0.5, 2], BN scales
    in [0.5, 1.5] and BN biases 0.3*N(0, 1); every other leaf unchanged."""

    def draw(like, fn):
        return torch.as_tensor(fn(like.shape), dtype=like.dtype, device=like.device)

    if isinstance(tree, bn_stats_type):
        return bn_stats_type(
            draw(tree.mean, lambda s: 0.3 * rng.standard_normal(s)),
            draw(tree.var, lambda s: rng.uniform(0.5, 2.0, s)),
        )
    if isinstance(tree, dict):
        return {k: with_random_bn(v, rng, bn_stats_type, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [with_random_bn(v, rng, bn_stats_type, key) for v in tree]
    if key.endswith("bn_scale"):
        return draw(tree, lambda s: rng.uniform(0.5, 1.5, s))
    if key.endswith("bn_bias"):
        return draw(tree, lambda s: 0.3 * rng.standard_normal(s))
    return tree


def write_dataset(root: Path, name: str, splits, write_ts_file):
    for split, (x, y) in splits.items():
        write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y, problem=name)


def cli_args(root, target, source_root, source, ckpts, out, vote="entropy_precision"):
    return [
        "--target-root", str(root), "--target", target,
        "--source-root", str(source_root), "--source", source,
        "--checkpoint", ",".join(str(c) for c in ckpts), "--out", str(out),
        "--vote", vote, "--device", "cuda",
    ]



# ------------------------------------------------------------------ phase 6 --

def wn_work(b: int, t: int, h: int, c: int, n_layers: int) -> dict:
    """FLOPs and bytes of one ``wn_fwd`` and one ``wn_bwd`` call: the products
    of ``_wn_fwd_kernel``'s and ``_wn_bwd_kernel``'s bodies that these inputs
    need (a tap whose read crosses a series boundary reads zero and is not
    counted; the last layer's res/skip is C x C), each input read once and
    each output written once."""
    rows = b * t
    taps = [rows + 2 * b * max(t - 2 ** i, 0) for i in range(n_layers)]  # live tap rows
    rs = [2 * c if i < n_layers - 1 else c for i in range(n_layers)]
    z = sum(2 * tr * c * 2 * c for tr in taps) + n_layers * 2 * rows * h * 2 * c
    fwd = 2 * rows * h * c + z + sum(2 * rows * c * n for n in rs) + 2 * rows * c * 2 * h
    bwd = (
        2 * rows * 2 * h * c  # g_skip
        + z  # the recomputed z
        + sum(2 * 2 * rows * c * n for n in rs)  # g_acts and gwr
        + sum(2 * 2 * tr * c * 2 * c for tr in taps)  # gwi and the transposed taps
        + n_layers * 2 * 2 * rows * h * 2 * c  # gwc and g_x
        + 2 * 2 * rows * h * c  # gws and the start's input gradient
    )
    weights = h * c + c + h * 2 * c * n_layers + 2 * c * n_layers + n_layers * 3 * c * 2 * c \
        + n_layers * 2 * c + n_layers * c * 2 * c + n_layers * 2 * c + c * 2 * h + 2 * h
    fwd_bytes = 4 * (rows * h + weights + rows * 2 * h + n_layers * rows * c + rows * c)
    bwd_bytes = 4 * (rows * h + rows * 2 * h + n_layers * rows * c + weights  # x, g, aud, weights
                     + rows * h + weights - c * 2 * h - 2 * h)  # gx and the weight grads
    return {"fwd_flops": fwd, "bwd_flops": bwd, "fwd_bytes": fwd_bytes, "bwd_bytes": bwd_bytes}


def random_wn(wn_init, wn_fused, weight_norm_weight, h, c, n_layers, seed):
    """Stacked effective WN weights on the card: random weight norm, and a
    non-zero end projection (the init's zero end would hide most of the
    backward)."""
    g = torch.Generator().manual_seed(seed)
    params = wn_init(g, h, n_layers, c)
    params["end"]["weight"] = 0.3 * torch.randn(c, 2 * h, generator=g)
    params["end"]["bias"] = 0.1 * torch.randn(2 * h, generator=g)
    for layer in params["in_layers"] + params["res_skip_layers"] + [params["start"], params["cond"]]:
        layer["g"] = layer["g"] * (0.5 + torch.rand(layer["g"].shape, generator=g))
    return [e.contiguous().cuda() for e in wn_fused.stack_effective(params, weight_norm_weight)]


def with_wn_ends(state, g: torch.Generator, scale: float = WN_END_SCALE):
    """``state`` (one run's, or K runs' stacked) with its WN end projections
    drawn as ``scale`` N(0, 1) from ``g``, each run its own draw: the init's
    zero end makes every layer gradient of the WN backward zero."""
    with torch.no_grad():
        for wn in state["params"]["nf"]["wn"]:
            end = wn["end"]["weight"]
            end.copy_(scale * torch.randn(end.shape, generator=g))
    return state


# A torch.profiler window that kept fewer launches than the wrappers made is taken again, up to
# this many windows in all.  On an H100 fresh processes' windows lost a contiguous third of their
# device events (experiments/wn_time.py: the f32 wn_fwd at VendGunPoint, wn_bwd[bf16] at pair),
# twice in about 100 windows, in code whose launches other windows counted exactly.  The checks
# that read a window (check_breakdown, profile_step) still need one that kept every launch.
PROFILE_ATTEMPTS = 3


def kernel_breakdown(fn, calls: int = 3, expected: dict | None = None) -> dict:
    """Device ms and launches a call of ``fn`` by ``__global__`` kernel
    (``torch.profiler``, ``calls`` calls after a warm-up), largest first.
    With ``expected`` (``check_breakdown``'s), a window whose launches
    differ is logged and taken again (PROFILE_ATTEMPTS)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in device_events(prof):
            row = out.setdefault(kernel_name(e.key), {"ms": 0.0, "launches": 0})
            row["ms"] += e.self_device_time_total / 1e3 / calls
            row["launches"] += e.count / calls
        out = dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))
        if expected is None or launches_by_base(out, expected) == expected:
            break
        log(f"profiler window {attempt + 1} kept launches a call "
            f"{ {k: v['launches'] for k, v in out.items()} }, expected {expected}")
    return out


def launches_by_base(by_kernel: dict, expected: dict) -> dict:
    """The launches a call of each kernel of ``expected`` (name without
    template arguments) in ``by_kernel``, its instances summed."""
    got = {name: 0.0 for name in expected}
    for key, row in by_kernel.items():
        base = key.split("<", 1)[0]
        if base in got:
            got[base] += row["launches"]
    return got


def device_events(prof) -> list:
    """The profile's device work by key (the event's name): CUDA events with
    device time, as ``key_averages()`` gives them (``key``, ``count``,
    ``self_device_time_total`` in us), less the ranges of host annotations
    (``record_function``, the optimizer's step), which show on the device
    timeline too and span kernels counted on their own.  Summed from the
    profile's raw events: ``key_averages()`` first builds every host op's
    event tree, which took about 42 s a traced phase-5 step on the card's
    host (K = 1 or 8 alike), for the same sums."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.is_async()
                or e.start_thread_id() != e.end_thread_id()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        row = rows.setdefault(e.name(), types.SimpleNamespace(
            key=e.name(), count=0, self_device_time_total=0.0))
        row.count += 1
        row.self_device_time_total += e.duration_ns() / 1e3
    return [r for r in rows.values() if r.self_device_time_total > 0]


def kernel_name(key: str) -> str:
    """A profiler key's kernel name, without ``void``, namespaces and
    arguments (template arguments kept)."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(", 1)[0].split("::")[-1]


def check_breakdown(what: str, by_kernel: dict, expected: dict) -> dict:
    """The launches a call of each ``__global__`` kernel of ``expected``
    (name without template arguments: count, ``wn_fused.global_kernels``)
    in ``by_kernel`` (``kernel_breakdown``): checked equal, so they add up
    to the entry's ``global_launches``."""
    got = launches_by_base(by_kernel, expected)
    check(got == expected, f"{what}: launches a call by kernel {got} != {expected}")
    return got


def wn_phase(wn_fused, wn_init, weight_norm_weight, cases, c: int, n_layers: int):
    """``wn_fwd``/``wn_bwd`` against their plain versions at each of
    ``cases``, (what, B, T, n_half)."""
    rows_out = []
    for what, b, t, h in cases:
        rows = b * t
        eff = random_wn(wn_init, wn_fused, weight_norm_weight, h, c, n_layers, seed=b + h)
        gen = torch.Generator(device="cuda").manual_seed(b)
        x2 = torch.randn(rows, h, device="cuda", generator=gen)
        g2 = torch.randn(rows, 2 * h, device="cuda", generator=gen)
        got = wn_fused.wn_fwd(x2, *eff, t)
        twice = wn_fused.wn_fwd(x2, *eff, t)
        want = wn_fused.wn_fwd_plain(x2, *eff, t)
        fwd_err = [rel_err(a, w) for a, w in zip(got, want)]
        fwd_same = all(torch.equal(a, b_) for a, b_ in zip(got, twice))
        _, aud, skip = want
        bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
        grads = wn_fused.wn_bwd(*bwd_args)
        again = wn_fused.wn_bwd(*bwd_args)
        plain = wn_fused.wn_bwd_plain(*bwd_args)
        bwd_err = [rel_err(a, w) for a, w in zip(grads, plain)]
        same_bits = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
        torch.cuda.synchronize()
        names = ("gx", "gws", "gbs", "gwc", "gbc", "gwi", "gbi", "gwr", "gbr", "gwe", "gbe")
        work = wn_work(b, t, h, c, n_layers)
        row = {
            "shape": what, "rows": rows, "t": t, "n_half": h, "c": c, "layers": n_layers,
            "fwd_rel": {k: e[1] for k, e in zip(("y", "aud", "skip"), fwd_err)},
            "bwd_rel": {k: e[1] for k, e in zip(names, bwd_err)},
            "fwd_max_abs": max(e[0] for e in fwd_err), "bwd_max_abs": max(e[0] for e in bwd_err),
            "fwd_deterministic": fwd_same, "bwd_deterministic": same_bits,
            "fwd_ms": cuda_ms(lambda: wn_fused.wn_fwd(x2, *eff, t), reps=5),
            "fwd_plain_ms": cuda_ms(lambda: wn_fused.wn_fwd_plain(x2, *eff, t), reps=3),
            "bwd_ms": cuda_ms(lambda: wn_fused.wn_bwd(*bwd_args), reps=5),
            "bwd_plain_ms": cuda_ms(lambda: wn_fused.wn_bwd_plain(*bwd_args), reps=3),
            **work,
            "global_launches_per_call": wn_fused.global_launches(n_layers),
        }
        for d in ("fwd", "bwd"):
            row[f"{d}_flop_ms"] = work[f"{d}_flops"] / FP32_PEAK * 1e3
            row[f"{d}_tc_flop_ms"] = TF32_PRODUCTS * work[f"{d}_flops"] / TC_PEAK * 1e3
            row[f"{d}_bytes_ms"] = work[f"{d}_bytes"] / HBM_RATE * 1e3
            row[f"{d}_bound_ms"] = max(row[f"{d}_tc_flop_ms"], row[f"{d}_bytes_ms"])
            row[f"{d}_fp32_bound_ms"] = max(row[f"{d}_flop_ms"], row[f"{d}_bytes_ms"])
            row[f"{d}_tflops"] = work[f"{d}_flops"] / row[f"{d}_ms"] / 1e9
        kernels = wn_fused.global_kernels(n_layers)
        row["fwd_by_kernel"] = kernel_breakdown(lambda: wn_fused.wn_fwd(x2, *eff, t),
                                                expected=kernels["wn_fwd"])
        row["bwd_by_kernel"] = kernel_breakdown(lambda: wn_fused.wn_bwd(*bwd_args),
                                                expected=kernels["wn_bwd"])
        for d in ("fwd", "bwd"):
            row[f"{d}_launches_by_kernel"] = check_breakdown(
                f"wn_{d} {what}", row[f"{d}_by_kernel"], kernels[f"wn_{d}"])
        log("wn " + json.dumps(row))
        check(max(row["fwd_rel"].values()) <= WN_FWD_REL_TOL, f"wn_fwd {what}: rel err {row['fwd_rel']}")
        check(fwd_same, f"wn_fwd {what}: two runs gave different bits")
        check(max(row["bwd_rel"].values()) <= WN_BWD_REL_TOL, f"wn_bwd {what}: rel err {row['bwd_rel']}")
        check(same_bits, f"wn_bwd {what}: two runs gave different bits")
        rows_out.append(row)
    return rows_out


# ------------------------------------------------------------------ phase 7 --

def osconv_grad_phase(osconv, layers):
    """dx and dw of the conv through ``OSConvCore`` (the kernel forward, the
    transposed-conv backward) against autograd of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for name, c_in, c_out, k, mask, _ in layers:
        x_pad = torch.randn(BATCH, SCP2["length"] + k - 1, c_in, device="cuda", generator=gen)
        w = torch.randn(k, c_in, c_out, device="cuda", generator=gen) / math.sqrt(c_in * k) * mask
        gy = torch.randn(BATCH, SCP2["length"], c_out, device="cuda", generator=gen)
        grads = []
        for fn in (osconv.OSConvCore.apply, osconv.os_conv_plain):
            xg, wg = x_pad.clone().requires_grad_(True), w.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(xg, wg), (xg, wg), gy))
        (dx, dw), (dx_p, dw_p) = grads
        row = {"layer": name, "dx_rel": rel_err(dx, dx_p)[1], "dw_rel": rel_err(dw, dw_p)[1],
               "dw_nonzero": bool(dw.abs().max() > 0)}
        log("osconv grad " + json.dumps(row))
        check(row["dw_nonzero"], f"{name}: the conv weight got no gradient on the card")
        check(row["dx_rel"] <= REL_TOL, f"{name}: dx rel err {row['dx_rel']:.3e}")
        check(row["dw_rel"] <= GRAD_REL_TOL, f"{name}: dw rel err {row['dw_rel']:.3e}")
        out.append(row)
    return out


# -------------------------------------------------------------- phases 8-9 --

def profile_step(pipe, state, batch) -> dict:
    """One phase-5 step traced by ``torch.profiler`` (a warm-up step first):
    the device time by kernel, and the share of the traced step's wall time
    (host clock around the step, inside the same profiler window) in which
    no kernel ran; then the same step untraced, for the profiler's cost.
    Checked complete: the profile keeps each WN ``__global__`` kernel's
    launches as often as the wrappers' counts (``wn_fused.LAUNCHES``) and
    ``wn_fused.global_kernels`` say the step launched it."""
    from torch.profiler import ProfilerActivity, profile

    from feature_level_style_transfer_for_tsc_tpu_torch.ops import wn_fused

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.phase5_step(state, *batch, 0, cpc_anchors=ANCHORS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    step()
    layers = pipe.config.flow.wn_layers
    wn_names = {k for bf16 in (False, True) for e in wn_fused.global_kernels(layers, bf16).values()
                for k in e}
    for attempt in range(PROFILE_ATTEMPTS):  # a window that lost launches is taken again
        before = dict(wn_fused.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_ms = step()
        calls = {k: n - before[k] for k, n in wn_fused.LAUNCHES.items() if n > before[k]}
        want = {}
        for entry, n in calls.items():
            per_entry = wn_fused.global_kernels(layers, entry.endswith("[bf16]"))
            for k, per_call in per_entry[entry.split("[")[0].removesuffix("_runs")].items():
                want[k] = want.get(k, 0) + n * per_call
        kernels = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count) for e in device_events(prof)),
            key=lambda k: -k[1],
        )
        kept = {k: 0 for k in want}
        groups = {"wn kernels": 0.0, "os_conv kernel": 0.0, "other": 0.0}
        for name, ms, count in kernels:
            base = kernel_name(name).split("<", 1)[0]
            if base in want:
                kept[base] += count
            # the fused route runs the tap GEMM (prep and main kernel) only for the OS conv
            groups["wn kernels" if base in wn_names else
                   "os_conv kernel" if "tap_gemm" in name else "other"] += ms
        if kept == want:
            break
        log(f"profiler window {attempt + 1} of the phase-5 step kept WN launches {kept}, "
            f"launched {want}")
    untraced_ms = step()
    device_ms = sum(groups.values())
    out = {"device_ms": device_ms, "traced_wall_ms": traced_ms,
           "device_idle_share": 1.0 - device_ms / traced_ms, "untraced_wall_ms": untraced_ms,
           "by_group_ms": groups, "wn_calls": calls, "wn_launches_kept": kept,
           "top": [{"kernel": n[:90], "ms": ms, "calls": c} for n, ms, c in kernels[:12]]}
    log(f"[profiled phase-5 step] device ms={device_ms:.1f} traced wall ms={traced_ms:.1f} "
        f"idle share={out['device_idle_share']:.3f} untraced wall ms={untraced_ms:.1f} by group="
        f"{ {k: round(v, 1) for k, v in groups.items()} }; WN launches kept {kept}")
    for row in out["top"]:
        log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
    check(bool(want) and kept == want,
          f"profiled phase-5 step: WN launches kept {kept}, launched {want} ({calls} calls)")
    return out


def expected_training_launches(pipe, n_series: int, epochs: dict, op_by_op: bool = False) -> dict:
    """Launches of a training drive, derived from the pipeline's code:
    one ``os_conv_fwd`` per OS layer applied; per flow step of each WN
    forward one ``wn_fwd`` (fused route) or one ``gate_fwd`` and one
    ``tap_conv_fwd`` per WN layer (op-by-op route); per WN node per backward
    pull that reaches it (phase 4: the loss; phase 5: the total 2F,
    t_nf+s_nf F, t_c+s_c 0, s2t2s_c 2F, with F flows) one ``wn_bwd`` or one
    ``tap_conv_fwd`` per WN layer (the input gradient of its dilated conv;
    the gate's backward is plain PyTorch)."""
    te, cl, se = len(pipe.t_ext_specs), len(pipe.cls_specs), len(pipe.s_ext_specs)
    flows = pipe.config.flow.n_flows
    nb = math.ceil(n_series / BATCH)  # batches per epoch, both domains
    ev = 2 * nb  # eval batches of a domain: train and test splits
    ev_t, ev_s = ev * (te + cl), ev * (se + cl)
    e = epochs
    sup4 = math.ceil(e["p4"] / pipe.config.nf_supervised_every)  # phase 4's supervised epochs
    conv = (
        e["p1"] * (nb * (te + cl) + ev_t)
        + e["p2"] * (nb * (se + cl) + ev_s)
        + e["p3"] * (nb * (te + se + 2 * cl) + ev_t + ev_s)
        + sup4 * (nb * (te + se + 2 * cl) + ev_t + ev_s)
        + (e["p4"] - sup4) * nb * (te + se)  # phase 4, unsupervised
        + e["p5"] * nb * (te + se + 3 * cl)
        + math.ceil(e["p5"] / pipe.config.eval_every) * (ev_t + ev_s)
    )
    forwards = e["p4"] * nb * flows + e["p5"] * nb * 2 * flows
    pulls = e["p4"] * nb * flows + e["p5"] * nb * 5 * flows
    if op_by_op:
        layers = pipe.config.flow.wn_layers
        wn = {"wn_fwd": 0, "wn_bwd": 0, "gate_fwd": layers * forwards,
              "tap_conv_fwd": layers * (forwards + pulls)}
    else:
        wn = {"wn_fwd": forwards, "wn_bwd": pulls, "gate_fwd": 0, "tap_conv_fwd": 0}
    return {"os_conv_fwd": conv, "os_conv_fused_fwd": 0, **wn}


def tree_to(tree, device):
    """A detached copy of a tree of dicts, lists and NamedTuples on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree


def cpu_state(state):
    """What ``phase5_grads`` reads of a training state, on the CPU."""
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import leaves

    params = tree_to(state["params"], "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    gradnorm = {k: types.SimpleNamespace(weights=v.weights.detach().cpu())
                for k, v in state["gradnorm"].items()}
    return {"params": params, "mstate": tree_to(state["mstate"], "cpu"),
            "consts": tree_to(state["consts"], "cpu"), "gradnorm": gradnorm,
            "generator": torch.Generator()}


def phase5_once(pipe, state, batch, masks, gradnorm_step, ctx, card_gradnorm):
    """One phase-5 forward and its merged pulls, pinned: the 9 losses, the
    gradients of the total, n_t, n_s (on the card), and the new GradNorm
    weights from a copy of ``card_gradnorm`` (the state's, on the card)."""
    with ctx:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, _, _, grads, n_t, n_s = pipe.phase5_grads(
            state, *batch, epoch=0, cpc_anchors=ANCHORS, dropout_masks=masks
        )
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0

    def card(v):
        return None if v is None else v.detach().cuda()

    losses = {k: card(v) for k, v in losses.items()}
    grads = {k: [card(g) for g in gs] for k, gs in grads.items()}
    n_t, n_s = card(n_t), card(n_s)
    gn = copy.deepcopy(card_gradnorm)
    vec = torch.stack([losses[k] for k in ("t_nf", "t_c", "s_nf", "s_c", "s2t2s_c")])
    g = pipe.config.gradnorm
    gradnorm_step(gn["t"], vec[:2], n_t, alpha=g.alpha, weight_sum=g.weights_t_sum)
    gradnorm_step(gn["s"], vec[2:], n_s, alpha=g.alpha, weight_sum=g.weights_s_sum)
    return {"losses": losses, "grads": grads, "n_t": n_t, "n_s": n_s,
            "w_t": gn["t"].weights, "w_s": gn["s"].weights, "secs": secs}


def phase5_gap(k, p) -> dict:
    """How far run ``k`` is from run ``p``: rel errors of the losses, the
    trunk norms and the GradNorm weights, and per module the relative L2
    distance of the gradients (``grad_l2_rel``) and the largest gradient
    difference over that module's own max|g| (``grad_rel``)."""
    row = {"loss_rel": {n: rel_err(k["losses"][n], p["losses"][n])[1] for n in k["losses"]},
           "n_t_rel": rel_err(k["n_t"], p["n_t"])[1], "n_s_rel": rel_err(k["n_s"], p["n_s"])[1],
           "w_t_rel": rel_err(k["w_t"], p["w_t"])[1], "w_s_rel": rel_err(k["w_s"], p["w_s"])[1],
           "losses": {n: float(v) for n, v in k["losses"].items()},
           "grad_l2_rel": {}, "grad_rel": {}, "grad_max": {}}
    for name, gs in p["grads"].items():
        pairs = [(a, b) for a, b in zip(k["grads"][name], gs) if b is not None]
        g_max = max((float(b.abs().max()) for _, b in pairs), default=0.0)
        diff = max((float((a - b).abs().max()) for a, b in pairs), default=0.0)
        d2 = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
        n2 = sum(float((b ** 2).sum()) for _, b in pairs)
        row["grad_max"][name] = g_max
        row["grad_rel"][name] = diff / g_max if g_max > 0 else diff
        row["grad_l2_rel"][name] = math.sqrt(d2 / n2) if n2 > 0 else math.sqrt(d2)
    return row


def pinned_masks():
    """The CDAN dropout multipliers of the phase-5 comparisons, on the CPU
    and on the card."""
    masks = [[(torch.rand(BATCH, 1024, generator=torch.Generator().manual_seed(i)) >= 0.2).float()
              / 0.8 for i in (2 * j, 2 * j + 1)] for j in range(2)]
    return masks, [[m.cuda() for m in pair] for pair in masks]


def phase5_against_plain(pipe, state, batch, osconv, wn_fused, gate, gradnorm_step, smi,
                         checked=True, cpu_pipe=None):
    """One full-width phase-5 step of ``state`` with the kernels and with the
    plain versions on the card, randomness pinned: the 9 losses, n_t, n_s,
    the new GradNorm weights and the gradients of the total.  Checked
    against the tolerances when ``gate``, else only measured.  Measured
    beside it: the step with only the WN kernels and with only the OS conv
    kernel on, and, with ``cpu_pipe``, the plain versions on the CPU, each
    held against the card's plain run (the last a witness of how far
    another summation order alone moves the same step).

    Gated on the step with only the WN kernels on: every module's
    gradients within GRAD_REL_TOL, as relative L2 distance and as largest
    difference over the module's own max|g|.  Gated on the step with every
    kernel on: the losses, trunk norms and GradNorm weights, and each
    module's relative L2 distance within STEP_GRAD_L2_TOL, which leaves room
    for the OS-CNN modules' sensitivity to the last bits of the conv
    outputs (a ReLU input within rounding of zero switches between two
    correct runs); the WN kernels' share is held to the tighter gate."""
    masks, card_masks = pinned_masks()
    flows = pipe.config.flow.n_flows
    convs = len(pipe.t_ext_specs) + len(pipe.s_ext_specs) + 3 * len(pipe.cls_specs)

    def once(ctx, p=pipe, s=state, b=batch, m=card_masks):
        return phase5_once(p, s, b, m, gradnorm_step, ctx, state["gradnorm"])

    for m in (osconv, wn_fused, gate):
        m.reset_launch_counts()
    kern = once(contextlib.nullcontext())
    launched = {**osconv.LAUNCHES, **wn_fused.LAUNCHES, **gate.LAUNCHES}  # one forward, 4 pulls
    want = {**RUN_AXIS_IDLE, **BF16_IDLE, "os_conv_fwd": convs, "os_conv_fused_fwd": 0,
            "tap_conv_fwd": 0, "wn_fwd": 2 * flows, "wn_bwd": 5 * flows, "gate_fwd": 0}
    check(launched == want, f"phase-5 step launches {launched} != {want}")
    plain = once(plain_convs(osconv, wn_fused, gate))
    row = phase5_gap(kern, plain)
    row["grads_and_norms_s"] = {"kernel": kern["secs"], "plain": plain["secs"]}
    log(f"[phase-5 step, kernels vs plain on the card, {'checked' if checked else 'measured'}] "
        f"{json.dumps(row)} on {smi}")
    alone = {"wn kernels only": plain_convs(osconv, wn_fused, gate, wn=False),
             "os_conv kernel only": plain_convs(osconv, wn_fused, gate, convs=False)}
    for what, ctx in alone.items():
        gap = phase5_gap(once(ctx), plain)
        row[what] = {key: gap[key] for key in ("loss_rel", "grad_l2_rel", "grad_rel")}
        gated = checked and what == "wn kernels only"
        log(f"[phase-5 step, {what} vs plain on the card, {'checked' if gated else 'measured'}] "
            f"{json.dumps(row[what])}")
    if cpu_pipe is not None:
        on_cpu = once(contextlib.nullcontext(), cpu_pipe, cpu_state(state),
                      [b.cpu() for b in batch], masks)
        row["cpu_plain_vs_card_plain"] = phase5_gap(on_cpu, plain)
        row["grads_and_norms_s"]["cpu_plain"] = on_cpu["secs"]
        log(f"[phase-5 step, plain on the CPU ({on_cpu['secs']:.1f} s) vs plain on the card, "
            f"measured] {json.dumps(row['cpu_plain_vs_card_plain'])}")
    if not checked:
        return row
    for n in ("n_t", "n_s"):
        check(bool(torch.isfinite(kern[n]).all()), f"phase-5 {n} is not finite")
    for n, v in row["loss_rel"].items():
        check(math.isfinite(row["losses"][n]), f"phase-5 loss {n} is not finite")
        check(v <= REL_TOL, f"phase-5 loss {n}: rel err {v:.3e} against plain")
    for n in ("n_t_rel", "n_s_rel"):
        check(row[n] <= GRAD_REL_TOL, f"phase-5 {n} {row[n]:.3e}")
    for n in ("w_t_rel", "w_s_rel"):
        check(row[n] <= REL_TOL, f"phase-5 GradNorm {n} {row[n]:.3e}")
    for n, v in row["grad_l2_rel"].items():
        check(v <= STEP_GRAD_L2_TOL, f"phase-5 grads of the total, {n}: relative L2 distance {v:.3e}")
    wn_only = row["wn kernels only"]
    for metric in ("grad_l2_rel", "grad_rel"):
        for n, v in wn_only[metric].items():
            check(v <= GRAD_REL_TOL, f"phase-5 grads with the WN kernels only, {n}: {metric} {v:.3e}")
    return row


# ----------------------------------------------------------------- phase 12 --

def gate_operands(rows: int, c: int, n_layers: int, gen: torch.Generator):
    """The gate's ``a`` (rows, 2C) and ``b``, layer 3's column slice of a
    (rows, 2*C*L) cond projection, whose rows are 2*C*L floats apart."""
    a = torch.randn(rows, 2 * c, device="cuda", generator=gen)
    spect = torch.randn(rows, 2 * c * n_layers, device="cuda", generator=gen)
    return a, spect[:, 2 * c * 3 : 2 * c * 4]


def gate_sets(rows: int, c: int, n_layers: int, gen: torch.Generator):
    """Enough ``gate_operands`` sets to exceed twice the L2, and the bytes
    one call must move (a and b read once, out written once)."""
    n_bytes = 4 * (2 * rows * 2 * c + rows * c)
    return [gate_operands(rows, c, n_layers, gen)
            for _ in range(int(2 * L2_BYTES // n_bytes) + 2)], n_bytes


def gate_phase(gate, c: int, n_layers: int):
    """``gate_fwd`` against ``gate_plain`` at the pair and infer rows of
    phase 5 (``gate_operands``), timed back to back on one input set
    (``ms``; the infer call's 55 MB nearly fit in L2) and over a rotation of
    sets that exceed twice the L2 (``rot_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []

    def call(a, b):
        return gate.gate_fwd(a, b, c)

    for what, b in (("pair", 2 * BATCH), ("infer", BATCH)):
        rows = b * SCP2["length"]
        sets, n_bytes = gate_sets(rows, c, n_layers, gen)
        a, b_view = sets[0]
        y = call(a, b_view)
        err, rel = rel_err(y, gate.gate_plain(a, b_view, c))
        torch.cuda.synchronize()
        row = {"shape": what, "rows": rows, "n": c, "max_abs": err, "rel": rel,
               "ms": cuda_ms(lambda: call(a, b_view), reps=20),
               "rot_ms": rotated_ms(call, sets), "rotated_sets": len(sets),
               "plain_ms": cuda_ms(lambda: gate.gate_plain(a, b_view, c), reps=20),
               "bytes_ms": n_bytes / HBM_RATE * 1e3,
               "flop_ms": GATE_OPS * rows * c / FP32_PEAK * 1e3}
        row["bound_ms"] = max(row["bytes_ms"], row["flop_ms"])
        row["gb_per_s"] = n_bytes / row["ms"] / 1e6
        row["rot_gb_per_s"] = n_bytes / row["rot_ms"] / 1e6
        log("gate " + json.dumps(row))
        check(rel <= REL_TOL, f"gate_fwd {what}: rel err {rel:.3e}")
        out.append(row)
    return out


def tap_conv_phase(osconv, c: int, n_layers: int):
    """``tap_conv_fwd`` against ``tap_conv_plain`` at every dilation of the
    pair pass (B=40, T=1152): the forward (x padded by d each side, C ->
    2C) and the input-gradient pass of ``TapConvCore`` (g padded by 2d each
    side, 2C -> C), beside ``F.conv1d`` with ``dilation``; then
    ``TapConvCore``'s dx and dw against autograd of the plain version."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    b, t = 2 * BATCH, SCP2["length"]
    rows = []
    for what, c_in, c_out, halo in (("fwd", c, 2 * c, 2), ("dx", 2 * c, c, 4)):
        for i in range(n_layers):
            d = 2 ** i
            x = torch.randn(b, t + halo * d, c_in, device="cuda", generator=gen)
            w = torch.randn(3, c_in, c_out, device="cuda", generator=gen) / math.sqrt(3 * c_in)
            y = osconv.tap_conv_fwd(x, w, d)
            err, rel = rel_err(y, osconv.tap_conv_plain(x, w, d))
            x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
            lib_rel = rel_err(F.conv1d(x_ncw, w_oik, dilation=d).transpose(1, 2), y)[1]
            torch.cuda.synchronize()
            flops = 2 * b * y.shape[1] * 3 * c_in * c_out
            n_bytes = 4 * (x.numel() + w.numel() + y.numel())
            row = {"pass": what, "dilation": d, "c_in": c_in, "c_out": c_out,
                   "rows_out": b * y.shape[1], "max_abs": err, "rel": rel,
                   "library_rel_vs_kernel": lib_rel,
                   "ms": cuda_ms(lambda: osconv.tap_conv_fwd(x, w, d)),
                   "plain_ms": cuda_ms(lambda: osconv.tap_conv_plain(x, w, d), reps=5),
                   "library_ms": cuda_ms(lambda: F.conv1d(x_ncw, w_oik, dilation=d)),
                   "single_call_ms": single_call_ms(lambda: osconv.tap_conv_fwd(x, w, d)),
                   "library_single_call_ms": single_call_ms(
                       lambda: F.conv1d(x_ncw, w_oik, dilation=d)),
                   "gflop": flops / 1e9, "issued_gflop": flops / 1e9,  # every tap is live
                   "flop_ms": flops / FP32_PEAK * 1e3,
                   "tc_flop_ms": TF32_PRODUCTS * flops / TC_PEAK * 1e3,
                   "bytes_ms": n_bytes / HBM_RATE * 1e3}
            row["bound_ms"] = max(row["tc_flop_ms"], row["bytes_ms"])
            row["fp32_bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
            row["tflops"] = flops / row["ms"] / 1e9
            row["ms_over_library"] = row["ms"] / row["library_ms"]
            log("tap_conv " + json.dumps(row))
            check(rel <= REL_TOL, f"tap_conv_fwd {what} d={d}: rel err {rel:.3e}")
            rows.append(row)
    grads = []
    for d in (1, 2 ** (n_layers - 1)):
        x = torch.randn(b, t + 2 * d, c, device="cuda", generator=gen)
        w = torch.randn(3, c, 2 * c, device="cuda", generator=gen) / math.sqrt(3 * c)
        gy = torch.randn(b, t, 2 * c, device="cuda", generator=gen)
        pair = []
        for fn in (osconv.tap_conv, osconv.tap_conv_plain):
            xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            pair.append(torch.autograd.grad(fn(xg, wg, d), (xg, wg), gy))
        (dx, dw), (dx_p, dw_p) = pair
        row = {"dilation": d, "dx_rel": rel_err(dx, dx_p)[1], "dw_rel": rel_err(dw, dw_p)[1]}
        log("tap_conv grad " + json.dumps(row))
        check(row["dx_rel"] <= REL_TOL, f"TapConvCore d={d}: dx rel err {row['dx_rel']:.3e}")
        check(row["dw_rel"] <= GRAD_REL_TOL, f"TapConvCore d={d}: dw rel err {row['dw_rel']:.3e}")
        grads.append(row)
    return rows, grads


# -------------------------------------------------------------- phases 8, 13 --

@contextlib.contextmanager
def watched_phase5(pipeline_cls):
    """Time every phase-5 step and keep the first step's losses: yields
    (step seconds, [first step's losses])."""
    step_s, first = [], []
    untimed = pipeline_cls.phase5_step

    def timed_step(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = untimed(self, *a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not first:
            first.append({k: float(v) for k, v in result[0].items()})
        return result

    pipeline_cls.phase5_step = timed_step
    try:
        yield step_s, first
    finally:
        pipeline_cls.phase5_step = untimed


def training_drive(run, train_cli, pipeline_cls, what: str, args, expect: dict, out: Path):
    """``cli.main`` through ``run.drive``, deterministic, with each phase-5
    step timed: finiteness as ``check_history`` and the JAX CLI's file set
    checked; (state, history, phase-5 step seconds, phase-5 record)."""
    with watched_phase5(pipeline_cls) as (step_s, first):
        with deterministic():
            state, history = run.drive(what, lambda: train_cli.main(args), expect, path="training")
    p5 = check_history(what, history, first[0])
    check_files(what, out)
    return state, history, step_s, p5


def resume_phase(run, train_cli, pipeline_cls, pipe, state, datasets, out: Path, args) -> dict:
    """``cli.main --resume`` on a copy of phase 8's out directory (its
    ``final_state.npz``, one phase-5 epoch) against ``pipe.run`` from a deep
    copy of the state phase 8 returned, both deterministic: the first
    phase-5 step's losses, taken before any update, and every key of the
    whole state after the epoch (``state_to_flat``: params, moments, counts,
    learning rates, schedulers, GradNorm, generator; NaN equal to NaN, as a
    truncated pretrain's flow can run away) must be the same bits."""
    memory = copy.deepcopy(state)
    resumed = out.with_name(out.name + "_resumed")
    shutil.copytree(out, resumed)
    expect = {**run.idle(), **expected_training_launches(pipe, TRAIN_SERIES, RESUME_EPOCHS)}
    with watched_phase5(pipeline_cls) as (_, from_file), deterministic():
        file_state, history = run.drive("training resumed",
                               lambda: train_cli.main(args(resumed, RESUME_EPOCHS) + ["--resume"]),
                               expect)
    with watched_phase5(pipeline_cls) as (_, from_memory), deterministic():
        memory_state, _ = pipe.run(*datasets, epochs=RESUME_EPOCHS, state=memory, seed=0,
                                   verbose=False)
    check(from_file[0] == from_memory[0],
          f"resumed from the file {from_file[0]} != from memory {from_memory[0]}")
    got, want = pipe.state_to_flat(file_state), pipe.state_to_flat(memory_state)
    differ = sorted(set(got) ^ set(want)) + sorted(
        k for k in set(got) & set(want) if not np.array_equal(got[k], want[k], equal_nan=True))
    check(not differ, f"resumed state from the file != from memory at {differ[:8]}")
    row = {"first_step_from_file": from_file[0], "first_step_from_memory": from_memory[0],
           "state_keys": len(want), "same_bits": not differ,
           "p5": check_history("training resumed", history, from_file[0])}
    log(f"[training resumed] first phase-5 step and all {len(want)} state keys the same bits "
        f"from the file and from memory: {json.dumps(from_file[0])}")
    return row


def check_history(what: str, history, first_step: dict) -> dict:
    """Every value logged in phases 1-4 and phase 5's evaluation, and every
    loss of phase 5's first step, must be finite.  Later in phase 5 a flow
    whose NF pretrain was cut this short can run away, the JAX package's as
    well (experiments/truncated_pretrain_runaway.py), so whether the logged
    phase-5 values stay finite is recorded and not checked."""
    p5_finite, p5_largest = True, 0.0
    for h in history:
        for key, v in h.items():
            if key in ("phase", "epoch"):
                continue
            finite = bool(np.all(np.isfinite(v)))
            if h["phase"] == "p5":
                p5_finite &= finite
                p5_largest = max(p5_largest, float(np.max(np.abs(v))) if finite else math.inf)
            else:
                check(finite, f"{what}: {key} not finite in {h}")
    for key, v in first_step.items():
        check(math.isfinite(v), f"{what}: phase 5's first step {key} = {v}")
    row = {"first_step": first_step, "p5_logged_finite": p5_finite, "p5_largest_abs": p5_largest}
    log(f"[{what}] phase 5, first step checked, the rest measured: {json.dumps(row)}")
    return row


def check_files(what: str, out: Path) -> None:
    """The files the JAX CLI writes for a run whose phase 5 evaluates once."""
    want = {"final_state.npz", "history.json", "log.jsonl", "epoch_0.npz",
            "epoch_0_source.npz", "feature_of_target_s2t", "feature_of_source_t2s"}
    want |= {f"p{i}_{side}_classifier_itself.npz" for i in range(1, 6)
             for side in ("target", "source")}
    have = {f.name for f in out.iterdir()}
    check(have == want, f"{what} wrote {sorted(have)}, want {sorted(want)}")


# ----------------------------------------------------------------- phase 10 --

def phase5_routes(pipe, state, batch, osconv, wn_fused, gate, gradnorm_step, smi) -> dict:
    """One full-width phase-5 step of ``state`` on the op-by-op route against
    the fused route, both with every kernel on (gated: losses within
    REL_TOL, the WN-carrying ``nf`` within GRAD_REL_TOL and every module
    within STEP_GRAD_L2_TOL, relative L2, as phase 9); and the op-by-op
    route's kernels against its plain versions on the card (all kernels:
    every module within STEP_GRAD_L2_TOL; the WN route's kernels alone:
    every module within GRAD_REL_TOL in both metrics)."""
    _, card_masks = pinned_masks()
    flows = pipe.config.flow.n_flows
    layers = pipe.config.flow.wn_layers
    convs = len(pipe.t_ext_specs) + len(pipe.s_ext_specs) + 3 * len(pipe.cls_specs)

    def once(*ctxs):
        return phase5_once(pipe, state, batch, card_masks, gradnorm_step, stacked(*ctxs),
                           state["gradnorm"])

    fused = once()
    for m in (osconv, wn_fused, gate):
        m.reset_launch_counts()
    op = once(environ(**OP_BY_OP))
    launched = {**osconv.LAUNCHES, **wn_fused.LAUNCHES, **gate.LAUNCHES}
    want = {**RUN_AXIS_IDLE, **BF16_IDLE, "os_conv_fwd": convs, "os_conv_fused_fwd": 0,
            "wn_fwd": 0, "wn_bwd": 0, "gate_fwd": layers * 2 * flows,
            "tap_conv_fwd": layers * (2 * flows + 5 * flows)}
    check(launched == want, f"op-by-op phase-5 step launches {launched} != {want}")
    plain = once(environ(**OP_BY_OP), plain_convs(osconv, wn_fused, gate))
    wn_only = once(environ(**OP_BY_OP), plain_convs(osconv, wn_fused, gate, wn=False))
    row = phase5_gap(op, fused)
    row["step_s"] = {"fused": fused["secs"], "op_by_op": op["secs"], "op_by_op_plain": plain["secs"]}
    row["launches"] = launched
    log(f"[phase-5 step, op-by-op vs fused route on the card, checked] {json.dumps(row)} on {smi}")
    for what, k in (("kernels", op), ("wn route kernels only", wn_only)):
        gap = phase5_gap(k, plain)
        row[f"op-by-op {what} vs plain"] = {key: gap[key] for key in ("loss_rel", "grad_l2_rel",
                                                                       "grad_rel")}
        log(f"[phase-5 step, op-by-op {what} vs op-by-op plain on the card, checked] "
            f"{json.dumps(row[f'op-by-op {what} vs plain'])}")
    for n, v in row["loss_rel"].items():
        check(math.isfinite(row["losses"][n]), f"op-by-op phase-5 loss {n} is not finite")
        check(v <= REL_TOL, f"op-by-op vs fused phase-5 loss {n}: rel err {v:.3e}")
    check(row["grad_l2_rel"]["nf"] <= GRAD_REL_TOL,
          f"op-by-op vs fused, nf gradients: relative L2 {row['grad_l2_rel']['nf']:.3e}")
    for gap in (row, row["op-by-op kernels vs plain"]):
        for n, v in gap["grad_l2_rel"].items():
            check(v <= STEP_GRAD_L2_TOL, f"op-by-op phase-5 grads, {n}: relative L2 {v:.3e}")
    for metric in ("grad_l2_rel", "grad_rel"):
        for n, v in row["op-by-op wn route kernels only vs plain"][metric].items():
            check(v <= GRAD_REL_TOL, f"op-by-op WN route kernels only, {n}: {metric} {v:.3e}")
    return row


# ----------------------------------------------------------------- phase 14 --

def vendored_drive(train_cli, pipeline_cls, modules, tmp: Path) -> dict:
    """``cli.main`` from disk on VendSCP2 <- VendEthanol (the reference
    main.py pair at its vendored lengths), fused route, reference budgets,
    ``VENDORED_EPOCHS``: n_half 72 runs through the WN kernels."""
    multi, uni = REPO / "datasets" / "Multivariate_ts", REPO / "datasets" / "Univariate_ts"
    out = tmp / "vend_run"
    args = ["--target-root", str(multi), "--target", "VendSCP2", "--source-root", str(uni),
            "--source", "VendEthanol", "--out", str(out), "--budget-multiplier", "1.0",
            "--phase-epochs", json.dumps(VENDORED_EPOCHS), "--device", "cuda"]
    for m in modules:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    with watched_phase5(pipeline_cls) as (_, first), deterministic():
        state, history = train_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: n for m in modules for name, n in m.LAUNCHES.items()}
    n_half = state["params"]["nf"]["wn"][0]["start"]["v"].shape[1]
    row = {"wall_s": wall, "launches": counts, "n_half": n_half,
           "last": {k: v for k, v in history[-1].items()}}
    log(f"[VendSCP2 <- VendEthanol] {json.dumps(row)}")
    check(n_half == 72, f"VendSCP2's WN half width {n_half}, want 72")
    check(counts["wn_fwd"] > 0 and counts["wn_bwd"] > 0, f"VendSCP2: WN kernels not run: {counts}")
    check(counts["gate_fwd"] == counts["tap_conv_fwd"] == 0, f"VendSCP2 left the fused route: {counts}")
    row["phase5"] = check_history("VendSCP2", history, first[0])
    check_files("VendSCP2", out)
    return row


# ----------------------------------------------------------------- phase 15 --

@contextlib.contextmanager
def watched_members(pipeline_cls):
    """Each ``run`` of a member pipeline: its wall time, phase-5 step times,
    first phase-5 step's losses and history; yields the list of runs."""
    runs = []
    untimed = pipeline_cls.run

    def run(self, *a, **kw):
        with watched_phase5(pipeline_cls) as (step_s, first):
            t0 = time.perf_counter()
            state, history = untimed(self, *a, **kw)
            torch.cuda.synchronize()
            runs.append({"wall_s": time.perf_counter() - t0, "phase5_step_s": step_s,
                         "first_step": first[0], "history": history})
        return state, history

    pipeline_cls.run = run
    try:
        yield runs
    finally:
        pipeline_cls.run = untimed


def multi_source_phase(run, ms_cli, predict, pipeline_cls, cfg, data: Path, target: str,
                       sources: dict, out: Path, smi: str) -> dict:
    """``cli.multi_source`` on the card: one member per source, full width,
    ``PHASE_EPOCHS``, deterministic; exact launches (each member's training
    drive plus the vote's member logits on the train and test splits);
    finiteness per member as ``check_history``; the JAX CLI's file set; and
    ``cli.predict`` over the saved members the same predictions, bit for bit."""
    c, t, n_cls = SCP2["channels"], SCP2["length"], SCP2["classes"]
    pipes = [pipeline_cls(c, t, n_cls, d["channels"], d["length"], d["classes"], cfg,
                          device="cuda") for d in sources.values()]
    expect = run.idle()
    for pipe in pipes:
        for name, k in expected_training_launches(pipe, TRAIN_SERIES, PHASE_EPOCHS).items():
            expect[name] += k
    member_convs = len(pipes[0].t_ext_specs) + len(pipes[0].cls_specs)
    # the vote: one run-axis launch a conv for the members, train split and test split
    expect["os_conv_fwd_runs"] += 2 * member_convs
    args = ["--target-root", str(data), "--target", target, "--source-root", str(data),
            "--sources", ",".join(sources), "--out", str(out),
            "--phase-epochs", json.dumps(PHASE_EPOCHS), "--device", "cuda"]
    with watched_members(pipeline_cls) as members, deterministic():
        result = run.drive("multi-source", lambda: ms_cli.main(args), expect)
    rows = {}
    for name, m in zip(sources, members):
        rows[name] = {"wall_s": m["wall_s"], "phase5_step_s": m["phase5_step_s"],
                      "phase5": check_history(f"member {name}", m["history"], m["first_step"])}
    want = {f"member_{name}.npz" for name in sources} | {
        "final_predict.npy", "true_label.npy", "prediction_strip.png", "ensemble.json"}
    have = {f.name for f in out.iterdir()}
    check(have == want, f"multi-source wrote {sorted(have)}, want {sorted(want)}")
    preds = np.load(out / "final_predict.npy")
    check(preds.shape == (TRAIN_SERIES,) and bool(np.all((preds >= 0) & (preds < n_cls))),
          f"multi-source predictions {preds.shape}")
    check(all(math.isfinite(v) for v in result["member_accs"])
          and bool(np.all(np.isfinite(result["class_weights"]))), "multi-source: non-finite vote")
    served = out.with_name(out.name + "_served")
    members_csv = ",".join(str(out / f"member_{name}.npz") for name in sources)
    predict.main(["--target-root", str(data), "--target", target, "--source-root", str(data),
                  "--source", next(iter(sources)), "--checkpoint", members_csv,
                  "--vote", "entropy_precision", "--out", str(served), "--device", "cuda"])
    check(np.array_equal(np.load(f"{served}_predict.npy"), preds),
          "cli.predict over the members differs from cli.multi_source's final_predict.npy")
    row = {"members": rows, "ensemble_acc": result["ensemble_acc"],
           "member_accs": result["member_accs"], "vote_variants": result["vote_variants"],
           "launches": run.by_drive["multi-source"]}
    for name, r in rows.items():
        step_s = r["phase5_step_s"]
        log(f"[multi-source member {name}] wall s={r['wall_s']:.2f} phase-5 step s="
            f"{[round(x, 4) for x in step_s]} median after the first="
            f"{statistics.median(step_s[1:] or step_s):.4f} on {smi}")
    log(f"[multi-source] ensemble={result['ensemble_acc']:.4f} members={result['member_accs']} "
        f"served by cli.predict: same predictions")
    return row


# ----------------------------------------------------------------- phase 16 --

@contextlib.contextmanager
def timed_methods(cls, names):
    """Wall time of every call of ``cls``'s methods ``names`` (synchronized)."""
    times = {n: [] for n in names}
    saved = {n: getattr(cls, n) for n in names}

    def timed(n):
        def call(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[n](self, *a, **kw)
            torch.cuda.synchronize()
            times[n].append(time.perf_counter() - t0)
            return out
        return call

    for n in names:
        setattr(cls, n, timed(n))
    try:
        yield times
    finally:
        for n, f in saved.items():
            setattr(cls, n, f)


def baseline_step(pipe, epoch, ctx) -> dict:
    """``epoch(state)`` of one batch from a fresh seeded state, with the
    gradients each optimizer step is given recorded by module."""
    state = pipe.init_state(torch.Generator().manual_seed(0))
    grads = {}
    cls = type(pipe)
    apply = cls._apply_updates

    def record(self, opt, params, names, gs):
        for n in names:
            grads[n] = [None if g is None else g.detach().clone() for g in gs[n]]
        return apply(self, opt, params, names, gs)

    cls._apply_updates = record
    try:
        with ctx:
            losses = {k: v.detach().clone() for k, v in epoch(state).items()}
            torch.cuda.synchronize()
    finally:
        cls._apply_updates = apply
    return {"losses": losses, "grads": grads}


def baseline_gap_row(pipe, epoch, osconv, wn_fused, gate) -> dict:
    """One step with the OS conv kernel against the same step with its plain
    version on the card: the kernel's launches, each loss's relative error
    and each module's gradients as relative L2 distance (unchecked)."""
    osconv.reset_launch_counts()
    kern = baseline_step(pipe, epoch, contextlib.nullcontext())
    launched = osconv.LAUNCHES["os_conv_fwd"]
    plain = baseline_step(pipe, epoch, plain_convs(osconv, wn_fused, gate, convs=True, wn=False))
    row = {"os_conv_fwd": launched,
           "loss_rel": {k: rel_err(v, plain["losses"][k])[1] for k, v in kern["losses"].items()},
           "losses": {k: v.tolist() for k, v in kern["losses"].items()},
           "grad_l2_rel": {}}
    for name, gs in plain["grads"].items():
        pairs = [(a, b) for a, b in zip(kern["grads"][name], gs) if b is not None]
        d2 = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
        n2 = sum(float((b ** 2).sum()) for _, b in pairs)
        row["grad_l2_rel"][name] = math.sqrt(d2 / n2) if n2 > 0 else math.sqrt(d2)
    return row


def baseline_batches(make_arrays) -> dict:
    """Every baseline domain's splits, as ``make_arrays`` makes them from
    their seeds (the CLI reads no source test split)."""
    n_train, n_test = BASELINE_SERIES
    data = {}
    for i, (name, (c, t, n)) in enumerate({**CODATS_DOMAINS, **SLARDA_DOMAINS}.items()):
        data[name] = {"TRAIN": make_arrays(n_train, c, t, n, seed=30 + 2 * i)}
        if name in (CODATS_TARGET, SLARDA_TARGET):
            data[name]["TEST"] = make_arrays(n_test, c, t, n, seed=31 + 2 * i)
    return data


def first_batch(splits) -> tuple:
    """The train split's first batch as one epoch's stacked (x, y)."""
    x, y = splits["TRAIN"]
    return (x[:BASELINE_BATCH].transpose(0, 2, 1)[None],
            np.array([int(v.split("_")[1]) for v in y[:BASELINE_BATCH]])[None])


def baseline_pipes(baselines, cfg_cls) -> dict:
    """CoDATS and SLARDA on the card at phase 16's shapes, batch 30."""
    cfg = cfg_cls(batch_size=BASELINE_BATCH)
    return {
        "codats": baselines.CoDATSPipeline(CODATS_DOMAINS[CODATS_TARGET],
                                           [CODATS_DOMAINS[d] for d in CODATS_SOURCES], config=cfg,
                                           device="cuda"),
        "slarda": baselines.SLARDAPipeline(SLARDA_DOMAINS[SLARDA_TARGET],
                                           SLARDA_DOMAINS[SLARDA_SOURCE], config=cfg,
                                           device="cuda"),
    }


def baseline_step_rows(pipes, data, osconv, wn_fused, gate) -> dict:
    """``baseline_gap_row`` of one step of each from a fresh state, on each
    domain's first batch: CoDATS, SLARDA's source step with a pinned CPC
    anchor and its target step after ``transfer_weights``."""
    codats, slarda = pipes["codats"], pipes["slarda"]
    xt, yt = first_batch(data[CODATS_TARGET])
    src = [first_batch(data[d]) for d in CODATS_SOURCES]
    (xst, yst), (xs, ys) = first_batch(data[SLARDA_TARGET]), first_batch(data[SLARDA_SOURCE])
    steps = {
        "CoDATS": (codats, lambda st: codats.train_epoch(st, xt, yt, [a[0] for a in src],
                                                          [a[1] for a in src])),
        "SLARDA source": (slarda, lambda st: slarda.source_epoch(st, xs, ys,
                                                                  cpc_anchor=SLARDA_ANCHOR)),
        "SLARDA target": (slarda, lambda st: slarda.target_epoch(slarda.transfer_weights(st),
                                                                  xst, yst, xs)),
    }
    return {what: baseline_gap_row(pipe, epoch, osconv, wn_fused, gate)
            for what, (pipe, epoch) in steps.items()}


def check_baseline_step(what: str, row: dict) -> None:
    """Losses within REL_TOL of the plain OS conv's, each module's gradients
    within BASELINE_GRAD_L2_TOL (relative L2 distance)."""
    log(f"[{what} step, kernel vs plain on the card, checked] {json.dumps(row)}")
    check(row["os_conv_fwd"] > 0, f"{what} step: os_conv_fwd never launched")
    for k, v in row["loss_rel"].items():
        check(bool(np.all(np.isfinite(row["losses"][k]))), f"{what} step: {k} not finite")
        check(v <= REL_TOL, f"{what} step: loss {k} rel err {v:.3e} against plain")
    for n, v in row["grad_l2_rel"].items():
        check(v <= BASELINE_GRAD_L2_TOL, f"{what} step grads, {n}: relative L2 {v:.3e}")


@contextlib.contextmanager
def source_epochs(cls, n: int):
    """``cls.fit`` with ``source_epochs=n`` whatever its caller asks for
    (``cli.baselines`` passes the reference's 70)."""
    fit = cls.fit
    cls.fit = lambda self, *a, **kw: fit(self, *a, **{**kw, "source_epochs": n})
    try:
        yield
    finally:
        cls.fit = fit


def expected_baseline_launches(run, which: str, pipe, epochs: int) -> dict:
    """``os_conv_fwd`` launches of a ``cli.baselines`` drive, derived from the
    pipelines' code (no fused conv: their eval passes fold no BatchNorm):
    CoDATS, per batch the target trunk and head and per source the trunk
    (eval mode) and its head, then every epoch the train and test splits'
    evaluation; SLARDA, per source batch the source trunk and head, per
    target batch the frozen source trunk, the critic's target pre-pass, the
    encoder's trunk and the head, then every target epoch the test split."""
    te, cl = len(pipe.ext_specs), len(pipe.cls_specs)
    n_train, n_test = BASELINE_SERIES
    nb, ev = math.ceil(n_train / BASELINE_BATCH), math.ceil(n_test / BASELINE_BATCH)
    if which == "codats":
        k = len(pipe.source_shapes)
        conv = epochs * (nb * (k + 1) * (te + cl) + (nb + ev) * (te + cl))
    else:
        conv = epochs * nb * (te + cl) + epochs * (nb * (3 * te + cl) + ev * (te + cl))
    return {**run.idle(), "os_conv_fwd": conv}


def baselines_phase(run, bl_cli, baselines, cfg_cls, make_arrays, write_ts_file, osconv,
                    wn_fused, gate, tmp: Path, smi: str) -> dict:
    """``cli.baselines codats|slarda`` on the card at the JAX CLI's example
    shapes, reference budgets, batch 30, the default discriminator,
    ``BASELINE_EPOCHS`` (SLARDA's source pretrain cut to them by
    ``source_epochs``), deterministic: exact launches, finite histories,
    epoch times; and one step of each from a fresh state against the same
    step with the plain OS conv on the card (``baseline_step_rows``)."""
    root = tmp / "baseline_data"
    t0 = time.perf_counter()
    data = baseline_batches(make_arrays)
    for name, splits in data.items():
        write_dataset(root, name, splits, write_ts_file)
    log(f"baseline data written in {time.perf_counter() - t0:.2f} s")
    pipes = baseline_pipes(baselines, cfg_cls)
    timed = {"codats": ("train_epoch",), "slarda": ("source_epoch", "target_epoch")}
    rows = {}
    for which, target, sources in (("codats", CODATS_TARGET, CODATS_SOURCES),
                                   ("slarda", SLARDA_TARGET, [SLARDA_SOURCE])):
        pipe, out = pipes[which], tmp / f"{which}_run"
        args = [which, "--target-root", str(root), "--target", target, "--source-root", str(root),
                "--sources", ",".join(sources), "--epochs", str(BASELINE_EPOCHS),
                "--out", str(out), "--device", "cuda"]
        expect = expected_baseline_launches(run, which, pipe, BASELINE_EPOCHS)
        with timed_methods(type(pipe), timed[which]) as times, deterministic(), \
                source_epochs(baselines.SLARDAPipeline, BASELINE_EPOCHS):
            t0 = time.perf_counter()
            _, history = run.drive(which, lambda: bl_cli.main(args), expect)
            wall = time.perf_counter() - t0
        written = json.loads((out / f"{which}_history.json").read_text())
        check(len(written) == len(history) == BASELINE_EPOCHS * (1 if which == "codats" else 2),
              f"{which}: {len(written)} history records")
        for h in written:
            for k, v in h.items():
                check(k == "phase" or bool(np.all(np.isfinite(v))), f"{which}: {k} = {v} in {h}")
        rows[which] = {"wall_s": wall, "epoch_s": times, "last": written[-1],
                       "launches": run.by_drive[which]}
        log(f"[{which}] wall s={wall:.2f} epoch s={json.dumps(times)} last={json.dumps(written[-1])} "
            f"on {smi}")

    steps = baseline_step_rows(pipes, data, osconv, wn_fused, gate)
    for what, row in steps.items():
        check_baseline_step(what, row)
    rows["codats"]["step"] = steps["CoDATS"]
    rows["slarda"]["source_step"] = steps["SLARDA source"]
    rows["slarda"]["target_step"] = steps["SLARDA target"]
    return rows


# ----------------------------------------------------------------- phase 17 --

@contextlib.contextmanager
def watched_fits(*classes):
    """Every ``fit`` of the classifiers: its synchronized wall time, the
    training series and the history; yields the list of fits."""
    fits = []
    saved = {cls: cls.fit for cls in classes}

    def wrap(fit):
        def call(self, train_ds, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, history = fit(self, train_ds, *a, **kw)
            torch.cuda.synchronize()
            fits.append({"fit_s": time.perf_counter() - t0, "n_train": train_ds.len,
                         "history": history})
            return state, history
        return call

    for cls, fit in saved.items():
        cls.fit = wrap(fit)
    try:
        yield fits
    finally:
        for cls, fit in saved.items():
            cls.fit = fit


def archive_splits(native, root: Path) -> dict:
    """name -> (n_train, n_test, C, T, classes) of every dataset of ``root``,
    read by the native parser without counting."""
    splits = {}
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        x, y = native.load_from_tsfile_native(str(d / f"{d.name}_TRAIN.ts"))
        x_test, _ = native.load_from_tsfile_native(str(d / f"{d.name}_TEST.ts"))
        splits[d.name] = (len(x), len(x_test), x.shape[1], x.shape[2], len(set(y.tolist())))
    return splits


def expected_sweep_launches(run, modules, splits: dict, epochs: int, bucket: bool,
                            fused: bool, cfg) -> dict:
    """Conv launches of one ``cli.archive_sweep`` drive, from the layer
    specs: every train step (``ceil(n_train / 20)`` an epoch) launches
    ``os_conv_fwd`` once a layer of ``ext`` and ``cls``; the evaluation of
    the test and train splits once a layer a batch of 20, into
    ``os_conv_fused_fwd`` under ``FLSTTSC_FUSE_EPILOGUE=1`` (the unbucketed
    model's folded BatchNorm; the padded model folds none)."""
    classifier, bucketed = modules
    expect = run.idle()
    for n_train, n_test, c, t, n_cls in splits.values():
        if bucket:
            key = bucketed.bucket_key(c, t, n_cls, cfg.max_kernel_size)
            model = bucketed.BucketedOSCNNClassifier(*key, config=cfg, device="cuda")
        else:
            model = classifier.OSCNNClassifier(c, t, n_cls, config=cfg, with_cpc=False,
                                               device="cuda")
        layers = len(model.ext_specs) + len(model.cls_specs)
        expect["os_conv_fwd"] += layers * epochs * math.ceil(n_train / BATCH)
        evals = layers * (math.ceil(n_test / BATCH) + math.ceil(n_train / BATCH))
        expect["os_conv_fused_fwd" if fused and not bucket else "os_conv_fwd"] += evals
    return expect


def sweep_drive(run, sweep_cli, ts_parser, modules, what: str, root: Path, flags, splits: dict,
                epochs: int, out: Path, cfg, fused: bool = False) -> dict:
    """``cli.archive_sweep.main`` over ``root`` on the card, deterministic:
    exact conv launches, every dataset with ``test_acc`` and no ``error``
    (the CLI's ``except`` would hide a kernel fault there), finite
    histories, the native parser for every file; each dataset's wall time
    and series/s of its ``fit``."""
    bucket = "--bucket" in flags
    expect = expected_sweep_launches(run, modules, splits, epochs, bucket, fused, cfg)
    args = ["--root", str(root), "--epochs", str(epochs), "--out", str(out),
            "--budget-multiplier", "1.0", "--device", "cuda", *flags]
    ts_parser.reset_parse_counts()
    fit_cls = modules[1].BucketedOSCNNClassifier if bucket else modules[0].OSCNNClassifier
    with watched_fits(fit_cls) as fits, deterministic(), \
            environ(FLSTTSC_FUSE_EPILOGUE="1" if fused else "0"):
        t0 = time.perf_counter()
        results = run.drive(what, lambda: sweep_cli.main(args), expect)
        wall = time.perf_counter() - t0
    check(json.loads(out.read_text()) == results, f"{what}: the results file differs")
    check(list(results) == list(splits), f"{what}: datasets {list(results)}, want {list(splits)}")
    check(ts_parser.PARSES == {"native": 2 * len(splits), "python": 0},
          f"{what}: parsers {ts_parser.PARSES}, want the native one for all {2 * len(splits)} files")
    check(len(fits) == len(splits), f"{what}: {len(fits)} fits")
    rows = {}
    for (name, r), fit in zip(results.items(), fits):
        check("error" not in r and "test_acc" in r, f"{what}: {name} gave {r}")
        check(("bucket" in r) == bucket, f"{what}: {name}'s keys {sorted(r)}")
        for h in fit["history"]:
            check(all(math.isfinite(v) for k, v in h.items() if k != "epoch"),
                  f"{what}: {name}'s history {h}")
        check(len(fit["history"]) == epochs, f"{what}: {name}: {len(fit['history'])} epochs")
        rows[name] = {**r, "fit_s": fit["fit_s"],
                      "series_per_s": fit["n_train"] * epochs / fit["fit_s"],
                      "last": fit["history"][-1]}
    log(f"[{what}] wall s={wall:.2f} " + " ".join(
        f"{n}: acc={r['test_acc']:.3f} wall={r['wall_s']} fit={r['fit_s']:.2f}s "
        f"series/s={r['series_per_s']:.1f}" for n, r in rows.items()))
    return {"wall_s": wall, "datasets": rows, "launches": run.by_drive[what]}


def parse_times(native, ts_parser, files) -> dict:
    """Native and Python parse times (host clock) of ``files``, and the same
    arrays and labels from both."""
    row = {"native_s": 0.0, "python_s": 0.0}
    for path in files:
        t0 = time.perf_counter()
        xn, yn = native.load_from_tsfile_native(str(path))
        t1 = time.perf_counter()
        xp, yp = ts_parser._load_from_tsfile_py(str(path))
        t2 = time.perf_counter()
        check(np.array_equal(xn, xp) and list(yn) == list(yp), f"{path.name}: parsers differ")
        row["native_s"] += t1 - t0
        row["python_s"] += t2 - t1
    return row


def bucket_step_row(bucketed, cfg, x_train, y_train, x_test, osconv, wn_fused, gate,
                    bn_stats_type) -> dict:
    """The FordA bucket (500 padded to 729, 2 of 4 classes) on the card: one
    ``train_batch`` from a fresh state and one evaluation batch of a state
    with random BatchNorm statistics, with the OS conv kernel and with its
    plain version: the loss's relative error, each module's gradients as
    relative L2 distance, the valid classes' logits' relative error."""
    clf = bucketed.BucketedOSCNNClassifier(*bucketed.bucket_key(1, 500, 2, cfg.max_kernel_size),
                                           config=cfg, device="cuda")
    check(clf.t_bucket == 729, f"FordA's bucket length {clf.t_bucket}")
    t_valid, cmask = clf.t_valid(500), clf.cmask(2)
    x, y, xe = clf._pad_x(x_train[:BATCH]), y_train[:BATCH], clf._pad_x(x_test[:BATCH])
    evaluated = with_random_bn(clf.init_models(torch.Generator().manual_seed(1)),
                               np.random.default_rng(1), bn_stats_type)

    def step(ctx):
        state = clf.init_state(torch.Generator().manual_seed(0))
        grads, apply = {}, clf._apply_updates

        def record(st, names, gs):
            for n in names:
                grads[n] = [None if g is None else g.detach().clone() for g in gs[n]]
            return apply(st, names, gs)

        clf._apply_updates = record
        try:
            with ctx:
                ce = clf.train_batch(state, x, y, t_valid, cmask)
                logits = clf.predict_logits(evaluated["params"], evaluated["mstate"], xe, t_valid,
                                            cmask)[:, :2]
                torch.cuda.synchronize()
        finally:
            del clf._apply_updates
        return ce, grads, logits

    osconv.reset_launch_counts()
    kern = step(contextlib.nullcontext())
    launched = osconv.LAUNCHES["os_conv_fwd"]
    plain = step(plain_convs(osconv, wn_fused, gate, convs=True, wn=False))
    row = {"os_conv_fwd": launched, "loss": float(kern[0]), "loss_rel": rel_err(kern[0], plain[0])[1],
           "logits_rel": rel_err(kern[2], plain[2])[1], "grad_l2_rel": {}}
    for name, gs in plain[1].items():
        pairs = [(a, b) for a, b in zip(kern[1][name], gs) if b is not None]
        d2 = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
        n2 = sum(float((b ** 2).sum()) for _, b in pairs)
        row["grad_l2_rel"][name] = math.sqrt(d2 / n2) if n2 > 0 else math.sqrt(d2)
    layers = len(clf.ext_specs) + len(clf.cls_specs)
    log(f"[FordA bucket step, kernel vs plain on the card, checked] {json.dumps(row)}")
    check(launched == 2 * layers, f"FordA bucket step: {launched} launches, want {2 * layers}")
    check(math.isfinite(row["loss"]) and row["loss_rel"] <= REL_TOL,
          f"FordA bucket step: loss rel err {row['loss_rel']:.3e}")
    check(row["logits_rel"] <= REL_TOL, f"FordA bucket: logits rel err {row['logits_rel']:.3e}")
    for n, v in row["grad_l2_rel"].items():
        check(v <= BASELINE_GRAD_L2_TOL, f"FordA bucket step grads, {n}: relative L2 {v:.3e}")
    return row


def sweep_phase(run, sweep_cli, modules, data_modules, osconv, wn_fused, gate, cfg,
                bn_stats_type, make_arrays, write_ts_file, tmp: Path, smi: str) -> dict:
    """``cli.archive_sweep`` on the card: (a) the vendored roots, ``SWEEP_EPOCHS``
    unbucketed (once more with ``FLSTTSC_FUSE_EPILOGUE=1``) and ``--bucket``,
    one epoch ``--with-cpc`` over the univariate root; (b) a synthetic archive
    at the UCR 2018 shapes of ``UCR_SHAPES`` (StarLightCurves' test split cut
    from 8236 to 1000 series for the drive's time), written by the port's
    ``write_ts_file`` and parsed back by the native parser, one epoch
    unbucketed and ``--bucket``; the native and Python parse times of the
    FordA files; one FordA-bucket step against the plain OS conv."""
    native, ts_parser = data_modules
    t_phase = time.perf_counter()
    rows = {}
    for root_name in ("Univariate_ts", "Multivariate_ts"):
        root = REPO / "datasets" / root_name
        splits = archive_splits(native, root)
        for tag, flags, fused in (("unbucketed", [], False), ("unbucketed fused", [], True),
                                  ("bucketed", ["--bucket"], False)):
            what = f"sweep {root_name} {tag}"
            rows[what] = sweep_drive(run, sweep_cli, ts_parser, modules, what, root, flags, splits,
                                     SWEEP_EPOCHS, tmp / f"{what.replace(' ', '_')}.json", cfg,
                                     fused)
    uni = REPO / "datasets" / "Univariate_ts"
    rows["sweep Univariate_ts with CPC"] = sweep_drive(
        run, sweep_cli, ts_parser, modules, "sweep Univariate_ts with CPC", uni, ["--with-cpc"],
        archive_splits(native, uni), 1, tmp / "sweep_cpc.json", cfg)

    ucr = tmp / "ucr_archive"
    t0 = time.perf_counter()
    for i, (name, (n_train, n_test, t, n_cls)) in enumerate(UCR_SHAPES.items()):
        write_dataset(ucr, name, {"TRAIN": make_arrays(n_train, 1, t, n_cls, seed=40 + 2 * i),
                                  "TEST": make_arrays(n_test, 1, t, n_cls, seed=41 + 2 * i)},
                      write_ts_file)
    written_s = time.perf_counter() - t0
    rows["parse_FordA"] = parse_times(native, ts_parser, [ucr / "FordA" / "FordA_TRAIN.ts",
                                                          ucr / "FordA" / "FordA_TEST.ts"])
    log(f"[UCR-shaped archive] written in {written_s:.2f} s; FordA parsed natively in "
        f"{rows['parse_FordA']['native_s']:.3f} s, by the Python parser in "
        f"{rows['parse_FordA']['python_s']:.3f} s (host clock) on {smi}")
    splits = archive_splits(native, ucr)
    for tag, flags in (("unbucketed", []), ("bucketed", ["--bucket"])):
        what = f"sweep UCR shapes {tag}"
        rows[what] = sweep_drive(run, sweep_cli, ts_parser, modules, what, ucr, flags, splits, 1,
                                 tmp / f"sweep_ucr_{tag}.json", cfg)
    buckets = {tuple(r["bucket"]) for r in rows["sweep UCR shapes bucketed"]["datasets"].values()}
    check(buckets == {(1, 89, 729, 4), (1, 89, 1094, 4)}, f"UCR-shaped buckets {sorted(buckets)}")
    x_tr, y_tr = make_arrays(BATCH, 1, 500, 2, seed=40)
    x_te, _ = make_arrays(BATCH, 1, 500, 2, seed=41)
    rows["FordA_bucket_step"] = bucket_step_row(
        modules[1], cfg, x_tr.transpose(0, 2, 1).copy(),
        np.array([int(v.split("_")[1]) for v in y_tr]), x_te.transpose(0, 2, 1).copy(),
        osconv, wn_fused, gate, bn_stats_type)
    rows["written_s"] = written_s
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[archive sweep] phase wall s={rows['wall_s']:.1f} on {smi}")
    return rows


# ----------------------------------------------------------------- phase 18 --

def expected_multirun_launches(pipe, n_series: int, epochs: dict) -> dict:
    """Launches of a ``MultiRunStylePipeline.run`` of any K: the run-axis
    kernels as often as one run (``expected_training_launches``) launches
    the one-run ones, less the pretrain evaluations, which the multirun
    does not take (as the JAX package's)."""
    one = expected_training_launches(pipe, n_series, epochs)
    te, cl, se = len(pipe.t_ext_specs), len(pipe.cls_specs), len(pipe.s_ext_specs)
    ev = 2 * math.ceil(n_series / BATCH)
    sup4 = math.ceil(epochs["p4"] / pipe.config.nf_supervised_every)
    pretrain_evals = (epochs["p1"] * ev * (te + cl) + epochs["p2"] * ev * (se + cl)
                      + (epochs["p3"] + sup4) * ev * (te + se + 2 * cl))
    return {"os_conv_fwd_runs": one["os_conv_fwd"] - pretrain_evals,
            "wn_fwd_runs": one["wn_fwd"], "wn_bwd_runs": one["wn_bwd"]}


@contextlib.contextmanager
def recorded_calls(module, names, every: bool = False):
    """``module.<name>`` for each of ``names`` wrapped to keep a copy of the
    arguments of its first call of each distinct set of shapes (``every``:
    of every call)."""
    seen = {n: {} for n in names}
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*args):
            key = len(seen[name]) if every else tuple(
                tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args)
            if key not in seen[name]:
                seen[name][key] = [a.detach().clone() if isinstance(a, torch.Tensor) else a
                                   for a in args]
            return fn(*args)
        return inner

    for n in names:
        setattr(module, n, wrap(n, saved[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(module, n, saved[n])


def rel_l2(got: torch.Tensor, want: torch.Tensor):
    """(max|got - want|, relative L2 distance), in float64."""
    got, want = got.double(), want.double()
    return (got - want).abs().max().item(), ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def f64_sums(wn_fused=None, osconv=None):
    """The control of the bf16 checks: inside, the plain WN versions'
    products (``wn_fused._mm``, with ``wn_fused``) and the OS conv
    (``osconv.os_conv``, with ``osconv``; entered inside ``plain_convs``)
    take the same bf16 operands and sum them in float64, rounded once:
    another, more exact order of the same sums."""
    saved = (wn_fused and wn_fused._mm), (osconv and osconv.os_conv)

    def mm(a, b, bf16):
        if bf16:
            a, b = a.bfloat16(), b.bfloat16()
        return (a.double() @ b.double()).float()

    if wn_fused:
        wn_fused._mm = mm
    if osconv:
        osconv.os_conv = lambda x_pad, w: osconv.os_conv_plain(x_pad.double(), w.double()).to(
            x_pad.dtype)
    try:
        yield
    finally:
        if wn_fused:
            wn_fused._mm = saved[0]
        if osconv:
            osconv.os_conv = saved[1]


def per_run(fn, args):
    """``fn`` run by run over the leading axis of ``args``' tensors, each
    output stacked: a list of outputs."""
    runs = args[0].shape[0]
    outs = [fn(*[a[r] if isinstance(a, torch.Tensor) else a for a in args]) for r in range(runs)]
    return [torch.stack(o) for o in zip(*outs)] if isinstance(outs[0], tuple) else [
        torch.stack(outs)]


def run_axis_row(name, args, runs_fn, one_fn, plain_fn, plain_tol, work, library=None,
                 library_outputs=0, err=rel_err, peak=TC_PEAK / TF32_PRODUCTS) -> dict:
    """A run-axis kernel on one recorded call's arguments: each run against
    the one-run kernel (the same bits, else the largest relative error,
    gated at RUN_AXIS_REL_TOL; the last ``library_outputs`` outputs are taken
    outside the kernel by one batched library product and are held to
    ``plain_tol``) and against the plain version (``err``, gated at
    ``plain_tol``, one for all outputs or a list, one an output), timed with
    the K one-run calls, the plain version run by run and ``library``; the
    operations bound at ``peak`` FLOP/s."""
    runs = args[0].shape[0]
    got = runs_fn(*args)
    got = list(got) if isinstance(got, tuple) else [got]
    one, plain = per_run(one_fn, args), per_run(plain_fn, args)
    torch.cuda.synchronize()
    n_kernel = len(got) - library_outputs
    same = all(torch.equal(a, b) for a, b in zip(got[:n_kernel], one[:n_kernel]))
    one_rel = max(rel_err(a, b)[1] for a, b in zip(got, one))
    errs = [err(a, b) for a, b in zip(got, plain)]
    tols = list(plain_tol) if isinstance(plain_tol, (list, tuple)) else [plain_tol] * len(errs)
    row = {
        "kernel": name, "runs": runs, "shapes": [list(a.shape) for a in args
                                                 if isinstance(a, torch.Tensor)][:2],
        "same_bits_as_one_run": same, "one_run_rel": one_rel,
        "kernel_outputs_one_run_rel": max(rel_err(a, b)[1] for a, b in
                                          zip(got[:n_kernel], one[:n_kernel])),
        "max_abs": max(e[0] for e in errs), "rel": max(e[1] for e in errs),
        "ms": cuda_ms(lambda: runs_fn(*args), reps=3),
        "one_run_calls_ms": cuda_ms(lambda: per_run(one_fn, args), warmup=1, reps=2),
        "plain_ms": cuda_ms(lambda: per_run(plain_fn, args), warmup=0, reps=1),
        "library_ms": cuda_ms(library, reps=3) if library else None,
        **work,
    }
    row["tc_flop_ms"] = work["flops"] / peak * 1e3
    row["bytes_ms"] = work["bytes"] / HBM_RATE * 1e3
    row["bound_ms"] = max(row["tc_flop_ms"], row["bytes_ms"])
    log(f"run-axis {json.dumps(row)}")
    check(same or row["kernel_outputs_one_run_rel"] <= RUN_AXIS_REL_TOL,
          f"{name} {row['shapes']}: runs against the one-run kernel, rel {one_rel:.3e}")
    check(one_rel <= min(tols), f"{name} {row['shapes']}: library outputs rel {one_rel:.3e}")
    check(all(e[1] <= t for e, t in zip(errs, tols)),
          f"{name} {row['shapes']}: errors {[e[1] for e in errs]} vs plain, bars {tols}")
    return row


def conv_runs_work(x_pad, w, out_numel, vectors: int = 0) -> dict:
    """Live-tap FLOPs (each run's own windows of nonzero weights) and bytes
    of one run-axis conv call (the operands' and output's element size)."""
    runs, b, t_pad, c_in = x_pad.shape
    k = w.shape[1]
    live = int((w != 0).any(dim=2).sum().item())  # (run, tap, column) with a nonzero weight
    flops = 2 * b * (t_pad - k + 1) * c_in * live
    return {"flops": flops, "bytes": x_pad.element_size() * (x_pad.numel() + w.numel() + out_numel)
            + 4 * vectors * runs * w.shape[-1]}


def run_axis_rows(osconv, wn_fused, conv_calls, fused_calls, wn_calls, bf16: bool = False) -> dict:
    """Every recorded run-axis call of phase 18's checks (or, ``bf16``, of
    phase 19's), held and timed."""
    import torch.nn.functional as F

    rows = {"os_conv_fwd_runs": [], "os_conv_fused_fwd_runs": [], "wn_fwd_runs": [],
            "wn_bwd_runs": []}
    # the bf16 instances: relative L2 against the plain bf16 versions, bound at the BF16 peak
    gate = {"err": rel_l2, "peak": BF16_PEAK} if bf16 else {}
    for args in conv_calls.values():
        x_pad, w = args
        runs, b, t_pad, c_in = x_pad.shape
        k, c_out = w.shape[1], w.shape[3]
        x_ncw = x_pad.permute(1, 0, 3, 2).reshape(b, runs * c_in, t_pad).contiguous()
        w_oik = w.permute(0, 3, 2, 1).reshape(runs * c_out, c_in, k).contiguous()
        rows["os_conv_fwd_runs"].append(run_axis_row(
            "os_conv_fwd_runs", args, osconv.os_conv_runs, osconv.os_conv, osconv.os_conv_plain,
            BF16_REL_L2 if bf16 else REL_TOL,
            conv_runs_work(x_pad, w, runs * b * (t_pad - k + 1) * c_out),
            library=lambda: F.conv1d(x_ncw, w_oik, groups=runs), **gate))
    for args in fused_calls.values():
        x_pad, w = args[:2]
        runs, b, t_pad, _ = x_pad.shape
        rows["os_conv_fused_fwd_runs"].append(run_axis_row(
            "os_conv_fused_fwd_runs", args, osconv.os_conv_fused_runs, osconv.os_conv_fused,
            osconv.os_conv_fused_plain, REL_TOL,
            conv_runs_work(x_pad, w, runs * b * (t_pad - w.shape[1] + 1) * w.shape[3], 2)))
    for name, (runs_fn, one_fn, plain_fn, d, outs) in {
        "wn_fwd_runs": (wn_fused.wn_fwd_runs, wn_fused.wn_fwd, wn_fused.wn_fwd_plain, "fwd", 0),
        "wn_bwd_runs": (wn_fused.wn_bwd_runs, wn_fused.wn_bwd, wn_fused.wn_bwd_plain, "bwd", 2),
    }.items():
        for args in wn_calls[name].values():
            x2, t = args[0], args[-2]  # the last argument is the bf16 flag
            runs, rows_n, h = x2.shape
            w_in = args[5] if name == "wn_fwd_runs" else args[7]
            work = wn_work(rows_n // t, t, h, w_in.shape[3], w_in.shape[1])
            tol = WN_FWD_REL_TOL if d == "fwd" else WN_BWD_REL_TOL
            if bf16:  # free-running: BF16_CASCADE of the switch's own effect on each output
                effect = [rel_l2(a, b)[1] for a, b in zip(
                    per_run(plain_fn, args), per_run(plain_fn, list(args[:-1]) + [False]))]
                tol = [max(BF16_REL_L2, BF16_CASCADE * e) for e in effect]
            rows[name].append(run_axis_row(
                name, args, runs_fn, one_fn, plain_fn, tol,
                {"flops": runs * work[f"{d}_flops"], "bytes": runs * work[f"{d}_bytes"]},
                library_outputs=outs, **gate))
            rows[name][-1]["bars"] = tol
    return rows


def multirun_pair(make_dataset) -> dict:
    """Phase 8's pair as arrays (SCP2 <- EthanolLevel shapes, TRAIN_SERIES a
    split): every run of phases 18 and 19 trains on it."""
    c, t, n_cls = SCP2["channels"], SCP2["length"], SCP2["classes"]
    e_c, e_t, e_n = ETHANOL["channels"], ETHANOL["length"], ETHANOL["classes"]
    t_labels, s_labels = {}, {}
    return {split: (ds.x, ds.y) for split, ds in (
        ("t_train", make_dataset(TRAIN_SERIES, c, t, n_cls, seed=11, label_dict=t_labels)),
        ("t_test", make_dataset(TRAIN_SERIES, c, t, n_cls, seed=12, label_dict=t_labels)),
        ("s_train", make_dataset(TRAIN_SERIES, e_c, e_t, e_n, seed=13, label_dict=s_labels)),
        ("s_test", make_dataset(TRAIN_SERIES, e_c, e_t, e_n, seed=14, label_dict=s_labels)))}


def run_gap(losses_a, grads_a, i, losses_b, grads_b) -> dict:
    """Run i of (K-leading) step a against one-run step b: each loss's
    relative error and each module's gradients' relative L2 distance."""
    loss_rel = {k: abs(float(losses_a[k][i].detach()) - float(v.detach()))
                / max(abs(float(v.detach())), 1e-30) for k, v in losses_b.items()}
    grad_l2 = {}
    for name, gs in grads_b.items():
        pairs_ = [(a[i], b) for a, b in zip(grads_a[name], gs) if b is not None]
        d2 = sum(float(((a - b) ** 2).sum()) for a, b in pairs_)
        n2 = sum(float((b ** 2).sum()) for _, b in pairs_)
        grad_l2[name] = math.sqrt(d2 / n2) if n2 > 0 else math.sqrt(d2)
    return {"loss_rel": loss_rel, "grad_l2_rel": grad_l2}


def multirun_phase(run, pipe, modules, make_dataset, smi) -> dict:
    """Phase 18: K = MULTIRUN_K runs of the curriculum at once
    (``MultiRunStylePipeline``), at phase 8's shapes and lengths."""
    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
        MultiRunData,
        MultiRunStylePipeline,
        unstack_state,
    )

    osconv, wn_fused, gate = modules
    k_runs = MULTIRUN_K
    pair = multirun_pair(make_dataset)
    data = MultiRunData.broadcast(pair, k_runs)
    mp = MultiRunStylePipeline(pipe)
    seeds = list(range(k_runs))
    out = {"k": k_runs}

    # the drive: K runs of PHASE_EPOCHS, launches counted
    expect = {**run.idle(), **expected_multirun_launches(pipe, TRAIN_SERIES, PHASE_EPOCHS)}
    t0 = time.perf_counter()
    states, history = run.drive(f"multirun K={k_runs}",
                                lambda: mp.run(data, seeds, epochs=PHASE_EPOCHS), expect,
                                path="multirun")
    out["drive_wall_s"] = time.perf_counter() - t0
    for rec in history:
        if rec["phase"] in ("p1", "p2", "p3", "p4"):
            for key, v in rec.items():
                if key not in ("phase", "epoch"):
                    check(bool(np.isfinite(v).all()), f"multirun {rec['phase']} {key} not finite")
    out["history"] = [{k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in r.items()}
                      for r in history]
    log(f"[multirun K={k_runs}] wall s={out['drive_wall_s']:.2f} last record "
        f"{json.dumps(out['history'][-1])}")

    t_block = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t_block
        now = time.perf_counter()
        out.setdefault("block_s", {})[what] = now - t_block
        log(f"[multirun] {what}: {now - t_block:.1f} s")
        t_block = now

    # the evaluation in the fused conv: K runs at once against one run, launches and accuracies
    with environ(FLSTTSC_FUSE_EPILOGUE="1"), recorded_calls(osconv, ["os_conv_fused_runs"]) as fused:
        ev = {**run.idle(), "os_conv_fused_fwd_runs": math.ceil(TRAIN_SERIES / BATCH) * (
            len(pipe.t_ext_specs) + len(pipe.s_ext_specs) + 2 * len(pipe.cls_specs))}
        accs = run.drive("multirun evaluation, fused", lambda: (
            mp.evaluate_target(states, *data.t_test), mp.evaluate_source(states, *data.s_test)),
            ev, path="multirun")
        one = unstack_state(states, 0)
        want = {**run.idle(), "os_conv_fused_fwd": ev["os_conv_fused_fwd_runs"]}
        one_accs = run.drive("one-run evaluation, fused", lambda: (
            pipe.evaluate_target(one, pair["t_test"][0], pair["t_test"][1]),
            pipe.evaluate_source(one, pair["s_test"][0], pair["s_test"][1])), want)
    check(accs[0][0] == one_accs[0] and accs[1][0] == one_accs[1],
          f"multirun evaluation {accs} != one run's {one_accs}")
    out["fused_eval_launches"] = {"k_runs": ev["os_conv_fused_fwd_runs"],
                                  "one_run": want["os_conv_fused_fwd"]}
    log(f"[multirun evaluation] os_conv_fused_fwd_runs={ev['os_conv_fused_fwd_runs']} for "
        f"{k_runs} runs, os_conv_fused_fwd={want['os_conv_fused_fwd']} for one")

    # a trained run, unstacked and through the JAX package's file layout,
    # continues in one-run training: its next phase-5 step from the loaded
    # state is the step from the unstacked state in memory, bit for bit
    # (deterministic, as phase 8b); beside it, measured, the K-run's own
    # next step for run 3 (the truncated curriculum may have let the flow
    # run away, which magnifies the last bits, see PHASE_EPOCHS)
    batch = [torch.as_tensor(np.asarray(a[:BATCH])).cuda() for a in (
        pair["t_train"][0], pair["t_train"][1], pair["s_train"][0], pair["s_train"][1])]
    batch = [b.long() if i % 2 else b for i, b in enumerate(batch)]
    k_batch = [b.expand(k_runs, *b.shape).contiguous() for b in batch]
    _, card_masks = pinned_masks()
    e5 = PHASE_EPOCHS["p5"]
    mem = unstack_state(states, 3)
    flat = pipe.state_to_flat(mem)
    loaded = pipe.state_from_flat(flat)
    again = pipe.state_to_flat(loaded)
    check(set(again) == set(flat) and all(np.array_equal(again[k], v) for k, v in flat.items()),
          "run 3's state changed through state_to_flat / state_from_flat")
    with deterministic():
        from_file = pipe.phase5_grads(loaded, *batch, e5, ANCHORS, card_masks)[0]
        from_memory = pipe.phase5_grads(mem, *batch, e5, ANCHORS, card_masks)[0]
        k_next = mp.phase5_grads(states, *k_batch, e5, ANCHORS, card_masks)[0]
    check(all(torch.equal(from_file[k], from_memory[k]) for k in from_memory),
          "run 3's next phase-5 losses from its file differ from those from memory")
    cont = {k: {"one_run": float(v.detach()), "k_run": float(k_next[k][3].detach())}
            for k, v in from_file.items()}
    out["unstacked_run3_next_step"] = cont
    log(f"[multirun] run 3 unstacked, written, loaded ({len(flat)} keys, the same): its next "
        f"phase-5 losses the same bits as from memory; beside the K-run's for run 3 "
        f"{json.dumps(cont)}")
    del states, mem, loaded, k_next, from_file, from_memory
    torch.cuda.empty_cache()
    lap("evaluation and run 3's continuation")

    # the K sweep, in a process of its own without CUBLAS_WORKSPACE_CONFIG
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    # (and the op-by-op route's, phase 23's, in the same process)
    proc = subprocess.run([sys.executable, str(REPO / "experiments" / "multirun_time.py"),
                           "--ks", ",".join(map(str, MULTIRUN_SWEEP)), "--routes",
                           "fused,op_by_op", "--rounds", "1"],
                          capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    check(proc.returncode == 0, f"multirun_time.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    both = json.loads(proc.stdout.strip().splitlines()[-1])
    sweep = {**{k: v for k, v in both.items() if k != "by_route"}, "route": "fused",
             "by_k": both["by_route"]["fused"]}
    out["sweep"] = sweep
    out["sweep_op_by_op"] = {**sweep, "route": "op_by_op", "by_k": both["by_route"]["op_by_op"]}
    for k, r in sweep["by_k"].items():
        log(f"[multirun sweep K={k}] step ms={r['median_ms']:.1f} ({[round(x, 1) for x in r['step_ms']]}) "
            f"series/s={r['series_per_s']:.1f} device ms={r['device_ms']:.1f} idle share="
            f"{r['device_idle_share']:.3f} peak MiB={r['peak_mib']:.0f} on {sweep['card']}")
        for name, ms, calls in r["top"]:
            log(f"  {ms:9.3f} ms {calls:6d} x {name}")
    log(f"[multirun] max_memory_allocated at K={k_runs}: "
        f"{sweep['by_k'][str(k_runs)]['peak_mib']:.0f} MiB on {smi}")
    lap("the K sweep, both routes (experiments/multirun_time.py)")

    # one phase-5 step of K fresh runs against K one-run steps from the same states
    fresh = with_wn_ends(mp.init_states(seeds), torch.Generator().manual_seed(18))
    with recorded_calls(osconv, ["os_conv_runs"]) as convs, \
            recorded_calls(wn_fused, ["wn_fwd_runs", "wn_bwd_runs"]) as wns:
        for m in modules:
            m.reset_launch_counts()
        losses, _, _, grads, n_t, n_s = mp.phase5_grads(fresh, *k_batch, 0, ANCHORS, card_masks)
        torch.cuda.synchronize()
        k_counts = run.counts()
    gaps, control = [], []
    for i in range(k_runs):
        st = unstack_state(fresh, i)
        for m in modules:
            m.reset_launch_counts()
        l1, _, _, g1, nt1, ns1 = pipe.phase5_grads(st, *batch, 0, ANCHORS, card_masks)
        torch.cuda.synchronize()
        one_counts = run.counts()
        gaps.append({**run_gap(losses, grads, i, l1, g1),
                     "n_t_rel": rel_err(n_t[i], nt1)[1], "n_s_rel": rel_err(n_s[i], ns1)[1]})
        # the control: how far the same one-run step moves with the plain OS conv
        with plain_convs(osconv, wn_fused, gate, wn=False):
            lp, _, _, gp, _, _ = pipe.phase5_grads(st, *batch, 0, ANCHORS, card_masks)
        control.append(run_gap({k: v[None] for k, v in lp.items()},
                           {k: [None if g is None else g[None] for g in v] for k, v in gp.items()},
                           0, l1, g1))
        del st, l1, g1, lp, gp
    worst = {"loss_rel": max(max(g["loss_rel"].values()) for g in gaps),
             "grad_l2_rel": max(max(g["grad_l2_rel"].values()) for g in gaps),
             "n_rel": max(max(g["n_t_rel"], g["n_s_rel"]) for g in gaps),
             "control_loss_rel": max(max(g["loss_rel"].values()) for g in control),
             "control_grad_l2_rel": max(max(g["grad_l2_rel"].values()) for g in control)}
    out["step_vs_one_run"] = {"per_run": gaps, "worst": worst, "control_plain_os_conv": control}
    for i, g in enumerate(gaps):
        log(f"  run {i}: loss rel {max(g['loss_rel'].values()):.2e} grads rel L2 "
            f"{ {k: float(f'{v:.2e}') for k, v in g['grad_l2_rel'].items()} }; control (plain "
            f"OS conv, one run) {max(control[i]['grad_l2_rel'].values()):.2e}")
    launches = {"k_runs": {n: k_counts[n] for n in ("os_conv_fwd_runs", "wn_fwd_runs", "wn_bwd_runs")},
                "one_run": {n: one_counts[n] for n in ("os_conv_fwd", "wn_fwd", "wn_bwd")}}
    out["step_launches"] = launches
    log(f"[multirun phase-5 step, {k_runs} runs vs {k_runs} one-run steps] worst {json.dumps(worst)}; "
        f"launches {json.dumps(launches)}")
    for n in ("os_conv_fwd", "wn_fwd", "wn_bwd"):
        check(launches["k_runs"][f"{n}_runs"] == launches["one_run"][n] > 0,
              f"a K-run step launched {n}_runs {launches['k_runs'][f'{n}_runs']} times, "
              f"a one-run step {n} {launches['one_run'][n]}")
    lap("the step against K one-run steps and their controls")
    check(worst["loss_rel"] <= STEP_LOSS_REL_TOL, f"multirun step losses rel {worst['loss_rel']:.3e}")
    for i, (g, ctl) in enumerate(zip(gaps, control)):
        for name, v in g["grad_l2_rel"].items():
            allowed = max(MULTIRUN_GRAD_L2_TOL, 2 * ctl["grad_l2_rel"][name])
            check(v <= allowed, f"multirun step, run {i} {name}: gradients relative L2 {v:.3e} "
                                f"> {allowed:.3e}")

    # the run-axis kernels at this phase's shapes
    out["run_axis"] = run_axis_rows(osconv, wn_fused, convs["os_conv_runs"],
                                    fused["os_conv_fused_runs"], wns)
    del convs, wns, fused
    lap("the run-axis kernels")

    del fresh
    torch.cuda.empty_cache()

    return out

# ----------------------------------------------------------------- phase 23 --

def tap_runs_work(x_pad, w, d: int) -> dict:
    """FLOPs (every tap live) and bytes of one ``tap_conv_fwd_runs`` call."""
    runs, b, t_pad, c_in = x_pad.shape
    k, c_out = w.shape[1], w.shape[3]
    t_out = t_pad - (k - 1) * d
    return {"flops": 2 * runs * b * t_out * c_in * k * c_out,
            "bytes": 4 * (x_pad.numel() + w.numel() + runs * b * t_out * c_out)}


def opbyop_run_axis_rows(osconv, gate, tap_calls, gate_calls) -> dict:
    """Every recorded call of phase 23's K-run step: ``tap_conv_fwd_runs``
    at each distinct shape and dilation, each run against the one-run
    ``tap_conv_fwd`` (the same bits) and ``tap_conv_plain`` (REL_TOL), timed
    beside K one-run calls, the plain version run by run and a grouped
    dilated ``F.conv1d`` (``groups=K``, TF32 off); the gate's folded launch
    (``gate_fwd_runs``) at each distinct shape, each run's rows against the
    one-run ``gate_fwd`` (the same bits) and ``gate_plain``, its bound the
    bytes."""
    import torch.nn.functional as F

    rows = {"tap_conv_fwd_runs": [], "gate_fwd_runs": []}
    for args in tap_calls.values():
        x_pad, w, d = args
        runs, b, t_pad, c_in = x_pad.shape
        k, c_out = w.shape[1], w.shape[3]
        x_ncw = x_pad.permute(1, 0, 3, 2).reshape(b, runs * c_in, t_pad).contiguous()
        w_oik = w.permute(0, 3, 2, 1).reshape(runs * c_out, c_in, k).contiguous()
        rows["tap_conv_fwd_runs"].append(run_axis_row(
            "tap_conv_fwd_runs", args, osconv.tap_conv_fwd_runs, osconv.tap_conv_fwd,
            osconv.tap_conv_plain, REL_TOL, tap_runs_work(x_pad, w, d),
            library=lambda: F.conv1d(x_ncw, w_oik, dilation=d, groups=runs)))
        rows["tap_conv_fwd_runs"][-1]["dilation"] = d
    for args in gate_calls.values():
        a, b_, n, name = args
        if name != "gate_fwd_runs":
            continue
        runs, rows_n = a.shape[0], a[0].numel() // (2 * n)
        work = {"flops": GATE_OPS * runs * rows_n * n,
                "bytes": 4 * (a.numel() + b_.numel() + runs * rows_n * n)}
        rows["gate_fwd_runs"].append(run_axis_row(
            "gate_fwd_runs", (a, b_, n), lambda a, b, n: gate.gate_fwd(a, b, n, "gate_fwd_runs"),
            gate.gate_fwd, gate.gate_plain, REL_TOL, work, peak=FP32_PEAK))
    return rows


def opbyop_multirun_phase(run, pipe, modules, make_dataset, smi, fused_gaps=None,
                          sweep=None) -> dict:
    """Phase 23: K = MULTIRUN_K runs at once on the op-by-op WN route
    (``FLSTTSC_WN_FUSED=0``, ``FLSTTSC_CONV_IMPL=pallas``) at phase 8's
    pair and full width: one K-run phase-5 step (the main path of the two
    run-axis forms) against K one-run steps from phase 18's fresh states,
    the run-axis kernels at its shapes, and the step timed at
    MULTIRUN_SWEEP's Ks.  ``fused_gaps``: phase 18's K-run step's gaps from
    its one-run steps on the same states (the fused route's own), else taken
    here;
    ``sweep``: phase 18's timing of this route's steps, else taken here."""
    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
        MultiRunStylePipeline,
        unstack_state,
    )

    osconv, wn_fused, gate = modules
    k_runs = MULTIRUN_K
    out = {"k": k_runs}
    t_block = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t_block
        now = time.perf_counter()
        out.setdefault("block_s", {})[what] = now - t_block
        log(f"[op-by-op multirun] {what}: {now - t_block:.1f} s")
        t_block = now

    pair = multirun_pair(make_dataset)
    batch = [torch.as_tensor(np.asarray(a[:BATCH])).cuda() for a in (
        pair["t_train"][0], pair["t_train"][1], pair["s_train"][0], pair["s_train"][1])]
    batch = [b.long() if i % 2 else b for i, b in enumerate(batch)]
    k_batch = [b.expand(k_runs, *b.shape).contiguous() for b in batch]
    _, card_masks = pinned_masks()
    mp = MultiRunStylePipeline(pipe)
    # phase 18's fresh states: its fused-route step's gaps are this step's second control
    fresh = with_wn_ends(mp.init_states(range(k_runs)), torch.Generator().manual_seed(18))
    if fused_gaps is None:
        losses, _, _, grads, _, _ = mp.phase5_grads(fresh, *k_batch, 0, ANCHORS, card_masks)
        fused_gaps = []
        for i in range(k_runs):
            l1, _, _, g1, _, _ = pipe.phase5_grads(unstack_state(fresh, i), *batch, 0, ANCHORS,
                                                   card_masks)
            fused_gaps.append(run_gap(losses, grads, i, l1, g1))
        del losses, grads, l1, g1
        lap("the fused route's K-run step against its one-run steps (the second control)")
    flows, layers = pipe.config.flow.n_flows, pipe.config.flow.wn_layers
    convs = len(pipe.t_ext_specs) + len(pipe.s_ext_specs) + 3 * len(pipe.cls_specs)
    # a merged step: each layer's tap conv forward (pair and infer passes) and its dx once a
    # WN backward (5F), the gate in the forwards; run axes for K runs, one-run kernels for one
    k_expect = {**run.idle(), "os_conv_fwd_runs": convs, "gate_fwd_runs": layers * 2 * flows,
                "tap_conv_fwd_runs": layers * (2 * flows + 5 * flows)}
    one_expect = {**run.idle(), "os_conv_fwd": convs, "gate_fwd": layers * 2 * flows,
                  "tap_conv_fwd": layers * (2 * flows + 5 * flows)}

    with environ(**OP_BY_OP):
        with recorded_calls(osconv, ["tap_conv_fwd_runs"]) as taps, \
                recorded_calls(gate, ["gate_fwd"]) as gates:
            losses, _, _, grads, n_t, n_s = run.drive(
                f"multirun K={k_runs} phase-5 step, op-by-op route",
                lambda: mp.phase5_grads(fresh, *k_batch, 0, ANCHORS, card_masks), k_expect,
                path="multirun op-by-op")
        lap("the K-run step (main path)")
        gaps, control = [], []
        for i in range(k_runs):
            st = unstack_state(fresh, i)
            l1, _, _, g1, nt1, ns1 = run.drive(
                f"one-run phase-5 step {i}, op-by-op route",
                lambda: pipe.phase5_grads(st, *batch, 0, ANCHORS, card_masks), one_expect)
            gaps.append({**run_gap(losses, grads, i, l1, g1),
                         "n_t_rel": rel_err(n_t[i], nt1)[1], "n_s_rel": rel_err(n_s[i], ns1)[1]})
            # the control: how far the same one-run step moves with the plain OS conv
            with plain_convs(osconv, wn_fused, gate, wn=False):
                lp, _, _, gp, _, _ = pipe.phase5_grads(st, *batch, 0, ANCHORS, card_masks)
            control.append(run_gap({k: v[None] for k, v in lp.items()},
                                   {k: [None if g is None else g[None] for g in v]
                                    for k, v in gp.items()}, 0, l1, g1))
            del st, l1, g1, lp, gp
    lap("K one-run steps and their controls")
    worst = {"loss_rel": max(max(g["loss_rel"].values()) for g in gaps),
             "grad_l2_rel": max(max(g["grad_l2_rel"].values()) for g in gaps),
             "n_rel": max(max(g["n_t_rel"], g["n_s_rel"]) for g in gaps),
             "control_grad_l2_rel": max(max(g["grad_l2_rel"].values()) for g in control),
             "fused_route_grad_l2_rel": max(max(g["grad_l2_rel"].values()) for g in fused_gaps)}
    out["step_vs_one_run"] = {"per_run": gaps, "worst": worst, "control_plain_os_conv": control,
                              "control_fused_route": fused_gaps}
    out["launches"] = {"k_runs": {n: v for n, v in k_expect.items() if v},
                       "one_run": {n: v for n, v in one_expect.items() if v}}
    for i, g in enumerate(gaps):
        log(f"  run {i}: loss rel {max(g['loss_rel'].values()):.2e} grads rel L2 "
            f"{ {k: float(f'{v:.2e}') for k, v in g['grad_l2_rel'].items()} }; controls (plain "
            f"OS conv, one run) {max(control[i]['grad_l2_rel'].values()):.2e}, (the fused "
            f"route's K-run step) {max(fused_gaps[i]['grad_l2_rel'].values()):.2e}")
    log(f"[op-by-op multirun phase-5 step, {k_runs} runs vs {k_runs} one-run steps] worst "
        f"{json.dumps(worst)}; launches {json.dumps(out['launches'])}")
    for n in ("os_conv_fwd", "tap_conv_fwd", "gate_fwd"):
        check(k_expect[f"{n}_runs"] == one_expect[n] > 0,
              f"op-by-op: a K-run step's {n}_runs {k_expect[f'{n}_runs']}, a one-run step's {n} "
              f"{one_expect[n]}")
    check(worst["loss_rel"] <= STEP_LOSS_REL_TOL,
          f"op-by-op multirun step losses rel {worst['loss_rel']:.3e}")
    for i, (g, ctl, fused) in enumerate(zip(gaps, control, fused_gaps)):
        for name, v in g["grad_l2_rel"].items():
            allowed = max(MULTIRUN_GRAD_L2_TOL, 2 * ctl["grad_l2_rel"][name],
                          2 * fused["grad_l2_rel"][name])
            check(v <= allowed, f"op-by-op multirun step, run {i} {name}: gradients relative L2 "
                                f"{v:.3e} > {allowed:.3e}")
    del losses, grads, fresh
    torch.cuda.empty_cache()

    # the run-axis forms at the step's shapes
    out["run_axis"] = opbyop_run_axis_rows(osconv, gate, taps["tap_conv_fwd_runs"],
                                           gates["gate_fwd"])
    for name, rows in out["run_axis"].items():
        check(bool(rows), f"phase 23 recorded no {name} call")
    del taps, gates
    torch.cuda.empty_cache()
    lap("the run-axis kernels")

    # the steps timed in a process of its own without CUBLAS_WORKSPACE_CONFIG (phase 18's,
    # which times both routes)
    if sweep is None:
        env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
        proc = subprocess.run([sys.executable, str(REPO / "experiments" / "multirun_time.py"),
                               "--ks", ",".join(map(str, MULTIRUN_SWEEP)), "--routes", "op_by_op"],
                              capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
        check(proc.returncode == 0, f"multirun_time.py --routes op_by_op exited "
                                    f"{proc.returncode}: {proc.stderr[-2000:]}")
        sweep = json.loads(proc.stdout.strip().splitlines()[-1])
    out["sweep"] = sweep
    for k, r in sweep["by_k"].items():
        log(f"[op-by-op multirun K={k}] step ms={r['median_ms']:.1f} series/s="
            f"{r['series_per_s']:.1f} device ms={r['device_ms']:.1f} idle share="
            f"{r['device_idle_share']:.3f} peak MiB={r['peak_mib']:.0f} on {sweep['card']}")
        for name, ms, calls in r["top"]:
            log(f"  {ms:9.3f} ms {calls:6d} x {name}")
    lap("the K-run steps timed (experiments/multirun_time.py --routes op_by_op)")
    return out


# ----------------------------------------------------------------- phase 19 --

def as_bf16(counts: dict) -> dict:
    """Launch counts of f32 kernels as those of their bf16 instances."""
    return {f"{name}[bf16]": n for name, n in counts.items() if f"{name}[bf16]" in BF16}


def bf16_conv_rows(osconv, layers) -> list:
    """``os_conv_fwd[bf16]`` at the six serving convs (the masked weights and
    x of phase 2's shapes, rounded to bf16): against ``os_conv_plain`` in
    bf16 (relative L2), against the f32 kernel on the f32 operands, and
    timed beside the plain version and ``F.conv1d`` in bf16 (cuDNN, the
    library yardstick).  The bound from the mask's live taps at the BF16
    peak and the bytes (``bound_ms``); the effective TFLOP/s on the live
    taps and the share of the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, c_in, c_out, k, mask, _ in layers:
        x32 = torch.randn(BATCH, SCP2["length"] + k - 1, c_in, device="cuda", generator=gen)
        w32 = torch.randn(k, c_in, c_out, device="cuda", generator=gen) / math.sqrt(c_in * k) * mask
        x_pad, w = x32.bfloat16(), w32.bfloat16()
        y = osconv.os_conv(x_pad, w)
        y32 = osconv.os_conv(x32, w32)
        max_abs, rel = rel_l2(y, osconv.os_conv_plain(x_pad, w))
        x_ncw, w_oik = x_pad.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        flops = 2 * BATCH * SCP2["length"] * c_in * int(mask.sum().item())  # live taps only
        row = {
            "layer": name, "c_in": c_in, "c_out": c_out, "k": k, "gflop": flops / 1e9,
            "max_abs": max_abs, "rel_l2": rel, "finite": bool(torch.isfinite(y).all()),
            "vs_f32_rel_l2": rel_l2(y, y32)[1], "same_as_f32": torch.equal(y.float(), y32),
            "library_rel_l2_vs_kernel": rel_l2(F.conv1d(x_ncw, w_oik).transpose(1, 2), y)[1],
            "ms": cuda_ms(lambda: osconv.os_conv(x_pad, w)),
            "f32_ms": cuda_ms(lambda: osconv.os_conv(x32, w32)),
            "plain_ms": cuda_ms(lambda: osconv.os_conv_plain(x_pad, w), reps=5),
            "library_ms": cuda_ms(lambda: F.conv1d(x_ncw, w_oik)),
            "flop_ms": flops / BF16_PEAK * 1e3,
            "bytes_ms": 2 * (x_pad.numel() + w.numel() + y.numel()) / HBM_RATE * 1e3,
        }
        row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
        row["live_tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]  # of the BF16-peak bound
        log("bf16 conv " + json.dumps(row))
        check(row["finite"], f"{name}: os_conv_fwd[bf16] gave a non-finite value")
        check(rel <= BF16_REL_L2, f"{name}: os_conv_fwd[bf16] rel L2 {rel:.3e} vs plain")
        check(not row["same_as_f32"] and row["vs_f32_rel_l2"] <= BF16_VS_F32_REL_L2,
              f"{name}: os_conv_fwd[bf16] vs the f32 kernel {row['vs_f32_rel_l2']:.3e}")
        rows.append(row)
    return rows


WN_OUTPUTS = {"fwd": ("y", "aud", "skip"),
              "bwd": ("gx", "gws", "gbs", "gwc", "gbc", "gwi", "gbi", "gwr", "gbr", "gwe", "gbe")}


def wn_bf16_gaps(wn_fused, d: str, args) -> dict:
    """One bf16 WN call, ``d`` "fwd" or "bwd" on ``args`` (its operands, no
    flag), on the kernel against the plain versions with ``bf16=True``, each
    output by relative L2: ``tight`` where no earlier rounding carries in
    (each forward layer from the kernel's own input to it,
    ``wn_fwd_plain_layers``; the backward's top layer and end projection),
    ``rel_l2`` free-running, ``effect`` the switch's own (plain bf16 against
    plain f32); the controls, the plain versions with float64 sums
    (``f64_sums``) against themselves with f32 sums, on the same outputs
    (``tight_control``, ``control``); ``outs`` the kernel's."""
    kern = wn_fused.wn_fwd if d == "fwd" else wn_fused.wn_bwd
    plain_fn = wn_fused.wn_fwd_plain if d == "fwd" else wn_fused.wn_bwd_plain
    got, want, f32 = kern(*args, True), plain_fn(*args, True), plain_fn(*args)

    def layers():
        return wn_fused.wn_fwd_plain_layers(args[0], got[1], got[2], *args[1:], True)

    with f64_sums(wn_fused):
        exact = plain_fn(*args, True)
        forced_exact = layers() if d == "fwd" else None
    if d == "fwd":
        forced = layers()
        tight = {n: (g, f, e) for n, g, f, e in zip(("layer inputs", "skip", "y"),
                                                      (got[1], got[2], got[0]), forced, forced_exact)}
    else:
        n_layers, c = args[7].shape[0], args[7].shape[2]
        top = slice(2 * c * (n_layers - 1), 2 * c * n_layers)
        tight = {"top " + n: (got[i][sl], want[i][sl], exact[i][sl]) for i, n, sl in (
            (3, "gwc", (slice(None), top)), (4, "gbc", top), (5, "gwi", -1), (6, "gbi", -1),
            (7, "gwr", -1), (8, "gbr", -1), (9, "gwe", ...), (10, "gbe", ...))}
    errs = [rel_l2(a, w) for a, w in zip(got, want)]
    names = WN_OUTPUTS[d]
    return {
        "tight_rel_l2": {n: rel_l2(a, w)[1] for n, (a, w, _) in tight.items()},
        "tight_control_rel_l2": {n: rel_l2(w, e)[1] for n, (_, w, e) in tight.items()},
        "rel_l2": dict(zip(names, (e[1] for e in errs))),
        "effect_rel_l2": dict(zip(names, (rel_l2(w, f)[1] for w, f in zip(want, f32)))),
        "control_rel_l2": dict(zip(names, (rel_l2(w, e)[1] for w, e in zip(want, exact)))),
        "max_abs": max(e[0] for e in errs),
        "finite": all(bool(torch.isfinite(a).all()) for a in got),
        "outs": got,
    }


def check_wn_bf16(what: str, gaps: dict) -> None:
    """``wn_bf16_gaps`` gated: non-finite values; the tight outputs within
    BF16_REL_L2 or BF16_FLIPS times their control (a sum that cancels
    magnifies a flip: the phase-5 step's gradients do); the free-running
    ones within BF16_CASCADE of the effect."""
    check(gaps["finite"], f"{what}: a non-finite value")
    for n, v in gaps["tight_rel_l2"].items():
        bar = max(BF16_REL_L2, BF16_FLIPS * gaps["tight_control_rel_l2"][n])
        check(v <= bar, f"{what}: {n} rel L2 {v:.3e} vs plain > {bar:.3e}")
    for n, v in gaps["rel_l2"].items():
        bar = max(BF16_REL_L2, BF16_CASCADE * gaps["effect_rel_l2"][n])
        check(v <= bar, f"{what}: free-running {n} rel L2 {v:.3e} vs plain > {bar:.3e}")


def one_live_layer(eff, j: int) -> list:
    """Stacked effective WN weights with every layer's in-projection zero but
    layer ``j``'s: then no layer's input gradient carries another's rounding
    down (the residual passes it through exactly), and the whole backward is
    within a few roundings of its operands."""
    w_in = torch.zeros_like(eff[4])
    w_in[j] = eff[4][j]
    return eff[:4] + [w_in] + eff[5:]


def bf16_wn_rows(wn_fused, wn_init, weight_norm_weight, cases, c: int, n_layers: int) -> dict:
    """``wn_fwd[bf16]`` and ``wn_bwd[bf16]`` at each of ``cases`` (what, B, T,
    n_half), phase 6's inputs, against the plain versions with ``bf16=True``
    (``wn_bf16_gaps``, ``check_wn_bf16``).  The same bits twice; y against
    the f32 kernel's.  Timed beside the plain versions and the f32 kernels,
    with the device time by ``__global__`` kernel, taken in a process of its
    own (``experiments/wn_time.py --bf16 --breakdown``; the note at BF16_ENV
    says why), the launches of each checked against
    ``wn_fused.global_kernels``.  At the last case, each
    layer's own arithmetic (``one_live_layer``, the layer's dilation): every
    output of both within BF16_FLIPS times its control, or BF16_REL_L2."""
    rows = {"wn_fwd[bf16]": [], "wn_bwd[bf16]": []}
    for what, b, t, h in cases:
        eff = random_wn(wn_init, wn_fused, weight_norm_weight, h, c, n_layers, seed=b + h)
        gen = torch.Generator(device="cuda").manual_seed(b)
        x2 = torch.randn(b * t, h, device="cuda", generator=gen)
        g2 = torch.randn(b * t, 2 * h, device="cuda", generator=gen)
        _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t, True)
        args = {"fwd": (x2, *eff, t),
                "bwd": (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)}
        work = wn_work(b, t, h, c, n_layers)
        for d in ("fwd", "bwd"):
            kern = wn_fused.wn_fwd if d == "fwd" else wn_fused.wn_bwd
            plain_fn = wn_fused.wn_fwd_plain if d == "fwd" else wn_fused.wn_bwd_plain
            gaps = wn_bf16_gaps(wn_fused, d, args[d])
            outs = gaps.pop("outs")
            again = kern(*args[d], True)
            f32_kernel = kern(*args[d])[:1] if d == "fwd" else kern(*args[d])
            torch.cuda.synchronize()
            fn = lambda: kern(*args[d], True)  # noqa: E731
            row = {
                "shape": what, "rows": b * t, "t": t, "n_half": h, "c": c, "layers": n_layers,
                **gaps,
                "deterministic": all(torch.equal(a, r) for a, r in zip(outs, again)),
                "vs_f32_rel_l2": max(rel_l2(a, f)[1] for a, f in zip(outs, f32_kernel)),
                "same_as_f32": all(torch.equal(a, f) for a, f in zip(outs, f32_kernel)),
                "ms": cuda_ms(fn, reps=5),
                "f32_ms": cuda_ms(lambda: kern(*args[d]), reps=5),
                "plain_ms": cuda_ms(lambda: plain_fn(*args[d], True), reps=3),
                "library_ms": None,
                "gflop": work[f"{d}_flops"] / 1e9,
                "flop_ms": work[f"{d}_flops"] / BF16_PEAK * 1e3,
                "tf32_flop_ms": work[f"{d}_flops"] / TC_PEAK * 1e3,
                "bytes_ms": work[f"{d}_bytes"] / HBM_RATE * 1e3,
                "global_launches_per_call": wn_fused.global_launches(n_layers, True)[f"wn_{d}"],
            }
            row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
            log(f"bf16 wn_{d} " + json.dumps(row))
            check_wn_bf16(f"wn_{d}[bf16] {what}", row)
            check(row["deterministic"], f"wn_{d}[bf16] {what}: two runs gave different bits")
            check(not row["same_as_f32"] and row["vs_f32_rel_l2"] <= BF16_VS_F32_REL_L2,
                  f"wn_{d}[bf16] {what}: against the f32 kernel {row['vs_f32_rel_l2']:.3e}")
            rows[f"wn_{d}[bf16]"].append(row)
    # the device time and launches by __global__ kernel of each call, in a process of its own
    # (the note at BF16_ENV says why), checked against wn_fused.global_kernels
    proc = subprocess.run([sys.executable, str(REPO / "experiments" / "wn_time.py"), "--bf16",
                           "--breakdown"], capture_output=True, text=True, timeout=600, cwd=REPO)
    check(proc.returncode == 0, f"wn_time.py --bf16 --breakdown exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    fresh = {(r["shape"], r["direction"]): r["by_kernel"] for r in (
        json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
        if line.startswith("breakdown "))}
    for d in ("fwd", "bwd"):
        for row in rows[f"wn_{d}[bf16]"]:
            row["by_kernel"] = fresh[(row["shape"], d)]
            row["launches_by_kernel"] = check_breakdown(
                f"wn_{d}[bf16] {row['shape']}", row["by_kernel"],
                wn_fused.global_kernels(n_layers, bf16=True)[f"wn_{d}"])
            log(f"[bf16 wn_{d} {row['shape']}] by kernel, in a process of its own: "
                f"{json.dumps(row['by_kernel'])}")
    # each layer alone (the last case's shape and inputs)
    live = []
    for j in range(n_layers):
        eff_j = one_live_layer(eff, j)
        _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff_j, t, True)
        lj = {"layer": j, "dilation": 2 ** j}
        for d, a in (("fwd", (x2, *eff_j, t)), ("bwd", (x2, g2, aud, skip, eff_j[0], eff_j[2],
                                                         eff_j[3], eff_j[4], eff_j[5], eff_j[6],
                                                         eff_j[8], t))):
            gaps = wn_bf16_gaps(wn_fused, d, a)
            lj[d] = {k: gaps[k] for k in ("rel_l2", "control_rel_l2")}
            for n, v in gaps["rel_l2"].items():
                bar = max(BF16_REL_L2, BF16_FLIPS * gaps["control_rel_l2"][n])
                check(v <= bar, f"wn_{d}[bf16] {what}, layer {j} alone: {n} rel L2 {v:.3e} vs "
                                f"plain > {bar:.3e}")
        live.append(lj)
    log(f"[bf16 wn, one live layer at a time, {what}] " + json.dumps(live))
    rows["wn_bwd[bf16]"][-1]["one_live_layer"] = live
    return rows


def bf16_step_calls(osconv, wn_fused, conv_calls, wn_calls) -> dict:
    """Every bf16 kernel call of one phase-5 step (``recorded_calls`` with
    ``every``) again on its own operands against the plain versions: each
    ``os_conv_fwd[bf16]`` call within BF16_REL_L2 or BF16_FLIPS times its
    control (the plain conv with float64 sums), each WN call as
    ``check_wn_bf16`` holds it.  The worst of each kernel."""
    worst = {"os_conv_fwd[bf16]": {"calls": 0, "rel_l2": 0.0, "control_rel_l2": 0.0}}
    for i, (x_pad, w) in enumerate(conv_calls.values()):
        want = osconv.os_conv_plain(x_pad, w)
        rel = rel_l2(osconv.os_conv(x_pad, w), want)[1]
        ctl = rel_l2(osconv.os_conv_plain(x_pad.double(), w.double()).to(want.dtype), want)[1]
        check(rel <= max(BF16_REL_L2, BF16_FLIPS * ctl),
              f"os_conv_fwd[bf16], call {i} of the bf16 step {list(x_pad.shape)}: rel L2 "
              f"{rel:.3e} vs plain, control {ctl:.3e}")
        r = worst["os_conv_fwd[bf16]"]
        r["calls"] += 1
        r["rel_l2"], r["control_rel_l2"] = max(r["rel_l2"], rel), max(r["control_rel_l2"], ctl)
    for name in ("wn_fwd", "wn_bwd"):
        r = worst[f"{name}[bf16]"] = {"calls": 0, "tight_rel_l2": 0.0, "rel_l2_over_effect": 0.0}
        for i, args in enumerate(wn_calls[name].values()):
            check(args[-1] is True, f"{name} call {i} of the bf16 step without the bf16 flag")
            gaps = wn_bf16_gaps(wn_fused, name[3:], args[:-1])
            check_wn_bf16(f"{name}[bf16], call {i} of the bf16 step", gaps)
            r["calls"] += 1
            r["tight_rel_l2"] = max([r["tight_rel_l2"], *gaps["tight_rel_l2"].values()])
            r["rel_l2_over_effect"] = max([r["rel_l2_over_effect"], *(
                v / max(gaps["effect_rel_l2"][n], 1e-30) for n, v in gaps["rel_l2"].items()
                if v > BF16_REL_L2)])
    log(f"[bf16 phase-5 step, every kernel call on its own operands vs plain] {json.dumps(worst)}")
    return worst


def bf16_phase(run, pipe, state, datasets, batch, modules, layers, wn_fns, make_dataset,
               gradnorm_step, smi) -> dict:
    """Phase 19: both bf16 switches, FLSTTSC_WN_MXU=bf16 and
    PipelineConfig.compute_dtype="bfloat16", on phase 8's pair."""
    import dataclasses

    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
        MultiRunData,
        MultiRunStylePipeline,
    )

    osconv, wn_fused, gate = modules
    wn_init, weight_norm_weight = wn_fns
    out = {}
    t_block = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t_block
        now = time.perf_counter()
        out.setdefault("block_s", {})[what] = now - t_block
        log(f"[bf16] {what}: {now - t_block:.1f} s")
        t_block = now

    cfg16 = dataclasses.replace(pipe.config, compute_dtype="bfloat16")
    pipe16 = type(pipe)(*pipe.t_shape, *pipe.s_shape, cfg16, device="cuda")
    flows = cfg16.flow.n_flows
    convs = len(pipe16.t_ext_specs) + len(pipe16.s_ext_specs) + 3 * len(pipe16.cls_specs)

    # the drives: one phase-5 epoch through StyleTransferPipeline.run from
    # phase 8's state, and K runs of one through MultiRunStylePipeline.run
    expect = {**run.idle(), **as_bf16(expected_training_launches(pipe16, TRAIN_SERIES,
                                                                 RESUME_EPOCHS))}
    with environ(**BF16_ENV), watched_phase5(type(pipe)) as (step_s, first):
        _, history = run.drive("training, both bf16 switches", lambda: pipe16.run(
            *datasets, epochs=RESUME_EPOCHS, state=copy.deepcopy(state), seed=0, verbose=False),
            expect, path="bf16")
    out["drive"] = {"step_s": step_s, "phase5": check_history("training bf16", history, first[0])}
    data = MultiRunData.broadcast(multirun_pair(make_dataset), MULTIRUN_K)
    mp16 = MultiRunStylePipeline(pipe16)
    expect = {**run.idle(), **as_bf16(expected_multirun_launches(pipe16, TRAIN_SERIES,
                                                                 RESUME_EPOCHS))}
    with environ(**BF16_ENV):
        _, k_history = run.drive(f"multirun K={MULTIRUN_K}, both bf16 switches", lambda: mp16.run(
            data, list(range(MULTIRUN_K)), epochs=RESUME_EPOCHS), expect, path="bf16")
    out["multirun_drive_last"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                                  for k, v in k_history[-1].items()}
    lap("the drives")

    # one full-width phase-5 step of a fresh state (phase 9's) with both
    # switches: launches, every kernel call of it held against the plain
    # version on its own operands, the step against the free-running plain
    # bf16 path on the card and against the f32 step, then traced in a process of its own
    g = torch.Generator().manual_seed(21)
    fresh = with_wn_ends(pipe16.init_state(g), g)
    _, card_masks = pinned_masks()

    def once(p, *ctxs, st=fresh):
        return phase5_once(p, st, batch, card_masks, gradnorm_step, stacked(*ctxs), st["gradnorm"])

    for m in modules:
        m.reset_launch_counts()
    with recorded_calls(osconv, ["os_conv"], every=True) as step_convs, \
            recorded_calls(wn_fused, ["wn_fwd", "wn_bwd"], every=True) as step_wns:
        kern = once(pipe16, environ(**BF16_ENV))
    launched = run.counts()
    for m in modules:
        m.reset_launch_counts()
    f32 = once(pipe)
    f32_launched = run.counts()
    want = {**run.idle(), "os_conv_fwd[bf16]": convs, "wn_fwd[bf16]": 2 * flows,
            "wn_bwd[bf16]": 5 * flows}
    check(launched == want, f"bf16 phase-5 step launches {launched} != {want}")
    check({k: v for k, v in as_bf16(f32_launched).items() if v}
          == {k: v for k, v in launched.items() if v},
          f"bf16 phase-5 step launches {launched}, the f32 step's {f32_launched}")
    out["step_calls"] = bf16_step_calls(osconv, wn_fused, step_convs["os_conv"], step_wns)
    del step_convs, step_wns
    torch.cuda.empty_cache()
    plain = once(pipe16, environ(**BF16_ENV), plain_convs(osconv, wn_fused, gate))
    row = phase5_gap(kern, plain)
    row["vs_f32"] = phase5_gap(kern, f32)
    # the controls: the plain bf16 step against itself with some of its sums in float64
    for what, ctx in {"control, f64 sums in conv and WN": f64_sums(wn_fused, osconv),
                      "control, f64 sums in WN": f64_sums(wn_fused),
                      "control, f64 sums in conv": f64_sums(osconv=osconv)}.items():
        gap = phase5_gap(once(pipe16, environ(**BF16_ENV), plain_convs(osconv, wn_fused, gate),
                              ctx), plain)
        row[what] = {key: gap[key] for key in ("loss_rel", "grad_l2_rel")}
    controls = [row[k] for k in row if k.startswith("control")]
    row["launches"] = {k: v for k, v in launched.items() if v}
    row["grads_and_norms_s"] = {"kernel": kern["secs"], "plain": plain["secs"], "f32": f32["secs"]}
    row["losses_f32"] = {n: float(v) for n, v in f32["losses"].items()}
    row["control_loss_spread"] = {n: max(c["loss_rel"][n] for c in controls)
                                  for n in row["loss_rel"]}
    row["control_grad_spread"] = {n: max(c["grad_l2_rel"][n] for c in controls)
                                  for n in row["grad_l2_rel"]}
    row["losses_not_held"] = sorted(n for n, v in row["control_loss_spread"].items()
                                    if v > BF16_LOSS_NOISE)
    log(f"[phase-5 step, both bf16 switches, kernels vs plain bf16 on the card, checked] "
        f"{json.dumps(row)} on {smi}")
    check(set(row["losses_not_held"]) <= set(BF16_NOISY_LOSSES),
          f"bf16 phase-5 losses {row['losses_not_held']} at the noise floor, named "
          f"{sorted(BF16_NOISY_LOSSES)}")
    for n, v in kern["losses"].items():
        check(bool(torch.isfinite(v).all()), f"bf16 phase-5 loss {n} is not finite")
        allowed = max(STEP_LOSS_REL_TOL, 2 * row["control_loss_spread"][n])
        check(row["loss_rel"][n] <= allowed, f"bf16 phase-5 loss {n}: kernels vs plain bf16 rel "
                                             f"{row['loss_rel'][n]:.3e} > {allowed:.3e}")
        l32 = row["losses_f32"][n]
        check(n in row["losses_not_held"] or abs(float(v) - l32) <= BF16_LOSS_TOL * (1 + abs(l32)),
              f"bf16 phase-5 loss {n} {float(v):.6g} against the f32 step's {l32:.6g}")
    check(any(float(v) != float(f32["losses"][n]) for n, v in kern["losses"].items()),
          "the bf16 phase-5 losses equal the f32 step's: the switches did not engage")
    for n, v in row["grad_l2_rel"].items():
        allowed = max(STEP_GRAD_L2_TOL, 2 * row["control_grad_spread"][n])
        check(v <= allowed, f"bf16 phase-5 grads, {n}: relative L2 {v:.3e} vs plain bf16 > "
                            f"{allowed:.3e}")
    # the step traced in a process of its own (the note at BF16_ENV says why), its inputs the
    # same shapes, its WN launches checked complete (profile_step)
    proc = subprocess.run([sys.executable, str(REPO / "experiments" / "phase5_step_time.py"),
                           "--bf16", "--steps", "2"], capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    check(proc.returncode == 0, f"phase5_step_time.py --bf16 exited {proc.returncode}: "
                                f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    for line in proc.stdout.strip().splitlines()[:-1]:
        log(line)
    out["profile"] = json.loads(proc.stdout.strip().splitlines()[-1])["profile"]
    out["step"] = row
    lap("the one-run step")

    # the kernels alone: the six serving convs, the WN at pair + infer
    out["conv_rows"] = bf16_conv_rows(osconv, layers)
    out["wn_rows"] = bf16_wn_rows(
        wn_fused, wn_init, weight_norm_weight,
        [("pair", 2 * BATCH, SCP2["length"], pipe.feat_channels // 2),
         ("infer", BATCH, SCP2["length"], pipe.feat_channels // 2)],
        cfg16.flow.wn_channels, cfg16.flow.wn_layers)
    lap("the one-run kernels")

    # the run-axis forms at the shapes of one K-run phase-5 step
    fresh_k = with_wn_ends(mp16.init_states(range(MULTIRUN_K)), torch.Generator().manual_seed(19))
    k_batch = [b.expand(MULTIRUN_K, *b.shape).contiguous() for b in batch]
    with environ(**BF16_ENV), recorded_calls(osconv, ["os_conv_runs"]) as k_convs, \
            recorded_calls(wn_fused, ["wn_fwd_runs", "wn_bwd_runs"]) as k_wns:
        k_losses = mp16.phase5_grads(fresh_k, *k_batch, 0, ANCHORS, card_masks)[0]
    for n, v in k_losses.items():
        check(bool(torch.isfinite(v).all()), f"bf16 K-run phase-5 loss {n} is not finite")
    rows_k = run_axis_rows(osconv, wn_fused, k_convs["os_conv_runs"], {}, k_wns, bf16=True)
    del fresh_k, k_convs, k_wns
    torch.cuda.empty_cache()
    lap("the run-axis kernels")

    out["rows"] = {"os_conv_fwd[bf16]": out["conv_rows"], **out["wn_rows"],
                   **{f"{name}[bf16]": r for name, r in rows_k.items() if r}}
    return out


# ----------------------------------------------------------------- phase 20 --

# PipelineConfig's GradNorm / optimizer knobs, by the names of
# experiments/phase5_step_time.py and multirun_time.py --knob
KNOBS = {"merged": {}, "unmerged": {"merged_pullbacks": False},
         "stacked": {"stacked_pullbacks": True}, "fused_opt": {"fused_optimizers": True}}
# Unmerged against merged pulls: the total's gradients are the same pull (the same bits under
# deterministic algorithms), and the trunk norms, which a merged pull sums with exact zeros
# across the trunks, and the GradNorm weights made from them, within JAX's rtol
# (tests/test_multirun.py:220).
KNOB_NORM_REL_TOL = 1e-6
# The fused RMSprop against the per-module torch RMSprop on the same gradients: the same
# element operations (torch's foreach RMSprop on the card divides through addcdiv, the fused
# update multiplies, then divides), within JAX's atol (tests/test_pipeline.py:140).
FUSED_OPT_ATOL = 1e-5
# The last two outputs of wn_bwd / wn_bwd_runs, the end projection's gradients, are taken
# outside the kernel by one library product (batched for the run axis; wn_fused._unpack): sums
# over every row in another order, held to GRAD_REL_TOL (on an H100 a stacked call's read
# 1.3e-5 from the one-cotangent call's at the pair pass, 46,080 rows)
WN_BWD_LIBRARY_OUTPUTS = 2


def knob_state(kpipe, fresh):
    """A copy of ``fresh``'s params, model state and constants in a training
    state of ``kpipe``'s config (its optimizer layout)."""
    models = copy.deepcopy({k: fresh[k] for k in ("params", "mstate", "consts")})
    return kpipe.training_state(models, 21)


def knob_step(kpipe, state, batch, masks, update: bool = True) -> dict:
    """One pinned phase-5 step of ``state`` (its pulls, and with ``update``
    GradNorm and the module updates): the losses, the gradients of the
    total, n_t, n_s, and after the update the GradNorm weights."""
    losses, new_m, _, grads, n_t, n_s = kpipe.phase5_grads(state, *batch, 0, ANCHORS, masks)
    out = {"losses": {k: v.detach() for k, v in losses.items()},
           "grads": {k: [None if g is None else g.detach() for g in gs] for k, gs in grads.items()},
           "n_t": n_t, "n_s": n_s}
    if update:
        kpipe._phase5_update(state, losses, new_m, grads, n_t, n_s)
        out["w_t"] = state["gradnorm"]["t"].weights.detach().clone()
        out["w_s"] = state["gradnorm"]["s"].weights.detach().clone()
    return out


def grads_l2_gap(got: dict, want: dict, run: int | None = None) -> dict:
    """Per module the relative L2 distance of ``got``'s gradients (run
    ``run`` of K-leading ones) from ``want``'s; a missing gradient is 0."""
    out = {}
    for name, gs in want.items():
        d2 = n2 = 0.0
        for a, b in zip(got[name], gs):
            a = None if a is None else (a if run is None else a[run])
            if a is None and b is None:
                continue
            a = torch.zeros_like(b) if a is None else a
            b = torch.zeros_like(a) if b is None else b
            d2 += float(((a - b) ** 2).sum())
            n2 += float((b ** 2).sum())
        out[name] = math.sqrt(d2 / n2) if n2 > 0 else math.sqrt(d2)
    return out


def cotangents_vs_one_call(wn_fused, calls, runs_per_call: int) -> dict:
    """Every recorded ``wn_bwd_runs`` call of a stacked pull, each of its
    cotangents (every ``runs_per_call``-th run block, one-run calls here)
    against the one-cotangent ``wn_bwd`` on the same operands: the kernel's
    outputs the same bits; the end projection's two gradients, one batched
    library product outside the kernel, within GRAD_REL_TOL."""
    same, library_rel, n = True, 0.0, 0
    for args in calls.values():
        tensors, (t_len, bf16) = args[:-2], args[-2:]
        check(args[0].shape[0] == runs_per_call,
              f"a stacked wn_bwd_runs call of {args[0].shape[0]} runs, {runs_per_call} expected")
        got = wn_fused.wn_bwd_runs(*tensors, t_len, bf16)
        for c in range(runs_per_call):
            one = wn_fused.wn_bwd(*(t[c] for t in tensors), t_len, bf16)
            kernel = len(one) - WN_BWD_LIBRARY_OUTPUTS
            same = same and all(torch.equal(a[c], b) for a, b in zip(got[:kernel], one[:kernel]))
            library_rel = max([library_rel] + [rel_err(a[c], b)[1] for a, b in
                                               zip(got[kernel:], one[kernel:])])
            n += 1
    return {"cotangents": n, "kernel_outputs_same_bits": same, "library_outputs_rel": library_rel}


def stacked_call_ms(wn_fused, calls, work) -> dict:
    """One recorded stacked ``wn_bwd_runs`` call (the pair pass's, 3
    cotangents) timed against its three one-cotangent ``wn_bwd`` calls, with
    three one-run calls' bound."""
    args = max(calls.values(), key=lambda a: a[0].shape[1])
    tensors, (t_len, bf16) = args[:-2], args[-2:]
    n = tensors[0].shape[0]
    row = {"runs": n, "rows": tensors[0].shape[1],
           "ms": cuda_ms(lambda: wn_fused.wn_bwd_runs(*tensors, t_len, bf16), reps=3),
           "one_call_ms": cuda_ms(lambda: [wn_fused.wn_bwd(*(t[c] for t in tensors), t_len, bf16)
                                           for c in range(n)], reps=3) / n}
    peak = (BF16_PEAK if bf16 else TC_PEAK / TF32_PRODUCTS)
    row["bound_ms"] = n * max(work["bwd_flops"] / peak, work["bwd_bytes"] / HBM_RATE) * 1e3
    return row


def knobs_phase(run, pipe, modules, batch, smi) -> dict:
    """Phase 20: PipelineConfig's GradNorm / optimizer knobs
    (``merged_pullbacks=False``, ``stacked_pullbacks=True``,
    ``fused_optimizers=True``) at full width on phase 8's pair."""
    import dataclasses

    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import (
        MultiRunStylePipeline,
        stack_states,
        unstack_state,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves

    osconv, wn_fused, gate = modules
    out = {}
    t_block = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t_block
        now = time.perf_counter()
        out.setdefault("block_s", {})[what] = now - t_block
        log(f"[knobs] {what}: {now - t_block:.1f} s")
        t_block = now

    cfg = pipe.config
    pipes = {k: type(pipe)(*pipe.t_shape, *pipe.s_shape, dataclasses.replace(cfg, **v),
                           device=pipe.device) if v else pipe for k, v in KNOBS.items()}
    flows, layers = cfg.flow.n_flows, cfg.flow.wn_layers
    convs = len(pipe.t_ext_specs) + len(pipe.s_ext_specs) + 3 * len(pipe.cls_specs)
    one_step = {**run.idle(), "os_conv_fwd": convs, "wn_fwd": 2 * flows}
    # WN backward calls of one step: a flow's pair pass is reached by the total, t_nf (+ s_nf)
    # and s2t2s_c, its infer pass by the total and s2t2s_c; the classifier pulls reach neither
    expect = {"merged": {**one_step, "wn_bwd": 5 * flows},
              "unmerged": {**one_step, "wn_bwd": 6 * flows},
              "stacked": {**one_step, "wn_bwd_runs": 2 * flows},
              "fused_opt": {**one_step, "wn_bwd": 5 * flows}}
    g = torch.Generator().manual_seed(21)
    fresh = with_wn_ends(pipe.init_state(g), g)  # phase 9's fresh state, again
    _, masks = pinned_masks()
    lap("the pipelines and phase 9's fresh state")

    # (a) the four configurations on one step, every kernel on, deterministic
    steps = {}
    with deterministic(), recorded_calls(wn_fused, ["wn_bwd_runs"], every=True) as rec:
        for knob, kpipe in pipes.items():
            state = knob_state(kpipe, fresh)
            steps[knob] = run.drive(f"knobs: phase-5 step {knob}",
                                    lambda: knob_step(kpipe, state, batch, masks), expect[knob])
            steps[knob]["params"] = [p.detach().clone() for p in leaves(state["params"])]
            del state
    merged, unmerged, stacked, fused = (steps[k] for k in KNOBS)
    lap("(a) the steps")
    row = {"unmerged_total_grads_same_bits": all(
        (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
        for m in merged["grads"] for a, b in zip(unmerged["grads"][m], merged["grads"][m]))}
    row["unmerged_rel"] = {n: rel_err(unmerged[n], merged[n])[1]
                           for n in ("n_t", "n_s", "w_t", "w_s")}
    row["stacked_grad_l2_rel"] = grads_l2_gap(stacked["grads"], merged["grads"])
    row["stacked_rel"] = {n: rel_err(stacked[n], merged[n])[1] for n in ("n_t", "n_s")}
    row["stacked_loss_rel"] = {n: rel_err(v, merged["losses"][n])[1]
                               for n, v in stacked["losses"].items()}
    row["stacked_cotangents"] = cotangents_vs_one_call(wn_fused, rec["wn_bwd_runs"], 3)
    row["stacked_wn_bwd_runs"] = stacked_call_ms(
        wn_fused, rec["wn_bwd_runs"], wn_work(2 * BATCH, pipe.t_shape[1], pipe.feat_channels // 2,
                                              cfg.flow.wn_channels, layers))
    row["fused_params_max_abs"] = max(float((a - b).abs().max())
                                      for a, b in zip(fused["params"], merged["params"]))
    del rec
    lap("(a) the stacked calls against one-cotangent calls, and timed")
    log(f"[knobs, one step of each, deterministic] {json.dumps(row)} on {smi}")
    check(row["unmerged_total_grads_same_bits"], "unmerged pulls: the total's gradients differ")
    for n, v in row["unmerged_rel"].items():
        check(v <= KNOB_NORM_REL_TOL, f"unmerged pulls: {n} rel {v:.3e} against merged")
    for n, v in row["stacked_grad_l2_rel"].items():
        check(v <= STEP_GRAD_L2_TOL, f"stacked pulls: {n} gradients relative L2 {v:.3e}")
    for n, v in {**row["stacked_rel"], **row["stacked_loss_rel"]}.items():
        check(v <= STEP_LOSS_REL_TOL, f"stacked pulls: {n} rel {v:.3e} against unstacked")
    cot = row["stacked_cotangents"]
    check(cot["cotangents"] == 3 * 2 * flows and cot["kernel_outputs_same_bits"],
          f"stacked wn_bwd_runs against one-cotangent wn_bwd: {cot}")
    check(cot["library_outputs_rel"] <= GRAD_REL_TOL, f"stacked wn_bwd_runs' end gradients: {cot}")
    check(row["fused_params_max_abs"] <= FUSED_OPT_ATOL,
          f"fused optimizers: params {row['fused_params_max_abs']:.3e} from the per-module step")
    # the fused update with a module outside the step: one phase-1 step
    xb, yb = batch[0][None], batch[1][None]
    p1 = {}
    for knob in ("merged", "fused_opt"):
        state = knob_state(pipes[knob], fresh)
        before = {m: [p.detach().clone() for p in leaves(ps)]
                  for m, ps in state["params"].items()}
        with deterministic():
            pipes[knob].phase1_epoch(state, xb, yb, cpc_anchor=ANCHORS[0])
        p1[knob] = ({m: [p.detach().clone() for p in leaves(ps)]
                     for m, ps in state["params"].items()}, before)
        del state
    stepped = ("t_ext", "t_cls", "cpc")
    untouched = all(torch.equal(a, b) for m, ps in p1["fused_opt"][0].items() if m not in stepped
                    for a, b in zip(ps, p1["fused_opt"][1][m]))
    p1_abs = max(float((a - b).abs().max()) for m in stepped
                 for a, b in zip(p1["fused_opt"][0][m], p1["merged"][0][m]))
    row["fused_phase1"] = {"others_untouched": untouched, "stepped_max_abs": p1_abs}
    check(untouched, "fused optimizers: a module outside the phase-1 step moved")
    check(p1_abs <= FUSED_OPT_ATOL, f"fused optimizers: phase-1 params {p1_abs:.3e} off")
    del p1
    lap("(a) the fused phase-1 step")

    # (a) the op-by-op route: the stacked pull's folded tap-conv input gradients
    op = {}
    tap = layers * 2 * flows  # the forward's tap convs
    op_expect = {"merged": {**run.idle(), "os_conv_fwd": convs, "gate_fwd": layers * 2 * flows,
                            "tap_conv_fwd": tap + layers * 5 * flows},
                 "stacked": {**run.idle(), "os_conv_fwd": convs, "gate_fwd": layers * 2 * flows,
                             "tap_conv_fwd": tap + layers * 2 * flows}}
    with environ(**OP_BY_OP), deterministic():
        for knob in ("merged", "stacked"):
            state = knob_state(pipes[knob], fresh)
            op[knob] = run.drive(f"knobs: op-by-op phase-5 pulls {knob}",
                                 lambda: knob_step(pipes[knob], state, batch, masks, update=False),
                                 op_expect[knob])
            del state
    row["op_by_op"] = {"grad_l2_rel": grads_l2_gap(op["stacked"]["grads"], op["merged"]["grads"]),
                       **{n: rel_err(op["stacked"][n], op["merged"][n])[1] for n in ("n_t", "n_s")},
                       "tap_conv_fwd": {k: v["tap_conv_fwd"] for k, v in op_expect.items()}}
    log(f"[knobs, op-by-op route, stacked vs merged pulls] {json.dumps(row['op_by_op'])}")
    for n, v in row["op_by_op"]["grad_l2_rel"].items():
        check(v <= STEP_GRAD_L2_TOL, f"op-by-op stacked pulls: {n} gradients relative L2 {v:.3e}")
    for n in ("n_t", "n_s"):
        check(row["op_by_op"][n] <= STEP_LOSS_REL_TOL, f"op-by-op stacked pulls: {n} off")
    out["step"] = row
    del steps, merged, unmerged, stacked, fused, op
    torch.cuda.empty_cache()
    lap("(a) the op-by-op route")

    # (b) K runs at once, fused optimizers and stacked pulls, from the same K states
    k_runs = MULTIRUN_K
    k_batch = [b.expand(k_runs, *b.shape).contiguous() for b in batch]
    k_expect = {"stacked": {**run.idle(), "os_conv_fwd_runs": convs, "wn_fwd_runs": 2 * flows,
                            "wn_bwd_runs": 2 * flows},
                "fused_opt": {**run.idle(), "os_conv_fwd_runs": convs, "wn_fwd_runs": 2 * flows,
                              "wn_bwd_runs": 5 * flows}}
    out["multirun"] = {}
    # each run's models once (as MultiRunStylePipeline.init_states draws them), in the
    # training state of each knob
    k_models = [pipe.init_models(torch.Generator().manual_seed(s)) for s in range(k_runs)]
    lap("(b) the runs' models")
    ksteps = {}
    for knob in ("fused_opt", "stacked"):
        kpipe = pipes[knob]
        mp = MultiRunStylePipeline(kpipe)
        states = with_wn_ends(stack_states([kpipe.training_state(copy.deepcopy(m), s + 1)
                                            for s, m in enumerate(k_models)]),
                              torch.Generator().manual_seed(18))
        ones = [unstack_state(states, i) for i in range(k_runs)]
        with recorded_calls(wn_fused, ["wn_bwd_runs"]) as rec:
            kstep = ksteps[knob] = run.drive(
                f"knobs: K={k_runs} phase-5 step {knob}",
                lambda: knob_step(mp, states, k_batch, masks, update=False), k_expect[knob])
        runs_a_call = sorted({a[0].shape[0] for a in rec["wn_bwd_runs"].values()})
        k_row = {"wn_bwd_runs_runs": runs_a_call, "per_run": []}
        check(runs_a_call == [(3 if knob == "stacked" else 1) * k_runs],
              f"K={k_runs} {knob}: wn_bwd_runs took {runs_a_call} runs a call")
        if knob == "fused_opt":
            # the (K, N) fused update against each run's one-run fused update, same gradients
            # (its pulls are the default merged ones, which phase 18 holds against one run's)
            kpipe._phase5_update(states, kstep["losses"], states["mstate"], kstep["grads"],
                                 kstep["n_t"], kstep["n_s"])
            worst = 0.0
            for i, st in enumerate(ones):
                kpipe._phase5_update(st, {n: v[i] for n, v in kstep["losses"].items()},
                                     st["mstate"], {m: [None if g is None else g[i] for g in gs]
                                                    for m, gs in kstep["grads"].items()},
                                     kstep["n_t"][i], kstep["n_s"][i])
                worst = max([worst] + [float((a[i] - b).detach().abs().max()) for a, b in
                                       zip(leaves(states["params"]), leaves(st["params"]))])
            k_row["update_max_abs"] = worst
            log(f"[knobs, K={k_runs} fused update vs {k_runs} one-run updates] max abs "
                f"{worst:.3e}; wn_bwd_runs runs a call {runs_a_call}")
            check(worst <= FUSED_OPT_ATOL,
                  f"K={k_runs} fused update {worst:.3e} from the one-run updates")
        # the stacked pulls against the same K runs' merged pulls (the fused step's), and
        # against K one-run stacked pulls; where a module's gap passes MULTIRUN_GRAD_L2_TOL, its
        # controls: phase 18's (the one-run step with the plain OS conv) and the merged K-run
        # step's own gap from the one-run merged step, which vmap's other summation order
        # moves as far on some states (PERF.md, PR 16)
        merged_k = ksteps["fused_opt"]
        for i, st in enumerate(ones if knob == "stacked" else ()):
            one = knob_step(kpipe, st, batch, masks, update=False)
            gap = {"loss_rel": max(rel_err(kstep["losses"][n][i], v)[1]
                                   for n, v in one["losses"].items()),
                   "n_rel": max(rel_err(kstep[n][i], one[n])[1] for n in ("n_t", "n_s")),
                   "grad_l2_rel": grads_l2_gap(kstep["grads"], one["grads"], i),
                   "vs_merged_k_grad_l2_rel": grads_l2_gap(
                       kstep["grads"], {m: [None if g is None else g[i] for g in gs]
                                        for m, gs in merged_k["grads"].items()}, i)}
            over = [n for n, v in gap["grad_l2_rel"].items() if v > MULTIRUN_GRAD_L2_TOL]
            if over:
                with plain_convs(osconv, wn_fused, gate, wn=False):
                    ctl = knob_step(kpipe, st, batch, masks, update=False)
                one_merged = knob_step(pipes["merged"], st, batch, masks, update=False)
                gap["control_grad_l2_rel"] = grads_l2_gap(ctl["grads"], one["grads"])
                gap["merged_k_grad_l2_rel"] = grads_l2_gap(merged_k["grads"],
                                                           one_merged["grads"], i)
            for n in over:
                allowed = 2 * max(gap["control_grad_l2_rel"][n], gap["merged_k_grad_l2_rel"][n])
                check(gap["grad_l2_rel"][n] <= allowed,
                      f"K={k_runs} stacked, run {i} {n}: gradients relative L2 "
                      f"{gap['grad_l2_rel'][n]:.3e} > {MULTIRUN_GRAD_L2_TOL} and twice the "
                      f"controls {allowed / 2:.3e}")
            for n, v in gap["vs_merged_k_grad_l2_rel"].items():
                check(v <= STEP_GRAD_L2_TOL, f"K={k_runs} stacked, run {i} {n}: relative L2 "
                                             f"{v:.3e} from the merged K-run step")
            check(gap["loss_rel"] <= STEP_LOSS_REL_TOL and gap["n_rel"] <= STEP_LOSS_REL_TOL,
                  f"K={k_runs} stacked, run {i}: {gap}")
            k_row["per_run"].append(gap)
        if knob == "stacked":
            k_row["worst"] = {key: max(max(g[key].values()) if isinstance(g[key], dict)
                                       else g[key] for g in k_row["per_run"])
                              for key in ("loss_rel", "n_rel", "grad_l2_rel",
                                          "vs_merged_k_grad_l2_rel")}
            log(f"[knobs, K={k_runs} stacked step vs {k_runs} one-run steps and the merged K-run "
                f"step] {json.dumps(k_row['worst'])}; wn_bwd_runs runs a call {runs_a_call}")
        out["multirun"][knob] = k_row
        del states, ones, mp
        torch.cuda.empty_cache()
        lap(f"(b) K runs at once, {knob}")
    del k_models, ksteps

    # (c) the bf16 stacked step: each cotangent of wn_bwd_runs[bf16] against wn_bwd[bf16]
    state = knob_state(pipes["stacked"], fresh)
    with environ(**BF16_ENV), deterministic():
        with recorded_calls(wn_fused, ["wn_bwd_runs"], every=True) as rec:
            bf = run.drive("knobs: bf16 stacked phase-5 pulls",
                           lambda: knob_step(pipes["stacked"], state, batch, masks, update=False),
                           {**run.idle(), "os_conv_fwd": convs, "wn_fwd[bf16]": 2 * flows,
                            "wn_bwd_runs[bf16]": 2 * flows})
        cot16 = cotangents_vs_one_call(wn_fused, rec["wn_bwd_runs"], 3)
        cot16["wn_bwd_runs[bf16]"] = stacked_call_ms(
            wn_fused, rec["wn_bwd_runs"], wn_work(2 * BATCH, pipe.t_shape[1],
                                                  pipe.feat_channels // 2, cfg.flow.wn_channels,
                                                  layers))
    del state, rec
    check(all(bool(torch.isfinite(v)) for v in bf["losses"].values()), "bf16 stacked: losses")
    out["bf16_stacked"] = cot16
    log(f"[knobs, bf16 stacked pulls] {json.dumps(cot16)}")
    check(cot16["cotangents"] == 3 * 2 * flows and cot16["kernel_outputs_same_bits"],
          f"stacked wn_bwd_runs[bf16] against one-cotangent wn_bwd[bf16]: {cot16}")
    check(cot16["library_outputs_rel"] <= GRAD_REL_TOL, f"bf16 stacked end gradients: {cot16}")
    del fresh, pipes, bf
    torch.cuda.empty_cache()
    lap("(c) the bf16 stacked step")

    # The knobs' K-run steps are timed outside chip_smoke.py (experiments/multirun_time.py
    # --knob, phase 18's method), to leave room for phases 22-23.
    return out


# ----------------------------------------------------------------- phase 21 --

# Phase 21: time-sharded sequence parallelism (parallel/sequence.py) at full width on EigenWorms'
# shape (UEA archive, 6 channels x 17,984 steps, 5 classes; synthetic data from the seed),
# PipelineConfig()'s batch (20), layer specs (receptive field min(T/4, 89) = 89) and flow, over
# SEQ_RANKS rank processes that share the one card.  NCCL refuses two ranks on one card, so the
# ranks run gloo, which stages CUDA tensors through the host itself.
SEQ_SHAPE = {"channels": 6, "length": 17984, "classes": 5}
SEQ_RANKS = 4  # T / 4 = 4,496 steps a shard, at least the widest halo (128)
SEQ_BACKEND = "cpu:gloo,cuda:gloo"
SEQ_SEED = 41
# Outputs and new running statistics: max|sharded - unsharded| within SEQ_ATOL of max(1, max|out|),
# the JAX package's tests' atol 1e-5 on outputs of order one (theirs are), scaled where an output
# is larger: the flow's z reaches 1,455 here (exp(log_s), log_s up to 4.8), where one float32 ulp
# is 1.2e-4.  On an H100 z sat 2.0e-3 (1.4e-6 of its largest value) from the unsharded ops,
# log_s 2.3e-6 to 1.4e-5 (values up to 4.8), the features 2.4e-6.
SEQ_ATOL = 1e-5
SEQ_LOGDET_RTOL = 1e-5
# The input gradient, and each module's gradients summed over the ranks (relative L2), against
# the unsharded step with the sharded run's ReLU sign patterns pinned (``ReluSigns``) and the
# OS conv's transposed convs (``OSConvCore``'s backward, cuDNN) in float64
# (``f64_os_conv_bwd``): within SEQ_GRAD_REL_L2, or within SEQ_GRAD_FACTOR times the same
# unsharded step's own gap with float32 transposed convs.
# * Pinned signs: a last-bit difference of the training-mode BatchNorm statistics (the sharded
#   op's E[x^2] - mean^2 over the ranks against the port's two-pass variance) moves a ReLU input
#   within rounding of zero to the other side, and one such flip moves a gradient summed over
#   360k rows by about 1e-3 of itself.  On an H100, 3 flips of layer 1's 81M ReLU inputs and 2
#   of the final ReLU's 18M put the extractor's and the input's gradients 3e-4 to 6e-4 from the
#   unsharded ones; eval mode (the same features, bit for bit) put them 2e-7 to 9e-6, and the
#   flow's gradient at the features sat 2.3e-6 (experiments/sequence_grad_gap.py).
# * Float64 transposed convs: cuDNN's float32 weight gradient of layer 1 (25 -> 225 channels,
#   K = 89) sums 360k rows a tap; with the signs pinned that layer's gradients sat 2.4e-5 from
#   the unsharded float32 step, every other module 5e-7 to 4.5e-6, and the unsharded float32
#   step sat 2.8e-5 from the float64 one in that layer, 0 to 7e-7 elsewhere (on an H100).
# The unpinned gaps and the flips are recorded.
SEQ_GRAD_REL_L2 = 1e-5
SEQ_GRAD_FACTOR = 2.0
SEQ_TIMEOUT = 300.0  # the ranks' deadline, spawn and import included
SEQ_REPS = 3  # timed forward+backward passes after the counted one


def sequence_inputs(batch: int) -> dict:
    """Phase 21's inputs on the current card, the same bits in every
    process: x (B, T, C) from the seed; the extractor at the layer specs
    ``PipelineConfig()`` gives the shape, with random BatchNorm state; the
    flow (``PipelineConfig().flow``, n_group the extractor's channels), its
    WN end projections WN_END_SCALE N(0, 1) (the init's zero end hides the
    WN's gradients) and each 1x1 mixing scaled per column by U(0.8, 1.25)
    (the init's rotation has log|det| 0); and the fixed projections of (z,
    log_s, log-determinants) whose sum is differentiated."""
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import waveglow_init
    from feature_level_style_transfer_for_tsc_tpu_torch.models.os_cnn import (
        os_block_masks,
        os_cnn_res_init,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import BNStats
    from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels
    from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import build_specs

    cfg, fc = PipelineConfig(), PipelineConfig().flow
    c, t = SEQ_SHAPE["channels"], SEQ_SHAPE["length"]
    specs, _ = build_specs(c, t, cfg)
    g = torch.Generator().manual_seed(SEQ_SEED)
    rng = np.random.default_rng(SEQ_SEED)
    ext_p, ext_s = os_cnn_res_init(g, specs, "cuda")
    ext_p, ext_s = with_random_bn(ext_p, rng, BNStats), with_random_bn(ext_s, rng, BNStats)
    n_group = total_out_channels(specs[-1])
    flow_p = waveglow_init(g, fc.n_flows, n_group, fc.wn_channels, fc.wn_layers, "cuda")
    for conv, wn in zip(flow_p["convinv"], flow_p["wn"]):
        conv["weight"] = conv["weight"] * (0.8 + 0.45 * torch.rand(n_group, generator=g)).cuda()
        wn["end"]["weight"] = WN_END_SCALE * torch.randn(wn["end"]["weight"].shape, generator=g).cuda()
    gc = torch.Generator(device="cuda").manual_seed(SEQ_SEED)
    return {
        "specs": specs, "ext_p": ext_p, "ext_s": ext_s, "masks": os_block_masks(specs, "cuda"),
        "flow_p": flow_p, "n_wn": fc.wn_channels,
        "x": torch.randn(batch, t, c, generator=g).cuda(),
        "proj_z": torch.randn(batch, t, n_group, device="cuda", generator=gc),
        "proj_ls": [torch.randn(batch, t, n_group // 2, device="cuda", generator=gc)
                    for _ in range(fc.n_flows)],
        "proj_ld": torch.randn(fc.n_flows, generator=g).cuda(),
    }


def sequence_step(inp: dict, seq=None, mesh=None) -> dict:
    """One pass of phase 21: the extractor in training mode (its features
    feed the flow) and in eval mode (no gradient), the flow's density
    direction, and the gradient of the projection of (z, log_s,
    log-determinants) with respect to the input and every parameter.  Over
    ``mesh``'s "data" axis through ``seq`` (``parallel.sequence``) when a
    mesh is given, each rank's share of the projection its own rows and 1/P
    of the replicated log-determinants' term; else the unsharded ops (the
    op-by-op WN, as ``OP_BY_OP`` sets it)."""
    from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import tree_items
    from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import waveglow_forward
    from feature_level_style_transfer_for_tsc_tpu_torch.models.os_cnn import os_cnn_res_apply

    params = {"ext": inp["ext_p"], "flow": inp["flow_p"]}
    leaves = list(tree_items(params))
    for _, p in leaves:
        p.requires_grad_(True)
        p.grad = None
    if mesh is None:
        parts = 1
        x, proj_z, proj_ls = inp["x"].clone(), inp["proj_z"], inp["proj_ls"]

        def ext(training):
            return os_cnn_res_apply(params["ext"], inp["ext_s"], inp["masks"], x, training)

        def flow(f):
            return waveglow_forward(params["flow"], f, inp["n_wn"])
    else:
        parts = mesh.size(0)
        x = seq.shard_time(inp["x"], mesh)
        proj_z = seq.shard_time(inp["proj_z"], mesh)
        proj_ls = [seq.shard_time(p, mesh) for p in inp["proj_ls"]]

        def ext(training):
            return seq.time_sharded_os_cnn_res_apply(mesh, params["ext"], inp["ext_s"],
                                                     inp["masks"], x, training=training)

        def flow(f):
            return seq.time_sharded_waveglow_forward(mesh, params["flow"], f, inp["n_wn"])

    x.requires_grad_(True)
    features, new_state = ext(True)
    with torch.no_grad():
        features_eval, _ = ext(False)
    z, log_s, log_det = flow(features)
    loss = (z * proj_z).sum() + sum((ls * p).sum() for ls, p in zip(log_s, proj_ls)) \
        + (torch.stack(log_det) * inp["proj_ld"]).sum() / parts
    loss.backward()
    return {"features": features.detach(), "features_eval": features_eval,
            "state": dict(tree_items(new_state)), "z": z.detach(),
            "log_s": [ls.detach() for ls in log_s], "log_det": torch.stack(log_det).detach(),
            "dx": x.grad, "grads": {k: p.grad for k, p in leaves}}


class ReluSigns:
    """``torch.relu`` inside the ``with`` block records the sign pattern of
    each call's input (``masks``, on the CPU, in call order) or, given
    ``pinned`` patterns, follows them in call order: the input passes where
    its pattern says, whatever its sign, and ``flips`` counts, call by call,
    the inputs on the other side of zero.  Phase 21's reference for the
    gradients takes the sharded run's patterns (see SEQ_GRAD_REL_L2)."""

    def __init__(self, pinned=None):
        self.pinned = pinned
        self.masks, self.flips = [], []

    def __enter__(self):
        self.relu = torch.relu

        def relu(y):
            if self.pinned is None:
                self.masks.append((y > 0).cpu())
                return self.relu(y)
            mask = self.pinned[len(self.flips)].to(y.device)
            self.flips.append(int((mask != (y > 0)).sum()))
            return torch.where(mask, y, torch.zeros_like(y))

        torch.relu = relu
        return self

    def __exit__(self, *exc):
        torch.relu = self.relu


@contextlib.contextmanager
def f64_os_conv_bwd(osconv):
    """``OSConvCore``'s backward (the transposed convs) in float64 inside,
    its results rounded to float32: a more exact order of the same sums."""
    f32 = osconv._os_conv_bwd

    def bwd(x_pad, w, g, need_dx, need_dw):
        dx, dw = f32(x_pad.double(), w.double(), g.double(), need_dx, need_dw)
        return tuple(None if d is None else d.float() for d in (dx, dw))

    osconv._os_conv_bwd = bwd
    try:
        yield
    finally:
        osconv._os_conv_bwd = f32


def to_cpu(tree):
    """A copy of a tree of dicts, lists and tensors with every tensor
    detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_cpu(v) for v in tree]
    return tree


def timed_steps(fn, reps: int = SEQ_REPS, barrier=None) -> list:
    """Host seconds of ``reps`` calls, each between ``synchronize()``s (and
    ``barrier()``s, so that ranks start together)."""
    out = []
    for _ in range(reps):
        if barrier:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def sequence_rank(rank: int, world: int, init_method: str, out_dir: str, batch: int) -> dict:
    """One rank of phase 21, in a process of its own: joins the gloo group,
    checks that gloo takes CUDA tensors in ``all_gather`` and
    ``all_reduce``, runs ``sequence_step`` once over the mesh with the
    launch counts set to 0 just before and read just after, saves its
    shards, gradient shares and ReLU sign patterns to ``out_dir``, then
    times SEQ_REPS more."""
    import torch.distributed as dist

    from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch, make_mesh
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import sequence as seq

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    with launch.process_group(rank, world, init_method, SEQ_BACKEND, timeout=SEQ_TIMEOUT):
        mesh = make_mesh(data=world, device="cuda")
        probe = torch.full((3,), float(rank + 1), device="cuda")
        gathered = [torch.empty_like(probe) for _ in range(world)]
        dist.all_gather(gathered, probe)
        dist.all_reduce(probe)
        collectives_ok = (probe.tolist() == [world * (world + 1) / 2] * 3
                          and [p[0].item() for p in gathered] == [r + 1.0 for r in range(world)])
        inp = sequence_inputs(batch)
        ready_s = time.perf_counter() - t_start
        modules = (osconv, wn_fused, gate)
        for m in modules:
            m.reset_launch_counts()
        with ReluSigns() as signs:
            out = sequence_step(inp, seq, mesh)
        torch.cuda.synchronize()
        counts = {name: n for m in modules for name, n in m.LAUNCHES.items()}
        torch.save({**to_cpu(out), "relu_signs": signs.masks}, Path(out_dir) / f"rank{rank}.pt")
        del out
        torch.cuda.reset_peak_memory_stats()
        step_s = timed_steps(lambda: sequence_step(inp, seq, mesh), barrier=dist.barrier)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        backend = str(dist.get_backend())
    return {"rank": rank, "device": torch.cuda.current_device(), "backend": backend,
            "collectives_on_cuda_tensors": collectives_ok, "ready_s": ready_s, "counts": counts,
            "step_s": step_s, "peak_mib": peak_mib}


def module_of(key: str) -> str:
    """The module a parameter key of ``sequence_step``'s tree belongs to:
    an extractor layer, the shortcut, a flow's 1x1 mixing or its WN."""
    if key.startswith("['ext']['block']['layers']"):
        return "extractor layer " + key.split("[")[4].rstrip("]")
    if key.startswith("['ext']"):
        return "extractor shortcut"
    kind, k = key.split("[")[2:4]
    return f"flow {kind.strip(chr(39) + ']')} {k.rstrip(']')}"


def sequence_kernel_rows(osconv, gate, inp, shard: int) -> dict:
    """Each kernel of the sharded path at its shard shapes against its plain
    version on the card, timed beside it, its bound and, for the convs,
    ``F.conv1d``: ``os_conv_fwd`` on each extractor layer's halo-extended
    shard, ``tap_conv_fwd`` at the WN's dilations (C -> 2C on the shard
    padded by d a side), ``gate_fwd`` on the shard's rows (b a column
    slice of a cond projection)."""
    import torch.nn.functional as F

    from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels

    gen = torch.Generator(device="cuda").manual_seed(SEQ_SEED + 1)
    b = inp["x"].shape[0]
    rows = {"os_conv_fwd": [], "tap_conv_fwd": [], "gate_fwd": []}

    def conv_row(what, x, w, y, plain_fn, kernel_fn, lib_fn, flops):
        n_bytes = 4 * (x.numel() + w.numel() + y.numel())
        err, rel = rel_err(y, plain_fn())
        row = {**what, "max_abs": err, "rel": rel, "ms": cuda_ms(kernel_fn),
               "plain_ms": cuda_ms(plain_fn, reps=5), "library_ms": cuda_ms(lib_fn),
               "gflop": flops / 1e9, "tc_flop_ms": TF32_PRODUCTS * flops / TC_PEAK * 1e3,
               "bytes_ms": n_bytes / HBM_RATE * 1e3}
        row["bound_ms"] = max(row["tc_flop_ms"], row["bytes_ms"])
        return row

    for i, (spec, mask) in enumerate(zip(inp["specs"], inp["masks"])):
        c_in, c_out, k = spec[0][0], total_out_channels(spec), spec[-1][-1]
        x = torch.randn(b, shard + k - 1, c_in, device="cuda", generator=gen)
        w = torch.randn(k, c_in, c_out, device="cuda", generator=gen) / math.sqrt(c_in * k) * mask
        x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        row = conv_row({"layer": i, "c_in": c_in, "c_out": c_out, "k": k}, x, w,
                       osconv.os_conv(x, w), lambda: osconv.os_conv_plain(x, w),
                       lambda: osconv.os_conv(x, w), lambda: F.conv1d(x_ncw, w_oik),
                       2 * b * shard * c_in * int(mask.sum().item()))
        rows["os_conv_fwd"].append(row)
    fc_ch, n_layers = inp["n_wn"], len(inp["flow_p"]["wn"][0]["in_layers"])
    for j in range(n_layers):
        d = 2 ** j
        x = torch.randn(b, shard + 2 * d, fc_ch, device="cuda", generator=gen)
        w = torch.randn(3, fc_ch, 2 * fc_ch, device="cuda", generator=gen) / math.sqrt(3 * fc_ch)
        x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        row = conv_row({"dilation": d, "c_in": fc_ch, "c_out": 2 * fc_ch}, x, w,
                       osconv.tap_conv_fwd(x, w, d), lambda: osconv.tap_conv_plain(x, w, d),
                       lambda: osconv.tap_conv_fwd(x, w, d),
                       lambda: F.conv1d(x_ncw, w_oik, dilation=d), 2 * b * shard * 3 * fc_ch * 2 * fc_ch)
        rows["tap_conv_fwd"].append(row)
    n_rows = b * shard
    a, b_view = gate_operands(n_rows, fc_ch, n_layers, gen)
    err, rel = rel_err(gate.gate_fwd(a, b_view, fc_ch), gate.gate_plain(a, b_view, fc_ch))
    n_bytes = 4 * (2 * n_rows * 2 * fc_ch + n_rows * fc_ch)
    row = {"rows": n_rows, "n": fc_ch, "max_abs": err, "rel": rel,
           "ms": cuda_ms(lambda: gate.gate_fwd(a, b_view, fc_ch), reps=20),
           "plain_ms": cuda_ms(lambda: gate.gate_plain(a, b_view, fc_ch), reps=20),
           "library_ms": None, "bytes_ms": n_bytes / HBM_RATE * 1e3,
           "flop_ms": GATE_OPS * n_rows * fc_ch / FP32_PEAK * 1e3}
    row["bound_ms"] = max(row["bytes_ms"], row["flop_ms"])
    rows["gate_fwd"].append(row)
    torch.cuda.synchronize()
    for name, rs in rows.items():
        for r in rs:
            log(f"[sequence kernel {name}] " + json.dumps(r))
            check(r["rel"] <= REL_TOL, f"{name} at the shard shapes {r}: rel err {r['rel']:.3e}")
    return rows


def sequence_phase(run, modules, smi) -> dict:
    """Phase 21: the time-sharded extractor and flow over SEQ_RANKS ranks
    on the one card, against the same unsharded ops on the card (the
    gradients against those with the ranks' ReLU sign patterns pinned and
    float64 transposed convs);
    each kernel at the shard shapes against its plain version; exact
    launches a rank, added to the main path's as the "sequence" path."""
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch

    osconv, wn_fused, gate = modules
    batch = PipelineConfig().batch_size
    out = {"backend": SEQ_BACKEND, "ranks": SEQ_RANKS, "batch": batch, **SEQ_SHAPE}
    torch.cuda.empty_cache()
    inp = sequence_inputs(batch)
    fc = PipelineConfig().flow
    n_ext = len(inp["specs"])
    expect = {**run.idle(), "os_conv_fwd": 2 * n_ext, "gate_fwd": fc.n_flows * fc.wn_layers,
              "tap_conv_fwd": 2 * fc.n_flows * fc.wn_layers}  # forward, and dx in the backward
    # the unsharded ops on the card, the op-by-op WN as the ranks run it (counted apart)
    torch.cuda.reset_peak_memory_stats()
    with environ(**OP_BY_OP):
        ref = to_cpu(run.drive("sequence unsharded", lambda: sequence_step(inp), expect))
        out["unsharded_step_s"] = timed_steps(lambda: sequence_step(inp))
    out["unsharded_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    shard = SEQ_SHAPE["length"] // SEQ_RANKS
    out["kernels"] = sequence_kernel_rows(osconv, gate, inp, shard)
    del inp
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as d:
        t0 = time.perf_counter()
        ranks = launch.spawn(sequence_rank, SEQ_RANKS, (f"file://{d}/rendezvous", d, batch),
                             timeout=SEQ_TIMEOUT)
        out["spawn_wall_s"] = time.perf_counter() - t0
        shards = [torch.load(Path(d) / f"rank{r}.pt") for r in range(SEQ_RANKS)]
    for r in ranks:
        log(f"[sequence rank {r['rank']}] cuda:{r['device']} backend={r['backend']} gloo takes "
            f"CUDA tensors in all_gather and all_reduce: {r['collectives_on_cuda_tensors']} "
            f"ready after {r['ready_s']:.1f} s, launches={r['counts']}, fwd+bwd s="
            f"{[round(s, 4) for s in r['step_s']]}, peak MiB={r['peak_mib']:.0f}")
        check(r["collectives_on_cuda_tensors"], f"rank {r['rank']}: gloo collectives on CUDA tensors")
        check(r["counts"] == expect, f"rank {r['rank']}: launches {r['counts']} != {expect}")
    out["rank_results"] = ranks
    out["host_staging"] = "none explicit: gloo copies CUDA tensors through the host itself"
    log(f"[sequence] backend {SEQ_BACKEND}; halos and statistics through the host: "
        f"{out['host_staging']}")
    run.add("sequence 4 ranks", {n: sum(r["counts"][n] for r in ranks) for n in expect},
            path="sequence")

    def cat(key, k=None):
        return torch.cat([s[key] if k is None else s[key][k] for s in shards], dim=1)

    gaps = {}
    for name, got, want in (
        ("features (training BN)", cat("features"), ref["features"]),
        ("features (eval BN)", cat("features_eval"), ref["features_eval"]),
        ("z", cat("z"), ref["z"]),
        *((f"log_s {k}", cat("log_s", k), ref["log_s"][k]) for k in range(len(ref["log_s"]))),
    ):
        scale = max(1.0, want.abs().max().item())
        gaps[name] = (got - want).abs().max().item() / scale
        log(f"[sequence] {name}: max abs {gaps[name] * scale:.3e}, largest |value| {scale:.3e}")
        check(gaps[name] <= SEQ_ATOL, f"sequence {name}: max abs {gaps[name] * scale:.3e} "
                                      f"> {SEQ_ATOL} x {scale:.3e}")
    for s in shards:
        stats = max((s["state"][k] - v).abs().max().item() for k, v in ref["state"].items())
        gaps["new BN stats"] = max(gaps.get("new BN stats", 0.0), stats)
        ld = ((s["log_det"] - ref["log_det"]).abs() / ref["log_det"].abs()).max().item()
        gaps["log_det rel"] = max(gaps.get("log_det rel", 0.0), ld)
    check(gaps["new BN stats"] <= SEQ_ATOL, f"sequence new BN stats: {gaps['new BN stats']:.3e}")
    check(gaps["log_det rel"] <= SEQ_LOGDET_RTOL, f"sequence log_det: {gaps['log_det rel']:.3e}")
    # the gradients against the unsharded step that takes the ranks' ReLU sign patterns, its
    # transposed convs in float64 (``exact``), and in float32 (``pinned``: its own gap)
    signs = [torch.cat([s["relu_signs"][i] for s in shards], dim=1)
             for i in range(len(shards[0]["relu_signs"]))]
    inp = sequence_inputs(batch)
    with environ(**OP_BY_OP):
        with ReluSigns(pinned=signs) as pinned_signs:
            pinned = to_cpu(sequence_step(inp))
        with ReluSigns(pinned=signs), f64_os_conv_bwd(osconv):
            exact = to_cpu(sequence_step(inp))
    del inp
    torch.cuda.empty_cache()
    summed = {k: sum(s["grads"][k] for s in shards) for k in ref["grads"]}
    keys_of = {"input": ["dx"]}
    for k in ref["grads"]:
        keys_of.setdefault(module_of(k), []).append(k)

    def flat(tree, keys):
        return torch.cat([(tree["dx"] if k == "dx" else tree["grads"][k]).flatten() for k in keys])

    sharded = {"dx": cat("dx"), "grads": summed}
    grads = {m: rel_l2(flat(sharded, ks), flat(exact, ks))[1] for m, ks in keys_of.items()}
    own = {m: rel_l2(flat(pinned, ks), flat(exact, ks))[1] for m, ks in keys_of.items()}
    vs_f32 = {m: rel_l2(flat(sharded, ks), flat(pinned, ks))[1] for m, ks in keys_of.items()}
    unpinned = {m: rel_l2(flat(sharded, ks), flat(ref, ks))[1] for m, ks in keys_of.items()}
    out["gaps"], out["grad_rel_l2"], out["unsharded_grad_rel_l2"] = gaps, grads, own
    out["grad_rel_l2_vs_f32_pinned"], out["unpinned_grad_rel_l2"] = vs_f32, unpinned
    out["relu_flips"] = {"calls": pinned_signs.flips, "inputs": [m.numel() for m in signs]}
    log(f"[sequence] vs unsharded on the card: {json.dumps(gaps)}; ReLU flips a call (layer 0, "
        f"layer 1, features; training then eval) {pinned_signs.flips} of "
        f"{out['relu_flips']['inputs']}; gradients (relative L2) against the pinned float64-"
        f"backward reference {json.dumps(grads)}, the unsharded float32 step's own "
        f"{json.dumps(own)}; against the pinned float32 step {json.dumps(vs_f32)}, the unpinned "
        f"{json.dumps(unpinned)}")
    for mod, g in grads.items():
        bar = max(SEQ_GRAD_REL_L2, SEQ_GRAD_FACTOR * own[mod])
        check(g <= bar, f"sequence gradient of {mod}: relative L2 {g:.3e} > {bar:.3e} "
                        f"(the unsharded step's own {own[mod]:.3e})")
    rank_s = [statistics.median(r["step_s"]) for r in ranks]
    out["rank_step_median_s"], out["unsharded_step_median_s"] = rank_s, statistics.median(
        out["unsharded_step_s"])
    log(f"[sequence] forward+backward s: a rank (4 share the card) {[round(s, 4) for s in rank_s]}, "
        f"unsharded {out['unsharded_step_median_s']:.4f}; spawn to joined "
        f"{out['spawn_wall_s']:.1f} s; on {smi}")
    return out


# ----------------------------------------------------------------- phase 22 --

# Phase 22: data parallelism (parallel/dp.py, parallel/dp_explicit.py) at full width on phase 8's
# pair (SCP2 <- EthanolLevel shapes, PipelineConfig(budget_multiplier=1.0)) with BATCH series a
# domain, DP_RANKS rank processes sharing the card on gloo as phase 21's (BATCH / DP_RANKS = 5 a
# rank), and the domain-sharded ensemble, DP_RANKS members one a rank.
DP_RANKS = 4
DP_SEED = 22
DP_SERIES = 40  # the ensemble's train and test splits
DP_TIMEOUT = 300.0  # the ranks' deadline, spawn and import included
DP_REPS = 1  # timed data-parallel phase-5 steps a rank after its drives (the first is cold)
# Gradients, each module's, against the unsharded step that takes the ranks' ReLU sign patterns,
# its OS conv's transposed convs in float64 (phase 21's reference): within DP_GRAD_REL_L2
# (relative L2), or DP_GRAD_FACTOR times the same unsharded step's own gap with float32
# transposed convs.  The global moments' last bits flip ReLU inputs within rounding of zero, as
# in phase 21.
DP_GRAD_REL_L2 = 1e-5
DP_GRAD_FACTOR = 2.0
# The configurations phase 22 also takes a data-parallel phase-5 step under: (PipelineConfig
# knobs, environment).  The float32 ones are held as the default step; the bf16 ones (BF16_DP)
# sit at the bf16 noise floor, where each quantity is held to the unsharded step within its
# gate or DP_GRAD_FACTOR times the largest gap between two correct unsharded bf16 steps, the
# controls (``dp_bf16_against``, measured in the same run and printed): the plain bf16 path on
# the card; the OS convs over the batch in DP_RANKS micro-batches (a bf16 conv's weight
# gradient is rounded to bf16 once a call, so a batch split four ways rounds four partial sums,
# as each rank's share does); the batch's rows in another order.
DP_CONFIGS = {
    "unmerged": ({"merged_pullbacks": False}, {}),
    "stacked": ({"stacked_pullbacks": True}, {}),
    "fused_optimizers": ({"fused_optimizers": True}, {}),
    "compute_dtype": ({"compute_dtype": "bfloat16"}, {}),
    "wn_mxu": ({}, BF16_ENV),
    "op_by_op": ({}, OP_BY_OP),
}
BF16_DP = ("compute_dtype", "wn_mxu")
# phases 2-4, one data-parallel step each of phase 8's config: (phase, supervised)
DP_EPOCHS = {"phase 2 step": (2, None), "phase 3 step": (3, True),
             "phase 4 step supervised": (4, True), "phase 4 step unsupervised": (4, False)}


def dp_inputs(cfg) -> dict:
    """Phase 22's models, states and data, the same bits in every process:
    phase 8's pipe, a fresh state with WN end projections (``with_wn_ends``,
    as phase 9's), a batch of BATCH series a domain and the pinned dropout
    multipliers; a target-shaped classifier without CPC and its state;
    DP_RANKS ensemble members with random BatchNorm state, and the
    ensemble's train and test splits."""
    from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import BNStats
    from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import OSCNNClassifier
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

    c, t, n = SCP2["channels"], SCP2["length"], SCP2["classes"]
    e_c, e_t, e_n = ETHANOL["channels"], ETHANOL["length"], ETHANOL["classes"]
    pipe = StyleTransferPipeline(c, t, n, e_c, e_t, e_n, cfg, device="cuda")
    g = torch.Generator().manual_seed(DP_SEED)
    state = with_wn_ends(pipe.init_state(g), g)
    rng = np.random.default_rng(DP_SEED)

    def series(b, length, ch, classes):
        return (torch.from_numpy(rng.standard_normal((b, length, ch)).astype(np.float32)).cuda(),
                torch.from_numpy(rng.integers(0, classes, b)).long().cuda())

    batch = (*series(BATCH, t, c, n), *series(BATCH, e_t, e_c, e_n))
    clf = OSCNNClassifier(c, t, n, config=cfg, with_cpc=False, device="cuda")
    members = [with_random_bn(clf.init_models(torch.Generator().manual_seed(DP_SEED + 1 + i)),
                              rng, BNStats) for i in range(DP_RANKS)]
    splits = [types.SimpleNamespace(x=x.cpu().numpy(), y=y.cpu().numpy())
              for x, y in (series(DP_SERIES, t, c, n) for _ in range(2))]
    return {"pipe": pipe, "state": state, "batch": batch, "masks": pinned_masks()[1],
            "clf": clf, "clf_state": clf.init_state(torch.Generator().manual_seed(DP_SEED)),
            "members": members, "splits": splits}


def digest(tree) -> str:
    """A hash of every tensor's bits in a tree of dicts, lists and tensors."""
    h = hashlib.sha256()
    for t in _tensor_leaves(tree):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def recorded_grads(model) -> list:
    """Each optimizer step's gradients by module (on the CPU), recorded
    from the model's ``_apply_updates``."""
    seen = []
    apply = model._apply_updates

    def record(state, names, grads):
        seen.append({n: [None if g is None else g.detach().cpu() for g in grads[n]] for n in names})
        return apply(state, names, grads)

    model._apply_updates = record
    return seen


def config_pipe(pipe, knobs: dict):
    """``pipe``'s shapes under its config with ``knobs`` replaced."""
    import dataclasses

    if not knobs:
        return pipe
    return type(pipe)(*pipe.t_shape, *pipe.s_shape, dataclasses.replace(pipe.config, **knobs),
                      device=pipe.device)


def dp_step_record(pipe, state, step, gradnorm_step, keep_grads: bool, signs=None) -> dict:
    """What phase 22 keeps of one phase-5 step's pulls (``phase5_grads``'s
    output): the losses, norms, the GradNorm weights one update would give,
    the new BatchNorm statistics, the gradients (``keep_grads``) and their
    digest, and the ReLU sign patterns ``signs`` recorded."""
    losses, new_m, _, grads, n_t, n_s = step
    gn = copy.deepcopy(state["gradnorm"])
    vec = torch.stack([losses[k] for k in ("t_nf", "t_c", "s_nf", "s_c", "s2t2s_c")]).detach()
    g = pipe.config.gradnorm
    gradnorm_step(gn["t"], vec[:2], n_t, alpha=g.alpha, weight_sum=g.weights_t_sum)
    gradnorm_step(gn["s"], vec[2:], n_s, alpha=g.alpha, weight_sum=g.weights_s_sum)
    return {"losses": to_cpu(losses), "n_t": n_t.cpu(), "n_s": n_s.cpu(),
            "w_t": gn["t"].weights.cpu(), "w_s": gn["s"].weights.cpu(),
            "new_m": to_cpu({k: new_m[k] for k in ("t_ext", "t_cls", "s_ext", "s_cls")}),
            "grads": to_cpu(grads) if keep_grads else None, "digest": digest(grads),
            "relu_signs": None if signs is None else signs.masks}


def dp_epoch_step(dp, mesh, pipe, state, local, phase: int, supervised):
    """One data-parallel epoch of one batch of phase 2, 3 or 4 over this
    rank's rows ``local`` (target x, y, source x, y)."""
    xt, yt, xs, ys = (t[None] for t in local)
    if phase == 2:
        return dp.phase2_epoch(mesh, pipe, state, xs, ys)
    if phase == 3:
        return dp.phase3_epoch(mesh, pipe, state, xt, yt, xs, ys, supervised, ANCHORS)
    return dp.phase4_epoch(mesh, pipe, state, xt, yt, xs, ys, supervised, ANCHORS)


def dp_rank(rank: int, world: int, init_method: str, out_dir: str) -> dict:
    """One rank of phase 22, in a process of its own: joins the gloo group,
    replicates the states, and runs on its rows of the batch, each with the
    launch counts set to 0 just before and read just after, its ReLU sign
    patterns recorded, each timed from a barrier: a data-parallel phase-5
    step (``dp.phase5_grads``) and, from the same state, the other
    configurations' (``DP_CONFIGS``) and a step of phases 2-4
    (``DP_EPOCHS``); a phase-1 step (``make_dp_phase1_epoch``, one batch), a
    classifier step (``dp.train_epoch``, one batch) and the domain-sharded
    ensemble's evaluation (its member, ``FLSTTSC_FUSE_EPILOGUE=1``); saves
    what it computed to ``out_dir``, then times DP_REPS more default
    phase-5 steps."""
    import torch.distributed as dist

    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.losses.gradnorm import gradnorm_step
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import dp, launch, make_mesh
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.dp_explicit import (
        make_dp_phase1_epoch,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.mesh import data_sharding, place
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
        MultiSourceEnsemble,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the ranks share the host's cores (gloo stages every collective through them)
    torch.set_num_threads(max(1, (os.cpu_count() or DP_RANKS) // DP_RANKS))
    t_start = time.perf_counter()
    cfg = PipelineConfig(budget_multiplier=1.0)
    modules = (osconv, wn_fused, gate)
    counts, saved, secs = {}, {}, {}

    def counted(what, fn):
        """``fn`` with the launch counts set to 0 before and read after, timed
        from a barrier (every rank runs the same drives in the same order)."""
        dist.barrier()
        for m in modules:
            m.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[what] = time.perf_counter() - t0
        counts[what] = {name: n for m in modules for name, n in m.LAUNCHES.items()}
        return out

    with launch.process_group(rank, world, init_method, SEQ_BACKEND, timeout=DP_TIMEOUT):
        mesh = make_mesh(data=world, device="cuda")
        domains = make_mesh(data=1, domain=world, device="cuda")
        inp = dp_inputs(cfg)
        pipe, state, clf = inp["pipe"], inp["state"], inp["clf"]
        ready_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        dp.replicate(mesh, state)
        dp.replicate(mesh, inp["clf_state"])
        torch.cuda.synchronize()
        replicate_s = time.perf_counter() - t0
        sh = data_sharding(mesh)
        local = [place(mesh, b, sh) for b in inp["batch"]]
        masks = [[place(mesh, m, sh) for m in pair] for pair in inp["masks"]]

        def step5():
            return dp.phase5_grads(mesh, pipe, state, *local, 0, ANCHORS, masks)

        with ReluSigns() as signs:
            saved["phase5"] = dp_step_record(pipe, state, counted("phase 5 step", step5),
                                             gradnorm_step, rank == 0, signs)

        # the other configurations' phase-5 steps, and phases 2-4, from the same state
        for name, (knobs, env) in DP_CONFIGS.items():
            kpipe = config_pipe(pipe, knobs)
            kstate = knob_state(kpipe, state)
            with environ(**env):
                with ReluSigns() as signs:
                    step = counted(f"phase 5 step {name}", lambda: dp.phase5_grads(
                        mesh, kpipe, kstate, *local, 0, ANCHORS, masks))
                    record = dp_step_record(kpipe, kstate, step, gradnorm_step, rank == 0,
                                            None if name in BF16_DP else signs)
            if kpipe.config.fused_optimizers:  # the update too: the fused RMSprop on the global grads
                kpipe._phase5_update(kstate, step[0], step[1], *step[3:])
                record["params_after"] = to_cpu(leaves(kstate["params"])) if rank == 0 else None
                record["params_digest"] = digest(kstate["params"])
            saved[f"phase5 {name}"] = record
            del kpipe, kstate, step, record
        for key, (phase, supervised) in DP_EPOCHS.items():
            pstate = knob_state(pipe, state)
            steps = recorded_grads(pipe)
            with ReluSigns() as signs:
                metrics = counted(key, lambda: dp_epoch_step(dp, mesh, pipe, pstate, local, phase,
                                                             supervised))
            del pipe._apply_updates  # the class's again
            saved[key] = {"metrics": to_cpu(metrics), "grads": steps[0] if rank == 0 else None,
                          "digest": digest(pstate["params"]), "relu_signs": signs.masks}
            del pstate, steps
        torch.cuda.empty_cache()

        steps = recorded_grads(pipe)
        epoch1 = make_dp_phase1_epoch(pipe, mesh)
        with ReluSigns() as signs:
            metrics = counted("phase 1 step", lambda: epoch1(state, local[0][None], local[1][None],
                                                             ANCHORS[0]))
        saved["phase1"] = {"metrics": to_cpu(metrics), "grads": steps[0] if rank == 0 else None,
                           "digest": digest(state["params"]), "relu_signs": signs.masks}

        steps = recorded_grads(clf)
        with ReluSigns() as signs:
            metrics = counted("classifier step", lambda: dp.train_epoch(
                mesh, clf, inp["clf_state"], local[0][None], local[1][None]))
        saved["classifier"] = {"metrics": to_cpu(metrics),
                               "grads": steps[0] if rank == 0 else None,
                               "digest": digest(inp["clf_state"]["params"]),
                               "relu_signs": signs.masks}

        ens = MultiSourceEnsemble(SCP2["channels"], SCP2["length"], SCP2["classes"], config=cfg,
                                  device="cuda", mesh=domains)
        stacked_members = ens.stack(inp["members"])
        with environ(FLSTTSC_FUSE_EPILOGUE="1"):
            res = counted("ensemble", lambda: ens.evaluate(stacked_members, *inp["splits"]))
        saved["ensemble"] = {"predictions": torch.from_numpy(res["predictions"]),
                             "class_weights": torch.from_numpy(res["class_weights"]),
                             "member_accs": res["member_accs"], "ensemble_acc": res["ensemble_acc"]}
        torch.save(saved, Path(out_dir) / f"rank{rank}.pt")
        del saved
        torch.cuda.reset_peak_memory_stats()
        step_s = timed_steps(step5, reps=DP_REPS, barrier=dist.barrier)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
    return {"rank": rank, "device": torch.cuda.current_device(), "ready_s": ready_s,
            "replicate_s": replicate_s, "counts": counts, "step_s": step_s, "peak_mib": peak_mib,
            "drive_s": secs}


def dp_conv_rows(osconv, pipe, b: int, n_fused: int) -> dict:
    """``os_conv_fwd`` at a rank's shapes (every masked conv of a phase-5
    step, B = ``b``) and ``os_conv_fused_fwd`` at the ensemble's (the
    target model's convs over ``n_fused`` series) against their plain
    versions, timed beside ``F.conv1d`` (the unfused conv) and their bounds."""
    import torch.nn.functional as F

    from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels

    gen = torch.Generator(device="cuda").manual_seed(DP_SEED)
    rows = {"os_conv_fwd": [], "os_conv_fused_fwd": []}
    for module, specs, masks, t in (("t_ext", pipe.t_ext_specs, pipe.t_ext_masks, SCP2["length"]),
                                    ("cls", pipe.cls_specs, pipe.cls_masks, SCP2["length"]),
                                    ("s_ext", pipe.s_ext_specs, pipe.s_ext_masks, ETHANOL["length"])):
        for i, (spec, mask) in enumerate(zip(specs, masks)):
            c_in, c_out, k = spec[0][0], total_out_channels(spec), spec[-1][-1]
            scale = torch.rand(c_out, device="cuda", generator=gen) + 0.5
            shift = torch.randn(c_out, device="cuda", generator=gen)
            cases = [("os_conv_fwd", b, osconv.os_conv, osconv.os_conv_plain, ())]
            if module != "s_ext":  # the ensemble's members are the target model
                cases.append(("os_conv_fused_fwd", n_fused, osconv.os_conv_fused,
                              osconv.os_conv_fused_plain, (scale, shift, True)))
            for kern, batch, fn, plain, epilogue in cases:
                x = torch.randn(batch, t + k - 1, c_in, device="cuda", generator=gen)
                w = torch.randn(k, c_in, c_out, device="cuda", generator=gen) / math.sqrt(c_in * k) * mask
                x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
                err, rel = rel_err(fn(x, w, *epilogue), plain(x, w, *epilogue))
                flops = 2 * batch * t * c_in * int(mask.sum().item())
                n_bytes = 4 * (x.numel() + w.numel() + batch * t * c_out + (2 * c_out if epilogue else 0))
                row = {"layer": f"{module}.{i}", "batch": batch, "t": t, "c_in": c_in,
                       "c_out": c_out, "k": k, "max_abs": err, "rel": rel,
                       "ms": cuda_ms(lambda: fn(x, w, *epilogue), reps=5),
                       "plain_ms": cuda_ms(lambda: plain(x, w, *epilogue), reps=3),
                       "library_ms": None if epilogue else cuda_ms(lambda: F.conv1d(x_ncw, w_oik), reps=5),
                       "tc_flop_ms": TF32_PRODUCTS * flops / TC_PEAK * 1e3,
                       "bytes_ms": n_bytes / HBM_RATE * 1e3}
                row["bound_ms"] = max(row["tc_flop_ms"], row["bytes_ms"])
                log(f"[data parallel kernel {kern}] " + json.dumps(row))
                check(rel <= REL_TOL, f"{kern} {module}.{i} at B={batch}: rel err {rel:.3e}")
                rows[kern].append(row)
    return rows


def dp_wn_rows(wn_fused, wn_init, weight_norm_weight, pipe, b: int) -> dict:
    """``wn_fwd`` and ``wn_bwd`` at a rank's phase-5 shapes (pair: 2b
    series, infer: b; T = 1152) against their plain versions, timed beside
    their bounds."""
    fc, t, h = pipe.config.flow, SCP2["length"], pipe.feat_channels // 2
    rows = {"wn_fwd": [], "wn_bwd": []}
    for what, series in (("pair", 2 * b), ("infer", b)):
        eff = random_wn(wn_init, wn_fused, weight_norm_weight, h, fc.wn_channels, fc.wn_layers,
                        seed=DP_SEED + series)
        gen = torch.Generator(device="cuda").manual_seed(DP_SEED + series)
        x2 = torch.randn(series * t, h, device="cuda", generator=gen)
        g2 = torch.randn(series * t, 2 * h, device="cuda", generator=gen)
        _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t)
        bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
        work = wn_work(series, t, h, fc.wn_channels, fc.wn_layers)
        for d, fn, plain, args in (("fwd", wn_fused.wn_fwd, wn_fused.wn_fwd_plain, (x2, *eff, t)),
                                   ("bwd", wn_fused.wn_bwd, wn_fused.wn_bwd_plain, bwd_args)):
            errs = [rel_err(a, w) for a, w in zip(fn(*args), plain(*args))]
            row = {"shape": what, "rows": series * t, "max_abs": max(e[0] for e in errs),
                   "rel": max(e[1] for e in errs), "ms": cuda_ms(lambda: fn(*args), reps=5),
                   "plain_ms": cuda_ms(lambda: plain(*args), reps=3), "library_ms": None,
                   "tc_flop_ms": TF32_PRODUCTS * work[f"{d}_flops"] / TC_PEAK * 1e3,
                   "bytes_ms": work[f"{d}_bytes"] / HBM_RATE * 1e3}
            row["bound_ms"] = max(row["tc_flop_ms"], row["bytes_ms"])
            log(f"[data parallel kernel wn_{d}] " + json.dumps(row))
            tol = WN_FWD_REL_TOL if d == "fwd" else WN_BWD_REL_TOL
            check(row["rel"] <= tol, f"wn_{d} at a rank's {what} shape: rel err {row['rel']:.3e}")
            rows[f"wn_{d}"].append(row)
    return rows


def dp_module_gaps(what: str, dp_grads: dict, ref: dict, pinned: dict, exact: dict) -> dict:
    """Each module's gradients (relative L2): the DP step's against the
    pinned float64-backward reference (gated), the pinned float32 step's own
    gap to it, and the DP step's against the unpinned step."""
    def flat(grads, name):
        return torch.cat([g.flatten() for g in grads[name] if g is not None])

    gaps = {}
    for name in dp_grads:
        if all(g is None for g in dp_grads[name]):
            continue
        gaps[name] = {"vs_exact": rel_l2(flat(dp_grads, name), flat(exact, name))[1],
                      "own": rel_l2(flat(pinned, name), flat(exact, name))[1],
                      "unpinned": rel_l2(flat(dp_grads, name), flat(ref, name))[1]}
        bar = max(DP_GRAD_REL_L2, DP_GRAD_FACTOR * gaps[name]["own"])
        check(gaps[name]["vs_exact"] <= bar, f"data parallel {what}, gradients of {name}: relative "
              f"L2 {gaps[name]['vs_exact']:.3e} > {bar:.3e} (own {gaps[name]['own']:.3e})")
    log(f"[data parallel {what}] gradients (relative L2) against the pinned float64-backward "
        f"reference, the unsharded float32 step's own, against the unpinned: {json.dumps(gaps)}")
    return gaps


def dp_phase5_against(what, kpipe, kstate, batch, masks, got, signs, osconv, gradnorm_step,
                      env=None) -> dict:
    """A data-parallel phase-5 step (rank 0's record ``got``) against the
    unsharded step of the same pipe and state on the card: the losses,
    trunk norms, GradNorm weights and new BatchNorm statistics (phase 22's
    gates), each module's gradients against the unsharded step that takes
    the ranks' ReLU sign patterns ``signs`` with float64 transposed convs
    (``dp_module_gaps``)."""
    def p5(*ctxs):
        with stacked(environ(**(env or {})), *ctxs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step = kpipe.phase5_grads(kstate, *batch, 0, ANCHORS, masks)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        return {**dp_step_record(kpipe, kstate, step, gradnorm_step, True), "secs": secs,
                "peak_mib": torch.cuda.max_memory_allocated() / 2**20}

    ref = p5()
    with ReluSigns(pinned=signs) as flips:
        pinned = p5()
    exact = p5(ReluSigns(pinned=signs), f64_os_conv_bwd(osconv))
    row = {"loss_rel": {k: rel_err(got["losses"][k], pinned["losses"][k])[1] for k in got["losses"]},
           "loss_rel_unpinned": {k: rel_err(got["losses"][k], ref["losses"][k])[1]
                                 for k in got["losses"]},
           "n_t_rel": rel_err(got["n_t"], pinned["n_t"])[1],
           "n_s_rel": rel_err(got["n_s"], pinned["n_s"])[1],
           "w_t_rel": rel_err(got["w_t"], pinned["w_t"])[1],
           "w_s_rel": rel_err(got["w_s"], pinned["w_s"])[1],
           "new_bn_stats": bn_stats_gap(got, ref), "relu_flips": flips.flips}
    log(f"[data parallel {what}] vs the unsharded step on the card: {json.dumps(row)}")
    row["unsharded_s"], row["unsharded_peak_mib"] = ref["secs"], ref["peak_mib"]
    for k, v in row["loss_rel"].items():
        check(math.isfinite(float(got["losses"][k])), f"data parallel {what} loss {k} not finite")
        check(v <= REL_TOL, f"data parallel {what} loss {k}: rel err {v:.3e}")
    for k in ("n_t_rel", "n_s_rel"):
        check(row[k] <= GRAD_REL_TOL, f"data parallel {what} {k} {row[k]:.3e}")
    for k in ("w_t_rel", "w_s_rel"):
        check(row[k] <= REL_TOL, f"data parallel {what} GradNorm {k} {row[k]:.3e}")
    check(row["new_bn_stats"] <= SEQ_ATOL, f"data parallel {what} new BN stats "
                                           f"{row['new_bn_stats']:.3e}")
    row["grads"] = dp_module_gaps(what, got["grads"], ref["grads"], pinned["grads"],
                                  exact["grads"])
    return row


def bn_stats_gap(a: dict, b: dict) -> float:
    """The largest difference of two records' new BatchNorm statistics, over
    max(1, the statistic's largest value)."""
    return max((x - y).abs().max().item() / max(1.0, y.abs().max().item())
               for x, y in zip(_tensor_leaves(a["new_m"]), _tensor_leaves(b["new_m"])))


def dp_record_gaps(a: dict, b: dict) -> dict:
    """How far record ``a`` is from ``b``: each loss, trunk norm and
    GradNorm weight (relative), the new BatchNorm statistics, and each
    module's gradients (relative L2)."""
    gaps = {f"loss {k}": rel_err(a["losses"][k], b["losses"][k])[1] for k in b["losses"]}
    for k in ("n_t", "n_s", "w_t", "w_s"):
        gaps[k] = rel_err(a[k], b[k])[1]
    gaps["new_bn_stats"] = bn_stats_gap(a, b)
    for name, gs in b["grads"].items():
        if any(g is not None for g in gs):
            gaps[f"grads {name}"] = grads_l2_gap({name: a["grads"][name]}, {name: gs})[name]
    return gaps


def dp_bf16_against(what, kpipe, kstate, batch, masks, got, modules, gradnorm_step, env) -> dict:
    """A bf16 configuration's data-parallel phase-5 step (rank 0's record
    ``got``) against the unsharded step on the card: each quantity of
    ``dp_record_gaps`` within its phase-22 gate or DP_GRAD_FACTOR times the
    largest gap of a control from the unsharded step (DP_CONFIGS says which;
    a norm or weight also twice its trunk's gradient gap, which bounds a
    norm's relative change)."""
    osconv, wn_fused, gate = modules

    def p5(b, m, *ctxs):
        with stacked(environ(**env), *ctxs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step = kpipe.phase5_grads(kstate, *b, 0, ANCHORS, m)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        return {**dp_step_record(kpipe, kstate, step, gradnorm_step, True), "secs": secs}

    core = osconv.OSConvCore

    class MicroBatched:
        """``OSConvCore`` over the batch in DP_RANKS micro-batches."""

        @staticmethod
        def apply(x_pad, w):
            return torch.cat([core.apply(part, w) for part in x_pad.chunk(DP_RANKS)])

    ref = p5(batch, masks)
    perm = torch.from_numpy(np.random.default_rng(DP_SEED).permutation(BATCH)).cuda()
    controls = {"plain bf16 path": p5(batch, masks, plain_convs(osconv, wn_fused, gate)),
                "OS convs in micro-batches": p5(batch, masks, patched(osconv, "OSConvCore",
                                                                      MicroBatched)),
                "rows in another order": p5([t[perm] for t in batch],
                                            [[m[perm] for m in pair] for pair in masks])}
    gaps = dp_record_gaps(got, ref)
    spread = {c: dp_record_gaps(r, ref) for c, r in controls.items()}
    bars = {"loss": REL_TOL, "n_t": GRAD_REL_TOL, "n_s": GRAD_REL_TOL, "w_t": REL_TOL,
            "w_s": REL_TOL, "new_bn_stats": SEQ_ATOL, "grads": DP_GRAD_REL_L2}
    trunk = {"n_t": "grads t_ext", "w_t": "grads t_ext", "n_s": "grads s_ext", "w_s": "grads s_ext"}
    row = {"gaps": gaps, "controls": spread, "allowed": {}, "unsharded_s": ref["secs"]}
    for key, gap in gaps.items():
        keys = [key] + ([trunk[key]] if key in trunk else [])
        control = max(c[k] for c in spread.values() for k in keys)
        row["allowed"][key] = max(bars[key.split(" ")[0]], DP_GRAD_FACTOR * control)
    log(f"[data parallel {what}] vs the unsharded step on the card, and the controls' gaps from "
        f"it (two correct unsharded bf16 steps): {json.dumps(row)}")
    for k, v in got["losses"].items():
        check(math.isfinite(float(v)), f"data parallel {what} loss {k} not finite")
    for key, gap in gaps.items():
        check(gap <= row["allowed"][key], f"data parallel {what} {key}: {gap:.3e} > "
                                          f"{row['allowed'][key]:.3e}")
    return row


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.<name>`` set to ``value`` inside."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def dp_epoch_reference(pipe, state, batch, phase: int, supervised, ctx) -> dict:
    """The unsharded step of a phase-2, 3 or 4 epoch of one batch: its
    losses and gradients, no update."""
    params, mstate, consts = state["params"], state["mstate"], state["consts"]
    with ctx:
        if phase == 2:
            losses, _ = pipe._phase2_forward(params, mstate, consts, batch[2], batch[3])
            names = ("s_ext", "dim_uni", "s_cls")
        elif phase == 3:
            losses, _ = pipe._phase3_forward(params, mstate, consts, *batch, ANCHORS, supervised)
            names = pipe._phase3_names(supervised)
        else:
            losses, _ = pipe._phase4_forward(params, mstate, consts, *batch,
                                             ANCHORS if supervised else None, supervised)
            names = pipe._phase4_names(supervised)[0]
        grads = pipe._grads(losses["total"], state, names)
    return {"losses": to_cpu(losses), "grads": to_cpu(grads)}


def dp_phase(run, modules, wn_fns, smi) -> dict:
    """Phase 22: a data-parallel phase-5 step, phase-1 step and classifier
    step over DP_RANKS ranks on the one card against the unsharded steps on
    the card (gradients against those with the ranks' ReLU sign patterns
    pinned and float64 transposed convs), the domain-sharded ensemble
    against the one-process ensemble, exact launches a rank (added to the
    main path's as the "data parallel" path), each kernel at a rank's
    shapes against its plain version."""
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.losses.classification import cross_entropy
    from feature_level_style_transfer_for_tsc_tpu_torch.losses.gradnorm import gradnorm_step
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
        MultiSourceEnsemble,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.train.steps import leaves

    osconv, wn_fused, gate = modules
    cfg = PipelineConfig(budget_multiplier=1.0)
    b_rank = BATCH // DP_RANKS
    out = {"backend": SEQ_BACKEND, "ranks": DP_RANKS, "batch": BATCH, "batch_a_rank": b_rank}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as d:
        t0 = time.perf_counter()
        ranks = launch.spawn(dp_rank, DP_RANKS, (f"file://{d}/rendezvous", d), timeout=DP_TIMEOUT)
        out["spawn_wall_s"] = time.perf_counter() - t0
        shards = [torch.load(Path(d) / f"rank{r}.pt") for r in range(DP_RANKS)]
    inp = dp_inputs(cfg)
    pipe, state, batch, masks = inp["pipe"], inp["state"], inp["batch"], inp["masks"]
    n_ext, n_s_ext, n_cls = len(pipe.t_ext_specs), len(pipe.s_ext_specs), len(pipe.cls_specs)
    flows = cfg.flow.n_flows
    convs5 = n_ext + n_s_ext + 3 * n_cls
    layers = cfg.flow.wn_layers
    expect = {
        "phase 5 step": {**run.idle(), "os_conv_fwd": convs5,
                         "wn_fwd": 2 * flows, "wn_bwd": 5 * flows},
        "phase 5 step unmerged": {**run.idle(), "os_conv_fwd": convs5, "wn_fwd": 2 * flows,
                                  "wn_bwd": 6 * flows},
        "phase 5 step stacked": {**run.idle(), "os_conv_fwd": convs5, "wn_fwd": 2 * flows,
                                 "wn_bwd_runs": 2 * flows},
        "phase 5 step fused_optimizers": {**run.idle(), "os_conv_fwd": convs5,
                                          "wn_fwd": 2 * flows, "wn_bwd": 5 * flows},
        "phase 5 step compute_dtype": {**run.idle(), "os_conv_fwd[bf16]": convs5,
                                       "wn_fwd": 2 * flows, "wn_bwd": 5 * flows},
        "phase 5 step wn_mxu": {**run.idle(), "os_conv_fwd": convs5, "wn_fwd[bf16]": 2 * flows,
                                "wn_bwd[bf16]": 5 * flows},
        "phase 5 step op_by_op": {**run.idle(), "os_conv_fwd": convs5,
                                  "gate_fwd": layers * 2 * flows,
                                  "tap_conv_fwd": layers * (2 * flows + 5 * flows)},
        "phase 2 step": {**run.idle(), "os_conv_fwd": n_s_ext + n_cls},
        "phase 3 step": {**run.idle(), "os_conv_fwd": n_ext + n_s_ext + 2 * n_cls},
        "phase 4 step supervised": {**run.idle(), "os_conv_fwd": n_ext + n_s_ext + 2 * n_cls,
                                    "wn_fwd": flows, "wn_bwd": flows},
        "phase 4 step unsupervised": {**run.idle(), "os_conv_fwd": n_ext + n_s_ext,
                                      "wn_fwd": flows, "wn_bwd": flows},
        "phase 1 step": {**run.idle(), "os_conv_fwd": n_ext + n_cls},
        "classifier step": {**run.idle(), "os_conv_fwd": n_ext + n_cls},
        "ensemble": {**run.idle(), "os_conv_fused_fwd_runs": 2 * (n_ext + n_cls)},
    }
    for r in ranks:
        log(f"[data parallel rank {r['rank']}] cuda:{r['device']} ready after {r['ready_s']:.1f} s, "
            f"replicate {r['replicate_s']:.2f} s, launches={r['counts']}, phase-5 step s="
            f"{[round(x, 4) for x in r['step_s']]}, peak MiB={r['peak_mib']:.0f}")
        for what, want in expect.items():
            check(r["counts"][what] == want,
                  f"rank {r['rank']} {what}: launches {r['counts'][what]} != {want}")
    total = run.idle()
    for r in ranks:
        for what in expect:
            for name, n in r["counts"][what].items():
                total[name] += n
    run.add("data parallel 4 ranks", total, path="data parallel")
    out["rank_results"] = ranks
    for key in ("phase5", "phase1", "classifier", *(f"phase5 {n}" for n in DP_CONFIGS),
                *DP_EPOCHS):
        check(len({s[key]["digest"] for s in shards}) == 1, f"data parallel {key}: the ranks' "
              "gradients or new parameters differ")
    for s in shards[1:]:
        check(torch.equal(s["ensemble"]["predictions"], shards[0]["ensemble"]["predictions"]),
              "domain-sharded ensemble: the ranks' predictions differ")

    def signs_of(key):
        return [torch.cat([s[key]["relu_signs"][i] for s in shards], dim=0)
                for i in range(len(shards[0][key]["relu_signs"]))]

    # ---- phase 5: the unsharded step on the card, unpinned, pinned, pinned with float64
    # transposed convs
    out["phase5"] = dp_phase5_against("phase-5 step", pipe, state, batch, masks,
                                      shards[0]["phase5"], signs_of("phase5"), osconv,
                                      gradnorm_step)

    # ---- phase 5 under the other configurations, from the same state
    for name, (knobs, env) in DP_CONFIGS.items():
        kpipe = config_pipe(pipe, knobs)
        kstate = knob_state(kpipe, state)
        got = shards[0][f"phase5 {name}"]
        if name in BF16_DP:
            out[f"phase5 {name}"] = dp_bf16_against(f"phase-5 step, {name}", kpipe, kstate,
                                                    batch, masks, got, modules, gradnorm_step,
                                                    env)
        else:
            out[f"phase5 {name}"] = dp_phase5_against(
                f"phase-5 step, {name}", kpipe, kstate, batch, masks, got,
                signs_of(f"phase5 {name}"), osconv, gradnorm_step, env)
        # a rank's step (its counted drive) beside the unsharded one (the reference's first)
        step_s = {"a_rank": [r["drive_s"][f"phase 5 step {name}"] for r in ranks],
                  "unsharded": out[f"phase5 {name}"].pop("unsharded_s")}
        out[f"phase5 {name}"]["step_s"] = step_s
        log(f"[data parallel phase-5 step, {name}] step s (pulls, no update): a rank (4 share the "
            f"card) {[round(x, 4) for x in step_s['a_rank']]}, unsharded "
            f"{step_s['unsharded']:.4f} on {smi}")
        if kpipe.config.fused_optimizers:
            # the fused RMSprop's update on the ranks' global gradients: the same bits on every
            # rank and as this process's update of a copy of the state on the same gradients
            check(len({s_[f"phase5 {name}"]["params_digest"] for s_ in shards}) == 1,
                  f"data parallel {name}: the ranks' updated parameters differ")
            kpipe._phase5_update(kstate, tree_to(got["losses"], "cuda"), kstate["mstate"],
                                 tree_to(got["grads"], "cuda"), got["n_t"].cuda(),
                                 got["n_s"].cuda())
            same = all(torch.equal(a.detach().cpu(), b) for a, b in
                       zip(leaves(kstate["params"]), got["params_after"]))
            out[f"phase5 {name}"]["update_same_bits"] = same
            log(f"[data parallel phase-5 step, {name}] the ranks' fused update the same bits as "
                f"one process's on the same gradients: {same}")
            check(same, f"data parallel {name}: the fused update differs from one process's")
        del kpipe, kstate, got
        torch.cuda.empty_cache()

    # ---- phases 2-4: the gradients of one step from the same state, no update
    for key, (phase, supervised) in DP_EPOCHS.items():
        signs = signs_of(key)
        pstate = knob_state(pipe, state)

        def pn(ctx):
            return dp_epoch_reference(pipe, pstate, batch, phase, supervised, ctx)

        ref = pn(contextlib.nullcontext())
        with ReluSigns(pinned=signs) as flips:
            pinned = pn(contextlib.nullcontext())
        exact = pn(stacked(ReluSigns(pinned=signs), f64_os_conv_bwd(osconv)))
        got = shards[0][key]
        loss_rel = {m: rel_err(got["metrics"][m], pinned["losses"][m])[1] for m in got["metrics"]}
        log(f"[data parallel {key}] losses rel vs the unsharded step {json.dumps(loss_rel)}, "
            f"ReLU flips {flips.flips}")
        for m, v in loss_rel.items():
            check(math.isfinite(float(got["metrics"][m])), f"data parallel {key} {m} not finite")
            check(v <= REL_TOL, f"data parallel {key} loss {m}: rel err {v:.3e}")
        out[key] = {"loss_rel": loss_rel, "relu_flips": flips.flips,
                    "grads": dp_module_gaps(key, got["grads"], ref["grads"], pinned["grads"],
                                            exact["grads"])}
        del ref, pinned, exact, pstate

    # ---- phase 1 and the classifier: the gradients of one step, no update
    def p1(ctx):
        with ctx:
            losses, _ = pipe._phase1_forward(state["params"], state["mstate"], state["consts"],
                                             batch[0], batch[1], (ANCHORS[0],))
            grads = pipe._grads(losses["total"], state, ("t_ext", "t_cls", "cpc"))
        return {"losses": to_cpu(losses), "grads": to_cpu(grads)}

    clf, cstate = inp["clf"], inp["clf_state"]

    def pc(ctx):
        with ctx:
            logits, _, _, _ = clf.forward(cstate["params"], cstate["mstate"], batch[0], True)
            loss = cross_entropy(logits, batch[1])
            grads = clf._grads(loss, cstate, clf.modules)
        return {"losses": {"c_loss": loss.detach().cpu()}, "grads": to_cpu(grads)}

    for key, fn, metric in (("phase1", p1, ("t_c_loss", "t_sl_loss")),
                            ("classifier", pc, ("c_loss",))):
        signs = signs_of(key)
        ref = fn(contextlib.nullcontext())
        with ReluSigns(pinned=signs) as flips:
            pinned = fn(contextlib.nullcontext())
        exact = fn(stacked(ReluSigns(pinned=signs), f64_os_conv_bwd(osconv)))
        got = shards[0][key]
        loss_rel = {m: rel_err(got["metrics"][m], pinned["losses"][m])[1] for m in metric}
        log(f"[data parallel {key} step] losses rel vs the unsharded step {json.dumps(loss_rel)}, "
            f"ReLU flips {flips.flips}")
        for m, v in loss_rel.items():
            check(v <= REL_TOL, f"data parallel {key} loss {m}: rel err {v:.3e}")
        out[key] = {"loss_rel": loss_rel, "relu_flips": flips.flips,
                    "grads": dp_module_gaps(f"{key} step", got["grads"], ref["grads"],
                                            pinned["grads"], exact["grads"])}
        del ref, pinned, exact

    # ---- the ensemble against the one-process ensemble
    ens = MultiSourceEnsemble(SCP2["channels"], SCP2["length"], SCP2["classes"], config=cfg,
                              device="cuda")
    with environ(FLSTTSC_FUSE_EPILOGUE="1"):
        res = ens.evaluate(ens.stack(inp["members"]), *inp["splits"])
    got = shards[0]["ensemble"]
    same = np.array_equal(got["predictions"].numpy(), res["predictions"])
    w_gap = float(np.abs(got["class_weights"].numpy() - res["class_weights"]).max())
    log(f"[data parallel ensemble] predictions equal to the one-process ensemble's: {same}; class "
        f"weights max abs {w_gap:.3e}; accuracy {got['ensemble_acc']:.4f} "
        f"({res['ensemble_acc']:.4f}); members {got['member_accs']}")
    check(same, "domain-sharded ensemble: predictions differ from the one-process ensemble's")
    check(w_gap <= 1e-6, f"domain-sharded ensemble: class weights {w_gap:.3e} from one process's")
    out["ensemble"] = {"predictions_equal": same, "class_weights_max_abs": w_gap}

    # ---- the kernels at a rank's shapes, and the step timed
    out["kernels"] = {**dp_conv_rows(osconv, pipe, b_rank, DP_SERIES),
                      **dp_wn_rows(wn_fused, *wn_fns, pipe, b_rank)}
    out["unsharded_step_s"] = [out["phase5"].pop("unsharded_s")]
    out["unsharded_peak_mib"] = out["phase5"].pop("unsharded_peak_mib")
    rank_s = [statistics.median(r["step_s"]) for r in ranks]
    out["rank_step_median_s"] = rank_s
    out["unsharded_step_median_s"] = statistics.median(out["unsharded_step_s"])
    log(f"[data parallel] phase-5 step s (pulls, no update): a rank (4 share the card, 5 series a "
        f"domain) {[round(x, 4) for x in rank_s]}, unsharded (20) "
        f"{out['unsharded_step_median_s']:.4f}; spawn to joined {out['spawn_wall_s']:.1f} s; peak "
        f"MiB a rank {[round(r['peak_mib']) for r in ranks]}, unsharded "
        f"{out['unsharded_peak_mib']:.0f}; on {smi}")
    del inp, state
    torch.cuda.empty_cache()
    return out



# ----------------------------------------------------------------- phase 24 --

# Phase 24: cli.predict and cli.multi_source under torchrun on the one card, the ranks sharing it
# (``parallel.launch.torchrun_group`` picks ``"cpu:gloo,cuda:gloo"`` when there are fewer cards
# than local ranks: NCCL refuses two ranks on one card).  Each rank runs the CLI's ``main`` as
# ``python -m`` runs it, through this script's rank mode (``cli_rank``), which also writes the
# rank's launch counts.
TORCHRUN_PREDICT_RANKS = (3, 2)  # P >= M = 3 members: the domain-sharded ensemble; P < M: rank 0
TORCHRUN_MULTI_RANKS = 2  # phase 15's two sources, one member a rank
TORCHRUN_TIMEOUT = 300  # a torchrun command's deadline in seconds, its start included
# phase 24's members: heads scaled by this, their biases set to centre the logits on the
# target's series, so that each member's predictions vary from series to series
HEAD_SCALE = 30.0
VARIED_SEED = 40  # their weights, from VARIED_SEED + i, and their BatchNorm state


def varied_members(member_def, x, paths, save_checkpoint, bn_stats_type) -> None:
    """Phase 24's members, written to ``paths``: random members with
    non-trivial BatchNorm state (``with_random_bn``), each head's weight
    scaled by HEAD_SCALE and its bias set to minus the median of the scaled
    products over the series ``x``, so that a member predicts every class."""
    rng = np.random.default_rng(VARIED_SEED)
    x = torch.as_tensor(x).cuda()
    for i, path in enumerate(paths):
        member = with_random_bn(member_def.init_models(
            torch.Generator().manual_seed(VARIED_SEED + i)), rng, bn_stats_type)
        head = member["params"]["cls"]["hidden"]
        with torch.no_grad():
            logits = member_def.predict_logits(member["params"], member["mstate"], x)
        head["weight"] = HEAD_SCALE * head["weight"]
        head["bias"] = -torch.median(HEAD_SCALE * (logits - head["bias"]), dim=0).values
        save_checkpoint(str(path), member)


@contextlib.contextmanager
def recorded_logits(ensemble_cls):
    """Every ``member_logits`` result of ``ensemble_cls`` inside (with a
    mesh, every rank's members gathered), as numpy arrays in call order."""
    calls = []
    member_logits = ensemble_cls.member_logits

    def recording(self, *args):
        out = member_logits(self, *args)
        calls.append(out.cpu().numpy())
        return out

    with patched(ensemble_cls, "member_logits", recording):
        yield calls


def cli_rank(out_dir: str, cli: str, argv) -> int:
    """The rank mode, under torchrun: ``chip_smoke.py --cli-rank <out_dir>
    <predict|multi_source> <the CLI's arguments>``.  Runs the CLI's
    ``main(argv)`` deterministic with TF32 off (as phases 4 and 15 run it),
    the launch counts set to 0 just before and read just after, each member
    pipeline's run watched (``watched_members``) and every ``member_logits``
    result recorded (``recorded_logits``), and writes the rank's counts,
    members and clock times to ``<out_dir>/rank<RANK>.json``, its logits to
    ``<out_dir>/rank<RANK>_logits.npz``."""
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import multi_source, predict
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
        MultiSourceEnsemble,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import (
        StyleTransferPipeline,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    modules = (osconv, wn_fused, gate)
    main_fn = {"predict": predict.main, "multi_source": multi_source.main}[cli]
    with watched_members(StyleTransferPipeline) as members, deterministic(), \
            recorded_logits(MultiSourceEnsemble) as logits:
        for m in modules:
            m.reset_launch_counts()
        t_main = time.time()
        main_fn(list(argv))
        torch.cuda.synchronize()
        t_end = time.time()
    rank = int(os.environ["RANK"])
    np.savez(Path(out_dir) / f"rank{rank}_logits.npz", *logits)
    record = {"rank": rank, "device": torch.cuda.current_device(),
              "counts": {name: n for m in modules for name, n in m.LAUNCHES.items()},
              "t_main": t_main, "t_end": t_end, "members": members,
              "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    (Path(out_dir) / f"rank{rank}.json").write_text(
        json.dumps(record, default=lambda v: np.asarray(v).tolist()))
    return 0


def torchrun_jobs(specs) -> list:
    """Each ``(cli, ranks, argv, out_dir, env)`` of ``specs`` as ``python -m
    torch.distributed.run --standalone --nproc-per-node <ranks>`` of this
    script's rank mode, all started at once (a command spends most of its
    time starting Python and importing torch in each process) and waited
    for: per command, its wall time from start to exit, its standard output
    and each rank's record, with ``startup_s`` (from the command's start to
    the rank entering ``main``) and ``main_s``, and its ``member_logits``
    results.  Fails when a command fails
    (a rank that fails fails torchrun) or outlives TORCHRUN_TIMEOUT; every
    command's process group is killed before this returns or raises."""
    import signal

    # the ranks see this process's card only, so that they share it whatever the machine holds
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    jobs = []
    try:
        for cli, ranks, argv, out_dir, env in specs:
            out_dir.mkdir(parents=True)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", str(ranks), str(REPO / "chip_smoke.py"), "--cli-rank",
                   str(out_dir), cli, *argv]
            with open(out_dir / "stdout.txt", "w") as out, open(out_dir / "stderr.txt", "w") as err:
                jobs.append({"cli": cli, "ranks": ranks, "out_dir": out_dir, "t0": time.time(),
                             "exit": None, "proc": subprocess.Popen(
                                 cmd, stdout=out, stderr=err, cwd=REPO, start_new_session=True,
                                 env={**os.environ, "CUDA_VISIBLE_DEVICES": card, **env})})
        deadline = time.time() + TORCHRUN_TIMEOUT
        while any(j["exit"] is None for j in jobs) and time.time() < deadline:
            for j in jobs:
                if j["exit"] is None and j["proc"].poll() is not None:
                    j["exit"] = time.time()
            time.sleep(0.1)
    finally:
        for j in jobs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(j["proc"].pid, signal.SIGKILL)
            j["proc"].wait()
    results = []
    for j in jobs:
        cli, ranks, out_dir = j["cli"], j["ranks"], j["out_dir"]
        stdout = (out_dir / "stdout.txt").read_text()
        check(j["exit"] is not None and j["proc"].returncode == 0,
              f"{cli} under torchrun ({ranks} ranks) exited {j['proc'].returncode} (killed after "
              f"{TORCHRUN_TIMEOUT} s if None): {stdout[-2000:]} "
              f"{(out_dir / 'stderr.txt').read_text()[-4000:]}")
        records = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(ranks)]
        for r in records:
            r["startup_s"], r["main_s"] = r["t_main"] - j["t0"], r["t_end"] - r["t_main"]
            check(r["cublas_workspace_config"] == os.environ["CUBLAS_WORKSPACE_CONFIG"],
                  f"rank {r['rank']}: CUBLAS_WORKSPACE_CONFIG {r['cublas_workspace_config']}")
        backends = [line for line in stdout.splitlines() if line.startswith("[rank ")]
        check(sorted(backends) == sorted(f"[rank {r} of {ranks}] backend {SEQ_BACKEND}, "
                                         f"device cuda:0" for r in range(ranks)),
              f"{cli} under torchrun: the ranks' backend lines {backends}")
        for line in backends:
            log(f"[torchrun {cli}, {ranks} ranks] {line}")
        logits = []
        for r in range(ranks):
            with np.load(out_dir / f"rank{r}_logits.npz") as z:
                logits.append([z[f"arr_{i}"] for i in range(len(z.files))])
        results.append({"wall_s": j["exit"] - j["t0"], "stdout": stdout, "ranks": records,
                        "logits": logits})
    return results


def same_arrays(got: list, want: list) -> bool:
    """The same arrays, bit for bit, in the same order."""
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        for a, b in zip(got, want))


def result_line(stdout: str) -> str:
    """``cli.predict``'s one result line, without the output path."""
    lines = [line for line in stdout.splitlines() if line.startswith("n=")]
    check(len(lines) == 1, f"cli.predict printed {len(lines)} result lines: {lines}")
    return lines[0].split(" -> ")[0]


def torchrun_phase(run, predict, pipeline_cls, cfg, ensemble, y_test, n_layers: int, data: Path,
                   train_data: Path, sources: dict, phase15: dict, tmp: Path, smi: str) -> dict:
    """Phase 24: (a) ``cli.predict`` over the three members of ``ensemble``
    (``varied_members``) under torchrun with P ranks sharing the card, P = 3
    (the domain-sharded ensemble, a member a rank) and P = 2 (fewer ranks
    than members: rank 0 alone), unfused: the predictions' file, the printed
    result (member accuracies, not all equal on ``y_test``, each member
    predicting every class) and every serving rank's gathered member logits
    those of the one-process run, bit for bit, one ``_predict.npy`` written,
    each rank's launches exact; (b) ``cli.multi_source`` with phase 15's
    sources, a member a rank: the JAX CLI's file set, every member finite
    (``check_history``), each rank's launches exact (its member's training
    drive and the vote over its member), ``final_predict.npy`` and each
    rank's gathered member logits what one-process ``cli.predict`` gives
    over the saved members, bit for bit.  The three torchrun commands run at
    once (``torchrun_jobs``).  Wall times, each rank's startup, and a rank's
    member wall time beside phase 15's, recorded; every rank's counts added
    to the main path's as the "torchrun" path."""
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
        MultiSourceEnsemble,
    )

    root = tmp / "torchrun"
    out = {"backend": SEQ_BACKEND}
    c, t, n_cls = SCP2["channels"], SCP2["length"], SCP2["classes"]
    unfused = {"FLSTTSC_FUSE_EPILOGUE": "0"}
    idle = run.idle()
    names = list(sources)
    prefixes = {ranks: root / f"predict_p{ranks}" / "ens" for ranks in TORCHRUN_PREDICT_RANKS}
    ms_out = root / "multi_source"
    ms_args = ["--target-root", str(train_data), "--target", "SynSCP2", "--source-root",
               str(train_data), "--sources", ",".join(sources), "--out", str(ms_out),
               "--phase-epochs", json.dumps(PHASE_EPOCHS), "--device", "cuda"]
    t0 = time.time()
    *predicts, multi = torchrun_jobs(
        [("predict", ranks, cli_args(data, "SynSCP2", data, "SynSource", ensemble, prefix),
          root / f"predict_p{ranks}_ranks", unfused) for ranks, prefix in prefixes.items()]
        + [("multi_source", TORCHRUN_MULTI_RANKS, ms_args, root / "multi_source_ranks", {})])
    out["commands_wall_s"] = time.time() - t0
    log(f"[torchrun] {len(predicts) + 1} commands at once: {out['commands_wall_s']:.1f} s")

    # (a) against the one-process run of the same command
    one = root / "predict_one_process" / "ens"
    with environ(**unfused), contextlib.redirect_stdout(io.StringIO()) as printed, \
            recorded_logits(MultiSourceEnsemble) as want_logits:
        predict.main(cli_args(data, "SynSCP2", data, "SynSource", ensemble, one))
    want_line = result_line(printed.getvalue())
    want_bytes = Path(f"{one}_predict.npy").read_bytes()
    member_preds = want_logits[-1].argmax(-1)  # the calls: the train split, then the test split
    member_accs = [float(np.mean(p == y_test)) for p in member_preds]
    out["members"] = {"accuracies": member_accs,
                      "per_class": [np.bincount(p, minlength=n_cls).tolist() for p in member_preds]}
    log(f"[torchrun predict] members: test accuracies {member_accs}, predictions per class "
        f"{out['members']['per_class']}")
    check(len(want_logits) == 2 and len(set(member_accs)) > 1
          and all(min(c) > 0 for c in out["members"]["per_class"]),
          f"torchrun predict: the members' predictions do not vary: {out['members']}")
    for (ranks, prefix), res in zip(prefixes.items(), predicts):
        what = f"predict, {ranks} ranks"
        written = sorted(p.name for p in prefix.parent.iterdir())
        check(written == ["ens_predict.npy"], f"torchrun {what}: wrote {written}")
        check(Path(f"{prefix}_predict.npy").read_bytes() == want_bytes,
              f"torchrun {what}: predictions differ from the one-process run's")
        line = result_line(res["stdout"])
        check(line == want_line, f"torchrun {what}: {line!r} against one process's {want_line!r}")
        serving = range(len(ensemble)) if ranks >= len(ensemble) else [0]
        for r in res["ranks"]:
            want = {**idle, "os_conv_fwd_runs": 2 * n_layers} if r["rank"] in serving else idle
            check(r["counts"] == want, f"torchrun {what}, rank {r['rank']}: launches "
                                       f"{r['counts']} != {want}")
            check(same_arrays(res["logits"][r["rank"]],
                              want_logits if r["rank"] in serving else []),
                  f"torchrun {what}, rank {r['rank']}: its gathered member logits differ from "
                  f"the one-process run's")
        run.add(f"torchrun {what}", {n: sum(r["counts"][n] for r in res["ranks"]) for n in idle},
                path="torchrun")
        out[f"predict_p{ranks}"] = {
            "wall_s": res["wall_s"], "mesh": ranks >= len(ensemble), "result": line,
            "ranks": [{k: r[k] for k in ("rank", "device", "counts", "startup_s", "main_s")}
                      for r in res["ranks"]]}
        log(f"[torchrun {what}] {'mesh data=1 domain=3' if ranks >= len(ensemble) else 'no mesh'}"
            f": the one-process bytes and result line ({line}); wall s={res['wall_s']:.1f}, "
            f"startup s={[round(r['startup_s'], 1) for r in res['ranks']]}, main s="
            f"{[round(r['main_s'], 1) for r in res['ranks']]} on {smi}")

    # (b) the members trained one a rank, then the vote on the mesh of the two ranks
    pipes = [pipeline_cls(c, t, n_cls, d["channels"], d["length"], d["classes"], cfg,
                          device="cuda") for d in sources.values()]
    member_convs = len(pipes[0].t_ext_specs) + len(pipes[0].cls_specs)
    want_files = {f"member_{name}.npz" for name in sources} | {
        "final_predict.npy", "true_label.npy", "prediction_strip.png", "ensemble.json"}
    have = {f.name for f in ms_out.iterdir()}
    check(have == want_files, f"torchrun multi-source wrote {sorted(have)}, want "
                              f"{sorted(want_files)}")
    rows = {}
    for r in multi["ranks"]:
        check(len(r["members"]) == 1, f"torchrun multi-source rank {r['rank']}: trained "
                                      f"{len(r['members'])} members")
        name, m = names[r["rank"]], r["members"][0]
        want = {**idle, **expected_training_launches(pipes[r["rank"]], TRAIN_SERIES, PHASE_EPOCHS)}
        want["os_conv_fwd_runs"] += 2 * member_convs  # the vote over its member: train, test split
        check(r["counts"] == want, f"torchrun multi-source rank {r['rank']}: launches "
                                   f"{r['counts']} != {want}")
        rows[name] = {"wall_s": m["wall_s"], "phase15_wall_s": phase15["members"][name]["wall_s"],
                      "phase5": check_history(f"torchrun member {name}", m["history"],
                                              m["first_step"]),
                      "startup_s": r["startup_s"], "main_s": r["main_s"]}
        log(f"[torchrun multi-source member {name}, rank {r['rank']}] wall s={m['wall_s']:.2f} "
            f"(phase 15, one process: {rows[name]['phase15_wall_s']:.2f}), startup s="
            f"{r['startup_s']:.1f} on {smi}")
    run.add("torchrun multi-source, 2 ranks",
            {n: sum(r["counts"][n] for r in multi["ranks"]) for n in idle}, path="torchrun")
    served = root / "multi_source_served"
    members_csv = ",".join(str(ms_out / f"member_{name}.npz") for name in sources)
    with recorded_logits(MultiSourceEnsemble) as served_logits:
        predict.main(["--target-root", str(train_data), "--target", "SynSCP2", "--source-root",
                      str(train_data), "--source", names[0], "--checkpoint", members_csv,
                      "--vote", "entropy_precision", "--out", str(served), "--device", "cuda"])
    check(np.array_equal(np.load(f"{served}_predict.npy"), np.load(ms_out / "final_predict.npy")),
          "torchrun multi-source: final_predict.npy differs from one-process cli.predict's")
    for r in multi["ranks"]:
        check(same_arrays(multi["logits"][r["rank"]], served_logits),
              f"torchrun multi-source, rank {r['rank']}: its gathered member logits differ "
              f"from one-process cli.predict's")
    out["multi_source"] = {"wall_s": multi["wall_s"], "members": rows}
    log(f"[torchrun multi-source, 2 ranks] the JAX CLI's files, final_predict.npy what "
        f"one-process cli.predict gives over the saved members; wall s={multi['wall_s']:.1f} on "
        f"{smi}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from feature_level_style_transfer_for_tsc_tpu_torch import baselines
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import baselines as bl_cli
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import archive_sweep as sweep_cli
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import main as train_cli
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import multi_source as ms_cli
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import predict
    from feature_level_style_transfer_for_tsc_tpu_torch.losses.gradnorm import gradnorm_step
    from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
    from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import wn_init
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.data import native, ts_parser
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import (
        make_arrays,
        make_dataset,
        write_ts_file,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import save_checkpoint
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, gate, osconv, wn_fused
    from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import BNStats
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
        MultiSourceEnsemble,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels
    from feature_level_style_transfer_for_tsc_tpu_torch.train import bucketed, classifier
    from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import OSCNNClassifier
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import (
        StyleTransferPipeline,
        TargetPredictor,
    )

    # ---- phase 1: setup
    clock = PhaseClock()
    clock.start("phase 1: setup and build")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build = build_kernels(_build, sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    osconv._lib()
    osconv._tap_lib()
    wn_fused._lib()
    gate._lib()

    results = {"device": kind, "nvidia_smi": smi, "build": build}
    cfg = PipelineConfig(budget_multiplier=1.0)
    predictor = TargetPredictor(
        SCP2["channels"], SCP2["length"], SCP2["classes"], config=cfg, device="cuda"
    )

    clock.start("phase 2 (and the data and checkpoints of phases 3-4)")
    # ---- phase 2: kernels against plain at the six full-width shapes
    layers = []
    for module, specs, masks, relu_last in (
        ("t_ext", predictor.t_ext_specs, predictor.t_ext_masks, False),
        ("t_cls", predictor.cls_specs, predictor.cls_masks, True),
    ):
        for i, (spec, mask) in enumerate(zip(specs, masks)):
            relu = relu_last or i < len(specs) - 1
            layers.append((f"{module}.{i}", spec[0][0], total_out_channels(spec),
                           spec[-1][-1], mask, relu))
    rows = kernel_phase(osconv, layers)
    results["kernels"] = rows
    results["kernels_total"] = conv_totals("os_conv_fwd, six serving convs", rows, "kernel_ms", "library_ms")
    results["kernels_total"]["fused_ms"] = sum(r["fused_ms"] for r in rows)

    run = Run(osconv, wn_fused, gate)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        # ---- data: SCP2-shaped target, a small source for the CLI's flags
        data = tmp / "data"
        t0 = time.perf_counter()
        c, t, n_cls = SCP2["channels"], SCP2["length"], SCP2["classes"]
        write_dataset(data, "SynSCP2", {
            "TRAIN": make_arrays(SCP2["n_train"], c, t, n_cls, seed=1),
            "TEST": make_arrays(SCP2["n_test"], c, t, n_cls, seed=2),
        }, write_ts_file)
        write_dataset(data, "SynSource", {
            "TRAIN": make_arrays(20, 1, 64, 2, seed=3),
            "TEST": make_arrays(20, 1, 64, 2, seed=4),
        }, write_ts_file)
        log(f"data written in {time.perf_counter() - t0:.2f} s")
        t_train, t_test, _, _ = predict.build_datasets(data, "SynSCP2", data, "SynSource")

        # ---- checkpoints: one full pipeline state, two extracted members,
        # all with non-trivial BatchNorm state
        rng = np.random.default_rng(0)
        state = with_random_bn(predictor.init_state(torch.Generator().manual_seed(0)), rng, BNStats)
        single = tmp / "ckpt" / "final_state.npz"
        save_checkpoint(str(single), state)
        member_def = OSCNNClassifier(c, t, n_cls, config=cfg, with_cpc=False, device="cuda")
        members = [tmp / "ckpt" / f"member{i}.npz" for i in (1, 2)]
        for i, path in enumerate(members):
            member = member_def.init_models(torch.Generator().manual_seed(10 + i))
            save_checkpoint(str(path), with_random_bn(member, rng, BNStats))
        ensemble = [members[0], single, members[1]]

        n_layers = len(layers)
        n_batches = math.ceil(SCP2["n_test"] / BATCH)
        x_test = torch.as_tensor(t_test.x).cuda()
        results["serving"] = {}
        clock.start("phases 3-4")
        for fused in (False, True):
            kern = "os_conv_fused_fwd" if fused else "os_conv_fwd"
            idle = run.idle()
            tag = "fused" if fused else "unfused"
            with environ(FLSTTSC_FUSE_EPILOGUE="1" if fused else "0"):
                # ---- phase 3: one checkpoint
                out = tmp / f"single_{tag}"
                acc = run.drive(
                    f"single {tag}",
                    lambda: predict.main(cli_args(data, "SynSCP2", data, "SynSource", [single], out)),
                    {**idle, kern: n_layers * n_batches}, path="serving",
                )
                preds = np.load(f"{out}_predict.npy")
                params, mstate = state["params"], state["mstate"]
                logits = predictor.predict_logits(params, mstate, x_test)
                with plain_convs(osconv, wn_fused, gate):
                    logits_plain = predictor.predict_logits(params, mstate, x_test)
                    predict.main(cli_args(data, "SynSCP2", data, "SynSource", [single], f"{out}_plain"))
                check(tuple(logits.shape) == (SCP2["n_test"], n_cls), f"logits {tuple(logits.shape)}")
                check(bool(torch.isfinite(logits).all()), "non-finite logits")
                l_abs, l_rel = rel_err(logits, logits_plain)
                check(l_rel <= REL_TOL, f"single {tag}: logits rel err {l_rel:.3e}")
                same = np.array_equal(preds, np.load(f"{out}_plain_predict.npy"))
                check(preds.shape == (SCP2["n_test"],) and same, f"single {tag}: predictions differ from plain")
                single_sps = series_per_s(
                    lambda: predictor.predict_target(state, t_test.x), SCP2["n_test"]
                )
                log(f"[single {tag}] accuracy={acc:.4f} logits max_abs={l_abs:.3e} rel={l_rel:.3e} "
                    f"series/s={single_sps:.1f} on {smi}")

                # ---- phase 4: ensemble of 3, the members under one vmap: one
                # run-axis launch a layer and split (train, test)
                out = tmp / f"ensemble_{tag}"
                acc_e = run.drive(
                    f"ensemble {tag}",
                    lambda: predict.main(cli_args(data, "SynSCP2", data, "SynSource", ensemble, out)),
                    {**idle, f"{kern}_runs": n_layers * 2}, path="serving",
                )
                with plain_convs(osconv, wn_fused, gate):
                    predict.main(cli_args(data, "SynSCP2", data, "SynSource", ensemble, f"{out}_plain"))
                same = np.array_equal(np.load(f"{out}_predict.npy"), np.load(f"{out}_plain_predict.npy"))
                check(same, f"ensemble {tag}: predictions differ from plain")
                ens = MultiSourceEnsemble(c, t, n_cls, config=cfg, device="cuda")
                loaded = [predict._load_member(str(p), "cuda") for p in ensemble]
                stacked = ens.stack(loaded)
                weights = ens.compute_class_weights(stacked, t_train.x, t_train.y)
                # the members at the ensemble's own shapes (whole train and
                # test splits in one call each) against the plain path
                ens_rel = {}
                for split, x in (("train", t_train.x), ("test", t_test.x)):
                    got = ens.member_logits(stacked, x)
                    with plain_convs(osconv, wn_fused, gate):
                        want = ens.member_logits(stacked, x)
                    check(tuple(got.shape) == (len(ensemble), len(x), n_cls)
                          and bool(torch.isfinite(got).all()),
                          f"ensemble {tag}: {split} member logits {tuple(got.shape)}")
                    ens_rel[split] = rel_err(got, want)[1]
                    check(ens_rel[split] <= REL_TOL,
                          f"ensemble {tag}: {split} member logits rel err {ens_rel[split]:.3e}")
                with plain_convs(osconv, wn_fused, gate):
                    weights_plain = ens.compute_class_weights(stacked, t_train.x, t_train.y)
                ens_rel["weights"] = rel_err(weights, weights_plain)[1]
                check(ens_rel["weights"] <= REL_TOL,
                      f"ensemble {tag}: class weights rel err {ens_rel['weights']:.3e}")
                member_preds = ens.member_logits(stacked, t_test.x).argmax(-1)
                log(f"[ensemble {tag}] member logits rel vs plain: train={ens_rel['train']:.3e} "
                    f"test={ens_rel['test']:.3e}; class weights rel={ens_rel['weights']:.3e}; "
                    f"test predictions per class per member="
                    f"{[torch.bincount(p, minlength=n_cls).tolist() for p in member_preds]}")
                ens_sps = series_per_s(
                    lambda: predict.entropy_precision_vote(
                        ens.member_logits(stacked, t_test.x), weights, ens.voting
                    ).cpu(),
                    SCP2["n_test"],
                )
                vmapped = ensemble_vmap_phase(osconv, wn_fused, ens, loaded, stacked, weights,
                                              (("train", t_train.x), ("test", t_test.x)),
                                              n_layers, fused)
                log(f"[ensemble {tag}] accuracy={acc_e:.4f} series/s={ens_sps:.1f} (members one "
                    f"after another, in the same run: {vmapped['loop_series_per_s']:.1f}) on {smi}")
                results["serving"][tag] = {
                    "single_accuracy": acc, "single_logits_rel": l_rel,
                    "single_series_per_s": single_sps,
                    "ensemble_accuracy": acc_e, "ensemble_series_per_s": ens_sps,
                    "ensemble_rel": ens_rel, "ensemble_vmap": vmapped,
                }

        clock.start("phase 5")
        # ---- phase 5: the vendored VendGunPoint, small case
        uni = REPO / "datasets" / "Univariate_ts"
        g_train, g_test, _, _ = predict.build_datasets(uni, "VendGunPoint", uni, "VendCoffee")
        g_pred = TargetPredictor(g_train.in_channel, g_train.time_length, g_train.num_class,
                                 config=cfg, device="cuda")
        g_ckpt = tmp / "ckpt" / "gunpoint.npz"
        save_checkpoint(str(g_ckpt), g_pred.init_state(torch.Generator().manual_seed(5)))
        out = tmp / "gunpoint"
        n_g = len(g_pred.t_ext_specs) + len(g_pred.cls_specs)
        run.drive(
            "VendGunPoint",
            lambda: predict.main(cli_args(uni, "VendGunPoint", uni, "VendCoffee", [g_ckpt], out)),
            {**run.idle(), "os_conv_fwd": n_g * math.ceil(g_test.len / BATCH)},
        )
        with plain_convs(osconv, wn_fused, gate):
            predict.main(cli_args(uni, "VendGunPoint", uni, "VendCoffee", [g_ckpt], f"{out}_plain"))
        check(np.array_equal(np.load(f"{out}_predict.npy"), np.load(f"{out}_plain_predict.npy")),
              "VendGunPoint: predictions differ from plain")

        # ---- the training configuration: SCP2 <- EthanolLevel, PipelineConfig()
        train_data = tmp / "train_data"
        write_dataset(train_data, "SynSCP2", {
            "TRAIN": make_arrays(TRAIN_SERIES, c, t, n_cls, seed=11),
            "TEST": make_arrays(TRAIN_SERIES, c, t, n_cls, seed=12),
        }, write_ts_file)
        e_c, e_t, e_n = ETHANOL["channels"], ETHANOL["length"], ETHANOL["classes"]
        write_dataset(train_data, "SynEthanol", {
            "TRAIN": make_arrays(TRAIN_SERIES, e_c, e_t, e_n, seed=13),
            "TEST": make_arrays(TRAIN_SERIES, e_c, e_t, e_n, seed=14),
        }, write_ts_file)
        pipe = StyleTransferPipeline(c, t, n_cls, e_c, e_t, e_n, cfg, device="cuda")
        fc = cfg.flow

        clock.start("phase 6")
        # ---- phase 6: the WN kernels at the phase-5 shapes, and at the
        # widest half widths of the vendored datasets
        h = pipe.feat_channels // 2
        wn_rows = wn_phase(wn_fused, wn_init, weight_norm_weight,
                           [("pair", 2 * BATCH, t, h), ("infer", BATCH, t, h)],
                           fc.wn_channels, fc.wn_layers)
        wide_rows = wn_phase(wn_fused, wn_init, weight_norm_weight,
                             [(f"pair {name}", 2 * BATCH, tt, hh) for name, tt, hh in WIDE_WN],
                             fc.wn_channels, fc.wn_layers)
        results["wn"] = wn_rows
        results["wn_wide"] = wide_rows

        clock.start("phase 7")
        # ---- phase 7: the OS conv's gradient on the card
        results["osconv_grad"] = osconv_grad_phase(osconv, layers)

        clock.start("phase 8")
        # ---- phase 8: training through cli.main
        def train_args(out, epochs):
            return ["--target-root", str(train_data), "--target", "SynSCP2",
                    "--source-root", str(train_data), "--source", "SynEthanol",
                    "--out", str(out), "--phase-epochs", json.dumps(epochs), "--device", "cuda"]

        train_out = tmp / "train_run"
        state, history, step_s, p5_record = training_drive(
            run, train_cli, StyleTransferPipeline, "training", train_args(train_out, PHASE_EPOCHS),
            {**run.idle(), **expected_training_launches(pipe, TRAIN_SERIES, PHASE_EPOCHS)}, train_out,
        )
        step_med = statistics.median(step_s[1:])  # the first step includes warm-up
        train_sps = 2 * BATCH / step_med
        p5 = [h for h in history if h["phase"] == "p5"]
        log(f"[training] phase-5 step s={[round(x, 4) for x in step_s]} median after the first="
            f"{step_med:.4f} series/s={train_sps:.1f} (target+source per step) on {smi}")
        log(f"[training] last p5 metrics {json.dumps(p5[-1])}")
        served = tmp / "served_epoch0"
        serve_args = ["--target-root", str(train_data), "--target", "SynSCP2",
                      "--source-root", str(train_data), "--source", "SynEthanol",
                      "--checkpoint", str(train_out / "epoch_0.npz"), "--device", "cuda"]
        acc_served = predict.main(serve_args + ["--out", str(served)])
        with plain_convs(osconv, wn_fused, gate):
            predict.main(serve_args + ["--out", f"{served}_plain"])
        check(np.array_equal(np.load(f"{served}_predict.npy"), np.load(f"{served}_plain_predict.npy")),
              "epoch_0.npz: served predictions differ from plain")
        results["training"] = {
            "phase5_step_s": step_s, "phase5_step_median_s": step_med,
            "phase5_series_per_s": train_sps, "history": history,
            "epoch0_served_accuracy": acc_served, "phase5": p5_record,
        }

        clock.start("phase 8b")
        # ---- phase 8b: --resume of phase 8's run against pipe.run from its
        # returned state
        tt_train, tt_test, ss_train, ss_test = predict.build_datasets(
            train_data, "SynSCP2", train_data, "SynEthanol")
        results["resume"] = resume_phase(
            run, train_cli, StyleTransferPipeline, pipe, state,
            (tt_train, tt_test, ss_train, ss_test), train_out, train_args)

        clock.start("phase 9")
        # ---- phase 9: one full-width phase-5 step against the plain path.
        # Checked on a fresh state whose WN end projections are 0.1*N(0,1):
        # the WN output (log_s about N(0,1)) and every WN gradient are near
        # the scale training gives them.  The flow amplifies last-bit
        # differences of the sums from coupling to coupling wherever log_s
        # is large, as in the state the short drive leaves, so that state is
        # measured, not checked.  The fresh state also runs the plain path on
        # the CPU, held against the plain path on the card: a witness of how far
        # another summation order alone moves the same step.
        batch = (
            torch.as_tensor(tt_train.x[:BATCH]).cuda(), torch.as_tensor(tt_train.y[:BATCH]).long().cuda(),
            torch.as_tensor(ss_train.x[:BATCH]).cuda(), torch.as_tensor(ss_train.y[:BATCH]).long().cuda(),
        )
        g = torch.Generator().manual_seed(21)
        fresh = with_wn_ends(pipe.init_state(g), g)
        cpu_pipe = StyleTransferPipeline(c, t, n_cls, e_c, e_t, e_n, cfg, device="cpu")
        results["phase5_vs_plain_trained"] = phase5_against_plain(
            pipe, state, batch, osconv, wn_fused, gate, gradnorm_step, smi, checked=False,
        )
        results["phase5_vs_plain"] = phase5_against_plain(
            pipe, fresh, batch, osconv, wn_fused, gate, gradnorm_step, smi,
            cpu_pipe=cpu_pipe,
        )

        clock.start("phase 10")
        # ---- phase 10: the same fresh state's phase-5 step, op-by-op route
        # against fused route
        results["phase5_op_by_op_vs_fused"] = phase5_routes(
            pipe, fresh, batch, osconv, wn_fused, gate, gradnorm_step, smi)

        clock.start("phase 11")
        # ---- phase 11: where a phase-5 step's device time goes (the steps
        # update the fresh state: the last use of it)
        results["phase5_profile"] = profile_step(pipe, fresh, batch)

        clock.start("phase 12")
        # ---- phase 12: the op-by-op WN's kernels at full width
        gate_rows = gate_phase(gate, fc.wn_channels, fc.wn_layers)
        tap_rows, tap_grads = tap_conv_phase(osconv, fc.wn_channels, fc.wn_layers)
        results["gate"], results["tap_conv"], results["tap_conv_grad"] = gate_rows, tap_rows, tap_grads
        results["tap_conv_total"] = conv_totals("tap_conv_fwd, 16 tap convs", tap_rows, "ms", "library_ms")

        clock.start("phase 13")
        # ---- phase 13: training through cli.main on the op-by-op route
        op_out = tmp / "train_run_op_by_op"
        with environ(**OP_BY_OP):
            _, op_history, op_step_s, op_p5 = training_drive(
                run, train_cli, StyleTransferPipeline, "training op-by-op",
                train_args(op_out, PHASE_EPOCHS),
                {**run.idle(), **expected_training_launches(pipe, TRAIN_SERIES, PHASE_EPOCHS,
                                                            op_by_op=True)},
                op_out,
            )
        op_med = statistics.median(op_step_s[1:])
        log(f"[training op-by-op] phase-5 step s={[round(x, 4) for x in op_step_s]} median after "
            f"the first={op_med:.4f} (fused route, phase 8: {step_med:.4f}) on {smi}")
        results["training_op_by_op"] = {"phase5_step_s": op_step_s, "phase5_step_median_s": op_med,
                                        "history": op_history, "phase5": op_p5}


        clock.start("phase 14")
        # ---- phase 14: the widened WN kernels on real data
        results["vendored_training"] = vendored_drive(train_cli, StyleTransferPipeline, (osconv, wn_fused, gate), tmp)

        clock.start("phase 15")
        # ---- phase 15: multi-source member training and the vote on the card
        write_dataset(train_data, "SynWorms", {
            "TRAIN": make_arrays(TRAIN_SERIES, WORMS["channels"], WORMS["length"],
                                 WORMS["classes"], seed=15),
            "TEST": make_arrays(TRAIN_SERIES, WORMS["channels"], WORMS["length"],
                                WORMS["classes"], seed=16),
        }, write_ts_file)
        results["multi_source"] = multi_source_phase(
            run, ms_cli, predict, StyleTransferPipeline, cfg, train_data, "SynSCP2",
            {"SynEthanol": ETHANOL, "SynWorms": WORMS}, tmp / "multi_source_run", smi)

        clock.start("phase 16")
        # ---- phase 16: the CoDATS and SLARDA baselines on the card
        results["baselines"] = baselines_phase(
            run, bl_cli, baselines, PipelineConfig, make_arrays, write_ts_file, osconv, wn_fused,
            gate, tmp, smi)

        clock.start("phase 17")
        # ---- phase 17: the archive sweep on the card
        results["archive_sweep"] = sweep_phase(
            run, sweep_cli, (classifier, bucketed), (native, ts_parser), osconv, wn_fused, gate,
            cfg, BNStats, make_arrays, write_ts_file, tmp, smi)

        clock.start("phase 18")
        # ---- phase 18: K runs of the curriculum in one launch set
        results["multirun"] = multirun_phase(run, pipe, (osconv, wn_fused, gate), make_dataset, smi)

        clock.start("phase 19")
        # ---- phase 19: both bf16 switches (FLSTTSC_WN_MXU=bf16,
        # PipelineConfig.compute_dtype="bfloat16")
        results["bf16"] = bf16_phase(
            run, pipe, state, (tt_train, tt_test, ss_train, ss_test), batch,
            (osconv, wn_fused, gate), layers, (wn_init, weight_norm_weight), make_dataset,
            gradnorm_step, smi)

        clock.start("phase 20")
        # ---- phase 20: PipelineConfig's GradNorm / optimizer knobs
        results["knobs"] = knobs_phase(run, pipe, (osconv, wn_fused, gate), batch, smi)

        clock.start("phase 21")
        # ---- phase 21: time-sharded sequence parallelism, 4 ranks on the card
        results["sequence"] = sequence_phase(run, (osconv, wn_fused, gate), smi)

        clock.start("phase 22")
        # ---- phase 22: data parallelism, 4 ranks on the card, and the domain-sharded ensemble
        results["data_parallel"] = dp_phase(run, (osconv, wn_fused, gate),
                                            (wn_init, weight_norm_weight), smi)

        clock.start("phase 23")
        # ---- phase 23: K runs at once on the op-by-op WN route (the run-axis tap conv, the
        # gate's runs folded into its rows)
        results["multirun_op_by_op"] = opbyop_multirun_phase(
            run, pipe, (osconv, wn_fused, gate), make_dataset, smi,
            results["multirun"]["step_vs_one_run"]["per_run"], results["multirun"]["sweep_op_by_op"])

        clock.start("phase 24")
        # ---- phase 24: cli.predict and cli.multi_source under torchrun, the ranks sharing the card
        varied = [tmp / "ckpt" / f"varied{i}.npz" for i in range(3)]
        varied_members(member_def, np.concatenate([t_train.x, t_test.x]), varied,
                       save_checkpoint, BNStats)
        results["torchrun"] = torchrun_phase(
            run, predict, StyleTransferPipeline, cfg, varied, t_test.y, n_layers, data, train_data,
            {"SynEthanol": ETHANOL, "SynWorms": WORMS}, results["multi_source"], tmp, smi)

    clock.start(None)
    results["phase_s"] = clock.secs
    for name, n in run.launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    results["launches_by_drive"] = run.by_drive
    results["launches_by_path"] = run.by_path
    line = {"kernels": [
        {
            "name": "os_conv_fwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["os_conv_fwd"], "launches": run.launches["os_conv_fwd"],
            "max_abs_err": max(r["max_abs"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if sum(r["tc_flop_ms"] for r in rows) >= sum(r["bytes_ms"] for r in rows) else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
        },
        {
            "name": "os_conv_fused_fwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["os_conv_fused_fwd"], "launches": run.launches["os_conv_fused_fwd"],
            "max_abs_err": max(r["fused_max_abs"] for r in rows),
            "ms": sum(r["fused_ms"] for r in rows),
            "plain_ms": sum(r["fused_plain_ms"] for r in rows),
            "bound_ms": sum(r["fused_bound_ms"] for r in rows),
            "bound_by": "operations" if sum(r["tc_flop_ms"] for r in rows) >= sum(r["fused_bytes_ms"] for r in rows) else "bytes",
            "library_ms": None,
        },
    ]}
    for name, d in (("wn_fwd", "fwd"), ("wn_bwd", "bwd")):
        # one pair call (46,080 rows) plus one infer call (23,040 rows)
        line["kernels"].append({
            "name": name, "route": "cuda", "source": WN_SOURCE, "replaces": REPLACES[name],
            "launches": run.launches[name],
            "max_abs_err": max(r[f"{d}_max_abs"] for r in wn_rows),
            "ms": sum(r[f"{d}_ms"] for r in wn_rows),
            "plain_ms": sum(r[f"{d}_plain_ms"] for r in wn_rows),
            "bound_ms": sum(r[f"{d}_bound_ms"] for r in wn_rows),
            "bound_by": "operations" if sum(r[f"{d}_tc_flop_ms"] for r in wn_rows)
            >= sum(r[f"{d}_bytes_ms"] for r in wn_rows) else "bytes",
            "library_ms": None,
        })
    line["kernels"].append({
        # one pair call (46,080 rows) plus one infer call (23,040 rows)
        "name": "gate_fwd", "route": "cuda", "source": GATE_SOURCE, "replaces": REPLACES["gate_fwd"],
        "launches": run.launches["gate_fwd"],
        "max_abs_err": max(r["max_abs"] for r in gate_rows),
        "ms": sum(r["ms"] for r in gate_rows), "plain_ms": sum(r["plain_ms"] for r in gate_rows),
        "bound_ms": sum(r["bound_ms"] for r in gate_rows),
        "bound_by": "bytes" if sum(r["bytes_ms"] for r in gate_rows)
        >= sum(r["flop_ms"] for r in gate_rows) else "operations",
        "library_ms": None,
    })
    line["kernels"].append({
        # the 16 tap convs of one pair-shape WN forward (8 layers) and backward
        "name": "tap_conv_fwd", "route": "cuda", "source": TAP_SOURCE,
        "replaces": REPLACES["tap_conv_fwd"], "launches": run.launches["tap_conv_fwd"],
        "max_abs_err": max(r["max_abs"] for r in tap_rows),
        "ms": sum(r["ms"] for r in tap_rows), "plain_ms": sum(r["plain_ms"] for r in tap_rows),
        "bound_ms": sum(r["bound_ms"] for r in tap_rows),
        "bound_by": "operations" if sum(r["tc_flop_ms"] for r in tap_rows)
        >= sum(r["bytes_ms"] for r in tap_rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in tap_rows),
    })
    for name, (one_run, source) in RUN_AXIS.items():
        # every recorded call of phase 18's checks (its shapes), summed
        rows_k = results["multirun"]["run_axis"][name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[one_run],
            "launches": run.launches[name],
            "max_abs_err": max(r["max_abs"] for r in rows_k),
            "ms": sum(r["ms"] for r in rows_k), "plain_ms": sum(r["plain_ms"] for r in rows_k),
            "bound_ms": sum(r["bound_ms"] for r in rows_k),
            "bound_by": "operations" if sum(r["tc_flop_ms"] for r in rows_k)
            >= sum(r["bytes_ms"] for r in rows_k) else "bytes",
            "library_ms": (sum(r["library_ms"] for r in rows_k)
                           if all(r["library_ms"] is not None for r in rows_k) else None),
        })
    for name, (one_run, source) in OPBYOP_RUN_AXIS.items():
        # every recorded call of phase 23's K-run step (its shapes), summed
        rows_k = results["multirun_op_by_op"]["run_axis"][name]
        flop_ms = sum(r["tc_flop_ms"] for r in rows_k)
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[one_run],
            "launches": run.launches[name],
            "max_abs_err": max(r["max_abs"] for r in rows_k),
            "ms": sum(r["ms"] for r in rows_k), "plain_ms": sum(r["plain_ms"] for r in rows_k),
            "bound_ms": sum(r["bound_ms"] for r in rows_k),
            "bound_by": "operations" if flop_ms >= sum(r["bytes_ms"] for r in rows_k) else "bytes",
            "library_ms": (sum(r["library_ms"] for r in rows_k)
                           if all(r["library_ms"] is not None for r in rows_k) else None),
        })
    for name, (source, replaces) in BF16.items():
        # phase 19: the six serving convs; pair plus infer WN calls; the run-axis forms at
        # the shapes of one K-run phase-5 step, each summed; bounds at the BF16 peak
        rows_b = results["bf16"]["rows"][name]
        flop_ms = sum(r.get("flop_ms", r.get("tc_flop_ms")) for r in rows_b)
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": run.launches[name],
            "max_abs_err": max(r["max_abs"] for r in rows_b),
            "ms": sum(r["ms"] for r in rows_b), "plain_ms": sum(r["plain_ms"] for r in rows_b),
            "bound_ms": sum(r["bound_ms"] for r in rows_b),
            "bound_by": "operations" if flop_ms >= sum(r["bytes_ms"] for r in rows_b) else "bytes",
            "library_ms": (sum(r["library_ms"] for r in rows_b)
                           if all(r["library_ms"] is not None for r in rows_b) else None),
        })
    results["summary"] = line
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_results.json").write_text(json.dumps(results, indent=1))
    log(f"card: {smi}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # a rank of phase 24, under torchrun
        sys.exit(cli_rank(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
