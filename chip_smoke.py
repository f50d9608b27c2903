#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and check its kernels.

Run from the repository root with one CUDA card:  python3 chip_smoke.py

It imports only torch, numpy and the port (never jax or the JAX package),
exits non-zero without a card or without the port beside it, and exits
non-zero when any check fails.  Phases:

1. setup: the card's name and power limit, TF32 off, the kernels' build
   from ``ops/csrc`` (timed);
2. each kernel against its plain PyTorch version at the six masked OS convs
   of the full-width serving model (SelfRegulationSCP2 shape of the
   reference main.py: 7 channels, T=1152, 2 classes; budget_multiplier=1.0,
   batch 20), with CUDA-event times of the kernel, the plain version and
   F.conv1d (the library yardstick, TF32 off) beside the bound;
3. single-checkpoint serving through ``cli.predict.main`` on SCP2-shaped
   synthetic data (200 train / 180 test series), with the launch counts,
   the logits against the plain path on the card, and series/s;
4. ensemble serving (3 members, entropy_precision vote) through
   ``cli.predict.main``, with launch counts and predictions against the plain
   path, and the members' logits on the whole train and test splits and the
   class weights against the plain path; phases 3 and 4 run with
   FLSTTSC_FUSE_EPILOGUE unset and =1; every checkpoint carries random
   BatchNorm state, so the folded epilogue is exercised;
5. the vendored VendGunPoint (T=150) once through ``cli.predict.main``.

The launch counts are set to 0 just before each drive of the serving path
and read just after it.  The line before the last lists every kernel as
JSON, with the launches of the SCP2 drives (single and ensemble; not the
VendGunPoint check) and a bound from the FLOPs of the mask's live taps; the
last line is {"ok": true, "device": {...}}.  Everything measured is also
written to chiprun_out/chip_smoke_results.json.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FP32_PEAK = 67e12  # H100 SXM FP32 FLOP/s outside the tensor cores (NVIDIA data sheet)
HBM_RATE = 3.35e12  # H100 SXM device memory bytes/s
REL_TOL = 1e-4  # max_abs / max|plain|, exact f32 both sides, sums in another order
BATCH = 20
SCP2 = {"channels": 7, "length": 1152, "classes": 2, "n_train": 200, "n_test": 180}
SOURCE = "feature_level_style_transfer_for_tsc_tpu_torch/ops/csrc/os_conv.cu"
REPLACES = {
    "os_conv_fwd": "feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:258",
    "os_conv_fused_fwd": "feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:288",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median CUDA-event time of one call, after warmup."""
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


def rel_err(got: torch.Tensor, want: torch.Tensor):
    max_abs = (got - want).abs().max().item()
    return max_abs, max_abs / max(want.abs().max().item(), 1e-30)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Run:
    """Launch counts of the drives; ``launches`` sums, per kernel, those of
    the SCP2 main path (single and ensemble), and ``by_drive`` keeps each."""

    def __init__(self, osconv):
        self.osconv = osconv
        self.launches = {name: 0 for name in osconv.LAUNCHES}
        self.by_drive = {}

    def drive(self, what: str, fn, expect: dict, main_path: bool = True):
        self.osconv.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(self.osconv.LAUNCHES)
        log(f"[{what}] launches={counts} expected={expect} wall_s={wall:.3f}")
        check(counts == expect, f"{what}: launches {counts} != {expect}")
        self.by_drive[what] = counts
        if main_path:
            for name, n in counts.items():
                self.launches[name] += n
        return out


@contextlib.contextmanager
def plain_convs(osconv):
    """The reference run: the plain PyTorch versions on the same CUDA tensors
    (and no kernel launch inside)."""
    saved = osconv.os_conv, osconv.os_conv_fused
    osconv.os_conv, osconv.os_conv_fused = osconv.os_conv_plain, osconv.os_conv_fused_plain
    osconv.reset_launch_counts()
    try:
        yield
    finally:
        osconv.os_conv, osconv.os_conv_fused = saved
    check(not any(osconv.LAUNCHES.values()), f"the plain reference launched {osconv.LAUNCHES}")


@contextlib.contextmanager
def fuse_epilogue(on: bool):
    old = os.environ.get("FLSTTSC_FUSE_EPILOGUE")
    os.environ["FLSTTSC_FUSE_EPILOGUE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FLSTTSC_FUSE_EPILOGUE")
        else:
            os.environ["FLSTTSC_FUSE_EPILOGUE"] = old


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
        conv_bytes = 4 * (x_pad.numel() + w.numel() + y.numel())
        fused_bytes = conv_bytes + 4 * 2 * c_out
        row = {
            "layer": name, "c_in": c_in, "c_out": c_out, "k": k, "relu": relu,
            "live_tap_share": live_taps / (k * c_out),
            "gflop": flops / 1e9, "dense_gflop": dense_flops / 1e9,
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
            "flop_ms": flops / FP32_PEAK * 1e3,
            "bytes_ms": conv_bytes / HBM_RATE * 1e3,
            "fused_bytes_ms": fused_bytes / HBM_RATE * 1e3,
        }
        row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
        row["fused_bound_ms"] = max(row["flop_ms"], row["fused_bytes_ms"])
        row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9  # live taps only
        row["kernel_dense_tflops"] = dense_flops / row["kernel_ms"] / 1e9
        log("kernel " + json.dumps(row))
        check(rel <= REL_TOL, f"{name}: os_conv_fwd rel err {rel:.3e} > {REL_TOL}")
        check(row["fused_rel"] <= REL_TOL, f"{name}: os_conv_fused_fwd rel err {row['fused_rel']:.3e}")
        rows.append(row)
    return rows


# -------------------------------------------------------------- phases 3-5 --

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import predict
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import (
        make_arrays,
        write_ts_file,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import save_checkpoint
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, osconv
    from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import BNStats
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
        MultiSourceEnsemble,
    )
    from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels
    from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import OSCNNClassifier
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import TargetPredictor

    # ---- phase 1: setup
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
    t0 = time.perf_counter()
    osconv._lib()
    build_s = time.perf_counter() - t0
    lib_path = _build.build("os_conv")
    ptxas = (lib_path.parent / (lib_path.name + ".ptxas.txt")).read_text()
    log(f"build: {lib_path.name} in {build_s:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    results = {"device": kind, "nvidia_smi": smi, "build_s": build_s}
    cfg = PipelineConfig(budget_multiplier=1.0)
    predictor = TargetPredictor(
        SCP2["channels"], SCP2["length"], SCP2["classes"], config=cfg, device="cuda"
    )

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

    run = Run(osconv)
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
        member_def = OSCNNClassifier(c, t, n_cls, config=cfg, device="cuda")
        members = [tmp / "ckpt" / f"member{i}.npz" for i in (1, 2)]
        for i, path in enumerate(members):
            member = member_def.init_state(torch.Generator().manual_seed(10 + i))
            save_checkpoint(str(path), with_random_bn(member, rng, BNStats))
        ensemble = [members[0], single, members[1]]

        n_layers = len(layers)
        n_batches = math.ceil(SCP2["n_test"] / BATCH)
        x_test = torch.as_tensor(t_test.x).cuda()
        results["serving"] = {}
        for fused in (False, True):
            kern = "os_conv_fused_fwd" if fused else "os_conv_fwd"
            idle = {name: 0 for name in osconv.LAUNCHES}
            tag = "fused" if fused else "unfused"
            with fuse_epilogue(fused):
                # ---- phase 3: one checkpoint
                out = tmp / f"single_{tag}"
                acc = run.drive(
                    f"single {tag}",
                    lambda: predict.main(cli_args(data, "SynSCP2", data, "SynSource", [single], out)),
                    {**idle, kern: n_layers * n_batches},
                )
                preds = np.load(f"{out}_predict.npy")
                params, mstate = state["params"], state["mstate"]
                logits = predictor.predict_logits(params, mstate, x_test)
                with plain_convs(osconv):
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

                # ---- phase 4: ensemble of 3
                out = tmp / f"ensemble_{tag}"
                acc_e = run.drive(
                    f"ensemble {tag}",
                    lambda: predict.main(cli_args(data, "SynSCP2", data, "SynSource", ensemble, out)),
                    {**idle, kern: len(ensemble) * n_layers * 2},
                )
                with plain_convs(osconv):
                    predict.main(cli_args(data, "SynSCP2", data, "SynSource", ensemble, f"{out}_plain"))
                same = np.array_equal(np.load(f"{out}_predict.npy"), np.load(f"{out}_plain_predict.npy"))
                check(same, f"ensemble {tag}: predictions differ from plain")
                ens = MultiSourceEnsemble(c, t, n_cls, config=cfg, device="cuda")
                stacked = ens.stack([predict._load_member(str(p), "cuda") for p in ensemble])
                weights = ens.compute_class_weights(stacked, t_train.x, t_train.y)
                # the members at the ensemble's own shapes (whole train and
                # test splits in one call each) against the plain path
                ens_rel = {}
                for split, x in (("train", t_train.x), ("test", t_test.x)):
                    got = ens.member_logits(stacked, x)
                    with plain_convs(osconv):
                        want = ens.member_logits(stacked, x)
                    check(tuple(got.shape) == (len(ensemble), len(x), n_cls)
                          and bool(torch.isfinite(got).all()),
                          f"ensemble {tag}: {split} member logits {tuple(got.shape)}")
                    ens_rel[split] = rel_err(got, want)[1]
                    check(ens_rel[split] <= REL_TOL,
                          f"ensemble {tag}: {split} member logits rel err {ens_rel[split]:.3e}")
                with plain_convs(osconv):
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
                log(f"[ensemble {tag}] accuracy={acc_e:.4f} series/s={ens_sps:.1f} on {smi}")
                results["serving"][tag] = {
                    "single_accuracy": acc, "single_logits_rel": l_rel,
                    "single_series_per_s": single_sps,
                    "ensemble_accuracy": acc_e, "ensemble_series_per_s": ens_sps,
                    "ensemble_rel": ens_rel,
                }

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
            {"os_conv_fwd": n_g * math.ceil(g_test.len / BATCH), "os_conv_fused_fwd": 0},
            main_path=False,
        )
        with plain_convs(osconv):
            predict.main(cli_args(uni, "VendGunPoint", uni, "VendCoffee", [g_ckpt], f"{out}_plain"))
        check(np.array_equal(np.load(f"{out}_predict.npy"), np.load(f"{out}_plain_predict.npy")),
              "VendGunPoint: predictions differ from plain")

    for name, n in run.launches.items():
        check(n > 0, f"{name} was never launched on the serving path")
    results["launches_by_drive"] = run.by_drive
    line = {"kernels": [
        {
            "name": "os_conv_fwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["os_conv_fwd"], "launches": run.launches["os_conv_fwd"],
            "max_abs_err": max(r["max_abs"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if sum(r["flop_ms"] for r in rows) >= sum(r["bytes_ms"] for r in rows) else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
        },
        {
            "name": "os_conv_fused_fwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["os_conv_fused_fwd"], "launches": run.launches["os_conv_fused_fwd"],
            "max_abs_err": max(r["fused_max_abs"] for r in rows),
            "ms": sum(r["fused_ms"] for r in rows),
            "plain_ms": sum(r["fused_plain_ms"] for r in rows),
            "bound_ms": sum(r["fused_bound_ms"] for r in rows),
            "bound_by": "operations" if sum(r["flop_ms"] for r in rows) >= sum(r["fused_bytes_ms"] for r in rows) else "bytes",
            "library_ms": None,
        },
    ]}
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
    sys.exit(main())
