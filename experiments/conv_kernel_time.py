#!/usr/bin/env python3
"""Check and time the port's two tap-GEMM kernels at their main-path shapes.

Run from the repository root on a CUDA card:

    python3 experiments/conv_kernel_time.py [--reps N] [--bf16] [--tree DIR] [--label NAME]
                                            [--save PATH] [--against PATH]

Builds ``os_conv`` and ``tap_conv`` (``ops/csrc``), prints ptxas's register
and spill lines, then for the six masked OS convs of the SCP2 serving model
(B=20, T=1152) and the 16 tap convs of one pair-shape WN (B=40, T=1152, C
120 -> 240 at d = 1..128 and the 240 -> 120 input-gradient passes) holds
each kernel against its plain version (rel 1e-4) and prints the time a call
of the kernel and of ``F.conv1d`` (TF32 off): CUDA events around a run of
``--reps`` back-to-back calls, median of 3 runs.  Then, under
``torch.profiler``, the device time a call of each kernel it launches (the
weight prep against the GEMM).

``--bf16`` takes the bf16 OS conv instead (``os_conv_fwd[bf16]``, the
convs of ``PipelineConfig(compute_dtype="bfloat16")``): ptxas's lines for
its kernels; the six serving convs on the same operands rounded to bf16,
held within 1e-4 (relative L2) of ``os_conv_plain`` in bf16 and timed
beside ``F.conv1d`` in bf16 and the plain version; then the run-axis form
(``os_conv_fwd_runs[bf16]``) on every distinct conv call of one K = 8
phase-5 step of ``MultiRunStylePipeline`` at the reference main.py pair's
shapes (SCP2 7 x 1152 <- EthanolLevel 1 x 1751, the calls recorded from the
step), each run the one-run call's bits, timed beside the grouped bf16
``F.conv1d`` and the plain version run by run.  Bounds: the live taps'
operations at the dense BF16 peak.

``--tree DIR`` times the port of another tree (e.g. the parent commit
unpacked by ``git archive`` into a git-ignored directory) with this
script's cases, so two trees are compared in turns in one call (parent,
change, change, parent).  ``--save PATH`` writes every case's kernel
outputs (float32: ``os_conv``, ``os_conv_fused`` with a fixed affine and
ReLU, ``tap_conv_fwd``), ``--against PATH`` reports whether this run's are
the same bits.  A quicker loop than ``chip_smoke.py`` while a kernel is
tuned; imports only torch and the port.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-4
BF16_REL_L2 = 1e-4  # a bf16 output against the plain bf16 version (chip_smoke.BF16_REL_L2)
BF16_PEAK = 989.4e12  # H100 SXM dense BF16 FLOP/s on the tensor cores (NVIDIA data sheet)
HBM_RATE = 3.35e12  # H100 SXM device memory bytes/s
RUNS_K = 8
TARGET, SOURCE, BATCH = (7, 1152, 2), (1, 1751, 4), 20  # the main.py pair, a domain's batch


def cuda_ms(fn, reps: int) -> float:
    """Time a call: CUDA events around ``reps`` back-to-back calls, median of 3."""
    for _ in range(2):
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


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def serving_operands(osconv, specs, total_out_channels):
    """(spec's name, x_pad, masked w, mask) of each serving conv, float32."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for spec in specs:
        k, c_in, c_out = spec[-1][-1], spec[0][0], total_out_channels(spec)
        mask = torch.from_numpy(osconv.build_os_mask(spec)).cuda()
        x = torch.randn(20, 1152 + k - 1, c_in, device="cuda", generator=gen)
        w = torch.randn(k, c_in, c_out, device="cuda", generator=gen) / math.sqrt(c_in * k) * mask
        out.append((f"os_conv {c_in}->{c_out} k={k}", x, w, mask))
    return out


def cases(osconv, specs, total_out_channels):
    """(what, kernel call, plain call, library call, live and issued FLOPs,
    the outputs to save)."""
    out = []
    for what, x, w, mask in serving_operands(osconv, specs, total_out_channels):
        c_out = w.shape[2]
        x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        win = osconv.tap_windows_plain(w.cpu())
        cols = torch.tensor([min(8, c_out - 8 * g) for g in range(len(win))])
        issued = 2 * 20 * 1152 * w.shape[1] * int(((win[:, 1] - win[:, 0]) * cols).sum())
        live = 2 * 20 * 1152 * w.shape[1] * int(mask.sum())
        scale = torch.linspace(0.5, 1.5, c_out, device="cuda")
        shift = torch.linspace(-0.2, 0.2, c_out, device="cuda")
        out.append((what,
                    lambda x=x, w=w: osconv.os_conv(x, w),
                    lambda x=x, w=w: osconv.os_conv_plain(x, w),
                    lambda x=x_ncw, w=w_oik: F.conv1d(x, w), live, issued,
                    lambda x=x, w=w, s=scale, h=shift: [osconv.os_conv(x, w),
                                                        osconv.os_conv_fused(x, w, s, h, True)]))
    gen = torch.Generator(device="cuda").manual_seed(1)
    for what, c_in, c_out, halo in (("fwd", 120, 240, 2), ("dx", 240, 120, 4)):
        for i in range(8):
            d = 2 ** i
            x = torch.randn(40, 1152 + halo * d, c_in, device="cuda", generator=gen)
            w = torch.randn(3, c_in, c_out, device="cuda", generator=gen) / math.sqrt(3 * c_in)
            x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
            flops = 2 * 40 * (1152 + (halo - 2) * d) * 3 * c_in * c_out
            out.append((f"tap_conv {what} d={d}",
                        lambda x=x, w=w, d=d: osconv.tap_conv_fwd(x, w, d),
                        lambda x=x, w=w, d=d: osconv.tap_conv_plain(x, w, d),
                        lambda x=x_ncw, w=w_oik, d=d: F.conv1d(x, w, dilation=d), flops, flops,
                        lambda x=x, w=w, d=d: [osconv.tap_conv_fwd(x, w, d)]))
    return out


def measure(all_cases, reps: int) -> dict:
    sums = {"os_ms": 0.0, "os_lib_ms": 0.0, "tap_ms": 0.0, "tap_lib_ms": 0.0, "ok": True}
    for what, kernel, plain, lib, live, issued, _ in all_cases:
        rel = rel_err(kernel(), plain())
        row = {"case": what, "rel": rel, "ms": cuda_ms(kernel, reps), "lib_ms": cuda_ms(lib, reps)}
        row["live_tflops"] = live / row["ms"] / 1e9
        row["issued_tflops"] = issued / row["ms"] / 1e9
        kind = "os" if what.startswith("os_conv") else "tap"
        sums[f"{kind}_ms"] += row["ms"]
        sums[f"{kind}_lib_ms"] += row["lib_ms"]
        sums["ok"] &= rel <= REL_TOL
        print("case " + json.dumps(row), flush=True)
    print("total " + json.dumps(sums), flush=True)
    return sums


def same_bits(outputs: dict, against: Path) -> bool:
    """This run's saved outputs against another run's (``--save``), case by case."""
    other = torch.load(against)
    ok = True
    for what, outs in outputs.items():
        same = [torch.equal(a, b.to(a.device)) for a, b in zip(outs, other[what])]
        ok &= all(same)
        print(f"same bits as {against.name}: {what} {same}", flush=True)
    return ok


def profile(all_cases, reps: int = 5) -> None:
    """Device time a call by kernel name (torch.profiler), at the serving
    convs and the d = 1 tap convs."""
    from torch.profiler import ProfilerActivity, profile as trace

    for what, kernel, *_ in all_cases:
        if "d=" in what and not what.endswith("d=1"):
            continue
        kernel()
        torch.cuda.synchronize()
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kernel()
            torch.cuda.synchronize()
        by = {e.key[:60]: round(e.self_device_time_total / 1e3 / reps, 4)
              for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}
        print(f"profile {what}: ms a call by kernel {json.dumps(by)}", flush=True)


def ptxas_lines(tag: str, path: Path, only=None) -> None:
    """ptxas's register and spill lines of ``path``'s kernels (those whose
    mangled name contains one of ``only``, where given)."""
    entry = ""
    for line in (path.parent / (path.name + ".ptxas.txt")).read_text().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or ("spill" in line and " 0 bytes spill stores" not in line)
              or (only and "spill" in line)):
            if only is None or any(o in entry for o in only):
                print(f"  ptxas {tag} {entry[-90:]}: {line.strip()}", flush=True)


def bf16_serving_rows(osconv, specs, total_out_channels, reps: int) -> dict:
    """``os_conv_fwd[bf16]`` at the six serving convs: against the plain bf16
    version, timed beside ``F.conv1d`` in bf16 and the plain version."""
    tot = {"ms": 0.0, "library_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "gflop": 0.0,
           "ok": True}
    outputs = {}
    for what, x32, w32, mask in serving_operands(osconv, specs, total_out_channels):
        x, w = x32.bfloat16(), w32.bfloat16()
        x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        y = osconv.os_conv(x, w)
        outputs[what] = [y]
        flops = 2 * 20 * 1152 * w.shape[1] * int(mask.sum())  # live taps
        row = {"case": what + " bf16", "rel_l2": rel_l2(y, osconv.os_conv_plain(x, w)),
               "library_rel_l2": rel_l2(F.conv1d(x_ncw, w_oik).transpose(1, 2), y),
               "ms": cuda_ms(lambda: osconv.os_conv(x, w), reps),
               "library_ms": cuda_ms(lambda: F.conv1d(x_ncw, w_oik), reps),
               "plain_ms": cuda_ms(lambda: osconv.os_conv_plain(x, w), 2),
               "gflop": flops / 1e9,
               "bound_ms": max(flops / BF16_PEAK,
                               2 * (x.numel() + w.numel() + y.numel()) / HBM_RATE) * 1e3}
        row["live_tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        for key in ("ms", "library_ms", "plain_ms", "bound_ms", "gflop"):
            tot[key] += row[key]
        tot["ok"] &= row["rel_l2"] <= BF16_REL_L2
        print("bf16 case " + json.dumps(row), flush=True)
    tot["live_tflops"] = tot["gflop"] / tot["ms"]
    tot["bound_share"] = tot["bound_ms"] / tot["ms"]
    tot["kernel_over_library"] = tot["ms"] / tot["library_ms"]
    print("bf16 serving total " + json.dumps(tot), flush=True)
    return tot, outputs


@contextlib.contextmanager
def recorded_runs(osconv):
    """``osconv.os_conv_runs`` wrapped to keep the arguments of its first
    call of each distinct set of shapes."""
    seen, saved = {}, osconv.os_conv_runs

    def inner(x_pad, w):
        key = (tuple(x_pad.shape), tuple(w.shape))
        if key not in seen:
            seen[key] = (x_pad.detach().clone(), w.detach().clone())
        return saved(x_pad, w)

    osconv.os_conv_runs = inner
    try:
        yield seen
    finally:
        osconv.os_conv_runs = saved


def bf16_run_rows(osconv, reps: int) -> dict:
    """``os_conv_fwd_runs[bf16]`` on the distinct conv calls of one K = 8
    phase-5 step with ``compute_dtype="bfloat16"``."""
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_dataset
    from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import MultiRunStylePipeline
    from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

    pipe = StyleTransferPipeline(*TARGET, *SOURCE, PipelineConfig(compute_dtype="bfloat16"),
                                 device="cuda")
    mp = MultiRunStylePipeline(pipe)
    states = mp.init_states(range(RUNS_K))
    batch = []
    t, s = make_dataset(BATCH, *TARGET, seed=11), make_dataset(BATCH, *SOURCE, seed=13)
    for a, dtype in ((t.x, torch.float32), (t.y, torch.long), (s.x, torch.float32),
                     (s.y, torch.long)):
        v = torch.as_tensor(np.asarray(a)).to("cuda", dtype)
        batch.append(v.expand(RUNS_K, *v.shape).contiguous())
    with recorded_runs(osconv) as calls:
        mp.phase5_step(states, *batch, 0)
    torch.cuda.synchronize()
    del states, mp, pipe
    tot = {"calls": len(calls), "ms": 0.0, "one_run_calls_ms": 0.0, "library_ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "gflop": 0.0, "ok": True}
    for (xs, ws), (x_pad, w) in calls.items():
        runs, b, t_pad, c_in = x_pad.shape
        k, c_out = w.shape[1], w.shape[3]
        got = osconv.os_conv_runs(x_pad, w)
        one = [osconv.os_conv(x_pad[r], w[r]) for r in range(runs)]
        plain = torch.stack([osconv.os_conv_plain(x_pad[r], w[r]) for r in range(runs)])
        x_ncw = x_pad.permute(1, 0, 3, 2).reshape(b, runs * c_in, t_pad).contiguous()
        w_oik = w.permute(0, 3, 2, 1).reshape(runs * c_out, c_in, k).contiguous()
        live = int((w != 0).any(dim=2).sum().item())  # (run, tap, column) with a nonzero weight
        flops = 2 * b * (t_pad - k + 1) * c_in * live
        row = {"case": f"os_conv_runs bf16 {list(xs)} x {list(ws)}",
               "same_bits_as_one_run": all(torch.equal(got[r], one[r]) for r in range(runs)),
               "rel_l2": rel_l2(got, plain),
               "ms": cuda_ms(lambda: osconv.os_conv_runs(x_pad, w), reps),
               "one_run_calls_ms": cuda_ms(
                   lambda: [osconv.os_conv(x_pad[r], w[r]) for r in range(runs)], 2),
               "library_ms": cuda_ms(lambda: F.conv1d(x_ncw, w_oik, groups=runs), reps),
               "plain_ms": cuda_ms(lambda: [osconv.os_conv_plain(x_pad[r], w[r])
                                            for r in range(runs)], 1),
               "gflop": flops / 1e9,
               "bound_ms": max(flops / BF16_PEAK,
                               2 * (x_pad.numel() + w.numel() + got.numel()) / HBM_RATE) * 1e3}
        row["live_tflops"] = flops / row["ms"] / 1e9
        for key in ("ms", "one_run_calls_ms", "library_ms", "plain_ms", "bound_ms", "gflop"):
            tot[key] += row[key]
        tot["ok"] &= row["same_bits_as_one_run"] and row["rel_l2"] <= BF16_REL_L2
        print("bf16 runs case " + json.dumps(row), flush=True)
    tot["live_tflops"] = tot["gflop"] / tot["ms"]
    tot["bound_share"] = tot["bound_ms"] / tot["ms"]
    tot["kernel_over_library"] = tot["ms"] / tot["library_ms"]
    print(f"bf16 runs K={RUNS_K} total " + json.dumps(tot), flush=True)
    return tot


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--bf16", action="store_true", help="the bf16 OS conv")
    parser.add_argument("--tree", type=Path, default=REPO, help="the tree whose port is timed")
    parser.add_argument("--label", default=None)
    parser.add_argument("--save", type=Path, default=None, help="write the kernels' outputs")
    parser.add_argument("--against", type=Path, default=None,
                        help="compare the kernels' outputs with a --save of another run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    label = args.label or tree.name
    sys.path.insert(0, str(tree))
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, osconv
    from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels
    from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import build_specs

    if not Path(osconv.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {osconv.__file__}, not the port in {tree}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; tree: {label}", flush=True)
    ext, cls = build_specs(7, 1152, PipelineConfig())
    if args.bf16:
        # the bf16 kernels: this tree's tap_gemm_bf16_kernel, or a BF16 template instance
        ptxas_lines(label, _build.build("os_conv"), only=("bf16", "Lb1E"))
        serving, outputs = bf16_serving_rows(osconv, ext + cls, total_out_channels, args.reps)
        runs = bf16_run_rows(osconv, max(3, args.reps // 4))
        ok = serving["ok"] and runs["ok"]
        summary = {"serving": serving, "runs": runs}
    else:
        for name in ("os_conv", "tap_conv"):
            ptxas_lines(label, _build.build(name))
        all_cases = cases(osconv, ext + cls, total_out_channels)
        ok = measure(all_cases, args.reps)["ok"]
        profile(all_cases)
        outputs = {case[0]: case[-1]() for case in all_cases}
        summary = {}
    if args.save:
        args.save.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: [t.cpu() for t in v] for k, v in outputs.items()}, args.save)
    if args.against:
        summary["same_bits"] = same_bits(outputs, args.against)
    print(json.dumps({"ok": ok, "label": label, "bf16": args.bf16, "card": smi, **summary}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
