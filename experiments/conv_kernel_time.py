#!/usr/bin/env python3
"""Check and time the port's two tap-GEMM kernels at their main-path shapes.

Run from the repository root on a CUDA card:

    python3 experiments/conv_kernel_time.py [--reps N]

Builds ``os_conv`` and ``tap_conv`` (``ops/csrc``), prints ptxas's register
and spill lines, then for the six masked OS convs of the SCP2 serving model
(B=20, T=1152) and the 16 tap convs of one pair-shape WN (B=40, T=1152, C
120 -> 240 at d = 1..128 and the 240 -> 120 input-gradient passes) holds
each kernel against its plain version (rel 1e-4) and prints the time a call
of the kernel and of ``F.conv1d`` (TF32 off): CUDA events around a run of
``--reps`` back-to-back calls, median of 3 runs.  Then, under
``torch.profiler``, the device time a call of each kernel it launches (the
weight prep against the GEMM).  A quicker loop than ``chip_smoke.py``
while a kernel is tuned (it imports the port of the tree it sits in: to
compare two trees, run each one's copy in turns in one call); imports only
torch and the port.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

REL_TOL = 1e-4


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


def cases(osconv, specs, total_out_channels):
    """(what, kernel call, plain call, library call, live and issued FLOPs)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for spec in specs:
        k, c_in, c_out = spec[-1][-1], spec[0][0], total_out_channels(spec)
        mask = torch.from_numpy(osconv.build_os_mask(spec)).cuda()
        x = torch.randn(20, 1152 + k - 1, c_in, device="cuda", generator=gen)
        w = torch.randn(k, c_in, c_out, device="cuda", generator=gen) / math.sqrt(c_in * k) * mask
        x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        win = osconv.tap_windows_plain(w.cpu())
        cols = torch.tensor([min(8, c_out - 8 * g) for g in range(len(win))])
        issued = 2 * 20 * 1152 * c_in * int(((win[:, 1] - win[:, 0]) * cols).sum())
        live = 2 * 20 * 1152 * c_in * int(mask.sum())
        out.append((f"os_conv {c_in}->{c_out} k={k}",
                    lambda x=x, w=w: osconv.os_conv(x, w),
                    lambda x=x, w=w: osconv.os_conv_plain(x, w),
                    lambda x=x_ncw, w=w_oik: F.conv1d(x, w), live, issued))
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
                        lambda x=x_ncw, w=w_oik, d=d: F.conv1d(x, w, dilation=d), flops, flops))
    return out


def measure(all_cases, reps: int) -> dict:
    sums = {"os_ms": 0.0, "os_lib_ms": 0.0, "tap_ms": 0.0, "tap_lib_ms": 0.0, "ok": True}
    for what, kernel, plain, lib, live, issued in all_cases:
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


def ptxas_lines(tag: str, path: Path) -> None:
    for line in (path.parent / (path.name + ".ptxas.txt")).read_text().splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  ptxas {tag} {path.name}: {line.strip()}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, osconv
    from feature_level_style_transfer_for_tsc_tpu_torch.structure import total_out_channels
    from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import build_specs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    for name in ("os_conv", "tap_conv"):
        ptxas_lines(name, _build.build(name))
    ext, cls = build_specs(7, 1152, PipelineConfig())
    all_cases = cases(osconv, ext + cls, total_out_channels)
    ok = measure(all_cases, args.reps)["ok"]
    profile(all_cases)
    print(json.dumps({"ok": ok, "card": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
