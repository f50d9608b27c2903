#!/usr/bin/env python3
"""Check and time the port's WN kernels ``wn_fwd`` and ``wn_bwd`` at the
shapes of ``chip_smoke.py`` phase 6, with their device time by ``__global__``
kernel.

Run from the repository root on a CUDA card:

    python3 experiments/wn_time.py [--tree DIR] [--reps N] [--label NAME]

Builds ``wn_fused`` (``ops/csrc``) of the port in ``DIR`` (default: this
tree), prints ptxas's register and spill lines, then at the pair pass
(B=40, T=1152, n_half 25), the infer pass (B=20), and VendGunPoint's (B=40,
T=150, n_half 65) and VendCoffee's (B=40, T=60, n_half 168) pair passes (C
120, 8 layers, phase 6's inputs) holds every output of ``wn_fwd`` and
``wn_bwd`` against ``wn_fwd_plain`` and ``wn_bwd_plain`` (max|diff| over
max|plain|), checks that two runs give the same bits, and prints the time of
a call beside its FLOPs, and under ``torch.profiler`` the device time a call
of each kernel it launches.  The
inputs, the timing, the FLOP count and the profiler breakdown are phase 6's
own (this tree's ``chip_smoke.py``); only the port under test changes with
``--tree``.

To compare two trees, unpack the other one (``git archive``) into a
git-ignored directory and run this script with and without ``--tree`` in
turns in one call (parent, change, change, parent): each run is a process
of its own, so each imports one port.  Prints one JSON line a kernel and
shape and a last line {"ok": ..., "label": ..., "card": ...}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
C, LAYERS = 120, 8
SHAPES = (("pair", 40, 1152, 25), ("infer", 20, 1152, 25),
          ("VendGunPoint", 40, 150, 65), ("VendCoffee", 40, 60, 168))


def load_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module, by path (another tree given
    by ``--tree`` may have its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=REPO, help="the tree whose port is timed")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smoke = load_chip_smoke()
    tree = args.tree.resolve()
    label = args.label or tree.name
    sys.path.insert(0, str(tree))
    from feature_level_style_transfer_for_tsc_tpu_torch.models.common import weight_norm_weight
    from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import wn_init
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, wn_fused

    if not Path(wn_fused.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {wn_fused.__file__}, not the port in {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    lib = _build.build("wn_fused")
    for line in (lib.parent / (lib.name + ".ptxas.txt")).read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    names = {"wn_fwd": ("y", "aud", "skip"),
             "wn_bwd": ("gx", "gws", "gbs", "gwc", "gbc", "gwi", "gbi", "gwr", "gbr", "gwe", "gbe")}
    tol = {"wn_fwd": smoke.WN_FWD_REL_TOL, "wn_bwd": smoke.WN_BWD_REL_TOL}
    ok = True
    for what, b, t, h in SHAPES:
        # phase 6's inputs (chip_smoke.wn_phase)
        eff = smoke.random_wn(wn_init, wn_fused, weight_norm_weight, h, C, LAYERS, seed=b + h)
        gen = torch.Generator(device="cuda").manual_seed(b)
        x2 = torch.randn(b * t, h, device="cuda", generator=gen)
        g2 = torch.randn(b * t, 2 * h, device="cuda", generator=gen)
        _, aud, skip = wn_fused.wn_fwd_plain(x2, *eff, t)
        bwd_args = (x2, g2, aud, skip, eff[0], eff[2], eff[3], eff[4], eff[5], eff[6], eff[8], t)
        work = smoke.wn_work(b, t, h, C, LAYERS)
        for name, call, d in (
            ("wn_fwd", lambda: wn_fused.wn_fwd(x2, *eff, t), "fwd"),
            ("wn_bwd", lambda: wn_fused.wn_bwd(*bwd_args), "bwd"),
        ):
            got, again = call(), call()
            want = getattr(wn_fused, f"{name}_plain")(*((x2, *eff, t) if d == "fwd" else bwd_args))
            rel = {n: smoke.rel_err(g, w)[1] for n, g, w in zip(names[name], got, want)}
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            ms = smoke.cuda_ms(call, reps=args.reps)
            row = {"label": label, "shape": what, "rows": b * t, "n_half": h,
                   "max_rel": max(rel.values()), "rel": rel, "same_bits": same, "ms": ms,
                   "tflops": work[f"{d}_flops"] / ms / 1e9,
                   "by_kernel": smoke.kernel_breakdown(call)}
            ok &= row["max_rel"] <= tol[name] and same
            print(f"{name} " + json.dumps(row), flush=True)
    print(json.dumps({"ok": ok, "label": label, "card": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
