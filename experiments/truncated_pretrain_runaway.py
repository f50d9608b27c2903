"""Does the flow's NLL run away after a truncated NF pretrain in both packages?

Trains the reference main.py pair at its vendored lengths (VendSCP2 <-
VendEthanol from datasets/, budget_multiplier 1.0) through both CLIs on the
CPU, once per phase-length set of ``GRID`` (seed 0) and at ``SPREAD``'s
lengths under more seeds: the JAX package's ``cli.main``
on its XLA path (``FLSTTSC_USE_PALLAS=0``) and the PyTorch port's
``cli.main --device cpu``.  Each run is a subprocess; this script imports
neither package.  For every run it records the phase-4 NF losses, the
phase-5 flow NLLs (``t_nf``, ``s_nf``) and GradNorm weights, the largest
|value| logged in phases 4-5, and whether every logged value is finite.

The two packages draw their weights and batches from different generators,
so a run of one is not the other's twin: the question is whether the
runaway (phase-5 NLLs many orders above their phase-3 values, GradNorm
weights turning NaN) shows in the JAX package at the same lengths too.

Usage: python experiments/truncated_pretrain_runaway.py [--jobs 2]
Writes experiments/results_truncated_pretrain_runaway.json.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RESULTS = REPO / "experiments" / "results_truncated_pretrain_runaway.json"
# phase lengths (p1..p5) probed for the vendored drive of chip_smoke.py
GRID = [(1, 1, 1, 1, 1), (1, 1, 1, 2, 1), (1, 1, 2, 1, 1), (1, 1, 2, 2, 1), (2, 2, 2, 2, 1)]
# one length set again under other seeds: how far the runaway spreads from draw to draw
SPREAD = ((2, 2, 2, 2, 1), (1, 2, 3))
PACKAGES = {
    "jax": (["-m", "feature_level_style_transfer_for_tsc_tpu.cli.main"],
            {"JAX_PLATFORMS": "cpu", "FLSTTSC_USE_PALLAS": "0"}),
    "torch": (["-m", "feature_level_style_transfer_for_tsc_tpu_torch.cli.main", "--device", "cpu"],
              {"OMP_NUM_THREADS": "4"}),
}


def _finite(v) -> bool:
    vals = v if isinstance(v, list) else [v]
    return all(isinstance(x, (int, float)) and math.isfinite(x) for x in vals)


def _largest(v) -> float:
    vals = v if isinstance(v, list) else [v]
    return max(abs(x) if math.isfinite(x) else math.inf for x in vals)


def run(package: str, lengths, seed: int) -> dict:
    module, env = PACKAGES[package]
    epochs = dict(zip(("p1", "p2", "p3", "p4", "p5"), lengths))
    with tempfile.TemporaryDirectory() as out:
        args = [sys.executable, *module,
                "--target-root", str(REPO / "datasets" / "Multivariate_ts"), "--target", "VendSCP2",
                "--source-root", str(REPO / "datasets" / "Univariate_ts"), "--source", "VendEthanol",
                "--out", out, "--budget-multiplier", "1.0", "--phase-epochs", json.dumps(epochs),
                "--seed", str(seed)]
        t0 = time.perf_counter()
        proc = subprocess.run(args, cwd=REPO, env={**os.environ, **env},
                              capture_output=True, text=True)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"{package} {epochs} exited {proc.returncode}: {proc.stderr[-2000:]}")
        history = json.loads((Path(out) / "history.json").read_text())
    late = [h for h in history if h["phase"] in ("p4", "p5")]
    values = [v for h in late for k, v in h.items() if k not in ("phase", "epoch")]
    nf = {f"{h['phase']}.{h['epoch']}": {k: v for k, v in h.items()
                                         if "nf" in k or k.startswith("gradnorm_w")}
          for h in late}
    row = {"package": package, "phase_epochs": epochs, "seed": seed, "wall_s": wall, "nf": nf,
           "largest_abs_p4_p5": max(_largest(v) for v in values),
           "all_finite": all(_finite(v) for h in history for k, v in h.items()
                             if k not in ("phase", "epoch"))}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=2, help="runs at a time")
    args = ap.parse_args()
    cases = [(p, g, 0) for g in GRID for p in PACKAGES]
    cases += [(p, SPREAD[0], seed) for seed in SPREAD[1] for p in PACKAGES]
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(lambda c: run(*c), cases))
    RESULTS.write_text(json.dumps({"pair": "VendSCP2 <- VendEthanol", "device": "cpu",
                                   "runs": rows}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
