#!/usr/bin/env python3
"""Check and time the port's gate kernel ``gate_fwd`` at the shapes of
``chip_smoke.py`` phase 12, back to back and with its operands cold in L2.

Run from the repository root on a CUDA card:

    python3 experiments/gate_time.py [--tree DIR] [--label NAME]

Builds ``gate`` (``ops/csrc``) of the port in ``DIR`` (default: this tree),
prints ptxas's register and spill lines, then at the pair (46,080 rows) and
infer (23,040 rows) shapes of phase 5 (n = 120, ``a`` a (rows, 240) tensor,
``b`` layer 3's column slice of a (rows, 1920) cond projection, as phase 12
builds them, ``chip_smoke.gate_operands``) holds ``gate_fwd`` against
``gate_plain`` (max|diff| over max|plain|), checks that two calls give the
same bits, and reads:

* ``ms``: CUDA events around back-to-back calls on one set of inputs, as
  ``chip_smoke.py`` has always timed the kernel (``cuda_ms``); at the infer
  shape the operands (55 MB) nearly fit in the 50 MB L2, so this reading can
  beat the bytes bound through L2 reuse;
* ``rot_ms``: the same over a rotation of input sets (each with its own
  output) that together exceed twice the L2, so each call reads from HBM;
* ``dev_ms`` / ``rot_dev_ms``: the kernel's device time a call under
  ``torch.profiler``, back to back and rotated (no host time inside);
* ``host_us``: the wrapper's host time a call, launches queued back to back.

Percentages of the bytes bound are taken against ``rot_ms``.  To compare two
trees, unpack the other one (``git archive``) into a git-ignored directory
and run this script with and without ``--tree`` in turns in one call (parent,
change, change, parent). Prints one JSON line a shape and a last line
{"ok": ..., "label": ..., "card": ...}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
C, LAYERS = 120, 8


def load_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module, by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_us(fn, args, calls: int = 200) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=REPO, help="the tree whose port is timed")
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smoke = load_chip_smoke()
    tree = args.tree.resolve()
    label = args.label or tree.name
    sys.path.insert(0, str(tree))
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, gate

    if not Path(gate.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {gate.__file__}, not the port in {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    lib = _build.build("gate")
    for line in (lib.parent / (lib.name + ".ptxas.txt")).read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    def call(a, b):
        return gate.gate_fwd(a, b, C)

    def device_ms(sets):
        calls = smoke.kernel_breakdown(lambda: [call(*x) for x in sets])
        return sum(k["ms"] for k in calls.values()) / len(sets)

    ok = True
    total = {"ms": 0.0, "rot_ms": 0.0, "dev_ms": 0.0, "rot_dev_ms": 0.0, "bytes_ms": 0.0}
    for what, rows in (("pair", 2 * smoke.BATCH * smoke.SCP2["length"]),
                       ("infer", smoke.BATCH * smoke.SCP2["length"])):
        gen = torch.Generator(device="cuda").manual_seed(3)
        sets, n_bytes = smoke.gate_sets(rows, C, LAYERS, gen)
        a, b = sets[0]
        got, again = call(a, b), call(a, b)
        _, rel = smoke.rel_err(got, gate.gate_plain(a, b, C))
        same = torch.equal(got, again)
        row = {"label": label, "shape": what, "rows": rows, "n": C, "rel": rel, "same_bits": same,
               "sets": len(sets), "rotated_mb": len(sets) * n_bytes / 1e6,
               "ms": smoke.cuda_ms(lambda: call(a, b), reps=20),
               "rot_ms": smoke.rotated_ms(call, sets),
               "dev_ms": device_ms(sets[:1]), "rot_dev_ms": device_ms(sets),
               "host_us": host_us(call, (a, b)),
               "bytes_ms": n_bytes / smoke.HBM_RATE * 1e3}
        row["rot_bound_share"] = row["bytes_ms"] / row["rot_ms"]
        for k in total:
            total[k] += row[k]
        ok &= rel <= smoke.REL_TOL and same
        print("gate " + json.dumps(row), flush=True)
    total["rot_bound_share"] = total["bytes_ms"] / total["rot_ms"]
    print("gate pair+infer " + json.dumps({"label": label, **total}), flush=True)
    print(json.dumps({"ok": ok, "label": label, "card": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
