"""Readings for the limits of a cell's checks: the program's, and the control's.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --mode control
    python3 perfbench/control.py --workload <name> --seeds 1,...,12 --mode program --seconds 5

``--mode fault --fault <name>`` runs the cell as ``program`` does with a fault of
``harness/faults.py`` planted in the program.  ``--mode witness`` (a loop with a
``witness``) holds two correct computations against each other by the cell's comparison:
what rounding alone moves each number by.  ``--mode control`` puts the reference, computed in TF32 (the precision below the
configuration's float32 with TF32 off), in the program's place on each seed, and prints the
numbers the cell compares: a limit has to sit below them.  ``--mode program`` runs the cell
on each seed in this one process, for ``--seconds`` a window, and prints the same numbers
with the run's end-to-end metrics: a limit has to sit above them.  One JSON line a seed.
The benchmark's own runs run neither.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("control", "program", "fault", "witness"), required=True)
    p.add_argument("--fault", help="with --mode fault: one of harness/faults.py FAULTS")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import run as entry

    entry._environment()
    import torch

    from harness import cell

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cell.load_benchmark(ROOT)
    entry_, config, traffic = cell.find_cell(bench, ROOT, args.workload)
    mod = cell.loop(traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cell.Run(args.workload, entry_, config, traffic, seed, args.seconds, False,
                       torch.device("cuda", 0), ROOT)
        t0 = time.perf_counter()
        if args.mode in ("control", "witness"):
            line = {"seed": seed, "mode": args.mode,
                    "numbers": getattr(mod, args.mode)(run)}
        else:
            from harness import faults

            with (faults.planted(traffic["loop"], args.fault) if args.mode == "fault"
                  else contextlib.nullcontext()):
                out = mod.run(run)
            line = {"seed": seed, "mode": args.mode, "fault": args.fault,
                    "numbers": {c.name: c.value for c in out.checks},
                    "metrics": out.metrics, "attempted": out.attempted,
                    "memory_peak_bytes": out.memory_peak_bytes}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        cell.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
