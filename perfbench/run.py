"""Run one cell of the port's benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the checkout's root.  The run makes its
inputs and weights from ``--seed``, warms up, measures for ``--seconds``, checks what the
measured window produced against the plain reference in ``perfbench/reference/``, and prints
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last the ``checks``, each number compared beside its limit, which also
end standard error.  It exits non-zero with no result line where there is no CUDA card, and
where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through ``transformers``; one
    host thread for PyTorch's and the BLAS libraries' CPU pools (the measured work is on
    the card, and idle pool threads only add jitter to a host-paced loop)."""
    build = ROOT / "build"
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for key in [k for k in os.environ if k.startswith("FLSTTSC_")]:
        del os.environ[key]  # the program at its defaults


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from harness import cell

    started = cell.process_start()
    import torch

    try:
        bench = cell.load_benchmark(ROOT)
        entry, config, traffic = cell.find_cell(bench, ROOT, args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            raise cell.Refused(f"the cell needs {entry['chips']} CUDA card(s); "
                               f"torch sees {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        run = cell.Run(args.workload, entry, config, traffic, args.seed, args.seconds,
                       bool(args.trace), torch.device("cuda", 0), ROOT)
        result = cell.execute(run, bench, started)
    except cell.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    found = cell.forbidden_modules()
    if found:
        print(f"refused: the process loaded {found}", file=sys.stderr)
        return 3
    cell.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
