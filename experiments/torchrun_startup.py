"""Time how long ``torchrun`` takes to bring up a rank of the port's CLIs on this machine.

``chip_smoke.py`` phase 24 runs ``cli.predict`` and ``cli.multi_source``
under ``python -m torch.distributed.run``; most of a command's wall time
there is spent before the CLI's ``main`` starts.  This script splits that
time: ``python -c "import torch"`` alone, then, for each launch variant
(``--standalone``, its c10d rendezvous; ``static``, the
``--master-addr 127.0.0.1`` rendezvous), ``--reps`` commands of ``--ranks``
ranks, each rank recording (in seconds from the command's start) when its
interpreter started, when ``import torch`` returned, when the port's two
CLI modules were imported, when its CUDA context was up (where there is a
card; the ranks share card 0) and when it had joined the default group
(``"cpu:gloo,cuda:gloo"``, or ``gloo`` without a card).  It imports only
torch and the port of the tree it sits in.

Usage: python experiments/torchrun_startup.py [--ranks 3] [--reps 2]
Prints one line a command and, last, one JSON line with every record.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def worker(out_dir: str) -> None:
    """One rank: its clock times, written to ``<out_dir>/rank<RANK>.json``."""
    t = {"start": time.time()}
    import torch
    import torch.distributed as dist

    t["torch"] = time.time()
    sys.path.insert(0, str(REPO))
    from feature_level_style_transfer_for_tsc_tpu_torch.cli import multi_source, predict  # noqa: F401

    t["port"] = time.time()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")
    t["cuda"] = time.time()
    dist.init_process_group("cpu:gloo,cuda:gloo" if cuda else "gloo", init_method="env://")
    t["joined"] = time.time()
    dist.barrier()
    dist.destroy_process_group()
    Path(out_dir, f"rank{os.environ['RANK']}.json").write_text(json.dumps(t))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=3)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    t0 = time.time()
    subprocess.run([sys.executable, "-c", "import torch"], check=True)
    out = {"import_torch_s": time.time() - t0, "commands": []}
    print(f"python -c 'import torch': {out['import_torch_s']:.2f} s", flush=True)
    variants = {"standalone": lambda: ["--standalone"],
                "static": lambda: ["--master-addr", "127.0.0.1", "--master-port", str(free_port())]}
    for _ in range(args.reps):
        for name, flags in variants.items():
            with tempfile.TemporaryDirectory() as d:
                t0 = time.time()
                subprocess.run([sys.executable, "-m", "torch.distributed.run", *flags(),
                                "--nproc-per-node", str(args.ranks), __file__, "--worker", d],
                               check=True, capture_output=True, timeout=600)
                wall = time.time() - t0
                ranks = [{k: v - t0 for k, v in json.loads(p.read_text()).items()}
                         for p in sorted(Path(d).glob("rank*.json"))]
            out["commands"].append({"variant": name, "wall_s": wall, "ranks": ranks})
            print(f"{name}: wall {wall:.1f} s; ranks, s from the start: "
                  + "; ".join(" ".join(f"{k} {v:.1f}" for k, v in r.items()) for r in ranks),
                  flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
