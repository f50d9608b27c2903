"""Shared fixtures of the benchmark's CPU tests: the harness on the path, a tiny cell.

The tiny configuration keeps every part of each configuration (three OS layers a model, a
two-flow WaveGlow, CDAN, CPC, GradNorm) at shapes a CPU runs in seconds; the tests drive the
harness's loops with it on the CPU, where the program runs its plain PyTorch versions.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"target": {"channels": 2, "length": 64, "classes": 2, "train": 40, "test": 24},
        "source": {"channels": 1, "length": 48, "classes": 3, "train": 44, "test": 20},
        "batch_size": 4, "max_kernel_size": 89, "cdan_dim": 32, "cpc_hidden": 8,
        "budget_scale": 0.1,
        "flow": {"n_flows": 2, "wn_channels": 8, "wn_layers": 2},
        "sources": [{"channels": 1, "length": 48, "classes": 3}] * 3,
        "vote": {"rule": "entropy_precision", "entropy_scale": 120.0, "weight_base": 9.0}}
#: the benchmark's cells with the tiny configuration's shapes, and their traffic overrides
SHRINK = {"runs": 2, "check_runs": 2, "pool": 2, "warmup": 1, "trace_requests": 0}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    import torch

    torch.set_num_threads(2)


def tiny_run(workload: str, seed: int = 2**31 + 11, seconds: float = 0.5):
    """A ``cell.Run`` of ``workload`` (a cell of BENCHMARK.json) at the tiny size, on the CPU."""
    import torch

    from harness import cell

    bench = cell.load_benchmark(ROOT)
    entry, _, traffic = cell.find_cell(bench, ROOT, workload)
    traffic = dict(traffic, **{k: v for k, v in SHRINK.items() if k in traffic})
    return cell.Run(workload, entry, json.loads(json.dumps(TINY)), traffic, seed, seconds, False,
                    torch.device("cpu"), ROOT), bench


@pytest.fixture
def cuda():
    """Skips a test where there is no CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
