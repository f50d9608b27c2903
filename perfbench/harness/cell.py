"""One run of one cell: find its files, drive it, check it, print its result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``, found by the
``file`` its entry gives) and a traffic mix (``traffic/<traffic>.json``).  The mix names
the loop (``loops/<loop>.py``) that runs it and holds its parameters and the limits of
its checks.  A per-layer metric is ``metrics/<name>.py``.  Adding a cell, a mix or a metric
adds files and entries; nothing here names one.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "feature_level_style_transfer_for_tsc_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a bad cell, an incomplete trace)."""


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclass
class Outcome:
    """What a loop hands back."""

    metrics: Dict[str, float]  # end-to-end, by name
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    window_start: float  # time.time() when the measured window opened
    slice: object = None  # trace.Slice with --trace 1
    traced_window_s: float = 0.0
    traced_units: int = 0
    work: Dict[str, float] = field(default_factory=dict)  # per unit, harness/work.py


@dataclass
class Run:
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    root: Path

    def limit(self, name: str) -> float:
        return float(self.traffic["limits"][name])


def process_start() -> float:
    """Wall-clock time at which this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def load_benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"{path} is missing")
    return json.loads(path.read_text())


def find_cell(bench: dict, root: Path, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((home(bench, root) / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def home(bench: dict, root: Path) -> Path:
    """The benchmark's folder in the checkout at ``root``: the first of its ``paths``."""
    return root / bench["paths"][0]


def loop(traffic: dict):
    """The traffic mix's loop module, ``loops/<loop>.py``."""
    return importlib.import_module(f"loops.{traffic['loop']}")


def load_metric(name: str, folder: Path = HERE):
    path = folder / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's metrics: end-to-end without a trace, per-layer with one."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18] if len(values) > 1 else values[0]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def device_info(run: Run, out: Outcome) -> dict:
    import torch

    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": out.memory_peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device), "count": 1,
            "memory_peak_bytes": out.memory_peak_bytes}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    import subprocess

    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 and got.stdout.strip() else None


class MetricContext:
    """What a per-layer metric's reader may read."""

    def __init__(self, run: Run, out: Outcome):
        self.run, self.out = run, out
        self.slice = out.slice
        self.work = out.work
        self.config, self.traffic = run.config, run.traffic


def execute(run: Run, bench: dict, started: float) -> dict:
    """Drive the cell and build its result line (a dict)."""
    out: Outcome = loop(run.traffic).run(run)
    metrics = {}
    if run.trace:
        ctx = MetricContext(run, out)
        for m in metrics_of(bench, run.name, True):
            value = load_metric(m["name"], home(bench, run.root)).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out.metrics, setup_s=out.window_start - started)
        for m in metrics_of(bench, run.name, False):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = device_info(run, out)
    result = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if run.trace and out.slice is not None:
        device["busy_s"] = out.slice.busy_s()
        device["window_s"] = out.slice.wall_s
        device["card"] = power_limit()  # the rooflines' peaks assume 700 W
        result["breakdown"] = {"device_ops": out.slice.top_ops(),
                               "idle_gaps": out.slice.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return result


def report(result: dict, checks_to_stderr: bool = True) -> None:
    if checks_to_stderr:
        for name, c in result["checks"].items():
            print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
