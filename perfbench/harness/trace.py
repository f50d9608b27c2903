"""The traced slice: device events from ``torch.profiler``, host spans, and what they give.

``device_events`` reads the profile's raw events (``key_averages()`` builds every host op's
event tree first, about 42 s a traced K-run step on the card's host, for the same sums):
CUDA events with device time, without the device-side copies of host annotations, which
span kernels counted on their own.  Busy time is the union of the events' intervals, so
overlapping kernels count once.  Host spans are the harness's own ``record_function``
ranges around its calls into the program (``SPANS``); each idle stretch of the device is
named after the innermost span the host was in at its middle.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

#: the harness's host spans, outermost first
SPANS = ("step", "request", "batch_to_device", "vote")


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without ``void``, namespaces, template and call
    arguments."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(", 1)[0].split("<", 1)[0].split("::")[-1].strip()


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


@dataclass
class Slice:
    """A traced slice: device events (name, start ns, end ns), host spans (name, start ns,
    end ns), its wall seconds by the host clock, and the units (steps or requests) in it."""

    events: List[Tuple[str, int, int]]
    spans: List[Tuple[str, int, int]]
    wall_s: float
    units: int
    launches: Dict[str, int] = field(default_factory=dict)

    def kernels(self):
        return [e for e in self.events if is_kernel(e[0])]

    def busy_s(self) -> float:
        return _union(self.events) / 1e9

    def device_s(self, names) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose base name is one of ``names``."""
        total, n = 0, 0
        for name, a, b in self.kernels():
            if kernel_name(name) in names:
                total += b - a
                n += 1
        return total / 1e9, n

    def top_ops(self, n: int = 10):
        by = {}
        for name, a, b in self.events:
            key = kernel_name(name) if is_kernel(name) else name
            by[key] = by.get(key, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """Idle device time inside the slice by the host span it fell in, largest first."""
        if not self.spans:
            return []
        lo = min(s[1] for s in self.spans)
        hi = max(s[2] for s in self.spans)
        merged = _merge([(a, b) for _, a, b in self.events if b > lo and a < hi])
        gaps, at = [], lo
        for a, b in merged:
            if a > at:
                gaps.append((at, min(a, hi)))
            at = max(at, b)
        if at < hi:
            gaps.append((at, hi))
        by = {}
        for a, b in gaps:
            mid = (a + b) // 2
            inside = [s for s in self.spans if s[1] <= mid < s[2]]
            label = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "between_spans"
            by[label] = by.get(label, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union(events) -> int:
    return sum(b - a for a, b in _merge([(a, b) for _, a, b in events]))


def device_events(prof) -> Tuple[list, list]:
    """(device events, host spans) of a profile, as (name, start ns, end ns)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_async() or getattr(e, "is_hidden_event", lambda: False)():
            continue
        start = e.start_ns()
        span = (e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.start_thread_id() != e.end_thread_id():
                continue
            if e.duration_ns() > 0:
                dev.append(span)
        elif e.name() in SPANS:
            host.append(span)
    return dev, host


class Tracer:
    """``span(name)``: a ``record_function`` range while tracing, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def trace_slice(fn: Callable[[], int], launches: Callable[[], dict]) -> Slice:
    """Run ``fn`` (which returns how many units it ran) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = launches()
    dev, host = device_events(prof)
    return Slice(dev, host, wall, units, {k: after[k] - before[k] for k in after
                                          if after[k] != before[k]})


# --------------------------------------------------------------- launch completeness ---

def kernels_per_launch(entry: str, wn_layers: int) -> Dict[str, int]:
    """The ``__global__`` kernels one counted launch of a program entry runs, by base name
    (f32 instances; the program's ``csrc``): the tap GEMM's weight prep and main kernel for
    each conv entry, the fused WN's row GEMMs, weight splits, layer kernels and weight
    gradient reductions, the gate's one kernel."""
    base = entry.removesuffix("_runs")
    grads = 2 * wn_layers + 1
    table = {
        "os_conv_fwd": {"prep_kernel": 1, "tap_gemm_kernel": 1},
        "os_conv_fused_fwd": {"prep_kernel": 1, "tap_gemm_kernel": 1},
        "tap_conv_fwd": {"prep_kernel": 1, "tap_gemm_kernel": 1},
        "gate_fwd": {"gate_kernel": 1},
        "wn_fwd": {"wsplit_fwd_kernel": 1, "rowgemm_kernel": 1, "wn_layer_fwd_kernel": wn_layers},
        "wn_bwd": {"wsplit_kernel": 1, "rowgemm_kernel": 2, "wn_layer_gz_kernel": wn_layers,
                   "wn_layer_ga_kernel": wn_layers, "wgrad_kernel": grads,
                   "reduce_partials_kernel": grads},
    }
    if base not in table:
        raise KeyError(f"no kernel table for the program's entry {entry}")
    return table[base]


def completeness(sl: Slice, wn_layers: int) -> Tuple[bool, dict]:
    """Whether the slice's profile kept every launch of the program's kernels that its
    counters counted: (complete, {kernel: [kept, counted]})."""
    want: Dict[str, int] = {}
    for entry, n in sl.launches.items():
        for k, per in kernels_per_launch(entry, wn_layers).items():
            want[k] = want.get(k, 0) + n * per
    kept = {k: 0 for k in want}
    for name, _, _ in sl.kernels():
        base = kernel_name(name)
        if base in kept:
            kept[base] += 1
    return kept == want, {k: [kept[k], want[k]] for k in want}
