"""What the serving loops share: the request pool, the closed loop, the recorded outputs.

One client sends requests back to back; each takes the next split of a pool made from the
seed (round robin), and its latency runs from the call to the predictions on the host.
The program's outputs are recorded where it produces them, by wrapping one of its bound
methods on the served object, and judged against the reference once the window has closed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from harness import cell, trace


class Recorder:
    """Wraps ``obj.<name>`` so that every result it returns is kept (on the device)."""

    def __init__(self, obj, name: str):
        self.calls: List[torch.Tensor] = []
        inner = getattr(obj, name)

        def recording(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.calls.append(out.detach())
            return out

        setattr(obj, name, recording)

    def take(self) -> List[torch.Tensor]:
        out, self.calls = self.calls, []
        return out


@dataclass
class Loop:
    """A closed loop's requests: every result (the traced ones last), the window's
    latencies, its seconds and start, and with a trace the slice and the traced window's
    seconds (the window and the slice)."""

    results: list
    latencies: List[float]
    window_s: float
    window_start: float
    slice: object
    traced_s: float


def closed_loop(request: Callable[[int], object], seconds: float, device, tracer: trace.Tracer,
                trace_requests: int = 0) -> Loop:
    """Requests back to back for ``seconds``; then, with ``trace_requests``, that many more
    under the profiler."""
    results, lat = [], []

    def one(i: int):
        t = time.perf_counter()
        with tracer.span("request"):
            results.append(request(i))
        lat.append(time.perf_counter() - t)

    window_start = time.time()
    t0 = time.perf_counter()
    i = 0
    while True:
        one(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    window_lat = list(lat)
    sl, traced_s = None, window_s
    if trace_requests:
        def traced():
            for j in range(trace_requests):
                one(i + j)
            return trace_requests

        from harness import port

        for attempt in range(2):
            sl = trace.trace_slice(traced, port.launches)
            complete, kept = trace.completeness(sl, 0)
            if complete:
                break
            if attempt:
                raise cell.Refused(f"the profile lost launches twice: {kept}")
        traced_s = window_s + sl.wall_s
    return Loop(results, window_lat, window_s, window_start, sl, traced_s)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest elementwise gap, against the reference's largest magnitude (infinite
    where the shapes differ)."""
    if got.shape != want.shape:
        return float("inf")
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


def served_gap(preds: np.ndarray, scores: torch.Tensor) -> float:
    """The widest gap by which a served answer's reference score lies below the reference's
    best for its series, against the scores' largest magnitude (0 where every answer is the
    reference's argmax; infinite where answers are missing)."""
    s = scores.double().cpu()
    preds = np.asarray(preds)
    if preds.shape != (s.shape[0],):
        return float("inf")
    best = s.max(dim=-1).values
    got = s.gather(-1, torch.as_tensor(preds, dtype=torch.long)[:, None])[:, 0]
    return float((best - got).max() / s.abs().max().clamp_min(1e-30))
