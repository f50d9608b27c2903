"""Tracing hooks (the reference has none).

Counterpart of the JAX package's ``utils/profiling.py``: ``profile_trace``
wraps a code region in ``torch.profiler`` (CPU and, where there is one, the
CUDA device), writing a TensorBoard trace into ``log_dir``; ``phase_scope``
names a region of that trace (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a trace for TensorBoard into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


def phase_scope(name: str):
    """Named region of a curriculum phase (shows up in traces)."""
    return torch.profiler.record_function(name)
