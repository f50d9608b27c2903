"""Shared arithmetic of the per-layer metrics' readers."""

from __future__ import annotations

from harness import work


def roofline(ctx, kernels, flops_key: str, bytes_key: str, launch_entries, launches_key: str):
    """A kernel's share of its roofline over the traced slice, in %: the least time the
    slice's calls need (the larger of their operations at the TF32 peak and their bytes at
    the HBM peak) over the device time of the op's kernels.  None where the slice ran the
    op another number of times than the frozen work model counts (the program changed
    what it launches), or ran none of its kernels."""
    sl = ctx.slice
    if sl is None or not sl.units:
        return None
    counted = sum(sl.launches.get(e, 0) for e in launch_entries)
    if counted != ctx.work[launches_key] * sl.units:
        return None
    secs, n = sl.device_s(kernels)
    if not n or secs <= 0:
        return None
    least, _ = work.bound_s(ctx.work[flops_key] * sl.units, ctx.work[bytes_key] * sl.units)
    return 100.0 * least / secs


def mfu(ctx):
    """The whole traced window's model operations over its time, against the TF32 peak."""
    out = ctx.out
    if not out.traced_window_s:
        return None
    return 100.0 * ctx.work["model_flops"] * out.traced_units / out.traced_window_s / work.PEAK_FLOPS


def idle_share(ctx):
    """The traced slice's wall time in which no operation ran on the device, in %."""
    sl = ctx.slice
    if sl is None or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.wall_s)


def launches_per_unit(ctx):
    sl = ctx.slice
    if sl is None or not sl.units:
        return None
    return len(sl.kernels()) / sl.units
