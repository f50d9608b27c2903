"""The fused WaveNet coupling kernels' share of their roofline in the K-run step (ops/csrc/wn_fused.cu through ops/wn_fused.py): wn_fwd_runs and wn_bwd_runs, their operations and bytes from harness/work.py wn_fwd and wn_bwd at each call's shape (a flow's pair and infer calls)."""

from __future__ import annotations

import importlib

_c = importlib.import_module("metrics._common")

#: the kernels of wn_fwd_runs and wn_bwd_runs (f32 instances), by base name
KERNELS = ("wsplit_fwd_kernel", "wsplit_kernel", "rowgemm_kernel", "wn_layer_fwd_kernel",
           "wn_layer_gz_kernel", "wn_layer_ga_kernel", "wgrad_kernel", "reduce_partials_kernel")
ENTRIES = ("wn_fwd_runs", "wn_bwd_runs")


def read(ctx):
    return _c.roofline(ctx, KERNELS, "wn_flops", "wn_bytes", ENTRIES, "wn_calls")
