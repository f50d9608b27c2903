"""The OS conv kernels' share of their roofline in a served request (ops/csrc/os_conv.cu with tap_gemm.cuh through ops/osconv.py, one-run os_conv_fwd and run-axis os_conv_fwd_runs): operations over the mask's live taps and bytes from harness/work.py os_conv."""

from __future__ import annotations

import importlib

_c = importlib.import_module("metrics._common")

#: the tap GEMM's weight prep and main kernel, by base name
KERNELS = ("prep_kernel", "tap_gemm_kernel")
ENTRIES = ("os_conv_fwd", "os_conv_fwd_runs", "os_conv_fused_fwd", "os_conv_fused_fwd_runs")


def read(ctx):
    return _c.roofline(ctx, KERNELS, "osconv_flops", "osconv_bytes", ENTRIES, "osconv_calls")
