"""The frozen shape arithmetic against counts made by hand at small shapes."""

from __future__ import annotations

import numpy as np
import pytest

from harness import work
from reference import model


def test_os_conv_counts_the_masks_live_taps():
    layer = [(2, 3, 1), (2, 3, 2), (2, 1, 5)]  # C_in 2; kernels 1, 2, 5; widths 3, 3, 1
    mask = model.os_mask(layer)  # (5, 1, 7)
    live = int(mask.sum()) * 2  # live (tap, column) pairs times C_in
    assert live == 2 * (3 * 1 + 3 * 2 + 1 * 5)
    w = work.os_conv(layer, batch=3, length=10)
    assert w["flops"] == 2 * 3 * 10 * live
    assert w["bytes"] == 4 * (3 * 10 * 2 + 3 * 10 * 7 + live + 7)


def _wn_hand(b, t, h, c, n_layers):
    """The fused WN's forward products by enumeration of every row and tap."""
    macs = 0
    for _ in range(b):
        for pos in range(t):
            macs += h * c + h * 2 * c * n_layers  # start, cond
            for i in range(n_layers):
                d = 2 ** i
                taps = sum(0 <= pos + off < t for off in (-d, 0, d))
                macs += taps * c * 2 * c
                macs += c * (2 * c if i < n_layers - 1 else c)
            macs += c * 2 * h  # end
    return 2 * macs, 2 * b * t * c * 2 * h


@pytest.mark.parametrize("shape", [(1, 7, 2, 3, 1), (2, 9, 3, 4, 3), (3, 4, 1, 2, 4)])
def test_wn_counts_each_product_once(shape):
    fwd, end = _wn_hand(*shape)
    assert work.wn_fwd(*shape)["flops"] == fwd
    assert work.wn_bwd(*shape)["flops"] == 2 * fwd - end


def test_bound_takes_the_larger_and_names_it():
    assert work.bound_s(work.PEAK_FLOPS, 0.0) == (1.0, "compute")
    assert work.bound_s(0.0, 2 * work.PEAK_BYTES) == (2.0, "memory")


def test_step_table_counts_every_module_and_its_pulls():
    sh = model.shapes((2, 64, 2), (1, 48, 3), 0.1)
    flow = {"n_flows": 2, "wn_channels": 8, "wn_layers": 2}
    table = work.step_table(sh, 4, flow, 32, 8)
    assert set(table) == {"t_ext", "t_cls", "s_ext", "dim_uni", "s_cls", "prob_trans", "nf",
                          "noise", "ad", "fd", "cpc"}
    for m, row in table.items():
        assert row["fwd"] > 0 and row["bwd"] > 0, m
    # the extractors' OS blocks are pulled by all four pulls: more than twice their forward
    assert table["t_ext"]["bwd"] > 2 * table["t_ext"]["fwd"]
    # the critics are only on the total's path: no more than twice their forward
    assert table["fd"]["bwd"] == pytest.approx(2 * table["fd"]["fwd"])


@pytest.mark.parametrize("max_kernel", [89, 7])
def test_classifier_forward_is_its_convs_shortcut_and_head(max_kernel):
    ext, cls = model.layer_specs(1, 64, max_kernel, 0.1)
    w = work.classifier_fwd(1, 64, 3, 5, 0.1, max_kernel)
    convs = sum(work.os_conv(l, 5, 64)["flops"] for l in ext + cls)
    feat = model.width(ext[-1])
    assert w["conv_flops"] == convs
    assert w["flops"] == pytest.approx(convs + 2 * 5 * 64 * 1 * feat + 2 * 5 * feat * 3)
    assert np.isfinite(w["conv_bytes"])
