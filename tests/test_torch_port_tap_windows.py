"""The logic around the port's tap-GEMM conv kernels that runs on the CPU.

* ``osconv.tap_windows_plain``, the plain mirror of the kernel's window
  search: summing only the taps inside each 8-column group's window gives
  exactly ``os_conv_plain`` (the skipped products are exact zeros) for the
  masked weights of every OS layer of the SCP2 serving model and of the
  EthanolLevel source extractor, for a weight with a stray nonzero outside
  the mask (the window widens to reach it) and for a group whose taps are
  all zero (an empty window, output 0); and the windows of a masked layer
  are the span of ``structure.mask_bounds`` over the group's branches.
* Why the kernels take three TF32 products a term: a numpy emulation of
  TF32 rounding (10 mantissa bits, round to nearest) at the serving
  reduction lengths.
* ``_build.source_digest`` covers the shared headers, so an edited
  ``csrc/*.cuh`` rebuilds every library.

No card and no nvcc needed; the kernels themselves are held against the
plain versions in tests/test_torch_port_kernels.py (``gpu``).
"""

import shutil

import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, osconv
from feature_level_style_transfer_for_tsc_tpu_torch.structure import mask_bounds, total_out_channels
from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import build_specs

GROUP = 8


def _layers():
    """(name, spec) of every OS layer: the SCP2 serving model (extractor and
    classifier) and the EthanolLevel source extractor."""
    ext, cls = build_specs(7, 1152, PipelineConfig())
    eth = build_specs(1, 1751, PipelineConfig())[0]
    return ([(f"scp2.ext{i}", s) for i, s in enumerate(ext)]
            + [(f"scp2.cls{i}", s) for i, s in enumerate(cls)]
            + [(f"ethanol.ext{i}", s) for i, s in enumerate(eth)])


LAYERS = _layers()


def _masked_weight(spec, seed):
    params = osconv.init_os_conv_params(torch.Generator().manual_seed(seed), spec)
    return params["weight"] * torch.from_numpy(osconv.build_os_mask(spec))


def _windowed(x_pad, w, windows):
    """``os_conv_plain`` summing, per column, only the taps inside its
    group's window, in the same order."""
    k, _, c_out = w.shape
    t = x_pad.shape[1] - k + 1
    taps = torch.arange(k).unsqueeze(1)
    lo = windows[:, 0].repeat_interleave(GROUP)[:c_out]
    hi = windows[:, 1].repeat_interleave(GROUP)[:c_out]
    inside = (taps >= lo) & (taps < hi)  # (K, C_out)
    y = torch.zeros(x_pad.shape[0], t, c_out)
    for j in range(k):
        y = torch.where(inside[j], y + x_pad[:, j : j + t] @ w[j], y)
    return y


def _x_pad(k, c_in, seed, b=2, t=40):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, t + k - 1, c_in)).astype(np.float32))


@pytest.mark.parametrize("name, spec", LAYERS, ids=[n for n, _ in LAYERS])
def test_windowed_sum_equals_plain_on_masked_weights(name, spec):
    w = _masked_weight(spec, seed=len(name))
    windows = osconv.tap_windows_plain(w)
    x_pad = _x_pad(w.shape[0], w.shape[1], seed=3)
    assert windows.shape == (-(-w.shape[2] // GROUP), 2) and windows.dtype == torch.int32
    assert torch.equal(_windowed(x_pad, w, windows), osconv.os_conv_plain(x_pad, w))


@pytest.mark.parametrize("name, spec", LAYERS, ids=[n for n, _ in LAYERS])
def test_windows_of_a_masked_layer_span_its_branches(name, spec):
    """Group g's window is [min lo, max hi) of mask_bounds over the branches
    whose columns meet the group's 8 columns."""
    largest = spec[-1][-1]
    branch_of_col = [k for (_, out, k) in spec for _ in range(out)]
    want = []
    for g in range(-(-total_out_channels(spec) // GROUP)):
        bounds = [mask_bounds(k, largest) for k in set(branch_of_col[g * GROUP : (g + 1) * GROUP])]
        want.append([min(b[0] for b in bounds), max(b[1] for b in bounds)])
    got = osconv.tap_windows_plain(_masked_weight(spec, seed=1))
    assert got.tolist() == want


def test_a_stray_tap_widens_the_window():
    """A nonzero weight outside the mask (the last tap of column 0, the
    kernel-1 branch) widens group 0's window to reach it, and the windowed
    sum still equals the plain conv."""
    spec = build_specs(7, 1152, PipelineConfig())[0][1]  # 25 -> 225, K = 89
    w = _masked_weight(spec, seed=2)
    k = w.shape[0]
    before = osconv.tap_windows_plain(w)
    w[k - 1, 3, 0] = 0.5
    after = osconv.tap_windows_plain(w)
    assert before[0, 1] < k and after[0].tolist() == [before[0, 0], k]
    assert torch.equal(after[1:], before[1:])
    x_pad = _x_pad(k, w.shape[1], seed=4)
    assert torch.equal(_windowed(x_pad, w, after), osconv.os_conv_plain(x_pad, w))


def test_an_all_zero_group_has_an_empty_window():
    spec = build_specs(7, 1152, PipelineConfig())[0][1]
    w = _masked_weight(spec, seed=5)
    w[:, :, GROUP : 2 * GROUP] = 0.0
    windows = osconv.tap_windows_plain(w)
    assert windows[1].tolist() == [0, 0]
    x_pad = _x_pad(w.shape[0], w.shape[1], seed=6)
    y = _windowed(x_pad, w, windows)
    assert torch.equal(y, osconv.os_conv_plain(x_pad, w))
    assert not y[:, :, GROUP : 2 * GROUP].any()


def test_windows_of_a_ragged_last_group_and_of_a_dense_weight():
    """C_out off the group width: the last group counts only real columns;
    a dense weight gives every group all K taps."""
    w = torch.zeros(5, 3, 11)
    w[1:3, 0, 0] = 1.0
    w[4, 2, 10] = -2.0
    assert osconv.tap_windows_plain(w).tolist() == [[1, 3], [4, 5]]
    dense = torch.randn(3, 4, 20, generator=torch.Generator().manual_seed(0))
    assert osconv.tap_windows_plain(dense).tolist() == [[0, 3]] * 3


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as cvt.rna.tf32.f32 does."""
    u = a.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("n", [89 * 25, 3 * 240, 7 * 8])
def test_three_tf32_products_are_needed_for_the_gate(n):
    """At the serving reduction lengths (89 taps x 25 channels, 3 taps x 240,
    a short one) one TF32 product a term misses the kernels' 1e-4 gate
    (max error over max |y|), and lo*hi + hi*lo + hi*hi stays within 1e-6
    of float64, as float32 does."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((64, n)).astype(np.float32)
    w = (rng.standard_normal((n, 64)) / np.sqrt(n)).astype(np.float32)
    want = x.astype(np.float64) @ w.astype(np.float64)

    def rel(y):
        return np.abs(y - want).max() / np.abs(want).max()

    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    one = xh @ wh
    three = xl @ wh + xh @ wl + xh @ wh
    assert rel(one) > 1e-4
    assert rel(three) < 1e-6
    assert rel(x @ w) < 1e-6
    np.testing.assert_array_equal(_tf32(xh), xh)  # hi is already TF32
    assert np.abs(xl).max() <= np.abs(x).max() * 2.0 ** -11


def test_source_digest_follows_the_shared_headers(tmp_path):
    """Editing any ``csrc/*.cuh`` changes the digest of every source, so a
    stale library is never loaded; editing one ``.cu`` changes only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    assert {"os_conv", "tap_conv"} <= set(names) and list(csrc.glob("*.cuh"))
    before = {n: _build.source_digest(n, csrc) for n in names}
    assert before == {n: _build.source_digest(n) for n in names}
    header = csrc / "tap_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.source_digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "gate.cu").write_text((csrc / "gate.cu").read_text() + "\n")
    again = {n: _build.source_digest(n, csrc) for n in names}
    assert again["gate"] != after["gate"]
    assert all(again[n] == after[n] for n in names if n != "gate")
