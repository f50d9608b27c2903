"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without a CUDA card.  The file imports neither jax nor the JAX
package, so that it runs on a GPU machine without jax:

    pytest --noconftest tests/test_torch_port_kernels.py -m gpu

Shapes cover the ragged edges of the kernels' tiles: time not a multiple of
the time tile, C_out not a multiple of 4 or of the C_out tile, C_in not a
multiple of the staged chunk, and every tap-group size (K of 1, 2, 3, 5, 89).
Tolerance: max|kernel - plain| <= 1e-4 * max|plain|, both exact float32
with TF32 off, the sums taken in another order.
"""

import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv

REL_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the os_conv kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * max(want.abs().max().item(), 1e-30), err


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, t, k, c_in, c_out",
    [
        (3, 150, 89, 25, 225),
        (2, 1152, 89, 7, 25),
        (2, 33, 2, 225, 50),
        (1, 5, 1, 5, 7),
        (2, 61, 3, 17, 33),
        (4, 100, 5, 3, 130),
    ],
)
@pytest.mark.parametrize("relu", [False, True])
def test_kernels_match_plain(card, b, t, k, c_in, c_out, relu):
    g = torch.Generator(device=card).manual_seed(k * 1000 + c_out)
    x_pad = torch.randn(b, t + k - 1, c_in, device=card, generator=g)
    w = torch.randn(k, c_in, c_out, device=card, generator=g) / (c_in * k) ** 0.5
    scale = torch.rand(c_out, device=card, generator=g) + 0.5
    shift = torch.randn(c_out, device=card, generator=g)
    before = dict(osconv.LAUNCHES)
    got = osconv.os_conv(x_pad, w)
    fused = osconv.os_conv_fused(x_pad, w, scale, shift, relu)
    torch.cuda.synchronize()
    assert got.shape == fused.shape == (b, t, c_out)
    assert osconv.LAUNCHES["os_conv_fwd"] == before["os_conv_fwd"] + 1
    assert osconv.LAUNCHES["os_conv_fused_fwd"] == before["os_conv_fused_fwd"] + 1
    _close(got, osconv.os_conv_plain(x_pad, w))
    _close(fused, osconv.os_conv_fused_plain(x_pad, w, scale, shift, relu))


@pytest.mark.gpu
def test_masked_os_conv_on_card_matches_cpu(card, monkeypatch):
    """The whole op (mask, padding, bias, folded BN) on the card against the
    same op on the CPU, through both kernels."""
    spec = [(6, 4, kk) for kk in (1, 2, 3, 5, 7, 11)]
    params = osconv.init_os_conv_params(torch.Generator().manual_seed(0), spec)
    mask = torch.from_numpy(osconv.build_os_mask(spec))
    x = torch.randn(3, 70, 6, generator=torch.Generator().manual_seed(1))
    scale, shift = torch.rand(24) + 0.5, torch.randn(24)
    for fuse in ("0", "1"):
        monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", fuse)
        args = (x, params["weight"], params["bias"], mask)
        want = osconv.masked_os_conv(*args, scale=scale, shift=shift, relu=True)
        got = osconv.masked_os_conv(
            *(a.to(card) for a in args), scale=scale.to(card), shift=shift.to(card), relu=True
        )
        _close(got.cpu(), want)


@pytest.mark.gpu
def test_wrapper_refuses_non_contiguous_input(card):
    x_pad = torch.randn(2, 12, 4, device=card).transpose(0, 1)
    w = torch.randn(3, 4, 5, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        osconv.os_conv(x_pad, w)
