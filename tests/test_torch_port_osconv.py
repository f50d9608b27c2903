"""The port's masked omni-scale conv against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX op on its XLA path (FLSTTSC_USE_PALLAS=0, as
conftest.py sets) and against the Pallas kernels in interpret mode.
Tolerance: atol=1e-4 on conv outputs, as tests/test_ops.py uses for the
Pallas kernel — the f32 sums over taps and channels are taken in another
order.  The CUDA kernels themselves run only on a card:
tests/test_torch_port_kernels.py.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.ops import osconv as jax_osconv
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv

ATOL = 1e-4
REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "feature_level_style_transfer_for_tsc_tpu_torch"


def _spec(k, c_in=3, width=2):
    """Branches of kernel 1, 2, 3 and ``k``: a layer of largest kernel ``k``."""
    return [(c_in, width, kk) for kk in (1, 2, 3, k)]


def _conv_inputs(k, seed, b=2, t=32, c_in=6, c_out=10):
    rng = np.random.default_rng(seed)
    x_pad = rng.standard_normal((b, t + k - 1, c_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, c_in, c_out))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    shift = rng.standard_normal(c_out).astype(np.float32)
    return x_pad, w, scale, shift


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("k", [7, 8])
def test_build_os_mask_matches_jax(k):
    np.testing.assert_array_equal(osconv.build_os_mask(_spec(k)), jax_osconv.build_os_mask(_spec(k)))


def test_init_respects_mask_and_bounds():
    spec = _spec(7)
    params = osconv.init_os_conv_params(torch.Generator().manual_seed(0), spec)
    mask = osconv.build_os_mask(spec)
    w = params["weight"].numpy()
    assert w.shape == (7, 3, 8) and params["bias"].shape == (8,)
    np.testing.assert_array_equal(w * (1 - mask), 0.0)
    # the largest kaiming_uniform(a=sqrt(5)) bound: the k=1 branch, fan_in 3
    assert np.abs(w).max() <= np.sqrt(1.0 / 3.0) * np.sqrt(3.0 / 3) + 1e-6


@pytest.mark.parametrize("k", [7, 8])
@pytest.mark.parametrize("epilogue", ["bias", "affine", "affine_relu"])
def test_masked_os_conv_matches_jax(k, epilogue, monkeypatch):
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", "0")
    spec = _spec(k)
    rng = np.random.default_rng(k)
    x = rng.standard_normal((3, 40, 3)).astype(np.float32)
    weight = (0.3 * rng.standard_normal((k, 3, 8))).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    mask = osconv.build_os_mask(spec)
    kw = {}
    if epilogue != "bias":
        kw = {
            "scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
            "shift": rng.standard_normal(8).astype(np.float32),
            "relu": epilogue == "affine_relu",
        }
    want = jax_osconv.masked_os_conv(
        jnp.asarray(x), jnp.asarray(weight), jnp.asarray(bias), jnp.asarray(mask),
        **{n: (jnp.asarray(v) if n != "relu" else v) for n, v in kw.items()},
    )
    got = osconv.masked_os_conv(
        _t(x), _t(weight), _t(bias), _t(mask),
        **{n: (_t(v) if n != "relu" else v) for n, v in kw.items()},
    )
    assert got.shape == (3, 40, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k", [7, 8])
def test_plain_conv_matches_pallas_interpret(k, monkeypatch):
    monkeypatch.setenv("FLSTTSC_PALLAS_INTERPRET", "1")
    x_pad, w, _, _ = _conv_inputs(k, seed=10 + k)
    want = jax_osconv._conv_pallas(jnp.asarray(x_pad), jnp.asarray(w))
    got = osconv.os_conv(_t(x_pad), _t(w))  # a CPU tensor: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k", [7, 8])
@pytest.mark.parametrize("relu", [False, True])
def test_fused_plain_matches_pallas_fused_interpret(k, relu, monkeypatch):
    monkeypatch.setenv("FLSTTSC_PALLAS_INTERPRET", "1")
    x_pad, w, scale, shift = _conv_inputs(k, seed=20 + k)
    want = jax_osconv._conv_pallas_fused(
        jnp.asarray(x_pad), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift), relu
    )
    got = osconv.os_conv_fused(_t(x_pad), _t(w), _t(scale), _t(shift), relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fuse_epilogue_env_is_read_per_call(monkeypatch):
    """FLSTTSC_FUSE_EPILOGUE=1 routes the folded-BN path through the fused
    op, and both routes give the same result."""
    spec = _spec(5)
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 24, 3)).astype(np.float32))
    params = osconv.init_os_conv_params(torch.Generator().manual_seed(1), spec)
    mask = _t(osconv.build_os_mask(spec))
    scale = _t(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    shift = _t(rng.standard_normal(8).astype(np.float32))
    calls = []
    fused = osconv.os_conv_fused
    monkeypatch.setattr(osconv, "os_conv_fused", lambda *a: calls.append(1) or fused(*a))

    def run():
        return osconv.masked_os_conv(
            x, params["weight"], params["bias"], mask, scale=scale, shift=shift, relu=True
        )

    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", "0")
    unfused = run()
    assert calls == []
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", "1")
    np.testing.assert_allclose(run().numpy(), unfused.numpy(), atol=1e-6)
    assert calls == [1]


def test_wrappers_refuse_other_devices():
    x_pad = torch.zeros(1, 9, 2, device="meta")
    w = torch.zeros(3, 2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        osconv.os_conv(x_pad, w)
    with pytest.raises(ValueError, match="device"):
        osconv.os_conv_fused(x_pad, w, w[0, 0], w[0, 0], True)


@pytest.mark.parametrize(
    "x_shape, w_shape, dtype, why",
    [
        ((2, 10, 3), (3, 4, 5), torch.float32, "do not chain"),
        ((2, 2, 3), (3, 3, 5), torch.float32, "unsupported"),
        ((2, 10, 3), (3, 3, 5), torch.float64, "float32"),
    ],
)
def test_operand_checks(x_shape, w_shape, dtype, why):
    """The checks the wrappers run before a launch (exercised on CPU tensors)."""
    with pytest.raises((ValueError, TypeError), match=why):
        osconv._check_operands(torch.zeros(x_shape, dtype=dtype), torch.zeros(w_shape, dtype=dtype))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert PORT / "train" / "multirun.py" in files  # the multi-run training, too
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "feature_level_style_transfer_for_tsc_tpu"), (
                f"{f.relative_to(REPO)} imports {mod}"
            )
    # and at run time: every module imports with jax made unimportable
    names = [
        ".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for f in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['feature_level_style_transfer_for_tsc_tpu'] = None\n"
        f"import importlib\nfor n in {names!r}: importlib.import_module(n)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and (m == 'jax'"
        " or m.startswith(('jax.', 'feature_level_style_transfer_for_tsc_tpu.')))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
