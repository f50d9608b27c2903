"""The port's OS-CNN extractor and classifier against the JAX package's.

Parameters are made by the JAX package's initializers, given non-trivial
BatchNorm affine parameters and running statistics from a numpy seed,
written with the JAX package's ``save_checkpoint`` and carried into the port
by ``from_jax_params`` — so the key strings are the ones the JAX package
really writes.  Both sides run in eval mode on the CPU, with
``fused_infer`` off and on (and, on the port's side, the fused epilogue
selected by FLSTTSC_FUSE_EPILOGUE=0/1).  Tolerance: atol=1e-4, rtol=1e-4 —
f32 sums taken in another order through a few layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.io.checkpoint import save_checkpoint as jax_save
from feature_level_style_transfer_for_tsc_tpu.models import os_cnn as jax_os_cnn
from feature_level_style_transfer_for_tsc_tpu.ops.batchnorm import BNStats as JaxBNStats
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import (
    from_jax_params,
    save_checkpoint,
)
from feature_level_style_transfer_for_tsc_tpu_torch.models import os_cnn
from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import BNStats
from feature_level_style_transfer_for_tsc_tpu_torch.structure import (
    generate_layer_parameter_list,
    layer_parameter_list_input_change,
    total_out_channels,
)

TOL = {"atol": 1e-4, "rtol": 1e-4}
# 2 input channels, receptive field 7: kernels 1,2,3,5,7 then the K=2 last layer
EXT_SPECS = generate_layer_parameter_list(1, 7, [36, 600], 2)
CLS_SPECS = layer_parameter_list_input_change(EXT_SPECS, total_out_channels(EXT_SPECS[-1]))


def _randomize(tree, rng):
    """Non-trivial BN scale/bias and running stats, as after training."""

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith(".var"):
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(np.float32))
        if name.endswith(".mean") or "bn_bias" in name:
            return jnp.asarray((0.3 * rng.standard_normal(x.shape)).astype(np.float32))
        if "bn_scale" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _to_port(tmp_path, name, tree):
    path = tmp_path / f"{name}.npz"
    jax_save(str(path), tree)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return flat, from_jax_params(flat)


@pytest.fixture
def x():
    return np.random.default_rng(0).standard_normal((3, 32, 2)).astype(np.float32)


def test_from_jax_params_keys_and_round_trip(tmp_path):
    """The JAX package's key strings (dict keys, list indices, BNStats
    fields) parse into the port's layout, and the port writes them back
    unchanged."""
    p, s = jax_os_cnn.os_cnn_res_init(jax.random.PRNGKey(0), EXT_SPECS)
    flat, port = _to_port(tmp_path, "ext", {"params": p, "mstate": s})
    assert "['params']['block']['layers'][0]['conv']['weight']" in flat
    assert "['mstate']['res_bn'].mean" in flat
    assert isinstance(port["mstate"]["res_bn"], BNStats)
    assert isinstance(port["params"]["block"]["layers"], list)
    save_checkpoint(str(tmp_path / "port.npz"), port)
    with np.load(tmp_path / "port.npz") as z:
        assert sorted(z.files) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(z[k], flat[k])


def test_port_init_has_the_jax_layout(tmp_path):
    """A state the port initializes has the same keys and shapes as the JAX
    package's, so each package reads the other's checkpoints."""
    jp, js = jax_os_cnn.os_cnn_init(jax.random.PRNGKey(0), CLS_SPECS, 3)
    flat, _ = _to_port(tmp_path, "cls", {"params": jp, "mstate": js})
    pp, ps = os_cnn.os_cnn_init(torch.Generator().manual_seed(0), CLS_SPECS, 3)
    save_checkpoint(str(tmp_path / "port.npz"), {"params": pp, "mstate": ps})
    with np.load(tmp_path / "port.npz") as z:
        assert {k: z[k].shape for k in z.files} == {k: v.shape for k, v in flat.items()}


@pytest.mark.parametrize("fused_infer, fuse_env", [(False, "0"), (True, "0"), (True, "1")])
def test_os_cnn_res_matches_jax(tmp_path, x, fused_infer, fuse_env, monkeypatch):
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", fuse_env)
    rng = np.random.default_rng(1)
    p, s = jax_os_cnn.os_cnn_res_init(jax.random.PRNGKey(1), EXT_SPECS)
    tree = _randomize({"params": p, "mstate": s}, rng)
    masks = jax_os_cnn.os_block_masks(EXT_SPECS)
    want, _ = jax_os_cnn.os_cnn_res_apply(
        tree["params"], tree["mstate"], [jnp.asarray(m) for m in masks], jnp.asarray(x),
        training=False, fused_infer=fused_infer,
    )
    _, port = _to_port(tmp_path, "ext", tree)
    got, _ = os_cnn.os_cnn_res_apply(
        port["params"], port["mstate"], os_cnn.os_block_masks(EXT_SPECS), torch.from_numpy(x),
        False, fused_infer=fused_infer,
    )
    assert got.shape == (3, 32, total_out_channels(EXT_SPECS[-1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused_infer, fuse_env", [(False, "0"), (True, "0"), (True, "1")])
def test_os_cnn_matches_jax(tmp_path, x, fused_infer, fuse_env, monkeypatch):
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", fuse_env)
    rng = np.random.default_rng(2)
    p, s = jax_os_cnn.os_cnn_init(jax.random.PRNGKey(2), CLS_SPECS, 3)
    tree = _randomize({"params": p, "mstate": s}, rng)
    feat = np.abs(rng.standard_normal((3, 32, CLS_SPECS[0][0][0]))).astype(np.float32)
    masks = jax_os_cnn.os_block_masks(CLS_SPECS)
    want_logits, want_pooled, _ = jax_os_cnn.os_cnn_apply(
        tree["params"], tree["mstate"], [jnp.asarray(m) for m in masks], jnp.asarray(feat),
        training=False, fused_infer=fused_infer,
    )
    _, port = _to_port(tmp_path, "cls", tree)
    logits, pooled, _ = os_cnn.os_cnn_apply(
        port["params"], port["mstate"], os_cnn.os_block_masks(CLS_SPECS), torch.from_numpy(feat),
        False, fused_infer=fused_infer,
    )
    assert logits.shape == (3, 3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), **TOL)


def test_batch_norm_eval_matches_jax():
    from feature_level_style_transfer_for_tsc_tpu.ops.batchnorm import batch_norm
    from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import batch_norm_eval

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(4).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    want, same = batch_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        JaxBNStats(jnp.asarray(mean), jnp.asarray(var)), training=False,
    )
    got = batch_norm_eval(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        BNStats(torch.from_numpy(mean), torch.from_numpy(var)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("relu_at_last", [False, True])
def test_relu_at_last_rule(relu_at_last):
    """Every layer but the last ends in ReLU; the last only when asked
    (models/os_cnn.py:118-120 of the JAX package)."""
    p, s = os_cnn.os_block_init(torch.Generator().manual_seed(3), EXT_SPECS)
    masks = os_cnn.os_block_masks(EXT_SPECS)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 2)).astype(np.float32))
    y, _ = os_cnn.os_block_apply(p, s, masks, x, False, relu_at_last=relu_at_last)
    assert (y.min().item() >= 0.0) == relu_at_last
