"""The port's op-by-op WaveNet coupling route against the JAX package's, on the CPU.

The route runs with ``FLSTTSC_WN_FUSED=0`` (or a ``dilated_conv=`` override):
per layer a dilated conv (``FLSTTSC_CONV_IMPL`` = conv, im2col or pallas, the
last the tap conv) and the gate.  On the CPU the port's gate and tap conv run
their plain versions; they are held against the JAX functions on the XLA
path (``FLSTTSC_USE_PALLAS=0``, as conftest.py sets) and against the Pallas
kernels in interpret mode.  The same environment variables steer both
packages, so each case compares one formulation with itself.

Tolerances are those of tests/test_torch_port_train_ops.py (f32 on both
sides, sums in another order): rtol 1e-5 / atol 1e-6 for the gate and the tap
conv's value and dx; the tap conv's dw sums 750 rows to values up to ~30, so
its atol is 1e-6 of max|dw|; rtol/atol 3e-4 / 5e-4 for the 8-layer WN value and gradients; the
phase-5 step as tests/test_torch_port_train_phases.py holds it.

Also here: the width fault of the fused WN kernels, which refused every
half width H > 32, and so every vendored dataset (``check_geometry``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_phases import (  # noqa: F401  (setup is a fixture)
    ANCHORS,
    _check_metrics,
    _check_mstate,
    _check_params,
    _ones_masks,
    _port_state,
    _recording_grads,
    setup,
)

from feature_level_style_transfer_for_tsc_tpu.models import flow as j_flow
from feature_level_style_transfer_for_tsc_tpu.ops import gate as j_gate
from feature_level_style_transfer_for_tsc_tpu.ops import osconv as j_osconv
from feature_level_style_transfer_for_tsc_tpu_torch.cli import main as port_main
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten, from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.models import flow
from feature_level_style_transfer_for_tsc_tpu_torch.ops import gate, osconv, wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import (
    StyleTransferPipeline,
    leaves,
)

ONE_OP = {"rtol": 1e-5, "atol": 1e-6}
WN_TOL = {"rtol": 3e-4, "atol": 5e-4}
IMPLS = ["conv", "im2col", "pallas"]
DATASETS = Path(__file__).resolve().parents[1] / "datasets"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and the tiny CPU ops of these runs, spread over every core by each
    process, slow each other down by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _interpret(monkeypatch):
    monkeypatch.setenv("FLSTTSC_USE_PALLAS", "1")
    monkeypatch.setenv("FLSTTSC_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------- gate ----

@pytest.mark.parametrize("pallas", [False, True])
def test_gate_matches_jax(pallas, monkeypatch):
    """Value and both gradients against JAX's custom-VJP gate (``_gate_xla``,
    or ``_gate_pallas`` in interpret mode), with ``b`` a column slice of a
    wider tensor, as the WN passes its cond projection."""
    if pallas:
        _interpret(monkeypatch)
    n = 6
    rng = np.random.default_rng(1)
    a, wide = _rand(rng, 3, 7, 2 * n), _rand(rng, 3, 7, 5 * n)
    b = wide[..., n : 3 * n]
    want = (j_gate._gate_pallas if pallas else j_gate._gate_xla)(jnp.asarray(a), jnp.asarray(b), n)
    want_ga, want_gb = jax.grad(
        lambda x, y: jnp.sum(jnp.sin(j_gate.fused_add_tanh_sigmoid_multiply(x, y, n))), argnums=(0, 1)
    )(jnp.asarray(a), jnp.asarray(b))
    at, wt = _t(a, True), _t(wide, True)
    got = gate.fused_add_tanh_sigmoid_multiply(at, wt[..., n : 3 * n], n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ONE_OP)
    ga, gw = torch.autograd.grad(torch.sin(got).sum(), (at, wt))
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_ga), **ONE_OP)
    np.testing.assert_allclose(gw[..., n : 3 * n].numpy(), np.asarray(want_gb), **ONE_OP)
    assert not gw[..., :n].any() and not gw[..., 3 * n :].any()


def test_gate_shape_check_and_row_views():
    """JAX's shape check; the kernel wrapper's view rule (a column slice is a
    row-strided view and is passed as it is, a transposed tensor is not),
    and its refusal of CPU tensors."""
    with pytest.raises(ValueError, match="expected"):
        gate.fused_add_tanh_sigmoid_multiply(torch.zeros(2, 8), torch.zeros(2, 6), 4)
    wide = torch.zeros(3, 5, 40)
    view = gate._rows(wide[..., 8:16], 4)
    assert view is not None and view.stride() == (40, 1) and view.data_ptr() == wide[..., 8:].data_ptr()
    assert gate._rows(torch.zeros(8, 5).T, 4) is None
    with pytest.raises(ValueError, match="CUDA"):
        gate.gate_fwd(torch.zeros(2, 8), torch.zeros(2, 8), 4)


# ------------------------------------------------------------ tap conv ----

@pytest.mark.parametrize("d", [1, 4, 128])
def test_tap_conv_matches_jax_interpret(d, monkeypatch):
    """Value, dx and dw against JAX's ``tap_conv`` with its Pallas kernel in
    interpret mode and its hand-written VJP (tests/test_ops.py's shapes)."""
    _interpret(monkeypatch)
    rng = np.random.default_rng(d)
    x = _rand(rng, 5, 150 + 2 * d, 12)
    w = _rand(rng, 3, 12, 24, scale=0.2)

    def jloss(xx, ww):
        return jnp.sum(jnp.sin(j_osconv.tap_conv(xx, ww, d)))

    want = j_osconv.tap_conv(jnp.asarray(x), jnp.asarray(w), d)
    want_gx, want_gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    got = osconv.tap_conv(xt, wt, d)
    assert got.shape == (5, 150, 24)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ONE_OP)
    gx, gw = torch.autograd.grad(torch.sin(got).sum(), (xt, wt))
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **ONE_OP)
    np.testing.assert_allclose(gw.numpy(), np.asarray(want_gw), rtol=1e-5,
                               atol=1e-6 * float(np.abs(want_gw).max()))


@pytest.mark.parametrize("impl", ["conv", "im2col"])
def test_tap_conv_plain_ignores_conv_impl(impl, monkeypatch):
    """``tap_conv_plain``, the reference the kernel is held against, is the
    k shifted matmuls whatever ``FLSTTSC_CONV_IMPL`` says, and equals JAX's
    ``_tap_conv_xla`` under that setting."""
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", impl)
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 2, 41, 5), _rand(rng, 3, 5, 7)
    got = osconv.tap_conv_plain(_t(x), _t(w), 8)
    taps = sum(_t(x)[:, 8 * j : 8 * j + 25] @ _t(w)[j] for j in range(3))
    assert torch.equal(got, taps)
    want = j_osconv._tap_conv_xla(jnp.asarray(x), jnp.asarray(w), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ONE_OP)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("d", [1, 2, 8])
def test_dilated_conv_same_matches_jax(impl, d, monkeypatch):
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", impl)
    rng = np.random.default_rng(10 * d)
    x, w, b = _rand(rng, 2, 21, 6), _rand(rng, 3, 6, 10, scale=0.3), _rand(rng, 10)
    want = j_flow._dilated_conv_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), d)
    got = flow._dilated_conv_same(_t(x), _t(w), _t(b), d)
    assert got.shape == (2, 21, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ONE_OP)


# ------------------------------------------------------------ op-by-op WN --

def _wn_case(b, t, h, c, seed):
    params = j_flow.wn_init(jax.random.PRNGKey(seed), h, 8, c)
    rng = np.random.default_rng(seed)
    # a non-zero end projection: the init's zero end would hide the backward
    params["end"] = {"weight": jnp.asarray(_rand(rng, c, 2 * h, scale=0.3)),
                     "bias": jnp.asarray(_rand(rng, 2 * h, scale=0.1))}
    return params, _rand(rng, b, t, h)


def _port(tree):
    out = from_jax_params(_flat({"t": tree}))["t"]
    for leaf in leaves(out):
        leaf.requires_grad_(True)
    return out


def _wn_against_jax(params, x, c, port_conv=None, jax_conv=None):
    """Value, input grad and every parameter grad of the port's ``wn_apply``
    against the JAX package's, on a WN tree the JAX package made."""
    def jloss(p, xx):
        return jnp.sum(jnp.sin(j_flow.wn_apply(p, xx, c, dilated_conv=jax_conv)))

    want = j_flow.wn_apply(params, jnp.asarray(x), c, dilated_conv=jax_conv)
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    pp, xt = _port(params), _t(x, True)
    y = flow.wn_apply(pp, xt, c, dilated_conv=port_conv)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **WN_TOL)
    loss = torch.sin(y).sum()
    grads = torch.autograd.grad(loss, [xt] + leaves(pp))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_gx), **WN_TOL)
    got = dict(zip(flatten({"t": pp}), grads[1:]))
    want_flat = _flat({"t": want_gp})
    assert set(got) == set(want_flat)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want_flat[k], **WN_TOL, err_msg=k)


def _no_fused(monkeypatch):
    monkeypatch.setattr(flow, "wn_apply_fused", lambda *a: pytest.fail("took the fused WN route"))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 64, 3)])
def test_op_by_op_wn_matches_jax(impl, shape, monkeypatch):
    """``FLSTTSC_WN_FUSED=0`` under each conv formulation, with T not a
    multiple of 8 and T < 2^7 (the deep layers' taps all fall off)."""
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0")
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", impl)
    _no_fused(monkeypatch)
    calls = []
    monkeypatch.setattr(flow, "fused_add_tanh_sigmoid_multiply",
                        lambda *a, f=flow.fused_add_tanh_sigmoid_multiply: calls.append(1) or f(*a))
    b, t, h = shape
    params, x = _wn_case(b, t, h, 16, seed=t)
    _wn_against_jax(params, x, 16)
    assert len(calls) == 8


def test_dilated_conv_override_takes_the_op_by_op_route(monkeypatch):
    """A ``dilated_conv=`` override runs op by op even with the fused route
    on, as the JAX package's halo conv does."""
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "1")
    _no_fused(monkeypatch)
    dilations = []

    def port_conv(x, w, bias, dilation):
        dilations.append(dilation)
        return flow._dilated_conv_same(x, w, bias, dilation)

    params, x = _wn_case(2, 29, 4, 16, seed=4)
    _wn_against_jax(params, x, 16, port_conv=port_conv, jax_conv=j_flow._dilated_conv_same)
    assert dilations == [2 ** i for i in range(8)]


def test_op_by_op_route_runs_the_tap_conv_and_the_gate(monkeypatch):
    """With both variables set, each layer goes through ``TapConvCore`` and
    ``GateCore`` (their plain versions on a CPU tensor), forward and back."""
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0")
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", "pallas")
    seen = {"tap": 0, "gate": 0}
    tap_plain, gate_plain = osconv.tap_conv_plain, gate.gate_plain
    monkeypatch.setattr(osconv, "tap_conv_plain",
                        lambda *a: seen.__setitem__("tap", seen["tap"] + 1) or tap_plain(*a))
    monkeypatch.setattr(gate, "gate_plain",
                        lambda *a: seen.__setitem__("gate", seen["gate"] + 1) or gate_plain(*a))
    params, x = _wn_case(2, 20, 3, 8, seed=5)
    pp, xt = _port(params), _t(x, True)
    y = flow.wn_apply(pp, xt, 8)
    assert seen == {"tap": 8, "gate": 8}
    torch.autograd.grad(y.sum(), xt)
    assert seen == {"tap": 16, "gate": 8}  # the backward's dx is the tap conv again


# --------------------------------------------------- the width of the WN ---

@pytest.mark.parametrize(
    "root, name, t_len, h",
    [
        ("Univariate_ts", "VendCoffee", 60, 168),
        ("Univariate_ts", "VendSemg", 90, 117),
        ("Univariate_ts", "VendWorms", 120, 77),
        ("Multivariate_ts", "VendSCP2", 144, 72),
        ("Univariate_ts", "VendGunPoint", 150, 65),
        ("Univariate_ts", "VendSkate", 200, 48),
        ("Univariate_ts", "VendEthanol", 175, 45),
    ],
)
def test_fused_wn_kernels_take_every_vendored_dataset(root, name, t_len, h):
    """The pipeline's WN geometry for each vendored dataset as target (half
    width H = feat/2 from the extractor's last layer, 120 channels, 8
    layers) at the pair and infer row counts: ``check_geometry`` accepts it.
    The kernels refused every H > 32, so every one of these."""
    from feature_level_style_transfer_for_tsc_tpu_torch.cli.predict import build_datasets

    path = str(DATASETS / root)
    train, _, _, _ = build_datasets(path, name, path, name)
    cfg = PipelineConfig()
    pipe = StyleTransferPipeline(train.in_channel, train.time_length, train.num_class,
                                 train.in_channel, train.time_length, train.num_class, cfg,
                                 device="cpu")
    assert (train.time_length, pipe.feat_channels // 2) == (t_len, h)
    for rows in (2 * cfg.batch_size * t_len, cfg.batch_size * t_len):
        wn_fused.check_geometry(rows, t_len, h, cfg.flow.wn_channels, cfg.flow.wn_layers)


@pytest.mark.parametrize("geometry", [(40, 7, 3, 16, 8), (40, 8, 3, 129, 8), (40, 8, 0, 16, 8),
                                      (40, 8, 3, 16, 31)])
def test_check_geometry_refuses(geometry):
    """Rows not whole series, C > 128, H = 0, more than 30 layers."""
    with pytest.raises(ValueError, match="unsupported WN geometry"):
        wn_fused.check_geometry(*geometry)


# ------------------------------------------------------- the phase-5 step --

def test_op_by_op_phase5_epoch_matches_jax(setup, monkeypatch):
    """One ``phase5_epoch`` of one batch with ``FLSTTSC_WN_FUSED=0
    FLSTTSC_CONV_IMPL=pallas`` against the JAX package's (XLA path): the
    metrics, GradNorm weights, model state and updated params, at the
    pinned anchors, dropout and batch of tests/test_torch_port_train_phases.py."""
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0")
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", "pallas")
    _no_fused(monkeypatch)
    jpipe, jstate, ppipe, batch = setup
    jnew, jm = jpipe.phase5_epoch(jstate, *map(jnp.asarray, batch), jnp.asarray(0))
    pstate = _port_state(ppipe, jstate)
    grads = _recording_grads(ppipe, monkeypatch)
    pm = ppipe.phase5_epoch(pstate, *batch, 0, cpc_anchors=ANCHORS, dropout_masks=_ones_masks(ppipe))
    _check_metrics(jm, pm)
    np.testing.assert_allclose(pstate["gradnorm"]["t"].weights.numpy(),
                               np.asarray(jnew["gradnorm"]["t"].weights), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pstate["gradnorm"]["s"].weights.numpy(),
                               np.asarray(jnew["gradnorm"]["s"].weights), rtol=1e-4, atol=1e-5)
    _check_mstate(jnew["mstate"], pstate)
    _check_params(jnew["params"], pstate, grads, port_pipeline.ALL_MODULES)


# ------------------------------------------------------------------ CLI ----

def test_cli_main_on_the_op_by_op_route_writes_the_jax_cli_file_set(tmp_path, monkeypatch):
    monkeypatch.setenv("FLSTTSC_WN_FUSED", "0")
    monkeypatch.setenv("FLSTTSC_CONV_IMPL", "pallas")
    _no_fused(monkeypatch)
    taps = []
    tap = osconv._tap
    monkeypatch.setattr(osconv, "_tap", lambda *a: taps.append(1) or tap(*a))
    root = tmp_path / "arch"
    for name, c, t, n, seed in (("TinyTarget", 2, 16, 2, 0), ("TinySource", 1, 12, 3, 5)):
        for split, count, s in (("TRAIN", 10, seed), ("TEST", 8, seed + 1)):
            x, y = make_arrays(count, c, t, n, seed=s)
            write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y, problem=name)
    out = tmp_path / "run"
    phases = {"p1": 1, "p2": 1, "p3": 1, "p4": 1, "p5": 1}
    _, history = port_main.main([
        "--target-root", str(root), "--target", "TinyTarget", "--source-root", str(root),
        "--source", "TinySource", "--out", str(out), "--budget-multiplier", "0.02",
        "--phase-epochs", json.dumps(phases), "--device", "cpu",
    ])
    want = {"final_state.npz", "history.json", "log.jsonl", "epoch_0.npz", "epoch_0_source.npz",
            "feature_of_target_s2t", "feature_of_source_t2s"}
    want |= {f"p{i}_{side}_classifier_itself.npz" for i in range(1, 6) for side in ("target", "source")}
    assert {p.name for p in out.iterdir()} == want
    assert taps, "the tap conv never ran"
    for h in history:
        for k, v in h.items():
            if k not in ("phase", "epoch"):
                assert np.all(np.isfinite(v)), (k, h)
