"""The port's data parallelism under every PipelineConfig knob, both bf16
switches, the op-by-op WN route and phases 2-4, on the CPU.

``parallel/dp.py`` runs in 4 gloo processes, spawned once for this module
(``tests/_torch_port_dp_knobs_ranks.py``, one torch thread a rank): each rank
runs the collectives under ``torch.func.vmap`` (forward, and a batched pull
through them), one data-parallel phase-5 step (``dp.phase5_epoch`` of one batch) under
each configuration of ``CONFIGS`` (``merged_pullbacks=False``,
``stacked_pullbacks=True``, ``fused_optimizers=True``,
``compute_dtype="bfloat16"``, ``FLSTTSC_WN_MXU=bf16``, ``FLSTTSC_WN_FUSED=0``
with ``FLSTTSC_CONV_IMPL=pallas``) and one epoch of one batch each of
phases 2, 3 (supervised) and 4 (both branches) through ``dp.phase2_epoch``
/ ``phase3_epoch`` / ``phase4_epoch``.  While they run, this process takes
JAX's single-device epochs of the same configurations (JAX's GSPMD data
parallelism equals them: JAX ``tests/test_parallel.py::
test_phase5_dp_epoch_matches_single_device``) and the port's unsharded ones.

Setup: ``tests/test_torch_port_dp.py``'s (target 2 x 16, 2 classes; source 1
x 12, 3 classes; batch 8, 2 rows a rank; the randomness pinned as there)
with a 2-flow WaveGlow of a 2-layer 8-channel WN (``FLOW``), JAX-made
models with the WN end projections set to 0.1 N(0, 1) (the init's zero end
zeroes every WN layer gradient); the JAX side runs XLA
(``FLSTTSC_USE_PALLAS=0``), but with ``FLSTTSC_WN_MXU=bf16`` its fused WN
kernel in interpret mode, where the switch lives in JAX.

Tolerances (measured on a CPU while writing this file, in brackets):

* float32 configurations, against the port's unsharded step: losses, trunk
  norms and GradNorm weights atol 1e-5 [6.4e-7 relative], gradients rtol
  1e-3 with atol 1e-5 * max|g| of the step (``GRAD_RTOL``), the state after the step as
  ``test_torch_port_dp.py`` holds it; against JAX's epoch: metrics rtol
  1e-4, atol 1e-5, GradNorm weights rtol 1e-3, model state rtol 1e-4, atol
  1e-5, updated parameters atol 1e-5 where the gradient is live (that
  file's rule);
* bf16 configurations sit at the bf16 noise floor (ROADMAP C9): each
  module's gradients (relative L2), each loss, trunk norm and GradNorm
  weight (absolute for the losses, else relative) is held to the unsharded
  step within 1e-5 or twice the spread between two correct unsharded bf16
  computations, measured here: the unsharded step against the same step
  with the bf16 products summed in float64 (phase 19's control), with each
  OS conv run over the batch in four micro-batches, their weight gradients
  summed (a bf16 conv's weight gradient is rounded to bf16 once a call, so
  a batch split four ways rounds four partial sums, as each rank's share
  does; JAX's GSPMD all-reduces the bf16 partials too), and with the
  batch's rows in another order (every batch sum in another order, and so
  other bf16 roundings downstream); a norm or weight also within twice its
  trunk's gradient spread.  With
  ``compute_dtype="bfloat16"`` the OS-CNN gradients sat 1.5e-3 to 4.1e-3
  from the unsharded step's, the micro-batch control 2.1e-3 to 5.4e-3;
  with ``FLSTTSC_WN_MXU=bf16`` up to 3.7e-4, the float64 control 3.5e-4.
  Against JAX's epoch: the bars of JAX's own bf16 test, rtol and atol 5e-2
  (``tests/test_torch_port_bf16_training.py``);
* phases 2-4: metrics against JAX rtol 1e-4, atol 1e-5 and against the
  unsharded epoch atol 1e-5; parameters, model state, StepLR counts and
  the nf plateau (phase 4 steps it on the last batch's GLOBAL total) as
  above.

Every rank's results are the same bits.
"""

import concurrent.futures
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_dp_knobs_ranks import (
    BF16_CONFIGS,
    CONFIGS,
    config_pipeline,
    environ,
    rank_main,
    rank_tensor,
)
from _torch_port_dp_ranks import pipe_state, pipeline, recording, recording_phase5
from test_torch_port_dp import (  # noqa: F401  (jax_patched and one_thread are fixtures)
    ANCHORS,
    KW,
    LOSS_TOL,
    P,
    S_SHAPE,
    STATE_TOL,
    T_SHAPE,
    B,
    _batches,
    _check_params,
    _close_grads,
    _flat,
    _flat_grads,
    _same_bits,
    jax_patched,
    one_thread,
)

from feature_level_style_transfer_for_tsc_tpu import ops as jax_ops
from feature_level_style_transfer_for_tsc_tpu.config import FlowConfig as JaxFlow
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.train import pipeline as jax_pipeline
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv, wn_fused
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch
from feature_level_style_transfer_for_tsc_tpu_torch.train import jax_state
from feature_level_style_transfer_for_tsc_tpu_torch.train import pipeline as port_pipeline

#: a 2-layer, 8-channel WN: JAX's fused WN kernel in interpret mode (the ``FLSTTSC_WN_MXU``
#: case) took 85 s to compile at 8 layers of 16 channels, 38 s at these
FLOW = dict(n_flows=2, wn_channels=8, wn_layers=2)
WN_END_SCALE = 0.1
#: the JAX side's environment of each configuration: the port's own (``CONFIGS``), and for
#: ``FLSTTSC_WN_MXU`` JAX's fused WN kernel in interpret mode (the switch lives in it;
#: ``jax_side`` routes JAX's WN, and only it, to Pallas)
JAX_ENV = {
    "wn_mxu": {"FLSTTSC_WN_MXU": "bf16", "FLSTTSC_PALLAS_INTERPRET": "1"},
    "op_by_op": CONFIGS["op_by_op"][1],
}
BF16_JAX_TOL = {"rtol": 5e-2, "atol": 5e-2}
FLOOR = 1e-5
#: the float32 steps' gradients against the unsharded step, beside atol 1e-5 * max|g|: the
#: gate of tests/test_torch_port_dp.py's JAX comparison; one element of the source
#: extractor's shortcut weight (a BatchNorm channel whose mean dwarfs its spread) sat 1.8e-4
#: relative, 2.3e-5 of max|g|, from it in every float32 configuration, the default included
GRAD_RTOL = 1e-3
MICRO_BATCHES = 4
EPOCHS = {"phase2": (2, None), "phase3": (3, True), "phase4_supervised": (4, True),
          "phase4_unsupervised": (4, False)}


@pytest.fixture(scope="module")
def setup(jax_patched):
    """The JAX models (WN ends non-zero), one batch a domain, the cases."""
    rng = np.random.default_rng(0)
    jpipe = jax_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, JaxConfig(**KW, flow=JaxFlow(**FLOW)))
    jstate = jpipe.init_state(jax.random.PRNGKey(0))
    params = dict(jstate["params"])
    params["nf"] = dict(params["nf"])
    params["nf"]["wn"] = [
        {**wn, "end": {"weight": jnp.asarray(WN_END_SCALE * rng.standard_normal(
            wn["end"]["weight"].shape).astype(np.float32)), "bias": wn["end"]["bias"]}}
        for wn in params["nf"]["wn"]]
    xt, yt = _batches(rng, 1, T_SHAPE)
    xs, ys = _batches(rng, 1, S_SHAPE)
    cases = {
        "pipe": {"t_shape": T_SHAPE, "s_shape": S_SHAPE, "kw": KW, "flow": FLOW,
                 "models": _flat({"params": params, "mstate": jstate["mstate"],
                                  "consts": jstate["consts"]})},
        "xt": xt, "yt": yt, "xs": xs, "ys": ys, "anchors": ANCHORS,
        "masks": [[np.ones((B, 1024), np.float32)] * 2] * 2,
    }
    return {"params": params, "cases": cases}


def _jax_state(jpipe, params):
    return {**jpipe.init_state(jax.random.PRNGKey(0)), "params": params}


@pytest.fixture(scope="module")
def jax_side(setup):
    """JAX's single-device epochs: phase 5 of one batch under each
    configuration, phases 2-4 of the default config."""
    c, params = setup["cases"], setup["params"]
    batch = [jnp.asarray(c[k]) for k in ("xt", "yt", "xs", "ys")]
    out = {}
    for name, (knobs, _) in CONFIGS.items():
        jpipe = jax_pipeline.StyleTransferPipeline(
            *T_SHAPE, *S_SHAPE, JaxConfig(**KW, flow=JaxFlow(**FLOW), **knobs))
        with environ(JAX_ENV.get(name, {})), pytest.MonkeyPatch.context() as mp:
            if name == "wn_mxu":  # JAX's flow reads ops.use_pallas per call; its convs keep XLA
                mp.setattr(jax_ops, "use_pallas", lambda: True)
            out[f"phase5_{name}"] = jpipe.phase5_epoch(_jax_state(jpipe, params), *batch,
                                                       jnp.asarray(0))
    jpipe = jax_pipeline.StyleTransferPipeline(*T_SHAPE, *S_SHAPE, JaxConfig(**KW, flow=JaxFlow(**FLOW)))
    state = _jax_state(jpipe, params)
    out["phase2"] = jpipe.phase2_epoch(state, batch[2], batch[3])
    out["phase3"] = jpipe.phase3_epoch(state, *batch, True)
    out["phase4_supervised"] = jpipe.phase4_epoch(state, *batch, True)
    out["phase4_unsupervised"] = jpipe.phase4_epoch(state, *batch, False)
    return out


class _MicroBatched:
    """``OSConvCore`` over the batch in ``MICRO_BATCHES`` parts (the control)."""

    core = osconv.OSConvCore

    @classmethod
    def apply(cls, x_pad, w):
        return torch.cat([cls.core.apply(part, w) for part in x_pad.chunk(MICRO_BATCHES)])


def _f64_mm(a, b, bf16):
    if bf16:
        a, b = a.bfloat16(), b.bfloat16()
    return (a.double() @ b.double()).float()


def _f64_os_conv_plain(x_pad, w, plain=osconv.os_conv_plain):
    if x_pad.dtype == torch.bfloat16:
        return plain(x_pad.double(), w.double()).to(x_pad.dtype)
    return plain(x_pad, w)


def _unsharded_step(c, name, patches=(), rows=None):
    """The port's unsharded pinned step (an epoch of one batch) under
    ``name``, recorded; ``patches``: (module, attribute, value) set inside;
    ``rows``: the batch's rows in this order."""
    pipe = config_pipeline(c["pipe"], name)
    state = pipe_state(pipe, c["pipe"])
    steps = recording_phase5(pipe)
    masks = [[torch.ones(B, 1024)] * 2] * 2
    batch = [c[k] if rows is None else c[k][:, rows] for k in ("xt", "yt", "xs", "ys")]
    with environ(CONFIGS[name][1]), pytest.MonkeyPatch.context() as mp:
        for module, attr, value in patches:
            mp.setattr(module, attr, value)
        pipe.phase5_epoch(state, *batch, 0, cpc_anchors=ANCHORS, dropout_masks=masks)
    return steps[0]


@pytest.fixture(scope="module")
def unsharded(setup):
    """The port's unsharded steps and epochs; for the bf16 configurations
    also the two controls."""
    c = setup["cases"]
    out = {}
    for name in CONFIGS:
        out[f"phase5_{name}"] = _unsharded_step(c, name)
        if name in BF16_CONFIGS:
            out[f"phase5_{name}_controls"] = [
                _unsharded_step(c, name, [(wn_fused, "_mm", _f64_mm),
                                          (osconv, "os_conv_plain", _f64_os_conv_plain)]),
                _unsharded_step(c, name, [(osconv, "OSConvCore", _MicroBatched)]),
                _unsharded_step(c, name, rows=np.random.default_rng(1).permutation(B)),
            ]
    for key, (phase, supervised) in EPOCHS.items():
        pipe = pipeline(c["pipe"])
        state = pipe_state(pipe, c["pipe"])
        steps = recording(pipe)
        if phase == 2:
            m = pipe.phase2_epoch(state, c["xs"], c["ys"])
        elif phase == 3:
            m = pipe.phase3_epoch(state, c["xt"], c["yt"], c["xs"], c["ys"], supervised, ANCHORS)
        else:
            m = pipe.phase4_epoch(state, c["xt"], c["yt"], c["xs"], c["ys"], supervised, ANCHORS)
        out[key] = {"steps": steps, "metrics": {k: float(v) for k, v in m.items()},
                    "state": jax_state.state_to_flat(state)}
    return out


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory, request):
    """Each rank's results: the 4 gloo ranks, spawned once; the JAX side and
    the port's unsharded runs are computed here while they run."""
    rdv = tmp_path_factory.mktemp("rendezvous") / "store"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, rank_main, P, (f"file://{rdv}", setup["cases"]),
                            timeout=420)
        for name in ("jax_side", "unsharded"):
            request.getfixturevalue(name)
        return ranks.result()


def _rel_l2(got, want):
    """Relative L2 distance of two lists of arrays (None a zero)."""
    pairs = [(np.zeros_like(w) if g is None else g, np.zeros_like(g) if w is None else w)
             for g, w in zip(got, want) if g is not None or w is not None]
    num = sum(float(((a.astype(np.float64) - b) ** 2).sum()) for a, b in pairs)
    den = sum(float((b.astype(np.float64) ** 2).sum()) for _, b in pairs)
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


#: the trunk whose gradients each GradNorm norm (and so each weight) reads
TRUNK = {"n_t": "t_ext", "w_t": "t_ext", "n_s": "s_ext", "w_s": "s_ext"}


def _gaps(step, want):
    """Each module's gradients (relative L2), each loss (absolute), each
    trunk norm and GradNorm weight (relative) of ``step`` from ``want``."""
    out = {f"grads {n}": _rel_l2(list(step["grads"][n].values()), list(want["grads"][n].values()))
           for n in want["grads"]}
    for k, v in want["losses"].items():
        out[f"loss {k}"] = abs(step["losses"][k] - v)
    for k in TRUNK:
        out[k] = float(np.max(np.abs(step[k] - want[k]) / np.abs(want[k])))
    return out


def _allowed(key, controls):
    """A bf16 gap's bar: FLOOR, or twice the controls' largest gap of the
    same quantity; a norm or weight also twice its trunk's gradient gap,
    which bounds a norm's relative change."""
    keys = [key] + ([f"grads {TRUNK[key]}"] if key in TRUNK else [])
    return max(FLOOR, 2 * max(ctl[k] for ctl in controls for k in keys))


# ----------------------------------------------------------- collectives --

def test_collectives_under_vmap(ranks):
    """``all_reduce_sum`` and ``all_gather_rows`` under ``torch.func.vmap``
    (the batch dim moved to the front, one collective): the sum of every
    rank's operand, and every rank's rows in rank order along the logical
    dim (0 and -1); a batched pull of 3 cotangents through both (their
    backwards apply ``_AllReduceSum`` to the batched gradient) equals the 3
    single pulls (rtol 1e-6, atol 1e-6; the same sums in one collective)."""
    xs = [rank_tensor(r).numpy() for r in range(P)]
    for r, res in enumerate(ranks):
        got = res["collectives"]
        np.testing.assert_allclose(got["sum"], sum(xs), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["rows"], np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(got["last"], np.concatenate(xs, axis=2))
        np.testing.assert_allclose(got["pull"], got["single"], rtol=1e-6, atol=1e-6, err_msg=r)


# ---------------------------------------------------------------- phase 5 --

@pytest.mark.parametrize("name", list(CONFIGS))
def test_phase5_dp_step_matches_unsharded(ranks, unsharded, name):
    """One data-parallel phase-5 step under each configuration against the
    port's unsharded step of the same configuration (tolerances in the
    module docstring); every rank's the same bits."""
    got = _same_bits(ranks, (f"phase5_{name}",))["step"]
    want = unsharded[f"phase5_{name}"]
    assert set(got["losses"]) == set(want["losses"]) and len(got["losses"]) == 9
    if name in BF16_CONFIGS:
        controls = [_gaps(ctl, want) for ctl in unsharded[f"phase5_{name}_controls"]]
        for key, gap in _gaps(got, want).items():
            allowed = _allowed(key, controls)
            assert gap <= allowed, f"{name} {key}: {gap:.3e} > {allowed:.3e} (controls {controls})"
        return
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=0, atol=1e-5, err_msg=k)
    for k in ("n_t", "n_s", "w_t", "w_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    _close_grads(got["grads"], _flat_grads(want["grads"]), f"{name} step vs unsharded",
                 rtol=GRAD_RTOL)
    _check_params(got["state"], want["state"], [got["grads"]], port_pipeline.ALL_MODULES)
    for k in (k for k in want["state"] if k.startswith(("['mstate']", "['gradnorm']"))):
        np.testing.assert_allclose(got["state"][k], want["state"][k], **STATE_TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_phase5_dp_step_matches_jax(ranks, jax_side, name):
    """The same step (the epoch of one batch) against JAX's single-device
    ``phase5_epoch`` of the same configuration: the metrics and GradNorm
    weights; for the float32 configurations also the new model state and
    the updated parameters where the gradient is live."""
    res = ranks[0][f"phase5_{name}"]
    jnew, jm = jax_side[f"phase5_{name}"]
    assert set(res["metrics"]) == set(jm)
    tol = BF16_JAX_TOL if name in BF16_CONFIGS else LOSS_TOL
    for k in jm:
        if k.startswith("gradnorm"):
            continue
        np.testing.assert_allclose(res["metrics"][k], np.asarray(jm[k]), **tol, err_msg=k)
    for g in ("t", "s"):
        np.testing.assert_allclose(res["metrics"][f"gradnorm_w_{g}"],
                                   np.asarray(jnew["gradnorm"][g].weights),
                                   **(BF16_JAX_TOL if name in BF16_CONFIGS else {"rtol": 1e-3}))
    if name in BF16_CONFIGS:
        return
    state = res["step"]["state"]
    want = _flat(jnew)
    for k in (k for k in want if k.startswith("['mstate']")):
        np.testing.assert_allclose(state[k], want[k], **STATE_TOL, err_msg=k)
    _check_params(state, want, [res["step"]["grads"]], port_pipeline.ALL_MODULES)


# ------------------------------------------------------------ phases 2-4 --

@pytest.mark.parametrize("key", list(EPOCHS))
def test_phase_epochs_match_jax_and_unsharded(ranks, jax_side, unsharded, key):
    """``dp.phase2_epoch``, ``phase3_epoch`` (supervised) and
    ``phase4_epoch`` (both branches) against JAX's single-device epochs and
    the port's unsharded ones: the global metrics, the updated parameters
    (live rule), the model state, the StepLR counts, and phase 4's nf
    plateau, stepped on the last batch's global total; every rank's state
    the same bits."""
    res = ranks[0][key]
    state = _same_bits(ranks, (key, "state"))
    jnew, jm = jax_side[key]
    u = unsharded[key]
    assert set(res["metrics"]) == set(jm) == set(u["metrics"])
    for k in jm:
        np.testing.assert_allclose(res["metrics"][k], float(jm[k]), **LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(res["metrics"][k], u["metrics"][k], rtol=0, atol=1e-5, err_msg=k)
    want = _flat(jnew)
    stepped = list(res["steps"][0])
    for ref in (want, u["state"]):
        _check_params(state, ref, res["steps"], stepped)
        for k in (k for k in ref if k.startswith("['mstate']")):
            np.testing.assert_allclose(state[k], np.asarray(ref[k]), **STATE_TOL, err_msg=k)
    for n in port_pipeline.STEPLR_MODULES:
        assert int(state[f"['sched']['{n}']"]) == int(jnew["sched"][n]) == int(u["state"][f"['sched']['{n}']"])
    if key.startswith("phase4"):
        for field in ("best", "num_bad", "lr"):
            k = f"['plateau']['nf'].{field}"
            np.testing.assert_allclose(state[k], float(getattr(jnew["plateau"]["nf"], field)),
                                       **LOSS_TOL, err_msg=k)
            np.testing.assert_allclose(state[k], u["state"][k], rtol=0, atol=1e-5, err_msg=k)
