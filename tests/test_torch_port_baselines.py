"""The port's CoDATS / SLARDA baselines against the JAX package's, on the CPU.

Sizes are ``tests/test_baselines.py``'s: ``tiny_config`` (batch 6, kernels up
to 5, ``budget_multiplier=0.02``), target (2 channels, T=16, 2 classes),
sources (1, 12, 3) and (3, 20, 4), and a discriminator 16 wide and 2 deep
with 2 heads and an MLP of 8.  The JAX package initializes each state; its
``params`` and ``mstate`` are carried into the port with ``from_jax_params``
and both packages start from fresh optimizers.  The same numpy-seeded
batches go through one epoch of one batch in both, the JAX one on its XLA
path (``FLSTTSC_USE_PALLAS=0``, as conftest.py sets).  SLARDA's CPC anchor
is pinned from the test (the JAX module's ``cpc_apply`` patched, the port's
``cpc_anchor=``); no JAX file changes.

Tolerances (f32 on both sides, sums in another order): the transformer's
output within 1e-5 of max|JAX output|, its input and parameter gradients
within 1e-4 of each leaf's max|JAX gradient|; epoch losses rtol 1e-5;
BatchNorm statistics rtol 1e-4, atol 1e-5; updated parameters atol 1e-5
where the step's gradient is live, exactly equal for modules the step does
not update (``tests/test_torch_port_train_phases.py``'s ``_check_params``:
an Adam first step moves a weight by about lr * sign(g) whatever the size of
g, so a gradient at noise level, such as an OS conv bias before a
training-mode BatchNorm, may flip its step).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.baselines import codats as jax_codats
from feature_level_style_transfer_for_tsc_tpu.baselines import common as jax_common
from feature_level_style_transfer_for_tsc_tpu.baselines import slarda as jax_slarda
from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu.models import transformer as jax_transformer
from feature_level_style_transfer_for_tsc_tpu_torch.baselines import codats, common, slarda
from feature_level_style_transfer_for_tsc_tpu_torch.cli import baselines as baselines_cli
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten, from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.models import transformer
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import leaves

KW = dict(batch_size=6, max_kernel_size=5, budget_multiplier=0.02)
DISC = dict(disc_hid=16, disc_depth=2, disc_heads=2, disc_mlp=8)
T_SHAPE, S_SHAPES = (2, 16, 2), [(1, 12, 3), (3, 20, 4)]
B = KW["batch_size"]
ANCHOR = 1  # SLARDA's CPC anchor, < (12 // 2) // 2
LOSS_TOL = {"rtol": 1e-5, "atol": 1e-6}
STATE_TOL = {"rtol": 1e-4, "atol": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and the tiny CPU ops of these runs, spread over every core by each
    process, slow each other down by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _models(jstate):
    return from_jax_params(_flat({k: jstate[k] for k in ("params", "mstate")}))


def _batches(shapes, seed):
    """One epoch of one batch per (C, T, n_class): (1, B, T, C), (1, B)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, B, t, c)).astype(np.float32),
             rng.integers(0, n, (1, B)).astype(np.int32)) for c, t, n in shapes]


def _recording(pipe, monkeypatch):
    """Record the gradients each optimizer step is given, by module."""
    seen = {}
    apply = pipe._apply_updates

    def record(opt, params, names, grads):
        for n in names:
            seen[n] = [None if g is None else g.clone() for g in grads[n]]
        return apply(opt, params, names, grads)

    monkeypatch.setattr(pipe, "_apply_updates", record)
    return seen


def _check_params(jparams, pparams, grads, stepped):
    want, got = _flat(jparams), flatten(pparams)
    assert set(got) == set(want)
    g_max = max(float(g.abs().max()) for n in stepped for g in grads[n] if g is not None)
    for name in pparams:
        keys = [k for k in got if k.startswith(f"['{name}']")]
        if name not in stepped:
            for k in keys:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        assert len(keys) == len(grads[name])
        for k, g in zip(keys, grads[name]):
            g = np.zeros_like(got[k]) if g is None else g.numpy()
            live = np.abs(g) > max(1e-6 * g_max, 1e-5)
            np.testing.assert_allclose(got[k][live], want[k][live], atol=1e-5, err_msg=k)


def _check_mstate(jmstate, pmstate):
    want, got = _flat(jmstate), flatten(pmstate)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STATE_TOL, err_msg=k)


def _check_metrics(jm, pm):
    assert set(jm) == set(pm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(pm[k]), np.asarray(jm[k]), **LOSS_TOL, err_msg=k)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# ------------------------------------------------------------ transformer --

def _transformer_case(grl, gelu=None, monkeypatch=None):
    """The discriminator's output and its input and parameter gradients
    (against a fixed cotangent) in both packages; ``gelu`` replaces the
    port's GELU."""
    patch, heads = 10, 2
    jp = jax_transformer.discriminator_att_init(jax.random.PRNGKey(3), patch, 16, 2, heads, 8,
                                                num_class=3)
    rng = np.random.default_rng(4)
    x = (2.0 * rng.standard_normal((4, patch, 6))).astype(np.float32)
    ct = rng.standard_normal((4, 3)).astype(np.float32)

    def jfn(p, xx):
        return jnp.sum(jax_transformer.discriminator_att_apply(p, xx, patch, heads, grl=grl) * ct)

    j_out = np.asarray(jax_transformer.discriminator_att_apply(jp, jnp.asarray(x), patch, heads,
                                                               grl=grl))
    j_gp, j_gx = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    if gelu is not None:
        monkeypatch.setattr(transformer, "F", type("F", (), {"gelu": staticmethod(gelu)}))
    pp = from_jax_params(_flat(jp))
    for t in leaves(pp):
        t.requires_grad_(True)
    px = torch.tensor(x, requires_grad=True)
    p_out = transformer.discriminator_att_apply(pp, px, patch, heads, grl=grl)
    grads = torch.autograd.grad((p_out * torch.from_numpy(ct)).sum(), [px] + leaves(pp))
    p_gp = dict(zip(flatten(pp), (g.numpy() for g in grads[1:])))
    return (j_out, np.asarray(j_gx), _flat(j_gp)), (p_out.detach().numpy(), grads[0].numpy(), p_gp)


@pytest.mark.parametrize("grl", [None, 1.2])
def test_discriminator_matches_jax(grl):
    (j_out, j_gx, j_gp), (p_out, p_gx, p_gp) = _transformer_case(grl)
    assert _rel(p_out, j_out) <= 1e-5
    assert _rel(p_gx, j_gx) <= 1e-4
    assert set(p_gp) == set(j_gp)
    for k in j_gp:
        assert _rel(p_gp[k], j_gp[k]) <= 1e-4, k


def test_seq_transformer_needs_the_tanh_gelu(monkeypatch):
    """``jax.nn.gelu`` is the tanh form: the exact erf GELU misses the
    output tolerance."""
    exact = lambda x, approximate="none": torch.nn.functional.gelu(x)  # noqa: E731
    (j_out, _, _), (p_out, _, _) = _transformer_case(None, exact, monkeypatch)
    assert _rel(p_out, j_out) > 1e-5


# ---------------------------------------------------------------- CoDATS --

def test_codats_train_epoch_matches_jax(monkeypatch):
    jpipe = jax_codats.CoDATSPipeline(T_SHAPE, S_SHAPES, config=JaxConfig(**KW), **DISC)
    jstate = jpipe.init_state(jax.random.PRNGKey(0))
    (xt, yt), *sources = _batches([T_SHAPE, *S_SHAPES], seed=0)
    xs, ys = [s[0] for s in sources], [s[1] for s in sources]
    jnew, jm = jpipe.train_epoch(jstate, jnp.asarray(xt), jnp.asarray(yt),
                                 [jnp.asarray(x) for x in xs], [jnp.asarray(y) for y in ys])
    ppipe = codats.CoDATSPipeline(T_SHAPE, S_SHAPES, config=PipelineConfig(**KW), **DISC,
                                  device="cpu")
    pstate = ppipe.training_state(_models(jstate))
    grads = _recording(ppipe, monkeypatch)
    pm = ppipe.train_epoch(pstate, xt, yt, xs, ys)
    _check_metrics(jm, pm)
    _check_mstate(jnew["mstate"], pstate["mstate"])
    _check_params(jnew["params"], pstate["params"], grads, tuple(pstate["params"]))
    assert pstate["sched"] == int(jnew["sched"]) == 1
    assert pstate["opt"].param_groups[0]["lr"] == pytest.approx(
        float(jnew["opt"].hyperparams["learning_rate"]))


# ---------------------------------------------------------------- SLARDA --

@pytest.fixture(scope="module")
def slarda_setup():
    mp = pytest.MonkeyPatch()
    cpc_apply = jax_slarda.cpc_apply
    mp.setattr(jax_slarda, "cpc_apply", lambda p, f, r: cpc_apply(p, f, r, anchor=ANCHOR))
    s_shape = S_SHAPES[0]
    jpipe = jax_slarda.SLARDAPipeline(T_SHAPE, s_shape, config=JaxConfig(**KW), **DISC)
    jstate = jpipe.init_state(jax.random.PRNGKey(0))
    ppipe = slarda.SLARDAPipeline(T_SHAPE, s_shape, config=PipelineConfig(**KW), **DISC,
                                  device="cpu")
    (xt, yt), (xs, ys) = _batches([T_SHAPE, s_shape], seed=1)
    yield jpipe, jstate, ppipe, (xt, yt, xs, ys)
    mp.undo()


def test_slarda_source_epoch_matches_jax(slarda_setup, monkeypatch):
    jpipe, jstate, ppipe, (_, _, xs, ys) = slarda_setup
    jnew, jm = jpipe.source_epoch(jstate, jnp.asarray(xs), jnp.asarray(ys))
    pstate = ppipe.training_state(_models(jstate))
    grads = _recording(ppipe, monkeypatch)
    pm = ppipe.source_epoch(pstate, xs, ys, cpc_anchor=ANCHOR)
    _check_metrics(jm, pm)
    _check_mstate(jnew["mstate"], pstate["mstate"])
    _check_params(jnew["params"], pstate["params"], grads, slarda.SOURCE_GROUP)
    assert pstate["sched_src"] == int(jnew["sched_src"]) == 1


def test_slarda_transfer_keeps_the_head_and_resets_the_moments(slarda_setup):
    jpipe, jstate, ppipe, (xt, yt, xs, _) = slarda_setup
    pstate = ppipe.training_state(_models(jstate))
    ppipe.target_epoch(pstate, xt, yt, xs)  # gives the target optimizer moments
    assert len(pstate["opt_tgt"].state) > 0
    head = pstate["params"]["t_cls"]["hidden"]["weight"].detach().clone()
    jnew = jpipe.transfer_weights(jstate)
    fresh = ppipe.transfer_weights(ppipe.training_state(_models(jstate)))
    got = flatten({"params": fresh["params"], "mstate": fresh["mstate"]})
    for k, v in _flat({"params": jnew["params"], "mstate": jnew["mstate"]}).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    ppipe.transfer_weights(pstate)
    np.testing.assert_array_equal(pstate["params"]["t_cls"]["hidden"]["weight"].detach(), head)
    for a, b in zip(leaves(pstate["params"]["t_ext"]), leaves(pstate["params"]["s_ext"])):
        np.testing.assert_array_equal(a.detach(), b.detach())
    opt = pstate["opt_tgt"]
    assert len(opt.state) == 0 and opt.param_groups[0]["lr"] == common.LR
    tgt = [p for n in slarda.TARGET_GROUP for p in leaves(pstate["params"][n])]
    assert [id(p) for p in opt.param_groups[0]["params"]] == [id(p) for p in tgt]


def test_slarda_target_epoch_matches_jax(slarda_setup, monkeypatch):
    """From the JAX state after one source epoch and the transfer; the
    target's running statistics are those of ONE update a batch (the JAX
    package drops the critic pre-pass's)."""
    jpipe, jstate, ppipe, (xt, yt, xs, ys) = slarda_setup
    jsrc, _ = jpipe.source_epoch(jstate, jnp.asarray(xs), jnp.asarray(ys))
    jsrc = jpipe.transfer_weights(jsrc)
    jnew, jm = jpipe.target_epoch(jsrc, jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(xs))
    pstate = ppipe.training_state(_models(jsrc))
    grads = _recording(ppipe, monkeypatch)
    pm = ppipe.target_epoch(pstate, xt, yt, xs)
    _check_metrics(jm, pm)
    _check_mstate(jnew["mstate"], pstate["mstate"])
    # the frozen source keeps its statistics; the target's moved
    before = flatten(_models(jsrc)["mstate"])
    after = flatten(pstate["mstate"])
    for k in before:
        if k.startswith(("['s_ext']", "['s_cls']")):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        elif k.endswith(".mean"):
            assert not np.array_equal(after[k], before[k]), k
    _check_params(jnew["params"], pstate["params"], grads, ("disc",) + slarda.TARGET_GROUP)
    assert pstate["sched_tgt"] == int(jnew["sched_tgt"]) == 1


# ---------------------------------------------------------------- shared --

@pytest.mark.parametrize("count", [0, 24, 25, 50])
def test_steplr_value_matches_jax(count):
    want = float(jax_common.steplr_value(2e-3, count))
    assert common.steplr_value(2e-3, count) == pytest.approx(want, rel=1e-6)
    assert common.steplr_value(2e-3, count) == 2e-3 * 0.5 ** (count // 25)


def test_evaluate_target_pads_the_last_batch(monkeypatch):
    """8 series at batch 6: two full batches, the second padded with the
    last series; the accuracy equals the JAX package's and that of one
    unbatched forward."""
    jpipe = jax_codats.CoDATSPipeline(T_SHAPE, S_SHAPES, config=JaxConfig(**KW), **DISC)
    jstate = jpipe.init_state(jax.random.PRNGKey(5))
    ppipe = codats.CoDATSPipeline(T_SHAPE, S_SHAPES, config=PipelineConfig(**KW), **DISC,
                                  device="cpu")
    pstate = ppipe.training_state(_models(jstate))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, T_SHAPE[1], T_SHAPE[0])).astype(np.float32)
    whole = ppipe.predict_target(pstate["params"], pstate["mstate"], torch.from_numpy(x))
    y = torch.argmax(whole, -1).numpy()
    y[::3] = 1 - y[::3]  # some wrong, so the accuracy is not 1
    seen = []
    predict = ppipe.predict_target

    def spy(params, mstate, xe):
        seen.append(xe.clone())
        return predict(params, mstate, xe)

    monkeypatch.setattr(ppipe, "predict_target", spy)
    acc = ppipe.evaluate_target(pstate, x, y)
    assert [tuple(s.shape) for s in seen] == [(B, T_SHAPE[1], T_SHAPE[0])] * 2
    np.testing.assert_array_equal(seen[1][2:].numpy(), np.repeat(x[-1:], 4, 0))
    assert acc == pytest.approx(float(np.mean(y == torch.argmax(whole, -1).numpy())))
    assert acc == pytest.approx(jpipe.evaluate_target(jstate, x, y))


# ------------------------------------------------------------------- CLI --

# history keys the JAX CLI writes: baselines/codats.py:234-236 and
# baselines/slarda.py:571,584-585
CODATS_KEYS = {"epoch", "loss_t", "loss_s", "loss_disc", "train_acc", "test_acc"}
SLARDA_KEYS = {"source": {"phase", "epoch", "s_c_loss", "s_sl_loss"},
               "target": {"phase", "epoch", "t_c_loss", "adapt_loss", "disc_loss", "test_acc"}}


def _archive(root, name, c, t, n, seed):
    for split, count, s in (("TRAIN", 30, seed), ("TEST", 10, seed + 1)):
        x, y = make_arrays(count, c, t, n, seed=s)
        write_ts_file(str(root / name / f"{name}_{split}.ts"), x, y)


@pytest.mark.parametrize("baseline", ["codats", "slarda"])
def test_cli_baselines_on_cpu(tmp_path, monkeypatch, baseline):
    """At the CLI's reference budgets and discriminator: series of T=128,
    where the OS-CNN feature map is 144 channels wide, keep it small."""
    _archive(tmp_path, "TinyT", 2, 128, 2, 0)
    _archive(tmp_path, "TinyS", 1, 96, 3, 5)
    out = tmp_path / "out"
    args = [baseline, "--target-root", str(tmp_path), "--target", "TinyT",
            "--source-root", str(tmp_path), "--sources", "TinyS", "--epochs", "1",
            "--out", str(out), "--device", "cpu"]
    asked, fit = [], slarda.SLARDAPipeline.fit

    def short_fit(self, *a, **kw):  # the CLI fixes the reference's 70 source epochs
        asked.append(kw["source_epochs"])
        return fit(self, *a, **{**kw, "source_epochs": 1})

    monkeypatch.setattr(slarda.SLARDAPipeline, "fit", short_fit)
    _, history = baselines_cli.main(args)
    assert asked == ([70] if baseline == "slarda" else [])
    written = json.loads((out / f"{baseline}_history.json").read_text())
    assert written == json.loads(json.dumps(history))
    if baseline == "codats":
        assert [set(h) for h in written] == [CODATS_KEYS]
    else:
        assert [set(h) for h in written] == [SLARDA_KEYS["source"], SLARDA_KEYS["target"]]
    for h in written:
        for k, v in h.items():
            if k != "phase":
                assert np.all(np.isfinite(v)), (k, v)


@pytest.mark.parametrize("baseline", ["codats", "slarda"])
def test_cli_baselines_refuses_without_cuda(tmp_path, baseline):
    if torch.cuda.is_available():
        pytest.skip("CUDA is here")
    with pytest.raises(RuntimeError, match="CUDA"):
        baselines_cli.main([baseline, "--target-root", str(tmp_path), "--target", "T",
                            "--source-root", str(tmp_path), "--sources", "S"])


def test_evaluate_target_folds_no_batchnorm(monkeypatch):
    """The JAX baselines' ``predict_target`` calls the OS-CNN without
    ``fused_infer``, so even ``FLSTTSC_FUSE_EPILOGUE=1`` runs no fused conv
    in their evaluation; the accuracy is the JAX package's."""
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv

    def refuse(*a, **kw):
        raise AssertionError("os_conv_fused ran in a baseline's evaluation")

    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", "1")
    monkeypatch.setattr(osconv, "os_conv_fused", refuse)
    monkeypatch.setattr(osconv, "os_conv_fused_plain", refuse)
    s_shape = S_SHAPES[0]
    jpipe = jax_slarda.SLARDAPipeline(T_SHAPE, s_shape, config=JaxConfig(**KW), **DISC)
    jstate = jpipe.init_state(jax.random.PRNGKey(7))
    ppipe = slarda.SLARDAPipeline(T_SHAPE, s_shape, config=PipelineConfig(**KW), **DISC,
                                  device="cpu")
    pstate = ppipe.training_state(_models(jstate))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((10, T_SHAPE[1], T_SHAPE[0])).astype(np.float32)
    y = rng.integers(0, T_SHAPE[2], 10)
    assert ppipe.evaluate_target(pstate, x, y) == pytest.approx(jpipe.evaluate_target(jstate, x, y))
