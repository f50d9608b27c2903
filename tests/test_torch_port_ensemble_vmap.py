"""The port's ensemble members under one ``torch.func.vmap``, on the CPU.

``MultiSourceEnsemble.member_logits`` runs the members' convs as one vmap
over the stacked model axis (the JAX package's ``jax.vmap``), so each layer
is one run-axis conv call for all the members (``OSConvCore`` /
``OSConvFusedCore``'s vmap rules: ``os_conv_runs`` / ``os_conv_fused_runs``),
and takes the time pool and the head member by member.  Held here, with
``FLSTTSC_FUSE_EPILOGUE`` unset and ``=1``: against the members' own
``predict_logits`` calls, bit for bit; against JAX's ``member_logits`` on
the same members (carried across with ``from_jax_params``), within 1e-5
relative (the same float32 model, sums in another order); the run-axis
calls counted, one a layer for all the members against one a member and
layer.  The class weights, vmapped as JAX vmaps them, against the members
one by one, bit for bit.

Members: 3 target models (2 channels, T=16, 2 classes; budget 0.02, the
sizes of ``tests/test_torch_port_multi_source.py``) initialized by the JAX
package from seeded keys, their BatchNorm statistics moved off their
initial values so the folded epilogue matters.
"""

import jax
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.config import PipelineConfig as JaxConfig
from feature_level_style_transfer_for_tsc_tpu.parallel.multi_source import (
    MultiSourceEnsemble as JaxEnsemble,
)
from feature_level_style_transfer_for_tsc_tpu.train.classifier import OSCNNClassifier as JaxOSCNN
from feature_level_style_transfer_for_tsc_tpu_torch.config import PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.evaluation.metrics import (
    normalize_model_weights,
    per_class_precision_weights,
)
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import from_jax_params
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv
from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import (
    MultiSourceEnsemble,
)

T_SHAPE = (2, 16, 2)
BUDGET = 0.02
SEEDS = (1, 2, 3)
REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["0", "1"], ids=["unfused", "fused"])
def fuse(request, monkeypatch):
    monkeypatch.setenv("FLSTTSC_FUSE_EPILOGUE", request.param)
    return request.param == "1"


def _jax_member(seed: int):
    """A JAX member ``{'params', 'mstate'}`` from ``seed``, its BatchNorm
    statistics moved off their initial values."""
    model = JaxOSCNN(*T_SHAPE, config=JaxConfig(budget_multiplier=BUDGET), with_cpc=False)
    st = model.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def moved(path, a):
        field = jax.tree_util.keystr(path).rsplit(".", 1)[-1]
        shape = np.shape(a)
        if field == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)

    return {"params": st["params"],
            "mstate": jax.tree_util.tree_map_with_path(moved, st["mstate"])}


@pytest.fixture(scope="module")
def members():
    jax_members = [_jax_member(s) for s in SEEDS]
    flat = [{jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_leaves_with_path(m)} for m in jax_members]
    return jax_members, [from_jax_params(f) for f in flat]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    c, t, n = T_SHAPE
    return (rng.standard_normal((12, t, c)).astype(np.float32), rng.integers(0, n, 12))


def _ensemble():
    return MultiSourceEnsemble(*T_SHAPE, config=PipelineConfig(budget_multiplier=BUDGET),
                               device="cpu")


def _counted(monkeypatch, names):
    """``osconv.<name>`` for each of ``names`` wrapped to count its calls."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(osconv, name)

        def counting(*args, _name=name, _fn=fn):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(osconv, name, counting)
    return calls


def test_vmapped_member_logits_are_the_members_own_calls(members, data, fuse):
    """The vmapped members' logits, bit for bit those of each member's own
    ``predict_logits`` call."""
    ens = _ensemble()
    got = ens.member_logits(ens.stack(members[1]), data[0])
    want = torch.stack([ens.model_def.predict_logits(m["params"], m["mstate"], data[0])
                        for m in members[1]])
    assert got.shape == (len(SEEDS), len(data[0]), T_SHAPE[2])
    assert torch.equal(got, want)


def test_vmapped_member_logits_match_jax(members, data, fuse):
    """Within 1e-5 relative of JAX's ``member_logits`` (one ``jax.vmap``)."""
    jens = JaxEnsemble(*T_SHAPE, config=JaxConfig(budget_multiplier=BUDGET))
    want = np.asarray(jens.member_logits(jens.stack(members[0]), jax.numpy.asarray(data[0])))
    ens = _ensemble()
    got = ens.member_logits(ens.stack(members[1]), data[0]).numpy()
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_one_run_axis_conv_call_a_layer(members, data, fuse, monkeypatch):
    """One run-axis conv call a layer for the three members (6 calls, the
    loop's 18 one-run calls)."""
    runs, one = ("os_conv_fused_runs", "os_conv_fused") if fuse else ("os_conv_runs", "os_conv")
    calls = _counted(monkeypatch, [runs, one])
    ens = _ensemble()
    layers = len(ens.model_def.ext_masks) + len(ens.model_def.cls_masks)
    stacked = ens.stack(members[1])
    ens.member_logits(stacked, data[0])
    assert layers == 6 and calls == {runs: layers, one: 0}
    for m in members[1]:
        ens.model_def.predict_logits(m["params"], m["mstate"], data[0])
    assert calls == {runs: layers, one: len(SEEDS) * layers}


def test_vmapped_class_weights_are_the_members_one_by_one(members, data):
    """``compute_class_weights`` (the precision weights under one vmap, as
    JAX's) against each member's weights taken alone, bit for bit."""
    ens = _ensemble()
    stacked = ens.stack(members[1])
    preds = ens.member_logits(stacked, data[0]).argmax(-1)
    labels = torch.as_tensor(data[1])
    want = normalize_model_weights(
        torch.stack([per_class_precision_weights(p, labels, T_SHAPE[2]) for p in preds]))
    assert torch.equal(ens.compute_class_weights(stacked, *data), want)


def test_stack_without_a_mesh_takes_every_member(members):
    """Without a mesh a rank holds every member: ``local_members`` is all of
    them, and a missing one (None) is refused."""
    ens = _ensemble()
    assert ens.local_members(3) == [0, 1, 2]
    with pytest.raises(ValueError, match="missing"):
        ens.stack([members[1][0], None, members[1][2]])
