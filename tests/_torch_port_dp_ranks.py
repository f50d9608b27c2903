"""The rank side of tests/test_torch_port_dp.py: no JAX here.

``rank_main`` runs in each of the test's spawned gloo processes.  It takes
the cases as numpy arrays (the JAX package's parameters and states,
flattened by their tree paths, and the batches), runs the port's data
parallelism on its own shard of each batch on the CPU, and returns numpy
arrays: what the placement helpers keep, the states before and after
``replicate``, the cross-replica BatchNorm's output and gradients, each
step's global gradients and losses, the states after each epoch, the
ensemble's results and the refusals' messages.
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.config import FlowConfig, PipelineConfig
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import flatten, from_jax_params, tree_items
from feature_level_style_transfer_for_tsc_tpu_torch.ops.batchnorm import BNStats, batch_norm, bn_cross_replica
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import dp, launch
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import mesh as port_mesh
from feature_level_style_transfer_for_tsc_tpu_torch.parallel.dp_explicit import make_dp_phase1_epoch
from feature_level_style_transfer_for_tsc_tpu_torch.parallel.multi_source import MultiSourceEnsemble
from feature_level_style_transfer_for_tsc_tpu_torch.train import jax_state
from feature_level_style_transfer_for_tsc_tpu_torch.train.classifier import OSCNNClassifier
from feature_level_style_transfer_for_tsc_tpu_torch.train.multirun import MultiRunStylePipeline
from feature_level_style_transfer_for_tsc_tpu_torch.train.pipeline import StyleTransferPipeline

P = 4


def _np(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def pipeline(c, **knobs):
    return StyleTransferPipeline(*c["t_shape"], *c["s_shape"],
                                 PipelineConfig(**c["kw"], flow=FlowConfig(**c["flow"]), **knobs),
                                 device="cpu")


def pipe_state(pipe, c, seed=0):
    """The port's training state of the JAX package's initial state."""
    return pipe.training_state(from_jax_params(c["models"]), seed=seed)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _runs(fn):
    """``fn``'s phase-5 step: (None, its global losses), or (the ValueError's
    message, None)."""
    try:
        losses = fn()[0]
    except ValueError as e:
        return str(e), None
    return None, {k: float(v) for k, v in losses.items()}


def placement_case(m, m22, c):
    x = torch.from_numpy(c["x"])
    out = {}
    for name, mesh in (("m4", m), ("m22", m22)):
        out[name] = {
            "data0": port_mesh.place(mesh, x, port_mesh.data_sharding(mesh)).numpy(),
            "data1": port_mesh.place(mesh, x, port_mesh.data_sharding(mesh, batch_axis=1)).numpy(),
            "domain": port_mesh.place(mesh, x, port_mesh.domain_sharding(mesh)).numpy(),
            "replicated": port_mesh.place(mesh, x, port_mesh.replicated(mesh)).numpy(),
            "placements": [str(p) for p in port_mesh.data_sharding(mesh, batch_axis=1)],
        }
    xb, yb = dp.shard_epoch_batches(m, c["xb"], c["yb"])
    out["epoch_batches"] = (xb, yb)
    out["indivisible"] = _raises(lambda: dp.shard_epoch_batches(m, c["xb"][:, :6], c["yb"][:, :6]))
    return out


def replicate_case(m, rank, c):
    """A classifier state and a pipeline state that differ from rank to
    rank (seeds, one local step, plateau and scheduler values), flattened
    before and after ``replicate``."""
    clf = OSCNNClassifier(*c["clf_shape"], config=PipelineConfig(**c["clf_kw"]), with_cpc=True,
                          device="cpu")
    cs = clf.init_state(torch.Generator().manual_seed(100 + rank))
    rng = np.random.default_rng(rank)
    xb = rng.standard_normal((1, 8, c["clf_shape"][1], c["clf_shape"][0])).astype(np.float32)
    yb = rng.integers(0, c["clf_shape"][2], (1, 8))
    clf.train_epoch(cs, xb, yb)
    pipe = pipeline(c["pipe"])
    ps = pipe.init_state(torch.Generator().manual_seed(200 + rank))
    ps["sched"]["t_ext"] = rank
    ps["plateau"]["nf"] = ps["plateau"]["nf"]._replace(best=float(rank), num_bad=rank)
    ps["gradnorm"]["t"].weights.add_(rank)
    ps["gradnorm"]["t"].initialized = rank % 2 == 0
    before = {"clf": jax_state.classifier_state_to_flat(cs), "pipe": jax_state.state_to_flat(ps),
              "clf_generator": cs["generator"].get_state().numpy()}
    cs2 = dp.replicate(m, cs)
    ps2 = dp.replicate(m, ps)
    assert cs2 is cs and ps2 is ps
    after = {"clf": jax_state.classifier_state_to_flat(cs), "pipe": jax_state.state_to_flat(ps),
             "clf_generator": cs["generator"].get_state().numpy(),
             "gradnorm_initialized": ps["gradnorm"]["t"].initialized,
             "draw": int(torch.randint(0, 2**30, (), generator=ps["generator"]))}
    return {"before": before, "after": after}


def bn_case(m, c):
    """Cross-replica BatchNorm on this rank's rows: output, new statistics,
    and the gradients of sum(y * r) (the input's rows; the parameters' share)."""
    x = dp.shard_epoch_batches(m, c["x"][None], c["x"][None])[0][0]
    r = dp.shard_epoch_batches(m, c["r"][None], c["r"][None])[0][0]
    x = torch.from_numpy(x).requires_grad_()
    scale, bias = (torch.from_numpy(c[k]).requires_grad_() for k in ("scale", "bias"))
    stats = BNStats(torch.from_numpy(c["mean"]), torch.from_numpy(c["var"]))
    group, _, _ = port_mesh.axis_group(m, "data")
    with bn_cross_replica(group):
        y, new = batch_norm(x, scale, bias, stats, True)
    (y * torch.from_numpy(r)).sum().backward()
    return {"y": _np(y), "mean": _np(new.mean), "var": _np(new.var), "dx": _np(x.grad),
            "dscale": _np(scale.grad), "dbias": _np(bias.grad)}


def keyed(params, grads):
    """Gradients by module, each ``{parameter path: array or None}``, the
    path as the JAX package's key of the parameter tree (``['t_ext']...``)."""
    return {n: {k: _np(g) for (k, _), g in zip(tree_items(params[n], f"[{n!r}]"), gs)}
            for n, gs in grads.items()}


def recording(model):
    """Each optimizer step's gradients (``keyed``), one dict a step."""
    seen = []
    apply = model._apply_updates

    def record(state, names, grads):
        seen.append(keyed(state["params"], {n: grads[n] for n in names}))
        return apply(state, names, grads)

    model._apply_updates = record
    return seen


def recording_phase5(pipe):
    """Each phase-5 step's global losses, gradients (``keyed``), trunk
    norms, new GradNorm weights and the state after it (flat), one dict a
    step."""
    steps = []
    grads_fn, update = pipe.phase5_grads, pipe._phase5_update

    def record_grads(state, *args, **kw):
        out = grads_fn(state, *args, **kw)
        losses, _, _, grads, n_t, n_s = out
        steps.append({"losses": {k: float(v) for k, v in losses.items()},
                      "grads": keyed(state["params"], grads), "n_t": _np(n_t), "n_s": _np(n_s)})
        return out

    def record_update(state, *args):
        update(state, *args)
        steps[-1]["w_t"] = _np(state["gradnorm"]["t"].weights)
        steps[-1]["w_s"] = _np(state["gradnorm"]["s"].weights)
        # copies: on the CPU the flat arrays share the tensors' memory
        steps[-1]["state"] = {k: np.array(v) for k, v in jax_state.state_to_flat(state).items()}

    pipe.phase5_grads, pipe._phase5_update = record_grads, record_update
    return steps


def classifier_case(m, c):
    clf = OSCNNClassifier(*c["clf_shape"], config=PipelineConfig(**c["clf_kw"]), with_cpc=False,
                          device="cpu")
    state = jax_state.load_classifier_state(clf.init_state(torch.Generator().manual_seed(1)),
                                            c["clf_state"])
    dp.replicate(m, state)
    steps = recording(clf)
    xb, yb = dp.shard_epoch_batches(m, c["clf_xb"], c["clf_yb"])
    metrics = dp.train_epoch(m, clf, state, xb, yb)
    return {"steps": steps, "metrics": {k: float(v) for k, v in metrics.items()},
            "state": jax_state.classifier_state_to_flat(state)}


def phase1_case(m, c):
    pipe = pipeline(c["pipe"])
    state = dp.replicate(m, pipe_state(pipe, c["pipe"]))
    steps = recording(pipe)
    epoch = make_dp_phase1_epoch(pipe, m)
    xb, yb = dp.shard_epoch_batches(m, c["xt"], c["yt"])
    metrics = epoch(state, xb, yb, cpc_anchor=c["anchors"][0])
    return {"steps": steps, "metrics": {k: float(v) for k, v in metrics.items()},
            "state": jax_state.state_to_flat(state)}


def phase5_case(m, c):
    """The pinned phase-5 epoch of two batches, each step recorded."""
    pipe = pipeline(c["pipe"])
    state = dp.replicate(m, pipe_state(pipe, c["pipe"]))
    steps = recording_phase5(pipe)
    (xt, yt), (xs, ys) = (dp.shard_epoch_batches(m, c[x], c[y]) for x, y in (("xt", "yt"), ("xs", "ys")))
    masks = [[torch.from_numpy(port_mesh.place(m, k, port_mesh.data_sharding(m))) for k in pair]
             for pair in c["masks"]]
    metrics = dp.phase5_epoch(m, pipe, state, xt, yt, xs, ys, 0, cpc_anchors=c["anchors"],
                              dropout_masks=masks)
    return {"steps": steps, "metrics": {k: _np(v) for k, v in metrics.items()},
            "state": jax_state.state_to_flat(state)}


def phase5_dropout_case(m, c):
    """One phase-5 step with the anchors and the dropout masks drawn from
    the replicated generator."""
    pipe = pipeline(c["pipe"])
    state = dp.replicate(m, pipe_state(pipe, c["pipe"], seed=c["dropout_seed"]))
    bt, lt, bs, ls = (torch.from_numpy(dp.shard_epoch_batches(m, c[k][:1], c[k][:1])[0][0])
                      for k in ("xt", "yt", "xs", "ys"))
    losses, new_m, _, grads, n_t, n_s = dp.phase5_grads(m, pipe, state, bt, lt.long(), bs,
                                                        ls.long(), 0)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": keyed(state["params"], grads),
            "n_t": _np(n_t), "n_s": _np(n_s), "new_m": flatten(new_m),
            "generator": state["generator"].get_state().numpy()}


def ensemble_case(mesh, members, c):
    """The domain-sharded ensemble's evaluation, or None off the mesh."""
    if mesh.get_coordinate() is None:
        return None
    ens = MultiSourceEnsemble(*c["shape"], config=PipelineConfig(**c["kw"]), device="cpu",
                              mesh=mesh)
    stacked = ens.stack([from_jax_params(f) for f in members])
    train = types.SimpleNamespace(x=c["train_x"], y=c["train_y"])
    test = types.SimpleNamespace(x=c["test_x"], y=c["test_y"])
    res = ens.evaluate(stacked, train, test)
    return {"local_members": int(stacked["params"]["cls"]["hidden"]["bias"].shape[0]),
            **{k: res[k] for k in ("ensemble_acc", "vote_variants", "member_accs",
                                   "class_weights", "predictions")}}


def refusals(m, c):
    pipe = pipeline(c["pipe"])
    state = pipe_state(pipe, c["pipe"])
    batch = [torch.zeros(2, *s) for s in ((16, 2), (12, 1))]
    labels = torch.zeros(2, dtype=torch.long)

    def step(p):
        return lambda: dp.phase5_grads(m, p, state, batch[0], labels, batch[1], labels, 0)

    out = {knob: _runs(step(pipeline(c["pipe"], **{knob: value})))
           for knob, value in (("merged_pullbacks", False), ("stacked_pullbacks", True),
                               ("fused_optimizers", True), ("compute_dtype", "bfloat16"))}
    for var, value in (("FLSTTSC_WN_MXU", "bf16"), ("FLSTTSC_WN_FUSED", "0")):
        os.environ[var] = value
        try:
            out[var] = _runs(step(pipe))
        finally:
            del os.environ[var]
    out["multirun"] = _raises(lambda: dp.phase5_epoch(m, MultiRunStylePipeline(pipe), {}, [], [],
                                                      [], [], 0))
    out["multirun_phase1"] = _raises(lambda: make_dp_phase1_epoch(MultiRunStylePipeline(pipe), m))
    ens = MultiSourceEnsemble(*c["ensemble"]["shape"], config=PipelineConfig(**c["ensemble"]["kw"]),
                              device="cpu", mesh=c["mesh4"])
    out["ensemble_indivisible"] = _raises(
        lambda: ens.stack([from_jax_params(f) for f in c["ensemble"]["members"][:3]]))
    return out


def rank_main(rank, world_size, init_method, cases):
    """Every case on this rank's shards."""
    torch.set_num_threads(1)
    with launch.process_group(rank, world_size, init_method, "gloo", timeout=120):
        m = port_mesh.make_mesh(data=P, device="cpu")
        m22 = port_mesh.make_mesh(data=2, domain=2, device="cpu")
        m_dom4 = port_mesh.make_mesh(data=1, domain=4, device="cpu")
        m_dom3 = port_mesh.make_mesh(data=1, domain=3, device="cpu")
        ens = cases["ensemble"]
        out = {
            "coordinate": tuple(m.get_coordinate()),
            "placement": placement_case(m, m22, cases["placement"]),
            "replicate": replicate_case(m, rank, cases),
            "bn": bn_case(m, cases["bn"]),
            "classifier": classifier_case(m, cases),
            "phase1": phase1_case(m, cases),
            "phase5": phase5_case(m, cases),
            "phase5_dropout": phase5_dropout_case(m, cases),
            "ensemble4": ensemble_case(m_dom4, ens["members"], ens),
            "ensemble3": ensemble_case(m_dom3, ens["members"][:3], ens),
            "refusals": refusals(m, {**cases, "mesh4": m_dom4}),
        }
    return out
