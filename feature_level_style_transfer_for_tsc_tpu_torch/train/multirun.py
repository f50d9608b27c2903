"""K independent curriculum runs in one launch set.

Counterpart of the JAX package's ``train/multirun.py``: K runs of the same
dataset-pair shapes (a seed sweep) train together, each phase step of all K
runs being ONE forward, ONE gradient pass and ONE stacked optimizer step,
so the host's launch work is spread over K runs:

* the forward is the single-run pipeline's own (``_phaseN_forward`` of
  ``StyleTransferPipeline``) under ``torch.func.vmap`` over stacked
  parameters, model state and batches.  The hand-written kernels see the
  runs through their Functions' vmap rules (``ops.osconv.OSConvCore``,
  ``ops.wn_fused.WNCore``): one run-axis kernel call for the K runs, so a
  K-run step launches ``os_conv_fwd_runs`` / ``wn_fwd_runs`` /
  ``wn_bwd_runs`` as often as a one-run step launches the one-run kernels.
  On the op-by-op WN route (``FLSTTSC_WN_FUSED=0``) ``ops.gate.GateCore``
  folds the runs into the rows of one ``gate_fwd`` launch (counted as
  ``gate_fwd_runs``) and, under ``FLSTTSC_CONV_IMPL=pallas``,
  ``ops.osconv.TapConvCore`` takes ``tap_conv_fwd_runs`` (forward and dx);
  the ``conv`` and ``im2col`` formulations are PyTorch's own batched ops;
* the gradient is taken OUTSIDE the transform: ``torch.autograd.grad`` of
  the runs' summed losses by the stacked leaves gives each run its own
  gradient in its own slice, because the runs share nothing; GradNorm's
  trunk norms are taken per run (``_phase5_pulls(per_run=True)``);
* the updates are ``StackedRMSprop`` / ``StackedAdam`` (``train/optim.py``)
  with a learning rate a run (with ``fused_optimizers``: one K-run
  ``FusedRMSprop``, a learning rate a run and element): the plateau
  schedules diverge per run, while the StepLR counters are shared (every
  run counts the same epochs);
* the pipeline config's GradNorm knobs hold here too (``merged_pullbacks``,
  ``stacked_pullbacks``: ``_phase5_pulls(per_run=True)``), as the JAX
  package's multirun vmaps the same step; under ``stacked_pullbacks`` the
  batched backward reaches ``wn_bwd_runs`` with 3K runs.

Randomness is drawn outside the transform, per run, in the order
``StyleTransferPipeline.run`` draws it: each run's batch orders from its own
``seed + 1`` generator on the host (or injected, ``perms``), its CPC anchors
and CDAN dropout masks from its state's generator.  So a K-run is K
single runs in turn, up to the summation order of batched products.  The
model-state counters (NoiseTransfer's step counts, the critics' GRL
iterations) advance alike in every run and stay shared and unbatched, so
the forwards read them on the host as in one run.

Evaluation runs the no-grad fused-inference forward under ``vmap`` inside
``torch.inference_mode()``.  There is no CLI, as in the JAX package: the
entry point is this API, on the pipeline's device (``"cuda"`` unless the
pipeline was made with ``device="cpu"``).
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..data.batching import epoch_batches
from ..losses.gradnorm import GradNormState
from ..models.cpc import draw_anchor
from ..models.critics import draw_dropout_masks
from .optim import (
    FusedRMSprop,
    plateau_step,
    stack_fused,
    stack_optimizers,
    unstack_fused,
    unstack_optimizer,
)
from .pipeline import (
    PHASE3_METRICS,
    PHASE4_METRICS,
    PHASE5_PLATEAU,
    PHASE5_STEPLR,
    StyleTransferPipeline,
)
from .steps import ModuleSteps, detached, leaves


def _shared(t: torch.Tensor) -> bool:
    """Integer leaves of the model state are step counters, shared by the runs."""
    return not t.is_floating_point()


def _stack_gradnorm(gs: Sequence[GradNormState]) -> GradNormState:
    lr = gs[0].optimizer.param_groups[0]["lr"]
    if len({g.initialized for g in gs}) != 1:
        raise ValueError("the runs' GradNorm states are not at the same step")
    out = GradNormState([0.0] * gs[0].weights.numel(), lr, gs[0].weights.device)
    out.weights = torch.stack([g.weights.detach() for g in gs]).contiguous()
    out.initial_sigmoid_loss = torch.stack([g.initial_sigmoid_loss for g in gs])
    out.initialized = gs[0].initialized
    out.optimizer = _stack_adam(out.weights, [g.optimizer for g in gs], lr)
    return out


def _stack_adam(weights: torch.Tensor, optimizers, lr: float) -> torch.optim.Adam:
    """One torch Adam over the stacked GradNorm weights (elementwise, so each
    row steps as its run's own) holding the runs' moments."""
    opt = torch.optim.Adam([weights], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    states = [o.state.get(o.param_groups[0]["params"][0], {}) for o in optimizers]
    if all(states):
        steps = {float(s["step"]) for s in states}
        if len(steps) != 1:
            raise ValueError(f"the runs' GradNorm Adams stepped unequally: {sorted(steps)}")
        opt.state[weights] = {"step": states[0]["step"].clone(),
                              **{k: torch.stack([s[k] for s in states])
                                 for k in ("exp_avg", "exp_avg_sq")}}
    elif any(states):
        raise ValueError("the runs' GradNorm Adams stepped unequally")
    return opt


def _unstack_gradnorm(g: GradNormState, i: int) -> GradNormState:
    lr = g.optimizer.param_groups[0]["lr"]
    out = GradNormState([0.0] * g.weights.shape[-1], lr, g.weights.device)
    out.weights = g.weights[i].detach().clone()
    out.initial_sigmoid_loss = g.initial_sigmoid_loss[i].clone()
    out.initialized = g.initialized
    out.optimizer = torch.optim.Adam([out.weights], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    state = g.optimizer.state.get(g.weights)
    if state:
        out.optimizer.state[out.weights] = {
            "step": state["step"].clone(),
            **{k: state[k][i].clone() for k in ("exp_avg", "exp_avg_sq")}}
    return out


def _stack_opt(optimizers, params: Dict, m: str):
    """K runs' optimizers of entry ``m`` of ``opt`` over the stacked
    ``params``: a stacked optimizer, or for ``"fused"`` a K-run
    ``FusedRMSprop``."""
    if isinstance(optimizers[0], FusedRMSprop):
        return stack_fused(optimizers, {n: params[n] for n in optimizers[0].names})
    return stack_optimizers(optimizers, leaves(params[m]))


def stack_states(states: Sequence[Dict]) -> Dict:
    """K training states of one pipeline (``StyleTransferPipeline.training_state``
    or ``init_state``) as one stacked state: parameters as leaves with a
    leading run axis that require grad, model state and constants stacked
    (the integer step counters shared, and checked equal), one stacked
    optimizer a module (with ``fused_optimizers``: one K-run
    ``FusedRMSprop`` and CPC's stacked Adam), the shared StepLR counters, a list of K plateau
    states a module, GradNorm weights (K, 2) and (K, 3), and the K
    generators."""
    first = states[0]

    def stack_model(*ls):
        if _shared(ls[0]):
            if any(not torch.equal(ls[0], other) for other in ls[1:]):
                raise ValueError("the runs' step counters differ")
            return ls[0].clone()
        return torch.stack([leaf.detach() for leaf in ls]).contiguous()

    params = tree_map(lambda *ls: torch.stack([leaf.detach() for leaf in ls]).requires_grad_(True),
                      *[s["params"] for s in states])
    if any(s["sched"] != first["sched"] for s in states):
        raise ValueError("the runs' StepLR counters differ")
    return {
        "params": params,
        "mstate": tree_map(stack_model, *[s["mstate"] for s in states]),
        "consts": tree_map(stack_model, *[s["consts"] for s in states]),
        "opt": {m: _stack_opt([s["opt"][m] for s in states], params, m) for m in first["opt"]},
        "sched": dict(first["sched"]),
        "plateau": {m: [s["plateau"][m] for s in states] for m in first["plateau"]},
        "gradnorm": {k: _stack_gradnorm([s["gradnorm"][k] for s in states])
                     for k in first["gradnorm"]},
        "generators": [s["generator"] for s in states],
    }


def unstack_state(states: Dict, i: int) -> Dict:
    """Run ``i`` of a stacked state as a one-run training state (copies):
    ``StyleTransferPipeline`` continues it, and ``state_to_flat`` writes it
    under every key of the JAX package's ``init_state``."""
    params = tree_map(lambda leaf: leaf[i].detach().clone().requires_grad_(True), states["params"])

    def one(leaf):
        return leaf.clone() if _shared(leaf) else leaf[i].clone()

    generator = torch.Generator()
    generator.set_state(states["generators"][i].get_state())
    return {
        "params": params,
        "mstate": tree_map(one, states["mstate"]),
        "consts": tree_map(one, states["consts"]),
        "opt": {m: unstack_fused(o, i, {n: params[n] for n in o.names})
                if isinstance(o, FusedRMSprop) else unstack_optimizer(o, i, leaves(params[m]))
                for m, o in states["opt"].items()},
        "sched": dict(states["sched"]),
        "plateau": {m: ps[i] for m, ps in states["plateau"].items()},
        "gradnorm": {k: _unstack_gradnorm(g, i) for k, g in states["gradnorm"].items()},
        "generator": generator,
    }


class MultiRunData:
    """K same-shaped dataset pairs stacked along a leading run axis.

    ``from_pairs`` takes K dicts with keys t_train/t_test/s_train/s_test,
    each an (x, y) tuple; all runs must share shapes (the same-dataset seed
    sweep).  ``broadcast`` gives every run the same pair."""

    def __init__(self, t_train, t_test, s_train, s_test):
        # each: (x (K, N, T, C), y (K, N)), numpy on the host
        self.t_train, self.t_test = t_train, t_test
        self.s_train, self.s_test = s_train, s_test
        self.n_runs = t_train[0].shape[0]

    @classmethod
    def from_pairs(cls, pairs):
        def gather(split):
            xs = np.stack([np.asarray(p[split][0], np.float32) for p in pairs])
            ys = np.stack([np.asarray(p[split][1]) for p in pairs])
            return xs, ys

        return cls(*(gather(s) for s in ("t_train", "t_test", "s_train", "s_test")))

    @classmethod
    def broadcast(cls, pair, n_runs: int):
        return cls.from_pairs([pair] * n_runs)


class MultiRunStylePipeline(ModuleSteps):
    """K-run wrapper around one ``StyleTransferPipeline`` definition, on its
    device."""

    def __init__(self, pipe: StyleTransferPipeline):
        self.pipe = pipe
        self.config = pipe.config
        self.base_lr = pipe.base_lr
        self.device = pipe.device

    # ------------------------------------------------------------ state ----

    def init_states(self, seeds: Sequence[int]) -> Dict:
        """Each run's ``init_state`` from its seed (exactly the state
        ``StyleTransferPipeline.run(seed=s)`` starts from), stacked."""
        return stack_states([self.pipe.init_state(torch.Generator().manual_seed(int(s)))
                             for s in seeds])

    @staticmethod
    def n_runs(states: Dict) -> int:
        return len(states["generators"])

    # ------------------------------------------------------- the transform --

    def _vmapped(self, forward, states: Dict, *batched):
        """``forward(params, mstate, consts, *batched)`` of every run at
        once: ``torch.func.vmap`` over the leading run axis of the stacked
        state and of ``batched``; the shared counters go in unbatched and
        come out once (``_collapse``)."""
        mstate = states["mstate"]
        m_dims = tree_map(lambda t: None if _shared(t) else 0, mstate)
        return torch.func.vmap(forward, in_dims=(0, m_dims, 0) + (0,) * len(batched))(
            states["params"], mstate, states["consts"], *batched)

    @staticmethod
    def _collapse(new_m: Dict) -> Dict:
        """The shared counters of a vmapped forward's model state, which
        vmap hands back once a run, back to one."""
        return tree_map(lambda t: t[0].clone() if _shared(t) else t, new_m)

    def _anchors(self, states: Dict, n: int, pinned: Optional[Sequence[int]]) -> torch.Tensor:
        """(K, n) CPC anchors: pinned for every run, or drawn from each
        run's generator in the single run's order."""
        if pinned is not None:
            rows = [list(pinned)[:n]] * self.n_runs(states)
        else:
            cpc = states["params"]["cpc"]  # the anchor's range: the number of heads
            rows = [[draw_anchor(cpc, g) for _ in range(n)] for g in states["generators"]]
        return torch.tensor(rows, dtype=torch.long, device=self.device)

    def _masks(self, states: Dict, batch: int, pinned=None):
        """The critic's dropout multipliers of every run, (K, B, hidden) each
        in the single run's nesting: pinned for every run, or drawn from
        each run's generator after its anchors, as ``cdan_loss`` draws them."""
        k = self.n_runs(states)
        if pinned is not None:
            return [[m.to(self.device).expand(k, *m.shape) for m in pair] for pair in pinned]
        hidden = states["params"]["ad"]["l1"]["weight"].shape[-1]
        per_run = [draw_dropout_masks(g, batch, hidden) for g in states["generators"]]
        return [[torch.stack([r[c][j] for r in per_run]).to(self.device) for j in range(2)]
                for c in range(2)]

    def _step_plateau(self, states: Dict, name: str, metrics: torch.Tensor) -> None:
        """One plateau update a run, from each run's metric; the stacked
        optimizer takes each run's learning rate."""
        o = self.config.optim
        ps = [plateau_step(p, v, factor=o.plateau_factor, min_lr=o.plateau_min_lr)
              for p, v in zip(states["plateau"][name], metrics.tolist())]
        states["plateau"][name] = ps
        self._set_module_lr(states, name, [p.lr for p in ps])

    def _train(self, states: Dict, losses: Dict, new_m: Dict, names) -> None:
        """The runs' summed total through the stacked leaves, each module's
        stacked optimizer stepped once."""
        self._train_step(states, losses["total"].sum(), self._collapse(new_m), names)

    # ------------------------------------------------------------ phases ---

    def _on_device(self, arrays) -> list:
        """An epoch's stacked host arrays (K, nb, B, ...) on the device, once."""
        return [torch.as_tensor(np.ascontiguousarray(a)).to(self.device) for a in arrays]

    def phase1_epoch(self, states: Dict, xb, yb, cpc_anchor: Optional[int] = None) -> Dict:
        """``StyleTransferPipeline.phase1_epoch`` of every run: xb (K, nb, B,
        T, C), yb (K, nb, B)."""
        pipe = self.pipe
        names = ("t_ext", "t_cls", "cpc")
        xb, yb = self._on_device((xb, yb))
        outs = []
        for j in range(xb.shape[1]):
            anchors = self._anchors(states, 1, None if cpc_anchor is None else (cpc_anchor,))
            losses, new_m = self._vmapped(pipe._phase1_forward, states, xb[:, j], yb[:, j].long(),
                                          anchors)
            self._train(states, losses, new_m, names)
            outs.append(detached(losses))
        self._step_steplr(states, names)
        return pipe._epoch_means(outs, ("t_c_loss", "t_sl_loss"))

    def phase2_epoch(self, states: Dict, xb, yb) -> Dict:
        pipe = self.pipe
        names = ("s_ext", "dim_uni", "s_cls")
        xb, yb = self._on_device((xb, yb))
        outs = []
        for j in range(xb.shape[1]):
            losses, new_m = self._vmapped(pipe._phase2_forward, states, xb[:, j], yb[:, j].long())
            self._train(states, losses, new_m, names)
            outs.append(detached(losses))
        self._step_steplr(states, names)
        return pipe._epoch_means(outs, ("s_c_loss",))

    def phase3_epoch(self, states: Dict, xt, yt, xs, ys, supervised: bool,
                     cpc_anchors: Optional[Sequence[int]] = None) -> Dict:
        pipe = self.pipe
        names = pipe._phase3_names(supervised)
        xt, yt, xs, ys = self._on_device((xt, yt, xs, ys))
        forward = functools.partial(pipe._phase3_forward, supervised=supervised)
        outs = []
        for j in range(xt.shape[1]):
            anchors = self._anchors(states, 2, cpc_anchors)
            losses, new_m = self._vmapped(forward, states, xt[:, j], yt[:, j].long(), xs[:, j],
                                          ys[:, j].long(), anchors)
            self._train(states, losses, new_m, names)
            outs.append(detached(losses))
        self._step_steplr(states, names)
        return pipe._epoch_means(outs, PHASE3_METRICS)

    def phase4_epoch(self, states: Dict, xt, yt, xs, ys, supervised: bool,
                     cpc_anchors: Optional[Sequence[int]] = None) -> Dict:
        pipe = self.pipe
        names, steplr = pipe._phase4_names(supervised)
        xt, yt, xs, ys = self._on_device((xt, yt, xs, ys))
        outs = []
        for j in range(xt.shape[1]):
            batch = (xt[:, j], yt[:, j].long(), xs[:, j], ys[:, j].long())
            if supervised:
                forward = functools.partial(pipe._phase4_forward, supervised=True)
                losses, new_m = self._vmapped(forward, states, *batch,
                                              self._anchors(states, 2, cpc_anchors))
            else:
                forward = functools.partial(pipe._phase4_forward, anchors=None, supervised=False)
                losses, new_m = self._vmapped(forward, states, *batch)
            self._train(states, losses, new_m, names)
            outs.append(detached(losses))
        self._step_steplr(states, steplr)
        self._step_plateau(states, "nf", pipe._phase4_plateau_metric(outs[-1]))
        return pipe._epoch_means(outs, PHASE4_METRICS)

    def phase5_grads(self, states: Dict, bt, lt, bs, ls, epoch: int,
                     cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None):
        """``StyleTransferPipeline.phase5_grads`` of every run, from (K, B,
        ...) batches: one vmapped forward and the pulls of the config's
        knobs (``_phase5_pulls(per_run=True)``), each through the stacked
        leaves.  Returns (losses (K,), new_m, feats,
        grads (K, ...) per module, n_t (K, 2), n_s (K, 3)).  Draws the anchors
        and then the dropout masks of every run unless pinned."""
        pipe = self.pipe
        anchors = self._anchors(states, 2, cpc_anchors)
        masks = self._masks(states, bt.shape[1], dropout_masks)

        def forward(params, mstate, consts, bt, lt, bs, ls, anchors, masks):
            return pipe._phase5_forward(params, mstate, consts, bt, lt, bs, ls, None, anchors,
                                        masks)

        losses, new_m, feats = self._vmapped(forward, states, bt, lt, bs, ls, anchors, masks)
        grads, n_t, n_s = pipe._phase5_pulls(states, losses, epoch, per_run=True)
        return losses, self._collapse(new_m), feats, grads, n_t, n_s

    def phase5_step(self, states: Dict, bt, lt, bs, ls, epoch: int,
                    cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None) -> Dict:
        """One joint step of every run; returns the losses (K,), detached."""
        losses, new_m, _, grads, n_t, n_s = self.phase5_grads(
            states, bt, lt, bs, ls, epoch, cpc_anchors, dropout_masks)
        self.pipe._phase5_update(states, losses, new_m, grads, n_t, n_s)
        return {k: v.detach() for k, v in losses.items()}

    def phase5_epoch(self, states: Dict, xt, yt, xs, ys, epoch: int,
                     cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None) -> Dict:
        xt, yt, xs, ys = self._on_device((xt, yt, xs, ys))
        steps = [self.phase5_step(states, xt[:, j], yt[:, j].long(), xs[:, j], ys[:, j].long(),
                                  epoch, cpc_anchors, dropout_masks)
                 for j in range(xt.shape[1])]
        self._step_steplr(states, PHASE5_STEPLR)
        last = steps[-1]
        for name, loss in PHASE5_PLATEAU:
            self._step_plateau(states, name, last[loss])
        metrics = {k: torch.stack([s[k] for s in steps]).mean(0) for k in last}
        metrics["gradnorm_w_t"] = states["gradnorm"]["t"].weights.clone()
        metrics["gradnorm_w_s"] = states["gradnorm"]["s"].weights.clone()
        return metrics

    # -------------------------------------------------------- evaluation ---

    def _accuracy(self, predict, states: Dict, x, y) -> np.ndarray:
        """Each run's accuracy of ``predict(params, mstate, batch)`` over x
        (K, N, T, C), in batches of ``batch_size`` whose last is padded by
        repeating each run's last series (the padded rows dropped)."""
        bsz = self.config.batch_size
        xs = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        preds = []
        with torch.inference_mode():
            for i in range(0, xs.shape[1], bsz):
                xe = xs[:, i : i + bsz]
                pad = bsz - xe.shape[1]
                if pad:
                    xe = torch.cat([xe, xe[:, -1:].expand(-1, pad, *xe.shape[2:])], 1)
                logits = torch.func.vmap(predict)(states["params"], self._batched_mstate(states),
                                                  xe.contiguous())
                preds.append(torch.argmax(logits, -1)[:, : bsz - pad])
        pred = torch.cat(preds, 1).cpu().numpy()
        return np.mean(pred == np.asarray(y), axis=1)

    def _batched_mstate(self, states: Dict) -> Dict:
        """The model state with every leaf batched (evaluation reads no counter)."""
        k = self.n_runs(states)
        return tree_map(lambda t: t.expand(k, *t.shape) if _shared(t) else t, states["mstate"])

    def _predict_target(self, params, mstate, x):
        feat, _ = self.pipe.target_features(params, mstate, x, False, fused_infer=True)
        return self.pipe.classify_target(params, mstate, feat, False, fused_infer=True)[0]

    def _predict_source(self, params, mstate, x):
        feat, _ = self.pipe.source_features(params, mstate, x, False, fused_infer=True)
        return self.pipe.classify_source(params, mstate, feat, False, fused_infer=True)[0]

    def evaluate_target(self, states: Dict, x, y) -> np.ndarray:
        """Each run's target accuracy on its x (K, N, T, C), y (K, N)."""
        return self._accuracy(self._predict_target, states, x, y)

    def evaluate_source(self, states: Dict, x, y) -> np.ndarray:
        return self._accuracy(self._predict_source, states, x, y)

    # ------------------------------------------------------ orchestration --

    def run(
        self,
        data: MultiRunData,
        seeds: Sequence[int],
        *,
        epochs: Optional[Dict[str, int]] = None,
        states: Optional[Dict] = None,
        eval_hook=None,
        verbose: bool = False,
        perms: Optional[Sequence[Iterable[np.ndarray]]] = None,
        cpc_anchors: Optional[Sequence[int]] = None,
        dropout_masks=None,
    ):
        """K full curricula at once; mirrors ``StyleTransferPipeline.run``
        with ``pretrain_eval_every=0``, as the JAX package's multirun does.

        Returns (stacked final states, history), each history record's
        metrics arrays with a leading K.  ``eval_hook(epoch, states, accs)``
        fires every ``eval_every`` phase-5 epochs.  ``perms``: per run, the
        batch permutations in the order the run draws them (each epoch's,
        the target's before the source's), instead of its ``seed + 1``
        generator's; ``cpc_anchors`` / ``dropout_masks`` pin those for every
        run, as the single run's epochs take them."""
        cfg = self.config
        seeds = [int(s) for s in seeds]
        if len(seeds) != data.n_runs:
            raise ValueError(f"{len(seeds)} seeds for {data.n_runs} runs")
        ep = {"p1": cfg.target_pretrain_epochs, "p2": cfg.source_pretrain_epochs,
              "p3": cfg.selfsup_epochs, "p4": cfg.nf_pretrain_epochs, "p5": cfg.joint_epochs}
        ep.update(epochs or {})
        if states is None:
            states = self.init_states(seeds)
        batch_gens = [torch.Generator().manual_seed(s + 1) for s in seeds]
        orders = [iter(p) for p in perms] if perms is not None else None
        history = []

        def log(phase, e, metrics):
            rec = {"phase": phase, "epoch": e}
            for k, v in metrics.items():
                rec[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            history.append(rec)
            if verbose:
                print({k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in rec.items()},
                      flush=True)

        def batches(split):
            x, y = split
            per_run = [epoch_batches(x[k], y[k], batch_gens[k], cfg.batch_size,
                                     perm=None if orders is None else next(orders[k]))
                       for k in range(data.n_runs)]
            return np.stack([b[0] for b in per_run]), np.stack([b[1] for b in per_run])

        def paired():
            xt, yt = batches(data.t_train)
            xs, ys = batches(data.s_train)
            nb = min(xt.shape[1], xs.shape[1])  # reference rounds_per_epoch
            return xt[:, :nb], yt[:, :nb], xs[:, :nb], ys[:, :nb]

        for e in range(ep["p1"]):
            anchor = None if cpc_anchors is None else cpc_anchors[0]
            log("p1", e, self.phase1_epoch(states, *batches(data.t_train), anchor))
        for e in range(ep["p2"]):
            log("p2", e, self.phase2_epoch(states, *batches(data.s_train)))
        for e in range(ep["p3"]):
            log("p3", e, self.phase3_epoch(states, *paired(), e % cfg.selfsup_supervised_every == 0,
                                           cpc_anchors))
        for e in range(ep["p4"]):
            log("p4", e, self.phase4_epoch(states, *paired(), e % cfg.nf_supervised_every == 0,
                                           cpc_anchors))
        for e in range(ep["p5"]):
            log("p5", e, self.phase5_epoch(states, *paired(), e, cpc_anchors, dropout_masks))
            if e % cfg.eval_every == 0:
                accs = {
                    "target_train_acc": self.evaluate_target(states, *data.t_train),
                    "target_test_acc": self.evaluate_target(states, *data.t_test),
                    "source_train_acc": self.evaluate_source(states, *data.s_train),
                    "source_test_acc": self.evaluate_source(states, *data.s_test),
                }
                log("p5_eval", e, accs)
                if eval_hook:
                    eval_hook(e, states, accs)
        return states, history

