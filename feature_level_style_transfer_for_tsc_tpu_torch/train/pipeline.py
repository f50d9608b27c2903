"""The five-phase feature-level style-transfer pipeline, and its served target.

Counterpart of the JAX package's ``train/pipeline.py`` (reference
``train_and_test.py:22-798``):

* ``StyleTransferPipeline`` trains the curriculum: 1 target pretrain
  (CE_t + CPC_t), 2 source pretrain (CE_s through DimensionUnification),
  3 self-supervised (CPC_t + CPC_s, + 0.8 CE_t + 1.2 CE_s every 50th epoch),
  4 NF pretrain (flow NLL on detached features, joint with 5 CE + 3 CPC every
  75th epoch), 5 joint adversarial (GradNorm-weighted NF + CE + s2t2s losses
  and epoch-staged CDAN / WGAN-critic / CPC terms, WGAN clipping);
* ``TargetPredictor`` serves the target extractor + classifier of a state.

PyTorch idiom inside: each phase-epoch is a Python loop over stacked
batches; parameters are leaf tensors updated in place by one torch optimizer
per module (``fused_optimizers``: one ``FusedRMSprop`` for the RMSprop
modules, and CPC's Adam); BatchNorm statistics, NoiseTransfer averages and
critic counters are explicit state under the JAX package's keys.  Phase 5
runs ONE forward and takes the GradNorm trunk gradients with
``torch.autograd.grad`` on the loss vector ``[total, t_nf, t_c, s_nf, s_c,
s2t2s_c]`` seeded one-hot, merged as the JAX package merges them
(``merged_pullbacks``, the default): total; t_nf + s_nf; t_c + s_c;
s2t2s_c.  Each pull names only the seeded losses as outputs, so autograd
walks only their ancestors (the JAX package gets that from dead-code
elimination of the zero seeds).  Unmerged, the total and each GradNorm loss
are pulled alone; ``stacked_pullbacks`` pulls the total, t_nf + s_nf and
s2t2s_c as one backward under a batch of cotangents (``batched_pull``).

Randomness (batch order, CPC anchors, CDAN dropout) comes from
``torch.Generator``s; the anchors and dropout masks can be pinned per call.

Each phase's step is a pure forward ``_phaseN_forward(params, mstate,
consts, batch..., anchors[, masks]) -> (losses, new mstate)`` that draws
nothing; the epoch draws the anchors (and phase 5 the dropout masks) and
takes the gradient.  ``train/multirun.py`` runs the same forwards under
``torch.func.vmap`` over K stacked runs.

The flow's coupling nets are reached only through ``waveglow_forward_pair``
(phases 4 and 5) and ``waveglow_infer`` (phase 5's s2t pass), which call
``models.flow.wn_apply`` per flow step.  It picks its route per call, as
the JAX package does: ``FLSTTSC_WN_FUSED=0`` runs the WN op by op (the gate
kernel in every layer, and under ``FLSTTSC_CONV_IMPL=pallas`` the tap-conv
kernel for each dilated conv), so both variables take effect in
``cli.main`` without a flag of its own; so does ``FLSTTSC_WN_MXU=bf16``
(the fused WN's products on bf16 operands).  ``PipelineConfig.compute_dtype
= "bfloat16"``, which no CLI sets, runs the OS-CNN convs in bf16
(``models/os_cnn.py``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.batching import epoch_batches
from ..losses.cdan import cdan_loss
from ..losses.classification import cross_entropy
from ..losses.gradnorm import gradnorm_init, gradnorm_step
from ..losses.wgan import wgan_loss
from ..models.adapters import (
    dimension_unification_apply,
    dimension_unification_init,
    noise_transfer_apply,
    noise_transfer_init,
    prob_transfer_apply,
    prob_transfer_init,
)
from ..models.cpc import cpc_apply, cpc_apply_pair, cpc_init, draw_anchor
from ..models.critics import (
    ad_net_init,
    feature_discriminator_apply,
    feature_discriminator_init,
    random_layer_init,
)
from ..models.flow import waveglow_forward_pair, waveglow_infer, waveglow_init, waveglow_loss
from ..models.os_cnn import (
    os_block_masks,
    os_cnn_apply,
    os_cnn_head,
    os_cnn_init,
    os_cnn_res_apply,
    os_cnn_res_init,
)
from ..ops import resolve_device
from ..ops.collectives import all_reduce_grads, reduce_values
from ..structure import total_out_channels
from . import jax_state
from .classifier import build_specs
from .optim import FusedRMSprop, clip_params, make_adam, make_rmsprop, plateau_init, plateau_step
from .steps import ModuleSteps, batched_argmax, detached, leaves

#: checkpoint key prefixes of the target model within a full pipeline state
TARGET_PREFIXES = (
    "['params']['t_ext']", "['params']['t_cls']",
    "['mstate']['t_ext']", "['mstate']['t_cls']",
)
STEPLR_MODULES = ("t_ext", "t_cls", "s_ext", "dim_uni", "s_cls", "noise", "cpc")
PLATEAU_MODULES = ("prob_trans", "nf", "ad", "fd")
ALL_MODULES = ("t_ext", "t_cls", "s_ext", "dim_uni", "s_cls", "prob_trans",
               "nf", "noise", "ad", "fd", "cpc")
#: the modules stepped by RMSprop, fused into one update under ``fused_optimizers``
RMS_MODULES = tuple(n for n in ALL_MODULES if n != "cpc")
#: the metrics of a phase-3 and a phase-4 epoch, in the JAX package's order
PHASE3_METRICS = ("t_c_loss", "t_sl_loss", "s_c_loss", "s_sl_loss")
PHASE4_METRICS = ("t_nf_loss", "s_nf_loss", "t_c_loss", "s_c_loss")
#: the losses GradNorm weighs: the target group, then the source group
GRADNORM_LOSSES = ("t_nf", "t_c", "s_nf", "s_c", "s2t2s_c")
#: phase 5's StepLR modules, and its plateau modules with the loss each reads
#: (the epoch's last step's)
PHASE5_STEPLR = ("t_ext", "t_cls", "cpc", "s_ext", "dim_uni", "s_cls", "noise")
PHASE5_PLATEAU = (("prob_trans", "s2t2s_c"), ("nf", "t_nf"), ("ad", "cdan"), ("fd", "fd"))
#: the feature sets dumped for t-SNE (reference train_and_test.py:792-797)
FEATURE_KEYS = ("t_feat", "s2t_feat", "s_feat", "s_pool", "t2s_pool", "s2t2s_pool")


def batched_pull(outputs: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor],
                 cotangents: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """ONE backward of ``outputs`` under a batch of cotangents (each (N,
    *output.shape)): the gradient of every input, (N, *input.shape), zero
    where an input is unused; the graph is kept.  The counterpart of JAX's
    ``jax.vmap(pullback)``: ``torch.func.vmap`` over ``torch.autograd.grad``,
    so each node's backward runs once on the batch, and the kernels'
    backward Functions take it through their vmap rules (one run-axis
    launch for the N cotangents).  ``torch.autograd.grad(...,
    is_grads_batched=True)`` would not do: it batches with the legacy vmap,
    which runs a Function's forward on its batched tensors and never reaches
    its vmap rule."""
    def pull(*gs):
        return torch.autograd.grad(outputs, inputs, gs, retain_graph=True, allow_unused=True,
                                   materialize_grads=True)

    return list(torch.func.vmap(pull)(*cotangents))


def _batch(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype).to(device)


class TargetPredictor:
    """The target extractor + classifier of a pipeline, served on ``device``."""

    def __init__(
        self,
        target_channels: int,
        target_length: int,
        target_classes: int,
        config: Optional[PipelineConfig] = None,
        device="cuda",
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self.t_shape = (target_channels, target_length, target_classes)
        self.t_ext_specs, self.cls_specs = build_specs(
            target_channels, target_length, self.config
        )
        self.t_ext_masks = os_block_masks(self.t_ext_specs, self.device)
        self.cls_masks = os_block_masks(self.cls_specs, self.device)
        # the OS-CNN convs' dtype (None: f32), as JAX train/pipeline.py:120-122
        self.compute_dtype = torch.bfloat16 if self.config.compute_dtype == "bfloat16" else None

    def init_state(self, generator: torch.Generator) -> Dict:
        t_ext_p, t_ext_s = os_cnn_res_init(generator, self.t_ext_specs, self.device)
        t_cls_p, t_cls_s = os_cnn_init(generator, self.cls_specs, self.t_shape[2], self.device)
        return {
            "params": {"t_ext": t_ext_p, "t_cls": t_cls_p},
            "mstate": {"t_ext": t_ext_s, "t_cls": t_cls_s},
        }

    def target_features(self, params, mstate, x, training: bool, fused_infer: bool = False):
        """(feature, new state)."""
        return os_cnn_res_apply(
            params["t_ext"], mstate["t_ext"], self.t_ext_masks, x, training,
            compute_dtype=self.compute_dtype, fused_infer=fused_infer,
        )

    def classify_target(self, params, mstate, feat, training: bool, fused_infer: bool = False):
        """(logits, pooled, new state)."""
        return os_cnn_apply(
            params["t_cls"], mstate["t_cls"], self.cls_masks, feat, training,
            compute_dtype=self.compute_dtype, fused_infer=fused_infer,
        )

    @torch.inference_mode()
    def predict_logits(self, params, mstate, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's ``_predict_target``: no grad, so the folded-BN
        conv epilogue (and with ``FLSTTSC_FUSE_EPILOGUE=1`` the fused kernel)
        is safe."""
        feat, _ = self.target_features(params, mstate, x, False, fused_infer=True)
        logits, _, _ = self.classify_target(params, mstate, feat, False, fused_infer=True)
        return logits

    def predict_target(self, state: Dict, x: np.ndarray) -> np.ndarray:
        """Argmax class predictions in batches of ``config.batch_size``."""
        return batched_argmax(self.predict_logits, state["params"], state["mstate"], x,
                              self.config.batch_size, self.device)


class StyleTransferPipeline(TargetPredictor, ModuleSteps):
    """The paired target/source model stack and its five training phases."""

    def __init__(
        self,
        target_channels: int,
        target_length: int,
        target_classes: int,
        source_channels: int,
        source_length: int,
        source_classes: int,
        config: Optional[PipelineConfig] = None,
        device="cuda",
    ):
        super().__init__(target_channels, target_length, target_classes, config, device)
        cfg = self.config
        self.s_shape = (source_channels, source_length, source_classes)
        self.feat_channels = total_out_channels(self.t_ext_specs[-1])
        self.s_ext_specs = build_specs(source_channels, source_length, cfg)[0]
        self.s_feat_channels = total_out_channels(self.s_ext_specs[-1])
        self.s_ext_masks = os_block_masks(self.s_ext_specs, self.device)
        self.log_s_clamp = float(cfg.log_s_clamp)
        o = cfg.optim
        self.base_lr = {
            "t_ext": o.lr_target_ext, "t_cls": o.lr_target_cls, "s_ext": o.lr_source_ext,
            "dim_uni": o.lr_dim_uni, "s_cls": o.lr_source_cls, "prob_trans": o.lr_prob_trans,
            "nf": o.lr_nf, "noise": o.lr_noise_trans, "ad": o.lr_ad_net,
            "fd": o.lr_feat_disc, "cpc": o.lr_cpc,
        }

    # ------------------------------------------------------------ state ----

    def init_models(self, generator: torch.Generator) -> Dict:
        """Params, model state and constants under the JAX package's keys."""
        cfg, dev = self.config, self.device
        (_, t_t, n_t), (_, t_s, n_s) = self.t_shape, self.s_shape
        t_ext_p, t_ext_s = os_cnn_res_init(generator, self.t_ext_specs, dev)
        t_cls_p, t_cls_s = os_cnn_init(generator, self.cls_specs, n_t, dev)
        s_ext_p, s_ext_s = os_cnn_res_init(generator, self.s_ext_specs, dev)
        dim_uni_p = dimension_unification_init(
            generator, self.s_feat_channels, self.feat_channels, t_s, t_t, dev
        )
        s_cls_p, s_cls_s = os_cnn_init(generator, self.cls_specs, n_s, dev)
        prob_trans_p = prob_transfer_init(generator, self.feat_channels, dev)
        nf_p = waveglow_init(generator, cfg.flow.n_flows, self.feat_channels,
                             cfg.flow.wn_channels, cfg.flow.wn_layers, dev)
        noise_p, noise_s = noise_transfer_init(generator, self.feat_channels, t_t, dev)
        ad_p, ad_s = ad_net_init(generator, cfg.cdan_dim, 1024, dev)
        fd_p, fd_s = feature_discriminator_init(generator, self.feat_channels, dev)
        cpc_p = cpc_init(generator, self.feat_channels, cfg.cpc_hidden, t_t // 2, dev)
        random_layer = random_layer_init(generator, [self.feat_channels * t_t, n_t],
                                         cfg.cdan_dim, dev)
        return {
            "params": {
                "t_ext": t_ext_p, "t_cls": t_cls_p, "s_ext": s_ext_p, "dim_uni": dim_uni_p,
                "s_cls": s_cls_p, "prob_trans": prob_trans_p, "nf": nf_p, "noise": noise_p,
                "ad": ad_p, "fd": fd_p, "cpc": cpc_p,
            },
            "mstate": {
                "t_ext": t_ext_s, "t_cls": t_cls_s, "s_ext": s_ext_s, "s_cls": s_cls_s,
                "noise": noise_s, "ad": ad_s, "fd": fd_s,
            },
            "consts": {"random_layer": random_layer},
        }

    def training_state(self, models: Dict, seed: int) -> Dict:
        """``models`` (params, mstate, consts) plus what training carries:
        one optimizer per module over its parameter tensors (made leaves that
        require grad; with ``fused_optimizers`` one ``FusedRMSprop`` for the
        RMSprop modules, under ``"fused"``, and CPC's Adam), StepLR counters, plateau states, GradNorm weights and
        the generator of CPC anchors and CDAN dropout."""
        g = self.config.gradnorm
        params = models["params"]
        for p in leaves(params):
            p.requires_grad_(True)
        if self.config.fused_optimizers:  # JAX train/pipeline.py:198-205
            opt = {"fused": FusedRMSprop({n: params[n] for n in RMS_MODULES},
                                         {n: self.base_lr[n] for n in RMS_MODULES}),
                   "cpc": make_adam(leaves(params["cpc"]), self.base_lr["cpc"])}
        else:
            opt = {
                name: (make_adam if name == "cpc" else make_rmsprop)(leaves(params[name]),
                                                                     self.base_lr[name])
                for name in ALL_MODULES
            }
        return {
            "params": params,
            "mstate": models["mstate"],
            "consts": models["consts"],
            "opt": opt,
            "sched": {name: 0 for name in STEPLR_MODULES},
            "plateau": {name: plateau_init(self.base_lr[name]) for name in PLATEAU_MODULES},
            "gradnorm": {
                "t": gradnorm_init(g.weights_t_init, g.lr_weights_t, self.device),
                "s": gradnorm_init(g.weights_s_init, g.lr_weights_s, self.device),
            },
            "generator": torch.Generator().manual_seed(seed),
        }

    def init_state(self, generator: torch.Generator) -> Dict:
        return self.training_state(self.init_models(generator), int(generator.initial_seed()) + 1)

    # ------------------------------------------ the JAX package's layout ---

    def state_to_flat(self, state: Dict) -> Dict[str, np.ndarray]:
        """``state`` as ``{keystr: array}`` under every key of the JAX
        package's ``init_state`` (``jax_state.state_to_flat``)."""
        return jax_state.state_to_flat(state)

    def state_from_flat(self, flat: Mapping[str, np.ndarray]) -> Dict:
        """A fresh ``init_state`` of the config's seed filled from ``flat``,
        a file of either package (``jax_state.load_state``), as the JAX
        package's restore fills its ``init_state`` template."""
        return jax_state.load_state(self.init_state(torch.Generator().manual_seed(self.config.seed)),
                                    flat)

    # ----------------------------------------------- forward building blocks

    def source_features(self, params, mstate, x, training: bool, fused_infer: bool = False):
        """s_ext + DimensionUnification -> target-shaped features."""
        feat, new_s = os_cnn_res_apply(
            params["s_ext"], mstate["s_ext"], self.s_ext_masks, x, training,
            compute_dtype=self.compute_dtype, fused_infer=fused_infer,
        )
        return dimension_unification_apply(params["dim_uni"], feat), new_s

    def classify_source(self, params, mstate, feat, training: bool, fused_infer: bool = False):
        return os_cnn_apply(
            params["s_cls"], mstate["s_cls"], self.cls_masks, feat, training,
            compute_dtype=self.compute_dtype, fused_infer=fused_infer,
        )

    # ---------------------------------------------------- optimizer steps --

    def _step_plateau(self, state: Dict, name: str, metric: float) -> None:
        o = self.config.optim
        ps = plateau_step(state["plateau"][name], metric, factor=o.plateau_factor,
                          min_lr=o.plateau_min_lr)
        state["plateau"][name] = ps
        self._set_module_lr(state, name, ps.lr)

    # ------------------------------------------------------------ phases ---

    @staticmethod
    def _epoch_means(outs: Sequence[Dict], keys: Sequence[str]) -> Dict:
        """Each key's mean over an epoch's steps (leading run axes kept)."""
        m = torch.stack([torch.stack([o[k] for k in keys]) for o in outs]).mean(0)
        return {k: m[i] for i, k in enumerate(keys)}

    def _phase1_forward(self, params, mstate, consts, x, y, anchors):
        """Target pretrain step (reference :141-180): CE_t + CPC_t."""
        feat, t_ext_s = self.target_features(params, mstate, x, True)
        sl = cpc_apply(params["cpc"], feat, anchors[0])
        logits, _, t_cls_s = self.classify_target(params, mstate, feat, True)
        ce = cross_entropy(logits, y)
        losses = {"t_c_loss": ce, "t_sl_loss": sl, "total": ce + sl}
        return losses, {**mstate, "t_ext": t_ext_s, "t_cls": t_cls_s}

    def phase1_epoch(self, state: Dict, xb, yb, cpc_anchor: Optional[int] = None) -> Dict:
        """Target pretrain (reference :141-180): CE_t + CPC_t."""
        names = ("t_ext", "t_cls", "cpc")
        outs = []
        for x, y in zip(xb, yb):
            x, y = _batch(x, self.device), _batch(y, self.device, torch.long)
            anchor = (draw_anchor(state["params"]["cpc"], state["generator"]) if cpc_anchor is None
                      else cpc_anchor)
            losses, new_m = self._phase1_forward(state["params"], state["mstate"], state["consts"],
                                                 x, y, (anchor,))
            self._train_step(state, losses["total"], new_m, names)
            outs.append(detached(losses))
        self._step_steplr(state, names)
        return reduce_values(self._epoch_means(outs, ("t_c_loss", "t_sl_loss")))

    def _phase2_forward(self, params, mstate, consts, x, y):
        """Source pretrain step (reference :181-220): CE_s."""
        feat, s_ext_s = self.source_features(params, mstate, x, True)
        logits, _, s_cls_s = self.classify_source(params, mstate, feat, True)
        ce = cross_entropy(logits, y)
        return {"s_c_loss": ce, "total": ce}, {**mstate, "s_ext": s_ext_s, "s_cls": s_cls_s}

    def phase2_epoch(self, state: Dict, xb, yb) -> Dict:
        """Source pretrain (reference :181-220): CE_s."""
        names = ("s_ext", "dim_uni", "s_cls")
        outs = []
        for x, y in zip(xb, yb):
            x, y = _batch(x, self.device), _batch(y, self.device, torch.long)
            losses, new_m = self._phase2_forward(state["params"], state["mstate"], state["consts"],
                                                 x, y)
            self._train_step(state, losses["total"], new_m, names)
            outs.append(detached(losses))
        self._step_steplr(state, names)
        return reduce_values(self._epoch_means(outs, ("s_c_loss",)))

    def _both_sides(self, params, mstate, bt, lt, bs, ls, anchors):
        """The supervised joint forward of phases 3 and 4."""
        new_m = dict(mstate)
        t_feat, new_m["t_ext"] = self.target_features(params, mstate, bt, True)
        t_logits, _, new_m["t_cls"] = self.classify_target(params, mstate, t_feat, True)
        s_feat, new_m["s_ext"] = self.source_features(params, mstate, bs, True)
        t_sl, s_sl = cpc_apply_pair(params["cpc"], t_feat, s_feat, anchors=anchors)
        s_logits, _, new_m["s_cls"] = self.classify_source(params, mstate, s_feat, True)
        return t_feat, s_feat, cross_entropy(t_logits, lt), t_sl, cross_entropy(s_logits, ls), s_sl, new_m

    @staticmethod
    def _pair_anchors(state: Dict, cpc_anchors):
        """Phases 3-5's two CPC anchors: pinned, or drawn from the state's
        generator (target first)."""
        if cpc_anchors is not None:
            return cpc_anchors
        g = state["generator"]
        return draw_anchor(state["params"]["cpc"], g), draw_anchor(state["params"]["cpc"], g)

    def _phase3_forward(self, params, mstate, consts, bt, lt, bs, ls, anchors, supervised: bool):
        """Joint self-supervised step (reference :221-363): CPC_t + CPC_s,
        plus 0.8 CE_t + 1.2 CE_s when supervised."""
        _, _, t_ce, t_sl, s_ce, s_sl, new_m = self._both_sides(params, mstate, bt, lt, bs, ls,
                                                               anchors)
        total = t_sl + s_sl + (0.8 * t_ce + 1.2 * s_ce if supervised else 0.0)
        losses = {"t_c_loss": t_ce, "t_sl_loss": t_sl, "s_c_loss": s_ce, "s_sl_loss": s_sl,
                  "total": total}
        return losses, new_m

    @staticmethod
    def _phase3_names(supervised: bool):
        return (("t_ext", "t_cls", "cpc", "s_ext", "dim_uni", "s_cls") if supervised
                else ("t_ext", "cpc", "s_ext", "dim_uni"))

    def phase3_epoch(self, state: Dict, xt, yt, xs, ys, supervised: bool,
                     cpc_anchors: Optional[Sequence[int]] = None) -> Dict:
        """Joint self-supervised (reference :221-363): CPC_t + CPC_s, plus
        0.8 CE_t + 1.2 CE_s when supervised (heads frozen otherwise)."""
        names = self._phase3_names(supervised)
        outs = []
        for bt, lt, bs, ls in zip(xt, yt, xs, ys):
            bt, bs = _batch(bt, self.device), _batch(bs, self.device)
            lt, ls = _batch(lt, self.device, torch.long), _batch(ls, self.device, torch.long)
            losses, new_m = self._phase3_forward(
                state["params"], state["mstate"], state["consts"], bt, lt, bs, ls,
                self._pair_anchors(state, cpc_anchors), supervised,
            )
            self._train_step(state, losses["total"], new_m, names)
            outs.append(detached(losses))
        self._step_steplr(state, names)
        return reduce_values(self._epoch_means(outs, PHASE3_METRICS))

    def _phase4_forward(self, params, mstate, consts, bt, lt, bs, ls, anchors, supervised: bool):
        """NF pretrain step (reference :374-494): the flow NLL on detached
        features, or joint with 5 CE + 3 CPC when supervised."""
        if supervised:
            t_feat, s_feat, t_ce, t_sl, s_ce, s_sl, new_m = self._both_sides(
                params, mstate, bt, lt, bs, ls, anchors
            )
        else:
            new_m = dict(mstate)
            t_feat, new_m["t_ext"] = self.target_features(params, mstate, bt, True)
            s_feat, new_m["s_ext"] = self.source_features(params, mstate, bs, True)
            t_feat, s_feat = t_feat.detach(), s_feat.detach()
        t_out, s_out = waveglow_forward_pair(params["nf"], t_feat, s_feat,
                                             self.config.flow.wn_channels, self.log_s_clamp)
        t_nf, s_nf = waveglow_loss(t_out), waveglow_loss(s_out)
        if supervised:
            total = t_nf + s_nf + 5 * t_ce + 5 * s_ce + 3 * t_sl + 3 * s_sl
        else:
            t_ce = s_ce = torch.zeros_like(t_nf)
            total = t_nf + s_nf
        losses = {"t_nf_loss": t_nf, "s_nf_loss": s_nf, "t_c_loss": t_ce, "s_c_loss": s_ce,
                  "total": total}
        return losses, new_m

    @staticmethod
    def _phase4_names(supervised: bool):
        """(modules stepped, modules whose StepLR counts the epoch)."""
        # the reference also steps t_ext/s_ext/dim_uni in the unsupervised
        # branch, but their grads are None after the detach (:483-489)
        if supervised:
            return (("t_ext", "t_cls", "s_ext", "dim_uni", "s_cls", "nf", "cpc"),
                    ("t_ext", "t_cls", "s_ext", "dim_uni", "s_cls", "cpc"))
        return ("nf",), ("t_ext", "s_ext", "dim_uni")

    @staticmethod
    def _phase4_plateau_metric(last: Dict):
        """The nf plateau steps with the LAST batch's total (:444,:494); under
        a data-parallel group the caller passes the global losses, so every
        rank's scheduler moves alike."""
        return last["t_nf_loss"] + last["s_nf_loss"] + 5 * last["t_c_loss"] + 5 * last["s_c_loss"]

    def phase4_epoch(self, state: Dict, xt, yt, xs, ys, supervised: bool,
                     cpc_anchors: Optional[Sequence[int]] = None) -> Dict:
        """NF pretrain (reference :374-494): the flow NLL on detached
        features, or joint with 5 CE + 3 CPC when supervised."""
        names, steplr = self._phase4_names(supervised)
        outs = []
        for bt, lt, bs, ls in zip(xt, yt, xs, ys):
            bt, bs = _batch(bt, self.device), _batch(bs, self.device)
            lt, ls = _batch(lt, self.device, torch.long), _batch(ls, self.device, torch.long)
            anchors = self._pair_anchors(state, cpc_anchors) if supervised else None
            losses, new_m = self._phase4_forward(state["params"], state["mstate"], state["consts"],
                                                 bt, lt, bs, ls, anchors, supervised)
            self._train_step(state, losses["total"], new_m, names)
            outs.append(detached(losses))
        self._step_steplr(state, steplr)
        self._step_plateau(state, "nf", float(self._phase4_plateau_metric(reduce_values(outs[-1]))))
        return reduce_values(self._epoch_means(outs, PHASE4_METRICS))

    def _phase5_forward(self, params, mstate, consts, bt, lt, bs, ls,
                        generator: Optional[torch.Generator] = None,
                        cpc_anchors: Optional[Sequence[int]] = None,
                        dropout_masks=None):
        """The full hot-loop forward (reference :539-621): every loss, the
        new model state and the feature sets.  ``cpc_anchors`` and
        ``dropout_masks`` (the critic's multipliers: target call, s2t call,
        two each) pin the randomness."""
        wn_ch = self.config.flow.wn_channels
        new_m = dict(mstate)
        t_feat, new_m["t_ext"] = self.target_features(params, mstate, bt, True)
        s_feat, new_m["s_ext"] = self.source_features(params, mstate, bs, True)
        t_sl, s_sl = cpc_apply_pair(params["cpc"], t_feat, s_feat, generator, cpc_anchors)
        t_nf_out, s_nf_out = waveglow_forward_pair(params["nf"], t_feat, s_feat, wn_ch,
                                                   self.log_s_clamp)
        t_nf_loss, s_nf_loss = waveglow_loss(t_nf_out), waveglow_loss(s_nf_out)
        s2t_noise, new_m["noise"] = noise_transfer_apply(
            params["noise"], mstate["noise"], t_nf_out[0], s_nf_out[0]
        )
        s2t_feat = waveglow_infer(params["nf"], s2t_noise, wn_ch, log_s_clamp=self.log_s_clamp)
        t_logits, t_pool, new_m["t_cls"] = self.classify_target(params, mstate, t_feat, True)
        # eval-mode s2t pass on the running stats JUST updated by the target
        # pass, as the reference's in-place BatchNorm sees them (:583-586)
        s2t_logits, s2t_pool, _ = self.classify_target(params, new_m, s2t_feat, False)
        s_logits, s_pool, new_m["s_cls"] = self.classify_source(params, mstate, s_feat, True)
        cdan, new_m["ad"] = cdan_loss(
            params["ad"], mstate["ad"], t_feat, s2t_feat, t_logits, s2t_logits,
            random_layer=consts["random_layer"], training=True, generator=generator,
            dropout_masks=dropout_masks,
        )
        t2s_pool = prob_transfer_apply(params["prob_trans"], t_pool)
        s2t2s_pool = prob_transfer_apply(params["prob_trans"], s2t_pool)
        s2t2s_logits = os_cnn_head(params["s_cls"], s2t2s_pool)
        fd_t, fd_state = feature_discriminator_apply(params["fd"], mstate["fd"], t2s_pool,
                                                     training=True)
        fd_s2t2s, fd_state = feature_discriminator_apply(params["fd"], fd_state, s2t2s_pool,
                                                         training=True)
        fd_src, new_m["fd"] = feature_discriminator_apply(params["fd"], fd_state, s_pool,
                                                          training=True)
        losses = {
            "t_nf": t_nf_loss, "s_nf": s_nf_loss,
            "t_c": cross_entropy(t_logits, lt), "s_c": cross_entropy(s_logits, ls),
            "t_sl": t_sl, "s_sl": s_sl, "cdan": cdan,
            "s2t2s_c": cross_entropy(s2t2s_logits, ls), "fd": wgan_loss(fd_t, fd_s2t2s, fd_src),
        }
        feats = {
            "t_feat": t_feat, "s2t_feat": s2t_feat, "s_feat": s_feat,
            "s_pool": s_pool, "t2s_pool": t2s_pool, "s2t2s_pool": s2t2s_pool,
        }
        return losses, new_m, feats

    @staticmethod
    def _staged_weights(epoch: int) -> List[float]:
        """Epoch-staged adversarial/CPC coefficients (reference :665-672)."""
        stages = ([3.0, 3.0, 2.0, 2.0], [2.0, 3.0, 1.8, 1.5],
                  [1.5, 2.0, 1.8, 1.8], [1.5, 1.5, 2.5, 2.5])
        return stages[sum(epoch >= e for e in (12, 24, 50))]

    def phase5_grads(self, state: Dict, bt, lt, bs, ls, epoch: int,
                     cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None):
        """One forward and the pulls of a phase-5 step (``_phase5_pulls``).

        Returns (losses, new_m, feats, grads of the total per module, n_t
        (2,), n_s (3,)): ``n_t`` from the t_nf+t_c pulls on the t_ext trunk,
        ``n_s`` from the s_nf+s_c and s2t2s_c pulls on the s_ext trunk.
        Under a data-parallel group (``parallel/dp.py``) the forward's
        losses are the rank's contributions: each pull's gradients are
        summed over the ranks before the norms are taken, and the losses
        returned are the global values, detached."""
        losses, new_m, feats = self._phase5_forward(
            state["params"], state["mstate"], state["consts"], bt, lt, bs, ls, state["generator"],
            cpc_anchors, dropout_masks,
        )
        pulls = self._phase5_pulls(state, losses, epoch)
        return (reduce_values(losses), new_m, feats) + pulls

    def _phase5_pulls(self, state: Dict, losses: Dict, epoch: int, per_run: bool = False):
        """The weighted total's gradients per module and the GradNorm trunk
        norms (n_t, n_s) of ``losses``.  ``per_run``: the losses are (K,),
        one a run of stacked parameters (``train/multirun.py``); the total is
        their sum, whose gradient in each run's slice is that run's (the runs
        share nothing), and each norm is taken per run, over every axis but
        the first.

        The pulls follow the config's knobs, as JAX ``train/pipeline.py:
        700-752`` takes them: ``merged_pullbacks`` (default) pulls the total,
        t_nf + s_nf, t_c + s_c and s2t2s_c (the cross-trunk gradients of the
        merged pairs are structurally zero); unmerged, the total and each of
        the five GradNorm losses alone; ``stacked_pullbacks`` (merged only)
        pulls the total, t_nf + s_nf and s2t2s_c as ONE backward under a
        batch of three cotangents (``batched_pull``, the cotangent axis in
        front of any run axis), and t_c + s_c alone, which reaches only the
        classifiers' ancestors.

        Under a data-parallel group (``parallel/dp.py``) every pull's
        gradients are summed over the ranks before the norms and the
        updates (``all_reduce_grads``; the stacked pull's (3, ...) gradients
        in one collective), and a batched pull's cotangents pass the
        collectives' vmap rules (``ops/collectives.py``); every rank runs
        the same pulls in the same order."""
        cfg = self.config
        params = state["params"]
        gn = state["gradnorm"]
        loss_t = torch.stack([losses["t_nf"], losses["t_c"]], dim=-1)
        loss_s = torch.stack([losses["s_nf"], losses["s_c"], losses["s2t2s_c"]], dim=-1)
        w = self._staged_weights(epoch)
        total = (
            torch.sum(gn["t"].weights.clone() * loss_t, dim=-1)
            + torch.sum(gn["s"].weights.clone() * loss_s, dim=-1)
            + w[0] * losses["cdan"] + w[1] * losses["fd"] + w[2] * losses["t_sl"]
            + w[3] * losses["s_sl"]
        ).sum()
        t_trunk = leaves(params["t_ext"]["block"])
        s_trunk = leaves(params["s_ext"]["block"])

        def norm(x):
            if not per_run:
                return torch.linalg.vector_norm(x)
            return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)

        def trunk_norm(g):
            return sum(norm(x) for x in g if x is not None)

        def norms(outputs, trunks, retain=True):
            outputs = [o.sum() for o in (outputs if isinstance(outputs, list) else [outputs])]
            g = all_reduce_grads(torch.autograd.grad(outputs, [p for t in trunks for p in t],
                                                     retain_graph=retain, allow_unused=True))
            out, j = [], 0
            for t in trunks:
                out.append(trunk_norm(g[j : j + len(t)]))
                j += len(t)
            return out

        if not cfg.merged_pullbacks:
            # six pulls: the total, then each GradNorm loss alone on its trunk
            grads = self._grads(total, state, ALL_MODULES, retain_graph=True)
            n_t = [norms(losses[k], (t_trunk,))[0] for k in ("t_nf", "t_c")]
            n_s = [norms(losses[k], (s_trunk,), retain=k != "s2t2s_c")[0]
                   for k in ("s_nf", "s_c", "s2t2s_c")]
        elif cfg.stacked_pullbacks:
            named = [leaves(params[n]) for n in ALL_MODULES]
            flat = [p for ps in named for p in ps]
            # seeds of [total, t_nf, s_nf, s2t2s_c], one row a pull: e_total;
            # e_t_nf + e_s_nf; e_s2t2s_c
            seeds = torch.eye(3, device=total.device)[:, [0, 1, 1, 2]]
            outputs = [total, losses["t_nf"], losses["s_nf"], losses["s2t2s_c"]]
            cotangents = [seeds[:, j].reshape(3, *([1] * o.dim())).expand(3, *o.shape)
                          for j, o in enumerate(outputs)]
            g = all_reduce_grads(batched_pull(outputs, flat, cotangents))
            grads, i = {}, 0
            for n, ps in zip(ALL_MODULES, named):
                grads[n] = [x[0] for x in g[i : i + len(ps)]]
                i += len(ps)
            by_id = {id(p): x for p, x in zip(flat, g)}
            g_t = [by_id[id(p)] for p in t_trunk]
            g_s = [by_id[id(p)] for p in s_trunk]
            n_c_t, n_c_s = norms([losses["t_c"], losses["s_c"]], (t_trunk, s_trunk), retain=False)
            n_t = [trunk_norm([x[1] for x in g_t]), n_c_t]
            n_s = [trunk_norm([x[1] for x in g_s]), n_c_s, trunk_norm([x[2] for x in g_s])]
        else:
            # one pull per seed: e_t_nf + e_s_nf, e_t_c + e_s_c, e_s2t2s_c; the
            # cross-trunk gradients of the merged pairs are structurally zero
            grads = self._grads(total, state, ALL_MODULES, retain_graph=True)
            n_nf_t, n_nf_s = norms([losses["t_nf"], losses["s_nf"]], (t_trunk, s_trunk))
            n_c_t, n_c_s = norms([losses["t_c"], losses["s_c"]], (t_trunk, s_trunk))
            (n_5_s,) = norms(losses["s2t2s_c"], (s_trunk,), retain=False)
            n_t, n_s = [n_nf_t, n_c_t], [n_nf_s, n_c_s, n_5_s]
        return (grads, torch.stack(n_t, dim=-1).detach(), torch.stack(n_s, dim=-1).detach())

    def _phase5_update(self, state: Dict, losses: Dict, new_m: Dict, grads, n_t, n_s) -> None:
        """GradNorm, all 11 module updates, the WGAN clip and the new model
        state, from one step's pulls (leading run axes kept throughout)."""
        cfg = self.config
        vec = torch.stack([losses[k] for k in GRADNORM_LOSSES], dim=-1).detach()
        gradnorm_step(state["gradnorm"]["t"], vec[..., :2], n_t, alpha=cfg.gradnorm.alpha,
                      weight_sum=cfg.gradnorm.weights_t_sum)
        gradnorm_step(state["gradnorm"]["s"], vec[..., 2:], n_s, alpha=cfg.gradnorm.alpha,
                      weight_sum=cfg.gradnorm.weights_s_sum)
        self._apply_updates(state, ALL_MODULES, grads)
        clip_params(leaves(state["params"]["ad"]), cfg.optim.ad_net_clip)
        clip_params(leaves(state["params"]["fd"]), cfg.optim.feat_disc_clip)
        state["mstate"] = detached(new_m)

    def phase5_step(self, state: Dict, bt, lt, bs, ls, epoch: int,
                    cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None):
        """One joint step: pulls, GradNorm, all 11 module updates, WGAN clip.
        Returns (losses, feats), detached."""
        losses, new_m, feats, grads, n_t, n_s = self.phase5_grads(
            state, bt, lt, bs, ls, epoch, cpc_anchors, dropout_masks
        )
        self._phase5_update(state, losses, new_m, grads, n_t, n_s)
        return ({k: v.detach() for k, v in losses.items()},
                {k: v.detach() for k, v in feats.items()})

    def phase5_epoch(self, state: Dict, xt, yt, xs, ys, epoch: int,
                     collect_features: bool = False,
                     cpc_anchors: Optional[Sequence[int]] = None, dropout_masks=None):
        """Joint adversarial training (reference :513-797), one epoch."""
        steps = []
        for bt, lt, bs, ls in zip(xt, yt, xs, ys):
            steps.append(self.phase5_step(
                state, _batch(bt, self.device), _batch(lt, self.device, torch.long),
                _batch(bs, self.device), _batch(ls, self.device, torch.long), epoch,
                cpc_anchors, dropout_masks,
            ))
        self._step_steplr(state, PHASE5_STEPLR)
        last = steps[-1][0]
        for name, loss in PHASE5_PLATEAU:
            self._step_plateau(state, name, float(last[loss]))
        metrics = {k: torch.stack([s[0][k] for s in steps]).mean() for k in last}
        metrics["gradnorm_w_t"] = state["gradnorm"]["t"].weights.clone()
        metrics["gradnorm_w_s"] = state["gradnorm"]["s"].weights.clone()
        if collect_features:
            feats = {k: torch.stack([s[1][k] for s in steps]).cpu().numpy() for k in FEATURE_KEYS}
            return metrics, feats
        return metrics

    # -------------------------------------------------------- evaluation ---

    @torch.inference_mode()
    def predict_source_logits(self, params, mstate, x: torch.Tensor) -> torch.Tensor:
        feat, _ = self.source_features(params, mstate, x, False, fused_infer=True)
        logits, _, _ = self.classify_source(params, mstate, feat, False, fused_infer=True)
        return logits

    def evaluate_target(self, state: Dict, x, y) -> float:
        return float(np.mean(self.predict_target(state, x) == y))

    def evaluate_source(self, state: Dict, x, y) -> float:
        pred = batched_argmax(self.predict_source_logits, state["params"], state["mstate"], x,
                              self.config.batch_size, self.device)
        return float(np.mean(pred == y))

    # ------------------------------------------------------ orchestration --

    def run(
        self,
        target_train,
        target_test,
        source_train,
        source_test,
        *,
        epochs: Optional[Dict[str, int]] = None,
        state: Optional[Dict] = None,
        verbose: bool = True,
        eval_hook=None,
        checkpoint_hook=None,
        phase_checkpoint_hook=None,
        artifact_dir: Optional[str] = None,
        log_every: int = 1,
        log_file: Optional[str] = None,
        pretrain_eval_every: int = 1,
        seed: Optional[int] = None,
    ):
        """The full curriculum (phase lengths overridable), with the JAX
        package's hooks and eval cadence: phases 1-3 evaluate every epoch,
        phase 4 on its supervised epochs, phase 5 every ``eval_every``
        epochs, where it also calls ``eval_hook``/``checkpoint_hook`` and,
        with ``artifact_dir``, dumps the feature sets.
        ``phase_checkpoint_hook(phase, state)`` fires at each phase end."""
        cfg = self.config
        ep = {
            "p1": cfg.target_pretrain_epochs, "p2": cfg.source_pretrain_epochs,
            "p3": cfg.selfsup_epochs, "p4": cfg.nf_pretrain_epochs, "p5": cfg.joint_epochs,
        }
        ep.update(epochs or {})
        seed = cfg.seed if seed is None else seed
        if state is None:
            state = self.init_state(torch.Generator().manual_seed(seed))
        batch_gen = torch.Generator().manual_seed(seed + 1)
        history = []
        file_logger = None
        if log_file:
            from ..utils.logging import FileLogger

            file_logger = FileLogger(log_file)

        def log(phase, e, metrics):
            if e % log_every and phase != "p5_eval":
                return
            rec = {"phase": phase, "epoch": e}
            for k, v in metrics.items():
                v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                rec[k] = v.tolist() if v.ndim else float(v)
            history.append(rec)
            if file_logger:
                file_logger.log(rec)
            if verbose:
                print(rec, flush=True)

        def batches(ds):
            return epoch_batches(ds.x, ds.y, batch_gen, cfg.batch_size)

        def paired_batches():
            xt, yt = batches(target_train)
            xs, ys = batches(source_train)
            nb = min(xt.shape[0], xs.shape[0])  # reference rounds_per_epoch
            return xt[:nb], yt[:nb], xs[:nb], ys[:nb]

        def accs(which):
            out = {}
            if "t" in which:
                out["target_train_acc"] = self.evaluate_target(state, target_train.x, target_train.y)
                out["target_test_acc"] = self.evaluate_target(state, target_test.x, target_test.y)
            if "s" in which:
                out["source_train_acc"] = self.evaluate_source(state, source_train.x, source_train.y)
                out["source_test_acc"] = self.evaluate_source(state, source_test.x, source_test.y)
            return out

        def pretrain_eval(phase, e, which):
            if pretrain_eval_every and e % pretrain_eval_every == 0:
                log(phase + "_eval", e, accs(which))

        def phase_done(phase):
            if phase_checkpoint_hook:
                phase_checkpoint_hook(phase, state)

        for e in range(ep["p1"]):
            log("p1", e, self.phase1_epoch(state, *batches(target_train)))
            pretrain_eval("p1", e, "t")  # reference :177-179
        phase_done("p1")
        for e in range(ep["p2"]):
            log("p2", e, self.phase2_epoch(state, *batches(source_train)))
            pretrain_eval("p2", e, "s")  # reference :217-219
        phase_done("p2")
        for e in range(ep["p3"]):
            log("p3", e, self.phase3_epoch(state, *paired_batches(),
                                           e % cfg.selfsup_supervised_every == 0))
            pretrain_eval("p3", e, "ts")  # reference :286-293,354-361
        phase_done("p3")
        for e in range(ep["p4"]):
            supervised = e % cfg.nf_supervised_every == 0
            log("p4", e, self.phase4_epoch(state, *paired_batches(), supervised))
            if supervised:  # reference evaluates only the supervised branch (:448-455)
                pretrain_eval("p4", e, "ts")
        phase_done("p4")
        for e in range(ep["p5"]):
            collect = artifact_dir is not None and e % cfg.eval_every == 0
            out = self.phase5_epoch(state, *paired_batches(), e, collect)
            if collect:
                from ..io.artifacts import save_feature_dumps

                out, feats = out
                save_feature_dumps(artifact_dir, e, feats)
            log("p5", e, out)
            if e % cfg.eval_every == 0:
                a = accs("ts")
                log("p5_eval", e, a)
                if eval_hook:
                    eval_hook(e, state, a)
                if checkpoint_hook:
                    checkpoint_hook(e, state)
        phase_done("p5")
        return state, history
