"""SLARDA self-supervised adversarial domain-adaptation baseline.

Counterpart of the JAX package's ``baselines/slarda.py`` (reference
``Comparison/SLARDA/train.py:78-271`` + ``models.py:6-24``):

* Phase A, source pretrain (70 epochs): raw source -> 1x1 channel resize
  (C_s -> C_t) -> OS_CNN_res (TARGET-shaped specs) -> OS_CNN head;
  loss = 2*CPC + CE, Adam(2e-3) + StepLR(25, 0.5)              (:149-187)
* Weight transfer: target extractor <- source extractor; target classifier
  <- source classifier SKIPPING the 'hidden' head; the target optimizer
  starts afresh; the source stack is frozen and left in eval mode, so its
  BatchNorm uses running statistics                            (:189-198)
* Phase B, ADDA-style target adaptation (450 epochs), two sub-steps a batch:
  1. critic step on DETACHED concat(source_feat, len_trans(target_feat))
     with BCE-with-logits labels [1 | 0] -> update the critic only
     (:222-235); this target pass's BatchNorm update is discarded;
  2. encoder step: fool the UPDATED critic (labels 1) + target CE ->
     update target extractor / length adapter / classifier    (:242-250);
     only this pass updates the target's running statistics.
  The critic is the Seq_Transformer WITHOUT gradient reversal (models.py).

The CPC anchors come from the state's ``generator``, or are pinned per call
(``source_epoch(..., cpc_anchor=)``).  An epoch mutates its state in place
and returns its mean losses.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import PipelineConfig
from ..data.batching import epoch_batches
from ..losses.classification import cross_entropy
from ..models.common import conv1x1, conv1x1_init, linear_init
from ..models.cpc import cpc_apply, cpc_init, draw_anchor
from ..models.os_cnn import os_cnn_apply, os_cnn_init, os_cnn_res_apply, os_cnn_res_init
from ..models.transformer import discriminator_att_apply, discriminator_att_init
from ..train.optim import set_lr
from ..train.steps import detached, leaves
from .common import BaselinePipeline, epoch_means, make_adam_steplr, steplr_value, to_record

SOURCE_GROUP = ("resize", "s_ext", "s_cls", "cpc")
TARGET_GROUP = ("t_ext", "len_trans", "t_cls")
CPC_HIDDEN = 64  # train.py:41-76


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch BCEWithLogitsLoss (mean reduction), in the JAX package's form."""
    x, z = logits, targets
    return torch.mean(torch.clamp(x, min=0) - x * z + torch.log1p(torch.exp(-torch.abs(x))))


def _copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the matching leaf of ``dst``, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


class SLARDAPipeline(BaselinePipeline):
    target_keys = ("t_ext", "t_cls")

    def __init__(
        self,
        target_shape: Tuple[int, int, int],
        source_shape: Tuple[int, int, int],
        config: Optional[PipelineConfig] = None,
        disc_hid: int = 128,
        disc_depth: int = 8,
        disc_heads: int = 8,
        disc_mlp: int = 64,
        device="cuda",
    ):
        # BOTH extractors use target-derived specs (reference :104-115)
        super().__init__(target_shape, config, device)
        self.source_shape = tuple(source_shape)
        self.disc_cfg = dict(
            patch_size=self.source_shape[1], att_hid_dim=disc_hid, depth=disc_depth,
            heads=disc_heads, mlp_dim=disc_mlp,
        )

    # ------------------------------------------------------------- state --

    def init_models(self, generator: torch.Generator) -> Dict:
        """Params and model state under the JAX package's keys."""
        dev, d = self.device, self.disc_cfg
        c_t, t_t, n_t = self.target_shape
        c_s, t_s, n_s = self.source_shape
        s_ext_p, s_ext_s = os_cnn_res_init(generator, self.ext_specs, dev)
        t_ext_p, t_ext_s = os_cnn_res_init(generator, self.ext_specs, dev)
        s_cls_p, s_cls_s = os_cnn_init(generator, self.cls_specs, n_s, dev)
        t_cls_p, t_cls_s = os_cnn_init(generator, self.cls_specs, n_t, dev)
        params = {
            "resize": conv1x1_init(generator, c_s, c_t, device=dev),
            "s_ext": s_ext_p, "t_ext": t_ext_p,
            "s_cls": s_cls_p, "t_cls": t_cls_p,
            "len_trans": linear_init(generator, t_t, t_s, dev),
            "cpc": cpc_init(generator, self.feat_channels, CPC_HIDDEN, t_s // 2, dev),
            "disc": discriminator_att_init(generator, t_s, d["att_hid_dim"], d["depth"],
                                           d["heads"], d["mlp_dim"], 1, dev),
        }
        mstate = {"s_ext": s_ext_s, "t_ext": t_ext_s, "s_cls": s_cls_s, "t_cls": t_cls_s}
        return {"params": params, "mstate": mstate}

    def _group_adam(self, params: Dict, names) -> torch.optim.Optimizer:
        return make_adam_steplr([p for n in names for p in leaves(params[n])], self.lr)

    def training_state(self, models: Dict, seed: int = 0) -> Dict:
        """``models`` plus the three Adams (source group, target group,
        critic) over parameters made leaves that require grad, their StepLR
        counters and the generator of CPC anchors."""
        params = models["params"]
        for p in leaves(params):
            p.requires_grad_(True)
        return {
            "params": params,
            "mstate": models["mstate"],
            "opt_src": self._group_adam(params, SOURCE_GROUP),
            "opt_tgt": self._group_adam(params, TARGET_GROUP),
            "opt_disc": self._group_adam(params, ("disc",)),
            "sched_src": 0,
            "sched_tgt": 0,
            "generator": torch.Generator().manual_seed(seed),
        }

    def init_state(self, generator: torch.Generator) -> Dict:
        return self.training_state(self.init_models(generator), int(generator.initial_seed()) + 1)

    # ----------------------------------------------- phase A: source ------

    def source_epoch(self, state: Dict, xb, yb, cpc_anchor: Optional[int] = None) -> Dict:
        """Source pretrain: 2*CPC + CE over the source group, one Adam step
        a batch; then StepLR."""
        losses = {"s_c_loss": [], "s_sl_loss": []}
        for x, y in zip(xb, yb):
            params, mstate = state["params"], state["mstate"]
            resized = conv1x1(params["resize"], self._batch(x))
            feat, s_ext_s = os_cnn_res_apply(params["s_ext"], mstate["s_ext"], self.ext_masks,
                                             resized, True)
            anchor = (draw_anchor(params["cpc"], state["generator"]) if cpc_anchor is None
                      else cpc_anchor)
            sl = cpc_apply(params["cpc"], feat, anchor)
            logits, _, s_cls_s = os_cnn_apply(params["s_cls"], mstate["s_cls"], self.cls_masks,
                                              feat, True)
            ce = cross_entropy(logits, self._batch(y, torch.long))
            self._step(state["opt_src"], params, SOURCE_GROUP, 2 * sl + ce)
            state["mstate"] = detached({**mstate, "s_ext": s_ext_s, "s_cls": s_cls_s})
            losses["s_c_loss"].append(ce.detach())
            losses["s_sl_loss"].append(sl.detach())
        state["sched_src"] += 1
        set_lr(state["opt_src"], steplr_value(self.lr, state["sched_src"]))
        return epoch_means(losses)

    # ------------------------------------------- weight transfer ----------

    @torch.no_grad()
    def transfer_weights(self, state: Dict) -> Dict:
        """target <- source, the classifier skipping its 'hidden' head
        (:189-198), in place; the target optimizer starts afresh so no
        moments leak across phases.  Returns ``state``."""
        params, mstate = state["params"], state["mstate"]
        _copy_into(params["t_ext"], params["s_ext"])
        _copy_into(params["t_cls"]["block"], params["s_cls"]["block"])
        mstate["t_ext"] = detached(mstate["s_ext"])
        mstate["t_cls"] = {**mstate["t_cls"], "block": detached(mstate["s_cls"]["block"])}
        state["opt_tgt"] = self._group_adam(params, TARGET_GROUP)
        return state

    # --------------------------------------------- phase B: target --------

    def _len_trans(self, params, feat):
        w = params["len_trans"]
        return torch.einsum("btc,ts->bsc", feat, w["weight"]) + w["bias"][None, :, None]

    def target_epoch(self, state: Dict, xt, yt, xs) -> Dict:
        """Two sub-steps a batch (critic, then encoder); then StepLR of the
        target group."""
        patch, heads = self.disc_cfg["patch_size"], self.disc_cfg["heads"]
        losses = {"t_c_loss": [], "adapt_loss": [], "disc_loss": []}
        for bt, lt, bs in zip(xt, yt, xs):
            params, mstate = state["params"], state["mstate"]
            bt, lt = self._batch(bt), self._batch(lt, torch.long)
            with torch.no_grad():
                # frozen source path, left in eval mode (:196-198), and the
                # critic's detached target input (its BatchNorm update dropped)
                s_feat, _ = os_cnn_res_apply(params["s_ext"], mstate["s_ext"], self.ext_masks,
                                             conv1x1(params["resize"], self._batch(bs)), False)
                t_feat_pre, _ = os_cnn_res_apply(params["t_ext"], mstate["t_ext"],
                                                 self.ext_masks, bt, True)
                changed_pre = self._len_trans(params, t_feat_pre)

            # --- sub-step 1: critic on detached features (:222-235) ---
            pred = discriminator_att_apply(params["disc"], torch.cat([s_feat, changed_pre]),
                                           patch, heads)[:, 0]
            labels = torch.cat([torch.ones(s_feat.shape[0], device=self.device),
                                torch.zeros(changed_pre.shape[0], device=self.device)])
            d_loss = bce_with_logits(pred, labels)
            self._step(state["opt_disc"], params, ("disc",), d_loss)

            # --- sub-step 2: encoder fools the (updated) critic (:242-250) --
            t_feat, t_ext_s = os_cnn_res_apply(params["t_ext"], mstate["t_ext"], self.ext_masks,
                                               bt, True)
            pred = discriminator_att_apply(params["disc"], self._len_trans(params, t_feat),
                                           patch, heads)[:, 0]
            loss_tgt = bce_with_logits(pred, torch.ones_like(pred))
            logits, _, t_cls_s = os_cnn_apply(params["t_cls"], mstate["t_cls"], self.cls_masks,
                                              t_feat, True)
            ce = cross_entropy(logits, lt)
            self._step(state["opt_tgt"], params, TARGET_GROUP, ce + loss_tgt)
            state["mstate"] = detached({**mstate, "t_ext": t_ext_s, "t_cls": t_cls_s})
            for k, v in zip(losses, (ce, loss_tgt, d_loss)):
                losses[k].append(v.detach())
        state["sched_tgt"] += 1
        set_lr(state["opt_tgt"], steplr_value(self.lr, state["sched_tgt"]))
        return epoch_means(losses)

    # ----------------------------------------------------------------- fit --

    def fit(self, target_train, target_test, source_train, source_epochs: int = 70,
            target_epochs: int = 450, verbose: bool = True):
        cfg = self.config
        state = self.init_state(torch.Generator().manual_seed(cfg.seed))
        batch_gen = torch.Generator().manual_seed(cfg.seed + 1)
        history = []

        def log(rec):
            history.append(rec)
            if verbose:
                print(rec, flush=True)

        for e in range(source_epochs):
            xb, yb = epoch_batches(source_train.x, source_train.y, batch_gen, cfg.batch_size)
            log({"phase": "source", "epoch": e, **to_record(self.source_epoch(state, xb, yb))})
        self.transfer_weights(state)
        for e in range(target_epochs):
            xt, yt = epoch_batches(target_train.x, target_train.y, batch_gen, cfg.batch_size)
            xs, _ = epoch_batches(source_train.x, source_train.y, batch_gen, cfg.batch_size)
            nb = min(xt.shape[0], xs.shape[0])
            m = self.target_epoch(state, xt[:nb], yt[:nb], xs[:nb])
            rec = {"phase": "target", "epoch": e, **to_record(m)}
            rec["test_acc"] = self.evaluate_target(state, target_test.x, target_test.y)
            log(rec)
        return state, history
