"""CoDATS multi-source adversarial domain-adaptation baseline.

Counterpart of the JAX package's ``baselines/codats.py`` (reference
``Comparison/CoDATS/main.py:13-243`` and its transformer discriminator
``discriminator.py:13-150``), generalized from 3 to K source domains:

* per-source 1x1 channel resize on the RAW signal + Linear(T_s -> T_t) time
  adapter on the extracted features (main.py:43-45,64-66);
* ONE shared target ``OS_CNN_res`` trunk, run in TRAIN mode for the target
  batch and in EVAL mode (running statistics, no update) for every source
  batch, still under the gradient, so only target data updates the
  BatchNorm statistics (main.py:158-165);
* per-domain OS_CNN classification heads (target-shaped specs);
* a (K+1)-way domain classifier: Seq_Transformer with gradient reversal at
  fixed coefficient 1.2 (discriminator.py:25-33);
* joint loss CE_t + sum_k CE_sk + CE_disc, one Adam(2e-3) over every
  parameter stepped per batch, StepLR(25, 0.5) per epoch (main.py:81-103,184).

An epoch mutates its state in place and returns its mean losses.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import PipelineConfig
from ..data.batching import epoch_batches
from ..losses.classification import cross_entropy
from ..models.common import conv1x1, conv1x1_init, linear_init
from ..models.os_cnn import os_cnn_apply, os_cnn_init, os_cnn_res_apply, os_cnn_res_init
from ..models.transformer import discriminator_att_apply, discriminator_att_init
from ..train.optim import set_lr
from ..train.steps import detached, leaves
from .common import BaselinePipeline, epoch_means, make_adam_steplr, steplr_value, to_record

GRL_COEFF = 1.2  # discriminator.py:27-28


class CoDATSPipeline(BaselinePipeline):
    def __init__(
        self,
        target_shape: Tuple[int, int, int],  # (C, T, n_class)
        source_shapes: Sequence[Tuple[int, int, int]],
        config: Optional[PipelineConfig] = None,
        disc_hid: int = 128,
        disc_depth: int = 8,
        disc_heads: int = 8,
        disc_mlp: int = 64,
        device="cuda",
    ):
        super().__init__(target_shape, config, device)
        self.source_shapes = [tuple(s) for s in source_shapes]
        self.disc_cfg = dict(
            patch_size=self.target_shape[1], att_hid_dim=disc_hid, depth=disc_depth,
            heads=disc_heads, mlp_dim=disc_mlp, num_class=len(self.source_shapes) + 1,
        )

    # ------------------------------------------------------------- state --

    def init_models(self, generator: torch.Generator) -> Dict:
        """Params and model state under the JAX package's keys."""
        dev, d = self.device, self.disc_cfg
        c_t, t_t, n_t = self.target_shape
        ext_p, ext_s = os_cnn_res_init(generator, self.ext_specs, dev)
        t_cls_p, t_cls_s = os_cnn_init(generator, self.cls_specs, n_t, dev)
        disc_p = discriminator_att_init(generator, d["patch_size"], d["att_hid_dim"], d["depth"],
                                        d["heads"], d["mlp_dim"], d["num_class"], dev)
        params: Dict = {"ext": ext_p, "t_cls": t_cls_p, "disc": disc_p,
                        "resize": [], "trans": [], "s_cls": []}
        mstate: Dict = {"ext": ext_s, "t_cls": t_cls_s, "s_cls": []}
        for c_s, t_s, n_s in self.source_shapes:
            params["resize"].append(conv1x1_init(generator, c_s, c_t, device=dev))
            params["trans"].append(linear_init(generator, t_s, t_t, dev))
            sc_p, sc_s = os_cnn_init(generator, self.cls_specs, n_s, dev)
            params["s_cls"].append(sc_p)
            mstate["s_cls"].append(sc_s)
        return {"params": params, "mstate": mstate}

    def training_state(self, models: Dict) -> Dict:
        """``models`` plus one Adam over every parameter (made leaves that
        require grad) and the StepLR counter."""
        for p in leaves(models["params"]):
            p.requires_grad_(True)
        return {"params": models["params"], "mstate": models["mstate"],
                "opt": make_adam_steplr(leaves(models["params"]), self.lr), "sched": 0}

    def init_state(self, generator: torch.Generator) -> Dict:
        return self.training_state(self.init_models(generator))

    # ----------------------------------------------------------- forward --

    def _source_feature(self, params, mstate, i, x):
        """resize -> SHARED trunk in EVAL mode -> time adapter (main.py:158-165)."""
        resized = conv1x1(params["resize"][i], x)
        feat, _ = os_cnn_res_apply(params["ext"], mstate["ext"], self.ext_masks, resized, False)
        w = params["trans"][i]
        return torch.einsum("bsc,st->btc", feat, w["weight"]) + w["bias"][None, :, None]

    def _loss(self, params, mstate, bt, lt, bs_list, ls_list):
        """(total, (ce_t, ce_s (K,), ce_disc), new model state)."""
        new_m = dict(mstate)
        t_feat, new_m["ext"] = os_cnn_res_apply(params["ext"], mstate["ext"], self.ext_masks,
                                                bt, True)
        feats, ce_s, new_s_cls = [t_feat], [], []
        for i, (xs, ys) in enumerate(zip(bs_list, ls_list)):
            s_feat = self._source_feature(params, mstate, i, xs)
            feats.append(s_feat)
            logits, _, sc_s = os_cnn_apply(params["s_cls"][i], mstate["s_cls"][i],
                                           self.cls_masks, s_feat, True)
            ce_s.append(cross_entropy(logits, ys))
            new_s_cls.append(sc_s)
        new_m["s_cls"] = new_s_cls
        t_logits, _, new_m["t_cls"] = os_cnn_apply(params["t_cls"], mstate["t_cls"],
                                                   self.cls_masks, t_feat, True)
        ce_t = cross_entropy(t_logits, lt)
        domain_labels = torch.cat([torch.full((f.shape[0],), i, device=self.device)
                                   for i, f in enumerate(feats)])
        disc_logits = discriminator_att_apply(
            params["disc"], torch.cat(feats, dim=0), self.disc_cfg["patch_size"],
            self.disc_cfg["heads"], grl=GRL_COEFF,
        )
        ce_disc = cross_entropy(disc_logits, domain_labels)
        return ce_t + sum(ce_s) + ce_disc, (ce_t, torch.stack(ce_s), ce_disc), new_m

    # -------------------------------------------------------------- train --

    def train_epoch(self, state: Dict, xt, yt, xs_list, ys_list) -> Dict:
        """One Adam step per batch over all of ``params``; then StepLR."""
        names = tuple(state["params"])
        losses = {"loss_t": [], "loss_s": [], "loss_disc": []}
        for b in range(len(xt)):
            params, mstate = state["params"], state["mstate"]
            bs_list = [self._batch(x[b]) for x in xs_list]
            ls_list = [self._batch(y[b], torch.long) for y in ys_list]
            total, (ce_t, ce_s, ce_disc), new_m = self._loss(
                params, mstate, self._batch(xt[b]), self._batch(yt[b], torch.long),
                bs_list, ls_list,
            )
            self._step(state["opt"], params, names, total)
            state["mstate"] = detached(new_m)
            for k, v in zip(losses, (ce_t, ce_s, ce_disc)):
                losses[k].append(v.detach())
        state["sched"] += 1
        set_lr(state["opt"], steplr_value(self.lr, state["sched"], 25, 0.5))
        return epoch_means(losses)

    # ----------------------------------------------------------------- fit --

    def fit(self, target_train, target_test, source_trains, epochs: int = 600, verbose=True):
        cfg = self.config
        state = self.init_state(torch.Generator().manual_seed(cfg.seed))
        batch_gen = torch.Generator().manual_seed(cfg.seed + 1)
        history = []
        for e in range(epochs):
            xt, yt = epoch_batches(target_train.x, target_train.y, batch_gen, cfg.batch_size)
            xs_list, ys_list = [], []
            nb = xt.shape[0]
            for ds in source_trains:
                xs, ys = epoch_batches(ds.x, ds.y, batch_gen, cfg.batch_size)
                nb = min(nb, xs.shape[0])
                xs_list.append(xs)
                ys_list.append(ys)
            m = self.train_epoch(state, xt[:nb], yt[:nb], [x[:nb] for x in xs_list],
                                 [y[:nb] for y in ys_list])
            rec = {"epoch": e, **to_record(m)}
            rec["train_acc"] = self.evaluate_target(state, target_train.x, target_train.y)
            rec["test_acc"] = self.evaluate_target(state, target_test.x, target_test.y)
            history.append(rec)
            if verbose:
                print(rec, flush=True)
        return state, history
