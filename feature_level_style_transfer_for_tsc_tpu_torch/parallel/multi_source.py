"""Multi-source ensemble of target-shaped models on one card.

Counterpart of the JAX package's ``parallel/multi_source.py``
``MultiSourceEnsemble`` (``stack``, ``member_logits``,
``compute_class_weights``, ``predict``, ``evaluate``).  The K members
(feature extractor + classifier) share the target architecture, so their
states stack along a leading model axis as in the JAX package; on one card
the members then run one after another over the shared input batch, and the
vote sums over the model axis.

With a ``mesh`` (``parallel.mesh.make_mesh``; every rank of it runs the same
calls, multi-controller) the model axis is sharded over "domain", as JAX's
``device_put`` with ``domain_sharding`` places it: ``stack`` keeps each
rank's own members (the member count must be divisible by the axis size),
and ``member_logits`` computes them and all-gathers the ``(M_loc, N, C)``
logits in member order, so the weights, the votes and every result are the
same on every rank.  The CLIs stay one process with ``mesh=None``, JAX's
case of fewer devices than members.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import PipelineConfig, VotingConfig
from ..evaluation.metrics import normalize_model_weights, per_class_precision_weights
from ..evaluation.voting import entropy_only_vote, entropy_precision_vote, predicted_label_vote
from ..ops.batchnorm import BNStats
from ..ops.collectives import all_gather
from ..train.classifier import OSCNNClassifier
from .mesh import axis_group, domain_sharding, place


def tree_map(fn, *trees):
    """``fn`` over the leaves of member states (dicts, lists, BNStats)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, BNStats):
        return BNStats(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


class MultiSourceEnsemble:
    """K target-shaped (extractor, classifier) models + weighted voting."""

    def __init__(
        self,
        in_channels: int,
        time_length: int,
        num_class: int,
        config: Optional[PipelineConfig] = None,
        voting: Optional[VotingConfig] = None,
        device="cuda",
        mesh=None,
    ):
        # Member model definition = the target classification stack
        # (reference multi_source_voting.py:240-263 rebuilds exactly this).
        self.model_def = OSCNNClassifier(
            in_channels, time_length, num_class, config=config, with_cpc=False, device=device
        )
        self.num_class = num_class
        self.voting = voting or VotingConfig()
        self.mesh = mesh

    def stack(self, members: List[Dict]) -> Dict:
        """Stack member ``{'params', 'mstate'}`` states along a model axis, on
        the ensemble's device; with a mesh, this rank's members only."""
        device = self.model_def.device
        stacked = tree_map(lambda *leaves: torch.stack([l.to(device) for l in leaves]), *members)
        if self.mesh is not None:
            sh = domain_sharding(self.mesh)
            stacked = tree_map(lambda leaf: place(self.mesh, leaf, sh), stacked)
        return stacked

    def member_logits(self, stacked: Dict, x) -> torch.Tensor:
        """(M, N, C) logits, one row per model (shared input batch); with a
        mesh, every rank's members, gathered in member order."""
        n_models = stacked["params"]["cls"]["hidden"]["bias"].shape[0]
        x = torch.as_tensor(x, dtype=torch.float32).to(self.model_def.device)
        out = []
        for m in range(n_models):
            member = tree_map(lambda leaf: leaf[m], stacked)
            out.append(self.model_def.predict_logits(member["params"], member["mstate"], x))
        logits = torch.stack(out)
        if self.mesh is None:
            return logits
        group, _, _ = axis_group(self.mesh, "domain")
        return torch.cat(all_gather(logits, group), dim=0)

    def compute_class_weights(self, stacked: Dict, x_train, y_train) -> torch.Tensor:
        """Per-model per-class precision on the TARGET TRAIN split, normalized
        across models (reference :281-367)."""
        preds = torch.argmax(self.member_logits(stacked, x_train), dim=-1)  # (M, N)
        labels = torch.as_tensor(y_train).to(preds.device)
        weights = torch.stack(
            [per_class_precision_weights(p, labels, self.num_class) for p in preds]
        )
        return normalize_model_weights(weights)

    def predict(self, stacked: Dict, x_test, class_weights: torch.Tensor) -> np.ndarray:
        """The entropy+precision vote (reference :405-429) on ``x_test``."""
        logits = self.member_logits(stacked, x_test)
        return entropy_precision_vote(logits, class_weights, self.voting).cpu().numpy()

    def evaluate(self, stacked: Dict, train_ds, test_ds) -> Dict:
        """Full ensemble evaluation: weights from the train split, vote on
        the test split.

        Reports all three vote rules the reference tree contains: the active
        entropy+precision vote (multi_source_voting.py:405-429), the
        commented entropy-only variant (:118-227) and the per-predicted-label
        variant (visualization.py:231-440).  The test split's member logits
        are computed once and feed every rule."""
        weights = self.compute_class_weights(stacked, train_ds.x, train_ds.y)
        logits = self.member_logits(stacked, test_ds.x)
        y = np.asarray(test_ds.y)
        pred = entropy_precision_vote(logits, weights, self.voting).cpu().numpy()
        variants = {
            "entropy_precision": float(np.mean(pred == y)),
            "entropy_only": float(np.mean(entropy_only_vote(logits).cpu().numpy() == y)),
            "predicted_label": float(
                np.mean(predicted_label_vote(logits, weights).cpu().numpy() == y)
            ),
        }
        member_accs = [float(np.mean(torch.argmax(l, -1).cpu().numpy() == y)) for l in logits]
        return {
            "ensemble_acc": variants["entropy_precision"],
            "vote_variants": variants,
            "member_accs": member_accs,
            "class_weights": weights.cpu().numpy(),
            "predictions": pred,
        }
