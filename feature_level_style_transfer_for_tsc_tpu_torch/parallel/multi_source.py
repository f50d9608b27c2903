"""Multi-source ensemble of target-shaped models on one card.

Counterpart of the JAX package's ``parallel/multi_source.py``
``MultiSourceEnsemble`` (``stack``, ``member_logits``,
``compute_class_weights``).  The K members (feature extractor + classifier)
share the target architecture, so their states stack along a leading model
axis as in the JAX package; on one card the members then run one after
another over the shared input batch, with no mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..config import PipelineConfig, VotingConfig
from ..evaluation.metrics import normalize_model_weights, per_class_precision_weights
from ..ops.batchnorm import BNStats
from ..train.classifier import OSCNNClassifier


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, BNStats):
        return BNStats(*(_tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return [_tree_map(fn, *leaves) for leaves in zip(*trees)]
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
    ):
        # Member model definition = the target classification stack
        # (reference multi_source_voting.py:240-263 rebuilds exactly this).
        self.model_def = OSCNNClassifier(
            in_channels, time_length, num_class, config=config, device=device
        )
        self.num_class = num_class
        self.voting = voting or VotingConfig()

    def stack(self, members: List[Dict]) -> Dict:
        """Stack member ``{'params', 'mstate'}`` states along a model axis."""
        return _tree_map(lambda *leaves: torch.stack(leaves), *members)

    def member_logits(self, stacked: Dict, x) -> torch.Tensor:
        """(M, N, C) logits, one row per model (shared input batch)."""
        n_models = stacked["params"]["cls"]["hidden"]["bias"].shape[0]
        x = torch.as_tensor(x, dtype=torch.float32).to(self.model_def.device)
        out = []
        for m in range(n_models):
            member = _tree_map(lambda leaf: leaf[m], stacked)
            out.append(self.model_def.predict_logits(member["params"], member["mstate"], x))
        return torch.stack(out)

    def compute_class_weights(self, stacked: Dict, x_train, y_train) -> torch.Tensor:
        """Per-model per-class precision on the TARGET TRAIN split, normalized
        across models (reference :281-367)."""
        preds = torch.argmax(self.member_logits(stacked, x_train), dim=-1)  # (M, N)
        labels = torch.as_tensor(y_train).to(preds.device)
        weights = torch.stack(
            [per_class_precision_weights(p, labels, self.num_class) for p in preds]
        )
        return normalize_model_weights(weights)
