"""Multi-source ensemble of target-shaped models.

Counterpart of the JAX package's ``parallel/multi_source.py``
``MultiSourceEnsemble`` (``stack``, ``member_logits``,
``compute_class_weights``, ``predict``, ``evaluate``).  The K members
(feature extractor + classifier) share the target architecture, so their
states stack along a leading model axis as in the JAX package, and the
members' forwards are one ``torch.func.vmap`` over that axis, sharing the
input batch, as JAX's are one ``jax.vmap``: each layer's conv is one
run-axis launch for all the members (``OSConvCore`` / ``OSConvFusedCore``'s
vmap rules, ``os_conv_fwd_runs`` / ``os_conv_fused_fwd_runs``), each member
the bits of its own call.  The time pool and the linear head, a few
kilobytes a member, run member by member, so each member's logits are the
bits of its own ``predict_logits`` call (a batched product sums in another
order).  The vote sums over the model axis.

With a ``mesh`` (``parallel.mesh.make_mesh``; every rank of it runs the same
calls, multi-controller) the model axis is sharded over "domain", as JAX's
``device_put`` with ``domain_sharding`` places it: ``stack`` keeps each
rank's own members (``local_members``: the member count must be divisible
by the axis size), and ``member_logits`` computes them and all-gathers the
``(M_loc, N, C)`` logits in member order, so the weights, the votes and
every result are the same on every rank.  ``ensemble_mesh`` is JAX's CLIs'
rule over devices with ranks in their place, which ``cli.predict`` and
``cli.multi_source`` follow under ``torchrun``: that mesh when there are at
least as many ranks as members, else the ensemble on rank 0 with
``mesh=None``.
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
from .mesh import axis_group, domain_sharding, make_mesh, place


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


def ensemble_mesh(world: int, rank: int, m: int, device):
    """``(mesh, takes_part)`` for an ensemble of ``m`` members on rank
    ``rank`` of ``world``: the JAX CLIs' rule over devices with the ranks in
    their place.  With several ranks and ``world >= m``,
    ``make_mesh(data=1, domain=m)`` (every rank of the group makes it; the
    ranks past ``m`` are outside it and take no part); else no mesh, and
    rank 0 alone runs the ensemble, as JAX runs one program."""
    if 1 < world and m <= world:
        mesh = make_mesh(data=1, domain=m, device=device)
        return mesh, mesh.get_coordinate() is not None
    return None, rank == 0


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

    def local_members(self, n: int) -> List[int]:
        """The indices of the members of ``n`` that this rank holds: all of
        them without a mesh; with one, its share of the model axis over
        "domain" (``place`` by ``domain_sharding``, which refuses an ``n``
        that the axis does not divide, and a rank outside the mesh)."""
        if self.mesh is None:
            return list(range(n))
        return place(self.mesh, np.arange(n), domain_sharding(self.mesh)).tolist()

    def stack(self, members: List[Optional[Dict]]) -> Dict:
        """Stack member ``{'params', 'mstate'}`` states along a model axis,
        on the ensemble's device; with a mesh, this rank's members only
        (``local_members``).  A member this rank does not hold is not read
        and may be None, so a rank need load only its own."""
        device = self.model_def.device
        mine = [members[i] for i in self.local_members(len(members))]
        if any(m is None for m in mine):
            raise ValueError("a member this rank holds is missing (None)")
        return tree_map(lambda *leaves: torch.stack([l.to(device) for l in leaves]), *mine)

    def member_logits(self, stacked: Dict, x) -> torch.Tensor:
        """(M, N, C) logits, one row per model (shared input batch); with a
        mesh, every rank's members, gathered in member order."""
        model = self.model_def
        x = torch.as_tensor(x, dtype=torch.float32).to(model.device)
        blocks = torch.func.vmap(
            lambda m: model.predict_block(m["params"], m["mstate"], x))(stacked)
        logits = torch.stack([
            model.predict_head(tree_map(lambda leaf: leaf[i], stacked["params"]), y)
            for i, y in enumerate(blocks)])
        if self.mesh is None:
            return logits
        group, _, _ = axis_group(self.mesh, "domain")
        return torch.cat(all_gather(logits, group), dim=0)

    def compute_class_weights(self, stacked: Dict, x_train, y_train) -> torch.Tensor:
        """Per-model per-class precision on the TARGET TRAIN split, normalized
        across models (reference :281-367)."""
        preds = torch.argmax(self.member_logits(stacked, x_train), dim=-1)  # (M, N)
        labels = torch.as_tensor(y_train).to(preds.device)
        weights = torch.func.vmap(
            lambda p: per_class_precision_weights(p, labels, self.num_class))(preds)
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
