"""Configuration of the serving path, with the reference's values as defaults.

The port's counterpart of the JAX package's ``config.py``: only the
``PipelineConfig`` fields that serving reads, and ``VotingConfig``.  The
training fields (phase lengths, learning rates, GradNorm, flow) come with
the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PipelineConfig:
    """Serving subset of the five-phase pipeline's configuration."""

    batch_size: int = 20  # reference train_and_test.py
    max_kernel_size: int = 89  # reference train_and_test.py:40
    #: scales the OS-CNN parameter budgets (1.0 = reference budgets
    #: train_and_test.py:38-39); tests shrink it to keep models tiny.
    budget_multiplier: float = 1.0
    seed: int = 0


@dataclass(frozen=True)
class VotingConfig:
    """Ensemble voting constants (reference multi_source_voting.py:405-420)."""

    entropy_scale: float = 120.0
    weight_base: float = 9.0
