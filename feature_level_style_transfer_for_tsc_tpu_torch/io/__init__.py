"""Checkpoints in the JAX package's .npz key layout, and analysis artifacts."""

from .artifacts import save_feature_dumps, save_prediction_strip  # noqa: F401
from .checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
