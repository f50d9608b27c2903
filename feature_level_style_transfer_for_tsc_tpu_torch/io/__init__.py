"""Checkpoints in the JAX package's .npz key layout."""
