"""Synthetic series at the archives' shapes, made from the seed on the host.

A copy of the class-separable generator the program's tests use: per-class frequency
signatures with a random phase per series and channel, channel scales, Gaussian noise,
and per-series, per-channel z-normalisation as in the UCR/UEA archives.  Layout (N, T, C)
as the program takes it; labels are int64 class indices.
"""

from __future__ import annotations

import numpy as np


def series(n: int, channels: int, length: int, classes: int, rng: np.random.Generator,
           noise: float = 0.3):
    y = rng.integers(0, classes, size=n)
    t = np.arange(length, dtype=np.float32)[None, None, :]
    freqs = 1.0 + np.arange(classes, dtype=np.float32) * 0.7
    phase = rng.uniform(0, 2 * np.pi, size=(n, channels, 1)).astype(np.float32)
    scale = 1.0 + 0.3 * np.arange(channels, dtype=np.float32)[None, :, None]
    x = np.sin(2 * np.pi * freqs[y][:, None, None] * t / length * 4 + phase) * scale
    x = x + noise * rng.standard_normal((n, channels, length)).astype(np.float32)
    x = (x - x.mean(axis=-1, keepdims=True)) / (x.std(axis=-1, keepdims=True) + 1e-8)
    return np.ascontiguousarray(x.transpose(0, 2, 1), dtype=np.float32), y.astype(np.int64)


def epoch_order(n: int, batch: int, rng: np.random.Generator) -> np.ndarray:
    """One epoch's (nb, batch) row indices: a permutation, the tail batch filled by
    wrapping around it, so every batch is full."""
    nb = max(1, -(-n // batch))
    return np.resize(rng.permutation(n), nb * batch).reshape(nb, batch)
