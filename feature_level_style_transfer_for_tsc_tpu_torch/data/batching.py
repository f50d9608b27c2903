"""Epoch batching with full batches only.

Counterpart of the JAX package's ``data/batching.py``: an epoch is one
stacked array ``(num_batches, B, T, C)``.  Every batch is full: when N is
not a multiple of B, the tail batch wraps around the same shuffled
permutation (instead of torch's smaller final batch), so batch-interacting
losses (CPC's InfoNCE, CDAN's weight normalization) stay well-defined.  The
permutation comes from a ``torch.Generator``, or is given (``perm=``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def num_full_batches(n: int, batch_size: int) -> int:
    return max(1, -(-n // batch_size))  # ceil, at least one batch


def epoch_batches(
    x: np.ndarray,
    y: np.ndarray,
    generator: Optional[torch.Generator],
    batch_size: int,
    *,
    perm: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffle and stack one epoch: returns (nb, B, T, C) and (nb, B)."""
    n = x.shape[0]
    nb = num_full_batches(n, batch_size)
    if perm is None:
        perm = torch.randperm(n, generator=generator).numpy()
    idx = np.resize(np.asarray(perm), nb * batch_size)  # wrap-around fill of the tail batch
    return x[idx].reshape(nb, batch_size, *x.shape[1:]), y[idx].reshape(nb, batch_size)
