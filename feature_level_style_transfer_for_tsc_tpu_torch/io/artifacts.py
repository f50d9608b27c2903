"""Analysis artifacts: the intermediate-feature dumps.

The port's copy of ``save_feature_dumps`` from the JAX package's
``io/artifacts.py``: the six feature sets the reference dumps every 2 epochs
for t-SNE (train_and_test.py:792-797), numpy only.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def save_feature_dumps(out_dir: str, epoch: int, feats: Dict[str, np.ndarray]) -> None:
    """feats maps {'t_feat','s2t_feat','s_feat','s_pool','t2s_pool','s2t2s_pool'}
    to arrays whose leading axes are (num_batches, batch, ...), saved
    flattened to (N, ...) like the reference's concatenated batches."""
    t_dir = os.path.join(out_dir, "feature_of_target_s2t")
    s_dir = os.path.join(out_dir, "feature_of_source_t2s")
    os.makedirs(t_dir, exist_ok=True)
    os.makedirs(s_dir, exist_ok=True)

    def flat(a):
        a = np.asarray(a)
        return a.reshape(-1, *a.shape[2:])

    np.save(os.path.join(t_dir, f"epoch_{epoch}target_feature.npy"), flat(feats["t_feat"]))
    np.save(os.path.join(t_dir, f"epoch_{epoch}s2t_feature.npy"), flat(feats["s2t_feat"]))
    np.save(os.path.join(t_dir, f"epoch_{epoch}source_feature.npy"), flat(feats["s_feat"]))
    np.save(os.path.join(s_dir, f"epoch_{epoch}source_feature.npy"), flat(feats["s_pool"]))
    np.save(os.path.join(s_dir, f"epoch_{epoch}target_feature.npy"), flat(feats["t2s_pool"]))
    np.save(os.path.join(s_dir, f"epoch_{epoch}s2t2s_feature.npy"), flat(feats["s2t2s_pool"]))
