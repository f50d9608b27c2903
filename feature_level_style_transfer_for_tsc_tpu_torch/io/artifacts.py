"""Analysis artifacts: intermediate-feature dumps and prediction strips.

The port's copy of the JAX package's ``io/artifacts.py``: the six feature
sets the reference dumps every 2 epochs for t-SNE (train_and_test.py:792-797)
and the correct/incorrect PNG strips of ``visualization.py:443-521``.  Numpy
and the standard library only: the PNG is written with ``zlib`` and
``struct`` (8-bit RGB, filter 0 on every row, one IDAT chunk), so its pixels
are the JAX package's (PIL-written) file's, its bytes need not be.
"""

from __future__ import annotations

import os
import struct
import zlib
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


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _write_png_rgb(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 9))
        + _png_chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def save_prediction_strip(
    path: str,
    predictions: np.ndarray,
    labels: np.ndarray,
    cell: int = 10,
    per_row: int = 40,
) -> None:
    """Render per-sample correct (green) / incorrect (red) cells as a PNG.

    Equivalent of visualization.py:443-521's paletted strips.
    """
    correct = np.asarray(predictions) == np.asarray(labels)
    rows = -(-len(correct) // per_row)
    img = np.full((rows * cell, per_row * cell, 3), 255, np.uint8)
    for i, ok in enumerate(correct):
        r, c = divmod(i, per_row)
        color = (60, 180, 75) if ok else (230, 25, 75)
        img[r * cell : (r + 1) * cell - 1, c * cell : (c + 1) * cell - 1] = color
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write_png_rgb(path, img)
