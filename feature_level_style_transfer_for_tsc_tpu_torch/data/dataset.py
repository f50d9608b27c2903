"""Dataset containers with the reference's label-dictionary semantics.

Parity with reference `DataSource.py:9-63`:

* `TrainData` builds the label->int mapping in first-appearance order,
  mutating the SHARED ``label_dict`` in place so the matching `TestData`
  agrees (DataSource.py:22-28);
* `TestData` reuses the dict and warns on unseen labels (DataSource.py:55).
  NOTE: the reference leaves ``TestData.num_class == 0`` (its ``class_label``
  counter is never incremented, DataSource.py:50,56) — a bug.  Here
  ``num_class`` is derived from the shared dict (documented fix).

Arrays are stored channel-LAST (N, T, C) for TPU lane efficiency; the
attribute names (.len, .in_channel, .time_length, .num_class) match the
reference API.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np

from .ts_parser import load_dataset_split


class TsClassificationData:
    """One split of a .ts classification dataset."""

    def __init__(
        self,
        file_path_begin: Optional[str] = None,
        file_path_end: Optional[str] = None,
        label_dict: Optional[Dict[str, int]] = None,
        *,
        is_train: bool,
        arrays: Optional[tuple] = None,
    ):
        if arrays is not None:
            x, y_raw = arrays
        else:
            x, y_raw = load_dataset_split(file_path_begin, file_path_end)
        if label_dict is None:
            label_dict = {}
        self.label_dict = label_dict
        self.len = x.shape[0]
        self.in_channel = x.shape[1]
        self.time_length = x.shape[-1]
        # channel-last for TPU: (N, T, C)
        self.x = np.ascontiguousarray(np.transpose(x, (0, 2, 1)).astype(np.float32))

        labels = []
        if is_train:
            class_label = len(label_dict)
            for lab in y_raw:
                if lab not in label_dict:
                    label_dict[lab] = class_label
                    class_label += 1
                labels.append(label_dict[lab])
        else:
            for lab in y_raw:
                if lab in label_dict:
                    labels.append(label_dict[lab])
                else:
                    warnings.warn(
                        "train/test label mismatch — stop training"
                        " (reference DataSource.py:55)"
                    )
                    labels.append(-1)
        self.y = np.asarray(labels, np.int32)
        self.num_class = len(label_dict)

    def __len__(self):
        return self.len

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]


def TrainData(file_path_begin, file_path_end, label_dict) -> TsClassificationData:
    """Reference-API constructor (DataSource.py:9-36)."""
    return TsClassificationData(file_path_begin, file_path_end, label_dict, is_train=True)


def TestData(file_path_begin, file_path_end, label_dict) -> TsClassificationData:
    """Reference-API constructor (DataSource.py:38-63)."""
    return TsClassificationData(file_path_begin, file_path_end, label_dict, is_train=False)


def check_z_normalized(x: np.ndarray, atol: float = 0.1) -> bool:
    """Sanity check that each series is per-channel z-normalized.

    (Activated version of the commented reference snippet,
    multi_source_voting.py:105-115.)  x is (N, T, C).
    """
    mean = np.nanmean(x, axis=1)
    std = np.nanstd(x, axis=1)
    return bool(np.all(np.abs(mean) < atol) and np.all(np.abs(std - 1.0) < atol))
