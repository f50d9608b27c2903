"""Reference-API compatibility layer.

Counterpart of the JAX package's ``compat.py``.  Users of the reference call
(``train_and_test.py:22``)

    train(target_train_dataset, target_test_dataset,
          source_train_dataset, source_test_dataset,
          with_nvidia=False, epoch_num=720)

with datasets built as ``TrainData(root, relpath, label_dict)``
(``DataSource.py``).  This module exposes the same call shape over the
port's pipeline: ``TrainData``/``TestData`` re-export the port's loaders,
and ``train`` runs the full five-phase curriculum.  ``with_nvidia`` is
accepted and ignored, as in the JAX package; placement is the explicit
``device``, the card by default (it raises without CUDA unless
``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional

from .config import PipelineConfig
from .data.dataset import TestData, TrainData  # noqa: F401  (re-export)
from .train.pipeline import StyleTransferPipeline


def train(
    target_train_dataset,
    target_test_dataset,
    source_train_dataset,
    source_test_dataset,
    with_nvidia: bool = False,
    epoch_num: int = 720,
    config: Optional[PipelineConfig] = None,
    device="cuda",
    **run_kwargs,
):
    """Reference-signature entry point; returns (state, history)."""
    del with_nvidia  # placement is ``device``
    cfg = config or PipelineConfig(joint_epochs=epoch_num)
    pipe = StyleTransferPipeline(
        target_train_dataset.in_channel,
        target_train_dataset.time_length,
        target_train_dataset.num_class,
        source_train_dataset.in_channel,
        source_train_dataset.time_length,
        source_train_dataset.num_class,
        cfg,
        device=device,
    )
    return pipe.run(
        target_train_dataset,
        target_test_dataset,
        source_train_dataset,
        source_test_dataset,
        **run_kwargs,
    )
