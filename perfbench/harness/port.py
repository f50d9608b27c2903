"""The program under test, and the benchmark's trees in the program's types.

Everything the harness takes from the program goes through this module: its package, its
launch counters, and its state types, to which the reference's NamedTuples of the same
names and fields are handed over.
"""

from __future__ import annotations

import importlib

import torch

PACKAGE = "feature_level_style_transfer_for_tsc_tpu_torch"

#: the reference's state types -> the program's module that defines the same NamedTuple
_TYPES = {"BNStats": "ops.batchnorm", "NoiseTransferState": "models.adapters",
          "CriticState": "models.critics"}
#: the program's modules whose LAUNCHES counters count the hand-written kernels' launches
COUNTED = ("ops.osconv", "ops.wn_fused", "ops.gate")


def module(name: str):
    return importlib.import_module(f"{PACKAGE}.{name}")


def to_program(tree):
    """``tree`` with each of the reference's state NamedTuples as the program's type."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        return {k: to_program(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        cls = getattr(module(_TYPES[type(tree).__name__]), type(tree).__name__)
        return cls(*(to_program(v) for v in tree))
    return [to_program(v) for v in tree]


def launches() -> dict:
    """The program's launch counters, entry -> launches so far."""
    out = {}
    for name in COUNTED:
        out.update(module(name).LAUNCHES)
    return out
