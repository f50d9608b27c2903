"""The whole K-run step's share of the card's TF32 peak: the step's operations by module (harness/work.py step_table: the forward and the four merged pulls) times the steps of the traced window, over its time."""

from __future__ import annotations

import importlib

_c = importlib.import_module("metrics._common")


def read(ctx):
    return _c.mfu(ctx)
