"""The whole request's share of the card's TF32 peak: the served models' forward operations (harness/work.py classifier_fwd) times the requests of the traced window, over its time."""

from __future__ import annotations

import importlib

_c = importlib.import_module("metrics._common")


def read(ctx):
    return _c.mfu(ctx)
