"""Kernel launches a K-run training step, counted in the traced slice's device events (all kernels, the program's and the libraries')."""

from __future__ import annotations

import importlib

_c = importlib.import_module("metrics._common")


def read(ctx):
    return _c.launches_per_unit(ctx)
