"""The traced slice's wall time in which no operation ran on the card (1 - the union of device event intervals over the slice), in %."""

from __future__ import annotations

import importlib

_c = importlib.import_module("metrics._common")


def read(ctx):
    return _c.idle_share(ctx)
