"""Append-to-file training logs: one JSON record per line.

The port's copy of the JAX package's ``utils/logging.py`` (reference
``train_log/log.txt``, train_and_test.py:642-644).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class FileLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, record: Dict) -> None:
        rec = {"ts": time.time(), **record}
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, default=str) + "\n")
