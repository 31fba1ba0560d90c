"""Observability: scalar metrics, PNG sample grids, command records, JSON logs.

Mirrors reference libraries/train_utils.py:10-40 (scalar `write`,
`save_img` √B grid, `record_command`) and train_DSO.py's log.json.
Scalars go to a flat ``metrics.jsonl`` (one JSON object per line).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np


class MetricsWriter:
    """Scalar writer: appends ``{"iter", name, "t"}`` lines to metrics.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, iteration: int, value, name: str):
        value = float(np.asarray(value))
        self._jsonl.write(json.dumps({"iter": iteration, name: value,
                                      "t": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


def save_img_grid(imgs, path: str):
    """Save a (B, C, H, W) [-1,1] batch as a √B x √B PNG grid
    (reference train_utils.py:26-40)."""
    from PIL import Image
    x = np.asarray(imgs)
    B = x.shape[0]
    g = int(np.floor(np.sqrt(B)))
    x = x[:g * g]
    if x.ndim == 3:  # (B, H, W) mask
        x = x[:, None].repeat(3, axis=1)
    if x.shape[1] == 1:
        x = x.repeat(3, axis=1)
    _, C, H, W = x.shape
    x = x.reshape(g, g, C, H, W).transpose(2, 0, 3, 1, 4).reshape(C, g * H, g * W)
    x = np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(x).save(path)


def record_command(out_dir: str):
    """Append argv to command.txt (reference train_utils.py:10-12)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "command.txt"), "a") as f:
        f.write(" ".join(sys.argv) + "\n")


class JsonLog:
    """Per-validation-interval metric log (reference train_DSO.py:313-325)."""

    def __init__(self, path: str):
        self.path = path
        self.log: Dict = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self.log = json.load(f)
            except Exception:
                self.log = {}

    def update(self, iteration: int, entry: Dict):
        self.log[str(iteration)] = entry
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.log, f)
