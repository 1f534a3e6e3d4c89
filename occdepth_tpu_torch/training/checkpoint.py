"""Checkpoints with `torch.save`: params, BN statistics, optimizer state,
step.

Counterpart of `occdepth_tpu/training/checkpoint.py::CheckpointManager`
(the reference's ModelCheckpoint pair, top-1 val/mIoU and top-1 val/IoU,
plus save_last): `last.pt`, `best_val_mIoU.pt`, `best_val_IoU.pt` and a
`meta.json` holding the best values and the last step, so a restarted
run keeps comparing against the best seen so far.  Under data parallelism
rank 0 saves (the Trainer then waits at a barrier) and every rank restores
onto its own device with `map_location`.
"""
from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    """Keeps `last` plus best-by-metric checkpoints, like the reference."""

    def __init__(self, directory: str, monitors=("val/mIoU", "val/IoU")):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitors = monitors
        self.best: Dict[str, float] = {}
        self._meta_path = os.path.join(self.directory, "meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.best = json.load(f).get("best", {})

    def path(self, name: str = "last") -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, state: Dict[str, Any], step: int,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Write `state` as `last`, and copy it to `best_<monitor>` for
        every monitor in `metrics` that improved.  Each file is replaced
        atomically (a reader never sees half a file)."""
        tmp = self.path() + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path())
        for mon in self.monitors:
            if metrics and mon in metrics and (
                    metrics[mon] > self.best.get(mon, -math.inf)):
                self.best[mon] = float(metrics[mon])
                name = "best_" + mon.replace("/", "_")
                shutil.copyfile(self.path(), self.path(name) + ".tmp")
                os.replace(self.path(name) + ".tmp", self.path(name))
        with open(self._meta_path, "w") as f:
            json.dump({"best": self.best, "last_step": int(step)}, f)

    def restore(self, name: str = "last",
                map_location=None) -> Optional[Dict[str, Any]]:
        """The saved state `name`, or None if there is none."""
        if not self.has(name):
            return None
        return torch.load(self.path(name), map_location=map_location,
                          weights_only=True)

    def has(self, name: str = "last") -> bool:
        return os.path.exists(self.path(name))
