"""Checkpoints with `torch.save`: params, BN statistics, optimizer state,
step.

Counterpart of `occdepth_tpu/training/checkpoint.py::CheckpointManager`
for the `last` checkpoint and auto-resume.  Best-by-metric checkpoints
need validation, which is not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, "last.pt")

    def save(self, state: Dict[str, Any], step: int):
        """Write `state` as `last` atomically (a reader never sees half a
        file)."""
        tmp = self.path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path)
        with open(os.path.join(self.directory, "meta.json"), "w") as f:
            json.dump({"last_step": int(step)}, f)

    def restore(self, map_location=None) -> Optional[Dict[str, Any]]:
        """The saved `last` state, or None if there is none."""
        if not os.path.exists(self.path):
            return None
        return torch.load(self.path, map_location=map_location,
                          weights_only=True)
