"""Training metrics as JSON lines (`metrics.jsonl` in the run directory).

Counterpart of `occdepth_tpu/training/logging.py::MetricsLogger`, without
its optional TensorBoard writer: one record per call, {"step", "time",
<prefix><name>: float, ...}, appended and closed at once.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, logdir: str, name: str = "metrics"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"{name}.jsonl")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
