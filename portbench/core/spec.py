"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

    BENCHMARK.json                       the cells, metrics and bounds
    portbench/configs/<config>.json      a configuration (named by the
                                         `file` of its `configs` entry)
    portbench/mixes/<traffic>.json       a traffic mix's parameters
    portbench/limits/<workload>.json     the limits of `correct`'s numbers
    portbench/metrics/<metric>.py        a per-layer metric's reader

A new configuration, mix, cell or per-layer metric is a new file and a new
entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PORTBENCH)


class Bench:
    def __init__(self, root: str = REPO):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.pb = os.path.join(root, "portbench")

    def _load(self, *parts):
        with open(os.path.join(self.pb, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        return self._load("mixes", f"{traffic}.json")

    def limits(self, workload: str) -> dict:
        return self._load("limits", f"{workload}.json")

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str):
        path = os.path.join(self.pb, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
