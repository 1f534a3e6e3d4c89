"""A copy of the benchmark with CPU-sized cells, for the CPU tests.

`tiny_bench(tmp)` copies BENCHMARK.json and portbench/ into `tmp` and adds,
as new files and entries only, the tiny KITTI and TartanAir
configurations, a serve mix at batch 2 and cells that run them on the
CPU in seconds.  Their limits are those of the benchmark's own cells of
the same kind (`LIMITS_OF`).
"""
from __future__ import annotations

import json
import os
import shutil

from portbench.core.spec import PORTBENCH, REPO, Bench

HERE = os.path.dirname(os.path.abspath(__file__))
TINY_SERVE = {"kind": "serve", "batch_size": 2,
              "max_in_flight": 2, "pool_frames": 4, "check_frames": 3,
              "trace_frames": 4}
LIMITS_OF = {"serve": "kitti_stereo.serve_b8", "train": "kitti_stereo.train_b1"}


def tiny_bench(tmp: str) -> Bench:
    root = os.path.join(tmp, "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(PORTBENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in ("tiny_kitti", "tiny_tartanair"):
        shutil.copy(os.path.join(HERE, "configs", f"{name}.json"),
                    os.path.join(pb, "configs", f"{name}.json"))
        bench["configs"].append({
            "name": name, "source": "https://example.org/tiny",
            "file": f"portbench/configs/{name}.json", "reduced": [],
            "why": "CPU-sized test configuration"})
    with open(os.path.join(pb, "mixes", "serve_tiny.json"), "w") as f:
        json.dump(TINY_SERVE, f)
    cells = {"tiny_kitti.serve_tiny": ("tiny_kitti", "serve_tiny"),
             "tiny_kitti.train_b1": ("tiny_kitti", "train_b1"),
             "tiny_tartanair.train_b1": ("tiny_tartanair", "train_b1")}
    for cell, (config, traffic) in cells.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU test cell"})
        kind = "serve" if traffic.startswith("serve") else "train"
        shutil.copy(os.path.join(pb, "limits", f"{LIMITS_OF[kind]}.json"),
                    os.path.join(pb, "limits", f"{cell}.json"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and LIMITS_OF[kind] in m["workloads"]:
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return Bench(root)
