"""The harness on the CPU: cells added as files and entries alone, the
names BENCHMARK.json may hold, a whole run with the timed path broken
underneath, the control, and the run's refusal without a card."""
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from portbench.core.cell import run_cell
from portbench.core.spec import PORTBENCH, REPO, Bench
from portbench.tests.helpers import tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 4321


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_mix_cell_and_metric_are_new_files_and_entries(tmp_path):
    b = tiny_bench(str(tmp_path))
    pb = os.path.join(b.root, "portbench")
    # a further per-layer metric: a reader file and an entry
    with open(os.path.join(pb, "metrics", "frames_traced.serve.py"),
              "w") as f:
        f.write("def read(ctx):\n"
                "    return float(ctx.stretch.units) if ctx.stretch else None\n")
    data = json.load(open(os.path.join(b.root, "BENCHMARK.json")))
    data["per_layer"].append({
        "name": "frames_traced.serve", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "serving",
        "moves": "frames_per_s", "workloads": ["tiny_kitti.serve_tiny"]})
    json.dump(data, open(os.path.join(b.root, "BENCHMARK.json"), "w"))
    b = Bench(b.root)

    before, after = _tree(PORTBENCH), _tree(pb)
    assert all(after.get(k) == v for k, v in before.items())  # no edits
    orig = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in orig[key]:  # every entry kept; new ones appended
            kept = [x for x in b.data[key] if x["name"] == e["name"]][0]
            assert {k: v for k, v in kept.items() if k != "workloads"} == {
                k: v for k, v in e.items() if k != "workloads"}
            assert kept.get("workloads", [])[:len(e.get("workloads", []))] \
                == e.get("workloads", [])

    assert "frames_traced.serve" in [
        m["name"] for m in b.per_layer("tiny_kitti.serve_tiny")]
    read = b.reader("frames_traced.serve")
    assert read(SimpleNamespace(stretch=SimpleNamespace(units=4))) == 4.0
    for cell in ("tiny_kitti.serve_tiny", "tiny_kitti.train_b1",
                 "tiny_tartanair.train_b1"):
        r = run_cell(cell, SEED, 0.5, False, time.perf_counter(), "cpu", b)
        assert r["correct"], (cell, r["checks"])
        assert set(r["metrics"]) == {m["name"] for m in b.end_to_end(cell)}
        assert list(r)[-1] == "checks"


def test_benchmark_json_keeps_to_the_contract():
    b = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == [] and os.path.isfile(
            os.path.join(REPO, c["file"]))
        assert c["name"] in [w["config"] for w in b["workloads"]]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(PORTBENCH, "mixes",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(PORTBENCH, "limits",
                                           w["name"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert os.path.isfile(os.path.join(PORTBENCH, "metrics",
                                           m["name"] + ".py"))
        for w in m["workloads"]:  # each listed cell reports what it moves
            assert w in [e["name"] for e in b["workloads"]]
            assert any(x["name"] == m["moves"] and w in x.get(
                "workloads", [w]) for x in b["end_to_end"])
    for c in cells:  # every cell: setup_s, one more end-to-end, a layer
        assert sum(1 for m in b["end_to_end"]
                   if c in m.get("workloads", [c])) >= 2
        assert any(c in m["workloads"] for m in b["per_layer"])


def test_served_answers_altered_come_out_incorrect(tmp_path, monkeypatch):
    from occdepth_tpu_torch.serving import pipeline

    serve = pipeline.ServingPipeline._serve
    monkeypatch.setattr(
        pipeline.ServingPipeline, "_serve",
        lambda self, x: (serve(self, x).long() + 1).remainder(
            self.cfg.n_classes).to(serve(self, x).dtype))
    b = tiny_bench(str(tmp_path))
    r = run_cell("tiny_kitti.serve_tiny", SEED, 0.5, False,
                 time.perf_counter(), "cpu", b)
    assert not r["correct"]


def test_step_that_leaves_its_state_unchanged_comes_out_incorrect(
        tmp_path, monkeypatch):
    from occdepth_tpu_torch.training import step

    monkeypatch.setattr(step, "apply_update", lambda cfg, opt, lr: None)
    b = tiny_bench(str(tmp_path))
    r = run_cell("tiny_kitti.train_b1", SEED, 0.5, False,
                 time.perf_counter(), "cpu", b)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > 0.9


@pytest.mark.parametrize("cell", ["tiny_kitti.serve_tiny",
                                  "tiny_kitti.train_b1"])
def test_control_in_the_programs_place_comes_out_incorrect(tmp_path, cell):
    """The plain reference computed in float8 (the nearest precision below
    the configurations' bfloat16) fails the cells' limits, where the
    program passes them (`tools/calibrate.py`, the readings the limits are
    set from, at the tiny configuration)."""
    sys.path.insert(0, os.path.join(PORTBENCH, "tools"))
    try:
        import calibrate
    finally:
        sys.path.pop(0)
    from portbench.core.check import verdict

    b = tiny_bench(str(tmp_path))
    w = b.workload(cell)
    read = calibrate.read_serve if "serve" in cell else calibrate.read_train
    rows = {r["reading"]: r for r in read(b, w, SEED, 0.5, True, False,
                                          "cpu")}
    limits = b.limits(cell)
    assert verdict(rows["program"]["numbers"], limits)[0]
    assert not verdict(rows["control_float8"]["numbers"], limits)[0]


def test_run_without_a_card_prints_nothing_and_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(PORTBENCH, "run.py"), "--workload",
         "kitti_stereo.serve_b8", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0 and out.stdout == ""
