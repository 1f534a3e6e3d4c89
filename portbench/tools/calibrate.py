"""Readings that the limits of `correct` are set from (on the card).

    python3 portbench/tools/calibrate.py --workload kitti_stereo.train_b1 \\
        --seeds 1,2,3 [--control-seeds 1,2,3] [--witness-seeds 1] \\
        [--seconds 3] [--out readings.jsonl] [--device cuda]

For each seed of `--seeds`, one process runs the cell as a benchmark run
does (set-up, a `--seconds` window at the cell's own load, the program
freed, the reference) and records the compared numbers: the program's
readings.  For `--control-seeds` it also reads the control: the plain
reference computed in float8 (`core/lowp.py`) in the program's place,
against the float32 reference on the same inputs.  For `--witness-seeds`
(train mixes) it reads the program run in float32 with TF32 off against
the same reference, a second witness of whether a gap is rounding.  Each
train reading lists the leaves with the widest gaps.  One JSON line a
reading goes to stdout and to `--out`.  The benchmark's runs never run
this.
"""
from __future__ import annotations

import argparse
import copy
import importlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def leaf_table(prog: dict, ref: dict, n: int = 8) -> dict:
    from portbench.core import check

    keep = check.kept_leaves(ref["grad_norms"])
    out = {}
    for key in ("grad_norms", "change_norms"):
        vals = sorted(ref[key][k] for k in keep)
        med = vals[len(vals) // 2]
        gaps = sorted(((abs(prog[key][k] - ref[key][k])
                        / max(ref[key][k], med), k) for k in keep),
                      reverse=True)
        g = [x for x, _ in gaps]
        out[key] = {"worst": [[k, x, prog[key][k], ref[key][k]]
                              for x, k in gaps[:n]],
                    "median_leaf_gap": g[len(g) // 2],
                    "p90_leaf_gap": g[len(g) // 10],
                    "over_0.1": sum(1 for x in g if x > 0.1),
                    "leaves": len(g)}
    return out


def runner_for(spec, mix, seed, device):
    return importlib.import_module(
        f"portbench.core.{mix['kind']}").Runner(spec, mix, seed, device)


def read_train(bench, w, seed, seconds, control, witness, device):
    import torch

    from portbench.core.check import verdict
    from portbench.core import lowp
    from portbench.core.train import compare_steps

    spec, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    r = runner_for(spec, mix, seed, device)
    r.setup()
    r.window(seconds)
    r.release()
    prog = r.program_steps()
    runs = [("program", prog)]
    if control:
        runs.append(("control_float8",
                     r.reference_steps(mode=lowp.float8())))
    if witness:
        spec32 = copy.deepcopy(spec)
        spec32["config"]["compute_dtype"] = "float32"
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            r32 = runner_for(spec32, mix, seed, device)
            r32.setup()
            runs.append(("witness_program_float32", r32.program_steps()))
            r32.release()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
    ref = r.reference_steps(grids=[run["argmax"] for _, run in runs])
    rows = []
    for k, (name, run) in enumerate(runs):
        numbers, info = compare_steps(run, ref, grid=k)
        row = {"reading": name, "numbers": numbers, "info": info,
               "leaves": leaf_table(run, ref)}
        if name == "program":
            row["checks"] = verdict(numbers, bench.limits(w["name"]))[1]
        rows.append(row)
    return rows


def read_serve(bench, w, seed, seconds, control, witness, device):
    import torch

    from portbench.core import lowp
    from portbench.core.check import verdict
    from portbench.core.serve import deficit_ratio

    spec, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    r = runner_for(spec, mix, seed, device)
    r.setup()
    out = r.window(seconds)
    r.release()
    res = r.check(out)
    rows = [{"reading": "program", "numbers": res["numbers"],
             "info": res["info"],
             "checks": verdict(res["numbers"], bench.limits(w["name"]))[1]}]
    if control:
        frames = r.sample(len(out["grids"]))
        served = {i: lg.argmax(-1).to(torch.uint8) for i, lg, _ in
                  r.reference_logits(frames, mode=lowp.float8())}
        numbers, info = deficit_ratio(r.reference_logits(frames), served,
                                      device)
        rows.append({"reading": "control_float8", "numbers": numbers,
                     "info": info})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=REPO,
                    help="checkout holding BENCHMARK.json")
    args = ap.parse_args()

    from portbench.core.spec import Bench

    bench = Bench(args.root)
    w = bench.workload(args.workload)
    kind = bench.mix(w["traffic"])["kind"]
    read = {"train": read_train, "serve": read_serve}[kind]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    for seed in seeds + sorted((control | witness) - set(seeds)):
        t0 = time.perf_counter()
        rows = read(bench, w, seed, args.seconds, seed in control,
                    seed in witness, args.device)
        for row in rows:
            row.update(workload=args.workload, seed=seed,
                       seconds=time.perf_counter() - t0)
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
