"""End-to-end kill/resume determinism check through the port's train CLI.

Counterpart of `occdepth_tpu/scripts/check_resume_determinism.py`.  The
reference auto-resumes from last.ckpt (occdepth/scripts/train.py:173-206):
a crashed run, restarted with the same command, continues as if never
interrupted.  The port's Trainer checkpoints at epoch ends, keys the
shuffle order to the epoch and the augmentation draws to (seed, epoch,
index), so a resumed run replays the interrupted epoch exactly.  This
script shows it end to end:

  1. builds the synthetic TartanAir toy tree (`testing.make_tartanair_tree`,
     `--frames` train and val frames, 16x8x16 voxels at 0.3 m);
  2. run A trains `--epochs` epochs straight through, logging every step;
  3. run B, the same command started beside A, is SIGKILLed (with every
     process it started) once its metrics.jsonl crosses `--kill-step`,
     then relaunched verbatim: auto-resume restores the last epoch-end
     checkpoint and replays the interrupted epoch;
  4. compares every logged metric of B with A at every step (train losses,
     lr, the epoch's val metrics), and the two `last` checkpoints tensor
     by tensor (`torch.load`), bitwise, reporting the largest relative
     difference of a value and of a tensor's norm.

Both runs train with `deterministic=true` (`Trainer`'s
`use_deterministic_algorithms`).  On the CPU the runs are bitwise equal.
On CUDA the ops without a deterministic implementation warn, and the
summary lists them (`nondeterministic_ops`, read from the runs' logs)
with the largest relative difference they left.  `--nproc N` runs both
runs under `torchrun` (N gloo ranks on the CPU, N GPUs under NCCL).

The toy tree at batch 1 trains `--frames` steps an epoch, so `--epochs 60`
is 120 steps; `--kill-step` must be below that and should land after the
first epoch's checkpoint and before the last step (the default, 61, is
one step into epoch 31).  `key=value` overrides go to both runs after the
tiny sizes below.

    python -m occdepth_tpu_torch.scripts.check_resume_determinism \\
        --base DIR --epochs 60 --kill-step 61 [--device cpu] [--nproc N]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

TA_CONFIG = "tartanair/flosp_crp_cascadecls"
SKIP_KEYS = {"time", "steps_per_sec"}
TOY = ["full_scene_size=[16,8,16]", "scene_size_m=[4.8,2.4,4.8]",
       "voxel_size_m=0.3", "feature=16", "feature_2d_oc=16",
       "frustum_size=2", "project_1_8=false", "compute_dtype=float32",
       "num_workers_per_gpu=0", "log_every_n_steps=1", "deterministic=true"]
NONDETERMINISTIC = re.compile(
    r"(\w+) does not have a deterministic implementation")


def build_tree(base: str, frames: int) -> None:
    from occdepth_tpu_torch.testing import make_tartanair_tree

    make_tartanair_tree(base, n_frames=frames)


def train_cmd(base: str, logdir: str, epochs: int, device=None,
              nproc: int = 1, overrides=()) -> list:
    from occdepth_tpu_torch.config import default_config_path

    launcher = [sys.executable, "-m"]
    if nproc > 1:
        launcher += ["torch.distributed.run", "--standalone",
                     f"--nproc_per_node={nproc}", "-m"]
    return launcher + [
        "occdepth_tpu_torch.scripts.train",
        "--config", default_config_path(TA_CONFIG),
        *(["--device", device] if device else []),
        f"max_epochs={epochs}", f"data_root={base}/ta",
        f"data_preprocess_root={base}/ta_pre", f"logdir={logdir}",
        *TOY, *overrides,
    ]


def metrics_path(logdir: str) -> str:
    hits = glob.glob(os.path.join(logdir, "*", "metrics.jsonl"))
    return hits[0] if hits else ""


def last_step(logdir: str) -> int:
    last, path = 0, metrics_path(logdir)
    if path:
        with open(path) as f:
            for line in f:
                try:
                    last = max(last, json.loads(line)["step"])
                except (json.JSONDecodeError, KeyError):
                    pass  # a line cut by the SIGKILL
    return last


def read_records(logdir: str) -> dict:
    """(step, is-epoch-record) -> the last record written for it (a
    resumed run rewrites the replayed steps; `compare` holds the final
    word to run A's)."""
    recs = {}
    with open(metrics_path(logdir)) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue  # a line cut by the SIGKILL; the resume rewrites it
            recs[(r["step"], "val/mIoU" in r)] = r
    return recs


def start(cmd, log_file) -> subprocess.Popen:
    """`cmd` in a session of its own (a SIGKILL then reaches torchrun's
    ranks too), output appended to `log_file`."""
    with open(log_file, "a") as lf:
        return subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT,
                                start_new_session=True)


def kill(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def run_to_completion(cmd, log_file) -> None:
    proc = start(cmd, log_file)
    try:
        if proc.wait():
            raise RuntimeError(f"{' '.join(cmd)} exited with "
                               f"{proc.returncode}; see {log_file}")
    finally:
        kill(proc)


def run_and_kill(cmd, log_file, logdir, kill_step, poll=0.25):
    """(step reached, whether the SIGKILL landed before the run ended)."""
    proc = start(cmd, log_file)
    try:
        while proc.poll() is None:
            time.sleep(poll)
            if last_step(logdir) >= kill_step:
                kill(proc)
                if proc.returncode == -signal.SIGKILL:
                    return last_step(logdir), True
    finally:
        kill(proc)
    last = last_step(logdir)
    if last >= kill_step:
        print(f"WARNING: run B finished (rc={proc.returncode}) before the "
              f"SIGKILL landed (step {last} >= {kill_step}); the resume "
              "path was NOT exercised", flush=True)
        return last, False
    raise RuntimeError(f"run B finished (rc={proc.returncode}) at step "
                       f"{last}, before the kill step {kill_step}")


def rel_diff(a, b) -> float:
    if a == b:
        return 0.0
    if not all(isinstance(v, (int, float)) for v in (a, b)):
        return math.inf
    return abs(a - b) / max(abs(a), 1e-30)


def compare(rec_a, rec_b):
    common = sorted(set(rec_a) & set(rec_b))
    missing = sorted(set(rec_a) ^ set(rec_b))
    mismatches, n_vals, worst = [], 0, 0.0
    for key in common:
        a, b = rec_a[key], rec_b[key]
        for k in sorted(set(a) | set(b)):
            if k.rsplit("/", 1)[-1] in SKIP_KEYS:
                continue
            n_vals += 1
            d = rel_diff(a.get(k), b.get(k))
            worst = max(worst, d)
            if d > 0:  # bitwise: JSON round-trips float64
                mismatches.append((key, k, a.get(k), b.get(k)))
    return common, missing, n_vals, mismatches, worst


def checkpoint_leaves(logdir: str) -> dict:
    """The `last` checkpoint's tensors and numbers by path (the model's
    state_dict, the AdamW state and groups, the step)."""
    import torch

    hits = glob.glob(os.path.join(logdir, "*", "checkpoints", "last.pt"))
    if not hits:
        raise RuntimeError(f"no last checkpoint under {logdir}")
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", torch.load(hits[0], map_location="cpu", weights_only=True))
    return flat


def leaf_diff(a, b) -> float:
    import torch

    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return math.inf
        if torch.equal(a, b):
            return 0.0
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b)) / max(
            float(torch.linalg.vector_norm(a)), 1e-30)
    return rel_diff(a, b)


def nondeterministic_ops(*logs) -> list:
    ops = set()
    for path in logs:
        with open(path) as f:
            ops.update(NONDETERMINISTIC.findall(f.read()))
    return sorted(ops)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default=None,
                    help="working directory (a new temporary one by "
                         "default): the tree, A/, B/, A.log, B.log")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--kill-step", type=int, default=61)
    ap.add_argument("--frames", type=int, default=2,
                    help="frames per sequence of the toy tree (train "
                         "steps per epoch at batch 1)")
    ap.add_argument("--device", default=None,
                    help="the train CLI's --device; CUDA by default")
    ap.add_argument("--nproc", type=int, default=1,
                    help="processes per run; above 1, under torchrun")
    ap.add_argument("overrides", nargs="*",
                    help="key=value config overrides for both runs")
    args = ap.parse_args(argv)

    base = args.base or tempfile.mkdtemp(prefix="resume_check_")
    os.makedirs(base, exist_ok=True)
    dir_a, dir_b = os.path.join(base, "A"), os.path.join(base, "B")
    log_a, log_b = os.path.join(base, "A.log"), os.path.join(base, "B.log")
    for path in (dir_a, dir_b, log_a, log_b):
        if os.path.exists(path):
            raise SystemExit(f"{path} exists: use a fresh --base (a stale "
                             "run would auto-resume)")
    build_tree(base, args.frames)

    def cmd(logdir):
        return train_cmd(base, logdir, args.epochs, args.device, args.nproc,
                         args.overrides)

    t0 = time.time()
    print(f"runs A ({args.epochs} epochs straight through) and B (SIGKILL "
          f"at step >= {args.kill_step}, then resumed) side by side",
          flush=True)
    run_a = start(cmd(dir_a), log_a)
    try:
        killed_at, was_killed = run_and_kill(cmd(dir_b), log_b, dir_b,
                                             args.kill_step)
        print(f"run B killed at step {killed_at}; relaunching", flush=True)
        run_to_completion(cmd(dir_b), log_b)
        if run_a.wait():
            raise RuntimeError(f"run A exited with {run_a.returncode}; see "
                               f"{log_a}")
    finally:
        kill(run_a)
    print(f"runs done in {time.time() - t0:.0f}s", flush=True)
    with open(log_b) as f:
        resumed = "resumed from step" in f.read()

    common, missing, n_vals, mismatches, worst = compare(
        read_records(dir_a), read_records(dir_b))
    ck_a, ck_b = checkpoint_leaves(dir_a), checkpoint_leaves(dir_b)
    ck_diff = {k: (leaf_diff(ck_a[k], ck_b[k])
                   if k in ck_a and k in ck_b else math.inf)
               for k in sorted(set(ck_a) | set(ck_b))}
    ck_bad = [k for k, d in ck_diff.items() if d > 0]
    summary = {
        "metric": "resume_determinism",
        "device": args.device or "cuda", "nproc": args.nproc,
        "epochs": args.epochs, "killed_at_step": killed_at,
        "resume_exercised": was_killed and resumed,
        "records_compared": len(common), "values_compared": n_vals,
        "records_missing_either_side": len(missing),
        "value_mismatches": len(mismatches), "max_value_rel_diff": worst,
        "checkpoint_leaves": len(ck_a),
        "checkpoint_leaf_mismatches": len(ck_bad),
        "max_checkpoint_rel_diff": max(ck_diff.values(), default=0.0),
        "nondeterministic_ops": nondeterministic_ops(log_a, log_b),
        "base": base,
    }
    summary["ok"] = summary["bitwise"] = (
        summary["resume_exercised"] and not mismatches and not missing
        and not ck_bad and len(common) > 0)
    print(json.dumps(summary))
    for m in mismatches[:20]:
        print("MISMATCH", m)
    for k in ck_bad[:20]:
        print("CKPT-MISMATCH", k, ck_diff[k])
    if not summary["ok"]:
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
