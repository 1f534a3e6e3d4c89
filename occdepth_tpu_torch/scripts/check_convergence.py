"""Convergence check at realistic shapes: sustained loss descent and a
mid-run SIGKILL/resume splice, through the port's train CLI.

Counterpart of `occdepth_tpu/scripts/check_convergence.py`.  Trains the
flagship SemanticKITTI config (370x1220 stereo, 256x256x32 grid) on a
synthetic on-disk KITTI tree (`testing.make_kitti_tree`: 10 train
sequences x `--frames`, random images and labels, which the model
memorises, so the loss must fall), SIGKILLs the run at `--kill-step`,
relaunches the same command (auto-resume, reference
scripts/train.py:173-206) and checks:

  * the relaunch resumed from the last epoch checkpoint (its log says so);
  * sustained descent: the mean train loss of the last `--tail` steps is
    below that of the first `--tail` steps by at least `--min-drop`;
  * no NaN or inf among the logged losses.

Prints a summary JSON; exits 1 when a check fails.

    python -m occdepth_tpu_torch.scripts.check_convergence \\
        --base DIR --epochs 15 --kill-step 150 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

from occdepth_tpu_torch.scripts.check_resume_determinism import (
    metrics_path,
    run_and_kill,
    run_to_completion,
)

FLAGSHIP = "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"


def train_cmd(base: str, logdir: str, epochs: int, device=None) -> list:
    from occdepth_tpu_torch.config import default_config_path

    return [
        sys.executable, "-m", "occdepth_tpu_torch.scripts.train",
        "--config", default_config_path(FLAGSHIP),
        *(["--device", device] if device else []),
        f"max_epochs={epochs}", "batch_size_per_gpu=1",
        "num_workers_per_gpu=0", f"data_root={base}/kitti",
        f"data_preprocess_root={base}/pre",
        f"data_stereo_depth_root={base}/stereo_depth",
        "log_every_n_steps=1", f"logdir={logdir}",
    ]


def read_train_losses(logdir: str) -> dict:
    """step -> the last train loss written for it (a resumed run replays
    the partial epoch; the final word per step is the curve)."""
    losses = {}
    with open(metrics_path(logdir)) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue  # a line cut by the SIGKILL
            if "train/loss" in r:
                losses[r["step"]] = r["train/loss"]
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default=None,
                    help="working directory (a new temporary one by "
                         "default): the tree, run/, train.log")
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--kill-step", type=int, default=150)
    ap.add_argument("--tail", type=int, default=30,
                    help="window of the first-vs-last loss means")
    ap.add_argument("--min-drop", type=float, default=0.5,
                    help="required (first mean - last mean) in loss units")
    ap.add_argument("--frames", type=int, default=2,
                    help="frames per synthetic sequence (an epoch is 10x "
                         "this)")
    ap.add_argument("--device", default=None,
                    help="the train CLI's --device; CUDA by default")
    args = ap.parse_args(argv)

    base = args.base or tempfile.mkdtemp(prefix="conv_check_")
    logdir = os.path.join(base, "run")
    log_file = os.path.join(base, "train.log")
    if os.path.exists(logdir):
        raise SystemExit(f"{logdir} exists: use a fresh --base")
    if not os.path.isdir(os.path.join(base, "kitti")):
        from occdepth_tpu_torch.testing import make_kitti_tree

        make_kitti_tree(base, n_frames=args.frames)
        print("synthetic KITTI tree built", flush=True)
    cmd = train_cmd(base, logdir, args.epochs, args.device)
    killed_at, killed = run_and_kill(cmd, log_file, logdir, args.kill_step)
    print(f"segment 1 ended at step {killed_at} (killed={killed})",
          flush=True)
    run_to_completion(cmd, log_file)  # auto-resume from the checkpoint

    with open(log_file) as f:
        resumed = "resumed from step" in f.read()
    losses = read_train_losses(logdir)
    steps = sorted(losses)
    vals = [losses[s] for s in steps]
    finite = all(math.isfinite(v) for v in vals)
    head = sum(vals[:args.tail]) / args.tail
    tail = sum(vals[-args.tail:]) / args.tail
    summary = {
        "metric": "convergence",
        "steps_logged": len(steps), "first_step": steps[0],
        "last_step": steps[-1], "head_mean_loss": head,
        "tail_mean_loss": tail, "drop": head - tail,
        "min_drop": args.min_drop, "finite": finite,
        "killed_at": killed_at, "resume_exercised": killed and resumed,
        "epochs": args.epochs, "config": FLAGSHIP + ".yaml",
        "tree": f"make_kitti_tree(n_frames={args.frames}): 10 train "
                "sequences, batch 1",
    }
    summary["ok"] = bool(finite and head - tail >= args.min_drop
                         and summary["resume_exercised"]
                         and len(steps) >= 2 * args.tail)
    print(json.dumps(summary))
    if not summary["ok"]:
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
