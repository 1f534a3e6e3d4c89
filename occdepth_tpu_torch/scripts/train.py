"""Training CLI: train a config on its disk dataset.

Counterpart of `occdepth_tpu/scripts/train.py` (reference
occdepth/scripts/train.py: hydra main + Lightning Trainer) with argparse
and `key=value` overrides:

    python -m occdepth_tpu_torch.scripts.train --config CONFIG.yaml \\
        [--max-steps N] [--device cpu] [key=value ...]

The datasets are `make_datasets(cfg)` (cfg.data_root,
cfg.data_preprocess_root); the run directory is `<logdir>/<exp_name>`,
and a run resumes from its `checkpoints/last` when that exists.  The device
is CUDA unless `--device cpu` is given; without a GPU the CUDA default
raises.

Data parallel, one process per GPU (`parallel/ddp.py`): the same command
under torchrun, e.g. on the CPU with gloo,

    torchrun --standalone --nproc_per_node 2 \\
        -m occdepth_tpu_torch.scripts.train --config CONFIG.yaml \\
        --device cpu [key=value ...]

and on GPUs without `--device` (NCCL, `cuda:LOCAL_RANK`); across nodes,
`--nnodes` is the config's `n_slices`.  The global batch is
batch_size_per_gpu times the number of processes; rank 0 prints the
lines below and writes the logs and checkpoints.
"""
from __future__ import annotations

import argparse

import torch

from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.parallel import ddp
from occdepth_tpu_torch.training.trainer import Trainer


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after this many optimizer steps in all")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA by default, `cpu` to run on "
                         "the CPU")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    trainer = Trainer(cfg, device=args.device)
    start = trainer.step
    trainer.fit(max_steps=args.max_steps)  # make_datasets(cfg)
    if trainer.rank == 0:
        print(f"train: steps {start} -> {trainer.step}, "
              f"metrics {trainer.metrics_logger.path}")
        if trainer.step_ms:
            print("train: ms/step (CUDA events) "
                  + ",".join(f"{t:.1f}" for t in trainer.step_ms))
        if trainer.device.type == "cuda":
            print(f"{trainer.device}: peak_bytes_in_use="
                  f"{torch.cuda.max_memory_allocated(trainer.device)}")
    ddp.shutdown()
    return trainer


if __name__ == "__main__":
    main()
