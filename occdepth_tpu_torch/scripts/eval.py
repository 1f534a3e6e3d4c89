"""Evaluation CLI: run the val split and print the SSC metric table.

Counterpart of `occdepth_tpu/scripts/eval.py` (reference
occdepth/scripts/eval.py: load a checkpoint, run the val dataloader, print
Precision/Recall/IoU, the per-class IoU and the mIoU), plus the device's
peak memory, which the reference prints too:

    python -m occdepth_tpu_torch.scripts.eval --config CONFIG.yaml \\
        [--ckpt last | --torch-ckpt PATH] [--device cpu] [key=value ...]

`--ckpt NAME` restores `<logdir>/<exp_name>/checkpoints/NAME.pt` (`last`,
`best_val_mIoU`, ...); `--torch-ckpt` loads a reference PyTorch `.ckpt`
or state_dict instead.  The device is CUDA unless `--device cpu` is given;
without a GPU the CUDA default raises.  Under torchrun (as the train CLI)
each process evaluates its rows of every global batch and rank 0 prints
the one-process table from the counts summed over the ranks.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from occdepth_tpu_torch.config import OccDepthConfig, load_config, parse_overrides
from occdepth_tpu_torch.data.kitti import Loader
from occdepth_tpu_torch.data.params import class_names_for
from occdepth_tpu_torch.parallel import ddp
from occdepth_tpu_torch.training.trainer import Trainer, make_datasets
from occdepth_tpu_torch.weights import load_reference_checkpoint


def print_stats(stats, class_names) -> None:
    """The reference's metric table, character for character."""
    print("test======")
    print(
        "Precision={:.4f}, Recall={:.4f}, IoU={:.4f}".format(
            stats["precision"] * 100, stats["recall"] * 100,
            stats["iou"] * 100,
        )
    )
    print("class IoU: {}, ".format(class_names))
    print(" ".join(
        "{:.4f},".format(x * 100) for x in stats["iou_ssc"].tolist()
    ))
    print("mIoU={:.4f}".format(stats["iou_ssc_mean"] * 100))


def evaluate(cfg: OccDepthConfig, ckpt: str = "last",
             torch_ckpt: Optional[str] = None, device=None) -> Dict:
    """Load the weights, run `Trainer.validate` over the val split and
    return its stats (metrics, counts, frames, val losses)."""
    trainer = Trainer(cfg, device=device)
    if torch_ckpt:
        load_reference_checkpoint(trainer.model, torch_ckpt)
    else:
        state = trainer.ckpt.restore(ckpt, map_location=trainer.device)
        if state is None:
            raise SystemExit(f"checkpoint '{ckpt}' not found under "
                             f"{trainer.ckpt.directory}")
        trainer.model.load_state_dict(state["model"])
    _, val_ds = make_datasets(cfg)
    val_loader = Loader(val_ds, trainer.global_batch, shuffle=False,
                        drop_last=False, rank=trainer.rank,
                        world=trainer.world)
    return trainer.validate(val_loader)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default="last",
                    help="checkpoint name under <logdir>/<exp>/checkpoints")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference PyTorch .ckpt/.pt to evaluate (the "
                         "released-checkpoint path)")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA by default, `cpu` to run on "
                         "the CPU")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    stats = evaluate(cfg, args.ckpt, args.torch_ckpt, args.device)
    rank = ddp.rank()
    ddp.shutdown()
    if rank:
        return
    print_stats(stats, class_names_for(cfg.dataset))
    if "ms_per_frame" in stats:
        print(f"eval: {stats['n_frames']} frames, "
              f"{stats['ms_per_frame']:.3f} ms/frame (CUDA events)")
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda":
        print(f"{dev}: peak_bytes_in_use="
              f"{torch.cuda.max_memory_allocated(dev)}")


if __name__ == "__main__":
    main()
