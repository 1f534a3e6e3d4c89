"""Training loop: datasets -> train steps -> validation, metrics and
checkpoints.

Counterpart of `occdepth_tpu/training/trainer.py::Trainer` on one device.
`Trainer(cfg, logdir, device=None).fit(train_ds, val_ds, max_steps)` takes
map-style datasets of per-sample dicts (the disk datasets of
`make_datasets(cfg)` when none are given), trains epoch by epoch on a
shuffled `Loader`, validates at every epoch end, logs the `train/*` and
`val/*` metrics to `<logdir>/<exp_name>/metrics.jsonl`, and keeps the
`last` and best-by-metric checkpoints; a new Trainer auto-resumes `last`.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.kitti import Loader
from occdepth_tpu_torch.data.params import class_names_for
from occdepth_tpu_torch.losses.metrics import SSCMetrics
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.training.checkpoint import CheckpointManager
from occdepth_tpu_torch.training.logging import MetricsLogger
from occdepth_tpu_torch.training.optim import lr_at, make_optimizer
from occdepth_tpu_torch.training.step import eval_step, train_step

INIT_SEED = 42  # the JAX trainer initialises from PRNGKey(42)


def exp_name(cfg: OccDepthConfig) -> str:
    """Experiment directory name from the config flags."""
    parts = [
        cfg.exp_prefix,
        cfg.dataset,
        f"{cfg.full_scene_size[0]}x{cfg.full_scene_size[1]}x{cfg.full_scene_size[2]}",
        cfg.trans_2d_to_3d,
        cfg.backbone_2d_name,
        f"f{cfg.feature}",
    ]
    if cfg.context_prior:
        parts.append("crp")
    if cfg.cascade_cls:
        parts.append("cascade")
    if cfg.occluded_cls:
        parts.append("occluded")
    if cfg.with_depth_gt:
        parts.append("depthgt")
    parts.append(f"run{cfg.run}")
    return "_".join(parts)


def make_datasets(cfg: OccDepthConfig):
    """(train, val) disk datasets for the config's dataset."""
    if cfg.dataset == "kitti":
        from occdepth_tpu_torch.data.kitti import KittiDataset

        return (KittiDataset(cfg, "train", fliplr=0.5),
                KittiDataset(cfg, "val", fliplr=0.0))
    if cfg.dataset == "tartanair":
        from occdepth_tpu_torch.data.tartanair import TartanAirDataset

        return (TartanAirDataset(cfg, "train", fliplr=0.5),
                TartanAirDataset(cfg, "val", fliplr=0.0))
    if cfg.dataset == "NYU":
        from occdepth_tpu_torch.data.nyu import NYUDataset

        return (NYUDataset(cfg, "train", fliplr=0.5),
                NYUDataset(cfg, "test", fliplr=0.0))
    raise ValueError(cfg.dataset)


def nominal_total_batches(steps_per_epoch: int) -> int:
    """Denominator of the sem-step-decay progress fraction: the reference
    pins it to a nominal 30-epoch schedule whatever max_epochs is
    (OccDepth.py:140-147), with the real per-epoch step count."""
    return steps_per_epoch * 30


def strip_metadata(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if k not in ("frame_id", "sequence")}


class Trainer:
    """Trains and validates `OccDepthModel(cfg)` on one device.

    `device=None` means CUDA; without a GPU that raises unless the caller
    passes `device="cpu"`.  The model is initialised with PyTorch's default
    initialisers from INIT_SEED, unless a `last` checkpoint exists under
    the run directory, which is then restored (params, BN statistics,
    optimizer state, step).  The batch size is cfg.batch_size_per_gpu.
    """

    def __init__(self, cfg: OccDepthConfig, logdir: Optional[str] = None,
                 device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer: no CUDA device (pass "
                                   "device='cpu' to train on the CPU)")
            device = "cuda"
        self.cfg = cfg
        self.device = torch.device(device)
        self.logdir = os.path.join(logdir or cfg.logdir, exp_name(cfg))
        os.makedirs(self.logdir, exist_ok=True)
        self.global_batch = cfg.batch_size_per_gpu
        self.class_names = class_names_for(cfg.dataset)
        self.metrics_logger = MetricsLogger(self.logdir)
        self.ckpt = CheckpointManager(os.path.join(self.logdir, "checkpoints"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(INIT_SEED)
            model = OccDepthModel(cfg)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), cfg)
        self.step = 0
        self.step_ms = []  # CUDA-event time of each step fit ran (CUDA only)
        state = self.ckpt.restore("last", map_location=self.device)
        if state is not None:
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.step = int(state["step"])
            print(f"resumed from step {self.step}")

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()
                if isinstance(v, (np.ndarray, torch.Tensor))}

    def _state(self) -> Dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def fit(self, train_ds=None, val_ds=None,
            max_steps: Optional[int] = None) -> "Trainer":
        """Train from `self.step` for cfg.max_epochs epochs, or until
        `max_steps` optimizer steps; one step is `accumulate_grad_batches`
        batches (a trailing partial group in an epoch is dropped).

        Every epoch end validates on `val_ds`, logs train and val metrics,
        and saves `last` plus the best-by-val/mIoU and val/IoU checkpoints.
        The shuffle order and the augmentation draws are functions of the
        epoch, so a resumed run replays what an uninterrupted one would.
        """
        cfg = self.cfg
        if train_ds is None or val_ds is None:
            train_ds, val_ds = make_datasets(cfg)
        for name, ds in (("train", train_ds), ("val", val_ds)):
            if len(ds) == 0:
                raise RuntimeError(
                    f"{name} dataset is empty — check data_root="
                    f"{cfg.data_root!r} / data_preprocess_root="
                    f"{cfg.data_preprocess_root!r}")
        workers = max(1, cfg.num_workers_per_gpu)
        train_loader = Loader(train_ds, self.global_batch, shuffle=True,
                              num_workers=workers)
        val_loader = Loader(val_ds, self.global_batch, shuffle=False,
                            drop_last=False, num_workers=workers)
        accum = max(1, cfg.accumulate_grad_batches)
        steps_per_epoch = max(1, len(train_loader) // accum)
        total_batches = nominal_total_batches(steps_per_epoch)
        train_metrics = SSCMetrics(cfg.n_classes)
        on_cuda = self.device.type == "cuda"

        def done() -> bool:
            return max_steps is not None and self.step >= max_steps

        start_step, t_start = self.step, time.time()
        start_epoch = self.step // steps_per_epoch
        train_loader.epoch = start_epoch
        for epoch in range(start_epoch, cfg.max_epochs):
            if done():
                break
            if hasattr(train_ds, "reseed"):
                train_ds.reseed(epoch)
            micro = []
            for batch in train_loader:
                micro.append(self._to_device(strip_metadata(batch)))
                if len(micro) < accum:
                    continue
                if on_cuda:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                logs, completion, conf = train_step(
                    cfg, self.model, self.optimizer, micro,
                    min(1.0, self.step / total_batches),
                    lr_at(cfg, steps_per_epoch, self.step),
                )
                if on_cuda:
                    ev[1].record()
                micro = []
                train_metrics.merge(completion, conf)  # waits for the step
                if on_cuda:
                    self.step_ms.append(ev[0].elapsed_time(ev[1]))
                self.step += 1
                if self.step % max(1, cfg.log_every_n_steps) == 0:
                    logs = {k: float(v) for k, v in logs.items()}
                    logs["steps_per_sec"] = (self.step - start_step) / max(
                        1e-9, time.time() - t_start)
                    logs["lr"] = lr_at(cfg, steps_per_epoch, self.step)
                    self.metrics_logger.log(self.step, logs, prefix="train/")
                if done():
                    break

            val_stats = self.validate(val_loader)
            stats = train_metrics.get_stats()
            epoch_logs = {
                "train/mIoU": stats["iou_ssc_mean"],
                "train/IoU": stats["iou"],
                "val/mIoU": val_stats["iou_ssc_mean"],
                "val/IoU": val_stats["iou"],
                "val/Precision": val_stats["precision"],
                "val/Recall": val_stats["recall"],
            }
            for name, iou in zip(self.class_names,
                                 val_stats["iou_ssc"].tolist()):
                epoch_logs[f"val/IoU_{name}"] = iou
            for k, v in val_stats.get("losses", {}).items():
                epoch_logs[f"val/{k}"] = v
            self.metrics_logger.log(self.step, epoch_logs)
            train_metrics.reset()
            self.ckpt.save(self._state(), self.step, {
                "val/mIoU": val_stats["iou_ssc_mean"],
                "val/IoU": val_stats["iou"],
            })
        return self

    def validate(self, val_loader) -> Dict:
        """Full-val metrics and mean val losses, with the model in eval
        mode.

        A ragged final batch is padded up to the batch size with repeated
        rows and a `sample_valid` mask, so padded rows never reach the
        confusion counts; the val losses are averaged over the full
        batches only (padding would bias the mean).  Besides SSCMetrics'
        stats the result holds the summed `completion` and `conf` counts,
        `n_frames` (the rows counted) and, on CUDA, `ms_per_frame` (CUDA
        events around each eval step, over the counted rows).
        """
        metrics = SSCMetrics(self.cfg.n_classes)
        gb = self.global_batch
        loss_sums: Dict[str, float] = {}
        n_loss_batches = n_frames = 0
        device_ms = 0.0
        on_cuda = self.device.type == "cuda"
        for batch in val_loader:
            batch = strip_metadata(batch)
            bs = next(iter(batch.values())).shape[0]
            valid = np.ones((gb,), bool)
            if bs < gb:
                valid[bs:] = False
                batch = {k: np.concatenate([v] + [v[:1]] * (gb - bs))
                         for k, v in batch.items()}
            batch["sample_valid"] = valid
            batch = self._to_device(batch)
            if on_cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            logs, completion, conf = eval_step(self.cfg, self.model, batch)
            if on_cuda:
                ev[1].record()
            metrics.merge(completion, conf)  # waits for the step
            if on_cuda:
                device_ms += ev[0].elapsed_time(ev[1])
            n_frames += min(bs, gb)
            if bs == gb:
                n_loss_batches += 1
                for k, v in logs.items():
                    loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
        stats = metrics.get_stats()
        stats.update(completion=metrics.completion.copy(),
                     conf=metrics.conf.copy(), n_frames=n_frames)
        if on_cuda and n_frames:
            stats["ms_per_frame"] = device_ms / n_frames
        if n_loss_batches:
            stats["losses"] = {k: v / n_loss_batches
                               for k, v in loss_sums.items()}
        return stats
