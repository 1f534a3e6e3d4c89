"""Training loop: datasets -> train steps -> validation, metrics and
checkpoints.

Counterpart of `occdepth_tpu/training/trainer.py::Trainer`, on one device
or, under `torchrun`, on one device per process (`parallel/ddp.py`).
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
from occdepth_tpu_torch.parallel import ddp
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


def use_deterministic_algorithms() -> None:
    """The `deterministic: true` config key (the reference hands it to
    Lightning): deterministic cuDNN, no autotuning, cuBLAS's fixed
    workspace (effective for cuBLAS handles made after this call, so the
    train CLI calls it before any CUDA work) and
    `torch.use_deterministic_algorithms` with `warn_only=True`: an op
    without a deterministic CUDA implementation warns instead of raising.
    On TartanAir's train path that is `avg_pool3d`'s backward alone (the
    3D UNet's shortcut pools, whose windows do not overlap: one atomic
    add per element), and two runs are bitwise equal on the card; OAD's
    and NYU's `F.grid_sample` backward is another such op.
    `scripts/check_resume_determinism.py` lists the ops that warned in a
    run and the largest difference left.  The CPU paths are bitwise
    repeatable."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


class Trainer:
    """Trains and validates `OccDepthModel(cfg)` on one device, or on one
    device per rank under torchrun.

    `device=None` means CUDA; without a GPU that raises unless the caller
    passes `device="cpu"`.  The model is initialised with PyTorch's default
    initialisers from INIT_SEED, unless a `last` checkpoint exists under
    the run directory, which is then restored (params, BN statistics,
    optimizer state, step).  The global batch is cfg.batch_size_per_gpu
    times the world size.

    Under torchrun's environment the Trainer joins the process group
    (`ddp.init_from_env`: NCCL on `cuda:LOCAL_RANK`, gloo on the CPU) and
    trains `self.net`, the model wrapped in `DistributedDataParallel`
    (buffers not broadcast: the cross-rank BatchNorm keeps the running
    statistics equal); `self.model` stays the bare module.  Each rank
    loads its rows of every global batch, computes its own losses (the
    reference's Lightning DDP) and holds the same parameters; validation
    counts, losses and the logged train losses are reduced over the ranks,
    and rank 0 alone writes metrics.jsonl and the checkpoints.
    """

    def __init__(self, cfg: OccDepthConfig, logdir: Optional[str] = None,
                 device=None):
        rank_device = ddp.init_from_env(device)
        if rank_device is not None:
            device = rank_device
        elif device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer: no CUDA device (pass "
                                   "device='cpu' to train on the CPU)")
            device = "cuda"
        if cfg.deterministic:
            use_deterministic_algorithms()
        self.cfg = cfg
        self.device = torch.device(device)
        self.rank, self.world = ddp.rank(), ddp.world()
        ddp.check_slices(cfg.n_slices, self.world)
        self.logdir = os.path.join(logdir or cfg.logdir, exp_name(cfg))
        os.makedirs(self.logdir, exist_ok=True)
        self.global_batch = cfg.batch_size_per_gpu * self.world
        self.class_names = class_names_for(cfg.dataset)
        self.metrics_logger = MetricsLogger(self.logdir,
                                            writer=self.rank == 0)
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
        self.net = ddp.wrap(self.model, self.device) if ddp.active() else (
            self.model)

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
                              num_workers=workers, rank=self.rank,
                              world=self.world)
        val_loader = Loader(val_ds, self.global_batch, shuffle=False,
                            drop_last=False, num_workers=workers,
                            rank=self.rank, world=self.world)
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
                    cfg, self.net, self.optimizer, micro,
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
                    logs = self._mean_over_ranks(logs)
                    logs["steps_per_sec"] = (self.step - start_step) / max(
                        1e-9, time.time() - t_start)
                    logs["lr"] = lr_at(cfg, steps_per_epoch, self.step)
                    self.metrics_logger.log(self.step, logs, prefix="train/")
                if done():
                    break

            val_stats = self.validate(val_loader)
            train_metrics.completion = ddp.all_reduce_sum(
                train_metrics.completion, self.device)
            train_metrics.conf = ddp.all_reduce_sum(train_metrics.conf,
                                                    self.device)
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
            if self.rank == 0:
                self.ckpt.save(self._state(), self.step, {
                    "val/mIoU": val_stats["iou_ssc_mean"],
                    "val/IoU": val_stats["iou"],
                })
            ddp.barrier()
        return self

    def _mean_over_ranks(self, logs: Dict[str, torch.Tensor]
                         ) -> Dict[str, float]:
        """The logged train losses, averaged over the ranks (one
        all-reduce, on logging steps only)."""
        names = sorted(logs)
        vals = torch.stack([logs[k].float() for k in names])
        vals = ddp.all_reduce_sum(vals) / self.world
        return dict(zip(names, vals.tolist()))

    def validate(self, val_loader) -> Dict:
        """Full-val metrics and mean val losses, with the model in eval
        mode.

        A ragged final batch is padded up to the batch size with repeated
        rows and a `sample_valid` mask, so padded rows never reach the
        confusion counts; the val losses are averaged over the full
        batches only (padding would bias the mean).  Besides SSCMetrics'
        stats the result holds the summed `completion` and `conf` counts,
        `n_frames` (the rows counted) and, on CUDA, `ms_per_frame` (CUDA
        events around each eval step, over this rank's counted rows).

        Under DDP each rank evaluates its rows of every global batch (the
        rank's Loader pads a ragged one and marks it with `sample_valid`);
        the counts, frames and loss sums are then summed over the ranks,
        so every rank returns the one-process table.
        """
        metrics = SSCMetrics(self.cfg.n_classes)
        rows = self.global_batch // self.world
        loss_sums: Dict[str, float] = {}
        n_loss_batches = n_frames = 0
        device_ms = 0.0
        on_cuda = self.device.type == "cuda"
        for batch in val_loader:
            batch = strip_metadata(batch)
            full = "sample_valid" not in batch  # else padded by the Loader
            if full:
                bs = next(iter(batch.values())).shape[0]
                full = bs == rows
                if not full:
                    batch = {k: np.concatenate([v] + [v[:1]] * (rows - bs))
                             for k, v in batch.items()}
                batch["sample_valid"] = np.arange(rows) < bs
            valid = batch["sample_valid"]
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
            n_frames += int(valid.sum())
            if full:
                n_loss_batches += 1
                for k, v in logs.items():
                    loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
        rank_frames = n_frames
        if self.world > 1:
            metrics.completion = ddp.all_reduce_sum(metrics.completion,
                                                    self.device)
            metrics.conf = ddp.all_reduce_sum(metrics.conf, self.device)
            names = sorted(loss_sums)
            sums = ddp.all_reduce_sum(np.array(
                [n_frames, n_loss_batches] + [loss_sums[k] for k in names],
                np.float64), self.device)
            n_frames, n_loss_batches = int(sums[0]), int(sums[1])
            loss_sums = dict(zip(names, sums[2:].tolist()))
        stats = metrics.get_stats()
        stats.update(completion=metrics.completion.copy(),
                     conf=metrics.conf.copy(), n_frames=n_frames)
        if on_cuda and rank_frames:
            stats["ms_per_frame"] = device_ms / rank_frames
        if n_loss_batches:
            stats["losses"] = {k: v / n_loss_batches
                               for k, v in loss_sums.items()}
        return stats
