"""Training loop: batches -> train steps -> metrics and checkpoints.

Counterpart of `occdepth_tpu/training/trainer.py::Trainer` on one device.
`Trainer(cfg, logdir, device=None).fit(batches, max_steps)` takes any
iterable of batch dicts (NumPy arrays or tensors, the
`make_synthetic_batch(..., with_labels=True)` schema), logs the `train/*`
losses, lr and steps/s to `<logdir>/<exp_name>/metrics.jsonl`, keeps the
train mIoU, and saves and auto-resumes the `last` checkpoint.  Validation
and the disk datasets are not ported yet.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.losses.metrics import SSCMetrics
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.training.checkpoint import CheckpointManager
from occdepth_tpu_torch.training.logging import MetricsLogger
from occdepth_tpu_torch.training.optim import lr_at, make_optimizer
from occdepth_tpu_torch.training.step import train_step

# the reference's sem-step-decay denominator is a nominal 30-epoch schedule
NOMINAL_EPOCHS = 30
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


class Trainer:
    """Trains `OccDepthModel(cfg)` on one device.

    `device=None` means CUDA; without a GPU that raises unless the caller
    passes `device="cpu"`.  The model is initialised with PyTorch's default
    initialisers from INIT_SEED, unless a `last` checkpoint exists under
    the run directory, which is then restored (params, BN statistics,
    optimizer state, step).
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
        self.metrics_logger = MetricsLogger(self.logdir)
        self.ckpt = CheckpointManager(os.path.join(self.logdir, "checkpoints"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(INIT_SEED)
            model = OccDepthModel(cfg)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), cfg)
        self.train_metrics = SSCMetrics(cfg.n_classes)
        self.step = 0
        self.step_ms = []  # CUDA-event time of each step fit ran (CUDA only)
        state = self.ckpt.restore(map_location=self.device)
        if state is not None:
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.step = int(state["step"])
            print(f"resumed from step {self.step}")

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()
                if isinstance(v, (np.ndarray, torch.Tensor))}

    def save(self) -> None:
        self.ckpt.save({"model": self.model.state_dict(),
                        "optimizer": self.optimizer.state_dict(),
                        "step": self.step}, self.step)

    def _end_epoch(self) -> None:
        stats = self.train_metrics.get_stats()
        self.metrics_logger.log(self.step, {"train/mIoU": stats["iou_ssc_mean"],
                                            "train/IoU": stats["iou"]})
        self.train_metrics.reset()
        self.save()

    def fit(self, batches: Iterable[Dict], max_steps: int) -> "Trainer":
        """Train until `self.step` reaches `max_steps` or the batches run
        out; one step is `accumulate_grad_batches` batches.

        An epoch, which places the LR milestones, is len(batches) //
        accumulate_grad_batches steps (max_steps for an unsized iterable).
        The train mIoU is logged and `last` saved at every epoch end and
        when fit returns.
        """
        cfg = self.cfg
        accum = max(1, cfg.accumulate_grad_batches)
        n = len(batches) // accum if hasattr(batches, "__len__") else max_steps
        steps_per_epoch = max(1, n)
        total_batches = steps_per_epoch * NOMINAL_EPOCHS
        on_cuda = self.device.type == "cuda"
        start_step, t_start = self.step, time.time()
        micro = []
        for batch in batches:
            if self.step >= max_steps:
                break
            micro.append(self._to_device(batch))
            if len(micro) < accum:
                continue
            if on_cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            logs, completion, conf = train_step(
                cfg, self.model, self.optimizer, micro,
                min(1.0, self.step / total_batches),
                lr_at(cfg, steps_per_epoch, self.step),
            )
            if on_cuda:
                ev[1].record()
            micro = []
            self.train_metrics.merge(completion, conf)  # waits for the step
            if on_cuda:
                self.step_ms.append(ev[0].elapsed_time(ev[1]))
            self.step += 1
            if self.step % max(1, cfg.log_every_n_steps) == 0:
                logs = {k: float(v) for k, v in logs.items()}
                logs["steps_per_sec"] = (self.step - start_step) / max(
                    1e-9, time.time() - t_start)
                logs["lr"] = lr_at(cfg, steps_per_epoch, self.step)
                self.metrics_logger.log(self.step, logs, prefix="train/")
            if self.step % steps_per_epoch == 0:
                self._end_epoch()
        if self.step > start_step and self.step % steps_per_epoch != 0:
            self._end_epoch()
        return self
