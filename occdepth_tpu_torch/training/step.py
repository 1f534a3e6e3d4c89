"""Loss assembly and the train step.

Counterpart of `occdepth_tpu/training/step.py`: `compute_losses` gathers
every loss term the config enables; `train_step` runs forward, losses and
backward per microbatch, clips, applies one AdamW update and returns the
logs with the step's confusion counts; `eval_step` is the validation step
(forward, test-time losses, confusion counts).

Both steps run under spans (`tracing.py`): `train.step` around
`train.forward`, `train.losses`, `train.backward`, `train.confusion` and
`train.update` (`apply_update`), and `eval.step` around `eval.forward`,
`eval.losses` and `eval.confusion`.

Numerics follow the port's explicit-cast rule (`models/layers.py`): no
`torch.autocast` and no gradient scaler, as the JAX package has none.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from occdepth_tpu_torch import tracing
from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.params import class_weights_for, class_weights_occ_for
from occdepth_tpu_torch.losses import (
    ce_ssc_loss,
    confusion_update,
    depth_cls_loss,
    frustum_proportion_loss_device,
    geo_scal_loss,
    relation_loss,
    sem_scal_loss,
)
from occdepth_tpu_torch.training.optim import clip_by_global_norm_


def compute_losses(
    cfg: OccDepthConfig,
    out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    progress: float,  # cur_batch / total_batch in [0, 1]
    is_test: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All loss terms, gated by the config flags; returns (loss, logs)."""
    logs: Dict[str, torch.Tensor] = {}
    ssc_logits = out["ssc_logit"]
    target = batch["target"]
    dev = ssc_logits.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)

    if cfg.context_prior and cfg.relation_loss:
        l_rel = relation_loss(out["P_logits"], batch["CP_mega_matrices"])
        loss = loss + l_rel
        logs["loss_relation_ce_super"] = l_rel

    if cfg.CE_ssc_loss:
        cw = torch.as_tensor(class_weights_for(cfg.dataset), device=dev)
        l_ssc = ce_ssc_loss(ssc_logits, target, cw)
        loss = loss + l_ssc
        logs["loss_ssc"] = l_ssc
        if cfg.cascade_cls:
            occ_target = torch.where((target != 0) & (target != 255), 1,
                                     target)
            cw_occ = torch.as_tensor(class_weights_occ_for(cfg.dataset),
                                     device=dev)
            l_occ = ce_ssc_loss(out["occ_logit"], occ_target, cw_occ)
            loss = loss + l_occ
            logs["loss_occ"] = l_occ
        if cfg.occluded_cls and "occluded" in batch:
            l_occl = ce_ssc_loss(out["occluded_logit"], batch["occluded"],
                                 torch.ones(2, device=dev))
            loss = loss + l_occl
            logs["loss_occluded"] = l_occl

    if (cfg.with_depth_gt and cfg.trans_2d_to_3d == "flosp_depth"
            and "gt_depth" in batch):
        depth_pred = out["depth_pred"]  # (B, V, h, w, D)
        if cfg.use_stereo_depth_gt:
            depth_pred = depth_pred[:, :1]  # left camera only
        fd = cfg.flosp_depth_conf
        l_depth = depth_cls_loss(batch["gt_depth"], depth_pred,
                                 fd.downsample_factor, fd.d_bound
                                 ) * cfg.depth_loss_weight
        loss = loss + l_depth
        logs["loss_depth"] = l_depth

    if cfg.sem_scal_loss:
        decay = max(0.1, 1.0 - progress) if cfg.sem_step_decay_loss else 1.0
        l_sem = sem_scal_loss(ssc_logits, target) * decay
        loss = loss + l_sem
        logs["loss_sem_scal"] = l_sem

    if cfg.geo_scal_loss:
        l_geo = geo_scal_loss(ssc_logits, target)
        loss = loss + l_geo
        logs["loss_geo_scal"] = l_geo

    if cfg.fp_loss and not is_test and "frustums_class_dists" in batch:
        l_fp = frustum_proportion_loss_device(cfg, ssc_logits, batch)
        loss = loss + l_fp
        logs["loss_frustums"] = l_fp

    logs["loss"] = loss
    return loss, logs


def train_step(
    cfg: OccDepthConfig,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    micro_batches: Sequence[Dict[str, torch.Tensor]],
    progress: float,
    lr: float,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One optimizer update over K = len(micro_batches) microbatches.

    Each microbatch backpropagates loss / K (Lightning's
    accumulate_grad_batches) and advances the BN running statistics once;
    then the summed gradient is clipped by global norm and one AdamW
    update at `lr` is applied.  Returns (mean logs over the microbatches,
    completion (3,), conf (C, C)), all on the device.

    `model` may be a `DistributedDataParallel`: its losses are this rank's
    (the reference's Lightning DDP), the first K - 1 backwards run under
    `no_sync()`, and the last all-reduces the summed gradients, which DDP
    averages over the ranks before the clip.
    """
    with tracing.span("train.step"):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        K = len(micro_batches)
        logs_sum: Dict[str, torch.Tensor] = {}
        completion = conf = None
        for i, mb in enumerate(micro_batches):
            with (model.no_sync() if i < K - 1 and hasattr(model, "no_sync")
                  else contextlib.nullcontext()):
                with tracing.span("train.forward"):
                    out = model(mb)
                with tracing.span("train.losses"):
                    loss, logs = compute_losses(cfg, out, mb, progress)
                with tracing.span("train.backward"):
                    (loss / K).backward()
            with torch.no_grad(), tracing.span("train.confusion"):
                comp_k, conf_k = confusion_update(
                    out["ssc_logit"].argmax(dim=-1), mb["target"],
                    cfg.n_classes)
                completion = (comp_k if completion is None
                              else completion + comp_k)
                conf = conf_k if conf is None else conf + conf_k
                for k, v in logs.items():
                    v = v.detach()
                    logs_sum[k] = v if k not in logs_sum else logs_sum[k] + v
        with tracing.span("train.update"):
            apply_update(cfg, optimizer, lr)
        return {k: v / K for k, v in logs_sum.items()}, completion, conf


def apply_update(cfg: OccDepthConfig, optimizer: torch.optim.Optimizer,
                 lr: float) -> None:
    """Clip the gradients by global norm and take one AdamW step at `lr`.

    A parameter without a gradient gets zeros, as optax updates (decays)
    every parameter.  Under DDP this runs after the all-reduce: the only
    parameters left without a gradient are those no output of the config
    depends on (`OccDepthModel.unused_parameter_names`), which DDP does
    not track, so every rank decays them alike.
    """
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if cfg.gradient_clip_val and cfg.gradient_clip_val > 0:
        clip_by_global_norm_([p.grad for p in params], cfg.gradient_clip_val)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def eval_step(
    cfg: OccDepthConfig,
    model: nn.Module,
    batch: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Validation step: eval-mode forward, the test-time losses and the
    confusion counts, on the device (counterpart of `make_eval_step`).

    An optional batch key `sample_valid` (B,) bool marks padding rows that
    keep the final val batch at the full batch size; they count nowhere in
    the confusion counts.  Returns (logs, completion (3,), conf (C, C)).
    """
    batch = dict(batch)
    sample_valid: Optional[torch.Tensor] = batch.pop("sample_valid", None)
    model.eval()
    with torch.inference_mode(), tracing.span("eval.step"):
        with tracing.span("eval.forward"):
            out = model(batch)
        with tracing.span("eval.losses"):
            _, logs = compute_losses(cfg, out, batch, 0.0, is_test=True)
        with tracing.span("eval.confusion"):
            completion, conf = confusion_update(
                out["ssc_logit"].argmax(dim=-1), batch["target"],
                cfg.n_classes, sample_valid)
    return logs, completion, conf
