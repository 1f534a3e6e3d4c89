"""Loss assembly and the train step.

Counterpart of `occdepth_tpu/training/step.py`: `compute_losses` gathers
every loss term the config enables; `train_step` runs forward, losses and
backward per microbatch, clips, applies one AdamW update and returns the
logs with the step's confusion counts.

Numerics follow the port's explicit-cast rule (`models/layers.py`): no
`torch.autocast` and no gradient scaler, as the JAX package has none.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

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
    """
    model.train()
    optimizer.zero_grad(set_to_none=True)
    K = len(micro_batches)
    logs_sum: Dict[str, torch.Tensor] = {}
    completion = conf = None
    for mb in micro_batches:
        out = model(mb)
        loss, logs = compute_losses(cfg, out, mb, progress)
        (loss / K).backward()
        with torch.no_grad():
            comp_k, conf_k = confusion_update(
                out["ssc_logit"].argmax(dim=-1), mb["target"], cfg.n_classes)
            completion = comp_k if completion is None else completion + comp_k
            conf = conf_k if conf is None else conf + conf_k
            for k, v in logs.items():
                v = v.detach()
                logs_sum[k] = v if k not in logs_sum else logs_sum[k] + v

    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:  # optax updates (decays) every parameter
            p.grad = torch.zeros_like(p)
    if cfg.gradient_clip_val and cfg.gradient_clip_val > 0:
        clip_by_global_norm_([p.grad for p in params], cfg.gradient_clip_val)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return {k: v / K for k, v in logs_sum.items()}, completion, conf
