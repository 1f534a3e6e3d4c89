"""Optimizer: AdamW + multi-step LR + global-norm clipping.

Counterpart of `occdepth_tpu/training/optim.py` (optax there): AdamW with
betas (0.9, 0.999), eps 1e-8 and decoupled weight decay on every
parameter; the LR is base_lr * gamma^(milestones passed), milestones
(18, 24) epochs with gamma 0.4, or (20,) with 0.1 for TartanAir.  Two
optax semantics are kept where PyTorch's stock pieces differ:
  * the LR of the update after `step` updates switches at
    step >= milestone * steps_per_epoch (`piecewise_constant_schedule`);
  * clipping scales by max_norm / ||g|| only when ||g|| >= max_norm, with
    no epsilon (`clip_grad_norm_` adds 1e-6 to the norm).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch

from occdepth_tpu_torch.config import OccDepthConfig


def multistep_lr(base_lr: float, milestones_steps: Sequence[int],
                 gamma: float, step: int) -> float:
    """base_lr * gamma^(number of milestones with step >= milestone)."""
    lr = base_lr
    for m in sorted(milestones_steps):
        if step >= m:
            lr *= gamma
    return lr


def lr_at(cfg: OccDepthConfig, steps_per_epoch: int, step: int) -> float:
    """The LR of the optimizer update that follows `step` updates."""
    if cfg.dataset == "tartanair":
        milestones, gamma = (20,), 0.1
    else:
        milestones, gamma = (18, 24), 0.4
    return multistep_lr(cfg.lr, [m * steps_per_epoch for m in milestones],
                        gamma, step)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: OccDepthConfig) -> torch.optim.AdamW:
    """AdamW over all `params` in one group (decay on every parameter);
    `lr_at` sets the group's LR before each update."""
    return torch.optim.AdamW(list(params), lr=cfg.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * max_norm / ||g|| when the
    global norm ||g|| >= max_norm, else unchanged.  Returns ||g||; the
    decision stays on the device (no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(grads))))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm
