"""CRP relation loss (multi-label BCE-with-logits, per-relation pos_weight).

Counterpart of `occdepth_tpu/losses/crp.py` (the reference's
occdepth/loss/CRP_loss.py).
"""
from __future__ import annotations

import torch


def relation_loss(p_logits: torch.Tensor, cp_mega: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits between predicted and ground-truth relations.

    Args:
        p_logits: (B, n_rel, M, N) predicted logits (the model's layout).
        cp_mega: (B, n_rel, N, M) ground-truth relations in {0, 1}.

    pos_weight per relation = #zeros / #ones over the whole batch; mean
    over all elements.
    """
    n_rel = p_logits.shape[1]
    # (n_rel, B*N*M) in the label layout
    x = p_logits.float().transpose(2, 3).transpose(0, 1).reshape(n_rel, -1)
    y = cp_mega.float().transpose(0, 1).reshape(n_rel, -1)

    cnt_pos = y.sum(dim=1)
    cnt_neg = (y == 0).sum(dim=1).float()
    pos_weight = cnt_neg / cnt_pos.clamp(min=1e-12)

    # stable BCE-with-logits with pos_weight (torch's formulation):
    # l = (1-y)*x + (1 + (pw-1)*y) * log(1 + exp(-x))   [max trick]
    log_weight = 1.0 + (pos_weight[:, None] - 1.0) * y
    loss = (1.0 - y) * x + log_weight * (
        torch.log1p(torch.exp(-x.abs())) + torch.clamp(-x, min=0.0)
    )
    return loss.mean()
