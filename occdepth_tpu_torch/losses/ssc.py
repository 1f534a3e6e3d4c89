"""SSC losses as branch-free masked tensor math.

Counterpart of `occdepth_tpu/losses/ssc.py` (the reference's
occdepth/loss/ssc_loss.py): the data-dependent guards become `where` masks,
with the same values as the JAX package for every branch combination.

Layout: logits (B, X, Y, Z, C) channels-last (the model's output views);
targets (B, X, Y, Z) int with 255 = invalid.
"""
from __future__ import annotations

import torch

_LOG_CLAMP = 100.0  # torch F.binary_cross_entropy clamps log at -100
_TINY = 1e-37  # below this, 1/x overflows fp32 and the clamp is active


def safe_neg_log(x: torch.Tensor) -> torch.Tensor:
    """-log(x) clamped at 100, as torch's BCE clamps, with a FINITE gradient.

    The double `where` evaluates log only where it is safe, so the
    gradient at the clamp is 0; `F.binary_cross_entropy` gives a huge one
    there, and a plain min(-log(x), 100) gives 0 * inf = NaN at x == 0.
    """
    safe = x > _TINY
    return torch.where(safe, -torch.log(torch.where(safe, x, 1.0)),
                       _LOG_CLAMP)


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def ce_ssc_loss(logits: torch.Tensor, target: torch.Tensor,
                class_weights: torch.Tensor) -> torch.Tensor:
    """Class-weighted cross entropy, ignore_index 255, weighted mean:
    sum_i w[y_i] * nll_i / sum_i w[y_i] over valid voxels, as
    nn.CrossEntropyLoss(weight, ignore_index=255) gives."""
    valid = target != 255
    t = torch.where(valid, target, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, t[..., None])[..., 0]
    w = class_weights.float()[t] * valid
    return (w * nll).sum() / w.sum().clamp(min=1e-12)


def geo_scal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary-occupancy precision/recall/specificity BCE."""
    prob = torch.softmax(logits.float(), dim=-1)
    empty = prob[..., 0]
    nonempty = 1.0 - empty
    valid = (target != 255).float()
    t_nonempty = ((target != 0) & (target != 255)).float()

    inter = (t_nonempty * nonempty * valid).sum()
    precision = _ratio(inter, (nonempty * valid).sum())
    recall = _ratio(inter, t_nonempty.sum())
    spec_num = ((1.0 - t_nonempty) * empty * valid).sum()
    spec = _ratio(spec_num, ((1.0 - t_nonempty) * valid).sum())
    return safe_neg_log(precision) + safe_neg_log(recall) + safe_neg_log(spec)


def sem_scal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class precision/recall/specificity BCE, averaged over the classes
    present in the target."""
    C = logits.shape[-1]
    prob = torch.softmax(logits.float(), dim=-1)  # (..., C)
    valid = (target != 255).float()
    t = torch.where(target == 255, 0, target).long()
    onehot = torch.nn.functional.one_hot(t, C).float() * valid[..., None]

    axes = tuple(range(target.dim()))
    p_sum = (prob * valid[..., None]).sum(dim=axes)  # (C,)
    ct_sum = onehot.sum(dim=axes)  # (C,)
    nom = (prob * onehot).sum(dim=axes)  # (C,)
    not_ct_sum = valid.sum() - ct_sum
    spec_nom = ((1.0 - prob) * (valid[..., None] - onehot)).sum(dim=axes)

    # denominators guarded with where(guard, x, 1), never max(x, eps): the
    # derivative -nom/eps^2 underflows to 0/0 = NaN in fp32
    has_class = ct_sum > 0
    p_pos = p_sum > 0
    nct_pos = not_ct_sum > 0
    loss_prec = torch.where(
        p_pos, safe_neg_log(nom / torch.where(p_pos, p_sum, 1.0)), 0.0)
    loss_rec = torch.where(
        has_class, safe_neg_log(nom / torch.where(has_class, ct_sum, 1.0)),
        0.0)
    loss_spec = torch.where(
        nct_pos,
        safe_neg_log(spec_nom / torch.where(nct_pos, not_ct_sum, 1.0)), 0.0)
    per_class = torch.where(has_class, loss_prec + loss_rec + loss_spec, 0.0)
    count = has_class.float().sum()
    return per_class.sum() / count.clamp(min=1.0)
