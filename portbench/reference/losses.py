"""The benchmark's plain reference of OccDepth's training losses and update.

A frozen copy of the loss and optimizer mathematics of the reference
(occdepth/loss/ssc_loss.py, CRP_loss.py, depth_loss.py, the frustum
proportion loss; Lightning's AdamW with global-norm clipping as optax
applies it), in float32 plain PyTorch.  The data-dependent guards are
written as masks with the reference's values, so that a zero count gives
the reference's value and a finite gradient.  Layouts are the program's:
logits (B, X, Y, Z, C), targets (B, X, Y, Z) with 255 invalid.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

_LOG_CLAMP = 100.0  # torch's BCE clamps log at -100
_TINY = 1e-37


def _neg_log(x):
    safe = x > _TINY
    return torch.where(safe, -torch.log(torch.where(safe, x, 1.0)), _LOG_CLAMP)


def _ratio(num, den):
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def ce_ssc_loss(logits, target, class_weights):
    """nn.CrossEntropyLoss(weight, ignore_index=255), weighted mean."""
    valid = target != 255
    t = torch.where(valid, target, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, t[..., None])[..., 0]
    w = class_weights.float()[t] * valid
    return (w * nll).sum() / w.sum().clamp(min=1e-12)


def geo_scal_loss(logits, target):
    prob = torch.softmax(logits.float(), dim=-1)
    empty = prob[..., 0]
    nonempty = 1.0 - empty
    valid = (target != 255).float()
    t_nonempty = ((target != 0) & (target != 255)).float()
    inter = (t_nonempty * nonempty * valid).sum()
    precision = _ratio(inter, (nonempty * valid).sum())
    recall = _ratio(inter, t_nonempty.sum())
    spec = _ratio(((1.0 - t_nonempty) * empty * valid).sum(),
                  ((1.0 - t_nonempty) * valid).sum())
    return _neg_log(precision) + _neg_log(recall) + _neg_log(spec)


def sem_scal_loss(logits, target):
    C = logits.shape[-1]
    prob = torch.softmax(logits.float(), dim=-1)
    valid = (target != 255).float()
    t = torch.where(target == 255, 0, target).long()
    onehot = torch.nn.functional.one_hot(t, C).float() * valid[..., None]
    axes = tuple(range(target.dim()))
    p_sum = (prob * valid[..., None]).sum(dim=axes)
    ct_sum = onehot.sum(dim=axes)
    nom = (prob * onehot).sum(dim=axes)
    not_ct_sum = valid.sum() - ct_sum
    spec_nom = ((1.0 - prob) * (valid[..., None] - onehot)).sum(dim=axes)
    has_class = ct_sum > 0
    p_pos = p_sum > 0
    nct_pos = not_ct_sum > 0
    loss_prec = torch.where(
        p_pos, _neg_log(nom / torch.where(p_pos, p_sum, 1.0)), 0.0)
    loss_rec = torch.where(
        has_class, _neg_log(nom / torch.where(has_class, ct_sum, 1.0)), 0.0)
    loss_spec = torch.where(
        nct_pos, _neg_log(spec_nom / torch.where(nct_pos, not_ct_sum, 1.0)),
        0.0)
    per_class = torch.where(has_class, loss_prec + loss_rec + loss_spec, 0.0)
    return per_class.sum() / has_class.float().sum().clamp(min=1.0)


def relation_loss(p_logits, cp_mega):
    """BCE with logits, pos_weight = #zeros / #ones per relation over the
    batch, mean over all elements.  p_logits (B, R, M, N), cp_mega
    (B, R, N, M)."""
    n_rel = p_logits.shape[1]
    x = p_logits.float().transpose(2, 3).transpose(0, 1).reshape(n_rel, -1)
    y = cp_mega.float().transpose(0, 1).reshape(n_rel, -1)
    pos_weight = (y == 0).sum(dim=1).float() / y.sum(dim=1).clamp(min=1e-12)
    log_weight = 1.0 + (pos_weight[:, None] - 1.0) * y
    loss = (1.0 - y) * x + log_weight * (
        torch.log1p(torch.exp(-x.abs())) + torch.clamp(-x, min=0.0))
    return loss.mean()


def _clamped_log(x):
    safe = x > _TINY
    return torch.where(safe, torch.log(torch.where(safe, x, 1.0)), -_LOG_CLAMP)


def depth_cls_loss(depth_labels, depth_preds, downsample, d_bound):
    """OAD depth BCE: GT nearest-resized, min-pooled per patch (zeros read
    as 1e5), binned uniformly by the d_bound step, one-hot; BCE against the
    softmaxed distribution over foreground pixels."""
    D = int((d_bound[1] - d_bound[0]) / d_bound[2])
    B, n_cam, h, w, _ = depth_preds.shape
    gt = depth_labels.reshape(-1, *depth_labels.shape[2:])
    H_in, W_in = gt.shape[-2:]
    H_out, W_out = h * downsample, w * downsample
    ri = torch.floor(torch.arange(H_out, dtype=torch.float32, device=gt.device)
                     * (H_in / H_out)).long().clamp(0, H_in - 1)
    ci = torch.floor(torch.arange(W_out, dtype=torch.float32, device=gt.device)
                     * (W_in / W_out)).long().clamp(0, W_in - 1)
    gt = gt.index_select(-2, ri).index_select(-1, ci)
    patches = gt.reshape(-1, h, downsample, w, downsample)
    patches = patches.permute(0, 1, 3, 2, 4).reshape(-1, h, w,
                                                     downsample * downsample)
    mind = torch.where(patches == 0.0, 1e5, patches).amin(dim=-1)
    idx = (mind - (d_bound[0] - d_bound[2])) / d_bound[2]
    idx = torch.where((idx < D + 1) & (idx >= 0.0), idx, 0.0).int().reshape(-1)
    bins = torch.arange(1, D + 1, dtype=torch.int32, device=gt.device)
    labels = (idx[:, None] == bins[None, :]).float()
    preds = depth_preds.reshape(-1, D).float()
    fg = (labels.amax(dim=1) > 0.0).float()
    p = preds.clamp(0.0, 1.0)
    bce = -(labels * _clamped_log(p) + (1.0 - labels) * _clamped_log(1.0 - p))
    return (bce * fg[:, None]).sum() / fg.sum().clamp(min=1.0)


def frustum_proportion_loss(cfg, logits, batch):
    """KL between each image-tile frustum's predicted class mass and its GT
    class histogram, averaged over the non-empty frustums.  A voxel belongs
    to a tile of a view when its centre pixel, round(x f / z + c) from the
    unflipped projection, falls in the tile and z > 0; the views are ORed."""
    B, C = logits.shape[0], logits.shape[-1]
    target = batch["target"]
    vol_dim = tuple(target.shape[1:])
    voxel_size = cfg.voxel_size_m * cfg.output_scale
    img_H, img_W = cfg.img_shape
    size = cfg.frustum_size
    dev = logits.device

    def bounds(dim):
        b = np.arange(size, dtype=np.float64) / size
        return (torch.from_numpy((b * dim).astype(np.float32)).to(dev),
                torch.from_numpy(((b + 1.0 / size) * dim).astype(np.float32)
                                 ).to(dev))

    sx, ex = bounds(img_W)
    sy, ey = bounds(img_H)
    origin = torch.tensor(cfg.spec["rig"]["vox_origin"], dtype=torch.float32,
                          device=dev)
    axes = [(torch.arange(n, dtype=torch.float32, device=dev) + 0.5)
            * voxel_size for n in vol_dim]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                      dim=1) + origin[None, :]
    prob = torch.softmax(logits.float(), dim=-1).reshape(B, -1, C)
    valid_t = target.reshape(B, -1) != 255
    n_tiles = size * size
    cum_prob = torch.zeros((n_tiles, C), dtype=torch.float32, device=dev)
    for b in range(B):
        E = batch["T_velo_2_cam"][b].float()
        k = batch["cam_k"][b].float()
        cam = pts[None] @ E[:, :3, :3].transpose(1, 2) + E[:, None, :3, 3]
        z = cam[..., 2]
        px = torch.round(cam[..., 0] * k[:, None, 0, 0] / z + k[:, None, 0, 2])
        py = torch.round(cam[..., 1] * k[:, None, 1, 1] / z + k[:, None, 1, 2])

        def tile_of(p, start, end):
            inside = (p[..., None] >= start) & (p[..., None] < end)
            return torch.where(inside.any(dim=-1),
                               inside.int().argmax(dim=-1), -1)

        ix, iy = tile_of(px, sx, ex), tile_of(py, sy, ey)
        tile = torch.where((ix >= 0) & (iy >= 0) & (z > 0), iy * size + ix,
                           n_tiles)
        member = torch.zeros((tile.shape[1], n_tiles + 1), dtype=torch.bool,
                             device=dev)
        member.scatter_(1, tile.t().long(), True)
        member = member[:, :n_tiles] & valid_t[b][:, None]
        cum_prob = cum_prob + member.float().t() @ prob[b]
    batch_cnt = batch["frustums_class_dists"].float().sum(dim=0)
    total_cnt = batch_cnt.sum(dim=1)
    total_prob = cum_prob.sum(dim=1)
    nonempty = (total_prob > 0) & (total_cnt > 0)
    target_prop = batch_cnt / total_cnt.clamp(min=1e-30)[:, None]
    p = cum_prob / total_prob.clamp(min=1e-30)[:, None]
    kl_el = torch.where(
        target_prop > 0,
        target_prop * (torch.log(target_prop.clamp(min=1e-30))
                       - torch.log(p.clamp(min=1e-30))),
        0.0)
    kl = torch.where(nonempty, kl_el.sum(dim=1), 0.0)
    return kl.sum() / nonempty.float().sum().clamp(min=1.0)


def compute_losses(cfg, out: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every loss term the configuration enables (train step, progress 0)."""
    logs: Dict[str, torch.Tensor] = {}
    logits, target = out["ssc_logit"], batch["target"]
    dev = logits.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.context_prior and cfg.relation_loss:
        logs["loss_relation_ce_super"] = relation_loss(
            out["P_logits"], batch["CP_mega_matrices"])
    if cfg.CE_ssc_loss:
        logs["loss_ssc"] = ce_ssc_loss(
            logits, target, torch.as_tensor(cfg.class_weights(), device=dev))
        if cfg.cascade_cls:
            occ_target = torch.where((target != 0) & (target != 255), 1,
                                     target)
            logs["loss_occ"] = ce_ssc_loss(
                out["occ_logit"], occ_target,
                torch.as_tensor(cfg.class_weights_occ(), device=dev))
    if (cfg.with_depth_gt and cfg.trans_2d_to_3d == "flosp_depth"
            and "gt_depth" in batch):
        pred = out["depth_pred"]
        if cfg.use_stereo_depth_gt:
            pred = pred[:, :1]
        fd = cfg.flosp_depth_conf
        logs["loss_depth"] = depth_cls_loss(
            batch["gt_depth"], pred, fd.downsample_factor, fd.d_bound
        ) * cfg.depth_loss_weight
    if cfg.sem_scal_loss:
        logs["loss_sem_scal"] = sem_scal_loss(logits, target)
    if cfg.geo_scal_loss:
        logs["loss_geo_scal"] = geo_scal_loss(logits, target)
    if cfg.fp_loss and "frustums_class_dists" in batch:
        logs["loss_frustums"] = frustum_proportion_loss(cfg, logits, batch)
    for v in logs.values():
        loss = loss + v
    logs["loss"] = loss
    return loss, logs


class RefAdamW:
    """AdamW (betas 0.9, 0.999, eps 1e-8, decoupled decay on every
    parameter) after clipping by global norm: g * max_norm / ||g|| when
    ||g|| >= max_norm, with no epsilon (optax's clip_by_global_norm)."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 weight_decay: float, clip: float):
        self.params = params
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One update; returns the clipped gradients it applied."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.clip and self.clip > 0:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            if norm >= self.clip:
                grads = [g * (self.clip / norm).float() for g in grads]
        self.t += 1
        with torch.no_grad():
            for p, g, m, v in zip(self.params, grads, self.m, self.v):
                p.mul_(1.0 - self.lr * self.wd)
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m_hat = m / (1.0 - b1 ** self.t)
                v_hat = v / (1.0 - b2 ** self.t)
                p.sub_(self.lr * m_hat / (v_hat.sqrt() + eps))
        return grads
