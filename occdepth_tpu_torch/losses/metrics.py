"""SSC metrics: completion IoU and per-class semantic IoU.

Counterpart of `occdepth_tpu/losses/metrics.py`.  `confusion_update` counts
on the device (int64 `bincount`); only the (C, C) matrix goes to the host,
where `SSCMetrics` accumulates it with the reference's get_stats API.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def confusion_update(
    y_pred: torch.Tensor,  # (B, ...) int predicted labels
    y_true: torch.Tensor,  # (B, ...) int targets (255 invalid)
    n_classes: int,
    sample_valid: Optional[torch.Tensor] = None,  # (B,) bool; False = padding
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch completion counts and semantic confusion matrix.

    Voxels with target 255 count as class 0 in both prediction and target
    (into conf[0, 0], as the reference counts them); rows that
    `sample_valid` marks as padding count nowhere.

    Returns completion (3,) int64 [tp, fp, fn] of binarised occupancy and
    conf (C, C) int64 with conf[t, p] counts.
    """
    invalid = y_true == 255
    t = torch.where(invalid, 0, y_true).long()
    p = torch.where(invalid, 0, y_pred).long()
    if sample_valid is not None:
        keep = sample_valid.reshape(
            sample_valid.shape + (1,) * (y_true.dim() - sample_valid.dim())
        ).expand_as(y_true)
        t, p = t[keep], p[keep]
    t, p = t.reshape(-1), p.reshape(-1)
    bt, bp = t > 0, p > 0
    completion = torch.stack([
        (bt & bp).sum(), (~bt & bp).sum(), (bt & ~bp).sum()
    ])
    conf = torch.bincount(t * n_classes + p, minlength=n_classes * n_classes)
    return completion, conf.reshape(n_classes, n_classes)


class SSCMetrics:
    """Host accumulator with the reference's add_batch / get_stats API."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.completion = np.zeros(3, np.int64)
        self.conf = np.zeros((self.n_classes, self.n_classes), np.int64)

    def add_batch(self, y_pred: torch.Tensor, y_true: torch.Tensor):
        self.merge(*confusion_update(y_pred, y_true, self.n_classes))

    def merge(self, completion: torch.Tensor, conf: torch.Tensor):
        """Accumulate counts already produced on the device."""
        self.completion += completion.cpu().numpy().astype(np.int64)
        self.conf += conf.cpu().numpy().astype(np.int64)

    def get_stats(self) -> Dict[str, np.ndarray]:
        """precision / recall / IoU / per-class IoU / mIoU."""
        tp, fp, fn = (float(x) for x in self.completion)
        if tp != 0:
            precision = tp / (tp + fp)
            recall = tp / (tp + fn)
            iou = tp / (tp + fp + fn)
        else:
            precision = recall = iou = 0.0
        conf = self.conf.astype(np.float64)
        tps = np.diag(conf)
        fps = conf.sum(0) - tps
        fns = conf.sum(1) - tps
        iou_ssc = tps / (tps + fps + fns + 1e-5)
        return {
            "precision": precision,
            "recall": recall,
            "iou": iou,
            "iou_ssc": iou_ssc,
            "iou_ssc_mean": float(np.mean(iou_ssc[1:])),
        }
