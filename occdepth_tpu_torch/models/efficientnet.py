"""EfficientNet (tf_efficientnet_*_ns) encoder, NCHW.

Counterpart of `occdepth_tpu/models/efficientnet.py`, with the module tree
and parameter names of the gen-efficientnet model the reference loads
(conv_stem / bn1 / blocks.{stage}.{block}.* / conv_head):

  * TF-SAME asymmetric padding on every strided conv,
  * BatchNorm eps 1e-3, SiLU, SE ratio 0.25 of the block *input* channels,
  * per-variant width/depth scaling with divisor-8 channel rounding,
  * taps (input, stage0, stage1, stage2, stage4, conv_head before bn2).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occdepth_tpu_torch.models.layers import (
    BN_EPS_TF,
    Conv2d,
    Conv2dSame,
    batch_norm2d,
)

# (width_coefficient, depth_coefficient)
VARIANTS = {
    "tf_efficientnet_b0_ns": (1.0, 1.0),
    "tf_efficientnet_b3_ns": (1.2, 1.4),
    "tf_efficientnet_b4_ns": (1.4, 1.8),
    "tf_efficientnet_b5_ns": (1.6, 2.2),
    "tf_efficientnet_b7_ns": (2.0, 3.1),
}

# EfficientNet-B0 stages: (expand_ratio, channels, repeats, stride, kernel)
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
STEM_CHS = 32
HEAD_CHS = 1280


def round_channels(chs: float, multiplier: float, divisor: int = 8) -> int:
    chs *= multiplier
    new = max(divisor, int(chs + divisor / 2) // divisor * divisor)
    if new < 0.9 * chs:
        new += divisor
    return int(new)


def round_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(multiplier * repeats))


def variant_channels(name: str) -> dict:
    """Per-variant derived channel table (stage outputs + stem + head)."""
    w, d = VARIANTS[name]
    return {
        "stem": round_channels(STEM_CHS, w),
        "stages": tuple(round_channels(c, w) for (_, c, _, _, _) in B0_STAGES),
        "head": round_channels(HEAD_CHS, w),
        "repeats": tuple(round_repeats(r, d) for (_, _, r, _, _) in B0_STAGES),
    }


def _bn(c: int) -> nn.BatchNorm2d:
    return batch_norm2d(c, eps=BN_EPS_TF)


class SqueezeExcite(nn.Module):
    def __init__(self, chs: int, reduced: int):
        super().__init__()
        self.conv_reduce = Conv2d(chs, reduced, 1)
        self.conv_expand = Conv2d(reduced, chs, 1)

    def forward(self, x):
        se = x.mean((2, 3), keepdim=True)
        se = self.conv_expand(F.silu(self.conv_reduce(se)))
        return x * torch.sigmoid(se)


class DepthwiseSeparable(nn.Module):
    """Stage-0 block (expand ratio 1, no pointwise expansion)."""

    def __init__(self, in_chs: int, out_chs: int, k: int):
        super().__init__()
        self.conv_dw = Conv2dSame(in_chs, in_chs, k, 1, groups=in_chs)
        self.bn1 = _bn(in_chs)
        self.se = SqueezeExcite(in_chs, max(1, int(in_chs * 0.25)))
        self.conv_pw = Conv2d(in_chs, out_chs, 1, bias=False)
        self.bn2 = _bn(out_chs)
        self.has_skip = in_chs == out_chs

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_dw(x)))
        h = self.bn2(self.conv_pw(self.se(h)))
        return h + x if self.has_skip else h


class MBConv(nn.Module):
    """Inverted residual block (gen-efficientnet InvertedResidual)."""

    def __init__(self, in_chs: int, out_chs: int, expand: int, k: int,
                 stride: int):
        super().__init__()
        mid = in_chs * expand
        self.conv_pw = Conv2d(in_chs, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(in_chs * 0.25)))
        self.conv_pwl = Conv2d(mid, out_chs, 1, bias=False)
        self.bn3 = _bn(out_chs)
        self.has_skip = stride == 1 and in_chs == out_chs

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = F.silu(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(self.se(h)))
        return h + x if self.has_skip else h


class EfficientNet(nn.Module):
    """EfficientNet trunk returning the UNet2D taps."""

    def __init__(self, variant: str = "tf_efficientnet_b3_ns"):
        super().__init__()
        cfg = variant_channels(variant)
        self.conv_stem = Conv2dSame(3, cfg["stem"], 3, 2)
        self.bn1 = _bn(cfg["stem"])
        stages = []
        in_chs = cfg["stem"]
        for si, (expand, _, _, stride, kernel) in enumerate(B0_STAGES):
            out_chs = cfg["stages"][si]
            blocks = []
            for bi in range(cfg["repeats"][si]):
                s = stride if bi == 0 else 1
                if expand == 1:
                    blocks.append(DepthwiseSeparable(in_chs, out_chs, kernel))
                else:
                    blocks.append(MBConv(in_chs, out_chs, expand, kernel, s))
                in_chs = out_chs
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = Conv2d(in_chs, cfg["head"], 1, bias=False)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        h = F.silu(self.bn1(self.conv_stem(x)))
        outs = []
        for stage in self.blocks:
            h = stage(h)
            outs.append(h)
        # the reference taps conv_head *before* bn2/act2 (features[11])
        return x, outs[0], outs[1], outs[2], outs[4], self.conv_head(h)
