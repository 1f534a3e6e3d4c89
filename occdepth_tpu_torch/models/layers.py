"""Shared building blocks and numerics conventions.

Counterpart of `occdepth_tpu/models/layers.py`, in PyTorch's NCHW/NCDHW
layouts.

Numerics (docs/DESIGN.md "Numerics policy"), by explicit casts rather than
`torch.autocast`, so CPU and CUDA follow one rule:
  * parameters stay float32;
  * convolutions and linear layers run in the dtype of their input — the
    model casts the image to `compute_dtype` once, and the layers below
    cast their float32 weights to it at each call;
  * BatchNorm normalises in float32 whatever its input dtype (PyTorch's
    mixed-dtype batch_norm with float32 statistics and affine parameters)
    and returns the input dtype.

BatchNorm conventions (PARITY.md "Known deliberate divergences"): torch
momentum m is flax momentum 1 - m; eps is 1e-5, except 1e-3 in the
`tf_efficientnet` encoder.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_EPS_TF = 1e-3


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Conv3d(nn.Conv3d):
    """nn.Conv3d computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class ConvTranspose3d(nn.ConvTranspose3d):
    """nn.ConvTranspose3d (fixed output_padding) in its input's dtype."""

    def forward(self, x):
        return F.conv_transpose3d(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation,
        )


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


def batch_norm2d(c: int, eps: float = BN_EPS,
                 momentum: float = 0.1) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=eps, momentum=momentum)


def batch_norm3d(c: int, momentum: float = 0.1) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=BN_EPS, momentum=momentum)


def tf_same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF-SAME asymmetric padding (the extra row/column bottom/right)."""
    ih, iw = x.shape[-2:]
    pad_h = max((math.ceil(ih / s) - 1) * s + k - ih, 0)
    pad_w = max((math.ceil(iw / s) - 1) * s + k - iw, 0)
    return F.pad(
        x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)
    )


class Conv2dSame(Conv2d):
    """Square conv with TF-SAME padding (flax `padding="SAME"`).

    Stride 1 with an odd kernel pads symmetrically, so the conv pads
    itself; strided convs pad asymmetrically first.
    """

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(cin, cout, k, stride,
                         padding=k // 2 if stride == 1 else 0,
                         groups=groups, bias=bias)

    def forward(self, x):
        if self.stride[0] != 1:
            x = tf_same_pad(x, self.kernel_size[0], self.stride[0])
        return super().forward(x)
