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
`tf_efficientnet` encoder.  In training mode the running statistics follow
the JAX package's `_BNCore`, not stock PyTorch: the running variance is
updated with the *biased* one-pass batch variance max(0, E[x^2] - E[x]^2)
(stock `nn.BatchNorm` uses the unbiased one).
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


class _TrainStatsMixin:
    """Train-mode forward of the JAX package's `_BNCore`.

    The output normalises with the batch statistics in float32 (PyTorch's
    mixed-dtype `batch_norm`, so the backward stores only the input and
    two per-channel vectors); the running statistics advance by
    (1 - m) * running + m * stat with the biased one-pass variance
    max(0, E[x^2] - E[x]^2), computed in float32 as the JAX package does.
    Eval mode is stock `nn.BatchNorm`.
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp_(min=0.0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BatchNorm2d(_TrainStatsMixin, nn.BatchNorm2d):
    pass


class BatchNorm3d(_TrainStatsMixin, nn.BatchNorm3d):
    pass


def batch_norm2d(c: int, eps: float = BN_EPS,
                 momentum: float = 0.1) -> BatchNorm2d:
    return BatchNorm2d(c, eps=eps, momentum=momentum)


def batch_norm3d(c: int, momentum: float = 0.1) -> BatchNorm3d:
    return BatchNorm3d(c, eps=BN_EPS, momentum=momentum)


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
