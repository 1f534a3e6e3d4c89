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
import torch.distributed as dist
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


def _channel_view(v: torch.Tensor, dim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (dim - 2))


def _global_means(sums: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(k, C) per-channel sums over this rank's `x` -> the means over every
    rank's rows: one all-reduce of the sums and the element count."""
    n = torch.tensor([x.numel() // x.shape[1]], dtype=sums.dtype,
                     device=sums.device)
    flat = torch.cat([sums.reshape(-1), n])
    dist.all_reduce(flat)
    return flat[:-1].reshape(sums.shape) / flat[-1]


class _CrossRankBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of all ranks, given the
    global mean and inverse std (`SyncBatchNorm`'s backward, with one
    all-reduce of the two per-channel sums of the upstream gradient).
    Computes in float32 and returns the input's dtype; the weight and bias
    gradients are this rank's share, which DDP averages with the rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd):
        xhat = (x.float() - _channel_view(mean, x.dim())) * _channel_view(
            invstd, x.dim())
        ctx.save_for_backward(x, weight, mean, invstd)
        return (xhat * _channel_view(weight, x.dim())
                + _channel_view(bias, x.dim())).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        gy = gy.float()
        xmu = x.float() - _channel_view(mean, x.dim())
        sums = torch.stack([gy.sum(dims), (gy * xmu).sum(dims)])
        grad_weight, grad_bias = sums[1] * invstd, sums[0]
        mean_dy, mean_dy_xmu = _global_means(sums, x)
        gx = (gy - _channel_view(mean_dy, x.dim())
              - xmu * _channel_view(invstd.square() * mean_dy_xmu, x.dim())
              ) * _channel_view(invstd * weight, x.dim())
        return gx.to(x.dtype), grad_weight, grad_bias, None, None


class _TrainStatsMixin:
    """Train-mode forward of the JAX package's `_BNCore`.

    The output normalises with the batch statistics in float32 (PyTorch's
    mixed-dtype `batch_norm`, so the backward stores only the input and
    two per-channel vectors); the running statistics advance by
    (1 - m) * running + m * stat with the biased one-pass variance
    max(0, E[x^2] - E[x]^2), computed in float32 as the JAX package does.
    Eval mode is stock `nn.BatchNorm`.

    In a process group of more than one rank (`parallel/ddp.py`) the batch
    is the global one, as under the reference's `sync_batchnorm=True` and
    the JAX package's mesh: one all-reduce of the float32 [Σx, Σx², n] per
    channel gives the statistics (the same one-pass variance), and one of
    the upstream gradient's two per-channel sums serves the backward
    (`_CrossRankBatchNorm`).
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        cross_rank = dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            xf = x.float()
            if cross_rank:
                mean, ex2 = _global_means(
                    torch.stack([xf.sum(dims), xf.square().sum(dims)]), x)
            else:
                mean = xf.mean(dims)
                ex2 = xf.square().mean(dims)
            var = (ex2 - mean.square()).clamp_(min=0.0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        if cross_rank:
            return _CrossRankBatchNorm.apply(
                x, self.weight, self.bias, mean,
                torch.rsqrt(var + self.eps))
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
