"""K3: 3x3 stride-1 SAME conv + bias (kernel `csrc/conv3x3.cu`), the 2D
decoder's convs under `decoder_conv_impl=pallas`.

Counterpart of `occdepth_tpu/ops/conv2d_shift.py`.  The contract is that
of its `conv3x3_shift` and `conv3x3_pallas` (and `conv3x3_pallas_x3`,
which computes the same function):

    out[b, o, h, w] = cast(bias[o] + sum_{dr, dc, c}
                           x_pad[b, c, h + dr, w + dc] * w[o, c, dr, dc])

with the weight cast to the input's dtype first, products summed in
float32, the float32 bias added to the float32 sums, and one cast to the
input's dtype at the end.  Layouts are the port's: x (B, Ci, H, W), w
(Co, Ci, 3, 3) (OIHW), bias (Co,), out (B, Co, H, W).

The JAX package defines no gradient for its Pallas kernel, so `conv3x3`
is forward-only: with grad mode on and an input that requires grad it
raises, on either device.  For CPU tensors it runs the plain version; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from occdepth_tpu_torch.ops import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: nine shifted (pixels, Ci) @ (Ci, Co) matmuls of the
    zero-padded image in float32, summed tap by tap, plus the bias in
    float32, cast once to x.dtype."""
    B, Ci, H, W = x.shape
    wt = w.to(x.dtype).float().permute(2, 3, 1, 0)  # (3, 3, Ci, Co)
    xp = F.pad(x.float(), (1, 1, 1, 1)).permute(0, 2, 3, 1)  # (B, H+2, W+2, Ci)
    acc = None
    for dr in range(3):
        for dc in range(3):
            tap = xp[:, dr:dr + H, dc:dc + W] @ wt[dr, dc]
            acc = tap if acc is None else acc + tap
    if b is not None:
        acc = acc + b.float()
    return acc.to(x.dtype).permute(0, 3, 1, 2).contiguous()


def _forbid_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "conv3x3 (decoder_conv_impl=pallas) is forward-only: the JAX "
            "package defines no gradient for its Pallas 3x3 conv kernel; "
            "train with decoder_conv_impl=xla, auto or shift")


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias.

    Args:
        x: (B, Ci, H, W) float32 or bfloat16, any strides.
        w: (Co, Ci, 3, 3) contiguous, in x's dtype (the caller casts the
            float32 parameter, as the layers do).
        b: (Co,) float32, or None.

    Returns (B, Co, H, W) contiguous in x's dtype.
    """
    _forbid_grad(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}")
    B, Ci, H, W = x.shape
    Co = w.shape[0]
    if w.shape[1] != Ci:
        raise ValueError(f"conv3x3: x has {Ci} channels, w expects {w.shape[1]}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x {x.dtype}, w {w.dtype} (float32 or "
                        "bfloat16, both alike)")
    if not w.is_contiguous():
        raise ValueError("conv3x3: w must be contiguous (OIHW)")
    if b is not None and (b.dtype != torch.float32 or b.shape != (Co,)
                          or not b.is_contiguous()):
        raise ValueError(f"conv3x3: bias {b.dtype} {tuple(b.shape)} "
                         f"(contiguous float32 ({Co},))")
    for name, t in (("w", w), ("b", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3x3: {name} on {t.device}, x on {x.device}")
    out = torch.empty((B, Co, H, W), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = cuda_lib.library().occ_conv3x3(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[x.dtype], B, Ci, Co, H, W, *x.stride(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


def resolve_conv_impl(impl: str, train: bool) -> str:
    """The decoder conv path for cfg.decoder_conv_impl, as the JAX package
    resolves it: 'auto' is the stock conv ('xla'); 'shift' (the plain
    version) and 'pallas' (K3) are forced options."""
    if impl != "auto":
        return impl
    return "xla"
