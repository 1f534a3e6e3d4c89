"""K4: filter gradient of a stride-1 SAME depthwise conv (kernel
`csrc/dw_filter_grad.cu`), and the depthwise conv whose backward uses it.

Counterpart of `occdepth_tpu/ops/dw_conv.py`:

    dw[c, 0, dr, dc] = sum_{b,h,w} x_pad[b, c, h+dr, w+dc] * g[b, c, h, w]

`dw_conv2d_fastgrad` is a stock depthwise conv forward whose backward takes
dx from PyTorch's own convolution backward and dw from K4, as the JAX
package's custom VJP takes dx from XLA and dw from its Pallas kernel.  For
CPU tensors `dw_filter_grad` runs the plain PyTorch version; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from occdepth_tpu_torch.ops import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 5)  # the EfficientNets' depthwise filters
_SLAB_FLOATS = 11776  # the kernel's x slab: at most 46 KB of shared memory


def dw_filter_grad_reference(x: torch.Tensor, g: torch.Tensor, kh: int,
                             kw: int) -> torch.Tensor:
    """Plain version: (B, C, H, W) x and g -> (C, 1, kh, kw) float32, the
    k*k shifted multiply-sums of the zero-padded input in float32."""
    B, C, H, W = x.shape
    pt, pl = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.float(), (pl, kw - 1 - pl, pt, kh - 1 - pt))
    gf = g.float()
    taps = [
        (xp[:, :, dr:dr + H, dc:dc + W] * gf).sum(dim=(0, 2, 3))
        for dr in range(kh) for dc in range(kw)
    ]
    return torch.stack(taps, dim=1).reshape(C, 1, kh, kw)


def _slab_rows(W: int, k: int) -> int:
    """Output rows per block of the kernel: the (rows + k - 1)-row x slab
    with its halo fits in the kernel's shared memory."""
    return _SLAB_FLOATS // (W + k - 1) - (k - 1)


def dw_filter_grad(x: torch.Tensor, g: torch.Tensor, kh: int,
                   kw: int) -> torch.Tensor:
    """Filter gradient of a stride-1 SAME depthwise conv.

    Args:
        x: (B, C, H, W) conv input, float32 or bfloat16, any strides.
        g: (B, C, H, W) output cotangent, same dtype, any strides.
        kh, kw: odd filter size (square, 3 or 5, on CUDA).

    Returns (C, 1, kh, kw) float32.  On CUDA the result is deterministic:
    per-block partial sums go to a scratch buffer that a second kernel
    reduces in a fixed order.
    """
    if x.device.type == "cpu":
        return dw_filter_grad_reference(x, g, kh, kw)
    B, C, H, W = x.shape
    for name, t in (("x", x), ("g", g)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"dw_filter_grad: {name} on {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"dw_filter_grad: {name} is {t.dtype}")
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"dw_filter_grad: x {x.dtype} {tuple(x.shape)}, "
                         f"g {g.dtype} {tuple(g.shape)}")
    if kh != kw or kh not in _KERNEL_SIZES:
        raise ValueError(f"dw_filter_grad: filter {kh}x{kw} (square "
                         f"{_KERNEL_SIZES} on CUDA)")
    rows = _slab_rows(W, kh)
    if rows < 1:
        raise ValueError(f"dw_filter_grad: width {W} exceeds the slab")
    if x.numel() == 0:
        return torch.zeros((C, 1, kh, kw), dtype=torch.float32,
                           device=x.device)
    rows = min(rows, H)
    n_tiles = -(-H // rows)
    partial = torch.empty((C, B * n_tiles, kh * kw), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((C, 1, kh, kw), dtype=torch.float32, device=x.device)
    rc = cuda_lib.library().occ_dw_filter_grad(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[x.dtype], kh, B, C, H, W, rows, n_tiles,
        *x.stride(), *g.stride(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, "dw_filter_grad")
    dw_filter_grad.launches += 1
    return out


dw_filter_grad.launches = 0


class _DwConvFastGrad(torch.autograd.Function):
    """Stride-1 SAME depthwise conv: stock forward, dw from K4."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        kh, kw = w.shape[-2:]
        return F.conv2d(x, w, None, 1, (kh // 2, kw // 2), 1, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        kh, kw = w.shape[-2:]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [kh // 2, kw // 2], [1, 1], False,
                [0, 0], x.shape[1], [True, False, False],
            )[0]
        if ctx.needs_input_grad[1]:
            # returned in the weight's (compute) dtype: bf16 rounds the fp32
            # sums once, as the JAX package's VJP does
            dw = dw_filter_grad(x, g, kh, kw).to(w.dtype)
        return dx, dw


def dw_conv2d_fastgrad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME depthwise conv; forward == F.conv2d, backward through
    K4 for the filter.

    x (B, C, H, W), w (C, 1, k, k) with k odd, both in the compute dtype
    (the caller casts the float32 parameter, as the layers do).
    """
    return _DwConvFastGrad.apply(x, w)


def use_fast_dw_grad(mode: str, kernel: int, stride: int) -> bool:
    """Whether a depthwise conv takes `dw_conv2d_fastgrad`.  `mode` is
    cfg.dw_conv_grad: 'pallas' selects K4 for stride-1 odd-kernel convs,
    'xla' and 'auto' keep PyTorch's own autograd; strided and even-kernel
    convs always keep it."""
    if mode not in ("pallas", "xla", "auto"):
        raise ValueError(
            f"dw_conv_grad={mode!r}: expected 'pallas', 'xla' or 'auto'"
        )
    if stride != 1 or kernel % 2 != 1:
        return False
    return mode == "pallas"
