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

The kernel reads channels-last operands through TMA, whose strides must be
multiples of 16 bytes, so the wrapper packs them first (the layout logic in
Python, so the CPU tests reach it): `to_padded_channels_last` makes x a
(B, H, W, Cp) array with Cp = Ci rounded up to a multiple of 8 and zero
channels past Ci (a view, no copy, when x is channels-last already and Ci
is a multiple of 8; on the card a transposing copy kernel otherwise),
`pack_conv3x3_weight` makes w (Co, 3, 3, Cp) the same way;
`conv3x3_packed_reference` is the plain conv of the packed operands.
Both dtypes run on the tensor cores (wgmma): bf16 as it is, fp32 as three
TF32 products, hi.hi + hi.lo + lo.hi (`ops/tf32.py`), the input split in
registers and the weights once per call into a (2, Co, 3, 3, Cp) hi/lo
buffer (`split_tf32_packed`, which packs them on the way), within ~2^-21
of the fp32 product.  `conv3x3.paths` counts the launches of each.
The kernel's output is NHWC memory, returned as (B, Co, H, W) in
`torch.channels_last` format: the same values, so a decoder that stays
channels-last (BN and LeakyReLU keep the format) feeds the next conv
without a transpose.  The packing copies count in the kernel's time.

The conv is the registered operator `occdepth::conv3x3`
(`torch.library.custom_op`), so a traced or exported program calls the
kernel by name: its CUDA implementation is the kernel launch, returning
the (B, H, W, Co) buffer that `conv3x3` views as channels-last (B, Co, H,
W); its CPU implementation the plain version, in the same layout, so a
program traced on either device reads the same strides.  The JAX package
defines no gradient for its Pallas kernel, so `conv3x3` is forward-only:
with grad mode on and an input that requires grad it raises, on either
device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from occdepth_tpu_torch.ops import cuda_lib
from occdepth_tpu_torch.ops.tf32 import split_tf32_packed

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


def padded_channels(ci: int) -> int:
    """Ci rounded up to a multiple of 8: a bf16 channels-last row is then
    a multiple of 16 bytes, as TMA needs."""
    return -(-ci // 8) * 8


def to_padded_channels_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H, W, Cp), channels past C zero, data
    16-byte aligned.  A channels-last x with C % 8 == 0 is returned as a
    view of the same memory.  Any other CUDA float32/bfloat16 x is copied
    by the packing kernel (`occ_pack_nhwc` in `csrc/conv3x3.cu`: a tiled
    transpose, 16-byte stores), a CPU x by PyTorch's copy."""
    B, C, H, W = x.shape
    Cp = padded_channels(C)
    xl = x.permute(0, 2, 3, 1)
    if Cp == C and xl.is_contiguous() and xl.data_ptr() % 16 == 0:
        return xl
    out = x.new_empty((B, H, W, Cp))
    if x.device.type == "cpu":
        out[..., C:].zero_()
        out[..., :C].copy_(xl)
        return out
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"to_padded_channels_last: {x.dtype} on CUDA "
                        "(float32 or bfloat16)")
    if out.numel():
        rc = cuda_lib.library().occ_pack_nhwc(
            x.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], B, C, Cp, H,
            W, *x.stride(), torch.cuda.current_stream(x.device).cuda_stream)
        cuda_lib.check(rc, "pack_nhwc")
    return out


def pack_conv3x3_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, Ci, 3, 3) -> contiguous (Co, 3, 3, Cp), K-major per output
    channel (tap, then channel), channels past Ci zero."""
    Co, Ci = w.shape[:2]
    Cp = padded_channels(Ci)
    if Cp == Ci:
        return w.permute(0, 2, 3, 1).contiguous()
    out = w.new_zeros((Co, 3, 3, Cp))
    out[..., :Ci].copy_(w.permute(0, 2, 3, 1))
    return out


def conv3x3_packed_reference(xp: torch.Tensor, wp: torch.Tensor,
                             b: Optional[torch.Tensor],
                             ci: int) -> torch.Tensor:
    """Plain version on the packed operands, as the kernel sees them: xp
    (B, H, W, Cp), wp (Co, 3, 3, Cp), all Cp channels summed (those past
    `ci` must be zero in both; raises otherwise), nine shifted matmuls in
    float32, the float32 bias, one cast to xp.dtype.  Returns (B, Co, H,
    W) in channels-last memory, as the kernel does."""
    B, H, W, Cp = xp.shape
    if wp.shape[1:] != (3, 3, Cp) or not 0 < ci <= Cp:
        raise ValueError(f"conv3x3_packed_reference: xp {tuple(xp.shape)}, "
                         f"wp {tuple(wp.shape)}, ci {ci}")
    if xp[..., ci:].any() or wp[..., ci:].any():
        raise ValueError("conv3x3_packed_reference: padded channels not zero")
    xpad = F.pad(xp.float(), (0, 0, 1, 1, 1, 1))  # (B, H+2, W+2, Cp)
    wt = wp.float()
    acc = None
    for dr in range(3):
        for dc in range(3):
            tap = xpad[:, dr:dr + H, dc:dc + W] @ wt[:, dr, dc].t()
            acc = tap if acc is None else acc + tap
    if b is not None:
        acc = acc + b.float()
    return acc.to(xp.dtype).permute(0, 3, 1, 2)


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

    Returns (B, Co, H, W) in x's dtype, channels-last memory: a view of
    the operator's contiguous (B, H, W, Co) buffer.
    """
    _forbid_grad(x, w, b)
    return torch.ops.occdepth.conv3x3(x, w, b).permute(0, 3, 1, 2)


@torch.library.custom_op("occdepth::conv3x3", mutates_args=(),
                         device_types="cuda")
def _conv3x3_op(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """The operator's CUDA implementation: one kernel launch (after the
    packing copies), returning the contiguous (B, H, W, Co) buffer."""
    return _launch(x, w, b)


@_conv3x3_op.register_kernel("cpu")
def _conv3x3_cpu(x, w, b):
    return conv3x3_reference(x, w, b).permute(0, 2, 3, 1).contiguous()


@_conv3x3_op.register_fake
def _conv3x3_fake(x, w, b):
    B, _, H, W = x.shape
    return x.new_empty((B, H, W, w.shape[0]))


def _launch(x, w, b):
    """The kernel launch behind `conv3x3` (CUDA tensors)."""
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
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    xp = to_padded_channels_last(x)
    Cp = xp.shape[-1]
    if x.dtype == torch.float32:  # (2, Co, 3, 3, Cp): TF32 hi and lo
        wp = split_tf32_packed(w.view(Co, Ci, 9).transpose(1, 2), Cp)
    else:
        wp = pack_conv3x3_weight(w)
    rc = cuda_lib.library().occ_conv3x3(
        xp.data_ptr(), wp.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[x.dtype], B, Cp, Co, H, W,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, "conv3x3")
    conv3x3.launches += 1
    conv3x3.paths["wgmma_tf32" if x.dtype == torch.float32
                  else "wgmma_bf16"] += 1
    return out


conv3x3.launches = 0
conv3x3.paths = {"wgmma_bf16": 0, "wgmma_tf32": 0}


def resolve_conv_impl(impl: str, train: bool) -> str:
    """The decoder conv path for cfg.decoder_conv_impl, as the JAX package
    resolves it: 'auto' is the stock conv ('xla'); 'shift' (the plain
    version) and 'pallas' (K3) are forced options."""
    if impl != "auto":
        return impl
    return "xla"
