"""K2: CRP relation product sigmoid(P) @ mega (kernel `csrc/crp_matmul.cu`).

Counterpart of `occdepth_tpu/ops/pallas_kernels.py::crp_relation_matmul`,
batched over relations: one launch computes every (batch item, relation)
product, with mega shared by the relations of a batch item.  For CPU
tensors the wrapper runs the plain PyTorch version; for CUDA tensors it
launches the kernel or raises.  Logits in the model's layout
(voxel-contiguous) take a tensor-core kernel: in bf16 the wgmma kernel,
whose sigmoid is split into two bf16 terms (`split_bf16`); in fp32 the
3xTF32 wgmma kernel, whose sigmoid is split into TF32 hi and lo in
registers and mega once per call (`ops/tf32.py`), three TF32 products per
step.  Each operand goes to them as is where TMA can read it (its
contiguous dim unit-stride, the other strides multiples of 16 bytes,
16-byte aligned), else as `pad_for_tma`'s copy: the logits for NYU's N =
2,025 voxels (a 4,050-byte stride in bf16, 8,100 in fp32), mega for
TartanAir's M = 1,350 mega-voxels (2,700 and 5,400 bytes; in fp32 the
split's buffer is that padded copy).  Other logits layouts take the SIMT
kernel.  `crp_relation_matmul.paths` counts the launches of each kernel.

The product is the registered operator `occdepth::crp_relation_matmul`
(`torch.library.custom_op`), so a traced or exported program calls the
kernel by name: its CUDA implementation is the kernel launch, its CPU
implementation the plain version, each returning the contiguous (..., C,
N) buffer that `crp_relation_matmul` views as (..., N, C).  Its autograd formula is the plain
version's gradient as two matmuls (the JAX package computes them outside
any Pallas kernel too):

    dP = (dOut @ mega^T) * s * (1 - s),   dmega = s^T @ dOut,   s = sigmoid(P)
"""
from __future__ import annotations

import torch

from occdepth_tpu_torch.ops import cuda_lib
from occdepth_tpu_torch.ops.tf32 import split_tf32_packed

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _broadcast_mega(p_logit: torch.Tensor, mega: torch.Tensor) -> torch.Tensor:
    """mega (B, M, C) read by (B, R, N, M) logits: one per batch item."""
    return mega.unsqueeze(-3) if p_logit.dim() == mega.dim() + 1 else mega


def crp_relation_matmul_reference(p_logit: torch.Tensor,
                                  mega: torch.Tensor) -> torch.Tensor:
    """Plain version: sigmoid(p_logit) @ mega in float32."""
    return torch.sigmoid(p_logit.float()) @ _broadcast_mega(
        p_logit, mega).float()


def split_bf16(s: torch.Tensor) -> tuple:
    """(hi, lo) bf16 with hi + lo = s within 2^-16 relative: the wgmma
    kernel's two-term form of an fp32 sigmoid (hi = bf16(s), lo = bf16(s -
    hi), each rounded to nearest)."""
    hi = s.to(torch.bfloat16)
    return hi, (s - hi.float()).to(torch.bfloat16)


def crp_relation_matmul(p_logit: torch.Tensor,
                        mega: torch.Tensor) -> torch.Tensor:
    """sigmoid(p_logit) @ mega with fp32 accumulation.

    Args:
        p_logit: (B, R, N, M), (B, N, M) or (N, M) relation logits, float32
            or bfloat16, any strides (the model passes a transposed view of
            its (B, R, M, N) stack of conv outputs).
        mega: (B, M, C) for 4-D or 3-D logits (shared by the R relations),
            (M, C) for 2-D ones; same dtype, any strides.

    Returns (B, R, N, C), (B, N, C) or (N, C) float32: a transposed view
    of the operator's contiguous (..., C, N) buffer, the channels-first
    layout the CRP's next conv reads.
    """
    return torch.ops.occdepth.crp_relation_matmul(
        p_logit, mega).transpose(-1, -2)


@torch.library.custom_op("occdepth::crp_relation_matmul", mutates_args=(),
                         device_types="cuda")
def _crp_op(p_logit: torch.Tensor, mega: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA implementation: one kernel launch, returning
    the contiguous (..., C, N) buffer."""
    return _launch(p_logit, mega)


@_crp_op.register_kernel("cpu")
def _crp_cpu(p_logit, mega):
    return crp_relation_matmul_reference(p_logit, mega).transpose(
        -1, -2).contiguous()


@_crp_op.register_fake
def _crp_fake(p_logit, mega):
    lead, (N, C) = p_logit.shape[:-2], (p_logit.shape[-2], mega.shape[-1])
    return p_logit.new_empty((*lead, C, N), dtype=torch.float32)


def _crp_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _crp_backward(ctx, grad_out):
    p_logit, mega = ctx.saved_tensors
    grad_out = grad_out.transpose(-1, -2)  # of the (..., C, N) buffer
    s = torch.sigmoid(p_logit.float())
    mega_b = _broadcast_mega(p_logit, mega).float()
    d_p = d_mega = None
    if ctx.needs_input_grad[0]:
        d_p = (grad_out @ mega_b.transpose(-1, -2)) * (s * (1.0 - s))
        d_p = d_p.to(p_logit.dtype)
    if ctx.needs_input_grad[1]:
        d_mega = s.transpose(-1, -2) @ grad_out
        if p_logit.dim() == mega.dim() + 1:
            d_mega = d_mega.sum(dim=-3)  # over the relations
        d_mega = d_mega.to(mega.dtype)
    return d_p, d_mega


_crp_op.register_autograd(_crp_backward, setup_context=_crp_setup)


def _sane_strides(t: torch.Tensor) -> list:
    """t's strides with each size-1 dim's replaced by t's extent in
    elements, the largest stride x size (torch leaves those arbitrary; TMA
    reads every stride, and the extent is a multiple of the others)."""
    extent = max(st * n for st, n in zip(t.stride(), t.shape))
    return [extent if n == 1 else st for st, n in zip(t.stride(), t.shape)]


def wgmma_path(p_logit: torch.Tensor, mega: torch.Tensor) -> bool:
    """Whether (B, R, N, M) logits and (B, M, C) mega take a tensor-core
    kernel (bf16 wgmma or fp32 3xTF32 wgmma): logits voxel-contiguous.
    Other strides of either operand that TMA cannot read are made readable
    by a padded copy (`pad_for_tma`)."""
    if p_logit.dtype not in _DTYPE_CODE or mega.dtype != p_logit.dtype:
        return False
    return _sane_strides(p_logit)[2] == 1


def _tma_multiple(t: torch.Tensor) -> int:
    """Elements in 16 bytes of t's dtype: 8 in bf16, 4 in fp32."""
    return 16 // t.element_size()


def tma_reads(t: torch.Tensor, dim: int) -> bool:
    """Whether the tensor-core kernels' TMA reads operand t as it is:
    `dim` contiguous (unit stride), the other strides multiples of 16
    bytes, the base 16-byte aligned.  `dim` is 2 for (B, R, N, M) logits,
    1 for (B, M, C) mega."""
    st, k = _sane_strides(t), _tma_multiple(t)
    return (st[dim] == 1 and all(s % k == 0 for i, s in enumerate(st)
                                 if i != dim)
            and t.data_ptr() % 16 == 0)


def pad_for_tma(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t as the tensor-core kernels' TMA reads it: a view of t's shape on
    a new zeroed buffer laid out with `dim` last and padded to 16 bytes (8
    bf16 or 4 fp32 elements), so `dim` is unit-stride and every other
    stride a 16-byte multiple.  For NYU's logits (B, R, N = 2,025, M) that
    is a (B, R, M, 2,032) buffer in bf16, (B, R, M, 2,028) in fp32; for
    TartanAir's mega (B, M = 1,350, C) a (B, C, 1,352) one in either.  The
    kernel reads only the view: TMA zero-fills its last tile past the
    view's extent, and the padding stays zero."""
    moved = t.movedim(dim, -1)
    n, k = moved.shape[-1], _tma_multiple(t)
    buf = t.new_zeros(*moved.shape[:-1], -(-n // k) * k)
    buf[..., :n] = moved
    return buf[..., :n].movedim(-1, dim)


def _launch(p_logit, mega):
    """The kernel launch behind `crp_relation_matmul` (CUDA tensors):
    returns the contiguous (B, R, C, N), (B, C, N) or (C, N) buffer."""
    dim = p_logit.dim()
    if dim not in (2, 3, 4) or mega.dim() != min(dim, 3):
        raise ValueError(f"crp_relation_matmul: shapes {tuple(p_logit.shape)}"
                         f" and {tuple(mega.shape)}")
    if dim == 2:
        p4, g3 = p_logit[None, None], mega[None]
    else:
        p4, g3 = (p_logit[:, None] if dim == 3 else p_logit), mega
    B, R, N, M = p4.shape
    C = g3.shape[-1]
    for name, t in (("p_logit", p4), ("mega", g3)):
        if t.device != p4.device or t.device.type != "cuda":
            raise ValueError(f"crp_relation_matmul: {name} on {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"crp_relation_matmul: {name} is {t.dtype}")
    if g3.dtype != p4.dtype:
        raise TypeError(f"crp_relation_matmul: dtypes {p4.dtype} "
                        f"and {g3.dtype} differ")
    if g3.shape != (B, M, C):
        raise ValueError(f"crp_relation_matmul: shapes {tuple(p_logit.shape)}"
                         f" and {tuple(mega.shape)}")
    out = torch.empty((B, R, C, N), dtype=torch.float32, device=p4.device)
    path = int(wgmma_path(p4, g3))
    if path and not tma_reads(p4, 2):
        p4 = pad_for_tma(p4, 2)
    tf32 = path and p4.dtype == torch.float32
    if tf32:  # mega's (2, B, C, Mp) hi/lo split, M padded to 16 bytes
        g3 = split_tf32_packed(g3.transpose(1, 2), -(-M // 4) * 4)
        gs = [C * g3.shape[-1], 1, g3.shape[-1]]
    else:
        if path and not tma_reads(g3, 1):
            g3 = pad_for_tma(g3, 1)
        gs = _sane_strides(g3)
    ps = _sane_strides(p4)
    rc = cuda_lib.library().occ_crp_relation_matmul(
        p4.data_ptr(), g3.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[p4.dtype], path, B, R, N, M, C,
        ps[0], ps[1], ps[2], ps[3], gs[0], gs[1], gs[2],
        *out.transpose(2, 3).stride(),
        torch.cuda.current_stream(p4.device).cuda_stream,
    )
    cuda_lib.check(rc, "crp_relation_matmul")
    crp_relation_matmul.launches += 1
    crp_relation_matmul.paths[
        "wgmma_tf32" if tf32 else "wgmma_bf16" if path else "simt"] += 1
    return out[0, 0] if dim == 2 else out[:, 0] if dim == 3 else out


crp_relation_matmul.launches = 0
crp_relation_matmul.paths = {"wgmma_bf16": 0, "wgmma_tf32": 0,
                             "simt": 0}
