"""The two-term TF32 form of fp32 operands (kernel `csrc/tf32_split.cu`).

K2 and K3 multiply fp32 operands on the tensor cores as three TF32
products, hi.hi + hi.lo + lo.hi (`csrc/hopper.cuh`).  TF32 keeps 10 of
fp32's 23 mantissa bits, and the tensor cores ignore the other 13, so an
operand x is split as

    hi = tf32(x),  lo = tf32(x - hi),  x = hi + lo + e,  |e| <= 2^-22 |x|

with tf32() rounding to nearest, ties away from zero (PTX `cvt.rna`).  The
dropped lo.lo term and e leave each product within ~2^-21 of its fp32
value, the accuracy of a plain fp32 product, where one TF32 product is off
by up to ~2^-10.  The kernels split their A operand in registers; the B
operand (K2's mega, K3's weights) is split once per call into a padded
K-major buffer by `split_tf32_packed`.

For CPU tensors `split_tf32_packed` runs the plain version (`split_tf32`,
integer arithmetic on the fp32 bits); for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from occdepth_tpu_torch.ops import cuda_lib


def to_tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero), as fp32 with the low 13 bits zero: the magnitude bits plus half
    a TF32 ulp, truncated."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo) TF32 with x = hi + lo within 2^-22 |x|."""
    hi = to_tf32_rna(x)
    return hi, to_tf32_rna(x.float() - hi)


def split_tf32_packed(x: torch.Tensor, d2p: int) -> torch.Tensor:
    """x (D0, D1, D2) fp32 at any strides -> contiguous (2, D0, D1, d2p):
    [0] the TF32 hi parts, [1] the lo parts, zeros past D2 (d2p >= D2)."""
    if x.dim() != 3 or x.dtype != torch.float32 or d2p < x.shape[2]:
        raise ValueError(f"split_tf32_packed: x {x.dtype} "
                         f"{tuple(x.shape)}, d2p {d2p}")
    D0, D1, D2 = x.shape
    if x.device.type == "cpu":
        out = x.new_zeros((2, D0, D1, d2p))
        out[0, ..., :D2], out[1, ..., :D2] = split_tf32(x)
        return out
    out = x.new_empty((2, D0, D1, d2p))
    rc = cuda_lib.library().occ_split_tf32(
        x.data_ptr(), out.data_ptr(), D0, D1, D2, d2p, *x.stride(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "split_tf32")
    return out
