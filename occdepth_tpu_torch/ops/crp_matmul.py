"""K2: CRP relation product sigmoid(P) @ mega (kernel `csrc/crp_matmul.cu`).

Counterpart of `occdepth_tpu/ops/pallas_kernels.py::crp_relation_matmul`.
For CPU tensors the wrapper runs the plain PyTorch version; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from occdepth_tpu_torch.ops import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def crp_relation_matmul_reference(p_logit: torch.Tensor,
                                  mega: torch.Tensor) -> torch.Tensor:
    """Plain version: sigmoid(p_logit) @ mega in float32."""
    return torch.sigmoid(p_logit.float()) @ mega.float()


def crp_relation_matmul(p_logit: torch.Tensor,
                        mega: torch.Tensor) -> torch.Tensor:
    """sigmoid(p_logit) @ mega with fp32 accumulation.

    Args:
        p_logit: (B, N, M) or (N, M) relation logits, float32 or bfloat16,
            any strides (the model passes a transposed view of its
            (B, M, N) conv output).
        mega: (B, M, C) or (M, C), same dtype, any strides.

    Returns (B, N, C) or (N, C) float32.  On CUDA the result is a
    transposed view of a contiguous (B, C, N) buffer — the channels-first
    layout the CRP's next conv reads.
    """
    if p_logit.device.type == "cpu":
        return crp_relation_matmul_reference(p_logit, mega)
    squeeze = p_logit.dim() == 2
    if squeeze:
        p_logit, mega = p_logit.unsqueeze(0), mega.unsqueeze(0)
    B, N, M = p_logit.shape
    C = mega.shape[-1]
    for name, t in (("p_logit", p_logit), ("mega", mega)):
        if t.device != p_logit.device or t.device.type != "cuda":
            raise ValueError(f"crp_relation_matmul: {name} on {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"crp_relation_matmul: {name} is {t.dtype}")
    if mega.dtype != p_logit.dtype:
        raise TypeError(f"crp_relation_matmul: dtypes {p_logit.dtype} "
                        f"and {mega.dtype} differ")
    if mega.shape != (B, M, C):
        raise ValueError(f"crp_relation_matmul: shapes {tuple(p_logit.shape)}"
                         f" and {tuple(mega.shape)}")
    out = torch.empty((B, C, N), dtype=torch.float32,
                      device=p_logit.device).transpose(1, 2)
    rc = cuda_lib.library().occ_crp_relation_matmul(
        p_logit.data_ptr(), mega.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[p_logit.dtype], B, N, M, C,
        *p_logit.stride(), *mega.stride(), *out.stride(),
        torch.cuda.current_stream(p_logit.device).cuda_stream,
    )
    cuda_lib.check(rc, "crp_relation_matmul")
    crp_relation_matmul.launches += 1
    return out[0] if squeeze else out


crp_relation_matmul.launches = 0
