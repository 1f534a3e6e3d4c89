"""K5: the resident-operand matmul probe (kernel `csrc/matmul_probe.cu`),
the tensor-core ceiling of a fused full-grid SSC-head kernel.

Counterpart of `occdepth_tpu/scripts/bench_head_pallas.py::
pallas_matmul_probe`: with p (1, m, k), w (k, n) and n_steps steps,

    out[s] = bf16(p[0] @ w)       for s in range(n_steps)

the products summed in float32 and rounded once; every operand bfloat16,
m, k and n multiples of 16.  For CPU tensors `matmul_probe` runs the plain
version; for CUDA tensors it launches the kernel or raises.  The kernel
reads both operands K-major through TMA, so the wrapper hands it w^T
(n, k), one small copy per call that counts in the kernel's time.
"""
from __future__ import annotations

import torch

from occdepth_tpu_torch.ops import cuda_lib


def matmul_probe_reference(p: torch.Tensor, w: torch.Tensor,
                           n_steps: int) -> torch.Tensor:
    """Plain version: the float32 product of p[0] and w, rounded to
    bfloat16 once and repeated over n_steps."""
    prod = (p[0].float() @ w.float()).to(torch.bfloat16)
    return prod.expand(n_steps, -1, -1).contiguous()


def _check(p: torch.Tensor, w: torch.Tensor, n_steps: int) -> None:
    if p.dim() != 3 or p.shape[0] != 1 or w.dim() != 2 \
            or w.shape[0] != p.shape[2]:
        raise ValueError(f"matmul_probe: p {tuple(p.shape)} must be "
                         f"(1, m, k) and w {tuple(w.shape)} (k, n)")
    if p.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"matmul_probe: p {p.dtype}, w {w.dtype} (bfloat16)")
    if any(d % 16 for d in (*p.shape[1:], w.shape[1])):
        raise ValueError(f"matmul_probe: m, k, n = {p.shape[1]}, "
                         f"{p.shape[2]}, {w.shape[1]} must be multiples of 16")
    if n_steps < 1:
        raise ValueError(f"matmul_probe: n_steps {n_steps} < 1")
    if w.device != p.device:
        raise ValueError(f"matmul_probe: w on {w.device}, p on {p.device}")


def matmul_probe(p: torch.Tensor, w: torch.Tensor, n_steps: int) -> torch.Tensor:
    """(n_steps, m, n) bfloat16: p (1, m, k) @ w (k, n) at every step."""
    _check(p, w, n_steps)
    if p.device.type == "cpu":
        return matmul_probe_reference(p, w, n_steps)
    if not (p.is_contiguous() and w.is_contiguous()) or p.data_ptr() % 16:
        raise ValueError("matmul_probe: p and w must be contiguous, p "
                         "16-byte aligned")
    _, m, k = p.shape
    n = w.shape[1]
    out = torch.empty((n_steps, m, n), dtype=torch.bfloat16, device=p.device)
    wt = w.t().contiguous()
    rc = cuda_lib.library().occ_matmul_probe(
        p.data_ptr(), wt.data_ptr(), out.data_ptr(), m, k, n, n_steps,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    cuda_lib.check(rc, "matmul_probe")
    matmul_probe.launches += 1
    return out


matmul_probe.launches = 0
