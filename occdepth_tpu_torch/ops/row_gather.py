"""K6: row gather `table[idx]` (kernel `csrc/row_gather.cu`), the probe of
the per-voxel row gathers of the FLoSP lift and the OAD frustum resample.

Counterpart of `occdepth_tpu/scripts/bench_gather.py::pallas_gather`.  The
TPU kernel leaves an index outside the table undefined; here the contract
is that of `jnp.take` in its default mode, the JAX script's `xla_take`:

    out[t] = table[idx[t]]        for -R <= idx[t] < R (negatives count
                                  from the end, as in numpy)
    out[t] = NaN                  otherwise

For CPU tensors `row_gather` runs the plain version; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from occdepth_tpu_torch.ops import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: `table.index_select(0, idx)` with negative indices
    wrapped and the rows of indices outside [-R, R) set to NaN."""
    R = table.shape[0]
    idx = torch.where(idx < 0, idx + R, idx)
    valid = (idx >= 0) & (idx < R)
    out = table.index_select(0, torch.where(valid, idx, 0))
    return out.masked_fill_(~valid[:, None], float("nan"))


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"row_gather: table {tuple(table.shape)} must be "
                         f"(R, C) and idx {tuple(idx.shape)} (T,)")
    if table.dtype not in _DTYPES:
        raise TypeError(f"row_gather: table {table.dtype} (float32 or "
                        "bfloat16)")
    if idx.dtype != torch.int32:
        raise TypeError(f"row_gather: idx {idx.dtype} (int32)")
    if table.shape[0] == 0:
        raise ValueError("row_gather: empty table")
    if idx.device != table.device:
        raise ValueError(f"row_gather: idx on {idx.device}, table on "
                         f"{table.device}")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of `table` (R, C), float32 or bfloat16, at `idx` (T,)
    int32; returns (T, C) contiguous in the table's dtype."""
    _check(table, idx)
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: table and idx must be contiguous")
    R, C = table.shape
    out = torch.empty((idx.shape[0], C), dtype=table.dtype,
                      device=table.device)
    rc = cuda_lib.library().occ_row_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C,
        idx.shape[0], table.element_size(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    cuda_lib.check(rc, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
