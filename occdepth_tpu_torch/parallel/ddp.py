"""Data parallelism over processes: torchrun + DistributedDataParallel.

Counterpart of `occdepth_tpu/parallel/mesh.py`.  The reference trains with
Lightning DDP over NCCL, one process per GPU, and `sync_batchnorm=True`;
the JAX package shards the global batch over a device mesh, where GSPMD
all-reduces the gradients and BatchNorm's statistics.  Here the launcher is
`torchrun`, which starts one process per GPU and gives each its `RANK`,
`WORLD_SIZE` and `LOCAL_RANK`:

    torchrun --nproc_per_node N -m occdepth_tpu_torch.scripts.train \\
        --config CONFIG.yaml [key=value ...]

`init_from_env` joins that process group; the Trainer then wraps the model
in `DistributedDataParallel`, `models/layers.py` reduces train-mode
BatchNorm statistics over the ranks, and each rank takes its contiguous
rows of every global batch (`rank_rows`, the rows `shard_batch` puts on a
mesh device).  `n_slices` becomes torchrun's node count (`--nnodes`): NCCL
builds the two-tier all-reduce itself, so only the divisibility rule of
`make_hybrid_mesh` remains (`check_slices`).

Without torchrun's environment nothing here runs and the Trainer trains on
one device: that is the single-process path, not a fallback.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched() -> bool:
    """Whether torchrun (or a caller imitating it) started this process."""
    return all(k in os.environ for k in ENV)


def init_from_env(device=None, backend: Optional[str] = None
                  ) -> Optional[torch.device]:
    """Join torchrun's process group and return this rank's device, or
    None outside torchrun's environment.

    `device=None` or `"cuda"` means `cuda:LOCAL_RANK` (raises without a
    GPU); an indexed CUDA device is taken as given (several gloo ranks on
    one card); `"cpu"` trains on the CPU.  The backend is NCCL on CUDA and
    gloo on the CPU unless `backend` names another (NCCL refuses two ranks
    on one GPU, gloo takes CUDA tensors for all_reduce and broadcast).  A
    group that is already initialised is joined as it is; a failed init
    raises.
    """
    if not launched():
        return None
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env: no CUDA device (pass "
                               "device='cpu' to train on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def active() -> bool:
    """Whether this process belongs to an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def wrap(model: torch.nn.Module, device: torch.device
         ) -> torch.nn.parallel.DistributedDataParallel:
    """`model` in `DistributedDataParallel` on `device`.

    The parameters no output depends on (`unused_parameter_names`, the
    decoder heads of scales nothing reads) stop requiring a gradient, so
    DDP leaves them out of its buckets instead of walking the autograd
    graph every step for them (`find_unused_parameters`); they had no
    gradient before either.  Buffers are not broadcast at each forward:
    the cross-rank BatchNorm advances the running statistics alike on
    every rank."""
    unused = set(model.unused_parameter_names())
    for name, p in model.named_parameters():
        if name in unused:
            p.requires_grad_(False)
    return torch.nn.parallel.DistributedDataParallel(
        model, broadcast_buffers=False,
        device_ids=[device.index] if device.type == "cuda" else None)


def check_slices(n_slices: int, world_size: int) -> None:
    """`make_hybrid_mesh`'s rule: the world splits into `n_slices` equal
    slices (torchrun nodes)."""
    if n_slices < 1 or world_size % n_slices:
        raise ValueError(f"{world_size} devices not divisible by "
                         f"n_slices={n_slices}")


def rank_rows(batch: Dict[str, Any], rank_: int, world_size: int
              ) -> Dict[str, Any]:
    """Rank `rank_`'s contiguous rows of every batched value (arrays,
    tensors, lists of frame ids): the rows `shard_batch` places on the
    rank_-th device of a 1-D mesh.  A batch dim that the world does not
    divide is rejected with `shard_batch`'s message."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] if hasattr(v, "shape") else len(v)
        if n % world_size:
            raise ValueError(
                f"batch[{k!r}] dim 0 = {n} not divisible by the world's "
                f"{world_size} ranks — pad the batch or drop the remainder "
                "(uneven per-rank batches are not supported)")
        per = n // world_size
        out[k] = v[rank_ * per:(rank_ + 1) * per]
    return out


def all_reduce_sum(x, device=None):
    """Sum of `x` (a tensor or a numpy array) over the ranks, of the same
    kind, dtype and shape; `x` itself at world 1.  numpy arrays travel as
    tensors on `device` (the CPU by default; NCCL needs the rank's GPU)."""
    if world() == 1:
        return x
    if isinstance(x, torch.Tensor):
        t = x.clone()
        dist.all_reduce(t)
        return t
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device or "cpu")
    dist.all_reduce(t)
    return t.cpu().numpy()
