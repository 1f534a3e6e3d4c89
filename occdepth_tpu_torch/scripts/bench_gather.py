"""Microbenchmark: per-voxel row gather strategies on the card.

The FLoSP lift and the OAD frustum resample are row gathers: for each of
N = 262,144 voxels, fetch one (C,)-row of an (R, C) table (reference
SFA.py:17-43 and flosp_depth.py:574-577).  This probe times three ways to
do it at the flagship shapes, as `occdepth_tpu/scripts/bench_gather.py`
does on the TPU:

  xla_take          PyTorch's own gather, `index_select` (the stock path;
                    the name is the JAX script's);
  xla_onehot_tiled  a one-hot matmul per 8192-index tile, tables of at
                    most 30,000 rows;
  pallas_gather     K6, `ops/row_gather.py` (the hand-written CUDA kernel
                    that replaces the TPU's Pallas kernel).

Unlike the JAX script, K6 runs at every shape: the script's 12 MB gate was
the TPU's VMEM, and K6 keeps no table resident.  Each timed call gathers
from the next of four variants (table and indices), so consecutive calls
read different tables.  Each line gives ms per gather and GB/s of output
(device times, `bench_timing.device_ms`); every output of a timed run
is kept, so no call rewrites a buffer still in L2.  The last line gives K6's
launch count.  Needs a CUDA device:

    python -m occdepth_tpu_torch.scripts.bench_gather [--dtype bfloat16]
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from occdepth_tpu_torch.ops.row_gather import row_gather
from occdepth_tpu_torch.scripts import bench_timing

N = 128 * 128 * 16  # flagship voxel count (project_scale=2)

# (name, table_rows, table_cols): SFA tables are (h*w+1, C=32) at 4 scales;
# OAD is (47*153, D=104)
SHAPES = [
    ("sfa_1_8", 47 * 153 + 1, 32),
    ("sfa_1_4", 93 * 305 + 1, 32),
    ("sfa_1_2", 185 * 610 + 1, 32),
    ("sfa_1_1", 370 * 1220 + 1, 32),
    ("oad_row", 47 * 153, 104),
]
ONEHOT_MAX_ROWS = 30000
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_variants(rows, cols, dtype, n_var=4, seed=0, device="cuda"):
    """n_var (table, idx) pairs drawn as the JAX script draws them."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_var):
        table = rs.randn(rows, cols).astype(np.float32) * 0.1
        idx = rs.randint(0, rows, size=(N,)).astype(np.int32)
        out.append((torch.from_numpy(table).to(device, dtype),
                    torch.from_numpy(idx).to(device)))
    return out


def xla_take(table, idx):
    return table.index_select(0, idx)


def xla_onehot_tiled(table, idx, tile=8192):
    """Gather as a one-hot matmul over index tiles (tensor cores instead of
    a gather).  Each output is one table entry times one plus zeros, so
    the product is exact in the table's dtype, as the JAX version's float32
    sums cast back are."""
    rows = torch.arange(table.shape[0], device=table.device)
    return torch.cat([(ic[:, None] == rows).to(table.dtype) @ table
                      for ic in idx.reshape(-1, tile)])


pallas_gather = row_gather


def in_turns(fn, variants):
    """A callable that runs `fn` on the next variant at each call and keeps
    every output, so consecutive calls read different tables and write
    distinct buffers (no warm L2 replayed from the call before)."""
    turn = itertools.cycle(variants)
    kept = []

    def call():
        kept.append(fn(*next(turn)))

    return call


def candidates(rows):
    cands = [("xla_take", xla_take)]
    if rows <= ONEHOT_MAX_ROWS:
        cands.append(("xla_onehot_tiled", xla_onehot_tiled))
    cands.append(("pallas_gather", pallas_gather))
    return cands


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--repeats", type=int, default=16)
    args = ap.parse_args(argv)
    dev = bench_timing.cuda_device("bench_gather")
    dtype = DTYPES[args.dtype]
    print(bench_timing.gpu_line(), flush=True)

    for name, rows, cols in SHAPES:
        variants = make_variants(rows, cols, dtype, device=dev)
        bytes_out = N * cols * variants[0][0].element_size()
        print(f"\n{name}: table ({rows}, {cols}) {args.dtype}, "
              f"{N} rows gathered ({bytes_out / 1e6:.1f} MB out)", flush=True)
        for label, fn in candidates(rows):
            t = bench_timing.device_ms(in_turns(fn, variants),
                                       calls=args.repeats)
            print(f"  {label:18s} {t:7.3f} ms/gather  "
                  f"({bytes_out / t / 1e6:.1f} GB/s out)", flush=True)
        del variants
        torch.cuda.empty_cache()
    print(f"\nlaunches row_gather={row_gather.launches}", flush=True)


if __name__ == "__main__":
    main()
