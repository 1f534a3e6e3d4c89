"""Device timing on the card: cuDNN conv vs shifted matmuls vs K3.

Counterpart of `occdepth_tpu/scripts/bench_conv2d.py`.  Shapes are the
flagship 2D decoder's hot 3x3 convs (b3 backbone, feature_2d_oc=32; both
stereo views folded into batch), in the port's NCHW layout.  Candidates,
under the JAX script's names:

  xla     `F.conv2d` (cuDNN);
  shift   `conv3x3_reference`, the nine shifted matmuls (K3's plain
          version);
  pallas  K3, `ops/conv2d_shift.py::conv3x3` (CUDA C++);
  pal_x3  K3 as well: the JAX package's `conv3x3_pallas_x3` computes the
          same function, and the port has one kernel for both.

float32 runs with TF32 off, so cuDNN computes the fp32 product that K3's
three TF32 products (3xTF32) reproduce.  Times are device times
(`bench_timing.device_ms`).
After each shape's candidates a `bound` line gives the least time the card
could take for that conv (`bench_timing.bound_ms`).  `--block-rows` tiles
the TPU kernel only and is accepted and ignored.
Needs a CUDA device:

    python -m occdepth_tpu_torch.scripts.bench_conv2d [--dtype bfloat16]
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from occdepth_tpu_torch.ops.conv2d_shift import conv3x3, conv3x3_reference
from occdepth_tpu_torch.scripts import bench_timing

SHAPES = [
    # (B, H, W, Ci, Co) — up1 conv0/conv1, up2 conv0/conv1 (b3: f=1536)
    (2, 370, 1220, 99, 48),
    (2, 370, 1220, 48, 48),
    (2, 185, 610, 120, 96),
    (2, 185, 610, 96, 96),
]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_inputs(shape, dtype, gen):
    """(x, w, b) for one of SHAPES on the generator's device: x and w in
    `dtype`, the bias fp32."""
    B, H, W, Ci, Co = shape
    dev = gen.device
    x = torch.randn((B, Ci, H, W), generator=gen, device=dev).to(dtype)
    w = (torch.randn((Co, Ci, 3, 3), generator=gen, device=dev)
         * 0.05).to(dtype)
    b = torch.randn((Co,), generator=gen, device=dev)
    return x, w, b


def xla_conv(x, w, b):
    return F.conv2d(x, w, b.to(x.dtype), padding=1)


CANDIDATES = [
    ("xla", xla_conv, ""),
    ("shift", conv3x3_reference, ""),
    ("pallas", conv3x3, ""),
    ("pal_x3", conv3x3, " (K3: one kernel for pallas and pal_x3)"),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--block-rows", type=int, default=0)
    args = ap.parse_args(argv)
    dev = bench_timing.cuda_device("bench_conv2d")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = DTYPES[args.dtype]
    print(bench_timing.gpu_line(), flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    for B, H, W, Ci, Co in SHAPES:
        x, w, b = make_inputs((B, H, W, Ci, Co), dtype, g)
        gf = 2 * B * H * W * 9 * Ci * Co / 1e9
        for label, fn, note in CANDIDATES:
            t = bench_timing.device_ms(lambda: fn(x, w, b),
                                       calls=args.repeats)
            print(f"({B},{H},{W},{Ci:3d}->{Co:3d})  {label:6s} {t:7.3f} ms"
                  f"  [{gf / t:6.1f} TF/s]{note}",
                  flush=True)
        # x, w and out once each, and the fp32 bias
        b_ms, kind = bench_timing.bound_ms(
            (x.numel() + w.numel() + B * Co * H * W) * x.element_size()
            + Co * 4, gf * 1e9,
            bench_timing.BF16_FLOPS if dtype == torch.bfloat16
            else bench_timing.FP32_TC_FLOPS)  # fp32: K3's 3xTF32
        print(f"({B},{H},{W},{Ci:3d}->{Co:3d})  bound  {b_ms:7.3f} ms"
              f"  ({kind})", flush=True)
    print(f"launches conv3x3={conv3x3.launches}", flush=True)


if __name__ == "__main__":
    main()
