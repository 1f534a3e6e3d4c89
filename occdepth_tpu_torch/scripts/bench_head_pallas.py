"""Measure the fused-SSC-head attack on the card.

Counterpart of `occdepth_tpu/scripts/bench_head_pallas.py`.  The proposal
it tests: ONE kernel for the full-grid head chain (conv0 -> ASPP(3
dilations x 2 convs + BN) -> cascade softmax concat -> class conv on a
(1, 16, 256, 256, 32) grid; reference occdepth/models/modules.py:109-175)
so intermediates never round-trip device memory.  Whether that can win
splits into two measurable questions at the flagship shapes:

  A. What does the stock path already achieve?  One dilated `F.conv3d`
     (cuDNN) in bf16, and the port's whole eval head
     (`models/unet3d_blocks.py::SegmentationHead`, seeded random weights).
  B. What is the compute CEILING of a fused kernel?  Any conv at C = 16
     must feed the tensor cores one of these matmul shapes per output tile:
       - im2col   (M, 27*16=432) @ (432, 16)
       - dz-pack  (M, 9*16=144) @ (144, 3*16=48)
       - lane-fold (M, 512) @ (512, 512) block-banded I_32 (x) W (1/32
         density: 32x padded flops, measured too)
     K5 (`ops/matmul_probe.py`) times each shape with the patch operand
     RESIDENT in shared memory, i.e. patch construction taken as free: an
     upper bound on any real fused kernel.

As in the JAX script and the port's `decoder_conv_impl`, `xla_*` names the
stock PyTorch/cuDNN path and `pallas_*` the hand-written kernel.  Every
timed call runs CHAIN conv-equivalents; times are device times per
conv-equivalent (`bench_timing.device_ms`).  Needs a CUDA device:

    python -m occdepth_tpu_torch.scripts.bench_head_pallas [--repeats 6] [--json]
"""
from __future__ import annotations

import argparse
import functools
import json

import torch
import torch.nn.functional as F

from occdepth_tpu_torch.ops.matmul_probe import matmul_probe
from occdepth_tpu_torch.scripts import bench_timing

# flagship head shapes: full scene grid, f//2 = 16 planes
X, Y, Z, C = 256, 256, 32, 16
M_TOTAL = X * Y * Z  # 2.097M voxels
USEFUL_FLOPS = 2 * M_TOTAL * C * 27 * C  # one 3x3x3 conv, 29 GFLOP
CHAIN = 8  # conv-equivalents per timed call, as in the JAX script

# each probe is sized to ONE conv's worth of work in that formulation:
#  - im2col: M_TOTAL outputs, K=27 taps x 16ci, N=16co
#  - dzpack: M_TOTAL outputs, K=9 XY-taps x 16ci, N=3dz x 16co
#    (the z shift-add is taken as free)
#  - lanefold: z rides the 512 columns; per conv = 9 XY-tap matmuls of
#    (65536, 512)@(512, 512) with the I_32 (x) W block-band (3/32
#    density) -> 309 GFLOP padded per 29 GFLOP useful; the probe runs the
#    same padded flop count in (2048, 512) steps: 9*65536/2048 = 288
PROBES = [
    ("im2col_432x16", 8192, 432, 16, M_TOTAL // 8192),
    ("dzpack_144x48", 8192, 144, 48, M_TOTAL // 8192),
    ("lanefold_512x512", 2048, 512, 512, 72 * 4),
]


def pallas_matmul_probe(m_tile: int, k: int, n: int, n_steps: int,
                        device="cuda"):
    """(fn, p, w): `fn(p, w)` runs K5's n_steps chained (m_tile, k) @ (k, n)
    products with p resident on chip; p and w are seeded bf16 normals."""
    gen = [torch.Generator(device=device).manual_seed(s) for s in (0, 1)]
    p = torch.randn((1, m_tile, k), generator=gen[0], device=device,
                    dtype=torch.bfloat16)
    w = torch.randn((k, n), generator=gen[1], device=device,
                    dtype=torch.bfloat16)
    return functools.partial(matmul_probe, n_steps=n_steps), p, w


def chained_conv3d(x, kern, d: int, chain: int = CHAIN):
    """`chain` dependent 3x3x3 convs of dilation d, SAME padding (x is
    (B, C, X, Y, Z), kern (O, I, 3, 3, 3))."""
    for _ in range(chain):
        x = F.conv3d(x, kern, padding=d, dilation=d)
    return x


def time_probe(m_tile, k, n, n_steps, repeats, device="cuda"):
    """Device ms per conv-equivalent of n_steps chained products."""
    fn, p, w = pallas_matmul_probe(m_tile, k, n, n_steps * CHAIN, device)
    return bench_timing.device_ms(lambda: fn(p, w), calls=repeats) / CHAIN


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    dev = bench_timing.cuda_device("bench_head_pallas")
    print(bench_timing.gpu_line(), flush=True)

    from occdepth_tpu_torch.models.unet3d_blocks import SegmentationHead
    from occdepth_tpu_torch.testing import randomize_weights

    results = {}

    # ---- A. stock side ----
    gen = [torch.Generator(device=dev).manual_seed(s) for s in (0, 1)]
    x = torch.randn((1, C, X, Y, Z), generator=gen[0], device=dev,
                    dtype=torch.bfloat16)
    kern = torch.randn((C, C, 3, 3, 3), generator=gen[1], device=dev,
                       dtype=torch.bfloat16)
    with torch.inference_mode():
        for d in (1, 2, 3):
            t = bench_timing.device_ms(
                lambda: chained_conv3d(x, kern, d), calls=args.repeats) / CHAIN
            results[f"xla_conv_d{d}_ms"] = t
            print(f"cuDNN conv3d dil={d}: {t:7.3f} ms  "
                  f"({USEFUL_FLOPS / t / 1e9:.1f} TFLOP/s useful)",
                  flush=True)

        head = randomize_weights(
            SegmentationHead(C, 20, (1, 2, 3), cascade_cls=True), seed=0)
        head = head.to(dev).eval()
        t = bench_timing.device_ms(lambda: head(x)[0].float().sum(),
                                   calls=args.repeats)
    results["xla_head_eval_ms"] = t
    print(f"full head (eval fwd, 10 convs): {t:7.3f} ms", flush=True)
    del x, head

    # ---- B. K5 compute ceilings (patches free) ----
    for name, m_tile, k, n, n_steps in PROBES:
        t = time_probe(m_tile, k, n, n_steps, args.repeats, dev)
        rate = USEFUL_FLOPS / (t / 1e3) / 1e12
        padded = 2 * m_tile * k * n * n_steps
        results[f"pallas_{name}_ms"] = t
        print(f"K5 probe {name:18s}: {t:7.3f} ms/conv-equiv  "
              f"({rate:.1f} useful TFLOP/s, "
              f"{padded / (t / 1e3) / 1e12:.1f} padded TFLOP/s; "
              f"patches assumed free)", flush=True)

    results["launches"] = {"matmul_probe": matmul_probe.launches}
    print(f"launches matmul_probe={matmul_probe.launches}", flush=True)
    if args.json:
        print(json.dumps(results))


if __name__ == "__main__":
    main()
