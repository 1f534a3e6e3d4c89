"""Depthwise-conv cost on the card: forward, dx, dw and K4 per encoder shape.

Counterpart of `occdepth_tpu/scripts/bench_dwconv.py`.  For every depthwise
conv of the tf_efficientnet_b3_ns encoder at the flagship 370x1220 input
(one view, batch 1, NCHW as the port's encoder runs it) it times, in device
ms (`bench_timing.device_ms`, CUDA-graph replays):

  fwd        the conv itself (`F.conv2d`, cuDNN);
  dx         its gradient with respect to the input (cuDNN);
  dw         its gradient with respect to the filter (cuDNN's weight
             gradient, `aten.convolution_backward`);
  dw_pallas  K4, `ops/dw_conv.py::dw_filter_grad` (CUDA C++), stride-1 only;
  plain      K4's plain PyTorch version, stride-1 only;

then the bytes bound of the filter gradient (x and g read once, the fp32
(C, 1, k, k) result written once; `bench_timing.bound_ms`) and K4's share
of it.  The totals weight each shape by its count in one encoder pass.
float32 runs with TF32 off, so cuDNN computes what K4 computes.  Stride-2
rows pad k // 2 on both sides, as the JAX script's "SAME" conv does (the
encoder pads those asymmetrically first; the bytes are the same).

The shape list is the JAX script's, except its last row: the JAX list counts
the 1392-channel 12x39 conv twice, and the encoder's two stage-6 blocks
have 1392 and 2304 channels (`models/efficientnet.py::variant_channels`).

    python -m occdepth_tpu_torch.scripts.bench_dwconv [--dtype bfloat16]
        [--repeats 8] [--json] [--check]

`--check` holds K4 to its plain version at every stride-1 shape (within
`K4_RTOL` x max|ref|, on the same inputs) and times nothing; it exits 1 on
a miss.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from occdepth_tpu_torch.ops.dw_conv import (
    K4_RTOL,
    dw_filter_grad,
    dw_filter_grad_reference,
)
from occdepth_tpu_torch.scripts import bench_timing

# (name, H, W, C, kernel, stride): every depthwise conv of the b3 encoder
# at 370x1220 (H, W are the conv input's; C = channels = groups)
B3_DW_SHAPES = [
    ("s0b0 k3 s1", 185, 610, 40, 3, 1),
    ("s0b1 k3 s1", 185, 610, 24, 3, 1),
    ("s1b0 k3 s2", 185, 610, 144, 3, 2),
    ("s1b1 k3 s1", 93, 305, 192, 3, 1),  # x2 blocks
    ("s2b0 k5 s2", 93, 305, 192, 5, 2),
    ("s2b1 k5 s1", 47, 153, 288, 5, 1),  # x2
    ("s3b0 k3 s2", 47, 153, 288, 3, 2),
    ("s3b1 k3 s1", 24, 77, 576, 3, 1),  # x4
    ("s4b0 k5 s1", 24, 77, 576, 5, 1),
    ("s4b1 k5 s1", 24, 77, 816, 5, 1),  # x4
    ("s5b0 k5 s2", 24, 77, 816, 5, 2),
    ("s5b1 k5 s1", 12, 39, 1392, 5, 1),  # x5
    ("s6b0 k3 s1", 12, 39, 1392, 3, 1),
    ("s6b1 k3 s1", 12, 39, 2304, 3, 1),
]
# how many times each shape occurs in one b3 forward
B3_DW_COUNTS = [1, 1, 1, 2, 1, 2, 1, 4, 1, 4, 1, 5, 1, 1]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def k4_shapes() -> list:
    """(name, H, W, C, k, count) of the stride-1 rows: the convs whose
    filter gradient K4 computes under dw_conv_grad=pallas."""
    return [(name, H, W, C, k, n)
            for (name, H, W, C, k, s), n in zip(B3_DW_SHAPES, B3_DW_COUNTS)
            if s == 1]


def make_inputs(H, W, C, k, s, dtype, gen):
    """(x, w, g) for one row on the generator's device: x (1, C, H, W) and
    the output cotangent g in `dtype`, the filter (C, 1, k, k) in `dtype`."""
    dev = gen.device
    x = torch.randn((1, C, H, W), generator=gen, device=dev).to(dtype)
    w = torch.randn((C, 1, k, k), generator=gen, device=dev).to(dtype)
    g = torch.randn((1, C, -(-H // s), -(-W // s)), generator=gen,
                    device=dev).to(dtype)
    return x, w, g


def k4_bound(C, H, W, k, elem_size, B=1) -> tuple:
    """(ms, "bytes" or "operations"): the least time for one filter
    gradient: x and g read once, the fp32 result written once, 2*k*k
    flops per element of g at the fp32 rate."""
    n = B * C * H * W
    return bench_timing.bound_ms(2 * n * elem_size + C * k * k * 4,
                                 2 * k * k * n, bench_timing.FP32_FLOPS)


def conv_grads(x, w, g, s):
    """(fwd, dx, dw) callables of the depthwise conv at stride s."""
    k, C = w.shape[-1], w.shape[0]
    pad = [k // 2, k // 2]

    def fwd():
        return F.conv2d(x, w, None, s, k // 2, 1, C)

    def grad(mask):
        return lambda: torch.ops.aten.convolution_backward(
            g, x, w, None, [s, s], pad, [1, 1], False, [0, 0], C, mask)

    return fwd, grad([True, False, False]), grad([False, True, False])


def time_shape(x, w, g, s, repeats) -> dict:
    """Device ms of every candidate for one row's inputs, and K4's bound
    and bound share at stride 1."""
    C, H, W = x.shape[1:]
    k = w.shape[-1]
    fwd, dx, dw = conv_grads(x, w, g, s)
    res = {name: bench_timing.device_ms(fn, calls=repeats)
           for name, fn in (("fwd_ms", fwd), ("dx_ms", dx), ("dw_ms", dw))}
    if s != 1:
        return dict(res, dw_pallas_ms=math.nan, plain_ms=math.nan,
                    bound_ms=math.nan, bound_by=None, bound_share=math.nan)
    res["dw_pallas_ms"] = bench_timing.device_ms(
        lambda: dw_filter_grad(x, g, k, k), calls=repeats)
    res["plain_ms"] = bench_timing.device_ms(
        lambda: dw_filter_grad_reference(x, g, k, k), calls=repeats)
    b_ms, kind = k4_bound(C, H, W, k, x.element_size())
    return dict(res, bound_ms=b_ms, bound_by=kind,
                bound_share=b_ms / res["dw_pallas_ms"])


def check_shape(x, g, k) -> tuple:
    """(max |K4 - plain|, max |plain|): K4 against its plain version in
    fp32 on the same inputs."""
    ref = dw_filter_grad_reference(x.float(), g.float(), k, k)
    out = dw_filter_grad(x, g, k, k)
    return (out - ref).abs().max().item(), ref.abs().max().item()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="K4 against its plain version at every stride-1 "
                         "shape; times nothing")
    args = ap.parse_args(argv)
    dev = bench_timing.cuda_device("bench_dwconv")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = DTYPES[args.dtype]
    gpu = bench_timing.gpu_line()
    gen = torch.Generator(device=dev).manual_seed(0)

    if args.check:
        worst = 0.0
        for name, H, W, C, k, _ in k4_shapes():
            x, _, g = make_inputs(H, W, C, k, 1, dtype, gen)
            err, ref_max = check_shape(x, g, k)
            rel = err / ref_max
            worst = max(worst, rel)
            print(f"{name:12s} max|err| {err:9.3e}  rel {rel:9.3e}",
                  flush=True)
        ok = worst <= K4_RTOL
        print(gpu, flush=True)
        print(json.dumps({"gpu": gpu, "dtype": args.dtype, "worst_rel_err": worst,
                          "rtol": K4_RTOL, "ok": ok}))
        if not ok:
            raise SystemExit(1)
        return

    results = {}
    tot = dict.fromkeys(("fwd", "dx", "dw", "dw_pallas"), 0.0)
    k4_tot = dict.fromkeys(("dw_pallas", "plain", "dw", "bound"), 0.0)
    print(f"{'shape':12s} {'fwd':>8s} {'dx':>8s} {'dw':>8s} {'dw_pal':>8s} "
          f"{'plain':>8s} {'bound':>8s} {'share':>6s}", flush=True)
    for (name, H, W, C, k, s), count in zip(B3_DW_SHAPES, B3_DW_COUNTS):
        x, w, g = make_inputs(H, W, C, k, s, dtype, gen)
        r = time_shape(x, w, g, s, args.repeats)
        results[name] = dict(r, count=count)
        for key in ("fwd", "dx", "dw"):
            tot[key] += r[f"{key}_ms"] * count
        # the JAX script's total: K4 where it applies, cuDNN's dw elsewhere
        tot["dw_pallas"] += (r["dw_ms"] if s != 1
                             else r["dw_pallas_ms"]) * count
        if s == 1:
            k4_tot["dw_pallas"] += r["dw_pallas_ms"] * count
            k4_tot["plain"] += r["plain_ms"] * count
            k4_tot["dw"] += r["dw_ms"] * count
            k4_tot["bound"] += r["bound_ms"] * count
        print(f"{name:12s} {r['fwd_ms']:8.4f} {r['dx_ms']:8.4f} "
              f"{r['dw_ms']:8.4f} {r['dw_pallas_ms']:8.4f} "
              f"{r['plain_ms']:8.4f} {r['bound_ms']:8.4f} "
              f"{r['bound_share']:6.1%}  x{count}", flush=True)
        del x, w, g
    print(f"TOTAL (b3 x1 view) fwd {tot['fwd']:.4f}  dx {tot['dx']:.4f}  "
          f"dw {tot['dw']:.4f}  dw_pallas(+s2 cuDNN) {tot['dw_pallas']:.4f} ms",
          flush=True)
    n_k4 = sum(n for *_, n in k4_shapes())
    print(f"TOTAL K4 ({n_k4} stride-1 convs) dw_pallas "
          f"{k4_tot['dw_pallas']:.4f}  plain {k4_tot['plain']:.4f}  "
          f"cuDNN dw {k4_tot['dw']:.4f}  bound {k4_tot['bound']:.4f}  "
          f"share {k4_tot['bound'] / k4_tot['dw_pallas']:.1%} ms", flush=True)
    print(f"launches dw_filter_grad={dw_filter_grad.launches}", flush=True)
    print(gpu, flush=True)
    if args.json:
        print(json.dumps({
            "gpu": gpu, "dtype": args.dtype,
            "totals_ms": tot, "k4_totals_ms": k4_tot,
            "per_shape": results,
            "launches": {"dw_filter_grad": dw_filter_grad.launches},
        }))


if __name__ == "__main__":
    main()
