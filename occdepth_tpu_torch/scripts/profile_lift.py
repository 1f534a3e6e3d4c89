"""Device time of the fused lift and its backward, split by kernel.

    python -m occdepth_tpu_torch.scripts.profile_lift [--rigs kitti,...]
        [--iters 5] [--out lift_profile.json]

For each rig (`RIGS`: the flagship KITTI stereo config at C = 32, the
highcap configs' C = 64, TartanAir at C = 32, NYU b4 at C = 100 and b7 at
C = 200; batch 1, P = 1; KITTI's projection is `make_synthetic_batch`'s,
TartanAir's and NYU's that of the full-size synthetic trees,
`testing.tartanair_rig_projection` and `nyu_rig_projection`) it makes
seeded bf16 maps of the image's four scales on the card and reports:
  * `fwd_ms` / `fwd_cl_ms`: one call of `flosp_stereo_lift` on NCHW maps
    and on channels-last copies of them (`bench_timing.device_ms`: CUDA
    graph replays, the least of 5);
  * `bwd_ms`: one call of `flosp_stereo_lift_backward` on the NCHW maps
    (so its four packs are timed too, as an older tree's backward packs
    them);
  * `train_ms`: the train step's lift, forward and backward through
    autograd on NCHW leaves (CUDA events, median of 10);
  * `train_peak_mib`: the device memory that one such forward and
    backward allocates at its peak, above what was allocated before it
    (`torch.cuda.max_memory_allocated`);
  * `fwd_stages` / `bwd_stages`: torch.profiler's device time per call of
    every kernel (and memset) that the forward on NCHW maps and the
    backward on their packed copies (a train step's) launch, keyed by
    kernel name without its template arguments, with its count per call
    (`--iters` calls profiled).
It uses only the lift's public functions, so the same script times an
older tree: copy this file and `testing.py`'s two rig helpers in, then
`cd <checkout> && PYTHONPATH=. python -m
occdepth_tpu_torch.scripts.profile_lift`.  One JSON object goes to stdout
(and to --out); the card's name and power limit are in it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics

import torch

from occdepth_tpu_torch.scripts.bench_timing import (
    cuda_device,
    device_ms,
    gpu_line,
)

SCALES = (1, 2, 4, 8)
# name -> (config, channels)
RIGS = {
    "kitti": ("semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls",
              32),
    "highcap": ("semantic_kitti/multicam_flospdepth_crp_stereodepth_"
                "cascadecls_highcap", 64),
    "tartanair": ("tartanair/flosp_crp_cascadecls", 32),
    "nyu_b4": ("NYU/multicam_flosp_crp_stereodepth_cascadecls", 100),
    "nyu_b7": ("NYU/multicam_flosp_crp_depthgt_b7_v100", 200),
}


def rig_inputs(name: str, dev, seed: int = 0) -> tuple:
    """(NCHW bf16 maps, pix, fov, grad_out, image hw) for rig `name`."""
    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.testing import (
        nyu_rig_projection,
        tartanair_rig_projection,
    )

    config, C = RIGS[name]
    cfg = load_config(default_config_path(config))
    if name == "tartanair":
        arrays = tartanair_rig_projection(cfg.full_scene_size,
                                          cfg.voxel_size_meters)
    elif name.startswith("nyu"):
        arrays = nyu_rig_projection()
    else:
        sample = make_synthetic_batch(cfg, batch_size=1, seed=0)
        arrays = (sample["projected_pix"], sample["fov_mask"])
    pix, fov = (torch.from_numpy(a).to(dev) for a in arrays)
    H, W = cfg.img_shape
    g = torch.Generator(device=dev).manual_seed(seed)
    maps = [torch.randn(1, 2, -(-H // s), -(-W // s), C, device=dev,
                        generator=g).bfloat16().permute(0, 1, 4, 2, 3)
            .contiguous() for s in SCALES]
    cot = torch.randn(1, pix.shape[2], C, device=dev, generator=g)
    return maps, pix, fov, cot, (H, W)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def short_name(key: str) -> str:
    """A kernel's name without namespace, template arguments and
    parameters: "void (anonymous namespace)::f<T, 8>(...)" -> "f"."""
    if key.startswith("Memset") or key.startswith("Memcpy"):
        return key
    stem = re.split(r"[<(]", key.replace("(anonymous namespace)::", ""))[0]
    return stem.split("::")[-1].split()[-1]


def stages(fn, iters: int) -> dict:
    """{kernel: {"ms": device ms per call, "count": launches per call}}
    over `iters` profiled calls of `fn`, largest first.  The trace drops
    the first kernel launched after the profiler starts (seen on the
    card: one launch in twenty), so a sentinel launch
    (`torch.cuda._sleep`'s `spin_kernel`, left out of the result) goes
    first.  Raises when the trace has no kernel or a kernel at a
    fractional count per call (lost events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = _device_us(e)
        k = short_name(e.key)
        if (us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA
                or k == "spin_kernel"):
            continue
        prev = out.get(k, {"ms": 0.0, "count": 0.0})
        out[k] = {"ms": prev["ms"] + us / 1e3 / iters,
                  "count": prev["count"] + e.count / iters}
    if not out or any(v["count"] < 1 or v["count"] != int(v["count"])
                      for v in out.values()):
        raise RuntimeError("profile_lift.stages: the trace lost events "
                           "(counts per call "
                           f"{ {k: v['count'] for k, v in out.items()} })")
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def events_ms(fn, iters: int = 10) -> float:
    """Median CUDA-event time of one call of `fn` after 2 warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_rig(name: str, dev, iters: int) -> dict:
    from occdepth_tpu_torch.ops.flosp_gather import (
        channels_last_map,
        flosp_stereo_lift,
        flosp_stereo_lift_backward,
    )

    maps, pix, fov, cot, hw = rig_inputs(name, dev)
    maps_cl = [m.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
               for m in maps]
    packed = [channels_last_map(m) for m in maps]

    def fwd():
        return flosp_stereo_lift(maps, pix, fov, SCALES)

    def bwd():
        return flosp_stereo_lift_backward(maps, pix, fov, SCALES, cot)

    leaves = [m.detach().requires_grad_() for m in maps]

    def train():
        return torch.autograd.grad(
            flosp_stereo_lift(leaves, pix, fov, SCALES), leaves, cot)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    train()
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20

    res = {"shape": f"(1, {pix.shape[2]}, P{pix.shape[3]}, "
                    f"C={maps[0].shape[2]}) bf16, {hw[0]}x{hw[1]} image",
           "fov_both_share": fov.all(dim=1).float().mean().item(),
           "fwd_ms": device_ms(fwd),
           "fwd_cl_ms": device_ms(
               lambda: flosp_stereo_lift(maps_cl, pix, fov, SCALES)),
           "bwd_ms": device_ms(bwd),
           "train_ms": events_ms(train),
           "train_peak_mib": peak_mib,
           "fwd_stages": stages(fwd, iters),
           "bwd_stages": stages(lambda: flosp_stereo_lift_backward(
               packed, pix, fov, SCALES, cot), iters)}
    del maps, maps_cl, leaves, packed
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rigs", default=",".join(RIGS),
                    help="comma-separated of: " + ", ".join(RIGS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = cuda_device("profile_lift")
    result = {"gpu": gpu_line(), "tree": os.path.abspath(os.getcwd()),
              "rigs": {}}
    for name in args.rigs.split(","):
        result["rigs"][name] = r = profile_rig(name, dev, args.iters)
        print(f"[lift] {name} fwd={r['fwd_ms']:.5f} "
              f"fwd_cl={r['fwd_cl_ms']:.5f} bwd={r['bwd_ms']:.5f} "
              f"train={r['train_ms']:.5f} "
              f"train_peak_mib={r['train_peak_mib']:.1f}", flush=True)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
