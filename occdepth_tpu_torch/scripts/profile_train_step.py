"""Where a train step's time goes, on one CUDA device.

    python -m occdepth_tpu_torch.scripts.profile_train_step \\
        [--config NAME] [--steps 5] [--out train_profile.json]

At a shipped config (`--config`, a name under occdepth_tpu_torch/configs: the
flagship KITTI stereo config by default, b3, feature 32, 370x1220 stereo,
256x256x32 grid; `tartanair/flosp_crp_cascadecls` for TartanAir's 480x640
stereo and 120x48x120 grid; `NYU/multicam_flosp_crp_stereodepth_cascadecls`
for NYU's 480x640 RGB-D and 60x36x60 grid), in bf16 at batch 1 with seeded
default-initialised weights and seeded labelled synthetic batches, it
reports:
  1. ms/step of `train_step` with `dw_conv_grad` = xla (PyTorch's own
     depthwise weight gradient) and = pallas (K4), in turns xla, pallas,
     pallas, xla, each the median over --steps steps after 2 warm-up steps;
  2. for dw_conv_grad=pallas, one step split by CUDA events into forward,
     losses, backward and clip + AdamW, the same pieces `train_step` runs;
  3. a torch.profiler trace of 2 steps: device busy share of the window,
     kernel time by kind, the top kernels, and K1/K2/K4's shares;
  4. peak device memory.
The numbers go to stdout and, as JSON, to --out.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import time

import torch

from occdepth_tpu_torch.config import default_config_path, load_config
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.training.optim import clip_by_global_norm_, make_optimizer
from occdepth_tpu_torch.training.step import compute_losses, train_step

FLAGSHIP = "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"

# kernel-name patterns -> kind, first match wins
KINDS = (
    ("K3 conv3x3", r"conv3x3"),
    ("K4 dw_filter_grad", r"dw_filter_grad"),
    ("K1 fused lift flosp_stereo_lift", r"flosp_stereo_lift"),
    ("K1 stereo_cosine_fuse", r"stereo_cosine_fuse"),
    ("K2 crp_relation_matmul", r"crp_relation_matmul|crp_wgmma"),
    ("batch norm", r"batch_norm|bn_"),
    ("convolution (cuDNN)", r"conv|xmma|implicit|dgrad|wgrad|cudnn|fprop"),
    ("matmul (cuBLAS)", r"gemm|cutlass|sm90_|ampere_"),
    ("depthwise conv (PyTorch)", r"depthwise|DepthwiseConv"),
    ("grid sample", r"grid_sample|grid_sampler"),
    ("index / gather / scatter", r"index|gather|scatter"),
    ("upsample / pooling", r"upsample|pool"),
    ("reduction", r"reduce|Reduce|norm_kernel"),
    ("layout copy", r"copy|transpose|nchwToNhwc|nhwcToNchw|permute"),
    ("optimizer", r"multi_tensor|foreach|adam"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def _kind(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _model(cfg, dev):
    gc.collect()  # the previous run's model and optimizer state
    torch.cuda.empty_cache()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(42)
        return OccDepthModel(cfg).to(dev)


def _steps_ms(cfg, batch, dev, n: int) -> list:
    model = _model(cfg, dev)
    opt = make_optimizer(model.parameters(), cfg)
    times = []
    for i in range(n + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(cfg, model, opt, [batch], 0.0, cfg.lr)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return times


def _phases_ms(cfg, batch, dev) -> dict:
    """One step's pieces, in the order train_step runs them."""
    model = _model(cfg, dev)
    opt = make_optimizer(model.parameters(), cfg)
    for _ in range(2):
        train_step(cfg, model, opt, [batch], 0.0, cfg.lr)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    model.train()
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    out = model(batch)
    ev[1].record()
    loss, _ = compute_losses(cfg, out, batch, 0.0)
    ev[2].record()
    loss.backward()
    ev[3].record()
    clip_by_global_norm_([p.grad for p in model.parameters()
                          if p.grad is not None], cfg.gradient_clip_val)
    opt.step()
    ev[4].record()
    ev[4].synchronize()
    names = ("forward", "losses", "backward", "clip_adamw")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def _profile(cfg, batch, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    model = _model(cfg, dev)
    opt = make_optimizer(model.parameters(), cfg)
    for _ in range(2):
        train_step(cfg, model, opt, [batch], 0.0, cfg.lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            train_step(cfg, model, opt, [batch], 0.0, cfg.lr)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device events only; the optimizer's record_function range
    # ("Optimizer.step#AdamW.step") also appears on the device timeline,
    # spanning the kernels it encloses, and would count them twice
    kernels = [(e.key, _device_us(e) / 1e3, e.count)
               for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]
    total = sum(ms for _, ms, _ in kernels)
    kinds = {}
    for name, ms, _ in kernels:
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:20]
    return {
        "window_ms_2_steps": window_ms,
        "kernel_ms_2_steps": total,
        "device_busy_share": total / window_ms if window_ms else None,
        "kinds_ms_2_steps": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms_2_steps": ms, "calls": c}
                        for n, ms, c in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=FLAGSHIP,
                    help="shipped config name (default: %(default)s)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device")
    dev = torch.device("cuda")
    base = dict(compute_dtype="bfloat16")
    cfgs = {m: load_config(default_config_path(args.config),
                           dict(base, dw_conv_grad=m))
            for m in ("xla", "pallas")}
    np_batch = make_synthetic_batch(cfgs["pallas"], 1, seed=0,
                                    with_labels=True)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in np_batch.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result = {"gpu": smi.splitlines()[0], "config": args.config,
              "steps": args.steps}

    per_mode = {"xla": [], "pallas": []}
    for mode in ("xla", "pallas", "pallas", "xla"):
        per_mode[mode] += _steps_ms(cfgs[mode], batch, dev, args.steps)
        print(f"[steps] dw_conv_grad={mode} ms={per_mode[mode][-args.steps:]}",
              flush=True)
    result["ms_per_step"] = {m: statistics.median(t)
                             for m, t in per_mode.items()}
    result["ms_per_step_all"] = per_mode
    torch.cuda.reset_peak_memory_stats()
    result["phases_ms"] = _phases_ms(cfgs["pallas"], batch, dev)
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result["profile"] = _profile(cfgs["pallas"], batch, dev)
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
