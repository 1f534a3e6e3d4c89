"""Where the flagship eval step's time goes, on one CUDA device.

    python -m occdepth_tpu_torch.scripts.profile_eval \\
        [--steps 5] [--out eval_profile.json]

At the flagship KITTI stereo config (b3, feature 32, 370x1220 stereo,
256x256x32 grid, bf16, batch 1 frame = 2 views, seeded default-initialised
weights, one seeded labelled synthetic batch on the device, so no data
loading is timed) it reports:
  1. ms/frame of `eval_step` (forward, test-time losses, confusion counts)
     with `decoder_conv_impl` = xla (cuDNN) and = pallas (K3), in turns
     xla, pallas, pallas, xla, each the median over --steps steps after 2
     warm-up steps;
  2. for each, one step split by CUDA events into forward, losses and
     confusion counts, the pieces `eval_step` runs;
  3. for each, a torch.profiler trace of 2 steps: device busy share of the
     window, kernel time by kind (K3 and cuDNN's convolutions apart), the
     top kernels;
  4. peak device memory.
The numbers go to stdout and, as JSON, to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

from occdepth_tpu_torch.config import default_config_path, load_config
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.losses import confusion_update
from occdepth_tpu_torch.scripts.profile_train_step import (
    FLAGSHIP,
    _device_us,
    _kind,
    _model,
)
from occdepth_tpu_torch.training.step import compute_losses, eval_step

IMPLS = ("xla", "pallas")


def _steps_ms(cfg, model, batch, n: int) -> list:
    times = []
    for i in range(n + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eval_step(cfg, model, batch)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return times


def _phases_ms(cfg, model, batch) -> dict:
    """One step's pieces, in the order eval_step runs them."""
    inputs = {k: v for k, v in batch.items() if k != "sample_valid"}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.eval()
    with torch.inference_mode():
        ev[0].record()
        out = model(inputs)
        ev[1].record()
        compute_losses(cfg, out, inputs, 0.0, is_test=True)
        ev[2].record()
        confusion_update(out["ssc_logit"].argmax(dim=-1), inputs["target"],
                         cfg.n_classes, batch["sample_valid"])
        ev[3].record()
    ev[3].synchronize()
    names = ("forward", "losses", "confusion")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def _profile(cfg, model, batch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            eval_step(cfg, model, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, _device_us(e) / 1e3, e.count)
               for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(ms for _, ms, _ in kernels)
    kinds = {}
    for name, ms, _ in kernels:
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:15]
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
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    dev = torch.device("cuda")
    cfgs = {m: load_config(default_config_path(FLAGSHIP), dict(
        compute_dtype="bfloat16", decoder_conv_impl=m)) for m in IMPLS}
    np_batch = make_synthetic_batch(cfgs["xla"], 1, seed=0, with_labels=True)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in np_batch.items()}
    batch["sample_valid"] = torch.ones(1, dtype=torch.bool, device=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result = {"gpu": smi.splitlines()[0], "steps": args.steps,
              "frames_per_step": 1}

    per_impl = {m: [] for m in IMPLS}
    for impl in ("xla", "pallas", "pallas", "xla"):
        model = _model(cfgs[impl], dev)
        per_impl[impl] += _steps_ms(cfgs[impl], model, batch, args.steps)
        print(f"[steps] decoder_conv_impl={impl} "
              f"ms={per_impl[impl][-args.steps:]}", flush=True)
        del model
    result["ms_per_frame"] = {m: statistics.median(t)
                              for m, t in per_impl.items()}
    result["ms_per_frame_all"] = per_impl
    result["phases_ms"], result["profile"], result["peak_mem_gib"] = {}, {}, {}
    for impl in IMPLS:
        model = _model(cfgs[impl], dev)
        _steps_ms(cfgs[impl], model, batch, 0)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        result["phases_ms"][impl] = _phases_ms(cfgs[impl], model, batch)
        result["peak_mem_gib"][impl] = torch.cuda.max_memory_allocated() / 2**30
        result["profile"][impl] = _profile(cfgs[impl], model, batch)
        del model
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
