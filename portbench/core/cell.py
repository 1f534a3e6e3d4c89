"""One run of one cell: set-up, the measured window, the check, the line.

`run_cell` drives a mix's runner (the module `portbench.core.<kind>` of
the mix's `kind`, its class `Runner`) through:

  1. set-up: the program's model with the seeded weights, the inputs,
     the warm-up (the first steps of a train mix); `setup_s` runs from
     the process start to the window;
  2. the window, `seconds` long; with trace, the window is the untraced
     stretch of the per-layer metrics and a profiled stretch follows;
  3. the device memory peak, then the program is freed;
  4. the plain reference over what the window produced, each compared
     number beside its limit.

It returns the result line's object, `checks` last.
"""
from __future__ import annotations

import importlib
import sys
import time
from types import SimpleNamespace

import torch

from portbench.core.check import verdict
from portbench.core.spec import Bench

FORBIDDEN = ("jax", "jaxlib", "flax", "occdepth_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device, count: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", bench: Bench = None) -> dict:
    bench = bench or Bench()
    w = bench.workload(workload)
    spec = bench.config(w["config"])
    mix = bench.mix(w["traffic"])
    limits = bench.limits(workload)
    device = torch.device(device)
    runner = importlib.import_module(f"portbench.core.{mix['kind']}").Runner(
        spec, mix, seed, device)
    cuda = device.type == "cuda"

    runner.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    out = runner.window(seconds, spans=traced)
    stretch = runner.profile() if traced else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    lift = runner.lift_bytes() if traced else {}
    runner.release()
    chk = runner.check(out, count_flops=traced)
    correct, checks = verdict(chk["numbers"], limits)
    correct = correct and out["failed"] == 0

    metrics = {}
    if not traced:
        values = dict(out["e2e"], setup_s=setup_s,
                      peak_mem_gib=peak / 2**30)
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(
            kind=mix["kind"], stretch=stretch,
            untraced_units=out["units"], untraced_seconds=out["seconds"],
            dispatch_host_ms=out.get("dispatch_host_ms"),
            flops_per_unit=chk["flops_per_unit"], **lift)
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(device, 1, peak)}
    if traced:
        result["device"].update(busy_s=stretch.busy_s,
                                window_s=stretch.window_s)
        result["breakdown"] = stretch.breakdown()
    result["info"] = dict(chk["info"], **{
        k: out[k] for k in ("host_ms_each", "batch_done_ms") if k in out})
    result["checks"] = checks
    return result
