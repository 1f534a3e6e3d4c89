"""Smoke run of the PyTorch/CUDA port (occdepth_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root, one CUDA device

Phases, one line each:
  1. environment: torch/CUDA versions, GPU name and power limit;
  2. builds the CUDA kernels from occdepth_tpu_torch/csrc with nvcc;
  3. K1 stereo_cosine_fuse vs its plain PyTorch version at the main
     path's shape (batch 2 x 262,144 voxel rows, C=32, two strided views
     of one fp32 tensor, masks ~30% zero), with CUDA-event times;
  4. K2 crp_relation_matmul vs its plain version at the main path's shape
     (batch 2, N=4096, M=512, C=256, transposed operand views), in bf16
     and fp32, with CUDA-event times;
  5. the tiny KITTI config's forward on CUDA (kernels) held to the same
     forward on the CPU (plain versions), fp32 with TF32 off;
  6. the serving path: ServingPipeline at the flagship KITTI stereo config
     (b3, feature 32, 370x1220 stereo, 256x256x32 grid, 20 classes, bf16,
     seeded random weights) serves 5 frames at batch size 2; the kernels'
     launch counters, set to 0 just before, must grow over that run;
  7. K4 dw_filter_grad vs its plain version at every stride-1 depthwise
     shape of the flagship encoder (batch 1), in bf16 and fp32, with the
     device times (CUDA-graph replays) of K4, the plain version and cuDNN's
     weight gradient (aten.convolution_backward), and the bytes bound;
  8. autograd through K1 and K2 on the card at the train path's shapes:
     their autograd Functions' gradients vs autograd of the plain versions;
  9. one tiny-config train step (fp32, TF32 off) on CUDA (kernels) vs the
     CPU (plain versions): loss terms, gradients, running statistics and
     updated parameters, within the fp32-noise-aware bounds of
     tests/test_torch_port_train_step.py;
 10. the training path: the Trainer at the flagship config in bf16 with
     dw_conv_grad=pallas takes 3 optimizer steps at batch 1 on 2 cycled
     labelled synthetic batches (counters set to 0 just before); every
     loss term finite, parameters changed, K4 launched once per stride-1
     depthwise conv of view 0 per step, K1 and K2 4 times per step;
     metrics.jsonl written; a second Trainer resumes at step 3.
Then a JSON line of per-kernel results, the `nvidia-smi` name/power-limit
line, and as the last line {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero; there is no CPU fallback.
"""
from __future__ import annotations

import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np

K1_TOL = 1e-5  # fp32 row sums of 32 terms in another order
K2_RTOL = 2e-5  # fp32 sums of 512 terms in another order, x max|ref|
TINY_ATOL = 1e-3  # fp32 CUDA (cuDNN, TF32 off) vs CPU sums over a whole net
N_FRAMES, BATCH = 5, 2
K4_RTOL = 1e-4  # x max|ref|: fp32 sums of up to 113k terms in another order
K1_GRAD_TOL = 1e-5  # fp32, the same formula's autograd in another order
K2_GRAD_RTOL = 2e-5  # x max|ref| in fp32 (512- and 4096-term sums)
K2_GRAD_BF16_RTOL = 2 ** -7  # one bf16 rounding of the returned gradient
LOSS_RTOL = 1e-4  # tiny train step, CUDA vs CPU loss terms
GRAD_RTOL, NOISE_MULT, N_PERTURB, FLIP_MULT = 1e-3, 4.0, 2, 2.0
TRAIN_STEPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
FLAGSHIP = "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of `fn`, in ms."""
    import torch

    for _ in range(warmup):
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn` in ms: `reps` calls captured in one
    CUDA graph, replayed between CUDA events, divided by `reps` (the host's
    enqueue cost, which single-call timing of a µs-scale kernel measures,
    is left out)."""
    import torch

    fn()  # warm-up outside the capture (cuDNN plans, allocator)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float) -> tuple:
    """(least time in ms, "bytes" or "operations") for moving n_bytes at
    the HBM rate and doing n_ops at peak_ops per second."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flagship_dw_shapes(dev) -> list:
    """(C, H, W, k) of every K4 conv of the flagship encoder at batch 1,
    read from the model by forward hooks (in forward order)."""
    import torch

    from occdepth_tpu_torch.models.efficientnet import DWConv2d, EfficientNet

    enc = EfficientNet("tf_efficientnet_b3_ns", dw_grad="pallas").to(dev)
    shapes = []
    for m in enc.modules():
        if isinstance(m, DWConv2d) and m.fast_grad:
            m.register_forward_hook(lambda mod, inp, out: shapes.append(
                (*inp[0].shape[1:], mod.kernel_size[0])))
    with torch.no_grad():
        enc(torch.zeros(1, 3, 370, 1220, device=dev, dtype=torch.bfloat16))
    del enc
    return shapes


def phase_k4(dev) -> dict:
    """7. K4 vs its plain version at every flagship stride-1 dw shape."""
    import torch

    from occdepth_tpu_torch.ops.dw_conv import (
        dw_filter_grad,
        dw_filter_grad_reference,
    )

    shapes = flagship_dw_shapes(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    max_err = max_rel = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kinds = set()
    for C, H, W, k in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, C, H, W, device=dev, generator=g).to(dtype)
            gy = torch.randn(1, C, H, W, device=dev, generator=g).to(dtype)
            # the plain version in fp32 on the same (bf16-rounded) inputs
            ref = dw_filter_grad_reference(x.float(), gy.float(), k, k)
            out = dw_filter_grad(x, gy, k, k)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = K4_RTOL * ref.abs().max().item()
            check(err <= tol, f"K4 {dtype} ({C},{H},{W},k{k}) error {err} > {tol}")
            max_err = max(max_err, err)
            max_rel = max(max_rel, err / ref.abs().max().item())
            if dtype != torch.bfloat16:
                continue  # times at the train path's dtype
            w = torch.zeros(C, 1, k, k, device=dev, dtype=dtype)

            def library():
                return torch.ops.aten.convolution_backward(
                    gy, x, w, None, [1, 1], [k // 2, k // 2], [1, 1], False,
                    [0, 0], C, [False, True, False])[1]

            ms = graph_ms(lambda: dw_filter_grad(x, gy, k, k))
            plain = graph_ms(lambda: dw_filter_grad_reference(x, gy, k, k))
            lib = graph_ms(library)
            ms_single = cuda_ms(lambda: dw_filter_grad(x, gy, k, k))
            n = C * H * W
            b_ms, kind = bound_ms(2 * n * x.element_size() + C * k * k * 4,
                                  2 * k * k * n, FP32_FLOPS)
            bound_kinds.add(kind)
            log("k4", shape=f"(1,{C},{H},{W})", k=k, dtype="bfloat16",
                max_abs_err=err, tol=f"{tol:.3e}", ms=f"{ms:.4f}",
                ms_single_call=f"{ms_single:.4f}",
                plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
                bound_ms=f"{b_ms:.4f}", bound_by=kind)
            tot["ms"] += ms
            tot["plain_ms"] += plain
            tot["library_ms"] += lib
            tot["bound_ms"] += b_ms
    log("k4_total", convs=len(shapes), **{k: f"{v:.4f}" for k, v in tot.items()},
        max_abs_err=max_err, max_rel_err=f"{max_rel:.3e}")
    return dict(tot, n_convs=len(shapes), max_abs_err=max_err,
                bound_by="bytes" if bound_kinds == {"bytes"} else "operations")


def phase_autograd(dev) -> None:
    """8. Gradients through the K1/K2 autograd Functions on the card vs
    autograd of the plain versions, at the train path's shapes."""
    import torch

    from occdepth_tpu_torch.ops.crp_matmul import (
        crp_relation_matmul,
        crp_relation_matmul_reference,
    )
    from occdepth_tpu_torch.ops.stereo_fuse import (
        stereo_cosine_fuse,
        stereo_cosine_fuse_reference,
    )

    g = torch.Generator(device=dev).manual_seed(8)

    def grads(fn, leaves, args, cot):
        out = fn(*args)
        check(out.grad_fn is not None, f"{fn.__name__} returned no grad_fn")
        return torch.autograd.grad(out, leaves, cot)

    # K1: one (B=1, V=2, N, C) feature tensor, the views strided slices
    N, C = 128 * 128 * 16, 32
    valid = (torch.rand(1, 2, N, device=dev, generator=g) > 0.3).float()
    feats = (torch.randn(1, 2, N, C, device=dev, generator=g)
             * valid[..., None]).requires_grad_()
    cot = torch.randn(1, N, C, device=dev, generator=g)
    args = (feats[:, 0], feats[:, 1], valid[:, 0], valid[:, 1])
    (gk,) = grads(stereo_cosine_fuse, [feats], args, cot)
    (gr,) = grads(stereo_cosine_fuse_reference, [feats], args, cot)
    err = (gk - gr).abs().max().item()
    log("k1_grad", shape=f"(1,{N},{C})x2", max_abs_err=err, tol=K1_GRAD_TOL)
    check(err <= K1_GRAD_TOL, f"K1 gradient error {err}")

    # K2: (B=1, M, N) logits and (B=1, C, M) mega read transposed, as the
    # CRP passes them
    Nv, M, Cc = 4096, 512, 256
    for dtype, rtol in ((torch.float32, K2_GRAD_RTOL),
                        (torch.bfloat16, K2_GRAD_BF16_RTOL)):
        logits = torch.randn(1, M, Nv, device=dev, generator=g).to(dtype)
        mega = torch.randn(1, Cc, M, device=dev, generator=g).to(dtype)
        logits.requires_grad_()
        mega.requires_grad_()
        cot = torch.randn(1, Nv, Cc, device=dev, generator=g)
        args = (logits.transpose(1, 2), mega.transpose(1, 2))
        gk = grads(crp_relation_matmul, [logits, mega], args, cot)
        gr = grads(crp_relation_matmul_reference, [logits, mega], args, cot)
        for name, a, b in zip(("dP", "dmega"), gk, gr):
            err = (a.float() - b.float()).abs().max().item()
            tol = rtol * b.float().abs().max().item()
            log("k2_grad", dtype=str(dtype).replace("torch.", ""), wrt=name,
                max_abs_err=err, tol=f"{tol:.3e}")
            check(err <= tol, f"K2 {dtype} {name} gradient error {err} > {tol}")


def phase_tiny_train(dev) -> dict:
    """9. One tiny-config train step on CUDA (kernels) vs the CPU."""
    import torch

    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.ops.stereo_fuse import stereo_cosine_fuse
    from occdepth_tpu_torch.testing import (
        count_flips,
        noise_aware_worst,
        perturbed_copy,
        randomize_weights,
        tiny_kitti_config,
    )
    from occdepth_tpu_torch.training.optim import make_optimizer
    from occdepth_tpu_torch.training.step import train_step

    cfg = tiny_kitti_config(dw_conv_grad="pallas")
    batch = make_synthetic_batch(cfg, batch_size=1, seed=31, with_labels=True)
    lr = cfg.lr

    def step(model, device):
        model = model.to(device)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        logs, _, _ = train_step(
            cfg, model, make_optimizer(model.parameters(), cfg),
            [{k: torch.from_numpy(v).to(device) for k, v in batch.items()}],
            0.0, lr)
        sd = model.state_dict()
        return ({k: float(v) for k, v in logs.items()},
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                {n: (sd[n] - before[n]).cpu() for n in before},
                {k: v.cpu() for k, v in sd.items()
                 if k.endswith(("running_mean", "running_var"))})

    cpu_model = randomize_weights(OccDepthModel(cfg), seed=1)
    gpu_models = [copy.deepcopy(cpu_model)] + [
        perturbed_copy(cpu_model, s) for s in range(N_PERTURB)]
    counts0 = (stereo_cosine_fuse.launches, crp_relation_matmul.launches,
               dw_filter_grad.launches)
    cuda_runs = [step(m, dev) for m in gpu_models]
    launches = [c1 - c0 for c0, c1 in zip(counts0, (
        stereo_cosine_fuse.launches, crp_relation_matmul.launches,
        dw_filter_grad.launches))]
    ref = step(cpu_model, "cpu")
    ours, noise = cuda_runs[0], cuda_runs[1:]

    loss_err = max(abs(ours[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ref[0])
    worst = {}
    for i, (name, rtol) in ((1, ("grads", GRAD_RTOL)), (3, ("stats", 1e-5))):
        worst[name] = noise_aware_worst(ours[i], ref[i], [q[i] for q in noise],
                                        rtol, NOISE_MULT)[0]
    flips = count_flips(ours[2], ref[2], 0.5 * lr)
    flips_noise = max(count_flips(ours[2], q[2], 0.5 * lr) for q in noise)
    log("tiny_train", loss_rel_err=f"{loss_err:.3e}", loss_rtol=LOSS_RTOL,
        grad_worst=f"{worst['grads'][0]:.3f}:{worst['grads'][1]}",
        stats_worst=f"{worst['stats'][0]:.3f}:{worst['stats'][1]}",
        update_flips=flips, noise_flips=flips_noise,
        k1_launches=launches[0], k2_launches=launches[1],
        k4_launches=launches[2])
    check(loss_err <= LOSS_RTOL, f"tiny train loss error {loss_err}")
    for name, w in worst.items():
        check(w[0] <= 1.0, f"tiny train {name}: {w}")
    check(flips <= FLIP_MULT * max(flips_noise, 1),
          f"tiny train update flips {flips} vs noise {flips_noise}")
    check(min(launches) > 0, f"tiny train launches {launches}")
    return {"loss_rel_err": loss_err}


def phase_train(dev, smi: str) -> dict:
    """10. The training path: the flagship Trainer takes 3 steps."""
    import numpy as np
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.ops.stereo_fuse import stereo_cosine_fuse
    from occdepth_tpu_torch.training import Trainer

    cfg = load_config(default_config_path(FLAGSHIP), overrides={
        "compute_dtype": "bfloat16", "dw_conv_grad": "pallas",
        "log_every_n_steps": 1})
    t0 = time.perf_counter()
    batches = [make_synthetic_batch(cfg, batch_size=1, seed=s,
                                    with_labels=True) for s in (0, 1)]
    data_s = time.perf_counter() - t0
    logdir = tempfile.mkdtemp(prefix="occdepth_train_")
    try:
        trainer = Trainer(cfg, logdir)
        check(trainer.step == 0 and trainer.device.type == "cuda",
              f"fresh trainer at step {trainer.step} on {trainer.device}")
        n_dw = sum(1 for m in trainer.model.modules()
                   if getattr(m, "fast_grad", False))
        before = {n: p.detach().clone()
                  for n, p in trainer.model.named_parameters()}
        cycled = [batches[i % 2] for i in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stereo_cosine_fuse.launches = 0
        crp_relation_matmul.launches = 0
        dw_filter_grad.launches = 0
        t0 = time.perf_counter()
        trainer.fit(cycled, max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"stereo_cosine_fuse": stereo_cosine_fuse.launches,
                    "crp_relation_matmul": crp_relation_matmul.launches,
                    "dw_filter_grad": dw_filter_grad.launches}
        peak = torch.cuda.max_memory_allocated()
        step_ms = trainer.step_ms
        ms_step = statistics.mean(step_ms[1:])
        final = {n: p.detach().clone()
                 for n, p in trainer.model.named_parameters()}
        # the decoder's 1_16 head feeds no loss: zero gradient, and AdamW's
        # decay alone (lr * wd ~ 2e-8 relative) is below an fp32 ulp
        trained = [n for n, p in trainer.model.named_parameters()
                   if p.grad is not None and bool(p.grad.any())]
        changed = sum(int(not torch.equal(final[n], before[n]))
                      for n in trained)
        with open(trainer.metrics_logger.path) as f:
            records = [json.loads(line) for line in f]
        train_recs = [r for r in records if "train/loss" in r]
        last = train_recs[-1] if train_recs else {}
        terms = sorted(k for k in last if k.startswith("train/loss"))
        log("train", steps=trainer.step, data_s=f"{data_s:.2f}",
            wall_s=f"{wall_s:.2f}",
            step_ms=",".join(f"{t:.1f}" for t in step_ms),
            ms_per_step_2_3=f"{ms_step:.2f}",
            peak_mem_gib=f"{peak / 2**30:.3f}", gpu=repr(smi),
            dw_convs=n_dw, params_changed=f"{changed}/{len(trained)}",
            k1_launches=launches["stereo_cosine_fuse"],
            k2_launches=launches["crp_relation_matmul"],
            k4_launches=launches["dw_filter_grad"],
            **{k.replace("train/", ""): f"{last[k]:.5f}" for k in terms})
        check(trainer.step == TRAIN_STEPS, f"trainer at step {trainer.step}")
        expected = {"train/loss", "train/loss_relation_ce_super",
                    "train/loss_ssc", "train/loss_occ", "train/loss_depth",
                    "train/loss_sem_scal", "train/loss_geo_scal",
                    "train/loss_frustums"}
        check([r["step"] for r in train_recs] == list(range(1, TRAIN_STEPS + 1)),
              f"metrics.jsonl train records {[r['step'] for r in train_recs]}")
        check(expected <= set(terms), f"loss terms {terms}")
        check(all(math.isfinite(r[k]) for r in train_recs for k in expected),
              "a loss term is not finite")
        check(changed == len(trained) >= len(before) - 2,
              f"{changed}/{len(trained)} params with a gradient changed")
        check(n_dw == 22, f"{n_dw} stride-1 depthwise convs (expected 22)")
        check(launches["dw_filter_grad"] == n_dw * TRAIN_STEPS,
              f"K4 launches {launches['dw_filter_grad']}")
        check(launches["stereo_cosine_fuse"]
              == len(cfg.project_res) * TRAIN_STEPS,
              f"K1 launches {launches['stereo_cosine_fuse']}")
        check(launches["crp_relation_matmul"] == cfg.n_relations * TRAIN_STEPS,
              f"K2 launches {launches['crp_relation_matmul']}")
        check(any("train/mIoU" in r for r in records), "no train/mIoU record")
        del trainer
        resumed = Trainer(cfg, logdir)
        log("resume", step=resumed.step)
        check(resumed.step == TRAIN_STEPS, f"resumed at step {resumed.step}")
        for n, p in resumed.model.named_parameters():
            check(torch.equal(p.detach(), final[n]),
                  f"resumed {n} differs from the saved parameters")
        del resumed
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return {"launches": launches, "ms_per_step": ms_step,
            "peak_gib": peak / 2**30}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.ops import cuda_lib
    from occdepth_tpu_torch.ops.crp_matmul import (
        crp_relation_matmul,
        crp_relation_matmul_reference,
    )
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.ops.stereo_fuse import (
        stereo_cosine_fuse,
        stereo_cosine_fuse_reference,
    )
    from occdepth_tpu_torch.serving import ServingPipeline
    from occdepth_tpu_torch.testing import randomize_weights, tiny_kitti_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        gpu=repr(smi), count=torch.cuda.device_count())

    # ---- 2. kernel build ----
    lib_path, build_s = cuda_lib.build()
    cuda_lib.library()
    log("build", seconds=f"{build_s:.2f}",
        cached=build_s == 0.0, library=lib_path)

    # ---- 3. K1 at the main path's shape ----
    g = torch.Generator(device=dev).manual_seed(0)
    N, C = 128 * 128 * 16, 32
    valid = (torch.rand(BATCH, 2, N, device=dev, generator=g) > 0.3).float()
    feats = torch.randn(BATCH, 2, N, C, device=dev,
                        generator=g) * valid[..., None]
    k1_args = (feats[:, 0], feats[:, 1], valid[:, 0], valid[:, 1])
    k1_err = (stereo_cosine_fuse(*k1_args)
              - stereo_cosine_fuse_reference(*k1_args)).abs().max().item()
    k1_ms = cuda_ms(lambda: stereo_cosine_fuse(*k1_args))
    k1_plain_ms = cuda_ms(lambda: stereo_cosine_fuse_reference(*k1_args))
    log("k1", shape=f"({BATCH},{N},{C})x2", max_abs_err=k1_err, tol=K1_TOL,
        ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}")
    check(k1_err <= K1_TOL, f"K1 error {k1_err} > {K1_TOL}")

    # ---- 4. K2 at the main path's shape, operands laid out as in the model ----
    Nv, M, Cc = 4096, 512, 256
    k2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        logits = torch.randn(BATCH, M, Nv, device=dev, generator=g).to(dtype)
        mega = torch.randn(BATCH, Cc, M, device=dev, generator=g).to(dtype)
        args = (logits.transpose(1, 2), mega.transpose(1, 2))
        ref = crp_relation_matmul_reference(*args)
        err = (crp_relation_matmul(*args) - ref).abs().max().item()
        tol = K2_RTOL * ref.abs().max().item()
        ms = cuda_ms(lambda: crp_relation_matmul(*args))
        plain_ms = cuda_ms(lambda: crp_relation_matmul_reference(*args))
        k2[dtype] = (err, ms, plain_ms)
        log("k2", dtype=str(dtype).replace("torch.", ""),
            shape=f"{BATCH}x({Nv},{M})@({M},{Cc})", max_abs_err=err,
            tol=f"{tol:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
        check(err <= tol, f"K2 {dtype} error {err} > {tol}")

    # ---- 5. tiny config: CUDA (kernels) vs CPU (plain versions) ----
    tcfg = tiny_kitti_config()
    cpu_model = randomize_weights(OccDepthModel(tcfg), seed=1).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    tbatch = make_synthetic_batch(tcfg, batch_size=2, seed=3)
    before = (stereo_cosine_fuse.launches, crp_relation_matmul.launches)
    with torch.inference_mode():
        out_cpu = cpu_model({k: torch.from_numpy(v) for k, v in tbatch.items()})
        out_gpu = gpu_model({k: torch.from_numpy(v).to(dev)
                             for k, v in tbatch.items()})
    tiny_err = max((out_gpu[k].cpu() - out_cpu[k]).abs().max().item()
                   for k in out_cpu)
    tiny_launches = (stereo_cosine_fuse.launches - before[0],
                     crp_relation_matmul.launches - before[1])
    log("tiny", keys=",".join(sorted(out_cpu)), max_abs_err=tiny_err,
        atol=TINY_ATOL, k1_launches=tiny_launches[0],
        k2_launches=tiny_launches[1])
    check(tiny_err <= TINY_ATOL, f"tiny CUDA vs CPU error {tiny_err}")
    check(min(tiny_launches) > 0, "tiny forward launched no kernel")

    # ---- 6. main path: flagship KITTI stereo serving ----
    cfg = load_config(
        default_config_path(
            "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"),
        overrides={"use_stereo_depth_gt": False,
                   "compute_dtype": "bfloat16", "use_pallas": True},
    )
    model = randomize_weights(OccDepthModel(cfg), seed=0).to(dev)
    calib = make_synthetic_batch(cfg, batch_size=1, seed=0)
    pipe = ServingPipeline(cfg, model, calib, batch_size=BATCH,
                           max_in_flight=2)
    t0 = time.perf_counter()
    pipe.warmup()
    warm_s = time.perf_counter() - t0
    rs = np.random.RandomState(0)
    H, W = cfg.img_shape
    frames = [rs.randint(0, 256, size=(cfg.n_views, H, W, 3)).astype(np.uint8)
              for _ in range(N_FRAMES)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stereo_cosine_fuse.launches = 0
    crp_relation_matmul.launches = 0
    dw_filter_grad.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    preds = list(pipe.run(frames))
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"stereo_cosine_fuse": stereo_cosine_fuse.launches,
                "crp_relation_matmul": crp_relation_matmul.launches,
                "dw_filter_grad": dw_filter_grad.launches}
    dispatches = -(-N_FRAMES // BATCH)
    ms_frame = start.elapsed_time(end) / N_FRAMES
    peak = torch.cuda.max_memory_allocated()
    log("serve", frames=len(preds), dispatches=dispatches,
        shape=tuple(preds[0].shape) if preds else None,
        warmup_s=f"{warm_s:.2f}", ms_per_frame=f"{ms_frame:.2f}",
        fps=f"{N_FRAMES / wall_s:.3f}",
        peak_mem_gib=f"{peak / 2**30:.3f}",
        k1_launches=launches["stereo_cosine_fuse"],
        k2_launches=launches["crp_relation_matmul"])
    check(len(preds) == N_FRAMES, f"{len(preds)} outputs for {N_FRAMES}")
    for p in preds:
        check(p.shape == tuple(cfg.full_scene_size) and p.dtype == np.uint8,
              f"output {p.shape} {p.dtype}")
        check(int(p.max()) < cfg.n_classes, f"class {int(p.max())}")
        check(np.unique(p).size > 1, "a served grid is constant")
    check(len({p.tobytes() for p in preds}) == N_FRAMES,
          "distinct frames gave identical grids")
    check(launches["stereo_cosine_fuse"] == dispatches * len(cfg.project_res),
          f"K1 launches {launches['stereo_cosine_fuse']}")
    check(launches["crp_relation_matmul"] == dispatches * cfg.n_relations,
          f"K2 launches {launches['crp_relation_matmul']}")
    check(launches["dw_filter_grad"] == 0, "serving ran a backward")

    # ---- 7-10. K4, autograd through K1/K2, tiny and flagship training ----
    k4 = phase_k4(dev)
    phase_autograd(dev)
    phase_tiny_train(dev)
    train = phase_train(dev, smi)

    def by_path(name):
        serve_n, train_n = launches[name], train["launches"][name]
        return {"launches": serve_n + train_n,
                "launches_by_path": {"serve": serve_n, "train": train_n}}

    bf16 = k2[torch.bfloat16]
    # bytes each kernel must move at the shapes timed above
    k1_bound = bound_ms(3 * BATCH * N * C * 4 + 2 * BATCH * N * 4,
                        6 * BATCH * N * C, FP32_FLOPS)
    k2_bound = bound_ms(BATCH * (Nv * M * 2 + M * Cc * 2 + Nv * Cc * 4),
                        2 * BATCH * Nv * M * Cc, BF16_FLOPS)
    print(json.dumps({"kernels": [
        {"name": "stereo_cosine_fuse", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/stereo_fuse.cu",
         "replaces": "occdepth_tpu/ops/pallas_kernels.py:118",
         **by_path("stereo_cosine_fuse"),
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "crp_relation_matmul", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/crp_matmul.cu",
         "replaces": "occdepth_tpu/ops/pallas_kernels.py:61",
         **by_path("crp_relation_matmul"),
         "max_abs_err": max(e for e, _, _ in k2.values()),
         "ms": bf16[1], "plain_ms": bf16[2],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "dw_filter_grad", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/dw_filter_grad.cu",
         "replaces": "occdepth_tpu/ops/dw_conv.py:99",
         **by_path("dw_filter_grad"),
         "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"],
         "timed": f"sum over the {k4['n_convs']} stride-1 depthwise convs "
                  "of one flagship view, bf16, batch 1"},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
