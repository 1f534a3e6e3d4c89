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
  6. the main path: ServingPipeline at the flagship KITTI stereo config
     (b3, feature 32, 370x1220 stereo, 256x256x32 grid, 20 classes, bf16,
     seeded random weights) serves 5 frames at batch size 2; the kernels'
     launch counters must grow over that run.
Then a JSON line of per-kernel results, the `nvidia-smi` name/power-limit
line, and as the last line {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero; there is no CPU fallback.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import numpy as np

K1_TOL = 1e-5  # fp32 row sums of 32 terms in another order
K2_RTOL = 2e-5  # fp32 sums of 512 terms in another order, x max|ref|
TINY_ATOL = 1e-3  # fp32 CUDA (cuDNN, TF32 off) vs CPU sums over a whole net
N_FRAMES, BATCH = 5, 2


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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    preds = list(pipe.run(frames))
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"stereo_cosine_fuse": stereo_cosine_fuse.launches,
                "crp_relation_matmul": crp_relation_matmul.launches}
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

    bf16 = k2[torch.bfloat16]
    print(json.dumps({"kernels": [
        {"name": "stereo_cosine_fuse", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/stereo_fuse.cu",
         "replaces": "occdepth_tpu/ops/pallas_kernels.py:118",
         "launches": launches["stereo_cosine_fuse"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "crp_relation_matmul", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/crp_matmul.cu",
         "replaces": "occdepth_tpu/ops/pallas_kernels.py:61",
         "launches": launches["crp_relation_matmul"],
         "max_abs_err": max(e for e, _, _ in k2.values()),
         "ms": bf16[1], "plain_ms": bf16[2]},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
