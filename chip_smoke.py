"""Smoke run of the PyTorch/CUDA port (occdepth_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root, one CUDA device

Phases, one line each:
  1. environment: torch/CUDA versions, GPU name and power limit;
  2. builds the CUDA kernels from occdepth_tpu_torch/csrc with nvcc;
 2b. csrc/hopper_selftest.cu before any kernel runs: the bf16 TMA swizzle
     and shifted-descriptor wgmma, ldmatrix.trans + RS wgmma, and the TF32
     SS and RS products (N = 48, 96, 128) of the fp32 kernels, each
     against the product computed on the host; the TF32 split kernel
     against its plain version, bit for bit;
  3. K1 stereo_cosine_fuse vs its plain PyTorch version at the lift's
     shape (batch 2 x 262,144 voxel rows, C=32, two strided views of one
     fp32 tensor, masks ~30% zero), with device times (CUDA-graph
     replays); the model's paths no longer run it (3b fuses it);
 3b. the fused lift flosp_stereo_lift (gather, K1's fusion and the sum
     over scales in one kernel) vs its plain version at the serving shape
     (batch 2, 262,144 voxels, C=32, maps at 1_1..1_8 of a 370x1220
     image, P=1): bf16 and fp32 maps, NCHW and channels-last, on points
     with every edge case (each map's last row and column, out of FOV,
     voxels seen by one view), a P=4 case at 32,768 voxels, and the
     serving rig's own projection; device times of the kernel (NCHW maps,
     so its channels-last copies are timed, and channels-last maps), the
     plain version, today's per-scale path (index_select + K1 per scale)
     as its yardstick, and the bytes bound (coordinates, masks, each
     distinct gathered row once, the output once);
  4. K2 crp_relation_matmul vs its plain version at the CRP's shape, the
     four relations in one call (batch 2, R=4, N=4096, M=512, C=256, the
     model's transposed operand views), in bf16 (wgmma) and fp32 (3xTF32
     wgmma), each on its tensor-core kernel by the per-path counters, with
     device times (CUDA-graph replays) beside the SIMT kernel on the same
     operands and torch.sigmoid + matmul (TF32 off), and the bound (fp32:
     three TF32 products at 495 TFLOP/s); both must beat the SIMT kernel;
  5. the tiny KITTI, TartanAir (project_scale 1), occluded-head KITTI and
     NYU RGB-D (the virtual right view) configs' forwards on CUDA
     (kernels) held to the same forwards on the CPU (plain versions), fp32
     with TF32 off: the fused lift and K2 (3xTF32) launch once each, the
     standalone K1 never;
  6. the serving path: ServingPipeline at the flagship KITTI stereo config
     (b3, feature 32, 370x1220 stereo, 256x256x32 grid, 20 classes, bf16,
     seeded random weights) serves 5 frames at batch size 2; the kernels'
     launch counters, set to 0 just before, must grow over that run (the
     fused lift and K2 once per dispatch); the device time of sfa_lift and
     of the CRP block per dispatch (CUDA events,
     scripts/profile_serve_stages.py's hooks);
  7. K4 dw_filter_grad (one launch per conv: clusters of blocks per
     channel, bands staged by bulk copies) vs its plain version at every
     stride-1 depthwise shape of the flagship encoder (batch 1, the 22
     convs of scripts/bench_dwconv.py, which the encoder's forward hooks
     must reproduce), in bf16 and fp32, with the device times (CUDA-graph
     replays, bench_dwconv's timing) of K4, the plain version and cuDNN's
     weight gradient (aten.convolution_backward), the bytes bound and the
     bound share of each of the ten distinct shapes; K4 must not read
     under its bound (a kernel that skipped work would);
  8. autograd through K1, the fused lift and K2 (its four relations in
     one call) on the card at the train path's shapes: their registered
     gradients vs autograd of the plain versions, the lift's (its backward
     kernel) also vs its closed-form plain version; then the lift's
     backward kernel alone at the flagship's train shape (batch 1,
     262,144 voxels, C=32, 370x1220): vs its plain version on the rig and
     on edge-case points at P=1 and P=4, bf16 and fp32, NCHW and
     channels-last, two calls equal bit for bit, device times of the
     kernel and the plain version (CUDA-graph replays), the bytes bound
     (grad_out and the coordinates read once, each distinct row that an
     in-FOV point names read once, every row written once) and its share; the kernel must not read under its
     bound and must beat the plain version;
  9. one tiny-config train step (fp32, TF32 off) on CUDA (kernels) vs the
     CPU (plain versions): loss terms, gradients, running statistics and
     updated parameters, within the fp32-noise-aware bounds of
     tests/test_torch_port_train_step.py; the lift's backward kernel once
     per step;
 10. the training path: the Trainer at the flagship config in bf16 with
     dw_conv_grad=pallas fits 3 optimizer steps at batch 1 on a 2-sample
     labelled synthetic dataset, validating on a 1-sample one at each
     epoch end (counters set to 0 just before); every loss term finite,
     parameters changed, K4 launched once per stride-1 depthwise conv of
     view 0 per step with no operand copied to NCHW, the fused lift and
     K2 once per step and per validation forward, the lift's backward
     kernel once per step, the plain lift (forward or backward) on no
     CUDA tensor, the standalone K1 never; val/mIoU logged,
     best_val_mIoU kept; metrics.jsonl written; a second Trainer resumes
     at step 3;
 11. K3 conv3x3 (implicit GEMM on 128-pixel tiles: one TMA halo load per
     128 bytes of channels; in bf16 read by shifted descriptors for the
     nine taps, in fp32 by register fragments split into TF32 hi and lo,
     three wgmmas per step against the weights' hi and lo; two consumer
     warpgroups) vs its plain version at the flagship decoder's ten 3x3 conv
     shapes (batch 2 images, NCHW inputs, so the wrapper's packing
     copies are timed), in bf16 and fp32 (TF32 off), with the device
     times (CUDA-graph replays) of K3, the plain version and cuDNN's conv
     (F.conv2d), the bound, TFLOP/s and bound share of each conv; K3 must
     not read under its bound (a kernel that skipped work would); then K3
     vs its plain version, untimed, at bench_conv2d's shapes that the
     decoder lacks (up2 conv0 at Ci=120), on that script's inputs;
 12. the eval path: a synthetic SemanticKITTI tree (make_kitti_tree, 3 val
     frames) and a reference-schema .ckpt of seeded random weights;
     `evaluate` at batch 2 (a ragged last batch) in fp32 (TF32 off) with
     decoder_conv_impl=xla and =pallas (counters set to 0 just before
     each): K3 launched 20 times under pallas and never under xla, the
     fused lift and K2 once per batch under both, K2 and K3 on their
     3xTF32 kernels, the confusion counts of the two within 1e-5 of the
     counted voxels, the padding counting 3 frames; then the flagship's
     fp32 eval forward of one frame at full width under pallas on the
     card and on the host's CPU (plain versions), each head within
     tests/test_fullres_parity.py's tolerances (logits 5e-3, depth_pred
     1e-3), with the seconds of each; then, after one untimed bf16 pass of
     each, bf16 ms/frame of xla and pallas in turns, and the eval CLI as a
     subprocess, which must print the metric table;
 13. K6 row_gather vs its plain version at bench_gather's five table shapes
     (262,144 indices), bf16 and fp32, bit for bit (a row of 33 values and
     out-of-range indices too), with the device times (CUDA-graph replays,
     in turns over 4 tables) of K6, the plain version and index_select, and
     the bytes bound of each gather;
 14. K5 matmul_probe (operands resident in shared memory after one TMA
     load, wgmma chains on two warpgroups taking the steps in turn, TMA
     stores) vs its plain version at bench_head_pallas's three probes (one
     conv-equivalent each), within 2^-7 max|ref|, with the device times of
     K5, the plain version and torch.matmul, and the bound; K5 must not
     read under its bound (a product hoisted out of the step loop would);
 15. the probe scripts bench_gather, bench_head_pallas --json,
     bench_dwconv and bench_conv2d as subprocesses: each exits 0, prints a
     time for every candidate (every row of bench_dwconv's list) and a
     launch count above 0 of its kernel (K6, K5, K4, K3);
 16. TartanAir's kernels on a full-size synthetic tree (make_tartanair_tree:
     480x640 stereo PNGs, 120x48x120 labels, a rig that puts ~80% of the
     voxels in both views): the fused lift into 691,200 voxels (batch 1,
     the tree's projection and edge-case points, bf16 and fp32, NCHW and
     channels-last) and its forward + backward time, and its backward
     kernel as in phase 8 (two calls bit for bit); K2 at the 30x12x30
     bottleneck, (1, 4, 10,800, 1,350) @ (1, 1,350, 256), bf16 on the
     wgmma kernel and fp32 on the 3xTF32 one (mega padded to 1,352) beside
     the SIMT kernel and torch.sigmoid + torch.matmul; K4 at the b3
     encoder's 22 stride-1 depthwise convs on a 480x640 image; K3 at the
     decoder's ten 3x3 convs on a 480x640 frame, bf16 and fp32, with
     cuDNN's conv beside (fp32 K3's ten-conv sum must beat cuDNN fp32's);
     each vs its plain version, with device times (CUDA-graph replays)
     and bounds;
 17. TartanAir training: the shipped tartanair config (b3, feature 32,
     120x48x120, 14 classes) in bf16 with dw_conv_grad=pallas fits 3 steps
     at batch 1 on the tree, validating at each epoch end (counters set
     to 0 just before): every loss term finite, parameters changed, K4
     once per stride-1 depthwise conv of view 0 per step with no copies,
     the fused lift and K2 once per step and per validation forward, K1
     never; ms/step and peak memory; then the train CLI as a subprocess
     for 2 steps, and again to resume at step 2;
 18. TartanAir evaluation of the tree's 2 val frames from a
     reference-schema .ckpt: fp32 (TF32 off) under decoder_conv_impl=xla
     and =pallas (K2 and K3 on their 3xTF32 kernels, K3 under pallas
     only, confusion counts within CONF_FLIP_FRAC), bf16 ms/frame in
     turns, and the eval CLI, which must print the 14-class table;
 19. the shipped occluded-head KITTI config at full width, bf16: 3 train
     steps at batch 1 (loss_occluded finite, the occluded head's
     parameters changed, the launch counts of phase 10) and an eval
     forward whose occluded_logit is (1, 256, 256, 32, 2) float32;
 20. NYU's kernels on a full-size synthetic tree (make_nyu_tree: 480x640
     RGB images, uint16 depth PNGs, 60x36x60 labels, a rig that puts ~70%
     of the voxels in the real and the virtual view): the fused lift of
     the real and the virtual view into 129,600 voxels at b4's C = 100
     (bf16 rows of 200 bytes: one element a lane) and b7's C = 200, bf16
     and fp32, NCHW and channels-last, on the tree's projection and on
     edge-case points, and its backward kernel as in phase 8; K2 at the
     15x9x15 bottleneck, (1, 4, 2,025, 196) @
     (1, 196, 800) and b7's 1,600 channels, bf16 on the wgmma kernel with
     the logits and mega padded (neither stride is a 16-byte multiple),
     fp32 on the 3xTF32 one with the logits padded, beside the SIMT kernel
     and sigmoid + matmul; K4 at the b4 and the b7 encoder's stride-1
     depthwise convs on 480x640; K3 at the b4 decoder's ten 3x3 convs,
     bf16 and fp32 with cuDNN's beside (fp32's ten-conv sum must beat
     cuDNN fp32's); each vs its plain version, with device times
     (CUDA-graph replays) and bounds;
 21. NYU training: the shipped b4 config (feature 100, 60x36x60, 12
     classes) in bf16 with dw_conv_grad=pallas fits 3 steps at batch 1 on
     the tree, validating on the test split at each epoch end, with phase
     17's checks (K4 once per stride-1 depthwise conv per step, no
     copies; the lift and K2 once per step and per validation forward);
     the train CLI for 2 steps and its resume; then the b7 config
     (feature 200) at full width: two train steps (the first pays
     one-time costs) and one eval forward, losses finite, K4 once per
     stride-1 depthwise conv of b7 per step with no copies, ms and peak
     memory;
 22. NYU evaluation of the tree's 2 test frames at batch 2 (sample 0's
     disparity warps both) from a reference-schema .ckpt: fp32 (TF32 off)
     under decoder_conv_impl=xla and =pallas (K2 and K3 on their 3xTF32
     kernels, K3 under pallas only, confusion counts within
     CONF_FLIP_FRAC), bf16 ms/frame in turns, and the eval CLI, which
     must print the 12-class table;
 23. the shipped KITTI configs no other phase trains, at full width in bf16
     with dw_conv_grad=pallas: K4 vs its plain version at the b7 encoder's
     stride-1 depthwise convs on 370x1220 (bench_dwconv's method, with its
     times, bound and cuDNN's); the fused lift (and its backward kernel)
     at the highcap configs' C = 64 and K2 at (1, 4, 4,096, 512) @ (1,
     512, 512), bf16 and fp32, vs their plain versions; flospdepth (one
     view, no CRP or cascade),
     the stereo-depth highcap (b7, feature 64) and the flosp highcap (b7,
     flosp), each 2 steps at batch 1 with validation: losses finite,
     parameters moved, K4 once per depthwise conv of each differentiated
     view (both views under share_2d_backbone_gradient: false) with 0
     copies, ms/step and peak memory;
 24. the output CLIs at full width (the flagship, bf16) on a
     make_kitti_tree tree whose eleven test sequences link to val sequence
     08, from a reference-schema .ckpt: infer under decoder_conv_impl=auto
     and =pallas (rendered if matplotlib imports), generate_output over the
     val split, generate_kitti_submission over the test split and the
     port's validator on it, dump_batch --synthetic, each main in-process
     with its launch counts (the lift and K2 once per frame, K3 ten times
     under pallas) and its y_pred held to the in-process argmax, wall and
     device ms/frame; infer once more as a subprocess;
 25. generate_output over the NYU b4 test split (the tree of 20-22):
     cam_pose, vox_origin, y_pred against the in-process argmax;
 26. export at full width: the flagship under decoder_conv_impl=pallas
     exported on the card, saved and loaded; the loaded program launches
     the lift and K2 once and K3 ten times per forward and matches eager;
     the export time and the loaded program's and eager's ms/frame;
 27. data parallel: (a) the flagship (bf16, dw_conv_grad=pallas) through
     the DDP Trainer in a one-rank NCCL group under torchrun's variables,
     2 steps with phase 10's checks (lift and K2 once a step, K4 22 times
     a step, no copies), ms/step, peak memory and its first-step
     parameters against a plain train_step on the same weights and batch;
     then side by side (b) scripts/check_ddp.py: two gloo ranks on this
     card (one tiny-config row each, fp32) held to the one-process
     emulation, with the kernels each rank launched, and (c)
     scripts/check_resume_determinism.py (TartanAir toy tree,
     deterministic: true, SIGKILL and resume) and
     scripts/check_convergence.py (the flagship on a make_kitti_tree tree,
     loss descent across a SIGKILL/resume splice);
 28. the raw-data path: (a) the native preprocessing library (built with
     g++ into build/native/ at start; here a forced build's seconds) and
     each binding held exactly to its plain NumPy version; (b) raw
     SemanticKITTI .label/.invalid files beside a full-size
     make_kitti_tree tree whose labels are deleted, the preprocess_kitti
     CLI, every _1_1 held to the plain remap and every _1_8 to the plain
     majority pool, then the flagship (bf16, dw_conv_grad=pallas) trained
     2 steps from that tree through the train CLI's main (the lift and K2
     once a step and per val forward, K4 22 times a step, no copies);
     (c) raw NYU RLE scans, the preprocess_nyu CLI, its targets held to
     the plain decode and pool, one b4 eval batch of 2 frames; (d) a raw
     10-frame TartanAir depth/seg sequence, the export_voxels_tartanair
     CLI with 2 workers, target_1_1 held to the plain vote, one eval batch
     of its 2 frames; (e) bench_loader on (b)'s tree: ms/sample with the
     native and the plain frustum histograms at workers 0 and 2, beside
     (b)'s ms/step.
Then a JSON line of per-kernel results, the `nvidia-smi` name/power-limit
line, and as the last line {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero; there is no CPU fallback.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from occdepth_tpu_torch.scripts.bench_timing import (
    BF16_FLOPS,
    FP32_FLOPS,
    FP32_TC_FLOPS,
    bound_ms,
    device_ms,
    gpu_line,
)

K1_TOL = 1e-5  # fp32 row sums of 32 terms in another order
LIFT_TOL = 1e-5  # as K1, and fp32 sums of 4 scales (and of P points) reordered
LIFT_SCALES = (1, 2, 4, 8)  # the flagship's project_res
K2_RTOL = 2e-5  # fp32 sums of 512 terms in another order, x max|ref|
# (the bf16 wgmma kernel's split sigmoid adds 2^-18 relative per term)
K2_RELATIONS = 4
TINY_ATOL = 1e-3  # fp32 CUDA (cuDNN, TF32 off) vs CPU sums over a whole net
N_FRAMES, BATCH = 5, 2
K1_GRAD_TOL = 1e-5  # fp32, the same formula's autograd in another order
K2_GRAD_RTOL = 2e-5  # x max|ref| in fp32 (512- and 4096-term sums)
K2_GRAD_BF16_RTOL = 2 ** -7  # one bf16 rounding of the returned gradient
# the lift's backward kernel vs its plain version, x max(1, max|ref|) per
# map: fp32 sums of each row's terms in another order; bf16 one rounding of
# those sums apart
LIFT_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
LOSS_RTOL = 1e-4  # tiny train step, CUDA vs CPU loss terms
GRAD_RTOL, NOISE_MULT, N_PERTURB, FLIP_MULT = 1e-3, 4.0, 2, 2.0
TRAIN_STEPS = 3
K3_BATCH = 2  # one eval frame: 2 views through the backbone at once
K5_RTOL = 2 ** -7  # x max|ref|: one bf16 rounding of fp32 sums reordered
K3_RTOL = {"float32": 1e-4,  # x max|ref|: fp32 sums of 9*Ci terms reordered
           "bfloat16": 2 ** -7}  # one bf16 rounding of the output
EVAL_FRAMES, EVAL_BATCH = 3, 2
CONF_FLIP_FRAC = 1e-5  # of counted voxels: argmax flips xla vs pallas, fp32
FLAGSHIP = "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"
OCCLUDED = FLAGSHIP + "_occluded"
TA_CONFIG = "tartanair/flosp_crp_cascadecls"
TA_GRID, TA_VOXEL = (120, 48, 120), 0.1  # the shipped config's grid
TA_FRAMES = 2  # per sequence: 2 train (P000) and 2 val (P005) samples
TA_HW = (480, 640)
NYU_B4 = "NYU/multicam_flosp_crp_stereodepth_cascadecls"
NYU_B7 = "NYU/multicam_flosp_crp_depthgt_b7_v100"
NYU_GRID, NYU_HW = (60, 36, 60), (480, 640)  # (X, Z_up, Y); the image
NYU_FRAMES = 2  # per split: 2 train and 2 test frames
NYU_EVAL_BATCH = 2  # one batch of 2: sample 0's disparity warps both


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


def phase_selftest(dev) -> dict:
    """2b. csrc/hopper_selftest.cu before any kernel runs: the bf16 TMA
    swizzle and shifted-descriptor wgmma (conv3x3's halo reads), the
    ldmatrix.trans + RS wgmma of bf16 K2, and the TF32 SS and RS products
    of fp32 K2 and K3 at N = 48, 96, 128, each against the product
    computed on the host from the same inputs; then the TF32 split kernel
    against its plain version, bit for bit."""
    import torch

    from occdepth_tpu_torch.ops import cuda_lib
    from occdepth_tpu_torch.ops.tf32 import split_tf32_packed, to_tf32_rna

    lib, stream = cuda_lib.library(), torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0

    def held(what, d, ref, rtol=1e-5):
        nonlocal worst
        err = (d.cpu() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        worst = max(worst, rel)
        check(rel <= rtol, f"hopper self-test {what}: error {rel:.3e} x "
                           f"max|ref| > {rtol}")

    for shift, rows in ((0, 8), (3, 8), (0, 24), (2, 24)):
        a = torch.randn(8 * rows + 8, 64, device=dev, generator=g).bfloat16()
        b = torch.randn(16, 64, device=dev, generator=g).bfloat16()
        dump = torch.empty(64, 64, dtype=torch.bfloat16, device=dev)
        d = torch.empty(64, 16, device=dev)
        cuda_lib.check(lib.occ_hopper_selftest(
            a.data_ptr(), b.data_ptr(), dump.data_ptr(), d.data_ptr(), shift,
            rows, stream), "hopper_selftest")
        torch.cuda.synchronize()
        m = torch.arange(64)
        ref = (a.cpu()[(m // 8) * rows + shift + m % 8].float()
               @ b.cpu().float().t())
        held(f"bf16 SS shift {shift} group {rows}", d, ref)
    at = torch.randn(64, 64, device=dev, generator=g).bfloat16()
    b = torch.randn(256, 64, device=dev, generator=g).bfloat16()
    d = torch.empty(64, 256, device=dev)
    cuda_lib.check(lib.occ_hopper_selftest_rs(
        at.data_ptr(), b.data_ptr(), d.data_ptr(), stream),
        "hopper_selftest_rs")
    torch.cuda.synchronize()
    held("bf16 RS", d, at.cpu().float().t() @ b.cpu().float().t())
    for n in (48, 96, 128):
        for rs in (0, 1):
            a = to_tf32_rna(torch.randn(64, 32, device=dev, generator=g))
            b = to_tf32_rna(torch.randn(n, 32, device=dev, generator=g))
            d = torch.empty(64, n, device=dev)
            cuda_lib.check(lib.occ_hopper_selftest_tf32(
                a.data_ptr(), b.data_ptr(), d.data_ptr(), n, rs, stream),
                "hopper_selftest_tf32")
            torch.cuda.synchronize()
            held(f"TF32 {'RS' if rs else 'SS'} n={n}", d,
                 a.cpu() @ b.cpu().t())
    x = torch.randn(2, 256, 1350, device=dev, generator=g)
    split = split_tf32_packed(x, 1352)
    check(torch.equal(split.cpu().view(torch.int32),
                      split_tf32_packed(x.cpu(), 1352).view(torch.int32)),
          "TF32 split kernel differs from its plain version")
    log("hopper_selftest", cases="bf16 SS x4, bf16 RS, TF32 SS/RS x "
        "n=48,96,128, TF32 split", max_rel_err=worst, rtol=1e-5)
    return {"max_rel_err": worst}


def phase_k1(dev) -> dict:
    """3. The standalone K1 vs its plain version at the lift's shape."""
    import torch

    from occdepth_tpu_torch.ops.stereo_fuse import (
        stereo_cosine_fuse,
        stereo_cosine_fuse_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    N, C = 128 * 128 * 16, 32
    valid = (torch.rand(BATCH, 2, N, device=dev, generator=g) > 0.3).float()
    feats = torch.randn(BATCH, 2, N, C, device=dev,
                        generator=g) * valid[..., None]
    args = (feats[:, 0], feats[:, 1], valid[:, 0], valid[:, 1])
    err = (stereo_cosine_fuse(*args)
           - stereo_cosine_fuse_reference(*args)).abs().max().item()
    ms = device_ms(lambda: stereo_cosine_fuse(*args))
    plain = device_ms(lambda: stereo_cosine_fuse_reference(*args))
    b_ms, kind = bound_ms(3 * BATCH * N * C * 4 + 2 * BATCH * N * 4,
                          6 * BATCH * N * C, FP32_FLOPS)
    log("k1", shape=f"({BATCH},{N},{C})x2", max_abs_err=err, tol=K1_TOL,
        ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}", bound_ms=f"{b_ms:.5f}",
        bound_by=kind, bound_share=f"{b_ms / ms:.3f}")
    check(err <= K1_TOL, f"K1 error {err} > {K1_TOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": kind}


def lift_maps(dev, dtype, layout, B, C, hw, seed):
    """Seeded random (B, 2, C, h, w) maps of the four scales of an hw =
    (H, W) image on the card, in `dtype` and `layout` ("nchw" or
    "channels_last")."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    H, W = hw
    maps = []
    for s in LIFT_SCALES:
        m = torch.randn(B, 2, -(-H // s), -(-W // s), C, device=dev,
                        generator=g).to(dtype).permute(0, 1, 4, 2, 3)
        maps.append(m.contiguous() if layout == "nchw" else m)
    return maps


def per_scale_lift(maps, pix, fov, scales):
    """The lift as it ran before the fused kernel, its yardstick: per
    scale flosp_gather_flat (index_select) then the standalone K1, summed."""
    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_gather_flat,
        multiview_cosine_fuse,
    )

    x3d = None
    for x2d, s in zip(maps, scales):
        feats, valid = flosp_gather_flat(x2d, pix // s if s > 1 else pix, fov)
        fused = multiview_cosine_fuse(feats, valid)
        x3d = fused if x3d is None else x3d + fused
    return x3d


def named_row_bytes(maps, pix, fov, scales) -> int:
    """The bytes of the distinct (batch, view, scale) map rows that an
    in-FOV point names and that lie on the map: what the lift reads."""
    import torch

    B, V, C = maps[0].shape[:3]
    n = 0
    for m, s in zip(maps, scales):
        h, w = m.shape[3:]
        p = (pix // s if s > 1 else pix).long()
        on = fov & (p[..., 0] >= 0) & (p[..., 0] < w) & (p[..., 1] >= 0) \
            & (p[..., 1] < h)
        idx = (p[..., 1] * w + p[..., 0]
               + torch.arange(B * V, device=p.device).view(B, V, 1, 1) * h * w)
        n += torch.unique(idx[on]).numel() * C * m.element_size()
    return n


def lift_bytes(maps, pix, fov, scales) -> int:
    """What the fused lift must move on these inputs: the coordinates and
    masks once, each distinct row that an in-FOV point names once, the
    fp32 output once."""
    B, C = maps[0].shape[0], maps[0].shape[2]
    n = pix.numel() * pix.element_size() + fov.numel()
    return (n + named_row_bytes(maps, pix, fov, scales)
            + B * pix.shape[2] * C * 4)


def lift_backward_bytes(maps, pix, fov, scales, grad_out) -> int:
    """What the lift's backward must move: grad_out, the coordinates and
    the masks read once, each distinct row that an in-FOV point names read
    once (the forward's reads), every row of each map's gradient written
    once (zeros where no point lands)."""
    n = grad_out.numel() * 4 + pix.numel() * pix.element_size() + fov.numel()
    n += named_row_bytes(maps, pix, fov, scales)
    return n + sum(m.numel() * m.element_size() for m in maps)


class PlainLiftCalls:
    """While active, counts the calls of the plain lift, forward or
    backward, on CUDA tensors (the module attributes the registered
    operators call); a train path on the card must make none."""

    NAMES = ("flosp_stereo_lift_reference",
             "flosp_stereo_lift_backward_reference")

    def __enter__(self):
        import occdepth_tpu_torch.ops.flosp_gather as fg

        self.module, self.saved, self.count = fg, {}, 0
        for name in self.NAMES:
            fn = self.saved[name] = getattr(fg, name)

            def counted(maps, *args, _fn=fn, **kwargs):
                self.count += int(any(m.is_cuda for m in maps))
                return _fn(maps, *args, **kwargs)

            setattr(fg, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def lift_backward_at_shape(dev, rig, hw, C, cases, tag, edge_seed,
                           map_seed) -> dict:
    """The lift's backward kernel at batch 1 on the rig's N voxels from the
    four scales of an hw image at C channels (the train step's shape), vs
    its plain version in each (dtype, layout, points) case of `cases`
    (points "rig": the projection, "edges": `lift_points`' edge cases at
    P=1, "p4": at P=4 on N / 8 voxels), within LIFT_GRAD_RTOL; then on the
    rig with bf16 NCHW maps (the train path's): two calls bit for bit, the
    device times of the kernel and the plain version, the bytes bound and
    its share.  The kernel must not read under its bound and must beat
    the plain version."""
    import torch

    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_stereo_lift_backward,
        flosp_stereo_lift_backward_reference,
    )
    from occdepth_tpu_torch.testing import lift_points

    N = rig[0].shape[2]
    rng = np.random.RandomState(edge_seed)
    points = {"rig": rig}
    for name, n, P in (("edges", N, 1), ("p4", N // 8, 4)):
        points[name] = [torch.from_numpy(a).to(dev)
                        for a in lift_points(rng, 1, n, P, hw)]
    g = torch.Generator(device=dev).manual_seed(map_seed)
    worst, worst_abs = {}, 0.0
    for i, (dtype, layout, name) in enumerate(cases):
        pix, fov = points[name]
        maps = lift_maps(dev, dtype, layout, 1, C, hw, seed=map_seed + i)
        cot = torch.randn(1, pix.shape[2], C, device=dev, generator=g)
        got = flosp_stereo_lift_backward(maps, pix, fov, LIFT_SCALES, cot)
        ref = flosp_stereo_lift_backward_reference(maps, pix, fov,
                                                   LIFT_SCALES, 1e-8, cot)
        torch.cuda.synchronize()
        diffs = [((a.float() - b.float()).abs().max().item(),
                  b.float().abs().max().item()) for a, b in zip(got, ref)]
        err = max(d / max(1.0, m) for d, m in diffs)
        worst_abs = max([worst_abs] + [d for d, _ in diffs])
        key = str(dtype).replace("torch.", "")
        log(f"{tag}_bwd_check", points=name, P=pix.shape[3], layout=layout,
            C=C, dtype=key, max_rel_err=err, rtol=LIFT_GRAD_RTOL[key])
        check(err <= LIFT_GRAD_RTOL[key], f"{tag} backward {name} {key} "
              f"{layout} C={C} error {err} x max(1, max|ref|)")
        worst[key] = max(worst.get(key, 0.0), err)
        del maps, got, ref
    pix, fov = rig
    maps = lift_maps(dev, torch.bfloat16, "nchw", 1, C, hw, seed=map_seed + 9)
    cot = torch.randn(1, N, C, device=dev, generator=g)
    first, second = (flosp_stereo_lift_backward(maps, pix, fov, LIFT_SCALES,
                                                cot) for _ in range(2))
    res = {"max_rel_err": worst, "max_abs_err": worst_abs,
           "bitwise": all(torch.equal(bits(a), bits(b))
                          for a, b in zip(first, second))}
    del first, second
    res["ms"] = device_ms(lambda: flosp_stereo_lift_backward(
        maps, pix, fov, LIFT_SCALES, cot))
    res["plain_ms"] = device_ms(lambda: flosp_stereo_lift_backward_reference(
        maps, pix, fov, LIFT_SCALES, 1e-8, cot))
    res["bound_ms"], res["bound_by"] = bound_ms(
        lift_backward_bytes(maps, pix, fov, LIFT_SCALES, cot), 0,
        FP32_FLOPS)
    log(f"{tag}_bwd", shape=f"(1,{N},P1,{C}) bf16 NCHW, rig projection",
        ms=f"{res['ms']:.5f}", plain_ms=f"{res['plain_ms']:.5f}",
        bound_ms=f"{res['bound_ms']:.5f}", bound_by=res["bound_by"],
        bound_share=f"{res['bound_ms'] / res['ms']:.3f}",
        bitwise=res["bitwise"], max_rel_err=worst)
    check(res["bitwise"], f"{tag}: two backward calls differ")
    check(res["ms"] >= res["bound_ms"],
          f"{tag} backward C={C} {res['ms']} ms under its bound")
    check(res["ms"] < res["plain_ms"], f"{tag} backward {res['ms']} ms, not "
          f"faster than the plain version {res['plain_ms']}")
    torch.cuda.empty_cache()
    return res


def phase_lift(dev, calib, hw) -> dict:
    """3b. The fused lift vs its plain version at the serving shape: the
    rig's N voxels (calib's projection) of an hw = (H, W) image."""
    import torch

    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_stereo_lift,
        flosp_stereo_lift_reference,
    )
    from occdepth_tpu_torch.testing import lift_points

    C, N = 32, calib["projected_pix"].shape[2]
    rng = np.random.RandomState(3)
    edge_pts = [torch.from_numpy(a).to(dev)
                for a in lift_points(rng, BATCH, N, 1, hw)]
    p4_pts = [torch.from_numpy(a).to(dev)
              for a in lift_points(rng, BATCH, N // 8, 4, hw)]
    # the serving rig's own projection, as the pipeline broadcasts it
    rig = [torch.from_numpy(np.broadcast_to(
        calib[k][:1], (BATCH,) + calib[k].shape[1:]).copy()).to(dev)
        for k in ("projected_pix", "fov_mask")]
    check(tuple(rig[0].shape) == (BATCH, 2, N, 1, 2),
          f"rig projection {tuple(rig[0].shape)}")
    max_err = 0.0
    cases = [(dt, lay, "edges", edge_pts)
             for dt in (torch.bfloat16, torch.float32)
             for lay in ("nchw", "channels_last")]
    cases += [(torch.bfloat16, "nchw", "p4", p4_pts),
              (torch.float32, "channels_last", "p4", p4_pts),
              (torch.bfloat16, "nchw", "rig", rig)]
    for i, (dtype, layout, name, (pix, fov)) in enumerate(cases):
        maps = lift_maps(dev, dtype, layout, BATCH, C, hw, seed=i)
        out = flosp_stereo_lift(maps, pix, fov, LIFT_SCALES)
        ref = flosp_stereo_lift_reference(maps, pix, fov, LIFT_SCALES)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log("lift_check", points=name, dtype=str(dtype).replace("torch.", ""),
            layout=layout, shape=f"({BATCH},{pix.shape[2]},P{pix.shape[3]},"
            f"{C})", max_abs_err=err, tol=LIFT_TOL)
        check(err <= LIFT_TOL, f"fused lift {name} {dtype} {layout} error "
                               f"{err} > {LIFT_TOL}")
        max_err = max(max_err, err)
        del maps, out, ref
    # times at the serving path's inputs: bf16 maps, the rig's projection
    pix, fov = rig
    res = {"max_abs_err": max_err}
    maps = lift_maps(dev, torch.bfloat16, "nchw", BATCH, C, hw, seed=9)
    maps_cl = [m.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
               for m in maps]
    for layout, ms_maps in (("nchw", maps), ("channels_last", maps_cl)):
        res[layout] = device_ms(
            lambda: flosp_stereo_lift(ms_maps, pix, fov, LIFT_SCALES))
    res["plain_ms"] = device_ms(
        lambda: flosp_stereo_lift_reference(maps, pix, fov, LIFT_SCALES))
    res["yardstick_ms"] = device_ms(
        lambda: per_scale_lift(maps, pix, fov, LIFT_SCALES))
    res["ms"] = res["nchw"]
    n_bytes = lift_bytes(maps, pix, fov, LIFT_SCALES)
    res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, 0, FP32_FLOPS)
    log("lift", shape=f"({BATCH},{N},P1,{C}) bf16 rig projection",
        ms_nchw=f"{res['nchw']:.5f}",
        ms_channels_last=f"{res['channels_last']:.5f}",
        plain_ms=f"{res['plain_ms']:.5f}",
        yardstick_ms=f"{res['yardstick_ms']:.5f}", bytes=n_bytes,
        bound_ms=f"{res['bound_ms']:.5f}", bound_by=res["bound_by"],
        bound_share=f"{res['bound_ms'] / res['ms']:.3f}",
        max_abs_err=max_err)
    check(res["channels_last"] >= res["bound_ms"],
          f"fused lift took {res['channels_last']} ms, under its bound "
          f"{res['bound_ms']}: work was skipped")
    check(res["ms"] < res["yardstick_ms"],
          f"fused lift {res['ms']} ms, not faster than the per-scale path "
          f"{res['yardstick_ms']}")
    torch.cuda.empty_cache()
    return res


def phase_tiny(dev) -> None:
    """5. The tiny KITTI, TartanAir (project_scale 1), occluded-head KITTI
    and NYU RGB-D (the virtual view; its batch carries depth) configs'
    forwards on CUDA (kernels) vs the CPU (plain versions), fp32 with TF32
    off: the fused lift and K2 once each, K1 never."""
    import torch

    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.testing import (
        randomize_weights,
        tiny_kitti_config,
        tiny_nyu_config,
        tiny_tartanair_config,
    )

    for name, tcfg in (("kitti", tiny_kitti_config()),
                       ("tartanair", tiny_tartanair_config()),
                       ("kitti_occluded", tiny_kitti_config(occluded_cls=True)),
                       ("nyu", tiny_nyu_config())):
        cpu_model = randomize_weights(OccDepthModel(tcfg), seed=1).eval()
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        tbatch = make_synthetic_batch(tcfg, batch_size=2, seed=3,
                                      with_labels=tcfg.dataset == "NYU")
        reset_counts()
        with torch.inference_mode():
            out_cpu = cpu_model({k: torch.from_numpy(v)
                                 for k, v in tbatch.items()})
            out_gpu = gpu_model({k: torch.from_numpy(v).to(dev)
                                 for k, v in tbatch.items()})
        tiny_err = max((out_gpu[k].cpu() - out_cpu[k]).abs().max().item()
                       for k in out_cpu)
        n = read_counts()
        check_fp32_tensor_cores(f"tiny {name}", n)
        log("tiny", config=name, keys=",".join(sorted(out_cpu)),
            max_abs_err=tiny_err, atol=TINY_ATOL,
            lift_launches=n["flosp_stereo_lift"],
            k2_launches=n["crp_relation_matmul"],
            k1_launches=n["stereo_cosine_fuse"])
        check(tiny_err <= TINY_ATOL, f"tiny {name} CUDA vs CPU error {tiny_err}")
        check(n["flosp_stereo_lift"] == 1 and n["crp_relation_matmul"] == 1
              and n["stereo_cosine_fuse"] == 0,
              f"tiny {name} forward launches {n} (lift and K2 once, K1 never)")
        check(("occluded_logit" in out_cpu) == tcfg.occluded_cls,
              f"tiny {name} outputs {sorted(out_cpu)}")


K2_PATH = {"bfloat16": "wgmma_bf16", "float32": "wgmma_tf32"}


def phase_k2(dev) -> dict:
    """4. K2, the four relations in one call, vs its plain version on the
    tensor cores in both dtypes (bf16 wgmma, fp32 3xTF32 wgmma: per-path
    counters), with device times beside the SIMT kernel on the same
    operands (k2_simt, the route fp32 took before) and torch.sigmoid +
    matmul (library_ms); fp32 must beat the SIMT kernel."""
    import torch

    from occdepth_tpu_torch.ops.crp_matmul import (
        crp_relation_matmul,
        crp_relation_matmul_reference,
        wgmma_path,
    )

    g = torch.Generator(device=dev).manual_seed(4)
    R, Nv, M, Cc = K2_RELATIONS, 4096, 512, 256
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        logits = torch.randn(BATCH, R, M, Nv, device=dev,
                             generator=g).to(dtype)
        mega = torch.randn(BATCH, Cc, M, device=dev, generator=g).to(dtype)
        args = (logits.transpose(2, 3), mega.transpose(1, 2))
        check(wgmma_path(*args), f"K2 {name} did not take a tensor-core "
                                 "kernel")
        ref = crp_relation_matmul_reference(*args)
        before = crp_relation_matmul.paths[K2_PATH[name]]
        err = (crp_relation_matmul(*args) - ref).abs().max().item()
        check(crp_relation_matmul.paths[K2_PATH[name]] == before + 1,
              f"K2 {name} launched no {K2_PATH[name]} kernel")
        tol = K2_RTOL * ref.abs().max().item()
        simt_err = (k2_simt(*args) - ref).abs().max().item()
        ms = device_ms(lambda: crp_relation_matmul(*args))
        plain = device_ms(lambda: crp_relation_matmul_reference(*args))
        simt = device_ms(lambda: k2_simt(*args))
        lib = device_ms(lambda: torch.sigmoid(args[0]) @ args[1].unsqueeze(1))
        es = logits.element_size()
        b_ms, kind = bound_ms(
            BATCH * (R * Nv * M * es + M * Cc * es + R * Nv * Cc * 4),
            2 * BATCH * R * Nv * M * Cc,
            BF16_FLOPS if dtype == torch.bfloat16 else FP32_TC_FLOPS)
        log("k2", dtype=name, kernel=K2_PATH[name],
            shape=f"{BATCH}x{R}x({Nv},{M})@({M},{Cc})", max_abs_err=err,
            simt_err=simt_err, tol=f"{tol:.3e}", ms=f"{ms:.5f}",
            plain_ms=f"{plain:.5f}", simt_ms=f"{simt:.5f}",
            library_ms=f"{lib:.5f}", bound_ms=f"{b_ms:.5f}", bound_by=kind,
            bound_share=f"{b_ms / ms:.3f}")
        check(err <= tol, f"K2 {name} error {err} > {tol}")
        check(simt_err <= tol, f"K2 SIMT {name} error {simt_err} > {tol}")
        check(ms >= b_ms, f"K2 {name} took {ms} ms, under its bound {b_ms}")
        check(ms < simt, f"K2 {name} {ms} ms, not faster than the SIMT "
                         f"kernel {simt}")
        if dtype == torch.bfloat16:
            check(ms < plain, f"K2 bf16 {ms} ms, not faster than its plain "
                              f"version {plain}")
        res[name] = {"max_abs_err": err, "kernel": K2_PATH[name], "ms": ms,
                     "plain_ms": plain, "simt_ms": simt, "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": kind}
        del logits, mega, ref
    return res


def flagship_dw_shapes(dev, hw=(370, 1220),
                       backbone="tf_efficientnet_b3_ns") -> list:
    """(C, H, W, k) of every K4 conv of the encoder (the flagship's b3 by
    default) at batch 1 on an hw = (H, W) image (the flagship's by
    default), read from the model by forward hooks (in forward order)."""
    import torch

    from occdepth_tpu_torch.models.efficientnet import DWConv2d, EfficientNet

    enc = EfficientNet(backbone, dw_grad="pallas").to(dev)
    shapes = []
    for m in enc.modules():
        if isinstance(m, DWConv2d) and m.fast_grad:
            m.register_forward_hook(lambda mod, inp, out: shapes.append(
                (*inp[0].shape[1:], mod.kernel_size[0])))
    with torch.no_grad():
        enc(torch.zeros(1, 3, *hw, device=dev, dtype=torch.bfloat16))
    del enc
    return shapes


def phase_k4(dev) -> dict:
    """7. K4 vs its plain version at every flagship stride-1 dw shape, and
    its device times at the ten distinct ones: shapes, inputs and timing
    from scripts/bench_dwconv.py, the probe users run."""
    import torch

    from occdepth_tpu_torch.ops.dw_conv import K4_RTOL, dw_filter_grad
    from occdepth_tpu_torch.scripts import bench_dwconv

    rows = bench_dwconv.k4_shapes()
    shapes = [(C, H, W, k) for _, H, W, C, k, n in rows for _ in range(n)]
    hooked = flagship_dw_shapes(dev)
    check(hooked == shapes, f"the encoder's K4 shapes {hooked} are not "
          f"bench_dwconv's {shapes}")
    g = torch.Generator(device=dev).manual_seed(7)
    max_err = max_rel = 0.0
    for C, H, W, k in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x, _, gy = bench_dwconv.make_inputs(H, W, C, k, 1, dtype, g)
            # the plain version in fp32 on the same (bf16-rounded) inputs
            err, ref_max = bench_dwconv.check_shape(x, gy, k)
            tol = K4_RTOL * ref_max
            check(err <= tol, f"K4 {dtype} ({C},{H},{W},k{k}) error {err} > {tol}")
            max_err = max(max_err, err)
            max_rel = max(max_rel, err / ref_max)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kinds = set()
    for _, H, W, C, k, n in rows:  # times at the train path's dtype
        x, w, gy = bench_dwconv.make_inputs(H, W, C, k, 1, torch.bfloat16, g)
        r = bench_dwconv.time_shape(x, w, gy, 1, repeats=20)
        ms_single = cuda_ms(lambda: dw_filter_grad(x, gy, k, k))
        bound_kinds.add(r["bound_by"])
        log("k4", shape=f"(1,{C},{H},{W})", k=k, count=n, dtype="bfloat16",
            ms=f"{r['dw_pallas_ms']:.4f}", ms_single_call=f"{ms_single:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}", library_ms=f"{r['dw_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
            bound_share=f"{r['bound_share']:.3f}")
        # a time under the bound means the kernel skipped work
        check(r["dw_pallas_ms"] >= r["bound_ms"],
              f"K4 ({C},{H},{W},k{k}) {r['dw_pallas_ms']} ms under its "
              f"bound {r['bound_ms']}")
        tot["ms"] += r["dw_pallas_ms"] * n
        tot["plain_ms"] += r["plain_ms"] * n
        tot["library_ms"] += r["dw_ms"] * n
        tot["bound_ms"] += r["bound_ms"] * n
        del x, w, gy
    log("k4_total", convs=len(shapes), **{k: f"{v:.4f}" for k, v in tot.items()},
        bound_share=f"{tot['bound_ms'] / tot['ms']:.3f}",
        max_abs_err=max_err, max_rel_err=f"{max_rel:.3e}")
    return dict(tot, n_convs=len(shapes), max_abs_err=max_err,
                bound_share=tot["bound_ms"] / tot["ms"],
                bound_by="bytes" if bound_kinds == {"bytes"} else "operations")


def phase_autograd(dev, calib, hw) -> dict:
    """8. Gradients through K1, the fused lift and K2 on the card vs
    autograd of the plain versions, at the train path's shapes; the
    lift's backward kernel also vs its closed-form plain version, then
    alone at the flagship's train shape (`lift_backward_at_shape`)."""
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

    # the fused lift: gradients w.r.t. the four maps (fp32, batch 1), on the
    # flagship rig's projection as the train step passes it: its backward
    # kernel vs autograd of the plain lift and vs the plain backward
    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_stereo_lift,
        flosp_stereo_lift_backward,
        flosp_stereo_lift_backward_reference,
        flosp_stereo_lift_reference,
    )

    rig = [torch.from_numpy(calib[k][:1]).to(dev)
           for k in ("projected_pix", "fov_mask")]
    pix, fov = rig
    maps = [m.requires_grad_() for m in lift_maps(
        dev, torch.float32, "nchw", 1, C, hw, seed=8)]
    cot = torch.randn(1, pix.shape[2], C, device=dev, generator=g)
    args = (maps, pix, fov, LIFT_SCALES)
    launches = flosp_stereo_lift_backward.launches
    gk = grads(flosp_stereo_lift, maps, args, cot)
    check(flosp_stereo_lift_backward.launches == launches + 1,
          "the lift's gradient did not launch its backward kernel")
    gr = grads(flosp_stereo_lift_reference, maps, args, cot)
    err = max((a - b).abs().max().item() for a, b in zip(gk, gr))
    gp = flosp_stereo_lift_backward_reference(
        [m.detach() for m in maps], pix, fov, LIFT_SCALES, 1e-8, cot)
    err_plain = max((a - b).abs().max().item() for a, b in zip(gk, gp))
    log("lift_grad", shape=f"(1,{pix.shape[2]},{C}) 4 maps fp32",
        max_abs_err=err, max_abs_err_plain_backward=err_plain,
        tol=K1_GRAD_TOL)
    check(max(err, err_plain) <= K1_GRAD_TOL,
          f"fused lift gradient error {err}, vs the plain backward "
          f"{err_plain}")
    del maps, gk, gr, gp
    backward = lift_backward_at_shape(
        dev, rig, hw, C,
        [(dt, lay, pts) for pts in ("rig", "edges", "p4")
         for dt in (torch.bfloat16, torch.float32)
         for lay in ("nchw", "channels_last")],
        "kitti_lift", edge_seed=81, map_seed=82)

    # K2: (B=1, R, M, N) logits and (B=1, C, M) mega read transposed, the
    # four relations in one call, as the CRP passes them
    Nv, M, Cc = 4096, 512, 256
    for dtype, rtol in ((torch.float32, K2_GRAD_RTOL),
                        (torch.bfloat16, K2_GRAD_BF16_RTOL)):
        logits = torch.randn(1, K2_RELATIONS, M, Nv, device=dev,
                             generator=g).to(dtype)
        mega = torch.randn(1, Cc, M, device=dev, generator=g).to(dtype)
        logits.requires_grad_()
        mega.requires_grad_()
        cot = torch.randn(1, K2_RELATIONS, Nv, Cc, device=dev, generator=g)
        args = (logits.transpose(2, 3), mega.transpose(1, 2))
        gk = grads(crp_relation_matmul, [logits, mega], args, cot)
        gr = grads(crp_relation_matmul_reference, [logits, mega], args, cot)
        for name, a, b in zip(("dP", "dmega"), gk, gr):
            err = (a.float() - b.float()).abs().max().item()
            tol = rtol * b.float().abs().max().item()
            log("k2_grad", dtype=str(dtype).replace("torch.", ""), wrt=name,
                relations=K2_RELATIONS, max_abs_err=err, tol=f"{tol:.3e}")
            check(err <= tol, f"K2 {dtype} {name} gradient error {err} > {tol}")
    return backward


def phase_tiny_train(dev) -> dict:
    """9. One tiny-config train step on CUDA (kernels) vs the CPU."""
    import torch

    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_stereo_lift,
        flosp_stereo_lift_backward,
    )
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
    counted = (flosp_stereo_lift, crp_relation_matmul, dw_filter_grad,
               stereo_cosine_fuse, flosp_stereo_lift_backward)
    counts0 = [fn.launches for fn in counted]
    with PlainLiftCalls() as plain:
        cuda_runs = [step(m, dev) for m in gpu_models]
    launches = [fn.launches - c0 for fn, c0 in zip(counted, counts0)]
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
        lift_launches=launches[0], k2_launches=launches[1],
        k4_launches=launches[2], k1_launches=launches[3],
        lift_backward_launches=launches[4], plain_lift_on_cuda=plain.count)
    check(loss_err <= LOSS_RTOL, f"tiny train loss error {loss_err}")
    for name, w in worst.items():
        check(w[0] <= 1.0, f"tiny train {name}: {w}")
    check(flips <= FLIP_MULT * max(flips_noise, 1),
          f"tiny train update flips {flips} vs noise {flips_noise}")
    check(launches[0] == launches[1] == launches[4] == len(cuda_runs)
          and launches[2] > 0 and launches[3] == 0 and plain.count == 0,
          f"tiny train launches {launches} (lift, K2 and the lift's "
          "backward once per step, K4, standalone K1 never), plain lift on "
          f"CUDA {plain.count}")
    return {"loss_rel_err": loss_err}


def kernel_counters() -> dict:
    """name -> the wrapper whose `.launches` counts that kernel."""
    from occdepth_tpu_torch.ops.conv2d_shift import conv3x3
    from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_stereo_lift,
        flosp_stereo_lift_backward,
    )
    from occdepth_tpu_torch.ops.matmul_probe import matmul_probe
    from occdepth_tpu_torch.ops.row_gather import row_gather
    from occdepth_tpu_torch.ops.stereo_fuse import stereo_cosine_fuse

    return {"stereo_cosine_fuse": stereo_cosine_fuse,
            "flosp_stereo_lift": flosp_stereo_lift,
            "flosp_stereo_lift_backward": flosp_stereo_lift_backward,
            "crp_relation_matmul": crp_relation_matmul,
            "conv3x3": conv3x3, "dw_filter_grad": dw_filter_grad,
            "row_gather": row_gather, "matmul_probe": matmul_probe}


def reset_counts() -> None:
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad

    for fn in kernel_counters().values():
        fn.launches = 0
        for key in getattr(fn, "paths", {}):
            fn.paths[key] = 0
    dw_filter_grad.copies = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def read_paths() -> dict:
    """K2's and K3's launches by kernel: {"k2": {"wgmma_bf16": n,
    "wgmma_tf32": n, "simt": n}, "k3": {"wgmma_bf16": n, "wgmma_tf32":
    n}}."""
    from occdepth_tpu_torch.ops.conv2d_shift import conv3x3
    from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul

    return {"k2": dict(crp_relation_matmul.paths), "k3": dict(conv3x3.paths)}


def check_fp32_tensor_cores(tag: str, launches: dict) -> None:
    """After an fp32 run (counters set to 0 before it): every K2 and K3
    launch went to the 3xTF32 tensor-core kernels."""
    paths = read_paths()
    check(paths["k2"]["wgmma_tf32"] == launches["crp_relation_matmul"]
          and paths["k3"]["wgmma_tf32"] == launches["conv3x3"],
          f"{tag}: fp32 K2/K3 launches by path {paths}, of "
          f"{launches['crp_relation_matmul']}/{launches['conv3x3']}")


def fit_and_check(cfg, train_ds, val_ds, logdir, expected, tag,
                  smi: str, n_dw_expected: int = 22, steps: int = TRAIN_STEPS,
                  k4_views: int = 1, lift_k2: int = 1, trainer=None) -> dict:
    """A Trainer fits `steps` steps at batch 1 on two-sample train_ds,
    validating on val_ds at each epoch end (steps 2 and 3), with the launch
    counts set to 0 just before.  Checks: every `expected` loss term
    logged and finite, the parameters with a gradient all changed (all but
    at most 2 have one), K4 once per stride-1 depthwise conv of each of
    `k4_views` views per step (view 0 alone unless the views' backbone
    passes are all differentiated) with no operand copied, the fused lift
    and K2 `lift_k2` times per step and per validation forward (0 for one
    view without CRP), the lift's backward kernel `lift_k2` times per step
    and the plain lift (forward or backward) on no CUDA tensor, K1 and K3
    never, val/mIoU logged, the best-by-metric checkpoints kept.  Returns
    the trainer (`trainer`, or a new one on `logdir`), its launch counts,
    ms/step (CUDA events, mean of the steps after the first) and peak
    memory."""
    import torch

    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.training import Trainer

    trainer = trainer or Trainer(cfg, logdir)
    check(trainer.step == 0 and trainer.device.type == "cuda",
          f"{tag}: fresh trainer at step {trainer.step} on {trainer.device}")
    n_dw = sum(1 for m in trainer.model.modules()
               if getattr(m, "fast_grad", False))
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with PlainLiftCalls() as plain:
        trainer.fit(train_ds, val_ds, max_steps=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, copies = read_counts(), dw_filter_grad.copies
    peak = torch.cuda.max_memory_allocated()
    ms_step = statistics.mean(trainer.step_ms[1:])
    # the decoder's 1_16 head feeds no loss: zero gradient, and AdamW's
    # decay alone (lr * wd ~ 2e-8 relative) is below an fp32 ulp
    params = dict(trainer.model.named_parameters())
    trained = [n for n, p in params.items()
               if p.grad is not None and bool(p.grad.any())]
    changed = sum(int(not torch.equal(params[n].detach(), before[n]))
                  for n in trained)
    with open(trainer.metrics_logger.path) as f:
        records = [json.loads(line) for line in f]
    train_recs = [r for r in records if "train/loss" in r]
    val_steps = [r["step"] for r in records if "val/mIoU" in r]
    last = train_recs[-1] if train_recs else {}
    terms = sorted(k for k in last if k.startswith("train/loss"))
    log(tag, steps=trainer.step, wall_s=f"{wall_s:.2f}",
        step_ms=",".join(f"{t:.1f}" for t in trainer.step_ms),
        ms_per_step_2_3=f"{ms_step:.2f}", peak_mem_gib=f"{peak / 2**30:.3f}",
        gpu=repr(smi), dw_convs=n_dw,
        params_changed=f"{changed}/{len(trained)}/{len(before)}",
        val_steps=val_steps, k4_copies=copies, plain_lift_on_cuda=plain.count,
        best_val_mIoU=trainer.ckpt.best.get("val/mIoU"),
        **{f"{k}_launches": v for k, v in launches.items()},
        **{k.replace("train/", ""): f"{last[k]:.5f}" for k in terms})
    check(trainer.step == steps, f"{tag}: trainer at step {trainer.step}")
    check([r["step"] for r in train_recs] == list(range(1, steps + 1)),
          f"{tag}: metrics.jsonl train records "
          f"{[r['step'] for r in train_recs]}")
    check(expected <= set(terms), f"{tag}: loss terms {terms}")
    check(all(math.isfinite(r[k]) for r in train_recs for k in expected),
          f"{tag}: a loss term is not finite")
    check(changed == len(trained) >= len(before) - 2,
          f"{tag}: {changed}/{len(trained)} params with a gradient changed")
    check(n_dw == n_dw_expected, f"{tag}: {n_dw} stride-1 depthwise convs "
          f"(expected {n_dw_expected})")
    check(launches["dw_filter_grad"] == n_dw * k4_views * steps,
          f"{tag}: K4 launches {launches['dw_filter_grad']}")
    # the train path hands K4 contiguous NCHW x and g: no copies
    check(copies == 0, f"{tag}: K4 copied {copies} operands to NCHW")
    # 2 samples at batch 1: epochs end at step 2 and at max_steps
    check(val_steps == sorted({2, steps}), f"{tag}: val/mIoU records "
                                           f"{val_steps}")
    forwards = (steps + len(val_steps) * len(val_ds)) * lift_k2
    for name in ("flosp_stereo_lift", "crp_relation_matmul"):
        check(launches[name] == forwards,
              f"{tag}: {name} launches {launches[name]} for {forwards} "
              "forwards")
    check(launches["flosp_stereo_lift_backward"] == steps * lift_k2,
          f"{tag}: the lift's backward launches "
          f"{launches['flosp_stereo_lift_backward']} for {steps} steps")
    check(plain.count == 0,
          f"{tag}: the plain lift ran {plain.count} times on the card")
    check(launches["stereo_cosine_fuse"] == 0,
          f"{tag}: K1 launches {launches['stereo_cosine_fuse']}")
    check(launches["conv3x3"] == 0, f"{tag}: training ran K3")
    check(any("train/mIoU" in r for r in records),
          f"{tag}: no train/mIoU record")
    check(trainer.ckpt.has("best_val_mIoU")
          and trainer.ckpt.has("best_val_IoU"),
          f"{tag}: no best-by-metric checkpoint")
    return {"trainer": trainer, "launches": launches, "ms_per_step": ms_step,
            "peak_gib": peak / 2**30, "before": before}


def phase_train(dev, smi: str) -> dict:
    """10. The training path: the flagship Trainer fits 3 steps."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.testing import synthetic_dataset
    from occdepth_tpu_torch.training import Trainer

    cfg = load_config(default_config_path(FLAGSHIP), overrides={
        "compute_dtype": "bfloat16", "dw_conv_grad": "pallas",
        "log_every_n_steps": 1})
    t0 = time.perf_counter()
    train_ds = synthetic_dataset(cfg, 2, seed=0)
    val_ds = synthetic_dataset(cfg, 1, seed=1)
    log("train_data", seconds=f"{time.perf_counter() - t0:.2f}")
    logdir = tempfile.mkdtemp(prefix="occdepth_train_")
    try:
        fit = fit_and_check(cfg, train_ds, val_ds, logdir, {
            "train/loss", "train/loss_relation_ce_super", "train/loss_ssc",
            "train/loss_occ", "train/loss_depth", "train/loss_sem_scal",
            "train/loss_geo_scal", "train/loss_frustums"}, "train", smi)
        del fit["before"]
        final = {n: p.detach().clone()
                 for n, p in fit.pop("trainer").model.named_parameters()}
        resumed = Trainer(cfg, logdir)
        log("resume", step=resumed.step)
        check(resumed.step == TRAIN_STEPS, f"resumed at step {resumed.step}")
        for n, p in resumed.model.named_parameters():
            check(torch.equal(p.detach(), final[n]),
                  f"resumed {n} differs from the saved parameters")
        del resumed
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return fit


def flagship_k3_shapes(dev, hw=(370, 1220),
                       backbone="tf_efficientnet_b3_ns", feature=32) -> list:
    """(Ci, H, W, Co) of the decoder's ten 3x3 convs on an hw = (H, W)
    image (the flagship's b3 decoder of 32 channels on its image by
    default), read from the 2D UNet by forward hooks (in forward order)."""
    import torch

    from occdepth_tpu_torch.models.unet2d import Conv3x3Fast, UNet2D

    net = UNet2D(backbone, feature, 1).to(dev).eval()
    shapes = []
    for m in net.modules():
        if isinstance(m, Conv3x3Fast):
            m.register_forward_hook(lambda mod, inp, out: shapes.append(
                (*inp[0].shape[1:], mod.out_channels)))
    with torch.inference_mode():
        net(torch.zeros(1, 3, *hw, device=dev, dtype=torch.bfloat16))
    del net
    return shapes


def k3_at_shapes(dev, shapes, dtype, g, tag: str) -> dict:
    """K3 vs its plain version at the decoder's conv shapes (K3_BATCH
    images, NCHW inputs, so the wrapper's packing copies are timed): each
    within K3_RTOL, with device times (CUDA-graph replays) of K3, the plain
    version and cuDNN's conv, the bound, TFLOP/s and bound share; K3 must
    not read under its bound (a kernel that skipped work would).  Returns
    the sums over the shapes.  Both dtypes run on the tensor cores (fp32 as
    three TF32 products: its bound is at FP32_TC_FLOPS), checked by the
    per-path counter."""
    import torch
    import torch.nn.functional as F

    from occdepth_tpu_torch.ops.conv2d_shift import conv3x3, conv3x3_reference

    name = str(dtype).replace("torch.", "")
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_TC_FLOPS
    path = "wgmma_bf16" if dtype == torch.bfloat16 else "wgmma_tf32"
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0}
    kinds = set()
    for Ci, H, W, Co in shapes:
        x = torch.randn(K3_BATCH, Ci, H, W, device=dev,
                        generator=g).to(dtype)
        w = (torch.randn(Co, Ci, 3, 3, device=dev, generator=g)
             / (9 * Ci) ** 0.5).to(dtype)
        b = 0.1 * torch.randn(Co, device=dev, generator=g)
        # the plain version in fp32 on the same (bf16-rounded) inputs
        ref = conv3x3_reference(x.float(), w.float(), b)
        before = conv3x3.paths[path]
        out = conv3x3(x, w, b)
        torch.cuda.synchronize()
        check(conv3x3.paths[path] == before + 1,
              f"K3 {name} ({Ci},{H},{W})->{Co} launched no {path} kernel")
        scale = ref.abs().max().item()
        err = (out.float() - ref).abs().max().item()
        tol = K3_RTOL[name] * scale
        check(err <= tol, f"K3 {name} ({Ci},{H},{W})->{Co} error "
                          f"{err} > {tol}")
        del ref, out
        bl = b.to(dtype)
        ms = device_ms(lambda: conv3x3(x, w, b), calls=10)
        plain = device_ms(lambda: conv3x3_reference(x, w, b), calls=10)
        lib = device_ms(lambda: F.conv2d(x, w, bl, 1, 1), calls=10)
        n_bytes = ((x.numel() + w.numel() + K3_BATCH * Co * H * W)
                   * x.element_size() + Co * 4)
        flops = 2 * K3_BATCH * H * W * 9 * Ci * Co
        b_ms, kind = bound_ms(n_bytes, flops, peak)
        kinds.add(kind)
        log(tag, dtype=name, shape=f"({K3_BATCH},{Ci},{H},{W})->{Co}",
            max_abs_err=err, tol=f"{tol:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=kind,
            bound_share=f"{b_ms / ms:.3f}",
            tflops=f"{flops / ms / 1e9:.1f}")
        check(ms >= b_ms, f"K3 {name} ({Ci},{H},{W})->{Co} took {ms} ms, "
                          f"under its bound {b_ms}: work was skipped")
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bound_ms"] += b_ms
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["max_rel_err"] = max(tot["max_rel_err"], err / scale)
        del x, w
    tot["bound_by"] = "bytes" if kinds == {"bytes"} else "operations"
    tot["bound_share"] = tot["bound_ms"] / tot["ms"]
    log(f"{tag}_total", dtype=name, convs=len(shapes),
        **{k: (f"{v:.4f}" if isinstance(v, float) and "err" not in k
               else v) for k, v in tot.items()})
    return tot


def k3_beats_cudnn_fp32(tot: dict, where: str) -> None:
    """At 480x640 cuDNN's fp32 decoder convs (TF32 off) are K3's yardstick:
    the 3xTF32 kernel's sum over the ten must be the faster."""
    check(tot["ms"] < tot["library_ms"],
          f"{where} K3 fp32 over the ten convs {tot['ms']} ms, not faster "
          f"than cuDNN fp32 {tot['library_ms']}")


def phase_k3(dev) -> dict:
    """11. K3 vs its plain version at the flagship decoder's ten shapes."""
    import torch

    from occdepth_tpu_torch.ops.conv2d_shift import conv3x3, conv3x3_reference
    from occdepth_tpu_torch.scripts import bench_conv2d

    shapes = flagship_k3_shapes(dev)
    check(len(shapes) == 10, f"{len(shapes)} decoder 3x3 convs (expected 10)")
    g = torch.Generator(device=dev).manual_seed(11)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        tot = k3_at_shapes(dev, shapes, dtype, g, "k3")
        # bench_conv2d's shapes that the decoder lacks, on the bench's inputs
        gb = torch.Generator(device=dev).manual_seed(0)
        for shape in bench_conv2d.SHAPES:
            B, H, W, Ci, Co = shape
            x, w, b = bench_conv2d.make_inputs(shape, dtype, gb)
            if B == K3_BATCH and (Ci, H, W, Co) in shapes:
                continue
            ref = conv3x3_reference(x.float(), w.float(), b)
            err = (conv3x3(x, w, b).float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = K3_RTOL[name] * scale
            log("k3_bench_shape", dtype=name, shape=f"({B},{Ci},{H},{W})->{Co}",
                max_abs_err=err, tol=f"{tol:.3e}")
            check(err <= tol, f"K3 {name} bench_conv2d {shape} error "
                              f"{err} > {tol}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["max_rel_err"] = max(tot["max_rel_err"], err / scale)
            del x, w, ref
        res[name] = tot
    torch.cuda.empty_cache()
    return res


# tests/test_fullres_parity.py's KITTI_HEADS tolerances: logits 5e-3,
# depth_pred 1e-3 (absolute)
FULLRES_ATOL = {"ssc_logit": 5e-3, "occ_logit": 5e-3, "P_logits": 5e-3,
                "depth_pred": 1e-3}


def fullres_fp32_forward(dev, cfg) -> dict:
    """12b. The flagship's fp32 eval forward of one frame at full width
    (370x1220 stereo, 256x256x32, seeded random weights, one synthetic
    frame) under decoder_conv_impl=pallas: on the card (the fused lift,
    3xTF32 K2 once and K3 ten times) and on the host's CPU (the plain
    versions), each head within FULLRES_ATOL; seconds of each."""
    import torch

    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.testing import randomize_weights

    cfg = dataclasses.replace(cfg, decoder_conv_impl="pallas",
                              compute_dtype="float32")
    model = randomize_weights(OccDepthModel(cfg), seed=0).eval()
    batch = make_synthetic_batch(cfg, batch_size=1, seed=31)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out_cpu = model({k: torch.from_numpy(v) for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    model.to(dev)
    with torch.inference_mode():  # the first pass pays cuDNN's plans
        model({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out_gpu = model({k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()})
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    n = read_counts()
    check_fp32_tensor_cores("fullres fp32 forward", n)
    check(n["conv3x3"] == 10 and n["crp_relation_matmul"] == 1
          and n["flosp_stereo_lift"] == 1,
          f"fullres fp32 forward launches {n}")
    check(set(FULLRES_ATOL) <= set(out_cpu),
          f"fullres fp32 forward heads {sorted(out_cpu)}")
    errs = {k: (out_gpu[k].cpu() - out_cpu[k]).abs().max().item()
            for k in FULLRES_ATOL}
    log("fullres_fp32", heads=",".join(FULLRES_ATOL),
        **{f"{k}_err": v for k, v in errs.items()},
        **{f"{k}_scale": out_cpu[k].abs().max().item() for k in FULLRES_ATOL},
        cpu_s=f"{cpu_s:.1f}", gpu_s=f"{gpu_s:.3f}",
        cpu_threads=torch.get_num_threads())
    for k, err in errs.items():
        check(err <= FULLRES_ATOL[k], f"fullres fp32 {k}: card vs CPU "
                                      f"error {err} > {FULLRES_ATOL[k]}")
    del model, out_cpu, out_gpu
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "cpu_s": cpu_s, "gpu_s": gpu_s}


def phase_eval(dev, smi: str) -> dict:
    """12. The eval path on a synthetic disk tree, xla vs pallas."""
    import numpy as np
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts.eval import evaluate
    from occdepth_tpu_torch.testing import make_kitti_tree, randomize_weights

    base = tempfile.mkdtemp(prefix="occdepth_eval_")
    try:
        t0 = time.perf_counter()
        make_kitti_tree(base, n_frames=EVAL_FRAMES)
        tree_s = time.perf_counter() - t0
        paths = {"data_root": os.path.join(base, "kitti"),
                 "data_preprocess_root": os.path.join(base, "pre"),
                 "data_stereo_depth_root": os.path.join(base, "stereo_depth"),
                 "batch_size_per_gpu": EVAL_BATCH,
                 "logdir": os.path.join(base, "logdir")}
        cfg = load_config(default_config_path(FLAGSHIP), overrides=dict(
            paths, compute_dtype="float32"))
        ckpt = os.path.join(base, "ref.ckpt")
        sd = randomize_weights(OccDepthModel(cfg), seed=0).state_dict()
        torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}},
                   ckpt)
        del sd

        runs, launches = {}, {}
        for impl in ("xla", "pallas"):
            reset_counts()
            stats = evaluate(dataclasses.replace(cfg, decoder_conv_impl=impl),
                             torch_ckpt=ckpt)
            torch.cuda.synchronize()
            launches[impl] = read_counts()
            check_fp32_tensor_cores(f"eval fp32 {impl}", launches[impl])
            runs[impl] = stats
            log("eval_fp32", impl=impl, frames=stats["n_frames"],
                mIoU=f"{stats['iou_ssc_mean']:.6f}", IoU=f"{stats['iou']:.6f}",
                loss=f"{stats['losses']['loss']:.5f}",
                **{f"{k}_launches": v for k, v in launches[impl].items()})
        n_batches = -(-EVAL_FRAMES // EVAL_BATCH)
        counted = int(runs["pallas"]["conf"].sum())
        flips = int(np.abs(runs["pallas"]["conf"].astype(np.int64)
                           - runs["xla"]["conf"]).sum()) // 2
        log("eval_xla_vs_pallas", counted_voxels=counted, conf_diff=flips,
            bound=int(CONF_FLIP_FRAC * counted),
            completion_xla=runs["xla"]["completion"].tolist(),
            completion_pallas=runs["pallas"]["completion"].tolist())
        check(launches["pallas"]["conv3x3"] == 10 * n_batches,
              f"K3 launched {launches['pallas']['conv3x3']} times under pallas")
        check(launches["xla"]["conv3x3"] == 0, "K3 launched under xla")
        for impl, n in launches.items():
            check(n["flosp_stereo_lift"] == n["crp_relation_matmul"]
                  == n_batches and n["stereo_cosine_fuse"] == 0,
                  f"{impl}: lift/K2/K1 launches {n['flosp_stereo_lift']}/"
                  f"{n['crp_relation_matmul']}/{n['stereo_cosine_fuse']} for "
                  f"{n_batches} batches")
        for impl, st in runs.items():
            check(st["n_frames"] == EVAL_FRAMES,
                  f"{impl}: {st['n_frames']} frames counted")
            check(int(st["conf"].sum()) == EVAL_FRAMES
                  * math.prod(cfg.full_scene_size),
                  f"{impl}: {int(st['conf'].sum())} voxels counted")
            vals = [st["precision"], st["recall"], st["iou"],
                    st["iou_ssc_mean"], *st["iou_ssc"].tolist(),
                    *st["losses"].values()]
            check(all(math.isfinite(v) for v in vals),
                  f"{impl}: a stat is not finite")
        check(flips <= CONF_FLIP_FRAC * counted,
              f"pallas vs xla confusion differs in {flips} voxels")
        fullres = fullres_fp32_forward(dev, cfg)

        # bf16 eval device time, in turns, after one untimed bf16 pass of
        # each (the first pass of a path pays one-time costs, cuDNN plans
        # and kernel loading for layouts this process has not run yet)
        times = {"xla": [], "pallas": []}
        peaks = {"xla": [], "pallas": []}
        for impl in ("xla", "pallas"):
            evaluate(dataclasses.replace(
                cfg, decoder_conv_impl=impl, compute_dtype="bfloat16"),
                torch_ckpt=ckpt)
        for impl in ("xla", "pallas", "pallas", "xla"):
            torch.cuda.reset_peak_memory_stats()
            stats = evaluate(dataclasses.replace(
                cfg, decoder_conv_impl=impl, compute_dtype="bfloat16"),
                torch_ckpt=ckpt)
            times[impl].append(stats["ms_per_frame"])
            peaks[impl].append(torch.cuda.max_memory_allocated() / 2**30)
        log("eval_bf16", gpu=repr(smi),
            ms_per_frame_xla=",".join(f"{t:.2f}" for t in times["xla"]),
            ms_per_frame_pallas=",".join(f"{t:.2f}" for t in times["pallas"]),
            peak_gib_xla=f"{max(peaks['xla']):.3f}",
            peak_gib_pallas=f"{max(peaks['pallas']):.3f}")

        # the eval CLI, as a user runs it
        cmd = [sys.executable, "-m", "occdepth_tpu_torch.scripts.eval",
               "--config", default_config_path(FLAGSHIP), "--torch-ckpt", ckpt,
               "decoder_conv_impl=pallas", "compute_dtype=bfloat16",
               *(f"{k}={v}" for k, v in paths.items())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines:
            print(f"[eval_cli] {line}", flush=True)
        check(proc.returncode == 0,
              f"eval CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        check("test======" in lines and any(l.startswith("mIoU=")
                                             for l in lines),
              "the eval CLI printed no metric table")
        check("WARNING" not in proc.stdout, "the eval CLI missed keys")
        log("eval_cli", seconds=f"{cli_s:.1f}", tree_s=f"{tree_s:.1f}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return {"launches": launches["pallas"], "times": times, "peaks": peaks,
            "flips": flips, "counted": counted, "fullres": fullres}


def bits(t):
    """t's bits as integers, so NaN rows compare equal bit for bit."""
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def phase_k6(dev) -> dict:
    """13. K6 vs its plain version at bench_gather's five shapes."""
    import torch

    from occdepth_tpu_torch.ops.row_gather import row_gather, row_gather_reference
    from occdepth_tpu_torch.scripts.bench_gather import (
        N,
        SHAPES,
        in_turns,
        xla_take,
    )

    g = torch.Generator(device=dev).manual_seed(13)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "max_abs_err": 0.0}
        # a row that is not a multiple of 16 bytes (the element-wise path),
        # and indices below -R, negative and past the end (NaN rows)
        for R, Cc in ((1000, 33), (SHAPES[0][1], SHAPES[0][2])):
            table = torch.randn(R, Cc, device=dev, generator=g).to(dtype)
            idx = torch.randint(-2 * R, 2 * R, (4099,), device=dev,
                                generator=g, dtype=torch.int32)
            out = row_gather(table, idx)
            check(torch.equal(bits(out), bits(row_gather_reference(table, idx))),
                  f"K6 {name} ({R},{Cc}) with out-of-range indices differs")
        for shape, R, Cc in SHAPES:
            variants = [
                (torch.randn(R, Cc, device=dev, generator=g).to(dtype),
                 torch.randint(0, R, (N,), device=dev, generator=g,
                               dtype=torch.int32)) for _ in range(4)]
            table, idx = variants[0]
            out, ref = row_gather(table, idx), row_gather_reference(table, idx)
            torch.cuda.synchronize()
            check(torch.equal(bits(out), bits(ref)),
                  f"K6 {name} {shape} differs from its plain version")
            err = (out.float() - ref.float()).abs().max().item()
            ms = device_ms(in_turns(row_gather, variants))
            plain = device_ms(in_turns(row_gather_reference, variants))
            lib = device_ms(in_turns(xla_take, variants))
            # what this run's data needs: output, indices, each distinct
            # table row once
            rows = torch.unique(idx).numel()
            es = table.element_size()
            b_ms, kind = bound_ms(N * Cc * es + 4 * N + rows * Cc * es, 0,
                                  BF16_FLOPS)
            log("k6", dtype=name, shape=shape, table=f"({R},{Cc})",
                indices=N, distinct_rows=rows, max_abs_err=err,
                ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
                library_ms=f"{lib:.5f}", bound_ms=f"{b_ms:.5f}",
                bound_by=kind, bound_share=f"{b_ms / ms:.3f}")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", b_ms)):
                tot[k] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            del variants, table, idx, out, ref
        tot["bound_by"] = "bytes"
        log("k6_total", dtype=name, shapes=len(SHAPES),
            **{k: (f"{v:.5f}" if isinstance(v, float) and "err" not in k
                   else v) for k, v in tot.items()})
        res[name] = tot
    torch.cuda.empty_cache()
    return res


def phase_k5(dev) -> dict:
    """14. K5 vs its plain version at the three head probes."""
    import torch

    from occdepth_tpu_torch.ops.matmul_probe import (
        matmul_probe,
        matmul_probe_reference,
    )
    from occdepth_tpu_torch.scripts.bench_head_pallas import (
        PROBES,
        pallas_matmul_probe,
    )

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "max_rel_err": 0.0}
    kinds = set()
    for name, m, k, n, steps in PROBES:
        _, p, w = pallas_matmul_probe(m, k, n, steps, device=dev)
        out = matmul_probe(p, w, steps)
        ref = matmul_probe_reference(p, w, steps)
        torch.cuda.synchronize()
        scale = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        tol = K5_RTOL * scale
        check(err <= tol, f"K5 {name} error {err} > {tol}")
        del out, ref
        ms = device_ms(lambda: matmul_probe(p, w, steps), calls=10)
        plain = device_ms(lambda: matmul_probe_reference(p, w, steps),
                          calls=10)
        lib = device_ms(lambda: torch.matmul(p.expand(steps, m, k), w),
                        calls=10)
        b_ms, kind = bound_ms(2 * (m * k + k * n + steps * m * n),
                              2 * m * k * n * steps, BF16_FLOPS)
        kinds.add(kind)
        log("k5", probe=name, shape=f"({m},{k})@({k},{n})x{steps}",
            max_abs_err=err, tol=f"{tol:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=kind,
            bound_share=f"{b_ms / ms:.3f}",
            tflops=f"{2 * m * k * n * steps / ms / 1e9:.1f}")
        check(ms >= b_ms, f"K5 {name} took {ms} ms, under its bound {b_ms}: "
                          "the product was hoisted out of the step loop")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b_ms)):
            tot[key] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["max_rel_err"] = max(tot["max_rel_err"], err / scale)
        del p, w
    tot["bound_by"] = "bytes" if kinds == {"bytes"} else "operations"
    tot["bound_share"] = tot["bound_ms"] / tot["ms"]
    log("k5_total", probes=len(PROBES),
        **{k: (f"{v:.4f}" if isinstance(v, float) and "err" not in k else v)
           for k, v in tot.items()})
    torch.cuda.empty_cache()
    return tot


def run_probe(module: str, *args) -> list:
    """Run a probe script as a user does; its stdout lines."""
    cmd = [sys.executable, "-m", f"occdepth_tpu_torch.scripts.{module}",
           *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"[{module}] {line}", flush=True)
    check(proc.returncode == 0,
          f"{module} exited {proc.returncode}: {proc.stderr[-2000:]}")
    log("probe_script", script=module, seconds=f"{time.perf_counter() - t0:.1f}")
    return lines


def probe_launches(lines, name: str) -> int:
    """The launch count a probe script printed for kernel `name`."""
    found = [int(l.split("=")[1]) for l in lines
             if l.startswith(f"launches {name}=")]
    check(len(found) == 1, f"no launch count of {name} printed")
    return found[0]


def phase_probes() -> dict:
    """15. The four probe scripts as subprocesses: every candidate timed,
    their kernel launched."""
    import re

    from occdepth_tpu_torch.scripts.bench_conv2d import CANDIDATES
    from occdepth_tpu_torch.scripts.bench_conv2d import SHAPES as CONV_SHAPES
    from occdepth_tpu_torch.scripts.bench_dwconv import (
        B3_DW_SHAPES as DW_SHAPES,
    )
    from occdepth_tpu_torch.scripts.bench_gather import SHAPES, candidates
    from occdepth_tpu_torch.scripts.bench_head_pallas import PROBES

    launches = {}

    def times(lines, pattern):
        return [float(m.group(1)) for m in map(re.compile(pattern).search,
                                                lines) if m]

    lines = run_probe("bench_gather", "--repeats", "4")
    want = sum(len(candidates(rows)) for _, rows, _ in SHAPES)
    got = times(lines, r"^\s+\w+\s+([0-9.]+) ms/gather")
    check(len(got) == want and all(0 < t < math.inf for t in got),
          f"bench_gather printed {len(got)} of {want} candidate times")
    launches["row_gather"] = probe_launches(lines, "row_gather")

    lines = run_probe("bench_head_pallas", "--repeats", "2", "--json")
    res = json.loads(lines[-1])
    keys = ([f"xla_conv_d{d}_ms" for d in (1, 2, 3)] + ["xla_head_eval_ms"]
            + [f"pallas_{name}_ms" for name, *_ in PROBES])
    check(all(0 < res.get(k, 0) < math.inf for k in keys),
          f"bench_head_pallas --json lacks a time: {res}")
    check(res["launches"]["matmul_probe"]
          == probe_launches(lines, "matmul_probe"), "two K5 launch counts")
    launches["matmul_probe"] = res["launches"]["matmul_probe"]

    lines = run_probe("bench_dwconv", "--repeats", "2")
    rows = [l.split() for l in lines if re.match(r"^s\d+b\d+ k\d s\d ", l)]
    want = [(name, s) for name, *_, s in DW_SHAPES]
    check([(" ".join(r[:3]), int(r[2][1:])) for r in rows] == want,
          f"bench_dwconv printed rows {[r[:3] for r in rows]}")
    for r in rows:  # fwd, dx, dw everywhere; K4, plain, bound at stride 1
        vals = [float(v) for v in r[3:9]]
        n_timed = 6 if r[2] == "s1" else 3
        check(all(0 < v < math.inf for v in vals[:n_timed]),
              f"bench_dwconv row {r}")
    launches["dw_filter_grad"] = probe_launches(lines, "dw_filter_grad")

    lines = run_probe("bench_conv2d", "--repeats", "2")
    got = times(lines, r"\)\s+\w+\s+([0-9.]+) ms\s+\[")  # not `bound`
    want = len(CONV_SHAPES) * len(CANDIDATES)
    check(len(got) == want and all(0 < t < math.inf for t in got),
          f"bench_conv2d printed {len(got)} of {want} candidate times")
    launches["conv3x3"] = probe_launches(lines, "conv3x3")

    log("probes", **{f"{k}_launches": v for k, v in launches.items()},
        head=json.dumps(res).replace(" ", ""))
    check(min(launches.values()) > 0, f"a probe launched no kernel: {launches}")
    return {"launches": launches, "head": res}


def ta_paths(base: str, run: str) -> dict:
    """Overrides that point a config at the tree under `base`, with the
    run's own logdir."""
    return {"data_root": os.path.join(base, "ta"),
            "data_preprocess_root": os.path.join(base, "ta_pre"),
            "logdir": os.path.join(base, run)}


def k2_simt(p_logit, mega):
    """K2's SIMT kernel on (B, R, N, M) logits and (B, M, C) mega as they
    are: the route bf16 took at TartanAir's M = 1,350 before the wrapper
    padded mega for the wgmma kernel (timed beside it)."""
    import torch

    from occdepth_tpu_torch.ops import cuda_lib
    from occdepth_tpu_torch.ops.crp_matmul import _DTYPE_CODE, _sane_strides

    B, R, N, M = p_logit.shape
    C = mega.shape[-1]
    out = torch.empty((B, R, C, N), dtype=torch.float32,
                      device=p_logit.device).transpose(2, 3)
    rc = cuda_lib.library().occ_crp_relation_matmul(
        p_logit.data_ptr(), mega.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[p_logit.dtype], 0, B, R, N, M, C,
        *_sane_strides(p_logit), *_sane_strides(mega), *out.stride(),
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "crp_relation_matmul (SIMT)")
    return out


def lift_at_shape(dev, rig, hw, C, cases, tag, edge_seed, map_seed) -> dict:
    """The fused lift at batch 1 into the rig's N voxels from the four
    scales of an hw image at C channels, vs its plain version in each
    (dtype, layout, points) case of `cases` (points "rig": the tree's
    projection, "edges": `lift_points`' edge cases); then its device
    times on the rig with bf16 NCHW maps (the kernel, the plain version,
    the per-scale path), the bytes bound, and the train step's forward +
    backward (CUDA events); then its backward kernel in the same cases
    (`lift_backward_at_shape`)."""
    import torch

    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_stereo_lift,
        flosp_stereo_lift_reference,
    )
    from occdepth_tpu_torch.testing import lift_points

    N = rig[0].shape[2]
    edges = [torch.from_numpy(a).to(dev) for a in
             lift_points(np.random.RandomState(edge_seed), 1, N, 1, hw)]
    max_err = 0.0
    for i, (dtype, layout, name) in enumerate(cases):
        pix, fov = rig if name == "rig" else edges
        maps = lift_maps(dev, dtype, layout, 1, C, hw, seed=map_seed + i)
        out = flosp_stereo_lift(maps, pix, fov, LIFT_SCALES)
        ref = flosp_stereo_lift_reference(maps, pix, fov, LIFT_SCALES)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log(f"{tag}_check", points=name, layout=layout, C=C,
            dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
            tol=LIFT_TOL)
        check(err <= LIFT_TOL, f"{tag} {name} {dtype} {layout} C={C} "
                               f"error {err} > {LIFT_TOL}")
        max_err = max(max_err, err)
        del maps, out, ref
    pix, fov = rig
    maps = lift_maps(dev, torch.bfloat16, "nchw", 1, C, hw, seed=map_seed + 9)
    lift = {"max_abs_err": max_err, "fov_share": fov.all(dim=1).float()
            .mean().item()}
    lift["ms"] = device_ms(
        lambda: flosp_stereo_lift(maps, pix, fov, LIFT_SCALES))
    lift["plain_ms"] = device_ms(
        lambda: flosp_stereo_lift_reference(maps, pix, fov, LIFT_SCALES))
    lift["yardstick_ms"] = device_ms(
        lambda: per_scale_lift(maps, pix, fov, LIFT_SCALES))
    lift["bound_ms"], lift["bound_by"] = bound_ms(
        lift_bytes(maps, pix, fov, LIFT_SCALES), 0, FP32_FLOPS)
    # the train step's lift: forward, then its backward kernel
    leaves = [m.detach().requires_grad_() for m in maps]
    cot = torch.randn(1, N, C, device=dev)
    lift["fwd_ms_events"] = cuda_ms(
        lambda: flosp_stereo_lift(leaves, pix, fov, LIFT_SCALES), iters=5)
    lift["fwd_bwd_ms_events"] = cuda_ms(lambda: torch.autograd.grad(
        flosp_stereo_lift(leaves, pix, fov, LIFT_SCALES), leaves, cot),
        iters=5)
    log(tag, shape=f"(1,{N},P1,{C}) bf16 NCHW, rig projection",
        **{k: (f"{v:.5f}" if isinstance(v, float) else v)
           for k, v in lift.items()},
        bound_share=f"{lift['bound_ms'] / lift['ms']:.3f}")
    check(lift["ms"] >= lift["bound_ms"],
          f"{tag} C={C} {lift['ms']} ms under its bound")
    check(lift["fov_share"] > 0.5, f"{tag}: the tree's rig sees too little")
    del maps, leaves
    lift["backward"] = lift_backward_at_shape(
        dev, rig, hw, C, cases, tag, edge_seed, map_seed + 10)
    return lift


def k2_at_shape(dev, N, M, C, padded, tag, seed) -> dict:
    """K2 at batch 1, (1, R, N, M) @ (1, M, C) in the CRP's layout, vs its
    plain version on the tensor cores in bf16 (wgmma) and fp32 (3xTF32
    wgmma; per-path counters), with the padded copies `padded` names for
    each dtype ("logits", "mega"); device times of the kernel, the plain
    version, the SIMT kernel (the route before the padding, and fp32's
    before the 3xTF32 kernel) and torch.sigmoid + torch.matmul; the
    tensor-core kernel must beat the SIMT one."""
    import torch

    from occdepth_tpu_torch.ops.crp_matmul import (
        crp_relation_matmul,
        crp_relation_matmul_reference,
        tma_reads,
        wgmma_path,
    )

    R = K2_RELATIONS
    g = torch.Generator(device=dev).manual_seed(seed)
    k2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        logits = torch.randn(1, R, M, N, device=dev, generator=g).to(dtype)
        mega = torch.randn(1, C, M, device=dev, generator=g).to(dtype)
        args = (logits.transpose(2, 3), mega.transpose(1, 2))
        check(wgmma_path(*args), f"{tag} {name} did not take a tensor-core "
                                 "kernel")
        pads = {"logits": not tma_reads(args[0], 2),
                "mega": not tma_reads(args[1], 1)}
        check({k for k, v in pads.items() if v} == set(padded[name]),
              f"{tag} {name}: padded copies {pads}, expected "
              f"{padded[name]}")
        ref = crp_relation_matmul_reference(*args)
        tol = K2_RTOL * ref.abs().max().item()
        before = crp_relation_matmul.paths[K2_PATH[name]]
        err = (crp_relation_matmul(*args) - ref).abs().max().item()
        check(crp_relation_matmul.paths[K2_PATH[name]] == before + 1,
              f"{tag} {name} launched no {K2_PATH[name]} kernel")
        simt_err = (k2_simt(*args) - ref).abs().max().item()
        check(simt_err <= tol, f"{tag} SIMT {name} error {simt_err} > {tol}")
        r = {"max_abs_err": err, "kernel": K2_PATH[name],
             "ms": device_ms(lambda: crp_relation_matmul(*args)),
             "plain_ms": device_ms(
                 lambda: crp_relation_matmul_reference(*args)),
             "simt_ms": device_ms(lambda: k2_simt(*args)),
             "library_ms": device_ms(
                 lambda: torch.sigmoid(args[0]) @ args[1].unsqueeze(1))}
        es = logits.element_size()
        r["bound_ms"], r["bound_by"] = bound_ms(
            R * N * M * es + M * C * es + R * N * C * 4,
            2 * R * N * M * C,
            BF16_FLOPS if dtype == torch.bfloat16 else FP32_TC_FLOPS)
        log(tag, dtype=name, shape=f"1x{R}x({N},{M})@({M},{C})",
            padded=",".join(padded[name]) or "none",
            tol=f"{tol:.3e}", **{k: (f"{v:.5f}" if isinstance(v, float)
                                     and k != "max_abs_err" else v)
                                 for k, v in r.items()},
            bound_share=f"{r['bound_ms'] / r['ms']:.3f}")
        check(err <= tol, f"{tag} {name} error {err} > {tol}")
        check(r["ms"] >= r["bound_ms"],
              f"{tag} {name} {r['ms']} ms under its bound")
        check(r["ms"] < r["simt_ms"], f"{tag} {name} {r['ms']} ms, not "
                                      f"faster than the SIMT kernel "
                                      f"{r['simt_ms']}")
        k2[name] = r
        del logits, mega, ref
    return k2


def k4_at_shapes(dev, shapes, tag, seed) -> dict:
    """K4 vs its plain version at an encoder's stride-1 depthwise convs
    (batch 1, bf16 and fp32), and the device times (bench_dwconv's timing)
    of K4, the plain version and cuDNN's weight gradient at each distinct
    shape in bf16, weighted by its count; sums over the convs."""
    import torch

    from occdepth_tpu_torch.ops.dw_conv import K4_RTOL
    from occdepth_tpu_torch.scripts import bench_dwconv

    gk = torch.Generator(device=dev).manual_seed(seed)
    max_err = max_rel = 0.0
    for C4, H, W, k in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x, _, gy = bench_dwconv.make_inputs(H, W, C4, k, 1, dtype, gk)
            err, ref_max = bench_dwconv.check_shape(x, gy, k)
            check(err <= K4_RTOL * ref_max, f"{tag} {dtype} ({C4},{H},{W},"
                  f"k{k}) error {err} > {K4_RTOL * ref_max}")
            max_err, max_rel = max(max_err, err), max(max_rel, err / ref_max)
    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    kinds = set()
    for (C4, H, W, k), n in counts.items():
        x, w, gy = bench_dwconv.make_inputs(H, W, C4, k, 1, torch.bfloat16,
                                            gk)
        r = bench_dwconv.time_shape(x, w, gy, 1, repeats=20)
        kinds.add(r["bound_by"])
        log(tag, shape=f"(1,{C4},{H},{W})", k=k, count=n,
            ms=f"{r['dw_pallas_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['dw_ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
            bound_share=f"{r['bound_share']:.3f}")
        check(r["dw_pallas_ms"] >= r["bound_ms"],
              f"{tag} ({C4},{H},{W},k{k}) under its bound")
        for key, v in (("ms", r["dw_pallas_ms"]), ("plain_ms", r["plain_ms"]),
                       ("library_ms", r["dw_ms"]),
                       ("bound_ms", r["bound_ms"])):
            tot[key] += v * n
        del x, w, gy
    tot.update(max_abs_err=max_err, max_rel_err=max_rel, n_convs=len(shapes),
               bound_by="bytes" if kinds == {"bytes"} else "operations",
               bound_share=tot["bound_ms"] / tot["ms"])
    log(f"{tag}_total", **{k: (f"{v:.4f}" if isinstance(v, float)
                               and "err" not in k else v)
                           for k, v in tot.items()})
    return tot


def phase_ta_kernels(dev, sample) -> dict:
    """16. K1+, K2, K4 and K3 at TartanAir's shapes vs their plain
    versions: the fused lift on a 480x640 image's four scales into 691,200
    voxels (batch 1, the full-size tree's rig and edge-case points), K2 at
    the 30x12x30 bottleneck ((1, 4, 10,800, 1,350) @ (1, 1,350, 256)), K4
    at the b3 encoder's stride-1 depthwise convs on a 480x640 image, K3 at
    the decoder's ten 3x3 convs on a 480x640 frame (2 images)."""
    import torch

    N = math.prod(TA_GRID)
    rig = [torch.from_numpy(sample[k][None]).to(dev)
           for k in ("projected_pix", "fov_mask")]
    check(tuple(rig[0].shape) == (1, 2, N, 1, 2),
          f"TartanAir projection {tuple(rig[0].shape)}")
    res = {"lift": lift_at_shape(
        dev, rig, TA_HW, 32, ((torch.bfloat16, "nchw", "rig"),
                              (torch.float32, "nchw", "rig"),
                              (torch.bfloat16, "channels_last", "edges"),
                              (torch.float32, "nchw", "edges")),
        "ta_lift", edge_seed=16, map_seed=20)}
    # K2 at M = 1,350: bf16 on wgmma (mega padded), fp32 on SIMT
    res["k2"] = k2_at_shape(dev, N // 64, 1350, 256,
                            {"bfloat16": ("mega",), "float32": ("mega",)},
                            "ta_k2", seed=17)
    shapes = flagship_dw_shapes(dev, TA_HW)
    check(len(shapes) == 22, f"{len(shapes)} stride-1 dw convs at 480x640")
    res["k4"] = k4_at_shapes(dev, shapes, "ta_k4", seed=18)
    shapes = flagship_k3_shapes(dev, TA_HW)
    check(len(shapes) == 10, f"{len(shapes)} decoder 3x3 convs at 480x640")
    g3 = torch.Generator(device=dev).manual_seed(19)
    res["k3"] = {str(dt).replace("torch.", ""): k3_at_shapes(
        dev, shapes, dt, g3, "ta_k3") for dt in (torch.bfloat16,
                                                 torch.float32)}
    k3_beats_cudnn_fp32(res["k3"]["float32"], "TartanAir")
    torch.cuda.empty_cache()
    return res


def run_cli(module: str, args: list, tag: str) -> list:
    """A port CLI as a subprocess, as a user runs it; its stdout lines."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"occdepth_tpu_torch.scripts.{module}",
         *args], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"[{tag}] {line}", flush=True)
    check(proc.returncode == 0,
          f"{tag} exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(tag, seconds=f"{time.perf_counter() - t0:.1f}")
    return lines


def phase_ta_train(dev, smi: str, base: str) -> dict:
    """17. TartanAir training: the shipped config (b3, feature 32, 480x640
    stereo, 120x48x120, 14 classes) in bf16 with dw_conv_grad=pallas on
    the full-size tree fits 3 steps at batch 1 and validates at each epoch
    end; then the train CLI for 2 steps, and again to resume."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.training.trainer import make_datasets

    overrides = dict(ta_paths(base, "train"), compute_dtype="bfloat16",
                     dw_conv_grad="pallas",
                     log_every_n_steps=1)
    cfg = load_config(default_config_path(TA_CONFIG), overrides=overrides)
    train_ds, val_ds = make_datasets(cfg)
    check(len(train_ds) == len(val_ds) == TA_FRAMES,
          f"TartanAir tree: {len(train_ds)} train, {len(val_ds)} val")
    expected = {"train/loss", "train/loss_relation_ce_super",
                "train/loss_ssc", "train/loss_occ", "train/loss_sem_scal",
                "train/loss_geo_scal", "train/loss_frustums"}
    fit = fit_and_check(cfg, train_ds, val_ds, os.path.join(base, "fit"),
                        expected, "ta_train", smi)
    del fit["trainer"], fit["before"]
    torch.cuda.empty_cache()

    # the train CLI, as a user runs it: 2 steps, then a rerun resumes
    args = ["--config", default_config_path(TA_CONFIG),
            *(f"{k}={v}" for k, v in overrides.items())]
    lines = run_cli("train", args + ["--max-steps", "2"], "ta_train_cli")
    check("train: steps 0 -> 2" in " ".join(lines),
          "the train CLI did not take 2 steps")
    lines = run_cli("train", args + ["--max-steps", "3"],
                    "ta_train_cli_resume")
    check("resumed from step 2" in lines
          and "train: steps 2 -> 3" in " ".join(lines),
          "the train CLI did not resume at step 2")
    return fit


def phase_ta_eval(dev, smi: str, base: str) -> dict:
    """18. TartanAir evaluation on the full-size tree's 2 val frames at the
    shipped batch 1: fp32 (TF32 off) under decoder_conv_impl=xla and
    =pallas, bf16 ms/frame of both in turns, and the eval CLI."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.params import TARTANAIR_CLASS_NAMES
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts.eval import evaluate
    from occdepth_tpu_torch.testing import randomize_weights

    paths = ta_paths(base, "eval")
    cfg = load_config(default_config_path(TA_CONFIG),
                      overrides=dict(paths, compute_dtype="float32"))
    ckpt = os.path.join(base, "ta_ref.ckpt")
    sd = randomize_weights(OccDepthModel(cfg), seed=0).state_dict()
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}},
               ckpt)
    del sd
    runs, launches = {}, {}
    for impl in ("xla", "pallas"):
        reset_counts()
        runs[impl] = evaluate(dataclasses.replace(cfg, decoder_conv_impl=impl),
                              torch_ckpt=ckpt)
        torch.cuda.synchronize()
        launches[impl] = read_counts()
        check_fp32_tensor_cores(f"ta_eval_fp32 {impl}", launches[impl])
        log("ta_eval_fp32", impl=impl, frames=runs[impl]["n_frames"],
            mIoU=f"{runs[impl]['iou_ssc_mean']:.6f}",
            loss=f"{runs[impl]['losses']['loss']:.5f}",
            **{f"{k}_launches": v for k, v in launches[impl].items()})
    n_batches = TA_FRAMES  # batch 1
    counted = int(runs["pallas"]["conf"].sum())
    flips = int(np.abs(runs["pallas"]["conf"].astype(np.int64)
                       - runs["xla"]["conf"]).sum()) // 2
    log("ta_eval_xla_vs_pallas", counted_voxels=counted, conf_diff=flips,
        bound=int(CONF_FLIP_FRAC * counted))
    check(launches["pallas"]["conv3x3"] == 10 * n_batches,
          f"TartanAir: K3 launched {launches['pallas']['conv3x3']} times "
          "under pallas")
    check(launches["xla"]["conv3x3"] == 0, "TartanAir: K3 launched under xla")
    for impl, n in launches.items():
        check(n["flosp_stereo_lift"] == n["crp_relation_matmul"] == n_batches
              and n["stereo_cosine_fuse"] == 0,
              f"TartanAir {impl}: lift/K2/K1 launches {n}")
    for impl, st in runs.items():
        n_vox = int(st["conf"].sum())
        check(st["n_frames"] == TA_FRAMES
              and n_vox == TA_FRAMES * math.prod(cfg.full_scene_size),
              f"TartanAir {impl}: {st['n_frames']} frames, {n_vox} voxels")
        check(all(math.isfinite(v) for v in [
            st["precision"], st["recall"], st["iou"], st["iou_ssc_mean"],
            *st["iou_ssc"].tolist(), *st["losses"].values()]),
            f"TartanAir {impl}: a stat is not finite")
    check(flips <= CONF_FLIP_FRAC * counted,
          f"TartanAir pallas vs xla confusion differs in {flips} voxels")

    times, peaks = {"xla": [], "pallas": []}, {"xla": [], "pallas": []}
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    for impl in ("xla", "pallas"):  # one untimed pass of each
        evaluate(dataclasses.replace(bf16, decoder_conv_impl=impl),
                 torch_ckpt=ckpt)
    for impl in ("xla", "pallas", "pallas", "xla"):
        torch.cuda.reset_peak_memory_stats()
        st = evaluate(dataclasses.replace(bf16, decoder_conv_impl=impl),
                      torch_ckpt=ckpt)
        times[impl].append(st["ms_per_frame"])
        peaks[impl].append(torch.cuda.max_memory_allocated() / 2**30)
    log("ta_eval_bf16", gpu=repr(smi),
        ms_per_frame_xla=",".join(f"{t:.2f}" for t in times["xla"]),
        ms_per_frame_pallas=",".join(f"{t:.2f}" for t in times["pallas"]),
        peak_gib_xla=f"{max(peaks['xla']):.3f}",
        peak_gib_pallas=f"{max(peaks['pallas']):.3f}")

    lines = run_cli("eval", [
        "--config", default_config_path(TA_CONFIG), "--torch-ckpt", ckpt,
        "decoder_conv_impl=pallas", "compute_dtype=bfloat16",
        *(f"{k}={v}" for k, v in paths.items())], "ta_eval_cli")
    check("test======" in lines
          and f"class IoU: {TARTANAIR_CLASS_NAMES}, " in lines
          and any(line.startswith("mIoU=") for line in lines),
          "the eval CLI printed no 14-class TartanAir table")
    check("WARNING" not in " ".join(lines), "the eval CLI missed keys")
    return {"launches": launches["pallas"], "times": times, "peaks": peaks,
            "flips": flips, "counted": counted}


def phase_occluded(dev, smi: str) -> dict:
    """19. The shipped occluded-head KITTI config at full width in bf16
    (dw_conv_grad=pallas): 3 train steps at batch 1 on a labelled
    synthetic dataset with occluded labels, validating at each epoch end;
    loss_occluded finite and the occluded head trained; an eval forward
    returns occluded_logit on the full grid."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.testing import synthetic_dataset

    cfg = load_config(default_config_path(OCCLUDED), overrides={
        "compute_dtype": "bfloat16", "dw_conv_grad": "pallas",
        "log_every_n_steps": 1})
    check(cfg.occluded_cls, "the occluded config has no occluded head")
    train_ds = synthetic_dataset(cfg, 2, seed=0)
    val_ds = synthetic_dataset(cfg, 1, seed=1)
    check("occluded" in train_ds[0], "no occluded labels in the batch")
    logdir = tempfile.mkdtemp(prefix="occdepth_occluded_")
    try:
        expected = {"train/loss", "train/loss_occluded", "train/loss_ssc",
                    "train/loss_occ", "train/loss_depth",
                    "train/loss_relation_ce_super", "train/loss_frustums"}
        fit = fit_and_check(cfg, train_ds, val_ds, logdir, expected,
                            "occluded_train", smi)
        model, before = fit.pop("trainer").model.eval(), fit.pop("before")
        head = {n: p for n, p in model.named_parameters()
                if n.startswith("net_3d_decoder.occluded_head.")}
        moved = sum(int(not torch.equal(p.detach(), before[n]))
                    for n, p in head.items())
        batch = {k: torch.from_numpy(np.asarray(v)[None]).to(dev)
                 for k, v in val_ds[0].items()}
        with torch.inference_mode():
            out = model(batch)
        occl = out["occluded_logit"]
        log("occluded_eval", occluded_head_params_changed=f"{moved}/"
            f"{len(head)}", occluded_logit=tuple(occl.shape),
            dtype=str(occl.dtype), finite=bool(torch.isfinite(occl).all()))
        check(len(head) > 0 and moved == len(head),
              f"{moved}/{len(head)} occluded_head parameters changed")
        check(tuple(occl.shape) == (1, *cfg.full_scene_size, 2)
              and occl.dtype == torch.float32
              and bool(torch.isfinite(occl).all()),
              f"occluded_logit {tuple(occl.shape)} {occl.dtype}")
        del model, out
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return fit


def nyu_overrides(base: str, run: str, **kw) -> dict:
    """Overrides that point an NYU config at the tree under `base`, with
    the run's own logdir."""
    return dict(data_root=base, data_preprocess_root=base,
                logdir=os.path.join(base, run), **kw)


def phase_nyu_kernels(dev, sample) -> dict:
    """20. K1+, K2, K4 and K3 at NYU's shapes vs their plain versions: the
    fused lift of the real and the virtual view into 129,600 voxels
    (batch 1, the full-size tree's projection and edge-case points) from a
    480x640 image's four scales at b4's C = 100 (bf16 rows of 200 bytes:
    the kernel's one-element-a-lane form) and b7's C = 200, in bf16 and
    fp32, NCHW and channels-last; K2 at the 15x9x15 bottleneck, (1, 4,
    2,025, 196) @ (1, 196, 800) and b7's C = 1,600, bf16 on wgmma (logits
    and mega padded) beside the SIMT kernel and sigmoid + matmul, fp32 on
    SIMT; K4 at the b4 and the b7 encoder's stride-1 depthwise convs on a
    480x640 image; K3 at the b4 decoder's ten 3x3 convs (100 channels
    out)."""
    import torch

    N = math.prod(NYU_GRID)
    rig = [torch.from_numpy(sample[k][None]).to(dev)
           for k in ("projected_pix", "fov_mask")]
    check(tuple(rig[0].shape) == (1, 2, N, 1, 2),
          f"NYU projection {tuple(rig[0].shape)}")
    cases = tuple((dt, layout, points) for points in ("rig", "edges")
                  for layout in ("nchw", "channels_last")
                  for dt in (torch.bfloat16, torch.float32))
    res = {"lift": lift_at_shape(dev, rig, NYU_HW, 100, cases, "nyu_lift",
                                 edge_seed=20, map_seed=40),
           "lift_b7": lift_at_shape(dev, rig, NYU_HW, 200, cases,
                                    "nyu_lift_b7", edge_seed=21,
                                    map_seed=60)}
    n_crp, m_crp = 15 * 9 * 15, 7 * 4 * 7
    pads = {"bfloat16": ("logits", "mega"), "float32": ("logits",)}
    res["k2"] = k2_at_shape(dev, n_crp, m_crp, 800, pads, "nyu_k2", seed=22)
    res["k2_b7"] = k2_at_shape(dev, n_crp, m_crp, 1600, pads, "nyu_k2_b7",
                               seed=23)
    for key, backbone, seed in (("k4", "tf_efficientnet_b4_ns", 24),
                                ("k4_b7", "tf_efficientnet_b7_ns", 26)):
        shapes = flagship_dw_shapes(dev, NYU_HW, backbone)
        res[key] = k4_at_shapes(dev, shapes, f"nyu_{key}", seed=seed)
    shapes = flagship_k3_shapes(dev, NYU_HW, "tf_efficientnet_b4_ns", 100)
    check(len(shapes) == 10, f"{len(shapes)} b4 decoder 3x3 convs")
    g3 = torch.Generator(device=dev).manual_seed(25)
    res["k3"] = {str(dt).replace("torch.", ""): k3_at_shapes(
        dev, shapes, dt, g3, "nyu_k3") for dt in (torch.bfloat16,
                                                  torch.float32)}
    k3_beats_cudnn_fp32(res["k3"]["float32"], "NYU")
    torch.cuda.empty_cache()
    return res


def phase_nyu_train(dev, smi: str, base: str, n_dw: int,
                    n_dw7: int) -> dict:
    """21. NYU training: the shipped b4 config (feature 100, 480x640
    RGB-D, 60x36x60, 12 classes) in bf16 with dw_conv_grad=pallas on the
    full-size tree fits 3 steps at batch 1 and validates on the test split
    at each epoch end; the train CLI for 2 steps, and again to resume;
    then the b7 config (feature 200) at full width: two train steps and
    one eval forward, K4 once per stride-1 depthwise conv of b7 (n_dw7, as
    phase 20 held them) per step with no copies."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.training import Trainer
    from occdepth_tpu_torch.training.step import eval_step, train_step
    from occdepth_tpu_torch.training.trainer import make_datasets

    overrides = nyu_overrides(base, "train", compute_dtype="bfloat16",
                              dw_conv_grad="pallas", log_every_n_steps=1)
    cfg = load_config(default_config_path(NYU_B4), overrides=overrides)
    train_ds, val_ds = make_datasets(cfg)
    check(len(train_ds) == len(val_ds) == NYU_FRAMES,
          f"NYU tree: {len(train_ds)} train, {len(val_ds)} test")
    expected = {"train/loss", "train/loss_relation_ce_super",
                "train/loss_ssc", "train/loss_sem_scal",
                "train/loss_geo_scal", "train/loss_frustums"}
    fit = fit_and_check(cfg, train_ds, val_ds, os.path.join(base, "fit"),
                        expected, "nyu_train", smi, n_dw_expected=n_dw)
    del fit["trainer"], fit["before"]
    torch.cuda.empty_cache()

    args = ["--config", default_config_path(NYU_B4),
            *(f"{k}={v}" for k, v in overrides.items())]
    lines = run_cli("train", args + ["--max-steps", "2"], "nyu_train_cli")
    check("train: steps 0 -> 2" in " ".join(lines),
          "the NYU train CLI did not take 2 steps")
    lines = run_cli("train", args + ["--max-steps", "3"],
                    "nyu_train_cli_resume")
    check("resumed from step 2" in lines
          and "train: steps 2 -> 3" in " ".join(lines),
          "the NYU train CLI did not resume at step 2")

    # b7 at full width: two train steps (the first pays one-time costs:
    # cuDNN's plans, the allocator), then one eval forward
    cfg7 = load_config(default_config_path(NYU_B7), overrides=nyu_overrides(
        base, "b7", compute_dtype="bfloat16", dw_conv_grad="pallas"))
    trainer = Trainer(cfg7)
    n_fast = sum(1 for m in trainer.model.modules()
                 if getattr(m, "fast_grad", False))
    check(n_fast == n_dw7, f"NYU b7: {n_fast} K4 convs in the model, "
          f"{n_dw7} held in phase 20")
    batches = [trainer._to_device({
        k: np.asarray(v)[None] for k, v in ds[0].items()
        if k not in ("frame_id", "sequence")}) for ds in (train_ds, val_ds)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dw_filter_grad.copies = 0
    step_ms, logs = [], {}
    with PlainLiftCalls() as plain:
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            logs, _, _ = train_step(cfg7, trainer.model, trainer.optimizer,
                                    batches[:1], 0.0, cfg7.lr)
            ev[1].record()
            torch.cuda.synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    vlogs, _, _ = eval_step(cfg7, trainer.model, batches[1])
    ev[1].record()
    torch.cuda.synchronize()
    n, copies = read_counts(), dw_filter_grad.copies
    b7 = {"launches": n, "train_ms": step_ms, "k4_copies": copies,
          "eval_ms": ev[0].elapsed_time(ev[1]),
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("nyu_b7", gpu=repr(smi), dw_convs=n_dw7, k4_copies=copies,
        train_step_ms=",".join(f"{t:.1f}" for t in step_ms),
        eval_forward_ms=f"{b7['eval_ms']:.1f}",
        peak_mem_gib=f"{b7['peak_gib']:.3f}",
        **{f"{k}_launches": v for k, v in n.items()},
        **{k: f"{float(v):.5f}" for k, v in logs.items()},
        **{f"val_{k}": f"{float(v):.5f}" for k, v in vlogs.items()})
    check(all(math.isfinite(float(v)) for v in [*logs.values(),
                                                 *vlogs.values()]),
          "NYU b7: a loss term is not finite")
    check(n["dw_filter_grad"] == 2 * n_dw7 and n_dw7 > n_dw,
          f"NYU b7: K4 launches {n['dw_filter_grad']} for {n_dw7} convs")
    check(copies == 0, f"NYU b7: K4 copied {copies} operands to NCHW")
    check(n["flosp_stereo_lift"] == n["crp_relation_matmul"] == 3
          and n["flosp_stereo_lift_backward"] == 2
          and n["stereo_cosine_fuse"] == n["conv3x3"] == 0,
          f"NYU b7: launches {n} (lift and K2 once per forward, the lift's "
          "backward once per step)")
    check(plain.count == 0,
          f"NYU b7: the plain lift ran {plain.count} times on the card")
    fit["b7"] = b7
    del trainer, batches
    torch.cuda.empty_cache()
    return fit


def phase_nyu_eval(dev, smi: str, base: str) -> dict:
    """22. NYU evaluation of the tree's 2 test frames at batch 2 (sample
    0's disparity warps both) from a reference-schema .ckpt of the b4
    config: fp32 (TF32 off) under decoder_conv_impl=xla and =pallas (K3
    under pallas only, confusion counts within CONF_FLIP_FRAC), bf16
    ms/frame in turns, and the eval CLI, which must print the 12-class
    table."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.params import NYU_CLASS_NAMES
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts.eval import evaluate
    from occdepth_tpu_torch.testing import randomize_weights

    paths = nyu_overrides(base, "eval", batch_size_per_gpu=NYU_EVAL_BATCH)
    cfg = load_config(default_config_path(NYU_B4),
                      overrides=dict(paths, compute_dtype="float32"))
    ckpt = os.path.join(base, "nyu_ref.ckpt")
    sd = randomize_weights(OccDepthModel(cfg), seed=0).state_dict()
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}},
               ckpt)
    del sd
    runs, launches = {}, {}
    for impl in ("xla", "pallas"):
        reset_counts()
        runs[impl] = evaluate(dataclasses.replace(cfg, decoder_conv_impl=impl),
                              torch_ckpt=ckpt)
        torch.cuda.synchronize()
        launches[impl] = read_counts()
        check_fp32_tensor_cores(f"nyu_eval_fp32 {impl}", launches[impl])
        log("nyu_eval_fp32", impl=impl, frames=runs[impl]["n_frames"],
            mIoU=f"{runs[impl]['iou_ssc_mean']:.6f}",
            loss=f"{runs[impl]['losses']['loss']:.5f}",
            **{f"{k}_launches": v for k, v in launches[impl].items()})
    n_batches = -(-NYU_FRAMES // NYU_EVAL_BATCH)
    counted = int(runs["pallas"]["conf"].sum())
    flips = int(np.abs(runs["pallas"]["conf"].astype(np.int64)
                       - runs["xla"]["conf"]).sum()) // 2
    log("nyu_eval_xla_vs_pallas", counted_voxels=counted, conf_diff=flips,
        bound=int(CONF_FLIP_FRAC * counted))
    check(launches["pallas"]["conv3x3"] == 10 * n_batches,
          f"NYU: K3 launched {launches['pallas']['conv3x3']} times "
          "under pallas")
    check(launches["xla"]["conv3x3"] == 0, "NYU: K3 launched under xla")
    for impl, n in launches.items():
        check(n["flosp_stereo_lift"] == n["crp_relation_matmul"] == n_batches
              and n["stereo_cosine_fuse"] == 0,
              f"NYU {impl}: lift/K2/K1 launches {n}")
    for impl, st in runs.items():
        n_vox = int(st["conf"].sum())
        check(st["n_frames"] == NYU_FRAMES
              and n_vox == NYU_FRAMES * math.prod(cfg.full_scene_size),
              f"NYU {impl}: {st['n_frames']} frames, {n_vox} voxels")
        check(all(math.isfinite(v) for v in [
            st["precision"], st["recall"], st["iou"], st["iou_ssc_mean"],
            *st["iou_ssc"].tolist(), *st["losses"].values()]),
            f"NYU {impl}: a stat is not finite")
    check(flips <= CONF_FLIP_FRAC * counted,
          f"NYU pallas vs xla confusion differs in {flips} voxels")

    times, peaks = {"xla": [], "pallas": []}, {"xla": [], "pallas": []}
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    for impl in ("xla", "pallas"):  # one untimed pass of each
        evaluate(dataclasses.replace(bf16, decoder_conv_impl=impl),
                 torch_ckpt=ckpt)
    for impl in ("xla", "pallas", "pallas", "xla"):
        torch.cuda.reset_peak_memory_stats()
        st = evaluate(dataclasses.replace(bf16, decoder_conv_impl=impl),
                      torch_ckpt=ckpt)
        times[impl].append(st["ms_per_frame"])
        peaks[impl].append(torch.cuda.max_memory_allocated() / 2**30)
    log("nyu_eval_bf16", gpu=repr(smi), batch=NYU_EVAL_BATCH,
        ms_per_frame_xla=",".join(f"{t:.2f}" for t in times["xla"]),
        ms_per_frame_pallas=",".join(f"{t:.2f}" for t in times["pallas"]),
        peak_gib_xla=f"{max(peaks['xla']):.3f}",
        peak_gib_pallas=f"{max(peaks['pallas']):.3f}")

    lines = run_cli("eval", [
        "--config", default_config_path(NYU_B4), "--torch-ckpt", ckpt,
        "decoder_conv_impl=pallas", "compute_dtype=bfloat16",
        *(f"{k}={v}" for k, v in paths.items())], "nyu_eval_cli")
    check("test======" in lines
          and f"class IoU: {NYU_CLASS_NAMES}, " in lines
          and len(lines[lines.index("test======") + 3].split()) == 12
          and any(line.startswith("mIoU=") for line in lines),
          "the eval CLI printed no 12-class NYU table")
    check("WARNING" not in " ".join(lines), "the NYU eval CLI missed keys")
    return {"launches": launches["pallas"], "times": times, "peaks": peaks,
            "flips": flips, "counted": counted}


KITTI_CONFIGS = (  # the shipped KITTI configs of phase 23, with their losses
    ("semantic_kitti/flospdepth", "flospdepth_train",
     {"loss", "loss_ssc", "loss_sem_scal", "loss_geo_scal",
      "loss_frustums"}),
    (FLAGSHIP + "_highcap", "highcap_train",
     {"loss", "loss_ssc", "loss_sem_scal", "loss_geo_scal", "loss_frustums",
      "loss_occ", "loss_depth", "loss_relation_ce_super"}),
    ("semantic_kitti/multicam_flosp_crp_cascadecls_highcap",
     "highcap_flosp_train",
     {"loss", "loss_ssc", "loss_sem_scal", "loss_geo_scal", "loss_frustums",
      "loss_occ", "loss_relation_ce_super"}),
)
CONFIG_STEPS = 2
HIGHCAP_C = 64  # both highcap configs' feature and feature_2d_oc


def phase_kitti_configs(dev, smi: str) -> dict:
    """23. The shipped KITTI configs no other phase runs, at full width in
    bf16 with dw_conv_grad=pallas: K4 vs its plain version at the b7
    encoder's stride-1 depthwise convs on a 370x1220 image (bench_dwconv's
    method, with its times, bound and cuDNN's); the fused lift at the
    highcap configs' C = 64 on their rig's 262,144 voxels and K2 at (1, 4,
    4,096, 512) @ (1, 512, 512), in bf16 and fp32, vs their plain versions
    (lift_at_shape, k2_at_shape: times, bounds); then flospdepth (one view,
    no CRP or cascade), the stereo-depth highcap (b7, feature 64) and the
    flosp highcap (b7, flosp) each fit 2 steps at batch 1 with
    validation (fit_and_check): losses finite, parameters moved, K4 once
    per depthwise conv of each differentiated view (both views under
    share_2d_backbone_gradient: false) with 0 copies, ms/step and peak
    memory."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.testing import synthetic_dataset

    from occdepth_tpu_torch.data.batch import make_synthetic_batch

    b7_shapes = flagship_dw_shapes(dev, (370, 1220), "tf_efficientnet_b7_ns")
    res = {"k4_b7": k4_at_shapes(dev, b7_shapes, "kitti_k4_b7", seed=27)}
    # the highcap configs' lift (C = 64 over the rig their training runs)
    # and K2 at feature 64 x 8, before they train
    hcfg = load_config(default_config_path(KITTI_CONFIGS[1][0]))
    check(hcfg.feature == hcfg.feature_2d_oc == HIGHCAP_C,
          f"highcap feature {hcfg.feature}, {hcfg.feature_2d_oc}")
    sample = make_synthetic_batch(hcfg, batch_size=1, seed=0)
    rig = [torch.from_numpy(sample[k]).to(dev)
           for k in ("projected_pix", "fov_mask")]
    cases = tuple((dt, layout, points) for points in ("rig", "edges")
                  for layout in ("nchw", "channels_last")
                  for dt in (torch.bfloat16, torch.float32))
    res["lift_highcap"] = lift_at_shape(
        dev, rig, tuple(hcfg.img_shape), HIGHCAP_C, cases,
        "kitti_lift_highcap", edge_seed=28, map_seed=80)
    res["k2_highcap"] = k2_at_shape(dev, 4096, 512, 8 * HIGHCAP_C,
                                    {"bfloat16": (), "float32": ()},
                                    "kitti_k2_highcap", seed=29)
    torch.cuda.empty_cache()
    for name, tag, losses in KITTI_CONFIGS:
        cfg = load_config(default_config_path(name), overrides={
            "compute_dtype": "bfloat16", "dw_conv_grad": "pallas",
            "log_every_n_steps": 1})
        train_ds = synthetic_dataset(cfg, 2, seed=0)
        val_ds = synthetic_dataset(cfg, 1, seed=1)
        b7 = cfg.backbone_2d_name == "tf_efficientnet_b7_ns"
        views = 1 if cfg.share_2d_backbone_gradient else cfg.n_views
        logdir = tempfile.mkdtemp(prefix=f"occdepth_{tag}_")
        try:
            fit = fit_and_check(
                cfg, train_ds, val_ds, logdir,
                {f"train/{k}" for k in losses}, tag, smi,
                n_dw_expected=len(b7_shapes) if b7 else 22,
                steps=CONFIG_STEPS, k4_views=views,
                lift_k2=int(cfg.n_views == 2))
            fit.pop("trainer"), fit.pop("before")
            res[tag] = fit
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


def near_tie_flips(pred, ref_logits, tag: str, margin: float) -> int:
    """Voxels where a CLI's class grid differs from the in-process model's
    argmax; fails unless every one lies where the in-process logits' two
    best are within `margin` (a rounding apart)."""
    ref = ref_logits.argmax(-1)
    flips = pred != ref
    top2 = np.sort(ref_logits[flips], axis=-1)[..., -2:]
    check(bool((top2[..., 1] - top2[..., 0] <= margin).all()),
          f"{tag}: {int(flips.sum())} voxels differ from the in-process "
          "argmax off its near-ties")
    return int(flips.sum())


OUT_FRAMES = 2  # per sequence of the outputs tree (val 08; test 11-21 -> 08)
TIE_MARGIN = 1e-2  # bf16 logits: voxels whose two best are a rounding apart


def phase_outputs(dev, smi: str) -> dict:
    """24. The output CLIs at full width (the flagship, bf16) on a
    make_kitti_tree tree whose eleven test sequences are symlinks of val
    sequence 08, from a reference-schema .ckpt of seeded random weights,
    each CLI's main in-process with the launch counts set to 0 just
    before: infer on one frame's PNGs and calib.txt under
    decoder_conv_impl=auto and =pallas (rendered where matplotlib
    imports); generate_output over the val split; generate_kitti_submission
    over the test split, then the port's validator (no errors);
    dump_batch --synthetic; infer once more as a subprocess.  Each CLI's
    y_pred equals the in-process model's argmax on the same batch (flips
    only at near-ties); the lift and K2 once per frame, K3 ten times per
    frame under pallas and never under auto; wall ms/frame of each CLI
    (host clock: data, forward, writing) and the forward's device
    ms/frame (CUDA events)."""
    import importlib.util
    import pickle

    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.kitti import KittiDataset, Loader
    from occdepth_tpu_torch.data.kitti_io import TEST_SEQUENCES, get_inv_map
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts import (
        dump_batch,
        generate_kitti_submission,
        generate_output,
        infer,
        valid_kitti_submission,
    )
    from occdepth_tpu_torch.scripts.common import load_model, model_inputs
    from occdepth_tpu_torch.testing import make_kitti_tree, randomize_weights
    from occdepth_tpu_torch.training.trainer import strip_metadata

    can_render = importlib.util.find_spec("matplotlib") is not None
    base = tempfile.mkdtemp(prefix="occdepth_outputs_")
    res = {"launches": {}, "render": can_render}
    try:
        t0 = time.perf_counter()
        make_kitti_tree(base, n_frames=OUT_FRAMES)
        seqs = os.path.join(base, "kitti", "dataset", "sequences")
        for seq in TEST_SEQUENCES:
            os.symlink(os.path.join(seqs, "08"), os.path.join(seqs, seq))
        over = [f"data_root={base}/kitti", f"data_preprocess_root={base}/pre",
                f"data_stereo_depth_root={base}/stereo_depth",
                f"logdir={base}/logdir", "compute_dtype=bfloat16"]
        config = default_config_path(FLAGSHIP)
        cfg = load_config(config, overrides=dict(
            a.split("=", 1) for a in over))
        ckpt = os.path.join(base, "ref.ckpt")
        torch.save({"state_dict": randomize_weights(
            OccDepthModel(cfg), seed=0).state_dict()}, ckpt)
        log("outputs_tree", seconds=f"{time.perf_counter() - t0:.1f}",
            test_sequences=len(TEST_SEQUENCES), frames_per_sequence=OUT_FRAMES,
            matplotlib=can_render)
        models = {impl: load_model(dataclasses.replace(
            cfg, decoder_conv_impl=impl), torch_ckpt=ckpt)
            for impl in ("auto", "pallas")}

        def logits_of(impl, batch):
            with torch.no_grad():
                out = models[impl](model_inputs(batch, dev))["ssc_logit"]
            return out.float().cpu().numpy()

        def device_ms(impl, batch):
            inputs = model_inputs(batch, dev)
            with torch.no_grad():
                return cuda_ms(lambda: models[impl](inputs), iters=5,
                               warmup=1)

        def run(tag, main, argv, frames):
            reset_counts()
            t0 = time.perf_counter()
            written = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res["launches"][tag] = launches = read_counts()
            check(len(written) == frames, f"{tag}: wrote {len(written)} "
                  f"files for {frames} frames")
            return written, launches, 1e3 * wall / frames

        # ---- infer, under auto and pallas ----
        left, right = (os.path.join(seqs, "08", d, "000000.png")
                       for d in ("image_2", "image_3"))
        calib = os.path.join(seqs, "08", "calib.txt")
        frame_args = ["--config", config, "--left", left, "--right", right,
                      "--calib", calib, "--torch-ckpt", ckpt]
        batch = infer.build_batch(cfg, [left], [right], calib)[0]
        for impl in ("auto", "pallas"):
            out = os.path.join(base, f"infer_{impl}.pkl")
            render = (["--render", os.path.join(base, f"infer_{impl}.png")]
                      if can_render else [])
            (path,), n, wall_ms = run(
                f"infer_{impl}", infer.main, frame_args + [
                    "--output", out, *render,
                    f"decoder_conv_impl={impl}"] + over, 1)
            with open(path, "rb") as f:
                record = pickle.load(f)
            flips = near_tie_flips(record["y_pred"],
                                   logits_of(impl, batch)[0],
                                   f"infer_{impl}", TIE_MARGIN)
            k3 = 10 if impl == "pallas" else 0
            ms = device_ms(impl, batch)
            log(f"infer_{impl}", gpu=repr(smi), wall_ms_per_frame=f"{wall_ms:.1f}",
                device_ms_per_frame=f"{ms:.3f}", flips=flips,
                y_pred=tuple(record["y_pred"].shape),
                png_bytes=(os.path.getsize(render[1]) if render
                           else "no matplotlib"),
                **{f"{k}_launches": v for k, v in n.items()})
            check(record["y_pred"].shape == tuple(cfg.full_scene_size)
                  and record["fov_mask_1"].size == record["y_pred"].size,
                  f"infer_{impl}: record {record['y_pred'].shape}")
            check(n["flosp_stereo_lift"] == n["crp_relation_matmul"] == 1
                  and n["conv3x3"] == k3 and n["stereo_cosine_fuse"] == 0,
                  f"infer_{impl}: launches {n}")
            if render:
                check(os.path.getsize(render[1]) > 1000,
                      f"infer_{impl}: no rendered PNG")
            res[f"infer_{impl}"] = {"wall_ms": wall_ms, "device_ms": ms}

        # ---- generate_output over the val split ----
        val = [b for b in Loader(KittiDataset(cfg, "val"), 1, shuffle=False,
                                 drop_last=False, num_workers=0)]
        out_dir = os.path.join(base, "outputs")
        written, n, wall_ms = run("generate_output", generate_output.main, [
            "--config", config, "--torch-ckpt", ckpt, "--output-dir",
            out_dir] + over, len(val))
        flips = 0
        for path, b in zip(written, val):
            with open(path, "rb") as f:
                record = pickle.load(f)
            check(os.path.basename(path) == f"08_{b['frame_id'][0]}.pkl"
                  and {"y_pred", "target", "fov_mask_1", "cam_k",
                       "T_velo_2_cam"} <= set(record),
                  f"generate_output: {path} keys {sorted(record)}")
            flips += near_tie_flips(record["y_pred"],
                                    logits_of("auto", strip_metadata(b))[0],
                                    "generate_output", TIE_MARGIN)
        check(n["flosp_stereo_lift"] == n["crp_relation_matmul"] == len(val)
              and n["conv3x3"] == 0, f"generate_output: launches {n}")
        log("generate_output", gpu=repr(smi), frames=len(val),
            wall_ms_per_frame=f"{wall_ms:.1f}", flips=flips,
            **{f"{k}_launches": v for k, v in n.items()})
        res["generate_output"] = {"wall_ms": wall_ms}

        # ---- the KITTI submission and its validator ----
        sub_dir = os.path.join(base, "submission")
        frames = len(TEST_SEQUENCES) * OUT_FRAMES
        written, n, wall_ms = run(
            "submission", generate_kitti_submission.main, [
                "--config", config, "--torch-ckpt", ckpt, "--output-dir",
                sub_dir] + over, frames)
        errors = valid_kitti_submission.validate_dir(sub_dir)
        test0 = next(iter(Loader(KittiDataset(cfg, "test"), 1, shuffle=False,
                                 drop_last=False, num_workers=0)))
        labels = np.fromfile(written[0], np.uint16)
        ref_logits = logits_of("auto", strip_metadata(test0))[0]
        raw = get_inv_map()[ref_logits.argmax(-1).reshape(-1)]
        differ = int((labels != raw).sum())
        top2 = np.sort(ref_logits.reshape(-1, ref_logits.shape[-1])[
            labels != raw], axis=-1)[..., -2:]
        log("submission", gpu=repr(smi), frames=frames,
            wall_ms_per_frame=f"{wall_ms:.1f}", validator_errors=len(errors),
            first_frame_differs=differ,
            **{f"{k}_launches": v for k, v in n.items()})
        check(errors == [], f"the validator found {errors[:5]}")
        check(bool((top2[..., 1] - top2[..., 0] <= TIE_MARGIN).all()),
              f"submission: {differ} labels differ off the near-ties")
        check(n["flosp_stereo_lift"] == n["crp_relation_matmul"] == frames,
              f"submission: launches {n}")
        res["submission"] = {"wall_ms": wall_ms}

        # ---- dump_batch --synthetic ----
        pkl = os.path.join(base, "batch.pkl")
        dump_batch.main(["--config", config, "--synthetic", "--out", pkl]
                        + over)
        with open(pkl, "rb") as f:
            dumped = pickle.load(f)
        check(dumped["img"].shape == (1, 2, *cfg.img_shape, 3)
              and dumped["target"].shape == (1, *cfg.full_scene_size)
              and all(isinstance(v, np.ndarray) for v in dumped.values()),
              f"dump_batch: {sorted((k, v.shape) for k, v in dumped.items())}")

        # ---- infer as a user runs it ----
        out = os.path.join(base, "infer_cli.pkl")
        run_cli("infer", frame_args + ["--output", out] + over, "infer_cli")
        with open(out, "rb") as f, open(os.path.join(
                base, "infer_auto.pkl"), "rb") as g:
            check(np.array_equal(pickle.load(f)["y_pred"],
                                 pickle.load(g)["y_pred"]),
                  "the infer subprocess and in-process runs differ")
        del models
    finally:
        shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def phase_nyu_outputs(dev, smi: str, base: str) -> dict:
    """25. generate_output over the NYU b4 config's test split (the tree
    of phases 20-22, bf16, a reference-schema .ckpt): pickles with
    cam_pose = inv(T_velo_2_cam) and vox_origin, y_pred equal to the
    in-process argmax (flips only at near-ties), the lift and K2 once per
    batch."""
    import pickle

    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.kitti import Loader
    from occdepth_tpu_torch.data.nyu import NYUDataset
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts import generate_output
    from occdepth_tpu_torch.scripts.common import load_model, model_inputs
    from occdepth_tpu_torch.testing import randomize_weights
    from occdepth_tpu_torch.training.trainer import strip_metadata

    over = nyu_overrides(base, "outputs", compute_dtype="bfloat16")
    cfg = load_config(default_config_path(NYU_B4), overrides=over)
    ckpt = os.path.join(base, "outputs_ref.ckpt")
    torch.save({"state_dict": randomize_weights(
        OccDepthModel(cfg), seed=0).state_dict()}, ckpt)
    out_dir = os.path.join(base, "nyu_outputs")
    reset_counts()
    t0 = time.perf_counter()
    written = generate_output.main(
        ["--config", default_config_path(NYU_B4), "--torch-ckpt", ckpt,
         "--output-dir", out_dir] + [f"{k}={v}" for k, v in over.items()])
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / max(1, len(written))
    launches = read_counts()
    model = load_model(cfg, torch_ckpt=ckpt)
    loader = Loader(NYUDataset(cfg, "test"), cfg.batch_size_per_gpu,
                    shuffle=False, drop_last=False, num_workers=0)
    flips, i = 0, 0
    for b in loader:
        with torch.no_grad():
            logits = model(model_inputs(strip_metadata(b), dev))[
                "ssc_logit"].float().cpu().numpy()
        for j in range(len(b["frame_id"])):
            with open(written[i], "rb") as f:
                record = pickle.load(f)
            i += 1
            check(np.allclose(record["cam_pose"] @ record["T_velo_2_cam"],
                              np.eye(4), atol=1e-5)
                  and "vox_origin" in record and "target" in record,
                  f"nyu generate_output: {sorted(record)}")
            flips += near_tie_flips(record["y_pred"], logits[j],
                                    "nyu_generate_output", TIE_MARGIN)
    n_batches = len(loader)
    log("nyu_generate_output", gpu=repr(smi), frames=len(written),
        wall_ms_per_frame=f"{wall_ms:.1f}", flips=flips,
        **{f"{k}_launches": v for k, v in launches.items()})
    check(i == len(written) == NYU_FRAMES, f"NYU outputs: {len(written)}")
    check(launches["flosp_stereo_lift"] == launches["crp_relation_matmul"]
          == n_batches, f"NYU outputs launches {launches}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_ms": wall_ms}


EXPORT_RTOL = 1e-5  # x max|eager|: the same kernels and ops, replayed


def phase_export(dev, smi: str) -> dict:
    """26. Export at full width: the flagship (bf16, decoder_conv_impl=
    pallas, seeded random weights) traced by export_forward on the card,
    saved, loaded by load_exported; each forward of the loaded program
    launches the lift and K2 once and K3 ten times (counts set to 0 just
    before); its logits equal the eager model's within EXPORT_RTOL x
    max|eager|; the export and load time in s and the device ms/frame of
    the loaded program and of eager (CUDA events, in turns)."""
    import torch

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts.common import model_inputs
    from occdepth_tpu_torch.scripts.export_model import (
        INPUT_KEYS,
        export_forward,
        load_exported,
    )
    from occdepth_tpu_torch.testing import randomize_weights

    cfg = load_config(default_config_path(FLAGSHIP), overrides={
        "compute_dtype": "bfloat16", "decoder_conv_impl": "pallas"})
    model = randomize_weights(OccDepthModel(cfg), seed=0).to(dev).eval()
    batch = model_inputs(make_synthetic_batch(cfg, batch_size=1, seed=3), dev)
    inputs = {k: v for k, v in batch.items() if k in INPUT_KEYS}
    base = tempfile.mkdtemp(prefix="occdepth_export_")
    try:
        t0 = time.perf_counter()
        exported = export_forward(cfg, model, batch)
        export_s = time.perf_counter() - t0
        nodes = sorted({str(n.target) for n in exported.graph.nodes
                        if "occdepth" in str(n.target)})
        path = os.path.join(base, "flagship.pt2")
        torch.export.save(exported, path)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        program = load_exported(path).module()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    with torch.no_grad():
        reset_counts()
        out = program(inputs)
        torch.cuda.synchronize()
        launches = read_counts()
        eager = model(batch)["ssc_logit"]
        err = (out - eager).abs().max().item()
        tol = EXPORT_RTOL * eager.abs().max().item()
        times = {"exported": [], "eager": []}
        for which in ("exported", "eager", "eager", "exported"):
            fn = (lambda: program(inputs)) if which == "exported" else (
                lambda: model(batch))
            times[which].append(cuda_ms(fn, iters=10, warmup=2))
    log("export", gpu=repr(smi), export_s=f"{export_s:.2f}",
        load_s=f"{load_s:.2f}", bytes=size, ops=",".join(nodes),
        max_abs_err=err, tol=f"{tol:.3e}",
        exported_ms_per_frame=",".join(f"{t:.3f}" for t in times["exported"]),
        eager_ms_per_frame=",".join(f"{t:.3f}" for t in times["eager"]),
        **{f"{k}_launches": v for k, v in launches.items()})
    check({"occdepth.flosp_stereo_lift.default",
           "occdepth.crp_relation_matmul.default",
           "occdepth.conv3x3.default"} <= set(nodes),
          f"the exported graph calls {nodes}")
    check(launches["flosp_stereo_lift"] == launches["crp_relation_matmul"]
          == 1 and launches["conv3x3"] == 10
          and launches["stereo_cosine_fuse"] == 0,
          f"the exported program's launches {launches}")
    check(tuple(out.shape) == (1, *cfg.full_scene_size, cfg.n_classes)
          and err <= tol, f"exported vs eager: {err} > {tol}")
    del program, exported, model
    torch.cuda.empty_cache()
    return {"launches": launches, "export_s": export_s, "load_s": load_s,
            "times": times, "max_abs_err": err}


DDP_STEPS = 2
DDP_RESUME = ("--epochs", "4", "--kill-step", "5")  # 2 steps an epoch
DDP_CONVERGENCE = ("--epochs", "2", "--kill-step", "25", "--tail", "10")
# the resume check compares runs A and B bitwise (its default): the
# TartanAir path's one op without a deterministic CUDA implementation,
# avg_pool3d's backward, pools non-overlapping windows (one atomic add per
# input element)


def tool_summary(proc, tag: str) -> dict:
    """Wait for a check script's subprocess; its last line's JSON."""
    out, err = proc.communicate(timeout=400)
    lines = out.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"{tag}: exit {proc.returncode}\n{out[-3000:]}\n{err[-3000:]}")
    return json.loads(lines[-1])


def phase_ddp(dev, smi: str) -> dict:
    """27. Data parallel.  (a) The flagship (bf16, dw_conv_grad=pallas)
    through the DDP Trainer in a one-rank NCCL group opened under
    torchrun's variables: 2 steps at batch 1 with phase 10's checks (the
    lift and K2 once a step, K4 22 times a step, no copies), ms/step and
    peak memory, and its first-step parameters against a plain train_step
    on a copy of the same initial weights and the same first batch.  Then,
    side by side, (b) check_ddp: two gloo ranks on this card held to the
    one-process emulation (the cross-rank BN, the running and batch
    gradients, K = 2 accumulation, Trainer.fit and validate, the kernels
    launched on each rank); (c) check_resume_determinism on the TartanAir
    toy tree (deterministic: true, 4 epochs, SIGKILL at step 5) and
    check_convergence on a make_kitti_tree flagship tree (2 epochs of 20
    steps, SIGKILL at step 25)."""
    import socket

    import torch
    import torch.distributed as dist

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.kitti import Loader
    from occdepth_tpu_torch.parallel import ddp
    from occdepth_tpu_torch.testing import synthetic_dataset
    from occdepth_tpu_torch.training import Trainer
    from occdepth_tpu_torch.training.optim import lr_at, make_optimizer
    from occdepth_tpu_torch.training.step import train_step
    from occdepth_tpu_torch.training.trainer import strip_metadata

    t_phase = time.perf_counter()
    cfg = load_config(default_config_path(FLAGSHIP), overrides={
        "compute_dtype": "bfloat16", "dw_conv_grad": "pallas",
        "log_every_n_steps": 1})
    train_ds = synthetic_dataset(cfg, 2, seed=0)
    val_ds = synthetic_dataset(cfg, 1, seed=1)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    os.environ.update(env)
    logdir = tempfile.mkdtemp(prefix="occdepth_ddp_")
    try:
        trainer = Trainer(cfg, logdir)
        check(isinstance(trainer.net,
                         torch.nn.parallel.DistributedDataParallel)
              and trainer.world == 1 and dist.get_backend() == "nccl"
              and trainer.device == torch.device("cuda", 0),
              f"ddp: {type(trainer.net).__name__} world {trainer.world} "
              f"on {trainer.device}")
        # two plain steps, each on a copy of the initial weights and fit's
        # first batch: the second is the run-to-run noise of one step (the
        # lift's backward sums in atomics' order, cuDNN picks algorithms)
        first = next(iter(Loader(train_ds, 1, shuffle=True, num_workers=0)))
        plain = []
        for _ in range(2):
            ref = copy.deepcopy(trainer.model)
            train_step(cfg, ref, make_optimizer(ref.parameters(), cfg),
                       [trainer._to_device(strip_metadata(first))], 0.0,
                       lr_at(cfg, len(train_ds), 0))
            plain.append(dict(ref.named_parameters()))
            del ref
        first_step = {}

        def snapshot(opt, args, kwargs):
            if not first_step:
                first_step.update({n: p.detach().clone() for n, p in
                                   trainer.model.named_parameters()})

        hook = trainer.optimizer.register_step_post_hook(snapshot)
        fit = fit_and_check(cfg, train_ds, val_ds, logdir, {
            "train/loss", "train/loss_relation_ce_super", "train/loss_ssc",
            "train/loss_occ", "train/loss_depth", "train/loss_sem_scal",
            "train/loss_geo_scal", "train/loss_frustums"}, "ddp_world1", smi,
            steps=DDP_STEPS, trainer=trainer)
        hook.remove()

        def differ(a, b):
            d = [(a[n].detach() - b[n].detach()).abs() for n in a]
            return (max(float(x.max()) for x in d),
                    sum(int((x > 0).sum()) for x in d))

        max_diff, n_diff = differ(plain[0], first_step)
        noise_max, noise_n = differ(plain[0], plain[1])
        lr = lr_at(cfg, len(train_ds), 0)
        log("ddp_first_step", bitwise=n_diff == 0,
            max_abs_diff=f"{max_diff:.3e}", elements_differing=n_diff,
            plain_vs_plain_max_abs_diff=f"{noise_max:.3e}",
            plain_vs_plain_elements_differing=noise_n,
            elements=sum(p.numel() for p in first_step.values()), lr=lr,
            bound="2 lr (AdamW's first update is ~lr sign(g): an element "
                  "whose gradient sits at fp32 noise may flip)")
        check(max_diff <= 2.0 * lr * (1 + 1e-3),
              f"ddp: first-step parameters differ by {max_diff}")
        fit["first_step"] = {"max_abs_diff": max_diff, "differing": n_diff,
                             "plain_max_abs_diff": noise_max,
                             "plain_differing": noise_n}
        del fit["trainer"], fit["before"], trainer, plain, first_step
    finally:
        ddp.shutdown()
        for k in env:
            os.environ.pop(k, None)
        shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
    world1_s = time.perf_counter() - t_phase

    # ---- (b) and (c): subprocesses side by side ----
    tmp = tempfile.mkdtemp(prefix="occdepth_ddp_tools_")
    t0 = time.perf_counter()
    try:
        def start(module, *args):
            return subprocess.Popen(
                [sys.executable, "-m", f"occdepth_tpu_torch.scripts.{module}",
                 *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)

        procs = {
            "check_ddp": start("check_ddp", "--device", "cuda:0",
                               "--backend", "gloo", "--out",
                               os.path.join(tmp, "ddp")),
            "resume": start("check_resume_determinism", "--base",
                            os.path.join(tmp, "resume"), *DDP_RESUME),
            "convergence": start("check_convergence", "--base",
                                 os.path.join(tmp, "convergence"),
                                 *DDP_CONVERGENCE),
        }
        try:
            res = {tag: tool_summary(p, tag) for tag, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tools_s = time.perf_counter() - t0
    rep = res["check_ddp"]
    log("ddp_two_ranks", ok=rep["ok"], device=rep["device"],
        bn_max_rel=f"{rep['bn']['max_rel']:.3e}",
        running_max_rel=f"{rep['running']['max_rel']:.3e}",
        running_bound=rep["running"]["bound"],
        batch_worst_ratio=f"{rep['batch']['worst_ratio']:.3f}",
        batch_noise_only_leaves=rep["batch"]["noise_only_leaves"],
        accum2_max_rel=f"{rep['accum2']['max_rel']:.3e}",
        eval_conf_flips=rep["fit"]["conf_flips"],
        near_ties=rep["fit"]["near_ties"],
        launches_per_rank=rep["fit"]["launches"])
    check(rep["ok"] and rep["fit"].get("launches_ok"),
          f"check_ddp on the card: {json.dumps(rep)[:3000]}")
    for tag in ("resume", "convergence"):
        log(f"ddp_{tag}", **{k: v for k, v in res[tag].items()
                             if k not in ("base", "config", "tree")})
        check(res[tag]["ok"], f"{tag}: {res[tag]}")
    log("ddp_phase", world1_s=f"{world1_s:.1f}", tools_s=f"{tools_s:.1f}",
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    return dict(fit, two_ranks=rep, resume=res["resume"],
                convergence=res["convergence"])


RAW_FRAMES = 2  # per KITTI sequence (00, 08; 01-07, 09, 10 link to 00)
RAW_TA_FRAMES = 10  # of the raw TartanAir sequence: 2 exported (every 5th)
RAW_EVAL_BATCH = 2  # NYU's and TartanAir's 2 eval frames: one batch
RAW_LOADER_N = 8  # samples timed per bench_loader case


def plain_pool(label, ds: int):
    """The plain majority pool (`native_ext.downsample_label_plain`) of a
    full-size grid, one slab of `ds` x-rows at a time on 8 threads: the
    plain version's one-hot temporaries stay per slab."""
    from concurrent.futures import ThreadPoolExecutor

    from occdepth_tpu_torch.native_ext import downsample_label_plain

    starts = range(0, label.shape[0] // ds * ds, ds)
    with ThreadPoolExecutor(8) as pool:
        return np.concatenate(list(pool.map(
            lambda x: downsample_label_plain(label[x:x + ds], ds), starts)))


def cli_summary(lines, name: str) -> tuple:
    """(items, seconds) of a preprocessing CLI's summary line."""
    line = next(x for x in lines if x.startswith(name + ": "))
    words = line.split()
    return int(words[1]), float(words[4])


def raw_native() -> dict:
    """28(a). The native library: a forced build into a fresh directory
    (its seconds), and each binding held exactly to its plain version on
    seeded inputs at small shapes."""
    from occdepth_tpu_torch import native_ext as ne
    from occdepth_tpu_torch.geometry.frustums_mask import (
        compute_frustum_class_dists_plain,
    )

    tmp = tempfile.mkdtemp(prefix="occdepth_native_")
    try:
        _, seconds = ne.build(force=True, build_dir=tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rng = np.random.RandomState(28)
    label = rng.choice([0, 1, 2, 7, 200, 255], size=(64, 32, 32),
                       p=[0.6, 0.1, 0.1, 0.04, 0.01, 0.15]).astype(np.uint8)
    label[:16] = 0
    label[-16:] = 255
    for ds in (2, 4, 8, 16):
        check(np.array_equal(ne.downsample_label(label, ds),
                             ne.downsample_label_plain(label, ds)),
              f"native downsample_label at ds {ds}")
    rle = np.stack([rng.choice(np.r_[0:37, 255, 40], size=500),
                    rng.randint(0, 40, size=500)], 1).reshape(-1)
    rle = rle.astype(np.uint32)
    cmap = (np.arange(37) % 12).astype(np.uint8)
    n = int(rle[1::2].sum())
    check(np.array_equal(ne.rle_decode(rle, cmap, n),
                         ne.rle_decode_plain(rle, cmap, n)),
          "native rle_decode")
    try:
        ne.rle_decode(rle, cmap, n - 1)
        check(False, "native rle_decode missed an overflow")
    except ValueError:
        pass
    vi = rng.randint(-2, 10, size=(5000, 3)).astype(np.int32)
    ci = rng.randint(0, 6, size=5000).astype(np.int32)
    for a, b in zip(ne.voxel_vote(vi, ci, (8, 6, 7), 6),
                    ne.voxel_vote_plain(vi, ci, (8, 6, 7), 6)):
        check(np.array_equal(a, b), "native voxel_vote")
    bits = (rng.rand(8 * 4096) < 0.3).astype(np.uint8)
    packed = ne.pack_bits(bits)
    check(np.array_equal(packed, ne.pack_bits_plain(bits))
          and np.array_equal(ne.unpack_bits(packed), bits)
          and np.array_equal(ne.unpack_bits_plain(packed), bits),
          "native pack_bits / unpack_bits")
    for V in (1, 2):
        pix = rng.randint(-8, 72, size=(V, 2400, 1, 2)).astype(np.int64)
        pix[:, :50, 0, 0] = 2 ** 40  # far past int32: invalid, not wrapped
        pz = rng.randn(V, 2400).astype(np.float32)
        tgt = rng.choice(np.r_[0:5, 255], size=(20, 12, 10)).astype(np.int32)
        native = ne.frustum_class_dists(pix[..., 0, 0], pix[..., 0, 1], pz,
                                        tgt.reshape(-1), 4, 64, 48, 5)
        plain = compute_frustum_class_dists_plain(pix, pz, tgt, 64, 48,
                                                  "kitti", 5, 4)
        check(np.array_equal(native, plain),
              f"native frustum_class_dists at V = {V}")
    res = {"build_s": seconds, "library": ne.library_path()}
    log("raw_native", build_s=f"{seconds:.2f}", library=res["library"],
        bindings="downsample_label ds 2/4/8/16, rle_decode (+ overflow), "
                 "voxel_vote, pack/unpack_bits, frustum_class_dists V 1/2: "
                 "equal to their plain versions")
    return res


def raw_eval(cfg, tag: str, n_frames: int) -> dict:
    """One eval batch of `cfg` (its val split, RAW_EVAL_BATCH frames) from
    a reference-schema .ckpt of seeded weights, counters set to 0 just
    before: the lift and K2 once, K1 never; finite stats."""
    import torch

    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts.eval import evaluate
    from occdepth_tpu_torch.testing import randomize_weights

    ckpt = os.path.join(cfg.logdir, "ref.ckpt")
    os.makedirs(cfg.logdir, exist_ok=True)
    sd = randomize_weights(OccDepthModel(cfg), seed=0).state_dict()
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}},
               ckpt)
    del sd
    reset_counts()
    st = evaluate(cfg, torch_ckpt=ckpt)
    torch.cuda.synchronize()
    launches = read_counts()
    n_vox = int(st["conf"].sum())
    log(tag, frames=st["n_frames"], batch=cfg.batch_size_per_gpu,
        mIoU=f"{st['iou_ssc_mean']:.6f}", loss=f"{st['losses']['loss']:.5f}",
        ms_per_frame=f"{st['ms_per_frame']:.2f}",
        **{f"{k}_launches": v for k, v in launches.items()})
    check(st["n_frames"] == n_frames
          and n_vox == n_frames * math.prod(cfg.full_scene_size),
          f"{tag}: {st['n_frames']} frames, {n_vox} voxels")
    check(launches["flosp_stereo_lift"] == launches["crp_relation_matmul"]
          == 1 and launches["stereo_cosine_fuse"] == 0,
          f"{tag}: one batch launched {launches}")
    check(all(math.isfinite(v) for v in [
        st["precision"], st["recall"], st["iou"], st["iou_ssc_mean"],
        *st["iou_ssc"].tolist(), *st["losses"].values()]),
        f"{tag}: a stat is not finite")
    return {"launches": launches, "ms_per_frame": st["ms_per_frame"]}


def raw_kitti(base: str, smi: str) -> dict:
    """28(b). KITTI from raw files: .label/.invalid beside a full-size
    make_kitti_tree tree, its pre/labels deleted, the preprocess_kitti CLI,
    every _1_1 held to the plain remap and every _1_8 to the plain pool of
    its _1_1, then the flagship (bf16, dw_conv_grad=pallas) trained 2
    steps from that tree through the train CLI's main."""
    import torch

    from occdepth_tpu_torch.config import default_config_path
    from occdepth_tpu_torch.data import kitti_io
    from occdepth_tpu_torch.native_ext import unpack_bits_plain
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.scripts import train as train_cli
    from occdepth_tpu_torch.testing import make_kitti_tree, write_kitti_raw

    t0 = time.perf_counter()
    make_kitti_tree(base, n_frames=RAW_FRAMES)
    n_raw = write_kitti_raw(base)
    shutil.rmtree(os.path.join(base, "pre", "labels"))
    tree_s = time.perf_counter() - t0
    paths = [f"data_root={base}/kitti", f"data_preprocess_root={base}/pre",
             f"data_stereo_depth_root={base}/stereo_depth"]
    t0 = time.perf_counter()
    lines = run_cli("preprocess_kitti", [
        "--config", default_config_path(FLAGSHIP), *paths], "raw_kitti_cli")
    cli_s = time.perf_counter() - t0
    frames, pre_s = cli_summary(lines, "preprocess_kitti")
    n_seq = len(kitti_io.TRAIN_SEQUENCES) + len(kitti_io.VAL_SEQUENCES)
    check(n_raw == 2 * RAW_FRAMES and frames == n_seq * RAW_FRAMES,
          f"preprocess_kitti wrote {frames} frames ({n_raw} raw)")
    # every frame of every sequence, the plain pool once per distinct _1_1
    t0 = time.perf_counter()
    lut, pools = kitti_io.get_remap_lut(), {}
    for seq in kitti_io.TRAIN_SEQUENCES + kitti_io.VAL_SEQUENCES:
        for i in range(RAW_FRAMES):
            vox = f"{base}/kitti/dataset/sequences/{seq}/voxels/{5 * i:06d}"
            raw = np.fromfile(vox + ".label", np.uint16)
            inv = unpack_bits_plain(np.fromfile(vox + ".invalid", np.uint8))
            expect = np.where(inv == 1, 255, lut[raw]).astype(np.uint8)
            out = f"{base}/pre/labels/{seq}/{5 * i:06d}"
            t11 = np.load(out + "_1_1.npy")
            check(np.array_equal(t11, expect.reshape(kitti_io.SCENE_DIMS)),
                  f"{seq}/{5 * i:06d}_1_1 is not the plain remap")
            key = t11.tobytes()
            if key not in pools:
                pools[key] = plain_pool(t11, 8)
            check(np.array_equal(np.load(out + "_1_8.npy"), pools[key]),
                  f"{seq}/{5 * i:06d}_1_8 is not the plain pool")
    check_s = time.perf_counter() - t0

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainLiftCalls() as plain:
        trainer = train_cli.main([
            "--config", default_config_path(FLAGSHIP), "--max-steps", "2",
            *paths, f"logdir={base}/logdir", "compute_dtype=bfloat16",
            "dw_conv_grad=pallas", "batch_size_per_gpu=1",
            "log_every_n_steps=1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, copies = read_counts(), dw_filter_grad.copies
    n_val = len(kitti_io.VAL_SEQUENCES) * RAW_FRAMES  # batch 1
    step_ms = list(trainer.step_ms)
    with open(trainer.metrics_logger.path) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    del trainer
    torch.cuda.empty_cache()
    log("raw_kitti", gpu=repr(smi), tree_s=f"{tree_s:.2f}",
        preprocess_frames=frames, preprocess_s=f"{pre_s:.3f}",
        preprocess_s_per_frame=f"{pre_s / frames:.4f}",
        cli_wall_s=f"{cli_s:.2f}", check_s=f"{check_s:.2f}",
        distinct_label_grids=len(pools), train_wall_s=f"{train_s:.2f}",
        step_ms=",".join(f"{t:.2f}" for t in step_ms),
        losses=",".join(f"{x:.4f}" for x in losses), k4_copies=copies,
        **{f"{k}_launches": v for k, v in launches.items()})
    check(len(step_ms) == 2 and len(losses) == 2
          and all(math.isfinite(x) for x in losses),
          f"raw KITTI train: steps {step_ms}, losses {losses}")
    check(launches["dw_filter_grad"] == 22 * 2 and copies == 0,
          f"raw KITTI train: K4 {launches['dw_filter_grad']}, {copies} "
          "copies")
    for name in ("flosp_stereo_lift", "crp_relation_matmul"):
        check(launches[name] == 2 + n_val,
              f"raw KITTI train: {name} {launches[name]} for 2 steps and "
              f"{n_val} val forwards")
    check(launches["flosp_stereo_lift_backward"] == 2 and plain.count == 0,
          f"raw KITTI train: the lift's backward launched "
          f"{launches['flosp_stereo_lift_backward']} times for 2 steps, the "
          f"plain lift {plain.count} times on the card")
    check(launches["stereo_cosine_fuse"] == launches["conv3x3"] == 0,
          f"raw KITTI train: K1/K3 launched {launches}")
    return {"launches": launches, "preprocess_s_per_frame": pre_s / frames,
            "frames": frames, "step_ms": step_ms, "tree": base}


def raw_nyu(base: str, smi: str) -> dict:
    """28(c). NYU from raw files: RLE .bin scans over a full-size
    make_nyu_tree tree, its base/*.pkl deleted, the preprocess_nyu CLI,
    target_1_4 / target_1_16 held to the plain decode and pool, and one
    eval batch of the b4 config on the card."""
    import pickle

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.native_ext import rle_decode_plain
    from occdepth_tpu_torch.scripts.preprocess_nyu import (
        SCENE_SIZE,
        SEG_CLASS_MAP,
        read_rle_bin,
    )
    from occdepth_tpu_torch.testing import make_nyu_tree, write_nyu_raw

    make_nyu_tree(base, n_frames=NYU_FRAMES)
    n_raw = write_nyu_raw(base)
    shutil.rmtree(os.path.join(base, "base"))
    lines = run_cli("preprocess_nyu", [
        "--config", default_config_path(NYU_B4), f"data_root={base}",
        f"data_preprocess_root={base}"], "raw_nyu_cli")
    scans, pre_s = cli_summary(lines, "preprocess_nyu")
    check(scans == n_raw == 2 * NYU_FRAMES,
          f"preprocess_nyu wrote {scans} of {n_raw} scans")
    t0 = time.perf_counter()
    for split in ("train", "test"):
        for i in range(NYU_FRAMES):
            name = f"NYU{i + 1:04d}_0000"
            origin, pose, rle = read_rle_bin(f"{base}/NYU{split}/{name}.bin")
            t11 = rle_decode_plain(rle, SEG_CLASS_MAP,
                                   math.prod(SCENE_SIZE)).reshape(SCENE_SIZE)
            with open(f"{base}/base/NYU{split}/{name}.pkl", "rb") as f:
                rec = pickle.load(f)
            check(np.array_equal(rec["target_1_4"], plain_pool(t11, 4))
                  and np.array_equal(rec["target_1_16"], plain_pool(t11, 16))
                  and np.array_equal(rec["cam_pose"], pose)
                  and np.array_equal(rec["voxel_origin"], origin),
                  f"NYU{split}/{name}: not the plain decode and pool")
    check_s = time.perf_counter() - t0
    cfg = load_config(default_config_path(NYU_B4), overrides=nyu_overrides(
        base, "raw_eval", batch_size_per_gpu=RAW_EVAL_BATCH))
    ev = raw_eval(cfg, "raw_nyu_eval", NYU_FRAMES)
    log("raw_nyu", gpu=repr(smi), scans=scans, preprocess_s=f"{pre_s:.3f}",
        preprocess_s_per_frame=f"{pre_s / scans:.4f}",
        check_s=f"{check_s:.2f}")
    return dict(ev, preprocess_s_per_frame=pre_s / scans, frames=scans)


def raw_tartanair(base: str, smi: str) -> dict:
    """28(d). TartanAir from raw files: a 10-frame 480x640 depth/seg
    sequence as the val sequence P005 of a full-size make_tartanair_tree
    tree whose labels are deleted, the export_voxels_tartanair CLI with 2
    workers (every 5th frame), target_1_1 held to the plain vote on the
    same unprojection, and one eval batch on the card."""
    import pickle

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.native_ext import (
        downsample_label_plain,
        voxel_vote_plain,
    )
    from occdepth_tpu_torch.scripts import export_voxels_tartanair as ex
    from occdepth_tpu_torch.testing import (
        make_tartanair_tree,
        write_tartanair_raw,
    )

    # images for frames 0-5, so the exported 000000 and 000005 have theirs
    make_tartanair_tree(base, grid=TA_GRID, voxel_size=TA_VOXEL, n_frames=6)
    shutil.rmtree(os.path.join(base, "ta_pre", "labels"))
    write_tartanair_raw(base, "P005", n_frames=RAW_TA_FRAMES)
    paths = ta_paths(base, "raw_eval")
    lines = run_cli("export_voxels_tartanair", [
        "--config", default_config_path(TA_CONFIG), "--workers", "2",
        "--sequences", "P005", *(f"{k}={v}" for k, v in paths.items())],
        "raw_ta_cli")
    frames, export_s = cli_summary(lines, "export_voxels_tartanair")
    check(frames == RAW_TA_FRAMES // 5, f"exported {frames} frames")
    seq_dir = os.path.join(base, "ta", "office", "Easy", "P005")
    poses = ex.read_center_poses(os.path.join(seq_dir, "pose_left.txt"))
    for i in range(0, RAW_TA_FRAMES, 5):
        depth = np.load(f"{seq_dir}/depth_left/{i:06d}_left_depth.npy")
        seg = np.load(f"{seq_dir}/seg_left/{i:06d}_left_seg.npy")
        vox_idx, cls = ex.depth_voxel_indices(depth, seg, poses[i])
        _, vcls = voxel_vote_plain(vox_idx, cls, ex.VOX_SHAPE,
                                   len(ex.TARTANAIR_CLASS_DICT))
        with open(f"{base}/ta_pre/labels/office/Easy/P005/voxels_left/"
                  f"{i:06d}.pkl", "rb") as f:
            rec = pickle.load(f)
        check(np.array_equal(rec["target_1_1"], vcls)
              and np.array_equal(rec["target_1_4"],
                                 downsample_label_plain(vcls, 4)),
              f"P005/{i:06d}: target_1_1 is not the plain vote")
        check(len(np.unique(vcls)) > 5, f"P005/{i:06d}: few classes")
    cfg = load_config(default_config_path(TA_CONFIG), overrides=dict(
        paths, batch_size_per_gpu=RAW_EVAL_BATCH))
    ev = raw_eval(cfg, "raw_ta_eval", RAW_TA_FRAMES // 5)
    log("raw_ta", gpu=repr(smi), frames=frames, export_s=f"{export_s:.3f}",
        export_s_per_frame=f"{export_s / frames:.4f}", workers=2)
    return dict(ev, export_s_per_frame=export_s / frames, frames=frames)


def phase_raw_data(smi: str) -> dict:
    """28. The raw-data path: (a) the native library, (b) KITTI, (c) NYU
    and (d) TartanAir from raw files through the port's preprocessing
    CLIs to a train step / an eval batch on the card, (e) bench_loader on
    (b)'s tree, native and plain histograms at workers 0 and 2."""
    import torch

    from occdepth_tpu_torch.scripts import bench_loader

    t_phase = time.perf_counter()
    res = {"native": raw_native()}
    bases = {k: tempfile.mkdtemp(prefix=f"occdepth_raw_{k}_")
             for k in ("kitti", "nyu", "ta")}
    try:
        res["kitti"] = raw_kitti(bases["kitti"], smi)
        res["nyu"] = raw_nyu(bases["nyu"], smi)
        res["tartanair"] = raw_tartanair(bases["ta"], smi)
        torch.cuda.empty_cache()
        step_ms = res["kitti"]["step_ms"][-1]
        cases = bench_loader.main([
            "--tree", bases["kitti"], "--n", str(RAW_LOADER_N),
            "--workers", "0,2", "--frustum", "native,plain",
            "--step-ms", f"{step_ms}"])
    finally:
        for b in bases.values():
            shutil.rmtree(b, ignore_errors=True)
    res["loader"] = {f"{c['frustum']}_w{c['workers']}": c["ms_per_sample"]
                     for c in cases}
    log("raw_loader", gpu=repr(smi), samples_per_case=RAW_LOADER_N,
        train_step_ms=f"{step_ms:.2f}",
        **{f"ms_per_sample_{k}": f"{v:.2f}"
           for k, v in res["loader"].items()},
        **{f"loader_per_step_{c['frustum']}_w{c['workers']}":
           f"{c['loader_per_step']:.3f}" for c in cases})
    check(len(cases) == 4 and all(c["ms_per_sample"] > 0 for c in cases),
          f"bench_loader cases {cases}")
    res["launches"] = {name: sum(res[k]["launches"][name]
                                 for k in ("kitti", "nyu", "tartanair"))
                       for name in kernel_counters()}
    res["seconds"] = time.perf_counter() - t_phase
    log("raw_phase", seconds=f"{res['seconds']:.1f}",
        **{f"{k}_launches": v for k, v in res["launches"].items()})
    return res


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.nyu import NYUDataset
    from occdepth_tpu_torch.data.tartanair import TartanAirDataset
    from occdepth_tpu_torch import native_ext
    from occdepth_tpu_torch.ops import cuda_lib
    from occdepth_tpu_torch.scripts.profile_serve_stages import (
        serving_setup,
        stage_events,
        stage_ms,
    )
    from occdepth_tpu_torch.testing import (
        make_nyu_tree,
        make_tartanair_tree,
        nyu_fov_share,
        tartanair_fov_share,
    )

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = gpu_line()
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        gpu=repr(smi), count=torch.cuda.device_count())

    # ---- 2. kernel build ----
    lib_path, build_s = cuda_lib.build()
    cuda_lib.library()
    log("build", seconds=f"{build_s:.2f}",
        cached=build_s == 0.0, library=lib_path)
    native_path, native_s = native_ext.build()
    log("build_native", seconds=f"{native_s:.2f}", cached=native_s == 0.0,
        library=native_path)
    phase_selftest(dev)

    # ---- 3, 3b, 4. K1, the fused lift and K2 at the main path's shapes ----
    cfg, pipe, calib = serving_setup(BATCH)
    k1 = phase_k1(dev)
    lift = phase_lift(dev, calib, cfg.img_shape)
    k2 = phase_k2(dev)

    # ---- 5. tiny configs: CUDA (kernels) vs CPU (plain versions) ----
    phase_tiny(dev)

    # ---- 6. main path: flagship KITTI stereo serving ----
    t0 = time.perf_counter()
    pipe.warmup()
    warm_s = time.perf_counter() - t0
    rs = np.random.RandomState(0)
    H, W = cfg.img_shape
    frames = [rs.randint(0, 256, size=(cfg.n_views, H, W, 3)).astype(np.uint8)
              for _ in range(N_FRAMES)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with stage_events(pipe.model) as events:
        start.record()
        preds = list(pipe.run(frames))
        end.record()
        end.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    stages = stage_ms(events)
    log("serve_stages", gpu=repr(smi), dispatches=len(events["sfa_lift"]),
        sfa_lift_ms_per_dispatch=f"{stages['sfa_lift']:.4f}",
        crp_ms_per_dispatch=f"{stages['crp']:.4f}",
        timed="median over the dispatches, CUDA events around sfa_lift "
              "and CPMegaVoxels.forward")
    dispatches = -(-N_FRAMES // BATCH)
    ms_frame = start.elapsed_time(end) / N_FRAMES
    peak = torch.cuda.max_memory_allocated()
    log("serve", frames=len(preds), dispatches=dispatches,
        shape=tuple(preds[0].shape) if preds else None,
        warmup_s=f"{warm_s:.2f}", ms_per_frame=f"{ms_frame:.2f}",
        fps=f"{N_FRAMES / wall_s:.3f}",
        peak_mem_gib=f"{peak / 2**30:.3f}",
        lift_launches=launches["flosp_stereo_lift"],
        k2_launches=launches["crp_relation_matmul"],
        k1_launches=launches["stereo_cosine_fuse"])
    check(len(preds) == N_FRAMES, f"{len(preds)} outputs for {N_FRAMES}")
    for p in preds:
        check(p.shape == tuple(cfg.full_scene_size) and p.dtype == np.uint8,
              f"output {p.shape} {p.dtype}")
        check(int(p.max()) < cfg.n_classes, f"class {int(p.max())}")
        check(np.unique(p).size > 1, "a served grid is constant")
    check(len({p.tobytes() for p in preds}) == N_FRAMES,
          "distinct frames gave identical grids")
    check(launches["flosp_stereo_lift"] == dispatches,
          f"fused lift launches {launches['flosp_stereo_lift']}")
    check(launches["stereo_cosine_fuse"] == 0,
          f"K1 launches {launches['stereo_cosine_fuse']}")
    check(launches["crp_relation_matmul"] == dispatches,
          f"K2 launches {launches['crp_relation_matmul']}")
    check(launches["dw_filter_grad"] == 0, "serving ran a backward")
    check(launches["conv3x3"] == 0, "serving at decoder_conv_impl=auto ran K3")

    # ---- 7-10. K4, autograd through K1/K2, tiny and flagship training ----
    k4 = phase_k4(dev)
    lift_bwd = phase_autograd(dev, calib, cfg.img_shape)
    phase_tiny_train(dev)
    train = phase_train(dev, smi)
    # ---- 11-12. K3 and the eval path ----
    k3 = phase_k3(dev)
    evaluation = phase_eval(dev, smi)
    # ---- 13-15. K6, K5 and the probe scripts ----
    k6 = phase_k6(dev)
    k5 = phase_k5(dev)
    probes = phase_probes()

    # ---- 16-19. TartanAir kernels, training and eval; occluded KITTI ----
    ta_base = tempfile.mkdtemp(prefix="occdepth_ta_")
    try:
        t0 = time.perf_counter()
        make_tartanair_tree(ta_base, grid=TA_GRID, voxel_size=TA_VOXEL,
                            n_frames=TA_FRAMES)
        log("ta_tree", grid=TA_GRID, frames_per_sequence=TA_FRAMES,
            seconds=f"{time.perf_counter() - t0:.1f}",
            both_views_fov_share=tartanair_fov_share(TA_GRID, TA_VOXEL))
        ta_cfg = load_config(default_config_path(TA_CONFIG),
                             overrides=ta_paths(ta_base, "data"))
        ta = phase_ta_kernels(dev, TartanAirDataset(ta_cfg, "val")[0])
        ta_train = phase_ta_train(dev, smi, ta_base)
        ta_eval = phase_ta_eval(dev, smi, ta_base)
    finally:
        shutil.rmtree(ta_base, ignore_errors=True)
    occluded = phase_occluded(dev, smi)
    # ---- 23. the shipped KITTI configs no other phase trains ----
    configs = phase_kitti_configs(dev, smi)

    # ---- 20-22, 25. NYU kernels, training, eval and outputs ----
    nyu_base = tempfile.mkdtemp(prefix="occdepth_nyu_")
    try:
        t0 = time.perf_counter()
        make_nyu_tree(nyu_base, n_frames=NYU_FRAMES)
        log("nyu_tree", grid=NYU_GRID, frames_per_split=NYU_FRAMES,
            seconds=f"{time.perf_counter() - t0:.1f}",
            both_views_fov_share=nyu_fov_share())
        nyu_cfg = load_config(default_config_path(NYU_B4),
                              overrides=nyu_overrides(nyu_base, "data"))
        nyu = phase_nyu_kernels(dev, NYUDataset(nyu_cfg, "test")[0])
        nyu_train = phase_nyu_train(dev, smi, nyu_base,
                                    nyu["k4"]["n_convs"],
                                    nyu["k4_b7"]["n_convs"])
        nyu_eval = phase_nyu_eval(dev, smi, nyu_base)
        nyu_outputs = phase_nyu_outputs(dev, smi, nyu_base)
    finally:
        shutil.rmtree(nyu_base, ignore_errors=True)

    # ---- 24, 26. the output CLIs and export at full width ----
    outputs = phase_outputs(dev, smi)
    exported = phase_export(dev, smi)
    # ---- 27. data parallel: DDP world 1, two gloo ranks, the tools ----
    parallel = phase_ddp(dev, smi)
    # ---- 28. the raw-data path: native library, preprocessing, loader ----
    raw = phase_raw_data(smi)

    def by_path(name):
        paths = {"serve": launches[name], "train": train["launches"][name],
                 "eval": evaluation["launches"][name],
                 "probe": probes["launches"].get(name, 0),
                 "ta_train": ta_train["launches"][name],
                 "ta_eval": ta_eval["launches"][name],
                 "occluded_train": occluded["launches"][name],
                 "nyu_train": nyu_train["launches"][name],
                 "nyu_b7": nyu_train["b7"]["launches"][name],
                 "nyu_eval": nyu_eval["launches"][name],
                 **{tag: configs[tag]["launches"][name]
                    for _, tag, _ in KITTI_CONFIGS},
                 "infer": sum(outputs["launches"][t][name]
                              for t in ("infer_auto", "infer_pallas")),
                 "outputs": sum(outputs["launches"][t][name]
                                for t in ("generate_output", "submission"))
                 + nyu_outputs["launches"][name],
                 "export": exported["launches"][name],
                 "ddp": parallel["launches"][name],
                 "raw_data": raw["launches"][name]}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    def at_ta(r, keys=("max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by")):
        return {k: r[k] for k in keys if k in r}

    print(json.dumps({"kernels": [
        {"name": "stereo_cosine_fuse", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/stereo_fuse.cu",
         "replaces": "occdepth_tpu/ops/pallas_kernels.py:118",
         **by_path("stereo_cosine_fuse"),
         **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
         "library_ms": None,
         "timed": "standalone, 2 x 262,144 rows x 32 fp32, CUDA-graph "
                  "replays; the model's paths run it fused (flosp_stereo_lift)"},
        {"name": "flosp_stereo_lift", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/stereo_fuse.cu",
         "replaces": "occdepth_tpu/ops/pallas_kernels.py:118, "
                     "occdepth_tpu/ops/flosp_gather.py:48, "
                     "occdepth_tpu/models/sfa.py:23",
         **by_path("flosp_stereo_lift"),
         **{k: lift[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "yardstick_ms")},
         "ms_channels_last": lift["channels_last"],
         "library_ms": None,
         "tartanair": dict(at_ta(ta["lift"]), **{
             k: ta["lift"][k] for k in ("yardstick_ms", "fwd_ms_events",
                                        "fwd_bwd_ms_events", "fov_share")},
             shape="batch 1, 691,200 voxels, C=32, bf16 NCHW maps of a "
                   "480x640 image, the tree's rig"),
         "nyu": {name: dict(at_ta(r), **{
             k: r[k] for k in ("yardstick_ms", "fwd_ms_events",
                               "fwd_bwd_ms_events", "fov_share")},
             shape=f"batch 1, 129,600 voxels, C={c}, bf16 NCHW maps of a "
                   "480x640 image and its virtual view, the tree's rig")
             for name, r, c in (("b4", nyu["lift"], 100),
                                ("b7", nyu["lift_b7"], 200))},
         "kitti_highcap": dict(at_ta(configs["lift_highcap"]), **{
             k: configs["lift_highcap"][k] for k in (
                 "yardstick_ms", "fwd_ms_events", "fwd_bwd_ms_events",
                 "fov_share")},
             shape="batch 1, 262,144 voxels, C=64, bf16 NCHW maps of a "
                   "370x1220 image, the highcap configs' rig"),
         "timed": "serving shape: batch 2, 262,144 voxels, C=32, bf16 NCHW "
                  "maps (their channels-last copies timed), the rig's "
                  "projection, P=1; yardstick: per-scale index_select + K1"},
        {"name": "flosp_stereo_lift_backward", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/stereo_fuse.cu",
         "replaces": "no TPU kernel: XLA's VJP of occdepth_tpu/models/sfa.py"
                     ":23 (the scatter-add of jnp.take in occdepth_tpu/ops/"
                     "flosp_gather.py:48 and the fusion's jnp formula)",
         **by_path("flosp_stereo_lift_backward"),
         **{k: lift_bwd[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "bitwise")},
         "library_ms": None,
         "tartanair": at_ta(ta["lift"]["backward"], (
             "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "bitwise")),
         "nyu": {name: at_ta(r["backward"], (
             "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "bitwise")) for name, r in (("b4", nyu["lift"]),
                                         ("b7", nyu["lift_b7"]))},
         "kitti_highcap": at_ta(configs["lift_highcap"]["backward"], (
             "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "bitwise")),
         "timed": "train shape: batch 1, 262,144 voxels, C=32, bf16 NCHW "
                  "maps of a 370x1220 image, the rig's projection, P=1; "
                  "max_rel_err: x max(1, max|ref|) per map"},
        {"name": "crp_relation_matmul", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/crp_matmul.cu",
         "replaces": "occdepth_tpu/ops/pallas_kernels.py:61",
         **by_path("crp_relation_matmul"),
         "max_abs_err": max(t["max_abs_err"] for t in k2.values()),
         **{k: k2["bfloat16"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
         "fp32": k2["float32"],
         "tartanair": {name: dict(at_ta(r), **{
             k: r[k] for k in ("kernel", "simt_ms", "library_ms") if k in r})
             for name, r in ta["k2"].items()},
         "nyu": {f"{cfg_name}_{name}": dict(at_ta(r), **{
             k: r[k] for k in ("kernel", "simt_ms", "library_ms") if k in r},
             shape=f"(1,4,2025,196)@(1,196,{c}), logits and mega padded")
             for cfg_name, res_k2, c in (("b4", nyu["k2"], 800),
                                         ("b7", nyu["k2_b7"], 1600))
             for name, r in res_k2.items()},
         "kitti_highcap": {name: dict(at_ta(r), **{
             k: r[k] for k in ("kernel", "simt_ms", "library_ms") if k in r},
             shape="(1,4,4096,512)@(1,512,512), the highcap configs' CRP")
             for name, r in configs["k2_highcap"].items()},
         "timed": "the four relations at batch 2 in one call, (4096,512)@"
                  "(512,256) each, bf16 (wgmma); fp32 (3xTF32 wgmma) "
                  "beside; simt_ms: the SIMT kernel on the same operands"},
        {"name": "dw_filter_grad", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/dw_filter_grad.cu",
         "replaces": "occdepth_tpu/ops/dw_conv.py:99",
         **by_path("dw_filter_grad"),
         "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"], "bound_share": k4["bound_share"],
         "tartanair": dict(at_ta(ta["k4"]), library_ms=ta["k4"]["library_ms"],
                           n_convs=ta["k4"]["n_convs"],
                           shape="the b3 encoder's stride-1 dw convs on a "
                                 "480x640 image, bf16, batch 1"),
         "nyu": {name: dict(at_ta(r), library_ms=r["library_ms"],
                            n_convs=r["n_convs"],
                            shape=f"the {name} encoder's stride-1 dw convs on "
                                  "a 480x640 image, bf16, batch 1")
                 for name, r in (("b4", nyu["k4"]), ("b7", nyu["k4_b7"]))},
         "kitti_b7": dict(at_ta(configs["k4_b7"]),
                          library_ms=configs["k4_b7"]["library_ms"],
                          n_convs=configs["k4_b7"]["n_convs"],
                          bound_share=configs["k4_b7"]["bound_share"],
                          shape="the b7 encoder's stride-1 dw convs on a "
                                "370x1220 image, bf16, batch 1"),
         "timed": f"sum over the {k4['n_convs']} stride-1 depthwise convs "
                  "of one flagship view, bf16, batch 1"},
        {"name": "conv3x3", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/conv3x3.cu",
         "replaces": "occdepth_tpu/ops/conv2d_shift.py:102, "
                     "occdepth_tpu/ops/conv2d_shift.py:251",
         **by_path("conv3x3"),
         "max_abs_err": max(t["max_abs_err"] for t in k3.values()),
         "ms": k3["bfloat16"]["ms"], "plain_ms": k3["bfloat16"]["plain_ms"],
         "bound_ms": k3["bfloat16"]["bound_ms"],
         "bound_by": k3["bfloat16"]["bound_by"],
         "library_ms": k3["bfloat16"]["library_ms"],
         "bound_share": k3["bfloat16"]["bound_share"],
         "fp32": {k: v for k, v in k3["float32"].items()},
         "tartanair": {name: dict(at_ta(r), library_ms=r["library_ms"],
                                  bound_share=r["bound_share"])
                       for name, r in ta["k3"].items()},
         "nyu": {name: dict(at_ta(r), library_ms=r["library_ms"],
                            bound_share=r["bound_share"],
                            shape="the b4 decoder's ten 3x3 convs (100 "
                                  "channels out) on a 480x640 frame, 2 images")
                 for name, r in nyu["k3"].items()},
         "timed": "sum over the flagship decoder's ten 3x3 convs at batch 2 "
                  "images (one eval frame), bf16; fp32 (3xTF32 wgmma; "
                  "cuDNN with TF32 off) beside",
         "fullres_fp32_forward": evaluation["fullres"]},
        {"name": "row_gather", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/row_gather.cu",
         "replaces": "occdepth_tpu/scripts/bench_gather.py:111",
         **by_path("row_gather"),
         "max_abs_err": max(t["max_abs_err"] for t in k6.values()),
         **{k: k6["bfloat16"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
         "fp32": k6["float32"],
         "timed": "sum over bench_gather's five table shapes, 262,144 int32 "
                  "indices each, in turns over 4 variants, bf16; fp32 "
                  "beside; library: torch.index_select"},
        {"name": "matmul_probe", "route": "cuda",
         "source": "occdepth_tpu_torch/csrc/matmul_probe.cu",
         "replaces": "occdepth_tpu/scripts/bench_head_pallas.py:55",
         **by_path("matmul_probe"),
         **{k: k5[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "bound_share")},
         "timed": "sum over bench_head_pallas's three probes at one "
                  "conv-equivalent each, bf16; library: torch.matmul of p "
                  "expanded over the steps"},
    ]}))
    log("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
