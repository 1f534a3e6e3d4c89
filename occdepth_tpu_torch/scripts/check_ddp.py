"""Hold data-parallel training and evaluation on N ranks to their
one-process emulation.

    python -m occdepth_tpu_torch.scripts.check_ddp --out DIR \\
        [--device cpu | cuda | cuda:0] [--backend gloo] [--nproc 2]

The command starts itself under `torchrun --standalone --nproc_per_node N`
(the ranks, which write `DIR/rank<r>.pt`), computes the emulation in this
process meanwhile, then compares and prints one JSON summary; it exits 1
when a check fails.  `--device cuda:0 --backend gloo` runs every rank on
one card (NCCL refuses two ranks on one GPU).

Data parallelism follows the reference's Lightning DDP: each rank computes
the losses of its own rows, BatchNorm normalises over the global batch
(`sync_batchnorm=True`) and DDP averages the gradients.  Its exact
one-process form, the emulation, is a forward of the global batch (BN over
all its rows) followed by the mean over the ranks' row shards of each
shard's losses.  At the tiny KITTI config (fp32, `dw_conv_grad=pallas`,
seeded random weights, a seeded global batch of one row per rank):

  bn       a port BatchNorm3d alone on N x 2 rows of (8, 4, 4, 4): output,
           input gradient, the sum of the ranks' weight and bias gradients
           and the running statistics against one BN over all rows, within
           BN_RTOL of each tensor's norm;
  running  gradients and loss terms of one forward/backward with BN on its
           running statistics (`testing.freeze_batchnorm`): the network is
           well conditioned, every leaf within RUNNING_RTOL of its norm;
  batch    the same with BN on (global) batch statistics: chaotic in fp32 at
           this size, so a leaf passes within GRAD_RTOL of its norm or
           NOISE_MULT times the emulation's own change under a 1e-7 weight
           perturbation (`testing.noise_aware_worst`);
  accum2   `train_step` over K = 2 microbatches (the first backward under
           `no_sync`), BN frozen: the clipped gradients within RUNNING_RTOL;
  fit      the Trainer: `validate` of its initial weights over 2N - 1
           samples (the last global batch padded), whose confusion counts
           equal a one-process `validate`'s except at voxels whose two
           best logits lie within TIE_MARGIN; then `fit` for 2 steps on 2N
           samples: parameters and running statistics equal on every
           rank, metrics.jsonl written once per step.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.data.kitti import Loader
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.models.layers import BatchNorm3d
from occdepth_tpu_torch.parallel import ddp
from occdepth_tpu_torch.testing import (
    freeze_batchnorm,
    noise_aware_worst,
    perturbed_copy,
    randomize_weights,
    synthetic_dataset,
    tiny_kitti_config,
)
from occdepth_tpu_torch.training.optim import make_optimizer
from occdepth_tpu_torch.training.step import (
    apply_update,
    compute_losses,
    train_step,
)

BN_RTOL = 1e-6  # fp32 one-pass global sums vs batch_norm's own reduction
RUNNING_RTOL = 1e-5  # x each leaf's norm: the sum of N ranks' gradients
GRAD_RTOL = 1e-3  # batch statistics: x each leaf's norm where it holds,
NOISE_MULT = 4.0  # else x the emulation's own 1e-7-perturbation change
N_PERTURB = 3
TIE_MARGIN = 1e-4  # logits: top-2 gap under which an argmax may flip
WEIGHT_SEED, BATCH_SEED, ACCUM_SEED, FIT_SEED = 21, 30, 40, 50
LR = 2e-4
KERNELS = ("flosp_stereo_lift", "flosp_stereo_lift_backward",
           "crp_relation_matmul", "dw_filter_grad")
JAX_SIDE = ("jax", "jaxlib", "flax", "optax", "occdepth_tpu")


def check_config(**overrides) -> OccDepthConfig:
    return tiny_kitti_config(dw_conv_grad="pallas", **overrides)


def to_tensors(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def global_batch(cfg, world: int, seed: int, device):
    return to_tensors(make_synthetic_batch(cfg, world, seed,
                                           with_labels=True), device)


def bn_case_inputs(world: int, device):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2 * world, 8, 4, 4, 4, generator=g) * 2.0 + 0.5
    cot = torch.randn(x.shape, generator=g)
    bn = BatchNorm3d(8, momentum=0.1)
    randomize_weights(bn, seed=4)
    return x.to(device), cot.to(device), bn.to(device)


def bn_case(x, cot, bn) -> dict:
    x = x.clone().requires_grad_(True)
    y = bn.train()(x)
    (y * cot).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def seeded_model(cfg, device):
    return randomize_weights(OccDepthModel(cfg), WEIGHT_SEED).to(device)


def fresh_copy(model, frozen_bn: bool):
    model = copy.deepcopy(model)
    return freeze_batchnorm(model) if frozen_bn else model


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def float_logs(logs) -> dict:
    return {k: float(v.detach()) for k, v in logs.items()}


def emulated_losses(cfg, out, batch, world: int, progress: float = 0.0):
    """The mean over the ranks' row shards of each shard's losses, and
    each shard's loss terms."""
    shards = [compute_losses(cfg, ddp.rank_rows(out, r, world),
                             ddp.rank_rows(batch, r, world), progress)
              for r in range(world)]
    loss = sum(s[0] for s in shards) / world
    return loss, [float_logs(s[1]) for s in shards]


def emulated_grads(cfg, model, batch, world: int):
    model.train()
    model.zero_grad(set_to_none=True)
    loss, logs = emulated_losses(cfg, model(batch), batch, world)
    loss.backward()
    return grads_of(model), logs


def emulated_accum(cfg, model, first_grads: dict, second, world: int):
    """train_step's clipped gradients over two microbatches, the first
    one's emulated gradients given."""
    g2, _ = emulated_grads(cfg, model, second, world)
    for n, p in model.named_parameters():
        if n in first_grads:
            p.grad = first_grads[n] / 2 + g2[n] / 2
    apply_update(cfg, make_optimizer(model.parameters(), cfg), LR)
    return grads_of(model)


# ---------------------------------------------------------------- ranks --

def launch_counts() -> dict:
    from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul
    from occdepth_tpu_torch.ops.dw_conv import dw_filter_grad
    from occdepth_tpu_torch.ops.flosp_gather import (
        flosp_stereo_lift,
        flosp_stereo_lift_backward,
    )

    fns = dict(zip(KERNELS, (flosp_stereo_lift, flosp_stereo_lift_backward,
                             crp_relation_matmul, dw_filter_grad)))
    counts = {k: fn.launches for k, fn in fns.items()}
    counts["dw_filter_grad_copies"] = dw_filter_grad.copies
    return counts


def run_rank(args) -> None:
    dev = ddp.init_from_env(args.device, args.backend)
    rank, world = ddp.rank(), ddp.world()
    cfg = check_config()
    res = {"rank": rank, "world": world, "device": str(dev)}

    x, cot, bn = bn_case_inputs(world, dev)
    res["bn"] = bn_case(ddp.rank_rows({"x": x}, rank, world)["x"],
                        ddp.rank_rows({"c": cot}, rank, world)["c"], bn)

    batch = global_batch(cfg, world, BATCH_SEED, dev)
    mine = ddp.rank_rows(batch, rank, world)
    model = seeded_model(cfg, dev)
    for case, frozen in (("running", True), ("batch", False)):
        net = ddp.wrap(fresh_copy(model, frozen), dev)
        net.train()
        loss, logs = compute_losses(cfg, net(mine), mine, 0.0)
        loss.backward()
        res[case] = {"grads": grads_of(net.module), "logs": float_logs(logs)}
        del net

    micro = [mine, ddp.rank_rows(global_batch(cfg, world, ACCUM_SEED, dev),
                                 rank, world)]
    net = ddp.wrap(fresh_copy(model, frozen_bn=True), dev)
    opt = make_optimizer(net.parameters(), cfg)
    train_step(cfg, net, opt, micro, 0.0, LR)
    res["accum2"] = {"grads": grads_of(net.module)}
    del net, opt

    res["fit"] = run_fit(args.out, dev)
    res["jax_side"] = sorted(m for m, mod in sys.modules.items()
                             if mod is not None
                             and m.split(".")[0] in JAX_SIDE)
    torch.save(res, os.path.join(args.out, f"rank{rank}.pt"))
    ddp.shutdown()


def fit_config() -> OccDepthConfig:
    return check_config(batch_size_per_gpu=1, log_every_n_steps=1,
                        max_epochs=1)


def fit_data(cfg, world: int):
    """(2N train samples, 2N - 1 val samples: the last global batch of
    the validation is padded)."""
    return (synthetic_dataset(cfg, 2 * world, seed=FIT_SEED),
            synthetic_dataset(cfg, 2 * world - 1, seed=FIT_SEED + 1))


def run_fit(out: str, dev) -> dict:
    """Validate the Trainer's initial weights, then fit 2 steps."""
    from occdepth_tpu_torch.training import Trainer

    cfg = fit_config()
    trainer = Trainer(cfg, os.path.join(out, "fit"), device=dev)
    train_ds, val_ds = fit_data(cfg, trainer.world)
    before = launch_counts()
    val = trainer.validate(Loader(val_ds, trainer.global_batch,
                                  shuffle=False, drop_last=False,
                                  num_workers=0, rank=trainer.rank,
                                  world=trainer.world))
    trainer.fit(train_ds, val_ds, max_steps=2)
    after = launch_counts()
    state = {k: v.detach().cpu() for k, v in
             trainer.model.state_dict().items()}
    return {"step": trainer.step, "state": state,
            "completion": val["completion"], "conf": val["conf"],
            "n_frames": val["n_frames"], "metrics": trainer.metrics_logger.path,
            "launches": {k: after[k] - before[k] for k in after},
            "n_dw": sum(1 for m in trainer.model.modules()
                        if getattr(m, "fast_grad", False))}


# --------------------------------------------------------------- parent --

def max_rel(ours: dict, ref: dict) -> tuple:
    """(worst |ours - ref| / |ref| over the named tensors, its name)."""
    worst = (0.0, "")
    for name, r in ref.items():
        r = torch.as_tensor(r).double().cpu()
        err = float(torch.linalg.vector_norm(
            torch.as_tensor(ours[name]).double().cpu() - r))
        worst = max(worst, (err / max(float(torch.linalg.vector_norm(r)),
                                      1e-12), name))
    return worst


def near_ties(logits: torch.Tensor, margin: float) -> int:
    top2 = logits.float().topk(2, dim=-1).values
    return int(((top2[..., 0] - top2[..., 1]) < margin).sum())


def compare(ranks: list, emu: dict, device) -> dict:
    world = len(ranks)
    rep = {"world": world, "device": str(device)}

    # bn: one BN over the concatenated batch
    ref = emu["bn"]
    ours = {k: torch.cat([r["bn"][k].cpu() for r in ranks])
            for k in ("y", "x_grad")}
    for k in ("weight_grad", "bias_grad"):
        ours[k] = sum(r["bn"][k].cpu() for r in ranks)
    stats = ("running_mean", "running_var")
    stats_spread = max(max_rel({k: r["bn"][k] for k in stats},
                               {k: ranks[0]["bn"][k] for k in stats})[0]
                       for r in ranks)
    for k in stats:
        ours[k] = ranks[0]["bn"][k]
    err, name = max_rel(ours, ref)
    rep["bn"] = {"max_rel": err, "worst": name, "bound": BN_RTOL,
                 "ok": err <= BN_RTOL and stats_spread <= BN_RTOL}

    # running: tight, every leaf and loss term
    ref_g, ref_logs = emu["running"]
    ours_g = {n: sum(r["running"]["grads"][n].cpu() for r in ranks) / world
              for n in ref_g}
    err, name = max_rel(ours_g, ref_g)
    loss_err = max(abs(r["running"]["logs"][k] - ref_logs[i][k])
                   / max(abs(ref_logs[i][k]), 1e-12)
                   for i, r in enumerate(ranks) for k in ref_logs[i])
    same_leaves = all(set(r["running"]["grads"]) == set(ref_g) for r in ranks)
    rep["running"] = {"max_rel": err, "worst": name, "loss_max_rel": loss_err,
                      "leaves": len(ref_g), "bound": RUNNING_RTOL,
                      "ok": same_leaves and err <= RUNNING_RTOL
                      and loss_err <= RUNNING_RTOL}

    # batch: noise-aware
    (ref_g, ref_logs), perturbed = emu["batch"], emu["batch_perturbed"]
    ours_g = {n: sum(r["batch"]["grads"][n].cpu() for r in ranks) / world
              for n in ref_g}
    worst = noise_aware_worst(ours_g, ref_g, [p[0] for p in perturbed],
                              GRAD_RTOL, NOISE_MULT)
    fixed = {n: GRAD_RTOL * float(torch.linalg.vector_norm(ref_g[n].double()))
             + 1e-6 for n in ref_g}
    noisy = sum(1 for _, n, e, _ in worst if e > fixed[n])
    loss_ok = True
    for i, r in enumerate(ranks):
        for k, v in ref_logs[i].items():
            noise = max(abs(v - p[1][i][k]) for p in perturbed)
            tol = max(RUNNING_RTOL * abs(v), NOISE_MULT * noise)
            loss_ok &= abs(r["batch"]["logs"][k] - v) <= tol
    rep["batch"] = {"worst_ratio": worst[0][0], "worst": worst[0][1],
                    "leaves": len(worst), "noise_only_leaves": noisy,
                    "loss_terms_ok": bool(loss_ok),
                    "ok": worst[0][0] <= 1.0 and bool(loss_ok)}

    # accum2: train_step's clipped gradients, BN frozen
    ref_g = emu["accum2"]
    err, name = max_rel(ranks[0]["accum2"]["grads"], ref_g)
    spread = max(max_rel(r["accum2"]["grads"], ranks[0]["accum2"]["grads"])[0]
                 for r in ranks)
    rep["accum2"] = {"max_rel": err, "worst": name, "rank_spread": spread,
                     "bound": RUNNING_RTOL,
                     "ok": err <= RUNNING_RTOL and spread == 0.0}

    # fit: ranks agree; metrics written once; validation as one process
    fits = [r["fit"] for r in ranks]
    state0 = fits[0]["state"]
    unequal = sorted({k for f in fits for k, v in f["state"].items()
                      if not torch.equal(v, state0[k])})
    with open(fits[0]["metrics"]) as f:
        recs = [json.loads(line) for line in f]
    train_steps = [r["step"] for r in recs if "train/loss" in r]
    one = emu["validation"]
    flips = int(np.abs(fits[0]["conf"] - one["conf"]).sum()) // 2
    comp_diff = int(np.abs(fits[0]["completion"] - one["completion"]).sum())
    if flips or comp_diff:
        one["near_ties"] = near_tie_count(one.pop("trainer"), device)
    rep["fit"] = {
        "steps": [f["step"] for f in fits], "unequal_state": unequal[:10],
        "train_records": train_steps,
        "epoch_records": sum(1 for r in recs if "val/mIoU" in r),
        "n_frames": [f["n_frames"] for f in fits],
        "one_process_frames": one["n_frames"], "conf_flips": flips,
        "completion_diff": comp_diff, "near_ties": one["near_ties"],
        "tie_margin": TIE_MARGIN,
        "ranks_agree": [bool(np.array_equal(f["conf"], fits[0]["conf"]))
                        for f in fits],
        "launches": [f["launches"] for f in fits],
        "n_dw": fits[0]["n_dw"]}
    rep["fit"]["ok"] = (
        all(f["step"] == 2 for f in fits) and not unequal
        and train_steps == [1, 2] and rep["fit"]["epoch_records"] == 1
        and all(f["n_frames"] == one["n_frames"] == 2 * world - 1
                for f in fits)
        and all(rep["fit"]["ranks_agree"])
        and flips <= one["near_ties"] and comp_diff <= 2 * one["near_ties"])
    if device.type == "cuda":
        # per rank: the lift and K2 once per forward (2 steps, then fit's
        # validation and this check's, 2 global batches each), the lift's
        # backward kernel and K4 (once per stride-1 depthwise conv of view
        # 0) each step, no operand copied
        n_fwd = 2 + 2 * 2
        want = {"flosp_stereo_lift": n_fwd, "flosp_stereo_lift_backward": 2,
                "crp_relation_matmul": n_fwd,
                "dw_filter_grad": 2 * fits[0]["n_dw"],
                "dw_filter_grad_copies": 0}
        rep["fit"]["launches_ok"] = all(f["launches"] == want for f in fits)
        rep["fit"]["ok"] &= rep["fit"]["launches_ok"]
    rep["jax_side"] = sorted({m for r in ranks for m in r["jax_side"]})
    rep["ok"] = all(rep[k]["ok"] for k in
                    ("bn", "running", "batch", "accum2", "fit")) and not (
        rep["jax_side"])
    return rep


def one_process_validation(out: str, world: int, device) -> dict:
    """`validate` of the Trainer's initial weights on one device at the
    global batch."""
    from occdepth_tpu_torch.training import Trainer

    cfg = dataclasses.replace(fit_config(), batch_size_per_gpu=world)
    trainer = Trainer(cfg, os.path.join(out, "one_process"), device=device)
    val_ds = fit_data(cfg, world)[1]
    stats = trainer.validate(Loader(val_ds, world, shuffle=False,
                                    drop_last=False, num_workers=0))
    return {"completion": stats["completion"], "conf": stats["conf"],
            "n_frames": stats["n_frames"], "near_ties": 0,
            "trainer": trainer}


def near_tie_count(trainer, device) -> int:
    """Voxels of the validation whose two best logits lie within
    TIE_MARGIN (where the ranks' and one process's argmax may differ)."""
    world = trainer.global_batch
    model = trainer.model.eval()
    ties = 0
    with torch.inference_mode():
        for sample in fit_data(trainer.cfg, world)[1]:
            b = to_tensors({k: v[None] for k, v in sample.items()}, device)
            ties += near_ties(model(b)["ssc_logit"], TIE_MARGIN)
    return ties


def emulate(world: int, out: str, device) -> dict:
    cfg = check_config()
    emu = {"bn": bn_case(*bn_case_inputs(world, device))}
    batch = global_batch(cfg, world, BATCH_SEED, device)
    seeded = seeded_model(cfg, device)
    emu["running"] = emulated_grads(cfg, fresh_copy(seeded, True), batch,
                                    world)
    model = fresh_copy(seeded, False)
    emu["batch"] = emulated_grads(cfg, model, batch, world)
    emu["batch_perturbed"] = [
        emulated_grads(cfg, perturbed_copy(model, s), batch, world)
        for s in range(N_PERTURB)]
    emu["accum2"] = emulated_accum(
        cfg, fresh_copy(seeded, True), emu["running"][0],
        global_batch(cfg, world, ACCUM_SEED, device), world)
    emu["validation"] = one_process_validation(out, world, device)
    return emu


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the ranks' results (a new temporary "
                         "one by default)")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda (cuda:LOCAL_RANK) or cuda:0 (all ranks "
                         "on one card); CUDA by default")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (NCCL on CUDA, gloo on the "
                         "CPU by default)")
    ap.add_argument("--nproc", type=int, default=2,
                    help="ranks; the global batch has one row per rank")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 on the card too
    torch.backends.cudnn.allow_tf32 = False
    if ddp.launched():
        run_rank(args)
        return {}
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("check_ddp: no CUDA device (pass --device cpu)")
    out = args.out or tempfile.mkdtemp(prefix="check_ddp_")
    os.makedirs(out, exist_ok=True)
    rank_args = ["--out", out] + (["--device", args.device]
                                  if args.device else []) + (
        ["--backend", args.backend] if args.backend else [])
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={args.nproc}", "-m",
         "occdepth_tpu_torch.scripts.check_ddp", *rank_args])
    try:
        emu = emulate(args.nproc, out, device)
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise SystemExit(f"check_ddp: the ranks exited with {rc}")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(args.nproc)]
    rep = compare(ranks, emu, device)
    print(json.dumps(rep))
    if not rep["ok"]:
        raise SystemExit(1)
    return rep


if __name__ == "__main__":
    main()
