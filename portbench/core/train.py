"""The train mixes: the program's `train_step` on device-resident batches.

Mix parameters (`portbench/mixes/<mix>.json`, kind "train"): batch_size
rows a step, pool_batches distinct seeded labelled batches made on the
device before the window and cycled through it, checked_steps first steps
that the reference follows, trace_steps steps in the profiled stretch.

Set-up builds one model and one optimizer and drives them through the
first `checked_steps` steps by the window's own call, on distinct batches;
the window then goes on with the same objects.  The loader is bypassed.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from portbench.core import check, inputs, program, roofline, trace

LIFT_BWD_OPS = ("occdepth::flosp_stereo_lift_backward",)
BETA1 = 0.9  # AdamW's first-moment decay: exp_avg after one step = 0.1 g


class Train:
    def __init__(self, spec: dict, mix: dict, seed: int, device):
        self.spec, self.mix, self.seed = spec, mix, seed
        self.device = torch.device(device)

    def _step(self, i: int):
        from occdepth_tpu_torch.training.step import train_step

        b = self.batches[i % len(self.batches)]
        return train_step(self.cfg, self.model, self.opt, [b], 0.0,
                          self.cfg.lr)

    def setup(self) -> None:
        from occdepth_tpu_torch.training.optim import make_optimizer

        mix = self.mix
        self.rig = inputs.Rig(self.spec)
        self.cfg, self.model, self.shapes = program.program_model(
            self.spec, self.seed, self.device)
        self.opt = make_optimizer(self.model.parameters(), self.cfg)
        self.batches = inputs.train_batches(
            self.spec, self.rig, mix["pool_batches"], mix["batch_size"],
            self.seed, self.device)
        init = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.losses, self.terms = [], []
        # the first step's forward as the model returns it inside
        # train_step: its class grid and relation logits (kept on the host)
        first = []
        hook = self.model.register_forward_hook(
            lambda m, args, out: first.append(first_outputs(out)))
        for i in range(mix["checked_steps"]):
            logs, _, _ = self._step(i)
            if i == 0:
                hook.remove()
                self.argmax, self.relations = first[0]
            self.losses.append(float(logs["loss"]))
            self.terms.append({k: float(v) for k, v in logs.items()})
            if i == 0:  # the first gradient, as the optimizer received it
                self.grad = {
                    n: (self.opt.state[p]["exp_avg"] / (1.0 - BETA1)).cpu()
                    if "exp_avg" in self.opt.state.get(p, {})
                    else torch.zeros(p.shape)
                    for n, p in self.model.named_parameters()}
                self.grad_norms = check.leaf_norms(self.grad)
        self.change_norms = check.leaf_norms({
            n: p.detach() - init[n] for n, p in self.model.named_parameters()})
        del init
        self.next = mix["checked_steps"]
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, spans: bool = False) -> dict:
        n = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        marks = [t0]
        while marks[-1] < t_end:
            self._step(self.next)
            self.next += 1
            n += 1
            marks.append(time.perf_counter())
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        close = time.perf_counter()
        return {"e2e": {"train_step_ms": (close - t0) * 1e3 / n},
                "attempted": n, "failed": 0, "units": n,
                "seconds": close - t0,
                "host_ms_each": [round((b - a) * 1e3, 3)
                                 for a, b in zip(marks, marks[1:])]}

    def profile(self) -> trace.Stretch:
        k = self.mix["trace_steps"]

        def run():
            for _ in range(k):
                self._step(self.next)
                self.next += 1
            return k

        return trace.profiled(run, LIFT_BWD_OPS)

    def lift_bytes(self) -> dict:
        c = self.spec["config"]
        pix, fov, _ = self.rig.projection(c["project_scale"])
        item = 2 if c["compute_dtype"] == "bfloat16" else 4
        return {"lift_bwd_bytes_per_call": roofline.lift_backward_bytes(
            pix, fov, roofline.project_scales(c),
            self.spec["derived"]["img_shape"],
            c["feature_2d_oc"], item, self.mix["batch_size"]),
            "lift_calls_per_unit": 1.0}

    def release(self) -> None:
        keep = self.batches[:self.mix["checked_steps"]]
        del self.model, self.opt, self.batches
        self.batches = keep
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, count_flops: bool = False, mode=None,
                        grids=()) -> dict:
        """The reference from the same weights through the checked steps
        on the same batches (float32, TF32 off; under `mode`, a torch
        function mode such as the float8 control, if given): each step's
        loss, the first gradient's and the change's norms by leaf, its
        first forward's class grid, and for each of `grids` (first-step
        class grids) its deficit under the first forward's logits over
        that of the bfloat16 reference's grid (`grid_gaps`)."""
        from portbench.reference.config import RefConfig
        from portbench.reference.losses import RefAdamW, compute_losses
        from portbench.reference.model import float32_exact

        rcfg = RefConfig(self.spec)
        ref = program.reference_model(self.spec, self.shapes, self.seed,
                                      self.device).train()
        named = list(ref.named_parameters())
        params = [p for _, p in named]
        init = [p.detach().clone() for p in params]
        opt = RefAdamW(params, rcfg.lr, rcfg.weight_decay,
                       rcfg.gradient_clip_val)
        losses, terms, flops, grad = [], [], None, None
        gaps, argmax, relations, first_grad = [], None, None, None
        with float32_exact(), (mode or contextlib.nullcontext()):
            for i in range(self.mix["checked_steps"]):
                b = self.batches[i]
                held = {}

                def fwd_bwd():
                    out = ref(b)
                    _, logs = compute_losses(rcfg, out, b)
                    held["logits"] = out["ssc_logit"].detach()[0]
                    held["relations"] = first_outputs(out)[1]
                    held["logs"] = {k: v.detach() for k, v in logs.items()}
                    held["grads"] = torch.autograd.grad(
                        logs["loss"], params, allow_unused=True)

                if i == 0 and count_flops:
                    flops = roofline.counted_flops(fwd_bwd)
                else:
                    fwd_bwd()
                logits = held.pop("logits")
                if i == 0:
                    argmax = logits.argmax(-1).to(torch.uint8)
                    relations = held.pop("relations")
                    if grids:  # before the update, from the same weights
                        gaps = grid_gaps(ref, b, logits, grids)
                del logits
                applied = opt.step(list(held["grads"]))
                losses.append(float(held["logs"]["loss"]))
                terms.append({k: float(v) for k, v in held["logs"].items()})
                if i == 0:
                    first_grad = {n: g.cpu() for (n, _), g in
                                  zip(named, applied)}
                    grad = check.leaf_norms(first_grad)
        change = check.leaf_norms(
            {n: p.detach() - p0 for (n, p), p0 in zip(named, init)})
        return {"losses": losses, "terms": terms, "grad_norms": grad,
                "change_norms": change, "flops": flops, "argmax": argmax,
                "logit_gaps": gaps, "relations": relations,
                "grad": first_grad}


    def program_steps(self) -> dict:
        return {"losses": self.losses, "terms": self.terms,
                "grad_norms": self.grad_norms,
                "change_norms": self.change_norms, "argmax": self.argmax,
                "relations": self.relations, "grad": self.grad}

    def check(self, out: dict, count_flops: bool = False) -> dict:
        ref = self.reference_steps(count_flops, grids=[self.argmax])
        numbers, info = compare_steps(self.program_steps(), ref)
        return {"numbers": numbers, "info": info,
                "flops_per_unit": ref["flops"]}


def first_outputs(out: dict) -> tuple:
    """A first forward's class grid (on the device) and its relation
    logits (float32, on the host; None without the CRP)."""
    p = out.get("P_logits")
    return (out["ssc_logit"].detach()[0].argmax(-1).to(torch.uint8),
            None if p is None else p.detach().float().cpu())


def grid_gaps(ref, batch, logits, grids) -> list:
    """Each first-step class grid's deficit under the reference's first
    forward's `logits`, over the deficit of the grid of the same forward
    computed in bfloat16 (`serve.deficit_ratio`)."""
    from portbench.core import lowp
    from portbench.core.serve import deficit_ratio

    with torch.no_grad(), lowp.bfloat16():
        rounded = ref(batch)["ssc_logit"][0].argmax(-1)
    return [deficit_ratio([(0, logits, rounded)], {0: g},
                          logits.device)[0]["served_gap"] for g in grids]


def compare_steps(prog: dict, ref: dict, grid: int = 0) -> tuple:
    """The compared numbers of two runs of the checked steps, and the
    readings recorded beside them; `grid` is the index of the first run's
    class grid among those the reference run was given."""
    keep = check.kept_leaves(ref["grad_norms"])
    grad = check.leaf_gaps(prog["grad_norms"], ref["grad_norms"], keep)
    change = check.leaf_gaps(prog["change_norms"], ref["change_norms"], keep)
    numbers = {"loss_gap": check.rel_gap(prog["losses"][0], ref["losses"][0]),
               "grad_gap": check.median_gap(grad),
               "change_gap": check.median_gap(change),
               "logit_gap": ref["logit_gaps"][grid]}
    info = {"losses": prog["losses"], "ref_losses": ref["losses"],
            "loss_gap_all_steps": max(check.rel_gap(p, r) for p, r in
                                      zip(prog["losses"], ref["losses"])),
            "grad_gap_worst_leaf": check.worst_gap(grad),
            "grad_diff": check.median_gap(check.leaf_gaps(
                check.leaf_norms({k: prog["grad"][k] - ref["grad"][k]
                                  for k in keep}),
                {k: 0.0 for k in keep}, keep, scale=ref["grad_norms"])),
            "relation_err": None if ref["relations"] is None else float(
                (prog["relations"] - ref["relations"]).double().norm()
                / ref["relations"].double().norm()),
            "change_gap_worst_leaf": check.worst_gap(change),
            "leaves_kept": len(keep), "leaves": len(ref["grad_norms"])}
    return numbers, info

Runner = Train
