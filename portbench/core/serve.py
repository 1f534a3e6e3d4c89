"""The serve mixes: the program's `ServingPipeline.run` in a closed loop.

Mix parameters (`portbench/mixes/<mix>.json`, kind "serve"): batch_size
and max_in_flight of the pipeline, pool_frames distinct seeded uint8 rig
frames cycled through the window, check_frames served frames sampled from
the seed for the comparison with the reference, trace_frames frames in
the profiled stretch.

The window hands frames to `run` as fast as it takes them (a closed loop:
the pipeline pulls the next frame when it has room), timing each frame
from the moment it is handed over to the moment its grid is yielded.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from portbench.core import check, inputs, program, roofline, trace

LIFT_FWD_OPS = ("occdepth::flosp_stereo_lift", "occdepth::pack_map")


class Serve:
    def __init__(self, spec: dict, mix: dict, seed: int, device):
        self.spec, self.mix, self.seed = spec, mix, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from occdepth_tpu_torch.serving.pipeline import ServingPipeline

        mix = self.mix
        self.rig = inputs.Rig(self.spec)
        cfg, model, self.shapes = program.program_model(
            self.spec, self.seed, self.device)
        self.pipe = ServingPipeline(
            cfg, model, self.rig.calib(1), batch_size=mix["batch_size"],
            max_in_flight=mix["max_in_flight"], device=self.device)
        pool = inputs.frames_u8(self.rig, mix["pool_frames"], self.seed,
                                self.device).cpu().numpy()
        self.pool = [pool[i] for i in range(len(pool))]
        # every shape the window uses: full batches, the in-flight queue
        # full, its drain
        n = mix["batch_size"] * (mix["max_in_flight"] + 1)
        for _ in self.pipe.run(self.pool[i % len(self.pool)]
                               for i in range(n)):
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, spans: bool = False) -> dict:
        """Frames through `run` for `seconds`; returns the end-to-end
        numbers and what the check and the per-layer readers need."""
        pool, P = self.pool, len(self.pool)
        handed, done, grids = [], [], []
        t_end = [math.inf]

        def source():
            i = 0
            while time.perf_counter() < t_end[0]:
                handed.append(time.perf_counter())
                yield pool[i % P]
                i += 1

        host = []
        if spans:  # host ms of each dispatch: upload + enqueue
            up, serve = self.pipe._upload, self.pipe._serve
            starts = []

            def timed_upload(frames):
                starts.append(time.perf_counter())
                return up(frames)

            def timed_serve(x):
                out = serve(x)
                host.append(time.perf_counter() - starts[-1])
                return out

            self.pipe._upload, self.pipe._serve = timed_upload, timed_serve
        try:
            t0 = time.perf_counter()
            t_end[0] = t0 + seconds
            for g in self.pipe.run(source()):
                done.append(time.perf_counter())
                grids.append(g)
        finally:
            if spans:
                del self.pipe._upload, self.pipe._serve
        close = t_end[0]
        lat = np.array([d - h for h, d in zip(handed, done)]) * 1e3
        B = self.mix["batch_size"]
        in_window = sum(1 for d in done if d <= close)
        return {
            "e2e": {
                "frames_per_s": in_window / (close - t0),
                "latency_p90_ms": float(np.percentile(lat, 90))
                if len(lat) else None,
            },
            "attempted": len(handed),
            "failed": len(handed) - len(done),
            "grids": grids,
            "units": in_window,
            "seconds": close - t0,
            "dispatch_host_ms": [h * 1e3 for h in host],
            "batch_done_ms": [round((d - t0) * 1e3, 3)
                              for d in done[B - 1::B]],
        }

    def profile(self) -> trace.Stretch:
        n = self.mix["trace_frames"]
        frames = [self.pool[i % len(self.pool)] for i in range(n)]

        def run():
            for _ in self.pipe.run(frames):
                pass
            return n

        return trace.profiled(run, LIFT_FWD_OPS)

    def lift_bytes(self) -> dict:
        c = self.spec["config"]
        pix, fov, _ = self.rig.projection(c["project_scale"])
        item = 2 if c["compute_dtype"] == "bfloat16" else 4
        return {"lift_fwd_bytes_per_call": roofline.lift_bytes(
            pix, fov, roofline.project_scales(c),
            self.spec["derived"]["img_shape"],
            c["feature_2d_oc"], item, self.mix["batch_size"]),
            "lift_calls_per_unit": 1.0 / self.mix["batch_size"]}

    def release(self) -> None:
        del self.pipe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, n_served: int) -> list:
        """The served frames the check compares, drawn from the seed,
        ordered by pool frame."""
        rng = np.random.default_rng([self.seed % 2**63, 7])
        k = min(self.mix["check_frames"], n_served)
        return sorted((int(i) for i in rng.choice(n_served, size=k,
                                                  replace=False)),
                      key=lambda i: (i % len(self.pool), i))

    def reference_logits(self, frames, count_flops: bool = False,
                         mode=None):
        """Yields (frame index, the reference's (X, Y, Z, C) logits, the
        class grid of the reference computed in bfloat16) for each pool
        index in `frames`, in order, computed once per pool frame: float32
        with TF32 off (under `mode` instead, if given; `lowp.bfloat16` for
        the grid).  Counts one frame's FLOPs into `self.ref_flops` when
        asked."""
        from portbench.core import lowp
        from portbench.reference.model import float32_exact

        ref = program.reference_model(self.spec, self.shapes, self.seed,
                                      self.device).eval()
        calib = {key: torch.from_numpy(v).to(self.device)
                 for key, v in self.rig.calib(1).items()}
        self.ref_flops = None
        logits, rounded, at = None, None, None
        with float32_exact(), torch.no_grad():
            for i in frames:
                p = i % len(self.pool)
                if p != at:
                    logits = None
                    img = inputs.normalize(
                        torch.from_numpy(self.pool[p])[None].to(self.device))
                    batch = dict(calib, img=img)
                    if count_flops and self.ref_flops is None:
                        self.ref_flops = roofline.counted_flops(
                            lambda: ref(batch))
                    with mode or contextlib.nullcontext():
                        logits = ref(batch)["ssc_logit"][0]
                    with lowp.bfloat16():
                        rounded = ref(batch)["ssc_logit"][0].argmax(-1)
                    at = p
                yield i, logits, rounded

    def check(self, out: dict, count_flops: bool = False) -> dict:
        """The reference over a seeded sample of the served frames: the
        served classes' deficit over the bfloat16 reference's."""
        grids = out["grids"]
        frames = self.sample(len(grids))
        numbers, info = deficit_ratio(self.reference_logits(
            frames, count_flops), {i: grids[i] for i in frames},
            self.device)
        return {"numbers": numbers, "info": info,
                "flops_per_unit": self.ref_flops}

def deficit_ratio(refs, grids: dict, device) -> tuple:
    """served_gap: the summed deficit of `grids` ({frame: class grid})
    under the reference over that of the bfloat16 reference's grids;
    `refs` yields (frame, logits, bfloat16 grid) for each frame."""
    total, rounded_total, widest, flips = 0.0, 0.0, [], []
    for i, logits, rounded in refs:
        g = grids[i]
        g = (g if isinstance(g, torch.Tensor)
             else torch.from_numpy(np.asarray(g))).to(device)
        d, w = check.deficit(logits, g)
        total += d
        rounded_total += check.deficit(logits, rounded)[0]
        widest.append(w)
        flips.append(float((logits.argmax(-1) != g.long()).float().mean()))
    numbers = {"served_gap": check.scaled(total, rounded_total)}
    info = {"frames_checked": len(widest), "deficit": total,
            "bf16_reference_deficit": rounded_total,
            "widest_logit_gap_each": widest,
            "argmax_differs_share_max": max(flips) if flips else None}
    return numbers, info


Runner = Serve
