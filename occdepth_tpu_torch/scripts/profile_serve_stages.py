"""Device time of the serving path's lift and CRP stages, per dispatch.

    python -m occdepth_tpu_torch.scripts.profile_serve_stages \\
        [--frames 10] [--batch 2] [--json]

Serves the flagship KITTI stereo config through `ServingPipeline` as
`chip_smoke.py` phase 6 does (b3, feature 32, 370x1220 stereo, 256x256x32
grid, bf16, `use_stereo_depth_gt=false`, seeded random weights, seeded
random uint8 frames) and brackets two stages of every dispatch with CUDA
events on the serving stream:
  * `sfa_lift`: the FLoSP lift of every scale with the Stereo-SFA fusion
    and the sum over scales (kernel K1 and the gathers around it);
  * the CRP block (`CPMegaVoxels.forward`): ASPP, the mega-context and
    relation-logit convs, the relation products (kernel K2), the resize.
Each stage's time is the device time between its two events, so it
includes any wait for the host's launches inside the stage.  It prints
the median over the timed dispatches (after one warm-up dispatch) and
ms/frame over the run; --json adds one JSON line.  It uses only entry
points the port has had since its first slice, so the same script times
an older tree (PYTHONPATH pointing at its checkout).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics

import numpy as np
import torch

FLAGSHIP = "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"


@contextlib.contextmanager
def stage_events(model):
    """Record (start, end) CUDA events around `sfa_lift` and the CRP block
    of every forward of `model`; yields {stage: [(start, end), ...]}."""
    from occdepth_tpu_torch.models import occdepth
    from occdepth_tpu_torch.models.crp3d import CPMegaVoxels

    events = {"sfa_lift": [], "crp": []}

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    lift = occdepth.sfa_lift

    def timed_lift(*args, **kwargs):
        start = record()
        out = lift(*args, **kwargs)
        events["sfa_lift"].append((start, record()))
        return out

    starts, hooks = [], []
    for m in model.modules():
        if isinstance(m, CPMegaVoxels):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: starts.append(record())))
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: events["crp"].append(
                    (starts.pop(), record()))))
    occdepth.sfa_lift = timed_lift
    try:
        yield events
    finally:
        occdepth.sfa_lift = lift
        for h in hooks:
            h.remove()


def stage_ms(events, skip: int = 0) -> dict:
    """{stage: median device ms over the recorded calls after `skip`}; call
    after a synchronise."""
    return {k: statistics.median(s.elapsed_time(e) for s, e in v[skip:])
            for k, v in events.items() if len(v) > skip}


def serving_setup(batch: int):
    """(cfg, pipeline, calibration batch) at the flagship serving config on
    CUDA."""
    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.serving import ServingPipeline
    from occdepth_tpu_torch.testing import randomize_weights

    cfg = load_config(default_config_path(FLAGSHIP), overrides={
        "use_stereo_depth_gt": False, "compute_dtype": "bfloat16",
        "use_pallas": True})
    model = randomize_weights(OccDepthModel(cfg), seed=0).to("cuda")
    calib = make_synthetic_batch(cfg, batch_size=1, seed=0)
    return cfg, ServingPipeline(cfg, model, calib, batch_size=batch,
                                max_in_flight=2), calib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve_stages: no CUDA device (a device "
                         "measurement; it has no CPU path)")
    from occdepth_tpu_torch.scripts.bench_timing import gpu_line

    cfg, pipe, _ = serving_setup(args.batch)
    pipe.warmup()
    rs = np.random.RandomState(0)
    H, W = cfg.img_shape
    frames = [rs.randint(0, 256, size=(cfg.n_views, H, W, 3)).astype(np.uint8)
              for _ in range(args.frames)]
    torch.cuda.synchronize()
    with stage_events(pipe.model) as events:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        n_out = len(list(pipe.run(frames)))
        end.record()
        end.synchronize()
    stages = stage_ms(events, skip=1)
    res = {"gpu": gpu_line(), "frames": n_out, "batch": args.batch,
           "dispatches": len(events["sfa_lift"]),
           "ms_per_frame": start.elapsed_time(end) / n_out,
           **{f"{k}_ms_per_dispatch": v for k, v in stages.items()}}
    for k, v in res.items():
        print(f"{k}: {v}")
    if args.json:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
