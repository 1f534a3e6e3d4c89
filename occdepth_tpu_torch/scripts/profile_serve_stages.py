"""Device time of the serving path's stages per dispatch, from the
program's spans.

    python -m occdepth_tpu_torch.scripts.profile_serve_stages \\
        [--frames 10] [--batch 2] [--json]

Serves the flagship KITTI stereo config through `ServingPipeline` as
`chip_smoke.py` phase 6 does (b3, feature 32, 370x1220 stereo, 256x256x32
grid, bf16, `use_stereo_depth_gt=false`, seeded random weights, seeded
random uint8 frames) under `tracing.recording()`, and reads each span the
program opens in a dispatch (`occdepth_tpu_torch/tracing.py`): the
dispatch's `serve.upload` and `serve.forward`, the model's
`model.backbone_2d`, `model.lift` (the FLoSP lift with the Stereo-SFA
fusion, kernel K1+), `model.oad`, `model.decoder_3d` and inside it
`model.crp` (the relation products, kernel K2) and `model.heads`, and the
readout `serve.drain`.  Each span's device time runs from the CUDA event
at its start to the one at its end, so it includes any wait for the
host's launches inside it; on CUDA each model stage but the lift is a
CUDA-graph replay inside its span (`serving/pipeline.py`).  It prints the median over the timed
dispatches (after one warm-up dispatch) and ms/frame over the run;
--json adds one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from occdepth_tpu_torch import tracing

FLAGSHIP = "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"


def stage_ms(skip: int = 0) -> dict:
    """{span name: median device ms over its recorded spans after the
    first `skip`}; call after a synchronise."""
    return {k: statistics.median(v[skip:])
            for k, v in tracing.device_ms().items() if len(v) > skip}


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
    tracing.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with tracing.recording():
        start.record()
        n_out = len(list(pipe.run(frames)))
        end.record()
    end.synchronize()
    stages = stage_ms(skip=1)
    res = {"gpu": gpu_line(), "frames": n_out, "batch": args.batch,
           "dispatches": len(tracing.device_ms()["serve.dispatch"]),
           "ms_per_frame": start.elapsed_time(end) / n_out,
           **{f"{k}_ms_per_dispatch": v for k, v in stages.items()}}
    for k, v in res.items():
        print(f"{k}: {v}")
    if args.json:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
