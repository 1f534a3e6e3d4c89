"""Dump per-frame predictions for the visualizers.

Counterpart of `occdepth_tpu/scripts/generate_output.py` (reference
occdepth/scripts/generate_output.py:86-134): an inference loop over the
val split (NYU: test) writing one pickle per frame, `{seq}_{frame}.pkl`,
holding {y_pred, target, fov_mask_1, cam_k, T_velo_2_cam, vox_origin} and,
for NYU, cam_pose:

    python -m occdepth_tpu_torch.scripts.generate_output --config CONFIG.yaml \\
        --output-dir DIR [--ckpt last | --torch-ckpt PATH] [--device cpu] \\
        [key=value ...]

The device is CUDA unless `--device cpu` is given; without a GPU the CUDA
default raises.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.data.batch import vox_origin_for
from occdepth_tpu_torch.data.kitti import Loader
from occdepth_tpu_torch.geometry.projection import vox2pix
from occdepth_tpu_torch.scripts.common import load_model, model_inputs, predict
from occdepth_tpu_torch.training.trainer import make_datasets, strip_metadata


def full_scale_fov(cfg, cam_k, T_velo_2_cam, vox_origin=None) -> np.ndarray:
    """Output-scale (1_1) FOV mask of one camera, the reference's
    `fov_mask_1` (kitti_dataset.py:258-284 at scale 1).  The model batch
    carries only the project-scale mask, which has 1/8 the voxels of
    y_pred and would not reshape onto it in the visualizers."""
    origin = vox_origin if vox_origin is not None else vox_origin_for(cfg)
    H, W = cfg.img_shape
    _, fov, _ = vox2pix(
        np.asarray(T_velo_2_cam, np.float64), np.asarray(cam_k, np.float64),
        np.asarray(origin, np.float64),
        cfg.voxel_size_meters * cfg.output_scale, W, H,
        cfg.scene_size_meters, 0,
    )
    return fov[:, 0]


def dump_records(cfg, model, loader, output_dir: str):
    """Inference loop -> per-frame visualizer pickles (reference
    generate_output.py:86-134).  Yields each written path."""
    device = next(model.parameters()).device
    for batch in loader:
        y_pred = predict(model, model_inputs(strip_metadata(batch), device))
        for i, frame_id in enumerate(batch["frame_id"]):
            vox_origin = (np.asarray(batch["vox_origin"][i])
                          if "vox_origin" in batch else None)
            record = {
                "y_pred": y_pred[i],
                "fov_mask_1": full_scale_fov(
                    cfg, batch["cam_k"][i, 0], batch["T_velo_2_cam"][i, 0],
                    vox_origin),
                "cam_k": np.asarray(batch["cam_k"][i, 0]),
                "T_velo_2_cam": np.asarray(batch["T_velo_2_cam"][i, 0]),
            }
            if "target" in batch:
                record["target"] = np.asarray(batch["target"][i])
            if vox_origin is not None:
                record["vox_origin"] = vox_origin
            if cfg.dataset == "NYU":
                # NYU visualizers read the camera pose (world->cam inverse)
                record["cam_pose"] = np.linalg.inv(
                    np.asarray(batch["T_velo_2_cam"][i, 0], np.float64))
            path = os.path.join(output_dir,
                                f"{batch['sequence'][i]}_{frame_id}.pkl")
            with open(path, "wb") as f:
                pickle.dump(record, f)
            yield path


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default="last",
                    help="checkpoint name under <logdir>/<exp>/checkpoints")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference PyTorch .ckpt to run")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA by default, `cpu` to run on "
                         "the CPU")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    os.makedirs(args.output_dir, exist_ok=True)
    model = load_model(cfg, args.ckpt, args.torch_ckpt, args.device)
    _, val_ds = make_datasets(cfg)
    loader = Loader(val_ds, cfg.batch_size_per_gpu, shuffle=False,
                    drop_last=False)
    written = []
    for path in dump_records(cfg, model, loader, args.output_dir):
        written.append(path)
        print("wrote", path)
    return written


if __name__ == "__main__":
    main()
