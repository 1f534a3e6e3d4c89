"""Single-frame / ad-hoc inference CLI: no dataset tree needed.

Counterpart of `occdepth_tpu/scripts/infer.py`: stereo (or mono) image
files and a KITTI-format calib.txt go through the whole pipeline (vox2pix
geometry -> normalized batch -> forward), and each frame's visualizer
pickle (generate_output's schema) comes out, with an optional PNG:

    python -m occdepth_tpu_torch.scripts.infer --config CONFIG.yaml \\
        --left 000000_2.png --right 000000_3.png --calib calib.txt \\
        --output out.pkl [--render out.png] \\
        [--ckpt last | --torch-ckpt PATH] [--device cpu] [key=value ...]

Several frames: pass --left/--right several times; the frames go through
as one batch.  The device is CUDA unless `--device cpu` is given; without
a GPU the CUDA default raises.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.data.augment import ida_matrix, normalize_rgb
from occdepth_tpu_torch.data.batch import vox_origin_for
from occdepth_tpu_torch.data.kitti_io import camera_geometry, read_calib
from occdepth_tpu_torch.geometry.projection import vox2pix
from occdepth_tpu_torch.scripts.common import load_model, model_inputs, predict
from occdepth_tpu_torch.scripts.generate_output import full_scale_fov


def load_image(path: str, img_h: int, img_w: int) -> np.ndarray:
    """An RGB file cropped to (img_h, img_w), ImageNet-normalized."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return normalize_rgb(img[:img_h, :img_w])


def build_batch(cfg, lefts, rights, calib_path):
    """(batch, cam_k, T_velo_2_cam, fov) for the frames: the model's
    numpy inputs, one row per frame, and the rig's (2, 3, 3) intrinsics,
    (2, 4, 4) extrinsics and (views, N, P) project-scale FOV masks."""
    cam_k, T_velo_2_cam = camera_geometry(read_calib(calib_path))
    n_views = 2 if cfg.multi_view_mode else 1
    img_h, img_w = cfg.img_shape
    vox_origin = vox_origin_for(cfg)

    pix, fov = [], []
    for v in range(n_views):
        p, f, _ = vox2pix(
            T_velo_2_cam[v], cam_k[v], vox_origin,
            cfg.voxel_size_meters * cfg.project_scale, img_w, img_h,
            cfg.scene_size_meters, cfg.pattern_id,
        )
        pix.append(p)
        fov.append(f)
    pix = np.stack(pix).astype(np.int32)
    fov = np.stack(fov)

    B = len(lefts)
    imgs = []
    for i in range(B):
        views = [load_image(lefts[i], img_h, img_w)]
        if n_views == 2:
            views.append(load_image(rights[i], img_h, img_w))
        imgs.append(np.stack(views))

    def rows(a, dtype=None):
        a = a if dtype is None else a.astype(dtype)
        return np.broadcast_to(a[None], (B,) + a.shape).copy()

    batch = {
        "img": np.stack(imgs),
        "projected_pix": rows(pix),
        "fov_mask": rows(fov),
        "cam_k": rows(cam_k[:n_views], np.float32),
        "T_velo_2_cam": rows(T_velo_2_cam[:n_views], np.float32),
        "ida_mats": rows(np.stack([ida_matrix((0, 0, img_w, img_h), False)]
                                  * n_views), np.float32),
    }
    return batch, cam_k, T_velo_2_cam, fov


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--left", action="append", required=True)
    ap.add_argument("--right", action="append", default=[])
    ap.add_argument("--calib", required=True)
    ap.add_argument("--ckpt", default="last",
                    help="checkpoint name under <logdir>/<exp>/checkpoints")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference PyTorch .ckpt to run")
    ap.add_argument("--output", required=True,
                    help="output pickle path (frame index appended if >1)")
    ap.add_argument("--render", default=None,
                    help="also render a PNG per frame to this path/prefix")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA by default, `cpu` to run on "
                         "the CPU")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))

    model = load_model(cfg, args.ckpt, args.torch_ckpt, args.device)
    batch, cam_k, T_velo_2_cam, _ = build_batch(
        cfg, args.left, args.right or args.left, args.calib)
    device = next(model.parameters()).device
    y_pred = predict(model, model_inputs(batch, device))

    B = y_pred.shape[0]
    fov_1 = full_scale_fov(cfg, cam_k[0], T_velo_2_cam[0])
    written = []
    for i in range(B):
        record = {"y_pred": y_pred[i], "fov_mask_1": fov_1,
                  "cam_k": cam_k[0], "T_velo_2_cam": T_velo_2_cam[0]}
        path = args.output if B == 1 else (
            os.path.splitext(args.output)[0] + f"_{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump(record, f)
        written.append(path)
        print("wrote", path)
        if args.render:
            from occdepth_tpu_torch.scripts.visualization.voxel_vis import (
                render_frame,
            )

            png = args.render if B == 1 else (
                os.path.splitext(args.render)[0] + f"_{i}.png")
            render_frame(record, png, dataset=cfg.dataset,
                         n_classes=cfg.n_classes)
            print("wrote", png)
    return written


if __name__ == "__main__":
    main()
