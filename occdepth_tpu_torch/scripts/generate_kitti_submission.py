"""Write a SemanticKITTI SSC benchmark submission.

Counterpart of `occdepth_tpu/scripts/generate_kitti_submission.py`
(reference occdepth/scripts/generate_kitti_submission.py:62-85):
test-split inference, train ids mapped back to raw label ids through the
inverse learning map, uint16 `.label` files in the CodaLab layout
(<out>/sequences/<seq>/predictions/<frame>.label):

    python -m occdepth_tpu_torch.scripts.generate_kitti_submission \\
        --config CONFIG.yaml --output-dir DIR \\
        [--ckpt last | --torch-ckpt PATH] [--device cpu] [key=value ...]

`valid_kitti_submission` checks the result.  The device is CUDA unless
`--device cpu` is given; without a GPU the CUDA default raises.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.data.kitti import KittiDataset, Loader
from occdepth_tpu_torch.data.kitti_io import get_inv_map
from occdepth_tpu_torch.scripts.common import load_model, model_inputs, predict
from occdepth_tpu_torch.training.trainer import strip_metadata


def write_prediction(output_dir: str, sequence: str, frame_id: str,
                     y_pred: np.ndarray, inv_map: np.ndarray) -> str:
    """Map train ids back to raw label ids and write one CodaLab-layout
    uint16 `.label` file (reference generate_kitti_submission.py:62-85)."""
    pred = inv_map[np.asarray(y_pred).reshape(-1)].astype(np.uint16)
    out_dir = os.path.join(output_dir, "sequences", sequence, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, frame_id + ".label")
    pred.tofile(path)
    return path


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
    model = load_model(cfg, args.ckpt, args.torch_ckpt, args.device)
    device = next(model.parameters()).device
    loader = Loader(KittiDataset(cfg, "test"), cfg.batch_size_per_gpu,
                    shuffle=False, drop_last=False)
    inv_map = get_inv_map()
    written = []
    for batch in loader:
        y_pred = predict(model, model_inputs(strip_metadata(batch), device))
        for i, frame_id in enumerate(batch["frame_id"]):
            path = write_prediction(args.output_dir, batch["sequence"][i],
                                    frame_id, y_pred[i], inv_map)
            written.append(path)
            print("wrote", path)
    return written


if __name__ == "__main__":
    main()
