"""Export the eval forward as a serialized `torch.export` program (.pt2).

Counterpart of `occdepth_tpu/scripts/export_model.py`, which serializes the
jitted forward as StableHLO with its Pallas calls inside.  Here
`torch.export` traces the eval forward (returning `ssc_logit`) under
`torch.no_grad()`, and the hand-written kernels appear in the graph as
the registered operators `occdepth::flosp_stereo_lift`,
`occdepth::crp_relation_matmul` and, under `decoder_conv_impl=pallas`,
`occdepth::conv3x3`.  The program is traced on the device it will run on
(the operators' CUDA and CPU layouts differ), and loading it needs those
operators registered: `load_exported` imports the port's ops first.

    python -m occdepth_tpu_torch.scripts.export_model --config CONFIG.yaml \\
        --out model.pt2 [--ckpt last | --torch-ckpt PATH] [--device cpu] \\
        [key=value ...]

The weights are those of the other output CLIs (`common.load_model`):
with no checkpoint found, the Trainer's seeded initial weights, as the
JAX CLI exports its PRNGKey(0) initialisation.  The device is CUDA unless
`--device cpu` is given; without a GPU the CUDA default raises.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import torch
import torch.nn as nn

from occdepth_tpu_torch.config import OccDepthConfig, load_config, parse_overrides
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.scripts.common import load_model, model_inputs

# the batch entries the forward reads (the labels stay out of the program)
INPUT_KEYS = ("img", "projected_pix", "fov_mask", "cam_k", "T_velo_2_cam",
              "ida_mats", "vox_origin", "gt_depth", "virtual_bf")


class _Logits(nn.Module):
    def __init__(self, model: OccDepthModel):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(batch)["ssc_logit"]


def export_forward(cfg: OccDepthConfig, model: OccDepthModel,
                   batch: Dict[str, torch.Tensor]):
    """The `torch.export.ExportedProgram` of model's eval forward on
    batches shaped like `batch` (tensors on the model's device), returning
    ssc_logit (B, X, Y, Z, n_classes) float32."""
    inputs = {k: v for k, v in batch.items() if k in INPUT_KEYS}
    with torch.no_grad():
        return torch.export.export(_Logits(model.eval()), (inputs,),
                                   strict=False)


def load_exported(path: str):
    """A saved program, with the port's operators registered first."""
    import occdepth_tpu_torch.ops.conv2d_shift  # noqa: F401
    import occdepth_tpu_torch.ops.crp_matmul  # noqa: F401
    import occdepth_tpu_torch.ops.flosp_gather  # noqa: F401

    return torch.export.load(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default="last",
                    help="checkpoint name under <logdir>/<exp>/checkpoints")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference PyTorch .ckpt whose weights to export")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA by default, `cpu` to run on "
                         "the CPU")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    model = load_model(cfg, args.ckpt, args.torch_ckpt, args.device)
    # NYU's forward reads the depth the labelled batch carries
    batch = make_synthetic_batch(cfg, batch_size=1,
                                 with_labels=cfg.dataset == "NYU")
    device = next(model.parameters()).device
    exported = export_forward(cfg, model, model_inputs(batch, device))
    torch.export.save(exported, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
