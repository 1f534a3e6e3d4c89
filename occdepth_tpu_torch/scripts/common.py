"""What the output CLIs share: the device, the weights, the batch.

The JAX package's infer, generate_output, generate_kitti_submission and
export CLIs each initialise a model and restore a Trainer checkpoint or
convert a reference `.ckpt`; here that is `load_model`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.training.checkpoint import CheckpointManager
from occdepth_tpu_torch.training.trainer import INIT_SEED, exp_name
from occdepth_tpu_torch.weights import load_reference_checkpoint


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when it is None; CUDA without a GPU raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass --device cpu to run on "
                               "the CPU)")
        device = "cuda"
    return torch.device(device)


def load_model(cfg: OccDepthConfig, ckpt: str = "last",
               torch_ckpt: Optional[str] = None, device=None) -> OccDepthModel:
    """The eval-mode model on `device`, with the weights of the reference
    checkpoint `torch_ckpt` if given, else of the Trainer checkpoint
    `<logdir>/<exp_name>/checkpoints/<ckpt>.pt`; with neither it warns, as
    the JAX CLIs do, and keeps the Trainer's seeded initial weights."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(INIT_SEED)
        model = OccDepthModel(cfg)
    if torch_ckpt:
        load_reference_checkpoint(model, torch_ckpt)
    else:
        directory = os.path.join(cfg.logdir, exp_name(cfg), "checkpoints")
        state = (CheckpointManager(directory).restore(ckpt, map_location="cpu")
                 if os.path.isdir(directory) else None)
        if state is None:
            print("WARNING: no checkpoint found — random weights")
        else:
            model.load_state_dict(state["model"])
    return model.to(dev).eval()


def model_inputs(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated batch's arrays as tensors on `device` (the frame ids and
    sequence names stay behind)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


@torch.no_grad()
def predict(model: OccDepthModel, batch: Dict[str, torch.Tensor]) -> np.ndarray:
    """The argmax class grid (B, X, Y, Z) uint8 of one batch."""
    logits = model(batch)["ssc_logit"]
    return logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()
