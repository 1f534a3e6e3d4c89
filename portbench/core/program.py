"""The program under test, as the benchmark drives it: its config, its
model at the configuration's sizes with the benchmark's weights."""
from __future__ import annotations

import dataclasses

import torch

from portbench.core import weights


def program_config(spec: dict):
    """The program's config object from the configuration file's
    `config` group (the shipped YAML's keys and the overrides)."""
    from occdepth_tpu_torch.config import OccDepthConfig

    fields = {f.name for f in dataclasses.fields(OccDepthConfig)}
    from occdepth_tpu_torch.config import FlospDepthConfig

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in spec["config"].items() if k in fields}
    if isinstance(kw.get("flosp_depth_override"), dict):
        kw["flosp_depth_override"] = FlospDepthConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in kw["flosp_depth_override"].items()})
    return OccDepthConfig(**kw)


def program_model(spec: dict, seed: int, device):
    """(config, model on `device` holding the seeded weights, the weights'
    names and shapes)."""
    from occdepth_tpu_torch.models import OccDepthModel

    cfg = program_config(spec)
    with torch.device(device):
        model = OccDepthModel(cfg)
    shapes = weights.shapes_of(model.state_dict())
    model.load_state_dict(weights.make_state_dict(shapes, seed, device))
    return cfg, model, shapes


def reference_model(spec: dict, shapes, seed: int, device):
    """The plain reference on `device` with the same seeded weights, drawn
    anew from the seed."""
    from portbench.reference.config import RefConfig
    from portbench.reference.model import RefOccDepth

    with torch.device(device):
        ref = RefOccDepth(RefConfig(spec))
    ref.load_state_dict(weights.make_state_dict(shapes, seed, device))
    return ref
