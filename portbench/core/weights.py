"""Seeded weights over a model's state_dict names and shapes.

The benchmark makes its own weights: one draw of standard normals on the
device for every floating entry, cut into the entries and scaled by a rule
on the entry's name and shape:

  * BatchNorm (an entry `<m>.weight` beside `<m>.running_mean`): weight
    1 + 0.2 z, bias 0.1 z, running_mean 0.1 z, running_var exp(0.25 z);
  * a weight of two or more dims (convolution, transposed convolution,
    linear): z / sqrt(3 fan_in), fan_in = shape[1] * prod(shape[2:]), the
    spread of PyTorch's default initialisation;
  * any other bias: z / sqrt(3 fan_in) of its layer's weight;
  * integer entries (num_batches_tracked): zeros.

The same seed and names give the same tensors, on any device that draws
the same normals from the same generator state.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.core.inputs import generator

Shapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def shapes_of(state_dict) -> Shapes:
    return {k: (tuple(v.shape), v.dtype) for k, v in state_dict.items()}


def _fan_in(shape) -> int:
    return shape[1] * math.prod(shape[2:])


def make_state_dict(shapes: Shapes, seed: int, device,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    floats = [k for k, (_, dt) in shapes.items() if dt.is_floating_point]
    sizes = [math.prod(shapes[k][0]) for k in floats]
    z = torch.randn(sum(sizes), generator=generator(seed, 3, device),
                    device=device, dtype=torch.float32)
    out = {}
    for k, flat in zip(floats, torch.split(z, sizes)):
        shape = shapes[k][0]
        t = flat.view(shape)
        stem, _, leaf = k.rpartition(".")
        bn = f"{stem}.running_mean" in shapes
        if bn and leaf == "weight":
            t = 1.0 + 0.2 * t
        elif bn and leaf in ("bias", "running_mean"):
            t = 0.1 * t
        elif leaf == "running_var":
            t = torch.exp(0.25 * t)
        elif len(shape) >= 2:
            t = t / math.sqrt(3.0 * _fan_in(shape))
        else:
            w = shapes.get(f"{stem}.weight")
            fan = _fan_in(w[0]) if w is not None and len(w[0]) >= 2 else 1
            t = t / math.sqrt(3.0 * fan)
        out[k] = t.to(dtype)
    for k, (shape, dt) in shapes.items():
        if k not in out:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
    return out
