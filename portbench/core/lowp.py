"""The reference computed in a lower precision, under a torch function mode.

Under `Rounded(...)` every convolution, transposed convolution, linear
layer and matmul of the plain reference takes its two operands rounded,
accumulates in float32, and (for bfloat16) returns its result rounded as
well; the rest of the reference stays float32.  The rounding passes
gradients straight through, so a backward multiplies by the rounded
operands it saved.

  * `bfloat16()`: operands and results in bfloat16, as the configurations'
    stated compute precision stores them.  The serve check reads the
    largest logit error that this rounding gives on each frame, the scale
    of the rounding that the stated precision entails.
  * `float8()`: operands in float8 e4m3 with a per-tensor scale (amax /
    448), as an fp8 path would feed the tensor cores: the control, the
    nearest precision below bfloat16.  The benchmark's runs never use it:
    `tools/calibrate.py` reads the control's numbers with it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
FUNCS = frozenset({F.conv1d, F.conv2d, F.conv3d, F.conv_transpose1d,
                   F.conv_transpose2d, F.conv_transpose3d, F.linear,
                   torch.bmm, torch.matmul, torch.mm, torch.Tensor.matmul,
                   torch.Tensor.__matmul__, torch.Tensor.bmm,
                   torch.Tensor.mm})


def _straight_through(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return t + (q - t.detach())


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or not t.is_floating_point():
        return t
    scale = E4M3_MAX / t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return _straight_through(t, q)


def round_bf16(t):
    if not isinstance(t, torch.Tensor) or not t.is_floating_point():
        return t
    return _straight_through(t, t.detach().to(torch.bfloat16).to(t.dtype))


class Rounded(TorchFunctionMode):
    def __init__(self, operand, result=None):
        super().__init__()
        self.operand, self.result = operand, result

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in FUNCS or len(args) < 2:
            return func(*args, **kwargs)
        args = (self.operand(args[0]), self.operand(args[1])) + tuple(
            args[2:])
        out = func(*args, **kwargs)
        return self.result(out) if self.result else out


def bfloat16() -> Rounded:
    return Rounded(round_bf16, round_bf16)


def float8() -> Rounded:
    return Rounded(round_e4m3)
