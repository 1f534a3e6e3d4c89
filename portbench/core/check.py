"""The numbers that decide `correct`, each against its limit.

Class grids (the served frames; a train step's first forward): the
deficit, the sum over voxels of the gap by which the reference's logit of
the grid's class lies below the reference's best logit (0 where the class
is the reference's argmax), over the deficit of the grid that the
reference computed in the configuration's bfloat16 gives on the same
inputs.  A program that rounds like bfloat16 reads about 1 on any seed,
whatever the seed's weights make of the logits' near-ties; the widest gap
is recorded beside it.

Train steps: the program's first steps against the reference run from the
same weights on the same batches.  Gradients and changes are compared
leaf by leaf: the gap between the program's norm and the reference's,
over the larger of the reference leaf's norm and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's (no output depends on them; they move by weight decay alone) are
left out.  The compared numbers are the first step's loss, the median
leaf's gap of the first gradient as the optimizer received it, and the
median leaf's gap of the change after the checked steps; the later
steps' losses and the worst leaves are recorded beside them (PERF.md
says why those are not compared).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

NEGLIGIBLE_GRAD = 1e-3


def deficit(ref_logits: torch.Tensor, grid: torch.Tensor) -> tuple:
    """(summed, widest) gap of the grid's class logit below the best one,
    over the voxels.  ref_logits (..., C) float32, grid (...) class ids."""
    best = ref_logits.amax(dim=-1)
    got = ref_logits.gather(-1, grid.long()[..., None])[..., 0]
    gap = (best - got).double()
    return float(gap.sum()), float(gap.max())


def scaled(gap: float, scale: float) -> float:
    """gap / scale; a gap with no rounding deficit to scale it by reads
    infinite (0 where there is no gap either)."""
    if scale > 0:
        return gap / scale
    return 0.0 if gap == 0 else math.inf


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def kept_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    vals = sorted(ref_grad_norms.values())
    median = vals[len(vals) // 2]
    return [k for k, v in ref_grad_norms.items()
            if v >= NEGLIGIBLE_GRAD * median]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Iterable[str], scale: Dict[str, float] = None
              ) -> Dict[str, float]:
    """Per leaf, |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's (norms of `scale` where
    given; a NaN reads infinite)."""
    keys = list(keys)
    scale = scale or ref
    vals = sorted(scale[k] for k in keys)
    median = vals[len(vals) // 2]
    out = {}
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(scale[k], median)
        out[k] = gap if gap == gap else math.inf
    return out


def median_gap(gaps: Dict[str, float]) -> float:
    """The median leaf's gap; infinite if any leaf's norm is not finite."""
    vals = sorted(gaps.values())
    return math.inf if math.isinf(vals[-1]) else vals[len(vals) // 2]


def worst_gap(gaps: Dict[str, float]) -> Tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def rel_gap(p: float, r: float) -> float:
    gap = abs(p - r) / abs(r)
    return gap if gap == gap else math.inf


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]
            ) -> Tuple[bool, Dict[str, dict]]:
    """Each compared number beside its limit; correct when every number is
    finite and within its limit (a missing number is not correct)."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        out[name] = {"value": v, "limit": lim["limit"]}
    return ok, out
