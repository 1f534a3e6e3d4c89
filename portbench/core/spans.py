"""What the span metrics read from the program's spans
(`occdepth_tpu_torch/tracing.py`).

Host intervals come from the spans' events in the profiled stretch
(`Stretch.host_events`, the clock of its device operations); a stage's
device ms from its spans' CUDA events (`tracing.records()`, read after the
stretch).  Every function gives None where the stretch holds none of the
spans it reads, as for a program without them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from portbench.core.trace import Stretch, gaps


def merged(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """The union of `intervals` as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """The length two lists of sorted disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_spans(st: Stretch, names: Sequence[str]
               ) -> List[Tuple[float, float]]:
    return [(s, e) for n, s, e in st.host_events if n in names]


def host_ms_per(st: Stretch, name: str, per: str) -> Optional[float]:
    """Host ms inside the spans `name` per span `per` over the stretch."""
    inside, units = host_spans(st, (name,)), host_spans(st, (per,))
    if not inside or not units:
        return None
    return sum(e - s for s, e in inside) / 1e3 / len(units)


def device_ms_per_unit(st: Stretch, name: str) -> Optional[float]:
    """Device ms per unit (frame or step) from the entry to the exit event
    of the spans `name`: the last records of that name, as many as the
    stretch holds spans of it."""
    n = len(host_spans(st, (name,)))
    if not n or not st.units:
        return None
    try:
        from occdepth_tpu_torch import tracing
    except ImportError:
        return None
    recs = [r for r in tracing.records() if r.name == name][-n:]
    ms = [r.device_ms for r in recs]
    if len(ms) < n or None in ms:
        return None
    return sum(ms) / st.units


def idle_ms_per_unit(st: Stretch, names: Sequence[str]) -> Optional[float]:
    """Device idle ms per unit while the host is inside any of the spans
    `names`: their intervals, inside the stretch, less the device
    operations' union."""
    inside = merged((max(s, st.start), min(e, st.end))
                    for s, e in host_spans(st, names)
                    if e > st.start and s < st.end)
    if not inside or not st.units:
        return None
    idle = gaps([(s, e) for _, s, e in st.device_ops], st.start, st.end)
    return overlap(inside, idle) / 1e3 / st.units
