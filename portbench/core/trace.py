"""The profiled stretch of a `--trace 1` run, and what is read from it.

`profiled(run)` runs `run()` (the program's own dispatches or steps) under
torch.profiler (CPU + CUDA) and reduces the trace to plain lists:

  * the stretch starts with a sentinel kernel (`torch.cuda._sleep`):
    torch.profiler has been seen to drop the first kernel record after it
    starts, and the sentinel's is the one it may drop.  Every other launch
    on the host needs its kernel record, or the run fails (lost records
    would read as idle time);
  * the stretch runs from its first device operation after the sentinel
    (work in flight before the profiler started runs first, unrecorded)
    to its last one's end;
  * busy time is the union of the device operations' intervals (kernels,
    memsets, copies), so overlapping kernels count once.
"""
from __future__ import annotations

import heapq
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

# kernel-name patterns -> kind, first match wins (the classes of the
# port's train-step profile script, copied)
KINDS = (
    ("K3 conv3x3", r"conv3x3"),
    ("K4 dw_filter_grad", r"dw_filter_grad"),
    ("K1+ bwd flosp_stereo_lift_backward",
     r"lift_bwd_|lift_vector_kernel<[^>]*true>"),
    ("K1 fused lift flosp_stereo_lift", r"flosp_stereo_lift|lift_vector"),
    ("packing pack_nhwc (K3's, the lift's maps)", r"pack_nhwc|pack_planes"),
    ("K1 stereo_cosine_fuse", r"stereo_cosine_fuse"),
    ("K2 crp_relation_matmul", r"crp_relation_matmul|crp_wgmma"),
    ("batch norm", r"batch_norm|bn_"),
    ("convolution (cuDNN)", r"conv|xmma|implicit|dgrad|wgrad|cudnn|fprop"),
    ("matmul (cuBLAS)", r"gemm|cutlass|sm90_|ampere_"),
    ("depthwise conv (PyTorch)", r"depthwise|DepthwiseConv"),
    ("grid sample", r"grid_sample|grid_sampler"),
    ("index / gather / scatter", r"index|gather|scatter"),
    ("upsample / pooling", r"upsample|pool"),
    ("reduction", r"reduce|Reduce|norm_kernel"),
    ("layout copy", r"copy|transpose|nchwToNhwc|nhwcToNchw|permute"),
    ("optimizer", r"multi_tensor|foreach|adam"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)

SENTINEL = "spin_kernel"
_LAUNCH = re.compile(r"^(cuda|cu)LaunchKernel")


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def short_name(key: str) -> str:
    """A kernel's name without namespace, template arguments and
    parameters: "void (anonymous namespace)::f<T, 8>(...)" -> "f"."""
    if key.startswith(("Memset", "Memcpy")):
        return key.split(" ")[0]
    stem = re.split(r"[<(]", key.replace("(anonymous namespace)::", ""))[0]
    return stem.split("::")[-1].split()[-1]


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def label_gaps(gap_list, host_events):
    """(label, length) of each gap: the shortest host event (CPU op or
    runtime call) running at the gap's midpoint, by a sweep over the
    events in start order with a heap of the started ones by duration."""
    events = sorted(host_events, key=lambda ev: ev[1])
    heap, i, out = [], 0, []
    for a, b in sorted(gap_list, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(events) and events[i][1] <= mid:
            name, s, e = events[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < mid:  # ended before this (and later)
            heapq.heappop(heap)
        out.append((heap[0][2] if heap else "host outside any op", b - a))
    return out


@dataclass
class Stretch:
    """A profiled stretch reduced to plain data (times in microseconds on
    the profiler's clock)."""

    device_ops: List[Tuple[str, float, float]]  # (name, start, end)
    host_events: List[Tuple[str, float, float]]  # CPU ops and runtime calls
    op_device_us: Dict[str, float]  # top-level op name -> its kernels' us
    start: float = 0.0
    end: float = 0.0
    units: int = 0  # frames or steps the stretch ran

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(max(s, self.start), min(e, self.end))
                             for _, s, e in self.device_ops
                             if e > self.start and s < self.end]) / 1e6

    def kind_us(self, kind: str) -> float:
        return sum(e - s for n, s, e in self.device_ops
                   if kind_of(n) == kind)

    def breakdown(self, n: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            k = short_name(name)
            by_name[k] = by_name.get(k, 0.0) + (e - s) / 1e6
        idle: Dict[str, float] = {}
        for label, length in label_gaps(
                gaps([(s, e) for _, s, e in self.device_ops], self.start,
                     self.end), self.host_events):
            idle[label] = idle.get(label, 0.0) + length / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:n]]}


def reduce_events(events, ops: Sequence[str]) -> Stretch:
    """torch.profiler FunctionEvents -> a Stretch.  `ops` are the operator
    names whose top-level calls' device time is kept."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            device.append((e.name, float(tr.start), float(tr.end)))
        else:
            host.append(e)
    # a record_function range also shows on the device timeline, spanning
    # the kernels it encloses: it is no device operation of its own
    host_names = {e.name for e in host}
    device = [d for d in device if d[0] not in host_names]
    # the stretch's work starts at its first device operation other than
    # the sentinel: what was in flight before the profiler started ran
    # first, and was launched unrecorded
    ops_after = [d for d in device if short_name(d[0]) != SENTINEL]
    if not ops_after:
        raise RuntimeError("trace: no device operation in the stretch")
    kernels = [d for d in ops_after
               if not d[0].startswith(("Memset", "Memcpy"))]
    launches = sum(1 for e in host if _LAUNCH.match(e.name))
    # every launch but the sentinel's needs its record
    if len(kernels) < launches - 1:
        raise RuntimeError(f"trace: {launches - 1} kernel launches but "
                           f"{len(kernels)} kernel records (lost records)")
    t0 = min(d[1] for d in ops_after)
    wanted = set(ops)
    op_us: Dict[str, float] = {k: 0.0 for k in ops}
    for e in host:
        if e.name not in wanted:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in wanted:
            p = p.cpu_parent
        if p is None:
            op_us[e.name] += float(e.device_time_total)
    host_events = [(e.name, float(e.time_range.start),
                    float(e.time_range.end)) for e in host]
    return Stretch(device_ops=ops_after, host_events=host_events,
                   op_device_us=op_us, start=t0,
                   end=max(d[2] for d in ops_after))


def profiled(run, ops: Sequence[str]) -> Stretch:
    """Profile `run()` (it returns the units it ran and leaves the device
    idle) behind a sentinel kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        units = run()
        torch.cuda.synchronize()
    st = reduce_events(prof.events(), ops)
    st.units = units
    return st
