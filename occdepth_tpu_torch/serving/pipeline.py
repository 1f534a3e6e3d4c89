"""Steady-state batched inference pipeline (the serving runtime).

Counterpart of `occdepth_tpu/serving/pipeline.py::ServingPipeline`:

* **uint8 ingestion** — frames go to the device as uint8 (V, H, W, 3); the
  /255 and ImageNet normalisation run on the device;
* **fixed-shape batching** — frames are grouped into a constant batch size,
  a ragged tail is padded and its padding rows are dropped; the rig's
  calibration tensors are uploaded once and reused by every batch;
* **stage graphs** — on CUDA the forward at the pipeline's batch shape
  is a chain of CUDA graphs (`StageGraphs`), one per stage of the model
  (`model.backbone_2d`, `model.oad`, the 3D decoder split at `model.crp`
  and `model.heads`, its input cast joining its first graph) and one per
  piece of glue between them (the normalisation, the outputs' casts),
  replayed on every dispatch in place of launching each kernel from
  Python.  The first dispatch captures them.  Batches are uploaded into
  a static uint8 input; the graphs share one memory pool, and a graph's
  output is the next graph's input itself.  A replay adds the kernel
  launches its capture recorded to the kernels' counters.  The lift
  (`model.lift`: the packs and the fused lift) stays eager: the profiler
  attributes its kernels to its operators' host events, which a replay
  does not emit; its output is copied into the captured input of the
  graph after it.  The argmax to uint8 runs eagerly after the last replay
  and writes a new grid each dispatch, so a dispatch still in flight
  keeps its grid while the next one replays.  On the CPU the forward runs
  eagerly;
* **bounded in-flight batches** — kernels are enqueued on the current
  CUDA stream without host synchronisation, up to `max_in_flight` batches
  ahead of the host's readout of the oldest one;
* **compact egress** — only the uint8 argmax grid leaves the device;
* **spans** (`tracing.py`) — `serve.dispatch` around each batch's
  `serve.upload` and `serve.forward`, and `serve.drain` around the
  blocking readout of one batch, under its dispatch's unit id; each stage
  graph's replay runs inside its stage's span, so the span's CUDA events
  time the replay.  `tracing.counts` counts dispatches by path and graph
  captures and replays.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from occdepth_tpu_torch import tracing
from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.models.occdepth import OccDepthModel
from occdepth_tpu_torch.ops import launch_counters

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_NON_INPUT_KEYS = ("img", "target", "gt_depth", "CP_mega_matrices",
                   "occluded", "sample_valid", "frame_id", "sequence")


def _layout(v):
    """A stage argument as a replay must find it: a tensor's shape, strides
    and dtype, any other value itself."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.stride(), v.dtype
    return v


def _launch_counts() -> dict:
    """Each hand-written kernel's wrapper -> its launch count and its
    counts by path."""
    return {fn: (fn.launches, dict(getattr(fn, "paths", {})))
            for fn in launch_counters().values()}


def _captured_launches(before: dict) -> list:
    """The launches a capture recorded since `before`, as (wrapper,
    launches, {path: launches}); the wrappers' counts are set back, since
    a capture runs nothing and each replay counts them."""
    launched = []
    for fn, (n, paths) in before.items():
        by_path = {k: v - paths[k] for k, v in getattr(fn, "paths", {}).items()
                   if v != paths[k]}
        if fn.launches != n or by_path:
            launched.append((fn, fn.launches - n, by_path))
            fn.launches = n
            if paths:
                fn.paths.update(paths)
    return launched


class StageGraphs:
    """The serving forward at one input shape as a chain of CUDA graphs.

    `serve(forward, x)` runs `forward(input, stage)` with this object as
    the stage runner (`OccDepthModel.forward`'s `stage`) on `input`, the
    static uint8 batch.  The first call runs the forward eagerly on a side
    stream (lazy set-up: libraries, handles, kernels), then captures each
    stage into its own graph in the shared pool and replays it; after that
    each stage call replays its graph.  Either way a replay runs inside
    the stage's span and adds the kernel launches its capture recorded to
    the wrappers' counters (`ops.launch_counters`).
    A stage's tensor arguments are the captured ones when they sit where
    they did at capture (the static input, the calibration tensors,
    earlier graphs' outputs and views of them) and are copied into them
    otherwise (what an eager call, the lift, made).  Outputs are the
    captured tensors, overwritten by the next replay, and are returned as
    captured: read them, do not mutate the containers.
    """

    def __init__(self, shape, device):
        self.input = torch.empty(shape, dtype=torch.uint8, device=device)
        self._pool = torch.cuda.graph_pool_handle()
        self._side = torch.cuda.Stream(device)
        # (name, graph, args, out, launches), in call order
        self._stages: list = []
        self._at: Optional[int] = None  # next stage while replaying

    def serve(self, forward: Callable, x: torch.Tensor):
        if x is not self.input:
            raise ValueError("StageGraphs.serve: x is not the static input "
                             "(`ServingPipeline._upload`'s result)")
        if self._stages:
            self._at = 0
        else:
            # the side stream cannot reuse blocks cached for this one
            torch.cuda.empty_cache()
            self._side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._side):
                forward(self.input, tracing.call)
            torch.cuda.current_stream().wait_stream(self._side)
            self._at = None
        out = forward(self.input, self)
        if self._at is not None and self._at != len(self._stages):
            raise RuntimeError(f"StageGraphs: {self._at} stages replayed "
                               f"of {len(self._stages)} captured")
        tracing.counts["serve.graph_dispatches"] += 1
        return out

    def __call__(self, name: Optional[str], fn: Callable, *args):
        if self._at is None:
            graph, out, launched = self._capture(name, fn, args)
        else:
            graph, out, launched = self._take(name, args)
        tracing.call(name, graph.replay)
        for wrapper, n, by_path in launched:
            wrapper.launches += n
            for k, v in by_path.items():
                wrapper.paths[k] += v
        tracing.counts["serve.graph_replays"] += 1
        return out

    def _capture(self, name, fn, args):
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn(*args)
        launched = _captured_launches(before)
        self._stages.append((name, graph, args, out, launched))
        tracing.counts["serve.graph_captures"] += 1
        return graph, out, launched

    def _take(self, name, args):
        if self._at >= len(self._stages):
            raise RuntimeError(f"StageGraphs: stage {name!r} after the "
                               f"{len(self._stages)} captured")
        held, graph, captured, out, launched = self._stages[self._at]
        if held != name or len(captured) != len(args):
            raise RuntimeError(f"StageGraphs: stage {name!r} where "
                               f"{held!r} was captured")
        for a, c in zip(args, captured):
            if _layout(a) != _layout(c):
                raise RuntimeError(f"StageGraphs: {name!r} argument "
                                   f"{_layout(a)}, captured {_layout(c)}")
            if isinstance(c, torch.Tensor) and a.data_ptr() != c.data_ptr():
                c.copy_(a)
        self._at += 1
        return graph, out, launched


class ServingPipeline:
    """Batched steady-state inference for one camera rig.

    Args:
        cfg: model config (image size, views, ... must match the rig).
        model: an `OccDepthModel` holding its weights; the pipeline moves
            it to the serving device and puts it in eval mode.
        calib_batch: batch dict holding the rig's non-image tensors
            (projected_pix, fov_mask, cam_k, T_velo_2_cam, ida_mats) with a
            leading batch dim; row 0 is broadcast to the serving batch.
        batch_size: frames per dispatch.
        max_in_flight: dispatched-but-unread batches to keep on the device.
        device: None means CUDA, and raises without a GPU; `"cpu"` is the
            only way to serve on the CPU.
    """

    def __init__(self, cfg: OccDepthConfig, model: OccDepthModel,
                 calib_batch: Dict[str, np.ndarray], batch_size: int = 8,
                 max_in_flight: int = 2, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ServingPipeline: no CUDA device (pass "
                                   "device='cpu' to serve on the CPU)")
            device = "cuda"
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        self.max_in_flight = max(1, int(max_in_flight))
        B = self.batch_size
        self._static = {}
        for k, v in calib_batch.items():
            if k in _NON_INPUT_KEYS or k.startswith("frustums"):
                continue
            v = np.asarray(v)
            self._static[k] = torch.from_numpy(
                np.broadcast_to(v[:1], (B,) + v.shape[1:]).copy()
            ).to(self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._mean = torch.tensor(IMAGENET_MEAN, **f32)
        self._std = torch.tensor(IMAGENET_STD, **f32)
        # on CUDA, the stage graphs of the one batch shape every dispatch has
        H, W = cfg.img_shape
        self._graphs = (StageGraphs((B, cfg.n_views, H, W, 3), self.device)
                        if self.device.type == "cuda" else None)

    def _normalize(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        return (imgs_u8.float() / 255.0 - self._mean) / self._std

    def _forward(self, imgs_u8: torch.Tensor, stage) -> torch.Tensor:
        img = stage(None, self._normalize, imgs_u8)
        out = self.model(dict(self._static, img=img), stage)
        return out["ssc_logit"].argmax(dim=-1).to(torch.uint8)

    @torch.inference_mode()
    def _serve(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        if self._graphs is None:
            tracing.counts["serve.eager_dispatches"] += 1
            return self._forward(imgs_u8, tracing.call)
        return self._graphs.serve(self._forward, imgs_u8)

    @torch.inference_mode()
    def _upload(self, frames) -> torch.Tensor:
        host = torch.from_numpy(np.stack(frames))
        if self._graphs is None:
            return host
        return self._graphs.input.copy_(host.pin_memory(), non_blocking=True)

    def warmup(self) -> None:
        """Run one batch so the first real dispatch is steady-state."""
        H, W = self.cfg.img_shape
        z = [np.zeros((self.cfg.n_views, H, W, 3), np.uint8)] * self.batch_size
        self._serve(self._upload(z)).cpu()

    def run(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Map frames -> predicted class grids, in order.

        Each frame is a (V, H, W, 3) uint8 array.  Yields one (X, Y, Z)
        uint8 grid per input frame.
        """
        B = self.batch_size
        in_flight: deque = deque()  # (device result, n_valid, dispatch span)

        def dispatch(buf, n_valid):
            with tracing.span("serve.dispatch") as span:
                with tracing.span("serve.upload"):
                    x = self._upload(buf)
                with tracing.span("serve.forward"):
                    in_flight.append((self._serve(x), n_valid, span))

        def drain_one():
            out, n_valid, span = in_flight.popleft()
            # the blocking readout alone, under the id of its dispatch
            with tracing.span("serve.drain", span and span.unit):
                grids = out.cpu().numpy()
            yield from grids[:n_valid]

        buf = []
        for frame in frames:
            buf.append(np.asarray(frame, np.uint8))
            if len(buf) == B:
                while len(in_flight) >= self.max_in_flight:
                    yield from drain_one()
                dispatch(buf, B)
                buf = []
        if buf:
            n_valid = len(buf)
            buf += [buf[0]] * (B - n_valid)
            while len(in_flight) >= self.max_in_flight:
                yield from drain_one()
            dispatch(buf, n_valid)
        while in_flight:
            yield from drain_one()
