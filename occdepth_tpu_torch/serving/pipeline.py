"""Steady-state batched inference pipeline (the serving runtime).

Counterpart of `occdepth_tpu/serving/pipeline.py::ServingPipeline`:

* **uint8 ingestion** — frames go to the device as uint8 (V, H, W, 3); the
  /255 and ImageNet normalisation run on the device;
* **fixed-shape batching** — frames are grouped into a constant batch size,
  a ragged tail is padded and its padding rows are dropped; the rig's
  calibration tensors are uploaded once and reused by every batch;
* **bounded in-flight batches** — kernels are enqueued on the current
  CUDA stream without host synchronisation, up to `max_in_flight` batches
  ahead of the host's readout of the oldest one;
* **compact egress** — only the uint8 argmax grid leaves the device.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.models.occdepth import OccDepthModel

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_NON_INPUT_KEYS = ("img", "target", "gt_depth", "CP_mega_matrices",
                   "occluded", "sample_valid", "frame_id", "sequence")


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

    @torch.inference_mode()
    def _serve(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        img = (imgs_u8.float() / 255.0 - self._mean) / self._std
        out = self.model(dict(self._static, img=img))
        return out["ssc_logit"].argmax(dim=-1).to(torch.uint8)

    def _upload(self, frames) -> torch.Tensor:
        host = torch.from_numpy(np.stack(frames))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

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
        in_flight: deque = deque()  # (device result, n_valid)

        def drain_one():
            out, n_valid = in_flight.popleft()
            yield from out.cpu().numpy()[:n_valid]

        buf = []
        for frame in frames:
            buf.append(np.asarray(frame, np.uint8))
            if len(buf) == B:
                while len(in_flight) >= self.max_in_flight:
                    yield from drain_one()
                in_flight.append((self._serve(self._upload(buf)), B))
                buf = []
        if buf:
            n_valid = len(buf)
            buf += [buf[0]] * (B - n_valid)
            while len(in_flight) >= self.max_in_flight:
                yield from drain_one()
            in_flight.append((self._serve(self._upload(buf)), n_valid))
        while in_flight:
            yield from drain_one()
