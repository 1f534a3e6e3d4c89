"""`ServingPipeline`'s two paths: eager on the CPU, a chain of stage CUDA
graphs on the card (`cuda` marker, skipped without one).  Either way every
served grid is bitwise the grid of the eager forward of the same padded
batch, and `tracing.counts` says which path served each dispatch.

The `cuda` cases import no JAX, so they run on a GPU host without it:
    python -m pytest tests/test_torch_port_serving.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from occdepth_tpu_torch import tracing
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.ops import launch_counters
from occdepth_tpu_torch.serving import ServingPipeline
from occdepth_tpu_torch.testing import (
    randomize_weights,
    tiny_kitti_config,
    tiny_nyu_config,
    tiny_tartanair_config,
)

N_FRAMES = 5  # a ragged tail at batch 2

CONFIGS = {
    "kitti": tiny_kitti_config,
    "kitti_bf16": lambda: tiny_kitti_config(compute_dtype="bfloat16"),
    "tartanair": tiny_tartanair_config,
    # serving takes RGB frames only: NYU without the depth input
    "nyu": lambda: tiny_nyu_config(use_depth_gt=False),
}


def _pipeline(cfg, batch_size, max_in_flight, device):
    model = randomize_weights(OccDepthModel(cfg), seed=0)
    return ServingPipeline(cfg, model, make_synthetic_batch(cfg, 1, seed=0),
                           batch_size=batch_size,
                           max_in_flight=max_in_flight, device=device)


def _frames(cfg):
    H, W = cfg.img_shape
    rs = np.random.RandomState(1)
    return [rs.randint(0, 256, (cfg.n_views, H, W, 3)).astype(np.uint8)
            for _ in range(N_FRAMES)]


@torch.inference_mode()
def _eager_grids(pipe, frames):
    """The eager forward of each padded batch, as `run` pads them: the
    model's forward with each stage run in place (`tracing.call`)."""
    B, grids = pipe.batch_size, []
    for i in range(0, len(frames), B):
        buf = frames[i:i + B]
        n = len(buf)
        buf = buf + [buf[0]] * (B - n)
        x = torch.from_numpy(np.stack(buf)).to(pipe.device)
        img = (x.float() / 255.0 - pipe._mean) / pipe._std
        out = pipe.model(dict(pipe._static, img=img))
        grids += list(out["ssc_logit"].argmax(-1).to(torch.uint8).cpu()
                      .numpy()[:n])
    return grids


def _launches():
    return {k: fn.launches for k, fn in launch_counters().items()}


def _stage_spans(cfg):
    names = ["model.backbone_2d", "model.lift", "model.decoder_3d",
             "model.heads"]
    if cfg.trans_2d_to_3d == "flosp_depth":
        names.append("model.oad")
    if cfg.context_prior:
        names.append("model.crp")
    return names


def test_cpu_serves_eagerly_as_the_direct_forward():
    cfg = tiny_kitti_config()
    pipe = _pipeline(cfg, 2, 2, "cpu")
    frames = _frames(cfg)
    before = dict(tracing.counts)
    grids = list(pipe.run(frames))
    counts = {k: tracing.counts[k] - before.get(k, 0)
              for k in tracing.counts}
    dispatches = -(-N_FRAMES // 2)
    assert counts.get("serve.eager_dispatches") == dispatches
    for k in ("serve.graph_dispatches", "serve.graph_captures",
              "serve.graph_replays"):
        assert counts.get(k, 0) == 0, k
    assert pipe._graphs is None
    eager = _eager_grids(pipe, frames)
    assert len(grids) == len(eager) == N_FRAMES
    for g, e in zip(grids, eager):
        assert np.array_equal(g, e)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("max_in_flight", [1, 2])
@pytest.mark.parametrize("batch_size", [1, 2])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_card_serves_stage_graphs_bitwise_as_eager(
        cuda_device, config, batch_size, max_in_flight):
    cfg = CONFIGS[config]()
    pipe = _pipeline(cfg, batch_size, max_in_flight, cuda_device)
    frames = _frames(cfg)
    dispatches = -(-N_FRAMES // batch_size)
    before = dict(tracing.counts)
    captured = list(pipe.run(frames))  # the first dispatch captures
    tracing.clear()
    launches = _launches()
    with tracing.recording():
        grids = list(pipe.run(frames))
    torch.cuda.synchronize()
    replayed = {k: n - launches[k] for k, n in _launches().items()}
    counts = {k: tracing.counts[k] - before.get(k, 0)
              for k in tracing.counts}

    # one capture of each stage graph, then one replay of each a dispatch
    n_graphs = len(pipe._graphs._stages)
    assert n_graphs == 6 + len(set(_stage_spans(cfg)) & {"model.oad",
                                                         "model.crp"})
    assert counts.get("serve.graph_captures") == n_graphs
    assert counts.get("serve.graph_dispatches") == 2 * dispatches
    assert counts.get("serve.graph_replays") == n_graphs * 2 * dispatches
    assert counts.get("serve.eager_dispatches", 0) == 0

    # each stage's span once a replayed dispatch, with its device time
    recs = tracing.records()
    for name in _stage_spans(cfg) + ["serve.dispatch", "serve.drain"]:
        ms = [r.device_ms for r in recs if r.name == name]
        assert len(ms) == dispatches, name
        assert all(m is not None and m >= 0 for m in ms), name

    # the kernels' counters see every launch a replay makes, as eagerly
    launches = _launches()
    eager = _eager_grids(pipe, frames)
    assert replayed == {k: n - launches[k] for k, n in _launches().items()}
    assert replayed["flosp_stereo_lift"] == (
        dispatches if cfg.dataset != "NYU" else 0)
    if cfg.context_prior:
        assert replayed["crp_relation_matmul"] == dispatches
    assert len(captured) == len(grids) == len(eager) == N_FRAMES
    for i, (c, g, e) in enumerate(zip(captured, grids, eager)):
        assert g.shape == tuple(cfg.full_scene_size) and g.dtype == np.uint8
        assert np.array_equal(c, e) and np.array_equal(g, e), f"frame {i}"
