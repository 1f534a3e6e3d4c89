"""The port's spans (`occdepth_tpu_torch/tracing.py`) on the CPU, at the
tiny KITTI config, batch 1: an inactive span does nothing; under
`tracing.recording()` the serving, model-stage and train-step spans nest
by unit; a CPU-only `torch.profiler` session sees them by name; and the
served grids, the step's loss and the updated parameters are bitwise the
same with tracing on and off.  (The export of the eval forward with
recording on is held in `test_torch_port_outputs.py`, beside the export
the port's tests already make.)"""
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from occdepth_tpu_torch import tracing
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.serving import ServingPipeline
from occdepth_tpu_torch.testing import tiny_kitti_config
from occdepth_tpu_torch.training.optim import make_optimizer
from occdepth_tpu_torch.training.step import train_step

MODEL = ["model.backbone_2d", "model.lift", "model.oad", "model.decoder_3d",
         "model.crp", "model.heads"]
DISPATCH = ["serve.dispatch", "serve.upload", "serve.forward"] + MODEL
# train mode runs the 2D UNet once per view
STEP = (["train.step", "train.forward", "model.backbone_2d"] + MODEL
        + ["train.losses", "train.backward", "train.confusion",
           "train.update"])


def _serve(cfg, model, state, frames):
    model.load_state_dict(state)
    pipe = ServingPipeline(cfg, model, make_synthetic_batch(cfg, 1, seed=0),
                           batch_size=1, max_in_flight=2, device="cpu")
    return [g.copy() for g in pipe.run(frames)]


def _step(cfg, model, state, batch):
    model.load_state_dict(state)
    opt = make_optimizer(model.parameters(), cfg)
    logs, _, _ = train_step(cfg, model, opt, [batch], 0.0, cfg.lr)
    return (logs["loss"].clone(),
            {n: p.detach().clone() for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def runs():
    """The same serving run of two frames and the same train step from the
    same state, with tracing off, under `recording()` and under a CPU-only
    profiler."""
    cfg = tiny_kitti_config()
    torch.manual_seed(0)
    model = OccDepthModel(cfg)
    state = copy.deepcopy(model.state_dict())
    H, W = cfg.img_shape
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (cfg.n_views, H, W, 3)).astype(np.uint8)
              for _ in range(2)]
    batch = {k: torch.as_tensor(v) for k, v in make_synthetic_batch(
        cfg, 1, seed=1, with_labels=True).items()}
    out = {}
    tracing.clear()
    out["off"] = (_serve(cfg, model, state, frames),
                  _step(cfg, model, state, batch))
    out["off_records"] = tracing.records()
    with tracing.recording():
        grids = _serve(cfg, model, state, frames)
        out["serve_records"] = tracing.records()
        tracing.clear()
        out["on"] = (grids, _step(cfg, model, state, batch))
        out["step_records"] = tracing.records()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out["profiled"] = (_serve(cfg, model, state, frames),
                           _step(cfg, model, state, batch))
    # the raw events: building the event tree would take seconds
    out["profiled_names"] = {
        e.name() for e in prof.profiler.kineto_results.events()}
    out["profiled_records"] = tracing.records()
    tracing.clear()
    return out


def _within(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_inactive_span_is_the_shared_null_context(monkeypatch):
    tracing.clear()
    s = tracing.span("serve.dispatch")
    assert s is tracing.span("model.lift", unit=3)
    with s as rec:
        assert rec is None
    assert tracing.records() == []
    # tracing for torch.compile / torch.export turns spans off
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with tracing.recording():
        assert tracing.span("model.lift") is s
    assert tracing.records() == []


def test_tracing_off_records_nothing(runs):
    assert runs["off_records"] == []


def test_serving_spans_nest_under_their_dispatch(runs):
    recs = runs["serve_records"]
    by_index = {r.index: r for r in recs}
    dispatches = [r for r in recs if r.name == "serve.dispatch"]
    drains = [r for r in recs if r.name == "serve.drain"]
    assert len(dispatches) == len(drains) == 2
    for d, drain in zip(dispatches, drains):
        unit = [r for r in recs if r.unit == d.unit and r.parent is not None]
        assert sorted(r.name for r in unit) == sorted(DISPATCH[1:])
        for r in unit:
            assert _within(r, by_index[r.parent])
            assert by_index[r.parent].unit == d.unit
        # the readout of this dispatch's grids, a root of its own
        assert drain.unit == d.unit and drain.parent is None
        assert drain.start_ns >= d.end_ns
        assert drain.device_ms is None  # no CUDA events on the CPU
    assert dispatches[0].unit != dispatches[1].unit
    crp = [r for r in recs if r.name == "model.crp"]
    assert {by_index[r.parent].name for r in crp} == {"model.decoder_3d"}


def test_train_step_spans_nest_under_the_step(runs):
    recs = runs["step_records"]
    assert sorted(r.name for r in recs) == sorted(STEP)
    root, = [r for r in recs if r.parent is None]
    assert root.name == "train.step"
    by_index = {r.index: r for r in recs}
    for r in recs:
        assert r.unit == root.unit
        if r is not root:
            assert _within(r, by_index[r.parent])
    phases = [r for r in recs if r.parent == root.index]
    assert [r.name for r in phases] == [
        "train.forward", "train.losses", "train.backward",
        "train.confusion", "train.update"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))


def test_profiler_alone_sees_the_spans_by_name(runs):
    assert set(DISPATCH + STEP + ["serve.drain"]) <= runs["profiled_names"]
    assert {r.name for r in runs["profiled_records"]} == set(
        DISPATCH + STEP + ["serve.drain"])


@pytest.mark.parametrize("traced", ["on", "profiled"])
def test_outputs_bitwise_equal_with_tracing_on_and_off(runs, traced):
    (grids, (loss, params)) = runs["off"]
    (grids_t, (loss_t, params_t)) = runs[traced]
    assert len(grids) == len(grids_t) == 2
    for a, b in zip(grids, grids_t):
        assert np.array_equal(a, b)
    assert torch.equal(loss, loss_t)
    assert params.keys() == params_t.keys()
    for n in params:
        assert torch.equal(params[n], params_t[n]), n
