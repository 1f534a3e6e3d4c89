"""The span metrics' readers on synthetic stretches and records: device
operations that overlap, an idle gap that straddles a phase boundary,
spans that start before the stretch, per-frame and per-step
normalisation, stale records, and None where the spans are absent."""
from types import SimpleNamespace

import pytest

from occdepth_tpu_torch import tracing
from portbench.core.spec import Bench
from portbench.core.trace import Stretch

SERVE_STAGES = {"backbone2d_ms.serve": "model.backbone_2d",
                "oad_ms.serve": "model.oad",
                "decoder3d_ms.serve": "model.decoder_3d",
                "crp_ms.serve": "model.crp"}
TRAIN_IDLE = ("forward_idle_ms.train", "backward_idle_ms.train",
              "update_idle_ms.train")
ALL = ("drain_wait_ms.serve",) + tuple(SERVE_STAGES) + TRAIN_IDLE


def read(metric, kind, stretch):
    return Bench().reader(metric)(SimpleNamespace(kind=kind,
                                                  stretch=stretch))


def train_stretch(spans=True):
    """Two steps over [0, 100] ms (times in us).  Device work: [0, 20]
    from two overlapping kernels, [40, 50] with a kernel inside another,
    [90, 100]; idle [20, 40] and [50, 90].  The host's phases: forward
    from before the stretch to 30, losses to 35, backward to 70,
    confusion to 75, update to 100, so the gap [20, 40] straddles the
    losses / backward boundary and [50, 90] the backward / confusion one."""
    ms = 1000.0
    ops = [("k1", 0, 10 * ms), ("k2", 5 * ms, 20 * ms),
           ("k3", 40 * ms, 50 * ms), ("k4", 45 * ms, 48 * ms),
           ("k5", 90 * ms, 100 * ms)]
    host = [("aten::conv2d", 1 * ms, 2 * ms)]
    if spans:
        host += [("train.step", -5 * ms, 100 * ms),
                 ("train.forward", -5 * ms, 30 * ms),
                 ("train.losses", 30 * ms, 35 * ms),
                 ("train.backward", 35 * ms, 70 * ms),
                 ("train.confusion", 70 * ms, 75 * ms),
                 ("train.update", 75 * ms, 100 * ms)]
    return Stretch(device_ops=ops, host_events=host, op_device_us={},
                   start=0.0, end=100 * ms, units=2)


def serve_stretch(spans=True):
    """Four frames in two dispatches; the drains wait 3 and 5 ms."""
    host = [("aten::copy_", 0.0, 1000.0)]
    if spans:
        host += [("serve.dispatch", 0.0, 2000.0),
                 ("model.backbone_2d", 100.0, 900.0),
                 ("model.crp", 1000.0, 1100.0),
                 ("serve.dispatch", 2500.0, 4000.0),
                 ("model.backbone_2d", 2600.0, 3000.0),
                 ("model.crp", 3100.0, 3200.0),
                 ("serve.drain", 4000.0, 7000.0),
                 ("serve.drain", 7000.0, 12000.0)]
    return Stretch(device_ops=[("k", 0.0, 12000.0)], host_events=host,
                   op_device_us={}, start=0.0, end=12000.0, units=4)


def rec(name, ms):
    return SimpleNamespace(name=name, device_ms=ms)


def test_idle_per_phase_splits_straddling_gaps_and_counts_overlaps_once():
    st = train_stretch()
    got = [read(m, "train", st) for m in TRAIN_IDLE]
    # forward + losses [0, 35]: idle [20, 35]; backward [35, 70]: [35, 40]
    # and [50, 70]; confusion + update [70, 100]: [70, 90]; per step
    assert got == pytest.approx([15 / 2, 25 / 2, 20 / 2])
    idle_ms = (st.window_s - st.busy_s) * 1e3 / st.units
    assert sum(got) == pytest.approx(idle_ms)


def test_drain_wait_is_host_ms_per_dispatch():
    assert read("drain_wait_ms.serve", "serve",
                serve_stretch()) == pytest.approx((3 + 5) / 2)


def test_stage_ms_per_frame_from_the_stretchs_last_records(monkeypatch):
    # a stale record from before the stretch comes first and is left out
    monkeypatch.setattr(tracing, "records", lambda: [
        rec("model.backbone_2d", 99.0), rec("model.backbone_2d", 10.0),
        rec("model.crp", 1.0), rec("model.backbone_2d", 12.0),
        rec("model.crp", 3.0)])
    st = serve_stretch()
    assert read("backbone2d_ms.serve", "serve", st) == pytest.approx(22 / 4)
    assert read("crp_ms.serve", "serve", st) == pytest.approx(4 / 4)
    # no host events of the stage in the stretch
    assert read("oad_ms.serve", "serve", st) is None


def test_stage_ms_none_until_every_span_has_its_device_time(monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: [
        rec("model.backbone_2d", 10.0), rec("model.backbone_2d", None)])
    assert read("backbone2d_ms.serve", "serve", serve_stretch()) is None
    monkeypatch.setattr(tracing, "records", lambda: [
        rec("model.backbone_2d", 10.0)])
    assert read("backbone2d_ms.serve", "serve", serve_stretch()) is None


@pytest.mark.parametrize("metric", ALL)
def test_none_without_spans_or_in_the_other_kind(metric, monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: [])
    serve = metric.endswith(".serve")
    st = serve_stretch(spans=False) if serve else train_stretch(spans=False)
    assert read(metric, "serve" if serve else "train", st) is None
    other = train_stretch() if serve else serve_stretch()
    assert read(metric, "train" if serve else "serve", other) is None
