"""The plain reference against the port's CPU path, at tiny sizes.

The benchmark's reference (portbench/reference) and the program under test
(occdepth_tpu_torch, its CPU plain versions of the kernels) load the same
seeded weights and read the same seeded inputs; in float32 on the CPU
they agree to rounding.

    python -m pytest portbench/tests -q
"""
import json
import os

import pytest
import torch

from portbench.core import inputs, program
from portbench.core.train import Train, compare_steps
from portbench.reference.config import RefConfig
from portbench.reference.losses import compute_losses

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN_MIX = {"kind": "train", "batch_size": 1, "pool_batches": 3,
             "checked_steps": 3, "trace_steps": 1}


def tiny(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["tiny_kitti", "tiny_tartanair"])
def test_reference_forward_matches_port(name):
    spec = tiny(name)
    cfg, model, shapes = program.program_model(spec, 5, "cpu")
    ref = program.reference_model(spec, shapes, 5, "cpu")
    assert set(ref.state_dict()) == set(shapes)
    batch = inputs.train_batches(spec, inputs.Rig(spec), 1, 1, 5, "cpu")[0]
    with torch.no_grad():
        got = model.eval()(batch)
        want = ref.eval()(batch)
    assert set(got) == set(want)
    for k in want:
        scale = want[k].abs().max()
        assert (got[k] - want[k]).abs().max() <= 1e-5 * scale, k


@pytest.mark.parametrize("name", ["tiny_kitti", "tiny_tartanair"])
def test_reference_losses_match_port(name):
    from occdepth_tpu_torch.training.step import compute_losses as port_losses

    spec = tiny(name)
    cfg, model, shapes = program.program_model(spec, 6, "cpu")
    ref = program.reference_model(spec, shapes, 6, "cpu")
    batch = inputs.train_batches(spec, inputs.Rig(spec), 1, 1, 6, "cpu")[0]
    with torch.no_grad():
        _, got = port_losses(cfg, model.train()(batch), batch, 0.0)
        _, want = compute_losses(RefConfig(spec), ref.train()(batch), batch)
    assert set(got) == set(want)
    # train-mode BatchNorm over the tiny 3D bottleneck moves the losses by
    # ~1e-4 of their value under float32 rounding alone
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(
            float(want[k])), k


@pytest.mark.parametrize("name", ["tiny_kitti", "tiny_tartanair"])
def test_reference_steps_match_port_steps(name):
    """Three train steps of the port (its train_step, clip and AdamW) and
    of the reference from the same weights: the first loss to rounding,
    the first gradients and the changes by the median leaf within the
    tiny network's float32 noise, the first class grid as the reference's
    own."""
    r = Train(tiny(name), TRAIN_MIX, 7, "cpu")
    r.setup()
    r.release()
    ref = r.reference_steps(grids=[r.argmax])
    numbers, info = compare_steps(r.program_steps(), ref)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 0.02
    assert numbers["change_gap"] < 0.05
    assert numbers["logit_gap"] < 0.1
    assert info["leaves_kept"] > 0.9 * info["leaves"]
