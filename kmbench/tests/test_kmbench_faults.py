"""The output check against broken runs, on the CPU at a small size: the
harness's whole run (its look for a card skipped) with the timed path
broken underneath must come out ``correct: false``, for each fault a cell
can have (one card, batch 1: an answer altered where it is produced, and
for training a step that leaves its state unchanged and a loss that leaves
half of the voxels out), and so must the control, the reference one precision step down in the program's place.
Each fault's number is also held against the same seed's unbroken run, so
that it is the fault that fails, not the small size.

The control at the cells' own sizes runs on the card:
``python -m pytest kmbench/tests -m gpu``."""

import pytest
import torch

from kmbench import calibrate, run
from kmbench.reference.precision import CONTROL
from kmbench.registry import Cell

SEED = 2 ** 31 + 11


def _run(cell, small):
    result, _ = run.execute(cell, SEED, 0.3, 0, device="cpu", config=small)
    return result["correct"], {k: v["value"] for k, v in result["check"].items()}


def _move_a_keypoint(monkeypatch):
    """The centre of mass puts one keypoint a heatmap voxel off."""
    from keymorph_tpu_torch.models import keymorph

    original = keymorph.center_of_mass

    def moved(vol, *args, **kwargs):
        out = original(vol, *args, **kwargs).clone()
        out[:, 0, 0] += 2.0 / vol.shape[1]
        return out

    monkeypatch.setattr(keymorph, "center_of_mass", moved)


def _alter_a_voxel(monkeypatch):
    """The warp returns one voxel altered."""
    from keymorph_tpu_torch.ops import resample

    original = resample.align_planes

    def altered(planes, x, *args, **kwargs):
        out = original(planes, x, *args, **kwargs).clone()
        out.view(-1)[out.numel() // 3] += 0.05
        return out

    monkeypatch.setattr(resample, "align_planes", altered)


def _leave_out_half(monkeypatch):
    """The step's loss leaves half of the voxels out and takes the mean over
    the rest (a batch of one's form of half of the batch left out)."""
    from keymorph_tpu_torch.training import train

    monkeypatch.setattr(train, "mse_loss", calibrate.half_mse)


def _keep_the_state(monkeypatch):
    """The optimizer leaves every parameter where it was."""
    from keymorph_tpu_torch.training import train

    monkeypatch.setattr(train, "make_optimizer",
                        lambda config, net: torch.optim.Adam(net.parameters(), lr=0.0))


@pytest.mark.parametrize("cell,fault,number", [
    ("serve-full-tps1", _move_a_keypoint, "keypoints"),
    ("serve-full-evalsweep", _alter_a_voxel, "warped"),
    ("train-half-tps", _move_a_keypoint, "keypoints"),
    ("train-half-tps", _leave_out_half, "loss"),
    ("train-half-tps", _keep_the_state, "param_change"),
])
def test_a_broken_run_is_not_correct(cell, fault, number, small, monkeypatch):
    _, sound = _run(cell, small)
    fault(monkeypatch)
    correct, broken = _run(cell, small)
    assert correct is False
    assert broken[number] > Cell(cell).limits[number]
    assert broken[number] > 10 * sound[number]


@pytest.mark.parametrize("cell", ["serve-full-tps1", "serve-full-evalsweep", "train-half-tps"])
def test_the_control_is_not_correct(cell, small):
    c = Cell(cell)
    ctx = run.Context(cell, dict(c.config, **small), c.traffic, SEED, 0.3, False,
                      torch.device("cpu"), 0.0)
    if c.traffic["driver"] == "train":
        numbers = calibrate.train_control(ctx, CONTROL)
    else:
        numbers = calibrate.serve_control(ctx, CONTROL)
    from kmbench import judge

    correct, _ = judge.verdict(numbers, c.limits)
    assert correct is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["serve-full-tps1", "train-half-tps", "serve-full-evalsweep"])
def test_the_control_fails_at_the_cells_size(cell, card):
    """On the card, at the cell's own size, on three seeds."""
    from kmbench import judge

    c = Cell(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        ctx = run.Context(cell, c.config, c.traffic, seed, 1.0, False, card, 0.0)
        if c.traffic["driver"] == "train":
            numbers = calibrate.train_control(ctx, CONTROL)
        else:
            numbers = calibrate.serve_control(ctx, CONTROL)
        assert judge.verdict(numbers, c.limits)[0] is False, (seed, numbers)
