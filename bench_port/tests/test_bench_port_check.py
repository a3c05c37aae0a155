"""`correct` comes out false when the timed path is broken underneath, and
for the control (the program's own int8 path), on the small CPU cell; the
look for a card is skipped (run_cell on the CPU)."""

import os

import pytest

from bench_port import faults
from bench_port.run import run_cell

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELL = "small_2cam.objects4"
NO_METRICS = {"end_to_end": [], "per_layer": []}


def _run(**kw):
    result, numbers = run_cell(CELL, 2**31 + 99, 8.0, False, device="cpu", here=DATA,
                               bench=NO_METRICS, **kw)
    return result, numbers


def test_sound_run_is_correct():
    result, numbers = _run()
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("fault, number", [
    (faults.state_unchanged, "tracker_state_diff"),
    (faults.half_the_cameras, "workspace_diff"),
    (faults.detections_dropped, "det_unpaired"),
    (faults.k2_self_in_window, "obj_voxels"),
    (faults.workspace_voxel_moved, "workspace_diff"),
])
def test_a_broken_step_is_not_correct(fault, number):
    result, numbers = _run(fault=fault)
    assert result["correct"] is False
    assert numbers[number] > result["checks"][number]["limit"]


def test_a_fault_is_undone_after_the_window():
    from rt3d_torch.geometry import ops

    orig = ops.window_prev_or
    _run(fault=faults.k2_self_in_window)
    assert ops.window_prev_or is orig


def test_the_control_is_not_correct():
    result, numbers = _run(control=True)
    assert result["correct"] is False
    failed = [k for k, v in result["checks"].items() if v["value"] > v["limit"]]
    assert "coeff_off_share" in failed
